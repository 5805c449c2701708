"""segment_reduce_roofline.serve: % of its roofline the segmented reduce
(``csrc/segment_reduce.cu``, kernel ``seg_kernel``) reached over the traced
micro-batches, each launch at its batch's lane width."""
from perfbench import bounds
from perfbench.readers import lanes_roofline, serving


def read(run):
    if not serving(run):
        return None
    return lanes_roofline(run, "segment_reduce", "seg_kernel",
                          bounds.segment_reduce_work)
