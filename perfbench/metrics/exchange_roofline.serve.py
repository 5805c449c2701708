"""exchange_roofline.serve: % of its roofline the replica exchange
(``csrc/replica_exchange.cu``, kernel ``exchange_kernel``) reached over the
traced micro-batches, each launch at its batch's lane width."""
from perfbench import bounds
from perfbench.readers import lanes_roofline, serving


def read(run):
    if not serving(run):
        return None
    return lanes_roofline(run, "exchange", "exchange_kernel",
                          bounds.exchange_work)
