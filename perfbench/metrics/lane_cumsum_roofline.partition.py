"""lane_cumsum_roofline.partition: % of its roofline DFEP's rank cumsum
(``csrc/lane_cumsum.cu``, kernel ``lane_cumsum_kernel``) reached over the
traced partition: two launches a round, on [2·E_pad, K] and [V, K] int32.
None where the trace or the launch count says otherwise."""
from perfbench import bounds
from perfbench.readers import partitioning


def read(run):
    if not partitioning(run) or run.profile is None or not run.launches:
        return None
    rounds, launched = run.launches[0]
    n_traced, seconds = run.profile.kernel("lane_cumsum_kernel")
    n = launched.get("lane_cumsum", 0)
    if seconds <= 0 or n != 2 * rounds or n_traced != n:
        return None
    k = run.sizes["k"]
    least = rounds * (
        bounds.least_seconds(bounds.lane_cumsum_work(run.sizes["slots"], k))
        + bounds.least_seconds(
            bounds.lane_cumsum_work(run.sizes["vertices"], k)))
    return 100.0 * least / seconds
