"""k2_roofline.train: the least time of the alignment searches of the traced
window's steps over the profiler's device time of K2's kernels."""

from benchmark.harness.trace import contains_seconds
from benchmark.harness.work import k2_least_s


def read(run):
    t = contains_seconds(run, ("mas_kernel", "mas_warp_kernel"))
    if not t or not run.get("mas_calls"):
        return None
    return 100.0 * k2_least_s(run["mas_calls"]) / t
