"""k1_roofline.synth: the least time of the int8 ResBlock2 chains launched
in the traced window over the profiler's device time of K1's kernels."""

from benchmark.harness.trace import contains_seconds
from benchmark.harness.work import k1_least_s


def read(run):
    t = contains_seconds(run, ("rb2_chain_kernel", "rb2_split_kernel"))
    if not t or not run.get("k1_chains"):
        return None
    return 100.0 * k1_least_s(run["k1_chains"]) / t
