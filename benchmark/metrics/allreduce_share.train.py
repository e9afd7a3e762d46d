"""allreduce_share.train: rank 0's device seconds in NCCL kernels (the
gradient all-reduces and the step's global counts) over the traced window."""

from benchmark.harness.trace import contains_seconds


def read(run):
    t = contains_seconds(run, ("nccl", "ncclDevKernel", "ncclKernel"))
    if not t or not run.get("window_s"):
        return None
    return 100.0 * t / run["window_s"]
