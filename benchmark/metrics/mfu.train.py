"""mfu.train: the least time of the training steps the traced window ran
(counted FLOPs at each batch's shapes, at the bf16 peak) over the window;
in a data-parallel cell, rank 0's steps over rank 0's window."""

from benchmark.harness.work import train_least_s


def read(run):
    work = run.get("train_work")
    if not work or not run.get("window_s"):
        return None
    return 100.0 * train_least_s(run["hps"], run["step_cfg"], work) / run["window_s"]
