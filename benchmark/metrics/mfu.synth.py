"""mfu.synth: the least time of the synthesis the traced window served
(each utterance's counted FLOPs at its frames served, float at the fp32
peak, int8 at the int8 peak) over the window."""

from benchmark.harness.work import synth_least_s


def read(run):
    work = run.get("synth_work")
    if not work or not run.get("window_s"):
        return None
    return 100.0 * synth_least_s(run["hps"], work) / run["window_s"]
