"""device_idle.synth: the share of the traced window in which no operation
ran on the card, from the profiler's device intervals."""


def read(run):
    if not run.get("window_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
