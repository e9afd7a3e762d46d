"""input_stall.train: the share of the traced window the launching thread
spent waiting in next() on the Prefetcher's stream."""


def read(run):
    if run.get("input_wait_s") is None or not run.get("window_s"):
        return None
    return 100.0 * run["input_wait_s"] / run["window_s"]
