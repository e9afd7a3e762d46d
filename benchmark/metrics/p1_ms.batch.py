"""p1_ms.batch: the mean device-clock milliseconds (CUDA events) of phase 1
(`infer_p1`) a batch in the traced window."""


def read(run):
    ms = run.get("events_ms", {}).get("p1")
    return sum(ms) / len(ms) if ms else None
