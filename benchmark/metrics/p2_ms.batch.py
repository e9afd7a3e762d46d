"""p2_ms.batch: the mean device-clock milliseconds (CUDA events) of phase 2
(`infer_path` and `infer_p2` with the int8 decoder) a batch in the traced
window."""


def read(run):
    ms = run.get("events_ms", {}).get("p2")
    return sum(ms) / len(ms) if ms else None
