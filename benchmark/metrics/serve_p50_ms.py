"""serve_p50_ms: the median latency of every request in the traced window."""

from benchmark.harness.common import percentile


def read(run):
    lat = run.get("latencies_ms")
    return percentile(lat, 50) if lat else None
