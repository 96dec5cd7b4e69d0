"""frame_ms_p95.host: the 95th percentile of every frame's latency in the
timed window, on the host clock from the frame's start to its image
synchronized (statistics' exclusive quantiles).  A per-layer metric: the
host's speed swings too much from run to run for a bound."""
import statistics


def read(ctx):
    lat = ctx.window.get("latencies") or []
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="exclusive")[94]
