"""The 90th percentile (ms, host clock) over the window's frames of the time
from a frame's hand-over to `track_stereo` to the return of the call that
gave back its finalized pose. Nothing below 10 frames."""
import statistics


def read(run):
    lat = run["window"]["latencies"]
    if len(lat) < 10:
        return None
    return 1e3 * statistics.quantiles(lat, n=10)[-1]
