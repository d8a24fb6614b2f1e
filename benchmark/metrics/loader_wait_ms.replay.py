"""Host time a frame in the loader and the staging: the benchmark's own
clock around ``SplitPrefetcher.next`` and ``Stager.put``, over the whole
window of a traced run."""

NAME, UNIT = "loader_wait_ms.replay", "ms"
LAYER = "app frame loop (runtime/native, runtime/device_io)"
MOVES, SOURCE = "scans_per_s", "host_clock"


def read(run):
    res = run.result
    if run.trace is None or not res.loader_wait_s or res.attempted <= 0:
        return None
    return 1e3 * res.loader_wait_s / res.attempted
