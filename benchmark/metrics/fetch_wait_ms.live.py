"""Median host ms a frame in the pose ``fetch`` span: the card's tail of the
step after its dispatch, then the copy. ``None`` without the program's
record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "fetch_wait_ms.live", "ms"
LAYER = "app frame loop (runtime/native, runtime/device_io)"
MOVES, SOURCE = "pose_latency_p95_ms", "program_span"


def read(run):
    return spans.host_median_ms(run, ("fetch",))
