"""Share of the traced stretch in which no operation ran on the card, at
the live 10 Hz (the card waits for the sensor and for the host's
dispatch)."""

NAME, UNIT, LAYER = "device_idle.live", "%", "device (H100)"
MOVES, SOURCE = "pose_latency_p95_ms", "device_trace"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
