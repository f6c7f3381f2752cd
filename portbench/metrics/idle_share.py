"""Share (%) of the traced segments' wall time in which no operation ran on
the device (profiler; layer: device)."""


def read(trace):
    s = trace.summary
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
