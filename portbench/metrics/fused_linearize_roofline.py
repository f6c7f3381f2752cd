"""Share (%) of its roofline that the `fused_linearize` kernel reaches in the traced
segments: the mean least time of its launches (portbench/roofline.py, from
each launch's shapes) over its mean device time per launch (profiler)."""


def read(trace):
    return trace.roofline_share("fused_linearize")
