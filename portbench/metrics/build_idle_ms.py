"""Device idle milliseconds per preconditioner build during which the host
was inside the program's ``precond_build`` span: the traced segment's idle
gaps put down to the innermost span open on the host (portbench/spans.py),
summed under ``precond_build``, over its spans; layer: preconditioner
build. Reads ``trace.device``, the device intervals on the profiler's
clock; None where the trace lacks them or the program's spans."""

from portbench import spans


def read(trace):
    prog = spans.program(trace)
    if prog is None:
        return None
    return spans.idle_ms_per(trace, "precond_build", spans.named(prog, "precond_build"))
