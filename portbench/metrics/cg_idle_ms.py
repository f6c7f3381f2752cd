"""Device idle milliseconds per CG iteration during which the host was
inside the program's ``cg`` span and not inside a ``vcycle`` or
``precond_build`` span within it: the traced segment's idle gaps put down
to the innermost span open on the host (portbench/spans.py), over the
``cg.iter`` spans of the linear solves; layer: Newton/CG control. Reads
``trace.device``; None where the trace lacks it or the program's spans."""

from portbench import spans


def read(trace):
    prog = spans.program(trace)
    if prog is None:
        return None
    return spans.idle_ms_per(trace, "cg", spans.named(prog, "cg.iter", parent="cg"),
                             outside=("vcycle", "precond_build"))
