"""Mean device milliseconds of one preconditioner build: the program's
``precond_build`` spans (``solver/newton.py``: block-Jacobi's block
diagonal and inverse, or the multigrid's ``build_precond``), each timed by
the CUDA events the program's tracer records around it (portbench/spans.py);
layer: preconditioner build. None where the program records no such span."""

from portbench import spans


def read(trace):
    prog = spans.program(trace)
    if prog is None:
        return None
    ms = [s["device_ms"] for s in spans.named(prog, "precond_build")]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)
