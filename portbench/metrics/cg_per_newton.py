"""CG iterations per Newton iteration over the traced segments
(``StepStats.cg_iters`` over ``StepStats.newton_iters``; layer: Newton/CG
control, solver/cg.py). None where no step took a Newton iteration."""


def read(trace):
    newton = sum(s["newton"] for s in trace.steps)
    return sum(s["cg"] for s in trace.steps) / newton if newton else None
