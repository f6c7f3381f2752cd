"""Newton iterations per member-step over the traced segments
(``StepStats.newton_iters``; layer: Newton/CG control, solver/newton.py)."""


def read(trace):
    if not trace.steps:
        return None
    return sum(s["newton"] for s in trace.steps) / len(trace.steps)
