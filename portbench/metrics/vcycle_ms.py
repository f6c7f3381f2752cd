"""Mean device milliseconds of one V-cycle (``solver.multigrid.mg_precondition``,
once per CG iteration), CUDA events around each call; layer: multigrid."""


def read(trace):
    spans = trace.spans_ms.get("vcycle") or []
    return sum(spans) / len(spans) if spans else None
