"""Mean device milliseconds of one multigrid build
(``solver.multigrid.build_precond``, once per Newton iteration), CUDA events
around each call; layer: multigrid."""


def read(trace):
    spans = trace.spans_ms.get("mg_build") or []
    return sum(spans) / len(spans) if spans else None
