"""Structured per-step metrics records (jsonl).

Counterpart of ``hot_tpu.utils.metrics``: each step emits one JSON object
with dt, Newton and CG iterations, the CN residual and the energies.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    """Writes one JSON object per line; also keeps records in memory."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.records = []
        self.echo = echo
        self._fh: Optional[IO] = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, **fields):
        fields.setdefault("wall_time", time.time())
        rec = {k: _jsonable(v) for k, v in fields.items()}
        self.records.append(rec)
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    """Convert tensor and numpy scalars and arrays to plain Python."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v
