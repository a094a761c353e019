"""Structured JSONL telemetry sink: counterpart of the writer in
:mod:`tpudist.telemetry` (``_json_safe``, ``TelemetrySink``).

One object per line, ``{"v": 1, "t": <unix seconds>, "kind": ...,
"rank": ..., "step": ..., <fields>}``, plus a trailing ``run_id`` when the
job has one (``TPUDIST_RUN_ID``) — the row shape ``tools/*.py`` read. The
file opens in APPEND mode and flushes per row. The serving engine writes
its ``serve`` / ``serve_summary`` rows here. Segment rotation
(``max_bytes``) is not ported.
"""

from __future__ import annotations

import json
import math
import numbers
import os
import threading
import time
from collections.abc import Mapping
from pathlib import Path
from typing import Any

SCHEMA_VERSION = 1
RUN_ID_ENV = "TPUDIST_RUN_ID"


def _json_safe(v):
    """Strict-JSON values: non-finite floats become null, numpy scalars
    python numbers (integers stay integers), containers recurse."""
    if isinstance(v, Mapping):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (str, int)):
        return v
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if not math.isfinite(f):
        return None
    return int(f) if isinstance(v, numbers.Integral) else f


def _env_run_id() -> str | None:
    raw = os.environ.get(RUN_ID_ENV)
    raw = None if raw is None else str(raw).strip()
    return raw or None


class TelemetrySink:
    """Append-only JSONL writer, one file per process; writes are
    serialized by a lock."""

    def __init__(self, path, *, rank: int = 0, clock=time.time,
                 run_id: str | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self._clock = clock
        self.run_id = run_id if run_id is not None else _env_run_id()
        self._lock = threading.Lock()
        self._file = open(self.path, "a", encoding="utf-8")

    def write(self, kind: str, step: int | None = None, **fields) -> dict:
        row: dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "t": round(float(self._clock()), 6),
            "kind": kind,
            "rank": self.rank,
        }
        if step is not None:
            row["step"] = int(step)
        row.update({k: _json_safe(v) for k, v in fields.items()})
        if self.run_id is not None:
            row["run_id"] = self.run_id
        line = json.dumps(row) + "\n"
        with self._lock:
            self._file.write(line)
            self._file.flush()
        return row

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()
