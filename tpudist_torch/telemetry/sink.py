"""Structured JSONL telemetry sink: counterpart of the writer in
:mod:`tpudist.telemetry` (``_json_safe``, ``TelemetrySink``).

One object per line, ``{"v": 1, "t": <unix seconds>, "kind": ...,
"rank": ..., "step": ..., <fields>}``, plus a trailing ``run_id`` when the
job has one (``TPUDIST_RUN_ID``) — the row shape ``tools/*.py`` read. The
file opens in APPEND mode and flushes per row. The serving engine writes
its ``serve`` / ``serve_summary`` rows here.

``max_bytes`` caps the active file: when the next row would pass it, the
file is sealed as the next numbered segment (``X.jsonl`` -> ``X.jsonl.1``,
``.2``, ...; the base path is always the live tail) and a fresh one
opens. Numbering resumes past the highest segment on disk, never in a
gap; :meth:`TelemetrySink.segments` lists the chain oldest first, the
active file last.
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
    """Append-only JSONL writer, one file per process, rotated into
    segments at ``max_bytes`` (module docstring; ``None`` keeps one
    file); writes are serialized by a lock."""

    def __init__(self, path, *, rank: int = 0, clock=time.time,
                 max_bytes: int | None = None, run_id: str | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self._clock = clock
        self.max_bytes = max_bytes
        self.run_id = run_id if run_id is not None else _env_run_id()
        self._lock = threading.Lock()
        self._size = self.path.stat().st_size if self.path.exists() else 0
        self._next_segment = 1 + max(
            (n for _, n in self._numbered_segments()), default=0)
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
        # the cap is in bytes on disk, not characters
        nbytes = len(line.encode("utf-8"))
        with self._lock:
            if (self.max_bytes and self._size
                    and self._size + nbytes > self.max_bytes):
                self._rotate()
            self._file.write(line)
            self._file.flush()
            self._size += nbytes
        return row

    def _numbered_segments(self) -> list[tuple[Path, int]]:
        out = []
        for p in self.path.parent.glob(f"{self.path.name}.*"):
            try:
                out.append((p, int(p.name[len(self.path.name) + 1:])))
            except ValueError:
                continue  # a foreign suffix, not a segment
        return sorted(out, key=lambda t: t[1])

    def _rotate(self) -> None:
        # under the lock: seal the full active file as the next segment
        self._file.close()
        self.path.rename(
            self.path.with_name(f"{self.path.name}.{self._next_segment}"))
        self._next_segment += 1
        self._file = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def segments(self) -> list[Path]:
        """The segment files oldest first (numeric order, gaps allowed),
        the active file last."""
        sealed = [p for p, _ in self._numbered_segments()]
        return sealed + ([self.path] if self.path.exists() else [])

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()
