"""Throughput/loss TSV logging: the port's copy of :mod:`tpudist.metrics`,
byte-for-byte the same file contract (the reference's main.py):

- every rank opens ``{jobId}_{batch_size}_{global_rank}.log`` and writes
  the header ``datetime\tg_step\tg_img\tloss_value\texamples_per_sec``;
- only rank 0 appends rows, every ``log_every`` (5) global steps:
  ``{datetime.now()}\t{global_step*world_size}\t{global_step*world_size*batch_size}\t{loss}\t{examples_per_sec}``
  with ``examples_per_sec = batch_size / step_duration``, per-rank
  throughput (the reference's quirk, kept for comparison); a step of
  zero or negative duration writes ``0.0`` under a ``ZeroDur`` tag;
- rank 0 prints ``Epoch: {e} step: {idx} loss: {loss}`` every
  ``print_every`` (10) batches;
- a final ``TrainTime\t%f`` row with the total wall seconds;
- ``HBM\t{json}`` rows (rank 0, :meth:`MetricsLogger.log_memory`) with
  the card's live allocator stats, after bring-up and at ``fit``'s
  ``memory_log_every`` cadence; none on the CPU, where the allocator
  reports nothing, so a CPU run's file is the reference's.

The reference's JSONL sink mirror belongs to the telemetry layer, which
is not ported yet (ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path

HEADER = "datetime\tg_step\tg_img\tloss_value\texamples_per_sec\n"


class MetricsLogger:
    def __init__(self, job_id: str, batch_size: int, global_rank: int,
                 world_size: int, *, log_every: int = 5, print_every: int = 10,
                 log_dir: str | Path = "."):
        self.job_id = job_id
        self.batch_size = batch_size
        self.global_rank = global_rank
        self.world_size = world_size
        self.log_every = log_every
        self.print_every = print_every
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self.file_name = Path(log_dir) / f"{job_id}_{batch_size}_{global_rank}.log"
        # every rank opens and writes the header; only rank 0 writes rows
        self._file = open(self.file_name, "w")
        self._file.write(HEADER)
        self._file.flush()
        self._train_begin = time.time()

    def start_timer(self) -> None:
        """Reset the TrainTime clock (just before the epoch loop)."""
        self._train_begin = time.time()

    def log_step(self, global_step: int, loss_value: float,
                 step_duration: float) -> None:
        """Call once per step on every rank; writes on rank 0 at the
        cadence."""
        if self.global_rank == 0 and global_step % self.log_every == 0:
            degenerate = step_duration <= 0.0
            examples_per_sec = (
                0.0 if degenerate else self.batch_size / step_duration)
            row = (
                f"{datetime.now()}\t{global_step * self.world_size}\t"
                f"{global_step * self.world_size * self.batch_size}\t"
                f"{loss_value}\t{examples_per_sec}\n"
            )
            if degenerate:
                row = "ZeroDur\t" + row
            self._file.write(row)
            self._file.flush()

    def print_progress(self, epoch: int, idx: int, loss_value: float) -> None:
        if self.global_rank == 0 and idx % self.print_every == 0:
            print("Epoch: {} step: {} loss: {}".format(epoch, idx, loss_value))

    def log_memory(self, stats: dict | None,
                   peak_bytes_in_use: int | None = None) -> None:
        """One ``HBM\t{json}`` row (rank 0) of live device memory stats
        (:func:`tpudist_torch.memory.device_memory_stats`), a tagged row
        like ``TrainTime``. Nothing when ``stats`` is None (the CPU) or
        off rank 0. ``peak_bytes_in_use``, when given, is the interval's
        peak ``fit`` derives from the allocator's lifetime peak; it
        replaces the lifetime value."""
        if not stats or self.global_rank != 0:
            return
        import json

        fields = dict(stats)
        if peak_bytes_in_use is not None:
            fields.pop("peak_bytes_in_use", None)
            fields["peak_bytes_in_use"] = int(peak_bytes_in_use)
        self._file.write("HBM\t%s\n" % json.dumps(fields, sort_keys=True))
        self._file.flush()

    def finish(self) -> float:
        train_time = time.time() - self._train_begin
        self._file.write("TrainTime\t%f\n" % train_time)
        self._file.close()
        return train_time

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._file.closed:
            self.finish()
