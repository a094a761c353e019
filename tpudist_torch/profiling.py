"""Windowed profiler tracing.

Counterpart of :mod:`tpudist.profiling`: the reference's
``torch.profiler.profile(schedule=schedule(wait=2, warmup=2, active=6,
repeat=1), tensorboard_trace_handler('./log_{jobId}'), with_stack=True)``.
After ``wait + warmup`` steps a window of ``active`` steps is captured
(CPU activity, and the card's kernels on CUDA) and written as a
TensorBoard/Chrome trace into ``log_dir`` (``{log_dir}/log_{JobID}`` from
``fit``). Wrap training in the context manager and call :meth:`step` once
per iteration. When the last window is written the profiler is closed, as
the reference stops its trace: a ``torch.profiler`` left open (its Python
stack tracer above all) keeps slowing every later step.
"""

from __future__ import annotations

from pathlib import Path

import torch


class WindowedProfiler:
    def __init__(self, job_id: str, *, wait: int = 2, warmup: int = 2,
                 active: int = 6, repeat: int = 1,
                 log_dir: str | Path | None = None, enabled: bool = True,
                 with_stack: bool = True, device=None):
        self.log_dir = str(log_dir if log_dir is not None else f"./log_{job_id}")
        self.enabled = enabled
        self._steps_left = (wait + warmup + active) * repeat
        self._prof = None
        if enabled:
            from torch.profiler import (
                ProfilerActivity, profile, schedule, tensorboard_trace_handler)

            activities = [ProfilerActivity.CPU]
            if device is not None and torch.device(device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            Path(self.log_dir).mkdir(parents=True, exist_ok=True)
            self._prof = profile(
                activities=activities,
                schedule=schedule(wait=wait, warmup=warmup, active=active,
                                  repeat=repeat),
                on_trace_ready=tensorboard_trace_handler(self.log_dir),
                with_stack=with_stack,
            )

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def step(self) -> None:
        """Advance the schedule; once per training iteration."""
        if self._prof is not None:
            self._prof.step()
            self._steps_left -= 1
            if self._steps_left <= 0:  # the last window is written: close
                self._prof.__exit__(None, None, None)
                self._prof = None

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
