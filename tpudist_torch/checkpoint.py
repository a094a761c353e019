"""Checkpoint and resume: the training state to disk and back, in place.

Counterpart of :mod:`tpudist.checkpoint`, built on
``torch.distributed.checkpoint`` (DCP) where the reference uses Orbax. A
directory holds one DCP checkpoint per saved step, ``<dir>/<step>/``,
plus the run's geometry ``tpudist_meta.json`` (:meth:`Checkpointer.write_meta`)
and, when one is set, the anchored step ``tpudist_anchor.json``. What a
step holds is :meth:`tpudist_torch.train.TrainState.state_dict`: the
float32 masters, the BN buffers, the optimizer state and the step.

- **Asynchronous saves.** :meth:`Checkpointer.save` copies the state into
  host buffers it keeps (pinned memory for a state on the card, copies
  queued on the current stream behind one event, so the loop waits for
  nothing on the device) and returns; a background thread waits for the
  event and writes the copy with DCP. ``wait=True`` is the emergency save:
  it returns once the step is durable. One save is in flight at a time:
  the next ``save`` (or ``wait``, ``restore``, ``close``) first waits for
  the one before.
- **A step appears whole or not at all.** The write goes to
  ``<step>.partial`` and rank 0 renames it once every rank's part is
  written, so a directory named by a bare integer is complete (a crash
  mid-write leaves a ``.partial`` that no scan sees).
- **Collectives.** DCP's save and load are collectives. Under a process
  group the checkpointer forms a gloo group of its own at construction
  (every rank constructs one at the same point): DCP coordinates on the
  host, and its writes run in a background thread beside the training
  step's collectives on the default group. Without a group it runs in
  one process.
- **Restore in place.** :meth:`Checkpointer.restore` loads into the live
  tensors of ``like`` (DCP reads into the destination's storage) and then
  applies the counters: no tensor is rebound, so the fused AdamW kernel's
  table of pointers and DDP's buckets stay valid. ``fallback=True`` walks
  back from a newest step that fails to load, emitting
  ``checkpoint_fallback`` events.

- **The elastic reshard's commit.** A resume onto another data world
  (:mod:`tpudist_torch.resilience.elastic`) rewrites history: the old
  steps are moved under ``_pre_reshard/`` with a commit marker
  (:meth:`Checkpointer.quarantine_steps`), the new-world state is saved,
  the meta flipped, and only then is the quarantine purged
  (:meth:`Checkpointer.purge_quarantined`).
  :meth:`Checkpointer.recover_interrupted_reshard` finishes or rolls back
  a commit a crash interrupted, as the reference's protocol does.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import tempfile
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from tpudist_torch.distributed import group_up

#: where restore's fallback walk sets aside step dirs that failed to load:
#: moved, never deleted (the failure may be transient I/O), but out of the
#: step namespace so latest_step stops seeing them
FAILED_DIR = "_failed"

#: where an elastic reshard's commit moves the old-world steps (a name
#: without digits: a step scan must never read it as a step)
QUARANTINE_DIR = "_pre_reshard"

#: the quarantine's commit marker: the NEW geometry, written after every
#: rename
COMMIT_MARKER = "commit_meta.json"

#: the last-known-good marker: its step is exempt from retention
ANCHOR_FILE = "tpudist_anchor.json"

#: the run geometry a resume is checked against
META_FILE = "tpudist_meta.json"

#: how many of the newest steps retention keeps when ``keep_last`` is None
#: (the reference's default)
KEEP_LAST = 3

_PARTIAL = ".partial"


def atomic_write_json(directory: Path, name: str, obj) -> None:
    """Write ``obj`` as JSON at ``directory/name`` atomically (a sibling
    temporary file, fsync, ``os.replace``): a preemption mid-write never
    leaves a torn file for the next generation to read."""
    directory = Path(directory)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f".{name}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(obj))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, directory / name)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _steps(directory: Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(int(d.name) for d in directory.iterdir()
                  if d.is_dir() and d.name.isdigit())


def latest_step(directory: str | Path) -> int | None:
    """Newest saved step under ``directory``: a directory scan (step dirs
    are bare integers; a write in flight is ``<step>.partial``)."""
    return max(_steps(Path(directory)), default=None)


def read_step(directory: str | Path, step: int) -> dict:
    """Every entry of saved step ``step`` on the CPU, by its flattened name
    (``opt.mu.conv1.weight``, ``step``): what two runs' checkpoints are
    compared by. A resume loads in place through
    :meth:`Checkpointer.restore` instead."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = str(Path(directory) / str(int(step)))
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    sd = {k: (torch.empty(m.size, dtype=m.properties.dtype)
              if isinstance(m, TensorStorageMetadata) else None)
          for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process")
        dcp.load(sd, checkpoint_id=path, no_dist=True)
    return sd


class Checkpointer:
    """A directory of step-numbered training-state checkpoints.

    >>> ckpt = Checkpointer("runs/ck", keep_last=2)
    >>> ckpt.save(state)                    # asynchronous; the step is state.step
    >>> ckpt.restore(like=state)            # the newest step, into state
    >>> ckpt.latest_step()

    ``keep_last`` (:data:`KEEP_LAST` when None) bounds retention to the
    newest step dirs plus the anchored step (:meth:`read_anchor`); rank 0
    prunes after each save is durable. ``last_write_s`` (the last save's
    background write) is kept for measurement."""

    def __init__(self, directory: str | Path, keep_last: int | None = None):
        self.directory = Path(directory).absolute()
        self.keep_last = KEEP_LAST if keep_last is None else int(keep_last)
        self._rank = dist.get_rank() if group_up() else 0
        if self._rank == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
        self._group = dist.new_group(backend="gloo") if group_up() else None
        self._barrier()
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._future: concurrent.futures.Future | None = None
        self._buffers: dict[str, torch.Tensor] = {}
        self.last_write_s = None

    # -- collectives ------------------------------------------------------
    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _dcp(self, fn, sd: dict, path: Path) -> None:
        if self._group is not None:
            fn(sd, checkpoint_id=str(path), process_group=self._group)
            return
        with warnings.catch_warnings():
            # DCP says it assumes one process; that is the intent here
            warnings.filterwarnings("ignore", message=".*single process")
            fn(sd, checkpoint_id=str(path), no_dist=True)

    # -- write ------------------------------------------------------------
    def save(self, state, wait: bool = False) -> bool:
        """Persist ``state`` (a :class:`~tpudist_torch.train.TrainState`),
        asynchronously unless ``wait``. Returns False if this step is
        already saved. ``wait=True`` is the emergency save: it returns
        once the checkpoint, and any earlier one in flight, is durable."""
        self.wait()
        step = int(state.step)
        if step in self.all_steps():
            return False
        staged, ready = self._stage(state.state_dict())
        self._future = self._executor.submit(self._write, staged, ready, step)
        if wait:
            self.wait()
        return True

    @torch.no_grad()
    def _stage(self, sd: dict):
        """A host copy of ``sd`` in buffers kept from save to save; copies
        from the card are queued on the current stream into pinned memory
        behind one event, which the writer waits for."""
        cuda = False

        def copy(tree, prefix=""):
            nonlocal cuda
            out = {}
            for k, v in tree.items():
                name = f"{prefix}{k}"
                if isinstance(v, dict):
                    out[k] = copy(v, f"{name}.")
                    continue
                if not isinstance(v, torch.Tensor):
                    out[k] = v
                    continue
                # a DTensor (a shard of a global array) stages its local
                # part and keeps its placement, so DCP writes its chunk
                t = v.to_local() if hasattr(v, "to_local") else v
                buf = self._buffers.get(name)
                if (buf is None or buf.shape != t.shape
                        or buf.dtype != t.dtype):
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.is_cuda)
                    self._buffers[name] = buf
                buf.copy_(t.detach(), non_blocking=t.is_cuda)
                cuda = cuda or t.is_cuda
                out[k] = buf
                if t is not v:
                    from torch.distributed.tensor import DTensor

                    out[k] = DTensor.from_local(
                        buf, v.device_mesh, v.placements, run_check=False,
                        shape=v.shape, stride=v.stride())
            return out

        staged = copy(sd)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        return staged, ready

    def _write(self, staged: dict, ready, step: int) -> None:
        if ready is not None:
            ready.synchronize()
        t0 = time.perf_counter()
        partial = self.directory / f"{step}{_PARTIAL}"
        # DCP's save returns on every rank after rank 0 wrote the metadata,
        # which it does once every rank's part is written
        self._dcp(_dcp_save, staged, partial)
        if self._rank == 0:
            os.replace(partial, self.directory / str(step))
            self._prune()
        self._barrier()
        self.last_write_s = time.perf_counter() - t0

    def _prune(self) -> None:
        """Retention: delete every step dir but the newest ``keep_last``
        and the anchored step. Fail-soft: retention never kills training
        over a racing delete."""
        keep = max(self.keep_last, 1)
        steps = self.all_steps()
        protect = set(steps[-keep:])
        anchor = self.read_anchor()
        if anchor is not None:
            protect.add(anchor)
        for s in steps:
            if s not in protect:
                shutil.rmtree(self.directory / str(s), ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is durable (re-raising its
        error, if it failed)."""
        future, self._future = self._future, None
        if future is not None:
            future.result()

    def quarantine_failed_step(self, step: int) -> bool:
        """Set aside one saved step that failed to load: rank 0 moves its
        dir into ``_failed/`` between two barriers, so it stops shadowing
        ``latest_step`` and can be saved again, but it is never deleted
        (the failure may have been transient I/O). The filesystem move is
        fail-soft; the barriers are not."""
        step = int(step)
        if not (self.directory / str(step)).is_dir():
            return False
        self.wait()
        self._barrier()
        if self._rank == 0:
            try:
                failed = self.directory / FAILED_DIR
                failed.mkdir(exist_ok=True)
                target = failed / str(step)
                if target.exists():
                    shutil.rmtree(target, ignore_errors=True)
                os.replace(self.directory / str(step), target)
            except OSError:
                pass
        self._barrier()
        return (self.directory / FAILED_DIR / str(step)).is_dir()

    # -- the elastic reshard's commit --------------------------------------
    # 1. quarantine_steps(commit_meta=new): every step dir renamed into
    #    QUARANTINE_DIR (still a valid old-world checkpoint), then the
    #    marker (the NEW meta) written atomically beside them;
    # 2. save(state, wait=True) at the remapped step;
    # 3. write_meta(new): the flip;
    # 4. purge_quarantined(): the old steps, marker last.
    # recover_interrupted_reshard() at the next bring-up: a live step and
    # the marker mean the save landed (adopt the marker as the meta and
    # purge); otherwise roll every quarantined dir back.
    def _quarantined(self) -> list[Path]:
        q = self.directory / QUARANTINE_DIR
        if not q.is_dir():
            return []
        return sorted((p for p in q.iterdir()
                       if p.is_dir() and p.name.isdigit()),
                      key=lambda p: int(p.name))

    def quarantine_steps(self, commit_meta: dict | None = None) -> list[int]:
        """Move every live step dir aside and drop the commit marker
        describing the NEW geometry. Returns the quarantined steps."""
        self.wait()
        steps = self.all_steps()
        self._barrier()
        if self._rank == 0:
            q = self.directory / QUARANTINE_DIR
            q.mkdir(exist_ok=True)
            for s in steps:
                os.replace(self.directory / str(s), q / str(s))
            if commit_meta is not None:
                # only after every rename: the marker certifies them
                atomic_write_json(q, COMMIT_MARKER, commit_meta)
        self._barrier()
        return steps

    def recover_interrupted_reshard(self) -> str | None:
        """Finish or roll back a commit a crash interrupted: ``"completed"``
        (a new-world step was saved: its marker becomes the meta and the
        quarantine is purged), ``"rolled_back"`` (the quarantined steps
        renamed back under the old meta, still valid), or None (nothing
        interrupted). Every rank reads the decision before any rank acts."""
        q = self.directory / QUARANTINE_DIR
        if not q.is_dir():
            return None
        marker = q / COMMIT_MARKER
        adopt = (json.loads(marker.read_text())
                 if self.all_steps() and marker.exists() else None)
        self._barrier()
        if adopt is not None:
            self.write_meta(adopt)
            self._barrier()
            self.purge_quarantined()
            return "completed"
        if self._rank == 0:
            # the marker first: a rollback cut short must leave a
            # marker-less quarantine, retried as another rollback
            if marker.exists():
                os.unlink(marker)
            for p in self._quarantined():
                os.replace(p, self.directory / p.name)
            try:
                q.rmdir()
            except OSError:
                pass
        self._barrier()
        return "rolled_back"

    def purge_quarantined(self) -> None:
        """Delete the quarantined old-world steps (once a new-world step
        and its meta are durable), the marker last."""
        if self._rank == 0:
            q = self.directory / QUARANTINE_DIR
            for p in self._quarantined():
                shutil.rmtree(p, ignore_errors=True)
            shutil.rmtree(q, ignore_errors=True)
        self._barrier()

    def saved_metadata(self, step: int) -> dict:
        """Each tensor entry of saved step ``step`` by its flattened name:
        ``(global shape, dtype)``."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata)

        meta = dcp.FileSystemReader(str(self.directory / str(int(step)))
                                    ).read_metadata().state_dict_metadata
        return {k: (tuple(m.size), m.properties.dtype)
                for k, m in meta.items()
                if isinstance(m, TensorStorageMetadata)}

    def raw_restore(self, sd: dict, step: int) -> dict:
        """Load saved step ``step`` into ``sd`` (nested dicts of tensors,
        each of the saved global shape or a DTensor of it; entries left
        out are not read). Returns ``sd``."""
        self.wait()
        self._dcp(_dcp_load, sd, self.directory / str(int(step)))
        return sd

    # -- read -------------------------------------------------------------
    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def all_steps(self) -> list[int]:
        return _steps(self.directory)

    def step_bytes(self, step: int) -> int:
        """The bytes of step ``step``'s files on disk."""
        return sum(f.stat().st_size
                   for f in (self.directory / str(step)).rglob("*")
                   if f.is_file())

    def restore(self, like, step: int | None = None, *,
                fallback: bool = False, on_event=None):
        """Load a checkpoint into ``like`` (a
        :class:`~tpudist_torch.train.TrainState`) in place and return it.

        ``step`` None takes the newest. ``fallback=True`` walks back to the
        previous saved step when one fails to load (a preemption mid-save
        can leave a truncated step dir): each failed step emits a
        ``checkpoint_fallback`` event through ``on_event``, and only when
        every step fails does the last error propagate."""
        self.wait()
        if step is not None:
            steps = [int(step)]
        else:
            steps = sorted(self.all_steps(), reverse=True)
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            if not fallback:
                steps = steps[:1]
        from torch.distributed.checkpoint.api import CheckpointException

        # DCP raises CheckpointException, a BaseException, for what any
        # rank failed to read
        _LOAD_ERRORS = (Exception, CheckpointException)
        last_exc: BaseException | None = None
        for i, s in enumerate(steps):
            try:
                sd = like.state_dict()
                self._dcp(_dcp_load, sd, self.directory / str(s))
                like.load_state_dict(sd)
            except _LOAD_ERRORS as exc:
                last_exc = exc
                if on_event is not None and len(steps) > 1:
                    on_event({
                        "tag": "checkpoint_fallback",
                        "failed_step": int(s),
                        "error": f"{type(exc).__name__}: {exc}"[:400],
                        "next_step": (int(steps[i + 1])
                                      if i + 1 < len(steps) else None),
                    })
                continue
            if like.step != s:
                raise ValueError(f"checkpoint {self.directory / str(s)} "
                                 f"holds step {like.step}")
            return like
        raise last_exc

    # -- run metadata -----------------------------------------------------
    def write_meta(self, meta: dict) -> None:
        """The run's geometry (rank 0 writes; a resume is checked
        against it)."""
        if self._rank == 0:
            atomic_write_json(self.directory, META_FILE, meta)

    def read_meta(self) -> dict | None:
        p = self.directory / META_FILE
        return json.loads(p.read_text()) if p.exists() else None

    def write_anchor(self, step: int) -> None:
        """Mark ``step`` last-known-good: retention never deletes it."""
        if self._rank == 0:
            atomic_write_json(self.directory, ANCHOR_FILE, {"step": int(step)})

    def read_anchor(self) -> int | None:
        p = self.directory / ANCHOR_FILE
        if not p.exists():
            return None
        try:
            return int(json.loads(p.read_text())["step"])
        except (ValueError, KeyError, TypeError, OSError):
            return None

    def close(self) -> None:
        """Wait for the save in flight, then release the writer thread and
        the checkpointer's group."""
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)
            if self._group is not None and group_up():
                dist.destroy_process_group(self._group)
            self._group = None


def _dcp_save(sd, **kw):
    import torch.distributed.checkpoint as dcp

    dcp.save(sd, **kw)


def _dcp_load(sd, **kw):
    import torch.distributed.checkpoint as dcp

    dcp.load(sd, **kw)
