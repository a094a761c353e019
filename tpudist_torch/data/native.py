"""ctypes wrapper over the host batcher (``tpudist_torch/csrc/batcher.cpp``).

The port's copy of :mod:`tpudist.data.native`: gathering the sampler's
index shard into one contiguous batch on a persistent C++ thread pool,
dtype-preserving, or fused with the ToTensor uint8 -> float32 scale and a
per-channel normalization. Two differences from the reference:

- the library is built with ``g++`` at first use
  (:func:`tpudist_torch.csrc.build.build_host`) and a failed build
  raises: there is no quiet fallback to numpy (``DataLoader(native=False)``
  is the explicit numpy path);
- on a machine with a card, :func:`native_batch` gathers straight into
  pinned host memory, so the batch is written once and
  :func:`tpudist_torch.data.loader.prefetch_to_device` copies it to the
  card from there.
"""

from __future__ import annotations

import atexit
import ctypes
import threading

import numpy as np
import torch


def _checked_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """int64 indices with numpy's semantics (negative ones wrap, out of
    range raises): the C side trusts its pointers."""
    idx = np.ascontiguousarray(idx, np.int64)
    lo, hi = (int(idx.min()), int(idx.max())) if len(idx) else (0, -1)
    if lo < -n or hi >= n:
        raise IndexError(f"index out of range for axis of size {n} "
                         f"(min {lo}, max {hi})")
    if lo < 0:
        idx = np.where(idx < 0, idx + n, idx)
    return idx


def _require_contiguous(src: np.ndarray) -> None:
    if not src.flags["C_CONTIGUOUS"]:
        raise ValueError("the native gather needs a C-contiguous source "
                         "array; np.ascontiguousarray it once up front")


def _load() -> ctypes.CDLL:
    from tpudist_torch.csrc.build import build_host

    lib = ctypes.CDLL(str(build_host("batcher.cpp")))
    c = ctypes
    P, L = c.c_void_p, c.c_int64
    lib.tpd_pool_create.restype = P
    lib.tpd_pool_create.argtypes = [c.c_int]
    lib.tpd_pool_destroy.restype = None
    lib.tpd_pool_destroy.argtypes = [P]
    lib.tpd_gather_rows.restype = None
    lib.tpd_gather_rows.argtypes = [P, P, L, P, L, P]
    lib.tpd_gather_u8_to_f32.restype = None
    lib.tpd_gather_u8_to_f32.argtypes = [P, P, L, P, L, P, c.c_float,
                                         c.c_float]
    lib.tpd_gather_u8_to_f32_ch.restype = None
    lib.tpd_gather_u8_to_f32_ch.argtypes = [P, P, L, L, P, L, P, P, P]
    return lib


def _host_buffer(shape, dtype, pin: bool) -> np.ndarray:
    """An uninitialized host array; with ``pin`` a numpy view of a pinned
    tensor from PyTorch's host allocator (whose copies to the card record
    their events, so the block is not handed out again while one reads
    it)."""
    if pin:
        dtype = np.dtype(dtype)
        tdt = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(tuple(shape), dtype=tdt, pin_memory=True).numpy()
    return np.empty(shape, dtype)


class NativeBatcher:
    """A persistent C++ thread pool with the parallel gather kernels.
    Each gather writes into ``out`` when given (C-contiguous, of the
    result's shape and dtype), else into a new array."""

    def __init__(self, num_threads: int = 0):
        self._lib = _load()
        self._pool = self._lib.tpd_pool_create(num_threads)
        if not self._pool:
            raise RuntimeError("tpd_pool_create failed")

    def close(self) -> None:
        if self._pool:
            self._lib.tpd_pool_destroy(self._pool)
            self._pool = None

    @staticmethod
    def _out(out, shape, dtype) -> np.ndarray:
        if out is None:
            return np.empty(shape, dtype)
        if (out.shape != tuple(shape) or out.dtype != dtype
                or not out.flags["C_CONTIGUOUS"]):
            raise ValueError(f"out is {out.shape} {out.dtype}, want a "
                             f"C-contiguous {tuple(shape)} {np.dtype(dtype)}")
        return out

    def gather(self, src: np.ndarray, idx: np.ndarray,
               out: np.ndarray | None = None) -> np.ndarray:
        """``out[i] = src[idx[i]]``, rows of any dtype."""
        _require_contiguous(src)
        idx = _checked_indices(idx, len(src))
        out = self._out(out, (len(idx),) + src.shape[1:], src.dtype)
        item_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                      dtype=np.int64))
        self._lib.tpd_gather_rows(self._pool, src.ctypes.data, item_bytes,
                                  idx.ctypes.data, len(idx), out.ctypes.data)
        return out

    def gather_u8_to_f32(self, src: np.ndarray, idx: np.ndarray,
                         scale: float = 1.0 / 255.0, shift: float = 0.0,
                         out: np.ndarray | None = None) -> np.ndarray:
        """``out[i] = float32(src[idx[i]]) * scale + shift`` in one pass."""
        if src.dtype != np.uint8:
            raise TypeError(f"expected a uint8 source, got {src.dtype}")
        _require_contiguous(src)
        idx = _checked_indices(idx, len(src))
        out = self._out(out, (len(idx),) + src.shape[1:], np.float32)
        item_elems = int(np.prod(src.shape[1:], dtype=np.int64))
        self._lib.tpd_gather_u8_to_f32(self._pool, src.ctypes.data,
                                       item_elems, idx.ctypes.data, len(idx),
                                       out.ctypes.data, scale, shift)
        return out

    def gather_u8_to_f32_channels(self, src: np.ndarray, idx: np.ndarray,
                                  scale: np.ndarray, shift: np.ndarray,
                                  out: np.ndarray | None = None) -> np.ndarray:
        """``out[i][..., c] = float32(src[idx[i]][..., c]) * scale[c] +
        shift[c]``: the gather fused with ToTensor and a per-channel
        normalization."""
        if src.dtype != np.uint8:
            raise TypeError(f"expected a uint8 source, got {src.dtype}")
        _require_contiguous(src)
        if src.ndim < 2:
            raise ValueError("a per-channel gather needs src.ndim >= 2 "
                             f"([N, ..., C]); got shape {src.shape}")
        channels = src.shape[-1]
        scale = np.ascontiguousarray(scale, np.float32)
        shift = np.ascontiguousarray(shift, np.float32)
        if scale.shape != (channels,) or shift.shape != (channels,):
            raise ValueError(f"scale/shift must be shape ({channels},) to "
                             f"match the innermost source dim; got "
                             f"{scale.shape}/{shift.shape}")
        idx = _checked_indices(idx, len(src))
        out = self._out(out, (len(idx),) + src.shape[1:], np.float32)
        item_elems = int(np.prod(src.shape[1:], dtype=np.int64))
        self._lib.tpd_gather_u8_to_f32_ch(
            self._pool, src.ctypes.data, item_elems, channels,
            idx.ctypes.data, len(idx), out.ctypes.data, scale.ctypes.data,
            shift.ctypes.data)
        return out


_default: NativeBatcher | None = None
_default_lock = threading.Lock()


def default_batcher() -> NativeBatcher:
    """The process's shared batcher, built on first use (raises when the
    library cannot be built)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = NativeBatcher()
            atexit.register(_default.close)
        return _default


def fused_spec(dataset, transform) -> dict | None:
    """``transform``'s ``native_spec`` (key -> (scale, shift), scalars or
    per-channel arrays) when the gather can apply it, else None: every key
    it names is a uint8 array whose innermost dim matches a per-channel
    spec. A transform without one, or whose spec does not fit, runs on the
    gathered rows instead."""
    spec = getattr(transform, "native_spec", None)
    if spec is None:
        return None
    for k, (scale, _) in spec.items():
        v = dataset.get(k)
        if v is None or v.dtype != np.uint8 or (np.ndim(scale) > 0 and (
                v.ndim < 2 or v.shape[-1] != np.shape(scale)[0])):
            return None
    return spec


def native_batch(dataset, idx: np.ndarray, transform, *,
                 pin: bool = False) -> dict:
    """One batch of ``dataset`` (C-contiguous arrays) through the native
    gather: a transform with a fitting ``native_spec``
    (:func:`fused_spec`) is fused into the gather of its keys, another is
    applied to the gathered rows afterwards. With ``pin`` the gathered
    arrays are pinned host memory (:func:`_host_buffer`)."""
    b = default_batcher()
    spec = fused_spec(dataset, transform)
    out = {}
    for k, v in dataset.items():
        if spec is not None and k in spec:
            scale, shift = spec[k]
            buf = _host_buffer((len(idx),) + v.shape[1:], np.float32, pin)
            if np.ndim(scale) > 0:
                out[k] = b.gather_u8_to_f32_channels(v, idx, scale, shift,
                                                     out=buf)
            else:
                out[k] = b.gather_u8_to_f32(v, idx, scale, shift, out=buf)
        else:
            buf = _host_buffer((len(idx),) + v.shape[1:], v.dtype, pin)
            out[k] = b.gather(v, idx, out=buf)
    if transform is not None and spec is None:
        out = transform(out)
    return out
