"""ctypes binding for the native IO library (``native/vqg_io.cc``).

The port's counterpart of ``blt_vqg_tpu/data/native.py``, with the same
entry points: threaded row gather, uint8 -> f32 conversion and batched
token surgery.  It builds the unchanged ``native/vqg_io.cc`` with ``g++``
at first use into ``blt_vqg_tpu_torch/build/`` (ignored by git), under a
name keyed by a hash of the source and flags, and never into ``native/``.
Every entry point falls back to numpy where no compiler exists;
:func:`available` and :func:`library_path` say which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "vqg_io.cc")
BUILD = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-march=native"]

_lib = None
_lib_path: Optional[str] = None
_lock = threading.Lock()
_tried = False


def _target() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD, f"libvqg_io-{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    try:
        path = _target()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        SOURCE], check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)   # atomic: concurrent builds race safely
        return path
    except Exception as e:  # no compiler / build failure -> numpy fallback
        log.warning("native build failed (%s); using numpy fallback", e)
        return None


def _load():
    global _lib, _lib_path, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.vqg_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
        lib.vqg_u8_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32]
        lib.vqg_token_surgery.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.vqg_make_posterior.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib, _lib_path = lib, path
        log.info("native IO library loaded: %s", path)
        return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """The loaded library's file, or None on the numpy fallback."""
    _load()
    return _lib_path


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ----------------------------------------------------------------- gather
def gather_rows(src: np.ndarray, indices: np.ndarray,
                num_threads: int = 0) -> np.ndarray:
    """dst[i] = src[indices[i]]; threaded memcpy when the lib is present."""
    lib = _load()
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None or not src.flags.c_contiguous:
        return np.ascontiguousarray(src[idx])
    row_shape = src.shape[1:]
    row_bytes = int(np.prod(row_shape)) * src.dtype.itemsize
    dst = np.empty((len(idx),) + row_shape, dtype=src.dtype)
    lib.vqg_gather_rows(_ptr(src), row_bytes, _ptr(idx), len(idx),
                        _ptr(dst), num_threads)
    return dst


def u8_to_f32(src: np.ndarray, scale: float = 1.0,
              num_threads: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None or not src.flags.c_contiguous:
        return src.astype(np.float32) * scale
    dst = np.empty(src.shape, dtype=np.float32)
    lib.vqg_u8_to_f32(_ptr(src), _ptr(dst), src.size, scale, num_threads)
    return dst


# ---------------------------------------------------------------- surgery
def token_surgery(rows: np.ndarray, drop_id: int, pad_id: int,
                  insert_vals: np.ndarray) -> np.ndarray:
    """Drop first ``drop_id`` per row (append pad), insert insert_vals at
    index 1 (the dataset's per-item surgery, batched)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    ins = np.ascontiguousarray(insert_vals, dtype=np.int32)
    n, t = rows.shape
    if lib is None or t > 511:
        from blt_vqg_tpu_torch.data.dataset import (_drop_first_token,
                                                    _insert_at_1)
        return _insert_at_1(_drop_first_token(rows, drop_id), ins)
    out = np.empty((n, t + 1), dtype=np.int32)
    lib.vqg_token_surgery(_ptr(rows), n, t, drop_id, pad_id, _ptr(ins),
                          _ptr(out))
    return out


def make_posterior(questions: np.ndarray, pos_id: int, end_id: int,
                   pad_id: int, insert_vals: np.ndarray) -> np.ndarray:
    lib = _load()
    q = np.ascontiguousarray(questions, dtype=np.int32)
    ins = np.ascontiguousarray(insert_vals, dtype=np.int32)
    n, t = q.shape
    if lib is None or t > 511:
        from blt_vqg_tpu_torch.data.dataset import (_drop_first_token,
                                                    _insert_at_1)
        p = q.copy()
        p[:, 0] = pos_id
        return _insert_at_1(_drop_first_token(p, end_id), ins)
    out = np.empty((n, t + 1), dtype=np.int32)
    lib.vqg_make_posterior(_ptr(q), n, t, pos_id, end_id, pad_id, _ptr(ins),
                           _ptr(out))
    return out
