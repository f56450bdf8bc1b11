"""ctypes loader for the native (C++/OpenMP) batch builder.

``batcher.cpp`` is copied from ``bert4clickpath_tpu/data/native/``; keep
the two in step (the tests hold both backends' batches to the JAX
package's). It is compiled with g++ on first use into ``build/native/`` at
the repository root, named by a hash of the source and the flags (so a
stale build is never loaded), and never next to the source.
:func:`native_train_batch` / :func:`native_eval_batch` have the semantics
of the numpy path (data/cloze.py). ``available()`` is False if no
toolchain is present, and the pipeline keeps using numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

# the C kernel uses a fixed 64-slot index scratch per row
MAX_ITEMS_NATIVE = 64


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatcher_{digest}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        target = _target()
        if not target.exists() and not _build(target):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            _failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_train_batch.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64, i32p, i32p, i32p,
        ]
        lib.build_eval_batch.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p,
        ]
        lib.batcher_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_train_batch(
    values: np.ndarray,  # (total,) int32 label-space
    offsets: np.ndarray,  # (n_seqs+1,) int64
    row_indices: np.ndarray,  # (B,) int64
    max_items: int,
    max_masked: int,
    masked_percentage: float,
    seed: int,
    batch_counter: int,
):
    lib = _load()
    if lib is None:
        raise RuntimeError("native batcher unavailable (g++ could not build it)")
    if max_items > MAX_ITEMS_NATIVE:
        raise ValueError(f"max_items {max_items} > {MAX_ITEMS_NATIVE}")
    b = len(row_indices)
    tokens = np.empty((b, max_items + 3), np.int32)
    positions = np.empty((b, max_masked), np.int32)
    labels = np.empty((b, max_masked), np.int32)
    lib.build_train_batch(
        _ptr(values, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64),
        _ptr(row_indices, ctypes.c_int64),
        b,
        max_items,
        max_masked,
        masked_percentage,
        seed,
        batch_counter,
        _ptr(tokens, ctypes.c_int32),
        _ptr(positions, ctypes.c_int32),
        _ptr(labels, ctypes.c_int32),
    )
    return tokens, positions, labels


def native_eval_batch(
    values: np.ndarray,
    offsets: np.ndarray,
    row_indices: np.ndarray,
    max_items: int,
    max_masked: int,
):
    lib = _load()
    if lib is None:
        raise RuntimeError("native batcher unavailable (g++ could not build it)")
    if max_items > MAX_ITEMS_NATIVE:
        raise ValueError(f"max_items {max_items} > {MAX_ITEMS_NATIVE}")
    b = len(row_indices)
    tokens = np.empty((b, max_items + 3), np.int32)
    positions = np.empty((b, max_masked), np.int32)
    labels = np.empty((b, max_masked), np.int32)
    lib.build_eval_batch(
        _ptr(values, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64),
        _ptr(row_indices, ctypes.c_int64),
        b,
        max_items,
        max_masked,
        _ptr(tokens, ctypes.c_int32),
        _ptr(positions, ctypes.c_int32),
        _ptr(labels, ctypes.c_int32),
    )
    return tokens, positions, labels
