"""Build, load and count the port's CUDA kernels.

The sources in ``bert4clickpath_torch/csrc/*.cu`` expose a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a`` into
one shared library under ``build/torch_kernels/`` at the repository root,
named by a hash of the sources (so a stale build is never loaded), and
loaded with ``ctypes``. Nothing is built when this module is imported.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code. Each wrapper adds one to its launch counter where
it launches its kernel and nowhere else, so a run can show that a path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry -> (restype, argtypes); every pointer and the stream are c_void_p
SIGNATURES = {
    # table, ids, pos, out, out_is_bf16, n_tokens, L, D, V, scale, device, stream
    "b4cp_gather_scale_pos": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # q, k, v, bias, out, is_bf16, B, L, D, H,
    # q/k/v batch and row strides (elements), scale, device, stream
    "b4cp_mha_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _P]),
    "b4cp_error_string": (ctypes.c_char_p, [_I]),
}

_lib = None
build_seconds = None  # wall time of the build in this process (None: not built yet)
build_log = ""  # nvcc's output (ptxas register/shared-memory report)

# launch counters, one per kernel (see launch_counts / reset_launch_counts)
_launches = {"gather": 0, "attention": 0}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the port's "
            "CUDA kernels are built from source at first use"
        )
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    srcs = sources()
    digest = hashlib.sha256()
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libb4cp_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        t0 = time.perf_counter()
        # build to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        msg = library().b4cp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")


def count(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
