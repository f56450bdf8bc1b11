"""Build, load and count the port's CUDA kernels.

The sources in ``bert4clickpath_torch/csrc/*.cu`` expose a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library under ``build/torch_kernels/`` at the repository root, named by a
hash of the sources (so a stale build is never loaded), and loaded with
``ctypes``. Nothing is built when this module is imported.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    # q, k, v, bias, dout, dq, dk, dv, is_bf16, B, L, D, H,
    # q/k/v batch and row strides (elements), scale, device, stream
    "b4cp_mha_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _P]),
    # x, w, bias|NULL, m_part, l_part, m, l, is_bf16, N, V, D, row_offset,
    # num_valid, row_start, splits, tiles_per_split, device, stream
    "b4cp_ce_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P]),
    # x, w, bias|NULL, labels (local rows), logz, dnll, live (2N + 1 int32 scratch),
    # work (f32 scratch of the packed rows), dx32, dw, db|NULL, is_bf16, N, V, D,
    # row_offset, num_valid, row_start, device, stream
    "b4cp_ce_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P]),
    # x, w, bias|NULL, labels (local rows), logz, dnll, part (splits, N, D) f32, dx,
    # is_bf16, N, V, D, row_offset, num_valid, row_start, splits,
    # tiles_per_split, device, stream
    "b4cp_ce_bwd_dx": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P]),
    # x, w, bias|NULL, labels (local rows), logz, dnll, dw, db|NULL, is_bf16,
    # N, V, D, row_offset, num_valid, row_start, device, stream
    "b4cp_ce_bwd_dw": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, lse, is_bf16, B, L, D, H,
    # q/k/v batch and row strides (elements), head stride (elements), scale,
    # vec, device, stream
    "b4cp_bmha_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _LL, _LL, _I, _F, _I, _I, _P]),
    # q, k, v, bias, lse, dout, delta, dq|NULL, dk|NULL, dv|NULL, is_bf16,
    # B, L, D, H, q/k/v batch and row strides, dout batch and row strides
    # (elements), head stride (elements), scale, vec, which (1 dq, 2 dk/dv,
    # 3 both), device, stream
    "b4cp_bmha_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _I, _F, _I, _I, _I, _P]),
    # x, seed (int32 on the device), out, is_bf16, n, threshold, inv_keep,
    # aligned, device, stream
    "b4cp_dropout": (_I, [_P, _P, _P, _I, _LL, ctypes.c_uint, _F, _I, _I, _P]),
    "b4cp_error_string": (ctypes.c_char_p, [_I]),
}

_lib = None
build_seconds = None  # wall time of the build in this process (None: not built yet)
build_log = ""  # nvcc's output (ptxas register/shared-memory report)

# launch counters, one per kernel (see launch_counts / reset_launch_counts)
_launches = {
    "gather": 0, "attention": 0, "attention_bwd": 0, "ce_fwd": 0, "ce_bwd": 0,
    "ce_bwd_dx": 0, "ce_bwd_dw": 0,
    "blockwise_fwd": 0, "blockwise_dq": 0, "blockwise_dkv": 0, "dropout": 0,
}


# copies a wrapper made of an input its kernel cannot read as it lies (the
# bf16 blockwise forward's and backward's tensor maps:
# ops/kernels/attention.py _tma_operands); not reset with the launch
# counters, so a run can show that it made none anywhere
_copies = {"blockwise_fwd": 0, "blockwise_bwd": 0}


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
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objects = [os.path.join(work, p.stem + ".o") for p in srcs]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(srcs, objects)
            ]
            logs = [proc.communicate()[0] for proc in procs]
            build_log = "".join(logs)
            failed = [p.name for p, proc in zip(srcs, procs) if proc.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            link = subprocess.run(
                [nvcc, "-shared", "-o", tmp, *objects], capture_output=True, text=True,
            )
            if link.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc -shared failed ({link.returncode}):\n{link.stdout}{link.stderr}")
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


def count_copy(name: str) -> None:
    _copies[name] += 1


def copy_counts() -> dict[str, int]:
    return dict(_copies)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
