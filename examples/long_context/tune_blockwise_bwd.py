"""Time the bf16 blockwise attention backward kernels under other tile
constants than the ones ``csrc/attention_blockwise.cu`` ships with.

    python3 examples/long_context/tune_blockwise_bwd.py \\
        --variant shipped: --variant wide:kDqWarps=8,kDqPass=32,kDqMinBlocks=2

Each ``--variant name:CONST=value,...`` is a copy of the source with the
named ``constexpr`` constants (``kWalk``, ``kFragmentsResident``;
``kDqWarps``, ``kDqPass``, ``kDqMinBlocks`` and the same three for
``kDkv``) set to the given expressions. All copies are compiled together (one nvcc each) into ``build/tune/``, loaded
beside the port's own library, held against the plain version at
(B, L, D) = (16, 1024, 256), 4 heads, bf16, and timed in turns over
``--rounds`` rounds (CUDA events, median device time). Prints ptxas'
registers per kernel, the times, and the card's name and power limit. A
measuring tool: nothing of the port calls it, and it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from bert4clickpath_torch.ops.kernels import _build  # noqa: E402
from bert4clickpath_torch.ops.kernels import attention as attn  # noqa: E402

ENTRIES = ("b4cp_bmha_fwd", "b4cp_bmha_dq", "b4cp_bmha_dkv")


def build_variants(variants: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    out_dir = os.path.join(REPO, "build", "tune")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, consts in variants.items():
        src_dir = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC, src_dir)
        path = os.path.join(src_dir, "attention_blockwise.cu")
        text = open(path).read()
        for const, value in consts.items():
            text, n = re.subn(rf"(constexpr (?:int|bool) {const} = )[^;]*;", rf"\g<1>{value};", text)
            if n != 1:
                raise SystemExit(f"{name}: no constexpr constant {const}")
        open(path, "w").write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src_dir, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = re.search(r"bmha_\w+?_kernelILi\d+E|bmha_\w+?_kernelI\w+?Li\d+E", line)
                entry = entry.group(0) if entry else ""
            elif "_mma_kernelILi64E" in entry and ("registers" in line or "spill" in line):
                print(f"[{name}] {entry}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        for fn in ENTRIES:
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[name] = lib
    return libs


class _Swapped:
    """The port's library with the blockwise entries of one variant."""

    def __init__(self, real, variant):
        self._real, self._variant = real, variant

    def __getattr__(self, name):
        return getattr(self._variant if name in ENTRIES else self._real, name)


def device_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(500_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="name:CONST=value,...")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", default="16,1024,256,4", help="B,L,D,H")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    variants = {}
    for spec in args.variant:
        name, _, consts = spec.partition(":")
        variants[name] = dict(c.split("=", 1) for c in consts.split(",") if c)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    real = _build.library()
    libs = build_variants(variants)

    b, l, d, h = (int(x) for x in args.shape.split(","))
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    bias = torch.zeros(b, 1, 1, l, device="cuda")
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        bias[i, ..., n:] = -1e9
    do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).cuda().bfloat16()
    with torch.no_grad():
        out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        call = (q, k, v, bias, lse, do, attn.attention_delta(do, out, h), h)
        want = (attn.blockwise_dq_reference(*call), *attn.blockwise_dkv_reference(*call))
        times = {name: {"dq": [], "dkv": []} for name in libs}
        errs = {}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                _build._lib = _Swapped(real, lib)
                if rnd == 0:
                    got = (attn.blockwise_mha_dq(*call), *attn.blockwise_mha_dkv(*call))
                    torch.cuda.synchronize()
                    errs[name] = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                                  for g, w in zip(got, want)]
                times[name]["dq"].append(device_ms(lambda: attn.blockwise_mha_dq(*call), args.reps))
                times[name]["dkv"].append(device_ms(lambda: attn.blockwise_mha_dkv(*call), args.reps))
        _build._lib = real
    for name in libs:
        print(json.dumps({"variant": name, "consts": variants[name], "shape": [b, l, d, h],
                          "dq_ms": times[name]["dq"], "dkv_ms": times[name]["dkv"],
                          "max_err_over_max_dq_dk_dv": errs[name], "card": card}), flush=True)


if __name__ == "__main__":
    main()
