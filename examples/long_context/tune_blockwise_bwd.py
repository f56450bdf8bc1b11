"""Time the bf16 tensor-core attention kernels under other tile constants
than the ones ``csrc/attention_blockwise.cu`` and ``csrc/attention.cu`` ship
with.

    python3 examples/long_context/tune_blockwise_bwd.py --kernel fwd \\
        --variant shipped: --variant wide:kFwdWarps=8,kFwdMinBlocks=2
    python3 examples/long_context/tune_blockwise_bwd.py --kernel mha_bwd \\
        --variant shipped: --variant one_term:kMhaDvSplit=false

``--kernel`` (repeatable; default ``dq`` and ``dkv``) names what is timed:
the blockwise forward (``fwd``), dq, dk/dv, or the whole-row backward
(``mha_bwd``). Each ``--variant name:CONST=value,...`` is a copy of the
sources with the named ``constexpr`` constants set to the given expressions:
``kWalk``, ``kFragmentsResident``; ``kDqWarps``, ``kDqPass``,
``kDqMinBlocks`` and the same three for ``kDkv``; ``kFwdWalk``,
``kFwdWarps``, ``kFwdPass``, ``kFwdStages``, ``kFwdMinBlocks``;
``kMhaWarps``, ``kMhaPassQ``, ``kMhaPassK``, ``kMhaMinBlocks``,
``kMhaFragmentsResident``, ``kMhaDvSplit``. All copies are compiled together
(one nvcc each) into ``build/tune/``, loaded beside the port's own library,
held against the plain version at the kernel's main-path shape, bf16
((B, L, D, H) = (16, 1024, 256, 4) for the blockwise kernels, (256, 53, 256,
4) for the whole-row backward; ``--shape`` sets another for all), and timed
in turns over ``--rounds`` rounds (CUDA events, median device time). Prints
ptxas' registers per kernel, the times, and the card's name and power limit.
A measuring tool: nothing of the port calls it, and it needs a CUDA card.
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

# kernel -> (source that holds it and its constants, C entry, main-path shape)
KERNELS = {
    "fwd": ("attention_blockwise.cu", "b4cp_bmha_fwd", "16,1024,256,4"),
    "dq": ("attention_blockwise.cu", "b4cp_bmha_dq", "16,1024,256,4"),
    "dkv": ("attention_blockwise.cu", "b4cp_bmha_dkv", "16,1024,256,4"),
    "mha_bwd": ("attention.cu", "b4cp_mha_bwd", "256,53,256,4"),
}
TUNED = ("attention_blockwise.cu", "attention.cu")


def build_variants(variants: dict[str, dict[str, str]], sources: list[str], entries: list[str]) -> dict:
    """One library per variant from ``sources`` with its constants replaced."""
    out_dir = os.path.join(REPO, "build", "tune")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, consts in variants.items():
        src_dir = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC, src_dir)
        texts = {src: open(os.path.join(src_dir, src)).read() for src in TUNED}
        for const, value in consts.items():
            found = 0
            for src in TUNED:
                texts[src], n = re.subn(rf"(constexpr (?:int|bool) {const} = )[^;]*;", rf"\g<1>{value};", texts[src])
                found += n
            if found != 1:
                raise SystemExit(f"{name}: no constexpr constant {const}")
        for src, text in texts.items():
            open(os.path.join(src_dir, src), "w").write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src_dir, "lib.so"),
             *(os.path.join(src_dir, src) for src in sources)],
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
                entry = re.search(r"mha_\w+?_kernelILi\d+E|mha_\w+?_kernelI\w+?Li\d+E", line)
                entry = entry.group(0) if entry else ""
            elif "_mma_kernelILi64E" in entry and ("registers" in line or "spill" in line):
                print(f"[{name}] {entry}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        for fn in entries:
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[name] = lib
    return libs


class _Swapped:
    """The port's library with the timed entries of one variant."""

    def __init__(self, real, variant, entries):
        self._real, self._variant, self._entries = real, variant, entries

    def __getattr__(self, name):
        return getattr(self._variant if name in self._entries else self._real, name)


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


def cases(kernels: list[str], shape: str | None) -> dict:
    """kernel -> (call, plain results, shape): the wrapper's call on seeded
    bf16 inputs (q, k, v slices of one projection, ragged padding) and what
    its plain version gives for them."""
    out = {}
    made = {}
    for kernel in kernels:
        b, l, d, h = (int(x) for x in (shape or KERNELS[kernel][2]).split(","))
        if (b, l, d, h) not in made:
            rng = np.random.default_rng(0)
            qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
            q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
            bias = torch.zeros(b, 1, 1, l, device="cuda")
            for i, n in enumerate(rng.integers(1, l + 1, size=b)):
                bias[i, ..., n:] = -1e9
            do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).cuda().bfloat16()
            made[b, l, d, h] = (q, k, v, bias, do)
        q, k, v, bias, do = made[b, l, d, h]
        if kernel == "mha_bwd":
            args = (q, k, v, bias, do, h)
            out[kernel] = (lambda args=args: attn.mha_backward(*args), attn.mha_backward_reference(*args), [b, l, d, h])
            continue
        want_out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        args = (q, k, v, bias, lse, do, attn.attention_delta(do, want_out, h), h)
        if kernel == "fwd":
            out[kernel] = (lambda q=q, k=k, v=v, bias=bias, h=h: attn.blockwise_mha_forward(q, k, v, bias, h),
                           (want_out, lse), [b, l, d, h])
        elif kernel == "dq":
            out[kernel] = (lambda args=args: (attn.blockwise_mha_dq(*args),), (attn.blockwise_dq_reference(*args),),
                           [b, l, d, h])
        else:
            out[kernel] = (lambda args=args: attn.blockwise_mha_dkv(*args), attn.blockwise_dkv_reference(*args),
                           [b, l, d, h])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="name:CONST=value,...")
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS), help="default: dq and dkv")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", default=None, help="B,L,D,H for every timed kernel (default: its main-path shape)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    kernels = args.kernel or ["dq", "dkv"]
    variants = {}
    for spec in args.variant:
        name, _, consts = spec.partition(":")
        variants[name] = dict(c.split("=", 1) for c in consts.split(",") if c)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    real = _build.library()
    entries = [KERNELS[kernel][1] for kernel in kernels]
    libs = build_variants(variants, sorted({KERNELS[kernel][0] for kernel in kernels}), entries)

    with torch.no_grad():
        todo = cases(kernels, args.shape)
        times = {name: {kernel: [] for kernel in kernels} for name in libs}
        errs = {name: {} for name in libs}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                _build._lib = _Swapped(real, lib, entries)
                for kernel, (call, want, _) in todo.items():
                    if rnd == 0:
                        got = call()
                        torch.cuda.synchronize()
                        # each result's largest error over its plain version's largest magnitude
                        errs[name][kernel] = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                                              for g, w in zip(got, want)]
                    times[name][kernel].append(device_ms(call, args.reps))
        _build._lib = real
    for name in libs:
        print(json.dumps({"variant": name, "consts": variants[name],
                          "shapes": {kernel: todo[kernel][2] for kernel in kernels},
                          "ms": times[name], "max_err_over_max": errs[name], "card": card}), flush=True)


if __name__ == "__main__":
    main()
