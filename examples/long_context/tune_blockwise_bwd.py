"""Time the bf16 tensor-core attention kernels (and the CE kernels) under
other tile constants than the ones ``csrc/attention_blockwise.cu``,
``csrc/attention.cu``, ``csrc/fused_ce.cu`` and ``csrc/fused_ce_two_pass.cu``
ship with.

    python3 examples/long_context/tune_blockwise_bwd.py --kernel fwd \\
        --variant shipped: --variant stages2:kFwdStages=2
    python3 examples/long_context/tune_blockwise_bwd.py --kernel mha_bwd \\
        --variant shipped: --variant one_term:kMhaDvSplit=false
    python3 examples/long_context/tune_blockwise_bwd.py --kernel mha_fwd \\
        --shape 1,53,256,4 --shape 256,53,256,4 --variant shipped: --variant one:kMhaFwdWarps=1
    python3 examples/long_context/tune_blockwise_bwd.py --kernel ce_fwd \\
        --shape 2560,55296,384 --variant shipped: --variant stages3:kCeFwdStages=3
    python3 examples/long_context/tune_blockwise_bwd.py --kernel ce_dw \\
        --variant shipped: --variant stages6:kTpStages=6
    python3 examples/long_context/tune_blockwise_bwd.py --kernel ce_bwd \\
        --variant shipped: --variant no_reduce:kCeBwdDxReduce=false

``--kernel`` (repeatable; default ``dq`` and ``dkv``) names what is timed:
the blockwise forward (``fwd``), dq, dk/dv, the whole-row forward
(``mha_fwd``) or backward (``mha_bwd``), or the fused CE forward
(``ce_fwd``), dx pass (``ce_dx``), dW pass (``ce_dw``) or merged backward
(``ce_bwd``), the last three in tf32 x3 (f32 x). Each ``--variant name:CONST=value,...`` is a
copy of the sources with the named ``constexpr`` constants set to the
given expressions:
the bf16 backward's ``kDqStages`` and ``kDqQBuffers`` (dq's TMA ring of K
and V stages of 128 keys, and its Q + dO buffers), ``kDkvWalk`` (the query
rows of a dk/dv stage: 128, or 64; a multiple of 64), ``kDkvStages`` and
``kDkvKvBuffers`` (dk/dv's ring of Q and dO stages, and its K + V
buffers), ``kBwdProducerRegs`` and ``kBwdConsumerRegs`` (their setmaxnreg
split, 128 x producer + 256 x consumer <= 65,536); the bf16 forward's
``kFwdStages`` (its TMA ring of K and V stages), ``kFwdQBuffers`` and
``kFwdProducerRegs`` and ``kFwdConsumerRegs`` (its setmaxnreg split, 128 x
producer + 256 x consumer <= 65,536);
``kMhaWarps``, ``kMhaPassQ``, ``kMhaPassK``, ``kMhaMinBlocks``,
``kMhaFragmentsResident``, ``kMhaDvSplit``; ``kMhaFwdWarps``,
``kMhaFwdPass``; ``kCeFwdStages`` (the TMA ring of the CE forward: four
48 KB stages for f32 x), ``kCeFwdProducerRegs`` and ``kCeFwdConsumerRegs``
(its setmaxnreg split, 128 x producer + 256 x consumer <= 65,536);
the two-pass kernel's ``kTpStages`` (its TMA ring, both passes) and
``DX_TARGET_UNITS`` is not a constant of the source (set it on the
wrapper); the merged backward's
``kCeBwdTv`` and ``kCeBwdStages`` (table rows a unit and stages of x in
its ring, both instances at once), ``kCeBwdProducerRegs`` and
``kCeBwdConsumerRegs`` (its setmaxnreg split), ``kCeBwdDxReduce`` (false:
its dx product kept but the TMA reduce-adds dropped, which prices the
reduction across units; dx is then wrong). All copies are compiled
together (one nvcc each) into ``build/tune/``, loaded beside the port's own
library, held against the plain version at the kernel's main-path shape,
bf16 ((B, L, D, H) = (16, 1024, 256, 4) for the blockwise kernels, (256, 53,
256, 4) for the whole-row ones; (N, V, D) = (2560, 55296, 384) f32 for the
CE kernels, D = 256 for the merged backward, a catalog window of 54,542 rows, a fifth of the labels padding; ``--shape``, repeatable, sets
others for all), and timed in turns over ``--rounds`` rounds (CUDA events,
median device time). Prints
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
    "dq": ("attention_blockwise.cu", "b4cp_bmha_bwd", "16,1024,256,4"),
    "dkv": ("attention_blockwise.cu", "b4cp_bmha_bwd", "16,1024,256,4"),
    "mha_fwd": ("attention.cu", "b4cp_mha_fwd", "256,53,256,4"),
    "mha_bwd": ("attention.cu", "b4cp_mha_bwd", "256,53,256,4"),
    "ce_fwd": ("fused_ce.cu", "b4cp_ce_fwd", "2560,55296,384"),
    "ce_dx": ("fused_ce_two_pass.cu", "b4cp_ce_bwd_two_pass", "2560,55296,384"),
    "ce_dw": ("fused_ce_two_pass.cu", "b4cp_ce_bwd_two_pass", "2560,55296,384"),
    "ce_bwd": ("fused_ce.cu", "b4cp_ce_bwd", "2560,55296,256"),
}
TUNED = ("attention_blockwise.cu", "attention.cu", "fused_ce.cu", "fused_ce_two_pass.cu")


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
                entry = re.search(r"mha_\w+?_kernelILi\d+E|mha_\w+?_kernelI\w+?Li\d+E|two_pass_kernelILi\dELi\dE\w+?E"
                                  r"|fwd_mma_kernelILi\dE(?:Lb\dE)+|(?:fwd|dq|dkv|merged)_wgmma_kernelILi\d+E", line)
                entry = entry.group(0) if entry else ""
            elif (("_mma_kernelILi64E" in entry or "wgmma_kernelILi64E" in entry or entry.startswith("fwd_")
                  or entry.startswith("two_pass") or entry.startswith("merged_"))
                  and ("registers" in line or "spill" in line)):
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


def cases(kernels: list[str], shapes: list[str] | None) -> dict:
    """(kernel, shape) -> (call, plain results, shape): the wrapper's call
    on seeded inputs (attention: bf16 q, k, v slices of one projection,
    ragged padding; CE forward: f32 x, a catalog window) and what its plain
    version gives for them."""
    from bert4clickpath_torch.ops.kernels import fused_ce as ce

    out = {}
    made = {}
    for kernel in kernels:
        for shape in shapes or [KERNELS[kernel][2]]:
            dims = tuple(int(x) for x in shape.split(","))
            if kernel in ("ce_fwd", "ce_dx", "ce_dw", "ce_bwd"):
                n, v, d = dims
                rng = np.random.default_rng(0)
                x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
                table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * 0.02).cuda()
                nv = min(v - 10, 54_542)
                if kernel == "ce_fwd":
                    out[kernel, shape] = (lambda x=x, t=table, nv=nv: ce.ce_stats(x, t, None, 10, nv),
                                          ce.ce_stats_reference(x, table, None, 10, nv), list(dims))
                    continue
                lab = torch.from_numpy(np.where(rng.random(n) < 0.2, -1, rng.integers(10, 10 + nv, size=n))
                                       .astype(np.int32)).cuda()
                dnll = (lab >= 0).float() / (lab >= 0).sum()
                m, l = ce.ce_stats_reference(x, table, None, 10, nv)
                args = (x, table, None, lab, m + torch.log(l), dnll, 10, nv)
                if kernel == "ce_bwd":  # dx and dW (no bias)
                    out[kernel, shape] = (lambda args=args: ce.ce_backward_merged(*args)[:2],
                                          ce.ce_backward_reference(*args)[:2], list(dims))
                    continue
                if kernel == "ce_dw":
                    out[kernel, shape] = (lambda args=args: ce.ce_backward_dw(*args)[:1],
                                          ce.ce_backward_dw_reference(*args)[:1], list(dims))
                    continue
                out[kernel, shape] = (lambda args=args: (ce.ce_backward_dx(*args),),
                                      (ce.ce_backward_dx_reference(*args),), list(dims))
                continue
            b, l, d, h = dims
            if dims not in made:
                rng = np.random.default_rng(0)
                qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
                q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
                bias = torch.zeros(b, 1, 1, l, device="cuda")
                for i, n in enumerate(rng.integers(1, l + 1, size=b)):
                    bias[i, ..., n:] = -1e9
                do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).cuda().bfloat16()
                made[dims] = (q, k, v, bias, do)
            q, k, v, bias, do = made[dims]
            if kernel == "mha_fwd":
                args = (q, k, v, bias, h)
                out[kernel, shape] = (lambda args=args: (attn.fused_mha(*args),), (attn.mha_reference(*args),), list(dims))
                continue
            if kernel == "mha_bwd":
                args = (q, k, v, bias, do, h)
                out[kernel, shape] = (lambda args=args: attn.mha_backward(*args), attn.mha_backward_reference(*args),
                                      list(dims))
                continue
            want_out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
            args = (q, k, v, bias, lse, do, attn.attention_delta(do, want_out, h), h)
            if kernel == "fwd":
                out[kernel, shape] = (lambda q=q, k=k, v=v, bias=bias, h=h: attn.blockwise_mha_forward(q, k, v, bias, h),
                                      (want_out, lse), list(dims))
            elif kernel == "dq":
                out[kernel, shape] = (lambda args=args: (attn.blockwise_mha_dq(*args),),
                                      (attn.blockwise_dq_reference(*args),), list(dims))
            else:
                out[kernel, shape] = (lambda args=args: attn.blockwise_mha_dkv(*args),
                                      attn.blockwise_dkv_reference(*args), list(dims))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="name:CONST=value,...")
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS), help="default: dq and dkv")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", action="append", default=None,
                    help="B,L,D,H (CE: N,V,D) for every timed kernel, repeatable (default: its main-path shape)")
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
        times = {name: {f"{kernel}@{shape}": [] for kernel, shape in todo} for name in libs}
        errs = {name: {} for name in libs}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                _build._lib = _Swapped(real, lib, entries)
                for (kernel, shape), (call, want, _) in todo.items():
                    key = f"{kernel}@{shape}"
                    if rnd == 0:
                        got = call()
                        torch.cuda.synchronize()
                        # each result's largest error over its plain version's largest magnitude
                        errs[name][key] = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                                           for g, w in zip(got, want)]
                    times[name][key].append(device_ms(call, args.reps))
        _build._lib = real
    for name in libs:
        print(json.dumps({"variant": name, "consts": variants[name],
                          "ms": times[name], "max_err_over_max": errs[name], "card": card}), flush=True)


if __name__ == "__main__":
    main()
