"""Check and take apart the bf16 blockwise attention kernels on the card:
the forward and the backward's dq and dk/dv.

    python3 examples/long_context/blockwise_fwd_probe.py            # oracles + times
    python3 examples/long_context/blockwise_fwd_probe.py --parts    # + parts removed
    python3 examples/long_context/blockwise_fwd_probe.py --only bwd # the backward alone

The oracle checks come first. The forward's holds ``blockwise_mha_forward``
(bf16, the TMA + ``wgmma`` kernel of ``csrc/attention_blockwise.cu``) at
small shapes against a dense f64 softmax of the same bf16 inputs and
against its plain version (the bound ``chip_smoke.py`` holds it to: abs
2e-3 + 2^-6 of the plain value, lse 1e-5 relative): head widths 16 to 128,
one and several 128-key stages, ragged padding. The backward's holds
``blockwise_mha_backward`` (dq and dk/dv from one call) at small shapes
against dense f64 gradients of the same bf16 inputs (printed) and against
its plain version within ``BLOCKWISE_BWD_TOL`` (2e-3 of the largest
gradient, floored at 1e-2, + 2^-6 of the plain value; a fully padded batch
row held against its own largest magnitude), two runs bit-equal: head
widths 16 to 128 (24, 48 and 96 in the next wider instance), one and
several stages, rows past seq_len whose boxes hold the next batch row.
They are the first thing to run after a change to a kernel's descriptors,
tensor maps or fragment hand-over. Then it times the forward and the
backward pair (median of CUDA events) beside
``F.scaled_dot_product_attention``'s forward and backward on the same
inputs, the padding bias as its mask, at (16, 1024, 256, 4) and
(8, 1024, 256, 4).

``--parts`` builds copies of the source with one part of a kernel removed
(the forward's exponentials, both products, the stage's bias; the
backward's exponentials and all its products) and times each in turns with
the source as it is, at (16, 1024, 256, 4): what each part costs the
kernel. Those copies compute wrong results; they are timed only. A
measuring tool: nothing of the port calls it, and it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from bert4clickpath_torch.ops.kernels import _build  # noqa: E402
from bert4clickpath_torch.ops.kernels import attention as attn  # noqa: E402

SOURCE = "attention_blockwise.cu"
ORACLE_SHAPES = [(2, 100, 64, 1), (2, 100, 128, 1), (2, 129, 256, 4), (3, 300, 128, 2), (2, 100, 32, 2),
                 (2, 100, 16, 1), (2, 130, 48, 2), (1, 1, 64, 4), (2, 1000, 256, 4), (8, 100, 256, 2),
                 (8, 100, 256, 8), (2, 77, 96, 1), (2, 130, 24, 4), (16, 1000, 256, 4), (16, 1000, 256, 8),
                 (24, 300, 64, 4)]
TIMED_SHAPES = [(16, 1024, 256, 4), (8, 1024, 256, 4)]
TOL, LSE_REL = (2e-3, 2.0**-6), 1e-5


def _cut(text: str, start: str, end: str, repl: str = "") -> str:
    i = text.index(start)
    return text[:i] + repl + text[text.index(end, i):]


BWD_SHAPES = [(2, 100, 64, 1), (2, 100, 128, 1), (2, 129, 256, 4), (3, 300, 128, 2), (2, 100, 32, 2),
              (2, 100, 16, 1), (2, 130, 48, 2), (1, 1, 64, 4), (2, 1000, 256, 4), (8, 100, 256, 2),
              (8, 100, 256, 8), (2, 77, 96, 1), (2, 130, 24, 4), (4, 1000, 256, 2), (4, 1000, 256, 8),
              (3, 257, 128, 1), (24, 300, 64, 4)]
# chip_smoke.py BLOCKWISE_BWD_TOL, bf16
BWD_SHARE, BWD_FLOOR, BWD_RTOL = 2e-3, 1e-2, 2.0**-6


def _cut_body(text: str, signature: str, repl: str) -> str:
    """text with the body of the function that ``signature`` opens replaced
    by ``repl`` (its braces balanced from the first one after it)."""
    i = text.index(signature)
    j = text.index("{", i)
    depth, k = 0, j
    while True:
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        k += 1
        if depth == 0:
            return text[: j + 1] + repl + text[k - 1 :]


# source edits that remove one part of a kernel (timing only); bwd_ edits
# are timed on dq and dk/dv, the others on the forward
PARTS = {
    "no_exp": lambda t: t.replace("ex2(s[4 * nb + 2 * r] - m_new)", "(s[4 * nb + 2 * r] - m_new)")
                         .replace("ex2(s[4 * nb + 2 * r + 1] - m_new)", "(s[4 * nb + 2 * r + 1] - m_new)"),
    "no_products": lambda t: _cut(_cut(t, "    hopper::wgmma_bf16_tb<DHP>(",
                                       "  hopper::wgmma_commit();\n}\n\nconstexpr float kLog2e", "    (void)kk;\n"),
                                  "  hopper::wgmma_bf16_m64n128k16_ss_first(s,",
                                  "  hopper::wgmma_commit();\n}\n\n// O += P V", "  (void)q_desc, (void)k_desc;\n"),
    "no_bias": lambda t: t.replace("bj[2 * nb + e] = at[nb * 8 + e] * unit;", "bj[2 * nb + e] = 0.f;"),
    "bwd_no_exp": lambda t: t.replace("__expf(fmaf(s[x], scale, bj[2 * nb + e]) - lse_r[r])",
                                      "(fmaf(s[x], scale, bj[2 * nb + e]) - lse_r[r])")
                             .replace("__expf(fmaf(sT[x], scale, bias_r[r]) - (e ? l2.y : l2.x))",
                                      "(fmaf(sT[x], scale, bias_r[r]) - (e ? l2.y : l2.x))"),
    "bwd_no_products": lambda t: _cut_body(_cut_body(t, "__device__ __forceinline__ void ss_product(",
                                                     "\n  (void)acc, (void)a_desc, (void)b_desc;\n"),
                                           "__device__ __forceinline__ void rs_product(",
                                           "\n  (void)acc, (void)af, (void)b_desc;\n"),
}


def _inputs(b, l, d, seed):
    """bf16 q, k, v as strided slices of one projection; ragged padding."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
    bias = torch.zeros(b, 1, 1, l, device="cuda")
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        bias[i, ..., n:] = -1e9
    return qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], bias


def _f64(q, k, v, bias, h):
    b, l, d = q.shape
    split = lambda t: t.double().unflatten(-1, (h, d // h))  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) / (d // h) ** 0.5 + bias.double()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), split(v)).reshape(b, l, d)


def device_ms(fn, reps: int = 30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def oracle() -> bool:
    ok = True
    before = _build.copy_counts()["blockwise_fwd"]
    for b, l, d, h in ORACLE_SHAPES:
        q, k, v, bias = _inputs(b, l, d, l + d)
        out, lse = attn.blockwise_mha_forward(q, k, v, bias, h)
        want, want_lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        torch.cuda.synchronize()
        err64 = (out.double() - _f64(q, k, v, bias, h)).abs().max().item()
        used = ((out.float() - want.float()).abs() / (TOL[0] + TOL[1] * want.float().abs())).max().item()
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max().item()
        good = used <= 1.0 and lse_err <= LSE_REL and bool(torch.isfinite(out.float()).all())
        ok &= good
        print(f"(B, L, D, H) = {(b, l, d, h)}: max |out - f64 softmax| {err64:.3e}; {used:.3f} of the bound of the "
              f"plain version; lse {lse_err:.2e} relative: {'held' if good else 'MISSED'}", flush=True)
    print(f"input copies for the tensor maps: {_build.copy_counts()['blockwise_fwd'] - before} "
          "(dh = 6 copies all three inputs, padded to 16 bytes a head)", flush=True)
    return ok


def _bwd_inputs(b, l, d, seed):
    """As _inputs, with batch row 0 fully padded where b > 1 and a seeded
    bf16 output gradient."""
    q, k, v, bias = _inputs(b, l, d, seed)
    if b > 1:
        bias[0] = -1e9
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((b, l, d), dtype=np.float32))
    return q, k, v, bias, do.cuda().bfloat16()


def _f64_grads(q, k, v, bias, do, h):
    """Dense f64 (dq, dk, dv) of the same bf16 inputs: the exact softmax
    backward, no rounding anywhere."""
    b, l, d = q.shape
    split = lambda t: t.double().unflatten(-1, (h, d // h))  # noqa: E731
    qf, kf, vf, dof = (split(t) for t in (q, k, v, do))
    scale = 1.0 / (d // h) ** 0.5
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.double(), -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    grads = (torch.einsum("bhqk,bkhd->bqhd", ds, kf), torch.einsum("bhqk,bqhd->bkhd", ds, qf),
             torch.einsum("bhqk,bqhd->bkhd", p, dof))
    return tuple(g.reshape(b, l, d) for g in grads)


def bwd_used(got, want) -> float:
    """The largest share of the bound ``chip_smoke.py`` holds a bf16
    gradient to against its plain version; batch row 0 (fully padded where
    b > 1) against its own largest magnitude."""
    diff = (got.float() - want.float()).abs()
    used = 0.0
    for part in ((slice(0, 1), slice(1, None)) if got.shape[0] > 1 else (slice(None),)):
        wp = want[part].float().abs()
        atol = BWD_SHARE * max(wp.max().item(), BWD_FLOOR)
        used = max(used, (diff[part] / (atol + BWD_RTOL * wp)).max().item())
    return used


def oracle_bwd() -> bool:
    ok = True
    before = _build.copy_counts()["blockwise_bwd"]
    for b, l, d, h in BWD_SHAPES:
        q, k, v, bias, do = _bwd_inputs(b, l, d, 7 * l + d)
        out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        got = attn.blockwise_mha_backward(q, k, v, bias, out, lse, do, h)
        again = attn.blockwise_mha_backward(q, k, v, bias, out, lse, do, h)
        want = attn.blockwise_mha_backward_reference(q, k, v, bias, lse, do, attn.attention_delta(do, out, h), h)
        exact = _f64_grads(q, k, v, bias, do, h)
        torch.cuda.synchronize()
        parts = []
        for name, g, g2, w, x in zip(("dq", "dk", "dv"), got, again, want, exact):
            used = bwd_used(g, w)
            rows = slice(1, None) if b > 1 else slice(None)  # the padded row's f64 gradients differ from f32's
            err64 = ((g[rows].double() - x[rows]).abs().max() / x[rows].abs().max().clamp(min=1e-30)).item()
            good = used <= 1.0 and bool(torch.isfinite(g.float()).all()) and torch.equal(g, g2)
            ok &= good
            parts.append(f"{name} {used:.3f} of the bound, {err64:.2e} of max |f64| "
                         f"{'held' if good else 'MISSED'}{'' if torch.equal(g, g2) else ' (two runs differ)'}")
        print(f"backward (B, L, D, H) = {(b, l, d, h)}: " + "; ".join(parts), flush=True)
    print(f"backward input copies for the tensor maps: {_build.copy_counts()['blockwise_bwd'] - before} "
          "(dh = 6 and 12 copy all four inputs, padded to 16 bytes a head)", flush=True)
    return ok


def times_bwd() -> None:
    for b, l, d, h in TIMED_SHAPES:
        q, k, v, bias, do = _bwd_inputs(b, l, d, 0)
        out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        delta = attn.attention_delta(do, out, h)
        args = (q, k, v, bias, lse, do, delta, h)
        dq = device_ms(lambda: attn.blockwise_mha_dq(*args))
        dkv = device_ms(lambda: attn.blockwise_mha_dkv(*args))
        pair = device_ms(lambda: attn.blockwise_mha_backward(q, k, v, bias, out, lse, do, h))
        dl = device_ms(lambda: attn.attention_delta(do, out, h))
        heads = lambda t: t.detach().unflatten(-1, (h, d // h)).transpose(1, 2)  # noqa: E731
        qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias.bfloat16())
        lib = device_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), heads(do), retain_graph=True))
        flops = 2.0 * b * l * l * d
        print(f"(B, L, D, H) = {(b, l, d, h)}: dq {dq:.4f} ms ({3 * flops / dq / 1e9:.1f} TFLOP/s), dk/dv "
              f"{dkv:.4f} ms ({4 * flops / dkv / 1e9:.1f} TFLOP/s), the pair from one call with delta "
              f"{pair:.4f} ms (delta alone {dl:.4f}), SDPA backward {lib:.4f} ms (a yardstick)", flush=True)


def times() -> None:
    for b, l, d, h in TIMED_SHAPES:
        q, k, v, bias = _inputs(b, l, d, 0)
        heads = lambda t: t.unflatten(-1, (h, d // h)).transpose(1, 2)  # noqa: E731
        mask = bias.bfloat16()
        ms = device_ms(lambda: attn.blockwise_mha_forward(q, k, v, bias, h))
        lib = device_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask))
        print(f"(B, L, D, H) = {(b, l, d, h)}: kernel {ms:.4f} ms ({4 * b * l * l * d / ms / 1e9:.1f} TFLOP/s), "
              f"SDPA forward {lib:.4f} ms (a yardstick)", flush=True)


class _Swapped:
    """The port's library with the attention entries of a variant."""

    def __init__(self, real, variant):
        self._real, self._variant = real, variant

    def __getattr__(self, name):
        return getattr(self._variant if name in ("b4cp_bmha_fwd", "b4cp_bmha_bwd") else self._real, name)


def parts(only: str, rounds: int = 3) -> None:
    text = open(os.path.join(_build.CSRC, SOURCE)).read()
    out_dir = os.path.join(REPO, "build", "fwd_parts")
    shutil.rmtree(out_dir, ignore_errors=True)
    wanted = {name: edit for name, edit in PARTS.items() if only == "all" or name.startswith("bwd_") == (only == "bwd")}
    procs = {}
    for name, edit in {"as_is": lambda t: t, **wanted}.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC, src)
        edited = edit(text)
        if name != "as_is" and edited == text:
            raise SystemExit(f"{name}: the edit no longer applies to {SOURCE}")
        open(os.path.join(src, SOURCE), "w").write(edited)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src, "lib.so"), os.path.join(src, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    real = _build.library()
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        for entry in ("b4cp_bmha_fwd", "b4cp_bmha_bwd"):
            getattr(lib, entry).restype, getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        libs[name] = lib
    b, l, d, h = TIMED_SHAPES[0]
    q, k, v, bias, do = _bwd_inputs(b, l, d, 0)
    out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
    args = (q, k, v, bias, lse, do, attn.attention_delta(do, out, h), h)
    calls = {"fwd": lambda: attn.blockwise_mha_forward(q, k, v, bias, h),
             "dq": lambda: attn.blockwise_mha_dq(*args), "dkv": lambda: attn.blockwise_mha_dkv(*args)}
    timed = {name: [c for c in calls if (c == "fwd") == (not name.startswith("bwd_"))] if name != "as_is" else
             [c for c in calls if only == "all" or (c == "fwd") == (only == "fwd")] for name in libs}
    got = {(name, c): [] for name in libs for c in timed[name]}
    for _ in range(rounds):
        for name, lib in libs.items():
            _build._lib = _Swapped(real, lib)
            for c in timed[name]:
                got[name, c].append(device_ms(calls[c]))
    _build._lib = real
    for (name, c), t in got.items():
        print(f"parts at {(b, l, d, h)}: {c} {name} {statistics.median(t):.4f} ms (rounds {[round(x, 4) for x in t]})",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", action="store_true", help="also time copies with one part of a kernel removed")
    ap.add_argument("--only", choices=("all", "fwd", "bwd"), default="all", help="the forward or the backward alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    ok = True
    if args.only != "bwd":
        ok &= oracle()
    if args.only != "fwd":
        ok &= oracle_bwd()
    if args.only != "bwd":
        times()
    if args.only != "fwd":
        times_bwd()
    if args.parts:
        parts(args.only)
    print(card, flush=True)
    if not ok:
        raise SystemExit("a kernel missed its bound")


if __name__ == "__main__":
    main()
