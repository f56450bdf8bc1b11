"""Check and time the merged CE backward (``ce_backward_merged``) on the card.

    python3 examples/long_context/ce_bwd_probe.py            # oracle + times
    python3 examples/long_context/ce_bwd_probe.py --parts    # + parts removed

The oracle check comes first: at small shapes the kernel (the TMA +
``wgmma`` kernel ``ce_bwd_merged_wgmma_kernel`` of ``csrc/fused_ce.cu``,
f32 and bf16 x) against dense f64 gradients of the same
inputs, dx, dW and db held within ``CE_GRAD_REL`` (1e-4) of the oracle's
largest magnitude for f32 x and within 2e-2 for bf16 x (whose oracle
takes the bf16-rounded table and A, as the kernel does), and against the
plain version. Widths 8 to 256 (both instances, ragged widths), N and V
off the tiles, one and several stages and units, a window that blinds
rows at both ends, LABEL_PAD rows (dnll 0), an out-of-vocabulary label
(-1 with a nonzero dnll), with and without a bias, ordinary and wide
logits; two runs: dW and db bit-equal, dx within 1e-5 of the largest |dx|
(atomic adds; bf16 dx besides one bf16 ulp of the value, where the two f32
sums round to neighbours). It is the first thing to run after a change to the
kernel's descriptors, planes or fragments.

Then it times the kernel (median of CUDA events) at the flagship's CE
shape (N = 2,560, V = 55,296, D = 256), at D = 128 on the same rows, at
the long-session shape (N = 160, V = 20,480, D = 256) and, with
``--large``, at the large catalog's (V = 10,000,384, D = 128), beside the
tf32 x3 bound of the labelled rows, and with bf16 x beside. ``--parts``
builds copies of ``fused_ce.cu`` with one part of the kernel removed (the
scores' products, the gradient products, the exponentials, dx's
reduce-adds) and times each in turns with the source as it is, at the
flagship and at N = 2,560, V = 1,000,064, D = 128 (the large catalog's
width, without its partial last wave of units): what each part costs.
Those copies compute wrong results; they are timed only. A measuring
tool: nothing of the port calls it, and it needs a CUDA card.
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

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from bert4clickpath_torch.ops.kernels import _build  # noqa: E402
from bert4clickpath_torch.ops.kernels import fused_ce as k  # noqa: E402

CE_GRAD_REL = 1e-4  # chip_smoke.py: f32 gradients, of the largest magnitude
BF16_REL = 2e-2
DX_REPEAT = 1e-5  # chip_smoke.py CE_DX_REPEAT
# (N, V, D, table scale): N and V off the 64-row tiles, D over both instances
ORACLE_SHAPES = [(100, 300, 8, 0.02), (130, 1000, 72, 0.02), (200, 777, 128, 0.02), (64, 64, 256, 0.02),
                 (300, 2000, 200, 0.02), (257, 513, 256, 0.02), (5, 100, 32, 0.02), (1, 40, 128, 0.02),
                 (700, 3001, 128, 0.3), (700, 3001, 256, 0.2), (129, 95, 64, 0.02), (2560, 4096, 256, 0.02)]
TIMED = {"flagship_256": (2560, 55_296, 256), "flagship_128": (2560, 55_296, 128), "long_session": (160, 20_480, 256)}
LARGE = {"large_128": (2560, 10_000_384, 128)}
PARTS_LARGE = (2560, 1_000_064, 128)  # the large catalog's width, a tenth of its rows: no partial last wave
TF32_PEAK = 495e12
OFF = 3


def _inputs(rng, n, v, d, scale, dtype, with_bias):
    """x, table, bias, labels (table rows), logz (f64 oracle), dnll: rows
    OFF .. v - 4 in the window, a fifth of the rows LABEL_PAD (dnll 0), row
    0 labelled out of the vocabulary (-1) with a nonzero dnll."""
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().to(dtype)
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * scale).cuda()
    bias = torch.from_numpy(rng.standard_normal(v, dtype=np.float32)).cuda() if with_bias else None
    nv = max(1, v - OFF - 4)
    lab = torch.from_numpy(rng.integers(OFF, OFF + nv, size=n).astype(np.int32)).cuda()
    keep = torch.from_numpy(rng.random(n) >= 0.2).cuda()
    keep[0] = True
    lab[0] = -1
    dnll = keep.float() / keep.float().sum()
    logz = _oracle(x, table, bias, lab, None, dnll, nv)[0]
    return (x, table, bias, lab, logz.float(), dnll, OFF, nv)


def _oracle(x, table, bias, lab, logz, dnll, nv):
    """logz (logz None) or (dx, dW, db) in f64; bf16 x: the table and A
    rounded to bf16 as the kernel rounds them."""
    bf16 = x.dtype == torch.bfloat16
    w = (table.to(x.dtype) if bf16 else table).double()
    s = x.double() @ w.T
    if bias is not None:
        s = s + bias.double()
    rows = torch.arange(table.shape[0], device=x.device)
    s = torch.where((rows >= OFF) & (rows < OFF + nv), s, torch.full_like(s, -1e30))
    if logz is None:
        return (torch.logsumexp(s, dim=1),)
    a = dnll.double()[:, None] * (torch.exp(s - logz.double()[:, None]) - (rows[None] == lab.long()[:, None]).double())
    ar = a.float().to(x.dtype).double() if bf16 else a
    return ar @ w, ar.T @ x.double(), a.sum(0)


def oracle_checks(rng) -> bool:
    ok = True
    for n, v, d, scale in ORACLE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_bias in (False, True):
                args = _inputs(rng, n, v, d, scale, dtype, with_bias)
                got = k.ce_backward_merged(*args)
                again = k.ce_backward_merged(*args)
                plain = k.ce_backward_reference(*args)
                want = _oracle(*args[:6], args[7])
                rel = CE_GRAD_REL if dtype == torch.float32 else BF16_REL
                used, vs_plain = [], []
                for g, p, w in zip(got, plain, want):
                    if g is None:
                        continue
                    top = float(w.abs().max())
                    used.append(float((g.double() - w).abs().max()) / (rel * top))
                    vs_plain.append(float((g.double() - p.double()).abs().max()) / (rel * top))
                # two runs of dx: atomic adds (bf16: each may round its f32 sum to the other neighbour)
                dx_top = max(float(want[0].abs().max()), 1e-30)
                slack = 0.0 if dtype == torch.float32 else 2.0**-7 * got[0].float().abs()
                dx_gap = float(((got[0].float() - again[0].float()).abs() - slack).clamp(min=0).max()) / dx_top
                bits = torch.equal(got[1], again[1]) and (got[2] is None or torch.equal(got[2], again[2]))
                fine = all(np.isfinite(used)) and max(used) <= 1.0 and bits and dx_gap <= DX_REPEAT
                fine &= all(torch.isfinite(g).all() for g in got if g is not None)
                ok &= fine
                print(f"oracle N={n} V={v} D={d} scale={scale} {str(dtype)[6:]} bias={with_bias}: dx / dW"
                      f"{' / db' if with_bias else ''} use " + " / ".join(f"{u:.3f}" for u in used)
                      + f" of {rel:.0e} (vs plain " + " / ".join(f"{u:.3f}" for u in vs_plain)
                      + f"); two runs: dW, db bit-equal {bits}, dx apart {dx_gap:.2e}"
                      + ("" if fine else "  <-- FAILED"), flush=True)
    return ok


def median_ms(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _timed_args(n, v, d):
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((n, d), generator=gen, device="cuda")
    table = torch.randn((v, d), generator=gen, device="cuda").mul_(0.02)
    nv = v - OFF - 1
    lab = torch.randint(OFF, OFF + nv, (n,), generator=gen, device="cuda", dtype=torch.int32)
    keep = torch.rand(n, generator=gen, device="cuda") >= 0.2
    dnll = keep.float() / keep.float().sum()
    logz = torch.full((n,), float(np.log(nv)), device="cuda")
    return (x, table, None, lab, logz, dnll, OFF, nv), int(keep.sum())


def times(shapes: dict, reps: int) -> dict:
    out = {}
    card = torch.cuda.get_device_name(0)
    for name, (n, v, d) in shapes.items():
        args, live = _timed_args(n, v, d)
        ms = median_ms(lambda: k.ce_backward_merged(*args), reps)
        bound = 3 * 6.0 * live * args[7] * d / TF32_PEAK * 1e3
        out[name] = ms
        bf16 = (args[0].to(torch.bfloat16), *args[1:])
        ms_b = median_ms(lambda: k.ce_backward_merged(*bf16), reps)
        bound_b = 6.0 * live * args[7] * d / (2 * TF32_PEAK) * 1e3
        print(f"time {name} N={n} V={v:,} D={d} f32: {ms:.4f} ms; bound {bound:.4f} ms at tf32 x3 ({live} labelled "
              f"rows; share {bound / ms:.3f}); bf16 x {ms_b:.4f} ms (bound {bound_b:.4f} at bf16, share "
              f"{bound_b / ms_b:.3f}) [{card}]", flush=True)
        del args
        torch.cuda.empty_cache()
    return out


# parts of the kernel removed in copies of fused_ce.cu: [(text, its replacement)]
PARTS = {
    "no_scores_products": [("              box_product<kHalf, kBf16>(ks,", "              if (false) box_product<kHalf, kBf16>(ks,")],
    "no_grad_products": [("              box_product<kTv, kBf16>(dk[grp.mt]", "              if (false) box_product<kTv, kBf16>(dk[grp.mt]"),
                         ("              box_product<kCeBwdRows, kBf16>(xk[grp.mt]",
                          "              if (false) box_product<kCeBwdRows, kBf16>(xk[grp.mt]")],
    "no_dx_reduce": [("constexpr bool kCeBwdDxReduce = true;", "constexpr bool kCeBwdDxReduce = false;")],
    "no_exp": [("(expf(sv - row_info[h].x) -", "((sv - row_info[h].x) -")],
}


class _Swapped:
    """The port's library with a copy's merged backward entry."""

    def __init__(self, real, variant):
        self._real, self._variant = real, variant

    def __getattr__(self, name):
        return getattr(self._variant if name == "b4cp_ce_bwd" else self._real, name)


def _build_copies(texts: dict) -> dict:
    """One library per copy of fused_ce.cu (one nvcc each, all at once)."""
    out_dir = os.path.join(REPO, "build", "ce_bwd_parts")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC, src)
        with open(os.path.join(src, "fused_ce.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src, "lib.so"),
             os.path.join(src, "fused_ce.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        lib.b4cp_ce_bwd.restype, lib.b4cp_ce_bwd.argtypes = _build.SIGNATURES["b4cp_ce_bwd"]
        libs[name] = lib
    return libs


def parts(shapes: list, rounds: int = 2) -> None:
    """Copies of fused_ce.cu with one part cut, timed in turns with the source."""
    src = (_build.CSRC / "fused_ce.cu").read_text()
    texts = {}
    for name, cuts in PARTS.items():
        texts[name] = src
        for text, repl in cuts:
            assert src.count(text) == 1, (name, text)
            texts[name] = texts[name].replace(text, repl)
    libs = _build_copies(texts)
    real = _build.library()
    card = torch.cuda.get_device_name(0)
    for shape in shapes:
        args, _ = _timed_args(*shape)
        t = {name: [] for name in ["shipped", *texts]}
        try:
            for _ in range(rounds):
                for name in t:
                    _build._lib = real if name == "shipped" else _Swapped(real, libs[name])
                    t[name].append(median_ms(lambda: k.ce_backward_merged(*args), 5))
        finally:
            _build._lib = real
        for name, v in t.items():
            print(f"parts {name} at N={shape[0]} V={shape[1]:,} D={shape[2]}: {min(v):.4f} ms (runs "
                  + ", ".join(f"{x:.4f}" for x in v) + f") [{card}]", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--parts", action="store_true", help="time copies with one part removed")
    p.add_argument("--large", action="store_true", help="also time the large catalog's shape")
    p.add_argument("--no-oracle", action="store_true", help="skip the oracle checks")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is required")
    _build.library()
    for line in _build.build_log.splitlines():
        if "C7513" in line or "warning" in line:
            print(f"build: {line.strip()}", flush=True)
    printing = False
    for line in _build.build_log.splitlines():  # ptxas' report of the new kernel's instances
        if "Compiling entry function" in line:
            printing = "ce_bwd_merged" in line
        if printing and ("registers" in line or "spill" in line or "Compiling" in line):
            print(f"ptxas: {line.strip()}", flush=True)
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library()._name], capture_output=True, text=True).stdout
    fn, ops = None, {}
    for line in sass.splitlines():  # the new kernel's warpgroup products and TMA instructions
        if "Function :" in line:
            fn = line.split("Function :")[1].strip() if "ce_bwd_merged" in line else None
        elif fn:
            for op in ("HGMMA", "UTMALDG", "UTMAREDG", "UBLKRED", "UTMASTG"):
                ops.setdefault(fn, dict.fromkeys(("HGMMA", "UTMALDG", "UTMAREDG", "UBLKRED", "UTMASTG"), 0))[op] += op in line
    for fn, c in ops.items():
        print(f"sass {fn[-60:]}: {c}", flush=True)
    ok = True if args.no_oracle else oracle_checks(np.random.default_rng(0))
    times({**TIMED, **(LARGE if args.large else {})}, 10)
    if args.parts:
        parts([TIMED["flagship_256"], PARTS_LARGE])
    if not ok:
        raise SystemExit("the merged backward misses its oracle")


if __name__ == "__main__":
    main()
