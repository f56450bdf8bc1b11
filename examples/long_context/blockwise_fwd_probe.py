"""Check and take apart the bf16 blockwise attention forward on the card.

    python3 examples/long_context/blockwise_fwd_probe.py            # oracle + times
    python3 examples/long_context/blockwise_fwd_probe.py --parts    # + parts removed

The oracle check holds ``blockwise_mha_forward`` (bf16, the TMA + ``wgmma``
kernel of ``csrc/attention_blockwise.cu``) at small shapes against a dense
f64 softmax of the same bf16 inputs and against its plain version (the
bound ``chip_smoke.py`` holds it to: abs 2e-3 + 2^-6 of the plain value,
lse 1e-5 relative): head widths 16 to 128, one and several 128-key stages,
ragged padding, and shapes that take three consumer warpgroups. It is the
first thing to run after a change to the kernel's descriptors, tensor maps
or fragment hand-over. Then it times the forward (median of CUDA events)
beside ``F.scaled_dot_product_attention`` on the same inputs, the padding
bias as its mask, at (16, 1024, 256, 4) and (8, 1024, 256, 4).

``--parts`` builds copies of the source with one part of the forward
removed (the exponentials, both products, the stage's bias) and times each
in turns with the source as it is, at (16, 1024, 256, 4): what each part
costs the kernel. Those copies compute wrong results; they are timed only.
A measuring tool: nothing of the port calls it, and it needs a CUDA card.
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


# source edits that remove one part of the forward (timing only)
PARTS = {
    "no_exp": lambda t: t.replace("ex2(s[4 * nb + 2 * r] - m_new)", "(s[4 * nb + 2 * r] - m_new)")
                         .replace("ex2(s[4 * nb + 2 * r + 1] - m_new)", "(s[4 * nb + 2 * r + 1] - m_new)"),
    "no_products": lambda t: _cut(_cut(t, "    hopper::wgmma_bf16_tb<DHP>(",
                                       "  hopper::wgmma_commit();\n}\n\nconstexpr float kLog2e", "    (void)kk;\n"),
                                  "  hopper::wgmma_bf16_m64n128k16_ss_first(s,",
                                  "  hopper::wgmma_commit();\n}\n\n// O += P V", "  (void)q_desc, (void)k_desc;\n"),
    "no_bias": lambda t: t.replace("bj[2 * nb + e] = at[nb * 8 + e] * kLog2e;", "bj[2 * nb + e] = 0.f;"),
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
    """The port's library with the forward's entry of a variant."""

    def __init__(self, real, variant):
        self._real, self._variant = real, variant

    def __getattr__(self, name):
        return getattr(self._variant if name == "b4cp_bmha_fwd" else self._real, name)


def parts(rounds: int = 3) -> None:
    text = open(os.path.join(_build.CSRC, SOURCE)).read()
    out_dir = os.path.join(REPO, "build", "fwd_parts")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, edit in {"as_is": lambda t: t, **PARTS}.items():
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
        lib.b4cp_bmha_fwd.restype, lib.b4cp_bmha_fwd.argtypes = _build.SIGNATURES["b4cp_bmha_fwd"]
        libs[name] = lib
    b, l, d, h = TIMED_SHAPES[0]
    q, k, v, bias = _inputs(b, l, d, 0)
    got = {name: [] for name in libs}
    for _ in range(rounds):
        for name, lib in libs.items():
            _build._lib = _Swapped(real, lib)
            got[name].append(device_ms(lambda: attn.blockwise_mha_forward(q, k, v, bias, h)))
    _build._lib = real
    for name, t in got.items():
        print(f"parts at {(b, l, d, h)}: {name} {statistics.median(t):.4f} ms (rounds {[round(x, 4) for x in t]})",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", action="store_true", help="also time copies with one part of the forward removed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    ok = oracle()
    times()
    if args.parts:
        parts()
    print(card, flush=True)
    if not ok:
        raise SystemExit("the forward missed its bound")


if __name__ == "__main__":
    main()
