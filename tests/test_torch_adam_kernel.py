"""The optimizer's one-pass Adam (``ops/kernels/adam.py``, ``csrc/adam.cu``)
against its plain version: ``Adam.update`` followed by ``p.add_(u * lr)``.

On the CPU ``apply_gradients`` takes the plain path and never launches the
kernel; the kernel's wrapper refuses what the kernel does not take before
it loads anything. Marked ``gpu`` (they skip where there is no card): three
steps through the kernel against the plain path on the same card, bit for
bit in p, mu and nu; on a machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_adam_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels import adam as adam_kernels
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import Adam, TrainState, apply_gradients
from bert4clickpath_torch.utils import profiling

STEPS = 3
SCHEDULE = schedules.warmup_constant(1e-3, 10)  # another learning rate each step
LR_SCALE = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ragged(device, seed=0) -> dict:
    """Named f32 parameters: sizes 1, 3 and 4,097, matrices that decay and
    tables that do not, and one whose start is not 16-byte aligned (a view
    one element into a flat buffer)."""
    rng = np.random.default_rng(seed)
    shapes = {
        "embed_items.weight": (37, 16), "encoder.layer_0.mha.wq.weight": (16, 16),
        "encoder.layer_0.mha.wq.bias": (3,), "encoder.layer_0.ln1.weight": (1,),
        "encoder.layer_0.ffn1.weight": (4097,), "encoder.layer_0.ffn2.weight": (33, 7),
    }
    params = {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device) for k, s in shapes.items()}
    flat = torch.from_numpy(rng.standard_normal(1 + 1001, dtype=np.float32)).to(device)
    params["encoder.layer_1.ffn1.weight"] = flat[1:].view(7, 143)
    return params


def _many(device, n: int) -> dict:
    """n small named tensors (more than one launch takes, for n above the
    kernel's capacity)."""
    rng = np.random.default_rng(1)
    shapes = {f"encoder.layer_{i}.ffn1.weight" if i % 2 else f"encoder.layer_{i}.ffn1.bias":
              (5, 3 + i % 7) if i % 2 else (3 + i % 7,) for i in range(n)}
    return {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device) for k, s in shapes.items()}


def _grads(params: dict, rng) -> dict:
    """Normal gradients spread over six decades, some exactly 0."""
    out = {}
    for k, p in params.items():
        g = rng.standard_normal(p.shape, dtype=np.float32) * 10.0 ** rng.uniform(-3, 3, size=p.shape)
        g[rng.random(p.shape) < 0.05] = 0.0
        out[k] = torch.from_numpy(g.astype(np.float32)).to(p.device)
    return out


def _plain_step(tx: Adam, state: TrainState, grads: dict) -> TrainState:
    """The plain path: ``Adam.update``, then ``p.add_(u * lr)``."""
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    with torch.no_grad():
        lr = SCHEDULE(state.step) * state.lr_scale
        for name, p in state.params.items():
            p.add_(updates[name] * lr)
    return state.replace(step=state.step + 1, opt_state=opt_state)


def _state(params: dict, tx: Adam, device) -> TrainState:
    state = TrainState.create(params, tx)
    state.lr_scale.fill_(LR_SCALE)
    return state


def _clone(params: dict) -> dict:
    """Copies laid out as the originals (the unaligned view stays one)."""
    out = {}
    for k, p in params.items():
        if p.storage_offset():
            base = torch.empty(p.storage_offset() + p.numel(), dtype=p.dtype, device=p.device)
            out[k] = base[p.storage_offset():].view(p.shape).copy_(p)
        else:
            out[k] = p.clone()
    return out


def _assert_same_bits(got: TrainState, want: TrainState, step: int):
    for name in want.params:
        for what, g, w in (("p", got.params[name], want.params[name]),
                           ("mu", got.opt_state.mu[name], want.opt_state.mu[name]),
                           ("nu", got.opt_state.nu[name], want.opt_state.nu[name])):
            assert g.dtype == w.dtype, (step, name, what)
            assert torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32),
                               w.view(torch.int16 if w.dtype == torch.bfloat16 else torch.int32)), (step, name, what)


def _run_both(params: dict, tx: Adam, device, steps: int = STEPS, on_step=None):
    """``steps`` of ``apply_gradients`` beside the plain path from the same
    parameters and gradients, held bit for bit after every step."""
    state = _state(params, tx, device)
    plain = _state(_clone(params), tx, device)
    rng = np.random.default_rng(3)
    for step in range(steps):
        grads = _grads(state.params, rng)
        _build.reset_launch_counts()
        state = apply_gradients(state, grads, tx, SCHEDULE)
        if on_step is not None:
            on_step(state)
        plain = _plain_step(tx, plain, grads)
        if device.type == "cuda":
            torch.cuda.synchronize()
        _assert_same_bits(state, plain, step)
        assert state.step == plain.step == step + 1 and state.opt_state.count == step + 1
    return state


# -- the CPU: the plain path ---------------------------------------------------


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_apply_gradients_on_cpu_is_the_plain_path(mu_dtype, weight_decay):
    """On the CPU two steps of ``apply_gradients`` are bitwise ``Adam.update``
    + ``p.add_(u * lr)``, and the kernel's counters stay at 0."""
    tx = Adam(0.9, 0.999, 1e-9, mu_dtype=mu_dtype, weight_decay=weight_decay)

    def no_launch(_):
        assert _build.launch_counts()["adam"] == 0
        assert adam_kernels.TENSORS_COUNTER not in profiling.counters()

    state = _run_both(_ragged(torch.device("cpu")), tx, torch.device("cpu"), steps=2, on_step=no_launch)
    assert all(m.dtype == mu_dtype for m in state.opt_state.mu.values())


def _lists(device="cpu", n=3, mu_dtype=torch.float32):
    ps = [torch.zeros(5, 4, device=device) for _ in range(n)]
    return dict(
        params=ps, grads=[torch.zeros_like(p) for p in ps], mus=[torch.zeros_like(p, dtype=mu_dtype) for p in ps],
        nus=[torch.zeros_like(p) for p in ps], decays=[False] * n,
    )


def _refused(kind: str, device) -> dict:
    lists = _lists(device, mu_dtype=torch.float16 if kind == "f16 mu" else torch.float32)
    if kind == "f64 param":
        lists["params"][1] = lists["params"][1].double()
    elif kind == "f64 grad":
        lists["grads"][2] = lists["grads"][2].double()
    elif kind == "bf16 nu":
        lists["nus"][0] = lists["nus"][0].bfloat16()
    elif kind == "mixed mu":
        lists["mus"][1] = lists["mus"][1].bfloat16()
    elif kind == "non-contiguous grad":
        lists["grads"][1] = torch.zeros(4, 5, device=device).t()
    elif kind == "non-contiguous param":
        lists["params"][0] = torch.zeros(5, 8, device=device)[:, ::2]
    elif kind == "other shape":
        lists["nus"][2] = torch.zeros(20, device=device)
    elif kind == "grad on the cpu":
        lists["grads"][0] = lists["grads"][0].cpu()
    elif kind == "short list":
        lists["decays"] = [False]
    return lists


REFUSED = ["f64 param", "f64 grad", "bf16 nu", "f16 mu", "mixed mu", "non-contiguous grad",
           "non-contiguous param", "other shape", "short list"]
HYPER = dict(b1=0.9, b1_mu=0.9, b2=0.999, eps=1e-9, bc1=0.1, bc2=0.001, weight_decay=0.0, lr=1e-3)


@pytest.mark.parametrize("kind", REFUSED + ["cpu tensors"])
def test_adam_kernel_refuses_before_loading(kind, monkeypatch):
    """The wrapper raises on what the kernel does not take (a dtype, a
    layout, a shape, the CPU) before it loads the library."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was loaded"))
    with pytest.raises(ValueError):
        adam_kernels.adam_step(**_refused(kind, "cpu"), **HYPER, lr_scale=torch.ones(()))


# -- the card: the kernel ------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tensors", ["ragged", "beyond_capacity"])
def test_adam_kernel_matches_plain_path_bitwise(cuda, mu_dtype, tensors):
    """Three steps of ``apply_gradients`` through the kernel against the
    plain path on the card, weight decay 0.01 on the matrices, lr_scale
    0.5: p, mu and nu bit-equal after each step; one launch a step for up
    to the kernel's capacity of tensors, the few it takes beyond, and every
    tensor counted."""
    cap = adam_kernels.capacity()
    params = _ragged(cuda) if tensors == "ragged" else _many(cuda, cap + 3)
    tx = Adam(0.9, 0.999, 1e-9, mu_dtype=mu_dtype, weight_decay=0.01)
    assert any(tx.decays(k, p) for k, p in params.items()) and not all(tx.decays(k, p) for k, p in params.items())

    def launches(_):
        assert _build.launch_counts()["adam"] == math.ceil(len(params) / cap)
        assert profiling.counters()[adam_kernels.TENSORS_COUNTER][0] == len(params)

    _run_both(params, tx, cuda, on_step=launches)


@pytest.mark.gpu
def test_adam_kernel_over_2_31_bytes(cuda):
    """A tensor of 2^29 + 5 f32 elements (over 2^31 bytes, a ragged tail)
    beside a small one: three steps bit-equal to the plain path."""
    g = torch.Generator(cuda).manual_seed(0)
    params = {
        "embed_items.weight": torch.randn(2**29 + 5, device=cuda, generator=g) * 0.02,
        "encoder.layer_0.ffn1.weight": torch.randn(64, 3, device=cuda, generator=g),
    }
    tx = Adam(0.9, 0.999, 1e-9, mu_dtype=torch.float32)
    state = _state(params, tx, cuda)
    plain = _state(_clone(params), tx, cuda)
    for step in range(STEPS):
        grads = {k: torch.randn(p.shape, device=cuda, generator=g) for k, p in params.items()}
        state = apply_gradients(state, grads, tx, SCHEDULE)
        plain = _plain_step(tx, plain, grads)
        torch.cuda.synchronize()
        _assert_same_bits(state, plain, step)
        del grads


@pytest.mark.gpu
@pytest.mark.parametrize("kind", REFUSED + ["grad on the cpu"])
def test_adam_kernel_refuses_on_card(cuda, kind):
    """CUDA tensors the kernel does not take raise; nothing falls back to
    the plain path."""
    _build.reset_launch_counts()
    with pytest.raises(ValueError):
        adam_kernels.adam_step(**_refused(kind, cuda), **HYPER, lr_scale=torch.ones((), device=cuda))
    assert _build.launch_counts()["adam"] == 0


@pytest.mark.gpu
def test_apply_gradients_on_card_never_takes_the_plain_path(cuda, monkeypatch):
    """On the card ``apply_gradients`` launches the kernel and never calls
    ``Adam.update``; a non-contiguous gradient raises there."""
    monkeypatch.setattr(Adam, "update", lambda *a, **k: pytest.fail("the plain path ran on the card"))
    params = _ragged(cuda)
    tx = Adam(0.9, 0.999, 1e-9, mu_dtype=torch.bfloat16)
    state = _state(params, tx, cuda)
    grads = _grads(params, np.random.default_rng(0))
    _build.reset_launch_counts()
    state = apply_gradients(state, grads, tx, SCHEDULE)
    assert _build.launch_counts()["adam"] == 1
    grads["encoder.layer_0.ffn2.weight"] = grads["encoder.layer_0.ffn2.weight"].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        apply_gradients(state, grads, tx, SCHEDULE)
