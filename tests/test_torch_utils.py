"""The port's utility modules and ``remat`` against the JAX package's, on
the CPU.

* ``utils/profiling.py``: ``trace`` writes a Chrome trace (its spans and
  counters: ``test_torch_tracing.py``);
* ``utils/debug.py``: ``checked``, ``assert_all_finite`` and
  ``finite_guard_step`` on a NaN and on a clean step;
* ``utils/cli.py``: ``parse_spec_args``, ``tests/test_cli_spec.py``'s cases
  against the JAX function;
* ``remat``: the loss and every gradient with ``remat=True`` bit-equal to
  ``remat=False`` in f32 (dropout off, and on through both back ends with
  the generator left where it was), and within 1e-5 (loss, relative) and
  1e-5 (gradients, absolute) of the JAX model with ``remat=True`` from
  transplanted weights.
"""

import os

import numpy as np
import pytest
import torch

from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.utils import cli as jcli
from bert4clickpath_torch.config import ModelConfig, TrainConfig
from bert4clickpath_torch.convert import flax_from_state_dict
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts
from bert4clickpath_torch.utils import cli, debug, profiling

from test_torch_train import N_ITEMS, _assert_tree_close, _host_batches, _jax_batch, _jax_grads, _jcfg, _port_model
from test_torch_train import _seeded_params

torch.set_num_threads(1)


# -- profiling ----------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    assert (tmp_path / files[0]).stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


# -- debug ----------------------------------------------------------------------


def test_checked_raises_on_nan():
    f = debug.checked(lambda x: torch.log(x))  # log(-1) -> nan
    assert torch.isfinite(f(torch.tensor(2.0)))
    with pytest.raises(FloatingPointError):
        f(torch.tensor(-1.0))


def test_checked_raises_inside_a_module():
    """A module's non-finite output raises where it happens, though the
    function's own output is finite; the hook is gone afterwards."""
    lin = torch.nn.Linear(3, 3)
    with torch.no_grad():
        lin.weight.fill_(float("inf"))
    f = debug.checked(lambda x: torch.nan_to_num(lin(x)))
    with pytest.raises(FloatingPointError, match="Linear"):
        f(torch.ones(2, 3))
    assert torch.isfinite(torch.nan_to_num(lin(torch.ones(2, 3)))).all()  # unwrapped: no hook left


def test_checked_passes_a_clean_step():
    """A real train step under ``checked`` runs and returns its state."""
    jcfg = _jcfg()
    model = _port_model(jcfg, _seeded_params(JModel(jcfg), _jax_batch(_host_batches(1)[0])))
    tx = tts.make_optimizer(TrainConfig())
    step = debug.checked(tts.make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=N_ITEMS))
    state, loss = step(tts.TrainState.create(dict(model.named_parameters()), tx), to_device(_host_batches(1)[0], "cpu"))
    assert state.step == 1 and torch.isfinite(loss)


def test_assert_all_finite():
    debug.assert_all_finite({"a": torch.ones(3), "b": [np.ones(2)]})
    with pytest.raises(FloatingPointError, match=r"params\['a'\]"):
        debug.assert_all_finite({"a": torch.tensor([1.0, float("nan")])}, "params")
    with pytest.raises(FloatingPointError):
        debug.assert_all_finite({"b": [np.array([np.inf])]})


def test_finite_guard_step():
    class S:
        step = 3

    guarded = debug.finite_guard_step(lambda state, batch, *rest: (state, torch.tensor(float("inf"))))
    with pytest.raises(FloatingPointError, match="at step 3"):
        guarded(S(), None, None)
    fine = debug.finite_guard_step(lambda state, batch, *rest: (state, torch.tensor(1.5)))
    assert fine(S(), None)[1].item() == 1.5


# -- cli --------------------------------------------------------------------------


CLI_CASES = {
    "defaults": ({"lr": 1e-3, "steps": 100, "name": "run"}, []),
    "overrides": ({"lr": 1e-3, "steps": 100, "name": "run"}, ["--lr", "0.01", "--steps", "5"]),
    "required type": ({"gamma": float}, ["--gamma", "2.5"]),
    "bool switches default": ({"silent": True, "verbose": False}, []),
    "bool switches set": ({"silent": True, "verbose": False}, ["-silent", "-verbose"]),
    "none default": ({"ckpt": None}, []),
    "none set": ({"ckpt": None}, ["--ckpt", "/x"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_parse_spec_args_equals_jax(case):
    spec, argv = CLI_CASES[case]
    assert cli.parse_spec_args(spec, argv) == jcli.parse_spec_args(spec, argv)


def test_parse_spec_args_required_missing():
    with pytest.raises(SystemExit):
        cli.parse_spec_args({"gamma": float}, [])


# -- remat --------------------------------------------------------------------------


def _loss_and_grads(jcfg, params, remat: bool, generator=None, dropout_impl="mask"):
    cfg = ModelConfig.from_json(jcfg.to_json())
    model = ClickstreamModel(cfg, device="cpu", remat=remat, dropout_impl=dropout_impl)
    model.load_state_dict(_port_model(jcfg, params).state_dict())
    batch = to_device(_host_batches(1)[0], "cpu")
    loss = tts.make_loss_fn(model, fused_ce_num_valid=N_ITEMS)(batch, generator)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return cfg, loss, dict(zip(names, grads))


@pytest.mark.parametrize("dropout_impl", [None, "mask", "fused"])
def test_remat_is_bit_equal(dropout_impl):
    """f32 on the CPU: the loss and every gradient with remat bit-equal to
    without; with dropout live, the recompute draws the same masks and the
    generator ends where the step without remat leaves it."""
    jcfg = _jcfg(dropout_rate=0.0 if dropout_impl is None else 0.1)
    params = _seeded_params(JModel(jcfg), _jax_batch(_host_batches(1)[0]))
    runs = []
    for remat in (False, True):
        gen = None if dropout_impl is None else torch.Generator().manual_seed(5)
        _, loss, grads = _loss_and_grads(jcfg, params, remat, gen, dropout_impl or "mask")
        runs.append((loss, grads, None if gen is None else gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    if s0 is not None:
        assert torch.equal(s0, s1)


def test_remat_matches_jax_remat():
    """The port's remat model against the JAX model with ``remat=True`` from
    transplanted weights: loss within 1e-5 relative, every gradient within
    1e-5 absolute."""
    jcfg = _jcfg()
    jb = _jax_batch(_host_batches(1)[0])
    jmodel = JModel(jcfg, attn_impl="pallas", embed_impl="pallas", remat=True)
    params = _seeded_params(jmodel, jb)
    jloss, jgrads = _jax_grads(jmodel, params, jb, N_ITEMS, True)
    cfg, loss, grads = _loss_and_grads(jcfg, params, remat=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(flax_from_state_dict(cfg, grads), jgrads, 0, 1e-5, "remat grads")
