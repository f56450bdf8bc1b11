"""End-to-end runs of the port's training CLI on simulated data, on the CPU,
in a subprocess: both presets train, resume and export; ``ServingModel``
loads the export; the flags the port cannot honour (or the support matrix
refuses) exit with their message; and the subprocess never imports jax or
the JAX package.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bert4clickpath_torch.training import checkpoint as tckpt
from bert4clickpath_torch.training.serving import ServingModel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "bert4rec", "train_torch.py")
# run the script's main, then report any JAX-side module that got imported
_RUNNER = (
    "import runpy, sys\n"
    "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bert4clickpath_tpu'))\n"
    "    print('JAX_SIDE_MODULES', bad, flush=True)\n"
)
BASE = ["--simulated", "--n_items", "40", "--n_sessions", "300", "--batch", "32", "--eval_batches", "2",
        "--max_items", "20", "--device", "cpu"]


def _run(model_dir, *extra, timeout=420):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-c", _RUNNER, SCRIPT, *BASE, "--model_dir", str(model_dir), *extra],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def _history(model_dir):
    with open(os.path.join(model_dir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("preset,extra", [
    # the wide-model flags at a small width, a stacked eval step with a ragged tail
    ("tpu", ["--d_model", "32", "--layers", "1", "--heads", "2", "--qkv_fused", "--mu_dtype", "bfloat16",
             "--eval_steps_per_call", "2", "--ema_decay", "0.9"]),
    ("parity", []),
    # the MLP head through the fused CE and the chunked scan, pre-LN, the fused dropout's plain version
    ("parity", ["--fused_head", "--norm_style", "pre", "--head_dims", "64,32", "--dropout_impl", "fused",
                "--steps_per_call", "3", "--schedule", "warmup_constant", "--warmup_steps", "5"]),
])
def test_train_cli_trains_resumes_and_exports(tmp_path, preset, extra):
    run = tmp_path / preset
    out = _run(run, "--preset", preset, "--epochs", "2", "--ckpt_keep", "1", *extra)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout and "JAX_SIDE_MODULES []" in out.stdout
    records = _history(run)
    assert len(records) == 2 and records[1]["step"] == 2 * records[0]["step"]
    assert all(0.0 <= r["val_recall@10"] <= 1.0 and r["val_loss"] > 0 for r in records)
    ckpts = os.listdir(run / "ckpts")
    assert len(ckpts) == 1 and (run / "ckpts" / ckpts[0] / tckpt.STATE_FILE).exists()
    assert (run / "export" / "model_config.json").exists()
    saved_step = int(ckpts[0].split("_")[1])

    out = _run(run, "--preset", preset, "--epochs", "1", "--ckpt_keep", "1", "--resume", *extra)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"at step {saved_step}" in out.stdout and "JAX_SIDE_MODULES []" in out.stdout
    resumed = _history(run)[2]
    assert resumed["step"] == saved_step + records[0]["step"]

    served = ServingModel(str(run / "export"), device="cpu")
    res = served.recommend([["item_1", "item_2", "item_3"], ["item_7"]], k=5)
    assert len(res) == 2 and all(len(r) == 5 and r[0][0].startswith("item_") for r in res)


def test_resumed_run_draws_fresh_dropout_masks(tmp_path):
    """``--resume`` at step N seeds the dropout generator from (seed, N): the
    first resumed step's mask differs from step 0's, and two resumes from the
    same checkpoint draw the same masks (and so log the same train loss)."""
    from bert4clickpath_torch.models.encoder import apply_dropout

    spec = importlib.util.spec_from_file_location("train_torch_in_process", SCRIPT)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    seen = []

    class Recording(cli.Trainer):
        def fit(self, state, batches, eval_fn, generator):
            first = torch.Generator("cpu").manual_seed(generator.initial_seed())
            mask = apply_dropout(torch.ones(4, 64), 0.1, first, "mask") != 0
            seen.append((int(state.step), generator.initial_seed(), mask))
            return super().fit(state, batches, eval_fn, generator)

    cli.Trainer = Recording
    flags = ["--preset", "tpu", "--d_model", "32", "--layers", "1", "--heads", "2", "--qkv_fused", "--seed", "5",
             "--epochs", "1", "--ckpt_keep", "1"]
    a, b = tmp_path / "a", tmp_path / "b"
    cli.main([*BASE, *flags, "--model_dir", str(a)])
    shutil.copytree(a, b)
    for run in (a, b):
        cli.main([*BASE, *flags, "--model_dir", str(run), "--resume"])
    (step0, seed0, mask0), (step_a, seed_a, mask_a), (step_b, seed_b, mask_b) = seen
    assert step0 == 0 and seed0 == 5 + 2  # a fresh run keeps its seed
    assert step_a == step_b == _history(a)[0]["step"] > 0
    assert seed_a == seed_b != seed0
    assert torch.equal(mask_a, mask_b) and not torch.equal(mask_a, mask0)
    assert not mask0.all() and not mask_a.all()  # dropout is on
    assert _history(a)[1]["train_loss"] == _history(b)[1]["train_loss"]


def test_init_ckpt_warm_starts_the_encoder(tmp_path):
    out = _run(tmp_path / "a", "--preset", "tpu", "--d_model", "32", "--layers", "1", "--heads", "2", "--epochs", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    out = _run(tmp_path / "b", "--preset", "tpu", "--d_model", "32", "--layers", "1", "--heads", "2", "--epochs", "1",
               "--lr", "0", "--init_ckpt", str(tmp_path / "a" / "export"))
    assert out.returncode == 0, out.stderr[-2000:]
    a = torch.load(tmp_path / "a" / "export" / tckpt.PARAMS_FILE, weights_only=True)
    b = torch.load(tmp_path / "b" / "export" / tckpt.PARAMS_FILE, weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)  # lr 0: run b exports what it loaded


@pytest.mark.parametrize("flags,message", [
    (["--parallel", "dp", "--sampled_softmax", "64"], "tier 'dp' rejects 'sampled'"),
    (["--preset", "parity", "--sampled_softmax", "64"], "--sampled_softmax requires a softmax-family head"),
    (["--attn_impl", "xla"], "--attn_impl xla: the port has the kernel path only"),
    (["--attn_impl", "auto"], "--attn_impl auto: the port has the kernel path only"),
    (["--steps_per_call", "4"], "--steps_per_call 4 does not divide steps_per_epoch 9"),
])
def test_unported_flags_are_refused_by_name(tmp_path, flags, message):
    out = _run(tmp_path / "run", "--preset", "tpu", "--d_model", "32", "--heads", "2", "--epochs", "1", *flags,
               timeout=120)
    assert out.returncode != 0
    assert message in out.stderr
    assert not (tmp_path / "run").exists()  # refused before anything was built
    assert "JAX_SIDE_MODULES []" in out.stdout


def test_cuda_is_the_default_and_is_not_replaced_by_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, SCRIPT, "--simulated", "--n_items", "40", "--n_sessions", "100", "--model_dir",
         str(tmp_path / "run"), "--epochs", "1"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert out.returncode != 0 and "--device cuda: no CUDA card" in out.stderr
    assert not (tmp_path / "run").exists()
