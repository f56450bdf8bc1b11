"""The port's task scripts end to end on simulated data, on the CPU, in a
subprocess: the chained binary model (segment routing, segment embeddings,
``pos_weight``), the multilabel model, the transfer chain (Cloze pretrain,
then a binary head on the pretrained encoder beside one from scratch) and
the multi-variable model (trained, exported and served with dict
sessions), at the sizes of the JAX scripts' tests (``tests/test_example_cli.py``).
Each run prints ``done`` and imports nothing of JAX; without ``--device
cpu`` each script asks for the card and exits naming its absence.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
SCRIPTS = {
    "chained": (os.path.join("examples", "chained", "train_torch.py"),
                ["--n_items", "60", "--n_sessions", "200", "--max_hist", "10", "--epochs", "2", "--batch", "32"]),
    "multilabel": (os.path.join("examples", "tasks", "multilabel_torch.py"),
                   ["--n_items", "60", "--n_sessions", "200", "--max_items", "10", "--epochs", "2", "--batch", "32"]),
    # rare positives: the automatic pos_weight (neg/pos ratio of the corpus)
    "transfer": (os.path.join("examples", "bert4rec", "transfer_torch.py"),
                 ["--n_items", "60", "--n_sessions", "200", "--batch", "32", "--max_items", "10",
                  "--pretrain_steps", "12", "--finetune_steps", "6", "--pos_frac", "0.7"]),
    "multivariable": (os.path.join("examples", "bert4rec", "multivariable_torch.py"),
                      ["--epochs", "2", "--n_sessions", "400", "--n_items", "60", "--max_items", "12"]),
}


def _run(name, *extra, timeout=300):
    script, flags = SCRIPTS[name]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-c", _RUNNER, os.path.join(REPO, script), *flags, *extra],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_task_script_runs_on_the_cpu(tmp_path, name):
    run = tmp_path / name
    out = _run(name, "--device", "cpu", "--model_dir", str(run))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout and "JAX_SIDE_MODULES []" in out.stdout
    if name == "transfer":
        lines = out.stdout.splitlines()
        assert any(line.startswith("pretrain final loss") for line in lines)
        assert any(line.startswith("pos_weight=") for line in lines)
        for arm in ("scratch", "transfer"):
            line = next(x for x in lines if x.startswith(f"{arm}: loss"))
            f1 = float(line.split(" f1 ")[1].split()[0])
            assert 0.0 <= f1 <= 1.0 and " pred_pos " in line
        assert (run / "pretrained" / "params.pt").exists()
        return
    with open(run / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and all(r["val_loss"] > 0 for r in records)
    if name == "multivariable":
        assert "serving top-5: [('item_" in out.stdout
        assert all(0.0 <= r["val_recall@10"] <= 1.0 for r in records)
        assert (run / "export" / "params.pt").exists()
    else:
        # the binary counts, pooled over the classes for multilabel
        assert all(0.0 <= r["val_f1"] <= 1.0 and 0.0 <= r["val_tp"] <= r["val_positives"] for r in records)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_task_script_needs_the_card_by_default(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    out = _run(name, "--model_dir", str(tmp_path / "run"), timeout=120)
    assert out.returncode != 0 and "--device cuda: no CUDA card" in out.stderr
    assert not (tmp_path / "run").exists()
    assert "JAX_SIDE_MODULES []" in out.stdout
