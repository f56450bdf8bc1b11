"""The port's multi-host demo (``examples/multihost/demo_torch.py``, the
counterpart of ``examples/multihost/demo.py``; ``tests/test_multihost.py``
runs that one): 2 hosts of 4 ranks on gloo on the CPU, each rank started
with torchrun's environment, every rank's losses equal (1e-6 relative) and
falling."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "examples", "multihost", "demo_torch.py")
torch.set_num_threads(1)


def _run(*flags):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, DEMO, *flags], capture_output=True, text=True, timeout=280, env=env)


def test_two_hosts_train_and_agree():
    out = _run("--procs", "2", "--device", "cpu")
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    assert "multihost demo OK" in out.stdout
    assert "all 8 ranks agree" in out.stdout
    ranks = [line for line in out.stdout.splitlines() if line.startswith("[rank ")]
    assert len(ranks) == 8 and {line.split("] ")[1] for line in ranks} == {ranks[0].split("] ")[1]}


def test_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    out = _run("--procs", "2")
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "multihost demo OK" not in out.stdout
