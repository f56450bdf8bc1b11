"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where there is none. On a machine with a card (``--noconftest``: the
suite's conftest.py imports jax, which the port's machines need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: attention bf16 abs 2e-2, f32 abs 1e-5;
gather exact (both versions round the same f32 value once).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels.attention import mha, mha_reference
from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 53, 256, 4), (5, 13, 32, 4), (3, 200, 128, 2), (2, 7, 96, 1)])
def test_mha_kernel_matches_plain(cuda, dtype, shape):
    b, l, d, h = shape
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).to(cuda, dtype)
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    bias = torch.from_numpy(np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)).to(cuda)
    bias[0] = -1e9  # a fully padded row
    before = _build.launch_counts()["attention"]
    got = mha(q, k, v, bias, h)
    assert _build.launch_counts()["attention"] == before + 1
    want = mha_reference(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, l, d) and torch.isfinite(got).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    # contiguous inputs give the same answer as strided slices
    torch.testing.assert_close(mha(q.contiguous(), k.contiguous(), v.contiguous(), bias, h), got, atol=0, rtol=0)


def test_mha_refuses_what_one_block_cannot_hold(cuda):
    x = torch.zeros(1, 4096, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="blockwise"):
        mha(x, x, x, torch.zeros(1, 1, 1, 4096, device=cuda), 1)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 53, 256), (64, 53, 256), (3, 13, 32)])
def test_gather_kernel_matches_plain(cuda, out_dtype, shape):
    b, l, d = shape
    rng = np.random.default_rng(1)
    v = 1000
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32)).to(cuda)
    ids_np = rng.integers(0, v, size=(b, l)).astype(np.int32)
    ids_np.flat[0], ids_np.flat[-1] = 0, v - 1
    ids = torch.from_numpy(ids_np).to(cuda)
    pos = torch.from_numpy(rng.standard_normal((l, d), dtype=np.float32)).to(cuda)
    got = gather_scale_pos(table, ids, pos, d**0.5, out_dtype)
    want = gather_scale_pos_reference(table, ids, pos, d**0.5, out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_gather_traps_on_out_of_range_id():
    """An id outside [0, V) is a device-side trap, never a silent read. Run
    in a child process: the trap poisons the CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import torch\n"
        "from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos\n"
        "t = torch.zeros(10, 32, device='cuda')\n"
        "ids = torch.full((1, 4), 10, dtype=torch.int32, device='cuda')\n"
        "gather_scale_pos(t, ids, torch.zeros(4, 32, device='cuda'), 1.0)\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr or "CUDA error" in proc.stderr


def test_serving_on_card_matches_cpu(cuda, tmp_path):
    """A small bundle served on the card and on the CPU: same rankings,
    log-probs within 2e-2 (bf16 compute on both), and both kernels launched."""
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath_torch.training.checkpoint import export_serving
    from bert4clickpath_torch.training.serving import ServingModel
    from bert4clickpath_torch.vocab import Vocabulary

    sys.path.insert(0, REPO)
    from chip_smoke import seeded_state_dict

    vocab = Vocabulary([f"item_{i}" for i in range(500)])
    cfg = ModelConfig(
        features={"items": FeatureConfig(512, 64)}, num_layers=2, num_heads=4, ffn_dim=128,
        max_len=21, head=HeadConfig("tied_softmax", output_size=500), dtype="bfloat16", qkv_fused=True,
    )
    export_serving(str(tmp_path), seeded_state_dict(cfg, 0), cfg, {"items": vocab})
    gpu = ServingModel(str(tmp_path), device=cuda)
    cpu = ServingModel(str(tmp_path), device="cpu")
    sessions = [["item_1", "item_2"], [f"item_{i}" for i in range(30)], []]
    _build.reset_launch_counts()
    got = gpu.recommend(sessions, k=5)
    assert _build.launch_counts() == {"gather": 1, "attention": 2}
    want = cpu.recommend(sessions, k=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=2e-2, rtol=0)
