"""Multi-host SPMD demo of the PyTorch port: N hosts of 4 ranks, one mesh,
sharded training.

The counterpart of ``examples/multihost/demo.py``: every host owns 4 ranks
(the JAX demo's 4 devices a process), the (data = 2 N, model = 2) mesh
spans all of them, each host feeds only its own slice of the sessions
(``ClozeDataset(process_index=host, process_count=N)``) and each rank takes
its data index's rows of its host's batch; the vocab-sharded train step's
sums cross hosts through ``torch.distributed``. Each rank is started as
``torchrun --nnodes N --nproc_per_node 4`` starts it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so the
world forms through ``parallel/mesh.py:initialize_distributed``.

  python3 examples/multihost/demo_torch.py --procs 2
  python3 examples/multihost/demo_torch.py --procs 2 --device cpu

On the card (the default) every rank shares the one card over gloo (NCCL
refuses two ranks on one device); ``--device cpu`` runs gloo on the CPU.
The script starts the ranks itself, checks that every rank reports the same
losses (1e-6 relative) and that they fall, and prints ``multihost demo
OK``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, REPO)

RANKS_PER_HOST = 4  # demo.py gives each process 4 devices
STEPS = 5


def worker(procs: int, device: str) -> None:
    import numpy as np
    import torch

    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, MeshConfig, ModelConfig, TrainConfig
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset
    from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
    from bert4clickpath_torch.parallel import spmd
    from bert4clickpath_torch.parallel.mesh import initialize_distributed, make_mesh
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_optimizer

    torch.set_num_threads(1)
    rank, world, dev = initialize_distributed(device, share_card=True)
    if world != RANKS_PER_HOST * procs:
        raise RuntimeError(f"world of {world} ranks, want {RANKS_PER_HOST * procs}")
    host = rank // RANKS_PER_HOST
    mesh = make_mesh(MeshConfig(data=procs * 2, model=2), dev)

    gen = ClickStreamGenerator(n_items=40, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    # each host holds only ITS slice of the data
    ds = ClozeDataset(items, vocab, max_items=20, process_index=host, process_count=procs, backend="numpy")
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 2, kernel_tile=32)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        head=HeadConfig("tied_softmax"),
    )
    per_host_batch = 16 // procs * 2  # global batch 32 over data = 2 procs
    # a host's ranks hold data indices host * 2 and host * 2 + 1: each takes
    # its rows of the host batch
    per_rank = per_host_batch // (mesh.data_size // procs)
    lo = (mesh.data_index - host * (mesh.data_size // procs)) * per_rank

    def rank_rows(b) -> dict:
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a[lo : lo + per_rank])).to(dev)  # noqa: E731
        return {"features": {k: put(v) for k, v in b.features.items()}, "head_positions": put(b.head_positions),
                "labels": put(b.labels)}

    model = ClickstreamModel(cfg, device=dev)
    model.load_state_dict(init_state_dict(cfg, 0))  # the same weights on every rank
    tx = make_optimizer(TrainConfig())
    state = spmd.shard_state(TrainState.create(dict(model.named_parameters()), tx), model, mesh)
    step = spmd.make_spmd_train_step(model, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size)
    it = ds.train_batches(per_host_batch, seed=host + 1)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, rank_rows(next(it)))
        losses.append(float(loss))
    print(f"[rank {rank} host {host} data {mesh.data_index} model {mesh.model_index}] losses: "
          f"{[round(v, 4) for v in losses]}", flush=True)
    print("LOSSES " + json.dumps({"rank": rank, "losses": losses}), flush=True)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2, help="hosts, of 4 ranks each")
    p.add_argument("--port", type=int, default=0, help="0: a free one")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.procs, args.device)
        return
    if args.device == "cuda":
        import torch

        from bert4clickpath_torch.ops.kernels import _build

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu")
        _build.library()  # built once here, loaded by every rank
    port = args.port or _free_port()
    world = RANKS_PER_HOST * args.procs
    ranks = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % RANKS_PER_HOST),
                   LOCAL_WORLD_SIZE=str(RANKS_PER_HOST), GROUP_RANK=str(rank // RANKS_PER_HOST),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        ranks.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "--procs", str(args.procs), "--device",
             args.device], env=env, stdout=subprocess.PIPE, text=True))
    try:
        outs = [r.communicate(timeout=600)[0] for r in ranks]
    finally:
        for r in ranks:
            if r.poll() is None:
                r.kill()
                r.wait()
    codes = [r.returncode for r in ranks]
    for out in outs:
        sys.stdout.write("".join(line + "\n" for line in out.splitlines() if not line.startswith("LOSSES ")))
    if any(codes):
        raise SystemExit(f"ranks exited with {codes}")
    import numpy as np

    got = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("LOSSES "):
                rec = json.loads(line[len("LOSSES "):])
                got[rec["rank"]] = np.asarray(rec["losses"])
    if sorted(got) != list(range(world)):
        raise SystemExit(f"losses from ranks {sorted(got)}, want all {world}")
    first = got[0]
    for rank, losses in got.items():
        if not np.allclose(losses, first, rtol=1e-6, atol=0):
            raise SystemExit(f"rank {rank} disagrees: {losses} against {first}")
    if not first[-1] < first[0]:
        raise SystemExit(f"did not learn: {first}")
    print(f"all {world} ranks agree: {[round(float(v), 4) for v in first]}")
    print("multihost demo OK")


if __name__ == "__main__":
    main()
