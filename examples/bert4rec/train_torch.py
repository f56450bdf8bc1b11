"""BERT4Rec-on-Amazon-Beauty training script of the PyTorch port.

Counterpart of ``examples/bert4rec/train.py``, single device: leave-one-out
Cloze training over beauty.txt (or simulated sessions) with recall@k /
NDCG@k eval against the full catalog, through
``bert4clickpath_torch.training.trainer.Trainer``.

Two model presets, as in the JAX script:
* ``--preset parity`` — the reference configuration: 2 layers, 2 heads,
  d_model 64, ffn 100, dropout 0.1, MLP softmax head [1024,512,256,128],
  Adam 1e-3, sinusoidal positions.
* ``--preset tpu`` — the flagship: 4L/256d bf16, learned positions,
  tied-weight softmax head trained through the fused CE kernels.

Runs on the CUDA card (``--device cuda``, the default, which raises where
there is none) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions). ``--attn_impl xla|auto`` is refused by name (attention
always runs the hand-written kernels, the JAX script's ``pallas``), and the
support matrix (``bert4clickpath_torch/parallel/support.py``) refuses what
it refuses, before any step is built.

``--sampled_softmax S`` trains the softmax-family heads on S batch-shared
uniform negatives a step (eval stays exact). ``--parallel dp`` (or
``auto`` under ``torchrun`` with more than one process) trains
data-parallel, one process per card: each rank takes its rows of every
global batch (``--batch`` and the eval batch must divide by the world
size), the gradients and eval sums are summed over the world, and only rank
0 writes the history, checkpoints and the export.

Usage:
  python examples/bert4rec/train_torch.py --data beauty.txt \
      --model_dir runs/run1 --preset parity --epochs 200
  python examples/bert4rec/train_torch.py --simulated --n_items 1000 \
      --model_dir runs/sim --preset tpu --device cpu --epochs 2
  torchrun --nproc_per_node=2 examples/bert4rec/train_torch.py --parallel dp \
      --simulated --model_dir runs/dp --preset tpu
"""

from __future__ import annotations

import argparse
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.data.beauty import load_beauty
from bert4clickpath_torch.data.cloze import stack_batches
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import initialize_distributed, make_mesh
from bert4clickpath_torch.parallel.support import validate_tier
from bert4clickpath_torch.training import checkpoint as ckpt_lib
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_optimizer,
    make_scan_train_step,
    make_train_step,
)
from bert4clickpath_torch.training.trainer import Trainer


def build_model_config(preset: str, vocab, args) -> ModelConfig:
    head_dims = tuple(int(x) for x in args.head_dims.split(",") if x)
    if preset == "parity":
        # reference defaults unless overridden; --parity_scale lifts the
        # encoder to the --d_model/--layers/--heads shape while keeping the
        # reference MLP softmax head
        scaled = args.parity_scale
        d = args.d_model if scaled else 64
        return ModelConfig(
            features={"items": FeatureConfig(vocab.model_vocab_size, d)},
            num_layers=args.layers if scaled else 2,
            num_heads=args.heads if scaled else 2,
            ffn_dim=4 * d if scaled else 100,
            dropout_rate=args.dropout,
            max_len=args.max_items + 3,
            positional="sinusoidal",
            head=HeadConfig("softmax", head_dims or (1024, 512, 256, 128), vocab.label_vocab_size),
            dtype=args.dtype or ("bfloat16" if scaled else "float32"),
            qkv_fused=args.qkv_fused,
            norm_style=args.norm_style,
        )
    if preset == "tpu":
        embed_dim = args.embed_dim or args.d_model
        return ModelConfig(
            # rows padded as the fused CE and the chunked eval scan want them
            features={"items": FeatureConfig(padded_rows(vocab.model_vocab_size), embed_dim)},
            # factorized input when table dim < encoder width (ALBERT-style)
            encoder_dim=args.d_model if embed_dim != args.d_model else 0,
            num_layers=args.layers,
            num_heads=args.heads,
            ffn_dim=4 * args.d_model,
            dropout_rate=args.dropout,
            max_len=args.max_items + 3,
            positional="learned",
            # output_size pins V so padded rows never enter dense logits
            head=HeadConfig(
                "tied_softmax", dense_dims=head_dims, output_size=vocab.label_vocab_size,
                tied_bias=args.tied_bias,
            ),
            dtype=args.dtype or "bfloat16",
            qkv_fused=args.qkv_fused,
            norm_style=args.norm_style,
        )
    raise ValueError(preset)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="beauty.txt", help="beauty.txt, or a prepared directory of packed shards")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--preset", choices=["parity", "tpu"], default="parity")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card (raises where there is none); cpu: the kernels' plain versions")
    p.add_argument("--dtype", default="", choices=["", "float32", "bfloat16"],
                   help="override the preset's activation dtype")
    p.add_argument("--parity_scale", action="store_true",
                   help="parity preset: scale the encoder to --d_model/--layers/--heads "
                   "(bf16) while keeping the reference MLP softmax head")
    p.add_argument("--simulated", action="store_true")
    p.add_argument("--n_items", type=int, default=1000)
    p.add_argument("--n_sessions", type=int, default=20000)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument("--mask_pct", type=float, default=0.0, help="Cloze mask rate (0 = reference default 0.4)")
    p.add_argument("--max_masked", type=int, default=10, help="mask-slot cap P")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = one full pass")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--embed_dim", type=int, default=0,
                   help="tpu preset: item-table dim (0 = d_model); when smaller, a "
                   "factorized input projection feeds the d_model-wide encoder")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--dropout_impl", default="mask", choices=["mask", "fused"],
                   help="mask: torch.rand keep masks; fused: the dropout kernel")
    p.add_argument("--head_dims", default="",
                   help="comma dims for the head MLP: the tied-head transform (tpu preset) "
                   "or the parity softmax head's dense stack (default 1024,512,256,128)")
    p.add_argument("--norm_style", default="post", choices=["post", "pre"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampled_softmax", type=int, default=0,
                   help="train on N batch-shared uniform negatives instead of the full catalog "
                   "(softmax-family heads through the fused path; eval stays exact); 0 = off")
    p.add_argument("--qkv_fused", action="store_true", help="single (D, 3D) QKV projection")
    p.add_argument("--eval_batches", type=int, default=0, help="0 = full eval")
    p.add_argument("--eval_batch", type=int, default=0, help="0 = --batch")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run the full-catalog eval every N epochs (patience counters "
                   "advance only on evaluated epochs)")
    p.add_argument("--parallel", default="auto", choices=["auto", "none", "dp"],
                   help="dp: data-parallel over the torchrun world (one process per card); "
                   "auto: dp when WORLD_SIZE > 1; none: one device")
    p.add_argument("--steps_per_call", type=int, default=-1,
                   help="train steps per call over one stacked host-to-device transfer; -1: 1")
    p.add_argument("--mu_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="Adam first-moment dtype; bfloat16 halves its memory traffic")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of params for eval/export (e.g. 0.999; 0 disables). "
                   "Resume requires the checkpoint to carry the same EMA setting.")
    p.add_argument("--attn_impl", default="pallas", choices=["xla", "pallas", "auto"],
                   help="pallas: the hand-written attention kernels (whole-row at short L, "
                   "blockwise at long L); xla and auto are not ported: refused")
    p.add_argument("--tied_bias", action="store_true",
                   help="tpu preset: free per-item output bias on the tied head")
    p.add_argument("--fused_head", action="store_true",
                   help="parity/MLP softmax head: train and eval through the fused CE / "
                   "chunked catalog scan (no dense (B,P,V) logits)")
    p.add_argument("--init_ckpt", default=None,
                   help="warm-start the encoder and embeddings from a params.pt (or an export directory)")
    p.add_argument("--resume", action="store_true",
                   help="resume full state from the latest checkpoint in model_dir/ckpts")
    p.add_argument("--monitor", default="val_ndcg@10")
    p.add_argument("--monitor_mode", default="auto", choices=["auto", "min", "max"])
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--plateau_patience", type=int, default=10)
    p.add_argument("--eval_steps_per_call", type=int, default=1,
                   help="eval batches per call of the eval step (a loop over a stacked batch)")
    p.add_argument("--ckpt_keep", type=int, default=0,
                   help="retain at most N best-so-far checkpoints (0 = keep all)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--wd_tables", action="store_true",
                   help="extend --weight_decay to embedding tables / learned positions")
    p.add_argument("--schedule", default="constant", choices=["constant", "rsqrt_warmup", "warmup_constant"])
    p.add_argument("--warmup_steps", type=int, default=4000)
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Exit with a message naming the first flag the port cannot honour yet."""
    if args.attn_impl != "pallas":
        raise SystemExit(
            f"--attn_impl {args.attn_impl}: the port has the kernel path only (--attn_impl pallas)"
        )


def load_sequences(args):
    if args.simulated:
        gen = ClickStreamGenerator(n_items=args.n_items, session_cohesiveness=200, seed=args.seed)
        sequences, _ = gen.generate_sessions(args.n_sessions)
        return sequences, gen.item_vocab()
    if os.path.isdir(args.data):
        # prepared directory (packed npz shards + vocab): prep once, train many
        from bert4clickpath_torch.data import etl
        from bert4clickpath_torch.vocab import Vocabulary

        vocab = Vocabulary.from_file(os.path.join(args.data, "vocabs", "item_vocab.txt"))
        sequences = etl.read_packed(os.path.join(args.data, "sequences_*.npz"))
        if not sequences:
            raise SystemExit(f"no sequences_*.npz shards under {args.data}")
        too_long = max(len(s) for s in sequences)
        if too_long > args.max_items:
            raise SystemExit(
                f"prepared sequences up to {too_long} items exceed --max_items {args.max_items}; "
                "re-run prepare_data or raise the flag"
            )
        return sequences, vocab
    return load_beauty(args.data, max_seq_len=args.max_items)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card (torch.cuda.is_available() is False); pass --device cpu")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    use_dp = args.parallel == "dp" or (args.parallel == "auto" and world > 1)
    if world > 1 and not use_dp:
        raise SystemExit(f"--parallel none under a world of {world}: one process trains alone")
    device = torch.device(args.device)
    mesh, rank = None, 0
    if use_dp:
        # under torchrun, or a world of one
        rank, world, device = initialize_distributed(args.device)
        mesh = make_mesh(None, device)
    if rank:
        # one voice: only rank 0 prints, writes the history, checkpoints
        # and the export (the Trainer's is_host0)
        sys.stdout = open(os.devnull, "w")

    sequences, vocab = load_sequences(args)
    print(f"sequences={len(sequences)} items={vocab.size}", flush=True)
    ds = ClozeDataset(
        sequences, vocab, max_items=args.max_items, max_masked=args.max_masked,
        masked_percentage=args.mask_pct or None,
    )
    cfg = build_model_config(args.preset, vocab, args)
    # tied heads train through the fused CE (no dense logits); --fused_head
    # opts the parity MLP head into the same kernels
    fused_num_valid = (
        vocab.label_vocab_size
        if cfg.head.kind == "tied_softmax" or (cfg.head.kind == "softmax" and args.fused_head)
        else None
    )
    # against the support matrix, before any step is built
    try:
        validate_tier(
            "dp" if use_dp else "single", cfg.head.kind, attn_impl=args.attn_impl,
            dropout_impl="pallas" if args.dropout_impl == "fused" else "xla",
            qkv_fused=cfg.qkv_fused, sampled=args.sampled_softmax,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    if args.sampled_softmax and not fused_num_valid:
        raise SystemExit("--sampled_softmax requires a softmax-family head (tied preset or --fused_head)")
    steps_per_epoch = args.steps_per_epoch or max(1, len(ds) // args.batch)
    tcfg = TrainConfig(
        batch_size=args.batch,
        learning_rate=args.lr,
        n_epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        validation_steps=args.eval_batches,
        seed=args.seed,
        monitor=args.monitor,
        monitor_mode=args.monitor_mode,
        early_stopping_patience=args.patience,
        plateau_patience=args.plateau_patience,
        eval_every=args.eval_every,
        eval_batch_size=args.eval_batch,
        ckpt_keep=args.ckpt_keep,
    )

    model = ClickstreamModel(cfg, device=device, dropout_impl=args.dropout_impl)
    model.load_state_dict(init_state_dict(cfg, args.seed))
    params = dict(model.named_parameters())
    if args.init_ckpt:
        restored = ckpt_lib.restore_encoder(args.init_ckpt, params)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored[name])
    n_params = sum(p.numel() for p in params.values())
    print(f"model={args.preset} d_model={cfg.d_model} params={n_params:,} device={device}", flush=True)

    tx = make_optimizer(
        tcfg, mu_dtype=getattr(torch, args.mu_dtype), weight_decay=args.weight_decay,
        decay_tables=args.wd_tables,
    )
    state = TrainState.create(params, tx, ema=args.ema_decay > 0)
    if args.resume:
        latest = ckpt_lib.latest_checkpoint(os.path.join(args.model_dir, "ckpts"))
        if latest:
            state = ckpt_lib.restore_state(latest, state)
            print(f"resumed from {latest} at step {int(state.step)}", flush=True)
    if args.schedule == "rsqrt_warmup":
        # Vaswani schedule scaled so the post-warmup peak equals --lr
        peak = (cfg.d_model * args.warmup_steps) ** -0.5
        schedule = schedules.rsqrt_warmup(cfg.d_model, args.warmup_steps, scale=tcfg.learning_rate / peak)
    elif args.schedule == "warmup_constant":
        schedule = schedules.warmup_constant(tcfg.learning_rate, args.warmup_steps)
    else:
        schedule = schedules.constant(tcfg.learning_rate)
    spc = args.steps_per_call
    if spc < 0:
        spc = 1
    elif spc > 1 and steps_per_epoch % spc:
        raise SystemExit(f"--steps_per_call {spc} does not divide steps_per_epoch {steps_per_epoch}")
    espc = max(1, args.eval_steps_per_call)
    eval_bs = args.eval_batch or args.batch
    if spc > 1:
        print(f"scan train step: {spc} steps/call", flush=True)
    if use_dp:
        if args.batch % world or eval_bs % world:
            raise SystemExit(
                f"--parallel dp: batch {args.batch} and eval batch {eval_bs} must divide over {world} ranks"
            )
        espc = 1  # DP evaluates a batch a call
        state = spmd.replicate_state(state, mesh)
        train_step = spmd.make_dp_train_step(
            model, mesh, tx, schedule, ema_decay=args.ema_decay, fused_ce_num_valid=fused_num_valid,
            steps_per_call=spc,
        )
        eval_step = spmd.make_dp_eval_step(model, mesh, ks=(5, 10), chunked_num_valid=fused_num_valid)
        shard = spmd.shard_stacked_batch if spc > 1 else spmd.shard_batch
        batch_to_device = lambda b: shard(to_device(b, device), mesh)  # noqa: E731
        print(f"data-parallel over {world} ranks", flush=True)
    else:
        make_step = make_scan_train_step if spc > 1 else make_train_step
        sampled = {}
        if args.sampled_softmax:
            sampled = dict(
                sampled_softmax_samples=args.sampled_softmax,
                negatives_generator=dropout_generator(device, args.seed + 3, int(state.step)),
            )
            print(f"sampled softmax: {args.sampled_softmax} negatives a step", flush=True)
        train_step = make_step(
            model, tx, schedule, fused_ce_num_valid=fused_num_valid, ema_decay=args.ema_decay, **sampled
        )
        # tied heads (and --fused_head MLP heads) evaluate via the chunked
        # blinded catalog scan
        eval_step = make_eval_step(model, ks=(5, 10), chunked_num_valid=fused_num_valid, steps_per_call=espc)
        batch_to_device = lambda b: to_device(b, device)  # noqa: E731
    if espc > 1:
        print(f"stacked eval step: {espc} batches/call", flush=True)

    def export_fn(best_params):
        ckpt_lib.export_serving(os.path.join(args.model_dir, "export"), best_params, cfg, {"items": vocab})

    trainer = Trainer(
        train_step,
        eval_step,
        tcfg,
        model_dir=args.model_dir,
        to_device=batch_to_device,
        export_fn=export_fn,
        is_host0=rank == 0,
        lr_fn=schedule,
        steps_per_call=spc,
        stack_batches=stack_batches if spc > 1 or espc > 1 else None,
        eval_steps_per_call=espc,
    )
    eval_limit = args.eval_batches or None
    # a resumed run folds its restored step in: fresh masks, not step 0's;
    # data ranks draw apart
    step0 = int(state.step)
    generator = (
        spmd.tier_generator(mesh, args.seed + 2, step0) if use_dp else dropout_generator(device, args.seed + 2, step0)
    )
    state = trainer.fit(
        state,
        ds.train_batches(args.batch, seed=args.seed + 1),
        lambda: ds.eval_batches(eval_bs, limit_batches=eval_limit),
        generator,
    )
    print("done", flush=True)
    if use_dp:
        torch.distributed.destroy_process_group()
        if rank:
            sys.stdout.close()
            sys.stdout = sys.__stdout__
    # for a caller that drives the run in its own process
    return types.SimpleNamespace(trainer=trainer, state=state, model=model, dataset=ds, vocab=vocab)


if __name__ == "__main__":
    main()
