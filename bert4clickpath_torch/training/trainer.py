"""Training loop with the reference's callback semantics (counterpart of
``bert4clickpath_tpu/training/trainer.py``).

* epochs of ``steps_per_epoch`` train steps;
* a validation pass per epoch (val_loss + ranking metrics), its sums
  accumulated on the device and fetched once;
* ReduceLROnPlateau(patience=10, factor=0.317) through the state's
  ``lr_scale`` field;
* EarlyStopping(patience=30) on the monitored metric;
* best-checkpoint save (synchronous, pruned to ``ckpt_keep`` after the
  commit) + best serving export;
* metric history as JSONL plus TensorBoard event files under
  ``model_dir/tensorboard`` including the effective LR.

Train losses stay on the device during an epoch and are fetched once at its
end, so no step waits for the host.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from bert4clickpath_torch.config import TrainConfig
from bert4clickpath_torch.data.pipeline import prefetch_to_device
from bert4clickpath_torch.ops import metrics as metrics_lib
from bert4clickpath_torch.training import checkpoint as ckpt_lib
from bert4clickpath_torch.training.train_state import TrainState, eval_params


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        eval_step: Callable,
        cfg: TrainConfig,
        model_dir: Optional[str] = None,
        to_device: Callable = lambda b: b,
        export_fn: Optional[Callable] = None,
        is_host0: bool = True,
        lr_fn: Optional[Callable] = None,
        tensorboard: bool = True,
        prefetch: int = 2,
        steps_per_call: int = 1,
        stack_batches: Optional[Callable] = None,
        eval_steps_per_call: int = 1,
    ):
        """
        train_step: (state, batch, generator) -> (state, loss)

        steps_per_call > 1 runs that many train steps per call:
        ``train_step`` must then be a scan step
        (train_state.make_scan_train_step) returning (K,) losses, and
        ``stack_batches`` must stack K host batches into one with a leading
        K axis (data.cloze.stack_batches): one host-to-device transfer per
        K steps. steps_per_epoch must be a multiple of steps_per_call.
        eval_step: (params, batch) -> stats dict of sums
        eval_steps_per_call > 1 feeds ``eval_step`` stacked (K, B, ...)
        chunks (``eval_step`` must then be
        make_eval_step(steps_per_call=K)); the last chunk of a pass may be
        smaller.
        to_device: ClozeBatch -> the batch dict the steps expect
        export_fn: params -> None, called when the monitored metric improves
        lr_fn: step -> base LR (the schedule); logged as ``lr`` scaled by
            the plateau ``lr_scale``
        tensorboard: also write TB event files under model_dir/tensorboard
        prefetch: keep this many batches already copied to the device; 0 to
            copy inside the step loop
        """
        self.train_step = train_step
        self.eval_step = eval_step
        self.cfg = cfg
        self.model_dir = model_dir
        self.to_device = to_device
        self.export_fn = export_fn
        self.is_host0 = is_host0
        self.lr_fn = lr_fn
        self.prefetch = prefetch
        self.steps_per_call = max(1, steps_per_call)
        self.stack_batches = stack_batches
        self.eval_steps_per_call = max(1, eval_steps_per_call)
        if self.eval_steps_per_call > 1 and stack_batches is None:
            raise ValueError("eval_steps_per_call > 1 requires stack_batches")
        if self.steps_per_call > 1:
            if stack_batches is None:
                raise ValueError("steps_per_call > 1 requires stack_batches")
            if cfg.steps_per_epoch % self.steps_per_call:
                raise ValueError(
                    f"steps_per_epoch {cfg.steps_per_epoch} not a multiple "
                    f"of steps_per_call {self.steps_per_call}"
                )
        self.history: list[dict] = []
        self._tb = None
        if tensorboard and model_dir and is_host0:
            from bert4clickpath_torch.utils.tb import EventWriter

            self._tb = EventWriter(os.path.join(model_dir, "tensorboard"))

    # -- logging ----------------------------------------------------------
    def _log(self, record: dict):
        self.history.append(record)
        if not self.is_host0:
            return
        msg = " ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
        )
        print(msg, flush=True)
        if self.model_dir:
            os.makedirs(self.model_dir, exist_ok=True)
            with open(os.path.join(self.model_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            scalars = {k: v for k, v in record.items() if k not in ("epoch", "step")}
            self._tb.scalars(scalars, record.get("step", len(self.history)))
            self._tb.flush()

    # -- evaluation -------------------------------------------------------
    def _stacked_chunks(self, batches: Iterator) -> Iterator:
        """Group host batches into stacks of eval_steps_per_call (smaller
        final chunk included) for the stacked eval step."""
        buf = []
        for b in batches:
            buf.append(b)
            if len(buf) == self.eval_steps_per_call:
                yield self.stack_batches(buf)
                buf = []
        if buf:
            yield self.stack_batches(buf)

    def _on_device(self, batches: Iterator) -> Iterator:
        if self.prefetch:
            return prefetch_to_device(batches, self.to_device, depth=self.prefetch)
        return (self.to_device(b) for b in batches)

    def evaluate(self, params, eval_batches: Iterator) -> dict[str, float]:
        if self.eval_steps_per_call > 1:
            eval_batches = self._stacked_chunks(eval_batches)
        # accumulate on the device and fetch once: a fetch per batch would
        # make every batch wait for the device
        acc = None
        for batch in self._on_device(eval_batches):
            stats = self.eval_step(params, batch)
            acc = stats if acc is None else metrics_lib.merge(acc, stats)
        if acc is None:
            return {"n": 0.0, "loss": float("nan")}
        return metrics_lib.finalize(acc)

    # -- fit --------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        train_batches: Iterator,
        eval_batches_fn: Callable[[], Iterator],
        generator: Optional[torch.Generator],
        n_epochs: Optional[int] = None,
    ) -> TrainState:
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        monitor = cfg.monitor
        if cfg.monitor_mode == "auto":
            sign = None  # resolved with the monitor at the first eval
        else:
            sign = 1.0 if cfg.monitor_mode == "min" else -1.0
        best_val = math.inf
        epochs_since_best = 0
        epochs_since_plateau_cut = 0
        spc = self.steps_per_call
        if spc > 1:
            # stack K host batches -> one (K, ...) chunk -> one transfer
            host_iter = train_batches

            def chunks():
                while True:
                    yield self.stack_batches([next(host_iter) for _ in range(spc)])

            train_batches = chunks()
        train_batches = self._on_device(train_batches)

        eval_every = max(1, getattr(cfg, "eval_every", 1))
        for epoch in range(n_epochs):
            t0 = time.monotonic()
            losses = []
            for _ in range(cfg.steps_per_epoch // spc):
                batch = next(train_batches)
                state, loss = self.train_step(state, batch, generator)
                losses.append(loss.reshape(-1))
            # one fetch per epoch, which also waits for the epoch's steps
            train_loss = float(torch.cat(losses).float().cpu().numpy().mean())
            dt = time.monotonic() - t0

            do_eval = (epoch % eval_every == 0) or (epoch == n_epochs - 1)
            record = {
                "epoch": epoch,
                "step": int(state.step),
                "train_loss": train_loss,
                "epoch_seconds": round(dt, 3),
                "lr_scale": float(state.lr_scale),
            }
            if self.lr_fn is not None:
                record["lr"] = float(np.float32(self.lr_fn(record["step"]))) * record["lr_scale"]
            if not do_eval:
                self._log(record)
                continue
            # EMA-enabled states validate and export the shadow params
            t_eval = time.monotonic()
            val = self.evaluate(eval_params(state), eval_batches_fn())
            record["eval_seconds"] = round(time.monotonic() - t_eval, 3)
            record["val_loss"] = float(val.get("loss", float("nan")))
            for k, v in val.items():
                if k not in ("loss", "n"):
                    record[f"val_{k}"] = float(v)
            self._log(record)

            if monitor == "auto":
                # full-softmax val_loss diverges while ranking still
                # improves, so prefer the ranking metric whenever the head
                # emits one
                monitor = "val_ndcg@10" if "val_ndcg@10" in record else "val_loss"
            if sign is None:  # monitor_mode == "auto": losses fall, metrics rise
                sign = 1.0 if "loss" in monitor else -1.0
            if monitor not in record:
                raise KeyError(
                    f"monitor {monitor!r} not in epoch record "
                    f"(available: {sorted(record)})"
                )
            monitored = sign * record[monitor]
            if monitored < best_val:
                best_val = monitored
                epochs_since_best = 0
                epochs_since_plateau_cut = 0
                if self.model_dir and self.is_host0:
                    ckpt_lib.save_checkpoint(
                        os.path.join(self.model_dir, "ckpts"), state, int(state.step),
                        keep=cfg.ckpt_keep,
                    )
                if self.export_fn is not None and self.is_host0:
                    self.export_fn(eval_params(state))
            else:
                epochs_since_best += 1
                epochs_since_plateau_cut += 1
                # ReduceLROnPlateau
                if epochs_since_plateau_cut >= cfg.plateau_patience:
                    state = state.replace(lr_scale=state.lr_scale * cfg.plateau_factor)
                    epochs_since_plateau_cut = 0
                # EarlyStopping
                if epochs_since_best >= cfg.early_stopping_patience:
                    self._log({"epoch": epoch, "early_stop": True})
                    break
        if self.model_dir and self.is_host0:
            ckpt_lib.wait_until_finished()
        if self._tb is not None:
            self._tb.close()
        return state
