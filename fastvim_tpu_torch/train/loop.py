"""Epoch training loop: steps/sec, eval of the raw and the EMA weights,
CSV and TensorBoard logs, checkpoints and resume.

Counterpart of ``fastvim_tpu/train/loop.py``. The host loader's batches
are NHWC numpy arrays; the loop moves them to the model's device (from
pinned memory, without blocking, on the card). The per-step metrics stay
on the device and are summed there, with one transfer at the end of an
epoch, and so are the eval metrics. On resume the loop restores the
state from the newest checkpoint, drops the log rows of the epochs it
runs again and sets the loader's epoch, so that a resumed run sees the
batches an uninterrupted one would.

Each epoch's training runs under ``torch.profiler.record_function(
"train_epoch")``: a profiler trace reads the device's idle share over
that span.

Over several ``torchrun`` ranks the train metrics come from the steps
already averaged over ranks; each rank evaluates its share of the val
batches and the weighted sums are added over ranks; rank 0 alone writes
``log.csv``, ``tb/`` and the checkpoints, and every rank waits for the
checkpoint (a barrier), so that each resumes from the same file.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch

from fastvim_tpu_torch.parallel import barrier, gather_objects, is_writer
from fastvim_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)


class CSVLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fieldnames = None

    def log(self, row: Dict[str, Any]):
        row = {k: (float(v) if hasattr(v, "item") else v)
               for k, v in row.items()}
        write_header = self._fieldnames is None
        if write_header:
            self._fieldnames = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames,
                               extrasaction="ignore")
            if write_header and f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    def truncate_from(self, value: int, column: str = "epoch"):
        """Drop rows whose ``column`` is >= ``value`` (crash-resume re-runs
        them).

        A row is logged before its checkpoint finishes writing, so a crash
        between the two leaves a logged epoch (or eval) whose state was
        lost; on resume it runs again and would otherwise appear twice in
        the log.
        """
        if not os.path.exists(self.path):
            return
        with open(self.path, newline="") as f:
            rows = list(csv.DictReader(f))
        kept = [r for r in rows if int(float(r[column])) < value]
        if len(kept) == len(rows):
            return
        with open(self.path, "w", newline="") as f:
            if rows:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(kept)


def to_device(batch: Mapping[str, Any],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _host_floats(values) -> list:
    """0-d device tensors → Python floats, in one transfer."""
    values = [v.float() for v in values]
    return torch.stack(values).cpu().tolist() if values else []


def run_training(
    *,
    state,
    train_step: Optional[Callable] = None,
    train_loader: Optional[Iterable] = None,
    epochs: int,
    eval_step: Optional[Callable] = None,
    eval_loader: Optional[Iterable] = None,
    save_dir: Optional[str] = None,
    ckpt_every: int = 1,
    resume: bool = False,
    epoch_fn: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
    steps_per_epoch: Optional[int] = None,
):
    """Returns the final state (the same object, updated in place).

    Two data paths: the host loader (``train_step(state, batch) ->
    (state, metrics)`` over ``train_loader``, ``eval_step(batch, params)``
    over ``eval_loader``) and the device-resident one (``epoch_fn(state,
    epoch) -> (state, metric_means)`` and ``eval_fn(params) -> metrics``,
    built by data/device.py); checkpoints, EMA columns, logs and resume
    behave the same on both."""
    device = next(state.model.parameters()).device
    writer = is_writer()
    logger = (CSVLogger(os.path.join(save_dir, "log.csv"))
              if save_dir and writer else None)
    tb = None
    if save_dir and writer:
        from fastvim_tpu_torch.utils.tboard import SummaryWriter

        tb = SummaryWriter(os.path.join(save_dir, "tb"))
    start_epoch = 0
    if resume and save_dir:
        path = latest_checkpoint(os.path.join(save_dir, "ckpt"))
        if path:
            state.load_state_dict(restore_checkpoint(path, device))
            spe = steps_per_epoch or max(len(train_loader), 1)
            start_epoch = state.step // spe
            print(f"resumed from {path} at epoch {start_epoch}")
            if logger is not None:
                logger.truncate_from(start_epoch)

    for epoch in range(start_epoch, epochs):
        t_epoch = time.perf_counter()
        with torch.profiler.record_function("train_epoch"):
            if epoch_fn is not None:
                state, means = epoch_fn(state, epoch)
                epoch_means = dict(zip(means, _host_floats(means.values())))
                n_steps = steps_per_epoch or 1
            else:
                if hasattr(train_loader, "epoch"):
                    train_loader.epoch = epoch
                n_steps = 0
                metric_sums: Dict[str, torch.Tensor] = {}
                for batch in train_loader:
                    state, metrics = train_step(state,
                                                to_device(batch, device))
                    n_steps += 1
                    for k, v in metrics.items():
                        metric_sums[k] = (v if k not in metric_sums
                                          else metric_sums[k] + v)
                epoch_means = ({k: v / n_steps for k, v in zip(
                    metric_sums, _host_floats(metric_sums.values()))}
                    if n_steps else {})
        dt = time.perf_counter() - t_epoch
        row = {"epoch": epoch, "steps": n_steps,
               "steps_per_sec": n_steps / dt if dt > 0 else 0.0,
               **epoch_means}

        if eval_fn is not None:
            evals = {f"val_{k}": v for k, v in eval_fn(None).items()}
            if state.ema_params is not None:
                evals.update({f"val_{k}_ema": v for k, v in
                              eval_fn(state.ema_params).items()})
            row.update(zip(evals, _host_floats(evals.values())))
        elif eval_step is not None and eval_loader is not None:
            # per-batch means weighted by batch size: a ragged final val
            # batch must not skew the epoch metric
            aggs: Dict[str, list] = {}
            weights: list = []
            for batch in eval_loader:
                batch = to_device(batch, device)
                weights.append(int(batch["image"].shape[0]))
                for k, v in eval_step(batch).items():
                    aggs.setdefault(f"val_{k}", []).append(v)
                if state.ema_params is not None:
                    for k, v in eval_step(batch, state.ema_params).items():
                        aggs.setdefault(f"val_{k}_ema", []).append(v)
            n = len(weights)
            flat = _host_floats([x for v in aggs.values() for x in v])
            nums = {k: sum(x * w for x, w in zip(flat[i * n:(i + 1) * n],
                                                 weights))
                    for i, k in enumerate(aggs)}
            # every rank's sums (a rank may have had no batch), in rank
            # order
            parts = gather_objects([(nums, float(sum(weights)))])
            wtot = sum(p[1] for p in parts) or 1.0
            for k in next((p[0] for p in parts if p[0]), {}):
                row[k] = float(sum(p[0].get(k, 0.0) for p in parts) / wtot)

        if writer:
            print({k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in row.items()})
        if logger:
            logger.log(row)
        if tb is not None:
            tb.add_scalars(int(state.step), row)
        if save_dir and (epoch + 1) % ckpt_every == 0:
            if writer:
                save_checkpoint(os.path.join(save_dir, "ckpt"), state)
            barrier()
    if tb is not None:
        tb.close()
    return state
