"""Checkpoints: raw + EMA params, optimizer state, step.

Counterpart of the save / restore half of ``fastvim_tpu/train/checkpoint.py``
with ``torch.save`` in place of orbax and the same layout: one checkpoint
a step at ``<ckpt_dir>/step_N`` holding ``{params, ema_params, opt_state,
step}`` (``ema_params`` only with EMA), the newest ``keep`` kept. A
checkpoint is written to ``step_N.tmp`` and renamed, so a run cut while
saving leaves no ``step_N`` behind. Loading takes ``weights_only=True``:
a checkpoint holds tensors, numbers and strings, and nothing else is
unpickled.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                    keep: int = 5) -> str:
    """Save ``state.state_dict()`` at ckpt_dir/step_N; returns the path."""
    step = int(state.step) if step is None else step
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}")
    payload = dict(state.state_dict(), step=step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    _prune(ckpt_dir, keep)
    return path


def _steps(ckpt_dir: str):
    return sorted(
        (int(d.split("_")[1]), d) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit())


def _prune(ckpt_dir: str, keep: int) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    for _, d in _steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, d))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``step_N`` under ``ckpt_dir`` (an absolute path), or
    None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1][1]) if steps else None


def restore_checkpoint(path: str,
                       map_location: Union[str, torch.device, None] = None
                       ) -> Dict[str, Any]:
    """The payload saved at ``path``, its tensors on ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
