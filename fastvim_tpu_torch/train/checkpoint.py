"""Checkpoints: raw + EMA params, optimizer state, step; and the transfer
of a pretrained backbone into another model.

Counterpart of ``fastvim_tpu/train/checkpoint.py`` with ``torch.save`` in
place of orbax and the same layout: one checkpoint
a step at ``<ckpt_dir>/step_N`` holding ``{params, ema_params, opt_state,
step}`` (``ema_params`` only with EMA), the newest ``keep`` kept. A
checkpoint is written to ``step_N.tmp`` and renamed, so a run cut while
saving leaves no ``step_N`` behind. Loading takes ``weights_only=True``:
a checkpoint holds tensors, numbers and strings, and nothing else is
unpickled.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

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


def load_pretrained_backbone(
    path: str, target: Mapping[str, torch.Tensor], *,
    prefer_ema: bool = True,
    new_grid: Optional[Tuple[int, int]] = None,
    old_grid: Optional[Tuple[int, int]] = None,
    scanpath_type: str = "rowwise", subtree: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """The checkpoint at ``path`` transferred onto ``target`` (a
    state_dict), as a new state_dict with the target's names, dtypes and
    devices, to ``load_state_dict``:

    * the EMA copy first when it is there and ``prefer_ema``;
    * a ``pos_embed`` of another grid resized bicubically from
      ``old_grid`` to ``new_grid`` (``ops/resize.py``);
    * an entry whose shape still differs keeps the target's value (a
      patch-size change, a new head);
    * a missing ``pos_embed`` of a square grid is filled with the sin-cos
      table: an MAE encoder's is computed, not saved;
    * ``subtree``: the checkpoint is a standalone backbone, and the
      target holds it under ``{subtree}.``.

    Prints the counts, "loaded / kept-init / sincos-filled"."""
    from fastvim_tpu_torch.models.mae import get_2d_sincos_pos_embed
    from fastvim_tpu_torch.models.patch_embed import resize_pos_embed

    restored = restore_checkpoint(path, "cpu")
    src = restored.get("ema_params") if prefer_ema else None
    if src is None:
        src = restored.get("params", restored)
    if subtree:
        src = {f"{subtree}.{k}": v for k, v in src.items()}

    out: Dict[str, torch.Tensor] = {}
    loaded = skipped = synthesized = 0
    for name, t in target.items():
        s = src.get(name)
        if s is None:
            grid = int(round(t.shape[1] ** 0.5)) if t.dim() == 3 else 0
            if (name.endswith("pos_embed") and t.dim() == 3
                    and grid * grid == t.shape[1]):
                table = get_2d_sincos_pos_embed(t.shape[2], grid)
                out[name] = torch.from_numpy(table)[None].to(t)
                synthesized += 1
            else:
                out[name] = t
                skipped += 1
            continue
        if "pos_embed" in name and s.shape != t.shape and new_grid:
            s = resize_pos_embed(s, new_grid, old_grid, scanpath_type)
        if s.shape != t.shape:
            out[name] = t
            skipped += 1
            continue
        out[name] = s.to(t)
        loaded += 1
    print(f"load_pretrained_backbone: loaded {loaded}, kept-init {skipped},"
          f" sincos-filled {synthesized}")
    return out
