"""Shared CLI plumbing for the task entry points.

Counterpart of ``fastvim_tpu/cli/common.py``, plus ``--device``: the
entry points run on the first CUDA device unless asked for the CPU
(``--device cpu``), and raise where there is no card.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from fastvim_tpu_torch.config import load_config


def base_parser(description: str) -> argparse.ArgumentParser:
    """The reference CLI surface: --config_name X --model_save_dir …
    plus key=value overrides, and --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config_name", "--config", required=True,
                   help="config name (e.g. FastVimT) or path")
    p.add_argument("--model_save_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data_dir", default=None,
                   help="dataset root (overrides config data.dir)")
    p.add_argument("--epochs", type=int, default=None,
                   help="override training_epochs (smoke runs)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--synthetic_samples", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the first CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides")
    return p


def load_cli_config(args, domain: str) -> Dict[str, Any]:
    cfg = load_config(args.config_name, domain=domain,
                      overrides=args.overrides)
    if args.data_dir is not None:
        cfg.setdefault("data", {})["dir"] = args.data_dir
    if args.epochs is not None:
        cfg["training_epochs"] = args.epochs
    if args.batch_size is not None:
        cfg["batch_size"] = args.batch_size
    return cfg


def cli_device(name: str) -> torch.device:
    """``--device`` as a torch device; a CUDA device where there is none
    raises (nothing falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def world_size() -> int:
    """Processes training together: ``torch.distributed``'s world size
    once it is initialised, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
