"""Shared CLI plumbing for the task entry points.

Counterpart of ``fastvim_tpu/cli/common.py``, plus ``--device``: the
entry points run on the first CUDA device unless asked for the CPU
(``--device cpu``), and raise where there is no card. Under ``torchrun``
(``torchrun --standalone --nproc_per_node N -m
fastvim_tpu_torch.cli.<cli> ...``) each process takes
``cuda:$LOCAL_RANK`` and :func:`setup_mesh` joins the process group, over
NCCL on the cards and gloo with ``--device cpu``; the config's
``batch_size`` is then the global batch, split over the ranks.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Tuple

import torch

from fastvim_tpu_torch.config import load_config
from fastvim_tpu_torch.parallel import (
    Mesh,
    get_mesh,
    init_distributed,
    local_rank,
    make_mesh,
    shard_batch,
)


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
    raises (nothing falls back to the CPU). "cuda" is ``cuda:$LOCAL_RANK``
    (``cuda:0`` outside ``torchrun``), made the current device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    return dev


def setup_mesh(device: torch.device) -> Tuple[Mesh, Callable]:
    """(mesh, shard_fn): under ``torchrun`` the process group joined over
    NCCL (a CUDA ``device``) or gloo (the CPU); alone a one-rank mesh.
    ``shard_fn(batch)`` is this rank's part of a global batch
    (``parallel.shard_batch``)."""
    init_distributed(device.type)
    mesh = make_mesh()
    return mesh, lambda batch: shard_batch(batch, mesh)


def world_size() -> int:
    """Processes that split the batch: the mesh's data size (its world
    size without a seq axis; 1 outside ``torchrun``)."""
    return get_mesh().data
