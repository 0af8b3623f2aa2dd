"""One training step over n ranks, at toy sizes.

Counterpart of ``dryrun_multichip`` in the JAX repository's entry point:

    python -m fastvim_tpu_torch.parallel.dryrun 4 [--device cpu]

spawns n processes that join one process group: NCCL, each on its own
card (it needs n cards), or with ``--device cpu`` gloo on the CPU. As in
the JAX entry point, the mesh is ``(data, seq) = (n / 2, 2)`` where n is
even and at least 4, else ``(n, 1)``. Each rank takes its data index's
rows of a global batch of 2n and runs two supervised steps:

1. a small ``VisionMamba`` (img 32, patch 8, depth 4, embed 64, d_state
   8) with mixup, cutmix and DropPath 0.1; over seq 2 its 4 × 4 token
   grid is sharded, 2 rows a rank;
2. the fused layer, ``layer_fused="on"`` (img 64, patch 8, depth 2,
   embed 64, d_state 16), without mixup; over seq 2 its 8 × 8 grid is
   sharded and its layers run unfused, as the JAX package sets the fused
   layer aside on a seq mesh.

Rank 0 prints each step's loss, the global batch's; every loss must be
finite and every rank's parameters equal rank 0's.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fastvim_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    reset_mesh,
    shard_batch,
)


def _step(model, mixup, batch, device, name: str, mesh) -> float:
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    tx = make_optimizer(cosine_with_warmup(1e-3, 1e-5, 100, 10),
                        weight_decay=0.05, params=model)
    state = TrainState.create(model, tx, ema=True)
    step = make_supervised_train_step(
        model, 10, mixup_config=mixup, label_smoothing=0.1,
        ema_decay=0.9999,
        generator=torch.Generator(device=device).manual_seed(2))
    state, metrics = step(state, {k: v.to(device)
                                  for k, v in shard_batch(batch).items()})
    loss = float(metrics["train_loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"{name}: loss {loss}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    if not torch.equal(flat, ref):
        raise AssertionError(f"{name}: rank {mesh.rank}'s parameters differ "
                             "from rank 0's")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.world}) {name}: mesh={mesh.shape} "
              f"loss={loss:.4f} step={state.step}", flush=True)
    return loss


def _rank(rank: int, world: int, store: str, device_type: str) -> None:
    from fastvim_tpu_torch.models import VisionMamba

    torch.set_num_threads(1)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    init_distributed(device.type, init_method=f"file://{store}",
                     world_size=world, rank=rank)
    try:
        seq = 2 if world % 2 == 0 and world >= 4 else 1
        mesh = make_mesh(data=world // seq, seq=seq)
        batch_size = 2 * world
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(batch_size, 32, 32, 3, generator=gen)
        y = torch.arange(batch_size) % 10
        model = VisionMamba(img_size=32, patch_size=8, depth=4,
                            embed_dim=64, num_classes=10,
                            drop_path_rate=0.1, ssm_cfg=dict(d_state=8))
        model.reset_parameters(torch.Generator().manual_seed(1))
        _step(model.to(device), dict(mixup_alpha=0.8, cutmix_alpha=1.0),
              {"image": x, "label": y}, device, "step", mesh)

        model = VisionMamba(img_size=64, patch_size=8, depth=2,
                            embed_dim=64, num_classes=10,
                            drop_path_rate=0.0, layer_fused="on",
                            ssm_cfg=dict(d_state=16))
        model.reset_parameters(torch.Generator().manual_seed(4))
        xf = torch.randn(batch_size, 64, 64, 3, generator=gen)
        _step(model.to(device), None, {"image": xf, "label": y}, device,
              "fused layer", mesh)
    finally:
        dist.destroy_process_group()
        reset_mesh()


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Spawn ``n`` ranks (NCCL, one card each; gloo with ``device="cpu"``)
    and run the two steps; raises if fewer than n cards are visible or a
    rank fails."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                           f"{torch.cuda.device_count()} visible; pass "
                           "--device cpu for gloo ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n, os.path.join(tmp, "store"), device_type),
                 nprocs=n, join=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default): NCCL ranks, one card each; "
                        "'cpu': gloo ranks on the CPU")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
