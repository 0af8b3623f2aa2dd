"""Where a step's device time goes: ``torch.profiler`` kernel times by name.

Counterpart of the step-timing part of ``fastvim_tpu/utils/profiling.py``.
:func:`device_time_by_kernel` runs a callable a few times under the
profiler and sums the CUDA time of each kernel; run as a script it
profiles a forward or a supervised train step of a registered model on the
first CUDA device and prints one table::

    python -m fastvim_tpu_torch.utils.profiling --model fastvim_tiny \\
        --img 2048 --batch 3 --train

It needs a CUDA device; nothing here falls back to the CPU.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import torch

# the port's own kernels, by a piece of their C++ name; checked in order
KERNEL_GROUPS = (
    ("K1 scan fwd", "scan_fwd_kernel"), ("K2 scan bwd", "scan_bwd_kernel"),
    ("K5 pass B bwd (main)", "pass_b_bwd"),
    ("K6 pass A bwd (conv adjoint)", "pass_a_bwd_conv"),
    ("K6 pass A bwd (dx GEMM)", "pass_a_bwd_dx"),
    ("K5/K6 weight-gradient GEMMs", "wgrad_kernel"),
    ("K2/K5/K6 partial sums", "sum_partials_kernel"),
    ("K3 pass A", "pass_a"), ("K4 pass B", "pass_b"))


def device_time_by_kernel(fn: Callable[[], object], warmup: int = 2,
                          iters: int = 3
                          ) -> Tuple[List[Tuple[str, float, int]], float,
                                     float]:
    """Run ``fn`` ``warmup`` times, then ``iters`` times under the
    profiler. Returns (rows, busy_ms, wall_ms) per call of ``fn``: rows =
    (kernel name, device ms, launches), sorted by time; busy_ms their
    sum; wall_ms the host time of an unprofiled call ending in a
    synchronize (mean of ``iters``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0))
        # kernels and copies only: a user annotation mirrored on the device
        # (the optimizer's) spans its kernels and would count them twice
        if (us > 0 and str(ev.device_type).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.key, us / 1e3 / iters, ev.count // iters))
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), wall_ms


def group_rows(rows) -> Dict[str, Tuple[float, int]]:
    """Sum rows into the port's kernels (KERNEL_GROUPS) and, for the rest,
    by kernel name."""
    out: Dict[str, Tuple[float, int]] = {}
    for name, ms, count in rows:
        key = next((g for g, part in KERNEL_GROUPS if part in name), name)
        prev = out.get(key, (0.0, 0))
        out[key] = (prev[0] + ms, prev[1] + count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="fastvim_tiny")
    ap.add_argument("--img", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--train", action="store_true",
                    help="a supervised train step instead of a forward")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    model = create_model(args.model, img_size=args.img, dtype=dtype,
                         drop_path_rate=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"image": torch.randn(args.batch, args.img, args.img, 3,
                                  device=dev, generator=gen, dtype=dtype),
             "label": torch.randint(1000, (args.batch,), device=dev,
                                    generator=gen)}
    if args.train:
        state = TrainState.create(model, make_optimizer(
            cosine_with_warmup(1e-3, 1e-5, 1000, 20), weight_decay=0.05,
            params=model))
        step = make_supervised_train_step(model, 1000, label_smoothing=0.1,
                                          ema_decay=None)
        fn = lambda: step(state, batch)
    else:
        def fn():
            with torch.inference_mode():
                return model(batch["image"])

    rows, busy_ms, wall_ms = device_time_by_kernel(fn)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    what = "train step" if args.train else "forward"
    print(f"{args.model} {args.img}px B={args.batch} {args.dtype} {what} "
          f"({card}): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    print(f"{'ms/step':>10} {'share':>7} {'launches':>9}  kernel")
    for name, (ms, count) in list(group_rows(rows).items())[:args.top]:
        print(f"{ms:10.3f} {ms / busy_ms:7.1%} {count:9d}  {name[:90]}")


if __name__ == "__main__":
    main()
