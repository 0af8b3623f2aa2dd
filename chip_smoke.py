#!/usr/bin/env python3
"""Drive the PyTorch port (fastvim_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. print the card's name and power limit, the torch / CUDA / nvcc
   versions, and build the CUDA kernels from ``ops/kernels/csrc``;
2. hold each kernel (K1 scan, K3 pass A, K4 pass B) against its plain
   PyTorch version on the card, at the main path's shapes, in fp32 and
   bf16, and time both;
3. build ``fastvim_tiny`` and ``vim_tiny`` at 224 px, full width, fp32,
   from one seed, and compare their logits on the card (kernels) with the
   same models on the CPU (plain versions);
4. run both models at 2048 px, batch 2, bf16: the main path. Logits must
   be finite, and the kernels' launch counters must show 24 pass A + 24
   pass B + 48 scans for FastVim-T and 48 scans for Vim-T per forward.
   Then time forwards with CUDA events (median of 5 windows) and print
   img/s.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

FP32_TOL = 1e-4  # |got - want| <= tol + tol·|want|: fp32 sums in another order
BF16_TOL = 2e-2  # ≈ 5 bf16 ulps: the outputs are rounded to bf16 on both sides
MODEL_TOL = 1e-3  # fp32 logits after 24 layers, card vs CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, tol):
    """Max abs / rel error of got against want; raise beyond tol."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    err = (got - want).abs()
    abs_err = err.max().item()
    rel_err = (err / want.abs().clamp_min(1e-6)).max().item()
    ok = bool((err <= tol + tol * want.abs()).all())
    log(f"[check] {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
        f" tol=atol=rtol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance {tol}")
    return abs_err


def cuda_ms(fn, iters: int, windows: int = 1) -> float:
    """ms per call: the median over ``windows`` windows of the mean over
    ``iters`` calls, after one warm-up call. Eager forwards at batch 2 are
    host-bound, and the host is shared, so one window is noisy."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def check_kernels(dev, card):
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    errs = {"selective_scan_fwd": 0.0, "pass_a_fwd": 0.0, "pass_b_fwd": 0.0}
    times = {}

    # K1: the pooled scans of FastVim-T at 2048 px (L = 128) and the
    # full-length scans of Vim-T (L = 16,384; 16,385 with the middle cls
    # token exercises the tail chunk)
    d, n = 384, 16
    A = -torch.exp(uni(d, n, bound=1.0))
    bias = uni(d, bound=0.5)
    for L, batch in ((128, 2), (16384, 2), (16385, 1)):
        base = dict(u=rnd(batch, L, d), delta=rnd(batch, L, d, scale=0.5),
                    B=rnd(batch, L, n), C=rnd(batch, L, n))
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            if L == 16385 and dtype == torch.bfloat16:
                continue
            t = {k: v.to(dtype) for k, v in base.items()}
            args = (t["u"], t["delta"], A, t["B"], t["C"])
            kw = dict(delta_bias=bias, delta_softplus=True)
            for reverse in (False, True):
                got = ss.selective_scan_fwd(*args, reverse=reverse, **kw)
                want = ss.selective_scan_plain(*args, reverse=reverse, **kw)
                e = compare(f"selective_scan_fwd L={L} B={batch} {dtype} "
                            f"reverse={reverse}", got, want, tol)
                errs["selective_scan_fwd"] = max(errs["selective_scan_fwd"],
                                                 e)
            if dtype == torch.bfloat16:
                kern = lambda: ss.selective_scan_fwd(*args, reverse=True, **kw)
                plain = lambda: ss.selective_scan_plain(*args, reverse=True,
                                                        **kw)
                k_ms = cuda_ms(kern, 200 if L == 128 else 5)
                p_ms = cuda_ms(plain, 3 if L == 128 else 1)
                log(f"[time] selective_scan_fwd bf16 B={batch} L={L} d={d}: "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
                times.setdefault("selective_scan_fwd", (k_ms, p_ms))

    # K3 / K4 at FastVim-T's widths: grid 128×128 (2048 px) and 14×14
    dm, di = 192, 384
    w_in = uni(2 * di, dm, bound=dm ** -0.5)
    conv = [uni(di, 4, bound=0.5) for _ in range(2)]
    cbias = [uni(di, bound=0.5) for _ in range(2)]
    w_out = uni(dm, di, bound=di ** -0.5 / 24 ** 0.5)
    d_f, d_b = uni(di, bound=1.0), uni(di, bound=1.0)
    ln_w, ln_b = 1 + uni(di, bound=0.1), uni(di, bound=0.1)
    for (H, W), batch in (((128, 128), 2), ((14, 14), 8)):
        base_x = rnd(batch, H, W, dm)
        for transposed in (False, True):
            P = W if transposed else H
            base_b = dict(xc_f=rnd(batch, H, W, di), xc_b=rnd(batch, H, W, di),
                          yf=rnd(batch, P, di), yb=rnd(batch, P, di))
            for dtype, tol in ((torch.float32, FP32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                x4 = base_x.to(dtype)
                wx, wz = w_in[:di].to(dtype), w_in[di:].to(dtype)
                a_args = (x4, wx, None, conv[0], cbias[0], conv[1], cbias[1],
                          1.0, transposed)
                tag = f"grid={H}x{W} B={batch} {dtype} transposed={transposed}"
                got = lf.pass_a(*a_args)
                want = lf.pass_a_plain(*a_args)
                for part, gt, wt in zip(("xc_f", "xc_b", "pf", "pb"), got,
                                        want):
                    e = compare(f"pass_a_fwd {part} {tag}", gt, wt, tol)
                    errs["pass_a_fwd"] = max(errs["pass_a_fwd"], e)
                bb = {k: v.to(dtype) for k, v in base_b.items()}
                b_args = (x4, bb["xc_f"], bb["xc_b"], bb["yf"], bb["yb"], wz,
                          None, d_f, d_b, ln_w, ln_b, w_out.to(dtype), None,
                          1e-5, True, transposed)
                e = compare(f"pass_b_fwd {tag}", lf.pass_b(*b_args),
                            lf.pass_b_plain(*b_args), tol)
                errs["pass_b_fwd"] = max(errs["pass_b_fwd"], e)
                if dtype == torch.bfloat16 and (H, W) == (128, 128):
                    for name, kern, plain, args in (
                            ("pass_a_fwd", lf.pass_a, lf.pass_a_plain, a_args),
                            ("pass_b_fwd", lf.pass_b, lf.pass_b_plain,
                             b_args)):
                        k_ms = cuda_ms(lambda: kern(*args), 20)
                        p_ms = cuda_ms(lambda: plain(*args), 20)
                        log(f"[time] {name} bf16 {tag}: kernel {k_ms:.4f} "
                            f"ms, plain {p_ms:.4f} ms ({card})")
                        times.setdefault(name, (k_ms, p_ms))
    return errs, times


def check_models_224(dev):
    """Phase 3: 224 px fp32 logits, card (kernels) vs CPU (plain)."""
    import torch

    from fastvim_tpu_torch.models import create_model

    x = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    for name in ("fastvim_tiny", "vim_tiny"):
        cpu_model = create_model(name, img_size=224,
                                 generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        want = cpu_model(x)
        got = gpu_model(x.to(dev)).cpu()
        compare(f"{name} 224px fp32 logits, card vs CPU", got, want,
                MODEL_TOL)


def run_main_path(dev, card):
    """Phase 4: FastVim-T and Vim-T at 2048 px, batch 2, bf16."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels

    batch, img = 2, 2048
    models = {name: create_model(name, img_size=img, dtype=torch.bfloat16,
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
              for name in ("fastvim_tiny", "vim_tiny")}
    x = torch.randn(batch, img, img, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    dtype=torch.bfloat16)
    expected = {
        "fastvim_tiny": {"selective_scan_fwd": 48, "pass_a_fwd": 24,
                         "pass_b_fwd": 24},
        "vim_tiny": {"selective_scan_fwd": 48, "pass_a_fwd": 0,
                     "pass_b_fwd": 0},
    }
    kernels.reset_launch_counts()
    seen = {}
    for name, model in models.items():
        before = kernels.launch_counts()
        logits = model(x)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        seen[name] = {k: after[k] - before[k] for k in after}
        if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                                 "not finite or of the wrong shape")
        log(f"[main] {name} {img}px B={batch} bf16: logits finite, "
            f"launches {seen[name]}")
        if seen[name] != expected[name]:
            raise AssertionError(f"{name}: launches {seen[name]}, expected "
                                 f"{expected[name]}")
    total = kernels.launch_counts()

    for name, model in models.items():
        ms = cuda_ms(lambda: model(x), 5, windows=5)
        log(f"[time] {name} {img}px B={batch} bf16 forward: {ms:.3f} ms, "
            f"{batch / ms * 1e3:.2f} img/s ({card})")
    b224 = 40
    x224 = torch.randn(b224, 224, 224, 3, device=dev, dtype=torch.bfloat16,
                       generator=torch.Generator(device=dev).manual_seed(3))
    m224 = create_model("fastvim_tiny", img_size=224, dtype=torch.bfloat16,
                        device=dev)
    ms = cuda_ms(lambda: m224(x224), 10, windows=5)
    log(f"[time] fastvim_tiny 224px B={b224} bf16 forward: {ms:.3f} ms, "
        f"{b224 / ms * 1e3:.2f} img/s ({card})")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from fastvim_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    log(card)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        errs, times = check_kernels(dev, card)
        check_models_224(dev)
        launches = run_main_path(dev, card)

    src = "fastvim_tpu_torch/ops/kernels/csrc/"
    table = [
        ("selective_scan_fwd", "selective_scan_fwd.cu",
         "fastvim_tpu/ops/pallas/selective_scan.py:79"),
        ("pass_a_fwd", "layer_fused_fwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:303"),
        ("pass_b_fwd", "layer_fused_fwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:409"),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + file,
         "replaces": tpu, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, file, tpu in table]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
