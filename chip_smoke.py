#!/usr/bin/env python3
"""Drive the PyTorch port (fastvim_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. print the card's name and power limit, the torch / CUDA / nvcc
   versions, and build the CUDA kernels from ``ops/kernels/csrc``;
2. hold each kernel (K1 scan, K3 pass A, K4 pass B, and the backward
   kernels K2 scan, K5 pass B, K6 pass A) against its plain PyTorch
   version on the card, at the main path's shapes, in fp32 and bf16, and
   time both;
3. build ``fastvim_tiny`` and ``vim_tiny`` at 224 px, full width, fp32,
   from one seed, and compare their logits, then their loss and every
   parameter's gradient, on the card (kernels) with the same models on
   the CPU (plain versions);
4. run both models forward at 2048 px, batch 2, bf16. Logits must be
   finite, and the kernels' launch counters must show 24 pass A + 24
   pass B + 48 scans for FastVim-T and 48 scans for Vim-T per forward.
   Then time forwards with CUDA events (median of 5 windows) and print
   img/s;
5. train: ``fastvim_tiny`` at 2048 px, batch 3, bf16, built on the card by
   ``create_model`` → ``make_optimizer`` (AdamW, cosine schedule with
   warmup, weight decay 0.05) → ``TrainState`` →
   ``make_supervised_train_step`` (label smoothing 0.1, no EMA): 5 steps
   on one fixed batch. Every loss must be finite, the last below the
   first, the parameters changed, and each step must launch 24 K3, 24 K4,
   48 K1, 24 K5, 24 K6 and 48 K2. Then one step of ``vim_tiny`` at
   2048 px, batch 2 (48 K1, 48 K2), and the step time of each as img/s.

The line before the last is a JSON object with one entry per kernel
(``bound_ms`` is the larger of bytes / 3.35 TB/s and operations / the
H100's peak for their type, for the inputs of the timed call); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

FP32_TOL = 1e-4  # |got - want| <= tol + tol·|want|: fp32 sums in another order
BF16_TOL = 2e-2  # ≈ 5 bf16 ulps: the outputs are rounded to bf16 on both sides
MODEL_TOL = 1e-3  # fp32 logits after 24 layers, card vs CPU
GRAD_TOL = 1e-4   # fp32 gradients after 24 layers, relative to the largest

# NVIDIA H100 SXM peaks (data sheet, dense): the yardstick of bound_ms
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, tol, summed=False):
    """Max abs error of got against want; raise beyond
    |got - want| <= atol + tol·|want| with atol = tol, or, for a tensor
    ``summed`` over all tokens or steps, atol = tol · max(1, max|want|):
    the rounding of a long fp32 sum grows with the size of its terms, not
    with the result, which may be near 0 where the terms cancel."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    err = (got - want).abs()
    abs_err = err.max().item()
    rel_err = (err / want.abs().clamp_min(1e-6)).max().item()
    atol = tol * max(1.0, want.abs().max().item()) if summed else tol
    ok = bool((err <= atol + tol * want.abs()).all())
    log(f"[check] {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
        f" atol={atol:.3g} rtol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance {tol}")
    return abs_err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: int, flops: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take
    to move n_bytes once and do flops operations of the given kind."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
                # per (b, t, d, n): exp, the recurrence (4), h·C and its sum
                b_ms, by = bound(nbytes(*args, bias, got), 9.0 * batch * L * d
                                 * n, "fp32")
                log(f"[time] selective_scan_fwd bf16 B={batch} L={L} d={d}: "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({by}) ({card})")
                times.setdefault("selective_scan_fwd", (k_ms, p_ms, b_ms, by))

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
                    gemm = 2.0 * batch * H * W * dm * di  # one GEMM's FLOP
                    for name, kern, plain, args, outs, flops in (
                            ("pass_a_fwd", lf.pass_a, lf.pass_a_plain, a_args,
                             got, gemm),
                            ("pass_b_fwd", lf.pass_b, lf.pass_b_plain, b_args,
                             (x4,), 2 * gemm)):
                        k_ms = cuda_ms(lambda: kern(*args), 20)
                        p_ms = cuda_ms(lambda: plain(*args), 20)
                        b_ms, by = bound(
                            nbytes(*(a for a in args
                                     if isinstance(a, torch.Tensor)), *outs),
                            flops, "bf16")
                        log(f"[time] {name} bf16 {tag}: kernel {k_ms:.4f} "
                            f"ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                            f"({by}) ({card})")
                        times.setdefault(name, (k_ms, p_ms, b_ms, by))
    return errs, times


def compare_all(name, got, want, tol, n_per_token):
    """compare() over two tuples of tensors, the first ``n_per_token`` of
    them per token or step and the rest summed over all of them; returns
    the largest error."""
    return max(compare(f"{name} [{i}]", g, w, tol, summed=i >= n_per_token)
               for i, (g, w) in enumerate(zip(got, want)))


def check_bwd_kernels(dev, card):
    """Phase 2, the backward kernels: K2, K5 and K6 against their plain
    versions on the card."""
    import torch

    from fastvim_tpu_torch.ops.kernels import layer_fused as lf
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    g = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    uni = lambda *s, bound: (torch.rand(*s, generator=g, device=dev) * 2
                             - 1) * bound
    errs = {"selective_scan_bwd": 0.0, "pass_b_bwd": 0.0, "pass_a_bwd": 0.0}
    times = {}

    # K2: the pooled scans of a FastVim-T train step at 2048 px (L = 128,
    # batch 3) and Vim-T's full-length scans (L = 16,384; 16,385 is the
    # ragged last chunk of the middle-cls-token model)
    d, n = 384, 16
    A = -torch.exp(uni(d, n, bound=1.0))
    bias, D = uni(d, bound=0.5), uni(d, bound=1.0)
    for L, batch in ((128, 3), (16384, 2), (16385, 1)):
        base = dict(u=rnd(batch, L, d), delta=rnd(batch, L, d, scale=0.5),
                    B=rnd(batch, L, n), C=rnd(batch, L, n),
                    g=rnd(batch, L, d))
        for dtype in (torch.float32, torch.bfloat16):
            if L == 16385 and dtype == torch.bfloat16:
                continue
            bf = dtype == torch.bfloat16
            tol = BF16_TOL if bf else FP32_TOL
            t = {k: v.to(dtype) for k, v in base.items()}
            ins = (t["u"], t["delta"], A, t["B"], t["C"], D, bias)
            for reverse in (False, True):
                _, states = ss.selective_scan_fwd(
                    *ins[:5], D=D, delta_bias=bias, delta_softplus=True,
                    reverse=reverse, save_states=True)
                got = ss.selective_scan_bwd(*ins, t["g"], states, True,
                                            reverse)
                want = ss.selective_scan_bwd_plain(*ins, t["g"], True,
                                                   reverse)
                # du, ddelta, dB, dC per step first; dA, dD, dbias are
                # summed over every step of every batch element
                order = (0, 1, 3, 4, 2, 5, 6)
                e = compare_all(f"selective_scan_bwd L={L} B={batch} {dtype} "
                                f"reverse={reverse}", [got[i] for i in order],
                                [want[i] for i in order], tol, 4)
                errs["selective_scan_bwd"] = max(errs["selective_scan_bwd"],
                                                 e)
            if bf and L != 16385:
                kern = lambda: ss.selective_scan_bwd(*ins, t["g"], states,
                                                     True, True)
                plain = lambda: ss.selective_scan_bwd_plain(*ins, t["g"],
                                                            True, True)
                k_ms = cuda_ms(kern, 100 if L == 128 else 3)
                p_ms = cuda_ms(plain, 2 if L == 128 else 1)
                # per (b, t, d, n): h rebuilt (6), lam and the products (14)
                b_ms, by = bound(nbytes(*ins, t["g"], states, *got),
                                 20.0 * batch * L * d * n, "fp32")
                log(f"[time] selective_scan_bwd bf16 B={batch} L={L} d={d}: "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({by}) ({card})")
                times.setdefault("selective_scan_bwd", (k_ms, p_ms, b_ms, by))
            del got, want, states
        del base, t
        torch.cuda.empty_cache()

    # K5 / K6 at FastVim-T's widths: grid 128×128 (2048 px, batch 3) and
    # 14×14 (224 px)
    dm, di = 192, 384
    w_in = uni(2 * di, dm, bound=dm ** -0.5)
    conv = [uni(di, 4, bound=0.5) for _ in range(2)]
    cbias = [uni(di, bound=0.5) for _ in range(2)]
    w_out = uni(dm, di, bound=di ** -0.5)
    d_f, d_b = uni(di, bound=1.0), uni(di, bound=1.0)
    ln_w, ln_b = 1 + uni(di, bound=0.1), uni(di, bound=0.1)
    for (H, W), batch in (((128, 128), 3), ((14, 14), 8)):
        base = dict(x=rnd(batch, H, W, dm), g=rnd(batch, H, W, dm),
                    xc_f=rnd(batch, H, W, di), xc_b=rnd(batch, H, W, di),
                    dxc_f=rnd(batch, H, W, di), dxc_b=rnd(batch, H, W, di))
        dx_b = rnd(batch, H, W, dm)
        for transposed in (False, True):
            P = W if transposed else H
            pooled = dict(yf=rnd(batch, P, di), yb=rnd(batch, P, di),
                          dpf=rnd(batch, P, di), dpb=rnd(batch, P, di))
            for dtype in (torch.float32, torch.bfloat16):
                bf = dtype == torch.bfloat16
                t = {k: v.to(dtype) for k, v in {**base, **pooled}.items()}
                wx, wz = w_in[:di].to(dtype), w_in[di:].to(dtype)
                tag = f"grid={H}x{W} B={batch} {dtype} transposed={transposed}"
                # K5: dx, dxc_f, dxc_b, dy per token or line; the 8 weight
                # and vector gradients summed over every token
                b_args = (t["g"], t["x"], t["xc_f"], t["xc_b"], t["yf"],
                          t["yb"], wz, None, d_f, d_b, ln_w, ln_b,
                          w_out.to(dtype), 1e-5, True, transposed)
                got_b = lf.pass_b_bwd(*b_args)
                tol = BF16_TOL if bf else FP32_TOL
                e = compare_all(f"pass_b_bwd {tag}", got_b,
                                lf.pass_b_bwd_plain(*b_args), tol, 4)
                errs["pass_b_bwd"] = max(errs["pass_b_bwd"], e)
                # K6: dx per token; 6 gradients summed over every token
                a_args = (t["x"], dx_b, t["dxc_f"], t["dxc_b"], t["dpf"],
                          t["dpb"], wx, None, conv[0], cbias[0], conv[1],
                          cbias[1], 1.0, transposed)
                got_a = lf.pass_a_bwd(*a_args)
                e = compare_all(f"pass_a_bwd {tag}", got_a,
                                lf.pass_a_bwd_plain(*a_args), tol, 1)
                errs["pass_a_bwd"] = max(errs["pass_a_bwd"], e)
                if bf and (H, W) == (128, 128):
                    gemm = 2.0 * batch * H * W * dm * di  # one GEMM's FLOP
                    for name, kern, plain, args, outs, flops in (
                            ("pass_b_bwd", lf.pass_b_bwd, lf.pass_b_bwd_plain,
                             b_args, got_b, 5 * gemm),
                            ("pass_a_bwd", lf.pass_a_bwd, lf.pass_a_bwd_plain,
                             a_args, got_a, 3 * gemm)):
                        k_ms = cuda_ms(lambda: kern(*args), 10)
                        p_ms = cuda_ms(lambda: plain(*args), 5)
                        b_ms, by = bound(
                            nbytes(*(a for a in args
                                     if isinstance(a, torch.Tensor)), *outs),
                            flops, "bf16")
                        log(f"[time] {name} bf16 {tag}: kernel {k_ms:.4f} "
                            f"ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                            f"({by}) ({card})")
                        times.setdefault(name, (k_ms, p_ms, b_ms, by))
    return errs, times


def check_models_224(dev):
    """Phase 3: 224 px fp32 logits, card (kernels) vs CPU (plain)."""
    import torch

    from fastvim_tpu_torch.models import create_model

    x = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    for name in ("fastvim_tiny", "vim_tiny"):
        cpu_model = create_model(name, img_size=224, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        want = cpu_model(x)
        got = gpu_model(x.to(dev)).cpu()
        compare(f"{name} 224px fp32 logits, card vs CPU", got, want,
                MODEL_TOL)


def check_grads_224(dev):
    """Phase 3, training: the loss and every parameter's gradient at
    224 px in fp32, card (kernels) vs CPU (plain versions)."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.train import cross_entropy

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 224, 224, 3, generator=gen)
    labels = torch.randint(1000, (2,), generator=gen)
    for name in ("fastvim_tiny", "vim_tiny"):
        cpu_model = create_model(name, img_size=224, device="cpu",
                                 drop_path_rate=0.0,
                                 generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        results = []
        for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
            model.train()
            loss = cross_entropy(model(x.to(d)), labels.to(d), 0.1)
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
            results.append((loss.detach().cpu(),
                            {n: gr.cpu() for n, gr in zip(params, grads)}))
        (want_loss, want), (got_loss, got) = results
        compare(f"{name} 224px fp32 loss, card vs CPU", got_loss, want_loss,
                MODEL_TOL)
        worst, worst_name = 0.0, ""
        for n, w in want.items():
            scale = w.abs().max().item() + 1e-12
            e = (got[n] - w).abs().max().item() / scale
            if not torch.isfinite(got[n]).all() or e > GRAD_TOL:
                raise AssertionError(f"{name}: gradient of {n} off by {e:.3e} "
                                     f"of its largest entry (> {GRAD_TOL})")
            if e > worst:
                worst, worst_name = e, n
        log(f"[check] {name} 224px fp32 gradients of {len(want)} parameters, "
            f"card vs CPU: worst {worst:.3e} of the largest entry "
            f"({worst_name}) tol={GRAD_TOL:g} ok")


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
    none = dict.fromkeys(kernels.launch_counts(), 0)
    expected = {
        "fastvim_tiny": {**none, "selective_scan_fwd": 48, "pass_a_fwd": 24,
                         "pass_b_fwd": 24},
        "vim_tiny": {**none, "selective_scan_fwd": 48},
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


def run_train_path(dev, card):
    """Phase 5: supervised train steps at 2048 px in bf16, through the
    entry points a user calls. Returns the launch counts of all steps."""
    import torch

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.ops import kernels
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    img, classes = 2048, 1000
    per_step = {
        "fastvim_tiny": {"selective_scan_fwd": 48, "selective_scan_bwd": 48,
                         "pass_a_fwd": 24, "pass_b_fwd": 24, "pass_b_bwd": 24,
                         "pass_a_bwd": 24},
        "vim_tiny": {"selective_scan_fwd": 48, "selective_scan_bwd": 48,
                     "pass_a_fwd": 0, "pass_b_fwd": 0, "pass_b_bwd": 0,
                     "pass_a_bwd": 0},
    }
    total = dict.fromkeys(kernels.launch_counts(), 0)
    for name, batch, steps in (("fastvim_tiny", 3, 5), ("vim_tiny", 2, 1)):
        # no device argument: the entry point builds on the card
        model = create_model(name, img_size=img, dtype=torch.bfloat16,
                             drop_path_rate=0.0,
                             generator=torch.Generator().manual_seed(0))
        if next(model.parameters()).device.type != "cuda":
            raise AssertionError("create_model did not build on the card")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        tx = make_optimizer(cosine_with_warmup(1e-3, 1e-5, 1000, 20),
                            weight_decay=0.05, params=model)
        state = TrainState.create(model, tx)
        train_step = make_supervised_train_step(
            model, classes, label_smoothing=0.1, ema_decay=None)
        gen = torch.Generator(device=dev).manual_seed(5)
        batch_ = {"image": torch.randn(batch, img, img, 3, device=dev,
                                       generator=gen, dtype=torch.bfloat16),
                  "label": torch.randint(classes, (batch,), device=dev,
                                         generator=gen)}
        losses = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            kernels.reset_launch_counts()
            state, metrics = train_step(state, batch_)
            torch.cuda.synchronize()
            seen = kernels.launch_counts()
            losses.append(metrics["train_loss"].item())
            if seen != per_step[name]:
                raise AssertionError(f"{name} step {i}: launches {seen}, "
                                     f"expected {per_step[name]}")
            for k, v in seen.items():
                total[k] += v
        log(f"[train] {name} {img}px B={batch} bf16: losses "
            f"{[round(v, 5) for v in losses]}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, launches per step "
            f"{per_step[name]}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if steps > 1:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{name}: loss did not fall: {losses}")
            if not any((p.detach() != before[n]).any()
                       for n, p in model.named_parameters()):
                raise AssertionError(f"{name}: parameters did not change")
        if state.step != steps:
            raise AssertionError(f"{name}: step count {state.step}")
        iters, windows = (3, 3) if name == "fastvim_tiny" else (1, 3)
        ms = cuda_ms(lambda: train_step(state, batch_), iters, windows)
        log(f"[time] {name} {img}px B={batch} bf16 train step: {ms:.3f} ms, "
            f"{batch / ms * 1e3:.2f} img/s ({card})")
        del model, state, tx, train_step, before, batch_
        torch.cuda.empty_cache()
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
    with torch.no_grad():
        errs_bwd, times_bwd = check_bwd_kernels(dev, card)
    errs.update(errs_bwd)
    times.update(times_bwd)
    with torch.inference_mode():
        check_models_224(dev)
    check_grads_224(dev)
    with torch.inference_mode():
        launches = run_main_path(dev, card)
    for name, count in run_train_path(dev, card).items():
        launches[name] += count

    src = "fastvim_tpu_torch/ops/kernels/csrc/"
    table = [
        ("selective_scan_fwd", "selective_scan_fwd.cu",
         "fastvim_tpu/ops/pallas/selective_scan.py:79"),
        ("selective_scan_bwd", "selective_scan_bwd.cu",
         "fastvim_tpu/ops/pallas/selective_scan.py:294"),
        ("pass_a_fwd", "layer_fused_fwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:303"),
        ("pass_b_fwd", "layer_fused_fwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:409"),
        ("pass_b_bwd", "layer_fused_bwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:453"),
        ("pass_a_bwd", "layer_fused_bwd.cu",
         "fastvim_tpu/ops/pallas/layer_fused.py:555"),
    ]
    for name, _, _ in table:
        if launches[name] < 1:
            raise AssertionError(f"{name}: not launched on the main path")
    print(card, flush=True)
    # library_ms: no single PyTorch call computes any of these functions
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + file,
         "replaces": tpu, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None}
        for name, file, tpu in table]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
