"""Where a step's device time goes: ``torch.profiler`` kernel times by name.

Counterpart of the step-timing part of ``fastvim_tpu/utils/profiling.py``.
:func:`device_time_by_kernel` runs a callable a few times under the
profiler and sums the CUDA time of each kernel; run as a script it
profiles a forward or a supervised train step of a registered model on the
first CUDA device and prints one table::

    python -m fastvim_tpu_torch.utils.profiling --model fastvim_tiny \\
        --img 2048 --batch 3 --train

With ``--graph`` the forward is captured once as a CUDA graph and the
replays are profiled, so that the forward's device time is read without
the host's launches in the way (``--layer-fused recompute`` for the
recompute configuration, ``--fused-kernels always`` for K8 and K9,
``--fused-merge`` for K10). With
``--fwd-times`` / ``--bwd-times`` it instead times K3 and K4 / K5 and K6
alone (``--dtype``, bf16 unless given; CUDA events, both orientations) at
the widths and grid of each model of ``--model`` (a comma-separated list:
``--bwd-times --dtype float32 --model
fastvim_tiny,fastvim_small,fastvim_base --img 224 --batch 128`` for the
fp32 adjoint of the 224 px CLIs), with ``--rc-times`` K7 and K3's
pools-only form (the recompute
configuration's two passes), with ``--fb-times`` K8 and K9, with
``--mg-times`` K10 at FastVim-T's and FastVim-S's widths, both
orientations, and
with ``--bwd-phases`` it builds the kernels with their cycle counters
compiled in and prints where a block of K5 and of K6 spends its cycles.
``--scan-times`` times the two forms, sequential and chunked, of K1 and
of K2, and the lanes scan, in turns on the same inputs at L = 128 to
16,384 (bf16, B = 2, d_inner 384, n 16, both directions; lanes forward
only), and names the form each launcher picks at each length: what sets
``selective_scan.CHUNKED_MIN_L``. ``--det vitdet_FastVimT_coco`` profiles
a train step of that detection config's detector as ``train_detection``
builds it (fp32, the config's batch unless ``--batch``), on synthetic
loader batches already on the card, after the time of each of its phases.
``--lm prefill`` / ``--lm decode`` profiles the language model at
mamba-130m's widths (d_model 768, 24 layers, vocab 50277, d_state 16;
seeded random weights): one prefill of ``--batch`` × ``--seq-len``
tokens, or one cached decode step after a 16-token prefill.
A profile also prints the peak device memory, e.g. of a train step with
``--model fastvim_huge --img 224 --batch 128 --dtype float32 --train
--layer-fused-bwd remat``.

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
    ("K1 scan fwd", "scan_fwd_kernel"),
    ("K1 scan fwd, chunked (phases 1, 3)", "scan_chunk_kernel"),
    ("K1 / K2 chunked, carry pass (phase 2)", "state_pass_kernel"),
    ("K2 scan bwd", "scan_bwd_kernel"),
    ("K2 scan bwd, chunked (phase 1)", "bwd_lam_chunk_kernel"),
    ("K2 scan bwd, chunked (phase 3)", "bwd_grad_chunk_kernel"),
    ("K5 pass B bwd, fp32 (middle)", "pass_b_bwd_mid"),
    ("K6 pass A bwd, fp32 (xin + conv adjoint)", "pass_a_bwd_tf32"),
    ("K5/K6 fp32 products (3xTF32)", "gemm_tf32"),
    ("K5 pass B bwd (main)", "pass_b_bwd"),
    ("K6 pass A bwd (main)", "pass_a_bwd_wgmma"),
    ("K5/K6 dx̂ product", "dx_wgmma"),
    ("K5/K6 weight-gradient GEMMs", "wgrad_"),
    ("K5/K6 partial sums", "sum_segments_kernel"),
    ("K2 partial sums", "sum_partials_kernel"),
    ("K2 partial sums", "sum_slots_kernel"),
    ("K7 pass B, conv stage recomputed", "pass_b_rc"),
    ("K8 conv + pool", "conv_pool_kernel"),
    ("K10 merge + LN + gate", "merge_ln_gate_kernel"),
    ("K9 conv again + merge + LN + gate", "merge_gate_kernel"),
    ("lanes scan fwd", "scan_lanes_kernel"),
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


# the PROF marks of csrc/layer_fused_bwd_wgmma.cu: a mark takes the cycles
# since the mark before it
K5_PHASES = ((0, "second pass of the tile before + barrier"),
             (11, "x̂, g copies started"), (12, "first pass: LN statistics"),
             (1, "wait for x̂, g"), (2, "db_out"), (3, "z product"),
             (4, "m0 to shared + dgated product"),
             (5, "gate / LayerNorm epilogue"), (6, "barrier"),
             (7, "column sums + dz copy-out"), (8, "dx̂ product"),
             (9, "row sums + dx̂ store"), (10, "second pass, last tile"))
K6_PHASES = ((16, "dx̂ store of the window before + wait for x̂"),
             (17, "xin product"), (18, "xin to shared"),
             (19, "wait for the cotangents"), (20, "conv adjoint walk"),
             (21, "barrier"), (22, "partials + dxin copy-out"),
             (23, "dx̂ product"))


def _bwd_args(dm: int, di: int, grid: int, batch: int, transposed: bool,
              dt: torch.dtype = torch.bfloat16):
    """Random arguments of ``pass_b_bwd`` and ``pass_a_bwd`` on a grid ×
    grid token grid, their tensors of ``dt`` where the kernels take it."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    H = W = grid
    tok = lambda c: rnd(batch, H, W, c).to(dt)
    pooled = lambda: rnd(batch, H, di).to(dt)
    b_args = (tok(dm), tok(dm), tok(di), tok(di), pooled(), pooled(),
              rnd(di, dm, scale=dm ** -0.5).to(dt), None, rnd(di), rnd(di),
              1 + rnd(di, scale=0.1), rnd(di, scale=0.1),
              rnd(dm, di, scale=di ** -0.5).to(dt), 1e-5, True, transposed)
    a_args = (tok(dm), rnd(batch, H, W, dm), tok(di), tok(di), pooled(),
              pooled(), rnd(di, dm, scale=dm ** -0.5).to(dt), rnd(di),
              rnd(di, 4, scale=.5), rnd(di), rnd(di, 4, scale=.5), rnd(di),
              1.0, transposed)
    return b_args, a_args


def _fwd_args(dm: int, di: int, grid: int, batch: int, transposed: bool,
              dt: torch.dtype = torch.bfloat16):
    """Random arguments of ``pass_b`` and ``pass_a``, as
    :func:`_bwd_args`."""
    b_args, a_args = _bwd_args(dm, di, grid, batch, transposed, dt)
    # pass_b: x̂, xc_f, xc_b, yf, yb, w_z, b_z, D_f, D_b, ln_w, ln_b, w_out,
    # b_out, eps, use_ln, transposed; pass_a: x̂, w_x, b_x, the convs
    return (b_args[1:12] + (b_args[12], None) + b_args[13:],
            a_args[:1] + a_args[6:])


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _event_ms(fn, args, iters: int) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(dm: int, di: int, grid: int, batch: int, fwd: bool,
                 iters: int = 20, recompute: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """Print the time of one call of K4 and K3 (``fwd``), of K7 and K3's
    pools-only form (``recompute``) or of K5 and K6 in ``dtype`` (CUDA
    events over ``iters`` calls after a warm-up one), on even and odd
    layers."""
    from fastvim_tpu_torch.ops.kernels import layer_fused as lf

    names = ("K4", "K3") if fwd else ("K5", "K6")
    fns = (lf.pass_b, lf.pass_a) if fwd else (lf.pass_b_bwd, lf.pass_a_bwd)
    if recompute:  # K7 and K3 without the xc stores
        names = ("K7", "K3 pools-only")
        fns = (lf.pass_b_recompute,
               lambda *a: lf.pass_a(*a, write_xc=False))
    for transposed in (False, True):
        args = (_fwd_args if fwd else _bwd_args)(dm, di, grid, batch,
                                                 transposed, dtype)
        if recompute:
            # pass_b_recompute: x̂, yf, yb, pass_a's weights, then pass_b's
            # from w_z on
            b, a = args
            args = ((b[0], b[3], b[4], *a[1:7], *b[5:]), a)
        with torch.no_grad():
            ms = [_event_ms(fn, a, iters) for fn, a in zip(fns, args)]
        print(f"{str(dtype)[6:]} d_model={dm} d_inner={di} grid={grid}x"
              f"{grid} B={batch} transposed={transposed}: {names[0]} "
              f"{ms[0]:.4f} ms, {names[1]} {ms[1]:.4f} ms")


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph after a warm-up call, replayed ``replays`` times after a warm-up
    replay and timed with CUDA events. A kernel that runs for less time
    than its wrapper takes on the host (K8 at FastVim's widths) reads the
    host's time when timed call by call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def kernels_a_call(fn) -> int:
    """Device kernels (and copies) one call of ``fn`` launches: the
    kernel, memcpy and memset nodes of a CUDA graph captured from one call
    after a warm-up one, read through the driver API while the capture is
    open. It does not depend on CUPTI tracing, as a profiler trace
    does."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            status, cid = ctypes.c_int(), ctypes.c_uint64()
            cugraph, deps = ctypes.c_void_p(), ctypes.c_void_p()
            ndeps, nnodes = ctypes.c_size_t(), ctypes.c_size_t()
            check(cu.cuStreamGetCaptureInfo_v2(
                stream, ctypes.byref(status), ctypes.byref(cid),
                ctypes.byref(cugraph), ctypes.byref(deps),
                ctypes.byref(ndeps)), "cuStreamGetCaptureInfo_v2")
            if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
                raise RuntimeError(f"stream not capturing ({status.value})")
            check(cu.cuGraphGetNodes(cugraph, None, ctypes.byref(nnodes)),
                  "cuGraphGetNodes")
            nodes = (ctypes.c_void_p * nnodes.value)()
            check(cu.cuGraphGetNodes(cugraph, nodes, ctypes.byref(nnodes)),
                  "cuGraphGetNodes")
            kinds = []
            for node in nodes:
                kind = ctypes.c_int()
                check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                            ctypes.byref(kind)),
                      "cuGraphNodeGetType")
                kinds.append(kind.value)
        del graph
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    return sum(kind in (0, 1, 2) for kind in kinds)


def block_times(di: int, grid: int, batch: int, iters: int = 20) -> None:
    """Print the device time of one call of K8 (mean pooling) and of K9
    (with LayerNorm) in bf16 (a CUDA graph of ``iters`` calls, replayed)
    on a grid × grid token grid, x and z the column halves of one
    in-projection output, each beside its byte bound (inputs read once,
    outputs written once, at 3.35 TB/s) and its largest difference from
    its plain version on the same inputs."""
    from fastvim_tpu_torch.ops.kernels import fused_block as fb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    L = grid * grid
    xz = rnd(batch, L, 2 * di).bfloat16()
    x, z = xz[..., :di], xz[..., di:]
    conv = (rnd(di, 4) * 0.5, rnd(di) * 0.3, rnd(di, 4) * 0.5, rnd(di) * 0.3)
    ys = (rnd(batch, grid, di), rnd(batch, grid, di))
    vec = (rnd(di), rnd(di), 1 + rnd(di) * 0.1, rnd(di) * 0.1)
    k8 = (x, *conv, grid, grid, "mean", 1.0)
    k9 = (x, z, *ys, *conv, *vec, grid, grid, 1e-5, True)
    small = 4 * (2 * di * 4 + 2 * di)  # weights and vectors, fp32
    pooled = 2 * batch * grid * di * 4
    tok = batch * L * di * 2
    with torch.no_grad():
        for name, fn, plain, args, n_bytes in (
                ("K8", fb.conv_pool, fb.conv_pool_plain, k8,
                 tok + pooled + small),
                ("K9", fb.merge_gate, fb.merge_gate_plain, k9,
                 3 * tok + pooled + small)):
            ms = graph_ms(lambda: fn(*args), iters)
            bound = n_bytes / 3.35e12 * 1e3
            got, want = fn(*args), plain(*args)
            got, want = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            differ = (sum((g != w).sum().item() for g, w in zip(got, want))
                      / sum(g.numel() for g in got))
            print(f"bf16 d_inner={di} grid={grid}x{grid} B={batch}: {name} "
                  f"{ms:.4f} ms, bound {bound:.4f} ms (bytes), "
                  f"{bound / ms:.1%} of it; against the plain version: max "
                  f"abs err {err:.3e}, {differ:.2%} of the outputs differ")


def merge_times(dis=(384, 768), grid: int = 128, batch: int = 2,
                iters: int = 20) -> None:
    """Print the device time of one K10 call with LayerNorm in bf16 (a
    CUDA graph of ``iters`` calls, replayed) and a call's time by CUDA
    events, at each d_inner and in both orientations, on a grid × grid
    token grid, z the column half of one in-projection output, beside its
    byte bound (inputs read once, out written once, at 3.35 TB/s) and its
    largest difference from its plain version on the same inputs."""
    from fastvim_tpu_torch.ops.kernels import merge_gate as mg

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    L = grid * grid
    with torch.no_grad():
        for di in dis:
            xc = [rnd(batch, L, di).bfloat16() for _ in range(2)]
            z = rnd(batch, L, 2 * di).bfloat16()[..., di:]
            ys = [rnd(batch, grid, di).bfloat16() for _ in range(2)]
            vec = (rnd(di), rnd(di), 1 + rnd(di) * 0.1, rnd(di) * 0.1)
            n_bytes = (4 * batch * L * di * 2 + 2 * batch * grid * di * 2
                       + 4 * di * 4)
            bound = n_bytes / 3.35e12 * 1e3
            for pool_axes in ((1,), (0,)):
                args = (*xc, z, *ys, *vec, (grid, grid), pool_axes, 1e-5,
                        True)
                fn = lambda: mg.merge_ln_gate(*args)
                ms = graph_ms(fn, iters)
                ev = _event_ms(mg.merge_ln_gate, args, iters)
                got, want = fn(), mg.merge_ln_gate_plain(*args)
                err = (got.float() - want.float()).abs().max().item()
                differ = (got != want).float().mean().item()
                print(f"K10 bf16 d_inner={di} grid={grid}x{grid} B={batch} "
                      f"pool_axes={pool_axes}: device {ms:.4f} ms, a call "
                      f"by events {ev:.4f} ms, bound {bound:.4f} ms "
                      f"(bytes), {bound / ms:.1%} of it; against the plain "
                      f"version: max abs err {err:.3e}, {differ:.2%} of the "
                      f"outputs differ", flush=True)


def scan_times(lengths=(128, 256, 512, 1024, 4096, 16384), batch: int = 2,
               d: int = 384, n: int = 16) -> None:
    """Print one call's times of K1 and of K2 in each form, and of the
    lanes scan (forward direction), in bf16 at each length and direction,
    with the form ``fwd_route`` / ``bwd_route`` picks: the device time
    of its kernels (``torch.profiler``), which sets the route, and the
    time per call with CUDA events over a run of calls
    after a warm-up one, which at short L is the host's enqueue time. The
    forms run in turns on the same inputs (sequential, chunked, chunked,
    sequential; each form's two readings printed), the chunked form's last
    profile split by kernel. K1's calls are the forward's (softplus,
    delta_bias and D, no states asked for: the chunked form writes them all
    the same); K2's take the states K1 saved for the same inputs and a
    random dL/dy. Also prints the resident blocks per SM of K2's chunked
    phase 3."""
    import ctypes

    from fastvim_tpu_torch.ops.kernels import _build
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev) * 2 - 1
    A, bias, D = -torch.exp(uni(d, n)), 0.5 * uni(d), uni(d)
    print(card_line(), flush=True)
    blocks = ctypes.c_int(0)
    for dtype, code in (("bf16", 1), ("fp32", 0)):
        _build.check(_build.library().fv_selective_scan_bwd_chunked_occupancy(
            ctypes.addressof(blocks), code, n), "occupancy")
        print(f"K2 chunked phase 3, {dtype}, n={n}: {blocks.value} blocks "
              f"of 128 threads resident per SM", flush=True)
    for L in lengths:
        rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                                     * scale).to(torch.bfloat16)
        args = (rnd(batch, L, d), rnd(batch, L, d, scale=0.5), A,
                rnd(batch, L, n), rnd(batch, L, n))
        gy = rnd(batch, L, d)
        iters = max(10, 2 ** 19 // L)
        for reverse in (False, True):
            with torch.no_grad():
                _, states = ss.selective_scan_fwd(
                    *args, D=D, delta_bias=bias, delta_softplus=True,
                    reverse=reverse, save_states=True)
                both = ("sequential", "chunked")
                calls = {
                    "K1": (both, ss.fwd_route(L), lambda r: ss._launch_fwd(
                        r, *args, D=D, delta_bias=bias, delta_softplus=True,
                        reverse=reverse)),
                    "K2": (both, ss.bwd_route(L), lambda r: ss._launch_bwd(
                        r, *args, D, bias, gy, states, True, reverse))}
                if not reverse:  # the lanes scan runs forward only
                    calls["lanes"] = (("kernel",), "kernel", lambda _: (
                        ss.selective_scan_fwd_lanes(
                            *args, D=D, delta_bias=bias,
                            delta_softplus=True)))
                for name, (forms, pick, launch) in calls.items():
                    dev_ms = {form: [] for form in forms}
                    ev_ms = {form: [] for form in forms}
                    for form in (*forms, *reversed(forms)):
                        fn = lambda: launch(form)
                        rows, busy, _ = device_time_by_kernel(fn, 1, 5)
                        dev_ms[form].append(busy)
                        ev_ms[form].append(_event_ms(fn, (), iters))
                        if form == forms[-1]:  # its last profile, by kernel
                            phases = ", ".join(
                                f"{kname} {ms:.4f}" for kname, (ms, _)
                                in group_rows(rows).items())
                    show = lambda m: " / ".join(f"{v:.4f}" for v in m)
                    each = lambda t: ", ".join(f"{form} {show(t[form])}"
                                               for form in forms)
                    print(f"{name} bf16 B={batch} L={L} d={d} n={n} "
                          f"reverse={reverse}: device ms {each(dev_ms)} "
                          f"({phases}); ms a call {each(ev_ms)}; the "
                          f"launcher takes {pick}", flush=True)


def bwd_phase_cycles(dm: int, di: int, grid: int, batch: int) -> None:
    """Print the cycles per block and phase of one K5 and one K6 call in
    bf16 on random inputs (thread 0's clock; the kernels are built with
    -DFV_PROFILE, so call this before anything else builds them)."""
    import ctypes

    from fastvim_tpu_torch.ops.kernels import _build
    from fastvim_tpu_torch.ops.kernels import layer_fused as lf

    _build.NVCC_FLAGS.append("-DFV_PROFILE")
    lib = _build.library()
    dev = torch.device("cuda", 0)

    def read():
        buf = (ctypes.c_uint64 * 32)()
        _build.check(lib.fv_bwd_phase_cycles(buf), "fv_bwd_phase_cycles")
        return list(buf)

    b_args, a_args = _bwd_args(dm, di, grid, batch, False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    windows = batch * -(-grid * grid // lf.A_BWD_WINDOW)
    with torch.no_grad():
        for name, fn, args, phases, nblk in (
                ("K5", lf.pass_b_bwd, b_args, K5_PHASES, batch * grid),
                ("K6", lf.pass_a_bwd, a_args, K6_PHASES, min(sms, windows))):
            fn(*args)  # warm-up
            read()
            fn(*args)
            cyc = read()
            total = sum(cyc)
            print(f"{name} bf16 d_model={dm} d_inner={di} grid={grid}x{grid} "
                  f"B={batch}: {total // nblk} cycles a block, {nblk} blocks")
            for mark, what in phases:
                print(f"{cyc[mark] // nblk:10d} {cyc[mark] / total:7.1%}  "
                      f"{what}")


def det_step(config: str, batch: int) -> Tuple[Callable[[], object], str]:
    """A train-step callable of the detection config's detector, as
    ``train_detection`` builds it and its optimizer, alternating over two
    synthetic loader batches moved to the card beforehand; before
    returning, print one step's phases (features, RPN, RPN losses and
    proposals, the three stages, the backward), each timed alone."""
    from fastvim_tpu_torch.cli.train_detection import (
        build_model,
        make_det_train_step,
    )
    from fastvim_tpu_torch.config import load_config
    from fastvim_tpu_torch.data import create_detection_loader
    from fastvim_tpu_torch.train import (
        TrainState,
        make_optimizer,
        vitdet_layer_decay_scales,
        warmup_multistep,
    )
    from fastvim_tpu_torch.train.loop import to_device

    dev = torch.device("cuda", 0)
    cfg = load_config(config, "detection")
    model, depth = build_model(cfg, dev)
    loader = create_detection_loader(
        None, "train", batch, cfg["img_size"], training=True,
        max_gt=cfg.get("max_gt", 32), synthetic_samples=2 * batch,
        num_classes=cfg.get("num_classes", 80))
    batches = [to_device(b, dev) for b in loader]
    opt = cfg.get("optimizer", {})
    state = TrainState.create(model, make_optimizer(
        warmup_multistep(opt.get("lr", 1e-4), cfg.get("warmup_iters", 250),
                         cfg.get("milestones", [163889, 177546])),
        weight_decay=opt.get("weight_decay", 0.05), params=model,
        layer_scales=vitdet_layer_decay_scales(
            model, opt.get("layer_decay", 0.7), depth)))
    step = make_det_train_step(model, cfg.get("seed", 0))
    step(state, batches[1])  # warm-up

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"  {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        return out

    b = batches[0]
    gens = [torch.Generator().manual_seed(0)] * b["image"].shape[0]
    model.train()
    print(f"{config} B={batch} fp32 {cfg['img_size']}px, one step's phases:")
    feats = timed("features (backbone, FPN)", lambda: model.features(
        b["image"]))
    logits, deltas = timed("RPN head", lambda: model.rpn(feats))
    rpn, props, pvalid = timed("RPN losses and proposals", lambda: (
        model.rpn_losses(feats, logits, deltas, b["boxes"], b["gt_valid"],
                         gens)))
    casc = timed("three cascade stages and the mask head", lambda: (
        model.cascade_losses(feats, props, pvalid, b["boxes"], b["labels"],
                             b["masks"], b["gt_valid"], gens)))
    total = sum(rpn.values()) + sum(casc.values())
    timed("backward", lambda: torch.autograd.grad(
        total, list(model.parameters())))
    del feats, logits, deltas, rpn, casc, total
    calls = iter(range(1 << 30))
    return (lambda: step(state, batches[next(calls) % 2]),
            f"{config} B={batch} fp32 train step")


def lm_step(kind: str, batch: int, seq_len: int, dtype: torch.dtype
            ) -> Tuple[Callable[[], object], str]:
    """A callable that runs one LM prefill of ``batch`` × ``seq_len``
    tokens (``kind="prefill"``) or one cached decode step of ``batch``
    tokens, each call advancing the caches of a 16-token prefill
    (``kind="decode"``), at mamba-130m's widths, seeded random weights;
    and what it profiles."""
    from fastvim_tpu_torch.models.lm import create_lm

    dev = torch.device("cuda", 0)
    model = create_lm(dev, torch.Generator().manual_seed(0), dtype=dtype,
                      vocab_size=50277, d_model=768, n_layer=24, d_state=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = lambda L: torch.randint(50277, (batch, L), device=dev,
                                   generator=gen)
    what = f"mamba-130m widths {dtype} B={batch} "
    if kind == "prefill":
        x = toks(seq_len)

        def fn():
            with torch.inference_mode():
                return model(x, prefill=True)

        return fn, what + f"prefill of {seq_len} tokens"
    with torch.inference_mode():
        logits, caches = model(toks(16), prefill=True)
    state = {"caches": caches, "next": logits[:, -1:].argmax(-1)}

    def step():
        with torch.inference_mode():
            logits, state["caches"] = model(state["next"],
                                            caches=state["caches"])
            state["next"] = logits[:, -1:].argmax(-1)

    return step, what + "decode step (after a 16-token prefill)"


def captured_forward(model, image: torch.Tensor) -> Callable[[], object]:
    """The model's forward on a static input, captured as a CUDA graph
    after three eager warm-up calls on a side stream; returns the replay,
    whose launches cost the host one call. The kernels' launch counters
    count the capture's launches only."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(stream):
        for _ in range(3):
            model(image)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        model(image)
    return graph.replay


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="fastvim_tiny",
                    help="a registered model; with the --*-times options "
                         "a comma-separated list of them")
    ap.add_argument("--img", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=None,
                    help="default 3; with --det the config's")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--train", action="store_true",
                    help="a supervised train step instead of a forward")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--layer-fused", default=None,
                    help="the model's layer_fused field (e.g. recompute)")
    ap.add_argument("--layer-fused-bwd", default=None,
                    choices=("fused", "remat"),
                    help="the model's layer_fused_bwd field")
    ap.add_argument("--fused-kernels", default=None,
                    choices=("always", "merge"),
                    help="the mixers' ssm_cfg fused_kernels field (K8 and "
                         "K9, or K9 alone; layer_fused off unless given)")
    ap.add_argument("--fused-merge", action="store_true",
                    help="the mixers' ssm_cfg fused_merge field (K10; "
                         "layer_fused off unless given)")
    ap.add_argument("--graph", action="store_true",
                    help="profile replays of the forward captured as a CUDA "
                         "graph")
    ap.add_argument("--fwd-times", action="store_true",
                    help="time K3 and K4 alone at the model's widths")
    ap.add_argument("--rc-times", action="store_true",
                    help="time K7 and K3's pools-only form alone at the "
                         "model's widths")
    ap.add_argument("--fb-times", action="store_true",
                    help="time K8 and K9 alone at the model's widths")
    ap.add_argument("--mg-times", action="store_true",
                    help="time K10 alone at FastVim-T's and FastVim-S's "
                         "widths")
    ap.add_argument("--bwd-times", action="store_true",
                    help="time K5 and K6 alone at the model's widths")
    ap.add_argument("--bwd-phases", action="store_true",
                    help="cycles per phase of K5 and K6 at the model's widths")
    ap.add_argument("--scan-times", action="store_true",
                    help="time the sequential and chunked forms of K1 "
                         "and K2 at L = 128 to 16,384")
    ap.add_argument("--lengths", default="128,256,512,1024,4096,16384",
                    help="the scan lengths of --scan-times, comma-separated")
    ap.add_argument("--det", default=None, metavar="CONFIG",
                    help="profile a train step of this detection config")
    ap.add_argument("--lm", default=None, choices=("prefill", "decode"),
                    help="profile the LM at mamba-130m's widths: a prefill "
                         "or a cached decode step")
    ap.add_argument("--seq-len", type=int, default=2048,
                    help="the prefill's tokens with --lm prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    if args.det:
        from fastvim_tpu_torch.config import load_config

        fn, what = det_step(args.det, args.batch or load_config(
            args.det, "detection")["batch_size"])
        return print_profile(fn, what, args.top)
    if args.batch is None:
        args.batch = 3
    if args.lm:
        fn, what = lm_step(args.lm, args.batch, args.seq_len,
                           getattr(torch, args.dtype))
        return print_profile(fn, what, args.top)
    if args.scan_times:
        return scan_times(tuple(int(L) for L in args.lengths.split(",")))
    if args.mg_times:
        print(card_line(), flush=True)
        return merge_times(grid=args.img // 16, batch=args.batch)
    if args.graph and args.train:
        raise SystemExit("profiling: --graph captures a forward only")
    if (args.bwd_phases or args.bwd_times or args.fwd_times or args.rc_times
            or args.fb_times):
        from fastvim_tpu_torch.models.registry import _SIZES

        if not args.bwd_phases:
            print(card_line(), flush=True)
        for name in args.model.split(","):
            size = _SIZES[name.split("_", 1)[1]]
            dm = size["embed_dim"]  # d_inner = 2 · d_model in every model
            shape = (dm, 2 * dm, args.img // size["patch_size"], args.batch)
            if args.bwd_phases:
                bwd_phase_cycles(*shape)
            elif args.fb_times:
                block_times(*shape[1:])
            else:
                kernel_times(*shape, fwd=args.fwd_times or args.rc_times,
                             recompute=args.rc_times,
                             dtype=getattr(torch, args.dtype))
        return None

    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_train_step,
    )

    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    fields = {} if args.layer_fused is None else dict(
        layer_fused=args.layer_fused)
    if args.layer_fused_bwd is not None:
        fields["layer_fused_bwd"] = args.layer_fused_bwd
    if args.fused_kernels is not None or args.fused_merge:
        cfg = ({"fused_merge": True} if args.fused_merge
               else {"fused_kernels": args.fused_kernels})
        fields = {"layer_fused": "off", **fields, "ssm_cfg": cfg}
    model = create_model(args.model, img_size=args.img, dtype=dtype,
                         drop_path_rate=0.0, **fields)
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
    elif args.graph:
        fn = captured_forward(model, batch["image"])
    else:
        def fn():
            with torch.inference_mode():
                return model(batch["image"])

    what = ("train step" if args.train
            else "forward, CUDA-graph replay" if args.graph else "forward")
    print_profile(fn, f"{args.model} {fields} {args.img}px B={args.batch} "
                  f"{args.dtype} {what}", args.top)


def print_profile(fn: Callable[[], object], what: str, top: int) -> None:
    """``device_time_by_kernel(fn)`` as a table: wall and busy ms a call,
    the idle share, the peak device memory, and the ``top`` kernel
    groups."""
    torch.cuda.reset_peak_memory_stats()
    rows, busy_ms, wall_ms = device_time_by_kernel(fn)
    print(f"{what} ({card_line()}): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, "
          f"{sum(r[2] for r in rows)} kernels and copies launched, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"{'ms/step':>10} {'share':>7} {'launches':>9}  kernel")
    for name, (ms, count) in list(group_rows(rows).items())[:top]:
        print(f"{ms:10.3f} {ms / busy_ms:7.1%} {count:9d}  {name[:90]}")


if __name__ == "__main__":
    main()
