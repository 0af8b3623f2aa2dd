"""The port's CUDA kernels against their plain versions, on the card.

chip_smoke.py checks the kernels at the main path's shapes; these tests
cover the rest of what the kernels accept, forward and backward: odd
grids, lines long enough for several GEMM passes or 32-token tiles,
biases, no LayerNorm, d_state 8, partial token tiles, wider models, the
autograd Functions end to end, and the wrappers' refusals. Without an NVIDIA GPU
every test skips. On a GPU machine (which need not have JAX, imported by
tests/conftest.py) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances as in chip_smoke.py: atol = rtol = 1e-4 in fp32 (sums in
another order) and 2e-2 in bf16 (outputs rounded to bf16 on both sides);
for a gradient summed over every token or step, atol is scaled by the
tensor's largest entry (a long fp32 sum rounds with the size of its
terms, not of the result).
"""

import pytest
import torch

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels import selective_scan as ss
from fastvim_tpu_torch.ops.scan import selective_scan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, tol, summed=False):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    atol = tol * max(1.0, want.float().abs().max().item()) if summed else tol
    bound = atol + tol * want.float().abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}"


def _close_all(got, want, tol, n_per_token):
    """The first n_per_token outputs per token or step, the rest summed."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, summed=i >= n_per_token)


def _rand(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device=g.device) * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,n,reverse,batch", [
    (37, 16, False, 2),    # one partial chunk
    (200, 16, True, 3),    # 4 chunks, the last partial, reversed
    (130, 8, False, 1),    # d_state 8
    (1, 16, True, 2),      # a single step
])
def test_scan_kernel_matches_plain(dev, dtype, L, n, reverse, batch):
    g = torch.Generator(device=dev).manual_seed(L)
    d = 64
    args = (_rand(g, batch, L, d).to(dtype),
            _rand(g, batch, L, d, scale=0.5).to(dtype),
            -torch.exp(_rand(g, d, n, scale=0.5)),
            _rand(g, batch, L, n).to(dtype), _rand(g, batch, L, n).to(dtype))
    kw = dict(D=_rand(g, d), delta_bias=_rand(g, d, scale=0.3),
              delta_softplus=True, reverse=reverse)
    with torch.no_grad():
        _close(ss.selective_scan_fwd(*args, **kw),
               ss.selective_scan_plain(*args, **kw), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,n,reverse,batch,extras", [
    (37, 16, False, 2, True),    # one partial chunk
    (200, 16, True, 3, True),    # 4 chunks, the last partial, reversed
    (130, 8, False, 1, False),   # d_state 8, no D and no delta_bias
    (1, 16, True, 2, True),      # a single step
])
def test_scan_bwd_kernel_matches_plain(dev, dtype, L, n, reverse, batch,
                                       extras):
    g = torch.Generator(device=dev).manual_seed(L + 1)
    d = 64
    ins = (_rand(g, batch, L, d).to(dtype),
           _rand(g, batch, L, d, scale=0.5).to(dtype),
           -torch.exp(_rand(g, d, n, scale=0.5)),
           _rand(g, batch, L, n).to(dtype), _rand(g, batch, L, n).to(dtype),
           _rand(g, d) if extras else None,
           _rand(g, d, scale=0.3) if extras else None)
    gy = _rand(g, batch, L, d).to(dtype)
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(
            *ins[:5], D=ins[5], delta_bias=ins[6], delta_softplus=True,
            reverse=reverse, save_states=True)
        got = ss.selective_scan_bwd(*ins, gy, states, True, reverse)
        want = ss.selective_scan_bwd_plain(*ins, gy, True, reverse)
    order = (0, 1, 3, 4, 2, 5, 6)  # du, ddelta, dB, dC per step; then sums
    _close_all([got[i] for i in order], [want[i] for i in order], TOL[dtype],
               4)


def test_scan_function_grads_match_cpu(dev):
    """selective_scan on CUDA tensors that require grad goes through K1
    (with states) and K2, and gives the CPU's gradients."""
    g = torch.Generator().manual_seed(9)
    batch, L, d, n = 2, 150, 64, 16
    base = [torch.randn(batch, L, d, generator=g),
            torch.randn(batch, L, d, generator=g) * 0.5,
            -torch.exp(torch.randn(d, n, generator=g) * 0.5),
            torch.randn(batch, L, n, generator=g),
            torch.randn(batch, L, n, generator=g), torch.randn(d, generator=g),
            torch.randn(d, generator=g) * 0.3]
    w = torch.randn(batch, L, d, generator=g)

    def grads(device):
        ins = [t.to(device).requires_grad_() for t in base]
        y = selective_scan(*ins[:5], D=ins[5], delta_bias=ins[6],
                           delta_softplus=True, reverse=True)
        return torch.autograd.grad((y * w.to(device)).sum(), ins)

    kernels.reset_launch_counts()
    got, want = grads(dev), grads("cpu")
    counts = kernels.launch_counts()
    assert counts["selective_scan_fwd"] == counts["selective_scan_bwd"] == 1
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.cpu(), b, 1e-4, summed=i in (2, 5, 6))


def _pass_a_args(g, dtype, batch, H, W, dm, di, bias, transposed):
    cb = (lambda: _rand(g, di, scale=0.3)) if bias else (lambda: None)
    return (_rand(g, batch, H, W, dm).to(dtype),
            _rand(g, di, dm, scale=dm ** -0.5).to(dtype), cb(),
            _rand(g, di, 4, scale=0.5), cb(), _rand(g, di, 4, scale=0.5),
            cb(), 0.5 if bias else 1.0, transposed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias", [
    ((6, 10), False, 3, 64, 128, False),
    ((6, 10), True, 3, 64, 128, True),
    ((4, 200), False, 1, 64, 128, True),   # 206-token lines: 2 GEMM passes
    ((170, 5), True, 1, 64, 128, False),   # 176-token columns: 2 passes
    ((8, 8), True, 2, 384, 768, False),    # FastVim-S widths
])
def test_pass_a_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                              bias):
    g = torch.Generator(device=dev).manual_seed(dm + grid[0])
    args = _pass_a_args(g, dtype, batch, *grid, dm, di, bias, transposed)
    with torch.no_grad():
        for got, want in zip(lf.pass_a(*args), lf.pass_a_plain(*args)):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    ((6, 10), False, 3, 64, 128, False, True),   # 180 tokens: partial tile
    ((6, 10), True, 3, 64, 128, True, False),
    ((8, 8), True, 2, 384, 768, True, True),     # two 384-column slabs
])
def test_pass_b_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                              bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(di + grid[1])
    H, W = grid
    P = W if transposed else H
    cb = (lambda k: _rand(g, k, scale=0.3)) if bias else (lambda k: None)
    args = (_rand(g, batch, H, W, dm).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
            _rand(g, di, dm, scale=dm ** -0.5).to(dtype), cb(di),
            _rand(g, di), _rand(g, di), 1 + _rand(g, di, scale=0.1),
            _rand(g, di, scale=0.1),
            _rand(g, dm, di, scale=di ** -0.5).to(dtype), cb(dm), 1e-5,
            use_ln, transposed)
    with torch.no_grad():
        _close(lf.pass_b(*args), lf.pass_b_plain(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    ((6, 10), False, 3, 64, 128, False, True),
    ((6, 10), True, 3, 64, 128, True, False),
    ((5, 70), False, 2, 64, 128, True, True),    # 70-token lines: 3 tiles
    ((70, 5), True, 2, 64, 128, False, True),    # the same down columns
    ((4, 4), True, 2, 64, 128, True, True),      # the smallest grid
    ((8, 8), True, 2, 192, 384, True, True),     # FastVim-T widths
])
def test_pass_b_bwd_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                                  bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(di + grid[1] + 1)
    H, W = grid
    P = W if transposed else H
    args = (_rand(g, batch, H, W, dm).to(dtype),
            _rand(g, batch, H, W, dm).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
            _rand(g, di, dm, scale=dm ** -0.5).to(dtype),
            _rand(g, di, scale=0.3) if bias else None,
            _rand(g, di), _rand(g, di), 1 + _rand(g, di, scale=0.1),
            _rand(g, di, scale=0.1),
            _rand(g, dm, di, scale=di ** -0.5).to(dtype), 1e-5, use_ln,
            transposed)
    with torch.no_grad():
        _close_all(lf.pass_b_bwd(*args), lf.pass_b_bwd_plain(*args),
                   TOL[dtype], 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias", [
    ((6, 10), False, 3, 64, 128, False),
    ((6, 10), True, 3, 64, 128, True),
    ((4, 200), False, 1, 64, 128, True),   # 206-token lines: 2 GEMM passes
    ((170, 5), True, 1, 64, 128, False),   # 176-token columns: 2 passes
    ((8, 8), True, 2, 192, 384, False),    # FastVim-T widths
    ((4, 4), False, 2, 64, 128, True),     # the smallest grid
])
def test_pass_a_bwd_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                                  bias):
    g = torch.Generator(device=dev).manual_seed(dm + grid[0] + 1)
    H, W = grid
    P = W if transposed else H
    x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, _ = _pass_a_args(
        g, dtype, batch, H, W, dm, di, bias, transposed)
    args = (x4, _rand(g, batch, H, W, dm), _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
            w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, transposed)
    with torch.no_grad():
        _close_all(lf.pass_a_bwd(*args), lf.pass_a_bwd_plain(*args),
                   TOL[dtype], 1)


@pytest.mark.parametrize("bwd_mode", ["fused", "remat"])
@pytest.mark.parametrize("transposed", [False, True])
def test_fused_layer_grads_match_cpu(dev, transposed, bwd_mode):
    """fused_mixer_core with gradients on CUDA: K3, K1 ×2, K4 forward and
    K5, K2 ×2, K6 backward (fused), or K1/K2 twice more through the
    recomputed unfused math (remat); the gradients of x̂ and of all 20
    parameters agree with the same layer on the CPU."""
    g = torch.Generator().manual_seed(4)
    dm, di, r, n = 64, 128, 4, 16
    u = lambda *s, b=0.2: (torch.rand(*s, generator=g) * 2 - 1) * b
    p = lf.FusedParams(u(2 * di, dm), u(2 * di), u(di, 4), u(di), u(di, 4),
                       u(di), u(r + 2 * n, di), u(di, r), u(di, b=0.5),
                       u(di, n, b=1), u(di), u(r + 2 * n, di), u(di, r),
                       u(di, b=0.5), u(di, n, b=1), u(di), 1 + u(di, b=0.1),
                       u(di, b=0.1), u(dm, di), u(dm))
    x = torch.randn(2, 6 * 10, dm, generator=g)
    w = torch.randn(2, 6 * 10, dm, generator=g)

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (x,) + tuple(p)]
        out = lf.fused_mixer_core(leaves[0], lf.FusedParams(*leaves[1:]),
                                  (6, 10), transposed, 0.5, 1e-5, True,
                                  torch.float32, bwd_mode=bwd_mode)
        return torch.autograd.grad((out * w.to(device)).sum(), leaves)

    kernels.reset_launch_counts()
    got = grads(dev)
    fused = bwd_mode == "fused"
    assert kernels.launch_counts() == {
        "selective_scan_fwd": 2 if fused else 4, "selective_scan_bwd": 2,
        "pass_a_fwd": 1, "pass_b_fwd": 1, "pass_b_bwd": int(fused),
        "pass_a_bwd": int(fused)}
    for a, b in zip(got, grads("cpu")):
        _close(a.cpu(), b, 1e-4, summed=True)


def test_fused_layer_launches_each_kernel(dev):
    """fused_mixer_core on CUDA runs pass A, two K1 scans and pass B, and
    agrees with the same layer on the CPU."""
    g = torch.Generator().manual_seed(3)
    dm, di, r, n = 64, 128, 4, 16
    u = lambda *s, b=0.2: (torch.rand(*s, generator=g) * 2 - 1) * b
    p = lf.FusedParams(u(2 * di, dm), None, u(di, 4), u(di), u(di, 4), u(di),
                       u(r + 2 * n, di), u(di, r), u(di, b=0.5), u(di, n, b=1),
                       u(di), u(r + 2 * n, di), u(di, r), u(di, b=0.5),
                       u(di, n, b=1), u(di), 1 + u(di, b=0.1), u(di, b=0.1),
                       u(dm, di), None)
    x = torch.randn(2, 6 * 10, dm, generator=g)
    args = ((6, 10), True, 1.0, 1e-5, True, torch.float32)
    want = lf.fused_mixer_core(x, p, *args)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = lf.fused_mixer_core(
            x.to(dev), lf.FusedParams(*(None if t is None else t.to(dev)
                                        for t in p)), *args)
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.LAUNCHES, 0), "selective_scan_fwd": 2,
        "pass_a_fwd": 1, "pass_b_fwd": 1}
    _close(got.cpu(), want, 1e-4)


def test_wrappers_refuse(dev):
    """Grad-requiring inputs, non-contiguous or unaligned tensors and
    unsupported dtypes raise instead of falling back."""
    g = torch.Generator(device=dev).manual_seed(0)
    u = _rand(g, 1, 8, 64)
    A = -torch.ones(64, 16, device=dev)
    B = _rand(g, 1, 8, 16)
    with pytest.raises(RuntimeError, match="requires grad"):
        ss.selective_scan_fwd(u.requires_grad_(), u.detach(), A, B, B)
    u = u.detach()
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan_fwd(_rand(g, 1, 64, 8).transpose(1, 2), u, A, B, B)
    with pytest.raises(TypeError, match="not supported"):
        h = u.half()
        ss.selective_scan_fwd(h, h, A, B.half(), B.half())
    flat = _rand(g, 8 * 64 + 4)
    with pytest.raises(ValueError, match="32-byte"):
        ss.selective_scan_fwd(flat[4:].view(1, 8, 64), u, A, B, B)
    # the backward launchers too: no grad-requiring input, states from K1,
    # and no d_inner wider than K5 holds
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(u, u, A, B, B, save_states=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ss.selective_scan_bwd(u.clone().requires_grad_(), u, A, B, B, None,
                              None, u, states)
    with pytest.raises(ValueError, match="states must be"):
        ss.selective_scan_bwd(u, u, A, B, B, None, None, u, states[:, :, :8])
    x4, wide = _rand(g, 1, 8, 8, 64), _rand(g, 1, 8, 8, 768)
    y, v = _rand(g, 1, 8, 768), _rand(g, 768)
    wide_p = lf.FusedParams(*([None] * 2), v.new_zeros(768, 4),
                            *([None] * 17))
    with pytest.raises(ValueError, match="bwd_mode='remat'"):
        lf.fused_mixer_core(_rand(g, 1, 64, 64).requires_grad_(), wide_p,
                            (8, 8), False, 1.0, 1e-5, True, torch.float32)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        selective_scan(_rand(g, 1, 8, 12).requires_grad_(), _rand(g, 1, 8, 12),
                       -torch.ones(12, 16, device=dev), B, B)
    with pytest.raises(ValueError, match="d_inner <= 384"):
        lf.pass_b_bwd(x4, x4, wide, wide, y, y, _rand(g, 768, 64), None, v, v,
                      v, v, _rand(g, 64, 768), 1e-5, True, False)
