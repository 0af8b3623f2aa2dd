"""The port's CUDA kernels against their plain versions, on the card.

chip_smoke.py checks the kernels at the main path's shapes; these tests
cover the rest of what the kernels accept: odd grids, lines long enough
for several GEMM passes, biases, no LayerNorm, d_state 8, partial token
tiles, wider models, and the wrappers' refusals. Without an NVIDIA GPU
every test skips. On a GPU machine (which need not have JAX, imported by
tests/conftest.py) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances as in chip_smoke.py: atol = rtol = 1e-4 in fp32 (sums in
another order) and 2e-2 in bf16 (outputs rounded to bf16 on both sides).
"""

import pytest
import torch

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels import selective_scan as ss

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


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}"


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
    assert kernels.launch_counts() == {"selective_scan_fwd": 2,
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
