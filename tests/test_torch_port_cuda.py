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
from fastvim_tpu_torch.ops.kernels import fused_block as fb
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels import merge_gate as mg
from fastvim_tpu_torch.ops.kernels import selective_scan as ss
from fastvim_tpu_torch.ops.scan import selective_scan
from fastvim_tpu_torch.utils.profiling import kernels_a_call

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


def _scan_args(g, dtype, batch, L, d, n, extras=True):
    ins = (_rand(g, batch, L, d).to(dtype),
           _rand(g, batch, L, d, scale=0.5).to(dtype),
           -torch.exp(_rand(g, d, n, scale=0.5)),
           _rand(g, batch, L, n).to(dtype), _rand(g, batch, L, n).to(dtype))
    kw = dict(D=_rand(g, d) if extras else None,
              delta_bias=_rand(g, d, scale=0.3) if extras else None)
    return ins, kw


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,L,n,batch,d", [
    (dt, *shape) for dt in DTYPES for shape in (
        (65, 16, 2, 64),     # one full chunk and one step
        (200, 8, 3, 36),     # a partial last chunk; d not a multiple of 64
        (1024, 16, 2, 64),   # 16 chunks
        (4096, 8, 2, 96))
] + [(torch.float32, 16385, 16, 1, 64)])  # Vim's middle-cls-token length
def test_scan_chunked_matches_plain(dev, dtype, L, n, batch, d, reverse):
    """K1's chunked form against its plain version (y and the chunk-entry
    states) and against the sequential kernel's states."""
    g = torch.Generator(device=dev).manual_seed(L + n)
    ins, kw = _scan_args(g, dtype, batch, L, d, n, extras=L != 200)
    with torch.no_grad():
        y, states = ss._launch_fwd(
            "chunked", *ins, **kw, delta_softplus=True, reverse=reverse,
            save_states=True)
        want_y, want_states = ss.selective_scan_fwd_chunked_plain(
            *ins, kw["D"], kw["delta_bias"], True, reverse)
        _, seq_states = ss._launch_fwd(
            "sequential", *ins, **kw, delta_softplus=True, reverse=reverse,
            save_states=True)
    _close(y, want_y, TOL[dtype])
    _close(states, want_states, TOL[torch.float32])
    _close(states, seq_states, TOL[torch.float32])


def test_scan_chunked_is_the_long_route_and_repeatable(dev):
    """From CHUNKED_MIN_L steps on the launcher takes the chunked form
    (one counted launch a call), and it gives the same bits every run."""
    assert ss.fwd_route(ss.CHUNKED_MIN_L) == "chunked"
    g = torch.Generator(device=dev).manual_seed(5)
    ins, kw = _scan_args(g, torch.bfloat16, 2, 4096, 64, 16)
    kw.update(delta_softplus=True, reverse=True, save_states=True)
    with torch.no_grad():
        kernels.reset_launch_counts()
        first = ss.selective_scan_fwd(*ins, **kw)
        assert kernels.launch_counts()["selective_scan_fwd"] == 1
        for _ in range(3):
            again = ss._launch_fwd("chunked", *ins, **kw)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_from_chunked_states(dev, dtype, reverse):
    """K2 rebuilding h from the states the chunked form saved (L long
    enough for the launcher to take it, a partial last chunk) gives the
    plain adjoint."""
    L = ss.CHUNKED_MIN_L + 37
    assert ss.fwd_route(L) == "chunked"
    g = torch.Generator(device=dev).manual_seed(L + reverse)
    ins, kw = _scan_args(g, dtype, 2, L, 64, 16)
    ins = ins + (kw["D"], kw["delta_bias"])
    gy = _rand(g, 2, L, 64).to(dtype)
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(
            *ins[:5], D=ins[5], delta_bias=ins[6], delta_softplus=True,
            reverse=reverse, save_states=True)
        got = ss.selective_scan_bwd(*ins, gy, states, True, reverse)
        want = ss.selective_scan_bwd_plain(*ins, gy, True, reverse)
    order = (0, 1, 3, 4, 2, 5, 6)  # du, ddelta, dB, dC per step; then sums
    _close_all([got[i] for i in order], [want[i] for i in order], TOL[dtype],
               4)


_BWD_ORDER = (0, 1, 3, 4, 2, 5, 6)  # du, ddelta, dB, dC per step; then sums


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,L,n,batch,d", [
    (dt, *shape) for dt in DTYPES for shape in (
        (65, 16, 2, 64),     # one full chunk and one step
        (200, 8, 3, 72),     # a partial last chunk; d ≡ 8 (mod 64): a slot
                             # of 8 channels, half a pass of d_state 8
        (1024, 16, 2, 72),   # 16 chunks, a slot of 8 channels
        (4096, 8, 2, 64))
] + [(torch.float32, 16385, 16, 1, 64)])  # Vim's middle-cls-token length
def test_scan_bwd_chunked_matches_plain(dev, dtype, L, n, batch, d, reverse):
    """K2's chunked form against the sequential plain adjoint, its own
    plain version (the three phases in tensor ops) and the sequential
    kernel, all from the states K1 saved."""
    g = torch.Generator(device=dev).manual_seed(L + n + 7)
    ins, kw = _scan_args(g, dtype, batch, L, d, n, extras=L != 200)
    ins = ins + (kw["D"], kw["delta_bias"])
    gy = _rand(g, batch, L, d).to(dtype)
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(
            *ins[:5], D=ins[5], delta_bias=ins[6], delta_softplus=True,
            reverse=reverse, save_states=True)
        got = ss._launch_bwd("chunked", *ins, gy, states, True, reverse)
        for want in (
                ss.selective_scan_bwd_plain(*ins, gy, True, reverse),
                ss.selective_scan_bwd_chunked_plain(*ins, gy, states, True,
                                                    reverse),
                ss._launch_bwd("sequential", *ins, gy, states, True,
                               reverse)):
            _close_all([got[i] for i in _BWD_ORDER],
                       [want[i] for i in _BWD_ORDER], TOL[dtype], 4)


def test_scan_bwd_chunked_is_the_long_route_and_repeatable(dev):
    """From the threshold on the launcher takes K2's chunked form (one
    counted launch a call), below it the sequential one, and the chunked
    form gives the same bits every run (no atomics)."""
    assert ss.bwd_route(ss.CHUNKED_BWD_MIN_L) == "chunked"
    assert ss.bwd_route(ss.CHUNKED_BWD_MIN_L - 1) == "sequential"
    g = torch.Generator(device=dev).manual_seed(6)
    ins, kw = _scan_args(g, torch.bfloat16, 2, 4096, 64, 16)
    ins = ins + (kw["D"], kw["delta_bias"])
    gy = _rand(g, 2, 4096, 64).to(torch.bfloat16)
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(
            *ins[:5], D=ins[5], delta_bias=ins[6], delta_softplus=True,
            reverse=True, save_states=True)
        kernels.reset_launch_counts()
        first = ss.selective_scan_bwd(*ins, gy, states, True, True)
        assert kernels.launch_counts()["selective_scan_bwd"] == 1
        for _ in range(3):
            again = ss._launch_bwd("chunked", *ins, gy, states, True, True)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


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


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["sequential", "chunked"])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 511, 512, 2048])
def test_scan_gate_and_last_state_match_plain(dev, L, form, dtype, reverse):
    """K1's gate (y · silu(z) before the one rounding, z a column slice of
    a wider tensor, as the LM's in-projection gives it) and its final
    state, in both forms, against the plain version: y within the dtype's
    tolerance, the fp32 state within fp32's (both sides scan the same
    rounded inputs in fp32). The chunk-entry states are those of a call
    without the gate and the final state."""
    g = torch.Generator(device=dev).manual_seed(3 * L + reverse)
    batch, d, n = 2, 64, 16
    ins, kw = _scan_args(g, dtype, batch, L, d, n)
    z = _rand(g, batch, L, 2 * d).to(dtype)[..., d:]
    kw.update(delta_softplus=True, reverse=reverse)
    with torch.no_grad():
        y, states, last = ss._launch_fwd(form, *ins, **kw, save_states=True,
                                         z=z, return_last_state=True)
        want_y, want_last = ss.selective_scan_plain(
            *ins, **kw, z=z.contiguous(), return_last_state=True)
        _, bare_states = ss._launch_fwd(form, *ins, **kw, save_states=True)
    assert last.shape == (batch, d, n) and last.dtype == torch.float32
    _close(y, want_y, TOL[dtype])
    _close(last, want_last, TOL[torch.float32])
    assert torch.equal(states, bare_states)


def test_scan_gate_and_last_state_through_the_dispatch(dev):
    """``selective_scan`` with z and ``return_last_state`` on CUDA tensors
    is one K1 launch, and so is the LM's prefill scan on the card: its
    result equals the launcher's."""
    g = torch.Generator(device=dev).manual_seed(12)
    ins, kw = _scan_args(g, torch.bfloat16, 2, 700, 64, 16)
    z = _rand(g, 2, 700, 64).to(torch.bfloat16)
    with torch.no_grad():
        kernels.reset_launch_counts()
        y, last = selective_scan(*ins, **kw, delta_softplus=True, z=z,
                                 return_last_state=True)
        assert kernels.launch_counts()["selective_scan_fwd"] == 1
        wy, wlast = ss._launch_fwd("chunked", *ins, **kw, delta_softplus=True,
                                   z=z, return_last_state=True)
    assert torch.equal(y, wy) and torch.equal(last, wlast)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_chunked_unchanged_by_the_final_state(dev, reverse):
    """K2's chunked form shares the state pass with K1, and passes it no
    final-state pointer: from the states of a K1 call that wrote its
    final state and of one that did not, K2 gives the same bits, and the
    plain adjoint."""
    L = 1024 + 37
    g = torch.Generator(device=dev).manual_seed(L + reverse)
    ins, kw = _scan_args(g, torch.float32, 2, L, 64, 16)
    ins = ins + (kw["D"], kw["delta_bias"])
    gy = _rand(g, 2, L, 64)
    fwd = dict(D=ins[5], delta_bias=ins[6], delta_softplus=True,
               reverse=reverse, save_states=True)
    with torch.no_grad():
        _, states, _ = ss._launch_fwd("chunked", *ins[:5], **fwd,
                                      return_last_state=True)
        _, bare = ss._launch_fwd("chunked", *ins[:5], **fwd)
        got = ss._launch_bwd("chunked", *ins, gy, states, True, reverse)
        again = ss._launch_bwd("chunked", *ins, gy, bare, True, reverse)
        want = ss.selective_scan_bwd_plain(*ins, gy, True, reverse)
    assert torch.equal(states, bare)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close_all([got[i] for i in _BWD_ORDER], [want[i] for i in _BWD_ORDER],
               TOL[torch.float32], 4)


def test_scan_function_gate_grads_match_cpu(dev):
    """The gate's gradient through ``SelectiveScanFn`` on the card (K1 with
    z forward, K1 again without it and K2 backward) against the CPU's."""
    g = torch.Generator().manual_seed(10)
    batch, L, d, n = 2, 600, 64, 16
    base = [torch.randn(batch, L, d, generator=g),
            torch.randn(batch, L, d, generator=g) * 0.5,
            -torch.exp(torch.randn(d, n, generator=g) * 0.5),
            torch.randn(batch, L, n, generator=g),
            torch.randn(batch, L, n, generator=g), torch.randn(d, generator=g),
            torch.randn(d, generator=g) * 0.3,
            torch.randn(batch, L, d, generator=g)]
    w = torch.randn(batch, L, d, generator=g)

    def grads(device):
        ins = [t.to(device).requires_grad_() for t in base]
        y, _ = selective_scan(*ins[:5], D=ins[5], delta_bias=ins[6],
                              z=ins[7], delta_softplus=True,
                              return_last_state=True)
        return torch.autograd.grad((y * w.to(device)).sum(), ins)

    kernels.reset_launch_counts()
    got, want = grads(dev), grads("cpu")
    counts = kernels.launch_counts()
    assert counts["selective_scan_fwd"] == 2
    assert counts["selective_scan_bwd"] == 1
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.cpu(), b, 1e-4, summed=i in (2, 5, 6))


def test_lm_prefill_decode_on_the_card(dev):
    """A small LM (d_model 64, 2 layers, d_state 16) on the card against
    the same weights on the CPU: prefill logits and caches (2 K1 launches)
    and two decode steps (no kernel launch), within 1e-4."""
    from fastvim_tpu_torch.models.lm import create_lm

    cpu = create_lm("cpu", vocab_size=100, d_model=64, n_layer=2)
    card = create_lm(dev, vocab_size=100, d_model=64, n_layer=2)
    toks = torch.randint(0, 100, (2, 70), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        kernels.reset_launch_counts()
        got, caches = card(toks.to(dev), prefill=True)
        assert kernels.launch_counts()["selective_scan_fwd"] == 2
        want, wcaches = cpu(toks, prefill=True)
        _close(got.cpu(), want, 1e-4)
        for step in range(2):
            for (a, b), (c, e) in zip(caches, wcaches):
                _close(a.cpu(), c, 1e-4)
                _close(b.cpu(), e, 1e-4)
            nxt = toks[:, step:step + 1]
            kernels.reset_launch_counts()
            got, caches = card(nxt.to(dev), caches=caches)
            assert sum(kernels.launch_counts().values()) == 0
            want, wcaches = cpu(nxt, caches=wcaches)
            _close(got.cpu(), want, 1e-4)


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
    ((128, 128), False, 2, 192, 384, True),  # FastVim-T at 2048 px
    ((128, 128), True, 2, 192, 384, False),
    ((6, 10), False, 2, 96, 192, True),    # d_model zero-padded to 128
    ((10, 6), True, 2, 160, 320, False),   # ... and to 192
    ((5, 63), False, 2, 64, 128, True),    # lines of 63, 64 and 65 tokens
    ((64, 5), True, 2, 64, 128, False),
    ((4, 65), False, 2, 128, 192, True),
    ((65, 4), True, 2, 128, 192, False),
    ((4, 200), False, 1, 384, 768, True),  # two segments at FastVim-S widths
    # runs of whole lines (fp32: up to 122 tokens a block) over 3-4 images:
    # 224 px (runs of 8 + 6 lines), 256 px (7 + 7 + 2), lines of 4 and 7
    ((14, 14), False, 3, 192, 384, True),
    ((14, 14), True, 3, 192, 384, False),
    ((16, 16), False, 3, 96, 192, True),
    ((16, 16), True, 4, 192, 384, False),
    ((4, 4), False, 3, 64, 128, True),
    ((9, 7), True, 3, 64, 128, True),
    ((40, 7), False, 2, 64, 128, False),   # 17 + 17 + 6 lines of 7
    ((7, 40), True, 2, 160, 320, True),
])
def test_pass_a_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                              bias):
    g = torch.Generator(device=dev).manual_seed(dm + grid[0])
    args = _pass_a_args(g, dtype, batch, *grid, dm, di, bias, transposed)
    with torch.no_grad():
        for got, want in zip(lf.pass_a(*args), lf.pass_a_plain(*args)):
            _close(got, want, TOL[dtype])


def _pass_b_args(g, dtype, batch, H, W, dm, di, bias, use_ln, transposed):
    P = W if transposed else H
    cb = (lambda k: _rand(g, k, scale=0.3)) if bias else (lambda k: None)
    return (_rand(g, batch, H, W, dm).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
            _rand(g, di, dm, scale=dm ** -0.5).to(dtype), cb(di),
            _rand(g, di), _rand(g, di), 1 + _rand(g, di, scale=0.1),
            _rand(g, di, scale=0.1),
            _rand(g, dm, di, scale=di ** -0.5).to(dtype), cb(dm), 1e-5,
            use_ln, transposed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    ((6, 10), False, 3, 64, 128, False, True),   # 180 tokens: partial tile
    ((6, 10), True, 3, 64, 128, True, False),
    ((8, 8), True, 2, 384, 768, True, True),     # six 128-channel slabs
    ((128, 128), False, 2, 192, 384, True, True),  # FastVim-T at 2048 px
    ((128, 128), True, 2, 192, 384, False, True),
    ((6, 10), False, 2, 96, 192, True, True),    # d_model zero-padded
    ((10, 6), True, 1, 160, 320, False, True),
    ((5, 13), False, 1, 64, 96, True, True),     # 65 tokens, a 96-wide slab
    ((8, 8), False, 2, 192, 352, True, True),    # d_inner % 64 == 32
    ((1, 40), False, 2, 64, 128, True, True),    # a 1 x N and an N x 1 grid
    ((40, 1), True, 2, 64, 128, False, True),
    ((3, 65), False, 2, 128, 192, True, True),   # lines of 65 tokens
    ((65, 3), True, 2, 128, 192, False, False),
    ((14, 14), False, 3, 192, 384, True, True),  # 224 px, tiles across images
    ((16, 16), True, 3, 96, 192, False, True),
])
def test_pass_b_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                              bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(di + grid[1])
    args = _pass_b_args(g, dtype, batch, *grid, dm, di, bias, use_ln,
                        transposed)
    with torch.no_grad():
        _close(lf.pass_b(*args), lf.pass_b_plain(*args), TOL[dtype])


# FastVim-B, -L and -H: K3's streamed form (d_model > 384) and K4's wide
# form (column groups of 384; d_model > 384 or d_inner > 768)
REGISTRY_WIDE = [(768, 1536), (1024, 2048), (1280, 2560)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias", [
    *[((14, 14), tr, 2, dm, di, tr) for dm, di in REGISTRY_WIDE
      for tr in (False, True)],
    ((4, 200), False, 1, 768, 1536, True),   # two streamed segments
    ((6, 10), True, 2, 800, 1600, False),    # d_model zero-padded to 832
    ((8, 8), False, 2, 384, 1536, True),     # K3's whole tile, wide d_inner
    ((14, 14), False, 3, 1024, 2048, True),  # runs across 3 images
    ((16, 16), True, 3, 768, 1536, False),
    ((14, 14), True, 3, 1280, 2560, True),
])
def test_pass_a_wide_matches_plain(dev, dtype, grid, transposed, batch, dm,
                                   di, bias):
    g = torch.Generator(device=dev).manual_seed(dm + di + grid[0])
    args = _pass_a_args(g, dtype, batch, *grid, dm, di, bias, transposed)
    with torch.no_grad():
        for got, want in zip(lf.pass_a(*args), lf.pass_a_plain(*args)):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    *[((14, 14), tr, 2, dm, di, tr, True) for dm, di in REGISTRY_WIDE
      for tr in (False, True)],
    ((6, 10), False, 3, 768, 1536, True, False),  # partial tile, no LN
    ((6, 10), True, 2, 800, 1600, True, True),    # a 32-column last group
    ((8, 8), False, 2, 384, 1536, False, True),   # one group, d_inner 1536
    ((5, 13), False, 1, 1024, 2080, True, True),  # 65 tokens, a 32-wide slab
    ((14, 14), True, 3, 1024, 2048, True, True),  # 224 px, 3 images
    ((16, 16), False, 3, 768, 1536, False, True),
    ((14, 14), False, 3, 1280, 2560, True, False),
])
def test_pass_b_wide_matches_plain(dev, dtype, grid, transposed, batch, dm,
                                   di, bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(dm + di + grid[1])
    args = _pass_b_args(g, dtype, batch, *grid, dm, di, bias, use_ln,
                        transposed)
    with torch.no_grad():
        _close(lf.pass_b(*args), lf.pass_b_plain(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dm,di", [(768, 1536), (1280, 2560)])
def test_wide_fwd_kernels_repeat_bitwise(dev, dtype, dm, di):
    """The wide forms write every output from one block, without atomics:
    two calls on the same inputs agree bit for bit, each one launch."""
    g = torch.Generator(device=dev).manual_seed(dm)
    a_args = _pass_a_args(g, dtype, 2, 10, 14, dm, di, True, True)
    b_args = _pass_b_args(g, dtype, 2, 10, 14, dm, di, True, True, False)
    with torch.no_grad():
        for fn, args in ((lf.pass_a, a_args), (lf.pass_b, b_args)):
            out = fn(*args)
            first = [t.clone() for t in (out if isinstance(out, tuple)
                                         else (out,))]
            again = fn(*args)
            for a, b in zip(first, again if isinstance(again, tuple)
                            else (again,)):
                assert torch.equal(a, b)
        assert kernels_a_call(lambda: lf.pass_a(*a_args)) == 1
        assert kernels_a_call(lambda: lf.pass_b(*b_args)) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,dm,di,batch", [
    ((6, 10), False, 64, 128, 2),
    ((128, 128), True, 192, 384, 2),
    ((200, 4), True, 384, 768, 2),
    ((5, 63), False, 96, 192, 2),
    ((14, 14), False, 192, 384, 3),    # runs of whole lines across images
    ((16, 16), True, 768, 1536, 3),
    ((14, 14), True, 1280, 2560, 3),
])
def test_pass_a_pools_only_matches_plain(dev, dtype, grid, transposed, dm,
                                         di, batch):
    """K3 without the xc stores (the recompute mode's pass A): no xc, and
    the pools of pass_a_plain."""
    g = torch.Generator(device=dev).manual_seed(dm + grid[1])
    args = _pass_a_args(g, dtype, batch, *grid, dm, di, True, transposed)
    with torch.no_grad():
        got = lf.pass_a(*args, write_xc=False)
        want = lf.pass_a_plain(*args)
    assert got[0] is None and got[1] is None
    for a, b in zip(got[2:], want[2:]):
        _close(a, b, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_fwd_kernels_bitwise_reproducible(dev, dtype, transposed):
    """K3 and K4 write every output from one block, without atomics: two
    calls on the same inputs agree bit for bit (ragged tiles and padded
    widths included)."""
    g = torch.Generator(device=dev).manual_seed(12)
    batch, H, W, dm, di = 2, 40, 70, 160, 352
    P = W if transposed else H
    a_args = _pass_a_args(g, dtype, batch, H, W, dm, 384, True, transposed)
    b_args = (_rand(g, batch, H, W, dm).to(dtype),
              _rand(g, batch, H, W, di).to(dtype),
              _rand(g, batch, H, W, di).to(dtype),
              _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
              _rand(g, di, dm, scale=dm ** -0.5).to(dtype),
              _rand(g, di, scale=0.3), _rand(g, di), _rand(g, di),
              1 + _rand(g, di, scale=0.1), _rand(g, di, scale=0.1),
              _rand(g, dm, di, scale=di ** -0.5).to(dtype),
              _rand(g, dm, scale=0.3), 1e-5, True, transposed)
    with torch.no_grad():
        for fn, args in ((lf.pass_a, a_args), (lf.pass_b, b_args)):
            out = fn(*args)
            first = [t.clone() for t in (out if isinstance(out, tuple)
                                         else (out,))]
            again = fn(*args)
            for a, b in zip(first, again if isinstance(again, tuple)
                            else (again,)):
                assert torch.equal(a, b)


def _pass_b_bwd_args(g, dtype, batch, H, W, dm, di, bias, use_ln,
                     transposed):
    P = W if transposed else H
    return (_rand(g, batch, H, W, dm).to(dtype),
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


def _pass_a_bwd_args(g, dtype, batch, H, W, dm, di, bias, transposed):
    P = W if transposed else H
    x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, _ = _pass_a_args(
        g, dtype, batch, H, W, dm, di, bias, transposed)
    return (x4, _rand(g, batch, H, W, dm), _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, H, W, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), _rand(g, batch, P, di).to(dtype),
            w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, transposed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    ((6, 10), False, 3, 64, 128, False, True),
    ((6, 10), True, 3, 64, 128, True, False),
    ((5, 70), False, 2, 64, 128, True, True),    # 70-token lines: 3 tiles
    ((70, 5), True, 2, 64, 128, False, True),    # the same down columns
    ((4, 4), True, 2, 64, 128, True, True),      # the smallest grid
    ((8, 8), True, 2, 192, 384, True, True),     # FastVim-T widths
    ((8, 8), False, 2, 384, 768, True, True),    # FastVim-S widths: 6 slabs
    ((6, 10), True, 2, 128, 512, False, True),   # d_inner > 384
    ((6, 10), False, 2, 64, 64, True, True),     # half a slab
    ((3, 65), False, 2, 128, 192, True, True),   # an M tile + 1 tokens
    ((65, 3), True, 2, 128, 192, False, False),
    ((1, 40), False, 2, 64, 128, True, True),    # a 1 x N and an N x 1 grid
    ((40, 1), True, 2, 64, 128, True, True),
    ((64, 64), False, 2, 192, 384, False, True),  # the detection backbone's
    ((64, 64), True, 2, 192, 384, False, True),   # grid (FastVim-T, 1024 px)
])
def test_pass_b_bwd_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                                  bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(di + grid[1] + 1)
    args = _pass_b_bwd_args(g, dtype, batch, *grid, dm, di, bias, use_ln,
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
    ((8, 8), False, 2, 384, 768, True),    # FastVim-S widths: 6 slabs
    ((6, 10), True, 2, 128, 512, False),   # d_inner > 384
    ((6, 10), False, 2, 64, 64, True),     # half a slab
    ((4, 65), False, 2, 128, 192, True),   # an M tile + 1 tokens a line
    ((65, 4), True, 2, 128, 192, False),
    ((14, 14), True, 3, 192, 384, True),   # windows that straddle images' ends
    ((64, 64), False, 2, 192, 384, False),  # the detection backbone's grid
    ((64, 64), True, 2, 192, 384, False),   # (FastVim-T, 1024 px)
])
def test_pass_a_bwd_matches_plain(dev, dtype, grid, transposed, batch, dm, di,
                                  bias):
    g = torch.Generator(device=dev).manual_seed(dm + grid[0] + 1)
    args = _pass_a_bwd_args(g, dtype, batch, *grid, dm, di, bias, transposed)
    with torch.no_grad():
        _close_all(lf.pass_a_bwd(*args), lf.pass_a_bwd_plain(*args),
                   TOL[dtype], 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_bwd_kernels_bitwise_reproducible(dev, dtype, transposed):
    """K5 and K6 add their cross-block sums in a fixed order (no atomics):
    two calls on the same inputs agree bit for bit, ragged tiles and
    several token slices included."""
    g = torch.Generator(device=dev).manual_seed(11)
    batch, H, W, dm, di = 2, 40, 70, 192, 384
    P = W if transposed else H
    tok = lambda c: _rand(g, batch, H, W, c).to(dtype)
    pooled = lambda: _rand(g, batch, P, di).to(dtype)
    b_args = (tok(dm), tok(dm), tok(di), tok(di), pooled(), pooled(),
              _rand(g, di, dm, scale=dm ** -0.5).to(dtype),
              _rand(g, di, scale=0.3), _rand(g, di), _rand(g, di),
              1 + _rand(g, di, scale=0.1), _rand(g, di, scale=0.1),
              _rand(g, dm, di, scale=di ** -0.5).to(dtype), 1e-5, True,
              transposed)
    x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, _ = _pass_a_args(
        g, dtype, batch, H, W, dm, di, True, transposed)
    a_args = (x4, _rand(g, batch, H, W, dm), tok(di), tok(di), pooled(),
              pooled(), w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling, transposed)
    with torch.no_grad():
        for fn, args in ((lf.pass_b_bwd, b_args), (lf.pass_a_bwd, a_args)):
            first = [t.clone() for t in fn(*args)]
            for a, b in zip(first, fn(*args)):
                assert torch.equal(a, b)


# the wide forms of K5 and K6: FastVim-B/L/H on 224 px (14 × 14), 256 px
# and 512 px (patch 16) grids, then partial tiles and the edges of the
# narrow forms' widths; with bias, LayerNorm too
BWD_WIDE_CASES = [
    *[(grid, tr, 1, dm, di, tr) for dm, di in REGISTRY_WIDE
      for grid in ((14, 14), (16, 16), (32, 32)) for tr in (False, True)],
    ((6, 10), False, 3, 768, 1536, True),   # 10-token lines: a partial tile
    ((5, 70), False, 2, 768, 1536, False),  # 70-token lines: 64 + 6
    ((70, 5), True, 2, 1024, 2048, True),   # the same down columns
    ((8, 8), True, 2, 384, 832, True),      # d_inner past 768, d_model 384
    ((8, 8), False, 2, 448, 768, False),    # d_model past 384
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias", BWD_WIDE_CASES)
def test_pass_b_bwd_wide_matches_plain(dev, dtype, grid, transposed, batch,
                                       dm, di, bias):
    g = torch.Generator(device=dev).manual_seed(dm + di + grid[1])
    args = _pass_b_bwd_args(g, dtype, batch, *grid, dm, di, bias, bias,
                            transposed)
    with torch.no_grad():
        _close_all(lf.pass_b_bwd(*args), lf.pass_b_bwd_plain(*args),
                   TOL[dtype], 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias", BWD_WIDE_CASES)
def test_pass_a_bwd_wide_matches_plain(dev, dtype, grid, transposed, batch,
                                       dm, di, bias):
    g = torch.Generator(device=dev).manual_seed(dm + di + grid[0])
    args = _pass_a_bwd_args(g, dtype, batch, *grid, dm, di, bias, transposed)
    with torch.no_grad():
        _close_all(lf.pass_a_bwd(*args), lf.pass_a_bwd_plain(*args),
                   TOL[dtype], 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dm,di", [(768, 1536), (1280, 2560)])
def test_wide_bwd_kernels_repeat_bitwise(dev, dtype, dm, di):
    """The wide forms add their cross-block sums in a fixed order (no
    atomics): two calls on the same inputs agree bit for bit. A call of K5
    is six launches in either dtype (bf16: the LayerNorm statistics, z and
    dgated with the gate epilogue, the second pass, dx̂, the weight
    gradients, the sums; fp32 (3xTF32): z, dgated, the middle, dx̂, the
    weight gradients, the sums), of K6 four (xin with the conv adjoint,
    dx̂, the weight gradient, the sums), and no weight transposes."""
    g = torch.Generator(device=dev).manual_seed(dm + 1)
    b_args = _pass_b_bwd_args(g, dtype, 2, 10, 70, dm, di, True, True, False)
    a_args = _pass_a_bwd_args(g, dtype, 2, 10, 70, dm, di, True, True)
    with torch.no_grad():
        for fn, args, n in ((lf.pass_b_bwd, b_args, 6),
                            (lf.pass_a_bwd, a_args, 4)):
            first = [t.clone() for t in fn(*args)]
            for a, b in zip(first, fn(*args)):
                assert torch.equal(a, b)
            assert kernels_a_call(lambda: fn(*args)) == n


# the bf16 wide forms as redesigned on 128-token tiles
# (csrc/layer_fused_bwd_wide.cu), at FastVim-B's, -L's and -H's widths on
# lines of 14 (224 px), 32 (-H at 448 px) and 128 tokens (2048 px), both
# orientations: token tiles that span images (B = 3, 588 tokens) with a
# ragged last tile, K6 windows with a ragged last window in each image
WIDE_REDESIGN_CASES = [
    ((14, 14), False, 3, 768, 1536), ((14, 14), True, 3, 768, 1536),
    ((14, 14), False, 3, 1024, 2048), ((14, 14), True, 3, 1024, 2048),
    ((32, 32), False, 2, 1280, 2560), ((32, 32), True, 2, 1280, 2560),
    ((128, 128), False, 1, 768, 1536), ((128, 128), True, 1, 768, 1536),
]


@pytest.mark.parametrize("grid,transposed,batch,dm,di", WIDE_REDESIGN_CASES)
def test_wide_bwd_redesign_matches_plain_and_repeats(dev, grid, transposed,
                                                     batch, dm, di):
    """K5's and K6's bf16 wide forms against their plain versions (2e-2),
    two calls bit for bit equal, six and four launches a call. K5's dy is
    a sum over a line's tokens (128 of them at 2048 px), so it is held as
    a summed output: its per-token bound fails by one bf16 ulp in the
    form before this one too, on the same inputs."""
    g = torch.Generator(device=dev).manual_seed(dm + grid[0] + batch)
    b_args = _pass_b_bwd_args(g, torch.bfloat16, batch, *grid, dm, di, True,
                              True, transposed)
    a_args = _pass_a_bwd_args(g, torch.bfloat16, batch, *grid, dm, di, True,
                              transposed)
    with torch.no_grad():
        for fn, plain, args, n_tok, launches in (
                (lf.pass_b_bwd, lf.pass_b_bwd_plain, b_args, 3, 6),
                (lf.pass_a_bwd, lf.pass_a_bwd_plain, a_args, 1, 4)):
            first = [t.clone() for t in fn(*args)]
            _close_all(first, plain(*args), TOL[torch.bfloat16], n_tok)
            for a, b in zip(first, fn(*args)):
                assert torch.equal(a, b)
            assert kernels_a_call(lambda: fn(*args)) == launches


@pytest.mark.parametrize("transposed", [False, True])
def test_wide_bwd_redesign_without_layernorm_or_bias(dev, transposed):
    """The wide K5 without the LayerNorm (m0 itself in the epilogue, no
    row sums) and without b_z, at a d_inner with a half channel tile (832)
    and a d_model that takes 64-column products (448)."""
    g = torch.Generator(device=dev).manual_seed(832 + transposed)
    for dm, di in ((448, 896), (512, 832)):
        args = _pass_b_bwd_args(g, torch.bfloat16, 2, 9, 7, dm, di, False,
                                False, transposed)
        with torch.no_grad():
            _close_all(lf.pass_b_bwd(*args), lf.pass_b_bwd_plain(*args),
                       TOL[torch.bfloat16], 4)


# the fp32 K5 and K6 (3xTF32, csrc/layer_fused_bwd_tf32.cu): every
# registry width at 224 px (14 × 14, B = 1), then lines of 4, 16, 17, 31,
# 32 and 130 tokens (K5's blocks hold 64 tokens, K6's 122: whole lines,
# ragged last blocks, a line in segments), both orientations
TF32_BWD_CASES = [
    *[((14, 14), tr, 1, dm, di) for dm, di in ((192, 384), (384, 768),
                                               *REGISTRY_WIDE)
      for tr in (False, True)],
    ((9, 4), False, 2, 64, 128),      # lines of 4: one block an image
    ((4, 9), True, 2, 64, 128),
    ((20, 16), False, 3, 64, 128),    # 4-line blocks; K6 7 + 7 + 6 lines
    ((17, 17), True, 2, 192, 384),    # 3 + ... + 2 and 7 + 7 + 3 lines
    ((31, 10), True, 1, 128, 256),    # 31-token columns
    ((6, 32), False, 2, 64, 128),     # 32-token lines (512 px)
    ((32, 6), True, 2, 448, 896),
    ((4, 130), False, 1, 64, 128),    # lines longer than a block
    ((130, 4), True, 2, 128, 192),
]


@pytest.mark.parametrize("grid,transposed,batch,dm,di", TF32_BWD_CASES)
def test_tf32_pass_b_bwd_matches_plain(dev, grid, transposed, batch, dm,
                                       di):
    g = torch.Generator(device=dev).manual_seed(dm + grid[0] + 3)
    args = _pass_b_bwd_args(g, torch.float32, batch, *grid, dm, di, True,
                            True, transposed)
    with torch.no_grad():
        _close_all(lf.pass_b_bwd(*args), lf.pass_b_bwd_plain(*args),
                   TOL[torch.float32], 4)


@pytest.mark.parametrize("grid,transposed,batch,dm,di", TF32_BWD_CASES)
def test_tf32_pass_a_bwd_matches_plain(dev, grid, transposed, batch, dm,
                                       di):
    g = torch.Generator(device=dev).manual_seed(dm + grid[1] + 5)
    args = _pass_a_bwd_args(g, torch.float32, batch, *grid, dm, di, True,
                            transposed)
    with torch.no_grad():
        _close_all(lf.pass_a_bwd(*args), lf.pass_a_bwd_plain(*args),
                   TOL[torch.float32], 1)


@pytest.mark.parametrize("grid,transposed,dm,di", [
    ((14, 14), False, 192, 384), ((14, 14), True, 768, 1536),
    ((130, 4), True, 64, 128), ((4, 130), False, 1280, 2560)])
def test_tf32_bwd_kernels_repeat_bitwise(dev, grid, transposed, dm, di):
    """The fp32 K5 and K6 add every sum over tokens in a fixed order (no
    atomics): two calls agree bit for bit, with ragged blocks and a line
    in segments; a call is six device kernels of K5 and four of K6."""
    g = torch.Generator(device=dev).manual_seed(di + 7)
    b_args = _pass_b_bwd_args(g, torch.float32, 3, *grid, dm, di, True, True,
                              transposed)
    a_args = _pass_a_bwd_args(g, torch.float32, 3, *grid, dm, di, True,
                              transposed)
    with torch.no_grad():
        for fn, args, n in ((lf.pass_b_bwd, b_args, 6),
                            (lf.pass_a_bwd, a_args, 4)):
            first = [t.clone() for t in fn(*args)]
            for a, b in zip(first, fn(*args)):
                assert torch.equal(a, b)
            assert kernels_a_call(lambda: fn(*args)) == n


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
        **dict.fromkeys(kernels.LAUNCHES, 0),
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
    # and no width beyond what K5 and K6 hold
    with torch.no_grad():
        _, states = ss.selective_scan_fwd(u, u, A, B, B, save_states=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ss.selective_scan_bwd(u.clone().requires_grad_(), u, A, B, B, None,
                              None, u, states)
    with pytest.raises(ValueError, match="states must be"):
        ss.selective_scan_bwd(u, u, A, B, B, None, None, u, states[:, :, :8])
    x4, v = _rand(g, 1, 8, 8, 64), _rand(g, 832)
    wide_bwd = _rand(g, 1, 8, 8, 2624)  # d_inner past the backward's 2560
    y_bwd, v_bwd = _rand(g, 1, 8, 2624), _rand(g, 2624)
    # d_inner past the forward kernels' 2560
    wide_p = lf.FusedParams(*([None] * 2), v.new_zeros(2624, 4),
                            *([None] * 17))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="fused forward kernels"):
        lf.fused_mixer_core(_rand(g, 1, 64, 64).requires_grad_(), wide_p,
                            (8, 8), False, 1.0, 1e-5, True, torch.float32)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        selective_scan(_rand(g, 1, 8, 12).requires_grad_(), _rand(g, 1, 8, 12),
                       -torch.ones(12, 16, device=dev), B, B)
    assert kernels.launch_counts()["pass_a_fwd"] == 0  # before the forward
    with pytest.raises(ValueError, match="d_inner <= 2560"):
        lf.pass_b_bwd(x4, x4, wide_bwd, wide_bwd, y_bwd, y_bwd,
                      _rand(g, 2624, 64), None, v_bwd, v_bwd, v_bwd, v_bwd,
                      _rand(g, 64, 2624), 1e-5, True, False)
    # the forward kernels take FastVim-H's widths and no more: d_model <=
    # 1280, d_inner <= 2560
    x1312 = _rand(g, 1, 8, 8, 1312)
    with pytest.raises(ValueError, match="d_model <= 1280"):
        lf.pass_a(x1312, _rand(g, 128, 1312), None, _rand(g, 128, 4), None,
                  _rand(g, 128, 4), None, 1.0, False)
    with pytest.raises(ValueError, match="d_inner <= 2560"):
        lf.pass_a(x4, _rand(g, 2624, 64), None, _rand(g, 2624, 4), None,
                  _rand(g, 2624, 4), None, 1.0, False)
    y128, v128 = _rand(g, 1, 8, 128), _rand(g, 128)
    with pytest.raises(ValueError, match="d_model <= 1280"):
        lf.pass_b(x1312, _rand(g, 1, 8, 8, 128), _rand(g, 1, 8, 8, 128), y128,
                  y128, _rand(g, 128, 1312), None, v128, v128, v128, v128,
                  _rand(g, 1312, 128), None, 1e-5, True, False)
    y2592, v2592 = _rand(g, 1, 8, 2592), _rand(g, 2592)
    with pytest.raises(ValueError, match="d_inner <= 2560"):
        lf.pass_b(x4, _rand(g, 1, 8, 8, 2592), _rand(g, 1, 8, 8, 2592), y2592,
                  y2592, _rand(g, 2592, 64), None, v2592, v2592, v2592, v2592,
                  _rand(g, 64, 2592), None, 1e-5, True, False)
    with pytest.raises(ValueError, match="d_inner <= 2560"):
        lf.pass_a_bwd(x4, _rand(g, 1, 8, 8, 64), wide_bwd, wide_bwd, y_bwd,
                      y_bwd, _rand(g, 2624, 64), None, _rand(g, 2624, 4), None,
                      _rand(g, 2624, 4), None, 1.0, False)


# ----------------------------------------------------------------------
# K7-K10 and lanes
# ----------------------------------------------------------------------

ODD_GRIDS = [(14, 14), (6, 10), (4, 200), (170, 5)]


def _block_args(g, dtype, batch, rows, cols, d, bias):
    """merge_gate's arguments: x and z as the two column halves of one
    (batch, L, 2d) array, as the mixer hands them over."""
    L = rows * cols
    xz = _rand(g, batch, L, 2 * d).to(dtype)
    cb = (lambda: _rand(g, d, scale=0.3)) if bias else (lambda: None)
    return [xz[..., :d], xz[..., d:], _rand(g, batch, rows, d),
            _rand(g, batch, rows, d), _rand(g, d, 4, scale=0.5), cb(),
            _rand(g, d, 4, scale=0.5), cb(), _rand(g, d), _rand(g, d),
            1 + _rand(g, d, scale=0.1), _rand(g, d, scale=0.1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,d,method,bias", [
    *[(grid, 128, "mean", True) for grid in ODD_GRIDS],
    ((14, 14), 768, "max", False), ((6, 10), 1536, "max", True),
    ((1, 12), 96, "mean", True),   # a single row
    ((6, 2), 32, "max", True),     # rows shorter than the conv's reach
    ((5, 1), 32, "mean", False),
])
def test_conv_pool_matches_plain(dev, dtype, grid, d, method, bias):
    g = torch.Generator(device=dev).manual_seed(d + grid[0])
    a = _block_args(g, dtype, 2, *grid, d, bias)
    args = (a[0], *a[4:8], *grid, method, 0.5)
    with torch.no_grad():
        for got, want in zip(fb.conv_pool(*args), fb.conv_pool_plain(*args)):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,d,bias,use_norm", [
    *[(grid, 128, True, True) for grid in ODD_GRIDS],
    ((14, 14), 768, False, True), ((6, 10), 1536, True, False),
    ((6, 10), 2560, True, True),   # FastVim-H's d_inner
    ((1, 12), 96, True, True), ((6, 2), 32, True, False),
])
def test_merge_gate_matches_plain(dev, dtype, grid, d, bias, use_norm):
    g = torch.Generator(device=dev).manual_seed(d + grid[1])
    a = _block_args(g, dtype, 2, *grid, d, bias)
    with torch.no_grad():
        _close(fb.merge_gate(*a, *grid, 1e-5, use_norm),
               fb.merge_gate_plain(*a, *grid, 1e-5, use_norm), TOL[dtype])


# K8 and K9 on grids whose rows end inside K9's tiles and K8's runs and
# whose cols divide neither (14 x 14, 6 x 10, 170 x 5, 4 x 200), at the
# narrowest width and FastVim-H's; many rows (2048 x 16), where K8's runs
# take several rows each; x and z as column slices whose offsets leave
# only 4- (bf16) or 8-byte (fp32) alignment (off 2)
BLOCK_CASES = [
    ((14, 14), 32, 0), ((6, 10), 96, 2), ((170, 5), 2560, 0),
    ((4, 200), 2560, 2), ((170, 5), 32, 2), ((4, 200), 96, 0),
    ((14, 14), 2560, 2), ((6, 10), 384, 2), ((1, 12), 2560, 0),
    ((2048, 16), 768, 0),
]


def _sliced_block_args(g, dtype, batch, rows, cols, d, off):
    """merge_gate's arguments with x and z as column slices of a (batch,
    L, 2d + 2·off) array, ``off`` elements in."""
    L = rows * cols
    xz = _rand(g, batch, L, 2 * d + 2 * off).to(dtype)
    a = _block_args(g, dtype, batch, rows, cols, d, off == 0)
    a[0], a[1] = xz[..., off:off + d], xz[..., d + 2 * off:]
    return a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["mean", "max"])
@pytest.mark.parametrize("grid,d,off", BLOCK_CASES)
def test_conv_pool_odd_grids_widths_and_slices(dev, dtype, grid, d, off,
                                               method):
    g = torch.Generator(device=dev).manual_seed(d + grid[0] + off)
    a = _sliced_block_args(g, dtype, 2, *grid, d, off)
    args = (a[0], *a[4:8], *grid, method, 0.5)
    with torch.no_grad():
        for got, want in zip(fb.conv_pool(*args), fb.conv_pool_plain(*args)):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("grid,d,off", BLOCK_CASES[:-1])
def test_merge_gate_odd_grids_widths_and_slices(dev, dtype, grid, d, off,
                                                use_norm):
    g = torch.Generator(device=dev).manual_seed(d + grid[1] + off)
    a = _sliced_block_args(g, dtype, 2, *grid, d, off)
    with torch.no_grad():
        _close(fb.merge_gate(*a, *grid, 1e-5, use_norm),
               fb.merge_gate_plain(*a, *grid, 1e-5, use_norm), TOL[dtype])


def _plan_edges(grid, elem_bytes):
    """(tile, d): for each tile size K9's plan gives on ``grid``, the
    widest d that gets it, where the block's shared memory is closest to
    the card's limit; the widest d ``fusable`` accepts among them."""
    widest = {}
    for d in range(32, 8192, 32):
        if not fb.fusable(*grid, d):
            break
        widest[fb.merge_gate_plan(d, *grid, elem_bytes).tile] = d
    return sorted(widest.items())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(6, 10), (170, 5)])
def test_merge_gate_at_each_plan_edge(dev, dtype, grid):
    """K9 launches and matches its plain version at the widest d of each
    tile size: the kernel refuses a plan whose shared-memory bytes differ
    from its own layout's, so these launches also hold the plan's formula
    to the kernel's where it matters most."""
    edges = _plan_edges(grid, torch.tensor([], dtype=dtype).element_size())
    assert len(edges) >= 5 and max(d for _, d in edges) >= 2560
    for tile, d in edges:
        g = torch.Generator(device=dev).manual_seed(d + tile)
        a = _block_args(g, dtype, 1, *grid, d, True)
        with torch.no_grad():
            _close(fb.merge_gate(*a, *grid, 1e-5, True),
                   fb.merge_gate_plain(*a, *grid, 1e-5, True), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,d", [((14, 14), 384), ((6, 10), 768),
                                    ((170, 5), 2560)])
def test_block_kernels_repeat_bitwise_in_one_launch(dev, dtype, grid, d):
    """K8 and K9 each launch one device kernel a call (no second pass, no
    atomics) and give the same bits from call to call."""
    g = torch.Generator(device=dev).manual_seed(d)
    a = _block_args(g, dtype, 2, *grid, d, True)
    calls = {"conv_pool_fwd": lambda: fb.conv_pool(a[0], *a[4:8], *grid,
                                                   "mean", 0.5),
             "merge_gate_fwd": lambda: fb.merge_gate(*a, *grid, 1e-5, True)}
    with torch.no_grad():
        for name, fn in calls.items():
            kernels.reset_launch_counts()
            first = fn()
            first = [t.clone() for t in (first if isinstance(first, tuple)
                                         else (first,))]
            for _ in range(2):
                again = fn()
                for x, y in zip(first, again if isinstance(again, tuple)
                                else (again,)):
                    assert torch.equal(x, y), name
            assert kernels.launch_counts()[name] == 3
            assert kernels_a_call(fn) == 1, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool_axes", [(1,), (0,)])
@pytest.mark.parametrize("grid,d,use_ln", [
    *[(grid, 128, True) for grid in ODD_GRIDS],
    ((14, 14), 768, True), ((6, 10), 1536, False), ((6, 10), 2560, True),
])
def test_merge_ln_gate_matches_plain(dev, dtype, pool_axes, grid, d, use_ln):
    g = torch.Generator(device=dev).manual_seed(d + grid[0] + pool_axes[0])
    H, W = grid
    P = H if pool_axes == (1,) else W
    xz = _rand(g, 2, H * W, 2 * d).to(dtype)
    ln = ((1 + _rand(g, d, scale=0.1), _rand(g, d, scale=0.1)) if use_ln
          else (None, None))
    args = (_rand(g, 2, H * W, d).to(dtype), _rand(g, 2, H * W, d).to(dtype),
            xz[..., d:], _rand(g, 2, P, d).to(dtype),
            _rand(g, 2, P, d).to(dtype), _rand(g, d), _rand(g, d), *ln, grid,
            pool_axes, 1e-5, use_ln)
    with torch.no_grad():
        _close(mg.merge_ln_gate(*args), mg.merge_ln_gate_plain(*args),
               TOL[dtype])


def _merge_ln_gate_args(g, dtype, batch, H, W, d, pool_axes, use_ln,
                        off=0):
    """merge_ln_gate's arguments, z the second column block of a (batch,
    L, 2d + off) array, ``off`` elements in (off 2: z only 4- or 8-byte
    aligned)."""
    P = H if pool_axes == (1,) else W
    xz = _rand(g, batch, H * W, 2 * d + off).to(dtype)
    ln = ((1 + _rand(g, d, scale=0.1), _rand(g, d, scale=0.1)) if use_ln
          else (None, None))
    return (_rand(g, batch, H * W, d).to(dtype),
            _rand(g, batch, H * W, d).to(dtype), xz[..., d + off:],
            _rand(g, batch, P, d).to(dtype), _rand(g, batch, P, d).to(dtype),
            _rand(g, d), _rand(g, d), *ln, (H, W), pool_axes, 1e-5, use_ln)


# K10 on grids of one token, odd rows and columns, and lines much longer
# than the other axis; at the narrowest d, each width the registry uses
# (its plan's exact splits: K 3 or 2 pieces a thread) and the widest d
# fusable accepts; z aligned and as a slice 2 elements off 16 bytes
MERGE_CASES = [((1, 1), 32), ((5, 7), 384), ((14, 14), 768), ((170, 5), 1536),
               ((5, 7), 2048), ((14, 14), 2560), ((1, 1), 4096),
               ((170, 5), 32), ((5, 7), 4096), ((14, 14), 384)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool_axes", [(1,), (0,)])
@pytest.mark.parametrize("grid,d", MERGE_CASES)
def test_merge_ln_gate_odd_grids_widths_and_slices(dev, dtype, pool_axes,
                                                   grid, d):
    for use_ln in (True, False):
        for off in (0, 2):
            g = torch.Generator(device=dev).manual_seed(d + grid[0] + off)
            args = _merge_ln_gate_args(g, dtype, 2, *grid, d, pool_axes,
                                       use_ln, off)
            with torch.no_grad():
                _close(mg.merge_ln_gate(*args), mg.merge_ln_gate_plain(*args),
                       TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_ln_gate_launches_at_every_width(dev, dtype):
    """Every d that fusable accepts launches with its plan (the kernel
    refuses a plan that does not cover d or overflows its block) and
    matches the plain version."""
    d = 32
    while mg.fusable((3, 5), (1,), d):
        g = torch.Generator(device=dev).manual_seed(d)
        args = _merge_ln_gate_args(g, dtype, 1, 3, 5, d, (d // 32 % 2,),
                                   True)
        with torch.no_grad():
            _close(mg.merge_ln_gate(*args), mg.merge_ln_gate_plain(*args),
                   TOL[dtype])
        d += 32
    assert d == mg.MAX_D + 32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,d", [((128, 128), 384), ((6, 10), 768),
                                    ((170, 5), 2560), ((7, 3), 160)])
def test_merge_ln_gate_repeats_bitwise_in_one_launch(dev, dtype, grid, d):
    """K10 launches one device kernel a call (no second pass, no atomics)
    and gives the same bits from call to call, in both orientations."""
    for pool_axes in ((1,), (0,)):
        g = torch.Generator(device=dev).manual_seed(d)
        args = _merge_ln_gate_args(g, dtype, 2, *grid, d, pool_axes, True)
        fn = lambda: mg.merge_ln_gate(*args)
        with torch.no_grad():
            kernels.reset_launch_counts()
            first = fn().clone()
            for _ in range(2):
                assert torch.equal(fn(), first)
            assert kernels.launch_counts()["merge_ln_gate_fwd"] == 3
            assert kernels_a_call(fn) == 1


def _recompute_args(g, dtype, batch, H, W, dm, di, bias, use_ln,
                    transposed):
    P = W if transposed else H
    x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, _, _ = _pass_a_args(
        g, dtype, batch, H, W, dm, di, bias, transposed)
    cb = (lambda k: _rand(g, k, scale=0.3)) if bias else (lambda k: None)
    return (x4, _rand(g, batch, P, di).to(dtype),
            _rand(g, batch, P, di).to(dtype), w_x, b_x, w_cf, b_cf, w_ab,
            b_ab, _rand(g, di, dm, scale=dm ** -0.5).to(dtype), cb(di),
            _rand(g, di), _rand(g, di), 1 + _rand(g, di, scale=0.1),
            _rand(g, di, scale=0.1),
            _rand(g, dm, di, scale=di ** -0.5).to(dtype), cb(dm), 1e-5,
            use_ln, transposed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    *[(grid, tr, 2, 64, 128, tr, True) for grid in ODD_GRIDS
      for tr in (False, True)],
    ((6, 10), True, 3, 64, 128, True, False),   # 60 tokens: a partial tile
    ((10, 13), False, 2, 64, 128, False, True),  # 130: the third partial
    ((8, 8), False, 2, 192, 384, False, True),  # FastVim-T widths
    ((8, 8), False, 2, 384, 768, True, True),   # FastVim-S widths
    ((8, 8), True, 2, 384, 768, False, True),
    ((14, 14), False, 1, 384, 768, False, False),  # ... without LayerNorm
    ((6, 10), False, 2, 96, 192, True, True),   # d_model zero-padded to 128
    ((10, 6), True, 2, 160, 320, False, True),  # ... to 192; d_inner 5 x 64
    ((6, 10), True, 2, 128, 160, True, True),   # d_inner 160: a half slab
    # the wide forms: FastVim-B, -L and -H widths, column groups of 384
    ((14, 14), False, 2, 768, 1536, True, True),
    ((14, 14), True, 2, 768, 1536, False, True),
    ((14, 14), False, 1, 1024, 2048, False, True),
    ((8, 8), True, 1, 1280, 2560, True, True),
    ((10, 13), True, 2, 384, 1536, False, False),  # one group, no LayerNorm
    ((6, 10), False, 2, 800, 1600, True, True),  # 13 column units: 6, 6, 1
    ((8, 8), True, 1, 768, 1568, False, True),   # a half slab of d_inner
])
def test_pass_b_recompute_matches_plain(dev, dtype, grid, transposed, batch,
                                        dm, di, bias, use_ln):
    g = torch.Generator(device=dev).manual_seed(di + grid[1] + 2)
    args = _recompute_args(g, dtype, batch, *grid, dm, di, bias, use_ln,
                           transposed)
    with torch.no_grad():
        _close(lf.pass_b_recompute(*args), lf.pass_b_recompute_plain(*args),
               TOL[dtype])
        if not lf.pass_a_widths_ok(dm, di):  # K3 walks whole 64-channel slabs
            return
        # pass A's pools-only form gives pass A's pools
        a_args = (args[0], *args[3:9], 0.5, transposed)
        none_f, none_b, pf, pb = lf.pass_a(*a_args, write_xc=False)
        assert none_f is None and none_b is None
        want = lf.pass_a(*a_args)
        assert torch.equal(pf, want[2]) and torch.equal(pb, want[3])


@pytest.mark.parametrize("dm,di", [(192, 384), (384, 768), (768, 1536)])
def test_pass_b_recompute_repeats_bitwise(dev, dm, di):
    """K7 in bf16, in each of its three designs (the tile's m kept at
    FastVim-T's widths, d_inner walked twice at FastVim-S's, the wide form
    at FastVim-B's), gives the same bits from call to call: one launch, no
    atomics."""
    g = torch.Generator(device=dev).manual_seed(dm)
    args = _recompute_args(g, torch.bfloat16, 2, 16, 20, dm, di, True, True,
                           True)
    with torch.no_grad():
        kernels.reset_launch_counts()
        first = lf.pass_b_recompute(*args)
        for _ in range(3):
            assert torch.equal(lf.pass_b_recompute(*args), first)
    assert kernels.launch_counts()["pass_b_recompute_fwd"] == 4


@pytest.mark.parametrize("grid,transposed,batch,dm,di,bias,use_ln", [
    ((9, 4), False, 3, 192, 384, True, True),     # FastVim-T, 4-token lines
    ((5, 7), True, 2, 192, 384, False, False),    # 5-token lines, no LN
    ((14, 14), False, 2, 384, 768, True, True),   # FastVim-S, 224 px
    ((16, 16), True, 1, 384, 768, False, True),   # 16-token lines
    ((14, 14), True, 2, 768, 1536, True, True),   # FastVim-B: 2 ranks
    ((7, 32), False, 1, 768, 1536, False, False),  # 32-token lines
    ((14, 14), False, 1, 1024, 2048, True, True),  # FastVim-L: 3 ranks
    ((4, 128), False, 1, 1024, 2048, False, True),  # 128-token lines
    ((16, 16), True, 1, 1280, 2560, True, True),  # FastVim-H: 4 ranks
    ((5, 6), False, 2, 1280, 2560, True, False),
    ((6, 10), False, 2, 800, 1600, True, True),   # 3 ranks, uneven shares
    ((6, 5), True, 2, 1280, 64, True, True),      # ranks with no channels
])
def test_pass_b_recompute_fp32_matches_plain(dev, grid, transposed, batch,
                                             dm, di, bias, use_ln):
    """The fp32 K7 (3xTF32, a cluster of rc_tf32_ranks CTAs a tile of 32
    tokens in conv order) at every registry width, on lines of 4-128
    tokens, tiles that end mid-image and tiles that hold two images'
    tokens (batch > 1), with and without LayerNorm and the biases."""
    g = torch.Generator(device=dev).manual_seed(dm + di + grid[0])
    args = _recompute_args(g, torch.float32, batch, *grid, dm, di, bias,
                           use_ln, transposed)
    with torch.no_grad():
        _close(lf.pass_b_recompute(*args), lf.pass_b_recompute_plain(*args),
               TOL[torch.float32])


@pytest.mark.parametrize("dm,di", [(192, 384), (768, 1536), (1280, 2560)])
def test_pass_b_recompute_fp32_repeats_bitwise(dev, dm, di):
    """The fp32 K7 with 1, 2 and 4 CTAs a cluster gives the same bits from
    call to call: one launch, one device kernel, no atomics, the
    LayerNorm partials added in rank order."""
    g = torch.Generator(device=dev).manual_seed(dm + 1)
    args = _recompute_args(g, torch.float32, 2, 14, 14, dm, di, True, True,
                           True)
    fn = lambda: lf.pass_b_recompute(*args)
    with torch.no_grad():
        kernels.reset_launch_counts()
        first = fn()
        for _ in range(3):
            assert torch.equal(fn(), first)
        assert kernels.launch_counts()["pass_b_recompute_fwd"] == 4
        assert kernels_a_call(fn) == 1


def test_fastvim_small_recompute_fuses(dev):
    """create_model("fastvim_small", layer_fused="recompute") fuses on the
    card, as the JAX package's recompute mode does at d_inner 768: 24 K3
    (pools only), 24 K7 and 48 K1 a forward, and the logits of the same
    model through the default fused layer (K3, K4) in fp32."""
    from fastvim_tpu_torch.models import create_model

    build = lambda **kw: create_model(
        "fastvim_small", img_size=64, device=dev,
        generator=torch.Generator().manual_seed(0), **kw)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = build()(x.to(dev))
        model = build(layer_fused="recompute")
        kernels.reset_launch_counts()
        got = model(x.to(dev))
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.LAUNCHES, 0), "pass_a_fwd": 24,
        "pass_b_recompute_fwd": 24, "selective_scan_fwd": 48}
    _close(got, want, 1e-3)


def _lanes_args(g, dtype, batch, L, d, n, extras):
    """Without softplus (``extras`` False) delta is taken positive, a step
    size as the softplus makes it: a negative step makes a > 1, and over
    hundreds of steps the state grows without bound, where any two
    summation orders part."""
    delta = _rand(g, batch, L, d, scale=0.5)
    args = (_rand(g, batch, L, d).to(dtype),
            (delta if extras else delta.abs()).to(dtype),
            -torch.exp(_rand(g, d, n, scale=0.5)),
            _rand(g, batch, L, n).to(dtype), _rand(g, batch, L, n).to(dtype))
    kw = dict(D=_rand(g, d) if extras else None,
              delta_bias=_rand(g, d, scale=0.3) if extras else None,
              delta_softplus=extras)
    return args, kw


S = ss.LANES_SPAN  # steps a block of the lanes kernel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,n,batch,extras", [
    (1, 16, 2, True),
    (127, 8, 1, False),     # less than a warp's 128 steps, no D, no bias
    (128, 16, 3, True),
    (129, 8, 2, True),
    (S - 1, 16, 1, True),   # a span short of one step
    (S + 1, 8, 3, True),    # a whole span and one step of the next
    (300, 16, 2, False),
    (16384, 16, 2, True),   # Vim-T's full-length scan: 64 spans
    (16384, 8, 1, True),
])
def test_lanes_scan_matches_plain(dev, dtype, L, n, batch, extras):
    """The lanes kernel against the doubling scan in tensor ops and
    against K1, at d 64 (one block's 16 channels four times over) and at
    d 36 (a last block of one 4-channel group)."""
    for d in (64, 36):
        g = torch.Generator(device=dev).manual_seed(L + d)
        args, kw = _lanes_args(g, dtype, batch, L, d, n, extras)
        with torch.no_grad():
            got = ss.selective_scan_fwd_lanes(*args, **kw)
            _close(got, ss.selective_scan_fwd_lanes_plain(*args, **kw),
                   TOL[dtype])
            _close(got, ss.selective_scan_fwd(*args, **kw), TOL[dtype])


@pytest.mark.parametrize("L", [128, 16384])
def test_lanes_launches_and_repeats_bitwise(dev, L):
    """One launch a call, a memset node (the spans' flags and the ticket
    counter) and one kernel; the same bits from call to call, whatever
    order the spans ran in."""
    g = torch.Generator(device=dev).manual_seed(3)
    args, kw = _lanes_args(g, torch.bfloat16, 2, L, 384, 16, True)
    fn = lambda: ss.selective_scan_fwd_lanes(*args, **kw)
    with torch.no_grad():
        kernels.reset_launch_counts()
        first = fn().clone()
        for _ in range(4):
            assert torch.equal(fn(), first)
        assert kernels.launch_counts()["selective_scan_fwd_lanes"] == 5
        assert kernels_a_call(fn) == 2


def test_lanes_function_grads_match_cpu(dev):
    """selective_scan(variant="lanes") on CUDA tensors that require grad:
    the lanes kernel forward, K1 (for the states) and K2 backward, and
    the CPU's gradients."""
    g = torch.Generator().manual_seed(11)
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
                           delta_softplus=True, variant="lanes")
        return torch.autograd.grad((y * w.to(device)).sum(), ins)

    kernels.reset_launch_counts()
    got, want = grads(dev), grads("cpu")
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.LAUNCHES, 0), "selective_scan_fwd_lanes": 1,
        "selective_scan_fwd": 1, "selective_scan_bwd": 1}
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.cpu(), b, 1e-4, summed=i in (2, 5, 6))


_SCANS = {"selective_scan_fwd": 2, "selective_scan_bwd": 2}


@pytest.mark.parametrize("config,transposed,counts", [
    # fused_kernels pools over the last axis only (blocks.py rotates)
    (dict(fused_kernels="always"), False,
     {"conv_pool_fwd": 1, "merge_gate_fwd": 1, **_SCANS}),
    (dict(fused_kernels="merge"), False, {"merge_gate_fwd": 1, **_SCANS}),
    (dict(fused_merge=True), False, {"merge_ln_gate_fwd": 1, **_SCANS}),
    (dict(fused_merge=True), True, {"merge_ln_gate_fwd": 1, **_SCANS}),
    # the remat backward runs K1 twice more through the unfused math
    (dict(layer_fused="recompute"), False,
     {"pass_a_fwd": 1, "pass_b_recompute_fwd": 1, "selective_scan_fwd": 4,
      "selective_scan_bwd": 2}),
    (dict(layer_fused="recompute"), True,
     {"pass_a_fwd": 1, "pass_b_recompute_fwd": 1, "selective_scan_fwd": 4,
      "selective_scan_bwd": 2}),
])
def test_mixer_configurations_grads_match_cpu(dev, config, transposed,
                                              counts):
    """One mixer in each configuration, forward and backward on the card:
    the kernels its forward launches (its backward recomputes through
    plain ops and K1/K2), and the CPU's output and gradients."""
    from fastvim_tpu_torch.models.mixer import MambaMixer

    kw = {"layer_fused": "off", **config}
    cpu = MambaMixer(d_model=64, n_layer=2, **kw)
    cpu.reset_parameters(torch.Generator().manual_seed(5))
    gpu = MambaMixer(d_model=64, n_layer=2, **kw)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.randn(2, 60, 64, generator=torch.Generator().manual_seed(6))
    grid, extra = (6, 10), (dict(pool_axes=(0,), transposed=True)
                            if transposed else {})

    def run(mixer, device):
        xx = x.to(device).requires_grad_()
        out = mixer(xx, grid, **extra)
        params = list(mixer.parameters())
        return out, torch.autograd.grad((out ** 2).sum(), [xx] + params)

    kernels.reset_launch_counts()
    out, got = run(gpu, dev)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                       **counts}
    want_out, want = run(cpu, "cpu")
    _close(out.detach().cpu(), want_out.detach(), 1e-4)
    for a, b in zip(got, want):
        _close(a.cpu(), b, 1e-4, summed=True)


def test_new_wrappers_refuse(dev):
    """Widths and layouts the new kernels do not take raise instead of
    falling back."""
    g = torch.Generator(device=dev).manual_seed(1)
    a = _block_args(g, torch.float32, 1, 4, 6, 32, True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fb.conv_pool(a[0].clone().requires_grad_(), *a[4:8], 4, 6)
    with pytest.raises(ValueError, match="d % 32"):
        fb.conv_pool(_rand(g, 1, 24, 20), *(t[:20] for t in a[4:8]), 4, 6)
    with pytest.raises(ValueError, match="column slice"):
        fb.merge_gate(_rand(g, 1, 32, 24).transpose(1, 2), *a[1:], 4, 6)
    with pytest.raises(ValueError, match="does not match grid"):
        fb.merge_gate(*a, 5, 6)
    with pytest.raises(ValueError, match="float32"):
        fb.merge_gate(a[0], a[1], a[2].bfloat16(), *a[3:], 4, 6)
    xc = _rand(g, 1, 24, 32)
    with pytest.raises(ValueError, match="pooled over one axis"):
        mg.merge_ln_gate(xc, xc, xc, a[2], a[3], a[8], a[9], None, None,
                         (4, 6), (0, 1), 1e-5, False)
    x4, y = _rand(g, 1, 8, 8, 64), _rand(g, 1, 8, 2592)
    v = _rand(g, 2592)
    with pytest.raises(ValueError, match="d_inner <= 2560"):
        lf.pass_b_recompute(x4, y, y, _rand(g, 2592, 64), None,
                            _rand(g, 2592, 4), None, _rand(g, 2592, 4), None,
                            _rand(g, 2592, 64), None, v, v, v, v,
                            _rand(g, 64, 2592), None, 1e-5, True, False)
    u = _rand(g, 1, 8, 64)
    with pytest.raises(NotImplementedError, match="forward-only"):
        selective_scan(u, u, -torch.ones(64, 16, device=dev),
                       _rand(g, 1, 8, 16), _rand(g, 1, 8, 16), reverse=True,
                       variant="lanes")


@pytest.fixture(params=["gloo", "nccl"])
def one_rank(dev, tmp_path, request):
    """A process group of one rank on the card (gloo stages its CUDA
    tensors through the host, NCCL takes them); yields the backend."""
    torch.distributed.init_process_group(
        request.param, init_method=f"file://{tmp_path / 'store'}",
        world_size=1, rank=0)
    yield request.param
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("method", ["mean", "max"])
def test_seq_functions_on_one_rank_match_plain(one_rank, dev, dtype,
                                               transposed, method):
    """The seq axis's halo conv, pools, gathers and final pools
    (``parallel/tokens.py``) over a one-rank group on the card against
    the whole-grid ops they stand for, outputs and gradients."""
    import torch_seq_ranks

    for name, got, want in torch_seq_ranks.one_rank_functions(
            dev, dtype, transposed, method, one_rank):
        assert got.device.type == "cuda", name
        _close(got, want, TOL[dtype], summed=True)
