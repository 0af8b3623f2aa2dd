"""K1's chunk-parallel form (csrc/selective_scan_fwd_chunked.cu) on the
CPU: its plain version against the JAX package, and the launcher's route.

:func:`selective_scan_fwd_chunked_plain` runs the kernel's three phases
in tensor ops (chunk-local scans from zero, the chunk-to-chunk pass with
exp(A·S), the rerun from the entry states). Here it is held to the
sequential JAX reference ``selective_scan_ref`` (the fp32 oracle, not the
associative scan) and to the Pallas kernel ``_pallas_fwd`` in interpret
mode with 64-step blocks, whose saved states (batch, nl, n, d) are the
port's (batch, nchunks, d, n) transposed. Inputs come from numpy seeds.
fp32; |got - want| <= 1e-5 + 1e-5·|want|: both sides do the same fp32
operations in other orders (the chunk's decay as one exp(A·S) here, as a
product of steps there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.ops.pallas.selective_scan import _pallas_fwd
from fastvim_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from fastvim_tpu_torch.ops.kernels import selective_scan as ss

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, batch, L, d, n, extras):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
             A=-np.exp(rng.uniform(-1, 1, (d, n))).astype(np.float32),
             B=f(batch, L, n), C=f(batch, L, n),
             D=rng.uniform(-1, 1, d).astype(np.float32),
             delta_bias=rng.uniform(-0.5, 0.5, d).astype(np.float32))
    if not extras:
        a["D"] = a["delta_bias"] = None
    return a


@pytest.mark.parametrize("n,d,extras", [(16, 32, True), (8, 16, False)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 37, 64, 65, 200, 385])
def test_chunked_plain_matches_pallas_and_ref(L, reverse, n, d, extras):
    """y and the chunk-entry states: one step, a partial chunk, exactly one
    chunk, one step past it, and 4 and 7 chunks with a partial last one
    (scanned first when reversed, from a zero state)."""
    a = _inputs(1000 * L + n + reverse, 2, L, d, n, extras)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    y, states = ss.selective_scan_fwd_chunked_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        True, reverse)
    assert y.dtype == torch.float32 and states.dtype == torch.float32
    assert tuple(states.shape) == (2, -(-L // 64), d, n)
    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    pal_y, pal_states = _pallas_fwd(
        j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"], j["delta_bias"],
        True, block_l=64, block_d=d, interpret=True, reverse=reverse,
        save_states=True)
    ref = jax_scan_ref(j["u"], j["delta"], j["A"], j["B"], j["C"], D=j["D"],
                       delta_bias=j["delta_bias"], delta_softplus=True,
                       reverse=reverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(pal_y), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        states.numpy(), np.asarray(pal_states).transpose(0, 1, 3, 2), **TOL)


def test_chunked_plain_no_softplus_and_bf16_inputs():
    """Without softplus, and with bf16 inputs (widened to fp32, y rounded
    back to bf16): the plain version agrees with the sequential one."""
    a = _inputs(7, 2, 150, 16, 16, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # delta + bias used as it is must stay >= 0, or the state grows
    t["delta"], t["delta_bias"] = t["delta"].abs(), t["delta_bias"].abs()
    for dtype in (torch.float32, torch.bfloat16):
        args = [t[k].to(dtype) if k in "u delta B C".split() else t[k]
                for k in ("u", "delta", "A", "B", "C")]
        for softplus in (False, True):
            y, _ = ss.selective_scan_fwd_chunked_plain(
                *args, t["D"], t["delta_bias"], softplus, True)
            want = ss.selective_scan_plain(
                *args, D=t["D"], delta_bias=t["delta_bias"],
                delta_softplus=softplus, reverse=True)
            assert y.dtype == want.dtype == dtype
            tol = TOL if dtype == torch.float32 else dict(rtol=1e-2,
                                                          atol=1e-2)
            torch.testing.assert_close(y.float(), want.float(), **tol)


def test_route_threshold():
    """FastVim's pooled scans (L = 128 at 2048 px; 14 at 224 px) and
    Vim's 224 px ones (197) stay on the sequential kernel; Vim-T's
    full-length ones at 2048 px (16,384, 16,385 with the middle cls token)
    take the chunked form. The H100's device times moved the threshold
    from the 1,024 first proposed to 512: the chunked form is faster from
    there (bf16, B = 2, d 384)."""
    assert ss.CHUNKED_MIN_L == 512
    for L in (1, 14, 64, 128, 197, 256, ss.CHUNKED_MIN_L - 1):
        assert ss.fwd_route(L) == "sequential"
    for L in (ss.CHUNKED_MIN_L, 4096, 16384, 16385):
        assert ss.fwd_route(L) == "chunked"


def test_cpu_launcher_runs_reference_and_forms_need_cuda():
    """On the CPU the launcher runs the sequential reference and returns no
    states; each of K1's forms launches on CUDA tensors only (nothing falls
    back to the plain version), and an unknown form raises."""
    a = _inputs(3, 1, 70, 16, 8, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = [t[k] for k in ("u", "delta", "A", "B", "C")]
    kw = dict(D=t["D"], delta_bias=t["delta_bias"], delta_softplus=True,
              save_states=True)
    want = ss.selective_scan_plain(*args, D=t["D"],
                                   delta_bias=t["delta_bias"],
                                   delta_softplus=True)
    y, states = ss.selective_scan_fwd(*args, **kw)
    assert states is None
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    for form in ("chunked", "sequential"):
        with pytest.raises(ValueError, match="unsupported device"):
            ss._launch_fwd(form, *args, **kw)
    with pytest.raises(KeyError):
        ss._launch_fwd("lanes", *args, **kw)
