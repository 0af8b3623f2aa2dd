"""K2's chunk-parallel form (csrc/selective_scan_bwd_chunked.cu) on the
CPU: its plain version against the JAX package, and the launcher's route.

:func:`selective_scan_bwd_chunked_plain` runs the kernel's three phases
in tensor ops (each chunk's λ from a zero carry, the carry passed from
chunk to chunk against scan order with exp(A·S), each chunk again from
the chunk-entry states and its carry). Here it is held to ``jax.vjp`` of
the sequential JAX reference ``selective_scan_ref`` in fp32 (the oracle,
not the associative scan) and to the Pallas kernel ``_pallas_bwd`` in
interpret mode with 64-step blocks, fed the chunk-entry states of K1's
plain version transposed to its layout ((batch, nl, n, d); the states
themselves are held to ``_pallas_fwd``'s in
tests/test_torch_port_scan_chunked.py). Inputs
come from numpy seeds. fp32; |got - want| <= 1e-5 + 1e-5·|want| for the
outputs per step (du, ddelta, dB, dC), and for the sums over every step
(dA, dD, dbias) with atol scaled by the largest entry of want: a long
fp32 sum rounds with the size of its terms, not of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.ops.pallas.selective_scan import _pallas_bwd
from fastvim_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from fastvim_tpu_torch.ops.kernels import selective_scan as ss

TOL = 1e-5
NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
SUMMED = ("dA", "dD", "dbias")


def _inputs(seed, batch, L, d, n, extras):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
             A=-np.exp(rng.uniform(-1, 1, (d, n))).astype(np.float32),
             B=f(batch, L, n), C=f(batch, L, n),
             D=rng.uniform(-1, 1, d).astype(np.float32),
             delta_bias=rng.uniform(-0.5, 0.5, d).astype(np.float32),
             g=f(batch, L, d))
    if not extras:
        a["D"] = a["delta_bias"] = None
    return a


def _close(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = TOL * max(1.0, np.abs(want).max()) if name in SUMMED else TOL
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("n,d,extras", [(16, 32, True), (8, 16, False)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 37, 64, 65, 200, 385])
def test_chunked_plain_matches_pallas_and_ref(L, reverse, n, d, extras):
    """All seven gradients: one step, a partial chunk, exactly one chunk,
    one step past it, and 4 and 7 chunks with a partial last one (scanned
    first when reversed, so its carry goes out last)."""
    a = _inputs(1000 * L + n + reverse, 2, L, d, n, extras)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    _, states = ss.selective_scan_fwd_chunked_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        True, reverse)
    got = ss.selective_scan_bwd_chunked_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["delta_bias"],
        t["g"], states, True, reverse)
    assert all(x.dtype == torch.float32 for x in got)

    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    pal = _pallas_bwd(j["u"], j["delta"], j["A"], j["B"], j["C"], j["D"],
                      j["delta_bias"], jnp.asarray(states.numpy()).transpose(
                          0, 1, 3, 2), j["g"], True, block_l=64, block_d=d,
                      interpret=True, reverse=reverse)
    for name, x, y in zip(NAMES, got, pal):
        _close(name, x.numpy(), y)

    # the fp32 oracle: the VJP of the sequential reference, for the
    # arguments the scan was given (D and delta_bias only where present)
    args = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    keys = [k for k in args if j[k] is not None]

    def scan(*vals):
        kw = dict(zip(keys, vals))
        return jax_scan_ref(kw["u"], kw["delta"], kw["A"], kw["B"], kw["C"],
                            D=kw.get("D"), delta_bias=kw.get("delta_bias"),
                            delta_softplus=True, reverse=reverse)

    vjp = jax.jit(lambda g, *vals: jax.vjp(scan, *vals)[1](g))
    for k, want in zip(keys, vjp(j["g"], *(j[k] for k in keys))):
        i = args.index(k)  # the gradients come in the arguments' order
        _close(NAMES[i], got[i].numpy(), want)


def test_chunked_plain_no_softplus_and_bf16_inputs():
    """Without softplus, and with bf16 inputs (widened to fp32; the
    gradients stay fp32): the chunked plain version agrees with the
    sequential one, fed the chunk-entry states of K1's plain version."""
    a = _inputs(7, 2, 150, 16, 16, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # delta + bias used as it is must stay >= 0, or the state grows
    t["delta"], t["delta_bias"] = t["delta"].abs(), t["delta_bias"].abs()
    for dtype in (torch.float32, torch.bfloat16):
        ins = [t[k].to(dtype) if k in "u delta B C".split() else t[k]
               for k in ("u", "delta", "A", "B", "C", "D", "delta_bias")]
        gy = t["g"].to(dtype)
        for softplus in (False, True):
            _, states = ss.selective_scan_fwd_chunked_plain(
                *ins, softplus, True)
            got = ss.selective_scan_bwd_chunked_plain(*ins, gy, states,
                                                      softplus, True)
            want = ss.selective_scan_bwd_plain(*ins, gy, softplus, True)
            for name, x, y in zip(NAMES, got, want):
                assert x.dtype == torch.float32
                _close(name, x.numpy(), y.numpy())


def test_bwd_route_threshold():
    """FastVim's pooled scans (L = 128 at 2048 px; 14 at 224 px) keep the
    sequential adjoint; Vim's 224 px ones (197) too; Vim-T's full-length
    ones at 2048 px (16,384, 16,385 with the middle cls token) take the
    chunked form. The threshold is K2's own, below K1's: both forms'
    device times on the H100 cross between 128 and 256 steps (bf16, B =
    2, d 384), where K1's cross between 256 and 512."""
    assert ss.CHUNKED_BWD_MIN_L == 256 < ss.CHUNKED_MIN_L
    for L in (1, 14, 64, 128, 197, ss.CHUNKED_BWD_MIN_L - 1):
        assert ss.bwd_route(L) == "sequential"
    for L in (ss.CHUNKED_BWD_MIN_L, 512, 4096, 16384, 16385):
        assert ss.bwd_route(L) == "chunked"


def test_cpu_launcher_runs_plain_and_forms_need_cuda():
    """On the CPU the launcher runs the sequential plain adjoint whatever
    L is, states or none; each of K2's forms launches on CUDA tensors only
    (nothing falls back to the plain version), and an unknown form
    raises."""
    L = ss.CHUNKED_BWD_MIN_L + 5
    a = _inputs(3, 1, L, 16, 8, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ins = [t[k] for k in ("u", "delta", "A", "B", "C", "D", "delta_bias")]
    _, states = ss.selective_scan_fwd_chunked_plain(*ins, True, False)
    want = ss.selective_scan_bwd_plain(*ins, t["g"], True, False)
    for st in (states, None):
        got = ss.selective_scan_bwd(*ins, t["g"], st, True, False)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for form in ("chunked", "sequential"):
        with pytest.raises(ValueError, match="unsupported device"):
            ss._launch_bwd(form, *ins, t["g"], states, True, False)
    with pytest.raises(KeyError):
        ss._launch_bwd("lanes", *ins, t["g"], states, True, False)
