"""K1, K2 and lanes: the chunked selective scan, forward
(``csrc/selective_scan_fwd.cu`` for short scans,
``csrc/selective_scan_fwd_chunked.cu`` for long ones) and backward
(``csrc/selective_scan_bwd.cu`` for short scans,
``csrc/selective_scan_bwd_chunked.cu`` for long ones), the forward with
time across a warp's lanes (``csrc/selective_scan_lanes.cu``), and the
``torch.autograd.Function``s around them.

K1 replaces ``_scan_kernel``, K2 ``_bwd_kernel`` and lanes
``_scan_kernel_lanes`` of ``fastvim_tpu/ops/pallas/selective_scan.py``.
K1's plain version is the sequential reference
:func:`fastvim_tpu_torch.ops.scan.selective_scan_ref`, and its
chunk-parallel form's is :func:`selective_scan_fwd_chunked_plain`, the
same three phases in tensor ops; K2's is :func:`selective_scan_bwd_plain`,
the same adjoint written in tensor ops (not autograd through the
forward), and its chunk-parallel form's is
:func:`selective_scan_bwd_chunked_plain`; lanes' is
:func:`selective_scan_fwd_lanes_plain`, the doubling scan written with
shifts over the time axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import selective_scan_ref

selective_scan_plain = selective_scan_ref

CHUNK = 64        # steps per chunk in K1 and K2 (kChunk in csrc/)
BWD_CHANNELS = 8  # channels per K2 block (kBwdChannels in csrc/)
BWD_SLOT = 32     # channels per dB/dC partial of chunked K2 (kSlot in csrc/)
LANES_CHUNK = 128  # steps per chunk of the TPU lanes kernel, as its plain
# version mirrors them
LANES_SPAN = 256     # steps a block of the lanes kernel (kSpan in csrc/)
LANES_CHANNELS = 4   # channels a group of the lanes kernel (kC in csrc/)
# K1 takes its chunk-parallel form from this many steps on; shorter scans
# (FastVim's pooled L = 128, Vim's 197 at 224 px) keep the sequential
# kernel. Set from both forms' device times on the H100 (bf16, B = 2, d
# 384: sequential faster at L = 256, chunked from 512 on; PERF.md §6,
# utils/profiling.py --scan-times).
CHUNKED_MIN_L = 512
# K2 takes its chunk-parallel form from this many steps on: its sequential
# form walks two chains a chunk, so the crossover comes earlier than K1's.
# Set from both forms' device times on the H100 (bf16, B = 2, d 384:
# sequential 0.030 against chunked 0.046 ms at L = 128, 0.052 against
# 0.047 at 256; PERF.md §6, utils/profiling.py --scan-times). FastVim's
# pooled L = 128 keeps the sequential kernel.
CHUNKED_BWD_MIN_L = 256


def fwd_route(L: int) -> str:
    """The K1 form :func:`selective_scan_fwd` launches on the card for a
    scan of L steps: "chunked" (``csrc/selective_scan_fwd_chunked.cu``)
    or "sequential" (``csrc/selective_scan_fwd.cu``)."""
    return "chunked" if L >= CHUNKED_MIN_L else "sequential"


def bwd_route(L: int) -> str:
    """The K2 form :func:`selective_scan_bwd` launches on the card for a
    scan of L steps: "chunked" (``csrc/selective_scan_bwd_chunked.cu``)
    or "sequential" (``csrc/selective_scan_bwd.cu``)."""
    return "chunked" if L >= CHUNKED_BWD_MIN_L else "sequential"


def _check_scan_args(name, u, delta, A, B, C, D, delta_bias):
    batch, L, d = u.shape
    n = A.shape[1]
    code = kernels.dtype_code(name, u)
    for arg, t, shape in (("delta", delta, (batch, L, d)),
                          ("B", B, (batch, L, n)), ("C", C, (batch, L, n))):
        if t.dtype != u.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {u.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t, shape in (("A", A, (d, n)), ("D", D, (d,)),
                          ("delta_bias", delta_bias, (d,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return batch, L, d, n, code


def _outputs(y, states, last, save_states: bool, return_last_state: bool):
    """y, then states with ``save_states``, then the last state with
    ``return_last_state``: a tuple when there is more than y."""
    out = (y,) + ((states,) if save_states else ()) + (
        (last,) if return_last_state else ())
    return out if len(out) > 1 else y


def selective_scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       reverse: bool = False, save_states: bool = False,
                       z: Optional[torch.Tensor] = None,
                       return_last_state: bool = False):
    """u, delta: (batch, L, d); B, C: (batch, L, n), all of one dtype
    (float32 or bfloat16); A: (d, n) float32; D, delta_bias: (d,) float32
    or None; z: (batch, L, d) of u's dtype or None, which gates the
    output, y · silu(z), in fp32 before its one rounding (on CUDA z may be
    a column slice of a wider (batch, L, ·) tensor, the z half of an
    in-projection). Returns y (batch, L, d) in u's dtype. On CUDA, d must
    be a multiple of 4 and n 8 or 16.

    With ``save_states`` also states (batch, ceil(L / 64), d, n) float32:
    the state h on entry to each 64-step chunk, in scan order, which K2
    rebuilds h from (None on the CPU: the plain backward needs none).
    With ``return_last_state`` also the state after the last step in scan
    order, (batch, d, n) float32 (after t = 0 for ``reverse``). The
    outputs come in that order, as a tuple when there is more than y.

    On CUDA one call is one K1 launch (``LAUNCHES``) of the form
    :func:`fwd_route` picks for L; the chunked form is three device
    kernels on the current stream."""
    if u.device.type == "cpu":
        out = selective_scan_plain(u, delta, A, B, C, D=D,
                                   delta_bias=delta_bias,
                                   delta_softplus=delta_softplus,
                                   reverse=reverse, z=z,
                                   return_last_state=return_last_state)
        y, last = out if return_last_state else (out, None)
        return _outputs(y, None, last, save_states, return_last_state)
    return _launch_fwd(fwd_route(u.shape[1]), u, delta, A, B, C, D,
                       delta_bias, delta_softplus, reverse, save_states, z,
                       return_last_state)


def _launch_fwd(form: str, u, delta, A, B, C, D=None, delta_bias=None,
                delta_softplus: bool = False, reverse: bool = False,
                save_states: bool = False, z=None,
                return_last_state: bool = False):
    """K1 on CUDA tensors in the given form, "chunked" or "sequential",
    whatever L is: :func:`selective_scan_fwd`'s launch, which the tests
    and timings call to hold one form against the other."""
    name = "selective_scan_fwd"
    chunked = {"chunked": True, "sequential": False}[form]
    kernels.check_cuda_args(name, u.device, token_strided=("z",), u=u,
                            delta=delta, A=A, B=B, C=C, D=D,
                            delta_bias=delta_bias, z=z)
    batch, L, d, n, code = _check_scan_args(name, u, delta, A, B, C, D,
                                            delta_bias)
    if d % 4 or n not in (8, 16):
        raise ValueError(f"{name}: needs d % 4 == 0 and n in (8, 16), got "
                         f"d={d}, n={n}")
    ldz = 0
    if z is not None:
        if z.dtype != u.dtype or z.shape != u.shape:
            raise ValueError(f"{name}: z must be {u.dtype} "
                             f"{tuple(u.shape)}, got {z.dtype} "
                             f"{tuple(z.shape)}")
        ldz = kernels.token_stride(name, "z", z)
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C,
                          delta_bias=delta_bias)
    nchunks = -(-L // CHUNK)
    out = torch.empty_like(u)
    f32 = dict(dtype=torch.float32, device=u.device)
    states = (torch.empty(batch, nchunks, d, n, **f32)
              if save_states or chunked else None)
    # an empty scan leaves the state at 0, and the kernels return at once
    last = ((torch.zeros if L == 0 else torch.empty)(batch, d, n, **f32)
            if return_last_state else None)
    ins = tuple(map(kernels.ptr, (u, delta, A, B, C, delta_bias, D, z, out,
                                  states, last)))
    flags = (batch, L, d, n, ldz, code, int(delta_softplus), int(reverse),
             kernels.stream_ptr(u.device))
    if chunked:  # the chunks' sums of delta: phase 1 → phase 2
        dsum = torch.empty(batch, nchunks, d, **f32)
        err = _build.library().fv_selective_scan_fwd_chunked(
            *ins, kernels.ptr(dsum), *flags)
    else:
        err = _build.library().fv_selective_scan_fwd(*ins, *flags)
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return _outputs(out, states, last, save_states, return_last_state)


def selective_scan_fwd_chunked_plain(u, delta, A, B, C, D=None,
                                     delta_bias=None,
                                     delta_softplus: bool = False,
                                     reverse: bool = False, z=None,
                                     return_last_state: bool = False):
    """K1's chunk-parallel form in tensor ops, fp32: L padded to whole
    64-step chunks with identity steps (delta = 0, so a = 1 and b = 0),
    the chunks turned into scan order, then the kernel's three phases:
    each chunk scanned from h = 0 (h_loc) with S = Σ delta over it, the
    state passed from chunk to chunk as h_in = exp(A·S)·h_in + h_loc, and
    each chunk scanned again from its h_in for y, gated by silu(z) where
    z is given. Returns ``(y, states)`` with y in u's dtype and states
    (batch, ceil(L / 64), d, n) float32, the chunk-entry states in K2's
    layout (position order, scan-order state), and with
    ``return_last_state`` ``(y, states, last)``: the state pass carried
    one chunk further, (batch, d, n) float32. Same contract as
    :func:`selective_scan_fwd` with ``save_states``; what checks the
    combine rule and the state layout, not the reference again."""
    batch, L, d = u.shape
    nc = -(-L // CHUNK)
    pad = nc * CHUNK - L
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = F.softplus(dt)
    # chunks and their steps in scan order: the flip is its own inverse
    order = lambda t: t.flip(1, 2) if reverse else t
    to_scan = lambda t: order(F.pad(t.float(), (0, 0, 0, pad))
                              .reshape(batch, nc, CHUNK, t.shape[-1]))
    dt_s, u_s, B_s, C_s = map(to_scan, (dt, u, B, C))  # (b, nc, CHUNK, ·)
    A32 = A.float()
    a = torch.exp(dt_s[..., None] * A32)             # (b, nc, CHUNK, d, n)
    x = (dt_s * u_s)[..., None] * B_s[:, :, :, None, :]

    h_loc = a.new_zeros(batch, nc, d, A.shape[1])  # phase 1
    for k in range(CHUNK):
        h_loc = a[:, :, k] * h_loc + x[:, :, k]
    decay = torch.exp(dt_s.sum(2)[..., None] * A32)  # (b, nc, d, n)
    entry = torch.empty_like(h_loc)  # phase 2
    h = torch.zeros_like(h_loc[:, 0])
    for c in range(nc):
        entry[:, c] = h
        h = decay[:, c] * h + h_loc[:, c]
    last = h  # the pass carried past the last chunk: the final state
    hs, h = torch.empty_like(a), entry  # phase 3
    for k in range(CHUNK):
        h = a[:, :, k] * h + x[:, :, k]
        hs[:, :, k] = h
    y = (hs * C_s[:, :, :, None, :]).sum(-1)  # (b, nc, CHUNK, d)
    if D is not None:
        y = y + D.float() * u_s
    if z is not None:
        y = y * F.silu(to_scan(z))
    y = order(y).reshape(batch, nc * CHUNK, d)[:, :L]
    states = (entry.flip(1) if reverse else entry).contiguous()
    if return_last_state:
        return y.to(u.dtype), states, last
    return y.to(u.dtype), states


# ----------------------------------------------------------------------
# lanes: the forward with time across the lanes
# ----------------------------------------------------------------------

def selective_scan_fwd_lanes_plain(u, delta, A, B, C, D=None, delta_bias=None,
                                   delta_softplus: bool = False,
                                   chunk: int = LANES_CHUNK):
    """The forward scan as the TPU lanes kernel computes it, in tensor
    ops: time last, padded to whole chunks (u = 0, so padded steps add
    nothing), inside each chunk a log-depth doubling scan of the pairs
    (a, b) ← (a·a₋ₖ, b + a·b₋ₖ) for shifts k = 1, 2, 4, … with the
    identity (1, 0) shifted in, then the state carried from chunk to
    chunk. (The CUDA kernel applies the same combine rule, to lane totals
    of 4 steps.) Same contract as :func:`selective_scan_plain` without
    ``reverse``; what checks the combine rule, not the reference again."""
    batch, L, d = u.shape
    pad = (-L) % chunk
    tl = lambda t: F.pad(t.float(), (0, 0, 0, pad)).transpose(1, 2)
    u_t, dt, B_t, C_t = tl(u), tl(delta), tl(B), tl(C)  # (b, d | n, L + pad)
    if delta_bias is not None:
        dt = dt + delta_bias.float()[:, None]
    if delta_softplus:
        dt = F.softplus(dt)
    chunks = lambda t: t.reshape(*t.shape[:-1], -1, chunk)
    a = chunks(torch.exp(dt[:, None] * A.float().t()[None, :, :, None]))
    b = chunks((dt * u_t)[:, None] * B_t[:, :, None])  # (b, n, d, nc, chunk)
    shift = 1
    while shift < chunk:
        a_sh = F.pad(a[..., :-shift], (shift, 0), value=1.0)
        b_sh = F.pad(b[..., :-shift], (shift, 0), value=0.0)
        b = b + a * b_sh
        a = a * a_sh
        shift *= 2
    h = a.new_zeros(a.shape[:3])  # (b, n, d): the carried state
    Cc = chunks(C_t)
    ys = []
    for ci in range(a.shape[3]):
        hc = b[..., ci, :] + a[..., ci, :] * h[..., None]
        h = hc[..., -1]
        ys.append((hc * Cc[:, :, None, ci]).sum(1))
    y = torch.cat(ys, -1) if ys else u_t
    if D is not None:
        y = y + D.float()[:, None] * u_t
    return y.transpose(1, 2)[:, :L].to(u.dtype)


def selective_scan_fwd_lanes(u, delta, A, B, C, D=None, delta_bias=None,
                             delta_softplus: bool = False):
    """The lanes variant of the forward scan, forward direction only;
    same contract as :func:`selective_scan_fwd` without ``reverse`` and
    ``save_states``. On CUDA, d must be a multiple of 4 and n 8 or 16;
    u, delta, B and C are read (batch, L, ·) as they lie and y is written
    so, with no copies. One call is one launch (``LAUNCHES``): a memset of
    the carry's scratch and one kernel, the carry chained from 256-step
    span to span."""
    if u.device.type == "cpu":
        return selective_scan_fwd_lanes_plain(u, delta, A, B, C, D=D,
                                              delta_bias=delta_bias,
                                              delta_softplus=delta_softplus)
    name = "selective_scan_fwd_lanes"
    kernels.check_cuda_args(name, u.device, u=u, delta=delta, A=A, B=B, C=C,
                            D=D, delta_bias=delta_bias)
    batch, L, d, n, code = _check_scan_args(name, u, delta, A, B, C, D,
                                            delta_bias)
    if d % LANES_CHANNELS or n not in (8, 16):
        raise ValueError(f"{name}: needs d % {LANES_CHANNELS} == 0 and n in "
                         f"(8, 16), got d={d}, n={n}")
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C)
    nspans = -(-L // LANES_SPAN)
    out = torch.empty_like(u)
    # each span's inclusive state and its flag, a 64-bit word each; the
    # ticket counter
    states = torch.empty(batch * nspans * d * n + 1, dtype=torch.int64,
                         device=u.device)
    err = _build.library().fv_selective_scan_fwd_lanes(
        *map(kernels.ptr, (u, delta, A, B, C, delta_bias, D, out, states)),
        batch, L, d, n, code, int(delta_softplus),
        kernels.stream_ptr(u.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


# ----------------------------------------------------------------------
# K2: the backward
# ----------------------------------------------------------------------

ScanGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor]


def selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, g,
                             delta_softplus: bool = False,
                             reverse: bool = False) -> ScanGrads:
    """The adjoint of the sequential scan in tensor ops, fp32: rebuild h
    in scan order, run λ[t] = C[t]·g[t] + a[next t]·λ[next t] against it,
    and contract. Returns (du, ddelta, dA, dB, dC, dD, dbias), all
    float32; dD and dbias are sums even where D / delta_bias is None."""
    batch, L, d = u.shape
    u32, g32 = u.float(), g.float()
    dt_in = delta.float()
    if delta_bias is not None:
        dt_in = dt_in + delta_bias.float()
    dt = F.softplus(dt_in) if delta_softplus else dt_in
    A32, Bf, Cf = A.float(), B.float(), C.float()
    a = torch.exp(dt.unsqueeze(-1) * A32)                     # (b, L, d, n)
    x = dt * u32
    order = list(range(L - 1, -1, -1) if reverse else range(L))
    hs = torch.empty_like(a)
    h_prev = torch.empty_like(a)
    h = a.new_zeros(batch, d, A.shape[1])
    for t in order:
        h_prev[:, t] = h
        h = a[:, t] * h + x[:, t, :, None] * Bf[:, t, None, :]
        hs[:, t] = h
    lam = torch.empty_like(a)
    carry = torch.zeros_like(h)
    for t in reversed(order):
        lam[:, t] = Cf[:, t, None, :] * g32[:, t, :, None] + carry
        carry = a[:, t] * lam[:, t]
    daa = lam * h_prev * a                                    # dL/da · a
    lam_b = torch.einsum("bldn,bln->bld", lam, Bf)
    du = lam_b * dt
    if D is not None:
        du = du + D.float() * g32
    ddelta = torch.einsum("bldn,dn->bld", daa, A32) + lam_b * u32
    if delta_softplus:
        ddelta = ddelta * torch.sigmoid(dt_in)
    return (du, ddelta, torch.einsum("bldn,bld->dn", daa, dt),
            torch.einsum("bldn,bld->bln", lam, x),
            torch.einsum("bldn,bld->bln", hs, g32),
            (g32 * u32).sum((0, 1)), ddelta.sum((0, 1)))


def selective_scan_bwd_chunked_plain(u, delta, A, B, C, D, delta_bias, g,
                                     states, delta_softplus: bool = False,
                                     reverse: bool = False) -> ScanGrads:
    """K2's chunk-parallel form in tensor ops, fp32: L padded to whole
    64-step chunks with identity steps (delta = 0, so a = 1, and u = g =
    B = C = 0), the chunks turned into scan order, then the kernel's three
    phases: each chunk's λ run against scan order from a zero carry (its
    summary, a·λ out of its first step, and S = Σ delta over it), the
    carry passed from chunk to chunk against scan order as carry_in =
    exp(A·S)·carry_in + summary, and each chunk again, h rebuilt from
    ``states`` (K1's chunk-entry states: (batch, ceil(L / 64), d, n),
    position order, scan-order entry) and λ from its carry_in, for the
    gradients. Same contract as :func:`selective_scan_bwd_plain`; what
    checks the carry pass and the use of the states, not the adjoint
    again."""
    batch, L, d = u.shape
    nc = -(-L // CHUNK)
    pad = nc * CHUNK - L
    dt_in = delta.float()
    if delta_bias is not None:
        dt_in = dt_in + delta_bias.float()
    dt = F.softplus(dt_in) if delta_softplus else dt_in
    sig = torch.sigmoid(dt_in) if delta_softplus else torch.ones_like(dt_in)
    # chunks and their steps in scan order: the flip is its own inverse
    order = lambda t: t.flip(1, 2) if reverse else t
    to_scan = lambda t: order(F.pad(t.float(), (0, 0, 0, pad))
                              .reshape(batch, nc, CHUNK, t.shape[-1]))
    dt_s, u_s, g_s, B_s, C_s = map(to_scan, (dt, u, g, B, C))
    A32 = A.float()
    a = torch.exp(dt_s[..., None] * A32)             # (b, nc, CHUNK, d, n)
    x = dt_s * u_s
    cg = g_s[..., None] * C_s[:, :, :, None, :]      # C·g

    out = a.new_zeros(batch, nc, d, A.shape[1])  # phase 1
    for k in reversed(range(CHUNK)):
        out = a[:, :, k] * (cg[:, :, k] + out)
    decay = torch.exp(dt_s.sum(2)[..., None] * A32)  # (b, nc, d, n)
    carry_in = torch.empty_like(out)  # phase 2, chunks against scan order
    carry = torch.zeros_like(out[:, 0])
    for c in reversed(range(nc)):
        carry_in[:, c] = carry
        carry = decay[:, c] * carry + out[:, c]
    h_prev, hs = torch.empty_like(a), torch.empty_like(a)  # phase 3
    h = (states.flip(1) if reverse else states).float()
    for k in range(CHUNK):
        h_prev[:, :, k] = h
        h = a[:, :, k] * h + x[:, :, k, :, None] * B_s[:, :, k, None, :]
        hs[:, :, k] = h
    lam = torch.empty_like(a)
    carry = carry_in
    for k in reversed(range(CHUNK)):
        lam[:, :, k] = cg[:, :, k] + carry
        carry = a[:, :, k] * lam[:, :, k]
    daa = lam * h_prev * a                                    # dL/da · a
    lam_b = torch.einsum("bckdn,bckn->bckd", lam, B_s)
    # back to positions, the padding cut
    back = lambda t: order(t).reshape(batch, nc * CHUNK, *t.shape[3:])[:, :L]
    du = back(lam_b * dt_s)
    if D is not None:
        du = du + D.float() * g.float()
    ddelta = back(torch.einsum("bckdn,dn->bckd", daa, A32) + lam_b * u_s)
    ddelta = ddelta * sig
    dA = torch.einsum("bckdn,bckd->dn", daa, dt_s)  # 0 where dt is padding
    dB = back(torch.einsum("bckdn,bckd->bckn", lam, x))
    dC = back(torch.einsum("bckdn,bckd->bckn", hs, g_s))
    return (du, ddelta, dA, dB, dC, (g.float() * u.float()).sum((0, 1)),
            ddelta.sum((0, 1)))


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, g, states,
                       delta_softplus: bool = False,
                       reverse: bool = False) -> ScanGrads:
    """K2; same contract as :func:`selective_scan_bwd_plain`, with the
    chunk-entry ``states`` that :func:`selective_scan_fwd` saved (unused
    on the CPU). On CUDA, d must be a multiple of 8 and n 8 or 16.

    On CUDA one call is one K2 launch (``LAUNCHES``) of the form
    :func:`bwd_route` picks for L. dB and dC sum over d and dA over the
    batch across blocks: the kernels write one partial per block and
    sum them in a fixed order, so the result is the same from run to
    run."""
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, g,
                                        delta_softplus, reverse)
    return _launch_bwd(bwd_route(u.shape[1]), u, delta, A, B, C, D,
                       delta_bias, g, states, delta_softplus, reverse)


def _launch_bwd(form: str, u, delta, A, B, C, D, delta_bias, g, states,
                delta_softplus: bool = False,
                reverse: bool = False) -> ScanGrads:
    """K2 on CUDA tensors in the given form, "chunked" or "sequential",
    whatever L is: :func:`selective_scan_bwd`'s launch, which the tests
    and timings call to hold one form against the other."""
    name = "selective_scan_bwd"
    chunked = {"chunked": True, "sequential": False}[form]
    kernels.check_cuda_args(name, u.device, u=u, delta=delta, A=A, B=B, C=C,
                            D=D, delta_bias=delta_bias, g=g, states=states)
    batch, L, d, n, code = _check_scan_args(name, u, delta, A, B, C, D,
                                            delta_bias)
    nchunks = -(-L // CHUNK)
    if g.dtype != u.dtype or g.shape != u.shape:
        raise ValueError(f"{name}: g must be {u.dtype} {tuple(u.shape)}")
    if (states is None or states.dtype != torch.float32
            or tuple(states.shape) != (batch, nchunks, d, n)):
        raise ValueError(f"{name}: states must be float32 "
                         f"{(batch, nchunks, d, n)} from selective_scan_fwd("
                         "save_states=True)")
    if d % BWD_CHANNELS or n not in (8, 16):
        raise ValueError(f"{name}: needs d % {BWD_CHANNELS} == 0 and n in "
                         f"(8, 16), got d={d}, n={n}")
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C, g=g)
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty(batch, L, d, **f32)
    ddelta = torch.empty(batch, L, d, **f32)
    dB = torch.empty(batch, L, n, **f32)
    dC = torch.empty(batch, L, n, **f32)
    vec = torch.empty(d * (n + 2), **f32)
    # per-block partials: dB, dC over the blocks along d; dA, dD, dbias
    # over the batch (and, chunked, over the chunks too)
    if chunked:
        dbc_part = torch.empty(2, batch, -(-d // BWD_SLOT), L, n, **f32)
        vec_part = torch.empty(batch, nchunks, d * (n + 2), **f32)
        carry = torch.empty(batch, nchunks, d, n, **f32)  # phase 1 → 3
        dsum = torch.empty(batch, nchunks, d, **f32)
        scratch = (carry, dsum)
    else:
        dbc_part = torch.empty(2, batch, d // BWD_CHANNELS, L, n, **f32)
        vec_part = torch.empty(batch, d * (n + 2), **f32)
        scratch = ()
    ins = tuple(map(kernels.ptr, (u, delta, A, B, C, delta_bias, D, g, states,
                                  du, ddelta, dbc_part, vec_part, dB, dC, vec,
                                  *scratch)))
    flags = (batch, L, d, n, code, int(delta_softplus), int(reverse),
             kernels.stream_ptr(u.device))
    lib = _build.library()
    fn = (lib.fv_selective_scan_bwd_chunked if chunked
          else lib.fv_selective_scan_bwd)
    _build.check(fn(*ins, *flags), name)
    kernels.LAUNCHES[name] += 1
    return (du, ddelta, vec[:d * n].view(d, n), dB, dC,
            vec[d * n:d * (n + 1)], vec[d * (n + 1):])


class SelectiveScanFn(torch.autograd.Function):
    """y = scan(u, delta, A, B, C, D, delta_bias) (· silu(z)): K1 with
    saved chunk-entry states forward, K2 backward (their plain versions on
    the CPU). Gradients are computed in fp32 and cast to each input's
    dtype. With ``z`` the gate is K1's, rounded once; the backward runs K1
    again without it for the ungated y (dz = g·y·silu'(z)) and hands K2
    g·silu(z). With ``return_last_state`` it returns ``(y, last_state)``;
    the last state is not differentiated (no caller of the JAX package
    differentiates it)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, z, delta_softplus,
                reverse, return_last_state=False):
        u, delta, B, C = (t.contiguous() for t in (u, delta, B, C))
        if u.is_cuda and u.shape[-1] % BWD_CHANNELS:
            # say so before the forward runs, not in the middle of backward
            raise ValueError(f"selective_scan: the backward kernel needs d % "
                             f"{BWD_CHANNELS} == 0, got d={u.shape[-1]}")
        y, states, *last = selective_scan_fwd(
            u, delta, A, B, C, D=D, delta_bias=delta_bias,
            delta_softplus=delta_softplus, reverse=reverse, save_states=True,
            z=z, return_last_state=return_last_state)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, z, states)
        ctx.flags = (delta_softplus, reverse)
        if return_last_state:
            ctx.mark_non_differentiable(last[0])
            return y, last[0]
        return y

    @staticmethod
    def backward(ctx, g, *_):
        u, delta, A, B, C, D, delta_bias, z, states = ctx.saved_tensors
        dz = None
        if z is not None:
            zf = z.float()
            sig = torch.sigmoid(zf)
            if ctx.needs_input_grad[7]:
                y = selective_scan_fwd(u, delta, A, B, C, D=D,
                                       delta_bias=delta_bias,
                                       delta_softplus=ctx.flags[0],
                                       reverse=ctx.flags[1])
                dz = (g.float() * y.float() * sig * (1 + zf * (1 - sig))
                      ).to(z.dtype)
            g = (g.float() * zf * sig).to(u.dtype)
        grads = selective_scan_bwd(u, delta, A, B, C, D, delta_bias,
                                   g.contiguous(), states, *ctx.flags)
        ins = (u, delta, A, B, C, D, delta_bias)
        return tuple(
            gr.to(t.dtype) if t is not None and need else None
            for gr, t, need in zip(grads, ins, ctx.needs_input_grad)
        ) + (dz, None, None, None)


class SelectiveScanLanesFn(torch.autograd.Function):
    """y = scan(...) through the lanes kernel, forward direction. The
    kernel saves no states, so the backward computes the forward again:
    on the card through K1, for the chunk-entry states, and then K2; on
    the CPU by autograd through the sequential reference. The JAX package
    recomputes through its associative scan; the values are the same."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus):
        u, delta, B, C = (t.contiguous() for t in (u, delta, B, C))
        if u.is_cuda and u.shape[-1] % BWD_CHANNELS:
            # say so before the forward runs, not in the middle of backward
            raise ValueError(f"selective_scan: the backward kernel needs d % "
                             f"{BWD_CHANNELS} == 0, got d={u.shape[-1]}")
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias)
        ctx.delta_softplus = delta_softplus
        return selective_scan_fwd_lanes(u, delta, A, B, C, D=D,
                                        delta_bias=delta_bias,
                                        delta_softplus=delta_softplus)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        if not g.is_cuda:
            return kernels.plain_vjp(
                selective_scan_plain, ins, (ctx.delta_softplus,), g,
                ctx.needs_input_grad[:7]) + (None,)
        u, delta, A, B, C, D, delta_bias = ins
        _, states = selective_scan_fwd(u, delta, A, B, C, D=D,
                                       delta_bias=delta_bias,
                                       delta_softplus=ctx.delta_softplus,
                                       save_states=True)
        grads = selective_scan_bwd(u, delta, A, B, C, D, delta_bias,
                                   g.contiguous(), states,
                                   ctx.delta_softplus, False)
        return tuple(
            gr.to(t.dtype) if t is not None and need else None
            for gr, t, need in zip(grads, ins, ctx.needs_input_grad)
        ) + (None,)
