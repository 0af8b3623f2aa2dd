"""Bidirectional (FastVim/Vim) Mamba mixer, dense path.

Counterpart of ``fastvim_tpu/models/mixer.py``:

* ``collapse_method="mean"|"max"``: FastVim's pooled scan — the conv
  output is pooled over one grid axis, the scan runs over the other, the
  result is broadcast back and per-token detail returns through the
  ``D·conv_out`` skip.
* ``collapse_method="none"``: plain Vim, a full-length scan.

The reverse direction is computed in original token order (anticausal
conv + reverse scan), with no full-length flips. ``transposed`` is the
odd-layer orientation: the conv runs along the column-major raster and
pooling is over rows, without moving the tokens.

Dispatch, in this order (``forward``):

1. ``layer_fused`` "auto" or "on" (the same here: the fused layer runs on
   every device), on a grid and at widths that
   :func:`~fastvim_tpu_torch.ops.kernels.layer_fused.fusable` accepts: the
   whole layer runs as pass A (K3) → pooled scans (K1) → pass B (K4),
   except where ``default_fwd_mode`` sends a forward that takes no
   gradient to the unfused path (fp32 FastVim-L and -H on lines of up to
   16 tokens, where the fused forward measured slower).
   ``layer_fused="recompute"`` (the JAX package's
   ``FASTVIM_LF_RECOMPUTE=1``) is the same layer with pass A writing the
   pools only and pass B computing the conv stage again (K7). K3, K4
   and K7 take every registry width (d_model up to 1280, d_inner up to
   2560: FastVim-T/S/B/L/H), so both modes fuse at every registry width;
   a layer outside the predicate runs the unfused path below, which
   computes the same function.
2. ``fused_kernels`` "auto" or "always" (the same here), for mean or max
   pooling over the last axis of a 2-D grid: conv + pool (K8) → pooled
   scans → conv again + merge + LN + gate (K9); "merge" runs the conv and
   the pool in plain ops and only K9. ``models/blocks.py`` materializes
   the odd-layer rotation for such a model, so every layer pools over its
   last axis.
3. ``fused_merge`` (the JAX package's ``FASTVIM_FUSED_MERGE=1``), for any
   pooled 2-D layer in either orientation: plain conv and pool, then
   broadcast + D-skip + merge + LN + gate in one kernel (K10).
4. the plain unfused math.

Over several ranks each rank runs these on its own rows of the batch:
the JAX package's ``fused_mixer_core_sharded`` (the fused layer under a
``shard_map`` over the mesh's data axis, since a ``pallas_call`` has no
GSPMD partitioning rule) has no counterpart, because a process already
holds only its shard.

With ``shard`` (a ``parallel.TokenShard``: the token grid sharded over
the mesh's seq axis, this rank holding whole grid rows) none of 1-3
applies either: K3-K10 take whole grids, as the JAX package sets the
fused layer aside on a seq mesh (``_cached_data_mesh``). The layer runs
the unfused math with the seq group's collectives
(``parallel/tokens.py``): the dual conv with its halo, the pooled
sequence made whole on every rank, the pooled scans (K1, K2) run whole
on every rank, and each rank's rows broadcast back.

With ``row_ids`` (the masked encoder of MAE, ``models/mae.py``) the
layer holds only the visible tokens, in raster order, and none of the
above applies: a masked layer never fuses. Each branch pools its conv
output into row bins (a scatter-add divided by the grid's full pooled
extent, ``cols``; ``scaling_factor`` plays no part), scans the bins
ascending in both directions, and gives each token its bin's output (a
gather). Both are products with the one-hot (batch, tokens, rows)
assignment, as in the JAX package: batched GEMMs of
2·batch·tokens·rows·d_inner operations each (at MAE-B's 49 tokens and 14
rows, 0.27 GFLOP a branch at batch 128), deterministic on the card where
a scatter-add's float atomics are not. The reverse branch runs its
anticausal conv in original order and assigns bins with the reversed
row-id sequence: position for position what the reference computes on
the flipped sequence with unflipped ids.

Every scan goes through
:func:`~fastvim_tpu_torch.ops.scan.selective_scan`. ``scan_impl="ref"``
forces the sequential reference scan; any other value ("auto", and the
JAX package's "assoc"/"pallas") dispatches on the device. When a gradient
is needed, ``layer_fused_bwd`` picks the fused layer's backward: "fused"
(the K5 and K6 adjoint kernels, scans by K2), "remat" (autograd through
the unfused math, recomputed; always so in the recompute mode) or "auto"
(the default), which each forward resolves from the widths, the dtype
and the grid (``default_bwd_mode``): "fused" but for fp32 FastVim-H on
lines of up to 16 tokens (224 px), where the fused adjoint does not fit
B = 128 on an 80 GB card; elsewhere the adjoint measured faster. A fused
layer whose widths the adjoint kernels do not take (d_model not a
multiple of 64 or > d_inner; ``fused_bwd_route``) takes "remat" whatever
the field says, so every width that fuses trains. K5 and K6 take every
registry width (d_model up to 1280, d_inner up to 2560). K8-K10
differentiate through their plain versions, and the unfused path's scans
through K2.

Parameters have the torch reference's names and layouts; they stay
float32 and are cast to the module ``dtype`` where they are used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from fastvim_tpu_torch.models.layers import (
    a_log_init_,
    dt_bias_init_,
    dt_proj_weight_init_,
    torch_linear_init_,
)
from fastvim_tpu_torch.ops.conv import (
    causal_conv1d_update,
    dual_conv1d,
    grid_dual_conv1d,
)
from fastvim_tpu_torch.ops.kernels import fused_block, merge_gate
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    default_bwd_mode,
    default_fwd_mode,
    fusable,
    fused_mixer_core,
    proj_scan,
)
from fastvim_tpu_torch.ops.norms import layer_norm
from fastvim_tpu_torch.ops.scan import broadcast_grid, pool_grid
from fastvim_tpu_torch.ops.state_update import selective_state_update
from fastvim_tpu_torch.parallel import tokens


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class MambaMixer(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Union[int, str] = "auto",
                 dt_min: float = 1e-3, dt_max: float = 0.1,
                 dt_init: str = "random", dt_scale: float = 1.0,
                 dt_init_floor: float = 1e-4, conv_bias: bool = True,
                 bias: bool = False, use_norm_after_ssm: bool = True,
                 collapse_method: str = "mean", scaling_factor: float = 1.0,
                 n_layer: int = 24, norm_eps: float = 1e-5,
                 scan_impl: str = "auto", layer_fused: str = "auto",
                 layer_fused_bwd: str = "auto",
                 fused_kernels: str = "never", fused_merge: bool = False,
                 init_layer_scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layer_fused not in ("auto", "on", "off", "recompute"):
            raise ValueError(f"layer_fused must be auto|on|off|recompute, "
                             f"got {layer_fused!r}")
        if fused_kernels not in ("never", "auto", "always", "merge"):
            raise ValueError(f"fused_kernels must be never|auto|always|merge,"
                             f" got {fused_kernels!r}")
        if layer_fused_bwd not in ("auto", "fused", "remat"):
            raise ValueError(f"layer_fused_bwd must be auto|fused|remat, got "
                             f"{layer_fused_bwd!r}")
        if collapse_method not in ("mean", "max", "none"):
            raise ValueError(f"unknown collapse method {collapse_method!r}")
        self.d_model = d_model
        self.d_state = d_state
        self.d_conv = d_conv
        self.d_inner = int(expand * d_model)
        self.dt_rank = (-(-d_model // 16) if dt_rank == "auto"
                        else int(dt_rank))
        self.dt_min, self.dt_max = dt_min, dt_max
        self.dt_init, self.dt_scale = dt_init, dt_scale
        self.dt_init_floor = dt_init_floor
        self.use_norm_after_ssm = use_norm_after_ssm
        self.collapse_method = collapse_method
        self.scaling_factor = scaling_factor
        self.n_layer = n_layer
        self.norm_eps = norm_eps
        self.scan_impl = scan_impl
        self.layer_fused = layer_fused
        self.layer_fused_bwd = layer_fused_bwd
        self.fused_kernels = fused_kernels
        self.fused_merge = fused_merge
        self.dtype = dtype

        di, n, r = self.d_inner, d_state, self.dt_rank
        self.in_proj = skip_init(nn.Linear, d_model, 2 * di, bias=bias)
        for sfx in ("", "_b"):
            setattr(self, f"conv1d{sfx}",
                    skip_init(nn.Conv1d, di, di, d_conv, groups=di,
                              bias=conv_bias))
            setattr(self, f"x_proj{sfx}",
                    skip_init(nn.Linear, di, r + 2 * n, bias=False))
            setattr(self, f"dt_proj{sfx}",
                    skip_init(nn.Linear, r, di, bias=True))
            setattr(self, f"A{sfx}_log", nn.Parameter(torch.empty(di, n)))
            setattr(self, f"D{sfx}", nn.Parameter(torch.ones(di)))
        self.layernorm = (skip_init(nn.LayerNorm, di)
                          if use_norm_after_ssm else None)
        self.out_proj = skip_init(nn.Linear, di, d_model, bias=bias)
        # layer scale on the output (the JAX package's ``gamma``)
        self.init_layer_scale = init_layer_scale
        self.gamma = (nn.Parameter(torch.empty(d_model))
                      if init_layer_scale is not None else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference init (see ``models/layers.py``), drawn from
        ``generator``."""
        di = self.d_inner
        torch_linear_init_(self.in_proj.weight, self.d_model, generator)
        if self.in_proj.bias is not None:
            nn.init.zeros_(self.in_proj.bias)
        for sfx in ("", "_b"):
            conv = getattr(self, f"conv1d{sfx}")
            torch_linear_init_(conv.weight, self.d_conv, generator)
            if conv.bias is not None:
                torch_linear_init_(conv.bias, self.d_conv, generator)
            torch_linear_init_(getattr(self, f"x_proj{sfx}").weight, di,
                               generator)
            dt_proj = getattr(self, f"dt_proj{sfx}")
            dt_proj_weight_init_(dt_proj.weight, self.dt_rank, generator,
                                 self.dt_scale, self.dt_init)
            dt_bias_init_(dt_proj.bias, generator, self.dt_min, self.dt_max,
                          self.dt_init_floor)
            a_log_init_(getattr(self, f"A{sfx}_log"))
            nn.init.ones_(getattr(self, f"D{sfx}"))
        if self.layernorm is not None:
            nn.init.ones_(self.layernorm.weight)
            nn.init.zeros_(self.layernorm.bias)
        torch_linear_init_(self.out_proj.weight, di, generator,
                           scale=1.0 / math.sqrt(self.n_layer))
        if self.out_proj.bias is not None:
            nn.init.zeros_(self.out_proj.bias)
        if self.gamma is not None:
            nn.init.constant_(self.gamma, self.init_layer_scale)

    def _conv_w(self, sfx: str) -> torch.Tensor:
        """conv1d{sfx}.weight (di, 1, w) as the ops' (w, di)."""
        return getattr(self, f"conv1d{sfx}").weight.squeeze(1).t()

    def fused_params(self) -> FusedParams:
        di = self.d_inner
        ln = self.layernorm
        return FusedParams(
            self.in_proj.weight, self.in_proj.bias,
            self.conv1d.weight.reshape(di, -1), self.conv1d.bias,
            self.conv1d_b.weight.reshape(di, -1), self.conv1d_b.bias,
            self.x_proj.weight, self.dt_proj.weight, self.dt_proj.bias,
            self.A_log, self.D,
            self.x_proj_b.weight, self.dt_proj_b.weight, self.dt_proj_b.bias,
            self.A_b_log, self.D_b,
            None if ln is None else ln.weight, None if ln is None else ln.bias,
            self.out_proj.weight, self.out_proj.bias)

    def _proj_scan(self, xp: torch.Tensor, sfx: str,
                   reverse: bool) -> torch.Tensor:
        """Projections and scan of one direction's (pooled) sequence."""
        dt_proj = getattr(self, f"dt_proj{sfx}")
        return proj_scan(xp, getattr(self, f"x_proj{sfx}").weight,
                         dt_proj.weight, dt_proj.bias,
                         getattr(self, f"A{sfx}_log"), self.dtype,
                         self.scan_impl, reverse)

    def _pool(self, xc, grid_shape, pool_axes):
        return pool_grid(xc, grid_shape, pool_axes, self.collapse_method,
                         self.scaling_factor)

    def _scan_branch(self, xc: torch.Tensor, sfx: str,
                     grid_shape: Sequence[int], pool_axes: Sequence[int],
                     reverse: bool) -> torch.Tensor:
        """One direction: (pool) → projections → scan → (broadcast) →
        + D·conv_out. xc: (batch, L, d_inner) conv output."""
        dtype = self.dtype
        pooled = self.collapse_method != "none"
        xp = self._pool(xc, grid_shape, pool_axes) if pooled else xc
        y = self._proj_scan(xp, sfx, reverse)
        if pooled:
            y = broadcast_grid(y, grid_shape, pool_axes)
        return y.to(dtype) + getattr(self, f"D{sfx}").to(dtype) * xc

    def _use_fused(self, grid_shape, pool_axes) -> bool:
        """The fused block kernels (K8, K9) take this layer: pooled over
        the last axis of a 2-D grid."""
        return (self.fused_kernels != "never"
                and self.collapse_method in ("mean", "max")
                and len(grid_shape) == 2 and tuple(pool_axes) == (1,)
                and fused_block.fusable(*grid_shape, self.d_inner))

    def _fused_forward(self, xin, z, grid_shape) -> torch.Tensor:
        """conv + pool (K8; plain ops in "merge" mode) → pooled scans →
        conv again + broadcast + D-skip + merge + LN + gate (K9)."""
        rows, cols = grid_shape
        conv = (self.conv1d.weight.reshape(self.d_inner, -1),
                self.conv1d.bias,
                self.conv1d_b.weight.reshape(self.d_inner, -1),
                self.conv1d_b.bias)
        pool_args = (xin, *conv, rows, cols, self.collapse_method,
                     self.scaling_factor)
        if self.fused_kernels == "merge":
            pf, pb = fused_block.conv_pool_plain(*pool_args)
        else:
            pf, pb = fused_block.ConvPoolFn.apply(*pool_args)
        yf = self._proj_scan(pf, "", False).float()
        yb = self._proj_scan(pb, "_b", True).float()
        ln = self.layernorm
        return fused_block.MergeGateFn.apply(
            xin, z, yf, yb, *conv, self.D, self.D_b,
            None if ln is None else ln.weight, None if ln is None else ln.bias,
            rows, cols, self.norm_eps, ln is not None)

    def init_cache(self, batch: int,
                   device: Optional[torch.device] = None) -> dict:
        """A zero cache for :meth:`forward`'s decode step: the rolling conv
        window ``conv`` (batch, d_conv, d_inner) in the module's dtype,
        oldest token first, and the SSM state ``ssm`` (batch, d_inner,
        d_state) fp32, of the causal (forward) branch. The JAX package's
        layout; on the module's device unless ``device`` is given."""
        device = device if device is not None else self.A_log.device
        return {"conv": torch.zeros(batch, self.d_conv, self.d_inner,
                                    dtype=self.dtype, device=device),
                "ssm": torch.zeros(batch, self.d_inner, self.d_state,
                                   device=device)}

    def forward(self, x: torch.Tensor,
                grid_shape: Optional[Sequence[int]] = None,
                pool_axes: Optional[Sequence[int]] = None,
                transposed: bool = False,
                row_ids: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None, shard=None):
        """x: (batch, L, d_model); grid_shape: the token grid in this
        mixer's orientation; pool_axes: grid axes pooled before the scan
        (default: the last). ``row_ids`` (batch, L) int64: x holds only
        visible tokens, and these are their grid rows (the masked path;
        ``grid_shape`` is then the full (rows, cols) grid).

        With ``cache`` (from :meth:`init_cache`) x is one token (batch, 1,
        d_model) and the call returns ``(out, new_cache)``: one step of
        the causal branch (conv window, projections, state update, D skip,
        the LayerNorm with ``use_norm_after_ssm``, the silu(z) gate), as
        the JAX mixer's decode step computes it; the anticausal branch has
        no decode step. The cache passed in is not modified.

        With ``shard`` (``parallel.TokenShard``) x holds this rank's rows
        of ``grid_shape``, the whole 2-D grid, pooled over its columns or,
        ``transposed``, its rows."""
        if cache is not None:
            out, new_cache = self._decode_step(x.to(self.dtype), cache)
            if self.gamma is not None:
                out = out * self.gamma.to(self.dtype)
            return out, new_cache
        if grid_shape is None:
            raise ValueError("grid_shape is required without a cache")
        grid_shape = tuple(grid_shape)
        pool_axes = (tuple(pool_axes) if pool_axes is not None
                     else (len(grid_shape) - 1,))
        dtype = self.dtype
        x = x.to(dtype)
        recompute = self.layer_fused == "recompute"
        if shard is None and row_ids is None and self.layer_fused != "off" \
                and fusable(
                grid_shape, pool_axes, transposed, self.d_model, self.d_inner,
                self.d_conv, self.collapse_method, recompute=recompute) \
                and (recompute or default_fwd_mode(
                    self.d_model, dtype, grid_shape[0 if transposed else 1],
                    self._needs_grad(x)) == "fused"):
            bwd = self.layer_fused_bwd
            if bwd == "auto":
                bwd = default_bwd_mode(self.d_model, dtype,
                                       grid_shape[0 if transposed else 1])
            out = fused_mixer_core(
                x, self.fused_params(), grid_shape, transposed,
                self.scaling_factor, self.norm_eps, self.use_norm_after_ssm,
                dtype, self.scan_impl, bwd_mode=bwd, recompute=recompute)
        else:
            out = self._unfused(x, grid_shape, pool_axes, transposed, row_ids,
                                shard)
        if self.gamma is not None:
            out = out * self.gamma.to(dtype)
        return out

    def _needs_grad(self, x: torch.Tensor) -> bool:
        """Whether this call will be differentiated: grad mode on and the
        input or a parameter requiring grad."""
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def _decode_step(self, x, cache):
        """One causal decode step of (batch, 1, d_model) x; see
        :meth:`forward`."""
        dtype = self.dtype
        di, r, n = self.d_inner, self.dt_rank, self.d_state
        xz = F.linear(x[:, 0], self.in_proj.weight.to(dtype),
                      _cast(self.in_proj.bias, dtype))
        xc, conv = causal_conv1d_update(
            xz[:, :di], cache["conv"], self._conv_w("").to(dtype),
            _cast(self.conv1d.bias, dtype))
        dbl = F.linear(xc.to(dtype), self.x_proj.weight.to(dtype))
        dt = F.linear(dbl[:, :r], self.dt_proj.weight.to(dtype))
        y, ssm = selective_state_update(
            cache["ssm"], xc, dt, -torch.exp(self.A_log.float()),
            dbl[:, r:r + n], dbl[:, r + n:], D=self.D,
            dt_bias=self.dt_proj.bias, dt_softplus=True)
        y = self._ln_gate(y, xz[:, di:]).to(dtype)
        out = F.linear(y[:, None], self.out_proj.weight.to(dtype),
                       _cast(self.out_proj.bias, dtype))
        return out, {"conv": conv, "ssm": ssm}

    def _unfused(self, x, grid_shape, pool_axes, transposed, row_ids,
                 shard=None):
        dtype = self.dtype
        di = self.d_inner
        xz = F.linear(x, self.in_proj.weight.to(dtype),
                      _cast(self.in_proj.bias, dtype))
        xin, z = xz[..., :di], xz[..., di:]
        if row_ids is not None:
            merged = self._masked_merge(xin, z, grid_shape, row_ids)
        elif shard is not None:
            merged = self._shard_merge(xin, z, shard, transposed)
        elif self._use_fused(grid_shape, pool_axes):
            merged = self._fused_forward(xin, z, grid_shape)
        else:
            merged = self._conv_merge(xin, z, grid_shape, pool_axes,
                                      transposed)
        return F.linear(merged, self.out_proj.weight.to(dtype),
                        _cast(self.out_proj.bias, dtype))

    def _conv_args(self, xin):
        """(xin, conv weights and biases of both directions) for the dual
        conv ops, in the working dtype."""
        dtype = self.dtype
        return (xin, self._conv_w("").to(dtype),
                _cast(self.conv1d.bias, dtype),
                self._conv_w("_b").to(dtype),
                _cast(self.conv1d_b.bias, dtype))

    def _ln_gate(self, merged, z):
        ln = self.layernorm
        if ln is not None:
            merged = layer_norm(merged, ln.weight, ln.bias, eps=self.norm_eps)
        return merged * F.silu(z)

    def _masked_merge(self, xin, z, grid_shape, row_ids):
        """The masked path (see the module docstring): plain dual conv over
        the visible tokens, each branch through its row bins, merge, LN
        and gate."""
        if self.collapse_method != "mean" or len(grid_shape) != 2:
            raise ValueError("the masked path pools a 2-D grid by mean only")
        dtype = self.dtype
        rows, cols = grid_shape
        xc_f, xc_b = dual_conv1d(*self._conv_args(xin))
        ys = []
        for xc, sfx, ids in ((xc_f, "", row_ids),
                             (xc_b, "_b", row_ids.flip(1))):
            onehot = F.one_hot(ids.long(), rows).to(dtype)  # (b, L, rows)
            xp = torch.bmm(onehot.transpose(1, 2), xc) / cols
            y = torch.bmm(onehot, self._proj_scan(xp, sfx, False).to(dtype))
            ys.append(y + getattr(self, f"D{sfx}").to(dtype) * xc)
        return self._ln_gate((ys[0] + ys[1]) * 0.5, z)

    def _shard_merge(self, xin, z, shard, transposed):
        """This rank's rows of a sharded grid (see the module docstring):
        the halo dual conv, each branch's pooled sequence made whole and
        scanned on every rank, this rank's rows broadcast back, merge, LN
        and gate."""
        dtype = self.dtype
        ys = []
        for xc, sfx, reverse in zip(
                tokens.halo_dual_conv(*self._conv_args(xin), shard,
                                      transposed), ("", "_b"), (False, True)):
            xp = tokens.pool_whole(xc, shard, transposed,
                                   self.collapse_method, self.scaling_factor)
            y = tokens.local_rows(self._proj_scan(xp, sfx, reverse), shard,
                                  transposed)
            ys.append(y.to(dtype) + getattr(self, f"D{sfx}").to(dtype) * xc)
        return self._ln_gate((ys[0] + ys[1]) * 0.5, z)

    def _conv_merge(self, xin, z, grid_shape, pool_axes, transposed):
        """Plain dual conv, then the scans and the merge: through K10
        with ``fused_merge``, else in plain ops."""
        dtype = self.dtype
        conv_args = self._conv_args(xin)
        if transposed:
            xc_f, xc_b = grid_dual_conv1d(*conv_args, grid_shape, axis=0)
        else:
            xc_f, xc_b = dual_conv1d(*conv_args)
        ln = self.layernorm
        if (self.fused_merge and self.collapse_method != "none"
                and merge_gate.fusable(grid_shape, pool_axes, self.d_inner)):
            yf = self._proj_scan(self._pool(xc_f, grid_shape, pool_axes), "",
                                 False)
            yb = self._proj_scan(self._pool(xc_b, grid_shape, pool_axes),
                                 "_b", True)
            return merge_gate.MergeLnGateFn.apply(
                xc_f.contiguous(), xc_b.contiguous(), z, yf.to(dtype),
                yb.to(dtype), self.D, self.D_b,
                None if ln is None else ln.weight,
                None if ln is None else ln.bias, grid_shape, pool_axes,
                self.norm_eps, ln is not None)
        y_f = self._scan_branch(xc_f, "", grid_shape, pool_axes, False)
        y_b = self._scan_branch(xc_b, "_b", grid_shape, pool_axes, True)
        return self._ln_gate((y_f + y_b) * 0.5, z)
