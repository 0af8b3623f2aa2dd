"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

=====  ===========================  ======================================
 id    wrapper                      replaces (fastvim_tpu/ops/pallas/)
=====  ===========================  ======================================
 K1    selective_scan.selective_    selective_scan.py ``_scan_kernel``
       scan_fwd
 K2    selective_scan.selective_    selective_scan.py ``_bwd_kernel``
       scan_bwd
 K3    layer_fused.pass_a           layer_fused.py ``_pass_a_even_kernel``
                                    / ``_pass_a_odd_kernel`` (with
                                    ``write_xc=False``: their pools-only
                                    form)
 K4    layer_fused.pass_b           layer_fused.py ``_pass_b_mat_kernel``
 K5    layer_fused.pass_b_bwd       layer_fused.py ``_pass_b_bwd_kernel``
 K6    layer_fused.pass_a_bwd       layer_fused.py
                                    ``_pass_a_bwd_even_kernel`` /
                                    ``_pass_a_bwd_odd_kernel``
 K7    layer_fused.pass_b_          layer_fused.py ``_pass_b_even_kernel``
       recompute                    / ``_pass_b_odd_kernel``
 K8    fused_block.conv_pool        fused_block.py ``_conv_pool_kernel``
 K9    fused_block.merge_gate       fused_block.py ``_merge_kernel``
 K10   merge_gate.merge_ln_gate     merge_gate.py ``_kernel``
 lanes selective_scan.selective_    selective_scan.py
       scan_fwd_lanes               ``_scan_kernel_lanes``
=====  ===========================  ======================================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built on first use by ``_build``) or raises. Each
launch adds one to its entry in ``LAUNCHES``. The launchers refuse
tensors that require grad; the ``torch.autograd.Function``s around them
call them with grad mode off. K1-K6 have backward kernels
(``SelectiveScanFn``, ``FusedMixerCoreFn``); K7-K10 and lanes are forward
kernels whose gradient recomputes through other code, as in the JAX
package: K7 through the unfused math (``FusedMixerCoreRematFn``), K8-K10
through their plain versions (``ConvPoolFn``, ``MergeGateFn``,
``MergeLnGateFn``), lanes through K1 and K2 (``SelectiveScanLanesFn``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("selective_scan_fwd", "selective_scan_bwd", "pass_a_fwd", "pass_b_fwd",
     "pass_b_bwd", "pass_a_bwd", "pass_b_recompute_fwd", "conv_pool_fwd",
     "merge_gate_fwd", "merge_ln_gate_fwd", "selective_scan_fwd_lanes"), 0)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_cuda_args(name: str, device: torch.device,
                    token_strided: Sequence[str] = (), **tensors) -> None:
    """Raise unless ``device`` is a CUDA device and every given tensor
    (None skipped) lies on it, is contiguous, and needs no gradient
    while grad mode is on: a raw launch records nothing for autograd.
    A tensor named in ``token_strided`` may instead be a column slice of a
    wider (batch, L, ·) array: see :func:`token_stride`."""
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    grad = torch.is_grad_enabled()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if arg in token_strided:
            token_stride(name, arg, t)
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if grad and t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad, but a raw kernel launch "
                "records no graph; call ops.scan.selective_scan or "
                "fused_mixer_core, or run under torch.no_grad()")


def token_stride(name: str, arg: str, t: torch.Tensor) -> int:
    """Elements between consecutive tokens of ``t`` (batch, L, d): d for
    a contiguous tensor, more for a column slice of a wider array (the x
    or z half of the in-projection's output). Raises unless channels are
    adjacent, tokens and images evenly spaced, and every channel pair
    starts on a 2-element boundary (the kernels load pairs)."""
    batch, L, d = t.shape
    # one token an image: the images' stride is the tokens'
    ld = t.stride(1) if L > 1 else t.stride(0) if batch > 1 else d
    if (t.stride(2) != 1 or ld < d or (batch > 1 and t.stride(0) != L * ld)
            or ld % 2 or t.data_ptr() % (2 * t.element_size())):
        raise ValueError(f"{name}: {arg} must be contiguous or a column "
                         "slice of a contiguous (batch, L, ·) tensor, with "
                         f"even offsets; got strides {t.stride()}")
    return ld


def check_aligned(name: str, **tensors) -> None:
    """Raise unless each given tensor (None skipped) starts on a 32-byte
    boundary: the kernels read 16-byte vectors and 32-byte aligned
    tensor-core tiles."""
    for arg, t in tensors.items():
        if t is not None and t.data_ptr() % 32:
            raise ValueError(f"{name}: {arg} must start on a 32-byte "
                             "boundary (pass a fresh or .clone()d tensor)")


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def plain_vjp(plain: Callable, tensors: Sequence[Optional[torch.Tensor]],
              static: tuple, cotangents, needs: Sequence[bool]) -> tuple:
    """Gradients of ``plain(*tensors, *static)`` against ``cotangents``
    (one per output), by autograd through the plain version on detached
    copies: the backward of the forward-only kernels, which the JAX
    package takes through its references in the same way. Returns one
    entry per tensor, None where it is absent or ``needs`` none."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(need))
              for t, need in zip(tensors, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = plain(*leaves, *static)
    grads = iter(torch.autograd.grad(out, wanted, cotangents,
                                     allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)
