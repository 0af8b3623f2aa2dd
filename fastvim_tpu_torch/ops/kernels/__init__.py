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
                                    / ``_pass_a_odd_kernel``
 K4    layer_fused.pass_b           layer_fused.py ``_pass_b_mat_kernel``
 K5    layer_fused.pass_b_bwd       layer_fused.py ``_pass_b_bwd_kernel``
 K6    layer_fused.pass_a_bwd       layer_fused.py
                                    ``_pass_a_bwd_even_kernel`` /
                                    ``_pass_a_bwd_odd_kernel``
=====  ===========================  ======================================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built on first use by ``_build``) or raises. Each
launch adds one to its entry in ``LAUNCHES``. The launchers refuse
tensors that require grad; the ``torch.autograd.Function``s around them
(``SelectiveScanFn``, ``FusedMixerCoreFn``) call them with grad mode off.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("selective_scan_fwd", "selective_scan_bwd", "pass_a_fwd", "pass_b_fwd",
     "pass_b_bwd", "pass_a_bwd"), 0)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_cuda_args(name: str, device: torch.device, **tensors) -> None:
    """Raise unless ``device`` is a CUDA device and every given tensor
    (None skipped) lies on it, is contiguous, and needs no gradient
    while grad mode is on: a raw launch records nothing for autograd."""
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    grad = torch.is_grad_enabled()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if grad and t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad, but a raw kernel launch "
                "records no graph; call ops.scan.selective_scan or "
                "fused_mixer_core, or run under torch.no_grad()")


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
