"""Image resampling as ``jax.image.scale_and_translate`` computes it.

``torch.nn.functional.interpolate`` is not the same function: its bicubic
kernel takes a = -0.75 where JAX's Keys kernel takes -0.5, and it
antialiases only on request. Here each spatial axis gets an explicit
(out, in) weight matrix built the way ``jax.image``'s
``compute_weight_mat`` builds it: the kernel evaluated at half-pixel
sample positions, widened by the inverse scale when shrinking with
antialiasing, renormalised over the taps that fall inside the input, and
zero where the sample lies outside it. The image is then contracted with
one matrix per axis, so the result is differentiable in the image.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, scale: Scalar,
                  translation: Scalar, method: str, antialias: bool,
                  device=None) -> torch.Tensor:
    """(..., out_size, in_size) float32 weights: output pixel o samples
    the input at (o + 0.5 - translation) / scale - 0.5. ``scale`` and
    ``translation`` are numbers or tensors of one batch shape (...)."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.as_tensor(scale, **f32)
    translation = torch.as_tensor(translation, **f32)
    inv_scale = 1.0 / scale
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones_like(inv_scale))
    sample_f = ((torch.arange(out_size, **f32) + 0.5) * inv_scale[..., None]
                - (translation * inv_scale)[..., None] - 0.5)
    x = ((sample_f[..., :, None] - torch.arange(in_size, **f32)).abs()
         / kernel_scale[..., None, None])
    w = KERNELS[method](x)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def scale_and_translate(images: torch.Tensor, out_hw: Tuple[int, int],
                        scale: torch.Tensor, translation: torch.Tensor,
                        method: str = "linear",
                        antialias: bool = True) -> torch.Tensor:
    """(batch, H, W, C) → (batch, out_h, out_w, C), float32, each image
    with its own ``scale`` and ``translation`` (batch, 2), ordered (y, x)."""
    _, H, W, _ = images.shape
    dev = images.device
    wy = weight_matrix(H, out_hw[0], scale[:, 0], translation[:, 0], method,
                       antialias, dev)
    wx = weight_matrix(W, out_hw[1], scale[:, 1], translation[:, 1], method,
                       antialias, dev)
    out = torch.einsum("bph,bhwc->bpwc", wy, images.float())
    return torch.einsum("bqw,bpwc->bpqc", wx, out)


def resize(images: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "linear", antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of (batch, H, W, C) images to ``out_hw``,
    float32: an axis whose size does not change is left as it is."""
    out = images.float()
    for axis, n in ((1, out_hw[0]), (2, out_hw[1])):
        m = out.shape[axis]
        if n == m:
            continue
        w = weight_matrix(m, n, n / m, 0.0, method, antialias, out.device)
        out = torch.movedim(torch.tensordot(w, out, dims=([1], [axis])),
                            0, axis)
    return out
