"""UperNet semantic-segmentation head (+ FCN aux head) over the trunk's
feature maps, NHWC at the module boundaries.

Counterpart of ``fastvim_tpu/models/upernet.py`` (the mmsegmentation
recipe: UPerHead over the backbone's 4 maps with pool scales (1, 2, 3, 6)
and 512 channels, plus an FCN aux head with 256 channels on the third
map). The convs run on NCHW views of NHWC tensors (channels-last memory,
which cuDNN takes as it is). The functions are the JAX package's:

* ``norm="ln"`` is flax's ``LayerNorm`` (eps 1e-6, variance E[x²]−E[x]²);
  ``norm="bn"`` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``
  written out: the batch's biased variance normalizes in training and
  moves the running variance (``BatchNorm2d`` would take the unbiased
  one there);
* the pyramid pooling is an average pool of window = stride =
  max(H // min(s, H), 1), which drops the remainder rows, not an
  adaptive pool;
* every resize is a bilinear upsampling (``align_corners=False``), which
  ``jax.image.resize`` computes too;
* the dropout is element-wise and draws from the generator
  ``set_drop_path_generator`` hands it (``layers.Dropout``).

``model.train()`` / ``model.eval()`` take the place of ``deterministic``:
they switch the dropouts and the BatchNorm statistics.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastvim_tpu_torch.models.layers import Dropout, lecun_normal_init_
from fastvim_tpu_torch.models.vision_mamba import VisionMamba
from fastvim_tpu_torch.ops.norms import layer_norm
from fastvim_tpu_torch.parallel import batch_moments, denominator


def resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (batch, H, W, C) maps to ``hw`` (an upsampling
    here, where it equals ``jax.image.resize``)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def conv_nhwc(conv: nn.Module, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv`` (a ``Conv2d`` or ``ConvTranspose2d``) applied to (batch,
    H, W, C) maps. With ``dtype`` it computes as flax's ``dtype=`` does:
    the input, the weight and the bias cast to it, the output in it (the
    parameters stay as they are)."""
    x = x.permute(0, 3, 1, 2)
    if dtype is None:
        return conv(x).permute(0, 2, 3, 1)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, conv.stride, conv.padding,
                               conv.output_padding, conv.groups,
                               conv.dilation)
    else:
        y = conv._conv_forward(x, w, b)
    return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, fp32
    statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    axis of NHWC maps. In training it normalizes with the batch's mean and
    biased variance (E[x²]−E[x]², fp32) and moves the running statistics
    by 0.1 of the way to them; in eval it takes the running ones. Over
    several ranks the batch is the global one: the sums of x and x² are
    summed over ranks (``parallel.batch_moments``), as flax reduces over
    the whole sharded batch under ``jit``."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean, mean_sq = batch_moments(x32, tuple(range(x.dim() - 1)))
            var = (mean_sq - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def _reset_conv(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax ``nn.Conv``'s init: lecun-normal kernel, zero bias."""
    fan_in = conv.in_channels * math.prod(conv.kernel_size)
    lecun_normal_init_(conv.weight, fan_in, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class ConvModule(nn.Module):
    """conv (no bias, "SAME" padding) → LayerNorm or BatchNorm → ReLU.
    The norm is the child ``ln`` or ``bn`` (mmcv's names), so that a
    state_dict names its kind."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 norm: str = "ln"):
        super().__init__()
        if norm not in ("ln", "bn"):
            raise ValueError(f"norm must be ln|bn, got {norm!r}")
        self.conv = nn.Conv2d(in_channels, features, kernel,
                              padding=kernel // 2, bias=False)
        self.norm_name = norm
        self.add_module(norm, LayerNorm(features) if norm == "ln"
                        else BatchNorm(features))

    @property
    def norm(self) -> nn.Module:
        return getattr(self, self.norm_name)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_conv(self.conv, generator)
        self.norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(conv_nhwc(self.conv, x)))


class PSPModule(nn.Module):
    """Pyramid pooling: for each scale s an average pool of window =
    stride = max(H // min(s, H), 1) (clamped for small maps), a 1 × 1
    ConvModule and a bilinear upsampling back; concatenated after the
    input."""

    def __init__(self, in_channels: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 channels: int = 512, norm: str = "ln"):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.stages = nn.ModuleList(
            ConvModule(in_channels, channels, kernel=1, norm=norm)
            for _ in self.pool_scales)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for stage in self.stages:
            stage.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        outs = [x]
        for s, stage in zip(self.pool_scales, self.stages):
            ph, pw = max(H // min(s, H), 1), max(W // min(s, W), 1)
            pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), (ph, pw),
                                  stride=(ph, pw)).permute(0, 2, 3, 1)
            outs.append(resize(stage(pooled), (H, W)))
        return torch.cat(outs, dim=-1)


class UPerHead(nn.Module):
    """PSP on the deepest map, lateral 1 × 1 ConvModules and top-down
    fusion, 3 × 3 ConvModules, concatenation at the first map's
    resolution, a 3 × 3 fusion ConvModule, dropout and a 1 × 1 classifier.
    ``in_channels``: the channels of each input map."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 150,
                 channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, norm: str = "ln"):
        super().__init__()
        in_channels = tuple(in_channels)
        n = len(in_channels)
        self.psp = PSPModule(in_channels[-1], pool_scales, channels, norm)
        self.bottleneck = ConvModule(
            in_channels[-1] + len(pool_scales) * channels, channels,
            norm=norm)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, kernel=1, norm=norm)
            for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, norm=norm) for _ in range(n - 1))
        self.fpn_bottleneck = ConvModule(n * channels, channels, norm=norm)
        self.dropout = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """In the JAX package's order of creation: PSP, bottleneck,
        laterals, FPN convs, fusion, classifier."""
        self.psp.reset_parameters(generator)
        for m in (self.bottleneck, *self.lateral_convs, *self.fpn_convs,
                  self.fpn_bottleneck):
            m.reset_parameters(generator)
        _reset_conv(self.conv_seg, generator)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """feats: NHWC maps. Returns per-pixel logits at the first map's
        resolution."""
        psp = self.bottleneck(self.psp(feats[-1]))
        laterals = [conv(f) for conv, f in zip(self.lateral_convs,
                                               feats[:-1])] + [psp]
        for i in range(len(laterals) - 1, 0, -1):
            hw = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize(laterals[i], hw)
        outs = [conv(l) for conv, l in zip(self.fpn_convs,
                                           laterals[:-1])] + [laterals[-1]]
        hw = outs[0].shape[1:3]
        fused = self.fpn_bottleneck(torch.cat([resize(o, hw) for o in outs],
                                              dim=-1))
        return conv_nhwc(self.conv_seg, self.dropout(fused))


class FCNHead(nn.Module):
    """Auxiliary FCN head: one 3 × 3 ConvModule, dropout, a 1 × 1
    classifier."""

    def __init__(self, in_channels: int, num_classes: int = 150,
                 channels: int = 256, dropout: float = 0.1,
                 norm: str = "ln"):
        super().__init__()
        self.convs = nn.Sequential(ConvModule(in_channels, channels,
                                              norm=norm))
        self.dropout = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.convs[0].reset_parameters(generator)
        _reset_conv(self.conv_seg, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv_seg, self.dropout(self.convs(x)))


class UperNetSegmentor(nn.Module):
    """Backbone (a ``VisionMamba`` with ``out_indices``) + UPerHead + the
    FCN aux head on map ``aux_index``, the logits upsampled to the input's
    resolution."""

    def __init__(self, backbone: nn.Module, num_classes: int = 150,
                 aux_index: int = 2, norm: str = "ln"):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.aux_index = aux_index
        dim = backbone.embed_dim
        self.decode_head = UPerHead((dim,) * len(backbone.out_indices),
                                    num_classes, norm=norm)
        self.aux_head = FCNHead(dim, num_classes, norm=norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``: the backbone's,
        then the heads' (flax's initializers)."""
        self.backbone.reset_parameters(generator)
        self.decode_head.reset_parameters(generator)
        self.aux_head.reset_parameters(generator)

    # every DropPath and dropout, the heads' included
    set_drop_path_generator = VisionMamba.set_drop_path_generator

    def forward(self, images: torch.Tensor, with_aux: bool = False):
        """images: (batch, H, W, 3). Returns logits (batch, H, W,
        num_classes), and with ``with_aux`` also the aux head's."""
        feats = self.backbone(images)
        H, W = images.shape[1:3]
        logits = resize(self.decode_head(feats), (H, W))
        if with_aux:
            return logits, resize(self.aux_head(feats[self.aux_index]),
                                  (H, W))
        return logits


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      aux_logits: Optional[torch.Tensor] = None,
                      aux_weight: float = 0.4,
                      ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel cross entropy in fp32 over the pixels whose label is not
    ``ignore_index``, divided by max(their count, 1), so an all-ignore
    batch gives 0; plus ``aux_weight`` times the aux head's. Over several
    ranks the count is the global batch's (``parallel.denominator``), so
    that the ranks' losses averaged are the global loss."""
    valid = labels != ignore_index
    count = denominator(valid.sum())

    def ce(lg: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(lg.float(), dim=-1)
        lbl = torch.where(valid, labels, 0).long()
        nll = -logp.gather(-1, lbl[..., None])[..., 0]
        return (nll * valid).sum() / count

    loss = ce(logits)
    if aux_logits is not None:
        loss = loss + aux_weight * ce(aux_logits)
    return loss


def slide_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    images: torch.Tensor, crop: int = 512, stride: int = 341,
                    num_classes: int = 150) -> torch.Tensor:
    """Sliding-window inference: ``apply_fn`` on crop × crop windows
    every ``stride`` pixels (and one flush with the far edge), the
    overlapping windows' fp32 logits averaged. Returns (batch, H, W,
    num_classes)."""
    B, H, W, _ = images.shape
    logits_sum = torch.zeros(B, H, W, num_classes, dtype=torch.float32,
                             device=images.device)
    counts = torch.zeros(1, H, W, 1, dtype=torch.float32,
                         device=images.device)
    ys = _window_starts(H, crop, stride)
    xs = _window_starts(W, crop, stride)
    ch, cw = min(crop, H), min(crop, W)
    for y in ys:
        for x in xs:
            lg = apply_fn(images[:, y:y + ch, x:x + cw]).float()
            logits_sum[:, y:y + ch, x:x + cw] += lg
            counts[:, y:y + ch, x:x + cw] += 1.0
    return logits_sum / counts.clamp_min(1.0)


def _window_starts(size: int, crop: int, stride: int) -> List[int]:
    starts = list(range(0, max(size - crop, 0) + 1, stride)) or [0]
    if starts[-1] + crop < size:
        starts.append(size - crop)
    return starts
