from fastvim_tpu_torch.ops.boxes import (
    box_iou,
    delta_decode,
    delta_encode,
    fast_nms,
    generate_anchors,
    max_iou_assign,
    multilevel_roi_align,
    nms,
    nms_scan,
    random_sample,
    roi_align,
    sample_from_draws,
)
from fastvim_tpu_torch.ops.conv import (
    anticausal_conv1d,
    causal_conv1d,
    dual_conv1d,
    grid_dual_conv1d,
)
from fastvim_tpu_torch.ops.norms import add_norm, layer_norm, rms_norm
from fastvim_tpu_torch.ops.scan import (
    broadcast_grid,
    pool_grid,
    selective_scan,
    selective_scan_ref,
)

__all__ = [
    "add_norm",
    "anticausal_conv1d",
    "box_iou",
    "broadcast_grid",
    "causal_conv1d",
    "delta_decode",
    "delta_encode",
    "dual_conv1d",
    "fast_nms",
    "generate_anchors",
    "grid_dual_conv1d",
    "layer_norm",
    "max_iou_assign",
    "multilevel_roi_align",
    "nms",
    "nms_scan",
    "pool_grid",
    "random_sample",
    "rms_norm",
    "roi_align",
    "sample_from_draws",
    "selective_scan",
    "selective_scan_ref",
]
