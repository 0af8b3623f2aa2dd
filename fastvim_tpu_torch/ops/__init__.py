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
    "broadcast_grid",
    "causal_conv1d",
    "dual_conv1d",
    "grid_dual_conv1d",
    "layer_norm",
    "pool_grid",
    "rms_norm",
    "selective_scan",
    "selective_scan_ref",
]
