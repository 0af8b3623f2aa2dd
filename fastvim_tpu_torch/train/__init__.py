from fastvim_tpu_torch.train.mixup import (
    accuracy,
    apply_mixup_cutmix,
    cross_entropy,
    mixup_cutmix,
    one_hot_smooth,
    sample_mixup_draws,
    soft_target_cross_entropy,
)
from fastvim_tpu_torch.train.metrics import (
    box_average_precision,
    coco_map,
    confusion_matrix,
    mask_average_precision,
    miou_from_confusion,
    paste_mask,
)
from fastvim_tpu_torch.train.optim import (
    ema_update,
    layer_decay_scales,
    make_lars,
    make_optimizer,
    make_sgd,
    vitdet_layer_decay_scales,
    wd_mask,
)
from fastvim_tpu_torch.train.schedules import (
    constant,
    cosine_with_warmup,
    scale_lr,
    warmup_multistep,
)
from fastvim_tpu_torch.train.state import TrainState
from fastvim_tpu_torch.train.trainer import (
    make_linear_probe_step,
    make_mae_train_step,
    make_supervised_eval_step,
    make_supervised_train_step,
)

__all__ = [
    "TrainState",
    "accuracy",
    "apply_mixup_cutmix",
    "box_average_precision",
    "coco_map",
    "confusion_matrix",
    "constant",
    "cosine_with_warmup",
    "cross_entropy",
    "ema_update",
    "layer_decay_scales",
    "make_lars",
    "make_linear_probe_step",
    "make_mae_train_step",
    "make_optimizer",
    "make_sgd",
    "make_supervised_eval_step",
    "make_supervised_train_step",
    "mask_average_precision",
    "miou_from_confusion",
    "mixup_cutmix",
    "one_hot_smooth",
    "paste_mask",
    "sample_mixup_draws",
    "scale_lr",
    "soft_target_cross_entropy",
    "vitdet_layer_decay_scales",
    "warmup_multistep",
    "wd_mask",
]
