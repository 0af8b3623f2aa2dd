from fastvim_tpu_torch.train.mixup import (
    accuracy,
    apply_mixup_cutmix,
    cross_entropy,
    mixup_cutmix,
    one_hot_smooth,
    sample_mixup_draws,
    soft_target_cross_entropy,
)
from fastvim_tpu_torch.train.optim import (
    ema_update,
    layer_decay_scales,
    make_optimizer,
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
    make_supervised_eval_step,
    make_supervised_train_step,
)

__all__ = [
    "TrainState",
    "accuracy",
    "apply_mixup_cutmix",
    "constant",
    "cosine_with_warmup",
    "cross_entropy",
    "ema_update",
    "layer_decay_scales",
    "make_optimizer",
    "make_supervised_eval_step",
    "make_supervised_train_step",
    "mixup_cutmix",
    "one_hot_smooth",
    "sample_mixup_draws",
    "scale_lr",
    "soft_target_cross_entropy",
    "warmup_multistep",
    "wd_mask",
]
