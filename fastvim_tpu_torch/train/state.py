"""Train state: the model, its optimizer, the step count and an optional
float32 EMA copy of the parameters.

Counterpart of ``fastvim_tpu/train/state.py``. The JAX state is an
immutable pytree and ``apply_gradients`` returns a new one; here the
parameters, the Adam moments and the EMA copy are updated in place and
``apply_gradients`` returns the same object. ``state_dict()`` is the
checkpoint's payload, ``{params, ema_params, opt_state, step}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from fastvim_tpu_torch.train.optim import ScheduledAdamW, ema_update


@dataclass
class TrainState:
    model: nn.Module
    tx: ScheduledAdamW
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # None: no EMA

    @classmethod
    def create(cls, model: nn.Module, tx: ScheduledAdamW,
               ema: bool = False) -> "TrainState":
        ema_params = ({n: p.detach().float().clone()
                       for n, p in model.named_parameters()} if ema else None)
        return cls(model=model, tx=tx, ema_params=ema_params)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def apply_gradients(self, grads: Mapping[str, torch.Tensor],
                        ema_decay: Optional[float] = None) -> "TrainState":
        self.tx.apply(grads)
        if self.ema_params is not None and ema_decay is not None:
            ema_update(self.ema_params, self.params, ema_decay)
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        """The parameters, the EMA copy (with EMA only), the optimizer's
        state and the step, as tensors and numbers."""
        state = {"params": self.model.state_dict(),
                 "opt_state": self.tx.state_dict(), "step": self.step}
        if self.ema_params is not None:
            state["ema_params"] = self.ema_params
        return state

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore, in place, what :meth:`state_dict` saved."""
        self.model.load_state_dict(state["params"])
        if self.ema_params is not None:
            with torch.no_grad():
                for name, e in self.ema_params.items():
                    e.copy_(state["ema_params"][name])
        self.tx.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
