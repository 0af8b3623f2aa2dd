from fastvim_tpu_torch.utils.convert import (
    from_jax_params,
    grads_to_numpy,
    to_jax_params,
)

__all__ = ["from_jax_params", "grads_to_numpy", "to_jax_params"]
