from fastvim_tpu_torch.utils.convert import (
    cache_from_jax,
    from_jax_params,
    grads_to_numpy,
    lm_from_jax_params,
    to_jax_params,
)

__all__ = ["cache_from_jax", "from_jax_params", "grads_to_numpy",
           "lm_from_jax_params", "to_jax_params"]
