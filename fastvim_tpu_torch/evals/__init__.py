from fastvim_tpu_torch.evals.lm_harness import (
    loglikelihood,
    loglikelihood_rolling,
    make_eval_wrapper,
)

__all__ = ["loglikelihood", "loglikelihood_rolling", "make_eval_wrapper"]
