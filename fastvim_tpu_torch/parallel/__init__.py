"""Data and token (seq) parallelism over ``torchrun`` ranks (counterpart
of ``fastvim_tpu/parallel``)."""

from fastvim_tpu_torch.parallel.collectives import (
    allreduce_grads,
    barrier,
    batch_moments,
    denominator,
    gather_objects,
    is_writer,
    mean_over_ranks,
    mirror_rows,
    rand_rows,
    sum_over_ranks,
)
from fastvim_tpu_torch.parallel.mesh import (
    Mesh,
    TokenShard,
    get_mesh,
    init_distributed,
    launched,
    local_rank,
    make_mesh,
    replicate,
    reset_mesh,
    shard_batch,
    token_shard,
)

__all__ = [
    "Mesh",
    "TokenShard",
    "allreduce_grads",
    "barrier",
    "batch_moments",
    "denominator",
    "gather_objects",
    "get_mesh",
    "init_distributed",
    "is_writer",
    "launched",
    "local_rank",
    "make_mesh",
    "mean_over_ranks",
    "mirror_rows",
    "rand_rows",
    "replicate",
    "reset_mesh",
    "shard_batch",
    "sum_over_ranks",
    "token_shard",
]
