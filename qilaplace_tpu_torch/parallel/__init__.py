"""Batched pipelines and mesh sharding (counterpart of
``qilaplace_tpu.parallel``)."""

from qilaplace_tpu_torch.parallel.mesh import (
    batched_qft_pipeline,
    batched_signal_mps,
    fit_mpo_step,
    make_mesh,
    multi_mpo_chi_batch,
    replicate,
    shard_batch,
    sharded_chi_grid,
    sharded_multi_scan,
    stack_mpos,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "batched_signal_mps",
    "batched_qft_pipeline",
    "sharded_chi_grid",
    "stack_mpos",
    "multi_mpo_chi_batch",
    "sharded_multi_scan",
    "fit_mpo_step",
]
