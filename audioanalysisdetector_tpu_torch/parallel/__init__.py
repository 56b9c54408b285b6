"""Parallelism substrate (PyTorch): process groups, device meshes, data
parallelism, model-axis sharding of the GMM."""

from audioanalysisdetector_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_batch_size,
    make_mesh,
    make_mesh_2d,
    process_shard,
)
from audioanalysisdetector_tpu_torch.parallel.sharded_gmm import (
    make_mesh_2d_for,
    make_sharded_masked_llr,
    shard_components,
)

__all__ = [
    "initialize_distributed",
    "local_batch_size",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_2d_for",
    "make_sharded_masked_llr",
    "process_shard",
    "shard_components",
]
