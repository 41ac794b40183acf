"""Data parallelism over cards (port of ``mmvae_tpu/parallel/``): the mesh
(``mesh.py``: a ``torch.distributed`` process group with a ``DeviceMesh``
of JAX's axis names, batches sharded, state replicated) and multi-process
bring-up (``multihost.py``). The train step reduces the gradient over the
mesh once a step (``train/step.py``). FSDP, tensor and pipeline
parallelism (``fsdp.py``, ``tp.py``, ``pp.py`` of the JAX package) are not
yet ported.
"""

from mmvae_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from mmvae_torch.parallel.multihost import (
    fetch_replicated,
    initialize as multihost_initialize,
    is_primary,
    process_count,
    sync,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "multihost_initialize",
    "is_primary",
    "process_count",
    "fetch_replicated",
    "sync",
]
