"""Data, fully-sharded, tensor and pipeline parallelism over cards (port
of ``mmvae_tpu/parallel/``): the meshes (``mesh.py``: a
``torch.distributed`` process group with a ``DeviceMesh`` of JAX's axis
names, batches sharded, state replicated; the ``(data, model)`` mesh of
tensor parallelism and the ``(data, pipe)`` one of pipeline parallelism),
multi-process bring-up (``multihost.py``), FSDP (``fsdp.py``: ZeRO-3, the
state sharded over the data mesh by JAX's layout rule), tensor parallelism
(``tp.py``: column/row-parallel experts and sharded attribute banks over
the model axis), pipeline parallelism (``pp.py``: the GPipe schedule of the
stage-stacked trunks over the pipe axis) and the sharded state they share
(``layout.py``). The train step reduces the gradient over the data group
once a step (``train/step.py``).
"""

from mmvae_torch.parallel.fsdp import fsdp_layout, fsdp_shard, fsdp_sharding
from mmvae_torch.parallel.layout import Layout, state_bytes
from mmvae_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    make_mesh_2d,
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
from mmvae_torch.parallel.pp import (
    make_mesh_pp,
    pipeline_apply,
    pp_param_specs,
    pp_shard,
    pp_shard_batch,
)
from mmvae_torch.parallel.tp import chain_assignments, tp_param_specs, tp_shard

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "Layout",
    "state_bytes",
    "fsdp_sharding",
    "fsdp_layout",
    "fsdp_shard",
    "chain_assignments",
    "tp_param_specs",
    "tp_shard",
    "make_mesh_pp",
    "pipeline_apply",
    "pp_param_specs",
    "pp_shard",
    "pp_shard_batch",
    "multihost_initialize",
    "is_primary",
    "process_count",
    "fetch_replicated",
    "sync",
]
