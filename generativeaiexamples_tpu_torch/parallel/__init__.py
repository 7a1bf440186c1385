"""Device mesh, sharding rules, the mesh's collectives and its single
controller, and ring/Ulysses attention (port of ``parallel/``)."""

from generativeaiexamples_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    MeshSpec,
    default_rules,
    fsdp_rules,
    logical_to_partition,
    make_mesh,
    replica_device_slices,
    shard_pytree,
)
from generativeaiexamples_tpu_torch.parallel.ring_attention import (
    ring_gqa_attention,
    sequence_parallel_attention,
    ulysses_gqa_attention,
)

__all__ = [
    "MESH_AXES",
    "Mesh",
    "MeshSpec",
    "default_rules",
    "fsdp_rules",
    "make_mesh",
    "logical_to_partition",
    "replica_device_slices",
    "shard_pytree",
    "ring_gqa_attention",
    "sequence_parallel_attention",
    "ulysses_gqa_attention",
]
