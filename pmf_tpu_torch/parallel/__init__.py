"""Multi-device training over ``torch.distributed``: meshes and
data-parallel placement (``mesh``), the row-sharded flat ring (``tp``) and
the blocked ring with the kernels inside it (``tp_blocked``).  Importing
it starts no process group and touches no device."""

from pmf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_blocked,
    shard_eval_set,
    shard_ratings,
    shard_state_rows,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "make_mesh_2d", "replicate",
           "shard_blocked", "shard_eval_set", "shard_ratings", "shard_state_rows"]
