from omnihuman_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SP,
    MeshConfig,
    create_mesh,
    current_mesh,
    init_distributed,
    local_mesh,
    use_mesh,
)
from omnihuman_tpu_torch.parallel.partition import (
    infer_param_specs,
    shard_params,
)

__all__ = [
    "AXIS_DATA", "AXIS_FSDP", "AXIS_SP",
    "MeshConfig", "create_mesh", "current_mesh", "init_distributed",
    "local_mesh", "use_mesh", "infer_param_specs", "shard_params",
]
