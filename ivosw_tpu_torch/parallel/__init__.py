from ivosw_tpu_torch.parallel.mesh import (
    Mesh,
    assess_param_shardings,
    frame_sharded_score_clip,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "assess_param_shardings",
    "frame_sharded_score_clip",
    "make_mesh",
    "replicate",
    "shard_batch",
]
