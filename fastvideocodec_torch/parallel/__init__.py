"""Multi-device training of the port on torch.distributed, ported from
fastvideocodec_tpu/parallel/: the (data, view, frame) mesh, the slices of a
GOP a rank holds, LSVC's frame axis and the collectives the models call
where JAX's GSPMD inserts them (``collectives``). ``make_train_step(...,
mesh=...)`` (train/trainer.py) runs a step on a mesh."""

from fastvideocodec_torch.parallel.distributed import global_mesh, initialize, mesh_layout
from fastvideocodec_torch.parallel.frame import frame_sharded_spec, gop_frame_sharding
from fastvideocodec_torch.parallel.mesh import (
    gop_sharding,
    make_mesh,
    replicate,
    shard_gop,
    shard_views,
)

__all__ = [
    "frame_sharded_spec",
    "global_mesh",
    "gop_frame_sharding",
    "gop_sharding",
    "initialize",
    "make_mesh",
    "mesh_layout",
    "replicate",
    "shard_gop",
    "shard_views",
]
