"""Frame-axis ("sequence") parallelism of the LSVC tree codec, ported from
fastvideocodec_tpu/parallel/frame.py.

The reference splits a tree layer's frame batch over two GPUs with
nn.DataParallel decoder wraps (models.py:1194-1203, 1363-1394). Here the
LSVC forward (models/lsvc.py, ``frame_axis``) splits the stage-1 flow and
mv batch and every tree layer's (chunk's) frame batch over the mesh axis:
each rank codes its frames and gathers the layer's recons, so that every
rank holds the parents of the next layer (GSPMD inserts the same gathers
from JAX's sharding constraints).

Composes with data parallelism: a batched step on a mesh with both axes
splits the clips over 'data' (tools/dryrun_multichip.py's fourth half).
"""

from __future__ import annotations

import copy
import dataclasses

from fastvideocodec_torch.parallel.mesh import GopSharding


def frame_sharded_spec(spec, axis: str = "frame"):
    """A CodecSpec whose LSVC module splits its per-layer frame batches over
    the mesh axis ``axis``. The module is a shallow copy that shares every
    parameter with ``spec``'s, so weights trained either way interchange."""
    if spec.family != "lsvc":
        raise ValueError(f"frame-axis sharding drives the LSVC tree schedule; got family "
                         f"'{spec.family}'")
    module = copy.copy(spec.module)
    module.frame_axis = axis
    return dataclasses.replace(spec, module=module)


def gop_frame_sharding(mesh, batched: bool = False) -> GopSharding:
    """The GOP input of a frame-sharded step: with ``batched`` the clips
    ([B, T, ...]) split over 'data'. JAX's also splits the frame axis T over
    'frame'; here every frame rank holds its clips' frames whole, since its
    frames' flow and motion compensation read their parents' raw and coded
    frames, and the model splits the work by frame."""
    return GopSharding(mesh, 0, ("data",) if batched else ())
