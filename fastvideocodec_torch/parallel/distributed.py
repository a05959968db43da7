"""Multi-process bring-up and the global mesh, ported from
fastvideocodec_tpu/parallel/distributed.py to torch.distributed.

Every process calls ``initialize()`` (torchrun's environment: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), then
builds one mesh over all ranks with ``global_mesh``, whose OUTER axis,
'data', is the one laid across hosts: the ranks of a host hold shards of
('view', 'frame'), whose activation collectives run every step, and the
gradient reduction of 'data', once a step, is the only collective between
hosts.

The backend is NCCL with one card a rank (``cuda:LOCAL_RANK``) and gloo on
the CPU. ``backend="gloo"`` with CUDA tensors lets several ranks share one
card: gloo stages its collectives through the host. That is the test
arrangement of a machine with one card (tools/dryrun_multichip.py); NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from fastvideocodec_torch.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Bring up the process group. With no arguments it reads torchrun's
    environment; else it joins ``coordinator_address`` ("host:port") as
    rank ``process_id`` of ``num_processes``. Returns at once when a group
    exists (the launcher's). The backend defaults to NCCL where CUDA is
    there, with this rank on ``cuda:LOCAL_RANK`` (else its rank modulo the
    cards), and to gloo on the CPU."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method, world, rank = "env://", None, None
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        init_method = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
        local = int(os.environ.get("LOCAL_RANK", process_id))
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def mesh_layout(world: int, per_host: int, data: int | None = None, view: int = 1,
                frame: int = 1) -> np.ndarray:
    """The ranks of a (data, view, frame) mesh over ``world`` ranks,
    ``per_host`` a host, as JAX's ``global_mesh`` lays out its devices:
    ``data`` fills what view x frame leaves, host-major (ranks in order, a
    host's ranks consecutive). Raises ValueError where JAX's does: world
    not divisible by view*frame, a data axis that does not fill it, and
    view*frame beyond one host's ranks when there are several hosts."""
    inner = view * frame
    if world % inner:
        raise ValueError(f"{world} devices not divisible by view*frame={inner}")
    if data is None:
        data = world // inner
    if data * inner != world:
        raise ValueError(f"mesh {data}x{view}x{frame} != {world} global devices")
    if inner > per_host and world // max(per_host, 1) > 1:
        raise ValueError(f"view*frame={inner} exceeds {per_host} devices/host — the "
                         "activation-collective axes must stay on one host")
    return np.arange(world).reshape(data, view, frame)


def global_mesh(data: int | None = None, view: int = 1, frame: int = 1,
                device_type: str | None = None):
    """A (data, view, frame) mesh over every rank (``mesh_layout``; ranks a
    host from torchrun's ``LOCAL_WORLD_SIZE``, else one host), on the card
    unless ``device_type`` says otherwise ("cpu" under gloo alone)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shape = mesh_layout(world, per_host, data, view, frame).shape
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return make_mesh(*shape, device_type=device_type)
