"""Device meshes for the sharded paths, and multi-process start-up.

Port of ``tpujpeg/parallel/mesh.py``. The reference is single-controller:
one process drives a named ``jax.make_mesh`` and its collectives. Here
one process drives a list of devices: a mesh is a tuple of
``torch.device``, one per shard, in shard order. A device may appear
more than once: ``("cpu",) * 8`` runs eight shards on the CPU, and
``(cuda:0,) * 4`` four shards on one card; a multi-GPU host gets one
shard per card. The reference's ``ppermute`` and ``all_gather`` become
peer copies between the shards' devices (``halo.py``), so no mesh needs
``torch.distributed``.

The reference's ``batch_sharding`` has no counterpart: a mesh is already
its placement (shard i's slice lives on ``mesh[i]``). Mesh axis names
have none either, so the port's ``DecodeConfig`` has no mesh axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def as_mesh(devices: Sequence) -> Mesh:
    """Devices (torch.device or strings such as "cuda:0", "cpu") as a
    mesh; raises ValueError on an empty list."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-process rendezvous; a no-op for one process, as the
    reference's. With `num_processes` > 1 it joins the process group at
    `coordinator` ("host:port"), NCCL where CUDA is available, else gloo.
    Nothing else in the port uses it: the sharded entries drive every
    device of a mesh from one process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id,
    )


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The given devices as a mesh, else every visible CUDA device. Raises
    RuntimeError with no card and no devices given: it never falls back
    to the CPU."""
    if devices is not None:
        return as_mesh(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the mesh's devices explicitly "
                           "(for example ('cpu',) * 8)")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


# The reference's two meshes, for batches and for one image's MCU rows,
# differ only in their axis names; a tuple of devices has none.
rows_mesh = data_mesh
