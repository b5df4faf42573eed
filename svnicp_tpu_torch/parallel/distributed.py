"""The multi-process runtime on `torch.distributed`.

Port of `svnicp_tpu/parallel/distributed.py`. Each process (rank) holds one
shard of the ("particle", "point") mesh and runs the same program (SPMD):
every rank stages the same frame, as every JAX process reads the same
stream, so the replicated inputs are equal by construction and the mesh
bodies of `parallel/sharding.py` and `parallel/voxmap_sharded.py` run
unchanged over `DistMesh`'s collectives.
- `initialize()` joins the process group from SVNICP_COORDINATOR
  ("host:port"), SVNICP_NUM_PROCESSES and SVNICP_PROCESS_ID (or explicit
  arguments): NCCL when every rank has a card of its own (rank r on card
  r), gloo otherwise (the CPU, or several ranks sharing one card);
- `maybe_initialize_from_env()` is the CLI's hook; `replicate`,
  `is_multiprocess` and `shutdown` complete it.

Rank r sits at (particle r // point_axis, point r % point_axis), the
row-major order of the JAX package's `make_mesh`. The point and particle
groups come from `dist.new_group`, which every rank calls for every
group in the same order. `psum`, `pmean` and `all_gather` are all-gathers
over the group, the sum then taken in member order on every rank (the
in-process mesh's order: both give the same bits); `ppermute` is a
batched isend/irecv ring on global ranks. Gloo takes CUDA tensors through
the host: the backend's name decides, not a caught error. An output split
over an axis is all-gathered, so every rank holds the global tensors (the
map blocks included), as a global jax.Array presents them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from svnicp_tpu_torch.parallel.mesh import (PARTICLE_AXIS, POINT_AXIS,
                                            Collectives, split)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> tuple[int, int]:
    """Join the process group -> (rank, world size). Arguments fall back to
    SVNICP_COORDINATOR, SVNICP_NUM_PROCESSES and SVNICP_PROCESS_ID."""
    coordinator_address = coordinator_address or os.environ.get("SVNICP_COORDINATOR")
    if num_processes is None and os.environ.get("SVNICP_NUM_PROCESSES"):
        num_processes = int(os.environ["SVNICP_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SVNICP_PROCESS_ID"):
        process_id = int(os.environ["SVNICP_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("distributed.initialize needs the coordinator address, "
                         "the process count and this process's id (arguments or "
                         "SVNICP_COORDINATOR, SVNICP_NUM_PROCESSES, SVNICP_PROCESS_ID)")
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= num_processes)
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def maybe_initialize_from_env() -> bool:
    """CLI hook: join the process group when SVNICP_COORDINATOR is set
    (every launched process runs the same command line)."""
    if os.environ.get("SVNICP_COORDINATOR"):
        initialize()
        return True
    return False


def replicate(tree, mesh):
    """Tensors of a (nested) tuple, list or dict on the mesh's device. Every
    rank must hold the same data: the SPMD staging contract above."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [replicate(v, mesh) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _RankCollectives(Collectives):
    """This rank's collectives over its point and particle groups."""

    def __init__(self, mesh: "DistMesh"):
        i, j = divmod(mesh.rank, mesh.shape[POINT_AXIS])
        super().__init__({PARTICLE_AXIS: i, POINT_AXIS: j}, mesh.shape)
        self.mesh = mesh

    def _wire(self, x):
        """x as a tensor gloo or NCCL takes -> (tensor, how to undo)."""
        if not isinstance(x, torch.Tensor):
            t = torch.tensor(x)
            return self._wire(t)[0], lambda v: v.item()
        dev, dtype, shape = x.device, x.dtype, x.shape
        wire = x.reshape(-1)
        if dtype == torch.bool:
            wire = wire.to(torch.uint8)
        if self.mesh.via_host:
            wire = wire.cpu()
        elif wire.device.type != "cuda":
            wire = wire.to(self.mesh.device)
        return wire.contiguous(), lambda v: v.to(dev).to(dtype).reshape(shape)

    def _gather(self, x, axis: str) -> list:
        if self.sizes[axis] == 1:
            return [x]
        group, members = self.mesh.groups[axis]
        wire, undo = self._wire(x)
        out = [torch.empty_like(wire) for _ in members]
        dist.all_gather(out, wire, group=group)
        return [undo(v) for v in out]

    def _shift(self, x, axis: str):
        _, members = self.mesh.groups[axis]
        me = members.index(self.mesh.rank)
        wire, undo = self._wire(x)
        recv = torch.empty_like(wire)
        ops = [dist.P2POp(dist.isend, wire, members[(me + 1) % len(members)]),
               dist.P2POp(dist.irecv, recv, members[(me - 1) % len(members)])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return undo(recv)


class DistMesh:
    """A ("particle", "point") mesh with one shard per rank of the process
    group; `device` is this rank's (the pipeline's) device."""

    def __init__(self, particle_shards: int, point_shards: int, kind: str | None = None):
        world = dist.get_world_size()
        if particle_shards * point_shards != world:
            raise ValueError(f"a ({particle_shards},{point_shards}) mesh needs "
                             f"{particle_shards * point_shards} processes, have {world}")
        self.shape = {PARTICLE_AXIS: particle_shards, POINT_AXIS: point_shards}
        self.rank = dist.get_rank()
        backend = dist.get_backend()
        kind = kind or ("cuda" if backend == "nccl" else "cpu")
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if kind == "cuda" else torch.device("cpu"))
        self.via_host = backend == "gloo"
        i, j = divmod(self.rank, point_shards)
        # every rank creates every group, in the same order
        point = [[a * point_shards + b for b in range(point_shards)]
                 for a in range(particle_shards)]
        particle = [[a * point_shards + b for a in range(particle_shards)]
                    for b in range(point_shards)]
        point_groups = [dist.new_group(m) for m in point]
        particle_groups = [dist.new_group(m) for m in particle]
        self.groups = {POINT_AXIS: (point_groups[i], point[i]),
                       PARTICLE_AXIS: (particle_groups[j], particle[j])}
        self._coll = _RankCollectives(self)

    def run(self, body, args, in_specs, out_specs) -> tuple:
        """`body(collectives, *this rank's blocks)` -> its outputs, the ones
        split over an axis all-gathered."""
        coll = self._coll
        local = [split(a, s, coll.coord, self.shape) for a, s in zip(args, in_specs)]
        outs = tuple(body(coll, *local))
        return tuple(v if spec is None else coll.all_gather(v, spec, tiled=True)
                     for v, spec in zip(outs, out_specs))
