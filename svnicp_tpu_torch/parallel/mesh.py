"""The ("particle", "point") device mesh and the collectives of its shards.

The JAX package writes each shard-local body once and runs it under
`jax.shard_map` with named-axis collectives. PyTorch has no shard_map, so
here a body takes a collectives object as its first argument and calls
`axis_index`, `axis_size`, `psum`, `pmean`, `all_gather` and the ring
`ppermute` on it by axis name ("particle", "point"); it does not know what
runs it:
- `Mesh` (this module) runs every shard in one process, one thread per
  shard, on the devices it was given, which may repeat one device: the
  counterpart of the JAX suite's simulated 8-device CPU mesh, and how 8
  shards run on one card;
- `distributed.DistMesh` runs one shard per `torch.distributed` rank.

`run(body, args, in_specs, out_specs)` is shard_map: an argument whose spec
is an axis name is split along its first dimension over that axis, one
whose spec is None is given whole to every shard; an output whose spec is
an axis name is put back together along its first dimension, one whose
spec is None is taken from the first shard (it is replicated). Shard
(i, j) of a (P, S) mesh is shard i * S + j, the row-major order of the JAX
package's `make_mesh`.

A reduction adds the group's values in member order, so every member gets
the same bits, repeats are bit-identical and the early-stop decision each
shard reads on the host is the same everywhere. In one process the shard
threads take turns: one baton passes from shard to shard, each runs until
its next collective, posts its value in a table of slots and hands the
baton on, and the first shard resumes once the last has posted (two tables
in turn, so no value is overwritten before every shard has read it). Only
one shard thread runs at a time: the shards' host work is serial, as it
would be under the GIL anyway (free-running threads that each launch many
small ops spend their time handing the GIL over), and on the card every
shard enqueues on the caller's current stream in that order, so a value is
ready for the shard that reads it. An exception in any shard wakes every
other shard with `ShardAborted`, and the first real error is raised in the
caller; a shard that waits longer than TURN_TIMEOUT_S for its turn
aborts the run.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PARTICLE_AXIS = "particle"
POINT_AXIS = "point"
TURN_TIMEOUT_S = 600.0   # the longest a shard waits for its turn


def split(x, spec, coord: dict, sizes: dict):
    """Shard `coord`'s block of `x` along dim 0 over axis `spec` (None: x)."""
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    step = x.shape[0] // sizes[spec]
    return x[coord[spec] * step:(coord[spec] + 1) * step]


class Collectives:
    """The named-axis collectives, built on `_gather` (every member's value
    in member order) and `_shift` (the ring neighbour's value)."""

    def __init__(self, coord: dict, sizes: dict):
        self.coord = coord
        self.sizes = sizes

    def axis_index(self, axis: str) -> int:
        return self.coord[axis]

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    def psum(self, x, axis: str):
        vals = self._gather(x, axis)
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def pmean(self, x, axis: str):
        return self.psum(x, axis) / self.sizes[axis]

    def all_gather(self, x, axis: str, tiled: bool = False) -> torch.Tensor:
        """Members' values stacked on a new first axis, or with `tiled`
        concatenated along the first axis."""
        vals = self._gather(x, axis)
        return torch.cat(vals) if tiled else torch.stack(vals)

    def ppermute(self, x, axis: str):
        """The ring shift: member m receives member m-1's value (JAX's
        `ppermute` with perm [(i, (i + 1) % n)])."""
        if self.sizes[axis] == 1:
            return x
        return self._shift(x, axis)

    def _gather(self, x, axis: str) -> list:
        raise NotImplementedError

    def _shift(self, x, axis: str):
        raise NotImplementedError


class ShardAborted(RuntimeError):
    """Another shard of the run failed (or a turn never came)."""


class _Baton:
    """The turn-taking of an in-process mesh's shard threads and the slots
    they exchange values through, one per shard."""

    def __init__(self, n: int):
        self.n = n
        self.turn = [threading.Semaphore(0) for _ in range(n)]
        self.broken = False
        self.slots = ([None] * n, [None] * n)
        self.calls = [0] * n

    def wait_turn(self, rank: int) -> None:
        if not self.turn[rank].acquire(timeout=TURN_TIMEOUT_S):
            self.abort()
        if self.broken:
            raise ShardAborted(f"shard {rank}: the mesh run was aborted")

    def pass_on(self, rank: int) -> None:
        self.turn[(rank + 1) % self.n].release()

    def post(self, rank: int, value) -> list:
        """Put this shard's value in the current table, let the next shard
        run, and return the table once every shard has posted."""
        slots = self.slots[self.calls[rank] & 1]
        self.calls[rank] += 1
        slots[rank] = value
        self.pass_on(rank)
        self.wait_turn(rank)
        return slots

    def abort(self) -> None:
        self.broken = True
        for sem in self.turn:
            sem.release()


class _LocalCollectives(Collectives):
    """A shard's collectives in an in-process mesh."""

    def __init__(self, mesh: "Mesh", table: _Baton, rank: int):
        i, j = divmod(rank, mesh.shape[POINT_AXIS])
        super().__init__({PARTICLE_AXIS: i, POINT_AXIS: j}, mesh.shape)
        self.rank = rank
        self.table = table
        self.device = mesh.devices[rank]
        self.members = {
            POINT_AXIS: [mesh.rank_of(i, m) for m in range(mesh.shape[POINT_AXIS])],
            PARTICLE_AXIS: [mesh.rank_of(m, j) for m in range(mesh.shape[PARTICLE_AXIS])],
        }

    def _here(self, v):
        return v.to(self.device) if isinstance(v, torch.Tensor) else v

    def _gather(self, x, axis: str) -> list:
        if self.sizes[axis] == 1:
            return [x]
        slots = self.table.post(self.rank, x)
        return [self._here(slots[m]) for m in self.members[axis]]

    def _shift(self, x, axis: str):
        slots = self.table.post(self.rank, x)
        members = self.members[axis]
        prev = members[(members.index(self.rank) - 1) % len(members)]
        return self._here(slots[prev])


class Mesh:
    """Every shard of a (particle, point) mesh in this process, shard r on
    devices[r]; the first device holds the assembled outputs."""

    def __init__(self, devices, particle_shards: int, point_shards: int):
        n = particle_shards * point_shards
        if len(devices) != n:
            raise ValueError(f"a ({particle_shards},{point_shards}) mesh takes {n} "
                             f"devices, got {len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.shape = {PARTICLE_AXIS: particle_shards, POINT_AXIS: point_shards}
        self.device = self.devices[0]

    @property
    def size(self) -> int:
        return self.shape[PARTICLE_AXIS] * self.shape[POINT_AXIS]

    def rank_of(self, i: int, j: int) -> int:
        return i * self.shape[POINT_AXIS] + j

    def run(self, body, args, in_specs, out_specs) -> tuple:
        """`body(collectives, *local args)` on every shard -> the outputs
        (a tuple, one per out_spec) put back together."""
        n = self.size
        table = _Baton(n)
        results: list = [None] * n
        errors: list = [None] * n
        grad = torch.is_grad_enabled()
        streams = {d: torch.cuda.current_stream(d)
                   for d in set(self.devices) if d.type == "cuda"}

        def shard(rank: int) -> None:
            try:
                if rank:
                    table.wait_turn(rank)
                coll = _LocalCollectives(self, table, rank)
                local = [coll._here(split(a, s, coll.coord, self.shape))
                         for a, s in zip(args, in_specs)]
                stream = streams.get(coll.device)
                ctx = (torch.cuda.stream(stream) if stream is not None
                       else contextlib.nullcontext())
                with ctx, torch.set_grad_enabled(grad):
                    results[rank] = tuple(body(coll, *local))
                table.pass_on(rank)
            except BaseException as e:   # noqa: BLE001 - re-raised by the caller
                errors[rank] = e
                table.abort()

        threads = [threading.Thread(target=shard, args=(r,), daemon=True,
                                    name=f"svnicp-shard-{r}") for r in range(1, n)]
        for t in threads:
            t.start()
        shard(0)
        for t in threads:
            t.join()
        raised = [e for e in errors if e is not None]
        if raised:
            real = [e for e in raised if not isinstance(e, ShardAborted)]
            raise (real or raised)[0]
        return self._assemble(results, out_specs)

    def _assemble(self, results, out_specs) -> tuple:
        outs = []
        p, s = self.shape[PARTICLE_AXIS], self.shape[POINT_AXIS]
        for k, spec in enumerate(out_specs):
            if spec is None:
                v = results[0][k]
            elif spec == POINT_AXIS:
                v = torch.cat([results[self.rank_of(0, j)][k].to(self.device)
                               for j in range(s)])
            else:
                v = torch.cat([results[self.rank_of(i, 0)][k].to(self.device)
                               for i in range(p)])
            outs.append(v.to(self.device) if isinstance(v, torch.Tensor) else v)
        return tuple(outs)
