"""Scaling benchmark of the mesh-parallel registration (`parallel/sharding.py`).

    python -m svnicp_tpu_torch.bench_scaling [--particles 256] [--points 4096]
        [--target 32768] [--iters 50] [--reps 3] [--shards 8] [--device cpu]

The counterpart of the JAX package's `bench_scaling.py`: the same problem
(a 4,096-point Gaussian cloud against 32,768 target points moved by a known
pose, both from default_rng(0); 50 iterations, K=100, no early stop) and the
same ladder of (particle, point) meshes: (1,1), then
`sharding.auto_axes(d, P)` for d = 2, 4, 8, ... up to `--shards`. Every
shard of a rung lies on the one device (`make_mesh(p, q, devices=[dev] * n)`),
so on one card the ladder measures the mesh code's overhead, not scaling:
`simulated` says so whenever several shards share a device.

Prints one JSON line per rung: metric, mesh, devices (shards), cards
(distinct devices), backend (`cuda` or `cpu`), simulated, value (seconds
per registration, the mean of `--reps` after one untimed call, closed by a
synchronisation), unit and scaling_efficiency (the (1,1) rung's time over
this rung's times its shards).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn

POSE = (0.2, -0.1, 0.05, 0.01, -0.01, 0.02)   # se3 of the target's motion


def problem(points: int, target: int, particles: int, iters: int,
            dtype=torch.float32, device=None):
    """(config, sharded_register's arguments after the mesh and config):
    the source cloud and its mask, the moved target cloud and its mask, the
    identity guess and the particles, drawn by `svn.init_particles_uniform`
    from a generator seeded 0."""
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(points, 3)).astype(np.float32) * 20
    r, t = geo.se3_exp(torch.tensor(POSE, dtype=torch.float32))
    tgt = geo.transform_points(
        r, t, torch.from_numpy(rng.normal(size=(target, 3)).astype(np.float32) * 20))
    cfg = SteinICPConfig(particle_count=particles, iterations=iters, lr=1.0,
                         max_dist=3.0, knn_count=100, early_stop=False)
    init = svn.init_particles_uniform(torch.Generator().manual_seed(0), particles,
                                      cfg.init_lb, cfg.init_ub)
    args = (torch.from_numpy(cloud), torch.ones(points, dtype=torch.bool), tgt,
            torch.ones(target, dtype=torch.bool), torch.eye(3), torch.zeros(3), init)
    return cfg, tuple(a.to(device=device, dtype=dtype if a.is_floating_point() else None)
                      for a in args)


def ladder(shards: int, particles: int) -> list[tuple[int, int]]:
    """(1,1), then auto_axes(d, particles) for d = 2, 4, ... <= shards."""
    from svnicp_tpu_torch.parallel import sharding

    shapes, d = [(1, 1)], 2
    while d <= shards:
        shapes.append(sharding.auto_axes(d, particles))
        d *= 2
    return shapes


def rung(devices, shape, cfg, args, reps: int):
    """One rung: sharded_register on a mesh of shape (p, q), shard r on
    devices[r] -> (seconds per registration, the last result)."""
    from svnicp_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(*shape, devices=devices)

    def sync():
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    out = sharding.sharded_register(mesh, cfg, *args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = sharding.sharded_register(mesh, cfg, *args)
    sync()
    return (time.perf_counter() - t0) / reps, out


def main(argv=None) -> list:
    """Run the ladder and print a line per rung -> [(line, result), ...]."""
    from svnicp_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--target", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8,
                    help="the largest mesh of the ladder")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, call_args = problem(args.points, args.target, args.particles, args.iters,
                             device=device)
    base, rows = None, []
    for shape in ladder(args.shards, args.particles):
        n = shape[0] * shape[1]
        devices = [device] * n
        dt, out = rung(devices, shape, cfg, call_args, args.reps)
        base = dt if base is None else base
        cards = len(set(devices))
        line = {"metric": "sharded_align_seconds", "mesh": f"{shape[0]}x{shape[1]}",
                "devices": n, "cards": cards, "backend": device.type,
                "simulated": n > cards, "value": round(dt, 4), "unit": "s/align",
                "scaling_efficiency": round(base / (dt * n), 3)}
        print(json.dumps(line), flush=True)
        rows.append((line, out))
    return rows


if __name__ == "__main__":
    main()
