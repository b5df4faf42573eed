"""The align loop's passes a round (`core/svn.ALIGN_CHUNK`) swept on the card.

Feeds one pipeline per benchmark cell the cell's own drive (lio_bench's
configuration and traffic files, `--seed`), its warm-up frames and then
`--frames` more back to back, unpaced. Frame k of those runs with the k-th
variant in turn, so every variant meets every stretch of the drive:
`eager1` is the loop as before the graph (one pass a round, issued op by
op, a read after each), `g<m>` a round of m passes replayed from one CUDA
graph with one read. Each variant's first frame, which captures its
graph, is fed before the timed frames. Prints per variant the median and
95th percentile of the frame's wall time (scan handed over to its pose on
the host), its mean iterations and rounds a frame, and one JSON line per
cell. Needs one CUDA card:

    python3 tools/torch_align_chunk_sweep.py [--cells geode_alpha.live10hz ...]
        [--chunks 1 4 5 8 10 13 16 20] [--frames 240] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = ("geode_alpha.live10hz", "subt_mrs_fullmap.live10hz")


def sweep(cell_name: str, chunks, frames: int, seed: int) -> dict:
    import torch

    from lio_bench.harness import cell, drive, window
    from svnicp_tpu_torch import config
    from svnicp_tpu_torch.core import svn
    from svnicp_tpu_torch.runtime.pipeline import LIOPipeline

    c = cell.find_cell(cell_name)
    cfg_d = cell.config_dict(c)
    cfg = config.from_dict(cfg_d)
    tr = cell.traffic(c)
    warm = int(tr["warmup_frames"])
    variants = ["eager1"] + [f"g{m}" for m in chunks]
    n = warm + len(variants) + frames
    drv = drive.make_drive(tr, seed, n, cfg.icp.particle_count,
                           *drive.prior_box(cfg_d["icp"]))
    parts = torch.from_numpy(drv.particles).to("cuda")
    graphed = svn._graphed
    feeder = window.Feeder(LIOPipeline(cfg, device="cuda"), drv, parts)
    times = {v: [] for v in variants}
    iters = {v: [] for v in variants}

    def run(k: int, v: str):
        svn.ALIGN_CHUNK = 1 if v == "eager1" else int(v[1:])
        svn._graphed = (lambda *a: False) if v == "eager1" else graphed
        feeder.imu(k)
        t0 = time.perf_counter()
        _, its, ok = feeder.scan(k)
        return time.perf_counter() - t0, its, ok

    for k in range(warm):
        run(k, variants[-1])
    for j, v in enumerate(variants):          # each variant's capture
        run(warm + j, v)
    for i in range(frames):
        k = warm + len(variants) + i
        v = variants[i % len(variants)]
        dt, its, ok = run(k, v)
        assert ok, (cell_name, k, v)
        times[v].append(dt * 1e3)
        iters[v].append(its)
    svn._graphed = graphed
    out = {}
    for v in variants:
        m = 1 if v == "eager1" else int(v[1:])
        it = np.asarray(iters[v], float)
        t = np.asarray(times[v])
        out[v] = {"median_ms": float(np.median(t)), "p95_ms": float(np.percentile(t, 95)),
                  "iters": float(it.mean()), "rounds": float(np.ceil(it / m).mean()),
                  "frames": len(t)}
        print(f"{cell_name} {v:>7}: frame median {out[v]['median_ms']:.3f} ms, "
              f"p95 {out[v]['p95_ms']:.3f} ms, {out[v]['iters']:.2f} iterations and "
              f"{out[v]['rounds']:.2f} rounds a frame over {len(t)} frames", flush=True)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--chunks", nargs="+", type=int, default=[1, 4, 5, 8, 10, 13, 16, 20])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for name in args.cells:
        res = sweep(name, args.chunks, args.frames, args.seed)
        print(json.dumps({"cell": name, "device": torch.cuda.get_device_name(0),
                          "variants": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
