"""The features path with its raw-scan selection as one CUDA graph and op by op.

Runs `configs/tpu_features.yaml` on `chip_smoke.py`'s 3 + 20 HDL-64 proxy
frames in one process, alternating the two ways of launching
`features.select_features` (graph, op by op, graph, op by op; op by op
replaces `core.cuda_graph.replay` with a plain call), and prints frames/s
and iterations of each run. Then one more run of each with
`pipeline._preprocess` timed by the host clock between two device
synchronisations, which gives the preprocessing's wall time per frame (the
synchronisations stall the pipeline, so those runs' frames/s are not
comparable with the first four). Needs one CUDA card:

    python3 tools/torch_features_graph_ab.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.core import cuda_graph
    from svnicp_tpu_torch.runtime import pipeline as pl

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_features.yaml"))
    events, _, _ = chip_smoke.proxy_sequence(chip_smoke.WARMUP + chip_smoke.TIMED)
    frames = chip_smoke.proxy_frames(events)
    graphed = cuda_graph.replay

    def op_by_op(key, fn, *args):
        return list(fn(*args))

    preprocess = pl._preprocess
    spent = []

    def timed_preprocess(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = preprocess(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    for mode in ("graph", "op by op", "graph", "op by op"):
        cuda_graph.replay = graphed if mode == "graph" else op_by_op
        pipe, dt, _ = chip_smoke.run_path(cfg, frames)
        iters = sum(o.icp_iterations for o in pipe.outputs)
        print(f"features path, selection {mode}: {chip_smoke.TIMED / dt:.2f} frames/s "
              f"over {chip_smoke.TIMED} timed frames, {iters} iterations  [{smi}]")
    pl._preprocess = timed_preprocess
    for mode in ("graph", "op by op"):
        cuda_graph.replay = graphed if mode == "graph" else op_by_op
        spent.clear()
        pipe, dt, _ = chip_smoke.run_path(cfg, frames)
        per = np.array(spent[chip_smoke.WARMUP - 1:]) * 1e3   # frame 0 bootstraps
        print(f"features path, selection {mode}, preprocessing timed: "
              f"{np.median(per):.2f} ms median per frame ({per.min():.2f}-"
              f"{per.max():.2f}) over {len(per)} frames, of {dt / chip_smoke.TIMED * 1e3:.2f} "
              f"ms a frame  [{smi}]")
    cuda_graph.replay = graphed
    pl._preprocess = preprocess
    return 0


if __name__ == "__main__":
    sys.exit(main())
