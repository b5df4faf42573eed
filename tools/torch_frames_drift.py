"""The main path's frames/s over repeated runs in one process.

Runs `configs/tpu_plane.yaml` on `chip_smoke.py`'s 3 + 20 main-path frames
(`chip_smoke.run_path`, a fresh pipeline each run) three times fresh, three
times with three million small Python objects kept alive (a heap like the
one `chip_smoke.py` holds by its phase 14), three times with that heap
frozen out of the garbage collector (`gc.freeze`), and three times after
releasing it, and prints frames/s per run: whether the frames/s a run reads
late in a long process depend on the live heap. Needs one CUDA card:

    python3 tools/torch_frames_drift.py
"""

from __future__ import annotations

import gc
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_frames_drift: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.io import native
    from svnicp_tpu_torch.kernels import _build

    _build.build_all()
    native.library()
    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_plane.yaml"))
    times, _, _, scans = cs.bench_sequence(cs.WARMUP + cs.TIMED)
    frames = [(t, s, [], None) for t, s in zip(times, scans)]

    def runs():
        out = []
        for _ in range(3):
            _, dt, _ = cs.run_path(cfg, frames)
            out.append(round(cs.TIMED / dt, 2))
        return out

    smi = cs.nvidia_smi_line()
    print(f"fresh: {runs()} frames/s ({len(gc.get_objects())} objects)  [{smi}]")
    keep = [{"a": i, "b": [i]} for i in range(3_000_000)]
    print(f"3M live objects: {runs()} frames/s ({len(gc.get_objects())} objects)")
    gc.freeze()
    print(f"3M objects frozen (gc.freeze): {runs()} frames/s")
    gc.unfreeze()
    del keep
    gc.collect()
    print(f"released: {runs()} frames/s ({len(gc.get_objects())} objects)  [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
