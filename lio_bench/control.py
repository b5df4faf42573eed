"""The readings a cell's limits are set from (PERF.md gives them; the
limits file keeps them beside each limit), each seed judged exactly as a
run of the cell is judged:

- the control (`--side control`, the default): the plain reference put in
  the program's place, computed one precision below the configuration's
  (float32 with every product's operands rounded to TF32, where the
  configuration states float32 with TF32 off), over the first `--frames`
  frames of the cell's drive: the upper readings;
- the program (`--side program`): one whole pass of the cell's drive fed
  to a fresh `LIOPipeline` as the window feeds it, unpaced (the live
  cell's pass, warm-up frames and `run_seconds` of scans, included: the
  pipeline's outputs do not depend on the sensor's pacing), so a dozen
  seeds fit one process: the lower readings; with `--fault <name>` a
  fault of `harness/faults.py` planted underneath, whose readings are the
  upper ones of the numbers the control does not separate.

    python3 lio_bench/control.py --workload <cell> --seeds 11 12 13 [--frames 300]
    python3 lio_bench/control.py --workload <cell> --side program [--fault early_stop] --seeds 11 12 13

prints one JSON line per seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setting(name: str, overrides):
    from lio_bench.harness import cell as cellmod

    c = cellmod.find_cell(name)
    overrides = overrides or {}
    cfg = cellmod.merge(cellmod.config_dict(c), overrides.get("pipeline"))
    tr = cellmod.merge(cellmod.traffic(c), overrides.get("traffic"))
    return c, cellmod.reference(c), cfg, tr


def _report(name, seed, frames, numbers, limits, aligned) -> dict:
    from lio_bench.harness import judge

    ok, _ = judge.verdict(numbers, limits)
    return {"workload": name, "seed": seed, "frames": frames, "correct": ok,
            "aligned": aligned,
            "numbers": {k: (v if v == v and abs(v) != float("inf") else str(v))
                        for k, v in numbers.items()}}


def control_numbers(name: str, seed: int, frames: int, device, overrides=None) -> dict:
    import torch

    from lio_bench.harness import cell as cellmod
    from lio_bench.harness import drive as drive_mod
    from lio_bench.harness import judge

    c, ref, cfg, tr = _setting(name, overrides)
    icp = cfg["icp"]
    drv = drive_mod.make_drive(tr, seed, frames, int(icp["particle_count"]),
                               *drive_mod.prior_box(icp))
    out = judge.control_outputs(ref, cfg, drv, frames, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.judge(ref, cfg, drv, out, seed, int(tr["check_frames"]), device)
    return _report(name, seed, frames, numbers, cellmod.limits(c), int(out.align_ok.sum()))


def program_numbers(name: str, seed: int, device, overrides=None, seconds=None,
                    fault: str | None = None) -> dict:
    import torch

    from svnicp_tpu_torch import config as pconfig
    from svnicp_tpu_torch.runtime.pipeline import LIOPipeline

    from lio_bench.harness import cell as cellmod
    from lio_bench.harness import drive as drive_mod
    from lio_bench.harness import faults, judge, window

    c, ref, cfg_d, tr = _setting(name, overrides)
    seconds = c.manifest["run_seconds"] if seconds is None else seconds
    patch = faults.Patch()
    try:
        if fault:
            faults.FAULTS[fault](patch.setattr)
        cfg = pconfig.from_dict(cfg_d)
        drv = drive_mod.make_drive(tr, seed, drive_mod.frame_count(tr, seconds),
                                   cfg.icp.particle_count,
                                   *drive_mod.prior_box(cfg_d["icp"]))
        n = (int(tr["frames"]) if tr["kind"] == "replay" else
             int(tr["warmup_frames"]) + window.live_frames(seconds, float(tr["rate_hz"])))
        feeder = window.Feeder(LIOPipeline(cfg, device=device), drv,
                               torch.from_numpy(drv.particles).to(device))
        for k in range(n):
            feeder.imu(k)
            feeder.scan(k)
        out = cellmod.pass_outputs(feeder.pipe)
    finally:
        patch.undo()
    del feeder
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.judge(ref, cfg_d, drv, out, seed, int(tr["check_frames"]), device)
    return _report(name, seed, n, numbers, cellmod.limits(c), int(out.align_ok.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--side", choices=("control", "program"), default="control")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.side == "control":
            r = control_numbers(args.workload, seed, args.frames, "cuda")
        else:
            r = program_numbers(args.workload, seed, "cuda", fault=args.fault)
            r["fault"] = args.fault
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
