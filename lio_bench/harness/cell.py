"""One run of one cell: find its files by name, make the drive, warm up,
measure, judge, print.

Everything that belongs to a configuration, a traffic mix or a metric is a
file of its own that this module finds by the names in `BENCHMARK.json`:
`lio_bench/configs/<config>.yaml` (`file` in the manifest),
`lio_bench/traffic/<traffic>.yaml`, `lio_bench/metrics/<metric>.py`,
`lio_bench/limits/<cell>.json`, and the plain reference that the
configuration file names, `lio_bench/reference/<reference>.py`. A new
cell, mix, metric or reference is new files and manifest entries, with no
edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import yaml

BENCH = Path(__file__).resolve().parent.parent        # lio_bench/
ROOT = BENCH.parent                                     # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "svnicp_tpu")     # top-level module names
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class CellError(RuntimeError):
    """A cell that cannot run here (no card, too few cards, missing files)."""


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config_file: Path
    traffic_name: str
    chips: int
    metrics: list             # manifest entries of the metrics this cell reports
    manifest: dict
    root: Path = ROOT


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def reports(entry: dict, cell: str, man: dict) -> bool:
    """Whether the cell reports the metric: listed in its `workloads`, or,
    without that key, every cell (an end-to-end metric) or every cell that
    reports the metric it moves (a per-layer metric)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if "moves" in entry:
        moved = next(m for m in man["end_to_end"] if m["name"] == entry["moves"])
        return reports(moved, cell, man)
    return True


def find_cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    try:
        w = next(w for w in man["workloads"] if w["name"] == name)
    except StopIteration:
        raise CellError(f"no workload {name!r} in BENCHMARK.json") from None
    c = next(c for c in man["configs"] if c["name"] == w["config"])
    metrics = [m for m in man["end_to_end"] + man["per_layer"] if reports(m, name, man)]
    return Cell(name, c["name"], root / c["file"], w["traffic"], int(w["chips"]),
                metrics, man, root)


def load_yaml(path: Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def config_dict(cell: Cell) -> dict:
    """The configuration as run: the `pipeline` block of the frozen copy,
    whose `reference` must name a module under `lio_bench/reference/`."""
    doc = load_yaml(cell.config_file)
    reference_module(doc.get("reference"), cell.root)
    return doc["pipeline"]


def reference(cell: Cell):
    """The plain reference that the cell's configuration file names."""
    return reference_module(load_yaml(cell.config_file).get("reference"), cell.root)


def traffic(cell: Cell, root: Path = ROOT) -> dict:
    return load_yaml(root / "lio_bench" / "traffic" / f"{cell.traffic_name}.yaml")


def limits(cell: Cell, root: Path = ROOT) -> dict:
    """The limit of each number the comparison reads: the cell's limits
    file, and 0 for the counts of the size guarantees its configuration
    states (`judge.guarantee_limits`)."""
    from lio_bench.harness import judge

    with open(root / "lio_bench" / "limits" / f"{cell.name}.json") as f:
        lim = json.load(f)["limits"]
    return {**lim, **judge.guarantee_limits(load_yaml(cell.config_file).get("guarantees"))}


def _load(path: Path, name: str, register: bool = False):
    """The module at `path`; with `register`, entered in sys.modules as
    `name` (dataclasses look their module up there while they are made)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    if register:
        sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: Path = ROOT):
    return _load(root / "lio_bench" / "metrics" / f"{name}.py", f"lio_bench_metric_{name}")


def reference_module(name, root: Path = ROOT):
    """`lio_bench/reference/<name>.py` under `root`, imported once a process
    (as `lio_bench_reference_<name>`); a name with no such module is a
    CellError."""
    path = root / "lio_bench" / "reference" / f"{name}.py"
    if not (isinstance(name, str) and NAME.fullmatch(name) and path.is_file()):
        raise CellError(f"no reference module {name!r} under {path.parent}")
    mod = sys.modules.get(f"lio_bench_reference_{name}")
    if mod is None or Path(mod.__file__).resolve() != path.resolve():
        mod = _load(path, f"lio_bench_reference_{name}", register=True)
    return mod


def process_start() -> float:
    """perf_counter() at this process's start (from /proc; the module's own
    import time where /proc is absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    cfg: dict
    traffic: dict
    window: object
    setup_s: float
    trace: object             # TraceSummary or None
    probes: dict              # what the readers' probes recorded, by metric name


def pass_outputs(pipe):
    """A pipeline's frames and final map as the judge reads them."""
    import torch

    from lio_bench.harness.judge import PassOutputs

    outs = pipe.outputs

    def stack(name, shape):
        return torch.stack([getattr(o, name).reshape(shape) for o in outs]
                           ).double().cpu().numpy()

    vmap = pipe.state.vmap
    counts = torch.stack([torch.stack([o.map_dropped.reshape(()).long(),
                                       o.target_overflow.reshape(()).long()])
                          for o in outs]).cpu().numpy()
    return PassOutputs(
        pose_r=stack("pose_r", (3, 3)), pose_t=stack("pose_t", (3,)),
        guess_r=stack("guess_r", (3, 3)), guess_t=stack("guess_t", (3,)),
        mean=torch.stack([o.particles.mean(0) for o in outs]).double().cpu().numpy(),
        var=stack("var_icp", (6,)),
        iterations=np.asarray([int(o.icp_iterations) for o in outs]),
        align_ok=np.asarray([bool(o.align_ok) for o in outs]),
        map_points=vmap.points.cpu().numpy(), map_key=vmap.key.cpu().numpy(),
        map_valid=vmap.valid.cpu().numpy(),
        map_dropped=counts[:, 0], target_overflow=counts[:, 1])


def cpu_times() -> tuple[float, float]:
    """(all, steal) jiffies of the host's CPUs from /proc/stat (zeros where
    absent): the share the hypervisor took from this machine."""
    try:
        with open("/proc/stat") as f:
            v = [float(x) for x in f.readline().split()[1:]]
        return sum(v), (v[7] if len(v) > 7 else 0.0)
    except (OSError, ValueError):
        return 0.0, 0.0


def nvidia_smi() -> str:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def merge(base: dict, over: dict | None) -> dict:
    """`base` with `over`'s entries in place, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _num(x: float):
    """A JSON number, or the string of a non-finite one."""
    return x if math.isfinite(x) else str(x)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Path = ROOT, overrides: dict | None = None) -> dict:
    """One run; returns the result object (the last line's content).
    `overrides` ({"pipeline": {...}, "traffic": {...}}) cut a cell down for
    the CPU tests; both the program and the judge see the cut."""
    t_start = process_start()
    cell = find_cell(name, root)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise CellError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{cell.name} needs {cell.chips} cards, "
                            f"{torch.cuda.device_count()} visible")
    from svnicp_tpu_torch import config as pconfig
    from svnicp_tpu_torch.runtime.pipeline import LIOPipeline

    from lio_bench.harness import drive as drive_mod
    from lio_bench.harness import judge, window
    from lio_bench.harness.trace import Tracer

    overrides = overrides or {}
    cfg_d = merge(config_dict(cell), overrides.get("pipeline"))
    ref = reference(cell)
    cfg = pconfig.from_dict(cfg_d)
    tr = merge(traffic(cell, root), overrides.get("traffic"))
    lim = limits(cell, root)
    n_frames = drive_mod.frame_count(tr, seconds)
    judge.check_supported(ref, cfg_d)
    drv = drive_mod.make_drive(tr, seed, n_frames, cfg.icp.particle_count,
                               *drive_mod.prior_box(cfg_d["icp"]))
    parts = torch.from_numpy(drv.particles).to(device)

    def make_pipe():
        return LIOPipeline(cfg, device=device)

    warm = int(tr["warmup_frames"])
    mods = {m["name"]: metric_module(m["name"], root) for m in cell.metrics
            if (m in cell.manifest["per_layer"]) == trace}
    probes_state: dict = {}
    tracer = None
    if trace:
        probes = [(lambda mod=mod, n=n: mod.probe(probes_state.setdefault(n, {}), cfg))
                  for n, mod in mods.items() if hasattr(mod, "probe")]
        tracer = Tracer(probes, cuda=device == "cuda")
    first_pipe = window.warm_up(make_pipe, drv, parts, warm)
    if tracer is not None:
        # the profiler's own first start costs seconds: pay it in set-up
        with Tracer(cuda=device == "cuda")():
            window.Feeder(make_pipe(), drv, parts).scan(0)
    if device == "cuda":
        torch.cuda.synchronize()
    trace_kw = dict(tracer=tracer, trace_start=int(tr["trace_start"]),
                    trace_frames=int(tr["trace_frames"]))
    cpu0 = cpu_times()
    if tr["kind"] == "live":
        setup_s = time.perf_counter() - t_start
        win = window.live(first_pipe, drv, parts, warm, float(tr["rate_hz"]), seconds,
                          **trace_kw)
    else:
        del first_pipe
        setup_s = time.perf_counter() - t_start
        win = window.replay(make_pipe, drv, parts, seconds, **trace_kw)
    cpu1 = cpu_times()
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    summary = tracer.summary() if tracer is not None and tracer.prof is not None else None

    run = Run(cell, cfg_d, tr, win, setup_s, summary, probes_state)
    metrics = {}
    for m in cell.metrics:
        if m["name"] not in mods:
            continue
        v = mods[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the judged pass: the last whole one, else the one the window ended in
    pipes = win.passes
    judged = pipes[-1]
    if tr["kind"] == "replay" and len(pipes) > 1:
        judged = pipes[-2]
    outs = pass_outputs(judged)
    del pipes, judged, win.passes[:]
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.judge(ref, cfg_d, drv, outs, seed, int(tr["check_frames"]), device)
    ok, lines = judge.verdict(numbers, lim)
    attempted = len(win.frames)
    failed = sum(not f.ok for f in win.frames)
    correct = ok and failed == 0 and numbers["_ref_failed"] == 0
    iters = sum(f.iterations for f in win.frames) / max(attempted, 1)
    thirds = [sum(1 for f in win.frames
                  if win.t_open + j * win.seconds / 3 <= f.t_done
                  < win.t_open + (j + 1) * win.seconds / 3) / (win.seconds / 3)
              for j in range(3)]
    steal = (cpu1[1] - cpu0[1]) / max(cpu1[0] - cpu0[0], 1.0)
    log("[lio_bench] frames/s by thirds of the window: "
        + " ".join(f"{x:.2f}" for x in thirds) + f"; CPU steal {100 * steal:.2f}%")
    log(f"[lio_bench] {cell.name} seed {seed}: {attempted} frames in "
        f"{win.seconds:.3f} s, {iters:.3f} iterations a frame, {failed} failed; "
        f"judged pass of {outs.frames} frames ({numbers['_sampled']} registrations), "
        f"ATE {judge.ate(outs, drv.trans):.4f} m; set-up {setup_s:.2f} s; "
        f"device {nvidia_smi() if device == 'cuda' else device}")
    log("[lio_bench] not compared: " + ", ".join(
        f"{n} {numbers[n]:.6g}" for n in judge.NAMES + judge.COUNTS if n not in lim))
    if found:
        raise CellError(f"modules of JAX or the JAX package were loaded: {found}")
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else str(device),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    checks = {n: {"value": _num(numbers[n]), "limit": float(lim[n])}
              for n in judge.NAMES + judge.COUNTS if n in lim}
    checks["failed_frames"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    for line in lines + [f"failed_frames {failed} {'<=' if failed == 0 else '>'} 0"]:
        log(line)
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of lio_bench.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except CellError as e:
        print(f"lio_bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0

