"""The port's scaling ladder (`svnicp_tpu_torch.bench_scaling`) against the
JAX package's `bench_scaling.py`.

A small ladder (P=16, 256 source points, 2,048 target points, 5
iterations; the meshes (1,1), (2,1), (4,1), (8,1)) on the port's in-process
CPU mesh, every shard on `cpu`, equals the JAX package's `sharded_register`
on its simulated 8-device CPU mesh (called through `jax.jit`, as its
pipeline calls it), on the same problem and the port's particle draws:
particles, mean, var and cov to 1e-9 in float64 (what is left is the order
of the point-axis sums, grown by the coupled iterations). In float32 every
rung stays within 1e-4 m in translation of the (1,1) rung, as phase 19 of
chip_smoke.py holds it on the card. The JSON lines carry the JAX line's
fields, and `cards` and `backend`.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.config import SteinICPConfig as JCfg
from svnicp_tpu.parallel import sharding as jsh
from svnicp_tpu_torch import bench_scaling as tbs
from svnicp_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

P, POINTS, TARGET, ITERS = 16, 256, 2048, 5
SMALL = ["--particles", str(P), "--points", str(POINTS), "--target", str(TARGET),
         "--iters", str(ITERS), "--reps", "1", "--device", "cpu"]
# the JAX line's fields (bench_scaling.py:97-106)
JAX_FIELDS = {"metric", "mesh", "devices", "backend", "simulated", "value", "unit",
              "scaling_efficiency"}

_jax_sharded = jax.jit(jsh.sharded_register, static_argnums=(0, 1))


def test_the_ladder_is_the_jax_package_s():
    assert tbs.ladder(8, P) == [(1, 1)] + [jsh.auto_axes(d, P) for d in (2, 4, 8)]
    assert tbs.ladder(8, 256) == [(1, 1), (2, 1), (4, 1), (8, 1)]
    assert tbs.ladder(2, 256) == [(1, 1), (2, 1)]


def test_the_problem_is_the_jax_package_s():
    """The clouds and configuration of bench_scaling.py:55-70."""
    cfg, args = tbs.problem(POINTS, TARGET, P, ITERS, device="cpu")
    jcfg = JCfg(particle_count=P, iterations=ITERS, lr=1.0, max_dist=3.0, knn_count=100,
                early_stop=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(POINTS, 3)).astype(np.float32) * 20
    np.testing.assert_array_equal(args[0].numpy(), cloud)
    from svnicp_tpu.core import geometry as jgeo
    r, t = jgeo.se3_exp(jnp.asarray(tbs.POSE))
    target = np.asarray(jgeo.transform_points(r, t, jnp.asarray(
        rng.normal(size=(TARGET, 3)).astype(np.float32) * 20)))
    np.testing.assert_allclose(args[2].numpy(), target, atol=2e-5)
    lo, hi = np.asarray(cfg.init_lb), np.asarray(cfg.init_ub)
    init = args[6].numpy()
    assert init.shape == (P, 6) and ((init >= lo - 1e-7) & (init <= hi + 1e-7)).all()


def test_float64_ladder_matches_jax():
    cfg, args = tbs.problem(POINTS, TARGET, P, ITERS, dtype=torch.float64, device="cpu")
    jcfg = JCfg(**dataclasses.asdict(cfg))
    for shape in tbs.ladder(8, P):
        n = shape[0] * shape[1]
        port = tsh.sharded_register(tsh.make_mesh(*shape, devices=["cpu"] * n), cfg,
                                    *args)
        with jax.enable_x64(True):
            want = jax.tree.map(np.asarray, _jax_sharded(
                jsh.make_mesh(*shape), jcfg, *[jnp.asarray(a.numpy()) for a in args]))
        for name in ("particles", "mean", "var", "cov", "grad_norm"):
            np.testing.assert_allclose(getattr(port, name).numpy(), getattr(want, name),
                                       atol=1e-9, err_msg=f"{shape} {name}")
        assert int(port.iterations) == int(want.iterations) == ITERS


def test_main_prints_a_line_per_rung(capsys):
    rows = tbs.main(SMALL)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r[0] for r in rows] == lines
    assert [x["mesh"] for x in lines] == ["1x1", "2x1", "4x1", "8x1"]
    for line in lines:
        assert JAX_FIELDS | {"cards"} == set(line)
        assert line["backend"] == "cpu" and line["cards"] == 1
        assert line["simulated"] == (line["devices"] > 1)
        assert line["unit"] == "s/align" and line["value"] > 0
    assert lines[0]["scaling_efficiency"] == 1.0
    base = rows[0][1].mean[:3]
    for _, out in rows[1:]:
        assert float((out.mean[:3] - base).abs().max()) < 1e-4


def test_main_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbs.main(SMALL[:-2])


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
