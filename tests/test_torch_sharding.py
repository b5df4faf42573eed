"""The port's sharded registration (`parallel/sharding.py`) against the JAX
package's `parallel/sharding.py` on the suite's simulated 8-device CPU mesh,
the port's in-process mesh with its 8 shards on `cpu` (plain ops: the XLA
route, use_pallas off).

The problem is the JAX test's (tests/test_sharding.py `make_problem`, built
in numpy here): a floor and two walls, 768 points with 1 cm noise, the
target the source moved by a known pose; the JAX package's own initial
particles. Tolerances:
- float64 with the early stop off, 12 iterations: particles, mean, var and
  cov to 1e-9 (what is left is the order of the point-axis sums, ~1e-15,
  grown by the coupled iterations; measured below 1e-11), on meshes (2,4),
  (4,2), (1,8) and (8,1) for both residuals, with svn_full_grad, with the
  MAP prior, and the history stack to 1e-9;
- float32 on the (2,4) mesh at the JAX test's own tolerances: 2e-4 on the
  mean, var to 5% relative, the same iterations;
- the port's sharded result against its own single-device `svn.register`,
  as `test_sharded_matches_single_device` does for JAX: 2e-4 on the mean
  in float32 and 1e-9 in float64;
- `auto_axes` and `make_mesh` as the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.config import SteinICPConfig as JCfg
from svnicp_tpu.core import svn as jsvn
from svnicp_tpu.parallel import sharding as jsh
from svnicp_tpu_torch.config import SteinICPConfig as TCfg
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import svn as tsvn
from svnicp_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

BASE = dict(particle_count=8, iterations=12, lr=1.0, max_dist=2.8, knn_count=16,
            early_stop=False)


def make_problem(n=768, seed=42):
    rng = np.random.default_rng(seed)
    n3 = n // 3
    floor = np.stack([rng.uniform(-10, 10, n3), rng.uniform(-10, 10, n3), np.zeros(n3)], 1)
    wall1 = np.stack([rng.uniform(-10, 10, n3), np.full(n3, 8.0), rng.uniform(0, 4, n3)], 1)
    wall2 = np.stack([np.full(n - 2 * n3, -6.0), rng.uniform(-10, 10, n - 2 * n3),
                      rng.uniform(0, 4, n - 2 * n3)], 1)
    cloud = np.concatenate([floor, wall1, wall2])
    cloud += rng.normal(scale=0.01, size=cloud.shape)
    r, t = tgeo.se3_exp(torch.tensor([0.25, -0.15, 0.08, 0.02, -0.02, 0.04],
                                     dtype=torch.float64))
    target = cloud @ r.numpy().T + t.numpy()
    return cloud, target


def _init(seed=0, p=8):
    cfg = JCfg(particle_count=p)
    return np.asarray(jsvn.init_particles_uniform(jax.random.PRNGKey(seed), p,
                                                  cfg.init_lb, cfg.init_ub))


def _args(dtype, seed=0):
    src, tgt = make_problem()
    n = len(src)
    return dict(source=src.astype(dtype), src_valid=np.ones(n, bool),
                target=tgt.astype(dtype), tgt_valid=np.ones(n, bool),
                r0=np.eye(3, dtype=dtype), t0=np.zeros(3, dtype),
                init=_init(seed).astype(dtype))


_jax_sharded = jax.jit(jsh.sharded_register, static_argnums=(0, 1),
                       static_argnames=("history",))


def _jax(axes, over, a, history=False):
    cfg = JCfg(**{**BASE, **over})
    x64 = a["source"].dtype == np.float64
    with jax.enable_x64(x64):
        args = [jnp.asarray(a[k]) for k in a]
        if axes is None:
            fn = jsvn.register_with_history if history else jsvn.register
            out = fn(cfg, *args)
        else:
            # jitted as the JAX pipeline calls it (eager shard_map runs op by op)
            out = _jax_sharded(jsh.make_mesh(*axes), cfg, *args, history=history)
        return jax.tree.map(np.asarray, out)


def _port(axes, over, a, history=False):
    cfg = TCfg(**{**BASE, **over})
    args = [torch.from_numpy(a[k]) for k in a]
    if axes is None:
        fn = tsvn.register_with_history if history else tsvn.register
        return fn(cfg, *args)
    mesh = tsh.make_mesh(*axes, devices=["cpu"] * 8)
    return tsh.sharded_register(mesh, cfg, *args, history=history)


def _close(port, want, atol, rtol=0.0):
    for name in ("particles", "mean", "var", "cov", "grad_norm"):
        np.testing.assert_allclose(getattr(port, name).numpy(), getattr(want, name),
                                   atol=atol, rtol=rtol, err_msg=name)
    assert int(port.iterations) == int(want.iterations)


AXES = [(2, 4), (4, 2), (1, 8), (8, 1)]
RESIDUALS = {"point": {}, "plane": dict(residual="point_to_plane")}


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("residual", RESIDUALS)
def test_float64_matches_jax(axes, residual):
    a = _args(np.float64)
    _close(_port(axes, RESIDUALS[residual], a), _jax(axes, RESIDUALS[residual], a),
           atol=1e-9)


@pytest.mark.parametrize("over", [dict(svn_full_grad=True, iterations=30),
                                  dict(prior_information=True, residual="point_to_plane",
                                       convergence_metric="mean_delta")],
                         ids=["svn_full_grad", "prior_information"])
def test_float64_options_match_jax(over):
    a = _args(np.float64, seed=1)
    _close(_port((2, 4), over, a), _jax((2, 4), over, a), atol=1e-9)


def test_float64_history_matches_jax():
    """Sharded save_particles: the [iters,P,6] stack, all-gathered every
    iteration, with the early stop on (updates frozen after it)."""
    over = dict(early_stop=True, convergence_metric="mean_delta",
                convergence_threshold=1e-3, iterations=30)
    a = _args(np.float64)
    port, hist = _port((4, 2), over, a, history=True)
    want, want_hist = _jax((4, 2), over, a, history=True)
    assert tuple(hist.shape) == (30, 8, 6)
    _close(port, want, atol=1e-9)
    assert int(port.iterations) < 30
    np.testing.assert_allclose(hist.numpy(), want_hist, atol=1e-9)
    np.testing.assert_allclose(hist[-1].numpy(), port.particles.numpy(), atol=0)


def test_float32_matches_jax_at_its_tolerances():
    """The JAX test's float32 envelope (tests/test_sharding.py): the psum
    order differs between the packages as it does between JAX's sharded
    and single-device runs."""
    a = _args(np.float32)
    port, want = _port((2, 4), {}, a), _jax((2, 4), {}, a)
    np.testing.assert_allclose(port.mean.numpy(), want.mean, atol=2e-4)
    np.testing.assert_allclose(port.var.numpy(), want.var, rtol=0.05, atol=1e-6)
    assert int(port.iterations) == int(want.iterations)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-4), (np.float64, 1e-9)])
def test_sharded_matches_the_ports_single_device(dtype, atol):
    a = _args(dtype)
    out, ref = _port((2, 4), {}, a), _port(None, {}, a)
    np.testing.assert_allclose(out.mean.numpy(), ref.mean.numpy(), atol=atol)
    np.testing.assert_allclose(out.var.numpy(), ref.var.numpy(), rtol=0.05, atol=1e-6)
    assert int(out.iterations) == int(ref.iterations)


def test_early_stop_is_the_same_on_every_shard():
    """Point-to-plane with the mean-drift stop: the pmean'd statistic is
    read on the host by every shard, and all leave on JAX's iteration."""
    over = dict(residual="point_to_plane", early_stop=True, iterations=30,
                convergence_metric="mean_delta", convergence_threshold=1e-3)
    a = _args(np.float64, seed=2)
    port, want = _port((2, 4), over, a), _jax((2, 4), over, a)
    assert 1 < int(port.iterations) < 30
    _close(port, want, atol=1e-9)


def test_auto_axes_and_make_mesh():
    for n, p in ((8, 64), (8, 4), (8, 1), (4, 64), (1, 64), (6, 4)):
        assert tsh.auto_axes(n, p) == jsh.auto_axes(n, p)
    mesh = tsh.make_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == {"particle": 2, "point": 4}
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        tsh.make_mesh(2, 4)
    with pytest.raises(ValueError, match="need 2 devices"):
        tsh.make_mesh(1, 2, devices=["cpu"])


def test_a_failing_shard_raises_in_the_caller():
    """An exception in one shard breaks the others' barrier; the caller
    gets the real error, not a hang or BrokenBarrierError."""
    mesh = tsh.make_mesh(2, 2, devices=["cpu"] * 4)

    def body(coll, x):
        if coll.axis_index("point") == 1:
            raise RuntimeError("shard failed")
        return (coll.psum(x, "point"),)

    with pytest.raises(RuntimeError, match="shard failed"):
        mesh.run(body, (torch.ones(4),), ("point",), (None,))


def test_collectives_in_one_process():
    """psum / pmean / all_gather / ppermute over both axes of a (2,4)
    mesh, shard values tagged by their coordinates."""
    mesh = tsh.make_mesh(2, 4, devices=["cpu"] * 8)

    def body(coll, x):
        i, j = coll.axis_index("particle"), coll.axis_index("point")
        v = torch.tensor([10.0 * i + j], dtype=torch.float64)
        return (coll.psum(v, "point"), coll.pmean(v, "particle"),
                coll.all_gather(v, "point", tiled=True),
                coll.ppermute(v, "point"), coll.psum(j, "point"), x + 0)

    outs = mesh.run(body, (torch.arange(8.0),), ("point",), (None, None, None, "point",
                                                            None, "point"))
    assert outs[0].item() == 6.0          # shard (0, *): 0+1+2+3
    assert outs[1].item() == 5.0          # shard (*, 0): (0 + 10) / 2
    assert outs[2].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert outs[3].tolist() == [3.0, 0.0, 1.0, 2.0]   # member m holds m-1's
    assert outs[4] == 6
    assert outs[5].tolist() == list(range(8))


def test_degenerate_set_skips_the_loop_on_every_shard():
    """Fewer than 6 source points with any candidate over ALL point shards:
    no epoch, grad_norm +inf (the pipeline's failed alignment)."""
    a = _args(np.float64)
    a["src_valid"][:] = False
    a["src_valid"][:4] = True
    port = _port((2, 4), {}, a)
    assert int(port.iterations) == 0 and not np.isfinite(port.grad_norm.item())
