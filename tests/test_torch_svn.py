"""One frame's registration through the port (`svn.register`) against the JAX
package's, at P=8, B=256, K=32:

- float32 against the JAX path with its Pallas kernels in interpret mode
  (bucketed candidates, plane moments, Stein update; the pattern of
  tests/test_nn_pallas.py): the ensemble mean to 1e-4 and the same number
  of iterations, on three noise-free planes whose ensemble mean converges
  crisply (on the noisy synthetic scan below the f32 stop statistic hovers
  at the threshold, and f32 runs of the JAX package itself stop anywhere
  between 8 and 40 iterations depending on rounding);
- float64 against the JAX XLA path under jax.enable_x64, on two noisy scans
  of a synthetic world: to 1e-6 and the same number of iterations.
The same for the point-to-point residual at the geode_alpha operating
point's P=10 (K=20, padded to 24 slots by both): float32 against Pallas
interpret on the planes (to 1e-4, same iterations; at its grad-norm
stop of 2e-3, where the planes' ensemble crosses the threshold steeply),
and float64 against the XLA path on the noisy scans at geode's 5e-4, with
P=10 and the single-particle path.
The Pallas kernels and the port both average tied minima while the XLA path
takes the first; the scans are continuous random samples, where ties have
measure zero.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from svnicp_tpu.config import SteinICPConfig as JaxICPConfig
from svnicp_tpu.core import svn as jsvn
from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import svn as tsvn
from svnicp_tpu_torch.io import datasets

torch.set_num_threads(2)

P, B, K = 8, 256, 32
ICP = dict(method="svn", residual="point_to_plane", particle_count=P,
           iterations=40, max_dist=3.0, knn_count=K, early_stop=True,
           convergence_metric="mean_delta", convergence_threshold=1e-3)
# the port runs only the kernel path (tied minima averaged); the JAX configs
# keep use_pallas off and so take the XLA path unless a test asks otherwise
PORT_ICP = dict(ICP, use_pallas=True)


@pytest.fixture(scope="module")
def problem():
    """Scan 1 (B points, its sensor frame) against scan 0 (4096 points, the
    map frame) of a synthetic world, guess = true relative pose perturbed."""
    world = datasets.SyntheticWorld(extent=30.0, seed=1)
    times, rots, trans = datasets.synthetic_trajectory(2, dt=0.1, speed=3.0, seed=2)
    rng = np.random.default_rng(5)
    target = world.scan_at(rng, rots[0], trans[0], n_points=4096)
    source = world.scan_at(rng, rots[1], trans[1], n_points=B)
    r_rel = rots[0].T @ rots[1]
    t_rel = rots[0].T @ (trans[1] - trans[0])
    guess_r = tgeo.so3_exp(torch.tensor([0.0, 0.0, 0.01], dtype=torch.float64)
                           ).numpy() @ r_rel
    guess_t = t_rel + np.array([0.05, -0.03, 0.01])
    lb, ub = np.array(SteinICPConfig().init_lb), np.array(SteinICPConfig().init_ub)
    init = lb + (ub - lb) * rng.random((P, 6))
    tv = np.ones(len(target), bool)
    tv[-200:] = False
    return dict(source=source, src_valid=np.ones(B, bool), target=target,
                tgt_valid=tv, r0=guess_r, t0=guess_t, init=init)


@pytest.fixture(scope="module")
def planes():
    """Three orthogonal planes, 256 source samples and 4096 target samples
    of the same planes moved by a known transform."""
    rng = np.random.default_rng(2)

    def sample(n):
        u = rng.uniform(-6, 6, size=(n, 3))
        which = rng.integers(0, 3, n)
        u[which == 0, 2] = 0.0
        u[which == 1, 1] = 4.0
        u[which == 2, 0] = -3.0
        return u

    src, tgt = sample(B), sample(4096)
    xi = torch.tensor([0.1, -0.05, 0.02, 0.01, 0.0, 0.02], dtype=torch.float64)
    r, t = (x.numpy() for x in tgeo.se3_exp(xi))
    lb, ub = np.array(SteinICPConfig().init_lb), np.array(SteinICPConfig().init_ub)
    init = lb + (ub - lb) * rng.random((P, 6))
    return dict(source=src, src_valid=np.ones(B, bool), target=tgt @ r.T + t,
                tgt_valid=np.ones(4096, bool), r0=np.eye(3), t0=np.zeros(3),
                init=init)


def _jax_args(pb, dtype):
    return [jnp.asarray(np.asarray(pb[k]), dtype) if pb[k].dtype != bool
            else jnp.asarray(pb[k]) for k in
            ("source", "src_valid", "target", "tgt_valid", "r0", "t0", "init")]


def _torch_args(pb, dtype):
    return [torch.tensor(pb[k]) if pb[k].dtype == bool
            else torch.tensor(np.asarray(pb[k]), dtype=dtype) for k in
            ("source", "src_valid", "target", "tgt_valid", "r0", "t0", "init")]


def test_register_f32_matches_pallas_interpret(planes):
    cfg = JaxICPConfig(**ICP, use_pallas=True)
    os.environ["SVNICP_PALLAS_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jsvn.register(cfg, *_jax_args(planes, jnp.float32))
    finally:
        del os.environ["SVNICP_PALLAS_INTERPRET"]
    got = tsvn.register(SteinICPConfig(**PORT_ICP), *_torch_args(planes, torch.float32))
    assert got.iterations == int(want.iterations)
    assert 1 < got.iterations < ICP["iterations"]
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-4)


@pytest.mark.parametrize("prior", [False, True])
def test_register_f64_matches_xla_path(problem, prior):
    with jax.enable_x64(True):
        want = jsvn.register(JaxICPConfig(**ICP, prior_information=prior),
                             *_jax_args(problem, jnp.float64))
        want_mean = np.asarray(want.mean)
        want_iters = int(want.iterations)
        want_var = np.asarray(want.var)
    got = tsvn.register(SteinICPConfig(**PORT_ICP, prior_information=prior),
                        *_torch_args(problem, torch.float64))
    assert got.iterations == want_iters
    np.testing.assert_allclose(got.mean.numpy(), want_mean, atol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), want_var, rtol=1e-5, atol=1e-9)


def test_degenerate_set_skips_the_loop(problem):
    """Fewer than 6 source points with any candidate: no iteration runs and
    grad_norm stays +inf, as in the JAX align."""
    args = _torch_args(problem, torch.float64)
    args[3] = torch.zeros_like(args[3])          # no valid target
    got = tsvn.register(SteinICPConfig(**PORT_ICP), *args)
    assert got.iterations == 0 and torch.isinf(got.grad_norm)


@pytest.mark.parametrize("prior", [False, True])
def test_single_particle(problem, prior):
    cfg = dataclasses.replace(SteinICPConfig(**PORT_ICP), particle_count=1,
                              prior_information=prior)
    args = _torch_args(problem, torch.float64)
    args[-1] = torch.zeros((1, 6), dtype=torch.float64)
    with jax.enable_x64(True):
        jcfg = dataclasses.replace(JaxICPConfig(**ICP), particle_count=1,
                                   prior_information=prior)
        jargs = _jax_args(problem, jnp.float64)
        jargs[-1] = jnp.zeros((1, 6), jnp.float64)
        want = jsvn.register(jcfg, *jargs)
        want_mean, want_iters = np.asarray(want.mean), int(want.iterations)
    got = tsvn.register(cfg, *args)
    assert got.iterations == want_iters
    np.testing.assert_allclose(got.mean.numpy(), want_mean, atol=1e-6)


P2P = dict(method="svn", residual="point_to_point", particle_count=10,
           iterations=60, max_dist=3.0, knn_count=20, early_stop=True,
           convergence_threshold=5e-4)


def _with_draws(pb, p, seed=3):
    lb, ub = np.array(SteinICPConfig().init_lb), np.array(SteinICPConfig().init_ub)
    init = lb + (ub - lb) * np.random.default_rng(seed).random((p, 6))
    return dict(pb, init=init if p > 1 else np.zeros((1, 6)))


def test_point_to_point_f32_matches_pallas_interpret(planes):
    icp = dict(P2P, convergence_threshold=2e-3)
    pb = _with_draws(planes, icp["particle_count"])
    os.environ["SVNICP_PALLAS_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jsvn.register(JaxICPConfig(**icp, use_pallas=True),
                                 *_jax_args(pb, jnp.float32))
    finally:
        del os.environ["SVNICP_PALLAS_INTERPRET"]
    got = tsvn.register(SteinICPConfig(**icp, use_pallas=True),
                        *_torch_args(pb, torch.float32))
    assert got.iterations == int(want.iterations)
    assert 1 < got.iterations < icp["iterations"]
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-4)


@pytest.mark.parametrize("p", [1, 10])
def test_point_to_point_f64_matches_xla_path(problem, p):
    icp = dict(P2P, particle_count=p)
    pb = _with_draws(problem, p)
    with jax.enable_x64(True):
        want = jsvn.register(JaxICPConfig(**icp), *_jax_args(pb, jnp.float64))
        want_mean, want_var = np.asarray(want.mean), np.asarray(want.var)
        want_iters = int(want.iterations)
    got = tsvn.register(SteinICPConfig(**icp, use_pallas=True),
                        *_torch_args(pb, torch.float64))
    assert got.iterations == want_iters
    assert 1 < want_iters < icp["iterations"]
    np.testing.assert_allclose(got.mean.numpy(), want_mean, atol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), want_var, rtol=1e-5, atol=1e-9)
