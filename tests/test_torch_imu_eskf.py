"""The port's strapdown propagation and error-state Kalman filter against the
JAX package's (`svnicp_tpu.core.imu`, `svnicp_tpu.core.eskf`) on the same
random numpy inputs: a chain of propagations over random IMU samples, a
chain of ESKF predicts (reference and textbook transition) with an update
in between, and the filter built from the geode_alpha configuration. In
float64 to 1e-10; in float32 to rtol 1e-5 (and 1e-6 of the largest entry,
for entries that cancel to near zero)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg_mod
from svnicp_tpu.core import eskf as jeskf
from svnicp_tpu.core import geometry as jgeo
from svnicp_tpu.core import imu as jimu
from svnicp_tpu_torch import config as tcfg_mod
from svnicp_tpu_torch.core import eskf as teskf
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import imu as timu

torch.set_num_threads(2)

NOISE = dict(rot_rw=[0.0005817764, 0.0005817764, 0.0029088821],
             vel_rw=[0.8333333333] * 3, bg_std=[0.0000969627] * 3,
             ba_std=[0.005] * 3)
DTYPES = {"float64": (np.float64, jnp.float64, torch.float64),
          "float32": (np.float32, jnp.float32, torch.float32)}


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30))


def _samples(rng, n, np_dt):
    return [(np.asarray(rng.uniform(0.005, 0.02), np_dt),
             (rng.normal(size=3) + [0, 0, 9.8]).astype(np_dt),
             (0.3 * rng.normal(size=3)).astype(np_dt)) for _ in range(n)]


def _j(sample, jdt):
    return jimu.IMUSample(*(jnp.asarray(x, jdt) for x in sample))


def _t(sample, tdt):
    return timu.IMUSample(*(torch.tensor(x, dtype=tdt) for x in sample))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_propagate_matches_jax(rng, dtype):
    np_dt, jdt, tdt = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"):
        r0 = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5, jdt)))
        nav_j = jimu.NavState(jnp.asarray(r0), jnp.asarray(rng.normal(size=3), jdt),
                              jnp.asarray(rng.normal(size=3), jdt))
        nav_t = timu.NavState(*(torch.tensor(np.asarray(x)) for x in nav_j))
        samples = _samples(rng, 12, np_dt)
        for start, finish in zip(samples[:-1], samples[1:]):
            nav_j = jimu.propagate(nav_j, _j(start, jdt), _j(finish, jdt))
            nav_t = timu.propagate(nav_t, _t(start, tdt), _t(finish, tdt))
        for a, b in zip(nav_t, nav_j):
            assert a.dtype == tdt
            _close(a.numpy(), b, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_euler_zyx_matches_jax(rng, dtype):
    np_dt, jdt, _ = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"):
        for ang in rng.normal(size=(5, 3)).astype(np_dt):
            want = jgeo.euler_zyx_to_matrix(*(jnp.asarray(a, jdt) for a in ang))
            got = tgeo.euler_zyx_to_matrix(*(torch.tensor(a) for a in ang))
            _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("textbook_phi", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_predict_update_matches_jax(rng, dtype, textbook_phi):
    """Predicts over a window, an update with a random ICP correction and
    covariance, then more predicts: state, covariance, Q, gain and the
    random-walk variance all agree."""
    np_dt, jdt, tdt = DTYPES[dtype]
    lio = dict(estimator="kf", init_pos_std=[0.05, 0.06, 0.07],
               init_vel_std=[0.05, 0.05, 0.08], init_rot_std=[0.1, 0.2, 0.3])
    jcfg = jcfg_mod.from_dict({"imu": NOISE, "lio": lio})
    tcfg = tcfg_mod.from_dict({"imu": NOISE, "lio": lio})
    with jax.enable_x64(dtype == "float64"):
        st_j = jeskf.create(jcfg.lio, jcfg.imu, jdt)
        st_t = teskf.create(tcfg.lio, tcfg.imu, tdt)
        _close(st_t.cov.numpy(), st_j.cov, dtype)
        r0 = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(size=3) * 0.3, jdt)))
        st_j = st_j._replace(nav=jimu.NavState(jnp.asarray(r0), st_j.nav.t,
                                               jnp.asarray([1.0, 0.2, 0.0], jdt)),
                             bg=jnp.asarray(1e-3 * rng.normal(size=3), jdt),
                             ba=jnp.asarray(1e-2 * rng.normal(size=3), jdt))
        st_t = st_t._replace(nav=timu.NavState(torch.tensor(r0), st_t.nav.t,
                                               torch.tensor(np.asarray(st_j.nav.v))),
                             bg=torch.tensor(np.asarray(st_j.bg)),
                             ba=torch.tensor(np.asarray(st_j.ba)))
        samples = _samples(rng, 9, np_dt)

        def predicts(st_j, st_t, window):
            prev = window[0]
            for cur in window:
                st_j = jeskf.predict(st_j, _j(prev, jdt), _j(cur, jdt), jcfg.imu,
                                     textbook_phi=textbook_phi)
                st_t = teskf.predict(st_t, _t(prev, tdt), _t(cur, tdt), tcfg.imu,
                                     textbook_phi=textbook_phi)
                prev = cur
            return st_j, st_t

        st_j, st_t = predicts(st_j, st_t, samples[:5])
        a = rng.normal(size=(6, 6)) * 1e-3
        meas_cov = (a @ a.T + 1e-5 * np.eye(6)).astype(np_dt)
        corr = np.concatenate([0.05 * rng.normal(size=3),
                               0.01 * rng.normal(size=3)]).astype(np_dt)
        st_j = jeskf.update(st_j, jnp.asarray(meas_cov), jnp.asarray(corr))
        st_t = teskf.update(st_t, torch.tensor(meas_cov), torch.tensor(corr))
        assert float(torch.abs(st_t.gain).max()) > 0
        st_j, st_t = predicts(st_j, st_t, samples[5:])
        want = jax.tree_util.tree_leaves(st_j)
        got = jax.tree_util.tree_leaves(tuple(st_t), is_leaf=torch.is_tensor)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.dtype == tdt
            _close(g.numpy(), w, dtype)
        _close(teskf.random_walk_variance(st_t).numpy(),
               jeskf.random_walk_variance(st_j), dtype)


def test_geode_filter_starts_like_jax():
    path = pathlib.Path(__file__).resolve().parents[1] / "configs" / "geode_alpha.yaml"
    jcfg = jcfg_mod.from_yaml(str(path))
    tcfg = tcfg_mod.from_yaml(str(path))
    with jax.enable_x64(True):
        want = jeskf.create(jcfg.lio, jcfg.imu, jnp.float64)
    got = teskf.create(tcfg.lio, tcfg.imu, torch.float64)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-15)
