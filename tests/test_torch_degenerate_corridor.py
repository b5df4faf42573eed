"""The paper's observability claim on the port: the corridor.

The JAX package holds the claim in tests/test_degenerate_pipeline.py: in
under-constrained geometry the SVN particle spread grows along the
unobservable directions, the ESKF then leans on the IMU there, and the
filter stays calibrated. This file and test_torch_degenerate_scenes.py
hold the port to it at that test's own configuration (`kf_cfg` as it is:
float64, P=8, K=16, source 1024, target 16384, map 65536, the KF with its
IMU noise), its `DegenerateWorld` scenes, `straight_trajectory`, 10 frames
and 4,000-point scans, the data not resized and no threshold loosened:
- parity: the JAX package's run (under enable_x64) and the port's with
  JAX's particle draws fed as `init_particles`, frame by frame: identical
  iterations, align_ok and first-frame map points, and the poses, var_icp
  and kf_cov_diag to the tolerances of TOL. At equilibrium (60 Stein
  iterations a frame, no early stop) the dynamics are chaotic: one frame
  amplifies a difference in the last place about a thousandfold, so the
  JAX package leaves its own run when one IMU sample moves by one unit in
  the last place, as the port's free run leaves it by frame 6
  (`test_the_reference_is_chaotic_at_equilibrium` prints both). There
  every frame after the bootstrap starts from the JAX package's state
  before it (`convert.state_from_numpy`), and one frame's amplification is
  what the tolerance holds: measured at most 7.7e-10 m, a relative 5.1e-8
  of var_icp and 2.7e-8 of kf_cov_diag (corridor; tunnel 1.2e-11 m, 6.1e-10,
  5.0e-10; plane 2.4e-16 m, 2.6e-12, 1.7e-12), held to 1e-8 m and 1e-6. The
  early-stopped run is not chaotic and runs free, with JAX's draws only:
  measured 2.2e-16 m, 3.1e-14 and 2.0e-14, held to 1e-12 m and 1e-11;
- the claim: the JAX test's own assertions on the port's own draws
  (the prior-relative ratios r, containment, align_ok, the x-dominant
  kf_cov_diag, the lateral NEES between 1e-3 and 60).
Here the corridor: two walls and a floor along x, x unobservable.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import test_degenerate_pipeline as jdeg  # noqa: E402
from svnicp_tpu.io import datasets as jdatasets  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch import convert  # noqa: E402
from svnicp_tpu_torch.core.imu import GRAVITY  # noqa: E402
from svnicp_tpu_torch.io import datasets  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("pose_t", "var_icp", "kf_cov_diag")
# (atol, rtol) of each field in the parity runs (see the module docstring)
TOL = {"equilibrium": {"pose_t": (1e-8, 0.0), "var_icp": (1e-18, 1e-6),
                       "kf_cov_diag": (0.0, 1e-6)},
       "early_stop": {"pose_t": (1e-12, 0.0), "var_icp": (1e-18, 1e-11),
                      "kf_cov_diag": (0.0, 1e-11)}}


def _jax_state_fields(state) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in leaves}


def jax_run(kind: str, cfg, perturb: bool = False) -> dict:
    """The JAX package's run of a scene, as its `run_world` makes it ->
    the fields per frame, iterations, align_ok, the first frame's map
    points, the state before each frame and the particle draws of each
    frame after the bootstrap. `perturb` moves one IMU sample's vertical
    acceleration (frame 1's) by one unit in the last place."""
    times, rots, trans = jdeg.straight_trajectory()
    world = jdatasets.DegenerateWorld(kind)
    rng = np.random.default_rng(0)
    states = []
    with jax.enable_x64(True):
        pipe = jdeg.pl.LIOPipeline(cfg)
        for j, (t, acc, gyro) in enumerate(
                jdatasets.synthetic_imu(times, rots, trans, jdeg.GRAVITY)):
            if perturb and j == 1:
                acc = np.array(acc, np.float64)
                acc[2] = np.nextafter(acc[2], np.inf)
            pipe.feed_imu(t, acc, gyro)
        for i in range(jdeg.N_FRAMES):
            states.append(_jax_state_fields(pipe.state))
            pipe.feed_scan(float(times[i]),
                           world.scan_at(rng, rots[i], trans[i], n_points=4000))
        out = {f: np.stack([np.asarray(getattr(o, f)) for o in pipe.outputs])
               for f in FIELDS}
        icp = cfg.icp
        lb = jnp.asarray(icp.init_lb, jnp.float64)
        ub = jnp.asarray(icp.init_ub, jnp.float64)
        key = jax.random.PRNGKey(cfg.seed)
        draws = [None]
        for _ in range(1, jdeg.N_FRAMES):
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
            draws.append(np.array(lb + (ub - lb) * u))
    out["iters"] = [int(o.icp_iterations) for o in pipe.outputs]
    out["align_ok"] = [bool(o.align_ok) for o in pipe.outputs]
    out["map_points0"] = int(pipe.outputs[0].map_points)
    out["states"] = states
    out["draws"] = draws
    return out


def port_run(kind: str, jcfg, want: dict | None = None, restart: bool = False):
    """`run_world` on the port (its own DegenerateWorld, the JAX package's
    configuration converted): with `want`, the JAX run's draws fed; with
    `restart` too, every frame after the bootstrap starts from the JAX
    package's state before it."""
    cfg = tcfg.from_dict(dataclasses.asdict(jcfg))
    times, rots, trans = jdeg.straight_trajectory()
    world = datasets.DegenerateWorld(kind)
    rng = np.random.default_rng(0)
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    for t, acc, gyro in datasets.synthetic_imu(times, rots, trans, GRAVITY):
        pipe.feed_imu(t, acc, gyro)
    for i in range(jdeg.N_FRAMES):
        if restart and i > 0:
            pipe.state = convert.state_from_numpy(want["states"][i], "cpu")
        pipe.feed_scan(float(times[i]),
                       world.scan_at(rng, rots[i], trans[i], n_points=4000),
                       init_particles=None if want is None else want["draws"][i])
    pipe.close()
    return pipe, trans


def assert_parity(pipe, want: dict, mode: str) -> dict:
    """The port's run against the JAX package's, frame by frame -> the
    largest absolute and relative differences per field."""
    assert [o.icp_iterations for o in pipe.outputs] == want["iters"]
    assert [o.align_ok for o in pipe.outputs] == want["align_ok"]
    assert int(pipe.outputs[0].map_points) == want["map_points0"]
    got = {f: np.stack([getattr(o, f).numpy() for o in pipe.outputs]) for f in FIELDS}
    seen = {f: (np.abs(got[f] - want[f]).max(),
                (np.abs(got[f] - want[f]) / np.abs(want[f]).clip(1e-300)).max())
            for f in FIELDS}
    print(f"{mode}: largest (abs, rel) differences from the JAX package: {seen}")
    for f in FIELDS:
        atol, rtol = TOL[mode][f]
        np.testing.assert_allclose(got[f], want[f], atol=atol, rtol=rtol, err_msg=f)
    return seen


def median_var(pipe):
    """jdeg.median_var on the port's outputs."""
    return np.median(np.stack([o.var_icp.numpy() for o in pipe.outputs[1:]]), axis=0)


def errors(pipe, trans):
    est = np.stack([o.pose_t.numpy() for o in pipe.outputs])
    return est - (trans - trans[0])


@pytest.fixture(scope="module")
def jax_equilibrium():
    return jax_run("corridor", jdeg.kf_cfg(equilibrium=True))


@pytest.fixture(scope="module")
def jax_early_stop():
    return jax_run("corridor", jdeg.kf_cfg())


def test_scans_and_imu_are_the_jax_packages():
    """The port's corridor scans and IMU samples are the JAX package's,
    byte for byte, so both runs see the same data."""
    times, rots, trans = jdeg.straight_trajectory()
    mine = datasets.DegenerateWorld("corridor")
    theirs = jdatasets.DegenerateWorld("corridor")
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(3):
        a = mine.scan_at(ra, rots[i], trans[i], n_points=4000)
        b = theirs.scan_at(rb, rots[i], trans[i], n_points=4000)
        assert a.tobytes() == b.tobytes()
    imu_t = datasets.synthetic_imu(times, rots, trans, GRAVITY)
    imu_j = jdatasets.synthetic_imu(times, rots, trans, jdeg.GRAVITY)
    for a, b in zip(imu_t, imu_j):
        np.testing.assert_array_equal(np.hstack(a), np.hstack(b))


def test_equilibrium_parity(jax_equilibrium):
    """Every frame from the JAX package's state before it, with its draws."""
    pipe, _ = port_run("corridor", jdeg.kf_cfg(equilibrium=True), jax_equilibrium,
                       restart=True)
    assert jax_equilibrium["iters"][1:] == [60] * (jdeg.N_FRAMES - 1)
    assert_parity(pipe, jax_equilibrium, "equilibrium")


def test_early_stop_parity(jax_early_stop):
    """The early-stopped run free, with the JAX package's draws only."""
    pipe, _ = port_run("corridor", jdeg.kf_cfg(), jax_early_stop)
    assert max(jax_early_stop["iters"]) > 1
    assert_parity(pipe, jax_early_stop, "early_stop")


def test_the_reference_is_chaotic_at_equilibrium(jax_equilibrium):
    """Why the equilibrium parity restarts each frame from the JAX state:
    60 Stein iterations a frame without early stop amplify a difference of
    one unit in the last place about a thousandfold a frame, so the JAX
    package leaves its own run when one IMU sample moves by one unit in the
    last place, as the port's free run leaves it (printed)."""
    moved = jax_run("corridor", jdeg.kf_cfg(equilibrium=True), perturb=True)
    free, _ = port_run("corridor", jdeg.kf_cfg(equilibrium=True), jax_equilibrium)
    want = jax_equilibrium["var_icp"]
    rel = {name: (np.abs(got - want) / np.abs(want).clip(1e-300)).max(axis=1)
           for name, got in (("JAX, one IMU ulp", moved["var_icp"]),
                             ("port, free", np.stack([o.var_icp.numpy()
                                                      for o in free.outputs])))}
    for name, r in rel.items():
        print(f"var_icp relative difference per frame from the JAX run, {name}: {r}")
    assert rel["JAX, one IMU ulp"][1] < 1e-9 and rel["JAX, one IMU ulp"][-4:].max() > 1e-2


class TestCorridor:
    """The JAX package's TestCorridor on the port's own draws."""

    def test_anisotropic_variance_and_containment(self):
        pipe, trans = port_run("corridor", jdeg.kf_cfg(equilibrium=True))
        r = median_var(pipe) / jdeg.prior_var()
        print(f"corridor r = {r}")
        assert r[0] > 0.15, f"x did not retain prior spread: {r}"
        assert r[1] < 0.05, f"y not constrained: {r}"
        assert r[5] < 0.01, f"yaw not constrained: {r}"
        assert r[0] > 10.0 * r[1], f"x not dominant over y: {r}"
        err = errors(pipe, trans)
        assert np.isfinite(err).all()
        assert np.abs(err[:, 1]).max() < 0.15, err[:, 1]
        assert np.abs(err[:, 2]).max() < 0.15, err[:, 2]
        assert np.abs(err[:, 0]).max() < 1.0, err[:, 0]
        assert all(bool(o.align_ok) for o in pipe.outputs[1:])

    @pytest.fixture(scope="class")
    def early_stop_run(self):
        return port_run("corridor", jdeg.kf_cfg())

    def test_kf_covariance_reflects_observability(self, early_stop_run):
        pipe, _ = early_stop_run
        kd = np.stack([o.kf_cov_diag.numpy() for o in pipe.outputs[2:]])
        pos = np.median(kd[:, 0:3], axis=0)
        assert pos[0] > 2.0 * max(pos[1], pos[2]), pos

    def test_lateral_nees_calibrated(self, early_stop_run):
        pipe, trans = early_stop_run
        err = errors(pipe, trans)
        kd = np.stack([o.kf_cov_diag.numpy() for o in pipe.outputs])
        vals = (err[2:, 1] ** 2 / kd[2:, 1]) + (err[2:, 2] ** 2 / kd[2:, 2])
        mean_nees = float(np.mean(vals))       # chi2(2) expectation = 2
        assert 1e-3 < mean_nees < 60.0, mean_nees
