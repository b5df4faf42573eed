"""The ESKF's propagation over an IMU window: kernel F1's CUDA source
(`svnicp_tpu_torch/csrc/eskf_propagate.cu`) run on the CPU against the plain
per-sample route, and the pipeline's route split by device.

The source is built with g++ against the thread-per-lane emulation of
tests/test_torch_kernel_emulation.py (block and warp barriers), so its
indexing, its barriers and its arithmetic are held to `eskf.predict` on a
host without a card; the card's compiler, and the kernel's time, only the
card shows (tests/test_torch_cuda.py). On the CPU the pipeline takes the
plain route and never builds a kernel."""

import ctypes

import numpy as np
import pytest
import torch

from svnicp_tpu_torch.config import IMUNoiseConfig
from svnicp_tpu_torch.core import eskf as eskf_mod
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import imu as imu_mod
from svnicp_tpu_torch.kernels import _build
from svnicp_tpu_torch.kernels import eskf as eskf_kernel
from svnicp_tpu_torch.runtime import pipeline, profiling
from svnicp_tpu_torch.runtime.ingest import ImuWindow
from test_torch_kernel_emulation import build_emulated

torch.set_num_threads(2)

# configs/geode_alpha.yaml's IMU noise, in SI
NOISE = IMUNoiseConfig(rot_rw=(0.0005817764, 0.0005817764, 0.0029088821),
                       vel_rw=(0.8333333333,) * 3, bg_std=(0.0000969627,) * 3,
                       ba_std=(0.005,) * 3)
WINDOWS = (1, 10, 11, 256)


def eskf_operands(n: int, dtype=torch.float64, seed: int = 0):
    """A filter state away from the identity, with nonzero biases and a
    dense covariance, and n IMU rows [dt, acc, gyro] of a 100 Hz IMU; row
    n // 2 is near free fall with a near-zero rate, so R a falls in the
    exponential's small-angle branch -> (state, rows)."""
    rng = np.random.default_rng(seed * 1000 + n)
    m = rng.normal(size=(15, 15)) * 0.05
    ba = rng.normal(size=3) * 0.05
    rows = np.concatenate([rng.uniform(0.008, 0.012, (n, 1)),
                           rng.normal(size=(n, 3)) + [0.0, 0.0, 9.8],
                           0.3 * rng.normal(size=(n, 3))], axis=1)
    rows[n // 2, 1:4] = ba + rng.normal(size=3) * 1e-4
    rows[n // 2, 4:7] = rng.normal(size=3) * 1e-5

    t = torch.tensor
    state = eskf_mod.ESKFState(
        nav=imu_mod.NavState(geo.so3_exp(t(rng.normal(size=3) * 0.7)),
                             t(rng.normal(size=3) * 3.0), t(rng.normal(size=3))),
        bg=t(rng.normal(size=3) * 0.01), ba=t(ba),
        cov=t(m @ m.T + np.diag(rng.uniform(1e-6, 1e-2, 15))),
        process_noise=torch.zeros((15, 15), dtype=torch.float64),
        gain=t(rng.normal(size=(15, 6))))
    return state_to(state, dtype), t(rows).to(dtype)


def state_to(state, *args, **kwargs):
    """The filter state with every tensor moved by `.to(*args, **kwargs)`."""
    return eskf_mod.ESKFState(imu_mod.NavState(*(x.to(*args, **kwargs) for x in state.nav)),
                              *(x.to(*args, **kwargs) for x in state[1:]))


def small_angle_rows(state, rows):
    """The rows whose R a (R before the sample) falls under the
    exponential's small-angle threshold on the plain route."""
    hits, ekf = [], state
    for i, cur in enumerate(rows):
        ra = ekf.nav.r @ (cur[1:4] - ekf.ba)
        if float((ra * ra).sum()) < 1e-6:
            hits.append(i)
        prev = rows[max(i - 1, 0)]
        ekf = eskf_mod.predict(ekf, imu_mod.IMUSample(prev[0], prev[1:4], prev[4:7]),
                               imu_mod.IMUSample(cur[0], cur[1:4], cur[4:7]), NOISE)
    return hits


def propagate_close(got, want, nav_tol: float, cov_tol: float):
    """Nav (R, t, v) to nav_tol of the largest entry, cov and Q to cov_tol
    relative (of the largest entry, for entries that cancel); biases and
    gain passed through bit for bit."""
    def close(a, b, tol):
        torch.testing.assert_close(a.double(), b.double(), rtol=tol,
                                   atol=tol * float(b.abs().max().clamp_min(1e-30)))

    for a, b in zip(got.nav, want.nav):
        close(a, b, nav_tol)
    close(got.cov, want.cov, cov_tol)
    close(got.process_noise, want.process_noise, cov_tol)
    for a, b in ((got.bg, want.bg), (got.ba, want.ba), (got.gain, want.gain)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated(tmp_path_factory, "eskf_propagate.cu").svn_eskf_propagate


def run_emulated(entry, ekf, rows, textbook):
    """The kernel's C entry as `kernels/eskf.propagate` calls it, on host
    memory."""
    nav = ekf.nav
    args = [x.contiguous() for x in (rows, nav.r, nav.t, nav.v, ekf.cov, ekf.ba)]
    out = torch.full((eskf_kernel._OUT,), float("nan"), dtype=ekf.cov.dtype)
    err = entry(*(_build.ptr(x) for x in args), eskf_kernel._variances(NOISE, ekf.cov.dtype),
                rows.shape[0], int(textbook), int(ekf.cov.dtype == torch.float64),
                _build.ptr(out), None)
    assert err == 0
    return eskf_kernel._unpack(ekf, out)


def test_operands_reach_the_small_angle_branch():
    for n in WINDOWS[1:]:
        assert n // 2 in small_angle_rows(*eskf_operands(n))


@pytest.mark.parametrize("textbook", [False, True])
@pytest.mark.parametrize("n", WINDOWS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eskf_propagate_kernel_source_on_the_cpu(emulated, dtype, n, textbook):
    state, rows = eskf_operands(n, dtype)
    got = run_emulated(emulated, state, rows, textbook)
    want = eskf_kernel.propagate_plain(state, rows, NOISE, textbook)
    # float64: the same operations in another order of a few sums; float32:
    # over up to 256 chained samples, the covariance's sums of 15 products
    # and the nav's cancellations grow the gap past a few units in the last
    # place
    if dtype == torch.float64:
        propagate_close(got, want, 1e-12, 1e-12)
    else:
        propagate_close(got, want, 2e-6, 2e-5)
    again = run_emulated(emulated, state, rows, textbook)
    assert all(torch.equal(a, b) for a, b in
               zip((*got.nav, got.cov, got.process_noise),
                   (*again.nav, again.cov, again.process_noise)))


def test_kernel_source_rejects_an_empty_window(emulated):
    state, rows = eskf_operands(1)
    out = torch.zeros(eskf_kernel._OUT, dtype=torch.float64)
    args = (rows, state.nav.r, state.nav.t, state.nav.v, state.cov, state.ba)
    err = emulated(*(_build.ptr(x) for x in args), eskf_kernel._variances(NOISE, torch.float64),
                   0, 0, 1, _build.ptr(out), None)
    assert err != 0 and not out.any()


def test_variances_are_squared_in_the_working_dtype():
    var = eskf_kernel._variances(NOISE, torch.float32)
    stds = (NOISE.vel_rw, NOISE.rot_rw, NOISE.bg_std, NOISE.ba_std)
    want = torch.cat([torch.tensor(s, dtype=torch.float32) ** 2 for s in stds])
    assert [float(x) for x in var] == want.tolist()
    var64 = eskf_kernel._variances(NOISE, torch.float64)
    want64 = torch.cat([torch.tensor(s, dtype=torch.float64) ** 2 for s in stds])
    assert [float(x) for x in var64] == want64.tolist()


def test_variances_are_made_once_per_diagonals_and_dtype():
    import dataclasses

    var = eskf_kernel._variances(NOISE, torch.float32)
    listed = dataclasses.replace(NOISE, rot_rw=list(NOISE.rot_rw))
    assert eskf_kernel._variances(listed, torch.float32) is var
    assert eskf_kernel._variances(NOISE, torch.float64) is not var
    other = dataclasses.replace(NOISE, ba_std=(0.01, 0.01, 0.01))
    assert list(eskf_kernel._variances(other, torch.float32))[9:] != list(var)[9:]


def _refuse_build():
    raise AssertionError("the CPU route built or loaded a CUDA kernel library")


@pytest.mark.parametrize("count", [1, 10])
def test_cpu_route_never_builds_a_kernel(monkeypatch, count):
    monkeypatch.setattr(_build, "build_all", _refuse_build)
    monkeypatch.setattr(_build, "library", lambda src: _refuse_build())
    state, rows = eskf_operands(count, torch.float32)
    buf = np.zeros((256, 7), np.float32)
    buf[:count] = rows.numpy()
    before = eskf_kernel.propagate.launches
    with profiling.tracing() as trace:
        got = pipeline._imu_scan_predict(state, ImuWindow(buf, count, 0), NOISE)
    want = eskf_kernel.propagate_plain(state, rows, NOISE)
    assert all(torch.equal(a, b) for a, b in zip((*got.nav, got.cov, got.process_noise),
                                                 (*want.nav, want.cov, want.process_noise)))
    assert trace.counters.get("svnicp.imu_samples") == count
    assert trace.counters.get("svnicp.filter.kernel_windows", 0) == 0
    assert eskf_kernel.propagate.launches == before
    assert [s.name for s in trace.spans] == ["svnicp.filter.predict", "svnicp.upload"]


def test_empty_window_leaves_the_state_and_counts_nothing():
    state, _ = eskf_operands(1)
    with profiling.tracing() as trace:
        assert pipeline._imu_scan_predict(state, None, NOISE) is state
        assert pipeline._imu_scan_predict(
            state, ImuWindow(np.zeros((256, 7)), 0, 0), NOISE) is state
    assert trace.counters == {} and trace.spans == []


def test_kernel_wrapper_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(_build, "build_all", _refuse_build)
    state, rows = eskf_operands(3)
    with pytest.raises(ValueError, match="CUDA"):
        eskf_kernel.propagate(state, rows, NOISE)


def test_build_knows_the_propagation_kernel():
    assert "eskf_propagate.cu" in _build.CUDA_SOURCES
    assert (_build.CSRC / "eskf_propagate.cu").is_file()
    argtypes = _build.SIGNATURES["eskf_propagate.cu"]["svn_eskf_propagate"]
    assert argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    assert set(_build.SIGNATURES) == set(_build.CUDA_SOURCES)
    assert "svn_eskf_propagate" in (_build.CSRC / "eskf_propagate.cu").read_text()
