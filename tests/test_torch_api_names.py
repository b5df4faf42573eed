"""Every public name of the JAX package has a counterpart of the same name in
the port, or stands in EXCEPTIONS with the reason it has none.

A module `svnicp_tpu/<path>.py` maps to `svnicp_tpu_torch/<path>.py`, the two
Pallas modules to the port's kernel modules (`kernels/nn.py`,
`kernels/stein.py`). The public names are those a JAX module defines or
assigns at its top level without a leading underscore. Each name added to
the port under its JAX name has a parity case below, on the same numpy
inputs in float64: the batched geometry aliases, the single-particle
Gauss-Newton systems, the Newton solves, and the pieces of the SVN update.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg
from svnicp_tpu.core import geometry as jgeo
from svnicp_tpu.core import residuals as jres
from svnicp_tpu.core import svn as jsvn
from svnicp_tpu_torch import config as tcfg
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import residuals as tres
from svnicp_tpu_torch.core import svn as tsvn

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULE_MAP = {"kernels/nn_pallas.py": "kernels/nn.py",
              "kernels/stein_pallas.py": "kernels/stein.py"}
_KERNEL = "a Pallas kernel's name; the port's kernel is "
EXCEPTIONS = {
    ("io/native.py", "AVAILABLE"):
        "the port builds its native library at first use and raises when it "
        "cannot; there is no fallback to flag",
    ("kernels/nn_pallas.py", "fused_nn_match"): _KERNEL + "nn.nn_match (B5)",
    ("kernels/nn_pallas.py", "fused_nn_match_oracle"):
        "the Pallas kernel's jnp oracle; the port's plain version is nn.nn_match_plain",
    ("kernels/nn_pallas.py", "fused_moments"):
        "the row-tiled Pallas moments, which no route of the JAX package takes; "
        "the port's point-to-point moments are nn.point_moments (B4)",
    ("kernels/nn_pallas.py", "fused_moments_plane"):
        "the row-tiled Pallas plane moments, which no route takes; the port's "
        "are nn.plane_moments (B2)",
    ("kernels/nn_pallas.py", "fused_moments_kb"): _KERNEL + "nn.point_moments (B4)",
    ("kernels/nn_pallas.py", "fused_moments_plane_kb"): _KERNEL + "nn.plane_moments (B2)",
    ("kernels/nn_pallas.py", "fused_moments_dispatch"):
        "the JAX package's choice of Pallas layout; the port dispatches by the "
        "prep's type in nn.moments",
    ("kernels/nn_pallas.py", "prepare_moments_kb"):
        "the Pallas layout's operands; the port's are nn.prepare_moments_point",
    ("kernels/nn_pallas.py", "prepare_moments_plane_kb"):
        "the Pallas layout's operands; the port's are nn.prepare_moments_plane",
    ("kernels/nn_pallas.py", "pallas_ok"):
        "whether a TPU backend can run Pallas; the port's kernels run on the "
        "card and their plain versions on the CPU, by the tensors' device",
    ("kernels/stein_pallas.py", "lower_median_bisect"):
        "the Pallas kernel's bisection median; the port's is the radix select "
        "stein.lower_median_radix",
    ("kernels/stein_pallas.py", "stein_body"):
        "the Pallas kernel's body; the port's plain version is stein.stein_update_plain",
    ("parallel/sharding.py", "run_align_loop"):
        "the JAX package's shard-local loop; the port's mesh runs the SVN "
        "loop's one driver, svn.align_loop, from sharding._align_shard",
    ("runtime/pipeline.py", "FrameInput"):
        "the jit entry points' pytree of one frame's staged inputs; the port's "
        "steps take those tensors as arguments",
    ("runtime/pipeline.py", "bootstrap_frame"):
        "the jit-compiled bootstrap; the port calls pipeline.bootstrap",
    ("runtime/pipeline.py", "bootstrap_packed"):
        "the jit entry over packed buffers; the port stages its bootstrap "
        "through pipeline.bootstrap",
    ("runtime/pipeline.py", "odometry_step_packed"):
        "the jit entry over packed buffers; the port's batched form is "
        "pipeline.odometry_steps_packed",
    ("runtime/pipeline.py", "odometry_step_packed_pre"):
        "the jit entry over packed buffers; the port's batched form is "
        "pipeline.odometry_steps_packed_pre",
}


def _public_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _modules():
    return sorted(str(p.relative_to(ROOT / "svnicp_tpu"))
                  for p in (ROOT / "svnicp_tpu").rglob("*.py"))


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    port_rel = MODULE_MAP.get(rel, rel)
    assert (ROOT / "svnicp_tpu_torch" / port_rel).exists(), port_rel
    mod = importlib.import_module(
        "svnicp_tpu_torch." + port_rel[:-3].replace("/", ".").removesuffix(".__init__"))
    missing = sorted(n for n in _public_names(ROOT / "svnicp_tpu" / rel)
                     if not hasattr(mod, n) and (rel, n) not in EXCEPTIONS)
    assert not missing, f"{rel}: no counterpart for {missing}"


def test_every_exception_is_still_missing_and_has_a_reason():
    for (rel, name), reason in EXCEPTIONS.items():
        assert name in _public_names(ROOT / "svnicp_tpu" / rel), (rel, name)
        port_rel = MODULE_MAP.get(rel, rel)
        mod = importlib.import_module("svnicp_tpu_torch." + port_rel[:-3].replace("/", "."))
        assert not hasattr(mod, name), (rel, name)
        assert len(reason) > 20


# ------------------------------------------------------------ parity cases

RNG = np.random.default_rng(13)
P, B = 5, 40


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["bso3_exp", "bso3_log", "bso3_left_jacobian"])
def test_batched_so3_aliases(name):
    w = RNG.normal(size=(P, 3)) * 0.7
    w[0] = 0.0
    w[1] = 1e-9
    with jax.enable_x64(True):
        if name == "bso3_log":
            want = jgeo.bso3_log(jgeo.bso3_exp(_j(w)))
            port = tgeo.bso3_log(tgeo.bso3_exp(_t(w)))
        else:
            want = getattr(jgeo, name)(_j(w))
            port = getattr(tgeo, name)(_t(w))
        _close(port, want)


def test_batched_euler_alias():
    a = RNG.normal(size=(3, P))
    with jax.enable_x64(True):
        want = jgeo.beuler_to_matrix(*(_j(x) for x in a))
    _close(tgeo.beuler_to_matrix(*(_t(x) for x in a)), want)


def _particle_operands():
    src = RNG.normal(size=(B, 3)) * 5
    r = np.asarray(tgeo.so3_exp(_t(RNG.normal(size=3) * 0.1)))
    trans = src @ r.T + RNG.normal(size=3)
    tgt = trans + RNG.normal(size=(B, 3)) * 0.5
    pair_valid = RNG.random(B) > 0.2
    point_valid = RNG.random(B) > 0.1
    normals = RNG.normal(size=(B, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return src, trans, tgt, pair_valid, point_valid, r, normals


def test_gauss_newton_system():
    src, trans, tgt, pv, vv, r, _ = _particle_operands()
    with jax.enable_x64(True):
        want = jres.gauss_newton_system(_j(src), _j(trans), _j(tgt), _j(pv), _j(vv), _j(r), 3.0)
    port = tres.gauss_newton_system(_t(src), _t(trans), _t(tgt), _t(pv), _t(vv), _t(r), 3.0)
    for a, b in zip(port, want):
        _close(a, b, atol=1e-10)


def test_gauss_newton_system_plane():
    src, trans, tgt, pv, _, r, normals = _particle_operands()
    with jax.enable_x64(True):
        want = jres.gauss_newton_system_plane(_j(src), _j(trans), _j(tgt), _j(normals),
                                              _j(pv), _j(r), 3.0)
    port = tres.gauss_newton_system_plane(_t(src), _t(trans), _t(tgt), _t(normals),
                                          _t(pv), _t(r), 3.0)
    for a, b in zip(port, want):
        _close(a, b, atol=1e-10)


@pytest.mark.parametrize("name", ["solve_newton", "ensemble_solve"])
def test_newton_solves(name):
    a = RNG.normal(size=(P, 6, 6))
    h = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6)
    b = RNG.normal(size=(P, 6))
    with jax.enable_x64(True):
        want = getattr(jres, name)(_j(h), _j(b))
    _close(getattr(tres, name)(_t(h), _t(b)), want, atol=1e-10)


def _cfgs():
    over = dict(prior_information=True, particle_count=P)
    jc, tc = jcfg.SteinICPConfig(**over), tcfg.SteinICPConfig(**over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def test_prior_information_and_kernel_scale():
    jc, tc = _cfgs()
    a = RNG.normal(size=(P, 6, 6))
    h, b, x = a @ a.transpose(0, 2, 1), RNG.normal(size=(P, 6)), RNG.normal(size=(P, 6))
    with jax.enable_x64(True):
        want = jsvn.add_prior_information(jc, _j(h), _j(b), _j(x))
        want_scale = jsvn.prior_kernel_scale(jc, jnp.float64)
    port = tsvn.add_prior_information(tc, _t(h), _t(b), _t(x))
    for p_, w_ in zip(port, want):
        _close(p_, w_)
    _close(tsvn.prior_kernel_scale(tc, torch.float64), want_scale)


def test_rbf_kernel_block_median_bandwidth_and_clip_step():
    x = RNG.normal(size=(8, 6))
    with jax.enable_x64(True):
        bw = jsvn.median_bandwidth(_j(x))
        want_k, want_d = jsvn.rbf_kernel_block(_j(x[2:5]), _j(x), bw)
        steps = RNG.normal(size=(8, 6)) * 3
        want_clip = jsvn.clip_step(_j(steps), 3.0)
    tbw = tsvn.median_bandwidth(_t(x))
    _close(tbw, bw)
    k, d = tsvn.rbf_kernel_block(_t(x[2:5]), _t(x), tbw)
    _close(k, want_k)
    _close(d, want_d)
    _close(tsvn.clip_step(_t(steps), 3.0), want_clip)
