"""The plain versions of the port's kernels (what runs for CPU tensors, and
the oracle the CUDA kernels are held to on the card) against the Pallas
kernels they replace, run in interpret mode on the CPU:
B1 nn_pallas.bucketed_candidates, B2 nn_pallas.fused_moments_plane_kb,
B3 stein_pallas.stein_update, B4 nn_pallas.fused_moments_kb,
B5 nn_pallas.fused_nn_match."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.core import geometry as jgeo
from svnicp_tpu.core import residuals as jres
from svnicp_tpu.core import svn as jsvn
from svnicp_tpu.kernels import knn as jknn
from svnicp_tpu.kernels import nn_pallas, stein_pallas
from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import svgd as tsvgd
from svnicp_tpu_torch.core import svn as tsvn
from svnicp_tpu_torch.kernels import knn as tknn
from svnicp_tpu_torch.kernels import nn as tnn
from svnicp_tpu_torch.kernels import stein as tstein

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("b,nt,k", [(64, 1000, 8), (100, 4096, 32)])
def test_stage1_plain_matches_pallas(rng, b, nt, k):
    source = (rng.normal(size=(b, 3)) * 10).astype(np.float32)
    target = (rng.normal(size=(nt, 3)) * 10).astype(np.float32)
    sv = rng.random(b) > 0.1
    tv = rng.random(nt) > 0.2
    pts_j, d2_j = nn_pallas.bucketed_candidates(
        jnp.asarray(source), jnp.asarray(target), jnp.asarray(sv),
        jnp.asarray(tv), k, point_tile=b, interpret=True)
    pts_t, d2_t = tnn.bucketed_candidates(
        torch.from_numpy(source), torch.from_numpy(target),
        torch.from_numpy(sv), torch.from_numpy(tv), k)
    valid = np.isfinite(np.asarray(d2_j))
    np.testing.assert_array_equal(np.isfinite(d2_t.numpy()), valid)
    np.testing.assert_allclose(d2_t.numpy()[valid], np.asarray(d2_j)[valid],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pts_t.numpy()[valid], np.asarray(pts_j)[valid],
                               rtol=1e-4, atol=1e-4)


def test_stage1_ties_are_averaged():
    """Two equidistant targets in one group: the Pallas kernel and the plain
    version both return their midpoint."""
    source = np.zeros((1, 3), np.float32)
    target = np.zeros((64, 3), np.float32)
    target[0] = [1.0, 0.0, 0.0]
    target[1] = [0.0, 1.0, 0.0]
    tv = np.zeros(64, bool)
    tv[:2] = True
    pts_j, _ = nn_pallas.bucketed_candidates(
        jnp.asarray(source), jnp.asarray(target), jnp.ones(1, bool),
        jnp.asarray(tv), 1, point_tile=1, interpret=True)
    pts_t, _ = tnn.bucketed_candidates(
        torch.from_numpy(source), torch.from_numpy(target), torch.ones(1, dtype=torch.bool),
        torch.from_numpy(tv), 1)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=0)
    np.testing.assert_allclose(pts_t.numpy()[0, 0], [0.5, 0.5, 0.0])


@pytest.mark.parametrize("nt,k", [(1, 1), (1000, 8), (4096, 32), (65536, 32),
                                  (200000, 100)])
def test_bucket_block_size_matches_jax(nt, k):
    assert tknn.bucket_block_size(nt, k) == jknn.bucket_block_size(nt, k)


def test_stage1_plain_matches_xla_path(rng):
    """On a continuous random cloud (no ties) the tie-averaging stage 1
    picks the same targets as the JAX package's index-based XLA path."""
    source = (rng.normal(size=(80, 3)) * 10).astype(np.float32)
    target = (rng.normal(size=(3000, 3)) * 10).astype(np.float32)
    sv = rng.random(80) > 0.1
    tv = rng.random(3000) > 0.3
    idx_j, d2_j = jknn.knn_candidates_bucketed(
        jnp.asarray(source), jnp.asarray(target), jnp.asarray(sv),
        jnp.asarray(tv), 16)
    pts_j, _ = jknn.gather_candidates(jnp.asarray(target), idx_j, d2_j)
    pts_t, d2_t = tnn.bucketed_candidates(
        torch.from_numpy(source), torch.from_numpy(target),
        torch.from_numpy(sv), torch.from_numpy(tv), 16)
    valid = np.isfinite(np.asarray(d2_j))
    np.testing.assert_array_equal(np.isfinite(d2_t.numpy()), valid)
    np.testing.assert_array_equal(pts_t.numpy()[valid], np.asarray(pts_j)[valid])
    np.testing.assert_allclose(d2_t.numpy()[valid], np.asarray(d2_j)[valid],
                               rtol=1e-5, atol=1e-4)


def _moments_problem(rng, p, b, k):
    source = (rng.normal(size=(b, 3)) * 5).astype(np.float32)
    src_valid = rng.random(b) > 0.2
    cand = (rng.normal(size=(b, k, 3)) * 5).astype(np.float32)
    cvalid = rng.random((b, k)) > 0.1
    xi = (rng.normal(size=(p, 6)) * 0.1).astype(np.float32)
    r = np.asarray(jgeo.bso3_exp(jnp.asarray(xi[:, 3:])))
    params = np.concatenate([r.reshape(p, 9), xi[:, :3]], axis=-1)
    return source, src_valid, cand, cvalid, params


@pytest.mark.parametrize("p,b,k", [(8, 64, 32), (10, 128, 16)])
def test_plane_moments_plain_matches_pallas(rng, p, b, k):
    source, src_valid, cand, cvalid, params = _moments_problem(rng, p, b, k)
    max_dist = 2.8
    feat, bias = jsvn.correspondence_features(jnp.asarray(source),
                                              jnp.asarray(cand),
                                              jnp.asarray(cvalid))
    normals, n_valid = jres.plane_normals(jnp.asarray(cand), jnp.asarray(cvalid))
    valid = n_valid & jnp.asarray(src_valid)
    prep_j = nn_pallas.prepare_moments_plane_kb(feat, bias, jnp.asarray(cand),
                                                jnp.asarray(source), normals, valid)
    h_j, b_j = nn_pallas.fused_moments_plane_kb(
        jnp.asarray(params), *prep_j, max_dist, particle_tile=p, point_tile=b,
        interpret=True)

    feat_t, bias_t = tsvn.correspondence_features(
        torch.from_numpy(source), torch.from_numpy(cand), torch.from_numpy(cvalid))
    prep_t = tnn.prepare_moments_plane(feat_t, bias_t, torch.from_numpy(cand),
                                       torch.from_numpy(source), _t(normals),
                                       _t(valid))
    h_t, b_t = tnn.plane_moments(torch.from_numpy(params), prep_t, max_dist)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-4)


def test_plane_moments_ties_are_averaged(rng):
    """Candidate 1 repeats candidate 0's score features exactly but carries
    another n.q: both tie at the minimum and the Pallas kernel and the plain
    version use the mean of the two n.q values (a first-index rule would
    give the result with candidate 1's n.q equal to candidate 0's)."""
    p, b, k, max_dist = 8, 128, 8, 2.8
    source = (rng.normal(size=(b, 3)) * 5).astype(np.float32)
    dirs = rng.normal(size=(b, k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cand = (source[:, None, :] + dirs * (0.3 + 0.4 * np.arange(k))[None, :, None]
            ).astype(np.float32)
    cvalid = np.ones((b, k), bool)
    normals, n_valid = jres.plane_normals(jnp.asarray(cand), jnp.asarray(cvalid))
    feat, bias = jsvn.correspondence_features(
        jnp.asarray(source), jnp.asarray(cand), jnp.asarray(cvalid))
    feat13, ndotc, src_t, nrm_t, vmask = (np.array(x) for x in
                                          nn_pallas.prepare_moments_plane_kb(
        feat, bias, jnp.asarray(cand), jnp.asarray(source), normals, n_valid))
    feat13[:, 1, :] = feat13[:, 0, :]
    xi = (rng.normal(size=(p, 6)) * 0.01).astype(np.float32)
    params = np.concatenate([np.asarray(jgeo.bso3_exp(jnp.asarray(xi[:, 3:]))
                                        ).reshape(p, 9), xi[:, :3]], axis=-1)

    def both(ndotc1):
        nq = ndotc.copy()
        nq[1] = ndotc1
        h_j, b_j = nn_pallas.fused_moments_plane_kb(
            jnp.asarray(params), jnp.asarray(feat13), jnp.asarray(nq),
            jnp.asarray(src_t), jnp.asarray(nrm_t), jnp.asarray(vmask), max_dist,
            particle_tile=p, point_tile=b, interpret=True)
        prep_t = tnn.PlanePrep(*(torch.from_numpy(x) for x in
                                   (feat13, nq, src_t, nrm_t, vmask.reshape(b))))
        h_t, b_t = tnn.plane_moments(torch.from_numpy(params), prep_t, max_dist)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-4)
        return b_t.numpy()

    b_tied = both(ndotc[0] + 0.2)
    b_first = both(ndotc[0])
    assert np.abs(b_tied - b_first).max() > 1e-2 * np.abs(b_first).max()


def _point_moments_both(params, feat13, cand_t, src_t, vmask, max_dist):
    """B4 on prepared operands: (Pallas interpret, port's wrapper) -> (H, b)."""
    p, b = params.shape[0], src_t.shape[1]
    h_j, b_j = nn_pallas.fused_moments_kb(
        jnp.asarray(params), jnp.asarray(feat13), jnp.asarray(cand_t),
        jnp.asarray(src_t), jnp.asarray(vmask.reshape(1, b)), max_dist,
        particle_tile=p, point_tile=b, interpret=True)
    prep_t = tnn.PointPrep(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                             (feat13, cand_t, src_t, vmask.reshape(b))))
    h_t, b_t = tnn.point_moments(torch.from_numpy(params), prep_t, max_dist)
    return (np.asarray(h_j), np.asarray(b_j)), (h_t.numpy(), b_t.numpy())


def _point_prep_port(source, src_valid, cand, cvalid):
    cand_t, cvalid_t = tnn.pad_candidates(torch.from_numpy(cand),
                                          torch.from_numpy(cvalid), multiple=8)
    feat, bias = tsvn.correspondence_features(torch.from_numpy(source), cand_t,
                                              cvalid_t)
    return tnn.prepare_moments_point(feat, bias, cand_t, torch.from_numpy(source),
                                     torch.from_numpy(src_valid))


@pytest.mark.parametrize("p,b,k", [(8, 64, 12), (10, 128, 100), (30, 96, 5)])
def test_point_moments_plain_matches_pallas(rng, p, b, k):
    """K not a multiple of 8: both sides pad it to one with invalid slots,
    as the JAX package's align does before its kernel."""
    source, src_valid, cand, cvalid, params = _moments_problem(rng, p, b, k)
    cvalid[3] = False                  # a point with no valid candidate
    max_dist = 2.8
    cand_p, cvalid_p = nn_pallas.pad_candidates(jnp.asarray(cand),
                                                jnp.asarray(cvalid), multiple=8)
    assert cand_p.shape[1] % 8 == 0 and cand_p.shape[1] > k
    h_j, b_j = nn_pallas.fused_moments(
        jnp.asarray(params), *jsvn.correspondence_features(
            jnp.asarray(source), cand_p, cvalid_p), cand_p,
        jnp.asarray(source), jnp.asarray(src_valid), max_dist,
        particle_tile=p, point_tile=b, interpret=True)
    prep_t = _point_prep_port(source, src_valid, cand, cvalid)
    assert prep_t.feat13.shape[1] == cand_p.shape[1]
    h_t, b_t = tnn.point_moments(torch.from_numpy(params), prep_t, max_dist)
    assert np.isfinite(h_t.numpy()).all() and np.isfinite(b_t.numpy()).all()
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-3)


def test_point_moments_ties_are_averaged(rng):
    """Candidate 1 repeats candidate 0's score features exactly but sits
    elsewhere: both tie at the minimum and the Pallas kernel and the plain
    version match the mean of the two points (a first-index rule would give
    the result with candidate 1 at candidate 0's place)."""
    p, b, k, max_dist = 8, 128, 8, 2.8
    source = (rng.normal(size=(b, 3)) * 5).astype(np.float32)
    dirs = rng.normal(size=(b, k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cand = (source[:, None, :] + dirs * (0.3 + 0.1 * np.arange(k))[None, :, None]
            ).astype(np.float32)
    feat13, cand_t, src_t, vmask = (np.array(x) for x in nn_pallas.prepare_moments_kb(
        *jsvn.correspondence_features(jnp.asarray(source), jnp.asarray(cand),
                                      jnp.ones((b, k), bool)),
        jnp.asarray(cand), jnp.asarray(source), jnp.ones(b, bool)))
    feat13[:, 1, :] = feat13[:, 0, :]
    xi = (rng.normal(size=(p, 6)) * 0.01).astype(np.float32)
    params = np.concatenate([np.asarray(jgeo.bso3_exp(jnp.asarray(xi[:, 3:]))
                                        ).reshape(p, 9), xi[:, :3]], axis=-1)

    def both(cand1):
        ct = cand_t.copy()
        ct[:, 1] = cand1
        (h_j, b_j), (h_t, b_t) = _point_moments_both(params, feat13, ct, src_t,
                                                     vmask, max_dist)
        np.testing.assert_allclose(h_t, h_j, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(b_t, b_j, rtol=1e-4, atol=1e-3)
        return b_t

    b_tied = both(cand_t[:, 1] + 0.2)
    b_first = both(cand_t[:, 0])
    assert np.abs(b_tied - b_first).max() > 1e-2 * np.abs(b_first).max()


def test_point_moments_padding_independence(rng):
    """Padding K with invalid (+inf bias) slots changes neither H nor b: a
    gated-out pair's identity damping depends only on the real pair."""
    source, src_valid, cand, cvalid, params = _moments_problem(rng, 8, 64, 16)
    cvalid[5] = False
    h1, b1 = tnn.point_moments(torch.from_numpy(params),
                               _point_prep_port(source, src_valid, cand, cvalid), 2.8)
    cand_p, cvalid_p = tnn.pad_candidates(torch.from_numpy(cand),
                                          torch.from_numpy(cvalid), multiple=64)
    h2, b2 = tnn.point_moments(torch.from_numpy(params), _point_prep_port(
        source, src_valid, cand_p.numpy(), cvalid_p.numpy()), 2.8)
    assert cand_p.shape[1] == 64
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-5)
    np.testing.assert_allclose(b1.numpy(), b2.numpy(), rtol=1e-5)


def test_point_moments_gated_pairs_damp_and_padded_points_do_not(rng):
    """Every pair outside the gate: H is sw I in the translation block with
    sw = the number of real points (padded points add nothing), only the
    jitter elsewhere, and b is 0."""
    source, src_valid, cand, cvalid, params = _moments_problem(rng, 4, 64, 8)
    h, bv = tnn.point_moments(torch.from_numpy(params), _point_prep_port(
        source, src_valid, cand + 100.0, cvalid), 2.8)
    n_real = float(src_valid.sum())
    want = np.zeros((4, 6, 6))
    want[:, :3, :3] = n_real * np.eye(3)
    want += 1e-6 * np.eye(6)
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-6, atol=1e-9)
    assert not bv.any()


@pytest.mark.parametrize("residual,prep_type,plain,averaged", [
    ("point_to_plane", "PlanePrep", "plane_moments_plain", "ndotc"),
    ("point_to_point", "PointPrep", "point_moments_plain", "cand_t")])
def test_moments_runs_the_residual_of_its_prep(rng, residual, prep_type, plain,
                                               averaged):
    """`nn.moments`, which every SVN iteration calls, runs the moments
    function of the residual the align's prep was built for, and the prep
    names the operand its tied minima average (K on axis -2)."""
    source, src_valid, cand, cvalid, params = _moments_problem(rng, 6, 64, 12)
    cfg = dataclasses.replace(SteinICPConfig(), residual=residual)
    prep = tsvn._prepare_align(cfg, torch.from_numpy(source),
                               torch.from_numpy(src_valid), torch.from_numpy(cand),
                               torch.from_numpy(cvalid))
    assert type(prep).__name__ == prep_type
    assert prep.averaged is getattr(prep, averaged)
    assert prep.averaged.shape[-2:] == (16, 64)
    h, b = tnn.moments(torch.from_numpy(params), prep, 2.8)
    h_p, b_p = getattr(tnn, plain)(torch.from_numpy(params), prep, 2.8)
    assert torch.equal(h, h_p) and torch.equal(b, b_p)


def _nn_match_both(params, source, src_valid, cand_score, cand, cvalid):
    """B5 through the JAX package's kernel route (P and B as given, K padded
    to 128 as its align pads them) and the port's wrapper (K padded to a
    multiple of 8, the SVGD loop's prep). Scores come from `cand_score`,
    the averaged coordinates from `cand` (equal unless a test builds ties)
    -> ((matched, best) of JAX, of the port)."""
    p, b = params.shape[0], source.shape[0]
    cs_p, cv_p = nn_pallas.pad_candidates(jnp.asarray(cand_score),
                                          jnp.asarray(cvalid), multiple=128)
    c_p, _ = nn_pallas.pad_candidates(jnp.asarray(cand), jnp.asarray(cvalid),
                                      multiple=128)
    feat, bias = jsvn.correspondence_features(jnp.asarray(source), cs_p, cv_p)
    m_j, b_j = nn_pallas.fused_nn_match(jnp.asarray(params), feat, bias, c_p,
                                        particle_tile=p, point_tile=b,
                                        interpret=True)
    prep = tsvgd.prepare(torch.from_numpy(source), torch.from_numpy(src_valid),
                         torch.from_numpy(cand_score), torch.from_numpy(cvalid))
    c_t, _ = tnn.pad_candidates(torch.from_numpy(cand), torch.from_numpy(cvalid))
    prep = prep._replace(cand_t=c_t.permute(2, 1, 0).contiguous())
    assert prep.feat13.shape[1] % 8 == 0
    m_t, b_t = tnn.nn_match(torch.from_numpy(params), prep)
    return (np.asarray(m_j), np.asarray(b_j)), (m_t.numpy(), b_t.numpy())


def _assert_same_match(jax_out, port_out):
    """Pairs with a finite best score agree to 1e-4. Where every slot of a
    point is invalid (best +inf) both average all their slots, 128 padded
    ones in JAX and 8k in the port, so the matched point depends on the
    padding; the SVGD gate drops those pairs, and only the +inf is compared."""
    (m_j, b_j), (m_t, b_t) = jax_out, port_out
    fin = np.isfinite(b_j)
    np.testing.assert_array_equal(np.isfinite(b_t), fin)
    assert fin.any()
    np.testing.assert_allclose(b_t[fin], b_j[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m_t[fin], m_j[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,b,k", [(8, 256, 16), (10, 256, 20)])
def test_nn_match_plain_matches_pallas(rng, p, b, k):
    source, src_valid, cand, cvalid, params = _moments_problem(rng, p, b, k)
    cvalid[7] = False                  # a point with no valid candidate
    jax_out, port_out = _nn_match_both(params, source, src_valid, cand, cand,
                                       cvalid)
    assert not np.isfinite(jax_out[1][:, 7]).any()
    _assert_same_match(jax_out, port_out)


def test_nn_match_ties_are_averaged(rng):
    """Ragged P=10, B=100, K=12: candidate 1 scores exactly as candidate 0
    but sits 0.2 m away; the Pallas kernel and the plain version both
    return the mean of the two wherever they win (a first-index rule would
    return candidate 0)."""
    p, b, k = 10, 100, 12
    source = (rng.normal(size=(b, 3)) * 5).astype(np.float32)
    dirs = rng.normal(size=(b, k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cand = (source[:, None, :] + dirs * (0.3 + 0.1 * np.arange(k))[None, :, None]
            ).astype(np.float32)
    cand[:, 1] = cand[:, 0]
    cvalid = rng.random((b, k)) > 0.1
    cvalid[:, :2] = True
    cvalid[3] = False
    src_valid = rng.random(b) > 0.1
    xi = (rng.normal(size=(p, 6)) * 1e-3).astype(np.float32)
    params = np.concatenate([np.asarray(jgeo.bso3_exp(jnp.asarray(xi[:, 3:]))
                                        ).reshape(p, 9), xi[:, :3]], axis=-1)
    moved = cand.copy()
    moved[:, 1] += 0.2
    jax_out, port_out = _nn_match_both(params, source, src_valid, cand, moved,
                                       cvalid)
    _assert_same_match(jax_out, port_out)
    fin = np.isfinite(port_out[1])
    mean = np.broadcast_to(cand[None, :, 0] + 0.1, port_out[0].shape)
    np.testing.assert_allclose(port_out[0][fin], mean[fin], atol=1e-5)


def _stein_problem(rng, p):
    a = rng.normal(size=(p, 6, 6)).astype(np.float32)
    hess = a @ a.transpose(0, 2, 1) + 10.0 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(p, 6)).astype(np.float32)
    w = 0.1 * rng.normal(size=(p, 3)).astype(np.float32)
    r = np.asarray(jgeo.bso3_exp(jnp.asarray(w)))
    t = 0.5 * rng.normal(size=(p, 3)).astype(np.float32)
    return hess, b, r, t


@pytest.mark.parametrize("use_prior", [False, True])
@pytest.mark.parametrize("p", [8, 10, 30, 64])
def test_stein_plain_matches_pallas(rng, p, use_prior):
    hess, b, r, t = _stein_problem(rng, p)
    prior = None
    if use_prior:
        prior = np.stack([np.full(6, 3.0), np.full(6, 0.5)]).astype(np.float32)
    r_j, t_j, gn_j, md_j = stein_pallas.stein_update(
        jnp.asarray(hess), jnp.asarray(b), jnp.asarray(r), jnp.asarray(t),
        None if prior is None else jnp.asarray(prior), max_dist=3.0,
        use_prior=use_prior, interpret=True)
    r_t, t_t, gn_t, md_t = tstein.stein_update(
        *(_t(x) for x in (hess, b, r, t)),
        None if prior is None else torch.from_numpy(prior), max_dist=3.0)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=2e-5)
    np.testing.assert_allclose(float(md_t), float(md_j), rtol=2e-5, atol=2e-6)


def test_median_bandwidth_is_sorted_lower_median(rng):
    x = rng.normal(size=(30, 6)).astype(np.float32)
    want = np.asarray(jsvn.median_bandwidth(jnp.asarray(x)))
    got = tstein.median_bandwidth(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
