"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes. Needs an NVIDIA GPU (and nvcc); skipped elsewhere. On the
machine with the card, where JAX is absent, run without the suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest -o addopts= tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package."""

import numpy as np
import pytest
import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn
from svnicp_tpu_torch.kernels import knn, nn, stein

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    from svnicp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _kernel_names(fn, calls: int = 5):
    """The names of the CUDA kernels that `calls` calls of fn() launch, one
    entry per kernel (the profiler can drop a launch's event, rarely all of
    a kernel's in five calls, and once dropped a whole trace: a trace with
    no CUDA event is taken once more, as chip_smoke.device_ms does, and an
    empty retake fails)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    raise AssertionError(f"two profiler traces of {calls} calls held no CUDA event")


@pytest.mark.parametrize("b,nt,k", [(1, 64, 1), (300, 5000, 12), (513, 20000, 32),
                                    (1000, 30000, 100), (777, 12345, 32)])
def test_stage1_kernel(dev, b, nt, k):
    # Nt=5000, 20000, 30000 and 12345 leave padding rows at the end of
    # groups; B=513 and 777 end inside a block of 512 sources
    g = torch.Generator().manual_seed(b)
    src = (torch.randn((b, 3), generator=g) * 10).to(dev)
    tgt = (torch.randn((nt, 3), generator=g) * 10).to(dev)
    sv = (torch.rand(b, generator=g) > 0.1).to(dev)
    tv = (torch.rand(nt, generator=g) > 0.2).to(dev)
    before = nn.bucketed_candidates.launches
    cand_k, d2_k = nn.bucketed_candidates(src, tgt, sv, tv, k)
    torch.cuda.synchronize()
    assert nn.bucketed_candidates.launches == before + 1
    cand_p, d2_p = nn.bucketed_candidates_plain(src, tgt, sv, tv, k)
    fin = torch.isfinite(d2_p)
    assert torch.equal(torch.isfinite(d2_k), fin)
    # slots whose runner-up lies within 1e-5 (relative) of the minimum may
    # pick the other target under the kernel's rounding
    score, _ = knn.group_scores(src, tgt, tv, k)
    two = torch.topk(score, min(2, score.shape[-1]), dim=-1, largest=False).values
    gap = two[..., -1] - two[..., 0] if two.shape[-1] > 1 else torch.full_like(two[..., 0], 1e9)
    keep = fin & (gap > 1e-5 * two[..., 0].abs().clamp_min(1.0))
    torch.testing.assert_close(cand_k[keep], cand_p[keep], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(d2_k[keep], d2_p[keep], rtol=1e-4, atol=1e-3)
    cand_k2, d2_k2 = nn.bucketed_candidates(src, tgt, sv, tv, k)
    assert torch.equal(cand_k, cand_k2) and torch.equal(d2_k, d2_k2)


@pytest.mark.parametrize("b,k", [(300, 12), (4096, 100)])
def test_stage1_launches_its_two_kernels_and_nothing_else(dev, b, k):
    # the target prep and the search
    g = torch.Generator().manual_seed(11)
    src = (torch.randn((b, 3), generator=g) * 10).to(dev)
    tgt = (torch.randn((20000, 3), generator=g) * 10).to(dev)
    sv = torch.ones(b, dtype=torch.bool, device=dev)
    tv = torch.ones(20000, dtype=torch.bool, device=dev)
    names = _kernel_names(lambda: nn.bucketed_candidates(src, tgt, sv, tv, k))
    assert len(names) == 2, names
    assert any("stage1_prep_kernel" in n for n in names), names
    assert any("stage1_kernel" in n for n in names), names


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k", [(1, 7, 3), (10, 300, 12), (64, 1024, 32),
                                   (70, 1001, 104)])
def test_plane_moments_kernel(dev, p, b, k, ties):
    # candidate j sits 0.1 (j+1) m from its point: the argmin and the gate
    # are far from near-ties under any rounding. With `ties`, candidate 1
    # takes candidate 0's score features but a larger n.q, an exact tie
    # whose n.q values must be averaged. The kernel writes H and b itself:
    # they must equal assemble_plane_system of the plain version's moments
    # (which plane_moments_plain returns), H exactly symmetric. B=7 and
    # B=1001 take the 4-byte copies, P=70 two particle groups.
    g = torch.Generator().manual_seed(p * b)
    src = torch.randn((b, 3), generator=g) * 5
    dirs = torch.nn.functional.normalize(torch.randn((b, k, 3), generator=g), dim=-1)
    cand = src[:, None, :] + dirs * (0.1 + 0.1 * torch.arange(k))[None, :, None]
    cvalid = torch.rand((b, k), generator=g) > 0.1
    normals = torch.nn.functional.normalize(torch.randn((b, 3), generator=g), dim=-1)
    valid = torch.rand(b, generator=g) > 0.1
    xi = torch.randn((p, 6), generator=g) * 1e-4
    params = torch.cat([geo.so3_exp(xi[:, 3:]).reshape(p, 9), xi[:, :3]], -1)
    src, cand, cvalid, normals, valid, params = (
        x.to(dev) for x in (src, cand, cvalid, normals, valid, params))
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_plane(feat, bias, cand, src, normals, valid)
    if ties:
        prep.feat13[:, 1] = prep.feat13[:, 0]
        prep.ndotc[1] = prep.ndotc[0] + 0.05
    before = nn.plane_moments.launches
    h_k, b_k = nn.plane_moments(params.contiguous(), prep, 3.0)
    torch.cuda.synchronize()
    assert nn.plane_moments.launches == before + 1
    assert h_k.shape == (p, 6, 6) and b_k.shape == (p, 6)
    h_p, b_p = nn.plane_moments_plain(params, prep, 3.0)
    torch.testing.assert_close(h_k, h_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(b_k, b_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(h_k, h_k.transpose(1, 2))
    h_k2, b_k2 = nn.plane_moments(params.contiguous(), prep, 3.0)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k", [(1, 7, 3), (10, 7, 12), (10, 300, 12), (30, 1000, 100),
                                   (64, 1024, 32), (70, 1001, 104), (64, 4096, 104)])
def test_point_moments_kernel(dev, p, b, k, ties):
    # candidate j sits 0.1 (j+1) m from its point, a sixth of the points
    # lie beyond the gate, 10% of the slots and of the points are invalid,
    # and K is padded to a multiple of 8 as on the path. With `ties`,
    # candidate 1 takes candidate 0's score features but another position,
    # an exact tie whose points must be averaged; candidates 5 and 9 tie with
    # it too: at P=1 and 10, 5 is scored by another set of warps than 0 and 1
    # (which share each chunk's candidates) and 9 in the next chunk. The
    # kernel writes H and b itself, H exactly symmetric. P=1 and 10 take a
    # particle group of 16 lanes, P=30 one of 32, P=64 and 70 two and three
    # groups of 32; B=7 and B=1001 take the 4-byte copies and a tile that
    # ends inside the points.
    g = torch.Generator().manual_seed(p * b + k)
    src = torch.randn((b, 3), generator=g) * 5
    dirs = torch.nn.functional.normalize(torch.randn((b, k, 3), generator=g), dim=-1)
    radius = (0.1 + 0.1 * torch.arange(k))[None, :].repeat(b, 1)
    radius[: b // 6] += 3.0
    cand = src[:, None, :] + dirs * radius[..., None]
    cvalid = torch.rand((b, k), generator=g) > 0.1
    valid = torch.rand(b, generator=g) > 0.1
    xi = torch.randn((p, 6), generator=g) * 1e-4
    params = torch.cat([geo.so3_exp(xi[:, 3:]).reshape(p, 9), xi[:, :3]], -1)
    src, cand, cvalid, valid, params = (
        x.to(dev) for x in (src, cand, cvalid, valid, params))
    cand, cvalid = nn.pad_candidates(cand, cvalid, multiple=8)
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_point(feat, bias, cand, src, valid)
    for j in [j for j in (1, 5, 9) if j < prep.feat13.shape[1]] if ties else []:
        prep.feat13[:, j] = prep.feat13[:, 0]
        prep.cand_t[:, j] = prep.cand_t[:, 0] + 0.05 * j
    before = nn.point_moments.launches
    h_k, b_k = nn.point_moments(params.contiguous(), prep, 3.0)
    torch.cuda.synchronize()
    assert nn.point_moments.launches == before + 1
    assert h_k.shape == (p, 6, 6) and b_k.shape == (p, 6)
    h_p, b_p = nn.point_moments_plain(params, prep, 3.0)
    torch.testing.assert_close(h_k, h_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(b_k, b_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(h_k, h_k.transpose(1, 2))
    h_k2, b_k2 = nn.point_moments(params.contiguous(), prep, 3.0)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2)


def test_point_moments_launches_its_two_kernels_and_nothing_else(dev):
    # the kernel pass and the tile sum that writes H and b: no host-side
    # assembly of the system after them
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(9)
    b, k, p = 512, 16, 10
    src = torch.randn((b, 3), generator=g) * 5
    cand = src[:, None, :] + torch.randn((b, k, 3), generator=g)
    cvalid = torch.rand((b, k), generator=g) > 0.1
    params = torch.cat([torch.eye(3).reshape(1, 9).repeat(p, 1), torch.zeros((p, 3))], -1)
    src, cand, cvalid, params = (x.to(dev) for x in (src, cand, cvalid, params))
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_point(feat, bias, cand, src, torch.ones(b, dtype=torch.bool,
                                                                      device=dev))
    nn.point_moments(params, prep, 3.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nn.point_moments(params, prep, 3.0)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(names) == 2, names
    assert any("point_moments_kernel" in n for n in names), names
    assert any("point_system_kernel" in n for n in names), names


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k", [(1, 7, 3), (10, 300, 12), (30, 1000, 100),
                                   (33, 1000, 100), (64, 1024, 32), (64, 4096, 32)])
def test_nn_match_kernel(dev, p, b, k, ties):
    # the operands of the point-moments test above: candidate j sits
    # 0.1 (j+1) m from its point, 10% of the slots invalid and a point with
    # none valid, K padded to a multiple of 8. With `ties`, candidate 1
    # takes candidate 0's score features but another position, an exact tie
    # whose points must be averaged. P=1 and 10 take a particle group of 16
    # lanes, P=30 one of 32, P=33 and 64 two groups of 32; B=7 and 1000 the
    # 4-byte copies and scalar stores.
    g = torch.Generator().manual_seed(p * b + k + 1)
    src = torch.randn((b, 3), generator=g) * 5
    dirs = torch.nn.functional.normalize(torch.randn((b, k, 3), generator=g), dim=-1)
    cand = src[:, None, :] + dirs * (0.1 + 0.1 * torch.arange(k))[None, :, None]
    cvalid = torch.rand((b, k), generator=g) > 0.1
    cvalid[b // 2] = False
    valid = torch.rand(b, generator=g) > 0.1
    xi = torch.randn((p, 6), generator=g) * 1e-4
    params = torch.cat([geo.so3_exp(xi[:, 3:]).reshape(p, 9), xi[:, :3]], -1)
    src, cand, cvalid, valid, params = (
        x.to(dev) for x in (src, cand, cvalid, valid, params))
    cand, cvalid = nn.pad_candidates(cand, cvalid, multiple=8)
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_point(feat, bias, cand, src, valid)
    if ties:
        prep.feat13[:, 1] = prep.feat13[:, 0]
        prep.cand_t[:, 1] = prep.cand_t[:, 0] + 0.05
    before = nn.nn_match.launches
    m_k, b_k = nn.nn_match(params.contiguous(), prep)
    torch.cuda.synchronize()
    assert nn.nn_match.launches == before + 1
    assert m_k.shape == (p, b, 3) and b_k.shape == (p, b)
    m_p, b_p = nn.nn_match_plain(params, prep)
    fin = torch.isfinite(b_p)
    assert torch.equal(torch.isfinite(b_k), fin) and not fin[:, b // 2].any()
    # candidates lie 0.1 m apart in distance: no near-ties, the same picks
    torch.testing.assert_close(m_k[fin], m_p[fin], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b_k[fin], b_p[fin], rtol=1e-4, atol=1e-3)
    m_k2, b_k2 = nn.nn_match(params.contiguous(), prep)
    assert torch.equal(m_k, m_k2) and torch.equal(b_k, b_k2)


def test_nn_match_launches_its_kernel_and_nothing_else(dev):
    g = torch.Generator().manual_seed(10)
    b, k, p = 512, 16, 30
    src = torch.randn((b, 3), generator=g) * 5
    cand = src[:, None, :] + torch.randn((b, k, 3), generator=g)
    cvalid = torch.rand((b, k), generator=g) > 0.1
    params = torch.cat([torch.eye(3).reshape(1, 9).repeat(p, 1), torch.zeros((p, 3))], -1)
    src, cand, cvalid, params = (x.to(dev) for x in (src, cand, cvalid, params))
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_point(feat, bias, cand, src, torch.ones(b, dtype=torch.bool,
                                                                      device=dev))
    names = _kernel_names(lambda: nn.nn_match(params, prep))
    assert len(names) == 1 and "nn_match_kernel" in names[0], names


@pytest.mark.parametrize("use_prior", [False, True])
@pytest.mark.parametrize("p", [2, 10, 33, 64, 200, 300, 512])
def test_stein_kernel(dev, p, use_prior):
    # P <= 128 keeps the pairwise distances in shared memory, larger P
    # recomputes them in each selection pass
    g = torch.Generator().manual_seed(p)
    a = torch.randn((p, 6, 6), generator=g)
    hess = a @ a.transpose(1, 2) + 10.0 * torch.eye(6)
    b = torch.randn((p, 6), generator=g)
    r = geo.so3_exp(0.1 * torch.randn((p, 3), generator=g))
    t = 0.5 * torch.randn((p, 3), generator=g)
    prior = torch.tensor([[3.0] * 6, [0.5] * 6]) if use_prior else None
    args = [x.to(dev).contiguous() for x in (hess, b, r, t)]
    prior = None if prior is None else prior.to(dev)
    before = stein.stein_update.launches
    out_k = stein.stein_update(*args, prior, max_dist=3.0)
    torch.cuda.synchronize()
    assert stein.stein_update.launches == before + 1
    out_p = stein.stein_update_plain(*args, prior, max_dist=3.0)
    for got, want in zip(out_k, out_p):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    out_k2 = stein.stein_update(*args, prior, max_dist=3.0)
    assert all(torch.equal(a, c) for a, c in zip(out_k, out_k2))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    m = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        nn.bucketed_candidates(x, x, m, m, 2)
    with pytest.raises(ValueError):
        nn.bucketed_candidates(x.float().T.contiguous().T, x.float(), m, m, 2)
    prep = nn.PointPrep(torch.zeros((13, 8, 4), device=dev),
                        torch.zeros((3, 8, 4), device=dev),
                        torch.zeros((3, 4), device=dev), torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        nn.nn_match(torch.zeros((2, 12), dtype=torch.float64, device=dev), prep)
    with pytest.raises(ValueError):
        nn.nn_match(torch.zeros((2, 13), device=dev), prep)


@pytest.mark.parametrize("p,copies", [(16, 2), (300, 6)])
def test_kernel_medians_are_exact(dev, p, copies):
    """Duplicated particles make many equal pairwise distances: the kernel's
    radix-select median must still land on the sorted lower median, so the
    update equals the plain version's."""
    base = torch.tensor(np.linspace(0, 1, p // copies), dtype=torch.float32)
    t = torch.stack([base, base, base], 1).repeat(copies, 1)
    r = torch.eye(3).repeat(p, 1, 1)
    hess = torch.eye(6).repeat(p, 1, 1) * 5.0
    b = torch.ones((p, 6))
    args = [x.to(dev).contiguous() for x in (hess, b, r, t)]
    out_k = stein.stein_update(*args, None, max_dist=3.0)
    out_p = stein.stein_update_plain(*args, None, max_dist=3.0)
    for got, want in zip(out_k, out_p):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_plane_moments_at_the_features_shape(dev):
    """B2 at configs/tpu_features.yaml's shape (P=10, K=32, B=4096: 54 of
    the 64 particle slots of a block masked) against the plain version run
    in float64: the kernel's error at most twice the float32 plain
    version's (plus 1e-7 of the largest entry), repeats bit-identical."""
    p, b, k = 10, 4096, 32
    g = torch.Generator().manual_seed(8)
    src = torch.randn((b, 3), generator=g) * 20
    dirs = torch.nn.functional.normalize(torch.randn((b, k, 3), generator=g), dim=-1)
    cand = src[:, None, :] + dirs * (0.1 + 0.1 * torch.arange(k))[None, :, None]
    cvalid = torch.rand((b, k), generator=g) > 0.1
    normals = torch.nn.functional.normalize(torch.randn((b, 3), generator=g), dim=-1)
    valid = torch.rand(b, generator=g) > 0.3
    xi = torch.randn((p, 6), generator=g) * torch.tensor([0.05] * 3 + [0.005] * 3)
    params = torch.cat([geo.so3_exp(xi[:, 3:]).reshape(p, 9), xi[:, :3]], -1)
    src, cand, cvalid, normals, valid, params = (
        x.to(dev) for x in (src, cand, cvalid, normals, valid, params))
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_plane(feat, bias, cand, src, normals, valid)
    h_k, b_k = nn.plane_moments(params.contiguous(), prep, 3.0)
    h_k2, b_k2 = nn.plane_moments(params.contiguous(), prep, 3.0)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2)
    h_p, b_p = nn.plane_moments_plain(params, prep, 3.0)
    h64, b64 = nn.plane_moments_plain(params.double(),
                                      type(prep)(*(x.double() for x in prep)), 3.0)
    for got, plain, ref in ((h_k, h_p, h64), (b_k, b_p, b64)):
        e_k = (got.double() - ref).abs().max().item()
        e_p = (plain.double() - ref).abs().max().item()
        assert e_k <= 2 * e_p + 1e-7 * ref.abs().max().item(), (e_k, e_p)


def test_preprocessing_on_the_card_matches_the_cpu(dev):
    """Two HDL-64 proxy sweeps through configs/tpu_features.yaml's feature
    selection and through range-image segmentation, on the card and on the
    CPU (`chip_smoke.compare_preprocess`: both round every step alike, so
    the picks are expected identical; any that differ must stay under 1%).
    The second sweep replays the CUDA graphs the first one captured."""
    import pathlib
    import sys

    from svnicp_tpu_torch import config as cfg_mod

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    cfg = cfg_mod.from_yaml(str(root / "configs" / "tpu_features.yaml"))
    events, _, _ = chip_smoke.proxy_sequence(4)
    for frame in chip_smoke.proxy_frames(events)[2:4]:
        d_sel, n_sel, d_seg, n_seg, _ = chip_smoke.compare_preprocess(cfg, frame, dev)
        print(f"select_features: {d_sel} of {n_sel} picks differ; "
              f"segment_cloud: {d_seg} of {n_seg} points differ")


def test_atan2f_fma_and_sqrt_round_alike_on_the_card(dev):
    """The float32 steps the projection depends on give the same bits on
    the card as on the CPU."""
    from svnicp_tpu_torch.core import segmentation as seg

    g = torch.Generator().manual_seed(3)
    y = torch.randn(1 << 20, generator=g) * 30
    x = torch.randn(1 << 20, generator=g) * 30
    x[:100] = 0.0
    y[100:200] = 0.0
    for fn in (seg.atan2f, lambda a, b: seg.fma(a, b, a * b),
               lambda a, b: seg.sqrt(a * a + b * b)):
        assert torch.equal(fn(y.to(dev), x.to(dev)).cpu(), fn(y, x))


def test_cuda_graph_replays_on_new_inputs(dev):
    """`core.cuda_graph.replay`: the first call captures, later calls
    replay on their own inputs, and earlier outputs are copies that a
    replay does not overwrite."""
    from svnicp_tpu_torch.core import cuda_graph

    def fn(x, m):
        return torch.where(m, x * 2.0 + 1.0, x), (x * m).sum()

    xs = [torch.randn(1000, device=dev) for _ in range(3)]
    ms = [torch.rand(1000, device=dev) > 0.5 for _ in range(3)]
    outs = [cuda_graph.replay("test", fn, x, m) for x, m in zip(xs, ms)]
    for (a, s), x, m in zip(outs, xs, ms):
        want_a, want_s = fn(x, m)
        assert torch.equal(a, want_a) and torch.equal(s, want_s)


# ------------------------------------------------ the align loop as a CUDA graph

# GEODE-Alpha's and SubT-MRS's registration shapes: (P, B, K before the
# padding to 104, cap, stop threshold)
ALIGN_SHAPES = {"geode": (10, 4096, 100, 60, 5e-4), "subt": (30, 8192, 100, 100, 1e-4)}


def _align_frame(dev, p, b, k, seed):
    """One frame's align operands: b source points, each with k candidates
    around its place under a small pose (a tenth of them invalid), the
    identity guess and a particle draw in the prior box."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randn((b, 3), generator=g) * 8.0
    xi = (torch.rand(6, generator=g) - 0.5) * torch.tensor([0.2, 0.2, 0.1, 0.01, 0.01, 0.02])
    r, t = geo.se3_exp(xi)
    cand = (src @ r.T + t)[:, None, :] + 0.05 * torch.randn((b, k, 3), generator=g)
    cand_valid = torch.rand((b, k), generator=g) > 0.1
    src_valid = torch.rand(b, generator=g) > 0.05
    lb, ub = torch.tensor(SteinICPConfig().init_lb), torch.tensor(SteinICPConfig().init_ub)
    init = lb + (ub - lb) * torch.rand((p, 6), generator=g)
    return [x.to(dev) for x in (src, src_valid, cand, cand_valid, torch.eye(3),
                                torch.zeros(3), init)]


def _align_cfg(p, k, cap, thr, **kw):
    return SteinICPConfig(particle_count=p, iterations=cap, knn_count=k,
                              max_dist=3.0, use_pallas=True, convergence_threshold=thr,
                              **kw)


@pytest.mark.parametrize("shape", list(ALIGN_SHAPES))
def test_align_graph_equals_the_uncaptured_rounds(dev, shape, monkeypatch):
    """At GEODE's and SubT's shapes, over several frames of new operands,
    the rounds replayed from the CUDA graph give the AlignResult of the
    same rounds issued op by op, bit for bit; one capture per shape, and
    B4's and B3's launch counts advance by ALIGN_CHUNK a replay."""
    from svnicp_tpu_torch.runtime import profiling

    p, b, k, cap, thr = ALIGN_SHAPES[shape]
    # a threshold of this test's own, so the capture is this test's
    cfg = _align_cfg(p, k, cap, thr * (1 + 1e-9))
    frames = [_align_frame(dev, p, b, k, seed) for seed in range(3)]
    eager = []
    with monkeypatch.context() as mp:
        mp.setattr(svn, "_graphed", lambda *a: False)
        for f in frames:
            eager.append(svn.align(cfg, *f))
    wrappers = (nn.point_moments, stein.stein_update, nn.plane_moments)
    with profiling.tracing() as tr:
        graphed = [svn.align(cfg, *f) for f in frames[:1]]
        before = [w.launches for w in wrappers]
        graphed += [svn.align(cfg, *f) for f in frames[1:]]
        torch.cuda.synchronize()
        made = [w.launches - x for w, x in zip(wrappers, before)]
    assert tr.counters.get("svnicp.align.graph_captures") == 1, tr.counters
    rounds = tr.counters["svnicp.align.graph_replays"]
    assert rounds == len(tr.named("svnicp.align.iter"))
    later = sum(-(-res.iterations // svn.ALIGN_CHUNK) for res in graphed[1:])
    assert made == [later * svn.ALIGN_CHUNK] * 2 + [0], (made, later)
    for want, got in zip(eager, graphed):
        assert got.iterations == want.iterations and 0 < got.iterations <= cap
        for name in ("particles", "mean", "var", "cov", "grad_norm"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    # a changed shape captures a graph of its own
    with profiling.tracing() as tr:
        svn.align(cfg, *_align_frame(dev, p, b // 2, k, 7))
    assert tr.counters.get("svnicp.align.graph_captures") == 1, tr.counters


def test_align_graph_replays_a_fault_planted_before_it(dev, monkeypatch):
    """lio_bench's `state_unchanged` fault, planted before the first frame,
    is the pass that gets captured: the particles stay at the draw and the
    loop stops after one pass, with no moments launch."""
    from lio_bench.harness import faults
    from svnicp_tpu_torch.runtime import profiling

    p, b, k, cap, thr = ALIGN_SHAPES["geode"]
    cfg = _align_cfg(p, k, cap, thr * (1 + 2e-9))
    faults.state_unchanged(monkeypatch.setattr)
    before = nn.point_moments.launches
    with profiling.tracing() as tr:
        for seed in range(2):
            f = _align_frame(dev, p, b, k, seed)
            res = svn.align(cfg, *f)
            want = svn.particle_coords(geo.so3_exp(f[-1][:, 3:]), f[-1][:, :3])
            assert res.iterations == 1 and float(res.grad_norm) == 0.0
            assert torch.equal(res.particles, want)
    assert tr.counters.get("svnicp.align.graph_captures") == 1, tr.counters
    assert tr.counters.get("svnicp.align.graph_replays") == 2, tr.counters
    assert nn.point_moments.launches == before


# ------------------------------------------------ the XLA route on the card

def test_voxel_keys_on_the_card_equal_the_cpu(dev):
    """The keys are a product with the reciprocal on both devices (the JAX
    package's rule), so the card's equal the CPU's bit for bit, on points
    that sit on voxel edges too."""
    from svnicp_tpu_torch.core import pointcloud as pc

    g = torch.Generator().manual_seed(0)
    pts = torch.rand((1_000_000, 3), generator=g) * 160.0 - 80.0
    pts[:1000] = torch.round(pts[:1000] / 0.2) * 0.2
    for voxel in (0.2, 0.1, 1.0):
        for fn in (pc.voxel_key, pc.floor_voxel_key):
            assert torch.equal(fn(pts.to(dev), voxel).cpu(), fn(pts, voxel)), (fn, voxel)


def _clouds(seed, b, nt, grid=False):
    g = torch.Generator().manual_seed(seed)
    if grid:
        src = torch.randint(-6, 7, (b, 3), generator=g).double()
        tgt = torch.randint(-6, 7, (nt // 2, 3), generator=g).double()
        tgt = torch.cat([tgt, tgt.flip(0)])
    else:
        src = torch.randn((b, 3), generator=g, dtype=torch.float64) * 10
        tgt = torch.randn((nt, 3), generator=g, dtype=torch.float64) * 10
    return src, tgt, torch.rand(b, generator=g) > 0.1, torch.rand(len(tgt), generator=g) > 0.2


def _on(dev, *xs):
    return [x.to(dev) for x in xs]


@pytest.mark.parametrize("grid", [False, True])
def test_xla_search_on_the_card_equals_the_cpu_in_float64(dev, grid):
    """Stage 1 by index and the exact top-k in float64: indices equal
    (first index at the grid's exact ties), distances to 1e-10."""
    src, tgt, sv, tv = _clouds(1, 300, 5000, grid)
    for fn, kw in ((knn.knn_candidates_bucketed, dict(k=16)),
                   (knn.knn_candidates, dict(k=20, chunk=1024))):
        i_c, d_c = fn(src, tgt, sv, tv, **kw)
        i_g, d_g = fn(*_on(dev, src, tgt, sv, tv), **kw)
        fin = torch.isfinite(d_c)
        assert torch.equal(torch.isfinite(d_g).cpu(), fin)
        assert torch.equal(i_g.cpu()[fin], i_c[fin]), fn.__name__
        torch.testing.assert_close(d_g.cpu()[fin], d_c[fin], rtol=1e-10, atol=1e-10)


def test_xla_stage1_in_float32_equals_float64_except_near_ties(dev):
    """The card's float32 picks (TF32 off) equal the float64 reference's
    except where the reference's two best scores of a group lie within
    2e-6 max(|s|^2, 1), as check_stage1 counts near-ties, and those are
    under 0.1% of the slots."""
    src, tgt, sv, tv = _clouds(2, 2000, 60000)
    i_ref, d_ref = knn.knn_candidates_bucketed(src, tgt, sv, tv, 100)
    i_32, _ = knn.knn_candidates_bucketed(*_on(dev, src.float(), tgt.float(), sv, tv), 100)
    score, _ = knn.group_scores(src, tgt, tv, 100)
    two = torch.topk(score, 2, dim=-1, largest=False).values
    scale = (src * src).sum(-1, keepdim=True).clamp_min(1.0)
    fin = torch.isfinite(d_ref)
    near_tie = fin & ((two[..., 1] - two[..., 0]) <= 2e-6 * scale)
    differ = fin & (i_32.cpu() != i_ref)
    assert bool((near_tie | ~differ).all())
    assert int(differ.sum()) < 1e-3 * int(fin.sum())


def test_nn_among_candidates_on_the_card(dev):
    g = torch.Generator().manual_seed(3)
    cand = torch.randint(-4, 5, (200, 24, 3), generator=g).double()
    cand[:, 12:] = cand[:, :12]
    valid = torch.rand((200, 24), generator=g) > 0.2
    tr = torch.randint(-4, 5, (7, 200, 3), generator=g).double()
    i_c, d_c = knn.nn_among_candidates(tr, cand, valid)
    i_g, d_g = knn.nn_among_candidates(*_on(dev, tr, cand, valid))
    assert torch.equal(i_g.cpu(), i_c)
    assert torch.equal(d_g.cpu(), d_c)


def test_gauss_newton_systems_on_the_card(dev):
    from svnicp_tpu_torch.core import residuals

    g = torch.Generator().manual_seed(4)
    p, b = 9, 500
    src = torch.randn((b, 3), generator=g, dtype=torch.float64) * 5
    r = geo.so3_exp(torch.randn((p, 3), generator=g, dtype=torch.float64) * 0.1)
    tr = torch.einsum("pij,bj->pbi", r, src) + 0.1
    tg = tr + torch.randn((p, b, 3), generator=g, dtype=torch.float64) * 0.3
    nrm = torch.nn.functional.normalize(torch.randn((b, 3), generator=g,
                                                    dtype=torch.float64), dim=-1)
    pv = torch.rand((p, b), generator=g) > 0.3
    ptv = torch.rand(b, generator=g) > 0.1
    for fn, args in ((residuals.ensemble_gauss_newton, (src, tr, tg, pv, ptv, r)),
                     (residuals.ensemble_gauss_newton_plane, (src, tr, tg, nrm, pv, r))):
        want = fn(*args, 3.0)
        got = fn(*_on(dev, *args), 3.0)
        for x, y in zip(got, want):
            torch.testing.assert_close(x.cpu(), y, rtol=1e-10, atol=1e-10)


def test_voxel_candidates_and_kabsch_on_the_card(dev):
    from svnicp_tpu_torch.core import pointcloud as pc
    from svnicp_tpu_torch.core import voxmap

    g = torch.Generator().manual_seed(5)
    pts = torch.randn((3000, 3), generator=g, dtype=torch.float64) * 6
    maps = []
    for d in ("cpu", dev):
        vm = voxmap.create(8192, torch.float64, d)
        vm, _ = voxmap.insert(vm, pc.PaddedCloud(pts.to(d), torch.ones(3000, dtype=torch.bool,
                                                                        device=d)),
                              torch.eye(3, dtype=torch.float64, device=d),
                              torch.zeros(3, dtype=torch.float64, device=d), 0.2, 5, 300.0)
        maps.append(vm)
    assert torch.equal(maps[1].key.cpu(), maps[0].key)
    q = torch.randn((400, 3), generator=g, dtype=torch.float64) * 6
    qv = torch.rand(400, generator=g) > 0.1
    c_c, v_c = voxmap.voxel_candidates(maps[0], q, qv, 0.2, 4)
    c_g, v_g = voxmap.voxel_candidates(maps[1], *_on(dev, q, qv), 0.2, 4)
    assert torch.equal(v_g.cpu(), v_c) and torch.equal(c_g.cpu(), c_c)
    tgt = torch.einsum("ij,pbj->pbi", geo.so3_exp(torch.tensor([0.1, -0.2, 0.3],
                                                               dtype=torch.float64)),
                       pts[:200].expand(4, -1, -1)) + 0.5
    w = torch.rand((4, 200), generator=g, dtype=torch.float64)
    src = pts[:200].expand(4, -1, -1)
    r_c, t_c = geo.kabsch(src, tgt, w)
    r_g, t_g = geo.kabsch(*_on(dev, src, tgt, w))
    torch.testing.assert_close(r_g.cpu(), r_c, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=1e-10, atol=1e-10)


def test_xla_route_launches_no_kernel(dev):
    """A registration with use_pallas off (float32 on the card) launches
    none of B1-B5; the same with use_pallas on launches B1, B2 and B3."""
    from svnicp_tpu_torch.config import SteinICPConfig

    src, tgt, sv, tv = _clouds(6, 512, 8000)
    args = _on(dev, src.float(), sv, tgt.float(), tv)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    init = (torch.rand((8, 6), generator=torch.Generator().manual_seed(6)) * 0.02).to(dev)
    wrappers = (nn.bucketed_candidates, nn.plane_moments, nn.point_moments,
                nn.nn_match, stein.stein_update)
    for use_pallas in (False, True):
        icp = SteinICPConfig(residual="point_to_plane", particle_count=8, iterations=5,
                             knn_count=16, use_pallas=use_pallas)
        before = [w.launches for w in wrappers]
        res = svn.register(icp, args[0], args[1], args[2], args[3], eye, zero, init)
        torch.cuda.synchronize()
        made = [w.launches - b for w, b in zip(wrappers, before)]
        if use_pallas:
            # whole rounds of ALIGN_CHUNK passes, frozen ones included
            passes = -(-res.iterations // svn.ALIGN_CHUNK) * svn.ALIGN_CHUNK
            assert made == [1, passes, 0, 0, passes], made
        else:
            assert made == [0] * 5, made


def test_posegraph_and_reanchor_on_the_card(dev):
    """The pose graph's float32 Gauss-Newton on the card against the same
    on the CPU (1e-4: two devices' float32 sums of one dense solve), and the
    re-anchor's map move on the card against the CPU's, in float64 (where
    no point lies within rounding of a voxel edge): the same keys and
    validity, the points within 1e-12 m."""
    import copy

    from svnicp_tpu_torch.core import pointcloud as pc
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.runtime import pipeline as pl
    from svnicp_tpu_torch.runtime import posegraph, posegraph_driver
    from svnicp_tpu_torch.config import PipelineConfig

    rng = np.random.default_rng(0)
    g = posegraph.PoseGraph(keyframe_trans_threshold=0.5, device="cpu")
    for i in range(30):
        th = 2 * np.pi * i / 28 + 0.003 * i
        r = geo.so3_exp(torch.tensor([0.0, 0.0, th], dtype=torch.float64)).numpy()
        t = np.array([4 * np.sin(th), 4 - 4 * np.cos(th), 0.0]) + 0.01 * rng.normal(size=3)
        g.maybe_add_keyframe(0.1 * i, r, t, np.eye(6) * 1e-4)
    n = len(g.nodes_r)
    g.add_loop_edge(0, n - 1, g.nodes_r[0].T @ g.nodes_r[n - 1] @ geo.so3_exp(
        torch.tensor([0.0, 0.0, -0.05], dtype=torch.float64)).numpy(),
        np.array([0.3, -0.2, 0.0]), np.eye(6) * 1e-3)
    on_card = copy.deepcopy(g)
    on_card.device = dev
    g.optimize(8)
    on_card.optimize(8)
    np.testing.assert_allclose(np.stack(on_card.nodes_t), np.stack(g.nodes_t), atol=1e-4)
    np.testing.assert_allclose(np.stack(on_card.nodes_r), np.stack(g.nodes_r), atol=1e-4)

    cfg = PipelineConfig(dtype="float64")
    state = pl.init_state(cfg, "cpu")
    pts = torch.from_numpy(rng.uniform(-30, 30, (5000, 3)))
    vm, _ = voxmap.insert(state.vmap, pc.PaddedCloud(pts, torch.ones(5000, dtype=torch.bool)),
                          torch.eye(3, dtype=torch.float64),
                          torch.zeros(3, dtype=torch.float64), 1.0, 20, 300.0)
    state = state._replace(vmap=vm)
    dr = geo.so3_exp(torch.tensor([0.0, 0.02, 0.4], dtype=torch.float64))
    dt = torch.tensor([1.5, -0.7, 0.1], dtype=torch.float64)
    want = posegraph_driver._reanchor_state(cfg, state, dr, dt)
    card_state = pl.init_state(cfg, dev)._replace(vmap=voxmap.VoxelMap(
        *(x.to(dev) for x in vm)))
    got = posegraph_driver._reanchor_state(cfg, card_state, dr.to(dev), dt.to(dev))
    assert torch.equal(got.vmap.key.cpu(), want.vmap.key)
    assert torch.equal(got.vmap.valid.cpu(), want.vmap.valid)
    assert int(want.vmap.valid.sum()) > 1000
    torch.testing.assert_close(got.vmap.points.cpu(), want.vmap.points, rtol=0, atol=1e-12)


def _batch_run(dev, batch: int, n_frames: int = 7):
    """A small host-downsampled ICP run on the card, per frame or batched."""
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.io import datasets
    from svnicp_tpu_torch.runtime import pipeline as pl

    cfg = cfg_mod.PipelineConfig(
        icp=cfg_mod.SteinICPConfig(particle_count=8, iterations=20, knn_count=16,
                                   residual="point_to_plane", use_pallas=True,
                                   source_capacity=1024, target_capacity=8192),
        map=cfg_mod.MapConfig(voxel_size=1.0, capacity=32768),
        preprocess=cfg_mod.PreprocessConfig(min_range=1.0, max_range=50.0,
                                            voxel_size=1.0, raw_capacity=8192,
                                            host_downsample=True),
        lio=cfg_mod.LIOConfig(estimator="icp", frame_gap_seconds=0.0),
        dispatch_batch=batch)
    world = datasets.SyntheticWorld(extent=40.0, seed=3)
    times, rots, trans = datasets.synthetic_trajectory(n_frames, dt=0.1, speed=1.2, seed=5)
    rng = np.random.default_rng(5)
    pipe = pl.LIOPipeline(cfg, device=dev)
    for i in range(n_frames):
        pipe.feed_scan(float(times[i]), world.scan_at(rng, rots[i], trans[i], n_points=4000))
    pipe.close()
    return pipe


def test_batched_step_makes_one_upload_and_one_readback_per_batch(dev):
    """dispatch_batch=3 over 7 frames (the bootstrap and two batches): one
    stacked upload and one read-back of the packed outputs per batch, the
    poses and variances bit-identical to per-frame dispatch, the outputs
    served on the host; the profiler's host-to-device copies from pinned
    memory are printed."""
    from torch.profiler import ProfilerActivity, profile

    from svnicp_tpu_torch.runtime import packing

    ref = _batch_run(dev, 1)
    packing.copies.update(upload=0, readback=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe = _batch_run(dev, 3)
        poses = [o.pose_t for o in pipe.outputs[1:]]
    assert packing.copies == {"upload": 2, "readback": 2}, packing.copies
    for a, b in zip(pipe.outputs, ref.outputs):
        assert torch.equal(a.pose_t.cpu(), b.pose_t.cpu())
        assert torch.equal(a.var_icp.cpu(), b.var_icp.cpu())
        assert a.icp_iterations == b.icp_iterations
    assert all(p.device.type == "cpu" for p in poses)
    copies = {}
    for e in prof.key_averages():
        if "Memcpy" in e.key:
            copies[e.key] = e.count
    print(f"copies {packing.copies}; profiler memcpy counts {copies}")


def test_host_frame_output_on_the_card_equals_frame_output(dev):
    """Packing a FrameOutput of the card and reading it through
    HostFrameOutput gives every field bit for bit, as CPU tensors and the
    port's host types, with one read-back."""
    from svnicp_tpu_torch.runtime import packing

    pipe = _batch_run(dev, 1, n_frames=3)
    out = pipe.outputs[-1]
    assert out.pose_t.device.type == "cuda"
    before = packing.copies["readback"]
    host = packing.HostFrameOutput(packing.pack_output(out))
    for name, _ in packing._PACK_F32:
        got = getattr(host, name)
        assert got.device.type == "cpu"
        assert torch.equal(got, getattr(out, name).cpu()), name
    assert host.icp_iterations == out.icp_iterations and type(host.icp_iterations) is int
    assert host.align_ok is out.align_ok
    assert int(host.map_points) == int(out.map_points)
    assert host.particles is out.particles
    assert packing.copies["readback"] == before + 1


@pytest.mark.parametrize("path,kernel", [("tpu_plane.yaml", "B2"), ("geode_alpha.yaml", "B4")])
def test_moments_at_the_mesh_shard_shapes(dev, path, kernel):
    """B2 and B4 as each shard of the (2, 4) mesh runs them (P=32 of 64 and
    P=5 of 10 particles, 1,024 of 4,096 rows, K=32 and 104), on the
    shard's own operands (`chip_smoke.mesh_shard_moments_inputs`): held to
    the plain version run in float64 as `chip_smoke.check_moments` holds
    every path's operands, repeats bit-identical."""
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    from svnicp_tpu_torch import config as cfg_mod

    cfg = cfg_mod.from_yaml(str(root / "configs" / path))
    seq = (chip_smoke.bench_sequence(3) if kernel == "B2"
           else chip_smoke.geode_sequence(3))
    src, sv, tgt, tv = chip_smoke.stage1_inputs(cfg, seq[3], dev)
    params, prep = chip_smoke.mesh_shard_moments_inputs(
        cfg.icp, src, sv, tgt, tv, dev, cfg.icp.source_capacity // 4,
        cfg.icp.particle_count // 2)
    assert params.shape[0] == cfg.icp.particle_count // 2
    assert prep.feat13.shape[2] == 1024
    assert isinstance(prep, nn.PlanePrep if kernel == "B2" else nn.PointPrep)
    chip_smoke.check_moments(f"mesh shard {path}", params, prep, cfg.icp.max_dist, [])


def test_in_process_mesh_on_the_card_equals_the_cpu(dev):
    """The (2, 4) mesh with its 8 shards on cuda:0 against the same mesh on
    the CPU, float64: the sharded registration to 1e-9 (rounding of the
    card's products), the sharded map's insert and rebalance exactly."""
    from svnicp_tpu_torch.config import SteinICPConfig
    from svnicp_tpu_torch.core import pointcloud as pc
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.io import datasets
    from svnicp_tpu_torch.parallel import sharding
    from svnicp_tpu_torch.parallel import voxmap_sharded as vms

    world = datasets.SyntheticWorld(extent=30.0, seed=1)
    _, rots, trans = datasets.synthetic_trajectory(2, dt=0.5, speed=2.0, seed=1)
    rng = np.random.default_rng(1)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=2500).astype(np.float64)
             for i in range(2)]
    cfg = SteinICPConfig(particle_count=8, iterations=12, lr=1.0, max_dist=2.8,
                         knn_count=16, early_stop=False)
    lb, ub = np.array(cfg.init_lb), np.array(cfg.init_ub)
    init = lb + (ub - lb) * np.random.default_rng(2).random((8, 6))
    src = scans[1][::4][:512]
    results = {}
    for where in ("cpu", dev):
        mesh = sharding.make_mesh(2, 4, devices=[where] * 8)

        def t(a, dtype=torch.float64):
            return torch.as_tensor(np.asarray(a)).to(device=where, dtype=dtype)

        res = sharding.sharded_register(
            mesh, cfg, t(src), t(np.ones(len(src)), torch.bool), t(scans[0]),
            t(np.ones(len(scans[0])), torch.bool), t(rots[1]), t(trans[1]), t(init))
        vmap = voxmap.create(4096, torch.float64, where)
        vmap, dropped = vms.sharded_insert(
            mesh, vmap, pc.PaddedCloud(t(scans[0]), t(np.ones(2500), torch.bool)),
            t(rots[0]), t(trans[0]), 1.0, 5, 100.0,
            split_keys=vms.uniform_split_keys(4, where))
        vmap, splits, shed = vms.rebalance(mesh, vmap, vms.uniform_split_keys(4, where),
                                           sample_per_shard=64)
        results[str(where)] = (res, vmap, splits, int(dropped), int(shed))
    (r_c, m_c, s_c, d_c, e_c), (r_g, m_g, s_g, d_g, e_g) = results.values()
    np.testing.assert_allclose(r_g.mean.cpu().numpy(), r_c.mean.numpy(), atol=1e-9)
    np.testing.assert_allclose(r_g.particles.cpu().numpy(), r_c.particles.numpy(), atol=1e-9)
    assert int(r_g.iterations) == int(r_c.iterations) == 12
    assert torch.equal(m_g.key.cpu(), m_c.key) and torch.equal(m_g.valid.cpu(), m_c.valid)
    assert torch.equal(s_g.cpu(), s_c) and (d_g, e_g) == (d_c, e_c)


@pytest.mark.parametrize("textbook", [False, True])
@pytest.mark.parametrize("n", [1, 10, 11, 256])
def test_eskf_propagate_kernel(dev, n, textbook):
    """F1 against the per-sample ops route on the card: in float32 against
    the float32 route and the float64 one, and in float64; nonzero biases, a
    small-angle sample and the first interval from the window's first row
    (test_torch_eskf_propagate.eskf_operands)."""
    from svnicp_tpu_torch.kernels import eskf as eskf_kernel
    from test_torch_eskf_propagate import NOISE, eskf_operands, propagate_close, state_to

    s32, r32 = eskf_operands(n, torch.float32)
    s32, r32 = state_to(s32, dev), r32.to(dev)
    s64, r64 = eskf_operands(n, torch.float64)
    s64, r64 = state_to(s64, dev), r64.to(dev)
    before = eskf_kernel.propagate.launches
    k32 = eskf_kernel.propagate(s32, r32, NOISE, textbook)
    k64 = eskf_kernel.propagate(s64, r64, NOISE, textbook)
    torch.cuda.synchronize()
    assert eskf_kernel.propagate.launches == before + 2
    p32 = eskf_kernel.propagate_plain(s32, r32, NOISE, textbook)
    p64 = eskf_kernel.propagate_plain(s64, r64, NOISE, textbook)
    # float32 over up to 256 chained samples: the kernel's and the ops
    # route's sums in another order drift apart by a few units in the last
    # place a sample; the float32 route itself sits 3e-6 (nav) and 6e-6 (Q)
    # of the largest entry from float64 at 256 samples (on the CPU)
    propagate_close(k32, p32, 5e-6, 2e-5)
    propagate_close(k32, state_to(p64, torch.float32), 1e-5, 4e-5)
    propagate_close(k64, p64, 1e-12, 1e-12)
    again = eskf_kernel.propagate(s32, r32, NOISE, textbook)
    assert all(torch.equal(a, b) for a, b in zip((*k32.nav, k32.cov), (*again.nav, again.cov)))
    names = _kernel_names(lambda: eskf_kernel.propagate(s32, r32, NOISE, textbook))
    assert len(names) == 1 and "eskf_propagate" in names[0], names


def _geode_live_drive(n: int):
    """n GEODE frames as the live cell drives them: configs/geode_alpha.yaml,
    32,000-point scans at 10 Hz, a 100 Hz IMU (10 samples a frame), and each
    frame's particle draws -> (config, feed), feed(pipe, k) feeding frame k."""
    import pathlib

    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = cfg_mod.from_yaml(str(root / "configs" / "geode_alpha.yaml"))
    sub = 10
    world = datasets.SyntheticWorld(extent=60.0, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(
        (n - 1) * sub + 1, dt=0.1 / sub, speed=1.5, seed=7, ramp_seconds=1.0)
    rng = np.random.default_rng(7)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=32000)
             for i in range(0, len(times), sub)]
    imu = datasets.synthetic_imu(times, rots, trans, GRAVITY)
    lb, ub = np.array(cfg.icp.init_lb), np.array(cfg.icp.init_ub)
    draws = (lb + (ub - lb) * rng.random((n, cfg.icp.particle_count, 6))).astype(np.float32)

    def feed(pipe, k):
        for j in range(max((k - 1) * sub + 1, 0), k * sub + 1):
            pipe.feed_imu(*imu[j])
        return pipe.feed_scan(float(times[k * sub]), scans[k], init_particles=draws[k])

    return cfg, feed


def _ops_route(ekf, rows, noise, textbook=False):
    from svnicp_tpu_torch.kernels import eskf as eskf_kernel

    return eskf_kernel.propagate_plain(ekf, rows, noise, textbook)


def _ops_route_in_float64(ekf, rows, noise, textbook=False):
    """The per-sample ops route computed in float64 and rounded to the
    state's dtype at the window's end: the same propagation, rounded once
    instead of at every operation."""
    from svnicp_tpu_torch.kernels import eskf as eskf_kernel
    from test_torch_eskf_propagate import state_to

    out = eskf_kernel.propagate_plain(state_to(ekf, torch.float64), rows.double(), noise,
                                      textbook)
    return state_to(out, ekf.cov.dtype)


def _free_run(cfg, feed, n, dev, nudge_after=None):
    """A LIOPipeline on the card fed n frames with nothing stepped from
    another run; with `nudge_after` = k, every entry of the filter's nav
    state (R, t, v) and covariance is moved up by one unit in the last
    place after frame k -> (positions [n,3], iterations per frame)."""
    from svnicp_tpu_torch.runtime import pipeline

    def up(x):
        return torch.nextafter(x, torch.full_like(x, float("inf")))

    pipe = pipeline.LIOPipeline(cfg, device=dev)
    poses, iters = [], []
    for k in range(n):
        out = feed(pipe, k)
        assert bool(out.align_ok), k
        poses.append(out.pose_t.double().cpu())
        iters.append(int(out.icp_iterations))
        if k == nudge_after:
            ekf = pipe.state.eskf
            ekf = ekf._replace(nav=type(ekf.nav)(*(up(x) for x in ekf.nav)), cov=up(ekf.cov))
            pipe.state = pipe.state._replace(eskf=ekf)
    pipe.close()
    return torch.stack(poses), iters


def test_pipeline_propagates_each_imu_window_in_one_launch(dev, monkeypatch):
    """30 GEODE frames (configs/geode_alpha.yaml, 32,000-point scans, a
    100 Hz IMU: 10 samples a frame) through LIOPipeline on the card: F1
    launches once for every frame that carries IMU samples, and each frame
    stepped by the per-sample ops route from the kernel run's own state
    (a second pipeline fed alike, the same particle draws) predicts the
    same pose to float32's rounding and registers it within 1 mm. Two free
    runs would not do: the float32 stop statistic is chaotic at its
    threshold, so a 1e-10 m gap in one prediction moves the iteration counts
    and two runs drift apart by centimetres in 30 frames, the ops route
    from another rounding of itself too (test_float32_free_runs_part_by_
    rounding_alone); free runs are held together in float64."""
    from svnicp_tpu_torch.kernels import eskf as eskf_kernel
    from svnicp_tpu_torch.runtime import pipeline, profiling

    n = 30
    cfg, feed = _geode_live_drive(n)
    kernel = eskf_kernel.propagate

    pipe_k = pipeline.LIOPipeline(cfg, device=dev)
    pipe_o = pipeline.LIOPipeline(cfg, device=dev)
    before, windows, predicts, guess_gaps, pose_gaps = kernel.launches, 0, 0, [], []
    for k in range(n):
        pipe_o.state = pipe_k.state
        with profiling.tracing() as trace:
            out_k = feed(pipe_k, k)
        windows += trace.counters.get("svnicp.filter.kernel_windows", 0)
        predicts += len(trace.named("svnicp.filter.predict"))
        monkeypatch.setattr(eskf_kernel, "propagate", _ops_route)
        out_o = feed(pipe_o, k)
        monkeypatch.setattr(eskf_kernel, "propagate", kernel)
        assert bool(out_k.align_ok) and bool(out_o.align_ok)
        guess_gaps.append(float((out_k.guess_t - out_o.guess_t).norm()))
        pose_gaps.append(float((out_k.pose_t - out_o.pose_t).norm()))
    pipe_k.close()
    pipe_o.close()
    print(f"kernel vs ops route from the same state, {n} GEODE frames: largest "
          f"guess gap {max(guess_gaps):.3e} m, pose gap {max(pose_gaps):.3e} m")
    # every frame carries IMU samples; the first is the map's bootstrap,
    # which propagates nothing
    assert windows == predicts == kernel.launches - before == n - 1
    assert max(guess_gaps) < 1e-5     # a few float32 ulps at the drive's ~5 m
    assert max(pose_gaps) < 1e-3      # two steps of the 5e-4 stop threshold


def test_free_runs_of_the_two_routes_agree_in_float64(dev, monkeypatch):
    """The same 30 GEODE frames in float64 (the XLA route of the
    registration; F1 in float64), one pipeline on F1 and one on the
    per-sample ops route, neither stepped from the other: their positions
    stay within 1 mm, so F1 builds up no bias over the frames; the
    float32 runs are measured beside them (PERF.md)."""
    import dataclasses

    from svnicp_tpu_torch.kernels import eskf as eskf_kernel

    n = 30
    cfg, feed = _geode_live_drive(n)
    cfg = dataclasses.replace(cfg, dtype="float64",
                              icp=dataclasses.replace(cfg.icp, use_pallas=False))
    before = eskf_kernel.propagate.launches
    pos_k, it_k = _free_run(cfg, feed, n, dev)
    assert eskf_kernel.propagate.launches - before == n - 1
    monkeypatch.setattr(eskf_kernel, "propagate", _ops_route)
    pos_o, it_o = _free_run(cfg, feed, n, dev)
    gap = float((pos_k - pos_o).norm(dim=1).max())
    print(f"float64, {n} GEODE frames, free runs: F1 against the ops route, largest "
          f"position gap {gap:.3e} m; iterations {sum(it_k)} against {sum(it_o)}, "
          f"{sum(a != b for a, b in zip(it_k, it_o))} frames differ")
    assert gap < 1e-3


def test_float32_free_runs_part_by_rounding_alone(dev, monkeypatch):
    """Why the float32 comparison of the two routes steps one from the
    other's state: the per-sample ops route, run free on the same 30 GEODE
    frames beside itself computed in float64 and rounded once a window (the
    same propagation, another rounding), parts further than the 1 mm that
    test_pipeline_propagates_each_imu_window_in_one_launch holds the two
    routes to, as F1 does (the float32 stop statistic is chaotic at its
    threshold); each run repeats itself bit for bit. Printed beside: the
    ops route with every entry of its filter state moved by one unit in
    the last place after frame 1."""
    from svnicp_tpu_torch.kernels import eskf as eskf_kernel

    n = 30
    cfg, feed = _geode_live_drive(n)
    pos_k, it_k = _free_run(cfg, feed, n, dev)
    monkeypatch.setattr(eskf_kernel, "propagate", _ops_route)
    pos_o, it_o = _free_run(cfg, feed, n, dev)
    again, _ = _free_run(cfg, feed, n, dev)
    pos_u, it_u = _free_run(cfg, feed, n, dev, nudge_after=1)
    monkeypatch.setattr(eskf_kernel, "propagate", _ops_route_in_float64)
    pos_r, it_r = _free_run(cfg, feed, n, dev)

    def parted(pos, its):
        gap = (pos - pos_o).norm(dim=1)
        first = next((k for k, (a, b) in enumerate(zip(it_o, its)) if a != b), None)
        return float(gap.max()), (f"{float(gap.max()):.3e} m (iterations first differ at "
                                  f"frame {first}, {sum(its)} against {sum(it_o)})")

    _, k_line = parted(pos_k, it_k)
    rounded, r_line = parted(pos_r, it_r)
    _, u_line = parted(pos_u, it_u)
    print(f"float32, {n} GEODE frames, free runs against the ops route: F1 {k_line}; "
          f"the ops route rounded once a window {r_line}; nudged by one ulp after frame 1 "
          f"{u_line}")
    assert torch.equal(again, pos_o)
    assert rounded > 1e-3


# ------------------------------------------- SubT-MRS at its full map (2^20 rows)

FULL = 2**20


def test_stage1_kernel_at_the_full_subt_target(dev):
    """B1 at the SubT-MRS deployment's shapes: 8,192 sources against a
    2^20-row target (blocks of 128 rows dealt to k=100 groups of 10,496
    rows, a 16.8 MB prep buffer), a third of the rows invalid, against its
    plain version on every 16th source. A score |c|^2 - 2 s.c here reaches
    ~2e4, where float32's unit in the last place is ~2e-3: slots whose
    runner-up lies within 0.05 of the minimum may pick the other target
    under the kernel's rounding (fewer than 1% of them), and the squared
    distance max(best + |s|^2, 0) carries that cancellation (atol 1e-2)."""
    g = torch.Generator().manual_seed(20)
    b, k = 8192, 100
    tgt = (torch.rand((FULL, 3), generator=g) * 120 - 60).to(dev)
    tv = (torch.rand(FULL, generator=g) < 0.66).to(dev)
    src = (torch.rand((b, 3), generator=g) * 100 - 50).to(dev)
    sv = (torch.rand(b, generator=g) < 0.95).to(dev)
    assert knn.bucket_block_size(FULL, k) == 128
    cand_k, d2_k = nn.bucketed_candidates(src, tgt, sv, tv, k)
    torch.cuda.synchronize()
    rows = torch.arange(0, b, 16, device=dev)
    cand_p, d2_p = nn.bucketed_candidates_plain(src[rows], tgt, sv[rows], tv, k)
    fin = torch.isfinite(d2_p)
    assert torch.equal(torch.isfinite(d2_k[rows]), fin)
    assert torch.equal(torch.isfinite(d2_k).any(1), sv)
    score, _ = knn.group_scores(src[rows], tgt, tv, k)
    two = torch.topk(score, 2, dim=-1, largest=False).values
    del score
    keep = fin & (two[..., 1] - two[..., 0] > 0.05)
    assert int((fin & ~keep).sum()) < 0.01 * int(fin.sum())
    torch.testing.assert_close(cand_k[rows][keep], cand_p[keep], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(d2_k[rows][keep], d2_p[keep], rtol=1e-4, atol=1e-2)


def test_voxmap_on_a_full_table_matches_the_cpu(dev):
    """`voxmap.insert` and `query_radius` on a 2^20-row map, ~700,000 rows
    held (as the SubT-MRS live drive's map at its end): the sorts, the
    run starts' binary search and the compaction into a 2^20-row target
    give the card the CPU's rows, keys and counts exactly (the pose's
    rotation is the identity, so the transform rounds alike on both)."""
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.core.pointcloud import PaddedCloud

    g = torch.Generator().manual_seed(7)
    held = torch.rand((700_000, 3), generator=g) * torch.tensor([120.0, 120.0, 8.0]) \
        - torch.tensor([60.0, 60.0, 0.5])
    scan = torch.rand((16384, 3), generator=g) * 80 - 40
    scan_valid = torch.rand(16384, generator=g) < 0.9
    eye = torch.eye(3)
    pose_t = torch.tensor([1.5, -2.25, 0.125])
    out = {}
    for d in ("cpu", dev):
        vmap = voxmap.create(FULL, device=d)
        vmap, dropped0 = voxmap.insert(vmap, PaddedCloud(held.to(d), torch.ones(
            len(held), dtype=torch.bool, device=d)), eye.to(d), torch.zeros(3, device=d),
            0.2, 1, 100.0)
        vmap, dropped = voxmap.insert(vmap, PaddedCloud(scan.to(d), scan_valid.to(d)),
                                      eye.to(d), pose_t.to(d), 0.2, 1, 100.0)
        target, overflow = voxmap.query_radius(vmap, pose_t.to(d), 70.0, FULL)
        out[str(d)] = [x.cpu() for x in (*vmap, dropped0, dropped, *target, overflow)]
    cpu, card = out["cpu"], out[str(dev)]
    rows = int(cpu[2].sum())
    assert 600_000 < rows < FULL and int(cpu[4]) == 0 and int(cpu[7]) == 0
    for a, b_ in zip(cpu, card):
        assert torch.equal(a, b_)


def _cummax_run_start(sorted_key):
    """Each row's run start as a prefix-max scan over the run-start
    indices: the reference for `voxmap._run_start`."""
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    idx = torch.arange(sorted_key.shape[0], device=sorted_key.device)
    return torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values


def test_map_run_starts_by_search_at_the_full_table(dev):
    """At the SubT-MRS insert's 2^20 + 16,384 merged rows, ~700,000 keys
    and an INVALID_KEY tail, the binary search's run starts equal the
    prefix-max scan's bit for bit on the card; one insert and one radius
    query of a 2^20-row map launch no scan kernel and count two
    searches."""
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.core.pointcloud import INVALID_KEY, PaddedCloud
    from svnicp_tpu_torch.runtime import profiling

    g = torch.Generator().manual_seed(23)
    key = torch.randint(-350_000, 350_000, (FULL + 16384,), generator=g,
                        dtype=torch.int32)
    key[-300_000:] = INVALID_KEY
    key = torch.sort(key).values.to(dev)
    start = voxmap._run_start(key)
    assert start.dtype == torch.int64
    assert torch.equal(start, _cummax_run_start(key))

    held = torch.rand((700_000, 3), generator=g) * torch.tensor([120.0, 120.0, 8.0]) \
        - torch.tensor([60.0, 60.0, 0.5])
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    vmap, _ = voxmap.insert(voxmap.create(FULL, device=dev), PaddedCloud(
        held.to(dev), torch.ones(len(held), dtype=torch.bool, device=dev)),
        eye, zero, 0.2, 1, 100.0)
    scan = PaddedCloud((torch.rand((16384, 3), generator=g) * 80 - 40).to(dev),
                       torch.ones(16384, dtype=torch.bool, device=dev))

    def step():
        voxmap.insert(vmap, scan, eye, zero, 0.2, 1, 100.0)
        voxmap.query_radius(vmap, zero, 70.0, FULL)

    names = _kernel_names(step, calls=1)
    assert not [n for n in names if "scan_innermost_dim_with_indices" in n], names
    assert [n for n in names if "searchsorted" in n], names
    with profiling.tracing() as trace:
        step()
    assert trace.counters["svnicp.map.run_searches"] == 2


def test_icp_frame_at_full_size_counts_every_stage1_score(dev):
    """One registered frame of the SubT-MRS deployment as the benchmark
    runs it (`lio_bench/configs/subt_mrs_fullmap.yaml`): stage 1 scores the
    8,192-row source against the whole 2^20-row target, padding rows
    included, and the constant-velocity guess opens its span on the card."""
    from pathlib import Path

    import yaml

    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.io import datasets
    from svnicp_tpu_torch.runtime import pipeline as pl
    from svnicp_tpu_torch.runtime import profiling

    path = Path(__file__).resolve().parents[1] / "lio_bench/configs/subt_mrs_fullmap.yaml"
    cfg = cfg_mod.from_dict(yaml.safe_load(path.read_text())["pipeline"])
    assert cfg.map.capacity == cfg.icp.target_capacity == FULL
    world = datasets.SyntheticWorld(extent=60.0, n_walls=14, n_boxes=10, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(2, dt=0.1, speed=1.5, seed=7)
    rng = np.random.default_rng(20)
    pipe = pl.LIOPipeline(cfg, device=dev)
    with profiling.tracing() as trace:
        for k in range(2):
            pipe.feed_scan(float(times[k]), world.scan_at(rng, rots[k], trans[k],
                                                          n_points=32000, max_range=60.0))
    pipe.close()
    assert trace.counters["svnicp.candidates.scores"] == 8192 * FULL
    assert trace.counters["svnicp.candidates.target_rows"] == FULL
    predict = trace.named("svnicp.predict")
    assert len(predict) == 2 and all(s.device_ms is not None for s in predict)
    out = pipe.outputs[-1]
    assert out.align_ok and out.icp_iterations >= 1
    assert int(out.map_dropped) == 0 and int(out.target_overflow) == 0
