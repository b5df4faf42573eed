"""Stage-1 candidate search and the per-iteration 1-NN by index.

Port of `svnicp_tpu/kernels/knn.py`. The target is split into k
BLOCKED-CYCLIC groups: contiguous blocks of `bucket_block_size(nt, k)` rows
are dealt round-robin to the k slots (row (o*k + c)*blk + j lands in slot
c), and each source point takes the nearest valid target of every slot.
Two routes use that layout, chosen by the configuration as the JAX package
chooses them (`find_candidate_points`):
- the kernel route (`use_pallas` with the bucketed method): the stage-1
  kernel B1 and its plain version (`kernels/nn.py`), which average equal
  minima as the Pallas kernel does;
- the index route (everything else, the JAX package's XLA route):
  `knn_candidates_bucketed`, `knn_candidates` (exact streamed top-k) and
  `nn_among_candidates`, plain torch ops that take the FIRST index at tied
  minima (`torch.argmin`, and stable sorts where JAX takes `lax.top_k`,
  which puts the lower index first among equal values).
Products run in full float32 (the JAX package asks for Precision.HIGHEST;
`device.resolve_device` turns TF32 off on the card).
"""

from __future__ import annotations

import torch


def bucket_block_size(nt: int, k: int) -> int:
    """Largest power of two <= 128 that still deals >= 4 blocks to every
    slot, floored at 8 (the stage-1 kernel and this oracle must agree)."""
    b = 8
    while b < 128 and (b * 2) * k * 4 <= max(nt, 1):
        b *= 2
    return b


def group_scores(source: torch.Tensor, target: torch.Tensor,
                 target_valid: torch.Tensor, k: int):
    """Scores |t|^2 - 2<s,t> (+inf at invalid targets) arranged by slot:
    returns (score [Ns,k,group], target rows [k,group] in the same layout,
    with rows >= Nt marking the zero padding). The score is written once
    into its slot-major layout."""
    ns, nt = source.shape[0], target.shape[0]
    blk = bucket_block_size(nt, k)
    pad = (-nt) % (k * blk)
    if pad:
        target = torch.cat([target, target.new_zeros((pad, 3))])
        target_valid = torch.cat([target_valid,
                                  target_valid.new_zeros((pad,))])
    group = target.shape[0] // k
    t2 = (target * target).sum(-1)
    # t2 - 2 s.t, in place (-2x is exact, so the order of the sum is moot)
    score = (source @ target.T).mul_(-2.0).add_(t2[None, :])
    score = score.masked_fill_(~target_valid[None, :], float("inf"))
    # row i = (o*k + c)*blk + j lands in slot c at position o*blk + j: the
    # reshape below is the one copy of the score
    score = score.reshape(ns, group // blk, k, blk).transpose(1, 2)
    rows = torch.arange(target.shape[0], device=source.device)
    rows = rows.reshape(group // blk, k, blk).transpose(0, 1)
    return score.reshape(ns, k, group), rows.reshape(k, group)


def knn_candidates_bucketed(source, target, source_valid, target_valid, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The nearest valid target of each of the k groups, first index at
    ties -> (target rows [Ns,k] int64, squared distances [Ns,k], +inf where
    the group is empty or the source invalid)."""
    score, rows = group_scores(source, target, target_valid, k)
    within = torch.argmin(score, dim=-1)                         # [Ns,k]
    best = torch.gather(score, 2, within[..., None])[..., 0]
    del score
    idx = torch.gather(rows.expand(source.shape[0], -1, -1), 2,
                       within[..., None])[..., 0]
    s2 = (source * source).sum(-1, keepdim=True)
    d2 = (best + s2).clamp_min(0.0)
    d2 = torch.where(torch.isfinite(best), d2, torch.full_like(d2, float("inf")))
    d2 = torch.where(source_valid[:, None], d2, torch.full_like(d2, float("inf")))
    return idx, d2


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(|a|^2 - 2 a.b + |b|^2, 0): [N,3] x [M,3] -> [N,M]."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)
    return (a2 - 2.0 * (a @ b.T) + b2[None, :]).clamp_min(0.0)


def knn_candidates(source, target, source_valid, target_valid, k: int,
                   chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest valid targets of every source point, exact, in
    ascending distance with the lower index first at ties -> (rows [Ns,k],
    squared distances [Ns,k], +inf past the valid targets or at an invalid
    source). The target streams in `chunk`-row tiles with a running merge,
    so at most [Ns, k + chunk] distances are live."""
    ns, nt = source.shape[0], target.shape[0]
    pad = (-nt) % chunk
    if pad:
        target = torch.cat([target, target.new_zeros((pad, 3))])
        target_valid = torch.cat([target_valid, target_valid.new_zeros((pad,))])
    best_d = source.new_full((ns, k), float("inf"))
    best_i = torch.zeros((ns, k), dtype=torch.int64, device=source.device)
    cols = torch.arange(chunk, device=source.device)
    for base in range(0, target.shape[0], chunk):
        d = _sq_dists(source, target[base:base + chunk])
        d = d.masked_fill_(~target_valid[None, base:base + chunk], float("inf"))
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, (base + cols).expand(ns, -1)], dim=1)
        # the running set's entries come first, and their indices are lower
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    best_d = torch.where(source_valid[:, None], best_d,
                         torch.full_like(best_d, float("inf")))
    return best_i, best_d


def nn_among_candidates(transformed: torch.Tensor, cand_pts: torch.Tensor,
                        cand_valid: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every particle's 1-NN among each point's candidates, first index at
    ties: transformed [P,B,3], cand_pts [B,K,3], cand_valid [B,K] ->
    (slot [P,B] into K, squared distance [P,B], +inf with no candidate)."""
    t2 = (transformed * transformed).sum(-1)                   # [P,B]
    c2 = (cand_pts * cand_pts).sum(-1)                         # [B,K]
    cross = torch.einsum("pbd,bkd->pbk", transformed, cand_pts)
    d2 = t2[..., None] - 2.0 * cross + c2[None]
    d2 = d2.masked_fill_(~cand_valid[None], float("inf"))
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, 2, idx[..., None])[..., 0]
    return idx, best


def gather_candidates(target: torch.Tensor, cand_idx: torch.Tensor,
                      cand_d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate points [B,K,3] and validity [B,K] from target rows; a row
    past the target (an empty group's padding) reads the last row, as JAX
    clamps an out-of-range gather."""
    pts = target[cand_idx.clamp(0, target.shape[0] - 1)]
    return pts, torch.isfinite(cand_d2)


def find_candidates(cfg, source_at_guess, target, source_valid, target_valid
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidates by index as (rows [B,K], squared distances [B,K]):
    the exact top-k for "topk", the blocked-cyclic groups otherwise (the
    JAX package's `find_candidates`, which the mesh's stage 1 runs)."""
    if cfg.candidate_method == "topk":
        return knn_candidates(source_at_guess, target, source_valid, target_valid,
                              cfg.knn_count)
    return knn_candidates_bucketed(source_at_guess, target, source_valid,
                                   target_valid, cfg.knn_count)


def find_candidate_points(cfg, source_at_guess, target, source_valid,
                          target_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidates as points (cand_pts [B,K,3], cand_valid [B,K]):
    kernel B1 (its plain version on the CPU) for the bucketed method with
    use_pallas; otherwise by index, the exact top-k for "topk" and the
    blocked-cyclic groups for the other methods."""
    if cfg.candidate_method == "bucketed" and cfg.use_pallas:
        from svnicp_tpu_torch.kernels import nn   # nn imports this module
        pts, d2 = nn.bucketed_candidates(source_at_guess, target, source_valid,
                                         target_valid, cfg.knn_count)
        return pts, torch.isfinite(d2)
    idx, d2 = find_candidates(cfg, source_at_guess, target, source_valid, target_valid)
    return gather_candidates(target, idx, d2)
