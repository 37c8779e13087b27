"""Lloyd k-means: the coarse-quantizer trainer, flat and two-level.

The counterpart of ``densephrases_tpu/ops/kmeans.py``:

- assignment: argmin ||x - c||² = argmin (||c||² - 2 x·c), one
  [chunk, k] product per data chunk;
- update: centroid sums as ``onehot(assign)ᵀ @ x``, another product;
- empty clusters are re-seeded from random data rows on the host.

Rounding follows the reference at the same points, on every device: x and
the centroids go to bf16 for the distance products, which accumulate in
fp32, while ``‖c‖²`` stays fp32; the Lloyd sums are ``onehot(assign)ᵀ @
bf16(x)`` in fp32. int8 inputs are assigned against transformed centroids
``c' = (c - offset)·scale`` (L2 assignment is affine-equivariant) and the
sums are moved back to the dequantized space on the host.

The corpus lives on the host and streams through ``device`` in blocks.
A block's last chunk is ragged instead of zero-padded, so no pad rows are
counted and no count fix-up is needed.

Two-level k-means (``kmeans_two_level``) trains ~k centroids at the
reference's scale (2^20 lists): ~√k parents by flat Lloyd, then each
parent's members clustered into children, parents bucketed by (child
count, power-of-two member count) and each bucket run as batched Lloyd
(``kmeans_batched``), one ``_batched_lloyd`` call a stack of groups. The
children sorted by parent are the coarse centroids. The host-side numpy
of the reference (bucketing, resampling, the seeds and the order of every
draw) is copied as it is, so both packages start every sub-run from the
same rows. The reference batches the sub-runs to hide its TPU's dispatch
latency; the port keeps that math and drops the reason.
``kmeans(rounded=True)`` resamples the data to a power-of-two length,
which in the reference spares its compiler a program per shape; the port
keeps it for the parity of its results.

Hierarchical assignment against such centroids: ``assign_blocks_hier``
probes each row's nearest parents and scans their children (host rows
streamed in blocks); ``assign_corpus_hier`` keeps the corpus on the device,
groups the rows by their top-1 parent (a stable sort) and scores each
group of ``pg`` parents with one product against the children of those
parents' nearest parents; ``assign_hier_streamed`` runs it block by block
for a corpus larger than the device.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from densephrases_tpu_torch.ops.topk import topk

logger = logging.getLogger(__name__)

_BLOCK = 262_144  # host rows uploaded at a time


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to fp32 (the reference's bf16 matmul inputs;
    the product of two bf16 values is exact in fp32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _assign_and_accumulate(x, centroids, *, chunk: int):
    """One Lloyd iteration body over device rows x [n, D] (fp32, or int8
    against transformed centroids). Returns (sums [k, D], counts [k], cost)
    in the space of x."""
    k = centroids.shape[0]
    c = centroids.to(torch.float32)
    c_sq = (c ** 2).sum(1)
    cbf = _bf16(c)
    sums = torch.zeros_like(c)
    counts = torch.zeros(k, dtype=torch.float32, device=c.device)
    cost = torch.zeros((), dtype=torch.float32, device=c.device)
    for i0 in range(0, x.shape[0], chunk):
        xb = _bf16(x[i0:i0 + chunk].to(torch.float32))
        dist = c_sq[None, :] - 2.0 * (xb @ cbf.T)
        assign = torch.argmin(dist, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        sums += onehot.T @ xb
        counts += onehot.sum(0)
        cost += dist.gather(1, assign[:, None]).sum()
    return sums, counts, cost


def kmeans_assign(x, centroids, *, chunk: int = 4096) -> torch.Tensor:
    """Assign device rows x [n, D] to their nearest centroid (L2).
    Returns int32 [n] on x's device."""
    c = centroids.to(torch.float32)
    c_sq = (c ** 2).sum(1)
    cbf = _bf16(c)
    out = []
    for i0 in range(0, x.shape[0], chunk):
        xb = _bf16(x[i0:i0 + chunk].to(torch.float32))
        out.append(torch.argmin(c_sq[None, :] - 2.0 * (xb @ cbf.T), dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cat(out).to(torch.int32)


def _effective(centroids: np.ndarray, quant: bool, offset: float,
               scale: float) -> np.ndarray:
    """Centroids in the space of the raw rows: c' = (c - offset)·scale for
    int8 codes, c itself for float rows."""
    if quant:
        return ((centroids - offset) * scale).astype(np.float32)
    return np.asarray(centroids, np.float32)


def accumulate_blocks(x: np.ndarray, centroids: np.ndarray,
                      chunk: int = 4096, block: int = _BLOCK,
                      offset: float = 0.0, scale: float = 1.0,
                      *, device):
    """Streamed Lloyd accumulation over host rows (f32, or int8 with the
    (offset, scale) dequant contract). Returns (sums [k, D], counts [k],
    cost) as numpy, in the DEQUANTIZED space."""
    k, d = centroids.shape[0], x.shape[1]
    quant = x.dtype == np.int8
    c_dev = torch.from_numpy(_effective(centroids, quant, offset, scale)) \
        .to(device)
    sums = np.zeros((k, d), np.float32)
    counts = np.zeros((k,), np.float32)
    cost = 0.0
    for b0 in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])) \
            .to(device)
        s, c, co = _assign_and_accumulate(xb, c_dev, chunk=chunk)
        sums += s.cpu().numpy()
        counts += c.cpu().numpy()
        cost += float(co)
    if quant:
        sums = sums / scale + offset * counts[:, None]
    return sums, counts, cost


def assign_blocks(x: np.ndarray, centroids: np.ndarray,
                  chunk: int = 4096, block: int = _BLOCK,
                  offset: float = 0.0, scale: float = 1.0,
                  *, device) -> np.ndarray:
    """Streamed nearest-centroid assignment of host rows (f32, or int8
    shipped raw). Returns int32 [N] (numpy)."""
    quant = x.dtype == np.int8
    c_dev = torch.from_numpy(_effective(centroids, quant, offset, scale)) \
        .to(device)
    out = np.empty(x.shape[0], np.int32)
    for b0 in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])) \
            .to(device)
        out[b0:b0 + len(xb)] = kmeans_assign(xb, c_dev, chunk=chunk) \
            .cpu().numpy()
    return out


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           chunk: int = 4096, verbose: bool = False, rounded: bool = False,
           offset: float = 0.0, scale: float = 1.0, *,
           device) -> Tuple[np.ndarray, np.ndarray]:
    """Train k centroids on host rows x (f32, or raw int8 codes with the
    (offset, scale) contract). Returns (centroids [k, D] f32 in the
    dequantized space, assignments [N] int32). The init and the empty-
    cluster reseeds draw from ``default_rng(seed)`` in the reference's
    order, so both packages start from the same rows.

    rounded: pad the data to a power-of-two length (at least 512 and k)
    with rows resampled from it, as the reference does; duplicated rows
    weigh double. The assignments returned are those of the real rows."""
    n = n_orig = x.shape[0]
    assert n >= k, f"need at least k={k} points, got {n}"
    quant = x.dtype == np.int8

    def deq(rows):
        return (rows.astype(np.float32) / scale + offset if quant
                else np.asarray(rows, np.float32))

    rng = np.random.default_rng(seed)
    if rounded:
        n_pad = max(1 << int(np.ceil(np.log2(max(n, 512)))), k)
        if n_pad > n:
            x = np.concatenate([x, x[rng.integers(0, n, size=n_pad - n)]])
            n = n_pad
    centroids = deq(x[rng.choice(n, size=k, replace=False)])
    for it in range(iters):
        sums, counts, cost = accumulate_blocks(
            x, centroids, chunk=chunk, offset=offset, scale=scale,
            device=device)
        nonempty = counts > 0
        centroids[nonempty] = sums[nonempty] / counts[nonempty, None]
        n_empty = int((~nonempty).sum())
        if n_empty:
            centroids[~nonempty] = deq(
                x[rng.choice(n, size=n_empty, replace=False)])
        if verbose:
            logger.info("kmeans iter %d: cost=%.1f empty=%d", it, cost,
                        n_empty)
    assigns = assign_blocks(x, centroids, chunk=chunk, offset=offset,
                            scale=scale, device=device)
    return centroids, assigns[:n_orig]


# ------------------------------------------------------ two-level k-means
def sort_children(centroids: np.ndarray, l1_centroids: np.ndarray, *,
                  device):
    """Give each centroid its nearest (L2) level-1 parent and sort by
    parent, stably. Returns (sorted centroids [K, D], parent offsets
    [k1 + 1] int32, order [K]: sorted position → original index)."""
    parent = assign_blocks(centroids.astype(np.float32), l1_centroids,
                           device=device)
    order = np.argsort(parent, kind="stable")
    offsets = np.searchsorted(
        parent[order], np.arange(l1_centroids.shape[0] + 1)).astype(np.int32)
    return centroids[order], offsets, order


def _batched_lloyd(X, C0, *, iters: int):
    """G independent Lloyd runs, one batched product a step. X [G, N, D]
    device rows (fp32, or int8 raw codes), C0 [G, K, D] fp32 → [G, K, D].

    An empty cluster takes the row farthest from its centroid: the e-th
    empty cluster of a group the e-th farthest row (ties to the lower row),
    as the reference reseeds inside its one compiled program."""
    k = C0.shape[1]
    xb = _bf16(X.to(torch.float32))
    C = C0.to(torch.float32)
    for _ in range(iters):
        dots = torch.einsum("gnd,gkd->gnk", xb, _bf16(C))
        dist = (C ** 2).sum(-1)[:, None, :] - 2.0 * dots  # [G, N, K]
        oh = torch.nn.functional.one_hot(torch.argmin(dist, dim=-1), k) \
            .to(torch.float32)
        sums = torch.einsum("gnk,gnd->gkd", oh, xb)
        counts = oh.sum(1)  # [G, K]
        new_c = torch.where(counts[..., None] > 0,
                            sums / counts.clamp(min=1.0)[..., None], C)
        empty = counts <= 0
        far = topk(dist.min(-1).values, k)[1]  # [G, K] farthest rows
        rank = (torch.cumsum(empty.to(torch.int64), 1) - 1).clamp(0, k - 1)
        rows = torch.gather(far, 1, rank)
        reseed = torch.gather(X, 1, rows[..., None].expand(-1, -1, X.shape[2]))
        C = torch.where(empty[..., None], reseed.to(torch.float32), new_c)
    return C


def kmeans_batched(groups, k: int, iters: int = 5, seed: int = 0,
                   max_group_floats: int = 256 << 20, offset: float = 0.0,
                   scale: float = 1.0, *, device):
    """One k-means per group (all with the same k), batched on ``device``.

    groups: [n_i, D] arrays, fp32 or raw int8 codes with the (offset,
    scale) contract; int8 groups run Lloyd in raw-code space (an affine
    image, the same partition) and come back dequantized. Each group is
    padded to a shared power-of-two row count with rows resampled from it,
    and stacks of ``max_group_floats // (n_pad · D)`` groups run as one
    ``_batched_lloyd``; the last stack is filled up by repeating its groups
    when earlier full stacks exist. The draws are the reference's, in its
    order. Returns a list of [k, D] centroid arrays."""
    assert groups, "no groups"
    d = groups[0].shape[1]
    quant = groups[0].dtype == np.int8
    dt = np.int8 if quant else np.float32
    n_pad = max(1 << int(np.ceil(np.log2(max(max(len(g) for g in groups),
                                             k, 256)))), k)
    g_max = max(1, max_group_floats // (n_pad * d))
    rng = np.random.default_rng(seed)
    out = []
    for g0 in range(0, len(groups), g_max):
        chunk_groups = groups[g0:g0 + g_max]
        g_eff = g_max if len(groups) > g_max else len(chunk_groups)
        X = np.empty((g_eff, n_pad, d), dt)
        C0 = np.empty((g_eff, k, d), np.float32)
        for gi in range(g_eff):
            g = np.asarray(chunk_groups[gi % len(chunk_groups)], dt)
            if len(g) < n_pad:
                g = np.concatenate(
                    [g, g[rng.integers(0, len(g), n_pad - len(g))]])
            X[gi] = g
            C0[gi] = g[rng.choice(n_pad, size=k, replace=False)]
        cents = _batched_lloyd(torch.from_numpy(X).to(device),
                               torch.from_numpy(C0).to(device),
                               iters=iters).cpu().numpy()
        if quant:
            cents = cents / scale + offset
        out.extend(cents[gi] for gi in range(len(chunk_groups)))
    return out


def kmeans_two_level(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
                     k1: Optional[int] = None, sub_iters: int = 5,
                     verbose: bool = False, offset: float = 0.0,
                     scale: float = 1.0, *, device):
    """Train ~k centroids hierarchically on host rows x (fp32, or raw int8
    codes with the (offset, scale) contract, which every stage keeps).
    Returns (centroids [K, D] fp32 sorted by parent, l1 centroids [k1', D],
    parent offsets [k1' + 1]). K may differ a little from k (the child
    counts are rounded to a quantum), and parents left with no children
    are dropped."""
    n = x.shape[0]
    quant = x.dtype == np.int8
    if k1 is None:  # Python's round: halves go to the even power
        k1 = int(np.clip(2 ** int(round(np.log2(max(np.sqrt(k), 2)))),
                         16, 4096))
    k1 = min(k1, max(n // 8, 1))
    if not quant:
        x = x.astype(np.float32, copy=False)
    l1, assign = kmeans(x, k1, iters=iters, seed=seed,
                        chunk=min(4096, _BLOCK), offset=offset, scale=scale,
                        device=device)
    counts = np.bincount(assign, minlength=k1).astype(np.float64)

    # each parent's child count, proportional to its members and rounded
    # to a quantum that grows with the mean child count k / k1
    q = float(max(8, int(2 ** np.ceil(np.log2(max(k / max(k1, 1), 8))))
                  // 16))
    raw = k * counts / max(counts.sum(), 1.0)
    k2 = np.maximum(np.round(raw / q) * q, (counts > 0) * 1).astype(np.int64)
    k2 = np.minimum(k2, counts.astype(np.int64))

    def deq(rows):
        return (rows.astype(np.float32) / scale + offset if quant
                else rows.astype(np.float32))

    children_by_parent = {}
    parents_kept = list(np.nonzero(k2 > 0)[0])
    buckets = {}
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(k1 + 1))
    for p in parents_kept:
        members = x[order[bounds[p]:bounds[p + 1]]]
        kp = int(k2[p])
        if kp >= len(members):  # every member is a centroid
            children_by_parent[p] = deq(members)
        elif kp <= 1:
            children_by_parent[p] = deq(members).mean(0, keepdims=True)
        else:
            nb = 1 << int(np.ceil(np.log2(max(len(members), 256))))
            buckets.setdefault((kp, nb), []).append((p, members))
    for bi, ((kp, _nb), entries) in enumerate(sorted(buckets.items())):
        cents = kmeans_batched([m for _, m in entries], kp, iters=sub_iters,
                               seed=seed + 31 + bi, offset=offset,
                               scale=scale, device=device)
        for (p, _), c in zip(entries, cents):
            children_by_parent[p] = c
    children = [children_by_parent[p] for p in parents_kept]
    if verbose:
        logger.info("two-level kmeans: k1=%d parents, %d children, %d "
                    "batched buckets", len(parents_kept),
                    sum(len(c) for c in children), len(buckets))
    l1_kept = l1[np.asarray(parents_kept)]
    cents = np.concatenate(children, axis=0).astype(np.float32)
    offsets = np.zeros(len(parents_kept) + 1, np.int32)
    np.cumsum([len(c) for c in children], out=offsets[1:])
    return cents, l1_kept, offsets


# ---------------------------------------------- hierarchical assignment
def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_children(centroids: np.ndarray, offsets: np.ndarray, tf):
    """(cap, centroids in the rows' space with cap zero rows appended, their
    ‖c‖² with +inf on the pad rows): candidate slices of cap rows from any
    list start never run past the array."""
    lens = np.diff(offsets)
    cap = _round_up(max(int(lens.max()), 8), 8)
    k, d = centroids.shape
    cents = np.concatenate([tf(centroids), np.zeros((cap, d), np.float32)])
    c_sq = np.concatenate([np.sum(cents[:k] ** 2, axis=1),
                           np.full(cap, np.inf, np.float32)])
    return cap, cents, c_sq


def _assign_hier(x, l1, cents_pad, c_sq_pad, offsets, *, probe: int,
                 cap: int, chunk: int):
    """Hierarchical nearest-centroid assignment of device rows x [n, d]:
    each row probes its ``probe`` nearest parents (ties to the lower id)
    and scans their child slices of cap rows, masked to each list's length;
    a later probe wins only with a strictly smaller distance. Returns int32
    [n] indices into the sorted centroids."""
    l1_sq = (l1 ** 2).sum(1)
    l1_bf, cents_bf = _bf16(l1), _bf16(cents_pad)
    col = torch.arange(cap, device=x.device)
    out = []
    for i0 in range(0, x.shape[0], chunk):
        xbf = _bf16(x[i0:i0 + chunk].to(torch.float32))
        parents = topk(-(l1_sq[None, :] - 2.0 * (xbf @ l1_bf.T)), probe)[1]
        best_d = torch.full((xbf.shape[0],), float("inf"), device=x.device)
        best_i = torch.zeros(xbf.shape[0], dtype=torch.int64, device=x.device)
        for pi in range(probe):
            par = parents[:, pi]
            offs = offsets[par]
            lens = offsets[par + 1] - offs
            rows = offs[:, None] + col  # [c, cap]
            dist = c_sq_pad[rows] - 2.0 * torch.einsum(
                "cd,ckd->ck", xbf, cents_bf[rows])
            dist = torch.where(col < lens[:, None], dist,
                               torch.full_like(dist, float("inf")))
            j = torch.argmin(dist, dim=1)
            dmin = dist.gather(1, j[:, None])[:, 0]
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, offs + j, best_i)
        out.append(best_i)
    return torch.cat(out).to(torch.int32)


def assign_blocks_hier(x: np.ndarray, l1: np.ndarray, centroids: np.ndarray,
                       offsets: np.ndarray, probe: int = 8,
                       chunk: int = 2048, block: int = _BLOCK,
                       offset: float = 0.0, scale: float = 1.0, *,
                       device) -> np.ndarray:
    """Streamed hierarchical assignment of host rows (fp32, or int8 shipped
    raw against c' = (c - offset)·scale). Returns int32 [N] indices into
    the sorted centroids (numpy)."""
    quant = x.dtype == np.int8
    cap, cents_pad, c_sq_pad = _padded_children(
        centroids, offsets,
        lambda c: _effective(c, quant, offset, scale))
    probe = min(probe, len(offsets) - 1)
    l1_dev = torch.from_numpy(_effective(l1, quant, offset, scale)).to(device)
    cents_dev = torch.from_numpy(cents_pad).to(device)
    csq_dev = torch.from_numpy(c_sq_pad).to(device)
    offs_dev = torch.from_numpy(offsets.astype(np.int64)).to(device)
    out = np.empty(x.shape[0], np.int32)
    for b0 in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])).to(device)
        out[b0:b0 + len(xb)] = _assign_hier(
            xb, l1_dev, cents_dev, csq_dev, offs_dev, probe=probe, cap=cap,
            chunk=chunk).cpu().numpy()
    return out


def _top1_parent(codes_dev, l1_eff, *, chunk: int = 8192):
    """The nearest parent of every row of the device corpus. [N] int64."""
    l1_sq = (l1_eff ** 2).sum(1)
    l1_bf = _bf16(l1_eff)
    return torch.cat([
        torch.argmin(l1_sq[None, :] - 2.0 * (
            _bf16(codes_dev[i0:i0 + chunk].to(torch.float32)) @ l1_bf.T),
            dim=1)
        for i0 in range(0, codes_dev.shape[0], chunk)])


# the largest [rows, candidates] distance matrix of one assignment step
GROUP_ELEMS = 1 << 28


def _group_assign(codes_dev, order, parent_sorted, start: int, p0: int, nbr,
                  cents_bf, csq_pad, offs, *, m_bucket: int, pg: int,
                  probe: int, cap: int):
    """Assign one group of ``pg`` consecutive parents' rows: the m_bucket
    parent-sorted rows from ``start`` against the children of the group's
    neighbour parents in one product, each row masked to its own parent's
    neighbour candidates. Returns the best child of each of the m_bucket
    rows (the caller keeps the group's own)."""
    d = codes_dev.shape[1]
    rows = _bf16(codes_dev[order[start:start + m_bucket]].to(torch.float32))
    row_slot = parent_sorted[start:start + m_bucket] - p0
    qs = nbr[p0:p0 + pg].reshape(-1)  # [pg * probe] parents
    c_offs = offs[qs]
    c_lens = offs[qs + 1] - c_offs
    col = torch.arange(cap, device=codes_dev.device)
    idx = c_offs[:, None] + col  # [pg * probe, cap]
    csq = torch.where(col < c_lens[:, None], csq_pad[idx],
                      torch.full(idx.shape, float("inf"),
                                 device=codes_dev.device))
    dist = csq.reshape(-1)[None, :] - 2.0 * (
        rows @ cents_bf[idx].reshape(-1, d).T)  # [m, pg * probe * cap]
    slot_of_cand = torch.arange(pg, device=codes_dev.device) \
        .repeat_interleave(probe * cap)
    dist = torch.where(slot_of_cand[None, :] == row_slot[:, None], dist,
                       torch.full_like(dist, float("inf")))
    j = torch.argmin(dist, dim=1)
    return c_offs[j // cap] + j % cap


def assign_corpus_hier(codes_dev, l1: np.ndarray, centroids: np.ndarray,
                       offsets: np.ndarray, probe: int = 8, pg: int = 2,
                       offset: float = 0.0, scale: float = 1.0) -> np.ndarray:
    """Hierarchical assignment of a device-resident corpus codes_dev [N, d]
    (int8 raw codes or fp32). Rows are grouped by their top-1 parent (a
    stable sort), and a row takes only the children of its parent's
    ``probe`` nearest parents (from the host ``argsort`` of the [k1, k1]
    parent distances). Returns int32 [N] indices into the sorted centroids
    (numpy)."""
    n, d = codes_dev.shape
    dev = codes_dev.device
    quant = codes_dev.dtype == torch.int8
    k1 = l1.shape[0]
    probe = min(probe, k1)
    l1_eff = _effective(l1, quant, offset, scale)
    l1sq = np.sum(l1_eff ** 2, axis=1)
    pdist = l1sq[None, :] - 2.0 * (l1_eff @ l1_eff.T)
    nbr = np.argsort(pdist, axis=1)[:, :probe]  # [k1, probe]
    cap, cents_eff, csq_pad = _padded_children(
        centroids, offsets, lambda c: _effective(c, quant, offset, scale))

    nbr_dev = torch.from_numpy(nbr.astype(np.int64)).to(dev)
    cents_bf = _bf16(torch.from_numpy(cents_eff).to(dev))
    csq_dev = torch.from_numpy(csq_pad).to(dev)
    offs_dev = torch.from_numpy(offsets.astype(np.int64)).to(dev)

    parent = _top1_parent(codes_dev, torch.from_numpy(l1_eff).to(dev))
    order = torch.sort(parent, stable=True).indices
    parent_sorted = parent[order]
    counts = np.bincount(parent.cpu().numpy(), minlength=k1)
    ranges = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    assign_sorted = torch.empty(n, dtype=torch.int64, device=dev)
    # a skewed corpus can put most rows under a few parents: a group's rows
    # go through in pieces of at most ``rows_max`` (each row's argmin is
    # its own, so the pieces change nothing)
    rows_max = 1 << max(9, int(np.log2(max(GROUP_ELEMS // (pg * probe * cap),
                                           1))))
    for g0 in range(0, k1, pg):
        g_start = int(ranges[g0])
        g_end = int(ranges[min(g0 + pg, k1)])
        for start in range(g_start, g_end, rows_max):
            m = min(rows_max, g_end - start)
            m_bucket = min(1 << int(np.ceil(np.log2(max(m, 512)))), n)
            start_c = min(start, n - m_bucket)  # clamped: tail sliced off
            gid = _group_assign(
                codes_dev, order, parent_sorted, start_c, g0, nbr_dev,
                cents_bf, csq_dev, offs_dev, m_bucket=m_bucket,
                pg=min(pg, k1 - g0), probe=probe, cap=cap)
            assign_sorted[start:start + m] = gid[start - start_c:
                                                 start - start_c + m]
    out = torch.empty_like(assign_sorted)
    out[order] = assign_sorted
    return out.to(torch.int32).cpu().numpy()


def assign_hier_streamed(x: np.ndarray, l1: np.ndarray,
                         centroids: np.ndarray, offsets: np.ndarray,
                         probe: int = 8, pg: int = 2, offset: float = 0.0,
                         scale: float = 1.0, block_bytes: int = 4 << 30, *,
                         device) -> np.ndarray:
    """``assign_corpus_hier`` for a corpus larger than the device: host
    rows x stream through ``device`` in blocks of ``block_bytes`` (at least
    65,536 rows), each assigned with the same candidate rule."""
    n, d = x.shape
    rows_per_block = max(int(block_bytes // max(x.dtype.itemsize * d, 1)),
                         1 << 16)
    out = np.empty(n, np.int32)
    for b0 in range(0, n, rows_per_block):
        xb = torch.from_numpy(np.array(x[b0:b0 + rows_per_block])).to(device)
        out[b0:b0 + xb.shape[0]] = assign_corpus_hier(
            xb, l1, centroids, offsets, probe=probe, pg=pg, offset=offset,
            scale=scale)
        del xb
    return out


def _batched_lloyd_stream(X, C0, *, iters: int, row_chunk: int):
    """G independent Lloyd runs over device rows, streamed over row chunks
    so the [G, n, K] distance tensor never exists for the whole n.
    X [G, N, D] f32, C0 [G, K, D] f32 → [G, K, D]. Empty clusters keep
    their previous centroid (the PQ codebook trainer's rule)."""
    g, n, _ = X.shape
    k = C0.shape[1]
    C = C0.to(torch.float32)
    for _ in range(iters):
        c_sq = (C ** 2).sum(-1)  # [G, K]
        c_bf = _bf16(C)
        sums = torch.zeros_like(C)
        counts = torch.zeros((g, k), dtype=torch.float32, device=C.device)
        for i0 in range(0, n, row_chunk):
            xb = _bf16(X[:, i0:i0 + row_chunk])
            dots = torch.einsum("gnd,gkd->gnk", xb, c_bf)
            a = torch.argmin(c_sq[:, None, :] - 2.0 * dots, dim=-1)
            oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
            sums += torch.einsum("gnk,gnd->gkd", oh, xb)
            counts += oh.sum(1)
        new_c = sums / counts.clamp(min=1.0)[..., None]
        C = torch.where(counts[..., None] > 0, new_c, C)
    return C
