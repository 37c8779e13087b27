"""Phrase search in plain float32 PyTorch, over the same int8 corpus and
index arrays the port serves, for the queries the port answered.

The semantics are those the port states for its serve path (the
DensePhrases search): each of the start and end query vectors takes its
``top_k`` best rows (stage 1); each start hit takes its best end among the
next ``max_answer_length`` rows of its doc, and each end hit its best start
among the rows before it (stage 2); the 2·top_k spans are sorted by score,
a span met twice is kept once, and the best ``top_k`` are the answers.

A row's vector is its int8 code dequantized by the store's affine,
``code / scale + offset``; a doc is ``vecs_per_doc`` consecutive rows.

Stage 1 is exact over all rows (flat), or (IVF) over the rows of the lists
the batch probed: each query's ``nprobe`` lists of highest inner product
with the centroids, every query scoring the union of its batch's lists
read in whole 32-row blocks; the rows' product-quantized scores (the
centroid's inner product plus the rotated query's table sums) pick
``top_k · refine_factor`` candidates, and their exact scores pick the
``top_k``.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 17  # corpus rows dequantized at a time
RB = 32  # rows a block of a list read


def dequant(codes, offset: float, scale: float):
    return codes.to(torch.float32) / scale + offset


def exact_scores_topk(corpus, offset, scale, q, k: int):
    """Exact top-k of q [n, D] over every row of the int8 corpus [N, D],
    and the population standard deviation of each query's N scores.
    → (vals [n, k], ids [n, k] int64, std [n])."""
    n = q.shape[0]
    vals = torch.full((n, 0), float("-inf"), device=q.device)
    ids = torch.zeros((n, 0), dtype=torch.long, device=q.device)
    s1 = torch.zeros(n, dtype=torch.float64, device=q.device)
    s2 = torch.zeros(n, dtype=torch.float64, device=q.device)
    for r0 in range(0, corpus.shape[0], BLOCK_ROWS):
        s = q @ dequant(corpus[r0:r0 + BLOCK_ROWS], offset, scale).T
        s1 += s.sum(1, dtype=torch.float64)
        s2 += (s.to(torch.float64) ** 2).sum(1)
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        vals, pos = torch.topk(torch.cat([vals, v], 1),
                               min(k, vals.shape[1] + v.shape[1]), dim=1)
        ids = torch.gather(torch.cat([ids, i + r0], 1), 1, pos)
    m = corpus.shape[0]
    var = (s2 / m - (s1 / m) ** 2).clamp(min=0)
    return vals, ids, var.sqrt().to(torch.float32)


def span_scores(corpus, offset, scale, qs, qe, s_rows, e_rows):
    """Exact score of spans: qs · v[s_row] + qe · v[e_row], for row ids
    [n, m] (a query's m spans)."""
    vs = dequant(corpus[s_rows.reshape(-1)], offset, scale).view(
        s_rows.shape + (-1,))
    ve = dequant(corpus[e_rows.reshape(-1)], offset, scale).view(
        e_rows.shape + (-1,))
    return (torch.einsum("nmd,nd->nm", vs, qs)
            + torch.einsum("nmd,nd->nm", ve, qe))


def span_scorer(corpus, offset, scale, qs, qe):
    """The scores of spans [(query, start row, end row)] → list."""
    def score(pairs):
        q, s, e = (torch.tensor([p[i] for p in pairs], device=qs.device)
                   for i in range(3))
        return span_scores(corpus, offset, scale, qs[q], qe[q], s[:, None],
                           e[:, None])[:, 0].cpu().tolist()
    return score


def rescore(corpus, offset, scale, qs, qe, s_ids, e_ids, s_vals, e_vals,
            vpd: int, max_len: int):
    """Stage 2 → (span start rows, span end rows, span scores), each
    [n, 2k]: the k start hits with their best ends, then the k end hits
    with their best starts."""
    n_rows = corpus.shape[0]
    off = torch.arange(max_len, device=qs.device)

    def best(anchor, rows, q, ok):
        v = dequant(corpus[rows.clamp(0, n_rows - 1).reshape(-1)], offset,
                    scale).view(rows.shape + (-1,))
        part = torch.einsum("nkld,nd->nkl", v, q)
        part = torch.where(ok, part, torch.full_like(part, float("-inf")))
        return part.max(-1)  # first of equal maxima

    doc_end = (s_ids // vpd + 1) * vpd
    ends = s_ids[..., None] + off
    e_best, e_at = best(s_ids, ends, qe, ends < doc_end[..., None])
    doc_base = (e_ids // vpd) * vpd
    starts = e_ids[..., None] - (max_len - 1) + off
    s_best, s_at = best(e_ids, starts, qs, starts >= doc_base[..., None])
    span_s = torch.cat([s_ids, e_ids - (max_len - 1) + s_at], 1)
    span_e = torch.cat([s_ids + e_at, e_ids], 1)
    score = torch.cat([s_vals + e_best, e_vals + s_best], 1)
    return span_s, span_e, score


def answers(span_s, span_e, score, vpd: int, top_k: int):
    """Host assembly: per query, the spans by score (ties in candidate
    order), each (doc, start word, end word) once, the best ``top_k`` as
    dicts of doc, start_pos, end_pos (characters: word w spans
    [5w, 5w + 4)) and score."""
    span_s, span_e, score = (t.cpu().tolist() for t in (span_s, span_e,
                                                         score))
    out = []
    for rs, re_, sc in zip(span_s, span_e, score):
        order = sorted(range(len(sc)), key=lambda j: -sc[j])
        seen, lst = set(), []
        for j in order:
            doc, sl, el = rs[j] // vpd, rs[j] % vpd, re_[j] % vpd
            key = (doc, sl, el)
            if key in seen:
                continue
            seen.add(key)
            lst.append({"doc": doc, "start_pos": 5 * sl,
                        "end_pos": 5 * el + 4, "score": sc[j]})
        out.append(lst[:top_k])
    return out


def flat_search(corpus, offset, scale, qs, qe, *, vpd, top_k, max_len):
    """Exact stage 1 over the flat corpus, then stage 2 and the assembly.
    → (answers per query, unit per query: the std of a start score plus
    that of an end score over all rows)."""
    q = torch.cat([qs, qe])
    vals, ids, std = exact_scores_topk(corpus, offset, scale, q, top_k)
    n = qs.shape[0]
    cand = rescore(corpus, offset, scale, qs, qe, ids[:n], ids[n:],
                   vals[:n], vals[n:], vpd, max_len)
    return answers(*cand, vpd, top_k), (std[:n] + std[n:]).cpu().tolist()


def probed_rows(index: dict, q, nprobe: int, rnd=None):
    """The sorted rows a batch's stacked queries q [n, D] read: each
    query's ``nprobe`` lists (at most all) of highest inner product with
    the centroids (both rounded by ``rnd`` first, if given), the union
    over the batch, each list read in whole 32-row blocks, rows past the
    last list's end left out. → (int64 rows [R], blocks read)."""
    offs = index["list_offsets"]
    n_real = int(offs[-1])
    cents = index["centroids"]
    if rnd is not None:
        q, cents = rnd(q), rnd(cents)
    probed = torch.topk(q @ cents.T, min(nprobe, cents.shape[0]),
                        dim=1).indices.unique()
    lo = offs[probed] // RB
    hi = (offs[probed + 1] + RB - 1) // RB
    n_blocks = (n_real + RB - 1) // RB + 1
    edge = torch.zeros(n_blocks + 1, dtype=torch.long, device=q.device)
    edge.index_add_(0, lo, torch.ones_like(lo))
    edge.index_add_(0, hi, -torch.ones_like(hi))
    blocks = torch.nonzero(torch.cumsum(edge, 0)[:n_blocks] > 0)[:, 0]
    rows = (blocks[:, None] * RB
            + torch.arange(RB, device=q.device)).reshape(-1)
    return rows[rows < n_real], int(blocks.numel())


def ivf_stage1(index: dict, corpus, offset, scale, q, *, nprobe: int,
               top_k: int, refine_factor: int, chunk: int = 1 << 14):
    """IVF stage 1 for one batch's stacked queries q [n, D] → (vals [n, k],
    global rows [n, k]). ``index``: centroids [nlist, D], list_offsets
    [nlist + 1] (of sorted rows), row_perm (sorted row → global row),
    rotation [D, D], books [M, ksub, dsub], pq_codes [N, M] (sorted
    rows). A row's product-quantized score is the query's inner product
    with its list's centroid plus the rotated query's table sums over its
    codes; the ``top_k · refine_factor`` best are scored exactly."""
    rows, _ = probed_rows(index, q, nprobe)
    books = index["books"]
    m, _, dsub = books.shape
    q_rot = (q @ index["rotation"]).view(q.shape[0], m, dsub)
    lut = torch.einsum("nms,mks->nmk", q_rot, books)  # [n, M, ksub]
    row_list = torch.searchsorted(index["list_offsets"], rows,
                                  right=True) - 1
    cent = q @ index["centroids"].T  # [n, nlist]
    sub = torch.arange(m, device=q.device)
    est = torch.empty((q.shape[0], rows.numel()), device=q.device)
    for c0 in range(0, rows.numel(), chunk):
        codes = index["pq_codes"][rows[c0:c0 + chunk]].long()  # [r, M]
        est[:, c0:c0 + codes.shape[0]] = (
            lut[:, sub, codes].sum(-1) + cent[:, row_list[c0:c0 + chunk]])
    wide = min(top_k * refine_factor, rows.numel())
    cand = index["row_perm"][rows[torch.topk(est, wide, dim=1).indices]]
    exact = torch.einsum("ncd,nd->nc",
                         dequant(corpus[cand.reshape(-1)], offset,
                                 scale).view(cand.shape + (-1,)), q)
    vals, pos = torch.topk(exact, min(top_k, wide), dim=1)
    return vals, torch.gather(cand, 1, pos)


def ivf_search(index, corpus, offset, scale, qs, qe, batches, *, vpd,
               top_k, max_len, nprobe, refine_factor):
    """IVF stage 1 for each batch (``batches``: (first query, queries) of
    each, as the port served them), then stage 2 and the assembly, as
    ``flat_search`` returns them; the unit from exact scores over all
    rows."""
    _, _, std = exact_scores_topk(corpus, offset, scale,
                                  torch.cat([qs, qe]), 1)
    n = qs.shape[0]
    out = []
    for b0, nb in batches:
        bs, be = qs[b0:b0 + nb], qe[b0:b0 + nb]
        vals, ids = ivf_stage1(index, corpus, offset, scale,
                               torch.cat([bs, be]), nprobe=nprobe,
                               top_k=top_k, refine_factor=refine_factor)
        cand = rescore(corpus, offset, scale, bs, be, ids[:nb], ids[nb:],
                       vals[:nb], vals[nb:], vpd, max_len)
        out += answers(*cand, vpd, top_k)
    return out, (std[:n] + std[n:]).cpu().tolist()
