"""The inputs a run makes from ``--seed``: the vocab, the query towers'
weights and the flat corpus. Both the port and the reference get these
same inputs; neither takes anything the other made.

Weights and corpus are drawn on the device by a ``torch.Generator`` there,
in a few large calls, in the type they are served in. The draws depend on
the seed alone, so the reference draws them again after the port's state
is freed instead of keeping a second copy on the card.
"""

from __future__ import annotations

import numpy as np
import torch

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# sub-streams of a seed, one for each input
STREAM = {"vocab": 1, "weights": 2, "corpus": 3, "traffic": 4, "warm": 5,
          "sample": 6, "index": 7}


def sub_seed(seed: int, stream: str, *extra: int) -> int:
    """A 63-bit seed for one input of a run; any whole ``seed`` (also past
    32 bits, or negative) is taken whole."""
    words = [abs(int(seed)), int(seed < 0), STREAM[stream], *extra]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device, *extra: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream, *extra))
    return gen


# ------------------------------------------------------------------ vocab
def make_vocab(size: int, lead_words, seed: int) -> list:
    """``size`` tokens: the BERT special tokens, ``lead_words``, then
    distinct lowercase words of 3 to 9 letters drawn from the seed. Every
    word is one token to a whole-word WordPiece vocab."""
    rng = np.random.default_rng(sub_seed(seed, "vocab"))
    vocab = list(SPECIAL_TOKENS) + list(lead_words)
    have = set(vocab)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < size:
        n = 2 * (size - len(vocab)) + 64
        lens = rng.integers(3, 10, n)
        chars = letters[rng.integers(0, 26, (n, 9))]
        for row, k in zip(chars, lens):
            word = "".join(row[:k])
            if word not in have:
                have.add(word)
                vocab.append(word)
                if len(vocab) == size:
                    break
    return vocab


# ---------------------------------------------------------------- weights
# (DensePhrases state-dict key under a layer, shape as (out, in) names,
# kind): kind "w" draws N(0, std), "ln_w" 1 + N(0, ln_std), "ln_b"
# N(0, ln_std), the stds from the configuration's "weights"
LAYER_LEAVES = (
    ("attention.self.query.weight", ("h", "h"), "w"),
    ("attention.self.query.bias", ("h",), "w"),
    ("attention.self.key.weight", ("h", "h"), "w"),
    ("attention.self.key.bias", ("h",), "w"),
    ("attention.self.value.weight", ("h", "h"), "w"),
    ("attention.self.value.bias", ("h",), "w"),
    ("attention.output.dense.weight", ("h", "h"), "w"),
    ("attention.output.dense.bias", ("h",), "w"),
    ("attention.output.LayerNorm.weight", ("h",), "ln_w"),
    ("attention.output.LayerNorm.bias", ("h",), "ln_b"),
    ("intermediate.dense.weight", ("f", "h"), "w"),
    ("intermediate.dense.bias", ("f",), "w"),
    ("output.dense.weight", ("h", "f"), "w"),
    ("output.dense.bias", ("h",), "w"),
    ("output.LayerNorm.weight", ("h",), "ln_w"),
    ("output.LayerNorm.bias", ("h",), "ln_b"),
)
EMBED_LEAVES = (
    ("embeddings.word_embeddings.weight", ("v", "h"), "w"),
    ("embeddings.position_embeddings.weight", ("p", "h"), "w"),
    ("embeddings.token_type_embeddings.weight", ("t", "h"), "w"),
    ("embeddings.LayerNorm.weight", ("h",), "ln_w"),
    ("embeddings.LayerNorm.bias", ("h",), "ln_b"),
)
# the two query towers, under the DensePhrases checkpoint's prefixes
TOWERS = ("query_start_encoder.", "query_end_encoder.")


def tower_leaves(model: dict, prefix: str):
    """[(key, shape, kind)] of one BERT tower in the DensePhrases
    state-dict layout (Linear weights [out, in])."""
    dims = {"h": model["hidden_size"], "f": model["intermediate_size"],
            "v": model["vocab_size"], "p": model["max_position_embeddings"],
            "t": model["type_vocab_size"]}
    out = [(prefix + k, tuple(dims[d] for d in s), kind)
           for k, s, kind in EMBED_LEAVES]
    for i in range(model["num_hidden_layers"]):
        out += [(f"{prefix}encoder.layer.{i}.{k}",
                 tuple(dims[d] for d in s), kind)
                for k, s, kind in LAYER_LEAVES]
    return out


def make_weights(model: dict, weights: dict, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """The two query towers' state dict, drawn on ``device``: one normal
    draw a tower, laid out so that each kind of leaf is one contiguous run
    and is scaled in one call (``weights``: {"std", "ln_std"}). Returns
    {key: tensor} (views of the towers' buffers)."""
    sd = {}
    for t, prefix in enumerate(TOWERS):
        leaves = sorted(tower_leaves(model, prefix),
                        key=lambda x: ("w", "ln_w", "ln_b").index(x[2]))
        sizes = [int(np.prod(s)) for _, s, _ in leaves]
        buf = torch.randn(sum(sizes), dtype=dtype, device=device,
                          generator=generator(seed, "weights", device, t))
        at = 0
        runs = {}
        for (key, shape, kind), n in zip(leaves, sizes):
            sd[key] = buf[at:at + n].view(shape)
            lo, hi = runs.get(kind, (at, at))
            runs[kind] = (lo, at + n)
            at += n
        lo, hi = runs["w"]
        buf[lo:hi].mul_(weights["std"])
        lo, hi = runs["ln_w"]
        buf[lo:hi].mul_(weights["ln_std"]).add_(1.0)
        lo, hi = runs["ln_b"]
        buf[lo:hi].mul_(weights["ln_std"])
    return sd


# ----------------------------------------------------------------- corpus
def make_flat_codes(index: dict, seed: int, device) -> torch.Tensor:
    """The flat corpus's int8 codes [n_docs * vecs_per_doc, dim], drawn
    uniformly in [code_low, code_high] on ``device`` in one call."""
    n = index["n_docs"] * index["vecs_per_doc"]
    return torch.randint(index["code_low"], index["code_high"] + 1,
                         (n, index["dim"]), dtype=torch.int8, device=device,
                         generator=generator(seed, "corpus", device))


def doc_layout(index: dict) -> dict:
    """Every doc's metadata, the same for every doc but its id and title:
    ``vecs_per_doc`` one-word phrases over a context of ``vecs_per_doc + 2``
    words of 4 letters, word w at characters [5w, 5w + 4)."""
    vpd = index["vecs_per_doc"]
    return {"vecs_per_doc": vpd,
            "word2char_start": np.arange(vpd, dtype=np.int32) * 5,
            "word2char_end": np.arange(vpd, dtype=np.int32) * 5 + 4,
            "f2o_start": np.arange(vpd, dtype=np.int32),
            "context": " ".join(["word"] * (vpd + 2))}


def title(doc: int) -> str:
    return f"doc{doc}"


# -------------------------------------------------------------- IVF index
RB = 32  # rows of a block of the index's list reads


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def list_sizes(index: dict, seed: int) -> np.ndarray:
    """Rows a list: a log-normal profile (``size_sigma``, drawn once from
    ``size_seed``) scaled to ``n_rows`` in all, each between 1 and
    ``size_cap`` times the mean, dealt to the lists in an order drawn from
    ``seed``. Every seed gets the same list sizes, so the same work."""
    n, nlist = index["n_rows"], index["nlist"]
    rng = np.random.default_rng(index["size_seed"])
    w = np.exp(index["size_sigma"] * rng.standard_normal(nlist))
    cap = int(index["size_cap"] * n / nlist)
    sizes = np.clip(np.floor(w / w.sum() * n), 1, cap).astype(np.int64)
    order = np.argsort(-w, kind="stable")
    while sizes.sum() != n:
        short = n - int(sizes.sum())
        room = order[sizes[order] < cap] if short > 0 else \
            order[::-1][sizes[order[::-1]] > 1]
        sizes[room[:abs(short)]] += np.sign(short)
    return np.random.default_rng(sub_seed(seed, "index", 0)).permutation(
        sizes)


def make_ivf(index: dict, seed: int, device) -> dict:
    """An IVF-PQ index over a seeded corpus, made on ``device`` and
    returned as host arrays: the int8 corpus ``codes`` [N, D] (global row
    order; also the refine matrix and the store's vectors), ``centroids``
    [nlist, D] (offset + each list's centre), ``list_offsets``
    [nlist + 1], ``row_perm`` (sorted row → global row, padded as the
    port's build pads it), the OPQ ``rotation`` [D, D], the PQ ``books``
    [M, ksub, D/M] and the sorted PQ ``pq_codes`` [N_pad, M].

    Rows of list l are ``offset + c_l + e`` with c_l ~ N(0,
    centroid_std²) and e ~ N(0, row_std²) a dim, quantized by the store's
    affine; rows fall to lists by a seeded permutation. The books are fitted
    by ``pq_iters`` Lloyd steps on ``pq_sample`` rows' rotated residuals
    (x − centroid) @ R, and every row is encoded by its nearest codeword a
    subspace."""
    n, d, nlist = index["n_rows"], index["dim"], index["nlist"]
    m, ksub = index["m"], 2 ** index["nbits"]
    off, scale = index["offset"], index["scale"]
    gen = generator(seed, "index", device, 1)
    sizes = list_sizes(index, seed)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    centres = torch.randn(nlist, d, generator=gen, device=device)
    centres *= index["centroid_std"]
    perm = torch.randperm(n, generator=gen, device=device)
    lists = torch.repeat_interleave(
        torch.arange(nlist, device=device),
        torch.as_tensor(sizes, device=device))
    assign = torch.empty(n, dtype=torch.long, device=device)
    assign[perm] = lists
    codes = torch.empty((n, d), dtype=torch.int8, device=device)
    step = 1 << 18
    for g0 in range(0, n, step):
        x = centres[assign[g0:g0 + step]]
        x += index["row_std"] * torch.randn(x.shape, generator=gen,
                                            device=device)
        codes[g0:g0 + step] = (x * scale).round_().clamp_(-128, 127).to(
            torch.int8)
        del x
    rot = torch.linalg.qr(torch.randn(d, d, generator=gen,
                                      device=device))[0].contiguous()
    cents = centres + off

    def residual(rows):
        x = codes[rows].to(torch.float32) / scale + off
        return ((x - cents[assign[rows]]) @ rot).view(-1, m, d // m)

    sample = torch.randperm(n, generator=gen,
                            device=device)[:index["pq_sample"]]
    ys = residual(sample)  # [S, M, dsub]
    books = ys[:ksub].transpose(0, 1).contiguous()  # [M, ksub, dsub]
    for _ in range(index["pq_iters"]):
        near = _nearest(ys, books)  # [S, M]
        hot = torch.nn.functional.one_hot(near, ksub).to(torch.float32)
        hot = hot.permute(1, 2, 0)  # [M, ksub, S]
        sums = torch.bmm(hot, ys.transpose(0, 1))  # [M, ksub, dsub]
        counts = hot.sum(-1, keepdim=True)
        books = torch.where(counts > 0, sums / counts.clamp(min=1), books)
        del hot, sums
    pq = torch.empty((n, m), dtype=torch.uint8, device=device)
    step = 1 << 15
    for g0 in range(0, n, step):
        rows = torch.arange(g0, min(g0 + step, n), device=device)
        pq[g0:g0 + step] = _nearest(residual(rows), books).to(torch.uint8)
    cap = _round_up(max(int(sizes.max()), 8), 8)
    pad = _round_up(cap, RB) + (-(n + _round_up(cap, RB))) % RB
    pq_sorted = torch.zeros((n + pad, m), dtype=torch.uint8, device=device)
    pq_sorted[:n] = pq[perm]
    host = {
        "codes": codes.cpu().numpy(),
        "centroids": cents.cpu().numpy(),
        "list_offsets": offs,
        "row_perm": np.concatenate([perm.cpu().numpy(),
                                    np.zeros(pad, np.int64)]),
        "rotation": rot.cpu().numpy(),
        "books": books.cpu().numpy(),
        "pq_codes": pq_sorted.cpu().numpy(),
    }
    return host


def _nearest(y, books):
    """Nearest codeword a subspace: y [R, M, dsub], books [M, ksub, dsub]
    → [R, M] int64."""
    dots = torch.bmm(y.transpose(0, 1), books.transpose(1, 2))  # [M, R, k]
    dist = (books * books).sum(-1)[:, None, :] - 2 * dots
    return dist.argmin(-1).T
