"""The port's query-side fine-tuning (models/encoder.query_loss,
train/query.py, cli/train_query.py) against the JAX reference on the same
seeded inputs and bridged weights: the loss and its gradients for each
label strategy, the annotators, train steps, a 2-epoch run with retrieval
in the loop on one store, and both drivers on one encoder dir and dump."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densephrases_tpu.models.encoder as jax_encoder
import densephrases_tpu.train.query as jax_query
from densephrases_tpu.cli import train_query as jax_cli
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.dump import dump_phrases as jax_dump
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.model import DensePhrases as JaxDensePhrases
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.bert import bert_forward
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu_torch import model as port_model
from densephrases_tpu_torch.cli import train_query as port_cli
from densephrases_tpu_torch.cli.common import load_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import embed_query, query_loss
from densephrases_tpu_torch.models.from_jax import encoder_from_jax, named_to_jax
from densephrases_tpu_torch.models.hf_import import state_dict_from_encoder
from densephrases_tpu_torch.train import query as port_query

B, C, LQ = 4, 6, 8
STRATS = ["phrase,doc", "phrase", "doc"]
TOWERS = ("query_start", "query_end")


def _cfgs(vocab_size=512, dropout=0.0):
    j = dataclasses.replace(JaxBertConfig.tiny(vocab_size),
                            hidden_dropout_prob=dropout)
    t = dataclasses.replace(BertConfig.tiny(vocab_size),
                            hidden_dropout_prob=dropout)
    return j, t


def _fp32_reference(monkeypatch):
    """The reference's towers in fp32 (its default compute is bf16)."""
    monkeypatch.setattr(jax_encoder, "bert_forward", functools.partial(
        bert_forward, compute_dtype=jnp.float32))


def _fp32_port(monkeypatch):
    """The port's serving query towers (``DensePhrases.query2vec``) in fp32."""
    monkeypatch.setattr(port_model, "embed_query", functools.partial(
        embed_query, compute_dtype=torch.float32))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _loss_inputs(cfg, seed=0):
    """Query ids with ragged masks; [B, C, H] candidate vectors; targets
    that mix rows with phrase and doc targets, a doc-only row, a row
    without targets, and masked candidates (one of them a target)."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    ids = rng.integers(5, cfg.vocab_size, (B, LQ)).astype(np.int32)
    am = np.ones((B, LQ), np.int32)
    am[1:, LQ - 3:] = 0
    sv = rng.standard_normal((B, C, h)).astype(np.float32) * 0.5
    ev = rng.standard_normal((B, C, h)).astype(np.float32) * 0.5
    t = np.zeros((B, C), bool)
    pt = np.zeros((B, C), bool)
    t[0, [1, 4]] = True
    pt[0, [1, 2, 4]] = True
    pt[1, [0, 5]] = True          # doc targets only
    t[3, 2] = True                # row 2: no targets
    pt[3, [2, 3]] = True
    cm = np.ones((B, C), bool)
    cm[0, 5] = cm[1, 4] = cm[3, 3] = False  # row 3's masked doc target
    return ids, am, sv, ev, t, pt, cm


def _by_strat(t, pt, strat):
    return (t if "phrase" in strat else np.zeros_like(t),
            pt if "doc" in strat else np.zeros_like(pt))


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(0), _cfgs()[0])


@pytest.mark.parametrize("strat,dtype", [(s, "float32") for s in STRATS]
                         + [("phrase,doc", "bfloat16")])
def test_query_loss_and_gradients_match_reference(jax_params, monkeypatch,
                                                  strat, dtype):
    jcfg, tcfg = _cfgs()
    if dtype == "float32":
        _fp32_reference(monkeypatch)
    ids, am, sv, ev, t, pt, cm = _loss_inputs(tcfg)
    t, pt = _by_strat(t, pt, strat)

    def loss_fn(p):
        return jax_encoder.query_loss(
            p, jcfg, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(sv),
            jnp.asarray(ev), jnp.asarray(t), jnp.asarray(pt),
            cand_mask=jnp.asarray(cm), deterministic=True, attn_impl="xla")

    (r_loss, r_top1), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_params)
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    loss, top1 = query_loss(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(am),
        torch.from_numpy(sv), torch.from_numpy(ev), torch.from_numpy(t),
        torch.from_numpy(pt), cand_mask=torch.from_numpy(cm),
        deterministic=True, compute_dtype=getattr(torch, dtype))
    loss.backward()
    # fp32: one function in one precision, summed in other orders; bf16:
    # both round the towers' activations to bf16 at the same points, a
    # product one bf16 ulp apart carries through two layers
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=rtol)
    if dtype == "float32":
        np.testing.assert_array_equal(top1.numpy(), np.asarray(r_top1))
    # only the query towers get a gradient, in both packages
    assert all(p.grad is None for n, p in params.named_parameters()
               if n.split(".")[0] not in TOWERS)
    assert not any(np.asarray(g).any() for g in jax.tree.leaves(
        {k: r_grads[k] for k in ("phrase", "filter")}))
    got = _leaves(named_to_jax((n, p.grad) for n, p in
                               params.named_parameters()
                               if n.split(".")[0] in TOWERS))
    want = _leaves({k: r_grads[k] for k in TOWERS})
    assert got.keys() == want.keys()
    # each leaf within tol of its own largest entry, floored at 1e-4 of the
    # largest gradient (some leaves, the key biases, are zero by symmetry
    # up to rounding); fp32 1e-4, bf16 8e-2 (as tests/test_torch_train.py)
    floor = 1e-4 * max(np.abs(np.asarray(v)).max() for v in want.values())
    tol = 1e-4 if dtype == "float32" else 8e-2
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, (jax.tree_util.keystr(path), err)


def test_query_loss_without_any_target_is_zero(jax_params):
    _, tcfg = _cfgs()
    ids, am, sv, ev, t, pt, cm = _loss_inputs(tcfg, seed=1)
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    zero = torch.zeros(B, C, dtype=torch.bool)
    loss, top1 = query_loss(params, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(am), torch.from_numpy(sv),
                            torch.from_numpy(ev), zero, zero,
                            cand_mask=torch.from_numpy(cm), deterministic=True)
    # both terms are gated off: the loss is exactly 0, no row is a hit
    assert float(loss.detach()) == 0.0 and not top1.any()


# ---- annotation ------------------------------------------------------------

def _results(seed=0, b=3, k=5, dim=4):
    """Search-result dicts: answers, contexts, titles, vectors, columns."""
    rng = np.random.default_rng(seed)
    words = ["paris", "the river", "Seine", "école", "1889", "a tower"]
    out = []
    for bi in range(b):
        ret = []
        for ci in range(k):
            ans = str(rng.choice(words))
            ctx = " ".join(rng.choice(words, 4)) + f" {ans}."
            ret.append({"answer": ans, "context": ctx,
                        "title": [f"T{int(rng.integers(0, 3))}"],
                        "cand_col": int(rng.permutation(2 * k)[0]),
                        "start_vec": rng.standard_normal(dim).astype(np.float32),
                        "end_vec": rng.standard_normal(dim).astype(np.float32)})
        out.append(ret)
    return out


@pytest.mark.parametrize("regex", [False, True])
@pytest.mark.parametrize("with_titles", [False, True])
def test_annotators_match_reference(regex, with_titles):
    results = _results()
    answers = [["Paris"], ["the river", "1889"], []] if not regex else \
        [["par.s"], [r"\d{4}"], []]
    titles = [["T0"], ["T1", "T2"], ["T0"]] if with_titles else None
    kw = dict(regex=regex, n_cands=7)
    ref = jax_query.annotate_candidates(results, answers, titles, **kw)
    got = port_query.annotate_candidates(results, answers, titles, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    ref = jax_query.annotate_candidate_cols(results, answers, titles, **kw)
    got = port_query.annotate_candidate_cols(results, answers, titles, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # phrase targets in every mode; doc targets by title, or by the answer
    # in the context (a regex pattern is matched as text there)
    assert ref[1].any() and (ref[2].any() or (regex and not with_titles))


# ---- train steps ---------------------------------------------------------

def _assert_params_match(got, want_tree, atol, noise_bound):
    """Each leaf within ``atol`` of the reference's. The key bias's gradient
    is 0 by symmetry (a softmax ignores a shift shared by a row's scores):
    in both packages it is rounding noise, which Adam's normalisation turns
    into moves of up to lr a step in any direction, so that leaf is held to
    ``noise_bound`` only."""
    for path, want in _leaves(want_tree).items():
        noise = jax.tree_util.keystr(path).endswith("['k_b']")
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                   atol=noise_bound if noise else atol,
                                   err_msg=str(path))


def _jax_query_optimizer(lr, total, ratio):
    """The reference's inline query-FT optimizer (train/query.py:215-221)."""
    warm = max(int(total * ratio), 1)
    return optax.adamw(optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warm),
         optax.linear_schedule(lr, 0.0, total)], [warm]), weight_decay=0.01)


# "doc" alone adds nothing to the step over the loss test above; "phrase"
# steps on a doc-only row with a zero loss term (ROADMAP.md Queue 3)
@pytest.mark.parametrize("strat", ["phrase,doc", "phrase"])
def test_query_train_steps_match_reference(jax_params, monkeypatch, strat):
    """Three steps of both packages' train steps on one batch in the
    vecs-on-device layout ([B, 2K, D] candidates gathered by cand_cols),
    fp32, dropout off; the first step has lr 0 (warmup)."""
    jcfg, tcfg = _cfgs()
    _fp32_reference(monkeypatch)
    ids, am, sv, ev, t, pt, cm = _loss_inputs(tcfg, seed=2)
    cols = np.random.default_rng(3).permutation(2 * C)[:C][None].repeat(B, 0)
    sv2 = np.random.default_rng(4).standard_normal(
        (B, 2 * C, tcfg.hidden_size)).astype(np.float32) * 0.5
    ev2 = np.random.default_rng(5).standard_normal(sv2.shape).astype(
        np.float32) * 0.5
    batch = {"query_input_ids": ids, "query_attention_mask": am,
             "start_vecs": sv2, "end_vecs": ev2, "cand_cols": cols.astype(
                 np.int32), "targets": t, "p_targets": pt, "cand_mask": cm}
    lr, total, ratio = 1e-3, 10, 0.1
    j_opt = _jax_query_optimizer(lr, total, ratio)
    q_params = {k: jax_params[k] for k in TOWERS}
    frozen = {k: v for k, v in jax_params.items() if k not in TOWERS}
    j_state = j_opt.init(q_params)
    j_step = jax_query.make_query_train_step(jcfg, j_opt, strat,
                                             attn_impl="xla")
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    opt = port_query.make_query_optimizer(lr, total, ratio)
    state = opt.init(port_query.query_named(params))
    step = port_query.make_query_train_step(tcfg, opt, strat,
                                            compute_dtype=torch.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    for i in range(3):
        q_params, j_state, j_loss, j_top1 = j_step(
            q_params, j_state, frozen, jb, jax.random.PRNGKey(i))
        loss, top1 = step(params, state, tb, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        np.testing.assert_array_equal(top1.numpy(), np.asarray(j_top1))
        got = _leaves(named_to_jax(
            (n, p) for n, p in params.named_parameters()
            if n.split(".")[0] in TOWERS))
        _assert_params_match(got, q_params, 1e-5, 2 * lr * i)
    # the phrase tower and the filter never move; the word embeddings do
    for n, p in params.named_parameters():
        if n.split(".")[0] not in TOWERS:
            assert torch.equal(p, before[n]), n
    assert not torch.equal(params.query_start.word_emb,
                           before["query_start.word_emb"])
    assert state["count"] == 3


# ---- the loop with retrieval ---------------------------------------------

FACTS = [("alpha", "the secret word is alpha and nothing else matters here"),
         ("bravo", "everyone knows bravo is the codeword of this document"),
         ("charlie", "charlie appears in this text as the hidden answer"),
         ("delta", "the delta token hides within this entire paragraph")]


def _vocab():
    words = sorted({w for _, text in FACTS for w in text.split()}
                   | {"find", "question", "zulu", "yankee", "xray"})
    return {t: i for i, t in enumerate(SPECIAL_TOKENS + words)}


def _qa():
    """Answerable pairs and pairs whose answer is nowhere in the corpus (a
    batch of only those has no target and is skipped)."""
    qa = [(f"find the word {a}", [a]) for a, _ in FACTS]
    qa += [(f"find question {w}", [w]) for w in ("zulu", "yankee", "xray")]
    qa += [("question zulu", ["zulu"])]
    return qa


@pytest.fixture(scope="module")
def qft_store(tmp_path_factory):
    """One store dumped by the reference from its weights; a vocab size no
    other test uses, so no jitted reference function comes from a cache
    traced at another precision."""
    vocab = _vocab()
    jcfg, tcfg = _cfgs(vocab_size=len(vocab) + 3)
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    docs = [{"doc_id": i, "title": f"doc-{a}", "paragraphs": [text]}
            for i, (a, text) in enumerate(FACTS)]
    root = tmp_path_factory.mktemp("qft")
    jax_dump(jparams, jcfg, JaxTokenizer(vocab), docs,
             str(root / "dump" / "phrase"), max_seq_length=32, batch_size=4,
             attn_impl="xla")
    return {"root": root, "vocab": vocab, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams}


def _recorded_steps(monkeypatch, module, record):
    """Wrap ``module.make_query_train_step`` so each step records its
    batch's questions (the first query ids)."""
    make = module.make_query_train_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def recording(*args):
            ids = np.asarray(args[-2]["query_input_ids"])
            record.append(tuple(map(tuple, ids[:, :6].tolist())))
            return step(*args)
        return recording

    monkeypatch.setattr(module, "make_query_train_step", wrapped)


def test_train_query_encoder_matches_reference(qft_store, monkeypatch):
    """Two epochs with retrieval in the loop on one store, fp32, dropout
    off, dev pairs: both packages step on the same batches and skip the
    same, their loss and top-1 histories and dev EMs agree, and they keep
    the same towers."""
    s = qft_store
    _fp32_reference(monkeypatch)
    _fp32_port(monkeypatch)
    path = str(s["root"] / "dump" / "phrase")
    jmodel = JaxDensePhrases(s["jparams"], s["jcfg"], JaxTokenizer(s["vocab"]),
                             JaxMIPS(JaxPhraseStore.load(path)),
                             max_query_length=12, attn_impl="xla")
    params = encoder_from_jax(jax.tree.map(np.asarray, s["jparams"]),
                              s["tcfg"], device="cpu")
    model = DensePhrases(params, s["tcfg"], WordPieceTokenizer(s["vocab"]),
                         MIPS(PhraseStore.load(path), device="cpu"),
                         max_query_length=12)
    # top_k 64 reaches past every phrase vector of the store: both searches
    # return every candidate, so no near-tie at the top-k boundary can
    # split them
    assert model.mips.store.n_vecs < 64
    kw = dict(top_k=64, learning_rate=1e-3, epochs=2, max_answer_length=3,
              update_freq=1)
    qa = _qa()
    j_steps, t_steps = [], []
    _recorded_steps(monkeypatch, jax_query, j_steps)
    _recorded_steps(monkeypatch, port_query, t_steps)
    _, j_hist = jax_query.train_query_encoder(
        jmodel, qa, jax_query.QueryFTConfig(**kw), batch_size=2,
        dev_pairs=qa[:4], eval_top_k=1, seed=3)
    kept, hist = port_query.train_query_encoder(
        model, qa, port_query.QueryFTConfig(**kw), batch_size=2,
        dev_pairs=qa[:4], eval_top_k=1, seed=3, compute_dtype=torch.float32)
    assert t_steps == j_steps
    # 4 batches an epoch; those of two unanswerable questions are skipped
    # (at this seed 2 in the first epoch, 1 in the second)
    assert [a + b for a, b in zip(hist["steps"], hist["skipped"])] == [4, 4]
    assert hist["skipped"] == [2, 1]
    assert len(j_steps) == sum(hist["steps"])
    np.testing.assert_allclose(hist["loss"], j_hist["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["top1"], j_hist["top1"], atol=1e-6)
    assert hist["dev_em"] == j_hist["dev_em"]
    _assert_params_match(_leaves(named_to_jax(model.params.named_parameters())),
                         jmodel.params, 1e-4, 2 * 1e-3 * len(t_steps))
    for name in TOWERS:
        assert all(torch.equal(a, b) for a, b in zip(
            getattr(kept, name).parameters(),
            getattr(model.params, name).parameters()))
    assert model.params is params  # trained in place, the searcher swapped out


def test_train_query_drivers_in_both_packages(qft_store, tmp_path):
    """Both drivers on one encoder dir (a pytorch_model.bin both packages
    read) and one dump; the port's output dir loads and serves."""
    s = qft_store
    enc = tmp_path / "enc"
    enc.mkdir()
    params = encoder_from_jax(jax.tree.map(np.asarray, s["jparams"]),
                              s["tcfg"], device="cpu")
    torch.save(state_dict_from_encoder(params), str(enc / "pytorch_model.bin"))
    with open(enc / "config.json", "w") as f:
        json.dump(s["tcfg"].__dict__, f)
    WordPieceTokenizer(s["vocab"]).save_vocab(str(enc / "vocab.txt"))
    qa_path = tmp_path / "qa.json"
    with open(qa_path, "w") as f:
        json.dump({"data": [{"id": str(i), "question": q, "answers": a}
                            for i, (q, a) in enumerate(_qa())]}, f)
    histories = {}
    for name, main in (("jax", jax_cli.main), ("port", functools.partial(
            port_cli.main, device="cpu"))):
        argv = ["--load_dir", str(enc), "--dump_dir", str(s["root"] / "dump"),
                "--train_file", str(qa_path), "--dev_file", str(qa_path),
                "--per_device_train_batch_size", "4", "--qsft_top_k", "8",
                "--qsft_epochs", "1", "--max_query_length", "12",
                "--top_k", "2", "--output_dir", str(tmp_path / f"out_{name}")]
        histories[name] = main(argv)
    j, t = histories["jax"], histories["port"]
    assert len(t["loss"]) == len(j["loss"]) == 1
    assert len(t["dev_em"]) == len(j["dev_em"]) == 1
    assert np.isfinite(t["loss"]).all() and t["steps"][0] > 0
    # bf16 towers in both: the losses agree to bf16 noise
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=5e-2)
    out, cfg, tok = load_encoder(str(tmp_path / "out_port"), device="cpu")
    assert not torch.equal(out.query_start.q_w if hasattr(
        out.query_start, "q_w") else out.query_start.layers[0].q_w,
        params.query_start.layers[0].q_w)
    assert torch.equal(out.phrase.layers[0].q_w, params.phrase.layers[0].q_w)
    served = DensePhrases(out, cfg, tok, MIPS(PhraseStore.load(
        str(s["root"] / "dump" / "phrase")), device="cpu"),
        max_query_length=12).search(["find the word alpha"], top_k=2)
    assert served[0]
