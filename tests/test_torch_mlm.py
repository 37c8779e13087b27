"""The port's MLM pretraining (train/mlm.py, cli/train_mlm.py) and the three
trainers' optimizers (train/rc.AdamW and its schedules) against the JAX
reference: the packed chunks, ``mlm_loss`` and a train step fed the
reference's corruption draws and dropout bits from its key splits, the
optimizers against optax step for step, and the pretrained backbone into
an encoder save."""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densephrases_tpu.train.mlm as jax_mlm
from densephrases_tpu.cli import train_mlm as jax_cli
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.bert import bert_forward
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.train.cross_encoder import init_cross_params as jax_cross_init
from densephrases_tpu_torch.cli import train_mlm as port_cli
from densephrases_tpu_torch.cli.common import load_encoder, save_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.from_jax import (
    _copy,
    _load_bert,
    cross_from_jax,
    encoder_from_jax,
    named_to_jax,
)
from densephrases_tpu_torch.train import mlm as port_mlm
from densephrases_tpu_torch.train.cross_encoder import make_cross_optimizer
from densephrases_tpu_torch.train.query import make_query_optimizer, query_named
from densephrases_tpu_torch.train.rc import (
    linear_warmup_schedule,
    warmup_linear_decay_schedule,
)

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "phrase", "retrieval", "returns", "short", "answers", "from", "a",
         "large", "corpus", "dense", "vector", "indexes", "trade", "speed",
         "."]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS)}
B, L = 4, 16


def _texts(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS[:-1], int(rng.integers(5, 14)))) + " ."
            for _ in range(n)]


def _cfgs(dropout=0.1):
    j = dataclasses.replace(JaxBertConfig.tiny(len(VOCAB)),
                            hidden_dropout_prob=dropout)
    t = dataclasses.replace(BertConfig.tiny(len(VOCAB)),
                            hidden_dropout_prob=dropout)
    return j, t


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _port_mlm(jparams, cfg):
    """The reference's MLM tree → ``MLMParams`` on the CPU."""
    tree = jax.tree.map(np.asarray, jparams)
    params = port_mlm.MLMParams(cfg)
    _load_bert(params.bert, tree["bert"], "bert")
    for leaf, arr in tree["mlm"].items():
        _copy(getattr(params.mlm, leaf), arr, f"mlm/{leaf}")
    return params


def reference_draws(rng, cfg, shape):
    """What the reference's ``mlm_loss`` draws from ``rng``: the corruption
    lanes, and the dropout bits ``bert_forward`` draws from its r_drop key
    (the embedding's from the first split, then per layer two masks)."""
    b, l = shape
    r_pos, r_act, r_tok, r_drop = jax.random.split(rng, 4)
    draws = (jax.random.bits(r_pos, (b, l), dtype=jnp.uint8),
             jax.random.bits(r_act, (b, l), dtype=jnp.uint8),
             jax.random.randint(r_tok, (b, l), jax_mlm.N_SPECIAL,
                                cfg.vocab_size, dtype=jnp.int32))
    h = (b, l, cfg.hidden_size)
    rest, sub = jax.random.split(r_drop)
    emb = jax.random.bits(sub, h, dtype=jnp.uint8)
    layers = []
    for key in jax.random.split(rest, cfg.num_hidden_layers):
        r1, r2 = jax.random.split(key)
        layers.append(np.stack([np.asarray(jax.random.bits(r, h, jnp.uint8))
                                for r in (r1, r2)]))
    to_t = lambda a: torch.from_numpy(np.array(a))
    return (tuple(to_t(d) for d in draws),
            (to_t(emb), torch.from_numpy(np.stack(layers))))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    chunks = port_mlm.pack_chunks(_texts(), WordPieceTokenizer(VOCAB), L)
    jparams = jax_mlm.init_mlm_params(jax.random.PRNGKey(0), jcfg)
    return {"jcfg": jcfg, "tcfg": tcfg, "chunks": chunks, "jparams": jparams}


def test_pack_chunks_match_reference():
    texts = _texts(seed=1) + ["", "quick unknownword ."]
    for seq in (8, 16, 64):
        got = port_mlm.pack_chunks(texts, WordPieceTokenizer(VOCAB), seq)
        want = jax_mlm.pack_chunks(texts, JaxTokenizer(VOCAB), seq)
        np.testing.assert_array_equal(got, want)


def test_draw_constants_match_reference():
    assert port_mlm.POS_THRESHOLD == int(round(jax_mlm.MASK_RATE * 256)) == 38
    assert port_mlm.N_SPECIAL == jax_mlm.N_SPECIAL == 5
    u_pos, u_act, rand = port_mlm.mlm_draws((64, 32), 40,
                                            torch.Generator().manual_seed(0))
    assert u_pos.dtype == u_act.dtype == torch.uint8
    assert int(rand.min()) >= 5 and int(rand.max()) < 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlm_loss_and_gradients_match_reference(setup, monkeypatch, dtype):
    """One ``mlm_loss`` with dropout on: the port fed the reference's
    corruption draws and dropout bits. fp32 (towers patched to fp32 in the
    reference; the head rounds at its own bf16 points in both) and bf16."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    if dtype == "float32":
        monkeypatch.setattr(jax_mlm, "bert_forward", functools.partial(
            bert_forward, compute_dtype=jnp.float32))
    ids = setup["chunks"][:B]
    am = (ids != 0).astype(np.int32)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jax_mlm.mlm_loss(p, jcfg, jnp.asarray(ids), jnp.asarray(am),
                                rng, mask_token_id=4, attn_impl="xla")

    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(setup["jparams"])
    draws, bits = reference_draws(rng, jcfg, ids.shape)
    params = _port_mlm(setup["jparams"], tcfg)
    loss, m = port_mlm.mlm_loss(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(am), draws,
        mask_token_id=4, dropout=bits, compute_dtype=getattr(torch, dtype))
    loss.backward()
    assert float(m["n_pred"]) == float(r_m["n_pred"]) > 0
    # fp32: one function summed in other orders; bf16: both round at the
    # same points, a product one bf16 ulp apart carries through two layers
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=rtol)
    if dtype == "float32":
        assert float(m["acc"]) == float(r_m["acc"])
    got = _leaves(named_to_jax((n, p.grad) for n, p in
                               params.named_parameters()))
    want = _leaves(r_grads)
    assert got.keys() == want.keys()
    # each leaf within tol of its own largest entry (floored at 1e-4 of the
    # largest gradient). fp32: 1e-4 (measured 5e-7 at worst), except the
    # head's bf16 dense layer, whose gradients both packages round to bf16,
    # so they sit up to a bf16 ulp apart: 1e-2 (measured 5.8e-3 on dense_b).
    # bf16: 8e-2 (measured 2.7e-2 at worst), as tests/test_torch_train.py
    floor = 1e-4 * max(np.abs(np.asarray(v)).max() for v in want.values())
    for path, w in want.items():
        key = jax.tree_util.keystr(path)
        tol = (8e-2 if dtype == "bfloat16" else
               1e-2 if key in ("['mlm']['dense_w']", "['mlm']['dense_b']")
               else 1e-4)
        w = np.asarray(w)
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, (key, err)


def test_mlm_steps_match_reference(setup, monkeypatch):
    """Two steps of ``make_mlm_step`` in both packages, fp32 towers,
    dropout on, the port fed each step's reference draws; warmup 1 so the
    first update has lr 0 and the second is the one that moves, clipping at
    a global norm of 1."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    monkeypatch.setattr(jax_mlm, "bert_forward", functools.partial(
        bert_forward, compute_dtype=jnp.float32))
    lr = 1e-3
    j_opt = jax_mlm.make_mlm_optimizer(lr, 1, 10)
    jparams = setup["jparams"]
    j_state = j_opt.init(jparams)
    j_step = jax_mlm.make_mlm_step(jcfg, j_opt, mask_token_id=4,
                                   attn_impl="xla")
    params = _port_mlm(jparams, tcfg)
    opt = port_mlm.make_mlm_optimizer(lr, 1, 10)
    state = opt.init(dict(params.named_parameters()))
    step = port_mlm.make_mlm_step(tcfg, opt, mask_token_id=4,
                                  compute_dtype=torch.float32)
    for i in range(2):
        ids = setup["chunks"][i * B:(i + 1) * B]
        batch = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}
        rng = jax.random.PRNGKey(10 + i)
        jparams, j_state, j_m = j_step(
            jparams, j_state, {k: jnp.asarray(v) for k, v in batch.items()},
            rng)
        draws, bits = reference_draws(rng, jcfg, ids.shape)
        m = step(params, state, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, draws, bits)
        # both steps see equal parameters (lr 0 at the first): losses to
        # fp32 rounding. A later step would not: parameters 1e-5 apart can
        # round the head's bf16 dense weights to neighbouring bf16 values
        np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]),
                                   rtol=1e-5)
        assert float(m["n_pred"]) == float(j_m["n_pred"])
        got = _leaves(named_to_jax(params.named_parameters()))
        for path, want in _leaves(jparams).items():
            # the key bias's gradient is 0 by symmetry (rounding noise that
            # Adam turns into moves of up to lr a step): held to that bound
            noise = jax.tree_util.keystr(path).endswith("['k_b']")
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                       atol=2 * lr * i if noise else 1e-5,
                                       err_msg=str(path))
    assert state["count"] == 2


# ---- the three trainers' optimizers against optax ------------------------

def _optax_query(lr, total, ratio):
    warm = max(int(total * ratio), 1)
    return optax.adamw(optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warm),
         optax.linear_schedule(lr, 0.0, total)], [warm]), weight_decay=0.01)


def _optax_cross(lr, steps):
    warm = max(steps // 10, 1)
    return optax.adamw(optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warm),
         optax.linear_schedule(lr, 0.0, steps)], [warm]), weight_decay=0.01)


@pytest.mark.parametrize("which", ["query", "cross", "mlm"])
def test_optimizers_match_optax(which):
    """Five steps of identical gradients, the first two large (the MLM chain
    clips them), then small ones; each optimizer's schedule and decay mask
    (every parameter for query FT and the teacher; not the layer norms and
    biases for MLM) against the reference's optax chain."""
    jcfg, tcfg = _cfgs()
    lr = 1e-2
    if which == "query":
        tree = jax_init(jax.random.PRNGKey(1), jcfg)
        tree = {k: tree[k] for k in ("query_start", "query_end")}
        params = encoder_from_jax(jax.tree.map(np.asarray, tree | {
            "phrase": tree["query_start"], "filter": {
                "w": np.zeros((tcfg.hidden_size, 2), np.float32),
                "b": np.zeros(2, np.float32)}}), tcfg, device="cpu")
        named = query_named(params)
        j_opt, opt = _optax_query(lr, 12, 0.25), make_query_optimizer(lr, 12,
                                                                     0.25)
    elif which == "cross":
        tree = jax_cross_init(jax.random.PRNGKey(2), jcfg)
        params = cross_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                                device="cpu")
        named = dict(params.named_parameters())
        j_opt, opt = _optax_cross(lr, 30), make_cross_optimizer(lr, 30)
    else:
        tree = jax_mlm.init_mlm_params(jax.random.PRNGKey(3), jcfg)
        params = _port_mlm(tree, tcfg)
        named = dict(params.named_parameters())
        j_opt = jax_mlm.make_mlm_optimizer(lr, 2, 6, weight_decay=0.1)
        opt = port_mlm.make_mlm_optimizer(lr, 2, 6, weight_decay=0.1)
    j_state = j_opt.init(tree)
    state = opt.init(named)
    rng = np.random.default_rng(4)
    for scale in (5.0, 3.0, 0.01, 0.02, 0.5):
        g_np = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                for n, p in named.items()}
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in g_np.values()))
        g_np = {n: g * (scale / norm) for n, g in g_np.items()}
        j_grads = named_to_jax((n, torch.from_numpy(g))
                               for n, g in g_np.items())
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, j_grads),
                                    j_state, tree)
        tree = optax.apply_updates(tree, upd)
        opt.update({n: torch.from_numpy(g) for n, g in g_np.items()}, state,
                   named)
        got = _leaves(named_to_jax(named.items()))
        for path, want in _leaves(tree).items():
            # fp32 elementwise updates in another operation order
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6,
                                       atol=1e-7, err_msg=str(path))
    assert state["count"] == 5


def test_schedules_match_optax():
    for lr, warm, total in ((1e-3, 1, 5), (3e-5, 2, 12), (1e-2, 3, 3)):
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warm),
             optax.linear_schedule(lr, 0.0, total)], [warm])
        got = warmup_linear_decay_schedule(lr, warm, total)
        for count in range(total + warm + 2):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                               abs=1e-12)
    # MLM: warmup max(steps // 20, 10), decay over steps - warmup
    for steps in (6, 40, 400):
        warm = max(steps // 20, 10)
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, 1e-3, max(warm, 1)),
             optax.linear_schedule(1e-3, 0.0, max(steps - warm, 1))],
            [max(warm, 1)])
        got = linear_warmup_schedule(1e-3, warm, steps)
        for count in range(0, steps + 2, max(steps // 10, 1)):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                               abs=1e-12)


@pytest.mark.parametrize("path,decayed", [
    ("bert/embed/word", True), ("bert/embed/ln_scale", False),
    ("bert/layers/q_w", True), ("bert/layers/q_b", False),
    ("bert/layers/attn_ln_bias", False), ("mlm/dense_w", True),
    ("mlm/dense_b", False), ("mlm/ln_scale", False), ("mlm/ln_bias", False),
    ("mlm/out_bias", False)])
def test_mlm_decay_mask(path, decayed):
    assert port_mlm.mlm_decayed(path) is decayed


# ---- pretraining end to end ------------------------------------------------

def test_pretrain_and_transplant(tmp_path):
    """A few steps of ``pretrain_mlm`` with a held-out probe, then the
    backbone into all three towers of an encoder save that loads back."""
    _, tcfg = _cfgs()
    tok = WordPieceTokenizer(VOCAB)
    params, hist = port_mlm.pretrain_mlm(
        _texts(48), tok, tcfg, steps=4, batch_size=4, seq_len=L, lr=1e-3,
        log_every=2, holdout_frac=0.1, device="cpu")
    assert len(hist["loss"]) == len(hist["dev_loss"]) == 2
    assert all(np.isfinite(hist["loss"]))
    enc = port_mlm.encoder_params_from_backbone(
        params.bert, tcfg, torch.Generator().manual_seed(0))
    save_encoder(str(tmp_path), enc, tcfg, tok)
    loaded, cfg, _ = load_encoder(str(tmp_path), device="cpu")
    assert cfg == tcfg
    backbone = params.bert.state_dict()
    for tower in ("phrase", "query_start", "query_end"):
        for k, v in getattr(loaded, tower).state_dict().items():
            assert torch.equal(v, backbone[k]), (tower, k)
    assert loaded.filter.w.abs().sum() > 0 and not loaded.filter.b.any()


def test_train_mlm_drivers_in_both_packages(tmp_path, monkeypatch):
    """Both drivers on one corpus file at a tiny size: the same flags and
    the same output blob."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(_texts(64, seed=3)) + "\n")
    argv = ["--corpus", str(corpus), "--steps", "2", "--batch", "4",
            "--seq", "16", "--hidden", "32", "--layers", "1", "--heads", "2",
            "--vocab", "120", "--max_pos", "32", "--holdout", "0.1"]
    monkeypatch.setattr(sys, "argv", ["train_mlm", "--out",
                                      str(tmp_path / "jax")] + argv)
    (tmp_path / "jax").mkdir()
    jax_cli.main()
    (tmp_path / "port").mkdir()
    blob = port_cli.main(["--out", str(tmp_path / "port")] + argv,
                         device="cpu")
    with open(tmp_path / "jax" / "mlm_history.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "mlm_history.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(blob))
    assert got.keys() == want.keys()
    assert got["history"].keys() == want["history"].keys()
    for k in ("steps", "batch", "seq", "lr", "n_paragraphs"):
        assert got[k] == want[k], k
    params, cfg, tok = load_encoder(str(tmp_path / "port"), device="cpu")
    assert cfg.hidden_size == 32 and cfg.num_hidden_layers == 1
    assert tok.vocab_size == cfg.vocab_size
