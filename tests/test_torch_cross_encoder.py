"""The port's cross-encoder trainer (train/cross_encoder.py,
cli/train_cross_encoder.py) and reader (eval/reader.py) against the JAX
reference on the same seeded inputs and bridged weights: the answer
positions, train steps, a whole run, the saved teacher loading into
``train_rc``, and the reader's answers and scores."""

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

import densephrases_tpu.eval.reader as jax_reader
import densephrases_tpu.train.cross_encoder as jax_cross
from densephrases_tpu.data.rc_dataset import batches as jax_batches
from densephrases_tpu.data.rc_dataset import convert_rc_examples as jax_convert
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.bert import bert_forward
from densephrases_tpu_torch.cli import train_cross_encoder as cross_cli
from densephrases_tpu_torch.cli import train_rc
from densephrases_tpu_torch.cli.common import save_encoder
from densephrases_tpu_torch.data.qa import load_rc_examples
from densephrases_tpu_torch.data.rc_dataset import batches, convert_rc_examples
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.eval import reader as port_reader
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import init_encoder_params
from densephrases_tpu_torch.models.from_jax import cross_from_jax, named_to_jax
from densephrases_tpu_torch.train import cross_encoder as port_cross
from densephrases_tpu_torch.train.cross_encoder import CrossParams
from densephrases_tpu_torch.utils.checkpoint import restore_checkpoint

WORDS = [f"w{i}" for i in range(120)]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS + [".", ","])}
FEAT_KW = dict(max_seq_length=48, doc_stride=24, max_query_length=12,
               with_teacher=True, max_cross_length=60)


def _cfgs(dropout=0.0):
    # a vocab size of this file's own: the reference's module-level jitted
    # reader forward is never served from a cache traced at another
    # precision
    j = dataclasses.replace(JaxBertConfig.tiny(len(VOCAB) + 1),
                            hidden_dropout_prob=dropout)
    t = dataclasses.replace(BertConfig.tiny(len(VOCAB) + 1),
                            hidden_dropout_prob=dropout)
    return j, t


def _squad(path, seed=0, n_titles=3):
    """A SQuAD-format file: questions are words of their paragraph, answers
    1-4 word spans of it."""
    rng = np.random.default_rng(seed)
    data = []
    for a in range(n_titles):
        paras = []
        for p in range(2):
            ws = list(rng.choice(WORDS, 36))
            qas = []
            for q in range(2):
                s, n = int(rng.integers(0, 32)), int(rng.integers(1, 5))
                qas.append({"id": f"{a}-{p}-{q}",
                            "question": " ".join(rng.choice(ws, 5)),
                            "answers": [{"text": " ".join(ws[s:s + n]),
                                         "answer_start": len(" ".join(ws[:s]))
                                         + (1 if s else 0)}]})
            paras.append({"context": " ".join(ws), "qas": qas})
        data.append({"title": f"t{a}", "paragraphs": paras})
    with open(path, "w") as f:
        json.dump({"data": data}, f)
    return path


def _fp32_reference(monkeypatch):
    monkeypatch.setattr(jax_cross, "bert_forward", functools.partial(
        bert_forward, compute_dtype=jnp.float32))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _port_cross(jparams, cfg):
    """The reference's teacher tree → ``CrossParams`` on the CPU."""
    return cross_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


# leaves whose gradient is 0 by symmetry, so that in both packages it is
# rounding noise, which Adam's normalisation turns into moves of up to lr a
# step in any direction: the key biases (a softmax ignores a shift shared
# by a row's scores), and what shifts every position's start or end logit
# alike (the QA head's bias, the last layer norm's bias; the leaf stacks
# every layer's, the others' within the bound too)
NOISE_LEAVES = ("['k_b']", "['qa_outputs']['b']", "['ffn_ln_bias']")


def _assert_params_match(got_module, want_tree, atol, noise_bound):
    """Each leaf within ``atol`` of the reference's; ``NOISE_LEAVES`` within
    ``noise_bound``."""
    got = _leaves(named_to_jax(got_module.named_parameters()))
    for path, want in _leaves(want_tree).items():
        noise = jax.tree_util.keystr(path).endswith(NOISE_LEAVES)
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                   atol=noise_bound if noise else atol,
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cross")
    path = _squad(str(tmp / "train.json"))
    examples = load_rc_examples(path)
    feats = convert_rc_examples(examples, WordPieceTokenizer(VOCAB), **FEAT_KW)
    jfeats = jax_convert(examples, JaxTokenizer(VOCAB), **FEAT_KW)
    jcfg, _ = _cfgs()
    jparams = jax_cross.init_cross_params(jax.random.PRNGKey(0), jcfg)
    return {"tmp": tmp, "path": path, "feats": feats, "jfeats": jfeats,
            "jparams": jparams}


def test_cross_positions_match_reference(data):
    for g, w in zip(batches(data["feats"], 4, seed=1),
                    jax_batches(data["jfeats"], 4, seed=1)):
        for a, b in zip(port_cross.cross_positions(g),
                        jax_cross.cross_positions(w)):
            np.testing.assert_array_equal(a, b)
    # an unmapped or out-of-range position becomes 0
    batch = {"teacher_gather": np.array([[-1, 5, 6], [2, 3, -1]]),
             "start_positions": np.array([0, 1]),
             "end_positions": np.array([3, 2])}
    for a, b in zip(port_cross.cross_positions(batch),
                    jax_cross.cross_positions(batch)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_cross.cross_positions(batch)[1], [0, 0])


def _cross_batch(feats, bs, seed):
    batch = next(batches(feats, bs, seed=seed))
    cs, ce = port_cross.cross_positions(batch)
    out = {k: batch[k] for k in port_cross.CROSS_KEYS}
    out["cross_start_positions"], out["cross_end_positions"] = cs, ce
    return out


def test_cross_train_steps_match_reference(data, monkeypatch):
    """Three steps of both packages' teacher steps, fp32, dropout off; the
    first has lr 0 (warmup)."""
    jcfg, tcfg = _cfgs()
    _fp32_reference(monkeypatch)
    lr, steps = 1e-3, 10
    warm = max(steps // 10, 1)
    j_opt = optax.adamw(optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warm),
         optax.linear_schedule(lr, 0.0, steps)], [warm]), weight_decay=0.01)
    jparams = data["jparams"]
    j_state = j_opt.init(jparams)
    j_step = jax_cross.make_cross_train_step(jcfg, j_opt, attn_impl="xla")
    params = _port_cross(jparams, tcfg)
    opt = port_cross.make_cross_optimizer(lr, steps)
    state = opt.init(dict(params.named_parameters()))
    step = port_cross.make_cross_train_step(tcfg, opt,
                                            compute_dtype=torch.float32)
    batch = _cross_batch(data["feats"], 4, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jparams, j_state, j_loss = j_step(jparams, j_state, jb,
                                          jax.random.PRNGKey(i))
        loss = step(params, state, tb, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        _assert_params_match(params, jparams, 1e-5, 2 * lr * i)
    assert state["count"] == 3


def test_train_cross_encoder_matches_reference(data, monkeypatch):
    """Two epochs from the same weights, fp32, dropout off: the same
    batches (``batches(seed=seed + epoch)``) and the same losses."""
    jcfg, tcfg = _cfgs()
    _fp32_reference(monkeypatch)
    kw = dict(epochs=2, batch_size=4, lr=1e-3, seed=5)
    jparams, j_losses = jax_cross.train_cross_encoder(
        jcfg, data["jfeats"], attn_impl="xla", params=data["jparams"], **kw)
    params, losses = port_cross.train_cross_encoder(
        tcfg, data["feats"], params=_port_cross(data["jparams"], tcfg),
        device="cpu", compute_dtype=torch.float32, **kw)
    assert len(losses) == len(j_losses) == 2 * (len(data["feats"]) // 4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    _assert_params_match(params, jparams, 1e-4, 2e-3 * len(losses))


def test_driver_saves_a_teacher_that_train_rc_loads(data, tmp_path):
    _, tcfg = _cfgs()
    enc = str(tmp_path / "enc")
    save_encoder(enc, init_encoder_params(tcfg, device="cpu"), tcfg,
                 WordPieceTokenizer(VOCAB))
    teacher_dir = str(tmp_path / "teacher")
    common = ["--max_seq_length", "48", "--max_query_length", "12",
              "--doc_stride", "24", "--per_device_train_batch_size", "4"]
    teacher, losses = cross_cli.main(
        ["--load_dir", enc, "--train_file", data["path"], "--output_dir",
         teacher_dir, "--num_train_epochs", "1"] + common, device="cpu")
    assert len(losses) == len(data["feats"]) // 4 and np.isfinite(losses).all()
    for name in ("config.json", "vocab.txt", "params/step_0/state.pt"):
        assert os.path.exists(os.path.join(teacher_dir, name)), name
    saved = restore_checkpoint(os.path.join(teacher_dir, "params"),
                               CrossParams(tcfg))
    for a, b in zip(saved.parameters(), teacher.parameters()):
        assert torch.equal(a, b)
    state, _ = train_rc.main(
        ["--load_dir", enc, "--train_file", data["path"], "--output_dir",
         str(tmp_path / "student"), "--lambda_kl", "2.0", "--teacher_dir",
         teacher_dir, "--max_steps", "2", "--warmup_steps", "1"] + common,
        device="cpu")
    # the student's teacher is the saved one (never trained further)
    for name in ("cross", "qa_outputs"):
        for a, b in zip(getattr(state.params, name).parameters(),
                        getattr(teacher, name).parameters()):
            assert torch.equal(a, b), name


def test_build_cq_inputs_match_reference():
    qs = ["what is w3", "w7 w8 w9 w10", ""]
    ps = ["w1  w2 w3\tw4 w5 .", " ".join(WORDS[:50]), "w9"]
    got = port_reader.build_cq_inputs(qs, ps, WordPieceTokenizer(VOCAB), 24)
    want = jax_reader.build_cq_inputs(qs, ps, JaxTokenizer(VOCAB), 24)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def test_read_passages_matches_reference(data, monkeypatch):
    """Both packages' readers on one teacher, fp32: the same answers and
    offsets, scores within fp32 rounding of the logit sums."""
    jcfg, tcfg = _cfgs()

    @functools.partial(jax.jit, static_argnames=("config", "attn_impl"))
    def fp32_forward(params, ids, mask, types, *, config, attn_impl="auto"):
        # the reference's _reader_forward at fp32 compute
        hidden = bert_forward(params["cross"], ids, mask, types,
                              config=config, deterministic=True,
                              attn_impl=attn_impl, compute_dtype=jnp.float32)
        logits = jnp.einsum("blh,ho->blo", hidden,
                            params["qa_outputs"]["w"]) + params["qa_outputs"]["b"]
        return logits[..., 0], logits[..., 1]

    monkeypatch.setattr(jax_reader, "_reader_forward", fp32_forward)
    examples = load_rc_examples(data["path"])
    qs = [e["question"] for e in examples]
    ps = [e["context"] for e in examples]
    want = jax_reader.read_passages(data["jparams"], jcfg, JaxTokenizer(VOCAB),
                                    qs, ps, max_length=64, attn_impl="xla")
    got = port_reader.read_passages(_port_cross(data["jparams"], tcfg), tcfg,
                                    WordPieceTokenizer(VOCAB), qs, ps,
                                    max_length=64,
                                    compute_dtype=torch.float32)
    assert len(got) == len(want) == len(qs)
    for g, w in zip(got, want):
        assert {k: g[k] for k in g if k != "score"} == \
            {k: w[k] for k in w if k != "score"}
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5,
                                   atol=1e-6)
        assert g["context"][g["start_pos"]:g["end_pos"]] == g["answer"]
