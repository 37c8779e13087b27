"""The port's HF / DensePhrases checkpoint import (models/hf_import.py) and
``cli.common.load_encoder``'s ``pytorch_model.bin`` branch against the JAX
reference: a tiny state dict under the reference's key names, written with
``torch.save`` in each prefix spelling, loaded by both packages."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densephrases_tpu.models.encoder as jax_encoder
from densephrases_tpu.cli.common import load_encoder as jax_load_encoder
from densephrases_tpu.models import hf_import as jax_hf
from densephrases_tpu.models.bert import bert_forward
from densephrases_tpu_torch.cli.common import load_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.models import hf_import
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import embed_query, init_encoder_params
from densephrases_tpu_torch.models.from_jax import encoder_to_jax

VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + [f"w{i}" for i in range(60)])}


@pytest.fixture(scope="module")
def source():
    cfg = BertConfig.tiny(len(VOCAB))
    params = init_encoder_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    # distinct towers, so that a tower read under the wrong prefix shows
    with torch.no_grad():
        for i, tower in enumerate((params.query_start, params.query_end)):
            for p in tower.parameters():
                p.add_(0.01 * (i + 1))
    return cfg, params


def _write(path, params, cfg, spelling, bert_level):
    path.mkdir()
    torch.save(hf_import.state_dict_from_encoder(params, spelling, bert_level),
               str(path / "pytorch_model.bin"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg.__dict__, f)
    WordPieceTokenizer(VOCAB).save_vocab(str(path / "vocab.txt"))
    return str(path)


@pytest.mark.parametrize("spelling,bert_level", [(0, False), (1, False),
                                                 (0, True), (1, True)],
                         ids=["current", "old", "current-bert", "old-bert"])
def test_both_packages_load_the_same_encoder(source, tmp_path, monkeypatch,
                                             spelling, bert_level):
    cfg, params = source
    path = _write(tmp_path / "enc", params, cfg, spelling, bert_level)
    loaded, lcfg, tok = load_encoder(path, device="cpu")
    jparams, jcfg, jtok = jax_load_encoder(path)
    assert lcfg == cfg and tok.vocab == jtok.vocab == VOCAB
    # the same weights, exactly, in both packages, and the source's
    got = encoder_to_jax(loaded)
    want = jax.tree.map(np.asarray, jparams)
    src = encoder_to_jax(params)
    for tree in (want, src):
        for (path_, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(tree)):
            np.testing.assert_array_equal(a, b, err_msg=str(path_))
    # the same query vectors: fp32 towers in both (the reference patched to
    # fp32 compute), one function in one precision: 1e-5 relative
    monkeypatch.setattr(jax_encoder, "bert_forward", functools.partial(
        bert_forward, compute_dtype=jnp.float32))
    rng = np.random.default_rng(0)
    ids = rng.integers(5, len(VOCAB), (3, 10)).astype(np.int32)
    am = np.ones_like(ids)
    am[1, 6:] = 0
    r_qs, r_qe = jax_encoder.embed_query(jparams, jcfg, jnp.asarray(ids),
                                         jnp.asarray(am), attn_impl="xla")
    qs, qe = embed_query(loaded, torch.from_numpy(ids), torch.from_numpy(am),
                         compute_dtype=torch.float32)
    for a, b in ((qs, r_qs), (qe, r_qe)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_state_dict_mapping_matches_reference(source):
    cfg, params = source
    sd = hf_import.state_dict_from_encoder(params)
    got = hf_import.encoder_params_from_state_dict(sd, cfg)
    want = jax_hf.encoder_params_from_state_dict(sd, cfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # a HF BertModel (under 'bert.') maps like one tower
    tower = {k[len("phrase_encoder."):]: v for k, v in sd.items()
             if k.startswith("phrase_encoder.")}
    hf = {"bert." + k: v for k, v in tower.items()}
    a = hf_import.bert_params_from_state_dict(hf, cfg, prefix="bert.")
    b = jax_hf.bert_params_from_state_dict(hf, cfg, prefix="bert.")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_missing_tower_raises(source, tmp_path):
    cfg, params = source
    sd = {k: v for k, v in hf_import.state_dict_from_encoder(params).items()
          if not k.startswith("query_end_encoder.")}
    with pytest.raises(KeyError, match="query_end"):
        hf_import.encoder_params_from_state_dict(sd, cfg)


def test_load_encoder_without_params_dir_or_bin_raises(tmp_path):
    cfg = BertConfig.tiny(len(VOCAB))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg.__dict__, f)
    WordPieceTokenizer(VOCAB).save_vocab(str(tmp_path / "vocab.txt"))
    with pytest.raises(FileNotFoundError):
        load_encoder(str(tmp_path), device="cpu")
