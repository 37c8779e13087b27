"""``convert_jax_checkpoint.py``: a JAX package save directory (orbax) into
the port's format, read by the port's ``load_encoder`` (an encoder) or by
``restore_checkpoint`` into ``init_cross_params`` (a teacher), held against
the JAX functions on the same tokens; and the port's refusal of a raw orbax
directory, with an error that names the converter."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_checkpoint
from densephrases_tpu.cli.common import save_encoder as jax_save_encoder
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.eval import reader as jax_reader
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import embed_query as jax_embed_query
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.train.cross_encoder import init_cross_params as jax_init_cross
from densephrases_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from densephrases_tpu_torch.cli.common import load_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.eval.reader import read_passages
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import embed_query
from densephrases_tpu_torch.models.from_jax import cross_from_jax, encoder_from_jax
from densephrases_tpu_torch.train.cross_encoder import init_cross_params
from densephrases_tpu_torch.utils.checkpoint import restore_checkpoint

WORDS = [f"w{i}" for i in range(60)] + ["paris", "river"]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS + [".", "?"])}


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A JAX encoder save and a JAX teacher save (train_cross_encoder's
    layout), each converted by the script's command line."""
    tmp = tmp_path_factory.mktemp("convert")
    jcfg = dataclasses.replace(JaxBertConfig.tiny(vocab_size=len(VOCAB)),
                               max_position_embeddings=384)
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    jax_save_encoder(str(tmp / "jax_enc"), jparams, jcfg, JaxTokenizer(VOCAB))
    jcross = jax_init_cross(jax.random.PRNGKey(4), jcfg)
    os.makedirs(tmp / "jax_teacher")
    (tmp / "jax_teacher" / "config.json").write_text(
        json.dumps(jcfg.__dict__))
    JaxTokenizer(VOCAB).save_vocab(str(tmp / "jax_teacher" / "vocab.txt"))
    jax_save_checkpoint(str(tmp / "jax_teacher" / "params"), jcross, step=0)
    for kind, src in (("encoder", "jax_enc"), ("cross", "jax_teacher")):
        assert convert_jax_checkpoint.main(
            ["--kind", kind, str(tmp / src), str(tmp / f"port_{kind}")]) == 0
    return {"tmp": tmp, "jcfg": jcfg, "jparams": jparams, "jcross": jcross}


def test_converter_writes_the_port_layout(saves):
    step = saves["tmp"] / "jax_enc" / "params" / "step_0"
    assert (step / "_CHECKPOINT_METADATA").exists()
    out = saves["tmp"] / "port_encoder"
    assert sorted(os.listdir(out)) == ["config.json", "params", "vocab.txt"]
    assert os.listdir(out / "params" / "step_0") == ["state.pt"]
    assert (out / "vocab.txt").read_text() == \
        (saves["tmp"] / "jax_enc" / "vocab.txt").read_text()


def test_converted_encoder_serves_like_the_reference(saves):
    params, config, tok = load_encoder(str(saves["tmp"] / "port_encoder"),
                                       device="cpu")
    assert dataclasses.asdict(config) == dataclasses.asdict(saves["jcfg"])
    assert tok.vocab == VOCAB
    # the weights are the bridge's, bit for bit
    want = encoder_from_jax(jax.tree.map(np.asarray, saves["jparams"]),
                            config, device="cpu").state_dict()
    got = params.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, len(VOCAB), (4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    types = np.zeros_like(ids)
    rs, re_ = jax_embed_query(saves["jparams"], saves["jcfg"],
                              jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(types), attn_impl="xla")
    qs, qe = embed_query(params, *(torch.as_tensor(x, dtype=torch.long)
                                   for x in (ids, mask, types)))
    for out, ref in ((qs, rs), (qe, re_)):
        # test_torch_bert.py::test_embed_query_matches_bf16's bound
        diff = np.abs(out.numpy() - np.asarray(ref))
        assert diff.max() < 0.05 and diff.mean() < 1e-2, diff.max()


def test_converted_teacher_reads_like_the_reference(saves):
    tmp = saves["tmp"]
    config = BertConfig(**saves["jcfg"].__dict__)
    teacher = restore_checkpoint(
        str(tmp / "port_cross" / "params"),
        init_cross_params(config, torch.Generator().manual_seed(9),
                          device="cpu"))
    want = cross_from_jax(jax.tree.map(np.asarray, saves["jcross"]), config,
                          device="cpu").state_dict()
    assert all(torch.equal(teacher.state_dict()[k], want[k]) for k in want)
    questions = ["w3 w4 ?", "where is the river", "w10"]
    rng = np.random.default_rng(1)
    passages = [" ".join(rng.choice(WORDS, 30)) + " ." for _ in questions]
    tok = JaxTokenizer(VOCAB)
    ref = jax_reader.read_passages(saves["jcross"], saves["jcfg"], tok,
                                   questions, passages, attn_impl="xla")
    got = read_passages(teacher, config, WordPieceTokenizer(VOCAB), questions,
                        passages)
    for g, w in zip(got, ref):
        assert {k: g[k] for k in g if k != "score"} == \
            {k: w[k] for k in w if k != "score"}
        np.testing.assert_allclose(g["score"], w["score"], rtol=2e-2,
                                   atol=1e-3)


@pytest.mark.parametrize("src", ["jax_enc", "jax_teacher"])
def test_raw_orbax_save_is_refused_naming_the_converter(saves, src):
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py"):
        load_encoder(str(saves["tmp"] / src), device="cpu")


def test_unknown_kind_is_refused(saves, tmp_path):
    with pytest.raises(ValueError, match="kind"):
        convert_jax_checkpoint.convert(str(saves["tmp"] / "jax_enc"),
                                       str(tmp_path / "out"), kind="mlm")
    with pytest.raises(SystemExit):
        convert_jax_checkpoint.main(["--kind", "mlm", "a", "b"])
