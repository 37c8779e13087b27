"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU, and nothing lands on the CPU silently.

Each public entry point that places data defaults to ``device="cuda"``,
resolved through ``utils/device.py:resolve_device``, which raises when there
is no GPU and never falls back. The internal helpers that take their
device from a caller have no default at all."""

import inspect

import numpy as np
import pytest
import torch

from densephrases_tpu_torch.cli import (
    build_phrase_index,
    common,
    eval_phrase_retrieval,
    generate_phrase_vecs,
    run_demo,
    train_cross_encoder,
    train_mlm,
    train_query,
    train_rc,
)
from densephrases_tpu_torch import parallel
from densephrases_tpu_torch.index import ivf, search, sharded
from densephrases_tpu_torch.parallel import multihost
from densephrases_tpu_torch.tools import parallel_dump
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFIndex
from densephrases_tpu_torch.index.tiered import TieredFlatIndex, TieredIVF
from densephrases_tpu_torch.models import encoder, from_jax
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.ops import kmeans, opq, pq
from densephrases_tpu_torch.serve import server
from densephrases_tpu_torch.train import cross_encoder, mlm

ENTRY_POINTS = {
    "FlatIndex.__init__": FlatIndex.__init__,
    "IVFIndex.__init__": IVFIndex.__init__,
    "IVFIndex.build": IVFIndex.build,
    "IVFIndex.load": IVFIndex.load,
    "IVFIndex.build_host_save": IVFIndex.build_host_save,
    "TieredFlatIndex.__init__": TieredFlatIndex.__init__,
    "TieredIVF.__init__": TieredIVF.__init__,
    "TieredIVF.load": TieredIVF.load,
    "TieredIVF.from_index": TieredIVF.from_index,
    "init_encoder_params": encoder.init_encoder_params,
    "encoder_from_jax": from_jax.encoder_from_jax,
    "load_encoder": common.load_encoder,
    "init_cross_params": cross_encoder.init_cross_params,
    "train_rc.main": train_rc.main,
    "generate_phrase_vecs.main": generate_phrase_vecs.main,
    "build_phrase_index.main": build_phrase_index.main,
    "eval_phrase_retrieval.main": eval_phrase_retrieval.main,
    "init_mlm_params": mlm.init_mlm_params,
    "pretrain_mlm": mlm.pretrain_mlm,
    "train_cross_encoder": cross_encoder.train_cross_encoder,
    "train_query.main": train_query.main,
    "train_cross_encoder.main": train_cross_encoder.main,
    "train_mlm.main": train_mlm.main,
    "run_demo.main": run_demo.main,
    # exported as densephrases_tpu_torch.Encoder: a user's constructor
    "Encoder.__init__": encoder.PhraseEncoder.__init__,
}

HELPERS = {
    "kmeans.accumulate_blocks": kmeans.accumulate_blocks,
    "kmeans.assign_blocks": kmeans.assign_blocks,
    "kmeans.kmeans": kmeans.kmeans,
    "kmeans.sort_children": kmeans.sort_children,
    "kmeans.kmeans_batched": kmeans.kmeans_batched,
    "kmeans.kmeans_two_level": kmeans.kmeans_two_level,
    "kmeans.assign_blocks_hier": kmeans.assign_blocks_hier,
    "kmeans.assign_hier_streamed": kmeans.assign_hier_streamed,
    "pq.train_pq": pq.train_pq,
    "pq.pq_encode": pq.pq_encode,
    "opq.train_opq": opq.train_opq,
    "ivf._balance_lists": ivf._balance_lists,
    "ivf._balance_lists_hier": ivf._balance_lists_hier,
    "ivf._force_partition": ivf._force_partition,
    "ivf._sq4_encode_stream": ivf._sq4_encode_stream,
    "IVFIndex.build_coarse": IVFIndex.build_coarse,
    "IVFIndex._train_sample": IVFIndex._train_sample,
    "IVFIndex._finish_build": IVFIndex._finish_build,
    "encoder.init_pre_batch": encoder.init_pre_batch,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda", (name, param.default)


def test_mips_default_is_the_index_device_else_the_card():
    # None: the given index's device, else "cuda" (the test below)
    param = inspect.signature(search.MIPS.__init__).parameters["device"]
    assert param.default is None


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_takes_its_device_from_the_caller(name):
    param = inspect.signature(HELPERS[name]).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY, (name, param.kind)
    assert param.default is inspect.Parameter.empty, (name, param.default)


def test_exported_encoder_is_an_entry_point(monkeypatch):
    import densephrases_tpu_torch

    assert densephrases_tpu_torch.Encoder is encoder.PhraseEncoder
    cfg = BertConfig.tiny()
    enc = densephrases_tpu_torch.Encoder(cfg, None, None, True, device="cpu")
    assert enc.params.with_teacher and enc.params.device.type == "cpu"
    assert not densephrases_tpu_torch.Encoder(cfg, device="cpu") \
        .params.with_teacher
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        densephrases_tpu_torch.Encoder(cfg)


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", ["init_encoder_params", "FlatIndex",
                                  "init_cross_params", "load_encoder",
                                  "TieredIVF.load", "TieredFlatIndex",
                                  "init_mlm_params", "pretrain_mlm",
                                  "train_cross_encoder", "make_mesh",
                                  "global_mesh", "ShardedIVF.build",
                                  "run_parallel_dump"])
def test_no_device_without_a_gpu_raises(monkeypatch, call, tmp_path):
    _no_gpu(monkeypatch)
    cfg = BertConfig.tiny()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if call == "init_encoder_params":
            encoder.init_encoder_params(cfg)
        elif call == "FlatIndex":
            FlatIndex(np.zeros((8, 4), np.int8))
        elif call == "TieredIVF.load":
            codes = np.random.default_rng(0).integers(
                -128, 128, (64, 8)).astype(np.int8)
            IVFIndex.build(codes, ivf.IVFConfig(num_clusters=4),
                           device="cpu").save(str(tmp_path / "ivf"))
            TieredIVF.load(str(tmp_path / "ivf"))
        elif call == "TieredFlatIndex":
            TieredFlatIndex(np.zeros((8, 4), np.int8))
        elif call == "init_cross_params":
            cross_encoder.init_cross_params(cfg)
        elif call == "init_mlm_params":
            mlm.init_mlm_params(cfg)
        elif call == "pretrain_mlm":
            mlm.pretrain_mlm(["w"], None, cfg, steps=1)
        elif call == "train_cross_encoder":
            cross_encoder.train_cross_encoder(cfg, [])
        elif call == "make_mesh":  # this rank's card
            parallel.make_mesh()
        elif call == "global_mesh":
            multihost.global_mesh()
        elif call == "ShardedIVF.build":  # every card
            sharded.ShardedIVF.build(np.zeros((64, 8), np.int8),
                                     ivf.IVFConfig(num_clusters=4))
        elif call == "run_parallel_dump":  # a worker a card
            (tmp_path / "data").mkdir()
            parallel_dump.run_parallel_dump(
                str(tmp_path / "data"), str(tmp_path / "dump"), "enc",
                dry_run=True)
        else:
            common.load_encoder(draft=True)


def test_mips_without_index_or_gpu_raises(monkeypatch):
    _no_gpu(monkeypatch)

    class Store:  # MIPS builds its flat index before it reads anything else
        vecs = np.zeros((8, 4), np.int8)
        offset, scale = 0.0, 1.0

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        search.MIPS(Store())


@pytest.mark.parametrize("driver", [generate_phrase_vecs, build_phrase_index,
                                    eval_phrase_retrieval, train_query,
                                    train_cross_encoder, train_mlm, run_demo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_without_a_gpu_raises(monkeypatch, driver):
    # the device is resolved before any flag or file is read
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        driver.main(["--dump_dir", "no_such_dump"])


@pytest.mark.parametrize("mode", ["q_serve", "serve_query", "p_serve",
                                  "single_serve", "serve", "serve_bert",
                                  "eval_request"])
def test_every_demo_mode_without_a_gpu_raises(monkeypatch, mode):
    # run_demo resolves the card before it loads or serves anything
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_demo.main(["--demo_mode", mode, "--load_dir", "no_such_dir",
                       "--test_path", "no_such_file"])


@pytest.mark.parametrize("make_app", [server.make_index_app,
                                     server.make_query_encoder_app,
                                     server.make_reader_app],
                         ids=lambda f: f.__name__)
def test_apps_serve_on_their_model_device(make_app):
    # an app places nothing: it serves on the device its model was loaded
    # onto, which run_demo.main resolves (default: the card)
    assert "device" not in inspect.signature(make_app).parameters
