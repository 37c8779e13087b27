"""The port's serve path as a whole, against the JAX reference: the same
docs and the same bridged weights through both ``dump_phrases``, both
``MIPS.search`` on one store over a flat index and over IVF indexes the
reference built, the brute-force span oracle, the four retrieval units, the
fused server, the public signatures, and the import and chip-script
contracts."""

import inspect
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from densephrases_tpu.data import features as jfeat
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.dump import dump_phrases as jax_dump
from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.model import DensePhrases as JaxDensePhrases
from densephrases_tpu.serve.fused import FusedServer as JaxFusedServer
from densephrases_tpu.models import encoder as jax_encoder
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.ops import kmeans as jax_kmeans
from densephrases_tpu.data import lazy as jax_lazy
from densephrases_tpu.eval import kilt as jax_kilt
from densephrases_tpu.eval import reader as jax_reader
from densephrases_tpu.models import hf_import as jax_hf
from densephrases_tpu.preprocess import datasets as jax_datasets
from densephrases_tpu.preprocess import doc_db as jax_doc_db
from densephrases_tpu.preprocess import wiki as jax_wiki
from densephrases_tpu.train import cross_encoder as jax_cross
from densephrases_tpu.train import mlm as jax_mlm
from densephrases_tpu.train import query as jax_query
from densephrases_tpu import parallel as jax_parallel
from densephrases_tpu.index import sharded as jax_sharded
from densephrases_tpu.parallel import multihost as jax_multihost
from densephrases_tpu.tools import parallel_dump as jax_pdump
from densephrases_tpu.train import rc as jax_rc
from densephrases_tpu.serve import server as jax_server
from densephrases_tpu.tools import analysis as jax_analysis
from densephrases_tpu.tools import benchmark as jax_benchmark
from densephrases_tpu.tools import kilt_tools as jax_kilt_tools
from densephrases_tpu.tools import question_generation as jax_qg
from densephrases_tpu_torch.data import features as tfeat
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.data.truecase import TrueCaser
from densephrases_tpu_torch.dump import dump_phrases
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.oracle import check_top1
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.models import encoder as port_encoder
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.from_jax import encoder_from_jax
from densephrases_tpu_torch.ops import kmeans as port_kmeans
from densephrases_tpu_torch.serve.fused import FusedServer
from densephrases_tpu_torch.data import lazy as port_lazy
from densephrases_tpu_torch.eval import kilt as port_kilt
from densephrases_tpu_torch.eval import reader as port_reader
from densephrases_tpu_torch.models import hf_import as port_hf
from densephrases_tpu_torch.preprocess import datasets as port_datasets
from densephrases_tpu_torch.preprocess import doc_db as port_doc_db
from densephrases_tpu_torch.preprocess import wiki as port_wiki
from densephrases_tpu_torch.train import cross_encoder as port_cross
from densephrases_tpu_torch.train import mlm as port_mlm
from densephrases_tpu_torch.train import query as port_query
from densephrases_tpu_torch import parallel as port_parallel
from densephrases_tpu_torch.index import sharded as port_sharded
from densephrases_tpu_torch.parallel import multihost as port_multihost
from densephrases_tpu_torch.tools import parallel_dump as port_pdump
from densephrases_tpu_torch.train import rc as port_rc
from densephrases_tpu_torch.serve import server as port_server
from densephrases_tpu_torch.tools import analysis as port_analysis
from densephrases_tpu_torch.tools import benchmark as port_benchmark
from densephrases_tpu_torch.tools import kilt_tools as port_kilt_tools
from densephrases_tpu_torch.tools import question_generation as port_qg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(200)] + ["paris", "river", "école"]


def _docs(n=7, seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        paras = [" ".join(rng.choice(WORDS, int(rng.integers(20, 90))))
                 + ". End, of para." for _ in range(int(rng.integers(1, 4)))]
        docs.append({"doc_id": 10 + i, "title": f"Title {i}",
                     "paragraphs": paras})
    return docs


@pytest.fixture(scope="module")
def vocab():
    # whole-word vocab built in plain Python (no `tokenizers` training)
    toks = SPECIAL_TOKENS + WORDS + ["end", "of", "para", "title", ".", ","] \
        + [str(i) for i in range(10)] + ["ecole"]
    return {t: i for i, t in enumerate(toks)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory, vocab):
    tmp = tmp_path_factory.mktemp("slice")
    docs = _docs()
    jcfg = JaxBertConfig.tiny(vocab_size=len(vocab))
    cfg = BertConfig.tiny(vocab_size=len(vocab))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = encoder_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    jstore = jax_dump(jparams, jcfg, JaxTokenizer(vocab), docs,
                      str(tmp / "jax"), max_seq_length=64, batch_size=4,
                      attn_impl="xla")
    stats = {}
    tok = WordPieceTokenizer(vocab)
    store = dump_phrases(params, cfg, tok, docs, str(tmp / "port"),
                         max_seq_length=64, batch_size=4, _stats=stats)
    model = DensePhrases(params, cfg, tok, MIPS(store, device="cpu"),
                         max_query_length=16, serve_dtype="bf16")
    return {"tmp": tmp, "jstore": jstore, "store": store, "stats": stats,
            "model": model, "cfg": cfg}


def test_host_copies_agree(vocab):
    jt, tt = JaxTokenizer(vocab), WordPieceTokenizer(vocab)
    paras = ["w1  w2\tParis, école. w3", "river w199 unknownword"]
    jf, jctx = jfeat.convert_context_to_features(5, "Title 1", paras, jt,
                                                 max_seq_length=10)
    tf, tctx = tfeat.convert_context_to_features(5, "Title 1", paras, tt,
                                                 max_seq_length=10)
    assert len(jf) == len(tf) > 1
    for a, b in zip(jf, tf):
        for f in ("input_ids", "attention_mask", "token_type_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.content_start, a.content_len, a.doc_token_offset) == \
            (b.content_start, b.content_len, b.doc_token_offset)
    assert jctx.context == tctx.context
    np.testing.assert_array_equal(jctx.tok2word, tctx.tok2word)
    qs = ["what is Paris?", "w3 école", ""]
    for a, b in zip(jfeat.convert_questions_to_features(qs, jt, 8),
                    tfeat.convert_questions_to_features(qs, tt, 8)):
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)


def test_dump_matches_reference(setup):
    js, ps = setup["jstore"], setup["store"]
    assert setup["stats"]["windows"] > len(_docs())  # docs span windows
    np.testing.assert_array_equal(ps.doc_bases, js.doc_bases)
    np.testing.assert_array_equal(ps.doc_ids, js.doc_ids)
    for i in range(js.num_docs):
        assert ps.metas[i] == js.metas[i]  # compressed records, byte for byte
    # bf16 towers in both: an element one bf16 ulp apart (at most 0.016
    # for |x| < 4) may round to the neighbouring int8 code, 0.05 wide,
    # never further; a third of such elements at most
    diff = np.abs(ps.vecs.astype(np.int16) - js.vecs.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.15


def _spans(results):
    """{(doc, start, end, candidate column): score} of one query's results."""
    return {(r["doc_idx"], r["start_idx"], r["end_idx"], r["cand_col"]):
            r["score"] for r in results}


def test_search_matches_reference_on_one_store(setup):
    path = str(setup["tmp"] / "jax")
    jm = JaxMIPS(JaxPhraseStore.load(path))
    pm = MIPS(PhraseStore.load(path), device="cpu")
    rng = np.random.default_rng(0)
    query = rng.standard_normal((4, 2 * setup["cfg"].hidden_size)) \
        .astype(np.float32)
    for top_k in (5, 20):
        ref = jm.search(query, top_k=top_k)
        out = pm.search(query, top_k=top_k)
        for r, o in zip(ref, out):
            rs, os_ = _spans(r), _spans(o)
            assert rs.keys() == os_.keys()
            # stage-1 scores share the bf16 query rounding; the fp32 sums
            # run in another order (scores are O(10))
            np.testing.assert_allclose([os_[k] for k in rs],
                                       list(rs.values()), atol=1e-3)
    agg_r = jm.search(query, top_k=5, aggregate=True, agg_strat="opt4")
    agg_o = pm.search(query, top_k=5, aggregate=True, agg_strat="opt4")
    assert [[(r["answer"], r["title"]) for r in rr] for rr in agg_r] == \
        [[(r["answer"], r["title"]) for r in rr] for rr in agg_o]


def test_brute_force_oracle(setup):
    mips = setup["model"].mips
    rng = np.random.default_rng(1)
    for _ in range(3):
        q = rng.standard_normal(2 * mips.store.dim).astype(np.float32)
        top = mips.search(q[None], top_k=50, return_idxs=True)[0][0]
        assert top["start_vec"].shape == (mips.store.dim,)
        assert check_top1(mips.store, q, top) in ("exact", "near-tie")


@pytest.mark.parametrize("unit", ["phrase", "sentence", "paragraph", "document"])
def test_search_all_units(setup, unit):
    model = setup["model"]
    answers, rets = model.search(["w3 w4 paris", "river"], retrieval_unit=unit,
                                 top_k=3, return_meta=True)
    assert len(answers) == 2
    for ans, ret in zip(answers, rets):
        assert 0 < len(ans) <= 3 and len(ret) == len(ans)
        scores = [r["score"] for r in ret]
        assert scores == sorted(scores, reverse=True)
        assert all(np.isfinite(scores))
    single = model.search("river", retrieval_unit=unit, top_k=2)
    assert isinstance(single, list) and isinstance(single[0], str)


def test_unknown_unit_raises(setup):
    with pytest.raises(NotImplementedError):
        setup["model"].search("river", retrieval_unit="word")


def test_evaluate(setup):
    metrics = setup["model"].evaluate([("w3 w4", ["w5"]), ("river", ["w7"])],
                                      top_k=3)
    assert metrics["n"] == 2 and len(metrics["predictions"]) == 2


def _ids(results):
    return [[(r["doc_idx"], r["start_idx"], r["end_idx"]) for r in rr]
            for rr in results]


def test_fused_matches_modular(setup):
    model = setup["model"]
    queries = ["w3 w4 paris", "river", "end of para w9"]
    fused = FusedServer(model)
    out_f = fused.search(queries, top_k=5, aggregate=True)
    _, out_m = model.search(queries, retrieval_unit="phrase", top_k=5,
                            return_meta=True)
    # the same ops on the same device in both paths: identical results
    assert _ids([r[:5] for r in out_f]) == _ids(out_m)
    for rr in out_f:
        for r in rr:
            assert r["answer"] == r["context"][r["start_pos"]:r["end_pos"]]


@pytest.mark.parametrize("chunk", [160, 300])
def test_fused_chunk_keeps_the_ids(setup, chunk):
    # the reference's FusedServer(model, chunk): each chunk's top-k is
    # exact, so any chunk gives the default chunk's ids; 300 does not
    # divide the padded flat buffer, so its last chunk is a short one
    model = setup["model"]
    index = model.mips.index
    assert index.codes.shape[0] % index.chunk == 0
    assert (chunk == 300) == (index.codes.shape[0] % chunk != 0)
    queries = ["w3 w4 paris", "river", "end of para w9", "w1 w2"]
    want = FusedServer(model).search(queries, top_k=5)
    fused = FusedServer(model, chunk)
    assert fused.chunk == chunk
    assert _ids(fused.search(queries, top_k=5)) == _ids(want)
    q = model.query2vec(queries)
    got = model.mips.search_dense(q, top_k=7, chunk=chunk)
    ref = model.mips.search_dense(q, top_k=7)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_port_exports_cover_the_reference():
    import densephrases_tpu
    import densephrases_tpu_torch

    assert set(densephrases_tpu.__all__) <= set(densephrases_tpu_torch.__all__)
    for name in densephrases_tpu.__all__:
        assert getattr(densephrases_tpu_torch, name) is not None
    from densephrases_tpu_torch import Options

    assert Options is densephrases_tpu_torch.options.Options


def test_pipelined_matches_sync(setup):
    fused = FusedServer(setup["model"])
    batches = [["w3 w4 paris", "river"], ["w1"], ["w9 w8", "end", "para w2"]]
    ref = [fused.search(b, top_k=4) for b in batches]
    out = fused.search_pipelined(batches, depth=2, top_k=4)
    assert [_ids(o) for o in out] == [_ids(r) for r in ref]


def test_import_leaves_jax_out():
    code = ("import sys, densephrases_tpu_torch, densephrases_tpu_torch.dump, "
            "densephrases_tpu_torch.serve.fused, "
            "densephrases_tpu_torch.models.from_jax, "
            "densephrases_tpu_torch.index.oracle, "
            "densephrases_tpu_torch.index.ivf, "
            "densephrases_tpu_torch.ops.ivf_pack, "
            "densephrases_tpu_torch.ops.kmeans, densephrases_tpu_torch.ops.pq, "
            "densephrases_tpu_torch.ops.opq, "
            "densephrases_tpu_torch.train.query, "
            "densephrases_tpu_torch.train.cross_encoder, "
            "densephrases_tpu_torch.train.mlm, "
            "densephrases_tpu_torch.eval.reader, "
            "densephrases_tpu_torch.eval.kilt, "
            "densephrases_tpu_torch.models.hf_import, "
            "densephrases_tpu_torch.cli.train_query, "
            "densephrases_tpu_torch.cli.train_cross_encoder, "
            "densephrases_tpu_torch.cli.train_mlm, "
            "densephrases_tpu_torch.cli.preprocess, "
            "densephrases_tpu_torch.preprocess.doc_db, "
            "densephrases_tpu_torch.preprocess.wiki, "
            "densephrases_tpu_torch.preprocess.datasets, "
            "densephrases_tpu_torch.preprocess.offline_corpus, "
            "densephrases_tpu_torch.tools.store_tools, "
            "densephrases_tpu_torch.data.lazy, "
            "densephrases_tpu_torch.parallel, "
            "densephrases_tpu_torch.parallel.multihost, "
            "densephrases_tpu_torch.index.sharded, "
            "densephrases_tpu_torch.tools.parallel_dump, "
            "densephrases_tpu_torch.serve.server, "
            "densephrases_tpu_torch.cli.run_demo, "
            "densephrases_tpu_torch.native, "
            "densephrases_tpu_torch.tools.benchmark, "
            "densephrases_tpu_torch.tools.analysis, "
            "densephrases_tpu_torch.tools.kilt_tools, "
            "densephrases_tpu_torch.tools.question_generation\n"
            "from densephrases_tpu_torch.preprocess.offline_corpus import "
            "package_roots\n"
            "package_roots()\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'densephrases_tpu' or m.startswith('densephrases_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_module_of_the_port_imports_jax():
    # not even inside a function: the card's machine has no jax
    pattern = re.compile(r"^\s*(import|from)\s+(jax|orbax|densephrases_tpu)"
                         r"(\.|\s|$)", re.M)
    root = os.path.join(REPO, "densephrases_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
               if f.endswith(".py")]
    assert len(sources) > 60
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, (path, hit and hit.group(0))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    cwd = REPO
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ------------------------------------------------------------- IVF serving
IVF_NLIST = 8


@pytest.fixture(scope="module")
def ivf_saves(setup):
    """SQ8 and OPQ8 indexes the reference built over the reference's store
    and saved; each package loads them."""
    store = JaxPhraseStore.load(str(setup["tmp"] / "jax"))
    out = {}
    for fq in ("SQ8", "OPQ8"):
        idx = JaxIVFIndex.build(store.vecs, JaxIVFConfig(
            num_clusters=IVF_NLIST, fine_quant=fq, kmeans_iters=4,
            pq_iters=3, opq_iters=2))
        idx.save(str(setup["tmp"] / f"ivf_{fq}"))
        out[fq] = str(setup["tmp"] / f"ivf_{fq}")
    return out


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("fq", ["SQ8", "OPQ8"])
def test_ivf_search_matches_reference_on_one_store(setup, ivf_saves, fq, b):
    path = str(setup["tmp"] / "jax")
    jm = JaxMIPS(JaxPhraseStore.load(path),
                 index=JaxIVFIndex.load(ivf_saves[fq]))
    pm = MIPS(PhraseStore.load(path),
              index=IVFIndex.load(ivf_saves[fq], device="cpu"))
    rng = np.random.default_rng(7 + b)
    query = rng.standard_normal((b, 2 * setup["cfg"].hidden_size)) \
        .astype(np.float32)
    for nprobe in (2, IVF_NLIST):
        ref = jm.search(query, nprobe=nprobe, top_k=8)
        out = pm.search(query, nprobe=nprobe, top_k=8)
        for r, o in zip(ref, out):
            rs, os_ = _spans(r), _spans(o)
            assert rs.keys() == os_.keys()
            np.testing.assert_allclose([os_[k] for k in rs],
                                       list(rs.values()), atol=1e-3)


@pytest.fixture(scope="module")
def ivf_model(setup):
    """The slice's model over a port-built full-probe SQ8 IVF index."""
    store, model = setup["store"], setup["model"]
    index = IVFIndex.build(store.vecs, IVFConfig(
        num_clusters=IVF_NLIST, fine_quant="SQ8", kmeans_iters=4),
        device="cpu")
    mips = MIPS(store, index=index)
    return DensePhrases(model.params, model.config, model.tokenizer, mips,
                        max_query_length=16)


@pytest.mark.parametrize("unit", ["phrase", "sentence", "paragraph", "document"])
def test_search_all_units_over_ivf(ivf_model, unit):
    answers, rets = ivf_model.search(["w3 w4 paris", "river"],
                                     retrieval_unit=unit, top_k=3,
                                     return_meta=True)
    assert len(answers) == 2
    for ans, ret in zip(answers, rets):
        assert 0 < len(ans) <= 3 and len(ret) == len(ans)
        scores = [r["score"] for r in ret]
        assert scores == sorted(scores, reverse=True)
        assert all(np.isfinite(scores))


def test_brute_force_oracle_over_full_probe_ivf(ivf_model):
    mips = ivf_model.mips
    assert mips.index.nlist <= 256  # the default nprobe probes every list
    rng = np.random.default_rng(11)
    for b in (1, 4):  # the per-probe route and the union route
        q = rng.standard_normal((b, 2 * mips.store.dim)).astype(np.float32)
        tops = mips.search(q, top_k=50, return_idxs=True)
        for qi, res in zip(q, tops):
            assert check_top1(mips.store, qi, res[0]) in ("exact", "near-tie")


def test_fused_server_refuses_ivf(ivf_model):
    with pytest.raises(AssertionError, match="FlatIndex"):
        FusedServer(ivf_model)


def test_pq_index_without_refine_is_refused(setup, ivf_saves):
    # a PQ index without a refine is refused a corpus copy on the device:
    # MIPS serves it in decode mode (tests/test_torch_serve_modes.py)
    index = IVFIndex.load(ivf_saves["OPQ8"], drop_refine=True,
                          device="cpu")
    mips = MIPS(setup["store"], index=index)
    assert mips.vecs_dev is None and mips.pq_serve is not None
    assert mips.pq_serve["codes"] is index.codes


# ------------------------------------------- public signatures (repairs)
def _params(fn):
    """The parameters a caller may pass by position (the port's own,
    ``device`` and ``stage_s``, are keyword-only)."""
    return [name for name, p in inspect.signature(fn).parameters.items()
            if name != "self" and p.kind in (p.POSITIONAL_ONLY,
                                             p.POSITIONAL_OR_KEYWORD)]


# the trainers, the reader, the checkpoint import and the host tools:
# (port module, reference module, public functions)
SLICE_8 = [
    (port_encoder, jax_encoder, ["query_loss"]),
    (port_query, jax_query, ["annotate_candidates", "annotate_candidate_cols",
                             "make_query_train_step", "train_query_encoder"]),
    (port_cross, jax_cross, ["cross_positions", "make_cross_train_step",
                             "train_cross_encoder"]),
    (port_reader, jax_reader, ["build_cq_inputs", "read_passages"]),
    (port_mlm, jax_mlm, ["make_mlm_optimizer", "make_mlm_step", "pack_chunks",
                         "pretrain_mlm"]),
    (port_hf, jax_hf, ["bert_params_from_state_dict",
                       "encoder_params_from_state_dict",
                       "load_encoder_from_torch"]),
    (port_kilt, jax_kilt, ["evaluate_kilt", "rprecision", "recall_at_k",
                           "results_to_kilt_predictions", "load_kilt_data"]),
    (port_doc_db, jax_doc_db, ["build_db"]),
    (port_wiki, jax_wiki, ["keep_article", "split_paragraphs",
                           "db_to_squad_docs", "concat_small_docs",
                           "create_openqa"]),
    (port_datasets, jax_datasets, ["nq_to_squad", "merge_openqa",
                                   "filter_noans", "filter_wiki",
                                   "tsv_to_corpus", "stat_entities"]),
    (port_lazy.LazyRCDataset, jax_lazy.LazyRCDataset, ["__init__"]),
    (port_lazy, jax_lazy, ["read_qa_jsonl"]),
]

# the scale-out path: meshes, multi-process shards, sharded IVF, the data-
# parallel step, the parallel dump
SLICE_9 = [
    (port_parallel, jax_parallel, ["make_mesh", "shard_put",
                                   "replicate_put"]),
    (port_multihost, jax_multihost, ["init_multihost", "global_mesh",
                                     "shard_layout", "process_row_range",
                                     "flat_from_process_shards",
                                     "broadcast_queries"]),
    (port_sharded.ShardedIVF, jax_sharded.ShardedIVF,
     ["__init__", "build", "search"]),
    (port_sharded.MeshShardedIVF, jax_sharded.MeshShardedIVF,
     ["build", "search", "_shared_int4_ranges"]),
    (port_rc, jax_rc, ["make_train_step", "shard_batch"]),
    (port_pdump, jax_pdump, ["make_ranges", "bin_by_size",
                             "run_parallel_dump", "merge_shards"]),
]

# the demo servers, the serve driver's client and the remaining host tools
SLICE_10 = [
    (port_server, jax_server, ["make_query_encoder_app", "make_index_app",
                               "make_reader_app", "serve", "eval_request"]),
    (port_server.RemoteQueryEncoder, jax_server.RemoteQueryEncoder,
     ["__init__", "query2vec"]),
    (port_analysis, jax_analysis, ["analyze_predictions",
                                   "compare_predictions"]),
    (port_benchmark, jax_benchmark, ["benchmark_store_read",
                                     "create_benchmark_data"]),
    (port_kilt_tools, jax_kilt_tools, ["build_title2wikiid",
                                       "strip_predictions", "sample_jsonl"]),
    (port_qg, jax_qg, ["cloze_qg", "cloze_qg_extended", "hf_seq2seq_qg",
                       "generate_squad", "filter_qg"]),
    (FusedServer, JaxFusedServer, ["__init__", "submit", "search"]),
]


@pytest.mark.parametrize("port_fn,ref_fn", [
    (MIPS.search, JaxMIPS.search),
    (MIPS.search_dense, JaxMIPS.search_dense),
    (FlatIndex.search, JaxFlatIndex.search),
    (IVFIndex.search, JaxIVFIndex.search),
    (IVFIndex.search_union, JaxIVFIndex.search_union),
    (DensePhrases.search, JaxDensePhrases.search),
    (DensePhrases.__init__, JaxDensePhrases.__init__),
    (MIPS.__init__, JaxMIPS.__init__),
    (MIPS.search_phrase, JaxMIPS.search_phrase),
    (FlatIndex.__init__, JaxFlatIndex.__init__),
    (IVFIndex.__init__, JaxIVFIndex.__init__),
    (IVFIndex.build, JaxIVFIndex.build),
    (IVFIndex.build_coarse, JaxIVFIndex.build_coarse),
    (IVFIndex.load, JaxIVFIndex.load),
    (port_kmeans.kmeans, jax_kmeans.kmeans),
    *[(getattr(port, name), getattr(ref, name))
      for port, ref, names in SLICE_8 + SLICE_9 + SLICE_10
      for name in names],
], ids=["MIPS.search", "MIPS.search_dense", "FlatIndex.search",
        "IVFIndex.search", "IVFIndex.search_union", "DensePhrases.search",
        "DensePhrases.__init__", "MIPS.__init__", "MIPS.search_phrase",
        "FlatIndex.__init__", "IVFIndex.__init__", "IVFIndex.build",
        "IVFIndex.build_coarse", "IVFIndex.load", "kmeans",
        *[f"{port.__name__.rsplit('.', 1)[-1]}.{name}"
          for port, ref, names in SLICE_8 + SLICE_9 + SLICE_10
          for name in names]])
def test_signatures_follow_reference(port_fn, ref_fn):
    # positional arguments mean the same in both packages: the port's
    # positional parameters are the reference's, in order (the port may
    # stop early); the port's own parameters come after them, keyword-only
    port, ref = _params(port_fn), _params(ref_fn)
    assert port == ref[:len(port)], (port, ref)


# The deliberate exceptions to the rule above. Each takes what the
# reference's first arguments cannot mean in the port, so a call in the
# reference's order fails instead of being misread: the init functions put
# ``config`` first and take a torch.Generator where the reference takes a
# JAX key first; the embed functions take no ``config`` (the towers carry
# it); ``encoder_params_from_backbone`` draws the filter head from a
# generator where the reference takes a seed for ``PRNGKey``, and
# ``mlm_loss`` takes the corruption draws as tensors where the reference
# takes the key it draws them from.
DELIBERATE = {
    "init_mlm_params": (port_mlm.init_mlm_params, jax_mlm.init_mlm_params),
    "encoder_params_from_backbone": (port_mlm.encoder_params_from_backbone,
                                     jax_mlm.encoder_params_from_backbone),
    "mlm_loss": (port_mlm.mlm_loss, jax_mlm.mlm_loss),
    "init_encoder_params": (port_encoder.init_encoder_params,
                            jax_encoder.init_encoder_params),
    "init_cross_params": (port_cross.init_cross_params,
                          jax_cross.init_cross_params),
    "embed_query": (port_encoder.embed_query, jax_encoder.embed_query),
    "embed_phrase": (port_encoder.embed_phrase, jax_encoder.embed_phrase),
    # one process a rank: each rank passes its own shard, not all of them
    "MeshShardedIVF.__init__": (port_sharded.MeshShardedIVF.__init__,
                                jax_sharded.MeshShardedIVF.__init__),
    # the exported Encoder draws fresh towers from a torch.Generator where
    # the reference takes a JAX key
    "PhraseEncoder.__init__": (port_encoder.PhraseEncoder.__init__,
                               jax_encoder.PhraseEncoder.__init__),
}


@pytest.mark.parametrize("name", sorted(DELIBERATE))
def test_deliberate_signature_exceptions(name):
    port_fn, ref_fn = DELIBERATE[name]
    port, ref = _params(port_fn), _params(ref_fn)
    if name.startswith("init_"):
        assert ref[:2] == ["rng", "config"]
        assert port[:2] == ["config", "generator"]
    elif name == "encoder_params_from_backbone":
        assert ref == ["backbone", "config", "seed"]
        assert port == ["backbone", "config", "generator"]
    elif name == "mlm_loss":
        assert ref[:4] == port[:4] and ref[4:] == ["rng"]
        assert port[4:] == ["draws"]
    elif name == "PhraseEncoder.__init__":
        assert ref == ["config", "params", "rng", "with_teacher"]
        assert port == ["config", "params", "generator", "with_teacher"]
    elif name == "MeshShardedIVF.__init__":
        assert ref[0] == "sub_indexes" and port[0] == "sub_index"
        assert port[1:] == ref[1:]
    else:
        assert ref[:2] == ["params", "config"] and "config" not in port
        assert port[:2] == ["params", "input_ids"]


def test_positional_nprobe_and_top_k(setup):
    mips = setup["model"].mips
    q = np.random.default_rng(3).standard_normal(
        (2, 2 * setup["cfg"].hidden_size)).astype(np.float32)
    by_pos = mips.search(q, None, 4, 3)  # nprobe=4, top_k=3
    by_kw = mips.search(q, top_k=3)
    assert [_spans(r) for r in by_pos] == [_spans(r) for r in by_kw]
    assert all(len(r) <= 2 * 3 for r in by_pos)
    index = mips.index
    for a, b in zip(index.search(q[:, :64], 5, 7),
                    index.search(q[:, :64], top_k=5)):
        np.testing.assert_array_equal(a, b)


def test_truecase_keeps_its_place(setup):
    model = setup["model"]
    caser = TrueCaser()
    caser.train(["the River Paris flows .", "a River and Paris ."])
    # positional: params, config, tokenizer, mips, max_query_length, truecase
    cased = DensePhrases(model.params, model.config, model.tokenizer,
                         model.mips, 16, caser)
    assert cased.truecase is caser
    seen = []
    cased.query2vec = lambda qs: (seen.extend(qs), model.query2vec(qs))[1]
    # positional: query, retrieval_unit, top_k, truecase, return_meta
    answers, rets = cased.search("river paris", "phrase", 2, True, True)
    assert 0 < len(answers) <= 2 and len(rets) == len(answers)
    cased.search("river paris", "phrase", 2, False)
    assert seen == ["River Paris", "river paris"]
