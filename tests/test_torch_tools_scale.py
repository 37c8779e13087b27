"""The port's at-scale measurement tools against the JAX package's, on the
CPU at a small size: ``bench_ivf_scale`` (the corpus, its ground truth,
the grid over a shared coarse cache), ``bench_cpu_ivf`` (the numpy IVF-PQ
baseline on a save the JAX ``IVFIndex`` wrote), ``bench_ivf_e2e`` (the
synthetic store and the three serve modes) and ``bench_tiered30m`` (the
streamed corpus, its ground truth, the host-save build and ``TieredIVF``).

Both packages read the same seeded numpy memmap through the tools' cache
path (the corpus generators draw different bits: ``jax.random`` against a
``torch.Generator``). Also: no new module imports jax or the JAX package,
and no tool writes into the repository by default."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.tools import bench_cpu_ivf as jax_cpu_ivf
from densephrases_tpu.tools import bench_ivf_e2e as jax_e2e
from densephrases_tpu_torch.index.store import DocMeta
from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.tools import bench_cpu_ivf, bench_ivf_e2e
from densephrases_tpu_torch.tools import bench_ivf_scale, bench_tiered30m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NLIST = 4096, 32, 16
# recall of two packages' searches over one saved index: the ids agree
# (test_torch_ivf.py), so the recalls agree up to a tie's swap
RECALL_ATOL = 0.02

NEW_MODULES = [
    "densephrases_tpu_torch.tools._bench",
    "densephrases_tpu_torch.tools.bench_ivf_scale",
    "densephrases_tpu_torch.tools.bench_cpu_ivf",
    "densephrases_tpu_torch.tools.bench_ivf_e2e",
    "densephrases_tpu_torch.tools.bench_tiered30m",
    "densephrases_tpu_torch.tools.dsmall",
    "densephrases_tpu_torch.tools.bench_serve_real",
    "densephrases_tpu_torch.tools.bench_ivf_real",
    "densephrases_tpu_torch.examples",
    "densephrases_tpu_torch.examples._common",
    "densephrases_tpu_torch.examples.create_custom_index",
    "densephrases_tpu_torch.examples.entity_linking",
    "densephrases_tpu_torch.examples.fid_reader",
    "densephrases_tpu_torch.examples.knowledge_dialogue",
    "densephrases_tpu_torch.examples.slot_filling",
]


def _seeded_corpus(path, n=N, d=D, n_clusters=24, seed=0):
    """A seeded clustered int8 corpus written as the tools' cache (with
    its ``.done`` marker)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(-2.0, 1.0, (n_clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.normal(
        size=(n, d)).astype(np.float32)
    codes = np.clip(np.round((x + 2.0) * 20.0), -128, 127).astype(np.int8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int8,
                                   shape=codes.shape)
    mm[:] = codes
    del mm
    with open(path + ".done", "w") as f:
        f.write(f"{n} {d}\n")
    return codes


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    """One seeded cache, the JAX package's SQ8 save under the tool's name,
    and the port's grid over it (SQ8 loaded, SQ4 and OPQ8 built from the
    shared coarse cache)."""
    work = str(tmp_path_factory.mktemp("scale"))
    cache = bench_ivf_scale.corpus_path(work, N, D)
    codes = _seeded_corpus(cache)
    jcfg = JaxIVFConfig(num_clusters=NLIST, fine_quant="SQ8", kmeans_iters=6,
                        sample_ratio=1.0, balance_factor=4.0,
                        refine_factor=4)
    jivf = JaxIVFIndex.build(codes, jcfg)
    path = bench_ivf_scale.index_dir(work, "SQ8", N, D, NLIST)
    jivf.save(path)
    open(os.path.join(path, "save.done"), "w").write("ok\n")
    out = os.path.join(work, "IVF_SCALE.json")
    res = bench_ivf_scale.main(
        ["--n", str(N), "--d", str(D), "--nlist", str(NLIST), "--quants",
         "SQ8,SQ4,OPQ8", "--probes", f"4,{NLIST}", "--n_rep", "1",
         "--kernel_rows", "--workdir", work, "--out", out], device="cpu")
    return {"work": work, "cache": cache, "codes": codes, "jivf": jivf,
            "res": res, "out": out}


COARSE_N, COARSE_D = 16384, 16
COARSE_NLIST = 8192  # IVFConfig.two_level_clusters: the two-level path


def test_coarse_study_row_equals_the_reference(tmp_path):
    # --coarse_only through main on a seeded cache; the JAX side's row from
    # its IVFIndex.build_coarse with the reference tool's config and
    # formulas (densephrases_tpu/tools/bench_ivf_scale.py:321-352)
    work, out = str(tmp_path / "work"), str(tmp_path / "coarse.json")
    codes = _seeded_corpus(
        bench_ivf_scale.corpus_path(work, COARSE_N, COARSE_D), n=COARSE_N,
        d=COARSE_D, n_clusters=64)
    argv = ["--coarse_only", "--n", str(COARSE_N), "--d", str(COARSE_D),
            "--nlist", str(COARSE_NLIST), "--reps", "2", "--workdir", work,
            "--out", out]
    res = bench_ivf_scale.main(argv, device="cpu")
    row = res["coarse"]
    cfg = JaxIVFConfig(num_clusters=COARSE_NLIST, fine_quant="SQ8",
                       kmeans_iters=6, sample_ratio=min(1.0, 1e6 / COARSE_N),
                       balance_factor=4.0)
    assert COARSE_NLIST >= cfg.two_level_clusters
    centroids, assign, _ = JaxIVFIndex.build_coarse(codes, cfg)
    centroids, assign = np.asarray(centroids), np.asarray(assign)
    lens = np.bincount(assign, minlength=centroids.shape[0])
    mean = float(lens.mean())
    k_req = min(COARSE_NLIST, centroids.shape[0])
    want = {
        "nlist_requested": COARSE_NLIST,
        "nlist_actual": int(centroids.shape[0]),
        "list_mean": round(mean, 2),
        "list_max": int(lens.max()),
        "list_p99": int(np.percentile(lens, 99)),
        "empty_lists": int((lens == 0).sum()),
        "empty_in_first_nlist": int((lens[:k_req] == 0).sum()),
        "empty_in_grown_tail": int((lens[k_req:] == 0).sum()),
        "poisson_null_empty": int(np.exp(-mean) * centroids.shape[0]),
        "centroid_bytes": int(centroids.size * 2),
    }
    assert {k: row[k] for k in want} == want
    assert want["nlist_actual"] > COARSE_NLIST  # the balancer grew lists
    assert set(row["stage_s"]) == {"sample_s", "kmeans_s", "assign_s",
                                   "balance_s"}
    probes = [f"probe_b{b}_p{p}_ms" for b in (1, 64) for p in (16, 64)]
    assert set(row) == set(want) | {"stage_s", "total_s"} | set(probes)
    assert all(row[k] > 0 for k in probes)
    assert "flat_b64_ms" not in res  # the flat phase is skipped
    with open(out) as f:
        assert json.load(f)["coarse"] == row
    # a second run reads the finished coarse cache and its stage clocks
    again = bench_ivf_scale.main(argv + ["--fresh"], device="cpu")["coarse"]
    assert {k: again[k] for k in want} == want
    assert again["stage_s"] == row["stage_s"]


def test_gen_corpus_device_and_cache(tmp_path):
    # the reference's distribution contract (test_tools.py), on the port's
    # torch.Generator corpus, and the memmap cache round trip
    codes = bench_ivf_scale.gen_corpus_device(2048, 32, n_clusters=8, seed=3,
                                              block=512, device="cpu")
    assert codes.shape == (2048, 32) and codes.dtype == torch.int8
    codes = codes.numpy()
    floats = codes.astype(np.float32) / 20.0 - 2.0
    assert -3.5 < floats.mean() < -0.5
    d2 = ((floats[:64, None, :] - floats[None, :256, :]) ** 2).sum(-1)
    np.fill_diagonal(d2[:, :64], np.inf)
    assert np.median(d2.min(1)) < 0.25 * np.median(np.median(d2, 1))
    np.testing.assert_array_equal(
        codes, bench_ivf_scale.gen_corpus_device(
            2048, 32, n_clusters=8, seed=3, block=512, device="cpu").numpy())
    path = str(tmp_path / "corpus.npy")
    bench_ivf_scale.cache_corpus(torch.as_tensor(codes), path, block=512)
    assert os.path.exists(path + ".done")
    assert not os.path.exists(path + ".progress")
    np.testing.assert_array_equal(np.load(path, mmap_mode="r"), codes)


def test_queries_follow_the_reference_chain(scale):
    # the reference draws its queries inline in main(); the same chain
    rng = np.random.default_rng(1)
    qids = np.sort(rng.integers(0, N, 65))
    want = scale["codes"][qids].astype(np.float32) / 20.0 - 2.0
    want += 0.05 * rng.normal(size=want.shape).astype(np.float32)
    np.testing.assert_array_equal(
        bench_ivf_scale.corpus_queries(scale["codes"]), want)


def test_ground_truth_equals_the_reference_flat_top20(scale):
    qrows = bench_ivf_scale.corpus_queries(scale["codes"])
    gt = np.load(scale["cache"] + ".gt20.npz")
    jflat = JaxFlatIndex(scale["codes"], chunk=65536)
    for q, got in ((qrows[:1], gt["ei1"]), (qrows[1:], gt["ei64"])):
        _, want = jflat.search(q, top_k=20)
        np.testing.assert_array_equal(got, want)
    # the host path (a cached corpus without its sidecar): fp32 queries,
    # where the flat scan rounds them to bf16, so a near-tie may swap;
    # stated bar: 97% of the ids
    host = bench_ivf_scale.exact_gt_host(scale["codes"], qrows[1:], block=1000)
    assert _bench.recall(host, gt["ei64"]) >= 0.97


def test_grid_over_a_shared_coarse_cache(scale):
    res, work = scale["res"], scale["work"]
    q = bench_ivf_scale.corpus_queries(scale["codes"])
    gt = np.load(scale["cache"] + ".gt20.npz")
    # the JAX save read through the cache path: the same recall as the
    # JAX package's own search of it
    for p in (4, NLIST):
        _, ids = scale["jivf"].search(q[1:], top_k=20, nprobe=p)
        assert abs(res["ivf_SQ8"][f"p{p}"]["recall20_b64"]
                   - _bench.recall(ids, gt["ei64"])) <= RECALL_ATOL
    assert "build_s" not in res["ivf_SQ8"]
    for quant in ("SQ4", "OPQ8"):
        assert res[f"ivf_{quant}"]["build_s"] > 0
        assert os.path.exists(os.path.join(bench_ivf_scale.index_dir(
            work, quant, N, D, NLIST), "save.done"))
    assert os.path.isdir(bench_ivf_scale.coarse_dir(work, N, D, NLIST))
    for quant in ("SQ8", "SQ4", "OPQ8"):
        row = res[f"ivf_{quant}"]
        assert row["device_bytes"] > 0 and row["code_bytes"] > 0
        for p in (4, NLIST):
            ent = row[f"p{p}"]
            assert 0.0 <= ent["recall20_b64"] <= 1.0
            assert ent["b1_ms"] > 0 and ent["b64_ms"] > 0
            k = row["kernel"][f"p{p}"]
            assert k["kernel"] == ("pq_pack_score" if quant == "OPQ8"
                                   else "ivf_pack_score")
            # on the CPU the wrappers run their plain twins: no launch
            assert k["launches"] == 0 and k["rows"] > 0
            assert k["ms"] > 0 and k["plain_ms"] > 0
            assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes",
                                                           "operations")
    # SQ8 at full probe scans every list: the flat top-20
    assert res["ivf_SQ8"][f"p{NLIST}"]["recall20_b64"] >= 0.95
    assert res["flat_bytes"] == N * D and res["flat_b64_ms"] > 0


def _opq_save(tmp, codes, fq):
    jivf = JaxIVFIndex.build(codes, JaxIVFConfig(
        num_clusters=NLIST, fine_quant=fq, kmeans_iters=4, pq_iters=3,
        opq_iters=2, refine_factor=4))
    path = str(tmp / fq)
    jivf.save(path)
    return path


@pytest.mark.parametrize("fq", ["OPQ8", "OPQ16x4"])
def test_cpu_ivfpq_search_equals_the_reference_tool(scale, tmp_path, fq):
    # exact: the same numpy algorithm over the same save
    path = _opq_save(tmp_path, scale["codes"], fq)
    q = bench_ivf_scale.corpus_queries(scale["codes"])[1:17]
    got = bench_cpu_ivf.cpu_ivfpq_search(bench_cpu_ivf.load_index_host(path),
                                         q, nprobe=4, refine_factor=4)
    want = jax_cpu_ivf.cpu_ivfpq_search(jax_cpu_ivf.load_index_host(path), q,
                                        nprobe=4, refine_factor=4)
    np.testing.assert_array_equal(got, want)


def test_cpu_baseline_main_reads_the_grid(scale):
    out = os.path.join(scale["work"], "BENCH_IVF.json")
    res = bench_cpu_ivf.main(["--n", str(N), "--d", str(D), "--nlist",
                              str(NLIST), "--quant", "OPQ8", "--nprobe", "4",
                              "--refine_factor", "4", "--windows", "1",
                              "--workdir", scale["work"], "--out", out])
    assert 0.0 <= res["recall20_b64"] <= 1.0 and res["qps"] > 0
    blob = _bench.merge_rows(out, "x", {})
    assert "cpu_baseline_OPQ8_rf4_p4" in blob["rows"]


def test_synth_store_equals_the_reference(tmp_path):
    corpus = _seeded_corpus(str(tmp_path / "c.npy"), n=512, d=16)
    got = bench_ivf_e2e.synth_store(corpus, vecs_per_doc=128)
    want = jax_e2e.synth_store(corpus, vecs_per_doc=128)
    np.testing.assert_array_equal(got.doc_bases, want.doc_bases)
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    assert (got.offset, got.scale) == (want.offset, want.scale)
    assert got.vecs is corpus and got.num_docs == want.num_docs == 4
    for i in range(4):
        a, b = got.meta(i), want.meta(i)
        assert (a.doc_id, a.title, a.context) == (b.doc_id, b.title,
                                                  b.context)
        for f in ("word2char_start", "word2char_end", "f2o_start"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert isinstance(got.meta(0), DocMeta)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The grid's caches at BERT-base width (768) for the whole serve."""
    work = str(tmp_path_factory.mktemp("e2e"))
    n, d = 2048, 768
    codes = _seeded_corpus(bench_ivf_scale.corpus_path(work, n, d), n=n, d=d)
    ivf, _ = bench_ivf_scale.build_or_load(codes, "OPQ96", 8, work,
                                           device="cpu", pq_iters=2,
                                           opq_iters=1, kmeans_iters=3)
    return {"work": work, "n": n, "d": d}


@pytest.mark.parametrize("mode", ["refine", "decode", "host_refine"])
def test_e2e_serve_modes(e2e, mode):
    out = os.path.join(e2e["work"], "BENCH_IVF.json")
    res = bench_ivf_e2e.main(
        ["--n", str(e2e["n"]), "--d", str(e2e["d"]), "--nlist", "8",
         "--serve_mode", mode, "--nprobe", "4", "--batch", "4",
         "--workdir", e2e["work"], "--out", out], device="cpu")
    assert res["distinct_qvecs"] == 4 and res["served_equals_mips_search"]
    assert 0.0 <= res["stage1_recall20_indist"] <= 1.0
    assert res["qps"] > 0 and set(res["stages_ms"]) == {
        "encode_b", "ivf_search_b", "rescore_assemble_b"}
    assert res["shared_refine_rescore"] == (mode == "refine")
    assert res["pq_decode_rescore"] == (mode != "refine")
    assert res["device_resident_bytes"] > 0
    assert "OPQ96_p4_" + mode in _bench.merge_rows(out, "x", {})["rows"]


def test_e2e_ground_truth_frees_the_flat_scan(e2e, tmp_path):
    corpus = np.load(bench_ivf_scale.corpus_path(e2e["work"], e2e["n"],
                                                 e2e["d"]), mmap_mode="r")
    rng = np.random.default_rng(0)
    qvec = rng.normal(size=(4, 2 * e2e["d"])).astype(np.float32)
    indist = bench_ivf_e2e.indist_queries(corpus, 8)
    gt = bench_ivf_e2e.ground_truth(str(tmp_path / "gt.npz"), corpus, qvec,
                                    indist, device="cpu")
    assert gt["allocated_after"] <= gt["allocated_before"]
    _, want = JaxFlatIndex(np.asarray(corpus), chunk=65536).search(
        indist, top_k=20)
    np.testing.assert_array_equal(gt["gt_ind"], want)
    assert gt["gt_ids"].shape == (8, 20)
    assert bench_ivf_e2e.ground_truth(str(tmp_path / "gt.npz"), corpus,
                                      qvec, indist, device="cpu")["cached"]


def test_tiered_stream_and_ground_truth(tmp_path):
    n, d, chunk = 4096, 32, 1024
    path = str(tmp_path / "tc.npy")
    qids = np.sort(np.random.default_rng(1).integers(0, n, 16))
    qraw = bench_tiered30m.gen_corpus_device_stream(
        path, n, d, qids, n_clusters=16, chunk=chunk, device="cpu")
    corpus = np.load(path, mmap_mode="r")
    assert os.path.exists(path + ".done")
    np.testing.assert_array_equal(qraw, corpus[qids])
    floats = np.asarray(corpus, np.float32) / 20.0 - 2.0
    assert -3.5 < floats.mean() < -0.5
    # a rerun reads the finished memmap
    np.testing.assert_array_equal(bench_tiered30m.gen_corpus_device_stream(
        path, n, d, qids, n_clusters=16, chunk=chunk, device="cpu"), qraw)
    q = qraw.astype(np.float32) / 20.0 - 2.0
    got = bench_tiered30m.exact_gt_device(path, q, str(tmp_path / "gt.npz"),
                                          chunk=chunk, device="cpu")
    _, want = JaxFlatIndex(np.asarray(corpus), chunk=65536).search(q, top_k=20)
    # the same set of 20 ids (the merge leaves them unordered)
    assert [set(a) for a in got.tolist()] == [set(b) for b in want.tolist()]


def test_tiered_main_beside_the_in_memory_index(tmp_path):
    out = str(tmp_path / "BENCH_IVF.json")
    res = bench_tiered30m.main(
        ["--n", "4096", "--d", "32", "--nlist", "16", "--probes", "4,16",
         "--batch", "8", "--chunk", "1024", "--block_rows", "512",
         "--compare_hbm", "--workdir", str(tmp_path), "--out", out],
        device="cpu")
    for p in ("p4", "p16"):
        assert 0.0 <= res[p]["recall20_b64"] <= 1.0 and res[p]["qps"] > 0
        # the same save served two ways: the same union of probed lists
        assert abs(res[p]["recall20_b64"]
                   - res["hbm"][p]["recall20_b64"]) <= 0.05
    assert res["p16"]["recall20_b64"] >= 0.95  # every list probed
    assert res["device_resident_bytes"] > 0 and res["build_s"] > 0


def test_size_n_checks_the_disk(tmp_path, monkeypatch):
    got = bench_tiered30m.size_n(32, 1024, str(tmp_path), device="cpu")
    assert got["n"] == 1024 and not got["beyond_card"]
    free = int(bench_tiered30m.DISK_FACTOR * 32 * 1024 * 3.5)
    monkeypatch.setattr(bench_tiered30m.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": free})())
    monkeypatch.setattr(bench_tiered30m.torch.cuda, "mem_get_info",
                        lambda dev: (0, 32 * 1024 * 10))
    monkeypatch.setattr(bench_tiered30m, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    got = bench_tiered30m.size_n(32, 1024, str(tmp_path), device="cuda")
    assert got["n"] == 3 * 1024 and not got["beyond_card"]
    assert "disk" in got["reason"]
    monkeypatch.setattr(bench_tiered30m.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": 10 ** 12})())
    got = bench_tiered30m.size_n(32, 1024, str(tmp_path), device="cuda")
    assert got["n"] == 11 * 1024 and got["beyond_card"]


def test_no_default_writes_into_the_repository():
    from densephrases_tpu_torch.examples import _common
    from densephrases_tpu_torch.tools import (
        bench_ivf_real, bench_serve_real, dsmall)

    paths = []
    for mod, argv in ((bench_ivf_scale, []), (bench_ivf_e2e, []),
                      (bench_cpu_ivf, []),
                      (bench_tiered30m, []),
                      (dsmall, []),
                      (bench_serve_real, ["--store", "/s/x",
                                          "--encoder", "e"]),
                      (bench_ivf_real, ["--store", "/s/x",
                                        "--encoder", "e"])):
        args = mod.parse_args(argv)
        paths += [args.out] + [p for p in (getattr(args, "workdir", None),)
                               if p]
    paths.append(_bench.default_workdir())
    paths += [_common.default_workdir(x) for x in ("custom_index", "dph")]
    for p in paths:
        rel = os.path.relpath(os.path.abspath(p), REPO)
        assert rel.startswith(".."), p
        assert not os.path.abspath(p).startswith(
            os.path.join(REPO, "docs")), p


def test_new_modules_leave_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'densephrases_tpu' or "
              "m.startswith('densephrases_tpu.')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
