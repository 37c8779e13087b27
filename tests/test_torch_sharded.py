"""The port's sharded IVF (``densephrases_tpu_torch/index/sharded.py``) and
the ``nlist_valid`` probe mask of its list scans (``ops/ivf_pack.py``)
against the JAX package on the same seeded inputs.

``MeshShardedIVF`` runs as 4 gloo ranks, each a subprocess that runs this
file as a script (the rank code sits above the JAX imports, so a rank
imports torch and the port only, and asserts that); the reference's
sharded indexes run in the test process on the forced CPU devices of
``tests/conftest.py``. Every rank searches the shard the reference built
and saved for it.

Tolerances: the port's scans and the reference's packed scans score the
same exact bf16 x int8 products (or bf16 LUT entries) in fp32, summed in
another order: ids equal, scores within 1e-4 relative. Against the
reference's ``MeshShardedIVF``, whose few-query SQ8 search scores each
query's own lists where the port scores the batch's union, the bar is the
reference's own (tests/test_ivf.py): overlap >= 0.9, sorted scores within
0.5.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

N, D, SHARDS, NLIST = 4096, 64, 4, 64
VARIANTS = ("SQ8", "OPQ8", "SQ4")
BATCHES = (2, 8)


# ------------------------------------------------------------ rank side
def _rank_search(rank, world, inp):
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.sharded import MeshShardedIVF
    from densephrases_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis="shard", devices=["cpu"] * world)
    bases = [i * (N // world) for i in range(world)]
    out = {}
    for fq in VARIANTS:
        sub = IVFIndex.load(os.path.join(inp["saves"], fq, str(rank)),
                            device="cpu")
        msh = MeshShardedIVF(sub, bases, mesh)
        out[f"{fq}_nlist"] = (msh.nlist_valid, int(msh.centroids.shape[0]),
                              msh.nlist_valid_min, msh.n_total)
        for b in BATCHES:
            out[f"{fq}_{b}"] = msh.search(inp["queries"][:b].numpy(),
                                          top_k=10, nprobe=16)
    return out


def _rank_build(rank, world, inp):
    import dataclasses

    from densephrases_tpu_torch.index.ivf import IVFConfig
    from densephrases_tpu_torch.index.sharded import MeshShardedIVF
    from densephrases_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis="shard", devices=["cpu"] * world)
    out = {}
    for fq in ("SQ8", "SQ4"):
        msh = MeshShardedIVF.build(inp["codes"].numpy(), IVFConfig(
            num_clusters=NLIST, fine_quant=fq, kmeans_iters=5,
            prefer_union_batch=4), mesh)
        out[f"{fq}_cfg"] = dataclasses.asdict(msh.cfg)
        out[f"{fq}_search"] = msh.search(inp["queries"].numpy(), top_k=10,
                                         nprobe=16)
    return out


RANK_CASES = {"search": _rank_search, "build": _rank_build}


def _rank_main():
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from densephrases_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    init_multihost(f"file://{tmp}/pg", world, rank, backend="gloo")
    try:
        inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = {case: RANK_CASES[case](rank, world, inp[case])
               for case in inp}
        out["jax_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] in
            ("jax", "densephrases_tpu"))
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())


# ------------------------------------------------------------ test side
import dataclasses  # noqa: E402
from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig  # noqa: E402
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex  # noqa: E402
from densephrases_tpu.index.sharded import MeshShardedIVF as JaxMeshIVF  # noqa: E402,E501
from densephrases_tpu.index.sharded import ShardedIVF as JaxShardedIVF  # noqa: E402,E501
from densephrases_tpu.ops import ivf_pack as jax_pack  # noqa: E402
from densephrases_tpu.ops.quant import float_to_int8  # noqa: E402
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex  # noqa: E402
from densephrases_tpu_torch.index.sharded import ShardedIVF  # noqa: E402
from densephrases_tpu_torch.ops import ivf_pack  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240  # seconds for one spawn of every rank


def spawn_ranks(world, tmp, inputs, timeout=RANK_TIMEOUT):
    """Run this file as ``world`` gloo ranks over ``inputs`` (a dict of
    case → input) and return each rank's outputs."""
    torch.save(inputs, os.path.join(tmp, "in.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(tmp)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _clustered(n, d, seed, n_clusters=32):
    """tests/test_ivf.py::_clustered_data's distribution."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(-2, 1.0, (n_clusters, d)).astype(np.float32)
    idx = rng.integers(0, n_clusters, n)
    return (centers[idx] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _cfg(cls, fq, **kw):
    """tests/test_ivf.py::test_mesh_sharded_ivf_collective's config."""
    return cls(num_clusters=NLIST, fine_quant=fq, kmeans_iters=5, pq_iters=3,
               opq_iters=2, prefer_union_batch=4, **kw)


def _jax_subs(codes, fq):
    """The shards the reference's ``MeshShardedIVF.build`` makes
    (tests/test_ivf.py::_rebuild_subs)."""
    cfg = _cfg(JaxIVFConfig, fq)
    ranges = JaxMeshIVF._shared_int4_ranges(codes, cfg, -2.0, 20.0)
    per = N // SHARDS
    return [JaxIVFIndex.build(codes[i * per:(i + 1) * per], replace(
        cfg, num_clusters=max(cfg.num_clusters // SHARDS, 1),
        seed=cfg.seed + i, int4_ranges=ranges)) for i in range(SHARDS)]


def _overlap(a, b):
    return np.mean([len(set(x.tolist()) & set(y.tolist())) / len(x)
                    for x, y in zip(a, b)])


@pytest.fixture(scope="module")
def data():
    codes = float_to_int8(_clustered(N, D, seed=14))
    return codes, _clustered(max(BATCHES), D, seed=15)


@pytest.fixture(scope="module")
def sharded(data, tmp_path_factory):
    """Each variant's reference shards, saved; the reference's mesh and
    host-merged searches over them; one 4-rank spawn over the saves."""
    codes, queries = data
    tmp = tmp_path_factory.mktemp("sharded")
    mesh = JaxMesh(np.array(jax.devices("cpu")[:SHARDS]), ("shard",))
    bases = [i * (N // SHARDS) for i in range(SHARDS)]
    ref = {}
    for fq in VARIANTS:
        subs = _jax_subs(codes, fq)
        for i, sub in enumerate(subs):
            sub.save(str(tmp / "saves" / fq / str(i)))
        msh = JaxMeshIVF(subs, bases, mesh)
        for b in BATCHES:
            ref[f"mesh_{fq}_{b}"] = msh.search(queries[:b], top_k=10,
                                               nprobe=16)
        ref[f"nlist_{fq}"] = [int(s.centroids.shape[0]) for s in subs]
        for sub in subs:  # the packed union scan at every batch size
            sub.cfg = replace(sub.cfg, prefer_union_batch=1)
        host = JaxShardedIVF(subs, bases)
        for b in BATCHES:
            ref[f"host_{fq}_{b}"] = host.search(queries[:b], top_k=10,
                                                nprobe=16)
    inputs = {"search": {"saves": str(tmp / "saves"),
                         "queries": torch.from_numpy(queries)},
              "build": {"codes": torch.from_numpy(codes),
                        "queries": torch.from_numpy(queries)}}
    outs = spawn_ranks(SHARDS, str(tmp), inputs)
    return {"ref": ref, "outs": outs, "tmp": tmp}


# ------------------------------------------------------- MeshShardedIVF
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("fq", VARIANTS)
def test_mesh_sharded_ivf_matches_host_merged_reference(sharded, fq, b):
    """Ids equal the reference's ``ShardedIVF`` over the same shards, both
    through the packed union scans; every rank returns the same merge."""
    want_v, want_i = sharded["ref"][f"host_{fq}_{b}"]
    for out in sharded["outs"]:
        vals, ids = out["search"][f"{fq}_{b}"]
        np.testing.assert_array_equal(ids, np.asarray(want_i))
        np.testing.assert_allclose(vals, np.asarray(want_v), rtol=1e-4)
        assert ids.dtype == np.int32


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("fq", VARIANTS)
def test_mesh_sharded_ivf_meets_the_reference_mesh_bar(sharded, data, fq, b):
    want_v, want_i = sharded["ref"][f"mesh_{fq}_{b}"]
    vals, ids = sharded["outs"][0]["search"][f"{fq}_{b}"]
    assert _overlap(ids, np.asarray(want_i)) >= 0.9
    np.testing.assert_allclose(np.sort(vals, 1), np.sort(want_v, 1),
                               atol=0.5)
    assert (ids >= 0).all() and (ids < N).all()


@pytest.mark.parametrize("fq", VARIANTS)
def test_mesh_pads_to_the_largest_nlist(sharded, fq):
    nlists = sharded["ref"][f"nlist_{fq}"]
    for r, out in enumerate(sharded["outs"]):
        valid, padded, smallest, n_total = out["search"][f"{fq}_nlist"]
        assert valid == nlists[r] and padded == max(nlists)
        assert smallest == min(nlists) and n_total == N


@pytest.mark.parametrize("fq", ["SQ8", "SQ4"])
def test_mesh_build_matches_reference_configs(sharded, data, fq,
                                              monkeypatch):
    """``MeshShardedIVF.build`` gives each rank the reference's sub-config
    field for field (SQ4: one int4 contract trained on a global
    subsample), and its search meets the reference mesh's bar."""
    codes, queries = data
    cfgs = []
    build = JaxIVFIndex.build

    def record(codes, cfg, *a, **kw):
        cfgs.append(cfg)
        return build(codes, cfg, *a, **kw)

    monkeypatch.setattr(JaxIVFIndex, "build", staticmethod(record))
    mesh = JaxMesh(np.array(jax.devices("cpu")[:SHARDS]), ("shard",))
    ref = JaxMeshIVF.build(codes, JaxIVFConfig(
        num_clusters=NLIST, fine_quant=fq, kmeans_iters=5,
        prefer_union_batch=4), mesh)
    want_v, want_i = ref.search(queries, top_k=10, nprobe=16)
    for r, out in enumerate(sharded["outs"]):
        got = out["build"][f"{fq}_cfg"]
        want = dataclasses.asdict(cfgs[r])
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "int4_ranges" and v is not None:
                for a, b in zip(got[k], v):
                    np.testing.assert_array_equal(a, b)
            else:
                assert got[k] == v, k
        vals, ids = out["build"][f"{fq}_search"]
        assert _overlap(ids, np.asarray(want_i)) >= 0.9
        np.testing.assert_allclose(np.sort(vals, 1), np.sort(want_v, 1),
                                   atol=0.5)


def test_no_jax_in_the_ranks(sharded):
    for out in sharded["outs"]:
        assert out["jax_modules"] == []


# ---------------------------------------------------------- ShardedIVF
@pytest.fixture(scope="module")
def built(data):
    codes, _ = data
    cfg = dict(num_clusters=NLIST, fine_quant="SQ8", kmeans_iters=5,
               prefer_union_batch=2, two_level_clusters=16)
    ref = JaxShardedIVF.build(codes, JaxIVFConfig(**cfg),
                              devices=jax.devices("cpu")[:SHARDS])
    port = ShardedIVF.build(codes, IVFConfig(**cfg), devices=["cpu"] * SHARDS)
    return ref, port


def test_sharded_build_matches_reference(built):
    """The same row split and sub-configs field for field (the fields the
    reference leaves out, here ``prefer_union_batch`` and
    ``two_level_clusters``, take their defaults), and each shard built as
    the reference builds it (tests/test_torch_ivf.py's bars)."""
    ref, port = built
    assert port.bases == ref.bases and port.n_total == ref.n_total == N
    for p, r in zip(port.subs, ref.subs):
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
        assert p.cfg.prefer_union_batch == 4
        assert p.cfg.two_level_clusters == 8192
        np.testing.assert_allclose(p.centroids.numpy(),
                                   np.asarray(r.centroids), atol=1e-4)
        pa = _row_lists(p.list_offsets.numpy(), p.row_perm.numpy())
        ra = _row_lists(np.asarray(r.list_offsets), np.asarray(r.row_perm))
        assert (pa == ra).mean() >= 0.99  # bf16 near-ties may move a row
        assert p.codes.shape == tuple(r.codes.shape)
        agree = (p.codes.numpy() == np.asarray(r.codes)).mean()
        assert agree >= 0.99, agree


def _row_lists(offsets, row_perm):
    """Each global row's list."""
    n = int(offsets[-1])
    out = np.empty(n, np.int64)
    out[np.asarray(row_perm[:n], np.int64)] = np.repeat(
        np.arange(len(offsets) - 1), np.diff(offsets))
    return out


@pytest.mark.parametrize("b", BATCHES)
def test_sharded_search_matches_reference(built, data, tmp_path, b):
    """The host merge over the reference's own shards, loaded by the
    port, one device repeated for every shard."""
    ref, _ = built
    _, queries = data
    subs = []
    for i, sub in enumerate(ref.subs):
        sub.save(str(tmp_path / str(i)))
        subs.append(IVFIndex.load(str(tmp_path / str(i)), device="cpu"))
    port = ShardedIVF(subs, ref.bases, devices=["cpu"] * SHARDS)
    want_v, want_i = ref.search(queries[:b], top_k=10, nprobe=16)
    vals, ids = port.search(queries[:b], top_k=10, nprobe=16)
    np.testing.assert_array_equal(ids, np.asarray(want_i))
    np.testing.assert_allclose(vals, np.asarray(want_v), rtol=1e-4)


def test_sharded_build_without_a_gpu_raises(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ShardedIVF.build(data[0], IVFConfig(num_clusters=8))


# ----------------------------------------------------------- nlist_valid
def _padded(index, q):
    """The index's centroids and list offsets padded by one centroid that
    would win every query's probe (a scaled mean query) and its empty
    list, as a mesh shard pads to a larger nlist."""
    lure = torch.as_tensor(q.mean(0) * 50.0)[None]
    cents = torch.cat([index.centroids, lure])
    offs = torch.cat([index.list_offsets, index.list_offsets[-1:]])
    return cents, offs


@pytest.mark.parametrize("fq", ["SQ8", "OPQ8"])
def test_nlist_valid_masks_padded_centroids(data, fq):
    codes, queries = data
    index = IVFIndex.build(codes[:1024], _cfg(IVFConfig, fq), device="cpu")
    q = torch.from_numpy(queries)
    cents, offs = _padded(index, q)
    nlist, nprobe = index.nlist, 4
    budget = index._pack_budget(q.shape[0], nprobe)
    common = dict(top_k=10, nprobe=nprobe, cap=index.cap, budget=budget,
                  n_real=index.n_real)

    def scan(c, o, nlist_valid=None):
        if index.pq_books is None:
            return ivf_pack.packed_union_scan(
                q, c, o, index.codes, index.row_perm, index.offset,
                index.scale, nlist_valid, **common)
        return ivf_pack.packed_pq_scan(
            q, q @ index.rotation, c, o, index.codes, index.row_perm,
            index.pq_books, index.refine_codes, index.offset, index.scale,
            nlist_valid, scan_k=40, pq_residual=index.pq_residual,
            row_list=index.row_list, **common)

    want_v, want_i = scan(index.centroids, index.list_offsets)
    got_v, got_i = scan(cents, offs, nlist)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    # unmasked, the lure takes a probe from every query
    _, lured_i = scan(cents, offs)
    assert not torch.equal(lured_i, want_i)
    if fq == "SQ8":  # the reference's packed scan masks the same way
        ref_v, ref_i = jax_pack.packed_union_scan(
            jnp.asarray(queries), jnp.asarray(cents.numpy()),
            jnp.asarray(offs.numpy().astype(np.int32)),
            jnp.asarray(index.codes.numpy()),
            jnp.asarray(index.row_perm.numpy()), index.offset, index.scale,
            jnp.int32(nlist), top_k=10, nprobe=nprobe, cap=index.cap,
            budgets=(budget,), n_real=index.n_real, interpret=True)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v),
                                   rtol=1e-4)
