"""The port's scale-out path (``densephrases_tpu_torch/parallel``, the mesh
``FlatIndex`` and ``MIPS``, data-parallel RC training with global
negatives, remat "dots") against the JAX package on the same seeded inputs.

The JAX side runs in the test process on the forced CPU devices of
``tests/conftest.py``. The port side runs as 2 and 4 gloo ranks, each a
subprocess that runs this file as a script: the rank code below sits above
the JAX imports, so a rank imports torch and the port only, and asserts
that. Each rank writes its results under the test's temporary directory
and the tests compare them.

Tolerances: flat scores are fp32 sums of the same exact bf16 x int8
products taken in another order (1e-5 relative); the train steps run both
packages in fp32 with dropout off (losses 1e-5 relative, parameters 2e-5
absolute after Adam steps of lr 1e-3); the exact-gradient identity (the
ranks against one process on the global batch) holds to fp32 summation
order (1e-6 relative on the loss, 1e-4 of the largest on the Adam
moments, as ``test_torch_train.py`` bounds fp32 gradients).
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

B_RANK, L, LQ = 2, 24, 8  # per-rank train batch, passage, query lengths
LOSS = dict(lambda_kl=2.0, lambda_neg=2.0, lambda_flt=1.0)
FLAT_ROWS = (4037, 1100)  # a short tail shard; an empty last shard at 4
DIM = 64


# ------------------------------------------------------------ rank side
def _rank_flat(rank, world, inp):
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.parallel import make_mesh
    from densephrases_tpu_torch.parallel.multihost import (
        broadcast_queries, flat_from_process_shards, global_mesh,
        process_row_range, shard_layout)

    mesh = make_mesh(axis="shard", devices=["cpu"] * world)
    out = {}
    q = inp["queries"].numpy()
    for n in FLAT_ROWS:
        codes = inp[f"codes_{n}"].numpy()
        idx = FlatIndex(codes, mesh=mesh)
        out[f"flat_{n}"] = idx.search(q, top_k=10)
        gm = global_mesh(devices=["cpu"] * world)
        lo, hi = process_row_range(n, gm)
        pre = flat_from_process_shards(codes[lo:hi], n, gm)
        out[f"pre_{n}"] = pre.search(q, top_k=10)
        out[f"layout_{n}"] = (shard_layout(n, gm), (lo, hi))
    out["bcast"] = broadcast_queries(q + rank)
    return out


def _rank_mips(rank, world, inp):
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.index.store import PhraseStore
    from densephrases_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis="shard", devices=["cpu"] * world)
    mips = MIPS(PhraseStore.load(inp["store"]), mesh=mesh, preload_meta=False)
    res = mips.search(inp["mips_queries"].numpy(), top_k=5)
    return {"mips": _span_list(res)}


def _span_list(results):
    return [[(int(r["doc_idx"]), int(r["start_idx"]), int(r["end_idx"]),
              float(r["score"])) for r in rs] for rs in results]


def _rank_grad(rank, world, inp):
    from densephrases_tpu_torch.parallel import all_gather_grad

    x = inp["x"][rank].clone().requires_grad_(True)
    y = all_gather_grad(x)
    (y * inp["w"][rank]).sum().backward()
    return {"gathered": y.detach(), "grad": x.grad}


def _no_dropout(cfg):
    """Dropout off: the two packages draw their masks differently, and
    the ranks draw theirs apart from one process."""
    import dataclasses

    return dataclasses.replace(cfg, hidden_dropout_prob=0.0)


def _encoder(inp, cfg):
    from densephrases_tpu_torch.models.encoder import init_encoder_params

    params = init_encoder_params(cfg, device="cpu", with_teacher=True)
    params.load_state_dict(inp["params"])
    return params


def _rank_train(rank, world, inp):
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import RCLossConfig
    from densephrases_tpu_torch.parallel import make_mesh
    from densephrases_tpu_torch.train.rc import (
        AdamW, create_train_state, make_optimizer, make_train_step,
        shard_batch)

    cfg = _no_dropout(BertConfig.tiny())
    mesh = make_mesh(axis="dp", devices=["cpu"] * world)
    loss_cfg = RCLossConfig(axis_name="dp", **LOSS)
    batch = {k: v.numpy() for k, v in inp["batch"].items()}
    out = {}
    # two steps beside the reference's mesh step (its schedule: lr 0 first)
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    state = create_train_state(_encoder(inp, cfg), opt, pbn_size=2,
                               batch_size=B_RANK, hidden=cfg.hidden_size)
    step = make_train_step(cfg, loss_cfg, opt, mesh=mesh,
                           compute_dtype=torch.float32)
    for i in range(2):
        state, metrics = step(state, shard_batch(batch, mesh),
                              torch.Generator().manual_seed(i))
        out[f"metrics_{i}"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = state.params.state_dict()
    out["ring"] = (state.pre_batch["start"], state.pre_batch["end"],
                   int(state.pre_batch["count"]))
    # one step at a constant lr: the gradient identity
    opt = AdamW(lambda count: 1e-3)
    state = create_train_state(_encoder(inp, cfg), opt, pbn_size=2,
                               batch_size=B_RANK, hidden=cfg.hidden_size)
    step = make_train_step(cfg, loss_cfg, opt, mesh=mesh,
                           compute_dtype=torch.float32)
    state, metrics = step(state, shard_batch(batch, mesh),
                          torch.Generator().manual_seed(0))
    out["identity"] = {"loss": float(metrics["loss"]),
                       "mu": state.opt_state["mu"],
                       "params": state.params.state_dict()}
    return out


def _rank_cli(rank, world, inp):
    from densephrases_tpu_torch.cli import train_rc

    def argv(batch, steps, *extra):
        return ["--load_dir", inp["enc"], "--train_file", inp["squad"],
                "--output_dir", inp["out"], "--lambda_neg", "2.0",
                "--lambda_flt", "1.0", "--pbn_size", "2",
                "--per_device_train_batch_size", str(batch),
                "--max_seq_length", "64", "--max_query_length", "16",
                "--doc_stride", "32", "--warmup_steps", "1",
                "--save_steps", "2", "--max_steps", str(steps), "--draft",
                "--verbose", *extra]

    state, _ = train_rc.main(argv(4, 3), device="cpu")
    first = {"step": state.step, "count": int(state.pre_batch["count"])}
    # resume from step 3 under remat "dots"
    state, _ = train_rc.main(argv(4, 5, "--remat", "dots"), device="cpu")
    out = {"first": first, "step": state.step,
           "params": state.params.state_dict()}
    try:  # fewer features than one global batch over the ranks: refused
        train_rc.main(argv(64, 1), device="cpu")
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


RANK_CASES = {"flat": _rank_flat, "mips": _rank_mips, "grad": _rank_grad,
              "train": _rank_train, "cli": _rank_cli}


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
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import densephrases_tpu.models.encoder as jax_encoder  # noqa: E402
from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex  # noqa: E402
from densephrases_tpu.index.search import MIPS as JaxMIPS  # noqa: E402
from densephrases_tpu.index.store import DocMeta as JaxDocMeta  # noqa: E402
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore  # noqa: E402,E501
from densephrases_tpu.index.store import StoreWriter as JaxStoreWriter  # noqa: E402,E501
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from densephrases_tpu.models.bert import bert_forward  # noqa: E402
from densephrases_tpu.models.encoder import RCLossConfig as JaxLossConfig  # noqa: E402,E501
from densephrases_tpu.models.encoder import init_encoder_params as jax_init  # noqa: E402,E501
from densephrases_tpu.ops.quant import float_to_int8, int8_to_float  # noqa: E402
from densephrases_tpu.parallel import multihost as jax_multihost  # noqa: E402
from densephrases_tpu.train import rc as jax_rc  # noqa: E402
from densephrases_tpu.tools import parallel_dump as jax_pdump  # noqa: E402
from densephrases_tpu_torch.cli import generate_phrase_vecs  # noqa: E402
from densephrases_tpu_torch.cli.common import save_encoder  # noqa: E402
from densephrases_tpu_torch.data.tokenization import (  # noqa: E402
    SPECIAL_TOKENS,
    WordPieceTokenizer,
)
from densephrases_tpu_torch.index.flat import FlatIndex  # noqa: E402
from densephrases_tpu_torch.index.search import MIPS  # noqa: E402
from densephrases_tpu_torch.index.store import PhraseStore  # noqa: E402
from densephrases_tpu_torch.models.bert import BertConfig  # noqa: E402
from densephrases_tpu_torch.models.encoder import (  # noqa: E402
    RCLossConfig,
    init_encoder_params,
    rc_loss,
)
from densephrases_tpu_torch.models.from_jax import (  # noqa: E402
    encoder_from_jax,
    encoder_to_jax,
    named_to_jax,
)
from densephrases_tpu_torch.parallel import make_mesh, rank_and_size  # noqa: E402,E501
from densephrases_tpu_torch.parallel.multihost import shard_layout  # noqa: E402
from densephrases_tpu_torch.tools.parallel_dump import (  # noqa: E402
    bin_by_size,
    make_ranges,
    merge_shards,
    run_parallel_dump,
)
from densephrases_tpu_torch.train.rc import (  # noqa: E402
    AdamW,
    create_train_state,
    make_train_step,
)

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


# ------------------------------------------------------------ fixtures
def _store(path):
    """The reference's MIPS test store (tests/test_mips_ivf.py::_store)."""
    rng = np.random.default_rng(0)
    writer = JaxStoreWriter(str(path), DIM)
    centers = rng.normal(-2, 1.0, (24, DIM)).astype(np.float32)
    for d in range(40):
        vecs = (centers[rng.integers(0, 24, 50)]
                + 0.25 * rng.normal(size=(50, DIM))).astype(np.float32)
        writer.add_doc(
            JaxDocMeta(doc_id=d, title=f"doc{d}",
                       context=" ".join(["tok"] * 52),
                       word2char_start=np.arange(50, dtype=np.int32) * 4,
                       word2char_end=np.arange(50, dtype=np.int32) * 4 + 3,
                       f2o_start=np.arange(50, dtype=np.int32)),
            float_to_int8(vecs))
    writer.finalize()
    return str(path)


def _mips_queries(store, n=6, seed=1):
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        b0 = int(store.doc_bases[int(rng.integers(0, store.num_docs))])
        s = int(rng.integers(0, 40))
        qs.append(np.concatenate([int8_to_float(np.asarray(store.vecs[b0 + s])),
                                  int8_to_float(np.asarray(store.vecs[b0 + s + 2]))]))
    return np.stack(qs).astype(np.float32)


def _train_batch(cfg, world, seed=0):
    """A global batch of ``world * B_RANK`` rows: ragged masks, every row
    answerable (the per-rank filter mean then equals the global one),
    teacher inputs and hard negatives."""
    rng = np.random.default_rng(seed)
    b = world * B_RANK
    ids = lambda *s: rng.integers(5, cfg.vocab_size, s).astype(np.int32)
    am = np.ones((b, L), np.int32)
    for i in range(b):
        am[i, L - 2 * (i % 4):] = 0
    qam = np.ones((b, LQ), np.int32)
    qam[1::2, LQ - 2:] = 0
    lc = L + LQ
    gather = np.full((b, L), -1, np.int32)
    gather[:, 0] = 0
    gather[:, 2:] = np.arange(LQ, LQ + L - 2)[None, :]
    start = rng.integers(1, 12, b).astype(np.int32)
    return {
        "input_ids": ids(b, L), "attention_mask": am,
        "token_type_ids": np.zeros((b, L), np.int32),
        "query_input_ids": ids(b, LQ), "query_attention_mask": qam,
        "query_token_type_ids": np.zeros((b, LQ), np.int32),
        "start_positions": start, "end_positions": start + 2,
        "cross_input_ids": ids(b, lc),
        "cross_attention_mask": np.ones((b, lc), np.int32),
        "cross_token_type_ids": np.concatenate(
            [np.zeros((b, LQ), np.int32), np.ones((b, L), np.int32)], 1),
        "teacher_gather": gather,
        "neg_input_ids": ids(b, L), "neg_attention_mask": am[::-1].copy(),
    }


WORDS = [f"w{i}" for i in range(200)]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS + [".", ","])}


def _squad(path, seed=0, n_titles=4):
    """A SQuAD-format file (tests/test_torch_train_cli.py::_squad)."""
    rng = np.random.default_rng(seed)
    data = []
    for a in range(n_titles):
        paras = []
        for p in range(2):
            ws = list(rng.choice(WORDS, 40))
            qas = []
            for q in range(3):
                s, n = int(rng.integers(0, 35)), int(rng.integers(1, 6))
                start = len(" ".join(ws[:s])) + (1 if s else 0)
                qas.append({"id": f"{a}-{p}-{q}",
                            "question": " ".join(rng.choice(ws, 6)),
                            "answers": [{"text": " ".join(ws[s:s + n]),
                                         "answer_start": start}]})
            paras.append({"context": " ".join(ws), "qas": qas})
        data.append({"title": f"t{a}", "paragraphs": paras})
    with open(path, "w") as f:
        json.dump({"data": data}, f)
    return str(path)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(0), JaxBertConfig.tiny(),
                    with_teacher=True)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory, jax_params):
    """One spawn of ``world`` ranks running every case; their outputs and
    the inputs."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    rng = np.random.default_rng(world)
    flat = {f"codes_{n}": torch.from_numpy(float_to_int8(
        rng.normal(-2, 1, (n, DIM)).astype(np.float32))) for n in FLAT_ROWS}
    flat["queries"] = torch.from_numpy(
        rng.normal(size=(5, DIM)).astype(np.float32))
    store = _store(tmp / "store")
    mips_q = _mips_queries(JaxPhraseStore.load(store))
    tcfg = BertConfig.tiny()
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu").state_dict()
    batch = _train_batch(tcfg, world)
    grad = {"x": torch.from_numpy(rng.normal(size=(world, 3, 5))),
            "w": torch.from_numpy(rng.normal(size=(world, 3 * world, 5)))}
    inputs = {"flat": flat,
              "mips": {"store": store, "mips_queries": torch.from_numpy(mips_q)},
              "grad": grad,
              "train": {"params": params,
                        "batch": {k: torch.from_numpy(v)
                                  for k, v in batch.items()}}}
    if world == 2:
        cfg = BertConfig.tiny(vocab_size=len(VOCAB))
        save_encoder(str(tmp / "enc"), init_encoder_params(cfg, device="cpu"),
                     cfg, WordPieceTokenizer(VOCAB))
        inputs["cli"] = {"enc": str(tmp / "enc"),
                         "squad": _squad(tmp / "squad.json"),
                         "out": str(tmp / "cli_out")}
    outs = spawn_ranks(world, str(tmp), inputs)
    return {"world": world, "outs": outs, "inputs": inputs, "tmp": tmp,
            "batch": batch, "store": store, "mips_q": mips_q}


def _jax_mesh(world, axis):
    return JaxMesh(np.array(jax.devices("cpu")[:world]), (axis,))


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("n", FLAT_ROWS)
def test_flat_mesh_matches_reference(ranks, n):
    world, outs, inp = ranks["world"], ranks["outs"], ranks["inputs"]["flat"]
    codes, q = inp[f"codes_{n}"].numpy(), inp["queries"].numpy()
    ref_v, ref_i = JaxFlatIndex(codes, mesh=_jax_mesh(world, "shard")).search(
        q, top_k=10)
    single_v, single_i = FlatIndex(codes, device="cpu").search(q, top_k=10)
    for out in outs:  # every rank returns the merged result
        vals, ids = out["flat"][f"flat_{n}"]
        np.testing.assert_array_equal(ids, np.asarray(ref_i))
        np.testing.assert_array_equal(ids, single_i)
        np.testing.assert_allclose(vals, np.asarray(ref_v), rtol=1e-5)
        np.testing.assert_array_equal(vals, single_v)
        assert ids.dtype == np.int32


@pytest.mark.parametrize("n", FLAT_ROWS)
def test_preassembled_shards_match_multihost_worker(ranks, n):
    """``flat_from_process_shards`` on each rank's own rows against the
    reference's multi-host assembly run in one process
    (tests/_multihost_worker.py's logic) over as many devices."""
    world, outs, inp = ranks["world"], ranks["outs"], ranks["inputs"]["flat"]
    codes, q = inp[f"codes_{n}"].numpy(), inp["queries"].numpy()
    mesh = _jax_mesh(world, "shard")
    lo, hi = jax_multihost.process_row_range(n, mesh)
    ref_v, ref_i = jax_multihost.flat_from_process_shards(
        codes[lo:hi], n, mesh).search(q, top_k=10)
    for out in outs:
        vals, ids = out["flat"][f"pre_{n}"]
        np.testing.assert_array_equal(ids, np.asarray(ref_i))
        np.testing.assert_allclose(vals, np.asarray(ref_v), rtol=1e-5)


@pytest.mark.parametrize("n", FLAT_ROWS)
def test_shard_layout_and_row_ranges(ranks, n):
    world, outs = ranks["world"], ranks["outs"]
    mesh = _jax_mesh(world, "shard")
    shard_rows, chunk = jax_multihost.shard_layout(n, mesh)
    ranges = []
    for r, out in enumerate(outs):
        layout, (lo, hi) = out["flat"][f"layout_{n}"]
        assert layout == (shard_rows, chunk)
        assert (lo, hi) == (min(r * shard_rows, n),
                            min((r + 1) * shard_rows, n))
        ranges.append((lo, hi))
    # the ranks' ranges tile the reference's one-process range
    assert (ranges[0][0], ranges[-1][1]) == jax_multihost.process_row_range(
        n, mesh)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_broadcast_queries_sends_rank_zeros(ranks):
    q = ranks["inputs"]["flat"]["queries"].numpy()
    for out in ranks["outs"]:
        np.testing.assert_array_equal(out["flat"]["bcast"], q)


def test_mips_mesh_matches_reference(ranks):
    world, store = ranks["world"], ranks["store"]
    q = ranks["mips_q"]
    want = _span_list(JaxMIPS(JaxPhraseStore.load(store),
                              mesh=_jax_mesh(world, "shard")).search(
                                  q, top_k=5))
    single = _span_list(MIPS(PhraseStore.load(store), device="cpu").search(
        q, top_k=5))
    for out in ranks["outs"]:
        got = out["mips"]["mips"]
        assert got == single  # the mesh serve is the one-device serve
        assert [[s[:3] for s in rs] for rs in got] == \
            [[s[:3] for s in rs] for rs in want]
        np.testing.assert_allclose([s[3] for rs in got for s in rs],
                                   [s[3] for rs in want for s in rs],
                                   rtol=1e-5)


def test_no_jax_in_the_ranks(ranks):
    for out in ranks["outs"]:
        assert out["jax_modules"] == []


# ------------------------------------------------------------ training
def test_all_gather_grad_matches_autograd_of_the_concatenation(ranks):
    world, outs = ranks["world"], ranks["outs"]
    x = ranks["inputs"]["grad"]["x"].clone().requires_grad_(True)
    w = ranks["inputs"]["grad"]["w"]
    cat = x.reshape(-1, x.shape[-1])
    # every rank's loss on the gathered tensor, summed: the gradient each
    # rank's slice gets from all the ranks' losses
    sum((cat * w[r]).sum() for r in range(world)).backward()
    for r, out in enumerate(outs):
        torch.testing.assert_close(out["grad"]["gathered"], cat.detach(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(out["grad"]["grad"], x.grad[r],
                                   rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def jax_dp(ranks, jax_params):
    """The reference's mesh train step, 2 steps, fp32 towers."""
    world = ranks["world"]
    jcfg = _no_dropout(JaxBertConfig.tiny())
    orig = jax_encoder.bert_forward
    jax_encoder.bert_forward = functools.partial(bert_forward,
                                                 compute_dtype=jnp.float32)
    try:
        mesh = _jax_mesh(world, "dp")
        opt = jax_rc.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
        state = jax_rc.create_train_state(jax_params, opt, pbn_size=2,
                                          batch_size=B_RANK,
                                          hidden=jcfg.hidden_size)
        step = jax_rc.make_train_step(
            jcfg, JaxLossConfig(axis_name="dp", **LOSS), opt, mesh=mesh,
            attn_impl="xla")
        batch = jax_rc.shard_batch(ranks["batch"], mesh)
        metrics = []
        for i in range(2):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
        rings = [np.asarray(s.data) for s in sorted(
            state.pre_batch["start"].addressable_shards,
            key=lambda s: s.device.id)]
        return {"metrics": metrics, "params": jax.tree.map(np.asarray,
                                                           state.params),
                "rings": rings, "count": int(state.pre_batch["count"])}
    finally:
        jax_encoder.bert_forward = orig


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_dp_step_matches_reference_mesh_step(ranks, jax_dp):
    tcfg = BertConfig.tiny()
    for out in ranks["outs"][:1]:  # the reference's part losses: device 0's
        for i in range(2):
            got, want = out["train"][f"metrics_{i}"], jax_dp["metrics"][i]
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    params = init_encoder_params(tcfg, device="cpu", with_teacher=True)
    params.load_state_dict(ranks["outs"][0]["train"]["params"])
    got = _leaves(encoder_to_jax(params))
    # an Adam step moves an entry by up to lr (1e-3) almost independently
    # of its gradient's size, so an entry whose gradient is near rounding
    # noise can move apart by a fraction of lr: measured 1.2e-2 lr at worst
    # (4 ranks), the tolerance is 2e-2 lr
    for path, want in _leaves(jax_dp["params"]).items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=2e-5,
                                   err_msg=str(path))


def test_dp_ranks_hold_equal_parameters_and_loss(ranks):
    outs = ranks["outs"]
    for out in outs[1:]:
        for k, v in outs[0]["train"]["params"].items():
            assert torch.equal(out["train"]["params"][k], v), k
        assert out["train"]["metrics_1"]["loss"] == \
            outs[0]["train"]["metrics_1"]["loss"]


def test_pre_batch_ring_is_each_ranks_own(ranks, jax_dp):
    """Each rank's ring holds its own golds, as each device's does in the
    reference's mesh step; a checkpoint keeps rank 0's (device 0's)."""
    assert len(jax_dp["rings"]) == ranks["world"]
    for r, out in enumerate(ranks["outs"]):
        start, _, count = out["train"]["ring"]
        assert count == jax_dp["count"] == 2
        np.testing.assert_allclose(start.numpy(), jax_dp["rings"][r],
                                   atol=1e-4)
    assert not np.allclose(jax_dp["rings"][0], jax_dp["rings"][1])


def test_dp_step_equals_one_process_on_the_global_batch(ranks, jax_params):
    """The exact-gradient identity: the ranks' averaged gradient (Adam's
    first moment after one step) and updated parameters equal one process
    stepping on the whole global batch."""
    tcfg = _no_dropout(BertConfig.tiny())
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    opt = AdamW(lambda count: 1e-3)
    state = create_train_state(params, opt, pbn_size=2,
                               batch_size=B_RANK * ranks["world"],
                               hidden=tcfg.hidden_size)
    step = make_train_step(tcfg, RCLossConfig(**LOSS), opt,
                           compute_dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in ranks["batch"].items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    for out in ranks["outs"]:
        ident = out["train"]["identity"]
        np.testing.assert_allclose(ident["loss"], float(metrics["loss"]),
                                   rtol=1e-6)
        mus = state.opt_state["mu"]
        floor = 1e-4 * max(float(m.abs().max()) for m in mus.values())
        for name, mu in mus.items():
            scale = max(float(mu.abs().max()), floor)
            err = float((ident["mu"][name] - mu).abs().max()) / scale
            assert err < 1e-4, (name, err)  # measured 3.3e-5
        # Adam's first step moves an entry by lr * g / (|g| + eps): equal
        # to 1e-6 where |g| > 1e-5; an entry whose gradient is rounding
        # noise may move by up to lr (1e-3) either way
        named = dict(state.params.named_parameters())
        for name, p in named.items():
            got = ident["params"][name]
            if name not in mus:
                assert torch.equal(got, p.detach()), name
                continue
            tol = torch.where(mus[name].abs() * 10 > 1e-5, 1e-6, 2e-3)
            assert bool(((got - p.detach()).abs() <= tol).all()), name


# ------------------------------------------------------------ the driver
@pytest.mark.parametrize("ranks", [2], indirect=True, ids=["2ranks"])
def test_train_rc_over_two_ranks(ranks):
    """``train_rc.main`` under a 2-rank group: 3 steps under remat "full",
    then a resume to 5 under "dots". Rank 0 alone writes the encoder and
    the checkpoints, every rank resumes, and the ranks stay equal; fewer
    features than one global batch is refused."""
    outs = ranks["outs"]
    out_dir = ranks["inputs"]["cli"]["out"]
    for out in outs:
        assert out["cli"]["first"]["step"] == 3 and out["cli"]["step"] == 5
        assert out["cli"]["first"]["count"] == 3
        assert out["cli"]["refused"]
    for k, v in outs[0]["cli"]["params"].items():
        assert torch.equal(outs[1]["cli"]["params"][k], v), k
    for name in ("config.json", "params/step_0/state.pt",
                 "ckpt/step_2/state.pt", "ckpt/step_3/state.pt",
                 "ckpt/step_4/state.pt", "ckpt/step_5/state.pt"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4, 5]  # rank 0 alone logs


# ------------------------------------------------------------ the dump
@pytest.mark.parametrize("n_files,n_workers", [(10, 4), (3, 8), (8, 2),
                                               (1, 1), (7, 3)])
def test_dump_ranges_and_bins_match_reference(n_files, n_workers):
    assert make_ranges(n_files, n_workers) == \
        jax_pdump.make_ranges(n_files, n_workers)
    sizes = {f"s{i}": int(v) for i, v in enumerate(
        np.random.default_rng(n_files).integers(1, 100, n_files))}
    assert bin_by_size(sizes, n_workers) == \
        jax_pdump.bin_by_size(sizes, n_workers)


def test_parallel_dump_equals_one_dump(tmp_path, monkeypatch):
    """Two worker processes on the CPU over a 4-file corpus, merged, equal
    one dump of the corpus file for file, byte for byte."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(4):
        docs = [{"title": f"t{i}{j}", "paragraphs": [
            {"context": " ".join(rng.choice(WORDS, int(rng.integers(30, 200))))}
            for _ in range(2)]} for j in range(int(rng.integers(2, 5)))]
        with open(corpus / f"part{i}.json", "w") as f:
            json.dump({"data": docs}, f)
    cfg = BertConfig.tiny(vocab_size=len(VOCAB))
    save_encoder(str(tmp_path / "enc"), init_encoder_params(cfg, device="cpu"),
                 cfg, WordPieceTokenizer(VOCAB))
    args = dict(max_seq_length=128, filter_threshold=-1e8)
    one = generate_phrase_vecs.main(
        ["--load_dir", str(tmp_path / "enc"), "--data_dir", str(corpus),
         "--predict_file", "0:4", "--dump_dir", str(tmp_path / "one"),
         "--max_seq_length", "128", "--index_filter", str(-1e8)], device="cpu")
    cmds = run_parallel_dump(str(corpus), str(tmp_path / "par"),
                             str(tmp_path / "enc"), 2, devices=["cpu"],
                             timeout=120, **args)
    assert [c[c.index("--predict_file") + 1] for c in cmds] == ["0:2", "2:4"]
    merged = merge_shards(str(tmp_path / "par"))
    names = sorted(os.listdir(tmp_path / "one" / "phrase"))
    assert names == sorted(os.listdir(merged))
    for name in names:
        with open(tmp_path / "one" / "phrase" / name, "rb") as a, \
                open(os.path.join(merged, name), "rb") as b:
            assert a.read() == b.read(), name
    assert PhraseStore.load(merged).num_docs == one.num_docs


# ------------------------------------------------------------ one process
def test_mesh_of_one_without_a_group():
    assert rank_and_size() == (0, 1)
    mesh = make_mesh(axis="dp", devices=["cpu"])
    assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"dp": 1})
    with pytest.raises(RuntimeError, match="need 2 devices"):
        make_mesh(2, devices=["cpu", "cpu"])
    jm = JaxMesh(np.array(jax.devices("cpu")[:1]), ("shard",))
    for n in (7, 5000):
        assert shard_layout(n, make_mesh(axis="shard", devices=["cpu"])) == \
            jax_multihost.shard_layout(n, jm)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_dots_matches_reference(jax_params, remat):
    """``rc_loss`` under remat "dots" in fp32: its loss and gradients equal
    "full" and "none" exactly, and the reference's ``remat="dots"``
    gradients to fp32 order (1e-4 of the largest, as
    ``test_torch_train.py`` states)."""
    jcfg, tcfg = JaxBertConfig.tiny(), BertConfig.tiny()
    batch = _train_batch(tcfg, 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def port(mode):
        params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                                  device="cpu")
        total, _ = rc_loss(params, tcfg, tb, RCLossConfig(**LOSS),
                           deterministic=True, remat=mode,
                           compute_dtype=torch.float32)
        total.backward()
        return float(total.detach()), {
            n: p.grad for n, p in params.named_parameters()
            if p.grad is not None}

    dots, other = port("dots"), port(remat)
    assert dots[0] == other[0]
    assert dots[1].keys() == other[1].keys()
    for n, g in dots[1].items():
        assert torch.equal(g, other[1][n]), n

    def ref_loss(p):
        fwd = functools.partial(bert_forward, compute_dtype=jnp.float32)
        orig = jax_encoder.bert_forward
        jax_encoder.bert_forward = fwd
        try:
            return jax_encoder.rc_loss(
                p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                JaxLossConfig(**LOSS), deterministic=True, attn_impl="xla",
                remat="dots")[0]
        finally:
            jax_encoder.bert_forward = orig

    r_total, r_grads = jax.value_and_grad(ref_loss)(jax_params)
    np.testing.assert_allclose(dots[0], float(r_total), rtol=1e-5)
    trained = ("phrase", "query_start", "query_end", "filter", "qa_outputs")
    got = _leaves(named_to_jax((n, g) for n, g in dots[1].items()
                               if n.split(".")[0] in trained))
    ref = _leaves({k: r_grads[k] for k in trained})
    assert got.keys() == ref.keys()
    floor = 1e-4 * max(np.abs(np.asarray(v)).max() for v in ref.values())
    for path, want in ref.items():
        want = np.asarray(want)
        err = np.abs(got[path] - want).max() / max(np.abs(want).max(), floor)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
