"""Port's RC training (densephrases_tpu_torch/models/{bert,encoder}.py,
train/rc.py, utils/checkpoint.py) against the JAX reference on the same
seeded inputs: dropout bit for bit, ``rc_loss`` and all its gradients, the
optimizer against optax, whole train steps against ``make_train_step``,
frozen parameters, remat under dropout, and exact resume."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densephrases_tpu.models.encoder as jax_encoder
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.bert import _dropout, bert_forward
from densephrases_tpu.models.encoder import RCLossConfig as JaxLossConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.models.encoder import rc_loss as jax_rc_loss
from densephrases_tpu.train.rc import create_train_state as jax_create_state
from densephrases_tpu.train.rc import make_optimizer as jax_make_optimizer
from densephrases_tpu.train.rc import linear_warmup_schedule as jax_sched
from densephrases_tpu.train.rc import make_train_step as jax_make_step
from densephrases_tpu_torch.cli.train_rc import step_generator
from densephrases_tpu_torch.models.bert import (
    BertConfig,
    dropout_from_bits,
    dropout_threshold,
)
from densephrases_tpu_torch.models.encoder import (
    RCLossConfig,
    init_encoder_params,
    init_pre_batch,
    pre_batch_update,
    rc_loss,
)
from densephrases_tpu_torch.models.from_jax import (
    encoder_from_jax,
    encoder_to_jax,
    named_to_jax,
)
from densephrases_tpu_torch.train.rc import (
    create_train_state,
    linear_warmup_schedule,
    make_optimizer,
    make_train_step,
)
from densephrases_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

B, L, LQ = 4, 24, 8
LOSS_CFG = dict(lambda_kl=2.0, lambda_neg=2.0, lambda_flt=1.0)
STUDENT = ("phrase", "query_start", "query_end", "filter")
# everything that gets a gradient in rc_loss: the teacher tower runs under
# stop_gradient, its head does not (the train step drops its gradient)
GRAD = STUDENT + ("qa_outputs",)


def _cfgs(dropout=0.0):
    j = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout_prob=dropout)
    t = dataclasses.replace(BertConfig.tiny(), hidden_dropout_prob=dropout)
    return j, t


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(0), _cfgs()[0], with_teacher=True)


def _batch(cfg, seed=0, hard_negatives=True):
    """A passage/query batch with ragged masks, one unanswerable row
    (position 0), teacher inputs and hard negatives."""
    rng = np.random.default_rng(seed)
    ids = lambda *s: rng.integers(5, cfg.vocab_size, s).astype(np.int32)
    am = np.ones((B, L), np.int32)
    for i in range(B):
        am[i, L - 3 * i:] = 0
    qam = np.ones((B, LQ), np.int32)
    qam[1:, LQ - 2:] = 0
    lc = L + LQ
    gather = np.full((B, L), -1, np.int32)
    gather[:, 0] = 0
    gather[:, 2:] = np.arange(LQ, LQ + L - 2)[None, :]
    batch = {
        "input_ids": ids(B, L), "attention_mask": am,
        "token_type_ids": np.zeros((B, L), np.int32),
        "query_input_ids": ids(B, LQ), "query_attention_mask": qam,
        "query_token_type_ids": np.zeros((B, LQ), np.int32),
        "start_positions": np.array([3, 0, 7, 11], np.int32),
        "end_positions": np.array([5, 0, 9, 12], np.int32),
        "cross_input_ids": ids(B, lc),
        "cross_attention_mask": np.ones((B, lc), np.int32),
        "cross_token_type_ids": np.concatenate(
            [np.zeros((B, LQ), np.int32), np.ones((B, L), np.int32)], 1),
        "teacher_gather": gather,
    }
    if hard_negatives:
        batch["neg_input_ids"] = ids(B, L)
        batch["neg_attention_mask"] = am[::-1].copy()
    return batch


def _pre_batch(hidden, seed=1):
    """A ring of 2 slots with the first filled (count 1)."""
    rng = np.random.default_rng(seed)
    start = np.zeros((2, B, hidden), np.float32)
    end = np.zeros((2, B, hidden), np.float32)
    start[0] = rng.standard_normal((B, hidden))
    end[0] = rng.standard_normal((B, hidden))
    return start, end


def _fp32_reference(monkeypatch):
    """Run the reference's towers in fp32 (its default compute is bf16)."""
    monkeypatch.setattr(jax_encoder, "bert_forward", functools.partial(
        bert_forward, compute_dtype=jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cos(got, want):
    got, want = np.ravel(got).astype(np.float64), np.ravel(want).astype(np.float64)
    return got @ want / max(np.linalg.norm(got) * np.linalg.norm(want), 1e-30)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


# ---- dropout -------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.001, 0.999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_reference_bit_for_bit(rate, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jdt = getattr(jnp, dtype)
    ref = _dropout(jnp.asarray(x, jdt), rate, key, False)
    bits = np.asarray(jax.random.bits(key, x.shape, dtype=jnp.uint8))
    out = dropout_from_bits(torch.from_numpy(x).to(getattr(torch, dtype)),
                            rate, torch.from_numpy(bits.copy()))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # the threshold is clamped to [1, 255]
    assert dropout_threshold(rate) == min(max(round(rate * 256), 1), 255)


# ---- rc_loss -------------------------------------------------------------

def _jax_loss_and_grads(params, cfg, batch, pre_batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {"start": jnp.asarray(pre_batch[0]), "end": jnp.asarray(pre_batch[1]),
          "count": jnp.int32(1)}

    def loss_fn(p):
        return jax_rc_loss(p, cfg, jb, JaxLossConfig(**LOSS_CFG), pre_batch=pb,
                           deterministic=True, attn_impl="xla")

    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return total, aux, grads


def _port_loss_and_grads(params, cfg, batch, pre_batch, dtype, remat="full"):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb = {"start": torch.from_numpy(pre_batch[0]),
          "end": torch.from_numpy(pre_batch[1]), "count": 1}
    total, aux = rc_loss(params, cfg, tb, RCLossConfig(**LOSS_CFG),
                         pre_batch=pb, deterministic=True, remat=remat,
                         compute_dtype=dtype)
    total.backward()
    grads = named_to_jax((n, p.grad) for n, p in params.named_parameters()
                         if n.split(".")[0] in GRAD)
    return total, aux, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rc_loss_and_gradients_match_reference(jax_params, monkeypatch, dtype):
    jcfg, tcfg = _cfgs()
    if dtype == "float32":
        _fp32_reference(monkeypatch)
    batch = _batch(tcfg)
    pre = _pre_batch(tcfg.hidden_size)
    r_total, r_aux, r_grads = _jax_loss_and_grads(jax_params, jcfg, batch, pre)
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    total, aux, grads = _port_loss_and_grads(params, tcfg, batch, pre,
                                             getattr(torch, dtype))
    # fp32: the same function in the same precision, summed in other
    # orders: losses to 1e-5 relative. bf16: both round activations to bf16
    # at the same points, but a product that lands one bf16 ulp apart
    # carries through two layers, so losses agree to 2%
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for k in ("single_loss", "kl_loss", "neg_loss", "filter_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(r_aux[k]),
                                   rtol=rtol)
    np.testing.assert_allclose(float(total.detach()), float(r_total), rtol=rtol)
    np.testing.assert_allclose(aux["gold_start"].numpy(),
                               np.asarray(r_aux["gold_start"]),
                               atol=1e-4 if dtype == "float32" else 0.1)
    # the teacher tower gets no gradient in either package
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(r_grads["cross"]))
    assert all(p.grad is None for p in params.cross.parameters())
    _assert_grads_match(grads, {k: r_grads[k] for k in GRAD}, dtype)


def _assert_grads_match(grads, ref, dtype):
    """Each gradient leaf within ``tol`` of the reference's, relative to the
    larger of its own largest entry and 1e-4 of the largest gradient of all:
    some leaves (the key biases, the teacher head's bias) are zero by
    symmetry, up to rounding noise. fp32: 1e-4 (measured 6e-5 at worst, on
    such a leaf; 1e-6 elsewhere). bf16: 8e-2 (measured 4e-2 at worst) and,
    on every leaf above the floor, a cosine above 0.999 (measured 0.9995)."""
    ref, got = _leaves(ref), _leaves(grads)
    assert ref.keys() == got.keys()
    floor = 1e-4 * max(np.abs(np.asarray(v)).max() for v in ref.values())
    tol = 1e-4 if dtype == "float32" else 8e-2
    for path, want in ref.items():
        want = np.asarray(want)
        scale = max(np.abs(want).max(), floor)
        err = np.abs(got[path] - want).max() / scale
        assert err <= tol, (jax.tree_util.keystr(path), err)
        if dtype == "bfloat16" and np.abs(want).max() > floor:
            assert _cos(got[path], want) > 0.999, jax.tree_util.keystr(path)


def test_ignored_index_matches_the_jitted_reference(jax_params, monkeypatch):
    """Reference fault, pinned: a position clipped to L (the ignored index)
    is gathered by ``jnp.take_along_axis`` out of range. Eager JAX fills
    NaN, so ``rc_loss`` is NaN; the jitted train step returns the finite
    loss of the other rows. The gradients are finite and equal in both. The
    port gives the jitted values, which are what the reference trains on."""
    jcfg, tcfg = _cfgs()
    _fp32_reference(monkeypatch)
    batch = _batch(tcfg, hard_negatives=False)
    batch["start_positions"][2] = L + 5
    pre = _pre_batch(tcfg.hidden_size)
    r_total, r_aux, r_grads = _jax_loss_and_grads(jax_params, jcfg, batch, pre)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    eager = jax_rc_loss(jax_params, jcfg, jb, JaxLossConfig(),
                        deterministic=True, attn_impl="xla")[1]["single_loss"]
    assert np.isnan(float(eager))
    assert np.isfinite(float(r_total))
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    total, aux, grads = _port_loss_and_grads(params, tcfg, batch, pre,
                                             torch.float32)
    for k in ("single_loss", "neg_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(r_aux[k]),
                                   rtol=1e-5)
    # the row adds nothing: the single loss is the mean over the other rows
    keep = np.arange(B) != 2
    logits = aux["start_logits"].detach()[keep]
    ce_s = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(batch["start_positions"][keep]).long())
    ce_e = torch.nn.functional.cross_entropy(
        aux["end_logits"].detach(), torch.from_numpy(
            batch["end_positions"]).long())
    np.testing.assert_allclose(float(aux["single_loss"].detach()),
                               float(0.5 * (ce_s + ce_e)), rtol=1e-5)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(grads))
    _assert_grads_match(grads, {k: r_grads[k] for k in GRAD}, "float32")


# ---- optimizer -----------------------------------------------------------

def test_schedule_matches_optax():
    for warm, total in ((0, 5), (2, 6), (3, 3)):
        want = jax_sched(1e-3, warm, total)
        got = linear_warmup_schedule(1e-3, warm, total)
        for count in range(total + 2):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                               abs=1e-12)
    assert linear_warmup_schedule(1e-3, 2, 6)(0) == 0.0


def test_optimizer_matches_optax(jax_params):
    """Three steps of identical gradients: the first with a global norm
    above max_grad_norm (clipped), then below it; warmup 1 so the first
    update has lr 0; the decay mask on biases and layer norms."""
    _, tcfg = _cfgs()
    student = {k: jax_params[k] for k in STUDENT}
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, weight_decay=0.1,
              adam_epsilon=1e-6, max_grad_norm=1.0)
    j_opt = jax_make_optimizer(**kw)
    j_state = j_opt.init(student)
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    named = {n: p for n, p in params.named_parameters()
             if n.split(".")[0] in STUDENT}
    opt = make_optimizer(**kw)
    state = opt.init(named)
    rng = np.random.default_rng(3)
    for scale in (5.0, 0.01, 0.02):
        g_np = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                for n, p in named.items()}
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in g_np.values()))
        g_np = {n: g * (scale / norm) for n, g in g_np.items()}
        j_grads = named_to_jax((n, torch.from_numpy(g)) for n, g in g_np.items())
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, j_grads),
                                    j_state, student)
        student = optax.apply_updates(student, upd)
        opt.update({n: torch.from_numpy(g) for n, g in g_np.items()}, state,
                   named)
        got = _leaves(encoder_to_jax(params))
        for path, want in _leaves(student).items():
            # fp32 elementwise updates in another operation order: within a
            # few fp32 ulps of the parameter
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6,
                                       atol=1e-7, err_msg=str(path))
    assert state["count"] == 3


# ---- whole train steps ---------------------------------------------------

def test_train_steps_match_reference(jax_params, monkeypatch):
    """Three steps of the port's ``make_train_step`` against the reference's
    on one batch, fp32, dropout off, every loss part and a pre-batch ring of
    2; the first step has lr 0 (warmup), the next two move the params."""
    jcfg, tcfg = _cfgs()
    _fp32_reference(monkeypatch)
    batch = _batch(tcfg, hard_negatives=False)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    j_opt = jax_make_optimizer(**kw)
    j_state = jax_create_state(jax_params, j_opt, pbn_size=2, batch_size=B,
                               hidden=tcfg.hidden_size)
    j_step = jax_make_step(jcfg, JaxLossConfig(**LOSS_CFG), j_opt,
                           attn_impl="xla")
    params = encoder_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                              device="cpu")
    opt = make_optimizer(**kw)
    state = create_train_state(params, opt, pbn_size=2, batch_size=B,
                               hidden=tcfg.hidden_size)
    step = make_train_step(tcfg, RCLossConfig(**LOSS_CFG), opt,
                           compute_dtype=torch.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        j_state, j_metrics = j_step(j_state, jb, jax.random.PRNGKey(i))
        state, metrics = step(state, tb, torch.Generator().manual_seed(i))
        for k, v in j_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5)
        got = _leaves(encoder_to_jax(state.params))
        for path, want in _leaves(j_state.params).items():
            # an Adam step moves an entry by up to lr (1e-3), almost
            # independently of the gradient's size, so an entry whose
            # gradient is rounding noise can move apart by a fraction of lr;
            # measured 1.6e-3 lr at worst, the tolerance is 1e-2 lr
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                       atol=1e-5, err_msg=str(path))
        np.testing.assert_allclose(state.pre_batch["start"].numpy(),
                                   np.asarray(j_state.pre_batch["start"]),
                                   atol=1e-4)
        assert state.pre_batch["count"] == int(j_state.pre_batch["count"])
        assert state.step == int(j_state.step) == i + 1


def _train(params, cfg, steps, start=0, state=None, frozen=True):
    opt = make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    if state is None:
        state = create_train_state(params, opt, pbn_size=2, batch_size=B,
                                   hidden=cfg.hidden_size)
    step = make_train_step(cfg, RCLossConfig(**LOSS_CFG), opt,
                           frozen_word_embeddings=frozen,
                           compute_dtype=torch.float32)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    for i in range(start, start + steps):
        state, _ = step(state, tb, step_generator(0, i))
    return state


@pytest.mark.parametrize("frozen", [True, False])
def test_frozen_word_embeddings_and_teacher(frozen):
    _, tcfg = _cfgs(dropout=0.1)
    params = init_encoder_params(tcfg, device="cpu", with_teacher=True)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    state = _train(params, tcfg, 3, frozen=frozen)
    for n, p in state.params.named_parameters():
        unchanged = torch.equal(p, before[n])
        if n.split(".")[0] in ("cross", "qa_outputs"):
            assert unchanged, n
        elif n.endswith(".word_emb"):
            assert unchanged == frozen, n
        elif n.endswith("layers.1.q_w"):
            assert not unchanged, n


def test_remat_full_equals_none_with_dropout():
    """Dropout seeds are drawn before a layer runs, so the recomputed layer
    draws the same masks: remat changes no value."""
    _, tcfg = _cfgs(dropout=0.1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, seed=2).items()}
    results = {}
    for remat, seed in (("full", 7), ("none", 7), ("none", 8)):
        params = init_encoder_params(tcfg, device="cpu", with_teacher=True)
        total, _ = rc_loss(params, tcfg, batch, RCLossConfig(**LOSS_CFG),
                           dropout=torch.Generator().manual_seed(seed),
                           remat=remat, compute_dtype=torch.float32)
        total.backward()
        results[remat, seed] = [float(total.detach())] + [
            p.grad.clone() for p in params.parameters() if p.grad is not None]
    full, none, other = results["full", 7], results["none", 7], results["none", 8]
    assert full[0] == none[0]
    assert all(torch.equal(a, b) for a, b in zip(full[1:], none[1:]))
    # the masks are live: another seed gives another loss
    assert other[0] != none[0]


def test_remat_dots_is_not_ported():
    """remat "dots", once refused, is ported: it keeps the products and
    recomputes the rest, and under dropout its loss and every gradient
    equal "none"'s bit for bit (the reference's "dots" gradients:
    tests/test_torch_parallel.py)."""
    _, tcfg = _cfgs(dropout=0.1)
    results = {}
    for remat in ("none", "dots"):
        params = init_encoder_params(tcfg, device="cpu", with_teacher=True)
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        total, _ = rc_loss(params, tcfg, batch, RCLossConfig(**LOSS_CFG),
                           dropout=torch.Generator().manual_seed(7),
                           remat=remat, compute_dtype=torch.float32)
        total.backward()
        results[remat] = [float(total.detach())] + [
            p.grad.clone() for p in params.parameters() if p.grad is not None]
    assert results["dots"][0] == results["none"][0]
    assert len(results["dots"]) == len(results["none"])
    assert all(torch.equal(a, b) for a, b in
               zip(results["dots"][1:], results["none"][1:]))
    with pytest.raises(ValueError, match="remat"):
        params.phrase(batch["input_ids"], batch["attention_mask"],
                      remat="some")


def test_resume_equals_uninterrupted_run(tmp_path):
    _, tcfg = _cfgs(dropout=0.1)
    whole = _train(init_encoder_params(tcfg, device="cpu", with_teacher=True), tcfg, 3)
    first = _train(init_encoder_params(tcfg, device="cpu", with_teacher=True), tcfg, 1)
    save_checkpoint(str(tmp_path), first, step=first.step)
    # a template from another seed: everything must come from the save
    template = create_train_state(
        init_encoder_params(tcfg, torch.Generator().manual_seed(9),
                            device="cpu", with_teacher=True),
        make_optimizer(), pbn_size=2, batch_size=B, hidden=tcfg.hidden_size)
    resumed = restore_checkpoint(str(tmp_path), template)
    assert resumed.step == 1 and resumed.pre_batch["count"] == 1
    resumed = _train(resumed.params, tcfg, 2, start=1, state=resumed)
    assert resumed.step == whole.step == 3
    for (n, a), b in zip(whole.params.named_parameters(),
                         resumed.params.parameters()):
        assert torch.equal(a, b), n
    assert whole.opt_state["count"] == resumed.opt_state["count"]
    for k in ("mu", "nu"):
        for n, t in whole.opt_state[k].items():
            assert torch.equal(t, resumed.opt_state[k][n]), (k, n)
    for k in ("start", "end"):
        assert torch.equal(whole.pre_batch[k], resumed.pre_batch[k])


def test_pre_batch_ring_wraps():
    ring = init_pre_batch(2, B, 4, device="cpu")
    for i in range(3):
        ring = pre_batch_update(ring, torch.full((B, 4), float(i)),
                                torch.full((B, 4), -float(i)))
    assert ring["count"] == 3
    assert ring["start"][0, 0, 0] == 2.0 and ring["start"][1, 0, 0] == 1.0
