"""compute_dtype="bfloat16" of temp_tpu_torch's flagship BiGRRGCN --impute
and the TeMP variants against the JAX package's bfloat16 path (CPU): K2's
three flagship modes, the flagship's final step (K6-K10 with K8 and K4),
the flagship trained two steps and ranked, and TED, --post-aggregation,
plain BiGRRGCN and the unidirectional --impute one step and ranked.

Both sides run with compute_dtype="bfloat16", each on the path its config
takes on the CPU: the JAX kernels in Pallas interpret mode where the JAX
package dispatches to them (K2 and the bi final step under fused_window and
fused_final), its XLA scan and unfused final step elsewhere (the variants,
whose port runs its windows step by step). The rule of tests/
test_torch_bf16.py, on the same inputs: RMS(port bf16 - JAX bf16) <= 0.1 *
RMS(JAX bf16 - f32), the distance between the two precisions being the
yardstick. For the kernels (K2's modes, the final step) the float32 side
is the JAX package's own; for the models (the slice, the variants) it is
the port's float32 run of the same path, which tests/test_torch_flagship.py
and tests/test_torch_post.py hold to the JAX package's within 1e-5, so that
each model compiles once in JAX. Measured on these fixtures (the ratio
RMS(port - JAX bf16) / RMS(JAX bf16 - f32)): K2's modes, the buffers and
their 12 cotangents, at most 0.0031 (the flagship's), 0.0067 (a) and
0.0001 (b); the final step's loss, table and the gradients of the six
histories and every parameter at most 0.0001 (either backward); the
slice's two losses and trained parameters at most 0.0009, its ranks equal
but for near-ties; the variants' loss and every gradient at most 0.0065
(TED), 0.0060 (--post-aggregation), 0.048 (plain BiGRRGCN's loss, 4.8e-7
apart) and 0.0013 (--impute), ranks equal but for near-ties. The two
sides round at the same points and sum
the same bfloat16 values in float32 in another order, and where such a sum
lands on a bfloat16 rounding boundary on one side only, they differ by the
flip, carried downstream. ``test_control_f32_fails_the_rule`` shows the
rule bites. A rank that differs from JAX's needs a competitor within
NEAR_TIE of the target's score; the tests count them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops import fused_final_bi as jax_ffb
from temp_tpu.ops.fused_window import _fused_window
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_final_bi as fb
from temp_tpu_torch.ops import fused_window as fw
from temp_tpu_torch.ops.scores import complex_all
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
import test_torch_flagship as tfl
import test_torch_post as tpo
import test_torch_train as tt
from test_torch_bf16 import BF, _f32, _lookup, _rule
from test_torch_post import _xla_unoptimized
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _COT, _pairs, _torch_params, _window_case


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

# a competitor within this of the target's score is a near-tie (as in
# tests/test_torch_bf16.py)
NEAR_TIE = 1e-3
EVAL_T = [4, 6, 8]


# -- K2 in the flagship's modes ---------------------------------------------

# (layer 2's ReLU, buffers): the flagship's windows, the unidirectional
# Post models' (a) and BiGRRGCN's (b)
_MODES = {"flagship": (True, 3), "a": (False, 3), "b": (True, 2)}


def _jax_window_vjp(c, rate, act2, n_buf, dtype_str, lam=0.1):
    """jax.vjp of _fused_window (interpret) in the mode (act2, n_buf,
    dtype_str) over the case's elements under vmap, with a cotangent on
    every buffer in the store dtype: (buffers [B][n_buf], dh0x, the 11
    weight cotangents summed over the elements)."""
    B, L1, A, d = c["h0x"].shape
    E, R2 = c["src"].shape[-1], c["wrel"].shape[0]
    Ap = Ep = Rp = 128
    store = "float32" if dtype_str is None else dtype_str
    static = (L1, Ap, Ep, d, Rp, rate, act2, lam, True, n_buf, dtype_str,
              store, True, False)
    pa, pe = ((0, 0), (0, 0), (0, Ap - A)), ((0, 0), (0, 0), (0, Ep - E))
    pm = ((0, 0), (0, 0), (0, Ap - A), (0, 0))
    ws = [jnp.pad(c["wrel"], ((0, Rp - R2), (0, 0)))] + [
        jnp.asarray(c[k])[None] if k.startswith("b") else jnp.asarray(c[k])
        for k in _COT[1:]]

    def col(x, pad, v=0):
        return jnp.pad(x, pad, constant_values=v)[..., None]

    gidx = (c["gidx"] // A) * Ap + c["gidx"] % A
    gs = tuple(jnp.pad(c[g], pm).reshape(B, L1 * Ap, d) for g in ("g1", "g2"))
    if n_buf == 3:
        gs += (jnp.pad(c["g3"], pm),)
    per = ((col(gidx, pa), col(c["live"], pa), col(c["dt"], pa),
            jnp.pad(c["m1"], pm), jnp.pad(c["m2"], pm)),
           (col(c["src"], pe, Ap - 1), col(c["dst"], pe, Ap - 1),
            col(c["rel"], pe), col(c["em"], pe)),
           jnp.pad(c["h0x"], pm), gs)

    def one(ins, edges, h0p, gs):
        outs, vjp = jax.vjp(
            lambda h, *w: _fused_window(static, h, *edges, *ins, *w),
            h0p, *ws)
        return outs, vjp(tuple(g.astype(outs[0].dtype) for g in gs))

    with _xla_unoptimized():
        outs, cts = jax.jit(jax.vmap(one))(*per)
    bufs = [[_f32(o[b]).reshape(L1, Ap, d)[:, :A] for o in outs]
            for b in range(B)]
    dws = [np.asarray(x).sum(0) for x in cts[1:]]
    dws[0] = dws[0][:R2]
    dws = [x[0] if k.startswith("b") else x for k, x in zip(_COT, dws)]
    return bufs, np.asarray(cts[0])[:, :, :A], dws


@pytest.fixture(scope="module")
def k2_modes():
    """mode -> (case, {dtype: JAX's vjp}), computed on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            act2, n_buf = _MODES[mode]
            c = _window_case(0.1, seed=4)
            c["g3"] = np.random.RandomState(9).standard_normal(
                c["g1"].shape).astype(np.float32)
            cache[mode] = (c, {dt: _jax_window_vjp(c, 0.1, act2, n_buf, dt)
                               for dt in ("bfloat16", None)})
        return cache[mode]

    return get


def _k2_port(c, act2, n_buf, hot):
    """K2f and K2b (their plain versions here) on the case in the mode:
    (buffers, the 12 cotangents), the cotangents given in the store
    dtype."""
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    g1, g2 = ({n: T[f"{k}{i}"] for n, k in (("wih_t", "wih"),
                                             ("whh_t", "whh"), ("bih", "bih"),
                                             ("bhh", "bhh"))}
              for i in (1, 2))
    args = (T["h0x"], T["src"], T["dst"], T["rel"], T["em"], T["gidx"],
            T["live"], T["dt"], T["wrel"], T["loop1"], T["loop2"], g1, g2,
            0.1)
    bufs = fw.fused_window_fwd(*args, False, T["m1"], T["m2"], act2, n_buf,
                               hot=hot)
    store = torch.float32 if hot is None else hot
    gbs = [T[g].to(store) for g in ("g1", "g2", "g3")[:n_buf]]
    grads = fw.fused_window_bwd(*args, T["m1"], T["m2"], bufs[0], bufs[1],
                                *gbs, *([None] * (3 - n_buf)), act2, hot=hot)
    return bufs, grads


@pytest.mark.parametrize("mode", list(_MODES))
def test_k2_flagship_modes_match_jax_bf16(k2_modes, mode):
    """K2f with dropout and K2b in the mode: the n_buf buffers of each
    element and the 12 cotangents, from a cotangent on every buffer."""
    act2, n_buf = _MODES[mode]
    c, ref = k2_modes(mode)
    (rb_bufs, rb_dh, rb_dw), (rf_bufs, rf_dh, rf_dw) = (ref["bfloat16"],
                                                        ref[None])
    bufs, grads = _k2_port(c, act2, n_buf, BF)
    assert len(bufs) == n_buf and all(b.dtype == BF for b in bufs)
    ratios = []
    for b in range(bufs[0].shape[0]):
        for i, buf in enumerate(bufs):
            ratios.append(_rule(buf[b], rb_bufs[b][i], rf_bufs[b][i],
                                f"buf{i + 1}"))
    ratios.append(_rule(grads[0], rb_dh, rf_dh, "dh0x"))
    for name, got, rb, rf in zip(_COT, grads[1:], rb_dw, rf_dw):
        assert got.dtype == torch.float32
        ratios.append(_rule(got, rb, rf, name))
    assert max(ratios) > 0  # the two sides are not the same computation


def test_control_f32_fails_the_rule(k2_modes):
    """The rule bites: the port in float32 against JAX in bfloat16."""
    c, ref = k2_modes("flagship")
    bufs, _ = _k2_port(c, True, 3, None)
    with pytest.raises(AssertionError):
        _rule(bufs[1][0], ref["bfloat16"][0][0][1], ref[None][0][0][1],
              "buf2")


# -- K6-K10 with K8 and K4: the flagship's final step ------------------------

T_ONE = tfl.T_ONE


@pytest.fixture(scope="module")
def final_case():
    """fused_final_bi_loss (interpret) of one element in bfloat16 and in
    float32 on the same histories (rounded to bfloat16, given to JAX in
    bfloat16) and JAX's initial weights with the impute clamp open: (loss,
    grads of the parameters and of the six histories, the table), and the
    inputs and draws for the port."""
    data = jax.device_put(jax_synthetic(**tfl.DATA))
    rs = np.random.RandomState(3)
    N, d, L1 = data.num_ents, 16, tfl.KW["train_seq_len"] - 1
    hists = [np.asarray(jnp.asarray(rs.standard_normal((N, d)) * 0.5,
                                    jnp.bfloat16)) for _ in range(6)]
    lps = [rs.randint(0, L1, N).astype(np.float32) for _ in range(2)]
    t = T_ONE[0]
    k_drop, k_pos, k_sub = jax.random.split(jax.random.PRNGKey(20), 3)
    em_full = data.train.emask[t]
    em_enc = jax_subsample_edges(k_sub, em_full, 0.5)
    ref, params = {}, None
    for dt in ("bfloat16", "float32"):
        cfg = JaxConfig(fused_final=True, fused_window=True, dropout=0.1,
                        compute_dtype=dt, **tfl.KW)
        model = jax_get_model(cfg, data)
        params = tfl._open_impute(model.init_params(jax.random.PRNGKey(0)))
        hdt = jnp.float32 if dt == "float32" else jnp.bfloat16

        def f(p, *hs, cfg=cfg, model=model):
            h1f, h2f, hlf, h1b, h2b, hlb = hs
            return jax_ffb.fused_final_bi_loss(
                p, cfg, model.lc2, data, h1f, h2f, hlf, lps[0], h1b, h2b,
                hlb, lps[1], data.train.src[t], data.train.dst[t],
                data.train.rel[t], em_enc, em_full, t, k_drop, k_pos, True)

        # the table as layer 2's row program writes it
        tables = []
        call = jax_ffb._call_gru_fwd

        def recording(static, act, impute, args, call=call, tables=tables):
            out = call(static, act, impute, args)
            if impute:
                jax.debug.callback(lambda x: tables.append(_f32(x)), out)
            return out

        jax_ffb._call_gru_fwd = recording
        try:
            with _xla_unoptimized():
                loss, grads = jax.jit(jax.value_and_grad(
                    f, argnums=tuple(range(7))))(
                    params, *(jnp.asarray(h, hdt) for h in hists))
                jax.block_until_ready(grads)
        finally:
            jax_ffb._call_gru_fwd = call
        assert len(tables) == 1
        ref[dt] = (float(loss), grads, tables[0][:N])
    keep = 0.9
    draws = {"edges": em_enc, "pos": jax_subsample_pos(
        k_pos, em_full, tfl.KW["num_pos_facts"])}
    draws.update(zip(("fin1", "fin2"), (
        jax.random.bernoulli(k, keep, (N, d))
        for k in jax.random.split(k_drop))))
    draws = {k: torch.from_numpy(np.array(v)[None]) for k, v in
             draws.items()}
    return (jax.tree_util.tree_map(np.asarray, params), hists, lps, draws,
            ref)


@pytest.mark.parametrize("kernels", [True, False])
def test_final_step_matches_jax_bf16(final_case, kernels):
    """The loss, the table and the gradients of the six histories and of
    every parameter: ``FusedFinalBi`` in bfloat16 (K8's, K4's and
    K9+K10's plain versions; kernels=False all of them on any device)."""
    np_params, hists, lps, draws, ref = final_case
    loss_bf, grads_bf, table_bf = ref["bfloat16"]
    loss_f, grads_f, table_f = ref["float32"]
    cfg = TKGConfig(dropout=0.1, compute_dtype="bfloat16", **tfl.KW)
    host = make_synthetic(**tfl.DATA)
    data = to_device(host, "cpu")
    answers = to_device(build_answer_lists(host), "cpu")
    bg = fb.final_graph_bi(data, answers, torch.tensor(T_ONE), draws,
                           torch.from_numpy(lps[0])[None],
                           torch.from_numpy(lps[1])[None],
                           cfg.inv_temperature, 0.1, cfg.train_seq_len, True,
                           False)
    params = _torch_params(np_params)
    hs = [torch.from_numpy(_f32(h))[None].to(BF).requires_grad_(True)
          for h in hists]
    tables = []
    fwd_plain = fb.fused_final_bi_fwd_plain

    def recording(*a, **k):
        out = fwd_plain(*a, **k)
        tables.append(out[1].detach())
        return out

    fb.fused_final_bi_fwd_plain = recording
    try:
        loss = fb.fused_final_bi_loss(params, bg, hs, kernels=kernels,
                                      hot=BF)
    finally:
        fb.fused_final_bi_fwd_plain = fwd_plain
    loss.sum().backward()
    ratios = [_rule(loss.detach()[0], loss_bf, loss_f, "loss"),
              _rule(tables[0][0], table_bf, table_f, "table")]
    assert len(tables) == 1
    for i, h in enumerate(hs):
        assert h.grad.dtype == BF
        ratios.append(_rule(h.grad[0], grads_bf[i + 1], grads_f[i + 1],
                            f"hist {i}"))
    n = 0
    for path, ref_bf, got in _pairs(grads_bf[0], params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        ratios.append(_rule(grad, ref_bf, _lookup(grads_f[0], path), path))
        n += 1
    assert n == len(param_leaves(params))
    assert float(params["encoder"]["impute_w_fwd"].grad.abs()) > 0
    assert max(ratios) > 0


# -- the flagship trained two steps, then ranked -----------------------------

@torch.no_grad()
def _near_ties(model, params, data, ranks, ref_ranks, mask, t_eval):
    """The queries whose ranks differ from the reference's, each checked to
    have a competitor within NEAR_TIE of its target's score in the port's
    scores: their count."""
    ev = data.valid
    Q = ranks.shape[1] // 2
    n = 0
    for b, q in np.argwhere((ranks != ref_ranks) & mask):
        t, j = t_eval[b], q % Q
        s, r, o = (x[t, j].long() for x in (ev.src, ev.rel, ev.dst))
        table = model.forward_element(params, data, t)
        remb = params["rel_embeds"][r][None]
        sc, target = ((complex_all(table[o][None], remb, table, "head")[0], s)
                      if q < Q else
                      (complex_all(table[s][None], remb, table, "tail")[0],
                       o))
        gap = (sc - sc[target]).abs()
        gap[target] = float("inf")
        assert float(gap.min()) <= NEAR_TIE, (b, q, float(gap.min()))
        assert abs(int(ranks[b, q]) - int(ref_ranks[b, q])) <= int(
            (gap <= NEAR_TIE).sum())
        n += 1
    return n


def _flat(trees):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in trees])


def test_flagship_slice_trains_and_ranks_as_jax_bf16():
    """The flagship through Trainer.train_step for two Adam steps on the JAX
    package's draws, then a valid batch's ranks, on its main path: the
    windows through K2 and the final step through K6-K10 with K4 (their
    plain versions here; JAX's kernels in interpret mode). The losses and
    the trained parameters (all leaves as one vector) under the rule, the
    ranks equal but for counted near-ties."""
    kw = {**tfl.KW, "dropout": 0.0, "lr": 0.01, "fused_final": True,
          "fused_window": True}
    data = jax.device_put(jax_synthetic(**tfl.DATA))
    jcfg = JaxConfig(compute_dtype="bfloat16", **kw)
    jmodel = jax_get_model(jcfg, data)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = jax_make_optimizer(jcfg)
    state = opt.init(params)
    tp, tv = jnp.asarray(tfl.T_POS, jnp.int32), jnp.asarray([True, True])

    @jax.jit
    def step(params, state, rng):
        loss, grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, data, tp, tv, rng))(params)
        updates, state = opt.update(grads, state, params)
        return loss, optax.apply_updates(params, updates), state

    losses_bf = []
    with _xla_unoptimized():
        for k in (10, 11):
            loss, params, state = step(params, state, jax.random.PRNGKey(k))
            losses_bf.append(float(loss))
        ranks_bf, mask_bf = (np.asarray(x) for x in jax.jit(
            lambda p: jmodel.eval_ranks(p, data, jnp.asarray(EVAL_T,
                                                             jnp.int32),
                                        jnp.asarray([True] * 3),
                                        "valid"))(params)[:2])
    params_bf = jax.tree_util.tree_map(np.asarray, params)

    host = make_synthetic(**tfl.DATA)
    runs = {}
    for dt in ("bfloat16", "float32"):
        cfg = TKGConfig(compute_dtype=dt, **kw)
        model = get_model(cfg, host, device="cpu")
        assert model.fused_window_on(True) and model.fused_final_on()
        trainer = Trainer(cfg, model, host)
        p = _torch_params(init)
        optimizer = make_optimizer(cfg, p)
        losses = [float(trainer.train_step(
            p, optimizer, tfl.T_POS, [True, True],
            draws=tfl.jax_draws_bi(jcfg, data, tfl.T_POS,
                                   jax.random.PRNGKey(k))))
            for k in (10, 11)]
        runs[dt] = (losses, p, model)
    (losses, p, model), (losses_f, p_f, _) = runs["bfloat16"], runs["float32"]
    for i in range(2):
        _rule(losses[i], losses_bf[i], losses_f[i], f"loss {i}")
    pairs = list(_pairs(params_bf, p))
    _rule(_flat([got.detach().numpy() for _, _, got in pairs]),
          _flat([ref for _, ref, _ in pairs]),
          _flat([_lookup(p_f, path).detach().numpy() for path, _, _ in
                 pairs]), "trained parameters")
    dd = to_device(host, "cpu")
    with torch.no_grad():
        ranks, mask, _ = model.eval_ranks(p, dd, EVAL_T, [True] * 3, "valid")
    ranks, mask = ranks.numpy(), mask.numpy()
    np.testing.assert_array_equal(mask, mask_bf)
    assert _near_ties(model, p, dd, ranks, ranks_bf, mask, EVAL_T) <= 2


# -- TED, --post-aggregation, plain BiGRRGCN, the unidirectional --impute ----

_VARIANTS = ("ted", "bi_agg", "bi_plain", "uni_impute")
T_STEP = [5]


@pytest.mark.parametrize("variant", _VARIANTS)
def test_variant_step_and_ranks_match_jax_bf16(variant):
    """One step's loss and the gradient of every parameter, and an eval
    batch's ranks, on the CPU's default path of both packages (the JAX
    package's XLA scan and unfused final step; the port's windows step by
    step through K1 and its final step one element at a time), the gated
    scores in bfloat16.

    The step takes one element (T_STEP): a weight's gradient there is the
    cotangent of its bfloat16 cast, a float32 sum rounded to bfloat16, and
    the JAX package's vmap over a batch rounds the final step's sum once
    for the whole batch. The port's final step, one element at a time,
    rounds the parameters once for all its elements
    (``ops.gru.shared_rounding``), so that the two round the same sum;
    with one element no batch is summed at all."""
    flags = tpo.VARIANTS[variant][0]
    kw = {**tpo.KW, **flags}
    jcfg = JaxConfig(fused_window=False, fused_final=False,
                     compute_dtype="bfloat16", **kw)
    data = jax.device_put(jax_synthetic(**tpo.DATA))
    jmodel = jax_get_model(jcfg, data)
    host = make_synthetic(**tpo.DATA)
    model = get_model(TKGConfig(compute_dtype="bfloat16", **kw), host,
                      device="cpu")
    assert not model.fused_window_on(True) and not model.fused_final_on()
    params = tpo._open(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), model.init_params(0)), flags)
    tp, tv = jnp.asarray(T_STEP, jnp.int32), jnp.asarray([True])
    rng = jax.random.PRNGKey(1)

    def run(p):
        return (jax.value_and_grad(
            lambda q: jmodel.loss(q, data, tp, tv, rng))(p),
            jmodel.eval_ranks(p, data, jnp.asarray(EVAL_T, jnp.int32),
                              jnp.asarray([True] * 3), "valid")[:2])

    with _xla_unoptimized():
        (loss_bf, grads_bf), (ranks_bf, mask_bf) = jax.jit(run)(params)
    draws = tpo.jax_draws_scan(jcfg, data, T_STEP, rng)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    dd = to_device(host, "cpu")
    out = {}
    for dt in ("bfloat16", "float32"):
        m = get_model(TKGConfig(compute_dtype=dt, **kw), host, device="cpu")
        p = _torch_params(np_params)
        loss = m.loss(p, dd, T_STEP, [True], draws=draws)
        loss.backward()
        out[dt] = (float(loss.detach()), p, m)
    (loss, p, m), (loss_f, p_f, _) = out["bfloat16"], out["float32"]
    _rule(loss, float(loss_bf), loss_f, "loss")
    n = 0
    for path, ref, got in _pairs(grads_bf, p):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        f32 = _lookup(p_f, path).grad
        _rule(grad, ref, torch.zeros_like(grad) if f32 is None else f32, path)
        n += 1
    assert n == len(param_leaves(p))
    with torch.no_grad():
        ranks, mask, _ = m.eval_ranks(p, dd, EVAL_T, [True] * 3, "valid")
    ranks, mask = ranks.numpy(), mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(mask_bf))
    assert _near_ties(m, p, dd, ranks, np.asarray(ranks_bf), mask,
                      EVAL_T) <= 2


# -- the kernels' bfloat16 launches, rehearsed without a card ----------------

def test_bf16_flagship_launches_match_the_library_signatures(monkeypatch):
    """With the device checks and the library replaced by a recorder, one
    bfloat16 training loss of the flagship and its backward (K2 in the
    flagship's mode for both windows, the fused final step) call the
    kernels' bfloat16 launchers (``name_bf16``), each with the arguments
    ``_build.SIGNATURES`` declares for ``name``, in the float32 path's order
    and number: K2f 2 a step and window, K6+K7 2, K8 2, K4 4, K9+K10 10, K2b
    5 a step and 2 a window; the float32 sums (the weights', the
    relations') are the float32 launchers."""
    import ctypes

    from temp_tpu_torch import _build

    kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
             ctypes.c_float: float, ctypes.c_longlong: int}
    calls = []

    class Recorder:
        def __getattr__(self, name):
            base = name[:-len("_bf16")] if name.endswith("_bf16") else name
            assert (base in _build.BF16_LAUNCHERS) == (name != base), name
            sig = _build.SIGNATURES[base]

            def launch(*args):
                assert len(args) == len(sig), name
                for a, t in zip(args, sig):
                    assert isinstance(a, kinds[t]) and not isinstance(
                        a, bool), (name, a)
                calls.append(name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    for mod in (fw, ff, fb):
        monkeypatch.setattr(mod, "_device", lambda name, t: "cuda")
    cfg = TKGConfig(fused_final=True, fused_window=True, dropout=0.1,
                    compute_dtype="bfloat16", **tfl.KW)
    data = make_synthetic(**tfl.DATA)
    model = get_model(cfg, data, device="cpu")
    params = model.init_params(0)
    for p in param_leaves(params):
        p.requires_grad_(True)
    owners = (fw.fused_window_fwd, fw.fused_window_bwd, fb.bi_layer_fwd,
              fb.bi_loss_fwd, ff.fused_final_bwd_loss, fb.bi_layer_bwd,
              ff.fused_final_fwd, ff.fused_final_bwd_layer)
    before = {f.__name__: f.launches for f in owners}
    loss = model.loss(params, to_device(data, "cpu"), tfl.T_POS,
                      [True, False], gen=torch.Generator().manual_seed(0))
    loss.backward()
    L1 = cfg.train_seq_len - 1
    layer_bwd = ["bi_bwd_gru_launch_bf16", "final_bwd_input_launch_bf16",
                 "bi_wgrad_launch_bf16", "final_wgrad_reduce_launch",
                 "final_rel_grad_launch"]
    k2b = (["window_bwd_gru_launch_bf16", "window_bwd_input_launch_bf16"] * 2
           + ["window_wgrad_launch_bf16"]) * L1 + [
        "window_wgrad_reduce_launch", "window_rel_grad_launch"]
    head = (["window_layer_launch_bf16"] * 4 * L1
            + ["bi_layer_launch_bf16"] * 2
            + ["final_scores_launch_bf16", "final_loss_reduce_launch_bf16",
               "final_dq_launch_bf16", "final_dq_finish_launch_bf16",
               "final_dtable_launch_bf16", "final_rel_grad_launch"]
            + layer_bwd + layer_bwd)
    assert calls == head + k2b + k2b
    after = {f.__name__: f.launches for f in owners}
    assert {k: after[k] - before[k] for k in after} == {
        "fused_window_fwd": 4 * L1, "fused_window_bwd": 2 * (5 * L1 + 2),
        "bi_layer_fwd": 2, "bi_loss_fwd": 2, "fused_final_bwd_loss": 4,
        "bi_layer_bwd": 10, "fused_final_fwd": 0,
        "fused_final_bwd_layer": 0}


# -- the CLI ------------------------------------------------------------------

def test_cli_trains_and_evaluates_the_flagship_in_bf16(tmp_path, capsys,
                                                       one_thread):
    """``python -m temp_tpu_torch.main --compute-dtype bfloat16 --module
    BiGRRGCN --impute --fast-dev-run`` (in this process) trains an epoch of
    the flagship with its fused final step's plain versions
    (``--fused-final on``) and evaluates it; the run's config keeps the
    dtype."""
    import json

    root = tt._write_dataset(tmp_path / "data")
    out = tt.run_cli(
        ["-c", os.path.join(tt.ROOT, "grid", "icews14", "config_grrgcn.json"),
         "--module", "BiGRRGCN", "--impute", "--device", "cpu",
         "--fast-dev-run", "--data-root", root, "--dataset", "tiny",
         "--edge-pad-multiple", "16", "--embed-size", "16",
         "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
         "--batch-size", "2", "--fused-final", "on",
         "--compute-dtype", "bfloat16",
         "--experiments-dir", str(tmp_path / "runs"), "--model-name", "bf"],
        capsys)
    assert "module=BiGRRGCN" in out
    assert "epoch 0:" in out and "test: mrr=" in out
    run = tmp_path / "runs" / "bf"
    assert json.load(open(run / "config.json"))["compute_dtype"] == \
        "bfloat16"
    test = json.load(open(run / "test_metrics.json"))
    assert test["n"] > 0 and 0.0 < test["mrr"] <= 1.0
