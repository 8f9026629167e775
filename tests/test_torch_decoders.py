"""The decoders (ComplEx, DistMult, TransE), the negative samplers and the
loss's candidate pools ("all", "shared", "per_query") of temp_tpu_torch
against the JAX package on the CPU, float32.

The decoders and the loss of one snapshot run on the same numpy inputs in
both packages. The samplers draw from a torch.Generator, which cannot
replay the JAX package's threefry bits: their own tests hold invariants
and distributions, and the pool parity hands the JAX draws to the port,
each rebuilt by the key derivation of the JAX losses (split(rng, B) per
element; split -> (r_fwd, r_loss); split(r_loss, 3) -> (k_pos, k_tail,
k_head), the samplers called with k_tail and k_head;
temp_tpu/models/objectives.py).

Every pool with every decoder runs through three whole models: GRRGCN, the
unidirectional TED gate (GRRGCN --impute --post-ensemble) and SARGCN. The
JAX side is its own loss taken apart by the chain rule, one compile a
model: the model's tables of each target (forward_element, or
forward_tables under the gate, with the key r_fwd) and their vjp compiled
once, and the decoder's and pool's loss of those tables (the JAX package's
train_loss_single or _gated_loss with r_loss) differentiated op by op for
each case, its cotangents carried back through the compiled vjp.

Tolerances: 1e-5 relative to max(1, the largest entry) for scores, losses
and gradients (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.objectives import train_loss_single as jax_loss_single
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops import scores as jsc
from temp_tpu.ops.sampling import draw_negatives as jax_draw_negatives
from temp_tpu.ops.sampling import (
    draw_shared_negatives as jax_draw_shared,
)
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, to_device
from temp_tpu_torch.models.objectives import train_loss_single
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import scores as sc
from temp_tpu_torch.ops.sampling import (
    draw_negatives, draw_shared_negatives, shared_bad,
)
from test_torch_post import _open, _xla_unoptimized, jax_draws_scan
from test_torch_selfattn import jax_draws_sa
from test_torch_train import _close, _pairs, _torch_params

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=3,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1,
          negative_rate=8, neg_oversample=8)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
T_POS = [5, 2]
DECODERS = ("complex", "distmult", "transE")


POOLS = ("all", "shared", "per_query")
MODELS = {"grrgcn": {"module": "GRRGCN"},
          "ted": {"module": "GRRGCN", "impute": True, "post_ensemble": True},
          "sargcn": {"module": "SARGCN"}}


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile
    and run op by op (``_xla_unoptimized``)."""
    with _xla_unoptimized():
        yield



def jax_loss_draws(cfg, data, t: int, r_loss):
    """The draws of the JAX package's loss of target t from its key r_loss,
    split into (k_pos, k_tail, k_head): the positives [E] bool and the
    candidates (neg_tail, neg_head) of cfg.negative_pool (None under
    "all"), as the port's tensors."""
    k_pos, k_tail, k_head = jax.random.split(r_loss, 3)
    r2, tr = 2 * data.num_rels, data.train
    pos = torch.from_numpy(np.array(jax_subsample_pos(
        k_pos, tr.emask[t], cfg.num_pos_facts)))
    if cfg.negative_pool == "all":
        return pos, None
    src, rel, dst = tr.src[t], tr.rel[t], tr.dst[t]
    neg = []
    for k, tbl, grp, ent in ((k_tail, data.train_tail, src * r2 + rel, dst),
                             (k_head, data.train_head, dst * r2 + rel, src)):
        if cfg.negative_pool == "shared":
            got = jax_draw_shared(k, tbl.grp[t], tbl.val[t], grp,
                                  data.num_ents, cfg.negative_rate)[0]
        else:
            got = jax_draw_negatives(k, tbl.grp[t], tbl.val[t], grp, ent,
                                     data.num_ents, cfg.negative_rate,
                                     cfg.neg_oversample)
        neg.append(torch.from_numpy(np.array(got)).long())
    return pos, tuple(neg)


def jax_draws_neg(cfg, data, t_pos, rng, split_fwd: bool = True):
    """The JAX package's negative candidates of the targets t_pos as the
    port's "neg_tail"/"neg_head" draws (None under "all"): element b's
    r_loss is split(split(rng, B)[b])[1], or split(rng, B)[b] itself
    without `split_fwd` (the baselines' and the Aggregator's losses)."""
    negs = [jax_loss_draws(cfg, data, t, jax.random.split(r)[1]
                           if split_fwd else r)[1]
            for t, r in zip(t_pos, jax.random.split(rng, len(t_pos)))]
    if negs[0] is None:
        return {"neg_tail": None, "neg_head": None}
    return {"neg_tail": torch.stack([n[0] for n in negs]),
            "neg_head": torch.stack([n[1] for n in negs])}


# -- the decoders -------------------------------------------------------------

def _chunked_l1(q, table, chunk=7):
    """-|q[p] - table[n]|_1 by the JAX package's chunked broadcast."""
    return torch.cat([-(q[i:i + chunk, None, :] - table[None]).abs().sum(-1)
                      for i in range(0, q.shape[0], chunk)])


@pytest.mark.parametrize("name", DECODERS)
def test_decoder_matches_reference(name):
    rs = np.random.RandomState(0)
    P, N, C, d = 13, 29, 6, 16
    s, r, o = (rs.randn(P, d).astype(np.float32) for _ in range(3))
    table = rs.randn(N, d).astype(np.float32)
    cand = rs.randint(0, N, (P, C))
    ja, js = jsc.get_score_fn(name)
    ta, ts = sc.get_score_fn(name)
    t = [torch.from_numpy(x) for x in (s, r, o, table)]
    _close(ts(*t[:3]).numpy(), js(s, r, o), "single")
    for mode in ("tail", "head"):
        ref = np.asarray(ja(s, r, table, mode))
        _close(ta(t[0], t[1], t[3], mode).numpy(), ref, mode)
        query = sc.query_for(ta, t[0], t[1], mode)
        jq = jsc.query_for(ja, s, r, mode)
        assert query[1] == jq[1] == ("l1" if name == "transE" else "dot")
        _close(query[0].numpy(), jq[0], "query")
        _close(sc.table_scores(query, t[3]).numpy(),
               jsc.table_scores(jq, table), "table")
        _close(sc.row_scores(query, t[2]).numpy(),
               jsc.row_scores(jq, o), "rows")
        _close(sc.score_against_rows(ta, t[0], t[1], t[3][:C], mode).numpy(),
               jsc.score_against_rows(ja, s, r, table[:C], mode), "shared")
        _close(sc.score_positive_rows(ta, t[0], t[1], t[2], mode).numpy(),
               jsc.score_positive_rows(ja, s, r, o, mode), "positive")
        _close(sc.score_candidates_all(ta, t[0], t[1], t[3],
                                       torch.from_numpy(cand), mode).numpy(),
               jsc.score_candidates_all(ja, s, r, table, cand, mode),
               "candidates")
        if name == "transE":
            # cdist against the chunked broadcast, and their gradients
            qa = query[0].clone().requires_grad_(True)
            qb = query[0].clone().requires_grad_(True)
            ga = torch.randn(P, N, generator=torch.Generator().manual_seed(1))
            (sc.l1_scores(qa, t[3]) * ga).sum().backward()
            (_chunked_l1(qb, t[3]) * ga).sum().backward()
            _close(qa.grad.numpy(), qb.grad.numpy(), "l1 grad")


def test_simple_single_and_unknown_decoder():
    rs = np.random.RandomState(1)
    xs = [rs.randn(7, 8).astype(np.float32) for _ in range(6)]
    _close(sc.simple_single(*map(torch.from_numpy, xs)).numpy(),
           jsc.simple_single(*xs), "simple")
    # the JAX package has no SimplE decoder: an unknown name raises
    for name in ("simple", "SimplE", "rotate"):
        with pytest.raises(KeyError):
            sc.get_score_fn(name)


# -- the samplers ---------------------------------------------------------------

def _filter(rs, n_groups, n_ents, per):
    """A sorted filter table of `per` true answers for each of n_groups
    groups (grp, val [F] long) and its Python sets."""
    pairs = sorted({(g, int(v)) for g in range(n_groups)
                    for v in rs.choice(n_ents, per, replace=False)})
    grp = torch.tensor([p[0] for p in pairs])
    val = torch.tensor([p[1] for p in pairs])
    sets = {g: {v for gg, v in pairs if gg == g} for g in range(n_groups)}
    return grp, val, sets


def test_per_query_sampler_invariants():
    rs = np.random.RandomState(0)
    N, G, K, os_ = 40, 5, 12, 6
    grp, val, sets = _filter(rs, G, N, 6)
    q = torch.from_numpy(rs.randint(0, G, 64))
    pos = torch.from_numpy(rs.randint(0, N, 64))
    gen = torch.Generator().manual_seed(3)
    cand = draw_negatives(gen, grp, val, q, pos, N, K, os_)
    assert cand.shape == (64, 1 + K) and cand.dtype == torch.int64
    assert torch.equal(cand[:, 0], pos)
    # the draws replayed: where the spare at k % oversample is valid, no
    # candidate is a true answer; elsewhere the main draw stays
    draws = torch.randint(0, N, (64, K + os_),
                          generator=torch.Generator().manual_seed(3))
    for p in range(64):
        bad = sets[int(q[p])]
        for k in range(K):
            main, spare = int(draws[p, k]), int(draws[p, K + k % os_])
            want = spare if (main in bad and spare not in bad) else main
            assert int(cand[p, 1 + k]) == want
            if spare not in bad:
                assert int(cand[p, 1 + k]) not in bad
    # the same seed, the same draws
    again = draw_negatives(torch.Generator().manual_seed(3), grp, val, q,
                           pos, N, K, os_)
    assert torch.equal(again, cand)


def test_per_query_strict_keeps_first_valid_in_draw_order():
    rs = np.random.RandomState(1)
    N, G, K, os_ = 12, 3, 5, 7
    # a handmade table: most entities are true answers of group 0
    grp, val, sets = _filter(rs, G, N, 8)
    q = torch.tensor([0, 1, 2, 0])
    pos = torch.tensor([3, 4, 5, 6])
    cand = draw_negatives(torch.Generator().manual_seed(5), grp, val, q, pos,
                          N, K, os_, strict=True)
    draws = torch.randint(0, N, (4, K + os_),
                          generator=torch.Generator().manual_seed(5))
    for p in range(4):
        valid = [int(v) for v in draws[p] if int(v) not in sets[int(q[p])]]
        want = (valid + [0] * K)[:K]
        assert cand[p, 1:].tolist() == want, (p, draws[p].tolist())
        assert int(cand[p, 0]) == int(pos[p])


def test_per_query_columns_are_uniform():
    """Chi-square over the entities of the candidates of a group with no
    true answer: uniform at the 0.1% level."""
    N, K, P = 20, 50, 400
    grp, val = torch.tensor([9]), torch.tensor([0])
    cand = draw_negatives(torch.Generator().manual_seed(11), grp, val,
                          torch.zeros(P, dtype=torch.long),
                          torch.zeros(P, dtype=torch.long), N, K, 8)
    counts = np.bincount(cand[:, 1:].reshape(-1).numpy(), minlength=N)
    expect = P * K / N
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 43.8  # chi-square, 19 degrees of freedom, p = 0.001


def test_shared_sampler_bad_is_set_membership():
    rs = np.random.RandomState(2)
    N, G, K = 25, 6, 30
    grp, val, sets = _filter(rs, G, N, 5)
    q = torch.from_numpy(rs.randint(0, G + 2, 40))  # some groups empty
    pool, bad = draw_shared_negatives(torch.Generator().manual_seed(7), grp,
                                      val, q, N, K)
    assert pool.shape == (K,) and bad.shape == (40, K)
    want = [[int(v) in sets.get(int(g), set()) for v in pool] for g in q]
    assert bad.tolist() == want
    assert bad.any() and not bad.all()
    pool2, _ = draw_shared_negatives(torch.Generator().manual_seed(7), grp,
                                     val, q, N, K)
    assert torch.equal(pool, pool2)
    # the leading batch dimension of the draws of a training step
    bb = shared_bad(grp[None].expand(2, -1), val[None].expand(2, -1),
                    q[None].expand(2, -1), N, torch.stack([pool, pool]))
    assert torch.equal(bb[1], bad)


# -- the loss of a batch's tables: every decoder, every pool -----------------

@pytest.fixture(scope="module")
def jax_losses():
    """(decoder, pool, gated) -> the JAX package's loss of the tables of
    the targets T_POS (train_loss_single of each [N, d] table, or under the
    gate TED's _gated_loss of each (loc, rec) pair), summed, with its
    gradient, op by op: f(small, tables, key), small
    {"rel_embeds"[, "gates"]}, element b's loss key split(split(key,
    B)[b])[1] as the JAX losses split it; built on first use and shared
    by every model with such tables."""
    data = jax.device_put(jax_synthetic(**DATA))
    cache = {}

    def get(name, pool, gated):
        k = (name, pool, gated)
        if k not in cache:
            flags = MODELS["ted" if gated else "grrgcn"]
            cfg = JaxConfig(score_function=name, negative_pool=pool, **KW,
                            **flags)
            tr, score_all = data.train, jsc.get_score_fn(name)[0]
            model = jax_get_model(cfg, data) if gated else None

            def one(small, tab, t, r_loss):
                if gated:
                    return model._gated_loss(small, data, t, tab[0], tab[1],
                                             r_loss)
                return jax_loss_single(cfg, data, score_all,
                                       small["rel_embeds"], tab, t,
                                       tr.src[t], tr.rel[t], tr.dst[t],
                                       tr.emask[t], r_loss)

            def f(small, tables, key):
                return sum(one(small, jax.tree_util.tree_map(
                    lambda x: x[b], tables), jnp.int32(t),
                    jax.random.split(r)[1])
                    for b, (t, r) in enumerate(zip(
                        T_POS, jax.random.split(key, len(T_POS)))))

            cache[k] = (cfg, data, jax.value_and_grad(f, argnums=(0, 1)))
        return cache[k]

    return get


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("name", DECODERS)
def test_pool_loss_matches_reference(jax_losses, name, pool):
    """Both targets' tail+head cross-entropy of random tables, against the
    JAX package's train_loss_single, loss and gradients."""
    cfg, jdata, run = jax_losses(name, pool, False)
    rs = np.random.RandomState(4)
    table = rs.randn(len(T_POS), DATA["num_ents"], 16).astype(
        np.float32) * 0.3
    rel = rs.randn(2 * DATA["num_rels"], 16).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(3)
    ref, (g_small, g_tab) = run({"rel_embeds": rel}, table, key)
    data = to_device(make_synthetic(**DATA), "cpu")
    rl, tb = (torch.from_numpy(x).requires_grad_(True) for x in (rel, table))
    tcfg = TKGConfig(score_function=name, negative_pool=pool, **KW)
    got = 0.0
    for b, (t, r) in enumerate(zip(T_POS, jax.random.split(key, 2))):
        pos, neg = jax_loss_draws(cfg, jdata, t, jax.random.split(r)[1])
        tr = data.train
        got = got + train_loss_single(tcfg, data, sc.get_score_fn(name)[0],
                                      rl, tb[b], t, tr.src[t], tr.rel[t],
                                      tr.dst[t], pos, neg)
    got.backward()
    _close(got.item(), float(ref), "loss")
    _close(rl.grad.numpy(), g_small["rel_embeds"], "d rel")
    _close(tb.grad.numpy(), g_tab, "d table")


# -- whole models: every pool with every decoder -----------------------------

def _port(tag, name="complex", pool="all"):
    cfg = TKGConfig(fused_window=True, fused_final=True, score_function=name,
                    negative_pool=pool, **KW, **MODELS[tag])
    data = make_synthetic(**DATA)
    return cfg, data, get_model(cfg, data, device="cpu")


@pytest.fixture(scope="module")
def jax_tables():
    """model tag -> the JAX model, config, data and params (the port's
    seeded init), "out": its tables of each target of T_POS in training
    ([B, N, d], or (loc, rec) under the gate) at key 1, and "bwd": their
    vjp (params, key, cotangent) -> the params' cotangent; one compile
    each, on first use."""
    cache = {}

    def get(tag):
        if tag not in cache:
            flags = MODELS[tag]
            cfg = JaxConfig(fused_window=False, fused_final=False, **KW,
                            **flags)
            data = jax.device_put(jax_synthetic(**DATA))
            model = jax_get_model(cfg, data)
            own = _port(tag)[2].init_params(0)
            params = _open(jax.tree_util.tree_map(
                lambda t: jnp.asarray(t.numpy()), own), flags)
            tp = jnp.asarray(T_POS, jnp.int32)
            fwd_fn = (model.forward_tables if cfg.post_ensemble
                      else model.forward_element)

            def tables(p, r):
                # r_fwd of each element, as the JAX losses split it
                return jax.vmap(lambda t, rr: fwd_fn(
                    p, data, t, True, jax.random.split(rr)[0]))(
                        tp, jax.random.split(r, len(T_POS)))

            def bwd(p, r, ct):
                return jax.vjp(lambda q: tables(q, r), p)[1](ct)[0]

            key = jax.random.PRNGKey(1)
            with _xla_unoptimized():
                out = jax.jit(tables).lower(params, key).compile()(params,
                                                                   key)
                bwd = jax.jit(bwd).lower(params, key, out).compile()
            cache[tag] = dict(cfg=cfg, data=data, model=model, key=key,
                              params=params, out=out, bwd=bwd)
        return cache[tag]

    return get


def _jax_case(js, losses, name, pool):
    """(loss, grads) of the JAX model of `js` with decoder `name` and pool
    `pool`: the loss of its compiled tables (`losses`, op by op), its
    cotangents carried back through the compiled vjp."""
    gated = js["cfg"].post_ensemble
    params = js["params"]
    small = {k: params[k] for k in ("rel_embeds", "gates") if k in params}
    loss, (g_small, ct) = losses(name, pool, gated)[2](small, js["out"],
                                                       js["key"])
    grads = dict(js["bwd"](params, js["key"], ct))
    for k, g in g_small.items():
        grads[k] = jax.tree_util.tree_map(jnp.add, grads[k], g)
    return float(loss), grads


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("name", DECODERS)
@pytest.mark.parametrize("tag", list(MODELS))
def test_model_pools_match_reference(jax_tables, jax_losses, tag, name,
                                     pool):
    js = jax_tables(tag)
    ref_loss, ref_grads = _jax_case(js, jax_losses, name, pool)
    cfg, data, model = _port(tag, name, pool)
    params = _torch_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    jcfg = js["cfg"].replace(negative_pool=pool)
    draws = (jax_draws_sa if tag == "sargcn" else jax_draws_scan)(
        jcfg, js["data"], T_POS, js["key"])
    draws.update(jax_draws_neg(jcfg, js["data"], T_POS, js["key"]))
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=draws)
    loss.backward()
    _close(loss.item(), ref_loss, "loss")
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref_grads)) > 3
