"""The linear-recurrence models (RRGCN, BiRRGCN), the static ones (SRGCN,
DRGCN) and the recurrent models' options (type1, learnable_lambda,
use_time_embedding, rec_only_last_layer, random_dropout, DropEdge's
edge_dropout) of temp_tpu_torch against the JAX package on the CPU,
float32.

The JAX models run with fused_window and fused_final off: the windows on
its XLA scan, the final steps one element at a time. The port runs with
both switches on, so the configs inside their envelopes take the plain
versions of K2 (eval), K3-K5 (GRRGCN under random_dropout or DropEdge) and
K6-K10 (BiGRRGCN --impute under DropEdge), the others its step-by-step
windows and element loop. Every graph product is K1's plain version over
the data's static tables. The JAX draws are rebuilt by
``test_torch_post.jax_draws_scan`` (the windows' edge keys, with the JAX
model's DropEdge rates) and, for the static models, ``jax_draws_static``
(temp_tpu/models/static.py: split(r_fwd) -> (k_sub, k_fwd), the self-loop
keys split(k_fwd)).

Tolerances: the layers, the type1 cell and the decay within 1e-6; the
drop rates and the features equal; losses, gradients and parameters
within 1e-5 relative to max(1, the largest entry) (float32 sums in another
order); eval ranks equal and MRR within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.frequency import build_freq_features as jax_freq
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models import layers as jax_layers
from temp_tpu.models.dynamic import gather_window as jax_gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops import gru as jax_gru
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.frequency import build_drop_rates
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models import layers
from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel
from temp_tpu_torch.models.dynamic import DynamicRGCNModel, gather_window
from temp_tpu_torch.models.objectives import metrics_from_ranks
from temp_tpu_torch.models.post import PostBiDynamicRGCNModel
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.models.static import DRGCNModel, StaticRGCNModel
from temp_tpu_torch.ops import gru
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
from test_torch_post import _open as open_impute
from test_torch_post import _xla_unoptimized, jax_draws_scan
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import (
    _close, _pairs, _torch_params, _write_dataset, run_cli,
)

# the port's side on one intra-op thread (``one_thread``)
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=3,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1, lr=0.01)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
T_POS = [5, 1]
GRU = {"module": "GRRGCN"}
# each config's flags, the port's class and whether training runs a fused
# final step (K3-K5, or the flagship's K6-K10)
VARIANTS = {
    "rrgcn": ({"module": "RRGCN"}, DynamicRGCNModel, False),
    "birrgcn": ({"module": "BiRRGCN"}, BiDynamicRGCNModel, False),
    "srgcn": ({"module": "SRGCN"}, StaticRGCNModel, False),
    "drgcn": ({"module": "DRGCN", "use_time_embedding": True,
               "use_embed_for_non_active": True}, DRGCNModel, False),
    "type1_lambda_temb": ({**GRU, "type1": True, "learnable_lambda": True,
                           "use_time_embedding": True}, DynamicRGCNModel,
                          False),
    "rec_only": ({**GRU, "rec_only_last_layer": True}, DynamicRGCNModel,
                 False),
    "edge_dropout": ({**GRU, "edge_dropout": True}, DynamicRGCNModel, True),
    "random_dropout": ({**GRU, "random_dropout": True}, DynamicRGCNModel,
                       True),
    "bi_impute_edge_dropout": ({"module": "BiGRRGCN", "impute": True,
                                "edge_dropout": True},
                               PostBiDynamicRGCNModel, True),
    "bi_aggregation_temb": ({"module": "BiGRRGCN", "post_aggregation": True,
                             "use_time_embedding": True, "type1": True},
                            PostBiDynamicRGCNModel, False),
    "rrgcn_random_dropout": ({"module": "RRGCN", "random_dropout": True},
                             DynamicRGCNModel, False),
    "birrgcn_options": ({"module": "BiRRGCN", "rec_only_last_layer": True,
                         "use_time_embedding": True, "learnable_lambda": True,
                         "edge_dropout": True}, BiDynamicRGCNModel, False),
}


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- the type1 cell, the linear-recurrent layers and the decay ---------------

def test_type1_gru_cell_matches_reference():
    rs = np.random.RandomState(0)
    p = {"w_ih": rs.standard_normal((8, 6)), "w_hh":
         rs.standard_normal((24, 8)), "b_ih": rs.standard_normal(8),
         "b_hh": rs.standard_normal(24)}
    p = {k: (v * 0.3).astype(np.float32) for k, v in p.items()}
    x = rs.standard_normal((11, 6)).astype(np.float32)
    h = rs.standard_normal((11, 8)).astype(np.float32)
    ref = np.asarray(jax_gru.type1_gru_cell(
        {k: _j(v) for k, v in p.items()}, _j(x), _j(h)))
    got = gru.type1_gru_cell({k: _t(v) for k, v in p.items()}, _t(x), _t(h))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # run_gru picks the cell by the config
    cfg = TKGConfig(type1=True)
    np.testing.assert_array_equal(
        gru.run_gru(cfg, [{k: _t(v) for k, v in p.items()}], _t(x),
                    _t(h)).numpy(), got.numpy())
    # the init: standard normal, the reference's shapes
    own = gru.init_type1_gru_params(torch.Generator().manual_seed(0), 6, 8)
    ref_p = jax_gru.init_type1_gru_params(jax.random.PRNGKey(0), 6, 8)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: np.shape(v) for k, v in ref_p.items()}
    allw = torch.cat([v.flatten() for v in own.values()])
    assert 0.7 < float(allw.std()) < 1.3


@pytest.mark.parametrize("learnable", [False, True])
def test_decay_factor_matches_reference(learnable):
    dt = np.arange(6, dtype=np.float32)
    p = {"decay_w": np.float32(0.4), "decay_b": np.float32(-0.9)}
    ref = np.asarray(jax_layers.decay_factor(
        {k: _j(v) for k, v in p.items()},
        JaxConfig(learnable_lambda=learnable), _j(dt)))
    got = layers.decay_factor({k: _t(v) for k, v in p.items()},
                              TKGConfig(learnable_lambda=learnable), _t(dt))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # the clamp shuts for the first time differences
    assert (got.numpy()[:3] == 1.0).all() == learnable


def _layer_case(seed=0, N=12, E=20, R2=6, d=8):
    rs = np.random.RandomState(seed)
    f = lambda *s: (rs.standard_normal(s) * 0.4).astype(np.float32)  # noqa
    p = {"weight": f(R2, d), "loop_weight": f(d, d), "h_bias": f(d),
         "time_embed": f(5, d), "time_weight": f(d, d),
         "time_weight_fwd": f(d, d), "time_weight_bwd": f(d, d),
         "decay_w": np.float32(0.3), "decay_b": np.float32(-0.2)}
    g = dict(src=rs.randint(0, N, E).astype(np.int32),
             dst=rs.randint(0, N, E).astype(np.int32),
             rel=rs.randint(0, R2, E).astype(np.int32),
             emask=rs.rand(E) < 0.8)
    dts = [rs.randint(0, 4, N).astype(np.float32) for _ in range(2)]
    return p, g, f(N, d), f(N, d), f(N, d), dts


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("learnable", [False, True])
def test_rrgcn_layers_match_reference(act, learnable):
    p, g, h, prev_f, prev_b, (dt_f, dt_b) = _layer_case()
    d, R2 = h.shape[1], p["weight"].shape[0]
    kw = dict(in_feat=d, out_feat=d, num_rels2=R2, n_bases=d, num_times=5,
              bias=True, activation=act)
    jcfg = JaxConfig(learnable_lambda=learnable, inv_temperature=0.3)
    cfg = TKGConfig(learnable_lambda=learnable, inv_temperature=0.3)
    jp, tp = {k: _j(v) for k, v in p.items()}, {k: _t(v)
                                                 for k, v in p.items()}
    jsnap = jax_layers.Snapshot(t_idx=jnp.int32(3), valid=True, active=None,
                                **{k: _j(v) for k, v in g.items()})
    snap = layers.Snapshot(t_idx=3, **{k: _t(v) for k, v in g.items()})
    lc, jlc = layers.LayerCfg(**kw), jax_layers.LayerCfg(**kw)
    for direction in (None, "fwd", "bwd"):
        ref = jax_layers.rrgcn_layer(jp, jcfg, jlc, _j(h), jsnap,
                                     _j(prev_f), _j(dt_f), False, None,
                                     direction=direction)
        got = layers.rrgcn_layer(tp, cfg, lc, _t(h), snap, _t(prev_f),
                                 _t(dt_f), direction=direction)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    ref = jax_layers.birrgcn_layer_center(
        jp, jcfg, jlc, _j(h), jsnap, _j(prev_f), _j(dt_f), _j(prev_b),
        _j(dt_b), False, None)
    got = layers.birrgcn_layer_center(tp, cfg, lc, _t(h), snap, _t(prev_f),
                                      _t(dt_f), _t(prev_b), _t(dt_b))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    # the time embedding of G graphs side by side, each to its rows
    x = _t(h)
    temb = tp["time_embed"][torch.tensor([1, 4])]
    y = layers.plus_time_embedding(x, temb)
    np.testing.assert_array_equal(y[:6].numpy(), (x[:6] + temb[0]).numpy())
    np.testing.assert_array_equal(y[6:].numpy(), (x[6:] + temb[1]).numpy())


# -- DropEdge's rates --------------------------------------------------------

@pytest.mark.parametrize("seq_len", [3, 5])
def test_drop_rates_match_reference(seq_len):
    """Both directions, two window lengths, rate bounds and lambdas other
    than the defaults: equal to the JAX package's."""
    kw = dict(rate_lower=0.1, rate_upper=0.7, lambda_1=3.0, lambda_2=5.0,
              lambda_3=7.0)
    for future in (False, True):
        ref = jax_freq(jax_synthetic(**DATA), seq_len, future,
                       with_drop_rates=True, **kw)
        past, fut = build_drop_rates(make_synthetic(**DATA), seq_len,
                                     future, **kw)
        for got, name in ((past, "drop_rate_past"),
                          (fut, "drop_rate_future")):
            want = np.asarray(getattr(ref, name))
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, name)
        # every tier and the floor occur
        assert len(np.unique(past[past > 0])) > 3
        assert (past == 0.1).any()
        assert (fut > 0).any() == future


# -- each config's loss, gradients and eval ranks ----------------------------

def jax_draws_static(cfg, data, t_pos, rng):
    """Every draw of the JAX package's static models' loss: split(rng, B)
    per element; split -> (r_fwd, r_loss); split(r_fwd) -> (k_sub, k_fwd);
    the edge subsample from k_sub; the self-loop keys split(k_fwd) at
    (N, d); the positives from split(r_loss, 3)[0]."""
    N, d, keep = data.num_ents, cfg.embed_size, 1.0 - cfg.dropout
    out = {k: [] for k in ("fin1", "fin2", "edges", "pos")}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        k_sub, k_fwd = jax.random.split(r_fwd)
        for key, k in zip(("fin1", "fin2"), jax.random.split(k_fwd)):
            out[key].append(np.asarray(jax.random.bernoulli(k, keep, (N, d))))
        em = data.train.emask[t]
        out["edges"].append(np.asarray(jax_subsample_edges(k_sub, em, 0.5)))
        out["pos"].append(np.asarray(jax_subsample_pos(
            jax.random.split(r_loss, 3)[0], em, cfg.num_pos_facts)))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}
    return {**draws, "win1": None, "win2": None, "win_edges": None}


def _draws(js, t_pos, rng):
    cfg, model = js["cfg"], js["model"]
    if cfg.module in ("SRGCN", "DRGCN"):
        return jax_draws_static(cfg, js["data"], t_pos, rng)
    return jax_draws_scan(cfg, js["data"], t_pos, rng,
                          (model.drop_past, model.drop_future))


def _open(params, flags):
    """The JAX params with decay scalars whose clamp is open for some of
    the windows' time differences and shut for others, and open impute
    scalars (``test_torch_post._open``)."""
    params = open_impute(params, flags)
    if not flags.get("learnable_lambda"):
        return params
    enc = dict(params["encoder"])
    for name in ("layer1", "layer2"):
        if "decay_w" in enc[name]:
            enc[name] = dict(enc[name], decay_w=jnp.float32(0.4),
                             decay_b=jnp.float32(-0.5))
    return dict(params, encoder=enc)


@pytest.fixture(scope="module")
def jax_side():
    """variant -> the JAX model, config, data and params (the port's seeded
    init), and `run`: one compiled function (params, rng) -> ((loss,
    grads) of the batch T_POS, (ranks, mask, loss) of an eval batch of
    every time on the valid split), with "out" its result at the variant's
    params and key 1; built on first use (one compile a variant)."""
    cache = {}

    def get(variant):
        if variant not in cache:
            flags = VARIANTS[variant][0]
            cfg = JaxConfig(fused_window=False, fused_final=False, **KW,
                            **flags)
            data = jax.device_put(jax_synthetic(**DATA))
            model = jax_get_model(cfg, data)
            own = _port(variant)[2].init_params(0)
            params = _open(jax.tree_util.tree_map(
                lambda t: jnp.asarray(t.numpy()), own), flags)
            tp, tv = jnp.asarray(T_POS, jnp.int32), jnp.asarray([True, True])
            T = data.num_times
            t_all = jnp.arange(T, dtype=jnp.int32)

            def run(p, r):
                return (jax.value_and_grad(
                    lambda q: model.loss(q, data, tp, tv, r))(p),
                    model.eval_ranks(p, data, t_all, jnp.ones(T, bool),
                                     "valid"))

            key = jax.random.PRNGKey(1)
            with _xla_unoptimized():
                run = jax.jit(run).lower(params, key).compile()
            cache[variant] = dict(cfg=cfg, data=data, model=model,
                                  params=params, run=run,
                                  out=run(params, key))
        return cache[variant]

    return get


def _port(variant, **over):
    flags = VARIANTS[variant][0]
    cfg = TKGConfig(fused_window=True, fused_final=True, **KW,
                    **{**flags, **over})
    data = ring_layout(cfg, make_synthetic(**DATA))
    return cfg, data, get_model(cfg, data, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_grads_and_ranks_match_reference(jax_side, variant):
    """The batch's loss and every gradient within 1e-5 relative, and the
    eval ranks of every time on the valid split equal (MRR within 1e-6),
    against the JAX package with the same weights and draws."""
    js = jax_side(variant)
    (ref_loss, ref_grads), (ref_ranks, ref_mask, ref_bce) = js["out"]
    cfg, data, model = _port(variant)
    flags, cls, fused = VARIANTS[variant]
    assert type(model) is cls and model.fused_final_on() == fused
    params = _torch_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    draws = _draws(js, T_POS, jax.random.PRNGKey(1))
    if cfg.random_dropout or cfg.edge_dropout:
        # the windows' edge masks drop some of the window's edges
        win_edges = draws["win_edges"]
        assert win_edges is not None and win_edges.sum() > 0
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=draws)
    loss.backward()
    ref_loss = float(ref_loss)
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = moved = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
        moved += bool(np.abs(np.asarray(ref)).max() > 0)
    assert n == len(param_leaves(params)) and moved > n // 2
    for name in ("layer1", "layer2"):
        layer = params["encoder"][name]
        if "decay_w" in layer and name == "layer2":
            # the open decay takes a gradient
            assert float(layer["decay_w"].grad) != 0.0

    T = DATA["num_times"]
    ref_ranks, ref_mask = np.asarray(ref_ranks), np.asarray(ref_mask)
    tr = Trainer(cfg, model, data)
    eparams = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, js["params"]), device="cpu")
    with torch.no_grad():
        ranks, mask, bce = model.eval_ranks(
            eparams, tr.data, np.arange(T), np.ones(T, bool), "valid")
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ranks.numpy()[ref_mask],
                                  ref_ranks[ref_mask])
    m = metrics_from_ranks(ranks.numpy(), mask.numpy())
    ref_m = metrics_from_ranks(ref_ranks, ref_mask)
    assert m["n"] == ref_m["n"] > 0
    assert abs(m["mrr"] - ref_m["mrr"]) <= 1e-6
    assert abs(float(bce) - float(ref_bce)) <= 1e-5
    run = tr.run_eval(eparams, "valid")
    assert abs(run["mrr"] - m["mrr"]) <= 1e-6


# -- the repairs: the conv1 table's guard, time embeddings in a batch --------

def test_precompute_eval_conv1_follows_the_reference_guard():
    """A table for GRRGCN (with type1 and DropEdge among its options, as
    in JAX); None for RRGCN, rec_only_last_layer and time
    embeddings, as the JAX package's guard gives."""
    jdata = jax_synthetic(**DATA)
    for flags, table in (({"type1": True, "edge_dropout": True}, True),
                         ({"module": "RRGCN"}, False),
                         ({"rec_only_last_layer": True}, False),
                         ({"use_time_embedding": True}, False),
                         ({"module": "BiRRGCN"}, False)):
        cfg = TKGConfig(**KW, **flags)
        data = ring_layout(cfg, make_synthetic(**DATA))
        model = get_model(cfg, data, device="cpu")
        jmodel = jax_get_model(JaxConfig(**KW, **flags), jdata)
        params = model.init_params(0)
        ref = jmodel.precompute_eval_conv1(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), params), jdata)
        got = model.precompute_eval_conv1(params, to_device(data, "cpu"))
        assert (got is not None) == (ref is not None) == table, flags
        if table:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=0)


def test_time_embedded_histories_match_reference():
    """A batch whose targets sit at different times: each element's window
    steps take their own times' embeddings, and the histories (stored with
    the embeddings added) and the local stream equal the JAX package's
    per-element scan."""
    flags = {**GRU, "use_time_embedding": True, "learnable_lambda": True}
    cfg = TKGConfig(**{**KW, "train_seq_len": 4}, **flags)
    jcfg = JaxConfig(fused_window=False, **{**KW, "train_seq_len": 4},
                     **flags)
    jdata = jax_synthetic(**DATA)
    jmodel = jax_get_model(jcfg, jdata)
    data = ring_layout(cfg, make_synthetic(**DATA))
    model = get_model(cfg, data, device="cpu")
    params = model.init_params(2)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    t_pos = [7, 3]
    L = 4
    tp = torch.tensor(t_pos)
    with torch.no_grad():
        got = model.pre_forward(params, gather_window(to_device(data, "cpu"),
                                                      tp, L),
                                L, tp, with_loc=True)
    for b, t in enumerate(t_pos):
        win = jax_gather_window(jdata, jnp.int32(t), L)
        ref = jmodel.pre_forward(jp, win, L, False, jax.random.PRNGKey(0),
                                 jnp.int32(t), with_loc=True)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       atol=1e-5, rtol=0)
    # the targets' window steps lie at different times, whose embeddings
    # differ
    temb = params["encoder"]["layer1"]["time_embed"]
    assert not torch.equal(temb[4], temb[0]) and not torch.equal(temb[6],
                                                                  temb[0])


# -- Adam steps, the parameter trees, checkpoints, the registry and the CLI --

def test_rrgcn_three_optimizer_steps_match_optax(jax_side):
    """Three of the port's train_steps of RRGCN held to JAX on one
    trajectory: at each step JAX's loss and gradients at the port's current
    parameters, with the same draws, agree with the port's to 1e-5, and
    optax's chain applied to the port's gradients gives the port's new
    parameters to 1e-5."""
    js = jax_side("rrgcn")
    jparams = js["params"]
    opt = jax_make_optimizer(js["cfg"])
    state = opt.init(jparams)

    @jax.jit
    def adam(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    cfg, data, model = _port("rrgcn")
    tr = Trainer(cfg, model, data)
    params = _torch_params(jax.tree_util.tree_map(np.asarray, jparams))
    optimizer = make_optimizer(cfg, params)

    def to_jax(tree, grad):
        return jax.tree_util.tree_map(
            lambda j, t: jnp.asarray((t.grad if grad else t).detach()
                                     .numpy().copy()), jparams, tree)

    for step in range(3):
        rng = jax.random.PRNGKey(10 + step)
        jparams = to_jax(params, False)
        (jloss, grads), _ = js["run"](jparams, rng)
        loss = tr.train_step(params, optimizer, T_POS, [True, True],
                             draws=_draws(js, T_POS, rng))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0,
                                                             float(jloss))
        norm = np.sqrt(sum(float(jnp.sum(g * g))
                           for g in jax.tree_util.tree_leaves(grads)))
        scale = min(1.0, cfg.gradient_clip_val / norm)
        port_grads = to_jax(params, True)
        for path, ref, got in _pairs(grads, port_grads):
            _close(np.asarray(got), np.asarray(ref) * scale,
                   f"step {step} {path}")
        jparams, state = adam(port_grads, state, jparams)
        n = 0
        for path, ref, got in _pairs(jparams, params):
            _close(got.detach().numpy(), np.asarray(ref),
                   f"step {step} {path}")
            n += 1
        assert n == len(param_leaves(params))


@pytest.mark.parametrize("variant", ["rrgcn", "birrgcn", "type1_lambda_temb",
                                     "drgcn", "birrgcn_options"])
def test_params_from_numpy_carries_the_trees(variant):
    flags = VARIANTS[variant][0]
    jmodel = jax_get_model(JaxConfig(**KW, **flags), jax_synthetic(**DATA))
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(np_params, device="cpu")
    n = 0
    for path, ref, got in _pairs(np_params, params):
        np.testing.assert_array_equal(got.numpy(), ref, path)
        assert got.dtype == torch.float32 and got.shape == np.shape(ref)
        n += 1
    enc = params["encoder"]
    if flags["module"] == "BiRRGCN":
        assert {"time_weight_fwd", "time_weight_bwd"} <= set(enc["layer2"])
    if flags.get("type1"):
        assert len(enc["layer1"]["gru"]) == 1
        assert tuple(enc["layer1"]["gru"][0]["w_ih"].shape) == (16, 16)
    # the port's own init has the same tree and shapes
    own = _port(variant)[2].init_params(0)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(own)] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(np_params)]
    assert n == len(param_leaves(own))


@pytest.mark.parametrize("variant", ["birrgcn", "type1_lambda_temb"])
def test_last_checkpoint_restores_the_trees(tmp_path, variant):
    cfg, data, model = _port(variant, experiments_dir=str(tmp_path))
    tr = Trainer(cfg, model, data)
    params, optimizer = tr.init_state()
    tr.train_step(params, optimizer, T_POS, [True, True],
                  gen=tr.step_generator(0, 0))
    tr.save_last(params, optimizer, 0, 0.5, 0)
    got, opt2, start, best = tr.load_last()
    assert (start, best) == (1, (0.5, 0))
    n = 0
    for (path, ref, x) in _pairs(params, got):
        assert torch.equal(ref.detach(), x.detach()), path
        n += 1
    assert n == len(param_leaves(params))
    state = optimizer.state_dict()["state"]
    assert all(torch.equal(state[k]["exp_avg"], v["exp_avg"])
               for k, v in opt2.state_dict()["state"].items())


def test_registry_dispatches_the_new_models_and_refuses_the_rest():
    data = make_synthetic(**DATA)
    for flags, cls, _ in VARIANTS.values():
        assert type(get_model(TKGConfig(**KW, **flags), data,
                              device="cpu")) is cls
    # the other decoders, the baselines and TimeDynamicRGCN build since
    for flags, name in (({"module": "SRGCN", "score_function": "distmult"},
                         "StaticRGCNModel"),
                        ({"module": "DE"}, "DiachronicEmbeddingModel"),
                        ({"module": "TimeDynamicRGCN"},
                         "TimeDynamicRGCNModel")):
        m = get_model(TKGConfig(**KW, **flags), data, device="cpu")
        assert type(m).__name__ == name, flags
        m.init_params(0)
    for flags in ({"module": "RRGCN", "impute": True},
                  {"module": "BiRRGCN", "post_ensemble": True},
                  {"module": "RRGCN", "edge_partition": "ring",
                   "mp_size": 4},
                  {**GRU, "type1": True, "edge_partition": "psum",
                   "mp_size": 2},
                  {**GRU, "score_function": "transE",
                   "edge_partition": "psum", "mp_size": 2}):
        with pytest.raises(NotImplementedError):
            get_model(TKGConfig(**KW, **flags), data,
                      device="cpu").init_params(0)


def test_main_cli_trains_rrgcn_on_cpu(tmp_path, capsys, one_thread):
    root = _write_dataset(tmp_path / "data")
    out = run_cli([
        "-c", os.path.join(ROOT, "grid", "icews14", "config_rrgcn.json"),
        "--device", "cpu", "--fast-dev-run", "--data-root", root, "--dataset",
        "tiny", "--edge-pad-multiple", "16", "--embed-size", "16",
        "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
        "--batch-size", "2", "--experiments-dir", str(tmp_path / "runs"),
        "--model-name", "rr",
    ], capsys)
    assert "module=RRGCN" in out
    assert "epoch 0:" in out and "test: mrr=" in out
    ckpt = torch.load(tmp_path / "runs" / "rr" / "checkpoints" / "best.pt",
                      weights_only=True)
    assert tuple(ckpt["params"]["encoder"]["layer2"]["time_weight"].shape) \
        == (16, 16)
