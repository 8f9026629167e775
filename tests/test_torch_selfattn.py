"""The self-attention models of temp_tpu_torch (SARGCN, BiSARGCN, their
--post-aggregation variants, and the options sa_compact, ema,
learnable_lambda, rec_only_last_layer, random_dropout and
use_embed_for_non_active) against the JAX package on the CPU, float32.

The JAX models run with fused_window and fused_final off (neither takes
these models); their history steps and final steps call rel_spmm, as the
port's call K1 (its plain version on the CPU, over the data's static tables
of the train snapshots, so every call's time positions are checked). The
JAX draws cannot be replayed by a torch.Generator, so ``jax_draws_sa``
rebuilds the key derivation of the JAX package's attention models
(temp_tpu/models/selfattn.py: forward_element's split into the history's,
the final step's and the subsample's keys, or four ways in the Bi models;
a window's step keys, each split first for the 80% edge subsample under
random_dropout, then into layer 1's and layer 2's self-loop keys; the
final step's two; the loss's positives from split(r_loss, 3)[0]) and hands
every mask to the port.

Tolerances: the attention functions within 1e-6; losses, gradients and
parameters within 1e-5 relative to max(1, the largest entry) (float32 sums
in another order); eval ranks equal and MRR within 1e-6.
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
from temp_tpu.models import selfattn as jax_sa
from temp_tpu.models.dynamic import gather_window as jax_gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models import selfattn
from temp_tpu_torch.models.objectives import metrics_from_ranks
from temp_tpu_torch.models.postselfattn import (
    PostBiSelfAttentionRGCNModel, PostSelfAttentionRGCNModel,
)
from temp_tpu_torch.models.dynamic import DynamicRGCNModel
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.models.selfattn import (
    BiSelfAttentionRGCNModel, SelfAttentionRGCNModel,
)
from temp_tpu_torch.models.static import StaticRGCNModel
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
from test_torch_post import _xla_unoptimized
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import (
    _close, _pairs, _torch_params, _write_dataset, run_cli,
)

# the port's side on one intra-op thread: its many tiny ops otherwise wait
# on the other test workers' threads (``one_thread``)
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1, lr=0.01)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
# t = 1 runs the forward window off t = 0 (two empty slots), t = 8 the
# backward one off T - 1
T_POS = [8, 1]
SA = {"module": "SARGCN"}
# each variant's flags and the port's class
VARIANTS = {
    "sa": (SA, SelfAttentionRGCNModel),
    "bisa": ({"module": "BiSARGCN"}, BiSelfAttentionRGCNModel),
    "post_sa": ({**SA, "post_aggregation": True},
                PostSelfAttentionRGCNModel),
    "post_bisa": ({"module": "BiSARGCN", "post_aggregation": True,
                   "sa_compact": True}, PostBiSelfAttentionRGCNModel),
    "compact": ({**SA, "sa_compact": True, "learnable_lambda": True,
                 "ema": True, "random_dropout": True},
                SelfAttentionRGCNModel),
    "ema": ({**SA, "ema": True, "learnable_lambda": True},
            SelfAttentionRGCNModel),
    "rec_only": ({**SA, "rec_only_last_layer": True,
                  "use_embed_for_non_active": True}, SelfAttentionRGCNModel),
    "random_dropout": ({**SA, "random_dropout": True},
                       SelfAttentionRGCNModel),
}


# -- the attention, its compact form and the EMA ----------------------------

def _attention_case(seed=0, S=5, N=12, A=4, d=16):
    """Layer params, cur [N, d], a dense history [S, N, d] with its mask
    and the same history in compact form (A slots a step); entities 0 and
    1 are never active."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    p = {k: f(d, d) * 0.3 for k in ("q_linear", "k_linear", "v_linear")}
    p["decay_w"], p["decay_b"] = np.float32(0.4), np.float32(-0.5)
    act_idx = np.full((S, A), N, np.int32)
    act_mask = np.zeros((S, A), bool)
    hist_c = f(S, A, d)
    dense = np.zeros((S, N, d), np.float32)
    mask = np.full((S, N), jax_sa.NEG_MASK, np.float32)
    for s in range(S):
        k = rs.randint(1, A + 1)
        ids = rs.choice(np.arange(2, N), k, replace=False)
        act_idx[s, :k], act_mask[s, :k] = ids, True
        dense[s, ids], mask[s, ids] = hist_c[s, :k], 0.0
    td = np.arange(S, -1, -1).astype(np.float32)
    return p, f(N, d), dense, mask, hist_c, act_idx, act_mask, td


@pytest.mark.parametrize("learnable_lambda", [False, True])
def test_attention_matches_reference(learnable_lambda):
    p, cur, dense, mask, hist_c, act_idx, act_mask, td = _attention_case()
    N = cur.shape[0]
    full = np.concatenate([mask, np.zeros((1, N), np.float32)])
    jcfg = JaxConfig(learnable_lambda=learnable_lambda)
    cfg = TKGConfig(learnable_lambda=learnable_lambda)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    T = lambda x: torch.from_numpy(x)  # noqa: E731
    ref = np.asarray(jax_sa.attention_over_history(
        jp, jcfg, cur, dense, td, full))
    got = selfattn.attention_over_history(tp, cfg, T(cur), T(dense), T(td),
                                          T(full)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    ref_c = np.asarray(jax_sa.attention_over_history_compact(
        jp, jcfg, cur, hist_c, act_idx, act_mask, td, N))
    got_c = selfattn.attention_over_history_compact(
        tp, cfg, T(cur), T(hist_c), T(act_idx), T(act_mask), T(td),
        N).numpy()
    np.testing.assert_allclose(got_c, ref_c, atol=1e-6, rtol=0)
    # the compact form is the dense one; rows never active attend only to
    # their current slot
    np.testing.assert_allclose(got_c, got, atol=1e-6, rtol=0)
    v = cur @ p["v_linear"].T
    v = v.reshape(N, 8, 2).transpose(0, 2, 1).reshape(N, -1)
    np.testing.assert_allclose(got[:2], v[:2], atol=1e-6, rtol=0)
    # an empty history
    empty = selfattn.attention_over_history_compact(
        tp, cfg, T(cur), T(hist_c[:0]), T(act_idx[:0]), T(act_mask[:0]),
        T(td[-1:]), N).numpy()
    np.testing.assert_allclose(empty, v, atol=1e-6, rtol=0)


def test_ema_matches_reference():
    _, cur, dense, *_ = _attention_case(seed=1)
    alpha = np.random.RandomState(2).standard_normal(
        (cur.shape[1], 1)).astype(np.float32)
    ref = np.asarray(jax_sa.ema_over_history(alpha, cur, dense))
    got = selfattn.ema_over_history(torch.from_numpy(alpha),
                                    torch.from_numpy(cur),
                                    torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# -- each variant's loss, gradients and eval ranks ---------------------------

def jax_draws_sa(cfg, data, t_pos, rng):
    """Every draw of the JAX package's attention models' losses, by their
    own key derivation (see the module's docstring)."""
    L = cfg.train_seq_len
    L1, N, d = L - 1, data.num_ents, cfg.embed_size
    rows = data.act_idx.shape[1] if cfg.sa_compact else N
    bi = cfg.module.startswith("Bi")
    drop = cfg.random_dropout and not bi
    keep = 1.0 - cfg.dropout
    wins = ("", "_b") if bi else ("",)
    out = {k: [] for k in [f"win{i}{s}" for s in wins for i in (1, 2)]
           + ["win_edges", "fin1", "fin2", "edges", "pos"]}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        keys = jax.random.split(r_fwd, 4 if bi else 3)
        k_fin, k_sub = keys[-2], keys[-1]
        for sfx, k_hist, backward in zip(wins, keys, (False, True)):
            win = jax_gather_window(data, jnp.int32(t), L, backward=backward)
            masks, edges = ([], []), []
            for i, key in enumerate(jax.random.split(k_hist, L1)):
                if drop:
                    kd, key = jax.random.split(key)
                    edges.append(np.asarray(
                        jax_subsample_edges(kd, win.emask[i], 0.8)))
                for m, k in zip(masks, jax.random.split(key)):
                    m.append(np.asarray(jax.random.bernoulli(k, keep,
                                                             (rows, d))))
            for i, m in zip((1, 2), masks):
                out[f"win{i}{sfx}"].append(np.stack(m))
            if drop:
                out["win_edges"].append(np.stack(edges))
        for key, k in zip(("fin1", "fin2"), jax.random.split(k_fin)):
            out[key].append(np.asarray(jax.random.bernoulli(k, keep, (N, d))))
        win = jax_gather_window(data, jnp.int32(t), L)
        out["edges"].append(np.asarray(
            jax_subsample_edges(k_sub, win.emask[L - 1], 0.5)))
        out["pos"].append(np.asarray(jax_subsample_pos(
            jax.random.split(r_loss, 3)[0], data.train.emask[t],
            cfg.num_pos_facts)))
    return {k: torch.from_numpy(np.stack(v)) if v else None
            for k, v in out.items()}


def _open_decay(params, flags):
    """The port's params with a logit decay whose clamp is open for some
    of the window's time differences and shut for others."""
    if not flags.get("learnable_lambda"):
        return params
    enc = {name: dict(layer, decay_w=jnp.float32(0.4),
                      decay_b=jnp.float32(-0.5))
           for name, layer in params["encoder"].items()}
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
            params = _open_decay(jax.tree_util.tree_map(
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
    cfg = TKGConfig(**KW, **{**flags, **over})
    data = ring_layout(cfg, make_synthetic(**DATA))
    return cfg, data, get_model(cfg, data, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_reference(jax_side, variant):
    js = jax_side(variant)
    (ref_loss, ref_grads), _ = js["out"]
    cfg, data, model = _port(variant)
    assert type(model) is VARIANTS[variant][1]
    assert model.cfg.use_time_embedding and not model.fused_final_on()
    params = _torch_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=jax_draws_sa(js["cfg"], js["data"], T_POS,
                                         jax.random.PRNGKey(1)))
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
    if "decay_w" in params["encoder"]["layer2"]:
        # the open decay takes a gradient
        assert float(params["encoder"]["layer2"]["decay_w"].grad) != 0.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_ranks_match_reference(jax_side, variant):
    js = jax_side(variant)
    T = DATA["num_times"]
    tp_all, tv_all = np.arange(T, dtype=np.int32), np.ones(T, bool)
    _, (ref_ranks, ref_mask, ref_loss) = js["out"]
    ref_ranks, ref_mask = np.asarray(ref_ranks), np.asarray(ref_mask)
    cfg, data, model = _port(variant)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      js["params"]),
                               device="cpu")
    tr = Trainer(cfg, model, data)
    with torch.no_grad():
        ranks, mask, loss = model.eval_ranks(params, tr.data, tp_all, tv_all,
                                             "valid")
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ranks.numpy()[ref_mask],
                                  ref_ranks[ref_mask])
    m = metrics_from_ranks(ranks.numpy(), mask.numpy())
    ref_m = metrics_from_ranks(ref_ranks, ref_mask)
    assert m["n"] == ref_m["n"] > 0
    assert abs(m["mrr"] - ref_m["mrr"]) <= 1e-6
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    run = tr.run_eval(params, "valid")
    assert abs(run["mrr"] - m["mrr"]) <= 1e-6
    # the gated eval reports a loss of 0, as the reference's does
    assert ("gates" in params) == (float(ref_loss) == 0.0 == run["loss"])


# -- Adam steps, the parameter tree, checkpoints, the registry and the CLI ---

def test_three_optimizer_steps_match_optax(jax_side):
    """Three of the port's train_steps of SARGCN held to JAX on one
    trajectory: at each step JAX's loss and gradients at the port's current
    parameters, with the same draws, agree with the port's to 1e-5, and
    optax's chain applied to the port's gradients gives the port's new
    parameters to 1e-5."""
    js = jax_side("sa")
    jparams = js["params"]
    opt = jax_make_optimizer(js["cfg"])
    state = opt.init(jparams)

    @jax.jit
    def adam(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    cfg, data, model = _port("sa")
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
                             draws=jax_draws_sa(js["cfg"], js["data"],
                                                T_POS, rng))
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


@pytest.mark.parametrize("variant", ["compact", "post_bisa", "rec_only"])
def test_params_from_numpy_carries_an_attention_tree(variant):
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
    layer2 = params["encoder"]["layer2"]
    assert {"q_linear", "k_linear", "v_linear"} <= set(layer2)
    if flags.get("learnable_lambda"):
        assert layer2["decay_w"].dim() == 0 == layer2["decay_b"].dim()
    if flags.get("ema"):
        assert tuple(params["alpha"].shape) == (KW["embed_size"], 1)
    # the port's own init has the same tree and shapes
    own = _port(variant)[2].init_params(0)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(own)] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(np_params)]
    assert n == len(param_leaves(own))


def test_last_checkpoint_restores_an_attention_tree(tmp_path):
    cfg, data, model = _port("compact", experiments_dir=str(tmp_path))
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
    assert got["encoder"]["layer1"]["decay_w"].dim() == 0
    state = optimizer.state_dict()["state"]
    assert all(torch.equal(state[k]["exp_avg"], v["exp_avg"])
               for k, v in opt2.state_dict()["state"].items())


def test_registry_selects_the_attention_models():
    data = make_synthetic(**DATA)
    for flags, cls in VARIANTS.values():
        for extra in ({}, {"impute": True, "post_ensemble": True}):
            cfg = TKGConfig(**KW, **flags, **extra)
            assert type(get_model(cfg, data, device="cpu")) is cls
    # DropEdge and type1 take no part in the attention models (the JAX
    # package's ignore them); the other modules and options build since
    for flags, cls in (({**SA, "edge_dropout": True},
                        SelfAttentionRGCNModel),
                       ({**SA, "type1": True}, SelfAttentionRGCNModel),
                       ({"module": "SRGCN"}, StaticRGCNModel),
                       ({"module": "RRGCN"}, DynamicRGCNModel),
                       ({"module": "GRRGCN", "learnable_lambda": True},
                        DynamicRGCNModel),
                       ({"module": "GRRGCN", "use_time_embedding": True},
                        DynamicRGCNModel),
                       ({**SA, "score_function": "distmult"},
                        SelfAttentionRGCNModel),
                       ({**SA, "negative_pool": "per_query"},
                        SelfAttentionRGCNModel)):
        m = get_model(TKGConfig(**KW, **flags), data, device="cpu")
        assert type(m) is cls, flags
        m.init_params(0)
    for flags in ({**SA, "edge_partition": "psum", "mp_size": 2},
                  {"module": "GRRGCN", "negative_pool": "per_query",
                   "edge_partition": "psum", "mp_size": 2}):
        with pytest.raises(NotImplementedError):
            get_model(TKGConfig(**KW, **flags), data,
                      device="cpu").init_params(0)


def test_main_cli_trains_sargcn_on_cpu(tmp_path, capsys, one_thread):
    root = _write_dataset(tmp_path / "data")
    out = run_cli([
        "-c", os.path.join(ROOT, "grid", "icews14", "config_sargcn.json"),
        "--device", "cpu", "--fast-dev-run", "--data-root", root, "--dataset",
        "tiny", "--edge-pad-multiple", "16", "--embed-size", "16",
        "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
        "--batch-size", "2", "--experiments-dir", str(tmp_path / "runs"),
        "--model-name", "sa",
    ], capsys)
    assert "module=SARGCN" in out
    assert "epoch 0:" in out and "test: mrr=" in out
    ckpt = torch.load(tmp_path / "runs" / "sa" / "checkpoints" / "best.pt",
                      weights_only=True)
    assert tuple(ckpt["params"]["encoder"]["layer2"]["q_linear"].shape) == (
        16, 16)
