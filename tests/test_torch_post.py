"""The TeMP variants of temp_tpu_torch (the frequency gates post_ensemble and
post_aggregation, the unidirectional impute model, plain BiGRRGCN) against
the JAX package on the CPU, float32.

The JAX models run with fused_window and fused_final off: the history
windows through its XLA scan (the whole-window kernel's plain reference),
the final step and the gated losses one element at a time. Its random
draws cannot be replayed by a torch.Generator, so ``jax_draws_scan``
rebuilds the key derivation of the JAX package's Post and Bi losses
(temp_tpu/models/post.py:218-224 and :175-198, :473-500;
temp_tpu/models/bidynamic.py; the scan's per-step keys of
temp_tpu/models/dynamic.py:195-213) and hands every mask to the port. The
port runs its windows through K2's plain version (fused_window on): the
two modes of K2 these models add, three buffers without the ReLU (the
unidirectional Post models) and two with it (BiGRRGCN), are also held to
the JAX kernel's vjp in interpret mode.

Tolerances: 1e-5 relative to max(1, the largest entry) for losses,
gradients and parameters (float32 sums in another order); features equal;
gate weights within 1e-6; eval ranks equal and MRR within 1e-6.
"""

import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.frequency import build_freq_features as jax_freq
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.dynamic import gather_window as jax_gather_window
from temp_tpu.models.post import gate_weight as jax_gate_weight
from temp_tpu.models.post import init_gate_mlp as jax_init_gate_mlp
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.frequency import build_freq_features
from temp_tpu_torch.data.snapshots import make_synthetic, to_device
from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel
from temp_tpu_torch.models.objectives import metrics_from_ranks
from temp_tpu_torch.models.post import (
    PostBiDynamicRGCNModel, PostDynamicRGCNModel, gate_weight, init_gate_mlp,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops.fused_window import fused_window_scan
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
from test_torch_flagship import _jax_flagship_window_vjp, _open_impute
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import (
    _close, _pairs, _torch_params, _window_case, _write_dataset, run_cli,
)


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=3,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1, lr=0.01)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
T_POS = [5, 2]
# each variant's flags (after the registry's remap) and the port's class
VARIANTS = {
    "ted": ({"module": "BiGRRGCN", "impute": True, "post_ensemble": True},
            PostBiDynamicRGCNModel),
    "bi_agg": ({"module": "BiGRRGCN", "impute": True,
                "post_aggregation": True}, PostBiDynamicRGCNModel),
    "uni_ens": ({"module": "GRRGCN", "impute": True, "post_ensemble": True},
                PostDynamicRGCNModel),
    "uni_agg": ({"module": "GRRGCN", "post_aggregation": True},
                PostDynamicRGCNModel),
    "uni_impute": ({"module": "GRRGCN", "impute": True},
                   PostDynamicRGCNModel),
    "bi_plain": ({"module": "BiGRRGCN"}, BiDynamicRGCNModel),
}


def jax_draws_scan(cfg, data, t_pos, rng, rates=(None, None)):
    """Every draw of the JAX package's Post and Bi losses with its windows
    on the XLA scan: split(rng, B) per element; split -> (r_fwd, r_loss);
    split(r_fwd, 4) -> (k_f, k_b, k_fin, k_sub) in the Bi models,
    split(r_fwd, 3) -> (k_pre, k_fin, k_sub) in the others; a window's
    step keys split(k_window, L1), each split into layer 1's and layer 2's
    self-loop keys at (A, d) (under random_dropout or edge_dropout first
    split into the step's edge key and the rest: the 80% edge subsample,
    or DropEdge's keep = uniform >= rate with `rates`, the JAX model's
    (drop_past, drop_future)); the final step's from split(k_fin) at
    (N, d); the edge subsample from k_sub; the positives from
    split(r_loss, 3)[0] (the gated loss's k_pos, and
    train_loss_single's)."""
    L = cfg.train_seq_len
    L1, A, N, d = L - 1, data.act_idx.shape[1], data.num_ents, cfg.embed_size
    bi = cfg.module.startswith("Bi")
    drop = cfg.random_dropout or cfg.edge_dropout
    keep = 1.0 - cfg.dropout
    wins = (("win1", "win2", "win_edges", False, rates[0]),
            ("win1_b", "win2_b", "win_edges_b", True, rates[1]))
    wins = wins[:2 if bi else 1]
    out = {k: [] for k in sum((w[:3] for w in wins), ())
           + ("fin1", "fin2", "edges", "pos")}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        keys = jax.random.split(r_fwd, 4 if bi else 3)
        k_fin, k_sub = keys[-2], keys[-1]
        for (m1, m2, me, backward, rate), k_win in zip(wins, keys):
            win = jax_gather_window(data, jnp.int32(t), L, backward=backward)
            steps, edges = [], []
            for i, k in enumerate(jax.random.split(k_win, L1)):
                if drop:
                    kd, k = jax.random.split(k)
                    em = win.emask[i]
                    edges.append(np.asarray(
                        em & (jax.random.uniform(kd, em.shape) >= rate[t, i])
                        if cfg.edge_dropout
                        else jax_subsample_edges(kd, em, 0.8)))
                steps.append(jax.random.split(k))
            for i, key in enumerate((m1, m2)):
                out[key].append(np.stack([np.asarray(jax.random.bernoulli(
                    s[i], keep, (A, d))) for s in steps]))
            if drop:
                out[me].append(np.stack(edges))
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


def _open(params, flags):
    """The JAX params with impute scalars whose clamp is open for the
    windows' dt, so their gradients are not 0 (``_open_impute``)."""
    if not flags.get("impute"):
        return params
    if flags["module"].startswith("Bi"):
        return _open_impute(params)
    enc = dict(params["encoder"], impute_w=jnp.float32(0.3),
               impute_b=jnp.float32(0.2))
    return dict(params, encoder=enc)


@contextmanager
def _xla_unoptimized(off: bool = True):
    """XLA's optimizations off while the JAX references compile (about a
    third less compile time; the same arithmetic up to float32 rounding);
    `off` False turns them back on inside (``xla_default``)."""
    key = "jax_disable_most_optimizations"
    old = jax.config.values[key]
    jax.config.update(key, off)
    try:
        yield
    finally:
        jax.config.update(key, old)


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile
    and run op by op (``_xla_unoptimized``), but in the tests that take
    ``xla_default``."""
    with _xla_unoptimized():
        yield


@pytest.fixture
def xla_default():
    """XLA's default optimizations for a test that runs optax's Adam steps
    (ROADMAP.md's test-time rule: the switch moves such a trajectory's
    entries by float32 roundings)."""
    with _xla_unoptimized(False):
        yield


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
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    return cfg, data, model


# -- the frequency features and the gate MLP --------------------------------

@pytest.mark.parametrize("future", [False, True])
@pytest.mark.parametrize("seq_len", [3, 5])
def test_freq_features_match_reference(future, seq_len):
    ref = jax_freq(jax_synthetic(**DATA), seq_len, future)
    got = build_freq_features(make_synthetic(**DATA), seq_len, future)
    n = 0
    for split in ("train", "valid", "test"):
        for part in ("sub", "obj"):
            name = f"{split}_{part}"
            x, y = getattr(got, name), np.asarray(getattr(ref, name))
            assert x.dtype == np.float32 and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, name)
            n += int((y > 0).sum())
    assert n > 0
    # with the DropEdge rates: the same features, and the rates of both
    # directions equal to the JAX package's
    ref = jax_freq(jax_synthetic(**DATA), seq_len, future,
                   with_drop_rates=True)
    got2 = build_freq_features(make_synthetic(**DATA), seq_len, future,
                               with_drop_rates=True)
    for name in ("train_sub", "valid_obj"):
        np.testing.assert_array_equal(getattr(got2, name),
                                      getattr(got, name))
    for name in ("drop_rate_past", "drop_rate_future"):
        x, y = getattr(got2, name), np.asarray(getattr(ref, name))
        assert x.dtype == np.float32 and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, name)
    assert (got2.drop_rate_past > 0).any()
    assert (got2.drop_rate_future > 0).any() == future


def test_gate_mlp_matches_reference():
    ref_p = jax_init_gate_mlp(jax.random.PRNGKey(3))
    own = init_gate_mlp(torch.Generator().manual_seed(3))
    b = 1.0 / np.sqrt(3)
    for k, v in ref_p.items():
        assert tuple(own[k].shape) == np.shape(v)
        assert float(own[k].abs().max()) <= b
    x = np.random.RandomState(0).poisson(4.0, (50, 3)).astype(np.float32)
    ref = np.asarray(jax_gate_weight(ref_p, jnp.asarray(x)))
    got = gate_weight(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, ref_p), device="cpu"), torch.from_numpy(x))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


# -- each variant's loss, gradients and eval ranks ---------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_reference(jax_side, variant):
    js = jax_side(variant)
    rng = jax.random.PRNGKey(1)
    (ref_loss, ref_grads), _ = js["out"]
    cfg, data, model = _port(variant)
    assert type(model) is VARIANTS[variant][1]
    assert not model.fused_final_on()  # no fused final step for these
    params = _torch_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=jax_draws_scan(js["cfg"], js["data"], T_POS, rng))
    loss.backward()
    ref_loss = float(ref_loss)
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(param_leaves(params))
    gates = params.get("gates", {})
    assert ("gates" in params) == (variant not in ("uni_impute", "bi_plain"))
    # the used gates learn; post_aggregation's last two MLPs are never read
    for name, g in gates.items():
        grad = g["b2"].grad
        assert (grad is not None and float(grad.abs().max()) > 0) == (
            name not in ("sqoe", "oqoe")), name


def _swap_gates(params):
    g = params["gates"]
    return dict(params, gates={"subject": g["object"],
                               "object": g["subject"]})


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
    if "gates" in params:
        # the gated eval reports a loss of 0, as the reference's does
        assert float(ref_loss) == 0.0 and run["loss"] == 0.0
    if variant in ("ted", "uni_ens"):
        # the ensemble's eval pairs the gates opposite to training: with
        # the two MLPs exchanged the ranks move
        with torch.no_grad():
            other, _, _ = model.eval_ranks(_swap_gates(params), tr.data,
                                           tp_all, tv_all, "valid")
        assert not np.array_equal(other.numpy()[ref_mask],
                                  ref_ranks[ref_mask])


# -- TED's optimizer steps, the parameter tree, checkpoints and the CLI ------

def test_ted_three_optimizer_steps_match_optax(jax_side, xla_default):
    """Three of the port's train_steps of TED (BiGRRGCN --impute
    --post-ensemble) held to JAX on one trajectory, as the flagship's test
    does: at each step JAX's loss and gradients at the port's current
    parameters, with the same draws, agree with the port's to 1e-5, and
    optax's chain applied to the port's gradients gives the port's new
    parameters (the gates' among them) to 1e-5."""
    js = jax_side("ted")
    jparams = js["params"]
    opt = jax_make_optimizer(js["cfg"])
    state = opt.init(jparams)

    @jax.jit
    def adam(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    cfg, data, model = _port("ted")
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
                             draws=jax_draws_scan(js["cfg"], js["data"],
                                                  T_POS, rng))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0,
                                                             float(jloss))
        # the port's gradients after its clip (optax's formula: times
        # max/norm at a norm of at least max), which optax's clip of them
        # leaves as they are
        norm = np.sqrt(sum(float(jnp.sum(g * g))
                           for g in jax.tree_util.tree_leaves(grads)))
        scale = min(1.0, cfg.gradient_clip_val / norm)
        port_grads = to_jax(params, True)
        for path, ref, got in _pairs(grads, port_grads):
            ref = np.asarray(ref) * scale
            _close(np.asarray(got), np.asarray(ref), f"step {step} {path}")
        jparams, state = adam(port_grads, state, jparams)
        n = 0
        for path, ref, got in _pairs(jparams, params):
            _close(got.detach().numpy(), np.asarray(ref),
                   f"step {step} {path}")
            n += 1
        assert n == len(param_leaves(params))


@pytest.mark.parametrize("variant", ["ted", "bi_agg"])
def test_params_from_numpy_carries_the_gates(variant):
    flags = VARIANTS[variant][0]
    jmodel = jax_get_model(JaxConfig(**KW, **flags), jax_synthetic(**DATA))
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(np_params, device="cpu")
    assert set(params["gates"]) == set(np_params["gates"])
    n = 0
    for path, ref, got in _pairs(np_params, params):
        np.testing.assert_array_equal(got.numpy(), ref, path)
        n += 1
    # the port's own init has the same tree and shapes
    own = _port(variant)[2].init_params(0)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(own)] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(np_params)]
    assert n == len(param_leaves(own))


def test_last_checkpoint_restores_the_gates(tmp_path):
    cfg, data, model = _port("ted", experiments_dir=str(tmp_path))
    tr = Trainer(cfg, model, data)
    params, optimizer = tr.init_state()
    tr.train_step(params, optimizer, T_POS, [True, True],
                  gen=tr.step_generator(0, 0))
    tr.save_last(params, optimizer, 0, 0.5, 0)
    got, opt2, start, best = tr.load_last()
    assert (start, best) == (1, (0.5, 0))
    for (path, ref, x) in _pairs(params, got):
        assert torch.equal(ref.detach(), x.detach()), path
    assert set(got["gates"]) == {"subject", "object"}
    state = optimizer.state_dict()["state"]
    assert all(torch.equal(state[k]["exp_avg"], v["exp_avg"])
               for k, v in opt2.state_dict()["state"].items())


def test_main_cli_trains_ted_on_cpu(tmp_path, capsys, one_thread):
    root = _write_dataset(tmp_path / "data")
    out = run_cli([
        "-c", os.path.join(ROOT, "grid", "icews14", "config_bigrrgcn.json"),
        "--post-ensemble", "--device", "cpu", "--fast-dev-run", "--data-root",
        root, "--dataset", "tiny", "--edge-pad-multiple", "16", "--embed-size",
        "16", "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
        "--batch-size", "2", "--experiments-dir", str(tmp_path / "runs"),
        "--model-name", "ted",
    ], capsys)
    assert "module=BiGRRGCN" in out
    assert "epoch 0:" in out and "test: mrr=" in out
    ckpt = torch.load(tmp_path / "runs" / "ted" / "checkpoints" / "best.pt",
                      weights_only=True)
    gates = ckpt["params"]["gates"]
    assert set(gates) == {"subject", "object"}
    assert tuple(gates["subject"]["w1"].shape) == (3, 3)


# -- K2's two new modes against the JAX kernel in interpret mode -------------

# (layer 2's ReLU, buffers, direction): the unidirectional Post models'
# windows, and BiGRRGCN's
_NEW_MODES = {"a": (False, 3, None), "b": (True, 2, "bwd")}


def _mode_enc(c, direction, seed=7):
    """An encoder pytree (numpy) on the case's weights, under "gru" or, for
    a direction, under its key with the other direction's GRUs random."""
    rs = np.random.RandomState(seed)
    d = c["loop1"].shape[0]

    def own(i):
        return [{"w_ih": c[f"wih{i}"].T.copy(), "w_hh": c[f"whh{i}"].T.copy(),
                 "b_ih": c[f"bih{i}"], "b_hh": c[f"bhh{i}"]}]

    def other():
        return [{k: (rs.standard_normal(s) * 0.3).astype(np.float32)
                 for k, s in (("w_ih", (3 * d, d)), ("w_hh", (3 * d, d)),
                              ("b_ih", (3 * d,)), ("b_hh", (3 * d,)))}]

    enc = {}
    for i in (1, 2):
        layer = {"weight": c["wrel"][:, (i - 1) * d:i * d].copy(),
                 "loop_weight": c[f"loop{i}"]}
        if direction is None:
            layer["gru"] = own(i)
        else:
            layer["gru_bwd" if direction == "bwd" else "gru_fwd"] = own(i)
            layer["gru_fwd" if direction == "bwd" else "gru_bwd"] = other()
        enc[f"layer{i}"] = layer
    return enc


_BATCHED = ("h0x", "src", "dst", "rel", "em", "gidx", "live", "dt", "m1",
            "m2", "g1", "g2")


@pytest.fixture(scope="module")
def mode_vjp():
    cache = {}

    def get(mode):
        if mode not in cache:
            act2, n_buf, _ = _NEW_MODES[mode]
            # one window (the JAX side runs each in interpret mode)
            c = {k: v[:1] if k in _BATCHED else v
                 for k, v in _window_case(0.1, seed=4).items()}
            c["g3"] = np.random.RandomState(9).standard_normal(
                c["g1"].shape).astype(np.float32)
            cache[mode] = (c,) + _jax_flagship_window_vjp(
                c, 0.1, act2=act2, n_buf=n_buf)
        return cache[mode]

    return get


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("mode", list(_NEW_MODES))
def test_window_new_modes_match_pallas_interpret_vjp(mode_vjp, mode,
                                                     kernels):
    """K2 (its plain version here) in mode (a), three buffers without the
    ReLU on "gru", and mode (b), two buffers with the ReLU on "gru_bwd",
    against the JAX kernel's vjp: the buffers and the 12 cotangents from a
    random cotangent on every buffer, with dropout."""
    act2, n_buf, direction = _NEW_MODES[mode]
    c, ref_bufs, ref_dh0x, ref_dws = mode_vjp(mode)
    enc = params_from_numpy(_mode_enc(c, direction), device="cpu")
    key = {"bwd": "gru_bwd", "fwd": "gru_fwd", None: "gru"}[direction]
    leaves = [enc[f"layer{i}"][k] for i in (1, 2)
              for k in ("weight", "loop_weight")]
    leaves += [t for i in (1, 2) for t in enc[f"layer{i}"][key][0].values()]
    for t in leaves:
        t.requires_grad_(True)
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    h0 = T["h0x"].clone().requires_grad_(True)
    A = h0.shape[2]
    prev_step = torch.where(T["live"] > 0, T["gidx"] // A, -1)
    bufs = fused_window_scan(
        enc, TKGConfig(embed_size=16, hidden_size=16, n_bases=16), h0,
        T["src"], T["dst"], T["rel"], T["em"], prev_step, T["gidx"] % A,
        T["dt"], T["live"] > 0, kernels=kernels, masks=(T["m1"], T["m2"]),
        direction=direction, activation2="relu" if act2 else None,
        n_buf=n_buf)
    assert len(bufs) == len(ref_bufs) == n_buf
    for got, ref in zip(bufs, ref_bufs):
        _close(got.detach().numpy(), ref)
    sum((b * T[g]).sum() for b, g in zip(bufs, ("g1", "g2", "g3"))).backward()
    _close(h0.grad.numpy(), ref_dh0x, "dh0x")
    got = {"wrel": torch.cat([enc["layer1"]["weight"].grad,
                              enc["layer2"]["weight"].grad], 1),
           "loop1": enc["layer1"]["loop_weight"].grad,
           "loop2": enc["layer2"]["loop_weight"].grad}
    for i in (1, 2):
        g = enc[f"layer{i}"][key][0]
        got.update({f"wih{i}": g["w_ih"].grad.t(),
                    f"whh{i}": g["w_hh"].grad.t(),
                    f"bih{i}": g["b_ih"].grad, f"bhh{i}": g["b_hh"].grad})
    names = ("wrel", "loop1", "loop2", "wih1", "whh1", "wih2", "whh2",
             "bih1", "bhh1", "bih2", "bhh2")
    for name, ref in zip(names, ref_dws):
        _close(got[name].numpy(), ref, name)
