"""The training slice of temp_tpu_torch against the JAX package (CPU, f32).

The JAX side runs its Pallas kernels in interpret mode (rel_spmm_pallas and
the whole-window kernel with fused_window=True), with fused_final off, the
configuration this slice ports. Its random draws (threefry bits) cannot be
replayed by a torch.Generator, so the tests rebuild the JAX key derivation,
draw every mask with jax.random, and hand them to the port as `draws`.
TF32 plays no part on the CPU; both sides compute in float32.

Tolerances: 1e-5 absolute for outputs and cotangents of order one
(float32 sums in another order); gradients that sum over many terms are
held to 1e-5 relative to max(1, the largest entry).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import build_tkg_data as jax_build_tkg_data
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.dynamic import gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.fused_window import _fused_window
from temp_tpu.ops.pallas_spmm import rel_spmm_pallas
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_history_tables, build_tkg_data, make_synthetic, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops.fused_window import (
    fused_window_bwd, fused_window_fwd, fused_window_scan,
)
from temp_tpu_torch.ops.segment import rel_spmm
from temp_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
          batch_size=3, seed=0, num_pos_facts=20)
DATA = dict(num_ents=40, num_rels=5, num_times=12, edges_per_time=30,
            seed=3)
T_POS = [5, 7, 2]


def _close(a, b, what="", rel=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= rel * max(1.0, float(np.abs(b).max(initial=0.0))), \
        (what, err)


def _pairs(jtree, ttree, path=""):
    """(path, jax leaf, torch leaf or None) over matching dict/list trees."""
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (list, tuple)):
        for i, (j, t) in enumerate(zip(jtree, ttree)):
            yield from _pairs(j, t, f"{path}/{i}")
    else:
        yield path, jtree, ttree


def _torch_params(np_params):
    params = params_from_numpy(np_params, device="cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def jax_draws(cfg, data, t_pos, rng):
    """Every draw of JAX's DynamicRGCNModel.loss (fused window, unfused
    final step), by the model's own key derivation: split(rng, B) per
    element; split -> (r_fwd, r_loss); split(r_fwd, 3) -> (k_pre, k_fin,
    k_sub); the window masks from split(k_pre) at (L1, Ap, d), Ap = A
    rounded up to 128, sliced to A; the final step's from split(k_fin);
    the edge subsample from k_sub; the positives from split(r_loss, 3)[0]."""
    L = cfg.train_seq_len
    L1, A, N, d = L - 1, data.act_idx.shape[1], data.num_ents, cfg.embed_size
    Ap = -(-A // 128) * 128
    keep = 1.0 - cfg.dropout
    out = {k: [] for k in ("win1", "win2", "fin1", "fin2", "edges", "pos")}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        k_pre, k_fin, k_sub = jax.random.split(r_fwd, 3)
        for key, k in zip(("win1", "win2"), jax.random.split(k_pre)):
            out[key].append(np.asarray(
                jax.random.bernoulli(k, keep, (L1, Ap, d)))[:, :A])
        for key, k in zip(("fin1", "fin2"), jax.random.split(k_fin)):
            out[key].append(np.asarray(jax.random.bernoulli(k, keep, (N, d))))
        win = gather_window(data, jnp.int32(t), L)
        out["edges"].append(np.asarray(
            jax_subsample_edges(k_sub, win.emask[L - 1], 0.5)))
        out["pos"].append(np.asarray(jax_subsample_pos(
            jax.random.split(r_loss, 3)[0], data.train.emask[t],
            cfg.num_pos_facts)))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}
    if cfg.dropout == 0.0:
        draws.update(win1=None, win2=None, fin1=None, fin2=None)
    return draws


# -- K1: relational SpMM backward -------------------------------------------

def test_rel_spmm_grads_match_pallas_interpret():
    rs = np.random.RandomState(0)
    n, e, r, d = 40, 50, 10, 16
    h = rs.standard_normal((n, d)).astype(np.float32)
    w = rs.standard_normal((r, d)).astype(np.float32)
    src, dst, rel = (rs.randint(0, m, e).astype(np.int32)
                     for m in (n, n // 2, r))
    em = rs.rand(e) < 0.8
    g = rs.standard_normal((n, d)).astype(np.float32)

    def f(h, w):
        out = rel_spmm_pallas(h, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(rel), jnp.asarray(em), w, n,
                              interpret=True)
        return jnp.sum(out * g)

    ref_h, ref_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    before = spmm_bwd.launches
    out = rel_spmm(th, torch.from_numpy(src), torch.from_numpy(dst),
                   torch.from_numpy(rel), torch.from_numpy(em), tw, d, d, n)
    (out * torch.from_numpy(g)).sum().backward()
    assert spmm_bwd.launches == before  # the CPU runs the plain version
    _close(th.grad.numpy(), np.asarray(ref_h))
    _close(tw.grad.numpy(), np.asarray(ref_w))


# -- K2: whole-window recurrence backward -----------------------------------

def _window_case(rate, seed=0):
    """Inputs of B windows whose history tables come from simulated entity
    activity (each live row names its entity's last earlier row)."""
    rs = np.random.RandomState(seed)
    B, L1, A, E, d, R2 = 2, 3, 20, 24, 16, 10
    prev_step = np.full((B, L1, A), -1, np.int32)
    prev_row = np.zeros((B, L1, A), np.int32)
    for b in range(B):
        last = {}
        for k in range(L1):
            ents = rs.permutation(2 * A)[:A]
            for a, ent in enumerate(ents):
                if ent in last:
                    prev_step[b, k, a], prev_row[b, k, a] = last[ent]
            for a, ent in enumerate(ents):
                last[ent] = (k, a)
    keep = 1.0 - rate
    c = dict(
        h0x=rs.standard_normal((B, L1, A, d)).astype(np.float32),
        src=rs.randint(0, A, (B, L1, E)).astype(np.int32),
        dst=rs.randint(0, A, (B, L1, E)).astype(np.int32),
        rel=rs.randint(0, R2, (B, L1, E)).astype(np.int32),
        em=(rs.rand(B, L1, E) < 0.8).astype(np.float32),
        gidx=(np.maximum(prev_step, 0) * A + prev_row).astype(np.int32),
        live=(prev_step >= 0).astype(np.float32),
        dt=(np.arange(L1)[None, :, None]
            - np.maximum(prev_step, 0)).astype(np.float32),
        m1=(rs.rand(B, L1, A, d) < keep).astype(np.float32) / keep,
        m2=(rs.rand(B, L1, A, d) < keep).astype(np.float32) / keep,
        g1=rs.standard_normal((B, L1, A, d)).astype(np.float32),
        g2=rs.standard_normal((B, L1, A, d)).astype(np.float32))
    w = {"wrel": (R2, 2 * d), "loop1": (d, d), "loop2": (d, d),
         "wih1": (d, 3 * d), "whh1": (d, 3 * d), "wih2": (d, 3 * d),
         "whh2": (d, 3 * d), "bih1": (3 * d,), "bhh1": (3 * d,),
         "bih2": (3 * d,), "bhh2": (3 * d,)}
    c.update({k: (rs.standard_normal(s) * 0.3).astype(np.float32)
              for k, s in w.items()})
    return c


_COT = ("wrel", "loop1", "loop2", "wih1", "whh1", "wih2", "whh2", "bih1",
        "bhh1", "bih2", "bhh2")


def _jax_window_vjp(c, rate, lam=0.1):
    """Per element: jax.vjp of temp_tpu.ops.fused_window._fused_window in
    interpret mode, inputs padded as fused_window_scan pads them. Returns
    (buf1, buf2, cotangents in _COT order after dh0x), summed over the
    elements for the weights."""
    B, L1, A, d = c["h0x"].shape
    E, R2 = c["src"].shape[-1], c["wrel"].shape[0]
    Ap = Ep = Rp = 128
    static = (L1, Ap, Ep, d, Rp, rate, False, lam, True, 2, None, "float32",
              True, False)
    pa, pe = ((0, 0), (0, Ap - A)), ((0, 0), (0, Ep - E))
    pm = ((0, 0), (0, Ap - A), (0, 0))
    ws = [jnp.pad(c["wrel"], ((0, Rp - R2), (0, 0)))] + [
        jnp.asarray(c[k])[None] if k.startswith("b") else jnp.asarray(c[k])
        for k in _COT[1:]]
    bufs, dh0x, dws = [], [], None
    for b in range(B):
        gidx = (c["gidx"][b] // A) * Ap + c["gidx"][b] % A
        col = lambda x, pad, v=0: jnp.pad(x, pad, constant_values=v)[..., None]  # noqa: E731
        ins = (col(gidx, pa), col(c["live"][b], pa), col(c["dt"][b], pa),
               jnp.pad(c["m1"][b], pm), jnp.pad(c["m2"][b], pm))
        edges = (col(c["src"][b], pe, Ap - 1), col(c["dst"][b], pe, Ap - 1),
                 col(c["rel"][b], pe), col(c["em"][b], pe))

        def f(h0p, *w):
            return _fused_window(static, h0p, *edges, *ins, *w)  # noqa: B023

        outs, vjp = jax.vjp(f, jnp.pad(c["h0x"][b], pm), *ws)
        cts = vjp(tuple(jnp.pad(c[g][b], pm).reshape(L1 * Ap, d)
                        for g in ("g1", "g2")))
        bufs.append([np.asarray(o).reshape(L1, Ap, d)[:, :A] for o in outs])
        dh0x.append(np.asarray(cts[0])[:, :A])
        w_ct = [np.asarray(x) for x in cts[1:]]
        dws = w_ct if dws is None else [x + y for x, y in zip(dws, w_ct)]
    dws[0] = dws[0][:R2]
    dws = [x[0] if k.startswith("b") else x for k, x in zip(_COT, dws)]
    return bufs, np.stack(dh0x), dws


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_window_bwd_plain_matches_pallas_interpret_vjp(rate):
    c = _window_case(rate)
    bufs, ref_dh0x, ref_dws = _jax_window_vjp(c, rate)
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    g1 = {n: T[f"{k}1"] for n, k in (("wih_t", "wih"), ("whh_t", "whh"),
                                     ("bih", "bih"), ("bhh", "bhh"))}
    g2 = {n: T[f"{k}2"] for n, k in (("wih_t", "wih"), ("whh_t", "whh"),
                                     ("bih", "bih"), ("bhh", "bhh"))}
    m1, m2 = (T["m1"], T["m2"]) if rate > 0 else (None, None)
    args = (T["h0x"], T["src"], T["dst"], T["rel"], T["em"], T["gidx"],
            T["live"], T["dt"], T["wrel"], T["loop1"], T["loop2"], g1, g2,
            0.1)
    b1, b2 = fused_window_fwd(*args, False, m1, m2)
    for b, (r1, r2) in enumerate(bufs):
        _close(b1[b].numpy(), r1)
        _close(b2[b].numpy(), r2)
    before = fused_window_bwd.launches
    grads = fused_window_bwd(*args, m1, m2, b1, b2, T["g1"], T["g2"])
    assert fused_window_bwd.launches == before  # CPU: the plain version
    assert len(grads) == 12
    _close(grads[0].numpy(), ref_dh0x)
    for name, got, ref in zip(_COT, grads[1:], ref_dws):
        _close(got.numpy(), ref, name)


def test_history_tables_name_each_earlier_row_once():
    """K2b adds the cotangent of a row's previous state into the row that
    gidx names with a plain read-add-store. That is exact because no two
    live rows of a window name the same earlier row: a row (j, r) holds one
    entity, and only that entity's next active step reads it. Dead rows
    (prev_step = -1) all name row 0 but add nothing (live = 0)."""
    data = make_synthetic(num_ents=60, num_rels=5, num_times=40,
                          edges_per_time=25, seed=5)
    for length in (4, 15):
        tbl = build_history_tables(data, length)
        A = data.act_idx.shape[1]
        for t in range(data.num_times):
            live = tbl.prev_step[t] >= 0
            named = (tbl.prev_step[t].astype(np.int64) * A
                     + tbl.prev_row[t])[live]
            assert len(np.unique(named)) == len(named)
            steps = np.nonzero(live)[0]
            assert (tbl.prev_step[t][live] < steps).all()


# -- the model's loss and its gradients -------------------------------------

@pytest.fixture(scope="module")
def jax_loss_reference():
    cfg = JaxConfig(fused_window=True, fused_final=False, dropout=0.1, **KW)
    data = jax.device_put(jax_synthetic(**DATA))
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(1)
    tv = jnp.asarray([True, True, False])

    def loss_fn(p):
        return model.loss(p, data, jnp.asarray(T_POS, jnp.int32), tv, rng)

    # one compile, not one for each eager op of the model, with XLA's
    # optimizations off (tests/test_torch_post.py's ``_xla_unoptimized``:
    # less compile time, the same arithmetic up to float32 rounding)
    from test_torch_post import _xla_unoptimized
    with _xla_unoptimized():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (float(loss), grads, jax.tree_util.tree_map(np.asarray, params),
            jax_draws(cfg, data, T_POS, rng))


@pytest.mark.parametrize("fused_window,kernels", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_loss_and_grads_match_reference(jax_loss_reference, fused_window,
                                        kernels):
    ref_loss, ref_grads, np_params, draws = jax_loss_reference
    cfg = TKGConfig(fused_window=fused_window, kernels=kernels, dropout=0.1,
                    **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    params = _torch_params(np_params)
    loss = model.loss(params, to_device(data, "cpu"), T_POS,
                      [True, True, False], draws=draws)
    loss.backward()
    assert abs(loss.item() - ref_loss) <= ATOL * max(1.0, abs(ref_loss))
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(param_leaves(params))


def test_loss_with_fused_final_on_raises():
    """fused_final resolves as fused_window does: "auto" is on for CUDA and
    off for the CPU, and an explicit on runs K3-K5's plain versions on the
    CPU (tests/test_torch_fused_final.py holds them to the JAX package).
    The other negative pools lie outside K3-K5's envelope: their final
    step runs one element at a time."""
    cfg = TKGConfig(fused_final=True, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.fused_final_on()
    params = model.init_params(0)
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True] * 3,
                      gen=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and loss.item() > 0.0
    assert TKGConfig(**KW).fused_final_on("cuda") is True
    assert TKGConfig(**KW).fused_final_on("cpu") is False
    for pool in ("shared", "per_query"):
        cfg = TKGConfig(fused_final=True, negative_pool=pool, **KW)
        model = get_model(cfg, data, device="cpu")
        assert not model.fused_final_on()
        loss = model.loss(model.init_params(0), to_device(data, "cpu"),
                          T_POS, [True] * 3,
                          gen=torch.Generator().manual_seed(0))
        assert torch.isfinite(loss) and loss.item() > 0.0


def test_three_optimizer_steps_match_optax():
    """Adam with L2 and the global-norm clip: the port's train_step against
    optax's make_optimizer chain applied to JAX's gradients, with the same
    draws each step. No dropout here (the loss test covers the masks), so
    the JAX side can take its scan path."""
    kw = {**KW, "dropout": 0.0, "lr": 0.01}
    jcfg = JaxConfig(fused_window=False, fused_final=False, **kw)
    data = jax.device_put(jax_synthetic(**DATA))
    jmodel = jax_get_model(jcfg, data)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    opt = jax_make_optimizer(jcfg)
    state = opt.init(jparams)

    @jax.jit  # one compile, not one for each eager op of the chain
    def adam(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    tv = jnp.asarray([True, True, True])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, r: jmodel.loss(p, data, jnp.asarray(T_POS, jnp.int32), tv,
                                 r)))

    cfg = TKGConfig(**kw)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    tr = Trainer(cfg, model, make_synthetic(**DATA))
    params = _torch_params(jax.tree_util.tree_map(np.asarray, jparams))
    optimizer = make_optimizer(cfg, params)
    for step in range(3):
        rng = jax.random.PRNGKey(10 + step)
        jloss, grads = grad_fn(jparams, rng)
        jparams, state = adam(grads, state, jparams)
        loss = tr.train_step(params, optimizer, T_POS, [True] * 3,
                             draws=jax_draws(jcfg, data, T_POS, rng))
        assert abs(float(loss) - float(jloss)) <= ATOL * max(1.0,
                                                             float(jloss))
    for path, ref, got in _pairs(jparams, params):
        _close(got.detach().numpy(), np.asarray(ref), path)


# -- data, the Trainer and the CLI ------------------------------------------

def run_cli(argv, capsys):
    """The training CLI in this process (``temp_tpu_torch.main.main``, what
    ``python -m temp_tpu_torch.main`` runs) with `argv`: its standard
    output."""
    from temp_tpu_torch.main import main

    main(argv)
    return capsys.readouterr().out


def _write_dataset(root, num_ents=30, num_rels=4, num_times=8, n=160,
                   seed=0):
    """A tiny dataset directory in the standard text layout."""
    rs = np.random.RandomState(seed)
    path = os.path.join(root, "interpolation", "tiny")
    os.makedirs(path)
    for name, m in (("train", n), ("valid", n // 4), ("test", n // 4)):
        q = np.stack([rs.randint(0, num_ents, m), rs.randint(0, num_rels, m),
                      rs.randint(0, num_ents, m),
                      rs.randint(0, num_times, m)], 1)
        np.savetxt(os.path.join(path, f"{name}.txt"), q, fmt="%d",
                   delimiter="\t")
    with open(os.path.join(path, "stat.txt"), "w") as f:
        f.write(f"{num_ents}\t{num_rels}\t{num_times}\n")
    return str(root)


@pytest.mark.parametrize("dataset_dir", ["interpolation", "extrapolation"])
def test_build_tkg_data_matches_reference(tmp_path, dataset_dir):
    root = _write_dataset(tmp_path / "data")
    if dataset_dir == "extrapolation":
        os.symlink(os.path.join(root, "interpolation"),
                   os.path.join(root, "extrapolation"))
    kw = dict(data_root=root, dataset="tiny", dataset_dir=dataset_dir,
              edge_pad_multiple=16)
    ref = jax_build_tkg_data(JaxConfig(**kw), cache=False)
    cache = str(tmp_path / "cache")
    built = build_tkg_data(TKGConfig(**kw), cache_dir=cache)
    cached = build_tkg_data(TKGConfig(**kw), cache_dir=cache)
    assert len(os.listdir(cache)) == 1
    for got in (built, cached):
        for (path, r, g) in _pairs(_fields(ref), _fields(got)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r), path)


def _fields(d):
    import dataclasses
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif isinstance(v, (int, np.ndarray)):
            out[f.name] = np.asarray(v)
    return out


def test_fit_writes_run_and_reload_reproduces_eval(tmp_path):
    cfg = TKGConfig(**{**KW, "dropout": 0.1, "patience": 5})
    data = make_synthetic(**DATA)
    tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data,
                 run_dir=str(tmp_path / "run"))
    lines = []
    out = tr.fit(max_epochs=2, log_fn=lines.append)
    assert len(lines) == 2 and out["last_epoch"] == 1
    recs = [json.loads(x) for x in
            open(tmp_path / "run" / "metrics.jsonl").read().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in recs)
    assert json.load(open(tmp_path / "run" / "config.json"))["seed"] == 0
    assert os.path.exists(tr.ckpt_path())
    assert not os.path.exists(tr.last_ckpt_path())  # removed at the end
    params, optimizer, extra = tr.load_checkpoint()
    assert extra["epoch"] == out["best_epoch"]
    assert optimizer.state_dict()["state"]  # Adam moments restored
    assert tr.run_eval(params, "valid")["mrr"] == pytest.approx(
        extra["metrics"]["mrr"], abs=1e-12)
    # the last-state checkpoint round trip resumes the epoch count
    tr.save_last(out["params"], out["optimizer"], 1, 0.5, 0)
    p2, o2, start, best = tr.load_last()
    assert start == 2 and best == (0.5, 0)
    for a, b in zip(param_leaves(p2), param_leaves(out["params"])):
        assert torch.equal(a.detach(), b.detach())


def test_epoch_randomness_depends_on_seed_and_epoch_only():
    cfg = TKGConfig(**KW)
    data = make_synthetic(**DATA)
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data)
        params, opt = tr.init_state()
        runs.append(tr.train_epoch(params, opt, epoch=3))
    assert runs[0] == runs[1]
    b3 = [t.tolist() for t, _ in tr.epoch_batches(3)]
    assert b3 != [t.tolist() for t, _ in tr.epoch_batches(4)]


def test_main_cli_fast_dev_run_on_cpu(tmp_path):
    root = _write_dataset(tmp_path / "data")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "temp_tpu_torch.main", "-c",
         os.path.join(ROOT, "grid", "icews14", "config_grrgcn.json"),
         "--device", "cpu", "--fast-dev-run", "--data-root", root,
         "--dataset", "tiny", "--edge-pad-multiple", "16",
         "--embed-size", "16", "--hidden-size", "16", "--n-bases", "16",
         "--train-seq-len", "3", "--batch-size", "2",
         "--experiments-dir", str(tmp_path / "runs"), "--model-name", "cli"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "epoch 0:" in proc.stdout and "test: mrr=" in proc.stdout
    run = tmp_path / "runs" / "cli"
    # the flat metrics dict, as the JAX package's main.py writes it
    test = json.load(open(run / "test_metrics.json"))
    assert test["n"] > 0 and 0.0 < test["mrr"] <= 1.0
    assert {"mrr", "hit_1", "hit_3", "hit_10", "loss"} <= set(test)
    assert os.path.exists(run / "checkpoints" / "best.pt")
