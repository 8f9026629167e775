"""The flagship BiGRRGCN --impute (PostBiDynamicRGCNModel) of temp_tpu_torch
against the JAX package on the CPU, float32.

The JAX side runs its Pallas kernels in interpret mode (the whole-window
kernel in its n_buf=3, ReLU and gru_bwd modes, and the bi+impute final step
of temp_tpu/ops/fused_final_bi.py). Its random draws (threefry bits) cannot
be replayed by a torch.Generator, so the tests rebuild the JAX key
derivation of PostBiDynamicRGCNModel.loss (temp_tpu/models/post.py:437-447),
draw every mask with jax.random and hand them to the port as `draws`. The
port's kernels are not reached on the CPU: every wrapper runs its plain
version, the fused final step's backward as the JAX kernels' own formulas
(``kernels=True``) or autograd through the plain forward
(``kernels=False``).

Tolerances: 1e-5 relative to max(1, the largest entry) for losses,
buffers and cotangents (float32 sums in another order; the helper of
tests/test_torch_train.py); eval ranks equal (the float paths agree to
about 1e-6, far from any rank-changing gap at these seeds) and MRR within
1e-6.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.dynamic import gather_window as jax_gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.models.registry import (
    normalize_remap_flags as jax_normalize_remap_flags,
)
from temp_tpu.ops.fused_final_bi import fused_final_bi_loss as jax_bi_loss
from temp_tpu.ops.fused_window import _fused_window
from temp_tpu.ops.fused_window import fused_window_scan as jax_scan
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.train.loop import Trainer as JaxTrainer
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch import _build
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, to_device,
)
from temp_tpu_torch.models.baselines import HyteModel
from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel
from temp_tpu_torch.models.dynamic import DynamicRGCNModel
from temp_tpu_torch.models.post import (
    PostBiDynamicRGCNModel, PostDynamicRGCNModel,
)
from temp_tpu_torch.models.registry import get_model, normalize_remap_flags
from temp_tpu_torch.models.selfattn import BiSelfAttentionRGCNModel
from temp_tpu_torch.models.static import StaticRGCNModel
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_final_bi as fb
from temp_tpu_torch.ops.fused_window import (
    fused_window_scan, fused_window_supported,
)
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import (
    _close, _pairs, _torch_params, _window_case, _write_dataset, run_cli,
)


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile,
    as tests/test_torch_post.py's ``_xla_unoptimized`` (about a third less
    compile time; the same arithmetic up to float32 rounding)."""
    from test_torch_post import _xla_unoptimized
    with _xla_unoptimized():
        yield


KW = dict(module="BiGRRGCN", impute=True, embed_size=16, hidden_size=16,
          n_bases=16, train_seq_len=3, batch_size=2, seed=0,
          num_pos_facts=100)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edges_per_time=25,
            edge_pad_multiple=16)
T_POS = [5, 2]


def _open_impute(params):
    """The JAX params with impute scalars whose w * dt + b > 0 for the
    windows' dt (1 or 2 here), so their gradients are not clamped to 0
    (the seeded init leaves them clamped)."""
    enc = dict(params["encoder"], impute_w_fwd=jnp.float32(0.3),
               impute_b_fwd=jnp.float32(0.2),
               impute_w_bwd=jnp.float32(-0.1),
               impute_b_bwd=jnp.float32(0.5))
    return dict(params, encoder=enc)


def jax_draws_bi(cfg, data, t_pos, rng):
    """Every draw of JAX's PostBiDynamicRGCNModel.loss (fused window; fused
    or unfused final step, which derive their keys alike): split(rng, B)
    per element; split -> (r_fwd, r_loss); split(r_fwd, 4) -> (k_f, k_b,
    k_fin, k_sub); each window's masks from split(k_dir) at (L1, Ap, d),
    Ap = A rounded up to 128, sliced to A; the final step's from
    split(k_fin); the edge subsample from k_sub; the positives from
    split(r_loss, 3)[0]."""
    L = cfg.train_seq_len
    L1, A, N, d = L - 1, data.act_idx.shape[1], data.num_ents, cfg.embed_size
    Ap = -(-A // 128) * 128
    keep = 1.0 - cfg.dropout
    keys = ("win1", "win2", "win1_b", "win2_b", "fin1", "fin2", "edges",
            "pos")
    out = {k: [] for k in keys}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        k_f, k_b, k_fin, k_sub = jax.random.split(r_fwd, 4)
        for names, k_dir in ((("win1", "win2"), k_f),
                             (("win1_b", "win2_b"), k_b)):
            for key, k in zip(names, jax.random.split(k_dir)):
                out[key].append(np.asarray(
                    jax.random.bernoulli(k, keep, (L1, Ap, d)))[:, :A])
        for key, k in zip(("fin1", "fin2"), jax.random.split(k_fin)):
            out[key].append(np.asarray(jax.random.bernoulli(k, keep, (N, d))))
        win = jax_gather_window(data, jnp.int32(t), L)
        out["edges"].append(np.asarray(
            jax_subsample_edges(k_sub, win.emask[L - 1], 0.5)))
        out["pos"].append(np.asarray(jax_subsample_pos(
            jax.random.split(r_loss, 3)[0], data.train.emask[t],
            cfg.num_pos_facts)))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}
    if cfg.dropout == 0.0:
        draws.update({k: None for k in keys[:6]})
    return draws


# -- (a) K2's flagship modes: n_buf=3, ReLU on layer 2, gru_bwd -------------

_COT = ("wrel", "loop1", "loop2", "wih1", "whh1", "wih2", "whh2", "bih1",
        "bhh1", "bih2", "bhh2")


def _enc_params(c, gen_seed=7):
    """An encoder pytree (numpy) with both directions' GRUs: gru_bwd from
    the case's weights, gru_fwd other random ones (so a wrong pick shows)."""
    rs = np.random.RandomState(gen_seed)
    d = c["loop1"].shape[0]

    def gru(i, own):
        if not own:
            return [{k: (rs.standard_normal(s) * 0.3).astype(np.float32)
                     for k, s in (("w_ih", (3 * d, d)), ("w_hh", (3 * d, d)),
                                  ("b_ih", (3 * d,)), ("b_hh", (3 * d,)))}]
        return [{"w_ih": c[f"wih{i}"].T.copy(), "w_hh": c[f"whh{i}"].T.copy(),
                 "b_ih": c[f"bih{i}"], "b_hh": c[f"bhh{i}"]}]

    return {f"layer{i}": {"weight": c["wrel"][:, (i - 1) * d:i * d].copy(),
                          "loop_weight": c[f"loop{i}"],
                          "gru_fwd": gru(i, False), "gru_bwd": gru(i, True)}
            for i in (1, 2)}


def _jax_flagship_window_vjp(c, rate, lam=0.1, act2=True, n_buf=3):
    """Per element: jax.vjp of _fused_window in its act2 / n_buf mode
    (interpret; the flagship's: the ReLU and three buffers) on the case's
    weights, with a cotangent on every buffer (g1, g2, g3). Returns (bufs
    [n_buf of B, L1, A, d], dh0x, weight cotangents)."""
    B, L1, A, d = c["h0x"].shape
    E, R2 = c["src"].shape[-1], c["wrel"].shape[0]
    Ap = Ep = Rp = 128
    static = (L1, Ap, Ep, d, Rp, rate, act2, lam, True, n_buf, None,
              "float32", True, False)
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
        cts = vjp((jnp.pad(c["g1"][b], pm).reshape(L1 * Ap, d),
                   jnp.pad(c["g2"][b], pm).reshape(L1 * Ap, d),
                   jnp.pad(c["g3"][b], pm))[:n_buf])
        bufs.append([np.asarray(o).reshape(L1, Ap, d)[:, :A] for o in outs])
        dh0x.append(np.asarray(cts[0])[:, :A])
        w_ct = [np.asarray(x) for x in cts[1:]]
        dws = w_ct if dws is None else [x + y for x, y in zip(dws, w_ct)]
    dws[0] = dws[0][:R2]
    dws = [x[0] if k.startswith("b") else x for k, x in zip(_COT, dws)]
    return [np.stack(x) for x in zip(*bufs)], np.stack(dh0x), dws


@pytest.fixture(scope="module")
def window_vjp():
    """rate -> (case, the JAX vjp's buffers, dh0x and weight cotangents),
    computed on first use."""
    cache = {}

    def get(rate):
        if rate not in cache:
            c = _window_case(rate)
            c["g3"] = np.random.RandomState(9).standard_normal(
                c["g1"].shape).astype(np.float32)
            cache[rate] = (c,) + _jax_flagship_window_vjp(c, rate)
        return cache[rate]

    return get


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_window_flagship_modes_match_pallas_interpret_vjp(window_vjp, rate,
                                                         kernels):
    """The backward window of the flagship: K2 on the gru_bwd weights with a
    ReLU on layer 2 and the third (local) buffer; the three buffers and the
    12 cotangents from a random cotangent on all three buffers."""
    c, ref_bufs, ref_dh0x, ref_dws = window_vjp(rate)
    enc = params_from_numpy(_enc_params(c), device="cpu")
    leaves = [enc[f"layer{i}"][k] for i in (1, 2)
              for k in ("weight", "loop_weight")]
    leaves += [t for i in (1, 2) for t in enc[f"layer{i}"]["gru_bwd"][0]
               .values()]
    for t in leaves:
        t.requires_grad_(True)
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    h0 = T["h0x"].clone().requires_grad_(True)
    B, L1, A, _ = h0.shape
    prev_step = torch.where(T["live"] > 0, T["gidx"] // A, -1)
    masks = None if rate == 0 else (T["m1"], T["m2"])
    bufs = fused_window_scan(
        enc, TKGConfig(embed_size=16, hidden_size=16, n_bases=16), h0,
        T["src"], T["dst"], T["rel"], T["em"], prev_step, T["gidx"] % A,
        T["dt"], T["live"] > 0, kernels=kernels, masks=masks,
        direction="bwd", activation2="relu", n_buf=3)
    assert len(bufs) == 3
    for got, ref in zip(bufs, ref_bufs):
        _close(got.detach().numpy(), ref)
    sum((b * T[g]).sum() for b, g in zip(bufs, ("g1", "g2", "g3"))).backward()
    _close(h0.grad.numpy(), ref_dh0x, "dh0x")
    got = {"wrel": torch.cat([enc["layer1"]["weight"].grad,
                              enc["layer2"]["weight"].grad], 1),
           "loop1": enc["layer1"]["loop_weight"].grad,
           "loop2": enc["layer2"]["loop_weight"].grad}
    for i in (1, 2):
        g = enc[f"layer{i}"]["gru_bwd"][0]
        got.update({f"wih{i}": g["w_ih"].grad.t(), f"whh{i}": g["w_hh"].grad.t(),
                    f"bih{i}": g["b_ih"].grad, f"bhh{i}": g["b_hh"].grad})
        assert enc[f"layer{i}"]["gru_fwd"][0]["w_ih"].grad is None
    for name, ref in zip(_COT, ref_dws):
        _close(got[name].numpy(), ref, name)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_window_scan_directions_match_jax_scan(direction):
    """The eval window of either direction through the JAX package's own
    fused_window_scan (n_buf=3, the Bi layer-2 ReLU) and the port's."""
    c = _window_case(0.0, seed=1)
    enc_np = _enc_params(c)
    B, L1, A, d = c["h0x"].shape
    live = c["live"] > 0
    prev_step = np.where(live, c["gidx"] // A, -1).astype(np.int32)
    prev_row = (c["gidx"] % A).astype(np.int32)
    jcfg = JaxConfig(module="BiGRRGCN", embed_size=d, hidden_size=d,
                     n_bases=d)
    from temp_tpu.models.encoders import make_layer_cfgs
    _, lc2 = make_layer_cfgs(jcfg, 5, 10)
    assert lc2.activation == "relu"
    enc = params_from_numpy(enc_np, device="cpu")
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    got = fused_window_scan(
        enc, TKGConfig(embed_size=d, hidden_size=d, n_bases=d), T["h0x"],
        T["src"], T["dst"], T["rel"], T["em"], torch.from_numpy(prev_step),
        torch.from_numpy(prev_row), T["dt"], torch.from_numpy(live),
        direction=direction, activation2="relu", n_buf=3)
    for b in range(B):
        ref = jax_scan(enc_np, jcfg, lc2, c["h0x"][b], c["src"][b],
                       c["dst"][b], c["rel"][b], c["em"][b] > 0,
                       prev_step[b], prev_row[b], c["dt"][b], live[b],
                       jax.random.PRNGKey(0), False, 3, direction=direction,
                       interpret=True)
        for x, y in zip(got, ref):
            _close(x[b].numpy(), np.asarray(y))


def test_window_envelope_takes_the_relu():
    cfg = TKGConfig(**KW)
    assert fused_window_supported(cfg, "GRRGCN", "relu", train=True)
    assert not fused_window_supported(cfg, "GRRGCN", "tanh")


# -- (b) the bi final step's plain versions against fused_final_bi_loss -----

T_ONE = [5]  # the batch of the per-element reference (B = 2 in (d))


@pytest.fixture(scope="module")
def final_case():
    """Per element: fused_final_bi_loss (interpret) on random history and
    JAX's initial weights, its loss and the gradients of the weights and of
    the six history tables; with the inputs and draws for the port."""
    cache = {}

    def get(noact):
        if noact in cache:
            return cache[noact]
        cfg = JaxConfig(fused_final=True, fused_window=True, dropout=0.1,
                        use_embed_for_non_active=noact, **KW)
        data = jax.device_put(jax_synthetic(**DATA))
        model = jax_get_model(cfg, data)
        params = _open_impute(model.init_params(jax.random.PRNGKey(0)))
        rs = np.random.RandomState(3)
        N, d, L1 = data.num_ents, cfg.embed_size, cfg.train_seq_len - 1
        hists = [(rs.standard_normal((len(T_ONE), N, d)) * 0.5)
                 .astype(np.float32) for _ in range(6)]
        lps = [rs.randint(0, L1, (len(T_ONE), N)).astype(np.float32)
               for _ in range(2)]
        keep = 1.0 - cfg.dropout
        losses, grads = [], []
        draws = {k: [] for k in ("fin1", "fin2", "edges", "pos")}
        for b, t in enumerate(T_ONE):
            k_drop, k_pos, k_sub = jax.random.split(jax.random.PRNGKey(20 + b),
                                                    3)
            em_full = data.train.emask[t]
            em_enc = jax_subsample_edges(k_sub, em_full, 0.5)
            for key, k in zip(("fin1", "fin2"), jax.random.split(k_drop)):
                draws[key].append(np.asarray(
                    jax.random.bernoulli(k, keep, (N, d))))
            draws["edges"].append(np.asarray(em_enc))
            draws["pos"].append(np.asarray(jax_subsample_pos(
                k_pos, em_full, cfg.num_pos_facts)))

            def f(p, h1f, h2f, hlf, h1b, h2b, hlb):
                return jax_bi_loss(
                    p, cfg, model.lc2, data, h1f, h2f, hlf,  # noqa: B023
                    lps[0][b], h1b, h2b, hlb, lps[1][b],  # noqa: B023
                    data.train.src[t], data.train.dst[t],  # noqa: B023
                    data.train.rel[t], em_enc, em_full, t,  # noqa: B023
                    k_drop, k_pos, True)  # noqa: B023

            loss, g = jax.jit(jax.value_and_grad(f, argnums=tuple(range(7))))(
                params, *(h[b] for h in hists))
            losses.append(float(loss))
            grads.append(g)
        cache[noact] = (np.asarray(losses), grads,
                        jax.tree_util.tree_map(np.asarray, params), hists,
                        lps, {k: torch.from_numpy(np.stack(v))
                              for k, v in draws.items()})
        return cache[noact]

    return get


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("noact", [False, True])
def test_final_step_matches_fused_final_bi_loss(final_case, noact, kernels):
    ref_loss, ref_grads, np_params, hists, lps, draws = final_case(noact)
    cfg = TKGConfig(dropout=0.1, use_embed_for_non_active=noact, **KW)
    host = make_synthetic(**DATA)
    data = to_device(host, "cpu")
    answers = to_device(build_answer_lists(host), "cpu")
    tp = torch.tensor(T_ONE)
    bg = fb.final_graph_bi(data, answers, tp, draws, torch.from_numpy(lps[0]),
                           torch.from_numpy(lps[1]), cfg.inv_temperature, 0.1,
                           cfg.train_seq_len, True, noact)
    params = _torch_params(np_params)
    hs = [torch.from_numpy(h).requires_grad_(True) for h in hists]
    launches = (fb.bi_layer_fwd.launches, fb.bi_loss_fwd.launches,
                fb.bi_layer_bwd.launches, ff.fused_final_bwd_loss.launches)
    loss = fb.fused_final_bi_loss(params, bg, hs, kernels=kernels)
    _close(loss.detach().numpy(), ref_loss, "loss")
    loss.sum().backward()
    assert (fb.bi_layer_fwd.launches, fb.bi_loss_fwd.launches,
            fb.bi_layer_bwd.launches,
            ff.fused_final_bwd_loss.launches) == launches  # the CPU: plain
    n = 0
    for path, _, got in _pairs(ref_grads[0][0], params):
        ref = sum(np.asarray(_leaf(g[0], path)) for g in ref_grads)
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), ref, path)
        n += 1
    assert n == len(param_leaves(params))
    for i, h in enumerate(hs):
        for b in range(len(T_ONE)):
            _close(h.grad[b].numpy(), np.asarray(ref_grads[b][1 + i]),
                   f"hist {i} element {b}")
    # the blend reaches the impute scalars (some entities are inactive),
    # unless the select replaces every inactive row by its input embedding
    enc = params["encoder"]
    scalars = [float(enc[k].grad.abs()) for k in (
        "impute_w_fwd", "impute_b_fwd", "impute_w_bwd", "impute_b_bwd")]
    assert all(g == 0.0 if noact else g > 0 for g in scalars), scalars


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def test_layer_backward_plain_matches_autograd():
    """K9+K10's plain formulas against autograd through the plain layer
    forward, both layers' modes (ReLU and blend on, and off), every
    cotangent including the four impute scalars."""
    host = make_synthetic(**DATA)
    data = to_device(host, "cpu")
    answers = to_device(build_answer_lists(host), "cpu")
    gen = torch.Generator().manual_seed(1)
    B, N, d = len(T_POS), host.num_ents, 16
    tp = torch.tensor(T_POS)
    em = data.train.emask[tp]
    draws = {"edges": em & (torch.rand(em.shape, generator=gen) < 0.5),
             "pos": em, "fin1": torch.rand(B, N, d, generator=gen) < 0.9,
             "fin2": torch.rand(B, N, d, generator=gen) < 0.9}
    lp = [torch.randint(0, 2, (B, N), generator=gen).float() for _ in "fb"]
    bg = fb.final_graph_bi(data, answers, tp, draws, lp[0], lp[1], 0.1, 0.1,
                           3, True, False)
    rnd = lambda *s: torch.randn(*s, generator=gen) * 0.5  # noqa: E731
    for relu, blend in ((True, True), (False, False)):
        leaves = [rnd(B, N, d), rnd(B, N, d), rnd(B, N, d), rnd(6, 2 * d),
                  rnd(d, d)] + [rnd(*s) for _ in "fb" for s in
                                ((d, 3 * d), (d, 3 * d), (3 * d,), (3 * d,))]
        hl = [rnd(B, N, d), rnd(B, N, d)] if blend else None
        imp = torch.tensor([0.4, -0.3, -0.6, 0.5]) if blend else None
        extra = (hl + [imp]) if blend else []
        leaves = [t.requires_grad_(True) for t in leaves + extra]
        x, pf, pb, w, lw = leaves[:5]
        gf = dict(zip(fb._GRU_PARTS, leaves[5:9]))
        gb = dict(zip(fb._GRU_PARTS, leaves[9:13]))
        args = (bg, bg.gr.m2, w, d, lw, gf, gb)
        kw = dict(relu=relu, hl=hl, imp=imp)
        d_out = rnd(B, N, d)
        (fb.bi_layer_fwd_plain(x, pf, pb, *args, **kw) * d_out).sum().backward()
        got = fb.bi_layer_bwd_plain(x, pf, pb, *args, d_out, **kw)
        refs = [x.grad, pf.grad, pb.grad] + (
            [hl[0].grad, hl[1].grad, imp.grad] if blend else [None] * 3) + [
            w.grad[:, d:], lw.grad] + [t.grad for t in leaves[5:13]]
        for i, (a, b) in enumerate(zip(got, refs)):
            if b is None:
                assert a is None
                continue
            _close(a.detach().numpy(), b.numpy(), f"cotangent {i}")
        assert float(w.grad[:, :d].abs().max()) == 0.0


# -- (c) eval ranks -----------------------------------------------------------

@pytest.mark.parametrize("fused_window", [True, False])
def test_eval_ranks_match_reference(fused_window, tmp_path):
    cfg_kw = {**KW, "dropout": 0.0}
    jdata = jax_synthetic(**DATA)
    jcfg = JaxConfig(fused_window=False, fused_final=False, **cfg_kw)
    jmodel = jax_get_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(2))
    jtr = JaxTrainer(jcfg, jmodel, jax.device_put(jdata),
                     run_dir=str(tmp_path / "ref"))
    tp, tv = jtr._stack_batches(jdata.num_times, jcfg.eval_batch, None)
    ref_ranks, ref_mask, _ = jtr.eval_epoch(params, jtr.data, tp, tv, "valid")
    ref_m = jtr.run_eval(params, "valid")
    ref_ranks, ref_mask = np.asarray(ref_ranks), np.asarray(ref_mask)

    cfg = TKGConfig(fused_window=fused_window, **cfg_kw)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert isinstance(model, PostBiDynamicRGCNModel)
    tr = Trainer(cfg, model, data)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    assert model.precompute_eval_conv1(tparams, tr.data) is None
    ranks, mask, _ = tr.eval_sweep(tparams, "valid")
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ranks.numpy()[ref_mask],
                                  ref_ranks[ref_mask])
    m = tr.run_eval(tparams, "valid")
    assert m["n"] == ref_m["n"] > 0
    assert abs(m["mrr"] - ref_m["mrr"]) <= 1e-6
    assert abs(m["loss"] - ref_m["loss"]) <= 1e-5


# -- (d) the model's loss, gradients and Adam steps --------------------------

@pytest.fixture(scope="module")
def jax_flagship_loss():
    """(loss, grads, numpy params, draws) of the JAX flagship's loss with
    fused_window on (interpret) and its unfused final step, which its fused
    one equals (tests/test_fused_final_bi.py; the port's fused final step
    is held to JAX's directly above)."""
    cfg = JaxConfig(fused_final=False, fused_window=True, dropout=0.1, **KW)
    data = jax.device_put(jax_synthetic(**DATA))
    model = jax_get_model(cfg, data)
    params = _open_impute(model.init_params(jax.random.PRNGKey(0)))
    rng = jax.random.PRNGKey(1)
    tv = jnp.asarray([True, True])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, data, jnp.asarray(T_POS, jnp.int32), tv,
                             rng)))(params)
    return (float(loss), grads, jax.tree_util.tree_map(np.asarray, params),
            jax_draws_bi(cfg, data, T_POS, rng))


@pytest.mark.parametrize("fused_final,kernels", [(True, True), (True, False),
                                                 (False, True)])
def test_loss_and_grads_match_reference(jax_flagship_loss, fused_final,
                                        kernels):
    ref_loss, ref_grads, np_params, draws = jax_flagship_loss
    cfg = TKGConfig(fused_final=fused_final, fused_window=True,
                    kernels=kernels, dropout=0.1, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.fused_final_on() == fused_final
    params = _torch_params(np_params)
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=draws)
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(param_leaves(params))
    enc = params["encoder"]
    assert all(float(enc[k].grad.abs()) > 0 for k in (
        "impute_w_fwd", "impute_b_fwd", "impute_w_bwd", "impute_b_bwd"))


@pytest.fixture(scope="module")
def jax_adam():
    """The JAX side of the Adam test: config, data, initial params, optax
    chain and the jitted loss-and-gradient (unfused scan path)."""
    kw = {**KW, "dropout": 0.0, "lr": 0.01}
    jcfg = JaxConfig(fused_window=False, fused_final=False, **kw)
    data = jax.device_put(jax_synthetic(**DATA))
    jmodel = jax_get_model(jcfg, data)
    tv = jnp.asarray([True, True])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, r: jmodel.loss(p, data, jnp.asarray(T_POS, jnp.int32), tv,
                                 r)))
    return (kw, jcfg, data, jmodel.init_params(jax.random.PRNGKey(0)),
            jax_make_optimizer(jcfg), grad_fn)


@pytest.mark.parametrize("fused_final", [True, False])
def test_three_optimizer_steps_match_optax(jax_adam, fused_final):
    """Three of the port's train_steps on the flagship, fused or unfused
    final step, held to JAX on one trajectory: at each step JAX's loss and
    gradients (its unfused scan path, whose loss the fused one equals; no
    dropout, so the draws do not depend on the window path) at the port's
    current parameters, with the same draws, agree with the port's to 1e-5,
    and optax's chain applied to the port's gradients gives the port's new
    parameters to 1e-5.

    One trajectory, not two: at these sizes a few entries' gradient plus
    weight decay u lies near Adam's eps (1e-8), where the step
    lr * u / (|u| + eps) is decided by the rounding of u. With these seeds
    a layer-1 gru_bwd w_ih entry has u = -2.1e-8 against JAX's -2.5e-8
    (gradients 4e-9 apart); on two separate trajectories its first step
    differs by 5% of lr and moves the next steps' gradients of that layer,
    and some entries end 1.5e-5 apart."""
    kw, jcfg, data, jparams, opt, grad_fn = jax_adam
    state = opt.init(jparams)

    @jax.jit  # one compile, not one for each eager op of the chain
    def adam(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    cfg = TKGConfig(fused_final=fused_final, **kw)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    assert model.fused_final_on() == fused_final
    tr = Trainer(cfg, model, make_synthetic(**DATA))
    params = _torch_params(jax.tree_util.tree_map(np.asarray, jparams))
    optimizer = make_optimizer(cfg, params)

    def to_jax(tree, grad):
        # a copy: jnp.asarray may alias the numpy view of a tensor that the
        # optimizer then updates in place
        return jax.tree_util.tree_map(
            lambda j, t: jnp.asarray((t.grad if grad else t).detach()
                                     .numpy().copy()), jparams, tree)

    for step in range(3):
        rng = jax.random.PRNGKey(10 + step)
        jparams = to_jax(params, False)
        jloss, grads = grad_fn(jparams, rng)
        loss = tr.train_step(params, optimizer, T_POS, [True, True],
                             draws=jax_draws_bi(jcfg, data, T_POS, rng))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0,
                                                             float(jloss))
        # the port's gradients after its clip (a no-op below the clip norm,
        # and idempotent above it); optax clips them again
        norm = np.sqrt(sum(float(jnp.sum(g * g))
                           for g in jax.tree_util.tree_leaves(grads)))
        assert norm < cfg.gradient_clip_val
        port_grads = to_jax(params, True)
        for path, ref, got in _pairs(grads, port_grads):
            _close(np.asarray(got), np.asarray(ref), f"step {step} {path}")
        jparams, state = adam(port_grads, state, jparams)
        n = 0
        for path, ref, got in _pairs(jparams, params):
            _close(got.detach().numpy(), np.asarray(ref),
                   f"step {step} {path}")
            n += 1
        assert n == len(param_leaves(params))


# -- (e) the registry -----------------------------------------------------

def test_registry_dispatches_the_flagship_and_refuses_the_rest():
    data = make_synthetic(**DATA)
    model = get_model(TKGConfig(**KW), data, device="cpu")
    assert type(model) is PostBiDynamicRGCNModel
    assert model.tbl_bwd is not None
    # the TeMP variants and plain BiGRRGCN, after the remap of the flags
    for over, cls in (
            ({"module": "GRRGCN", "impute": True}, PostDynamicRGCNModel),
            ({"module": "GRRGCN", "impute": False, "post_ensemble": True},
             PostDynamicRGCNModel),
            ({"module": "GRRGCN", "post_ensemble": True},
             PostDynamicRGCNModel),
            ({"module": "GRRGCN", "impute": False,
              "post_aggregation": True}, PostDynamicRGCNModel),
            ({"post_ensemble": True}, PostBiDynamicRGCNModel),
            ({"post_aggregation": True}, PostBiDynamicRGCNModel),
            ({"impute": False, "post_ensemble": True},
             PostBiDynamicRGCNModel),
            ({"impute": False}, BiDynamicRGCNModel),
            ({"module": "GRRGCN", "impute": False}, DynamicRGCNModel),
            ({"module": "BiSARGCN"}, BiSelfAttentionRGCNModel),
            # the linear-recurrence and static models, and the flagship
            # with the recurrent options
            ({"module": "BiRRGCN", "impute": False}, BiDynamicRGCNModel),
            ({"module": "SRGCN"}, StaticRGCNModel),
            ({"use_time_embedding": True}, PostBiDynamicRGCNModel),
            ({"type1": True}, PostBiDynamicRGCNModel),
            ({"edge_dropout": True}, PostBiDynamicRGCNModel),
            # the other decoders and pools, and the baselines
            ({"score_function": "distmult"}, PostBiDynamicRGCNModel),
            ({"negative_pool": "shared"}, PostBiDynamicRGCNModel),
            ({"module": "Hyte"}, HyteModel)):
        m = get_model(TKGConfig(**{**KW, **over}), data, device="cpu")
        assert type(m) is cls, over
        m.init_params(0)
    # under an edge partition GRRGCN, plain BiGRRGCN and the flagship
    # build, with ComplEx and the "all" pool
    for over in ({}, {"impute": False}, {"module": "GRRGCN",
                                         "impute": False}):
        cfg = TKGConfig(**{**KW, **over, "edge_partition": "ring",
                           "mp_size": 4})
        get_model(cfg, data, device="cpu").init_params(0)
    # RRGCN's TeMP variants, and every other model, option, decoder or
    # pool under an edge partition
    for over in ({"module": "BiRRGCN"},
                 {"module": "GRRGCN", "impute": False,
                  "score_function": "distmult", "edge_partition": "psum",
                  "mp_size": 4},
                 {"module": "GRRGCN", "impute": False,
                  "negative_pool": "shared", "edge_partition": "ring",
                  "mp_size": 4},
                 {"module": "BiSARGCN", "edge_partition": "psum",
                  "mp_size": 4},
                 {"post_ensemble": True, "edge_partition": "ring",
                  "mp_size": 4},
                 {"module": "GRRGCN", "post_aggregation": True,
                  "impute": False, "edge_partition": "psum", "mp_size": 4},
                 {"impute": False, "type1": True, "edge_partition": "ring",
                  "mp_size": 4}):
        with pytest.raises(NotImplementedError):
            m = get_model(TKGConfig(**{**KW, **over}), data, device="cpu")
            m.init_params(0)


@pytest.mark.parametrize("module", ["GRRGCN", "RRGCN", "BiGRRGCN", "BiRRGCN",
                                    "SARGCN", "BiSARGCN", "SRGCN"])
def test_normalize_remap_flags_matches_reference(module):
    names = ("impute", "post_aggregation", "post_ensemble")
    for bits in range(8):
        flags = {n: bool(bits >> i & 1) for i, n in enumerate(names)}
        got = normalize_remap_flags(TKGConfig(module=module, **flags))
        ref = jax_normalize_remap_flags(JaxConfig(module=module, **flags))
        assert [getattr(got, n) for n in names] == [getattr(ref, n)
                                                    for n in names]


# -- (f) the bi pytree across the bridge, and the CLI ------------------------

def test_params_from_numpy_carries_the_bi_pytree():
    jdata = jax_synthetic(**DATA)
    jmodel = jax_get_model(JaxConfig(**KW), jdata)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(np_params, device="cpu")
    enc = params["encoder"]
    for i in (1, 2):
        assert set(enc[f"layer{i}"]) >= {"gru_fwd", "gru_bwd"}
        assert "gru" not in enc[f"layer{i}"]
    for k in ("impute_w_fwd", "impute_b_fwd", "impute_w_bwd",
              "impute_b_bwd"):
        assert enc[k].shape == () and enc[k].dtype == torch.float32
        assert float(enc[k]) == float(np_params["encoder"][k])
    n = 0
    for path, ref, got in _pairs(np_params, params):
        np.testing.assert_array_equal(got.numpy(), ref, path)
        n += 1
    # the port's own init has the same tree, shapes and scalars
    model = get_model(TKGConfig(**KW), make_synthetic(**DATA), device="cpu")
    own = model.init_params(0)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(own)] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(np_params)]
    assert n == len(param_leaves(own))


def test_main_cli_trains_the_flagship_on_cpu(tmp_path, capsys, one_thread):
    root = _write_dataset(tmp_path / "data")
    out = run_cli([
        "-c", os.path.join(ROOT, "grid", "icews14", "config_bigrrgcn.json"),
        "--impute", "--device", "cpu", "--fast-dev-run", "--data-root", root,
        "--dataset", "tiny", "--edge-pad-multiple", "16", "--embed-size", "16",
        "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
        "--batch-size", "2", "--fused-final", "on", "--experiments-dir",
        str(tmp_path / "runs"), "--model-name", "bi",
    ], capsys)
    assert "module=BiGRRGCN" in out
    assert "epoch 0:" in out and "test: mrr=" in out
    ckpt = torch.load(tmp_path / "runs" / "bi" / "checkpoints" / "best.pt",
                      weights_only=True)
    assert ckpt["params"]["encoder"]["impute_w_fwd"].shape == ()


# -- the kernels' plumbing, without a card ------------------------------------

def test_launcher_signatures_match_the_sources():
    """Every ctypes signature in _build.SIGNATURES has the argument types of
    its extern "C" declaration in csrc/*.cu, in order."""
    src = "".join(open(p).read() for p in _build.SOURCES)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    assert {"bi_layer_launch", "bi_bwd_gru_launch",
            "bi_wgrad_launch"} <= set(_build.SIGNATURES)
    for name, sig in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                      re.S)
        assert m, name
        types = [kinds[a.strip().rsplit(" ", 1)[0].strip()]
                 for a in m.group(1).split(",")]
        assert types == sig, name


def test_fused_flagship_step_launches_the_kernels_in_order(monkeypatch):
    """With the wrappers told the tensors lie on a card and a library that
    records its calls: the flagship's fused training step makes the calls
    ``_build.SIGNATURES`` declares, in the order of the JAX package's
    ``_fused_final_bi_fwd``/``_bwd``: K6+K7 for both layers (without the
    GRU input's output), K8, then K4, K9+K10 for layer 2 and for layer 1."""
    kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
             ctypes.c_float: float, ctypes.c_longlong: int}
    calls = []

    class Recorder:
        def __getattr__(self, name):
            sig = _build.SIGNATURES[name]

            def launch(*args):
                assert len(args) == len(sig), name
                for a, t in zip(args, sig):
                    assert isinstance(a, kinds[t]) and not isinstance(
                        a, bool), (name, a)
                assert name != "bi_layer_launch" or args[-5] is None
                calls.append(name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(ff, "_device", lambda name, t: "cuda")
    monkeypatch.setattr(fb, "_device", lambda name, t: "cuda")
    cfg = TKGConfig(fused_final=True, fused_window=False, dropout=0.1,
                    use_embed_for_non_active=True, **KW)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    params = model.init_params(0)
    for p in param_leaves(params):
        p.requires_grad_(True)
    counts = (fb.bi_layer_fwd.launches, fb.bi_loss_fwd.launches,
              ff.fused_final_bwd_loss.launches, fb.bi_layer_bwd.launches)
    loss = model.loss(params, to_device(make_synthetic(**DATA), "cpu"),
                      T_POS, [True, False],
                      gen=torch.Generator().manual_seed(0))
    loss.backward()
    layer_bwd = ["bi_bwd_gru_launch", "final_bwd_input_launch",
                 "bi_wgrad_launch", "final_wgrad_reduce_launch",
                 "final_rel_grad_launch"]
    assert calls == (["bi_layer_launch"] * 2
                     + ["final_scores_launch", "final_loss_reduce_launch",
                        "final_dq_launch", "final_dq_finish_launch",
                        "final_dtable_launch", "final_rel_grad_launch"]
                     + layer_bwd + layer_bwd)
    assert (fb.bi_layer_fwd.launches - counts[0],
            fb.bi_loss_fwd.launches - counts[1],
            ff.fused_final_bwd_loss.launches - counts[2],
            fb.bi_layer_bwd.launches - counts[3]) == (2, 2, 4, 10)


def _recorded_bi_layer(monkeypatch, layer: int, d: int = 16):
    """One bi layer's operands (layer 2 with the ReLU and the impute blend,
    layer 1 without; d_out last) with the wrappers told they lie on a card
    and a library that checks each call's argument count and types against
    ``_build.SIGNATURES`` and records it: its name, or for the bi layer's
    forward and GRU launches (name, relu flag, whether the optional output
    is given). Returns (args, kw, calls)."""
    kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
             ctypes.c_float: float, ctypes.c_longlong: int}
    calls = []

    class Recorder:
        def __getattr__(self, name):
            sig = _build.SIGNATURES[name]

            def launch(*args):
                assert len(args) == len(sig), name
                for a, t in zip(args, sig):
                    assert isinstance(a, kinds[t]) and not isinstance(
                        a, bool), (name, a)
                # the GRU input (forward) and the ReLU's pattern (GRU launch)
                calls.append((name, args[10], args[-5] is not None)
                             if name in ("bi_bwd_gru_launch",
                                         "bi_layer_launch") else name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(fb, "_device", lambda name, t: "cuda")
    host = make_synthetic(**DATA)
    data = to_device(host, "cpu")
    answers = to_device(build_answer_lists(host), "cpu")
    gen = torch.Generator().manual_seed(2)
    B, N = len(T_POS), host.num_ents
    tp = torch.tensor(T_POS)
    em = data.train.emask[tp]
    draws = {"edges": em, "pos": em,
             "fin1": torch.rand(B, N, d, generator=gen) < 0.9,
             "fin2": torch.rand(B, N, d, generator=gen) < 0.9}
    lp = [torch.randint(0, 2, (B, N), generator=gen).float() for _ in "fb"]
    bg = fb.final_graph_bi(data, answers, tp, draws, lp[0], lp[1], 0.1, 0.1,
                           3, True, False)
    rnd = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    grus = [{k: rnd(*((3 * d,) if k.startswith("b") else (d, 3 * d)))
             for k in fb._GRU_PARTS} for _ in "fb"]
    relu = layer == 2
    kw = dict(relu=relu, hl=(rnd(B, N, d), rnd(B, N, d)) if relu else None,
              imp=rnd(4) if relu else None)
    args = (rnd(B, N, d), rnd(B, N, d), rnd(B, N, d), bg,
            bg.gr.m2 if relu else bg.gr.m1, rnd(2 * host.num_rels, 2 * d),
            d if relu else 0, rnd(d, d), *grus, rnd(B, N, d))
    return args, kw, calls


@pytest.mark.parametrize("layer", [1, 2])
def test_bi_layer_fwd_launches_match_the_library_signatures(monkeypatch,
                                                            layer):
    """K6+K7's plumbing, rehearsed on the CPU with a recording library: one
    layer forward makes one launch with the argument count and types that
    ``_build.SIGNATURES`` declares, without the GRU input's output (null on
    the main path); ``bi_gru_input`` makes the same launch with it and
    returns a [B, N, d] tensor. Each launch counts on
    ``bi_layer_fwd.launches``; a width the tiles do not take (not a
    multiple of 16) is refused before any launch."""
    args, kw, calls = _recorded_bi_layer(monkeypatch, layer)
    relu = int(layer == 2)
    before = fb.bi_layer_fwd.launches
    out = fb.bi_layer_fwd(*args[:10], **kw)
    gin = fb.bi_gru_input(*args[:10], **kw)
    assert calls == [("bi_layer_launch", relu, False),
                     ("bi_layer_launch", relu, True)]
    assert tuple(out.shape) == tuple(gin.shape) == tuple(args[1].shape)
    assert fb.bi_layer_fwd.launches - before == 2
    args, kw, calls = _recorded_bi_layer(monkeypatch, layer, d=24)
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.bi_layer_fwd(*args[:10], **kw)
    assert calls == []


@pytest.mark.parametrize("layer", [1, 2])
def test_bi_layer_bwd_launches_match_the_library_signatures(monkeypatch,
                                                            layer):
    """K9+K10's plumbing, rehearsed on the CPU with a library that records
    its calls: one layer backward (layer 2 with the ReLU and the impute
    blend, layer 1 without) makes the GRU, input, weight, weight-sum and
    relation launches in that order, each with the argument count and types
    that ``_build.SIGNATURES`` declares, the GRU launch without the ReLU
    pattern's output; ``bi_relu_pattern`` and ``bi_bwd_gru_launcher`` make
    the GRU launch alone, the first with that output. Each launch counts on
    ``bi_layer_bwd.launches``."""
    args, kw, calls = _recorded_bi_layer(monkeypatch, layer)
    relu = layer == 2
    B, N, d = args[1].shape
    before = fb.bi_layer_bwd.launches
    out = fb.bi_layer_bwd(*args, **kw)
    assert calls == [("bi_bwd_gru_launch", int(relu), False),
                     "final_bwd_input_launch", "bi_wgrad_launch",
                     "final_wgrad_reduce_launch", "final_rel_grad_launch"]
    assert len(out) == 16 and tuple(out[0].shape) == (B, N, d)
    assert (out[3] is None) == (not relu) and (out[5] is None) == (not relu)
    calls.clear()
    pattern = fb.bi_relu_pattern(*args, **kw)
    assert tuple(pattern.shape) == (B, N, d)
    fb.bi_bwd_gru_launcher(*args, **kw)()
    assert calls == [("bi_bwd_gru_launch", int(relu), True),
                     ("bi_bwd_gru_launch", int(relu), False)]
    assert fb.bi_layer_bwd.launches - before == 7


def test_final_bi_envelope():
    cfg = TKGConfig(**KW)
    assert fb.fused_final_bi_supported(cfg, "GRRGCN")
    for out in (cfg.replace(impute=False), cfg.replace(module="GRRGCN"),
                cfg.replace(post_ensemble=True),
                cfg.replace(score_function="distmult"),
                cfg.replace(negative_pool="shared"), cfg.replace(n_bases=8),
                cfg.replace(embed_size=256, hidden_size=256, n_bases=256)):
        assert not fb.fused_final_bi_supported(out, "GRRGCN")
    data = make_synthetic(**DATA)
    assert not get_model(cfg.replace(fused_final=False), data,
                         device="cpu").fused_final_on()
    assert get_model(cfg, data, device="cpu").fused_final_on() is False
    assert cfg.fused_final_on("cuda")
