"""compute_dtype="bfloat16" of temp_tpu_torch against the JAX package's
bfloat16 path (CPU), the last three kernels' slice: K13 (the ring SpMM)
and its backward, K11 (the fused eval), K12 (the batched window), GRRGCN
under the edge partitions "psum", "ring" and "ring_pallas" with 4 ranks,
and GRRGCN's step-by-step windows under random_dropout and edge_dropout.

Both sides run with compute_dtype="bfloat16"; the JAX kernels in Pallas
interpret mode (K13 on tests/conftest.py's virtual CPU devices). The rule
of tests/test_torch_bf16.py, on the same inputs: RMS(port bf16 - JAX
bf16) <= 0.1 * RMS(JAX bf16 - JAX f32), the JAX package's own distance
between its two precisions the yardstick (``_rule``; a leaf where JAX's two
precisions agree exactly must agree here within float32's 1e-5 relative).
Ranks must be equal but for counted near-ties. Measured on these fixtures
(the ratio RMS(port - JAX bf16) / RMS(JAX bf16 - JAX f32)): K13's forward,
its dh (s = 1) and its dw 0 for s = 1 and s = 2, the same float32 sums of
the same rounded values (for s = 2 the JAX transpose reads the unrounded
block weights, so dh is the float32 mode's, held within 1e-5); K11's BCE
0, its ranks equal; K12's buffers 0 in train and eval mode, bit-equal to B
per-element calls of K2's bfloat16 plain version; GRRGCN's loss 0.023
("psum", "ring") and 0 ("ring_pallas"), its gradients at most 0.0020
against JAX's "psum" mode, and against JAX's ring modes at most 0.36
("ring") and 0.33 ("ring_pallas") on layer 1's leaves and the input
embeddings, 0.78 and 0.85 of the bound with the allowance that
``test_partitioned_grrgcn_bf16_matches_jax`` states; under
random_dropout and edge_dropout the loss 0.029 and 0.065, the gradients
at most 0.0015. Where the ratio is not 0 the two sides sum the same
rounded values in float32 in another order, and a sum that lands on a
bfloat16 rounding boundary on one side only flips that rounding.
The file takes about 50 s alone ("ring_pallas"'s interpreted JAX model
at batch 2, train_seq_len 3, about 11 s of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops import fused_final as jax_ff
from temp_tpu.ops.fused_window_mb import (
    fused_window_scan_mb as jax_scan_mb,
)
from temp_tpu.ops.segment import rel_spmm as jax_rel_spmm
from temp_tpu.parallel import edge_partition as jep
from temp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from temp_tpu.parallel.mesh import replicated, use_mesh
from temp_tpu.parallel.ring_pallas import ring_rel_spmm_pallas
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_window as fw
from temp_tpu_torch.ops import fused_window_mb as fmb
from temp_tpu_torch.parallel.edge_partition import (
    EdgePartitionedModel, ring_regroup_data,
)
from temp_tpu_torch.parallel.mesh import make_mesh
from temp_tpu_torch.parallel.ring_spmm import (
    ring_spmm, ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
    ring_spmm_fwd_plain,
)
from temp_tpu_torch.train.optim import param_leaves
import test_torch_fused_window as tfw
import test_torch_ring as tr
from test_torch_bf16 import BF, RULE, _f32, _lookup, _rms, _rule
from test_torch_post import _xla_unoptimized, jax_draws_scan
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _close, _pairs, _torch_params

# the port's side on one intra-op thread (``one_thread``)
pytestmark = pytest.mark.usefixtures("one_thread")

M = tr.M
CPU4 = tr.CPU4


# -- K13: the ring SpMM and its backward ------------------------------------

@pytest.fixture(scope="module")
def jax_ring_bf16():
    """s -> (h, edges, w, cot, {dtype: (out, dh, dw)}): the JAX package's
    K13 in bfloat16 (ring_rel_spmm_pallas, Mosaic interpreter on the
    4-device virtual mesh) and its vjp, for diagonal (s = 1) and 2 x 2
    block weights; the float32 yardstick from the JAX package's segment
    SpMM, to which its own tests hold the float32 kernel."""
    mesh = JaxMesh(np.array(jax.devices()[:M]), ("model",))
    out = {}
    for s in (1, 2):
        nb = tr.D_G // s
        h, edges, w = tr._graph(31 + s, n_bases=nb)
        cot = np.random.RandomState(40 + s).randn(tr.N_G, tr.D_G).astype(
            np.float32)
        jedges = [jnp.asarray(x) for x in edges]
        res = {}
        for dt, fn in (
                (jnp.bfloat16, lambda h, w: ring_rel_spmm_pallas(
                    h, *jedges, w, tr.N_G, mesh, n_bases=nb,
                    dtype=jnp.bfloat16)),
                (None, lambda h, w: jax_rel_spmm(
                    h, *jedges, w, n_bases=nb, d_out=tr.D_G,
                    num_ents=tr.N_G, method="segment"))):
            # jitted: the interpreter's host work runs once a call
            o, dh, dw = jax.jit(lambda h, w, g, fn=fn: (
                lambda o, vjp: (o, *vjp(g)))(*jax.vjp(fn, h, w)))(
                    jnp.asarray(h), jnp.asarray(w), jnp.asarray(cot))
            res[dt] = tuple(np.asarray(x) for x in (o, dh, dw))
        out[s] = (h, edges, w, cot, res)
    return out


@pytest.mark.parametrize("s", [1, 2])
def test_k13_bf16_forward_matches_pallas(jax_ring_bf16, s):
    """K13's bfloat16 plain version (4 CPU ranks) against the JAX kernel's
    bfloat16 instantiation; the CPU wrapper is the plain version, no
    launch; rows without in-edges exactly 0."""
    h, edges, w, _, res = jax_ring_bf16[s]
    th, tw = torch.from_numpy(h)[None], torch.from_numpy(w)
    e = [torch.from_numpy(x)[None] for x in edges]
    rows = tr.N_G // M
    out, n2 = ring_spmm_fwd_plain(th, tw, *e, M, rows, CPU4, hot=BF)
    _rule(out[0], res[jnp.bfloat16][0], res[None][0], f"out s={s}")
    # the degrees stay exact float32: the same norm^2 as float32's
    _, n2_f = ring_spmm_fwd_plain(th, tw, *e, M, rows, CPU4)
    assert torch.equal(n2, n2_f)
    before = ring_spmm_fwd.launches
    got, _ = ring_spmm_fwd(th, tw, *e, M, rows, CPU4, hot=BF)
    assert ring_spmm_fwd.launches == before and torch.equal(got, out)
    dst, em = edges[1], edges[3]
    isolated = np.setdiff1d(np.arange(tr.N_G), dst[em])
    assert len(isolated) > 0 and bool((out[0, isolated] == 0).all())


@pytest.mark.parametrize("s", [1, 2])
def test_k13_bf16_backward_matches_pallas_vjp(jax_ring_bf16, s):
    """K13's bfloat16 backward (``ring_spmm_bwd_plain``, the transpose on
    the rounded residuals) against the vjp of the JAX kernel's bfloat16
    instantiation: dh and dw by the rule; and equal (float32's 1e-5) to
    autograd through the bfloat16 plain forward, with which RingSpMM
    agrees on the CPU."""
    h, edges, w, cot, res = jax_ring_bf16[s]
    th, tw = torch.from_numpy(h)[None], torch.from_numpy(w)
    e = [torch.from_numpy(x)[None] for x in edges]
    g = torch.from_numpy(cot)[None]
    rows = tr.N_G // M
    _, n2 = ring_spmm_fwd_plain(th, tw, *e, M, rows, CPU4, hot=BF)
    dh, dw = ring_spmm_bwd_plain(g, n2, th, tw, *e, M, rows, CPU4, hot=BF)
    if s == 1:
        _rule(dh[0], res[jnp.bfloat16][1], res[None][1], "dh s=1")
    else:
        # the JAX transpose reads the unrounded block weights: dh is the
        # float32 mode's
        dh_f, _ = ring_spmm_bwd_plain(g, n2, th, tw, *e, M, rows, CPU4)
        assert torch.equal(dh, dh_f)
        _close(dh[0].numpy(), res[jnp.bfloat16][1], "dh s=2")
    _rule(dw, res[jnp.bfloat16][2], res[None][2], f"dw s={s}")
    for kernels in (False, True):
        ah, aw = th.clone().requires_grad_(), tw.clone().requires_grad_()
        out = ring_spmm(ah, aw, *e, M, rows, CPU4, kernels=kernels, hot=BF)
        (out * g).sum().backward()
        _close(ah.grad.numpy(), dh.numpy(), "dh autograd")
        _close(aw.grad.numpy(), dw.numpy(), "dw autograd")
    got = ring_spmm_bwd(g, n2, th, tw, *e, M, rows, CPU4, hot=BF)
    assert all(torch.equal(a, b) for a, b in zip(got, (dh, dw)))


# -- K11: the fused eval ------------------------------------------------------

# tests/test_torch_fused_eval.py's sizes
DATA = dict(num_ents=30, num_rels=4, num_times=10, edges_per_time=25,
            edge_pad_multiple=16)
KW = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
          train_seq_len=4, batch_size=3, negative_rate=8, neg_oversample=8,
          num_pos_facts=100, seed=0)
EVAL_T = [5, 7, 2]
# a competitor within this of the target's score is a near-tie (the
# rounding flips of tests/test_torch_bf16.py's NEAR_TIE)
NEAR_TIE = 1e-3


def _near_tie_count(table, rtab, q, ranks, ref_ranks, mask):
    """The queries [B, 2Q] ([head, tail] layout) whose ranks differ from the
    reference's, each checked to hold a competitor within NEAR_TIE of its
    target's score in the port's table, and to differ by at most the
    number of such competitors: their count."""
    from temp_tpu_torch.ops.scores import complex_all

    Q = q.src.shape[1]
    n = 0
    for b, j in np.argwhere((ranks != ref_ranks) & mask):
        qi = j % Q
        s, o, r = (int(x[b, qi]) for x in (q.src, q.dst, q.rel))
        remb = rtab[r][None]
        sc, target = ((complex_all(table[b, o][None], remb, table[b],
                                   "head")[0], s) if j < Q else
                      (complex_all(table[b, s][None], remb, table[b],
                                   "tail")[0], o))
        gap = (sc - sc[target]).abs()
        gap[target] = float("inf")
        assert float(gap.min()) <= NEAR_TIE, (b, j, float(gap.min()))
        assert abs(int(ranks[b, j]) - int(ref_ranks[b, j])) <= int(
            (gap <= NEAR_TIE).sum())
        n += 1
    return n


@pytest.mark.parametrize("noact", [False, True])
def test_k11_bf16_matches_jax(noact):
    """K11's bfloat16 plain version on seeded bfloat16 histories against
    the JAX package's ``fused_eval_ranks`` (interpret mode) under
    compute_dtype="bfloat16", one eval batch of the valid split: the same
    query mask, the ranks equal but for counted near-ties, the BCE by the
    rule (JAX's float32 kernel on the same histories the yardstick); the
    CPU wrapper is the plain version."""
    kw = dict(KW, dropout=0.0, use_embed_for_non_active=noact)
    jdata = jax.device_put(jax_synthetic(**DATA))
    jmodel = jax_get_model(JaxConfig(**kw), jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rs = np.random.RandomState(3)
    B, N, d, L = len(EVAL_T), DATA["num_ents"], kw["embed_size"], 4
    hist = [np.asarray(jnp.asarray(rs.standard_normal((B, N, d)) * 0.5,
                                   jnp.bfloat16)) for _ in range(2)]
    last_pos = rs.randint(0, L - 1, (B, N)).astype(np.float32)
    tp = jnp.asarray(EVAL_T, jnp.int32)
    tr_, ev = jdata.train, jdata.valid
    ref = {}
    for dt in ("bfloat16", "float32"):
        cfg = JaxConfig(compute_dtype=dt, fused_eval=True, **kw)
        model = jax_get_model(cfg, jdata)

        def one(h1, h2, lp, t, cfg=cfg, model=model):
            return jax_ff.fused_eval_ranks(
                params, cfg, model.lc2, jdata, h1, h2, lp, tr_.src[t],
                tr_.dst[t], tr_.rel[t], tr_.emask[t], ev.src[t], ev.dst[t],
                ev.rel[t], ev.emask[t], t)

        with _xla_unoptimized():
            out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in hist),
                                         jnp.asarray(last_pos), tp)
        ref[dt] = tuple(np.asarray(x) for x in out)
    data = to_device(make_synthetic(**DATA), "cpu")
    answers = to_device(build_answer_lists(make_synthetic(**DATA), "valid"),
                        "cpu")
    gr, q = ff.final_graph_eval(data, answers, torch.tensor(EVAL_T),
                                torch.from_numpy(last_pos), 0.1, L, noact,
                                "valid")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    h0, wrel, loop1, loop2, g1, g2, rtab = ff.final_weights(tparams)
    h1, h2 = (torch.from_numpy(x.astype(np.float32)).to(BF) for x in hist)
    args = (h0, h1, h2, gr, q, wrel, loop1, loop2, g1, g2, rtab)
    before = ff.fused_eval_ranks.launches
    ranks, mask, bce = ff.fused_eval_ranks(*args, hot=BF)
    assert ff.fused_eval_ranks.launches == before
    plain = ff.fused_eval_ranks_plain(*args, hot=BF)
    assert all(torch.equal(a, b) for a, b in zip((ranks, mask, bce), plain))
    Q = q.src.shape[1]
    rb, mb, bb = ref["bfloat16"]
    np.testing.assert_array_equal(mask.numpy(), _jax_layout(mb, Q))
    table, _ = ff._encoder_plain(h0, h1, h2, gr, wrel, loop1, loop2, g1, g2,
                                 BF)
    n_ties = _near_tie_count(table, rtab, q, ranks.numpy(),
                             _jax_layout(rb, Q), mask.numpy())
    assert n_ties <= 2, n_ties
    _rule(bce, bb, ref["float32"][2], "bce")


def _jax_layout(x, Q: int):
    """JAX's per-element [head Qp, tail Qp] slots cut to the port's
    [head Q, tail Q]."""
    x = np.asarray(x)
    Qp = x.shape[1] // 2
    return np.concatenate([x[:, :Q], x[:, Qp:Qp + Q]], 1)


# -- K12: the batched window ------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_k12_bf16_matches_jax(train):
    """K12's bfloat16 plain version on tests/test_torch_fused_window.py's
    four windows against the JAX package's ``fused_window_scan_mb`` in
    bfloat16 (interpret mode): train mode with its dropout masks (rebuilt
    from the per-element keys), eval mode on given layer-1 convs
    (conv1_in); the buffers by the rule, bit-equal to B per-element calls
    of K2's bfloat16 plain version; the CPU wrapper is the plain version
    and K2b's bfloat16 backward runs through it."""
    data, _, params = tfw.setup.__wrapped__()
    kw = dict(tfw.KW, dropout=0.1 if train else 0.0)
    model = jax_get_model(JaxConfig(fused_window=True, **kw), data)
    elems = tfw._window_inputs(data, model, params, not train)
    st = {k: jnp.stack([e[k] for e in elems]) for k in elems[0]}
    B, L1, A = st["prev_step"].shape
    d = kw["embed_size"]
    rngs = jax.random.split(jax.random.PRNGKey(5), B)
    ref = {}
    for dt in ("bfloat16", "float32"):
        cfg = JaxConfig(fused_window=True, compute_dtype=dt, **kw)
        with _xla_unoptimized():
            bufs = jax.jit(lambda s, cfg=cfg: jax_scan_mb(
                params["encoder"], cfg, model.lc2, s["h0_xs"], s["src"],
                s["dst"], s["rel"], s["emask"], s["prev_step"],
                s["prev_row"], s["dt"], s["live"], rngs, train, 2,
                interpret=True, conv1_in=not train))(st)
        ref[dt] = [_f32(b) for b in bufs]
    masks = None
    if train:
        keep, Ap = 0.9, 128
        ms = [[np.asarray(jax.random.bernoulli(k, keep, (L1, Ap, d)))[:, :A]
               for k in jax.random.split(r)] for r in rngs]
        masks = tuple(torch.from_numpy(np.stack([m[i] for m in ms]))
                      .to(torch.float32) / keep for i in range(2))
    enc = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                   params["encoder"]), "cpu")
    cfg = TKGConfig(compute_dtype="bfloat16", **kw)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    lc2 = get_model(cfg, make_synthetic(num_ents=30, num_rels=4,
                                        num_times=10, edges_per_time=25),
                    device="cpu").lc2
    args = (enc, cfg, lc2, *(batch[k] for k in (
        "h0_xs", "src", "dst", "rel", "emask", "prev_step", "prev_row", "dt",
        "live")), masks, train, 2)
    plain = fmb.fused_window_scan_mb(*args, conv1_in=not train,
                                     kernels=False)
    for i, buf in enumerate(plain):
        assert buf.dtype == BF
        _rule(buf, ref["bfloat16"][i], ref["float32"][i], f"buf{i + 1}")
    # B per-element calls of K2's bfloat16 plain version, bit for bit
    a = fw.window_args(enc, cfg, *args[3:12], masks if train else None)
    for b in range(B):
        one = fw.fused_window_fwd_plain(
            **{k: v[b:b + 1] if isinstance(v, torch.Tensor) and k not in (
                "wrel", "loop1", "loop2") else v for k, v in a.items()},
            conv1_in=not train, n_buf=2, hot=BF)
        assert all(torch.equal(x[b:b + 1], y) for x, y in zip(plain, one))
    # the wrapper the model calls: the plain version on the CPU, with K2b's
    # bfloat16 backward where it trains
    before = fmb.fused_window_mb_fwd.launches
    h0 = args[3].clone().requires_grad_(train)
    got = fmb.fused_window_scan_mb(*args[:3], h0, *args[4:],
                                   conv1_in=not train)
    assert fmb.fused_window_mb_fwd.launches == before
    assert all(torch.equal(x, y) for x, y in zip(got, plain))
    if train:
        sum((g.float() * (i + 1)).sum() for i, g in enumerate(got)).backward()
        assert h0.grad is not None and bool(torch.isfinite(h0.grad).all())


# -- GRRGCN under the edge partitions ---------------------------------------

# tests/test_torch_ring.py's setup at batch 2: the interpreted JAX model in
# "ring_pallas" mode then takes about 9 s
RING_KW = dict(tr.KW, batch_size=2)
RING_T = [4, 7]


def _jax_partitioned(mode: str, dtype: str, data, params, rng):
    """(loss, grads) of the JAX package's GRRGCN in edge-partition mode
    `mode` over 4 virtual devices."""
    cfg = JaxConfig(edge_partition=mode, compute_dtype=dtype, **RING_KW)
    model = jax_get_model(cfg, data)
    mesh = jax_make_mesh(1, M)
    t_pos = jnp.asarray(RING_T, jnp.int32)
    tv = jnp.asarray([True, True])
    with use_mesh(mesh), _xla_unoptimized():
        wrapped = jep.EdgePartitionedModel(model, mesh, mode=mode)
        sp = jax.device_put(params, replicated(mesh))
        sd = jax.device_put(data, replicated(mesh))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: wrapped.loss(p, sd, t_pos, tv, rng)))(sp)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_ring_model():
    """The JAX package's GRRGCN on the regrouped data, seeded weights: the
    loss and gradients of one batch in each partition mode in bfloat16
    ("ring_pallas": K13 interpreted) and in "ring" mode in float32, the
    draws of its scan window, and the unpartitioned model's bfloat16 eval
    ranks of the valid split."""
    data = jax.device_put(jep.ring_regroup_data(jax_synthetic(**tr.DATA), M))
    cfg = JaxConfig(edge_partition="ring", compute_dtype="bfloat16",
                    **RING_KW)
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(5)
    out = {mode: _jax_partitioned(mode, "bfloat16", data, params, rng)
           for mode in tr.MODES}
    out["f32"] = _jax_partitioned("ring", "float32", data, params, rng)
    with _xla_unoptimized():
        ranks, mask, _ = jax.jit(lambda p: model.eval_ranks(
            p, data, jnp.asarray(tr.T_POS, jnp.int32), jnp.ones(4, bool),
            "valid"))(params)
    return dict(out, params=jax.tree_util.tree_map(np.asarray, params),
                draws=tr.scan_draws(cfg, data, RING_T, rng),
                ranks=np.asarray(ranks), mask=np.asarray(mask))


def _port_ring_model(mode: str, **over):
    cfg = TKGConfig(edge_partition=mode,
                    **{**RING_KW, "compute_dtype": "bfloat16", **over})
    data = ring_regroup_data(make_synthetic(**tr.DATA), M)
    model = get_model(cfg, data, device="cpu")
    return (EdgePartitionedModel(model, make_mesh(1, M, devices=CPU4),
                                 mode=mode), to_device(data, "cpu"))


def _grads_rule(params, ref, ref_f32, what: str, slack=None) -> float:
    """Every gradient leaf by the rule, RMS(port - ref) <= 0.1 RMS(ref -
    ref_f32), plus slack[path] where given; returns the largest ratio of
    RMS(port - ref) to the rule's bound without the slack."""
    worst, n = 0.0, 0
    for path, g_ref, p in _pairs(ref, params):
        got = _f32(torch.zeros_like(p) if p.grad is None else p.grad)
        g_ref = np.asarray(g_ref, np.float64)
        gap = _rms(got - g_ref)
        yard = _rms(g_ref - np.asarray(_lookup(ref_f32, path), np.float64))
        extra = 0.0 if slack is None else slack[path]
        assert gap <= RULE * yard + extra, (what, path, gap, yard, extra)
        worst = max(worst, gap / yard if yard else 0.0)
        n += 1
    assert n == len(param_leaves(params))
    return worst


@pytest.mark.parametrize("mode", tr.MODES)
def test_partitioned_grrgcn_bf16_matches_jax(jax_ring_model, mode):
    """GRRGCN with compute_dtype="bfloat16" over 4 CPU ranks: the loss and
    every gradient of one batch on the JAX package's draws against the JAX
    package's same mode in bfloat16 ("ring_pallas": K13's bfloat16 mode
    against the interpreted kernel's), by the rule, the float32 "ring"
    mode the yardstick (the three modes agree to 1e-6 in float32).

    One allowance: the JAX package's ring modes differentiate through a
    shard_map whose transpose leaves each device only its own rows'
    cotangents upstream of a ring SpMM, so it rounds each device's part of
    a bfloat16 cotangent (the weights' of layer 1, the input embeddings')
    before the parts are summed; the port, one controller, rounds their
    sum, as the JAX package's psum mode and unpartitioned path do. There a
    leaf may also differ from JAX's by the distance between JAX's own
    "ring" and "psum" gradients, which measures that rounding (0 for the
    leaves downstream of the last SpMM: layer 2's and the relation
    embeddings'). The XLA modes' eval ranks equal the JAX package's
    unpartitioned bfloat16 ranks but for counted near-ties."""
    js = jax_ring_model
    wrapped, data = _port_ring_model(mode)
    params = _torch_params(js["params"])
    before = ring_spmm_fwd.launches
    loss = wrapped.loss(params, data, RING_T, [True, True],
                        draws=js["draws"])
    loss.backward()
    assert ring_spmm_fwd.launches == before  # the CPU runs the plain version
    ref = js[mode]
    _rule(np.float64(loss.item()), ref[0], js["f32"][0], f"{mode} loss")
    slack = None
    if mode != "psum":
        slack = {path: _rms(np.asarray(g, np.float64) - np.asarray(
            _lookup(js["psum"][1], path), np.float64))
            for path, g, _ in _pairs(js["ring"][1], params)}
        # the XLA ring is the psum mode's function: held to it alone
        if mode == "ring":
            _grads_rule(params, js["psum"][1], js["f32"][1], "ring/psum")
    _grads_rule(params, ref[1], js["f32"][1], mode, slack)
    if mode == "ring_pallas":
        return
    eparams = params_from_numpy(js["params"], device="cpu")
    with torch.no_grad():
        ranks, mask, _ = wrapped.eval_ranks(eparams, data, tr.T_POS,
                                            [True] * 4, "valid")
    np.testing.assert_array_equal(mask.numpy(), js["mask"])
    off = (ranks.numpy() != js["ranks"]) & js["mask"]
    assert int(off.sum()) <= 2, int(off.sum())


# -- the step-by-step windows under random_dropout and DropEdge ---------------

# tests/test_torch_recurrent.py's setup
DROP_KW = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
               train_seq_len=3, batch_size=2, seed=0, num_pos_facts=100,
               dropout=0.1, lr=0.01)
DROP_DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
                 edges_per_time=25)
DROP_T = [5, 1]


@pytest.mark.parametrize("flag", ["random_dropout", "edge_dropout"])
def test_dropout_windows_bf16_match_jax(flag):
    """GRRGCN with compute_dtype="bfloat16" under random_dropout or
    DropEdge's edge_dropout: the windows step by step on the CPU (the JAX
    package's XLA scan window, which these switches select), the final
    step one element at a time; the loss and every gradient of one batch
    on the JAX package's draws (the windows' edge masks among them) by
    the rule, its float32 run the yardstick."""
    jdata = jax.device_put(jax_synthetic(**DROP_DATA))
    ref = {}
    for dt in ("bfloat16", "float32"):
        cfg = JaxConfig(compute_dtype=dt, **DROP_KW, **{flag: True})
        model = jax_get_model(cfg, jdata)
        if dt == "bfloat16":
            params = model.init_params(jax.random.PRNGKey(0))
        rng = jax.random.PRNGKey(1)
        with _xla_unoptimized():
            loss, grads = jax.jit(jax.value_and_grad(lambda p: model.loss(
                p, jdata, jnp.asarray(DROP_T, jnp.int32),
                jnp.asarray([True, True]), rng)))(params)
        ref[dt] = (float(loss), grads)
        if dt == "bfloat16":
            draws = jax_draws_scan(cfg, jdata, DROP_T, rng,
                                   (model.drop_past, model.drop_future))
    assert draws["win_edges"] is not None
    cfg = TKGConfig(compute_dtype="bfloat16", **DROP_KW, **{flag: True})
    data = ring_layout(cfg, make_synthetic(**DROP_DATA))
    model = get_model(cfg, data, device="cpu")
    assert not (model.fused_window_on(True) or model.fused_final_on())
    tparams = _torch_params(jax.tree_util.tree_map(np.asarray, params))
    loss = model.loss(tparams, to_device(data, "cpu"), DROP_T, [True, True],
                      draws=draws)
    loss.backward()
    _rule(np.float64(loss.item()), ref["bfloat16"][0], ref["float32"][0],
          f"{flag} loss")
    _grads_rule(tparams, ref["bfloat16"][1], ref["float32"][1], flag)


# -- K13's bfloat16 launches, rehearsed without a card -----------------------

def test_k13_bf16_launches_match_the_library_signatures(monkeypatch):
    """With the library replaced by a recorder and the card's stream and
    device contexts by stand-ins, K13's forward and backward on CPU
    tensors in the bfloat16 mode, every rank on one device, take the
    whole-card route: one ``ring_bf16_fwd_launch`` and one
    ``ring_bf16_bwd_launch`` (csrc/ring_spmm_bf16.cu), every float operand
    float32 (h read in place, rounded by the kernels). The stepped route
    (``_ring_fwd_steps``, ``_ring_bwd_steps``) calls the bfloat16 launchers
    ``name_bf16`` with the arguments ``_build.SIGNATURES`` declares for
    ``name``: the forward one launch a ring step, the backward one a step,
    one dw launch and the float32 dw reduction; the visiting shards and
    dw's rows go in as bfloat16, every other float operand float32."""
    import contextlib
    import ctypes
    import os
    import re

    from temp_tpu_torch import _build
    from temp_tpu_torch.parallel import ring_spmm as rs

    # the bfloat16 source renames exactly the launchers BF16_LAUNCHERS
    # lists for it, each declared in ring_spmm.cu
    bf16_src = open(os.path.join(os.path.dirname(_build.SOURCES[0]),
                                 "ring_spmm_bf16.cu")).read()
    renamed = re.findall(r"#define (\w+) \1_bf16", bf16_src)
    assert renamed == ["ring_fwd_step_launch", "ring_bwd_step_launch",
                       "ring_dw_launch"]
    assert set(renamed) <= set(_build.BF16_LAUNCHERS)
    assert "ring_dw_reduce_launch" not in _build.BF16_LAUNCHERS
    # the whole-card route's launchers exist in bfloat16 only, under their
    # own names
    card = re.findall(r'extern "C" int (ring_bf16_\w+)\(', bf16_src)
    assert card == ["ring_bf16_fwd_launch", "ring_bf16_bwd_launch",
                    "ring_bf16_occupancy"]
    assert set(card) <= set(_build.SIGNATURES)
    assert not set(card) & set(_build.BF16_LAUNCHERS)
    decl = r'extern "C" int (ring_bf16_\w+)\(([^)]*)\)'
    for name, params in re.findall(decl, bf16_src):
        assert len(params.split(",")) == len(_build.SIGNATURES[name]), name
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
                return 0
            launch.launcher = name
            return launch

    class Stream:
        cuda_stream = 0

    def spy(fn, name, dev, stream, *args):
        floats = [a.dtype for a in args if isinstance(a, torch.Tensor)
                  and a.is_floating_point()]
        calls.append((fn.launcher, floats))
        return real_launch(fn, name, dev, stream, *args)

    real_launch = rs._launch
    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(rs, "_launch", spy)
    h, (src, dst, rel, em), w = tr._graph(5)
    th, tw = torch.from_numpy(h)[None], torch.from_numpy(w)
    e = [torch.from_numpy(x)[None] for x in (src, dst, rel, em)]
    rows = tr.N_G // M
    emask = e[3].bool()
    tab, t_pos = rs._call_tables(th, tw, *e[:3], emask, M, rows, None)
    g = torch.ones_like(th)
    n2 = torch.ones(th.shape[:2])
    rs._ring_fwd_cuda(th, tw, emask, M, rows, CPU4, 1, tab, t_pos, hot=BF)
    rs._ring_bwd_cuda(g, n2, th, tw, emask, M, rows, CPU4, 1, tab, t_pos,
                      hot=BF)
    f32, bf = torch.float32, torch.bfloat16
    assert calls == [("ring_bf16_fwd_launch", [f32] * 4),
                     ("ring_bf16_bwd_launch", [f32] * 6)]
    calls.clear()
    rs._ring_fwd_steps(th, tw, emask, M, rows, CPU4, 1, tab, t_pos, hot=BF)
    rs._ring_bwd_steps(g, n2, th, tw, emask, M, rows, CPU4, 1, tab, t_pos,
                       hot=BF)
    assert calls == (
        [("ring_fwd_step_launch_bf16", [bf, f32, f32, f32])] * M
        + [("ring_bwd_step_launch_bf16", [f32, f32, f32, f32])]
        + [("ring_bwd_step_launch_bf16", [f32, f32, f32, f32, f32])] * (M - 1)
        + [("ring_dw_launch_bf16", [f32, f32, bf, f32]),
           ("ring_dw_reduce_launch", [f32, f32])])
    with pytest.raises(TypeError, match="no kernel mode"):
        rs._kernel_args(th, tw, e[3], CPU4, 1, "ring_spmm_fwd",
                        torch.float16)


# -- the profiles' flags -------------------------------------------------------

def test_profiles_take_bf16_with_the_new_paths():
    """``profile_train`` and ``profile_eval`` make a bfloat16 config with
    the batched window, the fused eval and the ring_pallas partition of
    4 ranks, the flags combined without error (the runs themselves need a
    card)."""
    from temp_tpu_torch import profile_eval, profile_train

    part = ["--edge-partition", "ring_pallas", "--mp-size", "4"]
    _, cfg = profile_train.parse(["--compute-dtype", "bfloat16",
                                  "--fused-window-mb"] + part)
    assert cfg.hot_dtype == BF and cfg.fused_window_mb_on("cuda")
    assert cfg.partitioned and cfg.edge_partition_mode == "ring_pallas"
    _, cfg = profile_train.parse(["--compute-dtype", "bfloat16",
                                  "--fused-window-mb"])
    assert cfg.hot_dtype == BF and not cfg.partitioned
    _, cfg = profile_eval.parse(["--compute-dtype", "bfloat16",
                                 "--fused-eval", "--fused-window-mb"])
    assert cfg.hot_dtype == BF and cfg.fused_eval_on("cpu")
    assert cfg.fused_window_mb_on("cpu")
    _, cfg = profile_eval.parse(["--compute-dtype", "bfloat16"] + part)
    assert cfg.hot_dtype == BF and cfg.mp_size == 4 and cfg.partitioned
