"""compute_dtype="bfloat16" of temp_tpu_torch against the JAX package's
bfloat16 path (CPU), GRRGCN's slice: the hot products, the GRU and the
scores, kernel K2's plain version (eval and training), K3-K5's (loss,
gradients and the final table) and the model trained two steps and ranked.

Both sides run with compute_dtype="bfloat16"; the JAX kernels in Pallas
interpret mode. The rule, on the same inputs: RMS(port bf16 - JAX bf16) <=
0.1 * RMS(JAX bf16 - JAX f32), the JAX package's own distance between its
two precisions being the yardstick (``_rule``). Measured on these fixtures
(the ratio RMS(port - JAX bf16) / RMS(JAX bf16 - JAX f32)): the GRU and
the scores at most 5.1e-5; K2's eval buffers 0 to 6.6e-3; K2 in training,
its buffers and its 12 cotangents, at most 4.5e-4; K3-K5's loss, tables,
histories' and parameters' gradients at most 5.3e-5; the slice's two
losses 0 and 0.034 and its trained parameters 0.028, one rank off JAX's
of 46, a near-tie. Both sides round at the same points and sum the same
bfloat16 values in float32, so they differ by float32 sums in another
order, and where such a sum lands on a bfloat16 rounding boundary on one
side only, by the flip, carried downstream (in the slice, through the
window's recurrence and two Adam steps). ``test_control_f32_fails_the_rule``
shows the rule bites: the port's float32 path against JAX's bfloat16
fails it. Ranks must be equal but for near-ties (a competitor within
NEAR_TIE of the target's score), which the test counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops import fused_final as jax_ff
from temp_tpu.ops.fused_window import _fused_window
from temp_tpu.ops.fused_window import fused_window_scan as jax_scan
from temp_tpu.ops.gru import gru_cell as jax_gru_cell
from temp_tpu.ops.scores import table_scores as jax_table_scores
from temp_tpu.train.optim import make_optimizer as jax_make_optimizer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, to_device
from temp_tpu_torch.models.layers import _matmul
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_window as fw
from temp_tpu_torch.ops.fused_window_mb import fused_window_mb_fwd
from temp_tpu_torch.ops.gru import _mm, gru_cell
from temp_tpu_torch.ops.scores import table_scores
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import make_optimizer, param_leaves
import test_torch_fused_final as tff
import test_torch_fused_window as tfw
import test_torch_train as tt
from test_torch_post import _xla_unoptimized
from test_torch_train import (
    _COT, _pairs, _torch_params, _window_case, jax_draws,
)

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

BF = torch.bfloat16
RULE = 0.1


def _rms(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0


def _f32(x):
    """A torch tensor, JAX array or number as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _rule(port, jax_bf, jax_f32, what=""):
    """RMS(port - JAX bf16) <= RULE * RMS(JAX bf16 - JAX f32); returns the
    ratio. Leaves where JAX's two precisions agree exactly (no product on
    their path) must agree exactly here too."""
    port, jax_bf, jax_f32 = (np.asarray(_f32(x), np.float64)
                             for x in (port, jax_bf, jax_f32))
    assert port.shape == jax_bf.shape, (what, port.shape, jax_bf.shape)
    gap, yard = _rms(port - jax_bf), _rms(jax_bf - jax_f32)
    assert gap <= RULE * yard, (what, gap, yard)
    return gap / yard if yard else 0.0


def _rb(x):
    return x.to(BF).to(torch.float32)


# -- the hot products, the GRU and the scores -------------------------------

def test_hot_matmul_is_the_f32_product_of_rounded_operands():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.standard_normal((33, 64)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((48, 64)).astype(np.float32))
    ref = (_rb(x).double() @ _rb(w).double().T).float()
    for got in (_mm(x, w, BF), _matmul(x, w.T, BF),
                fw.hot_mm(x, w.T.contiguous(), BF)):
        assert got.dtype == torch.float32
        # products of two bfloat16 values are exact in float32; only the
        # float32 sum of 64 of them rounds
        torch.testing.assert_close(got, ref, rtol=2e-6, atol=2e-6)
    # torch's bfloat16 matmul rounds its output, which the JAX products do
    # not: the helper is not it
    bf_out = (x.to(BF) @ w.to(BF).T).float()
    assert float((bf_out - ref).abs().max()) > 1e-3
    assert torch.equal(_mm(x, w), x @ w.T)


def test_gru_and_scores_match_jax_bf16():
    rs = np.random.RandomState(1)
    d, n = 16, 40
    p = {k: rs.standard_normal(s).astype(np.float32) * 0.4 for k, s in (
        ("w_ih", (3 * d, d)), ("w_hh", (3 * d, d)), ("b_ih", (3 * d,)),
        ("b_hh", (3 * d,)))}
    x, h = (rs.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    q, tbl = (rs.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    g = rs.standard_normal((n, d)).astype(np.float32)
    gs = rs.standard_normal((n, n)).astype(np.float32)

    def jax_side(dtype):
        def f(p, x, h, q, tbl):
            out = jax_gru_cell(p, x, h, dtype=dtype)
            sc = jax_table_scores((q, "dot"), tbl, dtype)
            return jnp.sum(out * g) + jnp.sum(sc * gs), (out, sc)
        with _xla_unoptimized():
            (_, outs), grads = jax.jit(jax.value_and_grad(
                f, (0, 1, 2, 3, 4), has_aux=True))(p, x, h, q, tbl)
        return outs, grads

    (jo_bf, jsc_bf), jg_bf = jax_side(jnp.bfloat16)
    (jo_f, jsc_f), jg_f = jax_side(None)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, th, tq, tt = (torch.from_numpy(v).requires_grad_()
                      for v in (x, h, q, tbl))
    out = gru_cell(tp, tx, th, BF)
    sc = table_scores((tq, "dot"), tt, BF)
    ((out * torch.from_numpy(g)).sum()
     + (sc * torch.from_numpy(gs)).sum()).backward()
    _rule(out.detach(), jo_bf, jo_f, "gru")
    _rule(sc.detach(), jsc_bf, jsc_f, "scores")
    for k in p:
        _rule(tp[k].grad, jg_bf[0][k], jg_f[0][k], k)
    for t, jb, jf, what in zip((tx, th, tq, tt), jg_bf[1:], jg_f[1:],
                               ("x", "h", "q", "table")):
        _rule(t.grad, jb, jf, what)


# -- K2: the window, eval and training --------------------------------------

@pytest.fixture(scope="module")
def k2_eval():
    """The windows of tests/test_torch_fused_window.py: conv1_in -> (the
    port's inputs, JAX's bf16 buffers, JAX's f32 buffers), the JAX kernel
    in interpret mode over the windows under vmap."""
    data, model, params = tfw.setup.__wrapped__()
    enc = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                   params["encoder"]),
                            device="cpu")
    out = {}
    for conv1_in in (True, False):
        elems = tfw._window_inputs(data, model, params, conv1_in)
        stacked = {k: jnp.stack([e[k] for e in elems]) for k in elems[0]}
        ref = []
        for dt in ("bfloat16", "float32"):
            cfg = JaxConfig(fused_window=True, compute_dtype=dt, **tfw.KW)

            def one(e, cfg=cfg, c1=conv1_in):
                return jax_scan(params["encoder"], cfg, model.lc2,
                                e["h0_xs"], e["src"], e["dst"], e["rel"],
                                e["emask"], e["prev_step"], e["prev_row"],
                                e["dt"], e["live"], None, False, 2,
                                interpret=True, conv1_in=c1)

            with _xla_unoptimized():
                bufs = jax.jit(jax.vmap(one))(stacked)
            ref.append(tuple(_f32(b) for b in bufs))
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in stacked.items()}
        out[conv1_in] = (enc, batch, *ref)
    return out


def _k2_port(case, conv1_in, compute_dtype):
    enc, batch = case[conv1_in][:2]
    cfg = TKGConfig(compute_dtype=compute_dtype, **tfw.KW)
    return fw.fused_window_scan(enc, cfg, conv1_in=conv1_in, **batch)


@pytest.mark.parametrize("conv1_in", [True, False])
def test_k2_eval_matches_jax_bf16(k2_eval, conv1_in):
    bufs = _k2_port(k2_eval, conv1_in, "bfloat16")
    _, _, ref_bf, ref_f = k2_eval[conv1_in]
    for i in range(2):
        assert bufs[i].dtype == BF
        _rule(bufs[i], ref_bf[i], ref_f[i], f"buf{i + 1}")


def test_control_f32_fails_the_rule(k2_eval):
    """The rule bites: the port in float32 against JAX in bfloat16."""
    bufs = _k2_port(k2_eval, False, "float32")
    _, _, ref_bf, ref_f = k2_eval[False]
    with pytest.raises(AssertionError):
        _rule(bufs[0], ref_bf[0], ref_f[0], "buf1")


def _jax_window_vjp_bf16(c, rate, dtype_str, lam=0.1):
    """tests/test_torch_train.py ``_jax_window_vjp`` in the mode dtype_str
    (None: float32; "bfloat16": bfloat16 products and buffers, and the
    buffers' cotangents in bfloat16), over the elements under vmap."""
    B, L1, A, d = c["h0x"].shape
    E, R2 = c["src"].shape[-1], c["wrel"].shape[0]
    Ap = Ep = Rp = 128
    store = "float32" if dtype_str is None else dtype_str
    static = (L1, Ap, Ep, d, Rp, rate, False, lam, True, 2, dtype_str, store,
              True, False)
    pa, pe = ((0, 0), (0, 0), (0, Ap - A)), ((0, 0), (0, 0), (0, Ep - E))
    pm = ((0, 0), (0, 0), (0, Ap - A), (0, 0))
    ws = [jnp.pad(c["wrel"], ((0, Rp - R2), (0, 0)))] + [
        jnp.asarray(c[k])[None] if k.startswith("b") else jnp.asarray(c[k])
        for k in _COT[1:]]

    def col(x, pad, v=0):
        return jnp.pad(x, pad, constant_values=v)[..., None]

    gidx = (c["gidx"] // A) * Ap + c["gidx"] % A
    per = ((col(gidx, pa), col(c["live"], pa), col(c["dt"], pa),
            jnp.pad(c["m1"], pm), jnp.pad(c["m2"], pm)),
           (col(c["src"], pe, Ap - 1), col(c["dst"], pe, Ap - 1),
            col(c["rel"], pe), col(c["em"], pe)),
           jnp.pad(c["h0x"], pm),
           tuple(jnp.pad(c[g], pm).reshape(B, L1 * Ap, d)
                 for g in ("g1", "g2")))

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


def test_k2_train_matches_jax_bf16():
    """K2f in training (dropout masks) and K2b: the buffers and all 12
    cotangents, the buffers' cotangents given in bfloat16 on both sides."""
    rate = 0.1
    c = _window_case(rate)
    ref = {dt: _jax_window_vjp_bf16(c, rate, dt) for dt in ("bfloat16",
                                                           None)}
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    g1, g2 = ({n: T[f"{k}{i}"] for n, k in (("wih_t", "wih"),
                                             ("whh_t", "whh"), ("bih", "bih"),
                                             ("bhh", "bhh"))}
              for i in (1, 2))
    args = (T["h0x"], T["src"], T["dst"], T["rel"], T["em"], T["gidx"],
            T["live"], T["dt"], T["wrel"], T["loop1"], T["loop2"], g1, g2,
            0.1)
    b1, b2 = fw.fused_window_fwd(*args, False, T["m1"], T["m2"], hot=BF)
    assert b1.dtype == b2.dtype == BF
    for b in range(b1.shape[0]):
        for i, buf in enumerate((b1, b2)):
            _rule(buf[b], ref["bfloat16"][0][b][i], ref[None][0][b][i],
                  f"buf{i + 1}")
    grads = fw.fused_window_bwd(*args, T["m1"], T["m2"], b1, b2,
                                T["g1"].to(BF), T["g2"].to(BF), hot=BF)
    _rule(grads[0], ref["bfloat16"][1], ref[None][1], "dh0x")
    for name, got, rb, rf in zip(_COT, grads[1:], ref["bfloat16"][2],
                                 ref[None][2]):
        assert got.dtype == torch.float32
        _rule(got, rb, rf, name)


# -- K3-K5: the fused final step and loss ----------------------------------

def _final_inputs():
    """tests/test_torch_fused_final.py's data, weights and draws (dropout,
    the select) with seeded histories rounded to bfloat16 and last
    positions: the same inputs for both sides and both precisions."""
    dropout, noact, tv = tff.CASES["noact"]
    data = jax.device_put(jax_synthetic(**tff.DATA))
    cfg = JaxConfig(fused_final=True, fused_window=True, dropout=dropout,
                    use_embed_for_non_active=noact, **tff.KW)
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    rs = np.random.RandomState(5)
    B, N, d = len(tff.T_POS), data.num_ents, cfg.embed_size
    hists = [np.asarray(jnp.asarray(rs.standard_normal((B, N, d)) * 0.5,
                                    jnp.bfloat16)) for _ in range(2)]
    last_pos = rs.randint(0, cfg.train_seq_len - 1, (B, N)).astype(
        np.float32)
    return data, params, hists, last_pos, tv


def _jax_final(dtype_str, data, params, hists, last_pos, tv):
    """The JAX package's fused_final_loss of each element (the keys of its
    model.loss) in `dtype_str`, summed with the t_valid weights: (loss,
    grads of the parameters and of both histories, the final tables)."""
    from temp_tpu.models.dynamic import gather_window
    from temp_tpu.ops.sampling import subsample_edges

    dropout, noact, _ = tff.CASES["noact"]
    cfg = JaxConfig(fused_final=True, fused_window=True, dropout=dropout,
                    use_embed_for_non_active=noact, compute_dtype=dtype_str,
                    **tff.KW)
    model = jax_get_model(cfg, data)
    L = cfg.train_seq_len
    rngs = jax.random.split(jax.random.PRNGKey(1), len(tff.T_POS))
    hdt = jnp.float32 if dtype_str == "float32" else jnp.bfloat16

    keys = []
    for t, r in zip(tff.T_POS, rngs):
        r_fwd, r_loss = jax.random.split(r)
        _, k_fin, k_sub = jax.random.split(r_fwd, 3)
        keys.append((k_fin, k_sub, jax.random.split(r_loss, 3)[0]))
    k_fin, k_sub, k_pos = (jnp.stack(k) for k in zip(*keys))

    def one(p, h1, h2, lp, t, k_fin, k_sub, k_pos):
        win = gather_window(data, t, L)
        full = win.emask[L - 1]
        return jax_ff.fused_final_loss(
            p, cfg, model.lc2, data, h1, h2, lp, win.src[L - 1],
            win.dst[L - 1], win.rel[L - 1], subsample_edges(k_sub, full, 0.5),
            full, t, k_fin, k_pos, True)

    def total(p, h1, h2):
        losses = jax.vmap(one, (None, 0, 0, 0, 0, 0, 0, 0))(
            p, h1, h2, jnp.asarray(last_pos), jnp.asarray(tff.T_POS,
                                                          jnp.int32),
            k_fin, k_sub, k_pos)
        return jnp.sum(losses * jnp.asarray(tv, jnp.float32))

    # K3's stored table of each element, recorded as the kernel writes it
    # (with its dt column, which tells the elements apart: vmap's callbacks
    # come in no fixed order)
    tables = []
    call_fwd = jax_ff._call_fwd

    def recording(static, args):
        res = call_fwd(static, args)
        jax.debug.callback(lambda dt, t: tables.append((_f32(dt), _f32(t))),
                           args[9], res[1])
        return res

    jax_ff._call_fwd = recording
    try:
        with _xla_unoptimized():
            loss, grads = jax.jit(jax.value_and_grad(total, (0, 1, 2)))(
                params, *(jnp.asarray(h, hdt) for h in hists))
            jax.block_until_ready(grads)
    finally:
        jax_ff._call_fwd = call_fwd
    N = data.num_ents
    by_elem = [next(t for dt, t in tables
                    if np.array_equal(dt[:N, 0], (L - 1) - last_pos[b]))
               for b in range(len(tff.T_POS))]
    return float(loss), grads, np.stack(by_elem)[:, :N]


@pytest.fixture(scope="module")
def final_case():
    data, params, hists, last_pos, tv = _final_inputs()
    ref = {dt: _jax_final(dt, data, params, hists, last_pos, tv)
           for dt in ("bfloat16", "float32")}
    rng = jax.random.PRNGKey(1)
    cfg = JaxConfig(dropout=tff.CASES["noact"][0], **tff.KW)
    draws = jax_draws(cfg, data, tff.T_POS, rng)
    return (jax.tree_util.tree_map(np.asarray, params), hists, last_pos, tv,
            draws, ref)


@pytest.mark.parametrize("kernels", [True, False])
def test_k3_k5_match_jax_bf16(final_case, kernels):
    """The loss of each element, the final tables (K3's), and the
    gradients of every parameter and of both histories (K4, the select and
    K5 through ``FusedFinal``; kernels=False its plain parts on any
    device), on the same histories."""
    np_params, hists, last_pos, tv, draws, ref = final_case
    loss_bf, grads_bf, table_bf = ref["bfloat16"]
    loss_f, grads_f, table_f = ref["float32"]
    dropout, noact, _ = tff.CASES["noact"]
    cfg = TKGConfig(fused_final=True, fused_window=True, kernels=kernels,
                    dropout=dropout, use_embed_for_non_active=noact,
                    compute_dtype="bfloat16", **tff.KW)
    data = to_device(make_synthetic(**tff.DATA), "cpu")
    model = get_model(cfg, data, device="cpu")
    params = _torch_params(np_params)
    hs = [torch.from_numpy(_f32(h)).to(BF).requires_grad_() for h in hists]
    tp = torch.tensor(tff.T_POS)
    gr = ff.final_graph(data, model.answers, tp, draws,
                        torch.from_numpy(last_pos), cfg.inv_temperature,
                        dropout, cfg.train_seq_len, noact)
    tables = []
    fwd_plain = ff.fused_final_fwd_plain

    def recording(*a, **k):
        out = fwd_plain(*a, **k)
        tables.append(out[1].detach())
        return out

    ff.fused_final_fwd_plain = recording
    try:
        losses = ff.fused_final_loss(params, gr, *hs, kernels=kernels,
                                     hot=BF)
    finally:
        ff.fused_final_fwd_plain = fwd_plain
    loss = (losses * torch.tensor([float(v) for v in tv])).sum()
    loss.backward()
    _rule(loss.detach(), loss_bf, loss_f, "loss")
    # the JAX kernel stores its table in the store dtype (bfloat16); the
    # port keeps it in float32 (K3's score launch reads it), and K4 rounds
    # it as the JAX kernel's residual is rounded
    assert len(tables) == 1
    _rule(tables[0].to(BF), table_bf, table_f, "table")
    for i, h in enumerate(hs):
        assert h.grad.dtype == BF
        _rule(h.grad, grads_bf[i + 1], grads_f[i + 1], f"hist{i + 1}")
    n = 0
    for path, ref_bf, got in _pairs(grads_bf[0], params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _rule(grad, ref_bf, _lookup(grads_f[0], path), path)
        n += 1
    assert n == len(param_leaves(params))


def _lookup(tree, path):
    for part in path.strip("/").split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else (
            tree[part])
    return tree


# -- the slice: GRRGCN trained two steps, then ranked -----------------------

# a competitor within this of the target's score is a near-tie: the two
# sides' tables differ by rounding flips of about 1e-3 where a float32 sum
# lands on a bfloat16 rounding boundary in one and not the other
NEAR_TIE = 1e-3
EVAL_T = [4, 6, 8]


def _jax_slice(dtype_str, data, kw, ranks: bool):
    """JAX's GRRGCN on its default CPU path (the XLA scan, unfused final
    step) from seeded weights: the losses of two Adam steps (keys 10, 11),
    the trained parameters, and (`ranks`) the valid ranks and mask of
    EVAL_T."""
    cfg = JaxConfig(compute_dtype=dtype_str, **kw)
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = jax_make_optimizer(cfg)
    state = opt.init(params)
    tp, tv = jnp.asarray(tt.T_POS, jnp.int32), jnp.asarray([True] * 3)

    @jax.jit
    def step(params, state, rng):
        loss, grads = jax.value_and_grad(
            lambda p: model.loss(p, data, tp, tv, rng))(params)
        updates, state = opt.update(grads, state, params)
        return loss, optax.apply_updates(params, updates), state

    losses = []
    with _xla_unoptimized():
        for k in (10, 11):
            loss, params, state = step(params, state, jax.random.PRNGKey(k))
            losses.append(float(loss))
        out = (None, None)
        if ranks:
            out = jax.jit(lambda p: model.eval_ranks(
                p, data, jnp.asarray(EVAL_T, jnp.int32),
                jnp.asarray([True] * 3), "valid"))(params)[:2]
    return (losses, jax.tree_util.tree_map(np.asarray, params),
            *(None if x is None else np.asarray(x) for x in out), init)


@torch.no_grad()
def _near_ties(model, params, data, ranks, ref_ranks, mask):
    """The queries whose ranks differ from the reference's, each checked to
    have a competitor within NEAR_TIE of its target's score in the port's
    scores: their count."""
    from temp_tpu_torch.ops.scores import complex_all

    ev = data.valid
    Q = ranks.shape[1] // 2
    n = 0
    for b, q in np.argwhere((ranks != ref_ranks) & mask):
        t, j = EVAL_T[b], q % Q
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


@torch.no_grad()
def _port_ranks(model, params, data):
    ranks, mask, _ = model.eval_ranks(params, data, EVAL_T, [True] * 3,
                                      "valid")
    return ranks.numpy(), mask.numpy()


def test_slice_trains_and_ranks_as_jax_bf16():
    """GRRGCN through Trainer.train_step for two Adam steps on the JAX
    package's draws, then a valid batch's ranks, on the default CPU path
    (the window step by step, the final step one element at a time): the
    losses and the trained parameters (all leaves as one vector) under the
    rule, the ranks equal but for counted near-ties."""
    kw = {**tt.KW, "dropout": 0.0, "lr": 0.01}
    data = jax.device_put(jax_synthetic(**tt.DATA))
    ref = {dt: _jax_slice(dt, data, kw, dt == "bfloat16")
           for dt in ("bfloat16", "float32")}
    losses_bf, params_bf, ranks_bf, mask_bf, init = ref["bfloat16"]
    losses_f, params_f, _, _, _ = ref["float32"]
    cfg = TKGConfig(compute_dtype="bfloat16", **kw)
    host = make_synthetic(**tt.DATA)
    model = get_model(cfg, host, device="cpu")
    assert not model.fused_window_on(True) and not model.fused_final_on()
    trainer = Trainer(cfg, model, host)
    params = _torch_params(init)
    optimizer = make_optimizer(cfg, params)
    jcfg = JaxConfig(compute_dtype="bfloat16", **kw)
    for step, k in enumerate((10, 11)):
        loss = trainer.train_step(params, optimizer, tt.T_POS, [True] * 3,
                                  draws=jax_draws(jcfg, data, tt.T_POS,
                                                  jax.random.PRNGKey(k)))
        _rule(float(loss), losses_bf[step], losses_f[step], f"loss {step}")
    flat = [np.concatenate([np.asarray(x, np.float64).ravel() for x in v])
            for v in ([got.detach().numpy() for _, _, got in
                       _pairs(params_bf, params)],
                      [ref_ for _, ref_, _ in _pairs(params_bf, params)],
                      [_lookup(params_f, path) for path, _, _ in
                       _pairs(params_bf, params)])]
    _rule(*flat, "trained parameters")
    dd = to_device(host, "cpu")
    ranks, mask = _port_ranks(model, params, dd)
    np.testing.assert_array_equal(mask, mask_bf)
    n_ties = _near_ties(model, params, dd, ranks, ranks_bf, mask)
    assert n_ties <= 2, n_ties


# -- the config ---------------------------------------------------------------

# what the port refused in bfloat16 until the boundary exchange, the data
# axis and the SpMM method "onehot" in bfloat16 were ported: each now
# builds (the method runs); multi-process training still raises
@pytest.mark.parametrize("field,value,what", [
    ("edge_partition", True, "boundary"),
    ("edge_partition", "boundary", "boundary"),
    ("dp_size", 2, "data parallelism"), ("spmm_method", "onehot", "onehot")])
def test_bf16_outside_the_slice_raises(field, value, what):
    if field == "spmm_method":
        from temp_tpu_torch.ops.segment import rel_spmm

        rs = np.random.RandomState(0)
        h, w = (torch.from_numpy(rs.standard_normal(s).astype(np.float32))
                for s in ((6, 4), (3, 4)))
        edges = [torch.tensor(x) for x in ([0, 1, 2], [1, 2, 3], [0, 1, 2],
                                           [True, True, False])]
        bf = rel_spmm(h, *edges, w, 4, 4, 6, dtype=BF, method=value)
        f32 = rel_spmm(h, *edges, w, 4, 4, 6, method=value)
        assert bf.dtype == torch.float32 and not torch.equal(bf, f32)
        return
    over = {field: value}
    if field == "edge_partition":
        over["mp_size"] = 2
    cfg = TKGConfig(compute_dtype="bfloat16", **over)
    assert cfg.hot_dtype == torch.bfloat16 and getattr(cfg, field) == value
    if field == "edge_partition":
        assert cfg.partitioned and cfg.edge_partition_mode == what
    with pytest.raises(NotImplementedError, match="multi-process"):
        TKGConfig(compute_dtype="bfloat16", distributed=True, **over)


# the values whose bfloat16 mode is ported: the step-by-step windows, K11,
# K12 and the partitions with K13 (tests/test_torch_bf16_k11_k12_k13.py),
# and every model, decoder, pool and option with K1's bfloat16 mode
# (tests/test_torch_bf16_k1_models.py)
@pytest.mark.parametrize("field,value", [
    ("random_dropout", True), ("edge_dropout", True), ("fused_eval", True),
    ("fused_eval", "auto"), ("fused_window_mb", True),
    ("fused_window_mb", "auto"), ("edge_partition", "ring_pallas"),
    ("module", "SARGCN"), ("module", "BiRRGCN"), ("module", "RRGCN"),
    ("score_function", "distmult"), ("score_function", "transE"),
    ("negative_pool", "shared"), ("negative_pool", "per_query"),
    ("module", "BiSARGCN"), ("module", "SRGCN"), ("module", "DE"),
    ("type1", True), ("learnable_lambda", True),
    ("use_time_embedding", True), ("rec_only_last_layer", True)])
def test_bf16_takes_the_ported_values(field, value):
    over = {field: value}
    if field == "edge_partition":
        over["mp_size"] = 4
    cfg = TKGConfig(compute_dtype="bfloat16", **over)
    assert cfg.hot_dtype == torch.bfloat16 and getattr(cfg, field) == value
    if field == "edge_partition":
        assert cfg.partitioned and cfg.edge_partition_mode == value


def test_bf16_in_the_slice_and_auto_stays_f32():
    for dt in ("bfloat16", "bf16"):
        cfg = TKGConfig(compute_dtype=dt, fused_final="auto",
                        fused_window="off", fused_eval="off")
        assert cfg.hot_dtype == torch.bfloat16
    # the flagship, plain BiGRRGCN and the TeMP variants
    for over in ({"module": "BiGRRGCN", "impute": True},
                 {"module": "BiGRRGCN"},
                 {"module": "GRRGCN", "impute": True},
                 {"module": "BiGRRGCN", "impute": True,
                  "post_ensemble": True},
                 {"module": "BiGRRGCN", "post_aggregation": True},
                 {"module": "GRRGCN", "post_ensemble": True}):
        assert TKGConfig(compute_dtype="bfloat16",
                         **over).hot_dtype == torch.bfloat16
    for dt in ("auto", "float32", "f32", None):
        assert TKGConfig(compute_dtype=dt).hot_dtype is None
    # "auto" resolves on the device, as the JAX package's on its backend:
    # float32 on the CPU (the JAX backend here), bfloat16 on CUDA
    assert JaxConfig(compute_dtype="auto").hot_dtype is None  # the CPU here
    assert TKGConfig().for_device("cpu").hot_dtype is None
    assert TKGConfig().for_device("cuda").hot_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float16"):
        TKGConfig(compute_dtype="float16")
    # K12 in bfloat16 on CPU tensors: its plain version, B per-element
    # calls of K2's bfloat16 plain version
    c = _window_case(0.0)
    T = {k: torch.from_numpy(v) for k, v in c.items()}
    g1, g2 = ({n: T[f"{k}{i}"] for n, k in (("wih_t", "wih"),
                                             ("whh_t", "whh"), ("bih", "bih"),
                                             ("bhh", "bhh"))}
              for i in (1, 2))
    args = (T["h0x"], T["src"], T["dst"], T["rel"], T["em"], T["gidx"],
            T["live"], T["dt"], T["wrel"], T["loop1"], T["loop2"], g1, g2,
            0.1, False)
    got = fused_window_mb_fwd(*args, hot=BF)
    want = [fw.fused_window_fwd_plain(*(a[b:b + 1] if i < 8 else a
                                        for i, a in enumerate(args)),
                                      hot=BF) for b in range(2)]
    assert all(x.dtype == BF and torch.equal(x, torch.cat(y))
               for x, *y in zip(got, *want))


# -- the kernels' bfloat16 launches, rehearsed without a card ----------------

def test_bf16_launches_match_the_library_signatures(monkeypatch):
    """With the device checks and the library replaced by a recorder, one
    bfloat16 training loss and its backward (the fused window, the fused
    final step) call the kernels' bfloat16 launchers (``name_bf16``), each
    with the arguments ``_build.SIGNATURES`` declares for ``name``, in the
    float32 path's order and number: K2f 2 a step, K3 4, K4 4, K5 10, K2b 5
    a step and 2; the float32 sums (the weights', the relations') are the
    float32 launchers."""
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
    monkeypatch.setattr(fw, "_device", lambda name, t: "cuda")
    monkeypatch.setattr(ff, "_device", lambda name, t: "cuda")
    cfg = TKGConfig(fused_final=True, fused_window=True, dropout=0.1,
                    compute_dtype="bfloat16", **tff.KW)
    data = make_synthetic(**tff.DATA)
    model = get_model(cfg, data, device="cpu")
    params = model.init_params(0)
    for p in param_leaves(params):
        p.requires_grad_(True)
    before = {f.__name__: f.launches for f in (
        fw.fused_window_fwd, fw.fused_window_bwd, ff.fused_final_fwd,
        ff.fused_final_bwd_loss, ff.fused_final_bwd_layer)}
    loss = model.loss(params, to_device(data, "cpu"), tff.T_POS,
                      [True, True, False],
                      gen=torch.Generator().manual_seed(0))
    loss.backward()
    L1 = cfg.train_seq_len - 1
    k5 = ["final_bwd_gru_launch_bf16", "final_bwd_input_launch_bf16",
          "final_wgrad_launch_bf16", "final_wgrad_reduce_launch",
          "final_rel_grad_launch"]
    k2b = ["window_bwd_gru_launch_bf16", "window_bwd_input_launch_bf16"] * 2 \
        + ["window_wgrad_launch_bf16"]
    assert calls == (["window_layer_launch_bf16"] * 2 * L1
                     + ["final_layer_launch_bf16"] * 2
                     + ["final_scores_launch_bf16",
                        "final_loss_reduce_launch_bf16",
                        "final_dq_launch_bf16",
                        "final_dq_finish_launch_bf16",
                        "final_dtable_launch_bf16", "final_rel_grad_launch"]
                     + k5 + k5 + k2b * L1
                     + ["window_wgrad_reduce_launch",
                        "window_rel_grad_launch"])
    after = {f.__name__: f.launches for f in (
        fw.fused_window_fwd, fw.fused_window_bwd, ff.fused_final_fwd,
        ff.fused_final_bwd_loss, ff.fused_final_bwd_layer)}
    assert {k: after[k] - before[k] for k in after} == {
        "fused_window_fwd": 2 * L1, "fused_window_bwd": 5 * L1 + 2,
        "fused_final_fwd": 4, "fused_final_bwd_loss": 4,
        "fused_final_bwd_layer": 10}


def test_cli_trains_and_evaluates_in_bf16(tmp_path, capsys):
    """``python -m temp_tpu_torch.main --compute-dtype bfloat16`` (in this
    process) trains an epoch of GRRGCN with the fused final step's plain
    versions (``--fused-final on``) and evaluates it; the run's config
    keeps the dtype. A bfloat16 run of what the port lacks (SARGCN under
    an edge partition) raises."""
    import json
    import os

    root = tt._write_dataset(tmp_path / "data")
    out = tt.run_cli(
        ["-c", os.path.join(tt.ROOT, "grid", "icews14", "config_grrgcn.json"),
         "--device", "cpu", "--fast-dev-run", "--data-root", root,
         "--dataset", "tiny", "--edge-pad-multiple", "16",
         "--embed-size", "16", "--hidden-size", "16", "--n-bases", "16",
         "--train-seq-len", "3", "--batch-size", "2", "--fused-final", "on",
         "--compute-dtype", "bfloat16",
         "--experiments-dir", str(tmp_path / "runs"), "--model-name", "bf"],
        capsys)
    assert "epoch 0:" in out and "test: mrr=" in out
    run = tmp_path / "runs" / "bf"
    assert json.load(open(run / "config.json"))["compute_dtype"] == \
        "bfloat16"
    test = json.load(open(run / "test_metrics.json"))
    assert test["n"] > 0 and 0.0 < test["mrr"] <= 1.0
    with pytest.raises(NotImplementedError, match="items 8-9"):
        tt.run_cli(["-c", os.path.join(tt.ROOT, "grid", "icews14",
                                       "config_sargcn.json"),
                    "--device", "cpu", "--compute-dtype", "bfloat16",
                    "--data-root", root, "--dataset", "tiny",
                    "--edge-pad-multiple", "16", "--edge-partition",
                    "boundary", "--mp-size", "2"],
                   capsys)
