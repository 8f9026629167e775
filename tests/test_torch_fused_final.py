"""The fused final step and loss of temp_tpu_torch (kernels K3-K5) against
the JAX package's fused path (CPU, float32).

The JAX side trains with fused_final=True and fused_window=True, its Pallas
kernels in interpret mode. The port runs with fused_final=True on the CPU,
where every wrapper takes its plain version: ``FusedFinal`` (the plain
forward, then K4, the select's backward and K5 as the JAX kernels' own
backward formulas, ``kernels=True``) or autograd through the plain forward
(``kernels=False``). The fused path derives its random keys as the unfused
one does (temp_tpu/ops/fused_final.py:808-810), so the port takes
``jax_draws`` of tests/test_torch_train.py.

Tolerances: 1e-5 relative to max(1, the largest entry), as in
tests/test_torch_train.py (float32 sums in another order); the plain
backward formulas against autograd through the plain forward to 1e-5 too.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu_torch import _build
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, to_device,
)
from temp_tpu_torch.models.layers import dropout_mask
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_window as fw
from temp_tpu_torch.ops import fused_window_mb as mb
from temp_tpu_torch.ops.fused_window import _gru_t
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.sampling import subsample_edges, subsample_positives
from temp_tpu_torch.train.optim import param_leaves
from test_torch_post import _xla_unoptimized
from test_torch_train import _close, _pairs, _torch_params, jax_draws

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
# the sizes of tests/test_fused_final.py
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
          batch_size=3, seed=0, num_pos_facts=100)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edges_per_time=25,
            edge_pad_multiple=16)
T_POS = [5, 7, 2]
CASES = {"dropout0": (0.0, False, [True, True, True]),
         "dropout0.1": (0.1, False, [True, True, False]),
         "noact": (0.1, True, [True, True, True])}


@pytest.fixture(scope="module")
def jax_fused():
    """case -> (loss, grads, numpy params, draws) of the JAX package's fused
    path, computed on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            dropout, noact, tv = CASES[case]
            cfg = JaxConfig(fused_final=True, fused_window=True,
                            dropout=dropout, use_embed_for_non_active=noact,
                            **KW)
            data = jax.device_put(jax_synthetic(**DATA))
            model = jax_get_model(cfg, data)
            params = model.init_params(jax.random.PRNGKey(0))
            rng = jax.random.PRNGKey(1)

            def loss_fn(p):
                return model.loss(p, data, jnp.asarray(T_POS, jnp.int32),
                                  jnp.asarray(tv), rng)

            # one compile a case: eager Pallas interpret is slow
            with _xla_unoptimized():
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
            cache[case] = (float(loss), grads,
                           jax.tree_util.tree_map(np.asarray, params),
                           jax_draws(cfg, data, T_POS, rng))
        return cache[case]

    return get


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax_fused_path(jax_fused, case, kernels):
    ref_loss, ref_grads, np_params, draws = jax_fused(case)
    dropout, noact, tv = CASES[case]
    cfg = TKGConfig(fused_final=True, fused_window=True, kernels=kernels,
                    dropout=dropout, use_embed_for_non_active=noact, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.fused_final_on()
    params = _torch_params(np_params)
    before = (ff.fused_final_fwd.launches, ff.fused_final_bwd_loss.launches,
              ff.fused_final_bwd_layer.launches)
    loss = model.loss(params, to_device(data, "cpu"), T_POS, tv, draws=draws)
    loss.backward()
    assert (ff.fused_final_fwd.launches, ff.fused_final_bwd_loss.launches,
            ff.fused_final_bwd_layer.launches) == before  # the CPU: plain
    assert abs(loss.item() - ref_loss) <= ATOL * max(1.0, abs(ref_loss))
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(param_leaves(params))


# -- the plain backward formulas against autograd ---------------------------

def _plain_case(rate=0.1, noact=True, seed=0):
    """A FinalGraph of three targets of the test data with seeded draws,
    random history, dt and weights (requiring grad)."""
    cfg = TKGConfig(dropout=rate, use_embed_for_non_active=noact, **KW)
    host = make_synthetic(**DATA)
    data = to_device(host, "cpu")
    model = get_model(cfg, host, device="cpu")
    params = model.init_params(seed)
    gen = torch.Generator().manual_seed(seed)
    tp = torch.tensor(T_POS)
    N, d = data.num_ents, cfg.embed_size
    em = data.train.emask[tp]
    draws = {"edges": subsample_edges(gen, em, 0.5),
             "pos": subsample_positives(gen, em, cfg.num_pos_facts),
             "fin1": None, "fin2": None}
    if rate > 0:
        draws["fin1"], draws["fin2"] = (dropout_mask(gen, (3, N, d), rate,
                                                     "cpu")
                                        for _ in range(2))
    last_pos = torch.randint(0, cfg.train_seq_len - 1, (3, N),
                             generator=gen).float()
    gr = ff.final_graph(data, model.answers, tp, draws, last_pos,
                        cfg.inv_temperature, rate, cfg.train_seq_len, noact)
    h0, wrel, loop1, loop2, g1, g2, rtab = ff.final_weights(params)
    hists = [torch.randn(3, N, d, generator=gen) * 0.5 for _ in range(2)]
    return gr, h0, hists, wrel, (loop1, loop2), (g1, g2), rtab, gen


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def test_bwd_loss_plain_matches_autograd():
    gr, h0, hists, wrel, loops, grus, rtab, gen = _plain_case()
    table, _ = ff._encoder_plain(h0, *hists, gr, wrel, *loops, *grus)
    table, rtab = _leaf(table), _leaf(rtab)
    g = torch.tensor([0.7, 1.3, 0.0])  # the last as a t_valid False element
    (ff._loss_plain(table, rtab, gr) * g).sum().backward()
    d_table, d_rtab = ff.fused_final_bwd_loss_plain(table.detach(),
                                                    rtab.detach(), gr, g)
    _close(d_table.numpy(), table.grad.numpy(), "d_table")
    _close(d_rtab.numpy(), rtab.grad.numpy(), "d_rtab")
    assert float(d_table[2].abs().max()) == 0.0


def test_select_bwd_matches_autograd():
    gr, h0, hists, wrel, loops, grus, rtab, gen = _plain_case()
    out2, x = _leaf(hists[0]), _leaf(h0)
    d_table = torch.randn(out2.shape, generator=gen)
    sel = torch.where(gr.active[..., None] > 0, out2, x.expand_as(out2))
    (sel * d_table).sum().backward()
    d_out2, d_h0 = ff.select_bwd(d_table, gr.active)
    _close(d_out2.numpy(), out2.grad.numpy(), "d_out2")
    _close(d_h0.sum(0).numpy(), x.grad.numpy(), "d_h0")
    assert ff.select_bwd(d_table, None) == (d_table, None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layer", [1, 2])
def test_bwd_layer_plain_matches_autograd(layer, rate):
    gr, h0, hists, wrel, loops, grus, rtab, gen = _plain_case(rate=rate)
    B, N, d = hists[0].shape
    h_in = h0 if layer == 1 else torch.randn(B, N, d, generator=gen)
    prev, loop, g = hists[layer - 1], loops[layer - 1], grus[layer - 1]
    mask = gr.m1 if layer == 1 else gr.m2
    col = 0 if layer == 1 else d
    leaves = [_leaf(t) for t in (h_in, prev, wrel, loop, g["wih_t"],
                                 g["whh_t"], g["bih"], g["bhh"])]
    x, pv, w, lp, wih, whh, bih, bhh = leaves
    gl = {"wih_t": wih, "whh_t": whh, "bih": bih, "bhh": bhh}
    dec = torch.exp(-gr.lam * gr.dt)[..., None]
    conv = ff._conv_plain(x.expand(B, N, d), gr, w[:, col:col + d], lp, mask)
    d_out = torch.randn(B, N, d, generator=gen)
    (_gru_t(conv, pv * dec, gl) * d_out).sum().backward()
    got = ff.fused_final_bwd_layer_plain(h_in, prev, gr, mask, wrel, col,
                                         loop, g, d_out)
    d_h = got[0] if layer == 2 else got[0].sum(0)
    ref = [x.grad, pv.grad, w.grad[:, col:col + d]] + [
        t.grad for t in leaves[3:]]
    names = ("d_h", "d_prev", "d_wrel", "d_loop", "d_wih_t", "d_whh_t",
             "d_bih", "d_bhh")
    for name, a, b in zip(names, [d_h] + list(got[1:]), ref):
        _close(a.detach().numpy(), b.numpy(), name)
    assert float(w.grad[:, d - col:2 * d - col].abs().max()) == 0.0


# -- dispatch ----------------------------------------------------------------

def test_outside_the_envelope_takes_the_unfused_path():
    """Block-diagonal relation weights (n_bases < d) are outside K3-K5's
    envelope, as in the JAX package: the loss is the unfused path's."""
    kw = {**KW, "n_bases": 8}
    data = make_synthetic(**DATA)
    losses = []
    for fused_final in (True, False):
        cfg = TKGConfig(fused_final=fused_final, dropout=0.0, **kw)
        model = get_model(cfg, data, device="cpu")
        assert not model.fused_final_on()
        params = model.init_params(0)
        losses.append(model.loss(params, to_device(data, "cpu"), T_POS,
                                 [True] * 3,
                                 gen=torch.Generator().manual_seed(4)))
    assert torch.equal(losses[0], losses[1])
    cfg = TKGConfig(**KW)
    assert ff.fused_final_supported(cfg, "GRRGCN")
    for out in (cfg.replace(score_function="distmult"),
                cfg.replace(negative_pool="per_query"),
                cfg.replace(n_bases=8), cfg.replace(learnable_lambda=True),
                cfg.replace(embed_size=24, hidden_size=24, n_bases=24),
                cfg.replace(embed_size=256, hidden_size=256, n_bases=256)):
        assert not ff.fused_final_supported(out, "GRRGCN")
    # a ReLU on layer 2 is in the JAX envelope; the port refuses it
    assert not ff.fused_final_supported(cfg, "GRRGCN", activation2="relu")
    assert not ff.fused_final_supported(cfg, "SRGCN")


def test_fused_final_on_resolves_auto_by_device():
    assert TKGConfig().fused_final_on("cuda") is True
    assert TKGConfig().fused_final_on("cpu") is False
    assert TKGConfig(fused_final=True).fused_final_on("cpu") is True
    assert TKGConfig(fused_final="off").fused_final_on("cuda") is False
    data = make_synthetic(**DATA)
    assert get_model(TKGConfig(**KW), data, device="cpu").fused_final_on() \
        is False


def test_answer_lists_match_filter_tables():
    """Each train edge slot's answer list is exactly its query's row of the
    train filter table's membership mask (padded slots: empty)."""
    data = make_synthetic(**DATA)
    answers = build_answer_lists(data)
    r2 = 2 * data.num_rels
    for ptr, val, tbl, grp_ids in (
            (answers.tail_ptr, answers.tail_val, data.train_tail,
             data.train.src),
            (answers.head_ptr, answers.head_val, data.train_head,
             data.train.dst)):
        assert ptr.shape == (data.num_times, data.train.src.shape[1] + 1)
        for t in range(data.num_times):
            q = torch.from_numpy(grp_ids[t].astype(np.int64) * r2
                                 + data.train.rel[t])
            mask = true_answer_mask(torch.from_numpy(tbl.grp[t]),
                                    torch.from_numpy(tbl.val[t]), q,
                                    data.num_ents).numpy()
            for e in range(data.train.src.shape[1]):
                lst = val[ptr[t, e]:ptr[t, e + 1]]
                want = (np.nonzero(mask[e])[0] if data.train.emask[t, e]
                        else np.zeros(0, np.int64))
                np.testing.assert_array_equal(lst, want)


def test_final_csr_relation_rows():
    """``final_csr``'s CSRs by relation, which K4 and K5 sum over: row r
    lists, in edge order, the flat index of every edge slot of relation r
    that the encoder's subsample keeps (K5) or that is a positive of the
    loss (K4), and no other."""
    g = np.random.default_rng(3)
    B, E, N, R = 3, 20, 30, 7
    src, dst, rel = (torch.from_numpy(g.integers(0, n, (B, E), dtype=np.int32))
                     for n in (N, N, R))
    emf, posm = (torch.from_numpy((g.random((B, E)) < 0.5).astype(np.float32))
                 for _ in range(2))
    gr = ff.FinalGraph(src, dst, rel, emf, posm, *([None] * 12), lam=0.1,
                       r2=R)
    csr = ff.final_csr(gr, N, R)
    for (r_ptr, r_eid), keep in ((csr[2], emf), (csr[3], posm)):
        assert r_ptr.dtype == torch.int32 and r_ptr.numel() == R + 1
        flat_rel, flat_keep = rel.reshape(-1), keep.reshape(-1) > 0
        for r in range(R):
            got = r_eid[int(r_ptr[r]):int(r_ptr[r + 1])].tolist()
            want = torch.nonzero(flat_keep & (flat_rel == r))[:, 0].tolist()
            assert got == want, r


def test_kernel_launches_match_the_library_signatures(monkeypatch):
    """The CUDA path's plumbing, rehearsed on the CPU: with the device check
    and the library replaced by a recorder, one training loss and its
    backward make each launch with the argument count and types that
    ``_build.SIGNATURES`` declares, in the order of the JAX package's
    ``_fused_final_bwd`` (K3, K4, K5 for layer 2, K5 for layer 1)."""
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
                calls.append(name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(ff, "_device", lambda name, t: "cuda")
    cfg = TKGConfig(fused_final=True, fused_window=False, dropout=0.1,
                    use_embed_for_non_active=True, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    params = model.init_params(0)
    for p in param_leaves(params):
        p.requires_grad_(True)
    counts = (ff.fused_final_fwd.launches, ff.fused_final_bwd_loss.launches,
              ff.fused_final_bwd_layer.launches)
    loss = model.loss(params, to_device(data, "cpu"), T_POS,
                      [True, True, False],
                      gen=torch.Generator().manual_seed(0))
    loss.backward()
    k5 = ["final_bwd_gru_launch", "final_bwd_input_launch",
          "final_wgrad_launch", "final_wgrad_reduce_launch",
          "final_rel_grad_launch"]
    assert calls == (["final_layer_launch"] * 2
                     + ["final_scores_launch", "final_loss_reduce_launch",
                        "final_dq_launch", "final_dq_finish_launch",
                        "final_dtable_launch", "final_rel_grad_launch"]
                     + k5 + k5)
    assert (ff.fused_final_fwd.launches - counts[0],
            ff.fused_final_bwd_loss.launches - counts[1],
            ff.fused_final_bwd_layer.launches - counts[2]) == (4, 4, 10)


def test_window_bwd_launches_match_the_library_signatures(monkeypatch):
    """K2b's plumbing, rehearsed on the CPU as the test above does K3-K5's:
    one fused window backward (the flagship's ReLU and third buffer, a
    ragged A) makes, per step in reverse order, the layer-2 GRU and input
    launches, the layer-1 GRU and input launches and the weight launch,
    then the weights' sum and the relation sum, each with the argument
    count and types that ``_build.SIGNATURES`` declares."""
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
                calls.append(name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(fw, "_device", lambda name, t: "cuda")
    B, L1, A, E, d, R = 2, 3, 37, 6, 16, 5
    g = np.random.default_rng(0)

    def f32(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))

    def ids(n, *shape):
        return torch.from_numpy(g.integers(0, n, shape, dtype=np.int32))

    def gru():
        return {"wih_t": f32(d, 3 * d), "whh_t": f32(d, 3 * d),
                "bih": f32(3 * d), "bhh": f32(3 * d)}

    act = (B, L1, A, d)
    em = torch.from_numpy((g.random((B, L1, E)) < 0.7).astype(np.float32))
    before = fw.fused_window_bwd.launches
    out = fw.fused_window_bwd(
        f32(*act), ids(A, B, L1, E), ids(A, B, L1, E), ids(R, B, L1, E), em,
        ids(L1 * A, B, L1, A), torch.ones(B, L1, A), torch.ones(B, L1, A),
        f32(R, 2 * d), f32(d, d), f32(d, d), gru(), gru(), 0.1, f32(*act),
        f32(*act), f32(*act), f32(*act), f32(*act), f32(*act), f32(*act),
        act2=True)
    step = ["window_bwd_gru_launch", "window_bwd_input_launch"] * 2 + [
        "window_wgrad_launch"]
    assert calls == step * L1 + ["window_wgrad_reduce_launch",
                                 "window_rel_grad_launch"]
    assert fw.fused_window_bwd.launches - before == 5 * L1 + 2
    assert [tuple(t.shape) for t in out[:4]] == [act, (R, 2 * d), (d, d),
                                                 (d, d)]


@pytest.mark.parametrize("conv1_in,n_buf,act2,masks", [
    (True, 2, False, False),      # eval: the layer-1 convs given
    (False, 2, False, True),      # GRRGCN training
    (False, 3, True, True),       # the flagship's windows
])
def test_window_fwd_launches_match_the_library_signatures(
        monkeypatch, conv1_in, n_buf, act2, masks):
    """K2f's plumbing (and K12's, on K2f's launches), rehearsed on the CPU
    as the tests above do K2b's and K3-K5's: one window forward in each
    mode (a ragged A) makes one layer launch a layer and step, layer 1 then
    layer 2, each with the argument count and types that
    ``_build.SIGNATURES`` declares, counted on its own wrapper."""
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
                calls.append((name, args[1], args[11], args[21] is None,
                              args[-2]))
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(fw, "_device", lambda name, t: "cuda")
    monkeypatch.setattr(mb, "_device", lambda name, t: "cuda")
    B, L1, A, E, d, R = 2, 3, 37, 6, 16, 5
    g = np.random.default_rng(1)

    def f32(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))

    def ids(n, *shape):
        return torch.from_numpy(g.integers(0, n, shape, dtype=np.int32))

    def gru():
        return {"wih_t": f32(d, 3 * d), "whh_t": f32(d, 3 * d),
                "bih": f32(3 * d), "bhh": f32(3 * d)}

    act = (B, L1, A, d)
    em = torch.from_numpy((g.random((B, L1, E)) < 0.7).astype(np.float32))
    args = dict(
        h0x=f32(*act), src=ids(A, B, L1, E), dst=ids(A, B, L1, E),
        rel=ids(R, B, L1, E), em=em, gidx=ids(L1 * A, B, L1, A),
        live=torch.ones(B, L1, A), dt=torch.ones(B, L1, A),
        wrel=f32(R, 2 * d), loop1=f32(d, d), loop2=f32(d, d), g1=gru(),
        g2=gru(), lam=0.1, conv1_in=conv1_in,
        m1=f32(*act) if masks else None, m2=f32(*act) if masks else None,
        act2=act2, n_buf=n_buf)
    for fwd in (fw.fused_window_fwd, mb.fused_window_mb_fwd):
        calls.clear()
        before = (fw.fused_window_fwd.launches,
                  mb.fused_window_mb_fwd.launches)
        bufs = fwd(**args)
        assert len(bufs) == n_buf
        assert all(tuple(b.shape) == act for b in bufs)
        # (name, conv given, relu, no third buffer, k): layer 1 (given in
        # eval, never a ReLU or a third buffer), then layer 2, step by step
        assert calls == [
            c for k in range(L1) for c in (
                ("window_layer_launch", int(conv1_in), 0, True, k),
                ("window_layer_launch", 0, int(act2), n_buf == 2, k))]
        own = fwd is mb.fused_window_mb_fwd
        assert (fw.fused_window_fwd.launches - before[0],
                mb.fused_window_mb_fwd.launches - before[1]) == (
            (0, 2 * L1) if own else (2 * L1, 0))
