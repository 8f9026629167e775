"""temp_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU; where there is none they skip (the fixture decides
at run time, so every worker collects the same tests). Run them on a card
with ``python -m pytest tests/test_torch_gpu.py -m gpu``.

Tolerance 1e-4 absolute: the kernels sum in another order than the plain
versions (f32, values of order one, up to 14 recurrent steps), and TF32 is
off for the plain versions' matrix products. Gradients that sum over many
rows (weight cotangents: up to B*L1*A = 71,680 rows, or B*N = 57,024 in the
final step) are held to 1e-4 relative to max(1, the largest entry): f32
sums of that many terms in another order differ by about sqrt(n) * 6e-8 of
the terms' size. The final step's losses are held to 1e-4 relative. The flagship's
final-step kernels (K6-K10) are held to 1e-5 of the largest entry of their
plain version's output, with no floor: their cotangents lie far below 1.
The fused eval (K11): ranks equal on every real query whose plain scores
hold no other column within 1e-5 of the row's largest |score| of the
target's, the BCE within 1e-5 relative. The batched window (K12) makes
K2f's launches: equal to K2f's output bit for bit. The ring SpMM (K13)
and its backward within 1e-5 of the largest entry of their plain
versions' outputs; bit for bit equal whether its ranks share one card or
sit on several, and whether it walks the data's tables or sorts the
call's edges.
Every config names float32: "auto" is bfloat16 on the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from temp_tpu_torch.config import TKGConfig as _Config
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.layers import dropout_mask
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops.fused_final import (
    _encoder_plain, _loss_plain, _loss_side, final_graph, final_graph_eval,
    fused_eval_ranks, fused_eval_ranks_plain, fused_final_bwd_layer,
    fused_final_bwd_layer_plain, fused_final_bwd_loss,
    fused_final_bwd_loss_plain, fused_final_fwd, fused_final_fwd_plain,
    fused_final_loss, table_ranks,
)
from temp_tpu_torch.ops import fused_final_bi as fb
from temp_tpu_torch.ops.fused_window import (
    fused_window_bwd, fused_window_fwd, fused_window_fwd_plain,
    fused_window_scan, window_args,
)
from temp_tpu_torch.ops.fused_window_mb import (
    fused_window_mb_fwd, fused_window_mb_fwd_plain,
)
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.sampling import (
    draw_negatives, draw_shared_negatives, subsample_edges,
    subsample_positives,
)
from temp_tpu_torch.ops.spmm import (
    _norm2_plain, flat_graph, spmm, spmm_bwd, spmm_bwd_plain, spmm_fwd,
    spmm_fwd_plain,
)
from temp_tpu_torch.parallel.edge_partition import (
    group_edges_by_dst_owner, ring_geometry, ring_tables,
)
from temp_tpu_torch.parallel.ring_spmm import (
    ring_spmm, ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
    ring_spmm_fwd_plain,
)
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import param_leaves

pytestmark = pytest.mark.gpu


def TKGConfig(**kw):
    """The port's config, float32 unless a test names another dtype."""
    return _Config(**{"compute_dtype": "float32", **kw})


TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, rel=1e-4):
    """max |a - b| <= rel * max(1, max |b|)."""
    return float((a - b).abs().max()) <= rel * max(1.0, float(b.abs().max()))


def _graph(n, e, r, d, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    w = torch.randn(r, d, generator=g)
    src = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, max(1, n // 2), (e,), generator=g,
                        dtype=torch.int32)  # half the rows get no edges
    rel = torch.randint(0, r, (e,), generator=g, dtype=torch.int32)
    em = torch.rand(e, generator=g) < 0.8
    return [t.to(dev) for t in (h, src, dst, rel, em, w)]


@pytest.mark.parametrize("n,e,r,d", [(7128, 256, 460, 128), (50, 0, 3, 32),
                                     (300, 5000, 7, 256), (33, 90, 4, 16)])
def test_spmm_kernel_matches_plain(cuda, n, e, r, d):
    args = _graph(n, e, r, d, cuda)
    before = spmm_fwd.launches
    out = spmm_fwd(*args)
    torch.cuda.synchronize()
    assert spmm_fwd.launches == before + 1
    ref = spmm_fwd_plain(*args)
    assert float((out - ref).abs().max()) <= TOL


def test_spmm_kernel_refuses_what_it_does_not_take(cuda):
    h, src, dst, rel, em, w = _graph(20, 30, 3, 16, cuda)
    with pytest.raises(TypeError):
        spmm_fwd(h.double(), src, dst, rel, em, w.double())
    with pytest.raises(ValueError):
        spmm_fwd(h.t(), src, dst, rel, em, w)
    with pytest.raises(ValueError):
        spmm_fwd(h, src.cpu(), dst, rel, em, w)
    big = torch.zeros(4, 512, device=cuda)
    with pytest.raises(ValueError):
        spmm_fwd(big, src[:2] % 4, dst[:2] % 4, rel[:2] % 3, em[:2],
                 torch.zeros(3, 512, device=cuda))


def _k1_tables_case(n, e, r, d, dev, B=1, rate=1.0, T=3, seed=0,
                    t_pos=None):
    """K1 over static tables: T snapshots' edges [T, E] and their tables
    (ring_tables of one rank over a static mask, sorted on the CPU and
    moved to the card, as the data's are), B graphs naming snapshots
    t_pos (one named twice where B > 1; or the given t_pos, [B]), a call
    mask inside the static mask (`rate` of it kept). Returns (h, (src,
    dst, rel, mask) [B, E], w, (tables, t_pos))."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (T, e), generator=g, dtype=torch.int32)
    dst = torch.randint(0, max(1, n // 2), (T, e), generator=g,
                        dtype=torch.int32)  # half the rows get no edges
    rel = torch.randint(0, r, (T, e), generator=g, dtype=torch.int32)
    static = torch.rand(T, e, generator=g) < 0.8
    tab = to_device(ring_tables(src, dst, rel, static, 1,
                                ring_geometry(n, 1), r), dev)
    if t_pos is None:
        t_pos = torch.tensor([T - 1, 0, T - 1, 1][:B]) if B > 1 else (
            torch.tensor([T // 2]))
    B = t_pos.shape[0]
    mask = static[t_pos] & (torch.rand(B, e, generator=g) < rate)
    h = torch.randn(B * n, d, generator=g)
    w = torch.randn(r, d, generator=g)
    edges = tuple(x.to(dev) for x in (src[t_pos], dst[t_pos], rel[t_pos],
                                      mask))
    return h.to(dev), edges, w.to(dev), (tab, t_pos.to(dev))


def _k1_flat(h, edges):
    s, t = flat_graph(edges[0], edges[1], h.shape[0] // edges[0].shape[0])
    return s, t, edges[2].reshape(-1), edges[3].reshape(-1)


_K1_TABLE_CASES = [(n, e, r, d, B, rate)
                   for n, e, r, d in ((7128, 256, 460, 128), (50, 0, 3, 32),
                                      (300, 5000, 7, 256), (33, 90, 4, 16))
                   for B, rate in ((1, 1.0), (3, 0.5))]


@pytest.mark.parametrize("n,e,r,d,B,rate", _K1_TABLE_CASES)
def test_spmm_tables_match_in_call_route(cuda, n, e, r, d, B, rate):
    """K1f and K1b over the static tables (one launch each, no sort in the
    call) equal the route that sorts the call's edges bit for bit, and the
    plain versions within 1e-5 of the largest entry; for one graph and
    for B graphs side by side, under the static mask and a 50% mask."""
    h, edges, w, tables = _k1_tables_case(n, e, r, d, cuda, B, rate)
    fl, fb, builds = spmm_fwd.launches, spmm_bwd.launches, \
        spmm_fwd.csr_builds
    out = spmm_fwd(h, *edges, w, tables=tables)
    g = torch.randn_like(h)
    deg = torch.zeros(h.shape[0], device=cuda).index_add_(
        0, _k1_flat(h, edges)[1], edges[3].reshape(-1).float())
    n2 = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0) ** 2
    dh, dw = spmm_bwd(g, n2, h, *edges, w, tables=tables)
    torch.cuda.synchronize()
    assert (spmm_fwd.launches, spmm_bwd.launches, spmm_fwd.csr_builds) == (
        fl + 1, fb + 1, builds)
    assert torch.equal(out, spmm_fwd(h, *edges, w))
    ch, cw = spmm_bwd(g, n2, h, *edges, w)
    assert torch.equal(dh, ch) and torch.equal(dw, cw)
    assert spmm_fwd.csr_builds == builds + 2
    flat = _k1_flat(h, edges)
    assert _scaled_ok(out, spmm_fwd_plain(h, *flat, w), 1e-5)[0]
    rh, rw = spmm_bwd_plain(g, n2, h, *flat, w)
    assert _scaled_ok(dh, rh, 1e-5)[0] and _scaled_ok(dw, rw, 1e-5)[0]


@pytest.mark.parametrize("off", [0, 5])
def test_spmm_at_the_attention_history_shape(cuda, off):
    """K1f and K1b at the attention models' history shape (SARGCN's: one
    element's 14 window slots side by side, 7128 rows each): over the
    tables one launch each and no sort, bit-equal to the in-call route and
    within 1e-5 of the largest entry of the plain versions. With `off`
    slots running off the data, as a window before t = 0 does: they name
    the clamped position 0 and mask every edge, and their rows are 0."""
    t_pos = (torch.arange(14) - off).clamp(min=0)
    h, edges, w, tables = _k1_tables_case(7128, 256, 460, 128, cuda,
                                          rate=0.8, T=20, t_pos=t_pos)
    src, dst, rel, mask = edges
    mask = mask.clone()
    mask[:off] = False
    edges = (src, dst, rel, mask)
    fl, fb, builds = spmm_fwd.launches, spmm_bwd.launches, \
        spmm_fwd.csr_builds
    out = spmm_fwd(h, *edges, w, tables=tables)
    g = torch.randn_like(h)
    flat = _k1_flat(h, edges)
    n2 = _norm2_plain(flat[1], flat[3].float(), h.shape[0])
    dh, dw = spmm_bwd(g, n2, h, *edges, w, tables=tables)
    torch.cuda.synchronize()
    assert (spmm_fwd.launches, spmm_bwd.launches, spmm_fwd.csr_builds) == (
        fl + 1, fb + 1, builds)
    assert torch.equal(out, spmm_fwd(h, *edges, w))
    ch, cw = spmm_bwd(g, n2, h, *edges, w)
    assert torch.equal(dh, ch) and torch.equal(dw, cw)
    assert not out[:off * 7128].any()
    assert _scaled_ok(out, spmm_fwd_plain(h, *flat, w), 1e-5)[0]
    rh, rw = spmm_bwd_plain(g, n2, h, *flat, w)
    assert _scaled_ok(dh, rh, 1e-5)[0] and _scaled_ok(dw, rw, 1e-5)[0]


def test_attention_models_train_and_evaluate_kernels_like_plain(cuda):
    """SARGCN (dense history) and BiSARGCN (sa_compact) at a small size:
    two training steps and an eval sweep with the kernels and with their
    plain versions, held to TOL; the kernel path launches K1f and K1b and
    sorts no call's edges."""
    data = make_synthetic(num_ents=300, num_rels=6, num_times=12,
                          edges_per_time=60, seed=0, edge_pad_multiple=16)
    for flags in ({"module": "SARGCN"},
                  {"module": "BiSARGCN", "sa_compact": True}):
        out = {}
        for kernels in (True, False):
            cfg = TKGConfig(embed_size=32, hidden_size=32, n_bases=32,
                            train_seq_len=5, batch_size=4, dropout=0.1,
                            kernels=kernels, **flags)
            d = ring_layout(cfg, data)
            tr = Trainer(cfg, get_model(cfg, d, device="cuda"), d)
            params, opt = tr.init_state()
            fl, fb, builds = spmm_fwd.launches, spmm_bwd.launches, \
                spmm_fwd.csr_builds
            losses = [float(tr.train_step(params, opt, t, v,
                                          gen=tr.step_generator(0, i)))
                      for i, (t, v) in enumerate(tr.epoch_batches(0)[:2])]
            out[kernels] = (losses, tr.run_eval(params, "valid"),
                            (spmm_fwd.launches - fl, spmm_bwd.launches - fb,
                             spmm_fwd.csr_builds - builds))
        (lk, mk, nk), (lp, mp, np_) = out[True], out[False]
        assert all(abs(a - b) <= TOL * max(1.0, abs(b))
                   for a, b in zip(lk, lp))
        assert mk["n"] == mp["n"] > 0 and abs(mk["mrr"] - mp["mrr"]) <= TOL
        assert nk[0] > 0 and nk[1] > 0 and nk[2] == 0 and np_ == (0, 0, 0)


@pytest.mark.parametrize("flags", [
    {"module": "RRGCN"}, {"module": "BiRRGCN"}, {"module": "SRGCN"},
    {"module": "GRRGCN", "type1": True, "learnable_lambda": True,
     "use_time_embedding": True, "random_dropout": True},
    {"module": "BiRRGCN", "rec_only_last_layer": True,
     "edge_dropout": True}])
def test_linear_and_static_models_train_and_evaluate_kernels_like_plain(
        cuda, flags):
    """RRGCN, BiRRGCN and SRGCN, and the recurrent options, at a small
    size: two training steps and an eval sweep with the kernels and with
    their plain versions, held to TOL; the kernel path launches K1f and
    K1b (two a layer's graph product: the window steps' B graphs side by
    side, then each element's final snapshot) and sorts no call's
    edges."""
    data = make_synthetic(num_ents=300, num_rels=6, num_times=12,
                          edges_per_time=60, seed=0, edge_pad_multiple=16)
    out = {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=32, hidden_size=32, n_bases=32,
                        train_seq_len=5, batch_size=4, dropout=0.1,
                        kernels=kernels, **flags)
        d = ring_layout(cfg, data)
        model = get_model(cfg, d, device="cuda")
        tr = Trainer(cfg, model, d)
        params, opt = tr.init_state()
        fl, fb, builds = spmm_fwd.launches, spmm_bwd.launches, \
            spmm_fwd.csr_builds
        batches = tr.epoch_batches(0)[:2]
        losses = [float(tr.train_step(params, opt, t, v,
                                      gen=tr.step_generator(0, i)))
                  for i, (t, v) in enumerate(batches)]
        out[kernels] = (losses, tr.run_eval(params, "valid"),
                        (spmm_fwd.launches - fl, spmm_bwd.launches - fb,
                         spmm_fwd.csr_builds - builds))
    (lk, mk, nk), (lp, mp, np_) = out[True], out[False]
    assert all(abs(a - b) <= TOL * max(1.0, abs(b)) for a, b in zip(lk, lp))
    assert mk["n"] == mp["n"] > 0 and abs(mk["mrr"] - mp["mrr"]) <= TOL
    assert nk[0] > 0 and nk[1] > 0 and nk[2] == 0 and np_ == (0, 0, 0)
    windows = (0 if flags["module"] == "SRGCN"
               else 2 if flags["module"].startswith("Bi") else 1)
    n_valid = sum(int(v.sum()) for _, v in batches)
    per_layer = 2 * (cfg.train_seq_len - 1) * windows * len(batches)
    assert nk[1] == per_layer + 2 * n_valid


def test_spmm_table_route_makes_no_sync(cuda):
    """One table-route call of K1f, of K1b and of the differentiable K1
    forward and backward makes no synchronizing CUDA call."""
    h, edges, w, tables = _k1_tables_case(7128, 256, 460, 128, cuda, 3, 0.5)
    g = torch.randn_like(h)
    n2 = torch.rand(h.shape[0], device=cuda)
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spmm_fwd(h, *edges, w, tables=tables)
        spmm_bwd(g, n2, h, *edges, w, tables=tables)
        spmm(hh, *edges, ww, tables=tables).backward(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert hh.grad is not None and ww.grad is not None


def _window_args(B, L1, A, E, d, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    prev_step = torch.randint(-1, L1, (B, L1, A), generator=g)
    prev_step = torch.minimum(prev_step,
                              torch.arange(L1)[None, :, None] - 1)
    kw = dict(
        h0_xs=torch.randn(B, L1, A, d, generator=g) * 0.5,
        src=torch.randint(0, A, (B, L1, E), generator=g),
        dst=torch.randint(0, A, (B, L1, E), generator=g),
        rel=torch.randint(0, 9, (B, L1, E), generator=g),
        emask=torch.rand(B, L1, E, generator=g) < 0.9,
        prev_step=prev_step,
        prev_row=torch.randint(0, A, (B, L1, A), generator=g),
    )
    kw["live"] = kw["prev_step"] >= 0
    kw["dt"] = (torch.arange(L1)[None, :, None]
                - kw["prev_step"].clamp(min=0)).float()
    kw = {k: v.to(dev) for k, v in kw.items()}

    def lin(*s):
        return (torch.rand(*s, generator=g) - 0.5).to(dev) * 0.5

    enc = {f"layer{i}": {"weight": lin(9, d), "loop_weight": lin(d, d),
                         "gru": [{"w_ih": lin(3 * d, d),
                                  "w_hh": lin(3 * d, d),
                                  "b_ih": lin(3 * d), "b_hh": lin(3 * d)}]}
           for i in (1, 2)}
    return enc, kw


@pytest.mark.parametrize("conv1_in", [True, False])
@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 37, 20, 16),
                                        (2, 3, 100, 300, 256)])
def test_window_kernel_matches_plain(cuda, conv1_in, B, L1, A, E, d):
    enc, kw = _window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    before = fused_window_fwd.launches
    k1, k2 = fused_window_scan(enc, cfg, conv1_in=conv1_in, **kw)
    torch.cuda.synchronize()
    assert fused_window_fwd.launches == before + 2 * L1
    p1, p2 = fused_window_scan(enc, cfg, conv1_in=conv1_in, kernels=False,
                               **kw)
    assert float((k1 - p1).abs().max()) <= TOL
    assert float((k2 - p2).abs().max()) <= TOL


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    enc, kw = _window_args(2, 3, 10, 8, 16, cuda)
    cfg = TKGConfig(embed_size=16, hidden_size=16, n_bases=16)
    with pytest.raises(TypeError):
        fused_window_scan(enc, cfg, **{**kw, "h0_xs": kw["h0_xs"].double()})
    with pytest.raises(ValueError):  # h0x batch does not match the edges
        fused_window_scan(enc, cfg, **{**kw, "h0_xs": kw["h0_xs"][:1]})


def test_run_eval_kernels_match_plain_path(cuda):
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    out = {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128,
                        train_seq_len=6, batch_size=4, kernels=kernels)
        model = get_model(cfg, data, device=cuda)
        params = model.init_params(0)
        spmm_fwd.launches = fused_window_fwd.launches = 0
        out[kernels] = Trainer(cfg, model, data).eval_sweep(params, "valid")
        if kernels:
            assert spmm_fwd.launches > 0 and fused_window_fwd.launches > 0
        else:
            assert spmm_fwd.launches == fused_window_fwd.launches == 0
    (rk, mk, bk), (rp, mp, bp) = out[True], out[False]
    assert torch.equal(mk, mp)
    same = float((rk[mk] == rp[mp]).float().mean())
    assert same >= 0.99
    assert float((bk - bp).abs().max()) <= TOL
    mrr_k = float((1.0 / rk[mk].double()).mean())
    mrr_p = float((1.0 / rp[mp].double()).mean())
    assert abs(mrr_k - mrr_p) <= TOL
    assert np.isfinite(mrr_k)


@pytest.mark.parametrize("n,e,r,d", [(7128, 128, 460, 128), (50, 0, 3, 32),
                                     (300, 5000, 7, 256), (33, 90, 4, 16)])
def test_spmm_bwd_kernel_matches_plain(cuda, n, e, r, d):
    h, src, dst, rel, em, w = _graph(n, e, r, d, cuda)
    g = torch.randn(n, d, device=cuda)
    deg = torch.zeros(n, device=cuda).index_add_(0, dst.long(), em.float())
    n2 = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0) ** 2
    before = spmm_bwd.launches
    dh, dw = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    torch.cuda.synchronize()
    assert spmm_bwd.launches == before + 1
    rh, rw = spmm_bwd_plain(g, n2, h, src, dst, rel, em, w)
    assert _close(dh, rh) and _close(dw, rw)


def test_spmm_autograd_matches_plain_autograd(cuda):
    h, src, dst, rel, em, w = _graph(400, 900, 11, 128, cuda)
    g = torch.randn(400, 128, device=cuda)
    grads = []
    for fn in (spmm, spmm_fwd_plain):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(hh, src, dst, rel, em, ww) * g).sum().backward()
        grads.append((hh.grad, ww.grad))
    (kh, kw), (ph, pw) = grads
    assert _scaled_ok(kh, ph)[0] and _scaled_ok(kw, pw)[0]


def _train_window_args(B, L1, A, E, d, dev, seed=0, rate=0.1):
    """Window inputs whose history tables come from simulated entity
    activity, as data/snapshots.build_history_tables makes them: each
    live row names the row of its entity's last earlier step, so no two
    live rows name the same row. Plus seeded dropout masks over keep."""
    enc, kw = _window_args(B, L1, A, E, d, dev, seed)
    rs = np.random.RandomState(seed)
    prev_step = np.full((B, L1, A), -1, np.int64)
    prev_row = np.zeros((B, L1, A), np.int64)
    for b in range(B):
        last = {}
        for k in range(L1):
            ents = rs.permutation(2 * A)[:A]
            for a, ent in enumerate(ents):
                if ent in last:
                    prev_step[b, k, a], prev_row[b, k, a] = last[ent]
            for a, ent in enumerate(ents):
                last[ent] = (k, a)
    kw["prev_step"] = torch.from_numpy(prev_step).to(dev)
    kw["prev_row"] = torch.from_numpy(prev_row).to(dev)
    kw["live"] = kw["prev_step"] >= 0
    kw["dt"] = (torch.arange(L1, device=dev)[None, :, None]
                - kw["prev_step"].clamp(min=0)).float()
    keep = 1.0 - rate
    g = torch.Generator(device=dev).manual_seed(seed)
    masks = tuple((torch.rand(B, L1, A, d, generator=g, device=dev) < keep)
                  .float() / keep for _ in range(2))
    return enc, kw, masks


def _leaves(enc, h0):
    return [h0] + param_leaves(enc)


@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 37, 20, 16),
                                        (2, 3, 100, 300, 64)])
def test_window_train_kernels_match_plain_autograd(cuda, B, L1, A, E, d):
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = [torch.randn(B, L1, A, d, generator=gen, device=cuda)
           for _ in range(2)]
    res = {}
    for kernels in (True, False):
        e = {k: {"weight": v["weight"].clone().requires_grad_(),
                 "loop_weight": v["loop_weight"].clone().requires_grad_(),
                 "gru": [{n: t.clone().requires_grad_()
                          for n, t in v["gru"][0].items()}]}
             for k, v in enc.items()}
        h0 = kw["h0_xs"].clone().requires_grad_()
        fb, bb = fused_window_fwd.launches, fused_window_bwd.launches
        b1, b2 = fused_window_scan(e, cfg, kernels=kernels, masks=masks,
                                   **{**kw, "h0_xs": h0})
        ((b1 * cot[0]).sum() + (b2 * cot[1]).sum()).backward()
        torch.cuda.synchronize()
        if kernels:
            assert fused_window_fwd.launches == fb + 2 * L1
            assert fused_window_bwd.launches == bb + 5 * L1 + 2
        res[kernels] = (b1.detach(), b2.detach(),
                        [t.grad for t in _leaves(e, h0)])
    (k1, k2, kg), (p1, p2, pg) = res[True], res[False]
    assert float((k1 - p1).abs().max()) <= TOL
    assert float((k2 - p2).abs().max()) <= TOL
    assert len(kg) == 13  # h0x, and per layer weight, loop, 4 GRU tensors
    for a, b in zip(kg, pg):
        assert _close(a, b)


def test_window_bwd_refuses_what_it_does_not_take(cuda):
    enc, kw, masks = _train_window_args(2, 3, 10, 8, 16, cuda)
    cfg = TKGConfig(embed_size=16, hidden_size=16, n_bases=16)
    h0 = kw["h0_xs"].clone().requires_grad_()
    b1, b2 = fused_window_scan(enc, cfg, masks=masks, **{**kw, "h0_xs": h0})
    with pytest.raises(RuntimeError):  # conv1_in has no backward
        c1, _ = fused_window_scan(enc, cfg, conv1_in=True,
                                  **{**kw, "h0_xs": h0})
        c1.sum().backward()
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_window_scan(enc, cfg, masks=(masks[0][:1], masks[1]), **kw)
    enc2, kw2, masks2 = _train_window_args(1, 2, 8, 4, 256, cuda)
    cfg2 = TKGConfig(embed_size=256, hidden_size=256, n_bases=256)
    h2 = kw2["h0_xs"].clone().requires_grad_()
    out, _ = fused_window_scan(enc2, cfg2, masks=masks2,
                               **{**kw2, "h0_xs": h2})
    with pytest.raises(ValueError):  # d = 256: no backward kernel
        out.sum().backward()
    h, src, dst, rel, em, w = _graph(20, 30, 3, 16, cuda)
    n2 = torch.ones(20, device=cuda)
    with pytest.raises(ValueError):  # g of the wrong shape
        spmm_bwd(torch.zeros(20, 8, device=cuda), n2, h, src, dst, rel, em, w)
    with pytest.raises(TypeError):
        spmm_bwd(h.double(), n2.double(), h.double(), src, dst, rel, em,
                 w.double())


def test_training_steps_kernels_match_plain_path(cuda):
    """The unfused final step (fused_final off): K1 and K2 with their
    backward kernels against the plain path."""
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    losses, finals = {}, {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128,
                        train_seq_len=6, batch_size=4, kernels=kernels,
                        num_pos_facts=40, fused_final=False)
        model = get_model(cfg, data, device=cuda)
        tr = Trainer(cfg, model, data)
        params, opt = tr.init_state(0)
        counts = (spmm_fwd.launches, spmm_bwd.launches,
                  fused_window_fwd.launches, fused_window_bwd.launches)
        losses[kernels] = []
        for step, (t_pos, t_valid) in enumerate(tr.epoch_batches(0)[:3]):
            gen = tr.step_generator(0, step)
            losses[kernels].append(float(tr.train_step(
                params, opt, t_pos, t_valid, gen=gen)))
        now = (spmm_fwd.launches, spmm_bwd.launches,
               fused_window_fwd.launches, fused_window_bwd.launches)
        if kernels:
            assert all(n > c for n, c in zip(now, counts))
        else:
            assert now == counts
        finals[kernels] = [p.detach() for p in param_leaves(params)]
    for a, b in zip(losses[True], losses[False]):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    for a, b in zip(finals[True], finals[False]):
        assert _close(a, b)


def test_backward_kernels_are_deterministic(cuda):
    """K1b and K2b use no atomics: two runs on the same inputs agree bit for
    bit."""
    h, src, dst, rel, em, w = _graph(7128, 256, 460, 128, cuda)
    g = torch.randn(7128, 128, device=cuda)
    n2 = torch.rand(7128, device=cuda)
    a = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    b = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    enc, kw, masks = _train_window_args(8, 14, 640, 256, 128, cuda)
    for t in param_leaves(enc):
        t.requires_grad_(True)
    cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128)
    runs = []
    for _ in range(2):
        h0 = kw["h0_xs"].clone().requires_grad_()
        b1, b2 = fused_window_scan(enc, cfg, masks=masks,
                                   **{**kw, "h0_xs": h0})
        grads = torch.autograd.grad(b1.sum() + 2.0 * b2.sum(),
                                    [h0] + param_leaves(enc),
                                    allow_unused=True)
        runs.append(grads)
    for x, y in zip(*runs):
        assert (x is None and y is None) or torch.equal(x, y)


# -- K3, K4, K5: the fused final step and loss ------------------------------

def _final_case(N, d, dev, B=4, seed=0, noact=False, rate=0.1, num_rels=12,
                edges_per_time=60, pad=16, L=6):
    """A batch of B final steps on synthetic data: the snapshots' edges
    (padded slots included) and true-answer lists, seeded draws, random
    history, dt and weights."""
    host = make_synthetic(
        num_ents=N, num_rels=num_rels, num_times=B + 4,
        edges_per_time=edges_per_time, seed=seed, edge_pad_multiple=pad)
    data = to_device(host, dev)
    answers = to_device(build_answer_lists(host), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tp = torch.arange(B, device=dev) + 2
    em = data.train.emask[tp]
    draws = {"edges": subsample_edges(gen, em, 0.5),
             "pos": subsample_positives(gen, em, 40),
             "fin1": None, "fin2": None}
    if rate > 0:
        draws["fin1"], draws["fin2"] = (dropout_mask(gen, (B, N, d), rate,
                                                     dev) for _ in range(2))
    last_pos = torch.randint(0, L - 1, (B, N), generator=gen,
                             device=dev).float()
    gr = final_graph(data, answers, tp, draws, last_pos, 0.1, rate, L,
                     noact)

    def lin(*s, scale=0.5):
        return (torch.rand(*s, generator=gen, device=dev) - 0.5) * scale

    R = 2 * num_rels
    w = dict(h0=lin(N, d, scale=1.0), hist1=lin(B, N, d, scale=1.0),
             hist2=lin(B, N, d, scale=1.0), wrel=lin(R, 2 * d),
             loop1=lin(d, d), loop2=lin(d, d), rtab=lin(R, d, scale=1.0),
             g1={k: lin(*s) for k, s in (("wih_t", (d, 3 * d)),
                                         ("whh_t", (d, 3 * d)),
                                         ("bih", (3 * d,)),
                                         ("bhh", (3 * d,)))},
             g2={k: lin(*s) for k, s in (("wih_t", (d, 3 * d)),
                                         ("whh_t", (d, 3 * d)),
                                         ("bih", (3 * d,)),
                                         ("bhh", (3 * d,)))})
    return gr, w


def _fwd_args(w):
    return (w["h0"], w["hist1"], w["hist2"])


_FINAL_SHAPES = [(7128, 128, 8, 230, 200, 128), (300, 32, 4, 12, 60, 16),
                 (77, 16, 3, 5, 20, 16)]


@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_fused_final_fwd_kernel_matches_plain(cuda, noact, N, d, B, R, per,
                                              pad):
    gr, w = _final_case(N, d, cuda, B=B, noact=noact, num_rels=R,
                        edges_per_time=per, pad=pad)
    args = (*_fwd_args(w), gr, w["wrel"], w["loop1"], w["loop2"], w["g1"],
            w["g2"], w["rtab"])
    before = fused_final_fwd.launches
    loss, saved = fused_final_fwd(*args)
    torch.cuda.synchronize()
    assert fused_final_fwd.launches == before + 4
    ref, table, out1 = fused_final_fwd_plain(*args)
    assert float((saved["out1"] - out1).abs().max()) <= TOL
    assert float((saved["table"] - table).abs().max()) <= TOL
    assert float(((loss - ref) / ref.abs().clamp(min=1.0)).abs().max()) <= TOL
    assert torch.isfinite(loss).all() and (loss > 0).all()


@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_fused_final_bwd_loss_kernel_matches_plain(cuda, N, d, B, R, per,
                                                   pad):
    gr, w = _final_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                        pad=pad)
    _, saved = fused_final_fwd(*_fwd_args(w), gr, w["wrel"], w["loop1"],
                               w["loop2"], w["g1"], w["g2"], w["rtab"])
    g = torch.rand(B, device=cuda) + 0.5
    g[-1] = 0.0  # an element whose t_valid is False
    before = fused_final_bwd_loss.launches
    d_table, d_rtab = fused_final_bwd_loss(saved, w["rtab"], gr, g)
    torch.cuda.synchronize()
    assert fused_final_bwd_loss.launches == before + 4
    r_table, r_rtab = fused_final_bwd_loss_plain(saved["table"], w["rtab"],
                                                 gr, g)
    assert _close(d_table, r_table) and _close(d_rtab, r_rtab)
    assert float(d_table[-1].abs().max()) == 0.0


@pytest.mark.parametrize("col_layer", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_fused_final_bwd_layer_kernel_matches_plain(cuda, col_layer, rate, N,
                                                    d, B, R, per, pad):
    gr, w = _final_case(N, d, cuda, B=B, rate=rate, num_rels=R,
                        edges_per_time=per, pad=pad)
    gen = torch.Generator(device=cuda).manual_seed(3)
    d_out = torch.randn(B, N, d, generator=gen, device=cuda)
    if col_layer == 1:
        args = (w["h0"], w["hist1"], gr, gr.m1, w["wrel"], 0, w["loop1"],
                w["g1"], d_out)
    else:
        h_in = torch.randn(B, N, d, generator=gen, device=cuda) * 0.5
        args = (h_in, w["hist2"], gr, gr.m2, w["wrel"], d, w["loop2"],
                w["g2"], d_out)
    before = fused_final_bwd_layer.launches
    got = fused_final_bwd_layer(*args)
    torch.cuda.synchronize()
    assert fused_final_bwd_layer.launches == before + 5
    ref = fused_final_bwd_layer_plain(*args)
    assert len(got) == len(ref) == 8
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _close(a, b)


@pytest.mark.parametrize("noact", [False, True])
def test_fused_final_autograd_matches_plain_autograd(cuda, noact):
    gr, w = _final_case(300, 32, cuda, B=4, noact=noact)
    tv = torch.tensor([1.0, 1.0, 0.0, 1.0], device=cuda)
    grads = []
    for kernels in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in w.items()
                  if not k.startswith("g")}
        gru = {k: {n: t.clone().requires_grad_() for n, t in w[k].items()}
               for k in ("g1", "g2")}
        params = {"ent_embeds": leaves["h0"], "rel_embeds": leaves["rtab"],
                  "encoder": {
                      f"layer{i}": {
                          "weight": leaves["wrel"][:, (i - 1) * 32:i * 32],
                          "loop_weight": leaves[f"loop{i}"],
                          "gru": [{"w_ih": gru[f"g{i}"]["wih_t"].t(),
                                   "w_hh": gru[f"g{i}"]["whh_t"].t(),
                                   "b_ih": gru[f"g{i}"]["bih"],
                                   "b_hh": gru[f"g{i}"]["bhh"]}]}
                      for i in (1, 2)}}
        loss = fused_final_loss(params, gr, leaves["hist1"],
                                leaves["hist2"], kernels=kernels)
        (loss * tv).sum().backward()
        grads.append([leaves[k].grad for k in sorted(leaves)]
                     + [gru[g][n].grad for g in ("g1", "g2")
                        for n in sorted(gru[g])])
    for a, b in zip(*grads):
        assert _close(a, b)


def test_fused_final_kernels_refuse_what_they_do_not_take(cuda):
    gr, w = _final_case(77, 16, cuda, B=3)
    args = dict(h0=w["h0"], hist1=w["hist1"], hist2=w["hist2"], gr=gr,
                wrel=w["wrel"], loop1=w["loop1"], loop2=w["loop2"],
                g1=w["g1"], g2=w["g2"], rtab=w["rtab"])
    with pytest.raises(TypeError):
        fused_final_fwd(**{**args, "hist1": w["hist1"].double()})
    with pytest.raises(ValueError):  # history of another batch size
        fused_final_fwd(**{**args, "hist2": w["hist2"][:2]})
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_final_fwd(**{**args, "gr": gr._replace(
            m1=torch.ones(3, 77, 8, device=cuda))})
    with pytest.raises(ValueError):
        fused_final_fwd(**{**args, "hist1": w["hist1"].transpose(1, 2)
                           .contiguous().transpose(1, 2)})
    gr2, w2 = _final_case(40, 256, cuda, B=2, num_rels=3, edges_per_time=10)
    with pytest.raises(ValueError):  # d = 256: K5 takes d <= 128
        fused_final_fwd(w2["h0"], w2["hist1"], w2["hist2"], gr2, w2["wrel"],
                        w2["loop1"], w2["loop2"], w2["g1"], w2["g2"],
                        w2["rtab"])
    _, saved = fused_final_fwd(**args)
    with pytest.raises(ValueError):  # g of the wrong shape
        fused_final_bwd_loss(saved, w["rtab"], gr, torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        fused_final_bwd_layer(w["h0"], w["hist1"], gr, gr.m1, w["wrel"], 5,
                              w["loop1"], w["g1"], w["hist1"])


def test_fused_final_training_steps_match_plain_and_unfused(cuda):
    """Training steps on the fused path (K3-K5) against the plain path and
    the unfused path (K1, fused_final off), from the same weights and
    draws."""
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    losses, finals = {}, {}
    counters = (fused_final_fwd, fused_final_bwd_loss, fused_final_bwd_layer,
                spmm_fwd, spmm_bwd)
    for name, kw in (("fused", {}), ("plain", {"kernels": False}),
                     ("unfused", {"fused_final": False})):
        cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128,
                        train_seq_len=6, batch_size=4, num_pos_facts=40,
                        **kw)
        model = get_model(cfg, data, device=cuda)
        assert model.fused_final_on() == (name != "unfused")
        tr = Trainer(cfg, model, data)
        params, opt = tr.init_state(0)
        for fn in counters:
            fn.launches = 0
        losses[name] = [float(tr.train_step(params, opt, t_pos, t_valid,
                                            gen=tr.step_generator(0, step)))
                        for step, (t_pos, t_valid)
                        in enumerate(tr.epoch_batches(0)[:3])]
        n = {fn.__name__: fn.launches for fn in counters}
        if name == "fused":
            assert n["fused_final_fwd"] == 12 and n["spmm_fwd"] == 0
            assert n["fused_final_bwd_loss"] == 12
            assert n["fused_final_bwd_layer"] == 30
        elif name == "plain":
            assert not any(n.values())
        else:
            assert n["spmm_bwd"] > 0 and n["fused_final_fwd"] == 0
        finals[name] = [p.detach() for p in param_leaves(params)]
    for other in ("plain", "unfused"):
        for a, b in zip(losses["fused"], losses[other]):
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
        for a, b in zip(finals["fused"], finals[other]):
            assert _close(a, b)


def test_final_backward_kernels_are_deterministic(cuda):
    """K4 and K5 use no atomics: two runs on the same inputs agree bit for
    bit."""
    gr, w = _final_case(7128, 128, cuda, B=8, num_rels=230,
                        edges_per_time=200, pad=128)
    _, saved = fused_final_fwd(*_fwd_args(w), gr, w["wrel"], w["loop1"],
                               w["loop2"], w["g1"], w["g2"], w["rtab"])
    g = torch.ones(8, device=cuda)
    a = fused_final_bwd_loss(saved, w["rtab"], gr, g)
    b = fused_final_bwd_loss(saved, w["rtab"], gr, g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    args = (saved["out1"], w["hist2"], gr, gr.m2, w["wrel"], 128, w["loop2"],
            w["g2"], a[0])
    x = fused_final_bwd_layer(*args)
    y = fused_final_bwd_layer(*args)
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_fused_final_element_without_positives(cuda):
    """An element with no positive edge slot (a snapshot without train
    facts) has loss 0 and adds nothing to any cotangent, on the kernels as
    on the plain versions."""
    gr, w = _final_case(300, 32, cuda, B=3)
    posm = gr.posm.clone()
    posm[1] = 0.0
    gr = gr._replace(posm=posm)
    args = (*_fwd_args(w), gr, w["wrel"], w["loop1"], w["loop2"], w["g1"],
            w["g2"], w["rtab"])
    loss, saved = fused_final_fwd(*args)
    ref, _, _ = fused_final_fwd_plain(*args)
    assert float(loss[1]) == 0.0 and float(ref[1]) == 0.0
    assert float(((loss - ref) / ref.abs().clamp(min=1.0)).abs().max()) <= TOL
    g = torch.ones(3, device=cuda)
    d_table, d_rtab = fused_final_bwd_loss(saved, w["rtab"], gr, g)
    r_table, r_rtab = fused_final_bwd_loss_plain(saved["table"], w["rtab"],
                                                 gr, g)
    assert float(d_table[1].abs().max()) == 0.0
    assert _close(d_table, r_table) and _close(d_rtab, r_rtab)


# -- the flagship: K2's new modes and K6-K10 ---------------------------------

def _bi_enc(enc, dev, seed=1):
    """The window tests' encoder with a GRU a direction: gru_fwd the given
    one, gru_bwd other random weights."""
    g = torch.Generator().manual_seed(seed)
    return {k: {"weight": v["weight"], "loop_weight": v["loop_weight"],
                "gru_fwd": v["gru"],
                "gru_bwd": [{n: ((torch.rand(t.shape, generator=g) - 0.5)
                                 * 0.5).to(dev)
                             for n, t in v["gru"][0].items()}]}
            for k, v in enc.items()}


# the TeMP variants' modes of K2: (n_buf, layer 2's ReLU, direction)
_NEW_K2_MODES = {"a": (3, False, None), "b": (2, True, "bwd")}


@pytest.mark.parametrize("mode", list(_NEW_K2_MODES))
@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (8, 7, 640, 256, 128),
                                        (3, 4, 37, 20, 16)])
def test_window_new_modes_match_plain_autograd(cuda, mode, B, L1, A, E, d):
    """K2f/K2b in the modes of the TeMP variants, (a) three buffers without
    the ReLU (the unidirectional Post models) and (b) two with it
    (BiGRRGCN), in train mode, against autograd through the plain forward
    with a cotangent on every buffer: buffers within TOL, cotangents within
    _close. In mode (b) the plain forward takes the kernels' ReLU pattern,
    read from the same launches with the third buffer written."""
    n_buf, relu, direction = _NEW_K2_MODES[mode]
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    if direction is not None:
        enc = _bi_enc(enc, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    act2 = "relu" if relu else None
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = [torch.randn(B, L1, A, d, generator=gen, device=cuda)
           for _ in range(n_buf)]
    pattern = None
    if relu:
        with torch.no_grad():
            pattern = (fused_window_scan(
                enc, cfg, masks=masks, direction=direction, activation2=act2,
                n_buf=3, **kw)[2] > 0).float()
    res = {}
    for kernels in (True, False):
        e = {k: {n: ([{m: t.clone().requires_grad_() for m, t in v[0].items()}]
                     if n.startswith("gru") else v.clone().requires_grad_())
                 for n, v in layer.items()} for k, layer in enc.items()}
        h0 = kw["h0_xs"].clone().requires_grad_()
        if kernels:
            bufs = fused_window_scan(e, cfg, kernels=True, masks=masks,
                                     direction=direction, activation2=act2,
                                     n_buf=n_buf, **{**kw, "h0_xs": h0})
        else:
            a = window_args(e, cfg, masks=masks, direction=direction,
                            activation2=act2, **{**kw, "h0_xs": h0})
            bufs = fused_window_fwd_plain(conv1_in=False, n_buf=n_buf,
                                          relu_mask=pattern, **a)
        assert len(bufs) == n_buf
        sum((b * c).sum() for b, c in zip(bufs, cot)).backward()
        torch.cuda.synchronize()
        grads = [h0.grad] + [t.grad for t in param_leaves(e)
                             if t.grad is not None]
        res[kernels] = ([b.detach() for b in bufs], grads)
    (kb, kg), (pb, pg) = res[True], res[False]
    for a, b in zip(kb, pb):
        assert float((a - b).abs().max()) <= TOL
    assert len(kg) == len(pg) == 13
    for a, b in zip(kg, pg):
        assert _close(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("B,L1,A,E,d", [(8, 7, 640, 256, 128),
                                        (3, 4, 37, 20, 16)])
def test_window_flagship_modes_match_plain_autograd(cuda, direction, rate, B,
                                                    L1, A, E, d):
    """K2f/K2b in the flagship's modes (the ReLU on layer 2, the third
    buffer, either direction's GRUs) against autograd through the plain
    forward, with a cotangent on all three buffers. The plain forward takes
    the kernels' ReLU pattern (their third buffer > 0): the two forwards
    round differently, and where layer 2's conv output lies within that
    rounding of 0 they may fall on either side of the ReLU, where the
    cotangents differ by the whole upstream cotangent."""
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    enc = _bi_enc(enc, cuda)
    masks = masks if rate > 0 else None
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = [torch.randn(B, L1, A, d, generator=gen, device=cuda)
           for _ in range(3)]
    used = "gru_fwd" if direction == "fwd" else "gru_bwd"
    res = {}
    for kernels in (True, False):
        e = {k: {n: ([{m: t.clone().requires_grad_() for m, t in v[0].items()}]
                     if n.startswith("gru") else v.clone().requires_grad_())
                 for n, v in layer.items()} for k, layer in enc.items()}
        h0 = kw["h0_xs"].clone().requires_grad_()
        fb_, bb = fused_window_fwd.launches, fused_window_bwd.launches
        if kernels:
            bufs = fused_window_scan(e, cfg, kernels=True, masks=masks,
                                     direction=direction,
                                     activation2="relu", n_buf=3,
                                     **{**kw, "h0_xs": h0})
            relu = (bufs[2] > 0).float().detach()
        else:
            a = window_args(e, cfg, masks=masks, direction=direction,
                            activation2="relu", **{**kw, "h0_xs": h0})
            bufs = fused_window_fwd_plain(conv1_in=False, n_buf=3,
                                          relu_mask=relu, **a)
        assert len(bufs) == 3
        sum((b * c).sum() for b, c in zip(bufs, cot)).backward()
        torch.cuda.synchronize()
        if kernels:
            assert fused_window_fwd.launches == fb_ + 2 * L1
            assert fused_window_bwd.launches == bb + 5 * L1 + 2
        for layer in e.values():
            other = "gru_bwd" if used == "gru_fwd" else "gru_fwd"
            assert all(t.grad is None for t in layer[other][0].values())
        grads = [h0.grad] + [t.grad for layer in e.values()
                             for t in (layer["weight"], layer["loop_weight"],
                                       *layer[used][0].values())]
        res[kernels] = ([b.detach() for b in bufs], grads)
    (kb, kg), (pb, pg) = res[True], res[False]
    for a, b in zip(kb, pb):
        assert float((a - b).abs().max()) <= TOL
    assert float(pb[2].min()) >= 0.0  # the local buffer is after the ReLU
    for a, b in zip(kg, pg):
        assert _close(a, b)


def _bi_case(N, d, dev, B=4, seed=0, noact=False, rate=0.1, num_rels=12,
             edges_per_time=60, pad=16, L=8):
    """A batch of B flagship final steps on synthetic data: the BiGraph
    (edges, true answers, seeded draws, both windows' dt), random histories
    and weights, and impute scalars whose clamp is open for some dt and
    closed for others."""
    host = make_synthetic(
        num_ents=N, num_rels=num_rels, num_times=B + 4,
        edges_per_time=edges_per_time, seed=seed, edge_pad_multiple=pad)
    data = to_device(host, dev)
    answers = to_device(build_answer_lists(host), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tp = torch.arange(B, device=dev) + 2
    em = data.train.emask[tp]
    draws = {"edges": subsample_edges(gen, em, 0.5),
             "pos": subsample_positives(gen, em, 40),
             "fin1": None, "fin2": None}
    if rate > 0:
        draws["fin1"], draws["fin2"] = (dropout_mask(gen, (B, N, d), rate,
                                                     dev) for _ in range(2))
    lp = [torch.randint(0, L - 1, (B, N), generator=gen, device=dev).float()
          for _ in range(2)]
    bg = fb.final_graph_bi(data, answers, tp, draws, lp[0], lp[1], 0.1, rate,
                           L, True, noact)

    def lin(*s, scale=0.5):
        return (torch.rand(*s, generator=gen, device=dev) - 0.5) * scale

    R = 2 * num_rels
    w = dict(h0=lin(N, d, scale=1.0),
             hists=tuple(lin(B, N, d, scale=1.0) for _ in range(6)),
             wrel=lin(R, 2 * d), loop1=lin(d, d), loop2=lin(d, d),
             rtab=lin(R, d, scale=1.0),
             grus={k: {n: lin(*s) for n, s in (("wih_t", (d, 3 * d)),
                                               ("whh_t", (d, 3 * d)),
                                               ("bih", (3 * d,)),
                                               ("bhh", (3 * d,)))}
                   for k in fb._GRUS},
             imp=torch.tensor([0.3, 0.2, -0.1, 0.5], device=dev))
    return bg, w


def _scaled_ok(got, ref, tol=1e-5):
    """max |got - ref| <= tol * max |ref|, no floor; (ok, abs, max ref)."""
    err, top = float((got - ref).abs().max()), float(ref.abs().max())
    return err <= tol * top, err, top


def _bi_layer_args(bg, w, layer, h_in=None):
    """Positional arguments of bi_layer_fwd/_bwd (up to gb) and the keyword
    arguments of one layer."""
    h1f, h2f, hlf, h1b, h2b, hlb = w["hists"]
    d = w["h0"].shape[1]
    if layer == 1:
        return ((w["h0"], h1f, h1b, bg, bg.gr.m1, w["wrel"], 0, w["loop1"],
                 w["grus"]["1f"], w["grus"]["1b"]), {})
    return ((h_in, h2f, h2b, bg, bg.gr.m2, w["wrel"], d, w["loop2"],
             w["grus"]["2f"], w["grus"]["2b"]),
            dict(relu=True, hl=(hlf, hlb), imp=w["imp"]))


_BI_SHAPES = [(7128, 128, 8, 230, 200, 128), (300, 32, 4, 12, 60, 16),
              (77, 16, 3, 5, 20, 16)]


@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_fwd_and_loss_kernels_match_plain(cuda, noact, N, d, B, R,
                                                   per, pad):
    """K6+K7 for both layers (layer 2 with the ReLU, the impute blend and,
    with noact, the select) and K8, each against its plain version on the
    same inputs."""
    bg, w = _bi_case(N, d, cuda, B=B, noact=noact, num_rels=R,
                     edges_per_time=per, pad=pad)
    args1, kw1 = _bi_layer_args(bg, w, 1)
    before = (fb.bi_layer_fwd.launches, fb.bi_loss_fwd.launches)
    out1 = fb.bi_layer_fwd(*args1, **kw1)
    ref1 = fb.bi_layer_fwd_plain(*args1, **kw1)
    args2, kw2 = _bi_layer_args(bg, w, 2, ref1)
    sel = w["h0"] if noact else None
    table = fb.bi_layer_fwd(*args2, **kw2, sel=sel)
    ref2 = fb.bi_layer_fwd_plain(*args2, **kw2, sel=sel)
    loss, saved = fb.bi_loss_fwd(ref2, w["rtab"], bg.gr)
    torch.cuda.synchronize()
    assert (fb.bi_layer_fwd.launches, fb.bi_loss_fwd.launches) == (
        before[0] + 2, before[1] + 2)
    ref_loss = _loss_plain(ref2, w["rtab"], bg.gr)
    for name, a, b in (("layer1", out1, ref1), ("layer2", table, ref2),
                       ("loss", loss, ref_loss)):
        ok, err, top = _scaled_ok(a, b)
        assert ok, (name, err, top)
    assert torch.isfinite(loss).all() and (loss > 0).all()
    assert {"qhat", "lse", "scpos", "cnt", "csr"} <= set(saved)


@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_bwd_kernel_matches_plain(cuda, layer, rate, N, d, B, R, per,
                                           pad):
    """K9+K10 for one layer against its plain version, the same output
    cotangent on both sides: all 16 cotangents (the impute scalars' and the
    local tables' on layer 2)."""
    bg, w = _bi_case(N, d, cuda, B=B, rate=rate, num_rels=R,
                     edges_per_time=per, pad=pad)
    gen = torch.Generator(device=cuda).manual_seed(3)
    h_in = torch.randn(B, N, d, generator=gen, device=cuda) * 0.5
    args, kw = _bi_layer_args(bg, w, layer, h_in)
    d_out = torch.randn(B, N, d, generator=gen, device=cuda)
    before = fb.bi_layer_bwd.launches
    got = fb.bi_layer_bwd(*args, d_out, **kw)
    torch.cuda.synchronize()
    assert fb.bi_layer_bwd.launches == before + 5
    ref = fb.bi_layer_bwd_plain(*args, d_out, **kw)
    assert len(got) == len(ref) == 16
    bad = {}
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None and layer == 1
            continue
        ok, err, top = _scaled_ok(a, b)
        if not (a.shape == b.shape and ok):
            bad[i] = (err, top)
    assert not bad, bad
    if layer == 2:
        assert float(got[5].abs().min()) > 0.0  # all four impute scalars


def test_bi_layer_bwd_is_deterministic(cuda):
    """K9+K10 use no atomics: two runs on the same inputs agree bit for
    bit."""
    bg, w = _bi_case(7128, 128, cuda, B=8, num_rels=230, edges_per_time=200,
                     pad=128)
    gen = torch.Generator(device=cuda).manual_seed(4)
    h_in = torch.randn(8, 7128, 128, generator=gen, device=cuda) * 0.5
    d_out = torch.randn(8, 7128, 128, generator=gen, device=cuda)
    for layer in (1, 2):
        args, kw = _bi_layer_args(bg, w, layer, h_in)
        x = fb.bi_layer_bwd(*args, d_out, **kw)
        y = fb.bi_layer_bwd(*args, d_out, **kw)
        assert all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip(x, y))


# (conv1_in, dropout rate, direction, n_buf, layer 2's ReLU)
_K2F_MODES = [(True, 0.0, None, 2, False),     # eval, the layer-1 convs given
              (False, 0.0, None, 2, False),    # eval, recomputed
              (False, 0.1, None, 2, False),    # GRRGCN training
              (False, 0.1, "fwd", 3, True),    # the flagship's windows
              (False, 0.0, "bwd", 3, True),
              (False, 0.1, None, 3, False),    # (a): the unidirectional Post
              (False, 0.1, "bwd", 2, True)]    # (b): BiGRRGCN


@pytest.mark.parametrize("mode", range(len(_K2F_MODES)))
@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 37, 20, 16),
                                        (2, 3, 100, 300, 48),
                                        (2, 3, 100, 300, 64),
                                        (2, 3, 70, 100, 80),
                                        (2, 3, 100, 300, 256)])
def test_window_fwd_modes_match_plain_and_repeat(cuda, mode, B, L1, A, E, d):
    """K2f on the tensor cores in every mode (the layer-1 convs given or
    recomputed, the training dropout masks, the flagship's ReLU, third
    buffer and either direction's GRUs, the third buffer without the ReLU
    and the ReLU without it) against its plain version within TOL, and two
    runs equal bit for bit: at the main path's shape (two column slabs of
    64), at a ragged A with d = 16 (one warp, one slab), and at widths of
    three warps (48), one slab of four (64), five slabs of one warp (80)
    and four slabs (256)."""
    conv1_in, rate, direction, n_buf, relu = _K2F_MODES[mode]
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda,
                                        rate=rate or 0.1)
    if direction is not None:
        enc = _bi_enc(enc, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    a = window_args(enc, cfg, masks=masks if rate else None,
                    direction=direction, activation2="relu" if relu else None,
                    **kw)
    before = fused_window_fwd.launches
    got = fused_window_fwd(**a, conv1_in=conv1_in, n_buf=n_buf)
    again = fused_window_fwd(**a, conv1_in=conv1_in, n_buf=n_buf)
    torch.cuda.synchronize()
    assert fused_window_fwd.launches == before + 4 * L1
    ref = fused_window_fwd_plain(**a, conv1_in=conv1_in, n_buf=n_buf)
    assert len(got) == len(ref) == n_buf
    for x, y, z in zip(got, again, ref):
        assert torch.equal(x, y)
        assert float((x - z).abs().max()) <= TOL


@pytest.mark.parametrize("relu,impute", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_bi_bwd_gru_ragged_matches_plain_and_repeats(cuda, relu, impute):
    """K9+K10's tensor-core GRU tile at a ragged N (not a multiple of its
    32-row tile) and d = 16 (one slab of one warp's 16 columns), with and
    without the ReLU and the impute blend, against its plain version
    through the kernel's ReLU pattern (``bi_relu_pattern``), and two runs
    equal bit for bit."""
    N, d, B = 37, 16, 3
    bg, w = _bi_case(N, d, cuda, B=B, num_rels=5, edges_per_time=20, pad=16)
    gen = torch.Generator(device=cuda).manual_seed(5)
    h_in = torch.randn(B, N, d, generator=gen, device=cuda) * 0.5
    d_out = torch.randn(B, N, d, generator=gen, device=cuda)
    h1f, h2f, hlf, h1b, h2b, hlb = w["hists"]
    args = (h_in, h2f, h2b, bg, bg.gr.m2, w["wrel"], d, w["loop2"],
            w["grus"]["2f"], w["grus"]["2b"])
    kw = dict(relu=relu, hl=(hlf, hlb) if impute else None,
              imp=w["imp"] if impute else None)
    got = fb.bi_layer_bwd(*args, d_out, **kw)
    again = fb.bi_layer_bwd(*args, d_out, **kw)
    pattern = fb.bi_relu_pattern(*args, d_out, **kw)
    torch.cuda.synchronize()
    ref = fb.bi_layer_bwd_plain(*args, d_out, **kw, relu_mask=pattern)
    assert bool(((pattern == 0) | (pattern == 1)).all())
    assert relu or bool((pattern == 1).all())
    bad = {}
    for i, (x, y, z) in enumerate(zip(got, again, ref)):
        if z is None:
            assert x is None and y is None and not impute
            continue
        assert torch.equal(x, y), i
        ok, err, top = _scaled_ok(x, z)
        if not ok:
            bad[i] = (err, top)
    assert not bad, bad


# (relu, impute blend, select) of the bi layer tests
_BI_MODES = [(False, False, False), (True, False, False),
             (False, True, False), (True, True, True)]


def _bi_mode_args(bg, w, relu, impute, dev, seed=6):
    """A layer-2 call of the bi layer with the ReLU and the impute blend on
    or off, from a random input: (positional arguments, keywords)."""
    B, N, d = w["hists"][0].shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    h_in = torch.randn(B, N, d, generator=gen, device=dev) * 0.5
    h1f, h2f, hlf, h1b, h2b, hlb = w["hists"]
    args = (h_in, h2f, h2b, bg, bg.gr.m2, w["wrel"], d, w["loop2"],
            w["grus"]["2f"], w["grus"]["2b"])
    kw = dict(relu=relu, hl=(hlf, hlb) if impute else None,
              imp=w["imp"] if impute else None)
    return args, kw


@pytest.mark.parametrize("mode", range(len(_BI_MODES)))
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_fwd_repeats_and_matches_plain(cuda, mode, N, d, B, R, per,
                                                pad):
    """K6+K7 on the tensor cores, with the ReLU, the impute blend and the
    select on and off, at the main shape, at d = 32 and at a ragged N (not
    a multiple of the 32-row tile) with d = 16 (one warp): two runs equal
    bit for bit, one launch each, and within 1e-5 of the largest entry of
    the plain version's output."""
    relu, impute, select = _BI_MODES[mode]
    bg, w = _bi_case(N, d, cuda, B=B, noact=select, num_rels=R,
                     edges_per_time=per, pad=pad)
    args, kw = _bi_mode_args(bg, w, relu, impute, cuda)
    sel = w["h0"] if select else None
    before = fb.bi_layer_fwd.launches
    got = fb.bi_layer_fwd(*args, **kw, sel=sel)
    again = fb.bi_layer_fwd(*args, **kw, sel=sel)
    torch.cuda.synchronize()
    assert fb.bi_layer_fwd.launches == before + 2
    assert torch.equal(got, again)
    ok, err, top = _scaled_ok(got, fb.bi_layer_fwd_plain(*args, **kw,
                                                         sel=sel))
    assert ok, (err, top)


@pytest.mark.parametrize("mode", range(len(_BI_MODES)))
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_gru_input_equals_the_backward_recompute(cuda, mode, N, d,
                                                          B, R, per, pad):
    """K6+K7 and K9+K10's GRU launch form the layer's GRU input (the conv
    output after the ReLU and the blend) with the same routines: the one
    the forward writes equals bit for bit the one the backward recomputes
    into its weight launch's operands (gin_s), and lies within 1e-5 of the
    largest entry of the plain version's."""
    relu, impute, _ = _BI_MODES[mode]
    bg, w = _bi_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                     pad=pad)
    args, kw = _bi_mode_args(bg, w, relu, impute, cuda)
    d_out = torch.randn(args[1].shape, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    gin = fb.bi_gru_input(*args, **kw)
    st, gru = fb._bi_bwd_prepare(*args, d_out, relu, kw["hl"], kw["imp"],
                                 None)
    gru()
    torch.cuda.synchronize()
    assert torch.equal(gin.reshape(-1), st["scr"]["gin"])
    ref = fb._rows_plain(*args[:8], relu, kw["hl"], kw["imp"])[1]
    ok, err, top = _scaled_ok(gin, ref)
    assert ok, (err, top)


@pytest.mark.parametrize("B,L1,A,E,d,act2,n_buf",
                         [(8, 14, 640, 256, 128, False, 2),
                          (3, 4, 37, 20, 16, True, 3),
                          (8, 14, 640, 256, 128, False, 3),
                          (8, 7, 640, 256, 128, True, 2),
                          (3, 4, 37, 20, 16, False, 3),
                          (3, 4, 37, 20, 16, True, 2)])
def test_window_bwd_is_deterministic(cuda, B, L1, A, E, d, act2, n_buf):
    """K2b's tensor-core products sum in a fixed order and use no atomics:
    two runs on the same inputs agree bit for bit, at the main path's shape
    and at a ragged one (A not a multiple of the 32-row tile, d = 16), in
    GRRGCN's mode, the flagship's (the ReLU and the third buffer), and the
    TeMP variants' (a) (the third buffer without the ReLU) and (b) (the
    ReLU without it)."""
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    a = window_args(enc, cfg, masks=masks,
                    activation2="relu" if act2 else None, **kw)
    bufs = fused_window_fwd(**a, conv1_in=False, n_buf=n_buf)
    gen = torch.Generator(device=cuda).manual_seed(2)
    gbs = [torch.randn(B, L1, A, d, generator=gen, device=cuda)
           for _ in range(n_buf)]
    args = dict(a, buf1=bufs[0], buf2=bufs[1], gb1=gbs[0], gb2=gbs[1],
                gb3=gbs[2] if n_buf == 3 else None)
    x = fused_window_bwd(**args)
    y = fused_window_bwd(**args)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_bwd_layer_is_deterministic(cuda, N, d, B, R, per, pad):
    """K5's tensor-core products sum in a fixed order and use no atomics:
    two runs of both layers agree bit for bit, at the main path's shape and
    at ragged ones (N not a multiple of the 32-row tile, d = 32 and 16)."""
    gr, w = _final_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                        pad=pad)
    gen = torch.Generator(device=cuda).manual_seed(6)
    d_out = torch.randn(B, N, d, generator=gen, device=cuda)
    h_in = torch.randn(B, N, d, generator=gen, device=cuda) * 0.5
    for args in ((w["h0"], w["hist1"], gr, gr.m1, w["wrel"], 0, w["loop1"],
                  w["g1"], d_out),
                 (h_in, w["hist2"], gr, gr.m2, w["wrel"], d, w["loop2"],
                  w["g2"], d_out)):
        x = fused_final_bwd_layer(*args)
        y = fused_final_bwd_layer(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_fwd_and_bwd_loss_are_deterministic(cuda, noact, N, d, B, R,
                                                  per, pad):
    """K3's and K4's tensor-core products sum in a fixed order and use no
    atomics: two runs agree bit for bit (the loss, the rows, the queries
    and log-sum-exps K4 reads, both cotangents), at the main path's shape
    and at ragged ones."""
    gr, w = _final_case(N, d, cuda, B=B, noact=noact, num_rels=R,
                        edges_per_time=per, pad=pad)
    args = (*_fwd_args(w), gr, w["wrel"], w["loop1"], w["loop2"], w["g1"],
            w["g2"], w["rtab"])
    (la, sa), (lb, sb) = fused_final_fwd(*args), fused_final_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for k in ("table", "out1", "qhat", "scpos", "lse", "cnt"):
        assert torch.equal(sa[k], sb[k]), k
    g = torch.rand(B, device=cuda) + 0.5
    x = fused_final_bwd_loss(sa, w["rtab"], gr, g)
    y = fused_final_bwd_loss(sa, w["rtab"], gr, g)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_lse_matches_plain(cuda, N, d, B, R, per, pad):
    """K3's log-sum-exp of each positive query (its scores on the tensor
    cores, summed per thread, then across threads and warps) within 1e-6
    relative of the plain version's on the same table."""
    gr, w = _final_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                        pad=pad)
    _, saved = fused_final_fwd(*_fwd_args(w), gr, w["wrel"], w["loop1"],
                               w["loop2"], w["g1"], w["g2"], w["rtab"])
    dirs, _ = _loss_side(saved["table"], w["rtab"], gr)
    on = gr.posm > 0
    assert bool(on.any())
    for k, (_, _, _, _, lse) in enumerate(dirs):
        got = saved["lse"][:, k][on]
        ref = lse[on]
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-6


@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_layer_shares_k2f_and_k5_products(cuda, N, d, B, R, per, pad):
    """K3's layer launches form the conv output and the gates with the
    routines of K2f and of K5's recompute (fwd_layer_tile: conv_rows_tc,
    gate_products), in whole-width tiles where K2f cuts column slabs: K3's
    layer 2 equals bit for bit K2f's layer on the same rows (one window step
    whose previous states are the dense history), and K2f's conv output
    there equals bit for bit the one K5's GRU launch recomputes (its step
    scratch)."""
    from temp_tpu_torch import _build
    from temp_tpu_torch.ops.fused_final import final_csr

    gr, w = _final_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                        pad=pad)
    _, saved = fused_final_fwd(*_fwd_args(w), gr, w["wrel"], w["loop1"],
                               w["loop2"], w["g1"], w["g2"], w["rtab"])
    out1, table = saved["out1"], saved["table"]
    assert gr.active is None  # no select: the table is layer 2's output
    lib = _build.lib()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    f32 = dict(device=cuda, dtype=torch.float32)
    g2 = w["g2"]
    rowptr, s_src, s_rel, s_em = final_csr(gr, N, R * 2)[0]
    # K2f, step k = 1 of a two-step window: its rows are layer 2's input,
    # its previous states step 0's rows, which hold the history
    counts = (rowptr[1:] - rowptr[:-1]).reshape(B, 1, N)
    counts = torch.cat([torch.zeros_like(counts), counts], 1).reshape(-1)
    ptr2 = torch.zeros(B * 2 * N + 1, device=cuda, dtype=torch.int32)
    ptr2[1:] = torch.cumsum(counts, 0).to(torch.int32)
    x = torch.zeros(B, 2, N, d, **f32)
    x[:, 1] = out1
    buf = torch.zeros(B, 2, N, d, **f32)
    buf[:, 0] = w["hist2"]
    loc = torch.zeros(B, 2, N, d, **f32)
    mask = torch.ones(B, 2, N, d, **f32)
    mask[:, 1] = gr.m2
    gidx = torch.arange(N, device=cuda, dtype=torch.int32).expand(
        B, 2, N).contiguous()
    live = torch.ones(B, 2, N, **f32)
    dt = torch.stack([gr.dt, gr.dt], 1).contiguous()
    _build.check(lib.window_layer_launch(
        p(x), 0, p(ptr2), p(s_src), p(s_rel), p(s_em), p(w["wrel"]), 2 * d,
        d, p(w["loop2"]), p(mask), 0, p(g2["wih_t"]), p(g2["whh_t"]),
        p(g2["bih"]), p(g2["bhh"]), p(gidx), p(live), p(dt), float(gr.lam),
        p(buf), p(loc), B, 2, N, d, 0, 1, stream), "window_layer")
    # K5's GRU launch on layer 2, its conv output in the step scratch
    rows = B * N
    wih, whh = (g2[k].t().contiguous() for k in ("wih_t", "whh_t"))
    d_out, d_prev = torch.ones(B, N, d, **f32), torch.empty(B, N, d, **f32)
    n2 = torch.empty(rows, **f32)
    scr = [torch.empty(rows * n * d, **f32) for n in (1, 1, 3, 3, 1, 1)]
    _build.check(lib.final_bwd_gru_launch(
        p(out1), p(rowptr), p(s_src), p(s_rel), p(s_em), p(w["wrel"]),
        2 * d, d, p(w["loop2"]), p(gr.m2), p(g2["wih_t"]), p(g2["whh_t"]),
        p(g2["bih"]), p(g2["bhh"]), p(wih), p(whh), p(gr.dt), float(gr.lam),
        p(w["hist2"]), p(d_out), p(d_prev), p(n2), *(p(t) for t in scr), B,
        N, d, stream), "final_bwd_gru")
    torch.cuda.synchronize()
    assert torch.equal(buf[:, 1], table)
    assert torch.equal(loc[:, 1], scr[0].view(B, N, d))


@pytest.mark.parametrize("B,N,d,n_split", [(3, 37, 16, 4), (2, 1000, 64, 16),
                                           (8, 7128, 128, 16)])
def test_weight_product_matches_plain(cuda, B, N, d, n_split):
    """The weight launch alone (wgrad_tile: the rows as the product's depth,
    3xTF32 on the tensor cores, the bias as the column sums of G), at a
    ragged row count with d = 16 (most of each 64 x 64 tile masked), a
    ragged one at d = 64 and K5's shape: each cotangent within 1e-5 of the
    largest entry of the plain x.T @ g (in float64), the bias of g.sum(0)."""
    from temp_tpu_torch import _build

    gen = torch.Generator(device=cuda).manual_seed(11)
    rows = B * N

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    conv, h0g, x, dlp = (rand(rows, d) for _ in range(4))
    dgi, dgh = rand(rows, 3 * d), rand(rows, 3 * d)
    sizes = [3 * d * d, 3 * d, 3 * d * d, 3 * d, d * d]
    part = torch.zeros(n_split, sum(sizes), device=cuda)
    out = torch.empty(sum(sizes), device=cuda)
    lib = _build.lib()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    p = [t.data_ptr() for t in (conv, dgi, h0g, dgh, x, dlp, part)]
    _build.check(lib.final_wgrad_launch(*p, n_split, B, N, d, stream),
                 "final_wgrad")
    _build.check(lib.final_wgrad_reduce_launch(part.data_ptr(), n_split,
                                               out.numel(), out.data_ptr(),
                                               stream), "final_wgrad_reduce")
    torch.cuda.synchronize()
    got = torch.split(out, sizes)
    want = [conv.double().t() @ dgi.double(), dgi.double().sum(0),
            h0g.double().t() @ dgh.double(), dgh.double().sum(0),
            x.double().t() @ dlp.double()]
    for g, r in zip(got, want):
        err = float((g.double() - r.reshape(-1)).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), (err, float(r.abs().max()))


def _bi_params(w):
    """The flagship's parameter tree over w's tensors (cloned, requiring
    grad), and the flat leaves."""
    d = w["h0"].shape[1]
    leaf = lambda t: t.clone().requires_grad_()  # noqa: E731
    enc = {}
    for i in (1, 2):
        enc[f"layer{i}"] = {
            "weight": leaf(w["wrel"][:, (i - 1) * d:i * d]),
            "loop_weight": leaf(w[f"loop{i}"])}
        for tag, key in (("f", "gru_fwd"), ("b", "gru_bwd")):
            g = w["grus"][f"{i}{tag}"]
            enc[f"layer{i}"][key] = [{"w_ih": leaf(g["wih_t"].t()),
                                      "w_hh": leaf(g["whh_t"].t()),
                                      "b_ih": leaf(g["bih"]),
                                      "b_hh": leaf(g["bhh"])}]
    for k, v in zip(("impute_w_fwd", "impute_b_fwd", "impute_w_bwd",
                     "impute_b_bwd"), w["imp"]):
        enc[k] = leaf(v)
    params = {"ent_embeds": leaf(w["h0"]), "rel_embeds": leaf(w["rtab"]),
              "encoder": enc}
    return params, param_leaves(params)


@pytest.mark.parametrize("noact", [False, True])
def test_fused_final_bi_autograd_matches_plain_autograd(cuda, noact):
    bg, w = _bi_case(300, 32, cuda, B=4, noact=noact)
    tv = torch.tensor([1.0, 1.0, 0.0, 1.0], device=cuda)
    grads = []
    for kernels in (True, False):
        params, leaves = _bi_params(w)
        hists = [h.clone().requires_grad_() for h in w["hists"]]
        loss = fb.fused_final_bi_loss(params, bg, hists, kernels=kernels)
        (loss * tv).sum().backward()
        grads.append([t.grad for t in leaves + hists])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if b is not None:
            assert _close(a, b)


def test_bi_kernels_refuse_what_they_do_not_take(cuda):
    bg, w = _bi_case(77, 16, cuda, B=3)
    args, kw = _bi_layer_args(bg, w, 2, w["hists"][0])
    with pytest.raises(TypeError):
        fb.bi_layer_fwd(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):  # the blend without its scalars
        fb.bi_layer_fwd(*args, relu=True, hl=kw["hl"], imp=None)
    with pytest.raises(ValueError):  # a history of another batch size
        fb.bi_layer_fwd(args[0], args[1][:2], *args[2:], **kw)
    with pytest.raises(ValueError):
        fb.bi_layer_bwd(*args[:6], 5, *args[7:], w["hists"][0], **kw)
    bg2, w2 = _bi_case(40, 256, cuda, B=2, num_rels=3, edges_per_time=10)
    args2, kw2 = _bi_layer_args(bg2, w2, 1)
    with pytest.raises(ValueError):  # d = 256: the kernels take d <= 128
        fb.bi_layer_fwd(*args2, **kw2)


def test_flagship_training_steps_match_plain_and_unfused(cuda):
    """Training steps of the flagship on the fused path (K2 in its new
    modes, K6-K10, K4) against the plain path and the unfused path (K1,
    fused_final off), from the same weights and draws."""
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    losses, finals = {}, {}
    counters = (fb.bi_layer_fwd, fb.bi_loss_fwd, fused_final_bwd_loss,
                fb.bi_layer_bwd, fused_window_fwd, fused_window_bwd,
                spmm_fwd, spmm_bwd)
    for name, kw in (("fused", {}), ("plain", {"kernels": False}),
                     ("unfused", {"fused_final": False})):
        cfg = TKGConfig(module="BiGRRGCN", impute=True, embed_size=32,
                        hidden_size=32, n_bases=32, train_seq_len=6,
                        batch_size=4, num_pos_facts=40, **kw)
        model = get_model(cfg, data, device=cuda)
        assert model.fused_final_on() == (name != "unfused")
        tr = Trainer(cfg, model, data)
        params, opt = tr.init_state(0)
        for fn in counters:
            fn.launches = 0
        losses[name] = [float(tr.train_step(params, opt, t_pos, t_valid,
                                            gen=tr.step_generator(0, step)))
                        for step, (t_pos, t_valid)
                        in enumerate(tr.epoch_batches(0)[:3])]
        n = {fn.__name__: fn.launches for fn in counters}
        if name == "fused":
            assert n["bi_layer_fwd"] == 6 and n["bi_loss_fwd"] == 6
            assert n["fused_final_bwd_loss"] == 12
            assert n["bi_layer_bwd"] == 30 and n["spmm_fwd"] == 0
            # two windows of L1 = 5 steps: 2 launches a step forward, 5 a
            # step and 2 more backward
            assert n["fused_window_fwd"] == 3 * 2 * 2 * 5
            assert n["fused_window_bwd"] == 3 * 2 * (5 * 5 + 2)
        elif name == "plain":
            assert not any(n.values())
        else:
            assert n["spmm_bwd"] > 0 and n["bi_layer_fwd"] == 0
        finals[name] = [p.detach() for p in param_leaves(params)]
    for other in ("plain", "unfused"):
        for a, b in zip(losses["fused"], losses[other]):
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
        for a, b in zip(finals["fused"], finals[other]):
            assert _close(a, b)


# -- K11: the fused eval; K12: the batched window ----------------------------

def _smoke():
    """chip_smoke.py at the root of the checkout, for its K11 helpers."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _eval_case(N, d, dev, B=4, seed=0, noact=False, num_rels=12,
               edges_per_time=60, pad=16, L=6):
    """K11's arguments for B eval targets of the valid split on synthetic
    data, with _final_case's random history and weights."""
    _, w = _final_case(N, d, dev, B=B, seed=seed, rate=0.0,
                       num_rels=num_rels, edges_per_time=edges_per_time,
                       pad=pad, L=L)
    host = make_synthetic(
        num_ents=N, num_rels=num_rels, num_times=B + 4,
        edges_per_time=edges_per_time, seed=seed, edge_pad_multiple=pad)
    data = to_device(host, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    last_pos = torch.randint(0, L - 1, (B, N), generator=gen,
                             device=dev).float()
    gr, q = final_graph_eval(
        data, to_device(build_answer_lists(host, "valid"), dev),
        torch.arange(B, device=dev) + 2, last_pos, 0.1, L, noact, "valid")
    return (w["h0"], w["hist1"], w["hist2"], gr, q, w["wrel"], w["loop1"],
            w["loop2"], w["g1"], w["g2"], w["rtab"])


def _ranks_agree(got, ref, args):
    """K11's result against the plain version's: masks equal, ranks equal
    on every real query but the plain scores' near-ties, BCE to 1e-5."""
    (ranks, mask, bce), (r_p, m_p, bce_p) = got, ref
    h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab = args
    table, _ = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2, g1,
                              g2)
    near = _smoke().near_ties(table, rtab, q)
    assert torch.equal(mask, m_p) and ranks.dtype == torch.int32
    assert not bool(((ranks != r_p) & mask & ~near).any())
    assert bool(((bce - bce_p).abs() <= 1e-5 * bce_p.abs()).all())


_EVAL_SHAPES = [(7128, 128, 8, 230, 200, 128), (300, 32, 4, 12, 60, 16),
                (77, 16, 3, 5, 20, 16)]


@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("N,d,B,R,per,pad", _EVAL_SHAPES)
def test_fused_eval_kernel_matches_plain(cuda, noact, N, d, B, R, per, pad):
    args = _eval_case(N, d, cuda, B=B, noact=noact, num_rels=R,
                      edges_per_time=per, pad=pad)
    before = fused_eval_ranks.launches
    got = fused_eval_ranks(*args)
    torch.cuda.synchronize()
    assert fused_eval_ranks.launches == before + 4
    _ranks_agree(got, fused_eval_ranks_plain(*args), args)
    if N == 77:
        assert args[4].src.shape[1] % 64  # Q not a multiple of 64


def test_fused_eval_element_without_queries(cuda):
    """An element with no real query (a snapshot without facts of the
    split): BCE 0 and every rank masked, on the kernels as on the plain
    versions; the other elements unchanged."""
    args = list(_eval_case(300, 32, cuda, B=3))
    q = args[4]
    qmask = q.mask.clone()
    qmask[1] = 0.0
    args[4] = q._replace(mask=qmask)
    ranks, mask, bce = fused_eval_ranks(*args)
    ref = fused_eval_ranks_plain(*args)
    assert float(bce[1]) == 0.0 and not bool(mask[1].any())
    _ranks_agree((ranks, mask, bce), ref, args)


def test_fused_eval_planted_copies_do_not_count(cuda):
    """K11's ranking half on a table with a target's row copied into the
    32 columns that scored lowest for its query: the copies tie with the
    target exactly and do not count, so the rank stays as it was."""
    args = _eval_case(7128, 128, cuda, B=4, num_rels=230,
                      edges_per_time=200, pad=128)
    h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab = args
    table, _ = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2, g1,
                              g2)
    planted, picks = _smoke().plant_copies(table, rtab, q)
    before, _, _ = table_ranks(table, rtab, q)
    after, _, _ = table_ranks(planted, rtab, q)
    assert len(picks) == 4
    for b, c in picks:
        assert int(after[b, c]) == int(before[b, c])


def test_fused_eval_is_deterministic(cuda):
    args = _eval_case(7128, 128, cuda, B=8, num_rels=230,
                      edges_per_time=200, pad=128)
    a = fused_eval_ranks(*args)
    b = fused_eval_ranks(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("N,d,B,R,per,pad", _EVAL_SHAPES)
def test_fused_eval_repeats_at_every_shape(cuda, N, d, B, R, per, pad):
    """K11 (its rank launch on the tensor cores, the targets scored by the
    same routine) twice on the same inputs: ranks, masks and BCE equal bit
    for bit, at the main shape, at d = 32 and at a Q and an N that are not
    multiples of 64; and its ranking half alone on the plain table."""
    args = _eval_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                      pad=pad)
    a = fused_eval_ranks(*args)
    b = fused_eval_ranks(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab = args
    table, _ = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2, g1,
                              g2)
    x, y = table_ranks(table, rtab, q), table_ranks(table, rtab, q)
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_fused_eval_refuses_what_it_does_not_take(cuda):
    args = list(_eval_case(77, 16, cuda, B=3))
    q = args[4]
    with pytest.raises(TypeError):
        fused_eval_ranks(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):  # a history of another batch size
        fused_eval_ranks(args[0], args[1], args[2][:2], *args[3:])
    with pytest.raises(ValueError):  # queries of another batch size
        fused_eval_ranks(*args[:4], q._replace(mask=q.mask[:2]), *args[5:])
    with pytest.raises(ValueError):  # eval has no dropout masks
        gr = args[3]
        fused_eval_ranks(*args[:3], gr._replace(m1=torch.ones_like(
            args[1])), *args[4:])
    big = _eval_case(40, 256, cuda, B=2, num_rels=3, edges_per_time=10)
    with pytest.raises(ValueError):  # d = 256: K3's layer takes d <= 128
        fused_eval_ranks(*big)


@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 40, 30, 32)])
def test_batched_window_kernel_matches_plain(cuda, B, L1, A, E, d):
    """K12's forward makes K2f's launches (bit for bit K2f's output) and
    agrees with its per-element plain version."""
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    a = dict(window_args(enc, cfg, masks=masks, **kw), conv1_in=False)
    before = (fused_window_mb_fwd.launches, fused_window_fwd.launches)
    got = fused_window_mb_fwd(**a)
    torch.cuda.synchronize()
    assert (fused_window_mb_fwd.launches, fused_window_fwd.launches) == (
        before[0] + 2 * L1, before[1])
    ref = fused_window_mb_fwd_plain(**a)
    k2f = fused_window_fwd(**a)
    for x, y, z in zip(got, ref, k2f):
        assert float((x - y).abs().max()) <= TOL and torch.equal(x, z)


def test_batched_window_paths_match_the_default(cuda):
    """fused_window_mb on: training steps of GRRGCN and of the flagship on
    the fused path, and a GRRGCN valid sweep with fused_eval on, equal to
    the runs without the switch (the same launches and draws), with K12's
    launches in place of K2f's."""
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    for extra in ({}, {"module": "BiGRRGCN", "impute": True}):
        runs = {}
        for mb in (False, True):
            cfg = TKGConfig(embed_size=32, hidden_size=32, n_bases=32,
                            train_seq_len=6, batch_size=4, num_pos_facts=40,
                            fused_window_mb=mb, fused_eval=True, **extra)
            model = get_model(cfg, data, device=cuda)
            assert model.fused_window_mb_on(6, train=True) == mb
            tr = Trainer(cfg, model, data)
            params, opt = tr.init_state(0)
            fused_window_mb_fwd.launches = fused_window_fwd.launches = 0
            fused_eval_ranks.launches = 0
            losses = [float(tr.train_step(params, opt, t_pos, t_valid,
                                          gen=tr.step_generator(0, step)))
                      for step, (t_pos, t_valid)
                      in enumerate(tr.epoch_batches(0)[:3])]
            ranks, mask, _ = tr.eval_sweep(params, "valid")
            runs[mb] = (losses, [p.detach() for p in param_leaves(params)],
                        ranks[mask])
            # training through K12 with the switch; GRRGCN's eval too (the
            # flagship's eval windows stay on K2f, as in the JAX package)
            assert (fused_window_mb_fwd.launches > 0) == mb
            assert (fused_window_fwd.launches == 0) == (mb and not extra)
            # K11 is GRRGCN's only: the flagship evaluates as before
            assert (fused_eval_ranks.launches > 0) == (not extra)
        (la, pa, ra), (lb, pb, rb) = runs[False], runs[True]
        assert la == lb and torch.equal(ra, rb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


# -- K13: the ring SpMM ------------------------------------------------------

def _ring_case(dev, s=1, n=7128, m=4, e=256, r=460, d=128, seed=0):
    """h padded to m row shards [1, m * rows, d], edges grouped by dst
    owner [1, E] (group_edges_by_dst_owner), weights [r, d * s]."""
    g = torch.Generator().manual_seed(seed)
    rows = ring_geometry(n, m)
    src = torch.randint(0, n, (e,), generator=g).numpy()
    dst = torch.randint(0, n // 2, (e,), generator=g).numpy()  # half isolated
    rel = torch.randint(0, r, (e,), generator=g).numpy()
    em = (torch.rand(e, generator=g) < 0.8).numpy()
    edges = [torch.from_numpy(x)[None].to(dev) for x in
             group_edges_by_dst_owner(src, dst, rel, em, m * rows, m)]
    h = torch.zeros(1, m * rows, d)
    h[0, :n] = torch.randn(n, d, generator=g)
    w = torch.randn(r, d * s, generator=g) / s
    return h.to(dev), w.to(dev), edges, rows


@pytest.mark.parametrize("s", [1, 4])
def test_ring_spmm_kernel_matches_plain(cuda, s):
    """K13 with 4 ranks on the card: forward, norm^2 and rows without
    in-edges (exactly 0) against the plain version; RingSpMM's backward
    against autograd through the plain forward; m launches a call."""
    h, w, edges, rows = _ring_case(cuda, s=s)
    devs = (cuda,) * 4
    before = ring_spmm_fwd.launches
    out, n2 = ring_spmm_fwd(h, w, *edges, 4, rows, devs)
    torch.cuda.synchronize()
    assert ring_spmm_fwd.launches == before + 4  # one a ring step
    ref, n2p = ring_spmm_fwd_plain(h, w, *edges, 4, rows, devs)
    assert _scaled_ok(out, ref)[0] and _scaled_ok(n2, n2p)[0]
    assert bool((out[0][n2[0] == 0] == 0).all())
    g = torch.randn_like(h)
    grads = []
    for kernels in (True, False):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        if kernels:
            o = ring_spmm(hh, ww, *edges, 4, rows, devs)
        else:
            o, _ = ring_spmm_fwd_plain(hh, ww, *edges, 4, rows, devs)
        (o * g).sum().backward()
        grads.append((hh.grad, ww.grad))
    (kh, kw), (ph, pw) = grads
    assert _scaled_ok(kh, ph)[0] and _scaled_ok(kw, pw)[0]


def _ring_tables_cases(dev, s):
    """K13 at the final-snapshot shape (one snapshot's edges in global ids,
    7128 rows in 4 shards) and at the window-step shape (8 snapshots in
    compact slots) of a dataset in the ring layout with its static tables:
    (tag, h, w, edges, rows, tables) each, the mask a 50% subsample of the
    static one."""
    cfg = TKGConfig(edge_partition="ring_pallas", mp_size=4)
    data = to_device(ring_layout(cfg, make_synthetic(
        num_ents=7128, num_rels=230, num_times=12, edges_per_time=200,
        seed=2, edge_pad_multiple=128)), dev)
    g = torch.Generator(device=dev).manual_seed(s)
    tr, d = data.train, 128
    w = torch.randn(2 * data.num_rels, d * s, generator=g, device=dev) / s
    out = []
    for tag, tab, t_pos, src, dst in (
            ("final", data.ring.glob, torch.tensor([5], device=dev),
             tr.src, tr.dst),
            ("window", data.ring.comp, torch.arange(2, 10, device=dev),
             data.train_src_loc, data.train_dst_loc)):
        rows = tab.rows
        em = tr.emask[t_pos] & (torch.rand(tr.emask[t_pos].shape,
                                           generator=g, device=dev) < 0.5)
        h = torch.randn(len(t_pos), 4 * rows, d, generator=g, device=dev)
        edges = (src[t_pos], dst[t_pos], tr.rel[t_pos], em)
        out.append((tag, h, w, edges, rows, (tab, t_pos)))
    return out


@pytest.mark.parametrize("s", [1, 4])
def test_ring_spmm_tables_match_in_call_route(cuda, s):
    """K13 walking the data's static tables (the path's route) against K13
    sorting the call's edges (the in-call route) at the final-snapshot and
    window-step shapes: equal bit for bit, both within 1e-5 of the
    largest entry of the plain version; 4 launches a call on one card and
    no sort with tables; a row whose every edge the call's mask drops
    comes out exactly 0."""
    devs = (cuda,) * 4
    for tag, h, w, edges, rows, tables in _ring_tables_cases(cuda, s):
        src, dst, rel, em = edges
        # drop every edge into one fed row of graph 0 from the mask
        row = int(dst[0][em[0]][0])
        em = em.clone()
        em[0][dst[0] == row] = False
        edges = (src, dst, rel, em)
        builds, before = ring_spmm_fwd.csr_builds, ring_spmm_fwd.launches
        out, n2 = ring_spmm_fwd(h, w, *edges, 4, rows, devs, tables=tables)
        torch.cuda.synchronize()
        assert ring_spmm_fwd.launches == before + 4
        assert ring_spmm_fwd.csr_builds == builds
        own, n2o = ring_spmm_fwd(h, w, *edges, 4, rows, devs)
        assert ring_spmm_fwd.csr_builds == builds + 1
        assert torch.equal(out, own) and torch.equal(n2, n2o), tag
        ref, n2p = ring_spmm_fwd_plain(h, w, *edges, 4, rows, devs)
        assert _scaled_ok(out, ref)[0] and _scaled_ok(n2, n2p)[0], tag
        assert bool((out[0, row] == 0).all()) and float(n2[0, row]) == 0.0
        assert bool((out[n2 == 0] == 0).all())


@pytest.mark.parametrize("s", [1, 4])
def test_ring_spmm_bwd_kernel_matches_plain_autograd(cuda, s):
    """K13's backward kernels over the data's tables against autograd
    through the plain forward (dh, dw within 1e-5 of the largest entry)
    and against ring_spmm_bwd_plain, at both shapes; the same call twice
    gives the same bits; m + 2 launches a call on one card (m ring steps,
    the dw partials, their sum)."""
    devs = (cuda,) * 4
    for tag, h, w, edges, rows, tables in _ring_tables_cases(cuda, s):
        gk = torch.Generator(device=cuda).manual_seed(7)
        g = torch.randn(h.shape, generator=gk, device=cuda)
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        o, n2 = ring_spmm_fwd_plain(hh, ww, *edges, 4, rows, devs)
        (o * g).sum().backward()
        before = ring_spmm_bwd.launches
        dh, dw = ring_spmm_bwd(g, n2, h, w, *edges, 4, rows, devs,
                               tables=tables)
        torch.cuda.synchronize()
        assert ring_spmm_bwd.launches == before + 6
        assert _scaled_ok(dh, hh.grad)[0] and _scaled_ok(dw, ww.grad)[0], tag
        ph, pw = ring_spmm_bwd_plain(g, n2, h, w, *edges, 4, rows, devs)
        assert _scaled_ok(dh, ph)[0] and _scaled_ok(dw, pw)[0], tag
        dh2, dw2 = ring_spmm_bwd(g, n2, h, w, *edges, 4, rows, devs,
                                 tables=tables)
        assert torch.equal(dh, dh2) and torch.equal(dw, dw2), tag
        ah, aw = h.clone().requires_grad_(), w.clone().requires_grad_()
        (ring_spmm(ah, aw, *edges, 4, rows, devs, tables=tables)
         * g).sum().backward()
        assert torch.equal(ah.grad, dh) and torch.equal(aw.grad, dw), tag


@pytest.mark.parametrize("s", [1, 4])
def test_ring_spmm_clips_a_destination_outside_its_slice(cuda, s):
    """The in-call route on edges where two kept edges have their
    destination outside their slice's shard (the plain ring clips it into
    the shard): the forward within 1e-5 of the largest entry of the plain
    version, and the backward kernels within 1e-5 of ring_spmm_bwd_plain
    and of autograd through the plain forward."""
    h, w, (src, dst, rel, em), rows = _ring_case(cuda, s=s, seed=5)
    cap = src.shape[1] // 4
    dst = dst.clone()
    assert bool(em[0, 0]) and bool(em[0, cap])
    dst[0, 0] = 3 * rows + 5    # slice 0, row 3 * rows + 5: clipped
    dst[0, cap] = 5             # slice 1, row 5: clipped
    edges = (src, dst, rel, em)
    devs = (cuda,) * 4
    out, n2 = ring_spmm_fwd(h, w, *edges, 4, rows, devs)
    ref, n2p = ring_spmm_fwd_plain(h, w, *edges, 4, rows, devs)
    assert _scaled_ok(out, ref)[0] and _scaled_ok(n2, n2p)[0]
    g = torch.randn(h.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(8))
    dh, dw = ring_spmm_bwd(g, n2, h, w, *edges, 4, rows, devs)
    ph, pw = ring_spmm_bwd_plain(g, n2p, h, w, *edges, 4, rows, devs)
    assert _scaled_ok(dh, ph)[0] and _scaled_ok(dw, pw)[0]
    ah, aw = h.clone().requires_grad_(), w.clone().requires_grad_()
    o, _ = ring_spmm_fwd_plain(ah, aw, *edges, 4, rows, devs)
    (o * g).sum().backward()
    assert _scaled_ok(dh, ah.grad)[0] and _scaled_ok(dw, aw.grad)[0]


_BAD_POSITION = """
import torch
from temp_tpu_torch.parallel.edge_partition import ring_tables
from temp_tpu_torch.parallel.ring_spmm import ring_spmm_fwd
dev, m, rows = torch.device("cuda"), 4, 128
g = torch.Generator(device=dev).manual_seed(0)
src, dst, rel = (torch.randint(0, n, (2, 64), device=dev, generator=g)
                 for n in (m * rows, m * rows, 3))
keep = torch.ones(2, 64, dtype=torch.bool, device=dev)
tab = ring_tables(src, dst, rel, keep, m, rows, 3)
h = torch.randn(1, m * rows, 32, device=dev, generator=g)
w = torch.randn(3, 32, device=dev, generator=g)
ring_spmm_fwd(h, w, src[:1], dst[:1], rel[:1], keep[:1], m, rows,
              (dev,) * m, tables=(tab, torch.tensor([2], device=dev)))
torch.cuda.synchronize()
print("no assert")
"""


def test_ring_spmm_time_position_outside_the_tables_asserts(cuda):
    """A call on the card that names a snapshot past its tables' T stops
    on the kernels' device assert instead of reading past the tables (in
    a process of its own: a device assert ends the process's CUDA
    context)."""
    proc = subprocess.run([sys.executable, "-c", _BAD_POSITION], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    said = proc.stdout + proc.stderr
    assert proc.returncode != 0 and "no assert" not in said, said[-2000:]
    assert "device-side assert" in said, said[-2000:]


def test_ring_spmm_on_distinct_cards(cuda):
    """The same ring with its ranks on distinct cards (peer copies between
    the slots), against the ranks all on one card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs 2 or more cards")
    h, w, edges, rows = _ring_case(cuda, seed=3)
    devs = tuple(torch.device("cuda", i % cards) for i in range(4))
    out, n2 = ring_spmm_fwd(h, w, *edges, 4, rows, devs)
    one, n2o = ring_spmm_fwd(h, w, *edges, 4, rows, (cuda,) * 4)
    assert out.device == h.device
    assert torch.equal(out, one) and torch.equal(n2, n2o)
    g = torch.randn_like(h)
    dh, dw = ring_spmm_bwd(g, n2, h, w, *edges, 4, rows, devs)
    dho, dwo = ring_spmm_bwd(g, n2, h, w, *edges, 4, rows, (cuda,) * 4)
    assert dh.device == h.device and dw.device == w.device
    assert torch.equal(dh, dho) and torch.equal(dw, dwo)


def _ring_near_ties(tr, params, tol=1e-5):
    """[T, 2Q] bool in eval_ranks' [head, tail] layout, one row a time of
    the valid split: the queries whose scores (from `tr`'s model, one
    element at a time under its partition) hold a column other than the
    target, not a true answer, within tol of the row's largest |score| of
    the target's score: there an f32 sum in another order may put the
    column on the other side."""
    model, data = tr.model, tr.data
    r2, q = 2 * data.num_rels, data.valid
    out = []
    with torch.no_grad():
        for t in range(data.num_times):
            with model._partition():
                table = model.inner.forward_element(params, data, t)
            src, rel, dst = (x[t].long() for x in (q.src, q.rel, q.dst))
            r_emb = params["rel_embeds"][rel]
            row = []
            for direction, ent, target, tab, key in (
                    ("head", dst, src, data.total_head, dst * r2 + rel),
                    ("tail", src, dst, data.total_tail, src * r2 + rel)):
                sc = model.score_all(table[ent], r_emb, table, direction)
                known = true_answer_mask(tab.grp[t], tab.val[t], key,
                                         sc.shape[-1])
                tgt = sc.gather(-1, target[:, None])
                cols = torch.arange(sc.shape[-1], device=sc.device)
                other = ~known & (cols != target[:, None])
                near = (sc - tgt).abs() <= tol * sc.abs().amax(-1,
                                                                keepdim=True)
                row.append((near & other).any(-1))
            out.append(torch.cat(row))
    return torch.stack(out)


def test_ring_path_launches_k13_and_no_k1(cuda):
    """A valid sweep and training steps of GRRGCN with edge_partition
    "ring_pallas" over 4 ranks: K13 and its backward launched over the
    data's tables (no sort in a call), none of K1, K2, K3-K5 or K11; the
    losses agree with the plain versions', and the ranks from the
    same weights are equal but for the counted near-ties of the plain
    scores."""
    data = ring_layout(TKGConfig(edge_partition="ring_pallas", mp_size=4),
                       make_synthetic(num_ents=300, num_rels=12,
                                      num_times=20, edges_per_time=60,
                                      seed=1, edge_pad_multiple=128))
    runs = {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=32, hidden_size=32, n_bases=32,
                        train_seq_len=4, batch_size=4, num_pos_facts=40,
                        edge_partition="ring_pallas", mp_size=4,
                        kernels=kernels, fused_eval=True)
        tr = Trainer(cfg, get_model(cfg, data, device=cuda), data)
        params, opt = tr.init_state(0)
        counters = (ring_spmm_fwd, spmm_fwd, spmm_bwd, fused_window_fwd,
                    fused_window_bwd, fused_final_fwd, fused_eval_ranks)
        for c in counters + (ring_spmm_bwd,):
            c.launches = 0
        ring_spmm_fwd.csr_builds = 0
        ranks, mask, _ = tr.eval_sweep(params, "valid")
        near = None if kernels else _ring_near_ties(tr, params)
        losses = [float(tr.train_step(params, opt, t_pos, t_valid,
                                      gen=tr.step_generator(0, step)))
                  for step, (t_pos, t_valid)
                  in enumerate(tr.epoch_batches(0)[:2])]
        assert (ring_spmm_fwd.launches > 0) == kernels
        assert (ring_spmm_bwd.launches > 0) == kernels
        assert ring_spmm_fwd.csr_builds == 0
        assert all(c.launches == 0 for c in counters[1:])
        runs[kernels] = (losses, ranks, mask, near)
    (lk, rk, mk, _), (lp, rp, mp, near) = runs[True], runs[False]
    assert np.allclose(lk, lp, rtol=TOL, atol=0)
    assert torch.equal(mk, mp) and bool(mk.any())
    T = data.num_times  # the sweep's batches hold t = 0..T-1 in order

    def per_time(x):
        return x.reshape(-1, x.shape[-1])[:T]

    off = per_time((rk != rp) & mk)
    assert not bool((off & ~near).any()), (
        f"{int((off & ~near).sum())} ranks differ away from a near-tie "
        f"({int((near & per_time(mk)).sum())} near-ties)")


# -- the negative samplers, TransE's table scores, TimeDynamicRGCN's window --

def _filter_on(dev, n_ents, n_groups, per, seed=0):
    """A sorted filter table (grp, val [F] on `dev`) of `per` true answers
    for each of n_groups groups, and its Python sets."""
    rs = np.random.RandomState(seed)
    pairs = sorted({(g, int(v)) for g in range(n_groups)
                    for v in rs.choice(n_ents, per, replace=False)})
    grp = torch.tensor([p[0] for p in pairs], device=dev)
    val = torch.tensor([p[1] for p in pairs], device=dev)
    sets = [set() for _ in range(n_groups)]
    for g, v in pairs:
        sets[g].add(v)
    return grp, val, sets


def test_negative_samplers_on_the_card(cuda):
    """The per_query and shared samplers on CUDA tensors from a CUDA
    generator: column 0 the positive; the draws replayed from the seed: a
    true answer only where its spare is one too; strict mode the first
    valid draws in draw order; the shared pool's mask the sets'
    membership; the same seed, the same draws."""
    N, G, K, os_, P = 300, 8, 40, 8, 128
    grp, val, sets = _filter_on(cuda, N, G, 60)
    g = torch.Generator().manual_seed(1)
    q = torch.randint(0, G, (P,), generator=g).to(cuda)
    pos = torch.randint(0, N, (P,), generator=g).to(cuda)

    def gen():
        return torch.Generator(device=cuda).manual_seed(3)

    cand = draw_negatives(gen(), grp, val, q, pos, N, K, os_)
    assert cand.device.type == "cuda" and cand.shape == (P, 1 + K)
    assert torch.equal(cand[:, 0], pos.long())
    assert torch.equal(cand, draw_negatives(gen(), grp, val, q, pos, N, K,
                                            os_))
    draws = torch.randint(0, N, (P, K + os_), generator=gen(),
                          device=cuda).cpu().numpy()
    cand, qh = cand.cpu().numpy(), q.cpu().numpy()
    for p in range(P):
        bad = sets[qh[p]]
        for k in range(K):
            main, spare = draws[p, k], draws[p, K + k % os_]
            want = spare if (main in bad and spare not in bad) else main
            assert cand[p, 1 + k] == want
    strict = draw_negatives(gen(), grp, val, q, pos, N, K, os_,
                            strict=True).cpu().numpy()
    for p in range(P):
        valid = [v for v in draws[p] if v not in sets[qh[p]]]
        assert list(strict[p, 1:]) == (valid + [0] * K)[:K]
    pool, bad = draw_shared_negatives(gen(), grp, val, q, N, K)
    assert pool.device.type == "cuda" and bad.shape == (P, K)
    want = [[int(v) in sets[qh[p]] for v in pool.tolist()] for p in range(P)]
    assert bad.cpu().tolist() == want and bad.any()


def test_transe_table_scores_match_the_chunked_broadcast(cuda):
    """TransE's L1 scores of 256 queries against a 7128-row table (cdist
    on the card) and their gradients, within 1e-5 of the largest entry of
    the JAX package's chunked [P, N, d] broadcast on the CPU."""
    from temp_tpu_torch.ops.scores import l1_scores, table_scores

    g = torch.Generator().manual_seed(0)
    q = torch.randn(256, 128, generator=g) * 0.1
    table = torch.randn(7128, 128, generator=g) * 0.1
    up = torch.randn(256, 7128, generator=g)
    qc, tc = (x.clone().requires_grad_(True) for x in (q, table))
    ref = torch.cat([-(qc[i:i + 64, None, :] - tc[None]).abs().sum(-1)
                     for i in range(0, 256, 64)])
    (ref * up).sum().backward()
    qg, tg = (x.to(cuda).requires_grad_(True) for x in (q, table))
    got = table_scores((qg, "l1"), tg)
    assert torch.equal(got, l1_scores(qg, tg))
    (got * up.to(cuda)).sum().backward()
    for a, b in ((got, ref), (qg.grad, qc.grad), (tg.grad, tc.grad)):
        a, b = a.detach().cpu(), b.detach()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_time_dynamic_window_kernel_matches_plain(cuda):
    """TimeDynamicRGCN's training windows at a small size, one of them
    running off t = 0: K2f and K2b with the kernels against their plain
    versions on the same draws, the histories and the gradients of the
    diachronic inputs (ent_embeds, w_temp, b_temp) within TOL."""
    data = make_synthetic(num_ents=300, num_rels=6, num_times=12,
                          edges_per_time=60, seed=0, edge_pad_multiple=16)
    tp = torch.tensor([1, 6, 9, 3], device=cuda)
    out = {}
    for kernels in (True, False):
        cfg = TKGConfig(module="TimeDynamicRGCN", embed_size=32,
                        hidden_size=32, n_bases=32, train_seq_len=5,
                        batch_size=4, dropout=0.1, kernels=kernels)
        d = ring_layout(cfg, data)
        model = get_model(cfg, d, device="cuda")
        assert model.fused_window_on(train=True)
        tr = Trainer(cfg, model, d)
        params = model.init_params(0)
        for p in param_leaves(params):
            p.requires_grad_(True)
        draws = model.draw_train(torch.Generator(device=cuda).manual_seed(0),
                                 tr.data, tp)
        before = (fused_window_fwd.launches, fused_window_bwd.launches)
        hists = model.batch_hists(params, tr.data, tp, model.train_len,
                                  draws)
        up = torch.Generator(device=cuda).manual_seed(1)
        sum((h * torch.randn(h.shape, generator=up, device=cuda)).sum()
            for h in hists[:2]).backward()
        torch.cuda.synchronize()
        out[kernels] = ([h.detach() for h in hists],
                        [params[k].grad for k in ("ent_embeds", "w_temp",
                                                  "b_temp")],
                        (fused_window_fwd.launches - before[0],
                         fused_window_bwd.launches - before[1]))
    (hk, gk, nk), (hp, gp, np_) = out[True], out[False]
    assert nk[0] > 0 and nk[1] > 0 and np_ == (0, 0)
    for a, b in zip(hk + gk, hp + gp):
        assert _close(a, b), float((a - b).abs().max())
    assert float(gk[1].abs().max()) > 0 and float(gk[2].abs().max()) > 0


# -- the predictions CLI ------------------------------------------------------

def test_predictions_cli_on_the_card_matches_the_cpu(cuda, tmp_path):
    """temp_tpu_torch.test on the card and with --device cpu on the same
    run directory (seeded GRRGCN weights, a small text dataset): the same
    records but the ranks, which are equal but for the CPU scores' counted
    near-ties; K1f and K2f launched on the card."""
    from temp_tpu_torch.data.snapshots import synthetic_quads, to_device
    from temp_tpu_torch.test import predict
    from temp_tpu_torch.train.checkpoint import save_checkpoint

    smoke = _smoke()
    root = smoke.write_dataset(str(tmp_path / "data"), "small",
                               synthetic_quads(300, 12, 20, 60, seed=3),
                               300, 12)
    cfg = TKGConfig(embed_size=32, hidden_size=32, n_bases=32,
                    train_seq_len=5, batch_size=4, data_root=root,
                    dataset="small", edge_pad_multiple=16)
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(cfg.to_json())
    data = make_synthetic(300, 12, 20, 60, seed=3, edge_pad_multiple=16)
    params = get_model(cfg, data, device="cpu").init_params(0)
    save_checkpoint(str(run / "checkpoints" / "best.pt"), params, None, 0,
                    {"mrr": 0.0})
    before = (spmm_fwd.launches, fused_window_fwd.launches)
    got = predict(str(run), "valid", device="cuda", log_fn=lambda *_: None)
    assert spmm_fwd.launches > before[0]
    assert fused_window_fwd.launches > before[1]
    ref = predict(str(run), "valid", device="cpu", log_fn=lambda *_: None)
    (m, rec, rk, mk), (m_p, rec_p, rp, mp) = got, ref
    assert len(rec) == len(rec_p) == m["n"] == m_p["n"] > 0
    assert [r[:5] for r in rec] == [r[:5] for r in rec_p]
    assert np.array_equal(mk, mp)
    diff = mk & (rk != rp)
    model = get_model(cfg, data, device="cpu")
    host = to_device(ring_layout(cfg, data), "cpu")
    B = rk.shape[1]
    near = 0
    for bi, b in {(int(i), int(j)) for i, j, _ in np.argwhere(diff)}:
        tied = smoke._element_near_ties(model, params, host, bi * B + b,
                                        "valid").numpy()
        assert not (diff[bi, b] & ~tied).any()
        near += int((diff[bi, b] & tied).sum())
    assert int(diff.sum()) == near


# -- the final step's bfloat16 forward layers (K3's layer launch, K6+K7) -----

BF16_RULE = 0.1


def _bf16_ok(got, plain_bf, plain_f32):
    """The bfloat16 rule: RMS(kernel - plain bfloat16) at most BF16_RULE of
    RMS(plain float32 - plain bfloat16) on the same inputs, the distance
    between the two precisions being the yardstick (the kernel and the
    plain version round at the same points and differ by float32 sums in
    another order); (ok, gap, yardstick)."""
    def rms(x):
        return float(x.double().pow(2).mean().sqrt())

    gap, yard = rms(got - plain_bf), rms(plain_f32 - plain_bf)
    return gap <= BF16_RULE * yard, gap, yard


def _bf16_final_args(w, gr):
    """K3's arguments with both histories rounded to bfloat16."""
    h1, h2 = (w[k].to(torch.bfloat16).contiguous() for k in ("hist1",
                                                             "hist2"))
    return (w["h0"], h1, h2, gr, w["wrel"], w["loop1"], w["loop2"], w["g1"],
            w["g2"], w["rtab"])


@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_layer_bf16_matches_plain_and_repeats(cuda, noact, N, d, B, R,
                                                    per, pad):
    """K3 in bfloat16 (its layer launches on native bfloat16 products, its
    score launch): out1 and the table within the bfloat16 rule of the
    plain bfloat16 version (the plain float32 version on the same
    histories the yardstick), with and without the select, at the main
    shape, at d = 32 and at a ragged N with d = 16; four launches a call;
    two runs bit-equal."""
    BF = torch.bfloat16
    gr, w = _final_case(N, d, cuda, B=B, noact=noact, num_rels=R,
                        edges_per_time=per, pad=pad)
    args = _bf16_final_args(w, gr)
    before = fused_final_fwd.launches
    loss, saved = fused_final_fwd(*args, hot=BF)
    again, saved2 = fused_final_fwd(*args, hot=BF)
    torch.cuda.synchronize()
    assert fused_final_fwd.launches == before + 8
    for k in ("table", "out1", "qhat", "lse"):
        assert torch.equal(saved[k], saved2[k]), k
    assert torch.equal(loss, again)
    _, tb, o1b = fused_final_fwd_plain(*args, hot=BF)
    _, tf, o1f = fused_final_fwd_plain(*args)
    for name, got, pb, pf in (("out1", saved["out1"], o1b, o1f),
                              ("table", saved["table"], tb, tf)):
        ok, gap, yard = _bf16_ok(got, pb, pf)
        assert ok, (name, gap, yard)


@pytest.mark.parametrize("N,d,B,R,per,pad", _FINAL_SHAPES)
def test_final_layer_bf16_shares_k2f_and_k5_products(cuda, N, d, B, R, per,
                                                     pad):
    """K3's bfloat16 layer launches form the conv output and the gates with
    the routines of K2f's and K5's bfloat16 launches (fwd_layer_tile_bf:
    conv_tc_bf, gate_products_bf): K3's layer 2 equals bit for bit K2f's
    layer on the same rows (one window step whose previous states are the
    dense history; K2f stores bfloat16, so the table rounded), and K2f's
    conv output there equals bit for bit the one K5's GRU launch recomputes
    (its bfloat16 step scratch); chip_smoke.py's ``k3_bf16_shares``."""
    gr, w = _final_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                        pad=pad)
    got = _smoke().k3_bf16_shares(*_bf16_final_args(w, gr))
    assert got["entries"] == B * N * d
    assert got["table_vs_k2f"] == 0 and got["conv_k2f_vs_k5"] == 0, got


def _bi_bf16(w):
    """_bi_case's weights with the histories and local tables rounded to
    bfloat16."""
    return dict(w, hists=tuple(h.to(torch.bfloat16).contiguous()
                               for h in w["hists"]))


@pytest.mark.parametrize("mode", range(len(_BI_MODES)))
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_bf16_repeats_and_matches_plain(cuda, mode, N, d, B, R, per,
                                                 pad):
    """K6+K7 in bfloat16 on native bfloat16 products, with the ReLU, the
    impute blend and the select on and off, at the main shape, at d = 32
    and at a ragged N with d = 16: two runs equal bit for bit, one launch
    each, and within the bfloat16 rule of the plain bfloat16 version (the
    plain float32 version on the same histories the yardstick)."""
    BF = torch.bfloat16
    relu, impute, select = _BI_MODES[mode]
    bg, w = _bi_case(N, d, cuda, B=B, noact=select, num_rels=R,
                     edges_per_time=per, pad=pad)
    args, kw = _bi_mode_args(bg, _bi_bf16(w), relu, impute, cuda)
    sel = w["h0"] if select else None
    before = fb.bi_layer_fwd.launches
    got = fb.bi_layer_fwd(*args, **kw, sel=sel, hot=BF)
    again = fb.bi_layer_fwd(*args, **kw, sel=sel, hot=BF)
    torch.cuda.synchronize()
    assert fb.bi_layer_fwd.launches == before + 2
    assert torch.equal(got, again)
    ok, gap, yard = _bf16_ok(got,
                             fb.bi_layer_fwd_plain(*args, **kw, sel=sel,
                                                   hot=BF),
                             fb.bi_layer_fwd_plain(*args, **kw, sel=sel))
    assert ok, (gap, yard)


@pytest.mark.parametrize("mode", range(len(_BI_MODES)))
@pytest.mark.parametrize("N,d,B,R,per,pad", _BI_SHAPES)
def test_bi_layer_bf16_gru_input_equals_the_backward_recompute(
        cuda, mode, N, d, B, R, per, pad):
    """K6+K7 and K9+K10's GRU launch in bfloat16 form the layer's GRU input
    with the same routines (conv_tc_bf, gin_at): the float32 one the
    forward forms, rounded to bfloat16, equals bit for bit the one the
    backward recomputes into its weight launch's operands (gin_s), and
    with the ReLU the forward's conv output takes the backward's branches
    (chip_smoke.py's ``bi_bf16_recompute``); the GRU input lies within the
    bfloat16 rule of the plain version's."""
    BF = torch.bfloat16
    relu, impute, _ = _BI_MODES[mode]
    bg, w = _bi_case(N, d, cuda, B=B, num_rels=R, edges_per_time=per,
                     pad=pad)
    args, kw = _bi_mode_args(bg, _bi_bf16(w), relu, impute, cuda)
    d_out = torch.randn(args[1].shape, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    got = _smoke().bi_bf16_recompute(args, kw, d_out)
    assert got["entries"] == B * N * d
    assert got["gin_vs_k9k10"] == 0 and got["relu_fwd_flips"] == 0, got
    gin = fb.bi_gru_input(*args, **kw, hot=BF)
    ok, gap, yard = _bf16_ok(
        gin, fb._rows_plain(*args[:8], relu, kw["hl"], kw["imp"], BF)[1],
        fb._rows_plain(*args[:8], relu, kw["hl"], kw["imp"])[1])
    assert ok, (gap, yard)
