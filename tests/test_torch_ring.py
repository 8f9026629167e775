"""The model-parallel slice of temp_tpu_torch against the JAX package (CPU,
float32): the ring-exchanged SpMM K13 (plain version, 4 CPU ranks), the
ring data layout, and GRRGCN's loss, gradients and eval ranks under the
edge partitions "psum", "ring" and "ring_pallas" with 4 ranks.

The JAX side runs on the virtual CPU devices of tests/conftest.py: K13's
Pallas kernel through the Mosaic interpreter where this file holds the
port's RingSpMM against it; the model under its XLA "ring" mode (the
interpreted model run costs 45 s, and the JAX package's own tests pin its
"ring" and "ring_pallas" modes together). Under a partition the JAX model
takes its scan window, whose dropout masks come from other keys than its
fused window's: ``scan_draws`` rebuilds that derivation.

Tolerances: 1e-5 absolute for outputs of order one (float32 sums in
another order: the ranks' shards sum in ring order); gradients, and
losses, 1e-5 relative to max(1, the largest entry); ranks equal (the float
paths agree to about 1e-6, far from any rank-changing gap at these seeds).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.dynamic import gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu.ops.segment import rel_spmm as jax_rel_spmm
from temp_tpu.parallel import edge_partition as jep
from temp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from temp_tpu.parallel.mesh import replicated, use_mesh
from temp_tpu.parallel.ring_pallas import ring_rel_spmm_pallas
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import segment
from temp_tpu_torch.ops.spmm import _norm2_plain, build_csr
from temp_tpu_torch.parallel.edge_partition import (
    EdgePartitionedModel, check_ring_layout, group_edges_by_dst_owner,
    rel_spmm_edge_partitioned, ring_geometry, ring_regroup_data, ring_tables,
)
from temp_tpu_torch.parallel.mesh import make_mesh, manual_partition
from temp_tpu_torch.parallel.ring_spmm import (
    ring_spmm, ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
    ring_spmm_fwd_plain,
)
from temp_tpu_torch.train.loop import Trainer
from test_torch_post import _xla_unoptimized
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import run_cli
from temp_tpu_torch.train.optim import param_leaves


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile
    (``_xla_unoptimized``: less compile time; the same arithmetic up to
    float32 rounding)."""
    with _xla_unoptimized():
        yield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
M = 4
CPU4 = ("cpu",) * M
MODES = ("psum", "ring", "ring_pallas")
# the JAX package's ring-mode test setup (tests/test_ring_mode.py)
DATA = dict(num_ents=300, num_rels=4, num_times=8, edges_per_time=180,
            edge_pad_multiple=16)
KW = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
          train_seq_len=3, batch_size=4, negative_rate=8, neg_oversample=8,
          num_pos_facts=64, dropout=0.1, mp_size=M)
T_POS = [4, 5, 2, 7]


def _close(a, b, what="", rel=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= rel * max(1.0, float(np.abs(b).max(initial=0.0))), \
        (what, err)


# -- K13: the ring SpMM -----------------------------------------------------

N_G, D_G, R_G, E_G = M * 128, 128, 60, 700  # tests/test_ring_pallas.py


def _graph(seed, n_bases=D_G):
    """tests/test_ring_pallas.py's graph: edges grouped by dst owner."""
    rs = np.random.RandomState(seed)
    src = rs.randint(0, N_G, E_G).astype(np.int32)
    dst = rs.randint(0, N_G, E_G).astype(np.int32)
    rel = rs.randint(0, R_G, E_G).astype(np.int32)
    emask = rs.rand(E_G) < 0.9
    edges = jep.group_edges_by_dst_owner(src, dst, rel, emask, N_G, M)
    h = rs.randn(N_G, D_G).astype(np.float32)
    w = rs.randn(R_G, n_bases * (D_G // n_bases) ** 2).astype(np.float32)
    return h, edges, w


def _port_ring(h, edges, w, kernels=True):
    """The port's differentiable K13 over 4 CPU ranks for one graph, with
    the gradients of sum(out * cot)."""
    th = torch.from_numpy(h)[None].requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    src, dst, rel, em = (torch.from_numpy(x)[None] for x in edges)
    out = ring_spmm(th, tw, src, dst, rel, em, M, N_G // M, CPU4,
                    kernels=kernels)
    return out[0], th, tw


def test_ring_spmm_matches_pallas_interpret():
    """Forward and both cotangents against ring_rel_spmm_pallas, the JAX
    package's K13, in interpret mode on the 4-device virtual mesh; rows
    without in-edges come out exactly 0; the CPU tensors take the plain
    version (no launch counted)."""
    h, edges, w = _graph(1)
    cot = np.random.RandomState(7).randn(N_G, D_G).astype(np.float32)
    mesh = JaxMesh(np.array(jax.devices()[:M]), ("model",))
    jedges = [jnp.asarray(x) for x in edges]

    def loss(h, w):
        out = ring_rel_spmm_pallas(h, *jedges, w, N_G, mesh)
        return jnp.sum(out * cot), out

    (_, ref), (ref_h, ref_w) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(h), jnp.asarray(w))
    before = ring_spmm_fwd.launches
    out, th, tw = _port_ring(h, edges, w)
    assert ring_spmm_fwd.launches == before
    _close(out.detach().numpy(), np.asarray(ref), "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(th.grad[0].numpy(), np.asarray(ref_h), "dh")
    _close(tw.grad.numpy(), np.asarray(ref_w), "dw")
    dst, em = edges[1], edges[3]
    isolated = np.setdiff1d(np.arange(N_G), dst[em])
    assert len(isolated) > 0
    assert np.all(out.detach().numpy()[isolated] == 0.0)


@pytest.mark.parametrize("s", [2, 4])
def test_ring_spmm_block_diagonal_matches_segment(s):
    """Block-diagonal relation weights (s x s blocks) against the JAX
    package's plain rel_spmm (method="segment"), to which the JAX package's
    own tests hold its Pallas ring's block cases in interpret mode (the
    slow cases of tests/test_ring_pallas.py)."""
    nb = D_G // s
    h, edges, w = _graph(3, n_bases=nb)
    cot = np.random.RandomState(9).randn(N_G, D_G).astype(np.float32)
    jedges = [jnp.asarray(x) for x in edges]

    def loss(h, w):
        out = jax_rel_spmm(h, *jedges, w, n_bases=nb, d_out=D_G,
                           num_ents=N_G, method="segment")
        return jnp.sum(out * cot), out

    (_, ref), (ref_h, ref_w) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    out, th, tw = _port_ring(h, edges, w)
    _close(out.detach().numpy(), np.asarray(ref), "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(th.grad[0].numpy(), np.asarray(ref_h), "dh")
    _close(tw.grad.numpy(), np.asarray(ref_w), "dw")


def test_ring_spmm_batched_graphs_and_refusals():
    """B graphs in one call equal B calls of one graph; the plain version
    is K13's CPU path; shapes the ring does not take raise."""
    rows = N_G // M
    h0, (src, dst, rel, em), w = _graph(4)
    h = torch.from_numpy(np.stack([h0, _graph(5)[0]]))
    w = torch.from_numpy(w)
    # a second graph on the same destination slices: other sources and
    # relations
    e = [torch.from_numpy(np.stack(x)) for x in (
        (src, (src + 37) % N_G), (dst, dst), (rel, (rel + 1) % R_G),
        (em, em[::-1].copy()))]
    out, n2 = ring_spmm_fwd(h, w, *e, M, rows, CPU4)
    plain, n2p = ring_spmm_fwd_plain(h, w, *e, M, rows, CPU4)
    assert torch.equal(out, plain) and torch.equal(n2, n2p)
    for b in range(2):
        one, _ = ring_spmm_fwd(h[b:b + 1], w, *(x[b:b + 1] for x in e), M,
                               rows, CPU4)
        assert torch.equal(one[0], out[b])
    with pytest.raises(ValueError):
        ring_spmm_fwd(h[:, :-1], w, *e, M, rows, CPU4)  # not m * rows rows
    with pytest.raises(ValueError):
        ring_spmm_fwd(h, w, *(x[:, :-1] for x in e), M, rows, CPU4)
    with pytest.raises(ValueError):
        ring_spmm_fwd(h, w[:, :-1], *e, M, rows, CPU4)
    with pytest.raises(ValueError):
        ring_spmm_fwd(h, w, *e, M, rows, CPU4[:2])


def test_psum_form_matches_jax():
    """The standalone psum form (each rank a chunk of the edges, partial
    degrees and sums added) against the JAX package's
    rel_spmm_edge_partitioned on 4 virtual devices, in any edge order."""
    rs = np.random.RandomState(11)
    n, d, r, e = 300, 16, 8, 256
    h = rs.randn(n, d).astype(np.float32)
    w = rs.randn(r, d).astype(np.float32)
    edges = (rs.randint(0, n, e).astype(np.int32),
             rs.randint(0, n, e).astype(np.int32),
             rs.randint(0, r, e).astype(np.int32), rs.rand(e) < 0.9)
    ref = jep.rel_spmm_edge_partitioned(
        jnp.asarray(h), *(jnp.asarray(x) for x in edges), jnp.asarray(w), d,
        d, n, jax_make_mesh(1, M))
    got = rel_spmm_edge_partitioned(
        torch.from_numpy(h), *(torch.from_numpy(x) for x in edges),
        torch.from_numpy(w), d, d, n, make_mesh(1, M, devices=CPU4))
    _close(got.numpy(), np.asarray(ref), "psum")


@pytest.fixture(scope="module")
def jax_ring_vjp():
    """The JAX package's K13 (ring_rel_spmm_pallas, Mosaic interpreter on
    the 4-device virtual mesh) and its vjp at one seeded cotangent, for
    diagonal (s = 1) and 4 x 4 block weights."""
    mesh = JaxMesh(np.array(jax.devices()[:M]), ("model",))
    out = {}
    for s in (1, 4):
        h, edges, w = _graph(21 + s, n_bases=D_G // s)
        cot = np.random.RandomState(s).randn(N_G, D_G).astype(np.float32)
        jedges = [jnp.asarray(x) for x in edges]

        def grads(h, w, g, s=s, jedges=jedges):
            _, vjp = jax.vjp(
                lambda h, w: ring_rel_spmm_pallas(h, *jedges, w, N_G, mesh,
                                                  n_bases=D_G // s), h, w)
            return vjp(g)

        # jitted: the interpreter's host work runs once a call
        out[s] = (h, edges, w, cot, *(np.asarray(x) for x in jax.jit(grads)(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(cot))))
    return out


@pytest.mark.parametrize("s", [1, 4])
def test_ring_spmm_bwd_plain_matches_pallas_vjp(jax_ring_vjp, s):
    """ring_spmm_bwd_plain (the transpose in torch ops, no replay of the
    forward) against the vjp of the JAX package's K13 in interpret mode,
    and against autograd through the plain forward: dh and dw within 1e-5
    of max(1, the largest entry)."""
    h, edges, w, cot, ref_h, ref_w = jax_ring_vjp[s]
    th, tw = torch.from_numpy(h)[None], torch.from_numpy(w)
    e = [torch.from_numpy(x)[None] for x in edges]
    g = torch.from_numpy(cot)[None]
    rows = N_G // M
    _, n2 = ring_spmm_fwd_plain(th, tw, *e, M, rows, CPU4)
    dh, dw = ring_spmm_bwd_plain(g, n2, th, tw, *e, M, rows, CPU4)
    _close(dh[0].numpy(), ref_h, "dh")
    _close(dw.numpy(), ref_w, "dw")
    ah, aw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    out, _ = ring_spmm_fwd_plain(ah, aw, *e, M, rows, CPU4)
    (out * g).sum().backward()
    _close(dh.numpy(), ah.grad.numpy(), "dh autograd")
    _close(dw.numpy(), aw.grad.numpy(), "dw autograd")


# -- K13's static tables ----------------------------------------------------

def _ring_data():
    cfg = TKGConfig(edge_partition="ring_pallas", **KW)
    return ring_layout(cfg, make_synthetic(**DATA))


def _spaces(data):
    """(name, tables, src, dst, rel) of both id spaces (numpy)."""
    tr = data.train
    return (("global", data.ring.glob, tr.src, tr.dst, tr.rel),
            ("compact", data.ring.comp, data.train_src_loc,
             data.train_dst_loc, tr.rel))


def test_static_tables_equal_in_call_csr():
    """ring_layout's tables (sorted once with the data, for all snapshots
    and ranks at once, as the kernels' in-call route sorts a call's
    graphs) equal, for every snapshot and rank, in both id spaces and all
    three orderings, build_csr run on that rank's edges alone with the
    same keys (destinations clipped into their rank's shard)."""
    data = _ring_data()
    keep = torch.from_numpy(data.train.emask)
    T, E = keep.shape
    cap, n_rels = E // M, 2 * data.num_rels
    assert data.ring.glob.rows == ring_geometry(data.num_ents, M)
    assert data.ring.comp.rows == data.act_idx.shape[1] // M
    for name, tab, *arrs in _spaces(data):
        rows, n_seg = tab.rows, M * tab.rows
        src, dst, rel = (torch.from_numpy(np.asarray(a)).long()
                         for a in arrs)
        slot = torch.arange(E).expand(T, E)
        base = torch.arange(E) // cap * rows
        dst_l = (dst - base).clamp(0, rows - 1)
        orders = (("fwd", src // rows * rows + dst_l, n_seg, (src, rel)),
                  ("src", src, n_seg, (base + dst_l, rel)),
                  ("rel", rel, n_rels, (src, base + dst_l)))
        for t in range(T):
            for r in range(M):
                sl = slice(r * cap, (r + 1) * cap)
                for o, key, width, (a, b) in orders:
                    ptr, x, y, z = build_csr(key[t, sl], width, a[t, sl],
                                             b[t, sl], slot[t, sl],
                                             keep=keep[t, sl])
                    got_ptr = getattr(tab, f"{o}_ptr")[t, r]
                    got = getattr(tab, f"{o}_edge")[t, r]
                    np.testing.assert_array_equal(got_ptr, ptr.numpy(),
                                                  f"{name} {o} {t} {r}")
                    np.testing.assert_array_equal(
                        got, torch.stack([x, y, z], -1).numpy(),
                        f"{name} {o} {t} {r}")


def test_table_walker_selects_the_plain_rings_edges():
    """A walker that reads only the tables, as the kernels do (the row
    pointer of its rank's block, the call's mask per edge), under a
    random dynamic mask inside the static one: at forward step k rank r
    gets exactly the edges the plain ring selects (kept, source in shard
    (r + k) % m) into each row, in slot order; the rows' degrees over
    their m owner segments give _norm2's norm^2; the table by source row
    gives the backward's step k exactly the rank's edges from shard
    (r + m - 1 - k) % m, the table by relation each relation's edges. The
    backward's accumulators, passed right after each step, end at their
    owners, and the walk's dh and dw equal ring_spmm_bwd_plain's."""
    data = _ring_data()
    rs = np.random.RandomState(3)
    static = np.asarray(data.train.emask)
    T, E = static.shape
    cap, n_rels, d = E // M, 2 * data.num_rels, 4
    dyn = static & (rs.rand(T, E) < 0.6)
    for name, tab, src, dst, rel in _spaces(data):
        rows = tab.rows
        n = M * rows
        w = rs.randn(n_rels, d).astype(np.float32)
        for t in range(T):
            keep, s_t, d_t, r_t = dyn[t], src[t], dst[t], rel[t]
            h = rs.randn(n, d).astype(np.float32)
            g = rs.randn(n, d).astype(np.float32)
            deg = np.zeros(n)
            for r in range(M):
                ptr, edge = tab.fwd_ptr[t, r], tab.fwd_edge[t, r]
                mine = np.arange(r * cap, (r + 1) * cap)
                for k in range(M):
                    owner = (r + k) % M
                    sel = mine[keep[mine] & (s_t[mine] // rows == owner)]
                    walked = []
                    for v in range(rows):
                        seg = edge[ptr[owner * rows + v]:
                                   ptr[owner * rows + v + 1]]
                        seg = seg[keep[seg[:, 2]]]
                        assert np.all(d_t[seg[:, 2]] == r * rows + v)
                        assert np.all(np.diff(seg[:, 2]) > 0)  # slot order
                        assert np.array_equal(seg[:, 0], s_t[seg[:, 2]])
                        assert np.array_equal(seg[:, 1], r_t[seg[:, 2]])
                        walked.append(seg[:, 2])
                        deg[r * rows + v] += len(seg)
                    walked = np.concatenate(walked)
                    assert np.array_equal(np.sort(walked), sel), (name, t)
            # the kernel's f32 arithmetic: norm = 1 / deg, norm^2
            deg = deg.astype(np.float32)
            norm = np.where(deg > 0, np.float32(1) / np.maximum(deg, 1),
                            np.float32(0))
            ref = _norm2_plain(torch.from_numpy(d_t.astype(np.int64)),
                               torch.from_numpy(keep.astype(np.float32)), n)
            np.testing.assert_array_equal(norm * norm, ref.numpy())
            n2 = ref.numpy()
            dh, dw = _walk_bwd(tab, t, keep, s_t, r_t, g, n2, h, w)
            args = [torch.from_numpy(np.asarray(a)[t][None]) for a in
                    (src, dst, rel)] + [torch.from_numpy(keep[None])]
            ph, pw = ring_spmm_bwd_plain(
                torch.from_numpy(g)[None], torch.from_numpy(n2)[None],
                torch.from_numpy(h)[None], torch.from_numpy(w), *args, M,
                rows, CPU4)
            _close(dh, ph[0].numpy(), f"{name} dh walk")
            _close(dw, pw.numpy(), f"{name} dw walk")


def _walk_bwd(tab, t, keep, s_t, r_t, g, n2, h, w):
    """K13's backward (s = 1) of snapshot t walked through the tables as
    its kernels walk them, under the dynamic mask `keep` [E]: accumulators
    [M, rows, d], rank r's at step k for shard (r + M - 1 - k) % M, gaining
    its edges from there (the table by source row, each edge's cotangent
    read at the destination the table holds) and passed right; dw partials
    by relation (the table by relation), summed in rank order. Asserts
    each step gets exactly the rank's kept edges from its shard. Returns
    (dh [M * rows, d], dw [n_rels, d])."""
    rows, cap = tab.rows, len(keep) // M
    d, n_rels = g.shape[1], w.shape[0]
    acc = np.zeros((M, rows, d), np.float64)
    dw = np.zeros((M, n_rels, d), np.float64)
    for k in range(M):
        for r in range(M):
            q = (r + M - 1 - k) % M
            ptr, edge = tab.src_ptr[t, r], tab.src_edge[t, r]
            got = []
            for v in range(rows):
                seg = edge[ptr[q * rows + v]:ptr[q * rows + v + 1]]
                seg = seg[keep[seg[:, 2]]]
                assert np.all(s_t[seg[:, 2]] == q * rows + v)
                for dd, rr, _ in seg:
                    acc[r, v] += g[dd] * n2[dd] * w[rr]
                got.append(seg[:, 2])
            mine = np.arange(r * cap, (r + 1) * cap)
            want = mine[keep[mine] & (s_t[mine] // rows == q)]
            assert np.array_equal(np.sort(np.concatenate(got)), want)
        if k < M - 1:
            acc = acc[[(r - 1) % M for r in range(M)]]
    for r in range(M):
        ptr, edge = tab.rel_ptr[t, r], tab.rel_edge[t, r]
        for x in range(n_rels):
            seg = edge[ptr[x]:ptr[x + 1]]
            seg = seg[keep[seg[:, 2]]]
            assert np.all(r_t[seg[:, 2]] == x)
            for ss, dd, _ in seg:
                dw[r, x] += h[ss] * g[dd] * n2[dd]
    return acc.reshape(M * rows, d), dw.sum(0)


def test_tables_clip_a_destination_outside_its_slice():
    """Edges sorted in a call (ring_tables, the in-call route) where two
    kept edges have their destination outside their slice's shard: all
    three orderings hold the destination clipped into the shard, as the
    plain ring clips it, and the backward walked through the tables equals
    ring_spmm_bwd_plain and autograd through the plain forward."""
    h, (src, dst, rel, em), w = _graph(31)
    rows, cap = N_G // M, len(em) // M
    dst = dst.copy()
    assert em[0] and em[2 * cap]
    dst[0] = 3 * rows + 5      # slice 0 -> clipped to row rows - 1
    dst[2 * cap] = 5           # slice 2 -> clipped to row 2 * rows
    clipped = {0: rows - 1, 2 * cap: 2 * rows}
    e = [torch.from_numpy(x)[None] for x in (src, dst, rel, em)]
    tab = ring_tables(*e, M, rows, R_G)
    tab = type(tab)(rows, *(getattr(tab, f.name).numpy()
                            for f in dataclasses.fields(tab)[1:]))
    for o, col in (("src", 0), ("rel", 1)):
        edge = getattr(tab, f"{o}_edge")[0].reshape(-1, 3)
        for slot, row in clipped.items():
            assert edge[edge[:, 2] == slot, col].tolist() == [row], o
    g = np.random.RandomState(32).randn(N_G, D_G).astype(np.float32)
    th, tw, tg = (torch.from_numpy(x) for x in (h[None], w, g[None]))
    _, n2 = ring_spmm_fwd_plain(th, tw, *e, M, rows, CPU4)
    dh, dw = _walk_bwd(tab, 0, em, src, rel, g, n2[0].numpy(), h, w)
    ph, pw = ring_spmm_bwd_plain(tg, n2, th, tw, *e, M, rows, CPU4)
    _close(dh, ph[0].numpy(), "dh walk")
    _close(dw, pw.numpy(), "dw walk")
    ah, aw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    out, _ = ring_spmm_fwd_plain(ah, aw, *e, M, rows, CPU4)
    (out * tg).sum().backward()
    _close(ph.numpy(), ah.grad.numpy(), "dh autograd")
    _close(pw.numpy(), aw.grad.numpy(), "dw autograd")


def test_time_position_outside_the_tables_raises():
    """A call that names a snapshot outside its tables' [0, T) raises (on
    the card the kernels stop on a device assert instead of reading past
    the tables)."""
    data = _ring_data()
    tab = data.ring.glob
    T, rows = data.num_times, tab.rows
    tr = data.train
    e = [torch.from_numpy(np.asarray(x)[:1]) for x in (tr.src, tr.dst, tr.rel,
                                                       tr.emask)]
    h = torch.zeros(1, M * rows, 4)
    w = torch.zeros(2 * data.num_rels, 4)
    g = torch.zeros_like(h)
    n2 = torch.zeros(1, M * rows)
    for bad in (T, -1):
        tables = (tab, torch.tensor([bad]))
        with pytest.raises(ValueError, match="outside"):
            ring_spmm_fwd(h, w, *e, M, rows, CPU4, tables=tables)
        with pytest.raises(ValueError, match="outside"):
            ring_spmm_bwd(g, n2, h, w, *e, M, rows, CPU4, tables=tables)
    out, _ = ring_spmm_fwd(h, w, *e, M, rows, CPU4,
                           tables=(tab, torch.tensor([0])))
    assert out.shape == h.shape


def test_ring_calls_name_train_snapshots_whose_mask_they_narrow(
        monkeypatch):
    """Under ring_pallas on the CPU, through the window and the final step
    of a training batch and of an eval batch, every SpMM names the
    snapshots its edges are (the data's tables of its id space and their
    time positions), its edges equal those snapshots' train edges in that
    space, and its mask lies inside their static mask, which the tables
    hold (a recording wrapper around the ring SpMM; the model is
    unchanged)."""
    data = to_device(_ring_data(), "cpu")
    cfg = TKGConfig(edge_partition="ring_pallas", **KW)
    model = get_model(cfg, data, device="cpu")
    wrapped = EdgePartitionedModel(model, make_mesh(1, M, devices=CPU4),
                                   mode="ring_pallas")
    calls = []
    real = segment.ring_spmm

    def record(h, w, src, dst, rel, emask, m, rows, devices, kernels=True,
               tables=None, hot=None):
        calls.append((src, dst, rel, emask, tables))
        return real(h, w, src, dst, rel, emask, m, rows, devices,
                    kernels=kernels, tables=tables, hot=hot)

    monkeypatch.setattr(segment, "ring_spmm", record)
    params = model.init_params(0)
    gen = torch.Generator().manual_seed(0)
    wrapped.loss(params, data, T_POS, [True, True, False, True], gen=gen)
    n_train = len(calls)
    with torch.no_grad():
        wrapped.eval_ranks(params, data, T_POS, [True] * 4, "valid")
    L1 = KW["train_seq_len"] - 1
    assert n_train == 2 * L1 + 2 * 3 and len(calls) == n_train + 2 * L1 + 8
    tr = data.train
    spaces = {id(data.ring.glob): (tr.src, tr.dst),
              id(data.ring.comp): (data.train_src_loc, data.train_dst_loc)}
    seen = set()
    for src, dst, rel, emask, tables in calls:
        assert tables is not None
        tab, t_pos = tables
        s_all, d_all = spaces[id(tab)]
        seen.add(id(tab))
        assert t_pos.shape == (src.shape[0],)
        for b, t in enumerate(t_pos.tolist()):
            assert torch.equal(src[b], s_all[t])
            assert torch.equal(dst[b], d_all[t])
            assert torch.equal(rel[b], tr.rel[t])
            assert not bool((emask[b] & ~tr.emask[t]).any())
    assert seen == set(spaces)


# -- the ring data layout ---------------------------------------------------

def _fields(d):
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _fields(v).items()})
        elif isinstance(v, (int, np.ndarray)):
            out[f.name] = np.asarray(v)
    return out


def test_layout_helpers_match_jax():
    """ring_geometry, ring_regroup_data and group_edges_by_dst_owner give
    the JAX package's arrays."""
    for n, m in ((300, 4), (7128, 4), (512, 8), (40, 2)):
        assert ring_geometry(n, m) == jep.ring_geometry(n, m)
    ref = _fields(jep.ring_regroup_data(jax_synthetic(**DATA), M))
    got = _fields(ring_regroup_data(make_synthetic(**DATA), M))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], k)
    rs = np.random.RandomState(0)
    edges = (rs.randint(0, 300, 256), rs.randint(0, 300, 256),
             rs.randint(0, 8, 256), rs.rand(256) < 0.9)
    for a, b in zip(group_edges_by_dst_owner(*edges, 512, M),
                    jep.group_edges_by_dst_owner(*edges, 512, M)):
        np.testing.assert_array_equal(a, b)


# -- GRRGCN under a partition -----------------------------------------------

def scan_draws(cfg, data, t_pos, rng):
    """Every draw of the JAX model's loss on its scan window and unfused
    final step (the path it takes under a partition): split(rng, B) per
    element; split -> (r_fwd, r_loss); split(r_fwd, 3) -> (k_pre, k_fin,
    k_sub); window step k's masks from split(split(k_pre, L1)[k]) at
    (A, d); the final step's from split(k_fin) at (N, d); the edge
    subsample from k_sub; the positives from split(r_loss, 3)[0]."""
    L = cfg.train_seq_len
    A, N, d = data.act_idx.shape[1], data.num_ents, cfg.embed_size
    keep = 1.0 - cfg.dropout
    out = {k: [] for k in ("win1", "win2", "fin1", "fin2", "edges", "pos")}
    for t, r in zip(t_pos, jax.random.split(rng, len(t_pos))):
        r_fwd, r_loss = jax.random.split(r)
        k_pre, k_fin, k_sub = jax.random.split(r_fwd, 3)
        steps = [jax.random.split(k) for k in jax.random.split(k_pre, L - 1)]
        for i, key in enumerate(("win1", "win2")):
            out[key].append(np.stack([np.asarray(
                jax.random.bernoulli(k[i], keep, (A, d))) for k in steps]))
        for key, k in zip(("fin1", "fin2"), jax.random.split(k_fin)):
            out[key].append(np.asarray(jax.random.bernoulli(k, keep, (N, d))))
        win = gather_window(data, jnp.int32(t), L)
        out["edges"].append(np.asarray(
            jax_subsample_edges(k_sub, win.emask[L - 1], 0.5)))
        out["pos"].append(np.asarray(jax_subsample_pos(
            jax.random.split(r_loss, 3)[0], data.train.emask[t],
            cfg.num_pos_facts)))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's GRRGCN in "ring" mode over 4 virtual devices on
    the regrouped data: loss and gradients, the draws, and the
    unpartitioned model's eval ranks of the valid split."""
    data = jax.device_put(jep.ring_regroup_data(jax_synthetic(**DATA), M))
    cfg = JaxConfig(edge_partition="ring", **KW)
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    t_pos = jnp.asarray(T_POS, jnp.int32)
    t_valid = jnp.asarray([True, True, False, True])
    rng = jax.random.PRNGKey(5)
    mesh = jax_make_mesh(1, M)
    with use_mesh(mesh):
        wrapped = jep.EdgePartitionedModel(model, mesh, mode="ring")
        sp = jax.device_put(params, replicated(mesh))
        sd = jax.device_put(data, replicated(mesh))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: wrapped.loss(p, sd, t_pos, t_valid, rng)))(sp)
    ranks, mask, _ = jax.jit(
        lambda p: model.eval_ranks(p, data, t_pos, jnp.ones(4, bool),
                                   "valid"))(params)
    return dict(loss=float(loss), grads=grads,
                params=jax.tree_util.tree_map(np.asarray, params),
                draws=scan_draws(cfg, data, T_POS, rng),
                ranks=np.asarray(ranks), mask=np.asarray(mask))


def _port_model(mode, **over):
    cfg = TKGConfig(edge_partition=mode, **{**KW, **over})
    data = ring_regroup_data(make_synthetic(**DATA), M)
    model = get_model(cfg, data, device="cpu")
    mesh = make_mesh(1, M, devices=CPU4)
    return (EdgePartitionedModel(model, mesh, mode=mode),
            to_device(data, "cpu"))


def _pairs(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (list, tuple)):
        for i, (j, t) in enumerate(zip(jtree, ttree)):
            yield from _pairs(j, t, f"{path}/{i}")
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax_ring(jax_ring, mode):
    """GRRGCN's summed loss and every gradient with 4 ranks, each mode of
    the port against the JAX package's "ring" mode, from the same weights
    and draws: within 1e-5 relative to max(1, the largest entry) (f32 sums
    in another order through a two-layer window of 2 steps and the final
    step)."""
    wrapped, data = _port_model(mode)
    params = params_from_numpy(jax_ring["params"], device="cpu")
    for p in param_leaves(params):
        p.requires_grad_(True)
    assert not wrapped.fused_final_on()  # cfg: "auto", off on the CPU
    before = ring_spmm_fwd.launches
    loss = wrapped.loss(params, data, T_POS, [True, True, False, True],
                        draws=jax_ring["draws"])
    loss.backward()
    assert ring_spmm_fwd.launches == before  # the CPU runs the plain version
    ref = jax_ring["loss"]
    assert abs(loss.item() - ref) <= ATOL * max(1.0, abs(ref))
    n = 0
    for path, g_ref, p in _pairs(jax_ring["grads"], params):
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad.numpy(), np.asarray(g_ref), path)
        n += 1
    assert n == len(param_leaves(params))


@pytest.mark.parametrize("mode", MODES)
def test_eval_ranks_match_jax_unpartitioned(jax_ring, mode):
    """The filtered ranks of the valid split with 4 ranks equal the JAX
    package's unpartitioned ranks on the same regrouped data; the fused
    switches asked for stay off inside the partition."""
    wrapped, data = _port_model(mode, fused_eval=True, fused_final=True,
                                fused_window=True)
    params = params_from_numpy(jax_ring["params"], device="cpu")
    assert wrapped.fused_final_on() and wrapped.fused_eval_on()
    assert wrapped.precompute_eval_conv1(params, data) is None
    with manual_partition("model", M, mode, CPU4):
        assert not (wrapped.fused_final_on() or wrapped.fused_eval_on()
                    or wrapped.fused_window_on())
    with torch.no_grad():
        ranks, mask, _ = wrapped.eval_ranks(params, data, T_POS, [True] * 4,
                                            "valid")
    np.testing.assert_array_equal(mask.numpy(), jax_ring["mask"])
    np.testing.assert_array_equal(ranks.numpy()[jax_ring["mask"]],
                                  jax_ring["ranks"][jax_ring["mask"]])


def test_trainer_fits_and_evaluates_under_ring_pallas(tmp_path, one_thread):
    """Trainer.fit for one epoch and run_eval with edge_partition
    "ring_pallas" and 4 CPU ranks: the Trainer wraps the model, the losses
    are finite, and the sweep's MRR equals the unpartitioned sweep's of the
    trained weights on the same data. On one intra-op thread: the ring's
    thousands of tiny ops otherwise wait on the other test workers'
    threads (``one_thread``)."""
    cfg = TKGConfig(edge_partition="ring_pallas", fast_dev_run=True,
                    **{**KW, "batch_size": 2})
    data = ring_regroup_data(make_synthetic(**DATA), M)
    tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data,
                 run_dir=str(tmp_path / "run"))
    assert isinstance(tr.model, EdgePartitionedModel)
    assert tr.mesh.placement() == "4 ranks on cpu"
    out = tr.fit(max_epochs=1, log_fn=lambda _: None)
    assert np.isfinite(out["history"][0]["train_loss"])
    m = tr.run_eval(out["params"], "valid")
    plain = TKGConfig(**{**KW, "mp_size": 1})
    ref = Trainer(plain, get_model(plain, data, device="cpu"), data)
    m_ref = ref.run_eval(out["params"], "valid")
    assert m["n"] == m_ref["n"] > 0
    assert abs(m["mrr"] - m_ref["mrr"]) <= 1e-6


@pytest.mark.parametrize("mode", ["ring", "ring_pallas"])
def test_trainer_refuses_data_not_in_ring_layout(mode):
    """The ring modes take data regrouped for their ranks and refuse any
    other: make_synthetic's layout (whose E is a multiple of 4 under
    edge_pad_multiple 16, so the shape alone would pass), and data
    regrouped for another number of ranks. psum takes any layout."""
    cfg = TKGConfig(edge_partition=mode, **KW)
    raw = make_synthetic(**DATA)
    assert raw.train.src.shape[1] % M == 0
    for data in (raw, ring_regroup_data(raw, 2)):
        with pytest.raises(ValueError, match="ring_regroup_data"):
            Trainer(cfg, get_model(cfg, data, device="cpu"), data)
    good = ring_regroup_data(raw, M)
    check_ring_layout(good, M)
    Trainer(cfg, get_model(cfg, good, device="cpu"), good)
    psum = TKGConfig(edge_partition="psum", **KW)
    Trainer(psum, get_model(psum, raw, device="cpu"), raw)


def _write_dataset(root, num_ents=300, num_rels=4, num_times=8, n=400):
    rs = np.random.RandomState(0)
    path = os.path.join(root, "interpolation", "tiny")
    os.makedirs(path)
    for name, k in (("train", n), ("valid", n // 4), ("test", n // 4)):
        q = np.stack([rs.randint(0, num_ents, k), rs.randint(0, num_rels, k),
                      rs.randint(0, num_ents, k),
                      rs.randint(0, num_times, k)], 1)
        np.savetxt(os.path.join(path, f"{name}.txt"), q, fmt="%d",
                   delimiter="\t")
    with open(os.path.join(path, "stat.txt"), "w") as f:
        f.write(f"{num_ents}\t{num_rels}\t{num_times}\n")
    return str(root)


def test_main_cli_ring_pallas_on_cpu(tmp_path, capsys, one_thread):
    root = _write_dataset(tmp_path / "data")
    out = run_cli([
        "-c", os.path.join(ROOT, "grid", "icews14", "config_grrgcn.json"),
        "--device", "cpu", "--fast-dev-run", "--data-root", root, "--dataset",
        "tiny", "--edge-pad-multiple", "16", "--embed-size", "16",
        "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
        "--batch-size", "2", "--edge-partition", "ring_pallas", "--mp-size",
        "4", "--experiments-dir", str(tmp_path / "runs"), "--model-name",
        "cli",
    ], capsys)
    assert "mesh: 4 ranks on cpu" in out
    assert "epoch 0:" in out and "test: mrr=" in out


# -- what stays unported ----------------------------------------------------

@pytest.mark.parametrize("over,what", [
    ({"edge_partition": True}, "boundary"),
    ({"edge_partition": "boundary"}, "boundary"),
    ({"edge_partition": "ring", "dp_size": 2}, "data parallelism"),
    ({"edge_partition": "ring", "distributed": True}, "multi-process"),
    ({"mp_size": 4}, "model parallelism"),
])
def test_unported_partitions_raise(over, what):
    """Multi-process training and mp_size > 1 without a partition still
    raise; the boundary exchange and the data axis are ported (the
    config builds, as the JAX package's does)."""
    if what in ("boundary", "data parallelism"):
        cfg = TKGConfig(**over, mp_size=M)
        assert cfg.partitioned and cfg.edge_partition_mode == \
            JaxConfig(**over, mp_size=M).edge_partition_mode
        assert cfg.dp_size == over.get("dp_size", 1)
    else:
        with pytest.raises(NotImplementedError, match=what):
            TKGConfig(**over)
    assert TKGConfig(edge_partition="ring_pallas",
                     mp_size=4).edge_partition_mode == "ring_pallas"
    assert TKGConfig(edge_partition="false").edge_partition_mode is None


def test_flagship_under_a_partition_raises():
    """The flagship (BiGRRGCN --impute) runs under a partition now; TED
    (--post-ensemble), --post-aggregation and the unidirectional --impute
    still raise, at get_model and in a model wrapped by hand, naming the
    ROADMAP items."""
    data = ring_regroup_data(make_synthetic(**DATA), M)
    kw = {**KW, "module": "BiGRRGCN", "impute": True}
    get_model(TKGConfig(edge_partition="ring", **kw), data, device="cpu")
    for over in ({"post_ensemble": True}, {"post_aggregation": True},
                 {"module": "GRRGCN"}):
        with pytest.raises(NotImplementedError, match="items 8-9"):
            get_model(TKGConfig(edge_partition="ring", **{**kw, **over}),
                      data, device="cpu")
    ted = {**kw, "post_ensemble": True, "mp_size": 1}
    model = get_model(TKGConfig(**ted), data, device="cpu")
    wrapped = EdgePartitionedModel(model, make_mesh(1, M, devices=CPU4),
                                   mode="ring")
    with pytest.raises(NotImplementedError, match="items 8-9"):
        wrapped.eval_ranks(model.init_params(0), to_device(data, "cpu"),
                           T_POS, [True] * 4, "valid")


def test_make_mesh_places_ranks_only_where_asked():
    """Without devices the ranks take the visible cards, round robin; with
    no card that raises rather than placing them on the CPU. A data axis
    splits the batch (``EdgePartitionedModel``)."""
    mesh = make_mesh(1, M, devices=CPU4)
    assert mesh.shape == {"data": 1, "model": M}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, M)
    with pytest.raises(ValueError):
        make_mesh(1, M, devices=CPU4[:2])
    grid = make_mesh(2, 2, devices=CPU4)
    wrapped = EdgePartitionedModel(object(), grid)
    assert (wrapped.dp, wrapped.mp) == (2, 2)
    assert grid.placement() == "2 x 2 ranks on cpu"
    two = make_mesh(1, 2, devices=["cpu", "meta"])
    assert two.placement() == "2 ranks on cpu, meta"
