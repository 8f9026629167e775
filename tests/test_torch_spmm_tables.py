"""Kernel K1's static CSR tables (``TKGData.spmm``: ``ring_tables`` of one
rank, built by ``ring_layout``) on the CPU, float32.

The tables equal ``build_csr`` of each snapshot under the static mask; a
plain walker that reads only the tables, as the kernels in
``csrc/spmm.cu`` do (the row pointer of the snapshot a graph names, the
call's mask per edge), gives what ``spmm_fwd_plain``/``spmm_bwd_plain``
and the JAX package's ``rel_spmm_pallas`` (interpret mode) and its vjp
give, within 1e-5 absolute (float32 sums of values of order one in
another order); every K1 call of the models names its snapshots in the
data's tables with a mask inside their static mask; a time position
outside the tables raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.ops.pallas_spmm import rel_spmm_pallas
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import segment
from temp_tpu_torch.ops.spmm import (
    _norm2_plain, build_csr, flat_graph, spmm, spmm_bwd, spmm_bwd_plain,
    spmm_fwd, spmm_fwd_plain,
)
from temp_tpu_torch.parallel.edge_partition import ring_geometry

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
DATA = dict(num_ents=40, num_rels=4, num_times=6, edges_per_time=30,
            edge_pad_multiple=16)
GRRGCN = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
              train_seq_len=3, batch_size=3, negative_rate=8,
              neg_oversample=8, num_pos_facts=64, dropout=0.1)
FLAGSHIP = dict(module="BiGRRGCN", impute=True, embed_size=16,
                hidden_size=16, n_bases=16, train_seq_len=3, batch_size=2,
                seed=0, num_pos_facts=100)


def _data(**over):
    return ring_layout(TKGConfig(**over), make_synthetic(**DATA))


def _spaces(data):
    """(name, tables, src, dst) of both id spaces: the final step's global
    ids and the window's compact slots."""
    tr = data.train
    return (("glob", data.spmm.glob, tr.src, tr.dst),
            ("comp", data.spmm.comp, data.train_src_loc,
             data.train_dst_loc))


@pytest.mark.parametrize("over", [{}, {"edge_partition": "ring_pallas",
                                      "mp_size": 2}])
def test_static_tables_equal_build_csr_of_each_snapshot(over):
    """ring_layout's K1 tables equal, for every snapshot and both id
    spaces, build_csr of that snapshot's edges under the static mask by
    destination, by source and by relation (each edge with its two other
    ints and its slot), in the unpartitioned layout and in a ring layout
    (the regrouped edges, beside K13's tables)."""
    data = _data(**over)
    keep = torch.from_numpy(data.train.emask)
    T, E = keep.shape
    n_rels = 2 * data.num_rels
    assert (data.ring is None) == (not over)
    assert data.spmm.glob.rows == ring_geometry(data.num_ents, 1)
    assert data.spmm.comp.rows == ring_geometry(data.act_idx.shape[1], 1)
    slot = torch.arange(E)
    for name, tab, *arrs in _spaces(data):
        src, dst = (torch.from_numpy(np.asarray(a)).long() for a in arrs)
        rel = torch.from_numpy(data.train.rel).long()
        for t in range(T):
            for o, key, width, a, b in (
                    ("fwd", dst[t], tab.rows, src[t], rel[t]),
                    ("src", src[t], tab.rows, dst[t], rel[t]),
                    ("rel", rel[t], n_rels, src[t], dst[t])):
                ptr, x, y, z = build_csr(key, width, a, b, slot,
                                         keep=keep[t])
                np.testing.assert_array_equal(
                    getattr(tab, f"{o}_ptr")[t, 0], ptr.numpy(),
                    f"{name} {o} {t}")
                np.testing.assert_array_equal(
                    getattr(tab, f"{o}_edge")[t, 0],
                    torch.stack([x, y, z], -1).numpy(), f"{name} {o} {t}")


# -- a plain walker of the tables -------------------------------------------

def _walk_fwd(tab, t_pos, mask, h, w):
    """K1f as the kernel walks it: graph b's rows over the table by
    destination of snapshot t_pos[b], its mask per edge. Returns (out,
    norm^2) over the B graphs' rows."""
    B = len(t_pos)
    n = h.shape[0] // B
    out = np.zeros_like(h)
    n2 = np.zeros(h.shape[0], np.float32)
    for b, t in enumerate(t_pos):
        ptr, edge = tab.fwd_ptr[t, 0], tab.fwd_edge[t, 0]
        for v in range(n):
            seg = edge[ptr[v]:ptr[v + 1]]
            seg = seg[mask[b, seg[:, 2]]]
            norm = 1.0 / len(seg) if len(seg) else 0.0
            n2[b * n + v] = norm * norm
            out[b * n + v] = (h[b * n + seg[:, 0]] * w[seg[:, 1]]).sum(0) \
                * norm * norm
    return out, n2


def _walk_bwd(tab, t_pos, mask, g, n2, h, w):
    """K1b as the kernel walks it: dh of graph b's rows over its table by
    source, dw of each relation over the graphs' tables by relation in
    order b = 0 .. B - 1."""
    B = len(t_pos)
    n = h.shape[0] // B
    dh, dw = np.zeros_like(h), np.zeros_like(w)
    gn = g * n2[:, None]
    for b, t in enumerate(t_pos):
        ptr, edge = tab.src_ptr[t, 0], tab.src_edge[t, 0]
        for u in range(n):
            seg = edge[ptr[u]:ptr[u + 1]]
            seg = seg[mask[b, seg[:, 2]]]
            dh[b * n + u] = (gn[b * n + seg[:, 0]] * w[seg[:, 1]]).sum(0)
    for r in range(w.shape[0]):
        for b, t in enumerate(t_pos):
            ptr, edge = tab.rel_ptr[t, 0], tab.rel_edge[t, 0]
            seg = edge[ptr[r]:ptr[r + 1]]
            seg = seg[mask[b, seg[:, 2]]]
            dw[r] += (gn[b * n + seg[:, 1]] * h[b * n + seg[:, 0]]).sum(0)
    return dh, dw


def _case(data, layout):
    """(tables, t_pos, src, dst, rel [B, E], rows a graph) of a layout:
    one graph in global ids (the final step), B graphs side by side in
    compact slots (a window step) or all T snapshots (the conv1 table)."""
    tr = data.train
    T = data.num_times
    if layout == "one":
        t_pos = np.array([T // 2])
        return (data.spmm.glob, t_pos, tr.src[t_pos], tr.dst[t_pos],
                tr.rel[t_pos], data.num_ents)
    t_pos = (np.array([T - 1, 1, T - 1]) if layout == "window"
             else np.arange(T))
    return (data.spmm.comp, t_pos, data.train_src_loc[t_pos],
            data.train_dst_loc[t_pos], tr.rel[t_pos], data.act_idx.shape[1])


@pytest.mark.parametrize("layout", ["one", "window", "conv1_table"])
def test_table_walker_matches_plain_and_pallas(layout):
    """Forward and backward walked through the tables, under the static
    mask and under a 50% mask inside it, against the plain versions and
    the JAX package's rel_spmm_pallas and its vjp (interpret mode), on the
    graphs flattened side by side; the port's spmm_fwd/spmm_bwd/spmm with
    the tables on the CPU run the plain versions on the same graphs."""
    data = _data()
    rs = np.random.RandomState(len(layout))
    tab, t_pos, src, dst, rel, n = _case(data, layout)
    static = data.train.emask[t_pos]
    B, d, R = len(t_pos), 8, 2 * data.num_rels
    h = rs.standard_normal((B * n, d)).astype(np.float32)
    w = rs.standard_normal((R, d)).astype(np.float32)
    g = rs.standard_normal((B * n, d)).astype(np.float32)
    fs, fd = (x.numpy() for x in flat_graph(torch.from_numpy(src),
                                            torch.from_numpy(dst), n))
    fr = rel.reshape(-1)
    tables = (tab, torch.from_numpy(t_pos))
    for mask in (static, static & (rs.rand(*static.shape) < 0.5)):
        out, n2 = _walk_fwd(tab, t_pos, mask, h, w)
        dh, dw = _walk_bwd(tab, t_pos, mask, g, n2, h, w)
        ft = [torch.from_numpy(x) for x in (h, fs, fd, fr, mask.reshape(-1),
                                            w)]
        np.testing.assert_allclose(out, spmm_fwd_plain(*ft).numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(
            n2, _norm2_plain(ft[2], ft[4].float(), B * n).numpy(), atol=ATOL)
        ph, pw = spmm_bwd_plain(torch.from_numpy(g), torch.from_numpy(n2),
                                *ft)
        np.testing.assert_allclose(dh, ph.numpy(), atol=ATOL)
        np.testing.assert_allclose(dw, pw.numpy(), atol=ATOL)

        def f(hh, ww):
            return rel_spmm_pallas(hh, *(jnp.asarray(x) for x in (
                fs, fd, fr, mask.reshape(-1))), ww, B * n, interpret=True)

        ref, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
        ref_h, ref_w = vjp(jnp.asarray(g))
        np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(dh, np.asarray(ref_h), atol=ATOL)
        np.testing.assert_allclose(dw, np.asarray(ref_w), atol=ATOL)

        e = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (src, dst, rel, mask)]
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        got = spmm(th, *e, tw, tables=tables)
        np.testing.assert_allclose(got.detach().numpy(), out, atol=ATOL)
        np.testing.assert_array_equal(spmm_fwd(torch.from_numpy(h), *e,
                                               torch.from_numpy(w),
                                               tables=tables).numpy(),
                                      got.detach().numpy())
        (got * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(th.grad.numpy(), dh, atol=ATOL)
        np.testing.assert_allclose(tw.grad.numpy(), dw, atol=ATOL)
        bh, bw = spmm_bwd(torch.from_numpy(g), torch.from_numpy(n2),
                          torch.from_numpy(h), *e, torch.from_numpy(w),
                          tables=tables)
        np.testing.assert_allclose(bh.numpy(), dh, atol=ATOL)
        np.testing.assert_allclose(bw.numpy(), dw, atol=ATOL)


def test_time_position_outside_the_tables_raises():
    """A call that names a snapshot outside its tables' [0, T) raises on
    the CPU (on the card the kernels stop on a device assert instead of
    reading past the tables)."""
    data = _data()
    tab, tr = data.spmm.glob, data.train
    T, N = data.num_times, data.num_ents
    e = [torch.from_numpy(np.asarray(x)[0]) for x in (tr.src, tr.dst, tr.rel,
                                                      tr.emask)]
    h = torch.zeros(N, 4)
    w = torch.zeros(2 * data.num_rels, 4)
    for bad in (T, -1):
        tables = (tab, torch.tensor([bad]))
        with pytest.raises(ValueError, match="outside"):
            spmm_fwd(h, *e, w, tables=tables)
        with pytest.raises(ValueError, match="outside"):
            spmm_bwd(h, torch.zeros(N), h, *e, w, tables=tables)
    out = spmm_fwd(h, *e, w, tables=(tab, torch.tensor([T - 1])))
    assert out.shape == h.shape


# -- the models' K1 calls name their snapshots ------------------------------

def _record(monkeypatch):
    calls = []
    real = segment.spmm

    def record(h, src, dst, rel, emask, weight, tables=None, hot=None,
               onehot=False):
        calls.append((src, dst, rel, emask, tables))
        return real(h, src, dst, rel, emask, weight, tables=tables, hot=hot,
                    onehot=onehot)

    monkeypatch.setattr(segment, "spmm", record)
    return calls


def _check_calls(calls, data):
    """Every call names the data's tables of its id space and time
    positions whose train edges its edges are, with a mask inside their
    static mask. Returns the id spaces seen."""
    tr = data.train
    spaces = {id(data.spmm.glob): ("glob", tr.src, tr.dst),
              id(data.spmm.comp): ("comp", data.train_src_loc,
                                   data.train_dst_loc)}
    seen = set()
    for src, dst, rel, emask, tables in calls:
        assert tables is not None
        tab, t_pos = tables
        name, s_all, d_all = spaces[id(tab)]
        seen.add(name)
        src, dst, rel, emask = (x.reshape(len(t_pos), -1)
                                for x in (src, dst, rel, emask))
        for b, t in enumerate(t_pos.tolist()):
            assert torch.equal(src[b], s_all[t])
            assert torch.equal(dst[b], d_all[t])
            assert torch.equal(rel[b], tr.rel[t])
            assert not bool((emask[b] & ~tr.emask[t]).any())
    return seen


def test_k1_calls_name_train_snapshots_whose_mask_they_narrow(monkeypatch):
    """Through a GRRGCN eval batch (the conv1 table, the windows' layer 2
    and the final steps), an unfused GRRGCN training batch (the windows
    and the final steps on the 50% edge subsample) and a flagship eval
    batch (both windows and the final steps), on the CPU where each window
    runs step by step: every K1 call names the snapshots its edges are in
    the data's tables of its id space, and its mask lies inside their
    static mask (a recording wrapper around K1; the models unchanged)."""
    data = to_device(_data(), "cpu")
    calls = _record(monkeypatch)
    model = get_model(TKGConfig(**GRRGCN), data, device="cpu")
    assert not model.fused_final_on() and not model.fused_window_on(True)
    params = model.init_params(0)
    t_pos, tv = [4, 1, 5], [True, True, False]
    with torch.no_grad():
        conv1 = model.precompute_eval_conv1(params, data)
        model.eval_ranks(params, data, t_pos, tv, "valid", conv1_all=conv1)
    n_eval = len(calls)
    model.loss(params, data, t_pos, tv,
               gen=torch.Generator().manual_seed(0))
    L1 = GRRGCN["train_seq_len"] - 1
    # eval: the conv1 table, layer 2 of each window step, 2 a target
    # (t_valid skips no eval target); training: 2 a window step, 2 a
    # valid target
    assert n_eval == 1 + L1 + 2 * 3
    assert len(calls) == n_eval + 2 * L1 + 2 * 2
    assert _check_calls(calls, data) == {"glob", "comp"}
    calls.clear()
    flag = get_model(TKGConfig(**FLAGSHIP), data, device="cpu")
    with torch.no_grad():
        flag.eval_ranks(flag.init_params(0), data, [3, 5], [True, True],
                        "valid")
    assert len(calls) == 2 * (2 * L1) + 2 * 2
    assert _check_calls(calls, data) == {"glob", "comp"}
