"""The whole-card route of K13 bf16 and K13b bf16 (csrc/ring_spmm_bf16.cu:
``ring_card_fwd_kernel``, ``ring_card_bwd_kernel``), emulated on the CPU.

The card's kernels cannot run here, so this file walks a small ring
layout's ``RingTables`` (4 ranks, both id spaces, three graphs at their
own time positions under a dynamic mask inside the static one) with the
index arithmetic of the CUDA source: the forward's warp of global row
r * rows + row takes owner (r + k) % m at step k, dh's warp of row v of
shard q walks the table of rank (q + 1 + k) % m, dw's warp of a relation
goes over the ranks in order and each rank's graphs in order. Each step's
or rank's sum starts from 0 and is added to the total in that order; the
values are float32 numpy sums of values rounded to bfloat16 as
``hot_round`` rounds them (h and the weights as the kernels read them, the
cotangents not).

It holds that walk bit for bit equal to an emulation of the stepped route
(``ring_spmm.cu`` with ``TK_BF16``): the shards and the dh accumulators
carried round the ring slot by slot, each step kernel's owner or shard
from its own formula, the dw partials by rank summed in rank order. Both
emulations add each term with a float32 multiply and a float32 add, where
the card's compiler may fuse the two: the card holds the two routes'
bits against each other itself (``chip_smoke.py`` bf16_k13). And it holds
the walk to ``ring_spmm_fwd_plain`` / ``ring_spmm_bwd_plain`` with
``hot=torch.bfloat16`` by the rule of tests/test_torch_bf16_k11_k12_k13.py
(RMS(walk - plain bf16) <= 0.1 RMS(plain bf16 - plain f32); that file
holds those plain versions to the JAX package's bf16 ring), norm^2
exactly. Measured here: the ratio at most 8.1e-7 for out, 1.4e-5 for dh
and 0 for dw (the plain version adds the ranks' messages and dh terms
with ``index_add`` in another order). The file takes about 15 s alone.
"""

import numpy as np
import pytest
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, ring_layout
from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.parallel.ring_spmm import (
    ring_spmm_bwd_plain, ring_spmm_fwd_plain,
)
import test_torch_ring as tr
from test_torch_bf16 import BF, RULE, _rms
from test_torch_slice import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

M = tr.M
F32 = np.float32
T_POS = (4, 1, 6)  # the graphs' time positions in the tables


def _r(x):
    """x rounded to bfloat16 and back, as ``hot_round`` does it."""
    return hot_round(torch.from_numpy(np.ascontiguousarray(x)), BF).numpy()


def _seg(ptr, key):
    return range(int(ptr[key]), int(ptr[key + 1]))


# -- the whole-card kernels' walk --------------------------------------------

def card_fwd(tab, keep, h, w):
    """ring_card_fwd_kernel: (out [B, n, d], n2 [B, n])."""
    B, n, d = h.shape
    rows = tab.rows
    hr, wr = _r(h), _r(w)
    out, n2 = np.zeros((B, n, d), F32), np.zeros((B, n), F32)
    for b, tp in enumerate(T_POS):
        for g in range(n):
            r, row = divmod(g, rows)
            ptr, edge = tab.fwd_ptr[tp, r], tab.fwd_edge[tp, r]
            tot, deg = None, 0
            for k in range(M):
                owner = (r + k) % M
                acc = np.zeros(d, F32)
                for e in _seg(ptr, owner * rows + row):
                    src, rel, slot = edge[e]
                    if keep[b, slot]:
                        deg += 1
                        acc = acc + _r(hr[b, src] * wr[rel])
                tot = acc if k == 0 else tot + acc
            norm = F32(1) / F32(deg) if deg else F32(0)
            n2[b, g] = norm * norm
            out[b, g] = tot * n2[b, g]
    return out, n2


def card_bwd(tab, keep, g, n2, h, w):
    """ring_card_bwd_kernel: (dh [B, n, d], dw [R, d]); dw warps first,
    then dh warps."""
    B, n, d = h.shape
    rows, R = tab.rows, w.shape[0]
    hr, wr = _r(h), _r(w)
    dw = np.zeros((R, d), F32)
    for rel in range(R):
        tot = np.zeros(d, F32)
        for r in range(M):
            acc = np.zeros(d, F32)
            for b, tp in enumerate(T_POS):
                ptr, edge = tab.rel_ptr[tp, r], tab.rel_edge[tp, r]
                for e in _seg(ptr, rel):
                    src, dst, slot = edge[e]
                    if keep[b, slot]:
                        acc = acc + hr[b, src] * (g[b, dst] * n2[b, dst])
            tot = tot + acc
        dw[rel] = tot
    dh = np.zeros((B, n, d), F32)
    for b, tp in enumerate(T_POS):
        for gr in range(n):
            q = gr // rows
            tot = np.zeros(d, F32)
            for k in range(M):
                r = (q + 1 + k) % M
                ptr, edge = tab.src_ptr[tp, r], tab.src_edge[tp, r]
                acc = np.zeros(d, F32)
                for e in _seg(ptr, gr):
                    dst, rel, slot = edge[e]
                    if keep[b, slot]:
                        acc = acc + (g[b, dst] * n2[b, dst]) * wr[rel]
                tot = tot + acc
            dh[b, gr] = tot
    return dh, dw


# -- the stepped route's kernels and copies ------------------------------------

def steps_fwd(tab, keep, h, w):
    """ring_fwd_step_kernel at steps k = 0 .. m - 1 on the shards rounded
    once (the wrapper's bf16 copy of h), each rank's slot receiving its
    right neighbour's shard between steps (``_rotate``)."""
    B, n, d = h.shape
    rows = tab.rows
    shards = _r(h).reshape(B, M, rows, d)
    wr = _r(w)
    visit = list(range(M))  # the shard in each rank's slot
    out, n2 = np.zeros((B, n, d), F32), np.zeros((B, n), F32)
    for k in range(M):
        if k > 0:
            visit = [visit[(r + 1) % M] for r in range(M)]
        for b, tp in enumerate(T_POS):
            for r in range(M):
                owner = (r + k) % M
                assert visit[r] == owner
                ptr, edge = tab.fwd_ptr[tp, r], tab.fwd_edge[tp, r]
                for row in range(rows):
                    acc = np.zeros(d, F32)
                    for e in _seg(ptr, owner * rows + row):
                        src, rel, slot = edge[e]
                        if keep[b, slot]:
                            hs = shards[b, visit[r], src - owner * rows]
                            acc = acc + _r(hs * wr[rel])
                    o = r * rows + row
                    scale = F32(1)
                    if k == M - 1:
                        deg = sum(int(keep[b, edge[e][2]]) for q in range(M)
                                  for e in _seg(ptr, q * rows + row))
                        norm = F32(1) / F32(deg) if deg else F32(0)
                        scale = n2[b, o] = norm * norm
                    out[b, o] = (acc if k == 0 else out[b, o] + acc) * scale
    return out, n2


def steps_bwd(tab, keep, g, n2, h, w):
    """ring_bwd_step_kernel at steps k = 0 .. m - 1, the accumulators
    passed right between steps, then ring_dw_kernel's partials by rank and
    ring_dw_reduce_kernel's sum in rank order."""
    B, n, d = h.shape
    rows, R = tab.rows, w.shape[0]
    hr, wr = _r(h), _r(w)
    dh = np.zeros((B, n, d), F32)
    for b, tp in enumerate(T_POS):
        slots, holds = None, [(r - 1) % M for r in range(M)]
        for k in range(M):
            if k > 0:  # rank r receives its left neighbour's accumulator
                slots = slots[[(r - 1) % M for r in range(M)]]
                holds = [holds[(r - 1) % M] for r in range(M)]
            nxt = np.zeros((M, rows, d), F32)
            for r in range(M):
                q = (r + M - 1 - k) % M
                assert holds[r] == q
                ptr, edge = tab.src_ptr[tp, r], tab.src_edge[tp, r]
                for v in range(rows):
                    acc = np.zeros(d, F32)
                    for e in _seg(ptr, q * rows + v):
                        dst, rel, slot = edge[e]
                        if keep[b, slot]:
                            acc = acc + (g[b, dst] * n2[b, dst]) * wr[rel]
                    nxt[r, v] = (slots[r, v] if k > 0 else F32(0)) + acc
            slots = nxt
        assert holds == list(range(M))  # each ends at its owner
        dh[b] = slots.reshape(n, d)
    part = np.zeros((M, R, d), F32)
    for r in range(M):
        for rel in range(R):
            acc = np.zeros(d, F32)
            for b, tp in enumerate(T_POS):
                ptr, edge = tab.rel_ptr[tp, r], tab.rel_edge[tp, r]
                for e in _seg(ptr, rel):
                    src, dst, slot = edge[e]
                    if keep[b, slot]:
                        acc = acc + hr[b, src] * (g[b, dst] * n2[b, dst])
            part[r, rel] = acc
    dw = np.zeros((R, d), F32)
    for r in range(M):
        dw = dw + part[r]
    return dh, dw


# -- the tests ------------------------------------------------------------------

def _rule(got, plain_bf, plain_f32, what):
    gap, yard = _rms(got - plain_bf), _rms(plain_bf - plain_f32)
    assert gap <= RULE * yard, (what, gap, yard)
    return gap / yard


@pytest.fixture(scope="module")
def ring_case():
    """The small ring layout's tables and B = len(T_POS) graphs on them,
    each space: (name, tables, src, dst, rel [B, E], dynamic mask
    [B, E], h [B, n, d], w [R, d], g [B, n, d])."""
    # denser than tr._ring_data's graphs: rows with kept in-edges from
    # three and four owners; and h's rows scaled over six decades, so that
    # the forward's sums of rounded messages round (sums of a few bf16
    # values of like size are exact in float32, in any order) and the
    # order of the steps' sums shows in the bits
    data = ring_layout(TKGConfig(edge_partition="ring_pallas", **tr.KW),
                       make_synthetic(**dict(tr.DATA, num_ents=500,
                                             edges_per_time=1500)))
    rs = np.random.RandomState(11)
    tp = list(T_POS)
    static = np.asarray(data.train.emask)[tp]
    keep = static & (rs.rand(*static.shape) < 0.7)
    R, d = 2 * data.num_rels, 8
    cases = []
    for name, tab, src, dst, rel in tr._spaces(data):
        n = M * tab.rows
        scale = 10.0 ** rs.uniform(-3, 3, (len(tp), n, 1))
        cases.append((name, tab, *(np.asarray(x)[tp] for x in
                                   (src, dst, rel)), keep,
                      (rs.randn(len(tp), n, d) * scale).astype(F32),
                      rs.randn(R, d).astype(F32),
                      rs.randn(len(tp), n, d).astype(F32)))
    return cases


def test_card_walk_equals_the_stepped_route_bit_for_bit(ring_case):
    """Forward and backward: the whole-card walk's out, norm^2, dh and dw
    equal the stepped route's bit for bit, in both id spaces; rows without
    kept in-edges come out 0, and rows with three or more kept in-edges
    exist (so the order of the steps' sums shows in the bits)."""
    for name, tab, _, dst, _, keep, h, w, g in ring_case:
        out, n2 = card_fwd(tab, keep, h, w)
        s_out, s_n2 = steps_fwd(tab, keep, h, w)
        assert np.array_equal(out.view(np.uint32), s_out.view(np.uint32)), \
            name
        assert np.array_equal(n2, s_n2), name
        fed = np.zeros(n2.shape, bool)
        for b in range(len(T_POS)):
            fed[b, dst[b][keep[b]]] = True
        assert (out[~fed] == 0).all() and (n2[~fed] == 0).all(), name
        assert (n2 > 0).sum() > 0 and ((n2 > 0) & (n2 < 0.25)).any(), name
        dh, dw = card_bwd(tab, keep, g, n2, h, w)
        s_dh, s_dw = steps_bwd(tab, keep, g, n2, h, w)
        assert np.array_equal(dh.view(np.uint32), s_dh.view(np.uint32)), \
            name
        assert np.array_equal(dw.view(np.uint32), s_dw.view(np.uint32)), \
            name


def test_card_walk_matches_the_plain_versions(ring_case):
    """The whole-card walk against ``ring_spmm_fwd_plain`` and
    ``ring_spmm_bwd_plain`` with hot=torch.bfloat16 on 4 CPU ranks: out,
    dh and dw by the rule (the plain float32 versions the yardstick),
    norm^2 exactly."""
    ratios = {}
    for name, tab, src, dst, rel, keep, h, w, g in ring_case:
        args = [torch.from_numpy(x) for x in (h, w, src, dst, rel, keep)]
        ring = (M, tab.rows, tr.CPU4)
        pb, n2p = ring_spmm_fwd_plain(*args, *ring, hot=BF)
        pf, _ = ring_spmm_fwd_plain(*args, *ring)
        out, n2 = card_fwd(tab, keep, h, w)
        assert np.array_equal(n2, n2p.numpy()), name
        ratios[f"{name} out"] = _rule(out, pb.numpy(), pf.numpy(), name)
        tg, tn2 = torch.from_numpy(g), torch.from_numpy(n2)
        bh, bw = ring_spmm_bwd_plain(tg, tn2, *args, *ring, hot=BF)
        fh, fw = ring_spmm_bwd_plain(tg, tn2, *args, *ring)
        dh, dw = card_bwd(tab, keep, g, n2, h, w)
        ratios[f"{name} dh"] = _rule(dh, bh.numpy(), fh.numpy(), name)
        ratios[f"{name} dw"] = _rule(dw, bw.numpy(), fw.numpy(), name)
    assert max(ratios.values()) <= 2e-5, ratios
