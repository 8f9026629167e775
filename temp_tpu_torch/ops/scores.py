"""Knowledge-graph decoders: ComplEx, DistMult and TransE, each as a
per-triple score and as scores against a whole entity table, and SimplE's
per-triple score (SimplE is a baseline, ``models/baselines.py``, not a
decoder).

Modes: 'tail' (s, r fixed per query; candidates on o) and 'head' (r, o
fixed; candidates on s).

Every decoder reduces to a query vector against candidate rows
(``query_for``): the bilinear ones (ComplEx, DistMult) to a dot product
qhat[p] . row[n] ("dot"), TransE to -|q[p] - row[n]|_1 ("l1"), with
q = s + r for tails and q = o - r for heads. ``table_scores`` scores such
queries against every row of a table: one matrix product for "dot", and
for "l1" one ``torch.cdist`` call (TransE is plain XLA in the JAX package,
which scores it by a chunked [P, N, d] broadcast; cdist's forward keeps
no such broadcast for the backward pass).
"""

from __future__ import annotations

import torch

from temp_tpu_torch.ops.gru import hot_round


def _split(x):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


# -- per-triple scores ----------------------------------------------------

def complex_single(s, r, o):
    s_re, s_im = _split(s)
    r_re, r_im = _split(r)
    o_re, o_im = _split(o)
    re_sc = s_re * r_re - s_im * r_im
    im_sc = s_re * r_im + s_im * r_re
    return torch.sum(re_sc * o_re + im_sc * o_im, -1)


def distmult_single(s, r, o):
    return torch.sum(s * r * o, -1)


def transe_single(s, r, o):
    return -torch.sum(torch.abs(s + r - o), -1)


def simple_single(s, s_inv, r, r_inv, o, o_inv):
    """SimplE: the mean of two DistMult terms over the canonical and the
    inverse embeddings."""
    sc1 = torch.sum(s * r * o_inv, -1)
    sc2 = torch.sum(s_inv * r_inv * o, -1)
    return (sc1 + sc2) / 2


# -- query transforms: score[p, n] = qhat[p] . table[n] ---------------------

def complex_qhat(s, r, mode):
    s_re, s_im = _split(s)
    r_re, r_im = _split(r)
    if mode == "tail":
        re_sc = s_re * r_re - s_im * r_im
        im_sc = s_re * r_im + s_im * r_re
    elif mode == "head":
        # `s` plays the fixed tail o; candidates are heads
        o_re, o_im = s_re, s_im
        re_sc = r_re * o_re + r_im * o_im
        im_sc = r_re * o_im - r_im * o_re
    else:
        raise ValueError(mode)
    return torch.cat([re_sc, im_sc], dim=-1)


def distmult_qhat(s, r, mode):
    # tail: sum(s * r * cand); head: sum(cand * r * o); both s * r
    return s * r


def transe_query(s, r, mode):
    """q such that score[p, n] = -|q[p] - table[n]|_1: s + r for tails,
    o - r for heads (`s` then plays the fixed tail o)."""
    if mode == "tail":
        return s + r
    if mode == "head":
        return s - r
    raise ValueError(mode)


def l1_scores(q, table):
    """-|q[p] - table[n]|_1, [..., P, d] x [..., N, d] -> [..., P, N]."""
    return -torch.cdist(q, table, p=1)


# -- all-entity scores: [..., P, d] queries x [..., N, d] table -> [..., P, N]

def complex_all(s, r, o_table, mode):
    return complex_qhat(s, r, mode) @ o_table.transpose(-1, -2)


def distmult_all(s, r, o_table, mode):
    return distmult_qhat(s, r, mode) @ o_table.transpose(-1, -2)


def transe_all(s, r, o_table, mode):
    return l1_scores(transe_query(s, r, mode), o_table)


_ALL_FNS = {"complex": complex_all, "distmult": distmult_all,
            "transE": transe_all}
_SINGLE_FNS = {"complex": complex_single, "distmult": distmult_single,
               "transE": transe_single}
# each decoder's query vector and its kind
_QUERY_FNS = {complex_all: (complex_qhat, "dot"),
              distmult_all: (distmult_qhat, "dot"),
              transe_all: (transe_query, "l1")}


def get_score_fn(name: str):
    """Return (score_all, score_single) for a decoder name; an unknown
    name raises KeyError."""
    if name not in _ALL_FNS:
        raise KeyError(f"unknown score_function {name!r} (the decoders: "
                       f"{', '.join(_ALL_FNS)})")
    return _ALL_FNS[name], _SINGLE_FNS[name]


def query_for(score_all_fn, q_ent, q_rel, mode):
    """The queries (q_ent, q_rel [P, d]) of the decoder `score_all_fn` as
    (qvec [P, d], kind): kind "dot" means score(p, n) = qvec[p] . row[n]
    (ComplEx, DistMult), "l1" means score(p, n) = -|qvec[p] - row[n]|_1
    (TransE). ``table_scores`` and ``row_scores`` take them, so the gated
    losses work with every decoder."""
    fn, kind = _QUERY_FNS[score_all_fn]
    return fn(q_ent, q_rel, mode), kind


def table_scores(query, table, dtype=None):
    """[P, N] scores of a ``query_for`` query against every row of `table`
    [N, d]: for "dot" one product, its operands rounded to `dtype` when
    given (float32 sums, as the JAX package's ``table_scores``); "l1"
    stays float32."""
    q, kind = query
    if kind == "dot":
        return hot_round(q, dtype) @ hot_round(table, dtype).transpose(-1, -2)
    return l1_scores(q, table)


def row_scores(query, rows):
    """[P] score of each query against its own row (rows [P, d])."""
    q, kind = query
    if kind == "dot":
        return torch.sum(q * rows, -1)
    return -torch.sum(torch.abs(q - rows), -1)


def score_against_rows(score_all_fn, q_ent, q_rel, rows, mode):
    """[P, C] scores of every query against one shared set of candidate
    rows [C, d] (the ``shared`` pool's rows, or the whole table)."""
    return table_scores(query_for(score_all_fn, q_ent, q_rel, mode), rows)


def score_positive_rows(score_all_fn, q_ent, q_rel, pos_rows, mode):
    """[P] score of each query against its own positive row [P, d]."""
    return row_scores(query_for(score_all_fn, q_ent, q_rel, mode), pos_rows)


def score_candidates_all(score_all_fn, q_ent, q_rel, table, candidates,
                         mode):
    """[P, C] scores of each query's own candidates (candidates [P, C]
    long, ids into `table` [N, d]): all N entities scored, then the
    candidates' columns gathered."""
    full = table_scores(query_for(score_all_fn, q_ent, q_rel, mode), table)
    return torch.gather(full, 1, candidates.long())
