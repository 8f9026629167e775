"""Knowledge-graph decoders: ComplEx, as a per-triple score and as scores
against the whole entity table (DistMult, TransE and SimplE are not ported
yet).

Modes: 'tail' (s, r fixed per query; candidates on o) and 'head' (r, o
fixed; candidates on s).
"""

from __future__ import annotations

import torch


def _split(x):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def complex_single(s, r, o):
    s_re, s_im = _split(s)
    r_re, r_im = _split(r)
    o_re, o_im = _split(o)
    re_sc = s_re * r_re - s_im * r_im
    im_sc = s_re * r_im + s_im * r_re
    return torch.sum(re_sc * o_re + im_sc * o_im, -1)


def complex_qhat(s, r, mode):
    """Query transform such that score[p, n] = qhat[p] . table[n]."""
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


def complex_all(s, r, o_table, mode):
    """[..., P, d] queries x [..., N, d] table -> [..., P, N]."""
    return complex_qhat(s, r, mode) @ o_table.transpose(-1, -2)


_QHAT_FNS = {complex_all: complex_qhat}


def query_for(score_all_fn, q_ent, q_rel, mode):
    """The query vector qhat [P, d] of the queries (q_ent, q_rel [P, d]),
    such that score(p, n) = qhat[p] . row[n] for the decoder
    `score_all_fn`."""
    if score_all_fn not in _QHAT_FNS:
        raise NotImplementedError("only ComplEx is ported as a table scorer")
    return _QHAT_FNS[score_all_fn](q_ent, q_rel, mode)


_ALL_FNS = {"complex": complex_all}
_SINGLE_FNS = {"complex": complex_single}


def get_score_fn(name: str):
    """Return (score_all, score_single) for a decoder name."""
    if name not in _ALL_FNS:
        raise NotImplementedError(f"score_function={name!r} is not ported "
                                  f"yet; see ROADMAP.md")
    return _ALL_FNS[name], _SINGLE_FNS[name]
