"""GRU cells for the temporal recurrence. The model only ever runs the GRU
as a cell, sequence length 1.

- ``gru_cell``: torch ``nn.GRU`` semantics (gate order r, z, n; the reset
  gate scales ``W_hn h + b_hn``), stacked ``num_layers`` deep by
  ``gru_stack``;
- ``type1_gru_cell`` (``type1``): the reference's hand-written cell
  (models/GRU_cell.py), whose reset and input gates read the hidden state
  only.

``run_gru`` picks the one the config names. Under a hot dtype
(``TKGConfig.hot_dtype``, bfloat16) the cells' products take operands
rounded to it and sum in float32 (``_mm``)."""

from __future__ import annotations

import contextlib
import math

import torch

# the GRU parameters of a layer by window direction: the unidirectional
# models' one GRU, or the Bi models' forward and backward ones
GRU_KEY = {"fwd": "gru_fwd", "bwd": "gru_bwd", None: "gru"}


def init_gru_params(gen: torch.Generator, input_size: int, hidden_size: int,
                    num_layers: int = 1):
    """torch nn.GRU init: U(-1/sqrt(H), 1/sqrt(H)) for all weights/biases."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * k

    params = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size
        params.append({
            "w_ih": u(3 * hidden_size, in_sz),
            "w_hh": u(3 * hidden_size, hidden_size),
            "b_ih": u(3 * hidden_size),
            "b_hh": u(3 * hidden_size),
        })
    return params


# id(tensor) -> (tensor, {dtype: its roundings, one a use}, {dtype: the
# uses so far in the element}) of the operands that ``shared_rounding``
# rounds once a use
_SHARED: dict = {}


def hot_round(x, dtype):
    """x rounded to `dtype` (to nearest, ties to even, as XLA's convert) and
    back to x's dtype; x itself when dtype is None. Differentiable: the
    cotangent is rounded the same way on its way back, as the JAX
    package's convert is transposed. Inside ``shared_rounding`` the k-th
    use within an element of an operand it names gets the k-th rounding,
    shared by the k-th use of every element."""
    if dtype is None:
        return x
    hit = _SHARED.get(id(x))
    if hit is None or hit[0] is not x:
        return x.to(dtype).to(x.dtype)
    tensor, rounds, uses = hit
    k = uses.get(dtype, 0)
    uses[dtype] = k + 1
    mine = rounds.setdefault(dtype, [])
    if k == len(mine):
        mine.append(x.to(dtype).to(x.dtype))
    return mine[k]


@contextlib.contextmanager
def shared_rounding(tensors):
    """Round each of `tensors` once a use for all the elements of a loop
    inside: the operands a batch's elements share (the weights, the input
    embeddings) where the elements run one at a time. Yields
    ``next_element``, which the loop calls as each element starts: the
    k-th use of an operand within an element then takes the k-th use's
    rounding, and its cotangents from every element add up in float32 and
    are rounded once, as each product of the JAX package's vmap over the
    batch rounds the cotangent of an operand the vmap does not map (one
    product over the batch, its sum rounded once), where a rounding a use
    would round each element's part."""
    added = [id(t) for t in tensors if id(t) not in _SHARED]
    for t in tensors:
        _SHARED.setdefault(id(t), (t, {}, {}))
    entries = [_SHARED[id(t)] for t in tensors]

    def next_element():
        for entry in entries:
            entry[2].clear()

    try:
        yield next_element
    finally:
        for key in added:
            _SHARED.pop(key, None)


def _mm(x, w, dtype=None):
    """x @ w.T with optional low-precision inputs and float32 sums: the
    JAX package's ``_mm``. Both operands rounded to `dtype`, multiplied in
    float32 (a product of two bfloat16 values is exact in float32; TF32
    stays off) and returned in float32."""
    return hot_round(x, dtype) @ hot_round(w, dtype).T


def gru_cell(p, x, h, dtype=None):
    """One standard GRU step. x: [N, in], h: [N, H] -> [N, H]."""
    gi = _mm(x, p["w_ih"], dtype) + p["b_ih"]
    gh = _mm(h, p["w_hh"], dtype) + p["b_hh"]
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_stack(params, x, h0, dtype=None):
    """Multi-layer GRU, sequence length 1: every layer starts from the SAME
    initial hidden state; returns the last layer's hidden."""
    h = None
    inp = x
    for p in params:
        h = gru_cell(p, inp, h0, dtype)
        inp = h
    return h


def init_type1_gru_params(gen: torch.Generator, input_size: int,
                          hidden_size: int):
    """The reference's type1 cell init (GRU_cell.py:12-15): every weight and
    bias standard normal (torch.randn)."""

    def n(*shape):
        return torch.randn(shape, generator=gen)

    return {"w_ih": n(hidden_size, input_size),
            "w_hh": n(3 * hidden_size, hidden_size),
            "b_ih": n(hidden_size), "b_hh": n(3 * hidden_size)}


def type1_gru_cell(p, x, h, dtype=None):
    """The reference's type1 cell (GRU_cell.py:18-31), its gates from the
    hidden state only: i_n = x W_ih^T + b_ih; (h_r, h_i, h_n) = h W_hh^T +
    b_hh; new = tanh(i_n + sigmoid(h_r) h_n); h' = new + sigmoid(h_i)
    (h - new). Both products in `dtype` (``_mm``)."""
    i_n = _mm(x, p["w_ih"], dtype) + p["b_ih"]
    gh = _mm(h, p["w_hh"], dtype) + p["b_hh"]
    H = h.shape[-1]
    new = torch.tanh(i_n + torch.sigmoid(gh[..., :H]) * gh[..., 2 * H:])
    return new + torch.sigmoid(gh[..., H:2 * H]) * (h - new)


def run_gru(cfg, params, x, h0):
    """A layer's recurrence from x with initial hidden h0: its one type1
    cell under ``cfg.type1``, else its standard stack (their products in
    ``cfg.hot_dtype``)."""
    if cfg.type1:
        return type1_gru_cell(params[0], x, h0, cfg.hot_dtype)
    return gru_stack(params, x, h0, cfg.hot_dtype)
