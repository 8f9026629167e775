"""The final step's bfloat16 backward on native bfloat16 products (K5 in
``csrc/fused_final_bf16.cu``, K9+K10 in ``csrc/fused_final_bi_bf16.cu``,
both on ``csrc/window_bf16.cuh``), checked without a card.

- The host side: what the K5 and K9+K10 wrappers hand their bfloat16
  launchers (the layer's input, the self-loop and its transpose, W_ih and
  W_hh transposed and in torch's layout, the history), read from the
  launch's own pointers, is bit for bit JAX's ``astype(jnp.bfloat16)`` of
  the same float32 values, halfway cases included, in the layout each
  launcher reads.
- The launchers: each new ``extern "C"`` launcher has as many parameters
  as ``_build.SIGNATURES`` declares, is in ``BF16_LAUNCHERS`` (the
  occupancy queries, which exist in bfloat16 only, are not), and the
  float32 sources define K5's and K9+K10's launchers for float32 only.
- The product loops: no routine of the new kernels rounds, splits or
  multiplies in TF32; each reaches the tensor cores through the native
  routines (``tile_product_bf``, ``wgrad_tile_bf``).
- The staging the K9+K10 tile adds beyond ``tile_product_bf`` (whose
  fragments ``tests/test_torch_bf16_mma.py`` models lane by lane): the
  GRU input, the gate cotangents and the impute terms written at each
  thread's accumulator positions, modelled lane by lane (every element of
  the tile written once, and the ldmatrix reads of the next product read
  only written elements), and its shared-memory plan.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu_torch import _build
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, to_device,
)
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_final_bi as fb

from test_torch_slice import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF = torch.bfloat16
CSRC = os.path.dirname(_build.SOURCES[0])
DATA = dict(num_ents=40, num_rels=5, num_times=12, edges_per_time=30,
            seed=0)
T_POS = [4, 7]


def _f32(g, *shape):
    """Seeded float32 values with exact halfway points between bfloat16
    neighbours (ties to even: two round down, two up) among them."""
    x = g.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                  -(1 + 2 ** -8), 3 * 2 ** -9], np.float32)
    return x


def _jax_bits(x) -> np.ndarray:
    """JAX's astype(bfloat16) of float32 x, as 16-bit words."""
    return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)).view(
        np.uint16).reshape(-1)


def _recorder(monkeypatch, grab: dict):
    """A library whose launchers check their argument count against
    ``_build.SIGNATURES`` and, for the launchers named in `grab`, copy the
    bfloat16 words behind the pointer arguments it names (index -> element
    count, from the launch's own B, N and d) at the launch; returns the
    copies, {(launcher, index): uint16 array}."""
    got = {}

    class Recorder:
        def __getattr__(self, name):
            base = name[:-len("_bf16")] if name.endswith("_bf16") else name
            sig = _build.SIGNATURES[base]

            def launch(*args):
                assert len(args) == len(sig), name
                B, N, d = args[-4:-1]
                for i, count in grab.get(name, {}).items():
                    n = count(B, N, d)
                    got[(name, i)] = np.frombuffer(
                        ctypes.string_at(args[i], 2 * n), np.uint16).copy()
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    for mod in (ff, fb):
        monkeypatch.setattr(mod, "_device", lambda name, t: "cuda")
    return got


def _graph(d: int):
    """The flagship's final-step graph (its ``gr`` serves K5) of a small
    synthetic dataset, with dropout masks."""
    host = make_synthetic(**DATA)
    data = to_device(host, "cpu")
    answers = to_device(build_answer_lists(host), "cpu")
    gen = torch.Generator().manual_seed(2)
    B, N = len(T_POS), host.num_ents
    tp = torch.tensor(T_POS)
    em = data.train.emask[tp]
    draws = {"edges": em, "pos": em,
             "fin1": torch.rand(B, N, d, generator=gen) < 0.9,
             "fin2": torch.rand(B, N, d, generator=gen) < 0.9}
    lp = [torch.randint(0, 2, (B, N), generator=gen).float() for _ in "fb"]
    return fb.final_graph_bi(data, answers, tp, draws, lp[0], lp[1], 0.1,
                             0.1, 3, True, False), 2 * host.num_rels


def _layer_weights(g, d):
    """A layer's float32 weights: the self-loop and a GRU's (numpy)."""
    return _f32(g, d, d), {"wih_t": _f32(g, d, 3 * d),
                           "whh_t": _f32(g, d, 3 * d),
                           "bih": _f32(g, 3 * d), "bhh": _f32(g, 3 * d)}


def _t(gru):
    return {k: torch.from_numpy(v) for k, v in gru.items()}


def _rows(B, N, d):
    return B * N * d


def _square(B, N, d):
    return d * d


def _gate(B, N, d):
    return 3 * d * d


@pytest.mark.parametrize("layer", [1, 2])
def test_k5_operands_round_once_as_jax(monkeypatch, layer):
    """K5's bfloat16 launches read the layer's input (layer 1: the
    embeddings [N, d], expanded; layer 2: K3's float32 output), the
    self-loop and its transpose, W_ih and W_hh transposed ([d, 3d]) and in
    torch's layout ([3d, d]) as JAX's astype(bfloat16) of the float32
    values, and the history as stored."""
    d = 16
    bg, R = _graph(d)
    gr = bg.gr
    B, N = gr.dt.shape
    g = np.random.default_rng(layer)
    x = _f32(g, N, d) if layer == 1 else _f32(g, B, N, d)
    prev = torch.from_numpy(_f32(g, B, N, d)).to(BF)
    loop, gru = _layer_weights(g, d)
    wrel = torch.from_numpy(_f32(g, R, 2 * d))
    d_out = torch.from_numpy(_f32(g, B, N, d))
    got = _recorder(monkeypatch, {
        "final_bwd_gru_launch_bf16": {0: _rows, 8: _square, 10: _gate,
                                      11: _gate, 14: _gate, 15: _gate,
                                      18: _rows},
        "final_bwd_input_launch_bf16": {11: _square, 12: _rows},
        "final_wgrad_launch_bf16": {4: _rows}})
    mask = gr.m1 if layer == 1 else gr.m2
    ff.fused_final_bwd_layer(torch.from_numpy(x), prev, gr, mask, wrel,
                             0 if layer == 1 else d, torch.from_numpy(loop),
                             _t(gru), d_out, hot=BF)
    xb = _jax_bits(np.broadcast_to(x, (B, N, d)))
    want = {("final_bwd_gru_launch_bf16", 0): xb,
            ("final_bwd_gru_launch_bf16", 8): _jax_bits(loop),
            ("final_bwd_gru_launch_bf16", 10): _jax_bits(gru["wih_t"]),
            ("final_bwd_gru_launch_bf16", 11): _jax_bits(gru["whh_t"]),
            ("final_bwd_gru_launch_bf16", 14): _jax_bits(gru["wih_t"].T),
            ("final_bwd_gru_launch_bf16", 15): _jax_bits(gru["whh_t"].T),
            ("final_bwd_gru_launch_bf16", 18):
                prev.view(torch.int16).numpy().view(np.uint16).reshape(-1),
            ("final_bwd_input_launch_bf16", 11): _jax_bits(loop.T),
            ("final_bwd_input_launch_bf16", 12): xb,
            ("final_wgrad_launch_bf16", 4): xb}
    assert set(got) == set(want)
    for key, bits in want.items():
        assert np.array_equal(got[key], bits), key


@pytest.mark.parametrize("layer", [1, 2])
def test_k9k10_operands_round_once_as_jax(monkeypatch, layer):
    """K9+K10's bfloat16 launches read the layer's input, the self-loop
    and its transpose and both GRUs' W_ih and W_hh in both layouts as JAX's
    astype(bfloat16) of the float32 values (K5's input launch, which they
    share, the self-loop transposed and the input too)."""
    d = 16
    bg, R = _graph(d)
    gr = bg.gr
    B, N = gr.dt.shape
    g = np.random.default_rng(10 + layer)
    x = _f32(g, N, d) if layer == 1 else _f32(g, B, N, d)
    prevs = [torch.from_numpy(_f32(g, B, N, d)).to(BF) for _ in "fb"]
    loop, gf = _layer_weights(g, d)
    _, gb = _layer_weights(g, d)
    wrel = torch.from_numpy(_f32(g, R, 2 * d))
    d_out = torch.from_numpy(_f32(g, B, N, d))
    kw = {}
    if layer == 2:
        kw = dict(relu=True, imp=torch.from_numpy(_f32(g, 4)),
                  hl=tuple(torch.from_numpy(_f32(g, B, N, d)).to(BF)
                           for _ in "fb"))
    got = _recorder(monkeypatch, {
        "bi_bwd_gru_launch_bf16": {0: _rows, 8: _square,
                                   **{i: _gate for i in (11, 12, 15, 16, 19,
                                                         20, 21, 22)}},
        "final_bwd_input_launch_bf16": {11: _square, 12: _rows},
        "bi_wgrad_launch_bf16": {7: _rows}})
    fb.bi_layer_bwd(torch.from_numpy(x), *prevs, bg,
                    gr.m1 if layer == 1 else gr.m2, wrel,
                    0 if layer == 1 else d, torch.from_numpy(loop), _t(gf),
                    _t(gb), d_out, hot=BF, **kw)
    xb = _jax_bits(np.broadcast_to(x, (B, N, d)))
    gru = {11: gf["wih_t"], 12: gf["whh_t"], 15: gb["wih_t"],
           16: gb["whh_t"], 19: gf["wih_t"].T, 20: gf["whh_t"].T,
           21: gb["wih_t"].T, 22: gb["whh_t"].T}
    want = {("bi_bwd_gru_launch_bf16", 0): xb,
            ("bi_bwd_gru_launch_bf16", 8): _jax_bits(loop),
            **{("bi_bwd_gru_launch_bf16", i): _jax_bits(w)
               for i, w in gru.items()},
            ("final_bwd_input_launch_bf16", 11): _jax_bits(loop.T),
            ("final_bwd_input_launch_bf16", 12): xb,
            ("bi_wgrad_launch_bf16", 7): xb}
    assert set(got) == set(want)
    for key, bits in want.items():
        assert np.array_equal(got[key], bits), key


def _extern_c(src: str) -> dict:
    """name -> parameter count of each extern "C" function in src."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _float32_only(src: str, name: str) -> bool:
    """Whether `name`'s definition in src lies inside an #if !TK_BF16
    block (so a TK_BF16 compile of src leaves it out)."""
    at = src.index(f'extern "C" int {name}(')
    opened = src.rfind("#if !TK_BF16", 0, at)
    return opened >= 0 and src.find("#endif", opened, at) < 0


@pytest.mark.parametrize("source,base,names,query", [
    ("fused_final_bf16.cu", "fused_final.cu",
     ("final_layer_launch", "final_bwd_gru_launch",
      "final_bwd_input_launch", "final_wgrad_launch"),
     "final_bf16_occupancy"),
    ("fused_final_bi_bf16.cu", "fused_final_bi.cu",
     ("bi_layer_launch", "bi_bwd_gru_launch", "bi_wgrad_launch"),
     "bi_bf16_occupancy")])
def test_native_launchers_match_the_build(source, base, names, query):
    """K3's layer launch and K5's (K6+K7's and K9+K10's) bfloat16 source
    defines its launchers ``name_bf16`` itself with as many parameters as
    ``_build.SIGNATURES[name]``, every one in ``BF16_LAUNCHERS``, and the
    occupancy query; its float32 source defines ``name`` for float32 only
    (its TK_BF16 compile, which the bfloat16 source includes, leaves them
    out)."""
    bf = _extern_c(_read(source))
    f32_src = _read(base)
    f32 = _extern_c(f32_src)
    assert set(bf) == {f"{n}_bf16" for n in names} | {query}
    for n in names:
        assert n in _build.BF16_LAUNCHERS
        assert bf[f"{n}_bf16"] == f32[n] == len(_build.SIGNATURES[n]), n
        assert _float32_only(f32_src, n), n
        assert f"#define {n} " not in _read(source), n
    assert query not in _build.BF16_LAUNCHERS
    assert bf[query] == len(_build.SIGNATURES[query])


def _body(src: str, fn: str) -> str:
    """The text of fn's definition in src: from its name to the closing
    brace at the start of a line."""
    m = re.search(rf"\b{fn}\([^;]*?\)\s*{{", src, re.S)
    assert m, fn
    return src[m.start():src.index("\n}\n", m.start())]


_TF32 = ("split_tf32", "mma_tf32", "mma3", "tf32", "frag_a", "frag_b",
         "conv_rows_tc", "load_tile(", "copy_prev(", "decay_prev(",
         "wgrad_tile(", "bwd_gru_tile(", "bwd_input_tile(")


@pytest.mark.parametrize("source,fn,calls", [
    ("fused_final_bf16.cu", "final_bwd_gru_kernel", ("bwd_gru_tile_bf",)),
    ("fused_final_bf16.cu", "final_bwd_input_kernel",
     ("bwd_input_tile_bf",)),
    ("fused_final_bf16.cu", "final_wgrad_kernel", ("wgrad_tile_bf",)),
    ("fused_final_bi_bf16.cu", "bi_bwd_gru_kernel",
     ("conv_tc_bf", "bi_direction_bwd_bf")),
    ("fused_final_bi_bf16.cu", "bi_direction_bwd_bf",
     ("gate_products_bf", "gate_cotangent_products_bf")),
    ("fused_final_bi_bf16.cu", "bi_wgrad_kernel", ("wgrad_tile_bf",)),
    ("window_bf16.cuh", "bwd_gru_tile_bf",
     ("conv_tc_bf", "gate_products_bf", "gate_cotangent_products_bf")),
    ("window_bf16.cuh", "gate_cotangent_products_bf", ("tile_product_bf",)),
    ("window_bf16.cuh", "gate_products_bf", ("tile_product_bf",)),
    ("window_bf16.cuh", "conv_tc_bf", ("tile_product_bf",)),
    ("window_bf16.cuh", "bwd_input_tile_bf", ("tile_product_bf",))])
def test_native_product_loops_have_no_tf32(source, fn, calls):
    """No routine of K5's and K9+K10's bfloat16 kernels rounds, splits or
    multiplies in TF32 or calls the float32 tiles' routines: each reaches
    the tensor cores through the native ones (mma.sync m16n8k16 bf16 in
    ``tile_product_bf`` and ``wgrad_tile_bf``); the product routines round
    no operand per step (round_bf16) either."""
    body = _body(_read(source), fn)
    for banned in _TF32:
        assert banned not in body, (fn, banned)
    assert re.search(r"\btile_product<", body) is None, fn
    assert re.search(r"\bgate_products\(", body) is None, fn
    if fn != "bwd_input_tile_bf":   # its SpMM^T rounds as the TPU kernel's
        assert "round_bf16" not in body, fn
    for c in calls:
        assert f"{c}(" in body or f"{c}<" in body, (fn, c)


def _acc_positions(d: int):
    """(row, column) of every thread's accumulator positions in a 16-row
    tile of 2d threads (d / 16 warps, each 16 columns; the mma's C layout
    of window_bf16.cuh's acc_row / acc_col with MT = 1), by thread."""
    out = []
    for t in range(2 * d):
        warp, lane = divmod(t, 32)
        out.append([((lane >> 2) + (8 if i >= 2 else 0),
                     warp * 16 + nt * 8 + 2 * (lane & 3) + (i & 1))
                    for nt in range(2) for i in range(4)])
    return out


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bi_tile_staging_covers_the_tile_once(d):
    """K9+K10's tile writes the GRU input (cs), each gate section of the
    cotangents (dg) and the impute terms' rows at the threads' own
    accumulator positions: modelled lane by lane, every element of the 16
    x d tile is written by exactly one thread, so the ldmatrix reads of the
    next product (frag_ptr: lane l reads row l % 16, columns 8 (l / 16)..
    of each 16 x 16 block) and the row sums read only written elements,
    and rows past N (zeros of the conv) are covered too."""
    pos = _acc_positions(d)
    flat = [p for ps in pos for p in ps]
    assert len(flat) == len(set(flat)) == 16 * d
    written = np.zeros((16, d), bool)
    for r, c in flat:
        written[r, c] = True
    for k0 in range(0, d, 16):
        for lane in range(32):
            r, c = lane & 15, k0 + (lane >> 4) * 8
            assert written[r, c:c + 8].all()


def _bf_rows(rows, d):
    return rows * (d + 8) * 2


def _f32_rows(rows, d):
    return rows * (d + 4) * 4


def _ring(G, wcols, ks):
    return 3 * ks * (G * wcols + 8) * 2


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bi_tile_shared_memory_plan(d):
    """The shared-memory plan of K9+K10's tile (bi_bwd_bf_smem_bytes), as
    the kernel lays it out: every region and row 16-byte aligned (cp.async
    and ldmatrix); the region holds in turn the input rows with the
    float32 SpMM rows, the decayed states and the 4d-wide gate
    cotangents, and the GRU input lives outside it; the impute terms'
    float32 rows fit the ring; at d = 128 the 72,192 bytes the source note
    gives, three blocks in an H100 SM's 228 KB (1 KB reserved a block)."""
    R = 16
    ring = max(_ring(3, d, 16), _ring(2, d, 32))
    region = max(_bf_rows(R, d) + _f32_rows(R, d), R * (4 * d + 8) * 2)
    cs, xs = ring, ring + _bf_rows(R, d)
    S, ri = xs + _bf_rows(R, d), xs + region
    total = ri + 2 * R * 16
    for off in (cs, xs, S, ri, (d + 8) * 2, (d + 4) * 4, (4 * d + 8) * 2):
        assert off % 16 == 0, off
    assert S + _f32_rows(R, d) <= ri and xs + _bf_rows(R, d) <= ri
    assert xs + R * (4 * d + 8) * 2 <= ri and cs + _bf_rows(R, d) <= xs
    assert 2 * _f32_rows(R, d) <= ring
    # the conv's ring (one window, 32-row slots) and the gate products'
    # (three windows, 16-row slots) fit it too
    assert _ring(1, d, 32) <= ring and _ring(3, d, 16) <= ring
    if d == 128:
        assert total == 72192
        assert 3 * (total + 1024) <= 228 * 1024
        assert "72,192 bytes at d = 128" in _read("fused_final_bi_bf16.cu")
