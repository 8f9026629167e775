"""The final step's bfloat16 forward layers on native bfloat16 products
(K3's layer launch in ``csrc/fused_final_bf16.cu``, which K11 makes too, and
K6+K7 in ``csrc/fused_final_bi_bf16.cu``, both on ``csrc/window_bf16.cuh``),
checked without a card.

- The host side: what the K3 and K6+K7 wrappers hand their bfloat16
  launchers (each layer's input, the self-loop, W_ih and W_hh transposed,
  the histories and local tables), read from the launch's own pointers, is
  bit for bit JAX's ``astype(jnp.bfloat16)`` of the same float32 values,
  halfway cases included; K3's layer 2 reads layer 1's float32 output so
  rounded, and both select and write float32.
- The launchers: ``final_layer_launch_bf16`` and ``bi_layer_launch_bf16``
  have as many parameters as ``_build.SIGNATURES`` declares, are in
  ``BF16_LAUNCHERS``, their float32 sources define the float32 ones for
  float32 only, and the occupancy queries know the new kernels.
- The product loops: no routine of the new kernels rounds, splits or
  multiplies in TF32, each reaches the tensor cores through the native
  routines (``tile_product_bf``), and a bfloat16 compile of
  ``rgcn_gru_layer.cuh`` has no layer tile of the TF32 design left.
- The staging K6+K7's tile adds beyond ``tile_product_bf``: the GRU input
  written at each thread's accumulator positions, modelled lane by lane
  (every element of the tile written once, the next product's ldmatrix
  reads only written elements), and the shared-memory plans of both new
  kernels.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_final_bi as fb

from test_torch_bf16_final_mma import (
    _TF32, _body, _extern_c, _f32, _float32_only, _graph, _jax_bits,
    _layer_weights, _read, _t,
)
from test_torch_slice import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF = torch.bfloat16


def _recorder(monkeypatch, grab: dict, fill=None):
    """A library whose launchers check their argument count against
    ``_build.SIGNATURES`` and, for the launchers named in `grab`, copy at
    each launch the words behind the pointer arguments it names (index ->
    (element count from the launch's B, N and d, bytes an element));
    `fill` (launcher -> (index, values)) writes float32 values behind a
    pointer at each launch of that launcher, standing in for its output.
    A null pointer is not read. Returns the copies, a list of (launcher,
    {index: uint16 or uint32 array}) in launch order."""
    calls = []

    class Recorder:
        def __getattr__(self, name):
            base = name[:-len("_bf16")] if name.endswith("_bf16") else name
            sig = _build.SIGNATURES[base]

            def launch(*args):
                assert len(args) == len(sig), name
                B, N, d = args[-4:-1]
                got = {}
                for i, (count, size) in grab.get(name, {}).items():
                    if args[i] is None:
                        continue
                    n = count(B, N, d)
                    raw = ctypes.string_at(args[i], size * n)
                    got[i] = np.frombuffer(
                        raw, np.uint16 if size == 2 else np.uint32).copy()
                if name in grab:
                    calls.append((name, got))
                if fill and name in fill:
                    i, vals = fill[name]
                    ctypes.memmove(args[i], vals.ctypes.data, vals.nbytes)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    for mod in (ff, fb):
        monkeypatch.setattr(mod, "_device", lambda name, t: "cuda")
    return calls


def _rows(B, N, d):
    return B * N * d


def _square(B, N, d):
    return d * d


def _gate(B, N, d):
    return 3 * d * d


def _f32_bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32).reshape(-1)


def _stored(t) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16).reshape(
        -1)


def test_k3_layer_operands_round_once_as_jax(monkeypatch):
    """K3's two bfloat16 layer launches read layer 1's input (the
    embeddings [N, d], expanded), layer 2's (layer 1's float32 output,
    written by the first launch), each layer's self-loop and W_ih, W_hh
    transposed ([d, 3d]) as JAX's astype(bfloat16) of the float32 values,
    the histories as stored, and the select's rows (the embeddings) in
    float32; layer 1 writes out1 and layer 2 the table, both float32."""
    d = 16
    bg, R = _graph(d)
    gr = bg.gr
    assert gr.active is not None   # layer 2 selects
    B, N = gr.dt.shape
    g = np.random.default_rng(3)
    h0 = _f32(g, N, d)
    hists = [torch.from_numpy(_f32(g, B, N, d)).to(BF) for _ in range(2)]
    (loop1, g1), (loop2, g2) = _layer_weights(g, d), _layer_weights(g, d)
    wrel = torch.from_numpy(_f32(g, R, 2 * d))
    rtab = torch.from_numpy(_f32(g, R, d))
    out1 = _f32(g, B, N, d)       # what the first launch "writes"
    calls = _recorder(
        monkeypatch,
        {"final_layer_launch_bf16": {0: (_rows, 2), 8: (_square, 2),
                                     10: (_gate, 2), 11: (_gate, 2),
                                     16: (_rows, 2), 17: (_rows, 4)}},
        fill={"final_layer_launch_bf16": (19, out1)})
    ff.fused_final_fwd(torch.from_numpy(h0), *hists, gr, wrel,
                       torch.from_numpy(loop1), torch.from_numpy(loop2),
                       _t(g1), _t(g2), rtab, hot=BF)
    assert [n for n, _ in calls] == ["final_layer_launch_bf16"] * 2
    h0x = np.broadcast_to(h0, (B, N, d))
    want = [
        {0: _jax_bits(h0x), 8: _jax_bits(loop1), 10: _jax_bits(g1["wih_t"]),
         11: _jax_bits(g1["whh_t"]), 16: _stored(hists[0])},
        {0: _jax_bits(out1), 8: _jax_bits(loop2), 10: _jax_bits(g2["wih_t"]),
         11: _jax_bits(g2["whh_t"]), 16: _stored(hists[1]),
         17: _f32_bits(h0x)}]
    for (_, got), exp in zip(calls, want):
        # layer 1 has no select: its sel_x is null
        assert set(got) == set(exp)
        for i, bits in exp.items():
            assert np.array_equal(got[i], bits), i


@pytest.mark.parametrize("layer", [1, 2])
def test_k6k7_operands_round_once_as_jax(monkeypatch, layer):
    """K6+K7's bfloat16 launch reads the layer's input, the self-loop and
    both GRUs' W_ih and W_hh transposed as JAX's astype(bfloat16) of the
    float32 values, both histories and both local tables as stored, and
    the select's rows in float32."""
    d = 16
    bg, R = _graph(d)
    gr = bg.gr
    B, N = gr.dt.shape
    g = np.random.default_rng(20 + layer)
    x = _f32(g, N, d) if layer == 1 else _f32(g, B, N, d)
    prevs = [torch.from_numpy(_f32(g, B, N, d)).to(BF) for _ in "fb"]
    loop, gf = _layer_weights(g, d)
    _, gb = _layer_weights(g, d)
    wrel = torch.from_numpy(_f32(g, R, 2 * d))
    sel = _f32(g, N, d)
    kw = {}
    grab = {0: (_rows, 2), 8: (_square, 2), 11: (_gate, 2),
            12: (_gate, 2), 15: (_gate, 2), 16: (_gate, 2), 22: (_rows, 2),
            23: (_rows, 2)}
    if layer == 2:
        hl = tuple(torch.from_numpy(_f32(g, B, N, d)).to(BF) for _ in "fb")
        kw = dict(relu=True, imp=torch.from_numpy(_f32(g, 4)), hl=hl,
                  sel=torch.from_numpy(sel))
        grab.update({25: (_rows, 2), 26: (_rows, 2), 28: (_rows, 4)})
    calls = _recorder(monkeypatch, {"bi_layer_launch_bf16": grab})
    fb.bi_layer_fwd(torch.from_numpy(x), *prevs, bg,
                    gr.m1 if layer == 1 else gr.m2, wrel,
                    0 if layer == 1 else d, torch.from_numpy(loop), _t(gf),
                    _t(gb), hot=BF, **kw)
    ((name, got),) = calls
    want = {0: _jax_bits(np.broadcast_to(x, (B, N, d))), 8: _jax_bits(loop),
            11: _jax_bits(gf["wih_t"]), 12: _jax_bits(gf["whh_t"]),
            15: _jax_bits(gb["wih_t"]), 16: _jax_bits(gb["whh_t"]),
            22: _stored(prevs[0]), 23: _stored(prevs[1])}
    if layer == 2:
        want.update({25: _stored(kw["hl"][0]), 26: _stored(kw["hl"][1]),
                     28: _f32_bits(np.broadcast_to(sel, (B, N, d)))})
    assert set(got) == set(want)
    for i, bits in want.items():
        assert np.array_equal(got[i], bits), i


@pytest.mark.parametrize("source,base,name,query,which,kernel", [
    ("fused_final_bf16.cu", "fused_final.cu", "final_layer_launch",
     "final_bf16_occupancy", 3, "final_layer_kernel"),
    ("fused_final_bi_bf16.cu", "fused_final_bi.cu", "bi_layer_launch",
     "bi_bf16_occupancy", 2, "bi_layer_kernel")])
def test_layer_launchers_match_the_build(source, base, name, query, which,
                                         kernel):
    """The bfloat16 source defines ``name_bf16`` itself (no #define onto
    its float32 source's launcher) with as many parameters as
    ``_build.SIGNATURES[name]``, in ``BF16_LAUNCHERS``; the float32 source
    defines ``name`` and its kernel for float32 only; the bfloat16 source's
    occupancy query reports the new kernel under its index."""
    src, f32_src = _read(source), _read(base)
    assert name in _build.BF16_LAUNCHERS
    assert (_extern_c(src)[f"{name}_bf16"] == _extern_c(f32_src)[name]
            == len(_build.SIGNATURES[name]))
    assert f"#define {name} " not in src
    assert _float32_only(f32_src, name)
    at = f32_src.index(f"{kernel}(")
    opened = f32_src.rfind("#if !TK_BF16", 0, at)
    assert opened >= 0 and f32_src.find("#endif", opened, at) < 0
    body = _body(src, query)
    case = body[body.index(f"case {which}:"):]
    case = case[:case.find("case ", 1) if "case " in case[1:] else None]
    assert f"occupancy({kernel}," in case


@pytest.mark.parametrize("source,fn,calls", [
    ("fused_final_bf16.cu", "final_layer_kernel", ("fwd_layer_tile_bf",)),
    ("window_bf16.cuh", "fwd_layer_tile_bf",
     ("conv_tc_bf", "gate_products_bf")),
    ("fused_final_bi_bf16.cu", "bi_layer_kernel",
     ("conv_tc_bf", "bi_direction_fwd_bf")),
    ("fused_final_bi_bf16.cu", "bi_direction_fwd_bf",
     ("gate_products_bf",))])
def test_layer_product_loops_have_no_tf32(source, fn, calls):
    """No routine of the new bfloat16 layer kernels rounds, splits or
    multiplies in TF32 or calls the float32 tiles' routines: each reaches
    the tensor cores through the native ones (the routines K2f, K5 and
    K9+K10 run), and rounds no operand per step (round_bf16)."""
    body = _body(_read(source), fn)
    for banned in _TF32 + ("fwd_layer_tile(", "round_bf16"):
        assert banned not in body, (fn, banned)
    assert re.search(r"\btile_product<", body) is None, fn
    assert re.search(r"\bgate_products\(", body) is None, fn
    for c in calls:
        assert f"{c}(" in body or f"{c}<" in body, (fn, c)


_TF32_TILES = ("load_tile", "copy_prev", "decay_prev", "tile_product",
               "conv_rows_tc", "gate_products", "fwd_layer_tile",
               "bwd_gru_tile", "bwd_input_tile", "wgrad_tile",
               "launch_bwd_tile")


def _active(src: str, macro_on: bool) -> str:
    """src with the lines a compile leaves out under #if !TK_BF16 removed
    when TK_BF16 is 1 (macro_on); the header's other conditionals kept."""
    out, skip = [], []
    for line in src.splitlines():
        s = line.strip()
        if s.startswith("#if"):
            skip.append(macro_on and s == "#if !TK_BF16")
            continue
        if s.startswith("#endif") and skip:
            skip.pop()
            continue
        if not any(skip):
            out.append(line)
    return "\n".join(out)


def test_bf16_compile_has_no_tf32_layer_tile():
    """A TK_BF16 compile of rgcn_gru_layer.cuh, fused_final.cu and
    fused_final_bi.cu defines none of the float32 layer tiles (so no
    bfloat16 layer launch can reach a TF32 product), while their float32
    compile defines every one."""
    for name in ("rgcn_gru_layer.cuh", "fused_final.cu", "fused_final_bi.cu"):
        src = _read(name)
        on, off = _active(src, True), _active(src, False)
        for fn in _TF32_TILES + ("final_layer_kernel", "bi_layer_kernel"):
            pat = (r"(?:void|cudaError_t)\s+"
                   rf"(?:__launch_bounds__\([^)]*\)\s+)?{fn}\(")
            if re.search(pat, src):
                assert re.search(pat, on) is None, (name, fn)
                assert re.search(pat, off), (name, fn)


def _const(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\w+);", _read(source))
    assert m, name
    v = m.group(1)
    return int(v) if v.isdigit() else _const("window_bf16.cuh", v)


def _acc_positions(d: int, mt: int):
    """(row, column) of every thread's accumulator positions in a tile of
    16 * mt rows and 2d threads (d / 16 warps, each 16 columns; the mma's
    C layout of acc_row / acc_col), by thread."""
    out = []
    for t in range(2 * d):
        warp, lane = divmod(t, 32)
        out.append([(m * 16 + (lane >> 2) + (8 if i >= 2 else 0),
                     warp * 16 + nt * 8 + 2 * (lane & 3) + (i & 1))
                    for m in range(mt) for nt in range(2) for i in range(4)])
    return out


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bi_fwd_tile_staging_covers_the_tile_once(d):
    """K6+K7's tile writes the GRU input (cs, over the conv output that
    conv_tc_bf wrote at the same positions) at the threads' own
    accumulator positions: modelled lane by lane, every element of the
    kBiFwdRows x d tile is written by exactly one thread, so the ldmatrix
    reads of both directions' gate products (lane l reads row l % 16,
    columns 8 (l / 16).. of each 16 x 16 block, for each m16 tile) read
    only written elements, and rows past N (the conv's zeros) are covered
    too."""
    rows = _const("fused_final_bi_bf16.cu", "kBiFwdRows")
    assert rows % 16 == 0
    flat = [p for ps in _acc_positions(d, rows // 16) for p in ps]
    assert len(flat) == len(set(flat)) == rows * d
    written = np.zeros((rows, d), bool)
    for r, c in flat:
        written[r, c] = True
    for m0 in range(0, rows, 16):
        for k0 in range(0, d, 16):
            for lane in range(32):
                r, c = m0 + (lane & 15), k0 + (lane >> 4) * 8
                assert written[r, c:c + 8].all()


def _bf_rows(rows, d):
    return rows * (d + 8) * 2


def _f32_rows(rows, d):
    return rows * (d + 4) * 4


def _ring(G, wcols, ks):
    return 3 * ks * (G * wcols + 8) * 2


def _fits(nbytes: int, blocks: int) -> bool:
    """Whether `blocks` blocks of nbytes fit an H100 SM's 228 KB of shared
    memory (1 KB reserved a block)."""
    return blocks * (nbytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bi_fwd_tile_shared_memory_plan(d):
    """The shared-memory plan of K6+K7's tile (bi_fwd_bf_smem_bytes), as
    the kernel lays it out: every region and row 16-byte aligned
    (cp.async and ldmatrix); the ring holds the gate products' three
    windows and the conv's one; the region holds the input rows with the
    float32 SpMM rows, then a direction's decayed states, and the GRU
    input lives outside it; kBiFwdBlocks blocks an SM fit; at d = 128 the
    bytes the source note gives."""
    src = "fused_final_bi_bf16.cu"
    R = _const(src, "kBiFwdRows")
    ks = _const(src, "kBiFwdKs")
    blocks = _const(src, "kBiFwdBlocks")
    ring = max(_ring(3, d, ks), _ring(1, d, 32))
    cs, xs = ring, ring + _bf_rows(R, d)
    S = xs + _bf_rows(R, d)
    ri = xs + _bf_rows(R, d) + _f32_rows(R, d)
    total = ri + 2 * R * 16
    for off in (cs, xs, S, ri, (d + 8) * 2, (d + 4) * 4):
        assert off % 16 == 0, off
    assert S + _f32_rows(R, d) <= ri and cs + _bf_rows(R, d) <= xs
    assert _fits(total, blocks)
    if d == 128:
        note = _read(src)
        assert f"{total:,} bytes at d = 128" in note


def test_k3_layer_tile_shared_memory_plan():
    """K3's bfloat16 layer launch is K2f's tile (fwd_layer_bf_smem_bytes)
    at kFinalBfWarps warps: its slab of 16 * warps columns divides d =
    128, kFinalBfBlocks blocks an SM fit, and the source note gives its
    bytes and blocks."""
    src = "fused_final_bf16.cu"
    warps = _const(src, "kFinalBfWarps")
    blocks = _const(src, "kFinalBfBlocks")
    d, rows = 128, 32
    assert d % (16 * warps) == 0
    total = (_ring(3, 16 * warps, 32) + 2 * _bf_rows(rows, d)
             + _f32_rows(rows, d) + rows * 16)
    assert _fits(total, blocks)
    assert f"{total:,}" in _read(src)
