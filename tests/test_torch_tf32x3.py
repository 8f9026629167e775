"""The tolerance argument for the tensor-core products (3xTF32) of the
window's and the final step's kernels (K2f, K2b, K3-K7, K9-K11).

The backward tiles (``csrc/rgcn_gru_layer.cuh`` ``tile_product``) split
each f32 operand x into hi, x with its 13 low mantissa bits cleared, and
lo = x - hi (exact in f32), passed to the tensor core as it is: a tf32
operand's 13 low bits are not read, so the product sees lo truncated to
11 significant bits. The weight launch (``wgrad_tile``), whose sums run
over thousands of rows, rounds hi to tf32 instead (nearest, ties away, as
``cvt.rna.tf32.f32``). Each step of 8 depth terms adds lo*hi + hi*lo +
hi*hi, from zero, into an f32 accumulator. A numpy model of those
products, at the depths of the kernels' products (128: the gate and
self-loop products at d = 128; 384: the transposed gate products over 3d;
3,584: a range of K5's weight launch, whose depth is rows), is held to
float64 within 1e-6 of the largest entry, tenfold inside the smoke's 1e-5
(``SCALED_TOL``). Plain f32 (one rounded multiply-add a term, as the
forward tiles) and a single TF32 product are printed beside it. The card's
own accumulation order inside an mma is not modelled: the card's checks
(``chip_smoke.py``, ``tests/test_torch_gpu.py``) decide. Beyond the
products: the flagship's forward layer rows (K6+K7: the conv output, the
impute blend and both directions' gates and outputs in f32 from the
modelled products) and K11's rank count (scores and each target's score
by the modelled route, planted copies of target rows, ties of the band
that ``chip_smoke.py`` leaves out).
"""

import numpy as np
import pytest

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-6


def tf32(x):
    """x (float32) rounded to tf32: nearest, ties away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc13(x):
    """x (float32) with its 13 low mantissa bits cleared: tf32 by
    truncation, and what the tensor core reads of a tf32 operand."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, rounded: bool):
    """(hi, lo as the tensor core reads it) of the kernels' split."""
    hi = tf32(x) if rounded else trunc13(x)
    return hi, trunc13((x - hi).astype(np.float32))


def product_3xtf32(a, b, rounded: bool):
    """a [M, K] @ b [K, N] as the kernels compute it: per step of 8 depth
    terms the three split products, exact (float64: each is a product of
    two 11-bit significands) and rounded once to f32, added to the f32
    accumulator."""
    ahi, alo = split(a, rounded)
    bhi, blo = split(b, rounded)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        t = (alo[:, s].astype(np.float64) @ bhi[s].astype(np.float64)
             + ahi[:, s].astype(np.float64) @ blo[s].astype(np.float64)
             + ahi[:, s].astype(np.float64) @ bhi[s].astype(np.float64))
        acc = (acc + t.astype(np.float32)).astype(np.float32)
    return acc


def product_f32(a, b):
    """a @ b as one f32 multiply-add a depth term, in order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        prod = (a[:, k:k + 1].astype(np.float64) * b[k:k + 1].astype(
            np.float64) + acc).astype(np.float32)
        acc = prod
    return acc


@pytest.mark.parametrize("rounded,bound", [(False, 2.0 ** -20),
                                           (True, 2.0 ** -21)])
def test_split_keeps_21_bits(rounded, bound):
    g = np.random.default_rng(0)
    x = g.standard_normal(4096).astype(np.float32)
    hi, lo = split(x, rounded)
    # both parts are tf32 values; together they hold x to 2^-20 (hi
    # truncated) or 2^-21 (hi rounded)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(lo.view(np.uint32) & np.uint32(0x1FFF) == 0)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= bound
    assert np.abs(hi - x).max() > 0  # tf32 alone drops bits
    # ties round away from zero, as cvt.rna does
    t = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    assert tf32(t).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    assert trunc13(t).tolist() == [1.0, -1.0]


@pytest.mark.parametrize("depth,rows,cols,scale,rounded", [
    (128, 256, 64, 1.0, False),     # gate and self-loop products, d = 128
    (384, 256, 64, 1.0, False),     # d_gi @ W_ih, d_gh @ W_hh over 3d
    (3584, 64, 64, 1e-3, True),     # a range of K5's weight launch (rows)
])
def test_split_product_is_within_f32_rounding(depth, rows, cols, scale,
                                              rounded):
    g = np.random.default_rng(depth)
    a = (g.standard_normal((rows, depth)) * scale).astype(np.float32)
    # xavier-sized weights, or for the weight launch cotangent-sized rows
    b = (g.standard_normal((depth, cols)) / np.sqrt(depth)).astype(
        np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err3 = float(np.abs(product_3xtf32(a, b, rounded) - ref).max())
    err32 = float(np.abs(product_f32(a, b) - ref).max())
    err1 = float(np.abs(tf32(a).astype(np.float64) @ tf32(b) - ref).max())
    print(f"depth {depth}: 3xTF32 {err3 / big:.3e}, plain f32 "
          f"{err32 / big:.3e}, one TF32 product {err1 / big:.3e} of the "
          f"largest entry {big:.3e}")
    assert err3 <= TOL * big
    # the same order as plain f32, and far from a single TF32 product
    assert err3 <= 10 * max(err32, 1e-9 * big)
    assert err1 > 10 * err3


def mma_rz(c, prods):
    """One tensor-core step as modelled here: the f32 sum c [M, N] plus the
    exact products prods [k, M, N], each addend truncated toward zero to
    the 24-bit grid of the largest of them (alignment without guard bits),
    summed, and the sum truncated toward zero to f32. Pessimistic beside
    the card: it keeps no extra alignment bits."""
    terms = np.concatenate([c[None].astype(np.float64), prods], 0)
    top = np.abs(terms).max(0)
    grid = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    s = (np.trunc(terms / grid) * grid).sum(0)
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f).astype(
        np.float32)


def product_tc(a, b, window: int):
    """a [M, K] @ b [K, N] as the tensor-core tiles compute it (the split of
    ``split`` with hi truncated, as ``tile_product``): per step of 8 depth
    terms the products lo*hi, hi*lo and hi*hi in that order, each an mma
    step (``mma_rz``) on a running sum that starts from zero every
    `window` depth terms and is then added to the f32 accumulator with a
    rounded add."""
    ahi, alo = split(a, False)
    bhi, blo = split(b, False)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for w0 in range(0, a.shape[1], window):
        t = np.zeros_like(acc)
        for k in range(w0, min(a.shape[1], w0 + window), 8):
            s = slice(k, k + 8)
            for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                t = mma_rz(t, np.einsum("mk,kn->kmn", x[:, s].astype(
                    np.float64), y[s].astype(np.float64)))
        acc = (acc + t).astype(np.float32)
    return acc


@pytest.mark.parametrize("depth", [
    128,    # K2f's and K9+K10's self-loop and gate products at d = 128
    384,    # the bi tile's transposed products over 2d, then d, a section
])
def test_tile_accumulation_depth_keeps_f32_accuracy(depth):
    """The window's forward layer (K2f) and the flagship's bi GRU tile
    (K9+K10) compute every product with ``tile_product``: the truncated
    split and a running sum of 8 depth terms in the tensor core, then a
    rounded f32 add. Under the truncating accumulation of ``mma_rz`` that
    stays within 1e-6 of the largest entry of the float64 product; the
    tensor core's own sum over the whole depth (as one long chain of
    products into one accumulator would keep it) does not."""
    g = np.random.default_rng(depth + 1)
    a = g.standard_normal((96, depth)).astype(np.float32)
    b = (g.standard_normal((depth, 48)) / np.sqrt(depth)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err8 = float(np.abs(product_tc(a, b, 8) - ref).max())
    err_all = float(np.abs(product_tc(a, b, depth) - ref).max())
    print(f"depth {depth}: 8 terms a sum {err8 / big:.3e}, the whole depth "
          f"{err_all / big:.3e} of the largest entry {big:.3e}")
    assert err8 <= TOL * big
    assert err_all > err8


def _softmax_rows(g, rows: int, n: int, cols: int, scale: float):
    """The probability tile of K4: exp(score - lse) of `rows` queries over
    the first `cols` of n columns, float32, scaled by `scale` (d_table's
    loss weight)."""
    s = (g.standard_normal((rows, n)) * 3).astype(np.float32)
    lse = np.log(np.exp(s.astype(np.float64)).sum(1, keepdims=True))
    return (np.exp(s[:, :cols] - lse) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ["scores", "dq", "d_table"])
def test_loss_products_keep_f32_accuracy(case):
    """K3's and K4's tensor-core products (``csrc/fused_final.cu``
    ``score_product`` and ``cot_product``) use the tiles' split and 8-term
    running sums: the score tile (64 queries by 64 table rows at depth d =
    128); K4's dq = P T over one column range of the main shape (891
    columns, 14 tiles of 64 whose sums carry on in one f32 accumulator);
    and d_table = P^T Q over both directions' 256 queries (8 tiles of 64),
    P the loss-weighted probabilities. Under ``mma_rz`` each stays within
    1e-6 of the largest entry of the float64 product. The kernels take a
    k8 step's terms in another order (pairs of depth terms in slots t and
    t + 4), which the model does not see: a step sums the same 8 terms."""
    g = np.random.default_rng({"scores": 11, "dq": 12, "d_table": 13}[case])
    if case == "scores":
        a = (g.standard_normal((64, 128)) * 0.5).astype(np.float32)
        b = g.standard_normal((128, 64)).astype(np.float32)
    elif case == "dq":
        a = _softmax_rows(g, 64, 7128, 891, 1.0)
        b = g.standard_normal((891, 128)).astype(np.float32)
    else:
        a = np.ascontiguousarray(_softmax_rows(g, 512, 7128, 64,
                                               1 / 3200).T)
        b = g.standard_normal((512, 128)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err = float(np.abs(product_tc(a, b, 8) - ref).max())
    print(f"{case}: 3xTF32 {err / big:.3e} of the largest entry {big:.3e}")
    assert err <= TOL * big


def _sigmoid32(v):
    return (np.float32(1) / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _gru_rows(x, h, wih_t, whh_t, bih, bhh, route: str):
    """One GRU over rows x, h [M, d] with weights [d, 3d] and biases [3d]:
    (r, z, n, output). route "tc": as the tiles compute it
    (``gate_products``: the r and z gates one running sum over the input's
    then the state's depth, the n gate's two products apart, in
    ``product_tc``; ``gate_at``'s order of the bias adds; f32 throughout);
    "f32": the same with plain f32 products (one rounded multiply-add a
    depth term); "f64": float64."""
    d = x.shape[1]
    sl = [slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)]
    if route == "f64":
        x, h, wih_t, whh_t, bih, bhh = (v.astype(np.float64) for v in (
            x, h, wih_t, whh_t, bih, bhh))
        gi, gh = x @ wih_t + bih, h @ whh_t + bhh
        r = 1 / (1 + np.exp(-(gi[:, sl[0]] + gh[:, sl[0]])))
        z = 1 / (1 + np.exp(-(gi[:, sl[1]] + gh[:, sl[1]])))
        n = np.tanh(gi[:, sl[2]] + r * gh[:, sl[2]])
        return r, z, n, (1 - z) * n + z * h
    prod = ((lambda a, b: product_tc(a, b, 8)) if route == "tc"
            else product_f32)
    xh = np.concatenate([x, h], 1)
    acc = [prod(xh, np.concatenate([wih_t[:, s], whh_t[:, s]], 0))
           for s in sl[:2]]
    acc += [prod(x, wih_t[:, sl[2]]), prod(h, whh_t[:, sl[2]])]
    r = _sigmoid32(acc[0] + (bih[sl[0]] + bhh[sl[0]]))
    z = _sigmoid32(acc[1] + (bih[sl[1]] + bhh[sl[1]]))
    n = np.tanh((acc[2] + bih[sl[2]]) + r * (acc[3] + bhh[sl[2]]))
    return r, z, n, ((np.float32(1) - z) * n + z * h).astype(np.float32)


def _bi_rows(inputs, relu: bool, blend: bool, route: str):
    """The row part of one bi layer (K6+K7): the conv output (the SpMM rows
    plus the self-loop product times its dropout mask, then the ReLU), the
    GRU input (the impute blend on the inactive rows) and both directions'
    gates and outputs, and their sum; by `route` as ``_gru_rows``."""
    x, s, mask, loop, hf, hb, hl_f, hl_b, dt_f, dt_b, active, imp, grus = (
        inputs)
    if route == "f64":
        one = 1.0
        conv = s.astype(np.float64) + (x.astype(np.float64) @ loop) * mask
    else:
        one = np.float32(1)
        prod = product_tc(x, loop, 8) if route == "tc" else product_f32(
            x, loop)
        conv = (s + prod * mask).astype(np.float32)
    if relu:
        conv = np.maximum(conv, 0)
    gin = conv
    if blend:
        def w(i, dt):
            a = imp[i] * dt + imp[i + 1]
            return (np.exp(-np.maximum(a, 0)) * (one / 2))[:, None]

        wf, wb = w(0, dt_f), w(2, dt_b)
        blended = wf * hl_f + wb * hl_b + (one - wf - wb) * conv
        gin = np.where(active[:, None] > 0, conv, blended)
    out = {"gin": gin}
    total = 0
    for tag, h, gw in (("f", hf, grus[0]), ("b", hb, grus[1])):
        r, z, n, o = _gru_rows(gin, h, *gw, route)
        out.update({f"r_{tag}": r, f"z_{tag}": z, f"n_{tag}": n,
                    f"out_{tag}": o})
        total = total + o
    out["out"] = total
    return out


@pytest.mark.parametrize("relu,blend", [(False, False), (True, True)])
def test_bi_layer_rows_keep_f32_accuracy(relu, blend):
    """K6+K7's row part at d = 128 (layer 1: no ReLU, no blend; layer 2:
    both) from the tiles' modelled products (``conv_rows_tc``,
    ``gate_products``, in ``product_tc``'s split and 8-term running sums)
    and f32 elsewhere: the GRU input, each direction's gates and output
    and their sum, each within 1e-6 of the largest float64 entry of the
    row part (the GRU input's, which the products take) and of the order
    of plain f32's error (printed beside it). The weights and biases are
    drawn as the model initialises a GRU (U(-k, k), k = 1 / sqrt(d)), the
    self-loop at xavier scale, the states in (-1, 1) as a GRU's are, and
    the input rows unit normal, larger than either layer's (the embeddings;
    the sum of two GRU outputs)."""
    g = np.random.default_rng(21 if relu else 20)
    rows, d = 64, 128
    f = np.float32
    k = d ** -0.5

    def unif(*shape, scale=1.0):
        return ((g.random(shape) * 2 - 1) * scale).astype(f)

    keep = 0.9
    mask = ((g.random((rows, d)) < keep) / keep).astype(f)
    grus = [(unif(d, 3 * d, scale=k), unif(d, 3 * d, scale=k),
             unif(3 * d, scale=k), unif(3 * d, scale=k)) for _ in "fb"]
    inputs = (g.standard_normal((rows, d)).astype(f),
              (g.standard_normal((rows, d)) * 0.5).astype(f), mask,
              unif(d, d, scale=np.sqrt(3.0) * k), unif(rows, d),
              unif(rows, d), unif(rows, d), unif(rows, d),
              g.integers(0, 7, rows).astype(f),
              g.integers(0, 7, rows).astype(f),
              (g.random(rows) < 0.5).astype(f),
              np.array([0.3, -0.4, -0.1, 0.5], f), grus)
    got = _bi_rows(inputs, relu, blend, "tc")
    f32 = _bi_rows(inputs, relu, blend, "f32")
    ref = _bi_rows(inputs, relu, blend, "f64")
    big = max(float(np.abs(r).max()) for r in ref.values())
    for name, r in ref.items():
        err = float(np.abs(got[name].astype(np.float64) - r).max())
        err32 = float(np.abs(f32[name].astype(np.float64) - r).max())
        print(f"{name}: 3xTF32 {err / big:.3e}, plain f32 {err32 / big:.3e} "
              f"of the largest entry {big:.3e}")
        assert got[name].dtype == np.float32, name
        assert err <= TOL * big, name
        assert err <= 10 * max(err32, 1e-9 * big), name


def _ranks(scores, tgt, target, known):
    """1 + the count of the columns other than the target, the true answers
    at -1e7, whose score is strictly greater than the target's."""
    v = np.where(known, -1.0e7, scores)
    v[np.arange(len(target)), target] = -np.inf
    return 1 + (v > tgt[:, None]).sum(1)


@pytest.mark.parametrize("scale", [0.5, 0.05])
def test_rank_tile_counts_like_float64(scale):
    """K11's rank count from its modelled scores (``score_product``: the
    queries as A, the table rows as B, the split and 8-term running sums)
    for a 64-query tile against 896 columns. Each target is scored by the
    same route from a tile of the targets' rows, so copies of a target's
    row planted into columns that scored well below it tie with it
    exactly and never count; and the ranks equal float64's on every query
    whose float64 scores hold no column (other than the target, not a true
    answer) within the smoke's band (1e-5 of the row's largest |score|) of
    the target's."""
    g = np.random.default_rng(31 if scale > 0.1 else 32)
    n_q, n_c, d = 64, 896, 128
    qs = (g.standard_normal((n_q, d)) * scale).astype(np.float32)
    table = g.standard_normal((n_c, d)).astype(np.float32)
    target = g.permutation(n_c)[:n_q]
    known = g.random((n_q, n_c)) < 0.02
    known[np.arange(n_q), target] = False

    def model(tab):
        sc = product_tc(qs, np.ascontiguousarray(tab.T), 8)
        tg = np.diagonal(product_tc(qs, np.ascontiguousarray(
            tab[target].T), 8)).copy()
        return sc, tg

    sc, tg = model(table)
    ranks = _ranks(sc, tg, target, known)
    s64 = qs.astype(np.float64) @ table.astype(np.float64).T
    t64 = s64[np.arange(n_q), target]
    ranks64 = _ranks(s64, t64, target, known)
    other = ~known
    other[np.arange(n_q), target] = False
    band = 1e-5 * np.abs(s64).max(1, keepdims=True)
    near = ((np.abs(s64 - t64[:, None]) <= band) & other).any(1)
    print(f"scale {scale}: {int(near.sum())} near-ties, "
          f"{int((ranks != ranks64).sum())} ranks differ")
    assert near.sum() <= n_q // 8
    assert np.array_equal(ranks[~near], ranks64[~near])
    # the target's score by the route of a column: the same bits
    assert np.array_equal(tg, sc[np.arange(n_q), target])

    # copies of the first 16 targets' rows, 8 each, into columns that
    # scored well below that target and are no query's target or answer:
    # they score the target's bits exactly, and the ranks on the planted
    # table equal float64's there (where a copy ties exactly too) on every
    # query without a near-tie among the other columns
    planted = table.copy()
    free = np.ones(n_c, bool)
    free[target] = False
    free &= ~known.any(0)
    copy = np.zeros((n_q, n_c), bool)
    for q in range(16):
        ok = free & (s64[q] < t64[q] - 1e-3 * np.abs(s64[q]).max())
        cols = np.nonzero(ok)[0][:8]
        assert len(cols) == 8
        planted[cols] = table[target[q]]
        free[cols] = False
        copy[:, cols] = (table[target][:, None] == table[target[q]]).all(-1)
    sc_p, tg_p = model(planted)
    assert np.array_equal(tg_p, tg)
    for q in range(16):
        assert np.array_equal(sc_p[q, copy[q]], np.full(8, tg[q]))
    s64_p = qs.astype(np.float64) @ planted.astype(np.float64).T
    ranks_p = _ranks(sc_p, tg_p, target, known)
    ranks64_p = _ranks(s64_p, t64, target, known)
    near_p = ((np.abs(s64_p - t64[:, None]) <= band) & other
              & ~copy).any(1)
    assert np.array_equal(ranks_p[~near_p], ranks64_p[~near_p])
    assert not near_p[:16].all()
