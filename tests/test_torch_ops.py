"""temp_tpu_torch ops against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages. Float
results agree to 1e-5 absolute: both sides compute in float32 on values of
order one, and only the order of the sums differs. Ranks and masks are
integers and must be equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.ops import gru as jgru
from temp_tpu.ops import membership as jmem
from temp_tpu.ops import ranking as jrank
from temp_tpu.ops import scores as jscores
from temp_tpu.ops.pallas_spmm import rel_spmm_pallas
from temp_tpu.ops.segment import rel_spmm as jax_rel_spmm
from temp_tpu_torch import _build
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.ops import gru, membership, ranking, scores
from temp_tpu_torch.ops.fused_window import (
    fused_window_fwd, fused_window_supported,
)
from temp_tpu_torch.ops.segment import in_degree_norm, rel_spmm
from temp_tpu_torch.ops.spmm import build_csr, spmm_fwd, spmm_fwd_plain

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5


def _graph(rng, n, e, r, d, wdim=None):
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((r, wdim or d)).astype(np.float32)
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    rel = rng.randint(0, r, e).astype(np.int32)
    em = rng.rand(e) < 0.8
    return h, src, dst, rel, em, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,e,r,d", [(20, 60, 6, 8), (33, 7, 4, 16),
                                     (5, 0, 3, 4)])
def test_rel_spmm_diagonal_matches_reference(n, e, r, d):
    h, src, dst, rel, em, w = _graph(np.random.RandomState(n), n, e, r, d)
    ref = jax_rel_spmm(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
                       jnp.asarray(rel), jnp.asarray(em), jnp.asarray(w),
                       d, d, n, method="segment")
    out = rel_spmm(*_t(h, src, dst, rel, em, w), d, d, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_rel_spmm_block_diagonal_matches_reference():
    n, e, r, d, nb = 15, 40, 5, 8, 2
    h, src, dst, rel, em, w = _graph(np.random.RandomState(1), n, e, r, d,
                                     wdim=nb * (d // nb) ** 2)
    ref = jax_rel_spmm(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
                       jnp.asarray(rel), jnp.asarray(em), jnp.asarray(w),
                       nb, d, n)
    out = rel_spmm(*_t(h, src, dst, rel, em, w), nb, d, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_plain_matches_pallas_interpret(seed):
    """K1's plain version against the TPU kernel run in interpret mode."""
    n, e, r, d = 40, 100, 7, 16
    h, src, dst, rel, em, w = _graph(np.random.RandomState(seed), n, e, r, d)
    ref = rel_spmm_pallas(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(rel), jnp.asarray(em), jnp.asarray(w),
                          n, interpret=True)
    out = spmm_fwd_plain(*_t(h, src, dst, rel, em, w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_in_degree_norm_counts_masked_edges():
    dst = torch.tensor([0, 0, 2, 2, 2])
    em = torch.tensor([True, True, True, False, True])
    np.testing.assert_allclose(in_degree_norm(dst, em, 4).numpy(),
                               [0.5, 0.0, 0.5, 0.0])


def test_kernel_wrappers_take_plain_version_on_cpu():
    h, src, dst, rel, em, w = _t(*_graph(np.random.RandomState(2), 9, 20, 3,
                                         4))
    before = spmm_fwd.launches
    np.testing.assert_array_equal(spmm_fwd(h, src, dst, rel, em, w).numpy(),
                                  spmm_fwd_plain(h, src, dst, rel, em,
                                                 w).numpy())
    assert spmm_fwd.launches == before


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    h = torch.empty(4, 4, device="meta")
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmm_fwd(h, idx, idx, idx, idx.bool(), h)
    x = torch.empty(1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_window_fwd(x, *([None] * 13), False)


def test_build_csr_groups_edges_by_destination():
    dst = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    src = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    rowptr, s_src = build_csr(dst, 4, src)
    assert rowptr.tolist() == [0, 2, 3, 5, 5]
    assert s_src.tolist() == [11, 14, 13, 10, 12]  # stable within a row


def test_build_csr_leaves_dropped_edges_out_of_every_row():
    dst = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    src = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    keep = torch.tensor([True, False, True, True, True])
    rowptr, s_src = build_csr(dst, 4, src, keep=keep)
    assert rowptr.tolist() == [0, 1, 2, 4, 4]
    assert s_src.tolist()[:4] == [14, 13, 10, 12]
    assert s_src.tolist()[4:] == [11]  # after the last row


@pytest.mark.parametrize("num_layers", [1, 2])
def test_gru_matches_reference(num_layers):
    rng = np.random.RandomState(num_layers)
    d = 8
    params = [{k: rng.uniform(-0.4, 0.4, s).astype(np.float32)
               for k, s in (("w_ih", (3 * d, d)), ("w_hh", (3 * d, d)),
                            ("b_ih", (3 * d,)), ("b_hh", (3 * d,)))}
              for _ in range(num_layers)]
    x = rng.standard_normal((11, d)).astype(np.float32)
    h = rng.standard_normal((11, d)).astype(np.float32)
    ref = jgru.gru_stack([{k: jnp.asarray(v) for k, v in p.items()}
                          for p in params], jnp.asarray(x), jnp.asarray(h))
    out = gru.gru_stack(params_from_numpy(params, device="cpu"),
                        *_t(x, h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # torch's own GRU cell agrees on a single layer
    cell = torch.nn.GRUCell(d, d)
    with torch.no_grad():
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            getattr(cell, name.replace("w_", "weight_").replace(
                "b_", "bias_")).copy_(torch.from_numpy(params[0][name]))
        np.testing.assert_allclose(
            gru.gru_cell(params_from_numpy(params[0], device="cpu"),
                         *_t(x, h)).numpy(),
            cell(*_t(x, h)).numpy(), atol=ATOL)


def test_init_gru_params_shapes_and_range():
    p = gru.init_gru_params(torch.Generator().manual_seed(0), 6, 4, 2)
    assert [tuple(q["w_ih"].shape) for q in p] == [(12, 6), (12, 4)]
    assert float(p[0]["w_hh"].abs().max()) <= 0.5


@pytest.mark.parametrize("mode", ["tail", "head"])
def test_complex_scores_match_reference(mode):
    rng = np.random.RandomState(3)
    s, r = (rng.standard_normal((7, 12)).astype(np.float32) for _ in range(2))
    table = rng.standard_normal((19, 12)).astype(np.float32)
    ref_all = jscores.complex_all(jnp.asarray(s), jnp.asarray(r),
                                  jnp.asarray(table), mode)
    out_all = scores.complex_all(*_t(s, r, table), mode)
    np.testing.assert_allclose(out_all.numpy(), np.asarray(ref_all),
                               atol=ATOL)
    ref_single = jscores.complex_single(jnp.asarray(s), jnp.asarray(r),
                                        jnp.asarray(table[:7]))
    np.testing.assert_allclose(
        scores.complex_single(*_t(s, r, table[:7])).numpy(),
        np.asarray(ref_single), atol=ATOL)
    all_fn, single_fn = scores.get_score_fn("complex")
    assert all_fn is scores.complex_all and single_fn is scores.complex_single


def _filter_table(rng, n_grp, n, f_pad):
    pairs = np.unique(np.stack([rng.randint(0, n_grp, f_pad // 2),
                                rng.randint(0, n, f_pad // 2)], 1), axis=0)
    grp = np.full(f_pad, np.iinfo(np.int32).max, np.int32)
    val = np.full(f_pad, np.iinfo(np.int32).max, np.int32)
    grp[:len(pairs)], val[:len(pairs)] = pairs[:, 0], pairs[:, 1]
    return grp, val


def test_true_answer_mask_matches_reference():
    rng = np.random.RandomState(4)
    grp, val = _filter_table(rng, 6, 15, 32)
    q = rng.randint(0, 7, 9).astype(np.int32)
    ref = jmem.true_answer_mask(jnp.asarray(grp), jnp.asarray(val),
                                jnp.asarray(q), 15)
    out = membership.true_answer_mask(*_t(grp, val, q), 15)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_filtered_ranks_match_reference_with_ties():
    rng = np.random.RandomState(5)
    n = 15
    grp, val = _filter_table(rng, 6, n, 32)
    # scores on a coarse grid so that ties occur; ranks count only
    # strictly greater scores
    sc = rng.randint(0, 4, (9, n)).astype(np.float32)
    tgt = rng.randint(0, n, 9).astype(np.int32)
    q = rng.randint(0, 6, 9).astype(np.int32)
    ref = jrank.filtered_ranks(jnp.asarray(sc), jnp.asarray(tgt),
                               jnp.asarray(grp), jnp.asarray(val),
                               jnp.asarray(q))
    out = ranking.filtered_ranks(*_t(sc, tgt, grp, val, q))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_fused_window_envelope_is_decided_by_the_config():
    grid = TKGConfig.from_json_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "grid",
        "icews14", "config_grrgcn.json"))
    assert fused_window_supported(grid, "GRRGCN")
    assert not fused_window_supported(grid.replace(n_bases=4), "GRRGCN")
    assert not fused_window_supported(grid, "RRGCN")
    assert not fused_window_supported(grid.replace(type1=True), "GRRGCN")
    # the Bi models' ReLU on layer 2 is a mode of K2; nothing else is
    assert fused_window_supported(grid, "GRRGCN", activation2="relu")
    assert not fused_window_supported(grid, "GRRGCN", activation2="tanh")
    big = grid.replace(embed_size=512, hidden_size=512, n_bases=512)
    assert not fused_window_supported(big, "GRRGCN")


def test_ptxas_summary_keeps_register_and_spill_lines():
    text = ("ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
            "ptxas info    : Function properties for _Z3fooPf\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 40 registers, used 0 barriers\n")
    lines = _build.ptxas_summary(text).splitlines()
    assert lines == ["_Z3fooPf: 0 bytes stack frame, 0 bytes spill stores, "
                     "0 bytes spill loads",
                     "_Z3fooPf: Used 40 registers, used 0 barriers"]
    assert _build.SOURCES and all(s.endswith(".cu") for s in _build.SOURCES)
