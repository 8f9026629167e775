"""The eval slice whole: temp_tpu_torch's Trainer.run_eval against the JAX
package's on the same synthetic data and weights (CPU, float32), the import
rules of the port, and a rehearsal of chip_smoke.py's phases.

The float paths agree to about 1e-6, far from any rank-changing gap at these
seeds, so ranks must be EQUAL and MRR agree to 1e-6. Entity tables agree to
1e-5 absolute (float32 sums in another order, values of order one).
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.train.loop import Trainer as JaxTrainer
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, to_device
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.train.loop import Trainer


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
          batch_size=3, seed=0, dropout=0.0)
DATA = dict(num_ents=40, num_rels=5, num_times=12, edges_per_time=30,
            seed=3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    data = jax_synthetic(**DATA)
    cfg = JaxConfig(**KW)
    model = jax_get_model(cfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    tr = JaxTrainer(cfg, model, jax.device_put(data),
                    run_dir=str(tmp_path_factory.mktemp("ref")))
    out = {}
    for split in ("valid", "test"):
        tp, tv = tr._stack_batches(data.num_times, cfg.eval_batch, None)
        ranks, mask, _ = tr.eval_epoch(params, tr.data, tp, tv, split)
        out[split] = (np.asarray(ranks), np.asarray(mask),
                      tr.run_eval(params, split))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    table = model.forward_element(params, tr.data, 6, False,
                                  jax.random.PRNGKey(0))
    return out, np_params, np.asarray(table)


@pytest.mark.parametrize("fused_window", [False, True])
@pytest.mark.parametrize("eval_conv1", [True, False])
@pytest.mark.parametrize("split", ["valid", "test"])
def test_run_eval_matches_reference(reference, fused_window, eval_conv1,
                                    split):
    out, np_params, _ = reference
    ref_ranks, ref_mask, ref_m = out[split]
    cfg = TKGConfig(fused_window=fused_window, eval_conv1=eval_conv1, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    tr = Trainer(cfg, model, data)
    params = params_from_numpy(np_params, device="cpu")
    ranks, mask, _ = tr.eval_sweep(params, split)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ranks.numpy()[ref_mask],
                                  ref_ranks[ref_mask])
    m = tr.run_eval(params, split)
    assert m["n"] == ref_m["n"] > 0
    assert abs(m["mrr"] - ref_m["mrr"]) <= 1e-6
    for k in ("hit_1", "hit_3", "hit_10"):
        assert m[k] == ref_m[k]
    assert abs(m["loss"] - ref_m["loss"]) <= 1e-5


def test_forward_element_matches_reference(reference):
    _, np_params, ref_table = reference
    cfg = TKGConfig(**KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    table = model.forward_element(params_from_numpy(np_params, device="cpu"),
                                  to_device(data, "cpu"), 6)
    np.testing.assert_allclose(table.numpy(), ref_table, atol=1e-5)


def test_seeded_init_is_deterministic_and_shaped_like_reference(reference):
    _, np_params, _ = reference
    data = make_synthetic(**DATA)
    model = get_model(TKGConfig(**KW), data, device="cpu")
    a, b = model.init_params(5), model.init_params(5)
    leaves_a = jax.tree_util.tree_leaves(a)
    ref_shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(np_params)]
    assert [tuple(x.shape) for x in leaves_a] == ref_shapes
    for x, y in zip(leaves_a, jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)


def test_unported_configs_raise():
    data = make_synthetic(**DATA)
    # ported since: the linear-recurrence and static models, the
    # recurrent options, the other decoders and pools, the baselines,
    # TimeDynamicRGCN and the Aggregator build and initialize
    for kw, name in (({"module": "RRGCN"}, "DynamicRGCNModel"),
                     ({"module": "SRGCN"}, "StaticRGCNModel"),
                     ({"use_time_embedding": True}, "DynamicRGCNModel"),
                     ({"edge_dropout": True}, "DynamicRGCNModel"),
                     ({"rec_only_last_layer": True}, "DynamicRGCNModel"),
                     ({"score_function": "distmult"}, "DynamicRGCNModel"),
                     ({"negative_pool": "shared"}, "DynamicRGCNModel"),
                     ({"module": "DE"}, "DiachronicEmbeddingModel"),
                     ({"module": "TimeDynamicRGCN"}, "TimeDynamicRGCNModel"),
                     ({"module": "Aggregator"}, "AggregatorModel")):
        model = get_model(TKGConfig(**{**KW, **kw}), data, device="cpu")
        assert type(model).__name__ == name, kw
        model.init_params(0)
    for kw in ({"score_function": "distmult", "edge_partition": "psum",
                "mp_size": 2},
               {"negative_pool": "shared", "edge_partition": "ring",
                "mp_size": 2},
               {"module": "DE", "edge_partition": "psum", "mp_size": 2},
               {"module": "RRGCN", "edge_partition": "psum", "mp_size": 2},
               {"module": "RRGCN", "impute": True}):
        with pytest.raises(NotImplementedError):
            model = get_model(TKGConfig(**{**KW, **kw}), data, device="cpu")
            model.init_params(0)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "temp_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "temp_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {m}")
    assert not bad, bad


def test_port_builds_without_pytorch_extension_headers():
    srcs = _port_files() + [
        os.path.join(ROOT, "temp_tpu_torch", "csrc", n)
        for n in os.listdir(os.path.join(ROOT, "temp_tpu_torch", "csrc"))]
    for path in srcs:
        text = open(path).read()
        for banned in ("cpp_extension", "torch/extension.h", "ninja"):
            assert banned not in text, (path, banned)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the smoke's phases run thousands
    of tiny ops, and with every test worker's thread pool on the same
    cores each op waits on the others' threads far longer than it
    computes (about 900 s in the parallel tier-1 run, 6 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_phases_rehearse_on_cpu(one_thread):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    # fused_final on: "auto" resolves to off on the CPU, and the smoke's
    # main training path is the fused one
    ctx = chip_smoke.phase_setup("cpu", num_ents=40, num_rels=5,
                                 num_times=12, edges_per_time=30,
                                 embed_size=16, hidden_size=16, n_bases=16,
                                 train_seq_len=4, batch_size=3,
                                 num_pos_facts=20, fused_final=True)
    ctx["train_steps"] = 2
    k1 = chip_smoke.phase_k1(ctx)
    k2 = chip_smoke.phase_k2(ctx)
    path = chip_smoke.phase_path(ctx)
    k1b = chip_smoke.phase_k1b(ctx)
    k2b = chip_smoke.phase_k2b(ctx)
    k3 = chip_smoke.phase_k3(ctx)
    k4 = chip_smoke.phase_k4(ctx)
    k5 = chip_smoke.phase_k5(ctx)
    train = chip_smoke.phase_train(ctx)
    bf16_kernels = chip_smoke.phase_bf16_kernels(ctx)
    bf16_path = chip_smoke.phase_bf16_path(ctx, train, path)
    fctx = chip_smoke.phase_setup_flagship(ctx)
    fctx["train_steps"] = 2
    assert fctx["cfg"].module == "BiGRRGCN" and fctx["cfg"].impute
    res = {"k1": k1, "k2": k2, "path": path, "k1b": k1b, "k2b": k2b,
           "k3": k3, "k4": k4, "k5": k5, "train": train,
           "bf16_kernels": bf16_kernels, "bf16_path": bf16_path,
           "k2_flagship": chip_smoke.phase_k2_flagship(fctx),
           "k6k7": chip_smoke.phase_k6k7(fctx),
           "k8": chip_smoke.phase_k8(fctx),
           "k9k10": chip_smoke.phase_k9k10(fctx),
           "flagship_path": chip_smoke.phase_path(fctx),
           "flagship_train": chip_smoke.phase_train(fctx, flagship=True),
           "k11": chip_smoke.phase_k11(ctx),
           "path_fused_eval": chip_smoke.phase_path_fused_eval(ctx, path),
           "mb": chip_smoke.phase_mb(ctx, fctx),
           "k2_modes": chip_smoke.phase_k2_modes(ctx, fctx)}
    res.update(
        bf16_flagship_kernels=chip_smoke.phase_bf16_flagship_kernels(ctx,
                                                                     fctx),
        bf16_flagship_path=chip_smoke.phase_bf16_flagship_path(
            fctx, res["flagship_train"], res["flagship_path"]),
        bf16_variants=chip_smoke.phase_bf16_variants(ctx))
    res.update(bf16_k11=chip_smoke.phase_bf16_k11(ctx, bf16_path),
               bf16_mb=chip_smoke.phase_bf16_mb(ctx, fctx))
    tctx = chip_smoke.phase_setup_ted(ctx)
    tctx["train_steps"] = 2
    assert type(tctx["model"]).__name__ == "PostBiDynamicRGCNModel"
    assert tctx["cfg"].post_ensemble and tctx["cfg"].impute
    res.update(ted_path=chip_smoke.phase_ted_path(tctx),
               ted_train=chip_smoke.phase_train_unfused(tctx),
               variants=chip_smoke.phase_variants(ctx))
    res.update(chip_smoke.sa_phases(ctx, train_steps=2))
    res.update(chip_smoke.rec_phases(ctx, train_steps=2))
    res.update(chip_smoke.tdyn_phases(ctx, train_steps=2))
    res["zoo_variants"] = chip_smoke.phase_zoo_variants(ctx)
    res.update(chip_smoke.baseline_phases(ctx, train_steps=2))
    res.update(chip_smoke.agg_phases(ctx))
    ctx["parse_lines"] = 2000
    res.update(chip_smoke.run_phases(ctx))
    rctx = chip_smoke.phase_setup_ring(ctx)
    assert rctx["mesh"].placement() == "4 ranks on cpu"
    res.update(k13=chip_smoke.phase_k13(rctx),
               ring_path=chip_smoke.phase_ring_path(rctx),
               ring_train=chip_smoke.phase_ring_train(rctx))
    res.update(bf16_k13=chip_smoke.phase_bf16_k13(rctx),
               bf16_ring=chip_smoke.phase_bf16_ring(
                   rctx, res["ring_path"], res["ring_train"]))
    res.update(bf16_k1=chip_smoke.phase_bf16_k1(ctx),
               bf16_spmm_pallas=chip_smoke.phase_bf16_spmm_pallas(
                   ctx, bf16_path))
    res.update(chip_smoke.bf16_zoo_phases(ctx))
    # "auto" (bfloat16 on the card, float32 here), K1's "onehot" rounding,
    # the boundary exchange, the data axis and the flagship's partitions
    res.update(
        auto_dtype=chip_smoke.phase_auto_dtype(ctx, fctx),
        onehot_bf16=chip_smoke.phase_onehot_bf16(ctx),
        boundary=chip_smoke.phase_boundary(ctx, res["ring_path"],
                                           res["ring_train"]),
        dp_mesh=chip_smoke.phase_dp_mesh(ctx),
        flagship_partition=chip_smoke.phase_flagship_partition(
            fctx, res["flagship_path"]))
    assert res["auto_dtype"]["grrgcn"]["resolved"] == "float32"
    assert res["boundary"]["float32"]["loss_gaps"]["kernels/psum"] <= (
        chip_smoke.TRAIN_TOL)
    assert res["dp_mesh"]["placement"] == "2 x 4 ranks on cpu"
    line = chip_smoke.kernels_line(res)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in line["kernels"]] == [
        "spmm_fwd", "spmm_bwd", "fused_window_fwd", "fused_window_bwd",
        "fused_final_fwd", "fused_final_bwd_loss", "fused_final_bwd_layer",
        "bi_layer_fwd", "bi_loss_fwd", "bi_layer_bwd", "fused_eval_ranks",
        "fused_window_mb_fwd", "ring_spmm_fwd", "ring_spmm_bwd",
        "fused_window_fwd_bf16", "fused_window_bwd_bf16",
        "fused_final_fwd_bf16", "fused_final_bwd_loss_bf16",
        "fused_final_bwd_layer_bf16", "bi_layer_fwd_bf16", "bi_loss_fwd_bf16",
        "bi_layer_bwd_bf16", "fused_eval_ranks_bf16",
        "fused_window_mb_fwd_bf16", "ring_spmm_fwd_bf16",
        "ring_spmm_bwd_bf16", "spmm_fwd_bf16", "spmm_bwd_bf16",
        "spmm_fwd_onehot_bf16", "spmm_bwd_onehot_bf16"]
    assert [k["id"] for k in line["kernels"]][-8:] == [
        "K11_bf16", "K12_bf16", "K13_bf16", "K13b_bf16", "K1f_bf16",
        "K1b_bf16", "K1f_onehot_bf16", "K1b_onehot_bf16"]
    assert {"boundary_train", "bf16_boundary_eval", "dp_mesh_train",
            "flagship_boundary_eval", "flagship_ring_pallas_train"} <= set(
        line["kernels"][0]["launches_by_path"])
    # K1's bfloat16 mode at every shape of K1's phases, the attention
    # history's and the RRGCN window step's, forward and backward: the
    # plain versions against themselves on the CPU, run twice
    b1 = res["bf16_k1"]
    assert {"final", "table", "train", "sa_history", "sa_compact",
            "rrgcn_window", "bwd_train", "bwd_final", "bwd_sa_history",
            "bwd_rrgcn_window_sub"} <= set(b1)
    assert all(c["bitwise"] and c["scaled_err"] == 0.0 and c["bound_ms"] > 0
               for c in b1.values())
    assert set(line["kernels"][-4]["cases"]) == {
        t for t in b1 if not t.startswith("bwd_")} - {"final"}
    # the method "pallas" in bfloat16: GRRGCN's sweep and SARGCN's steps
    # and sweep against their plain versions; every config lifted from
    # float32-only in bfloat16, kernels against plain
    bs = res["bf16_spmm_pallas"]
    assert bs["eval_kernels"]["mrr"] == bs["eval_plain"]["mrr"]
    assert bs["sa_train"]["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert set(res["bf16_zoo"]) == {t for t, *_ in chip_smoke._BF16_ZOO}
    assert all(r["model"] for r in res["bf16_zoo"].values())
    assert set(res["bf16_baselines"]) == set(chip_smoke._BASELINE_MODULES)
    assert all(r["max_rel_gap"] == 0.0
               for r in res["bf16_baselines"].values())
    assert res["bf16_agg_train"]["gate_leaves_moved"] == 8
    assert line["kernels"][0]["id"] == "K1f"
    # the bfloat16 modes' plain versions against themselves on the CPU
    assert all(r == 0.0 for c in bf16_kernels.values()
               for r in c["rms_ratios"].values())
    assert set(bf16_kernels) == {"k2f", "k2f_train", "k2b", "k3", "k4", "k5"}
    assert bf16_path["max_rel_gaps"] == {"fused": 0.0, "unfused": 0.0}
    assert all(bf16_path["params"][k]["max_rel_gaps"][f"{k}/{pl}"] < 1e-5
               for k, pl in (("fused", "plain"),
                             ("unfused", "unfused_plain")))
    assert bf16_path["same_rank_share"] == 1.0
    for rec in line["kernels"]:
        assert keys <= set(rec)
        assert rec["max_abs_err"] == 0.0  # the CPU runs the plain version
        assert rec["launches"] == 0
        assert os.path.exists(os.path.join(ROOT, rec["source"]))
        assert rec["bound_ms"] > 0
    assert set(k2b["bwd"]["errors"]) == set(chip_smoke._COTANGENTS)
    assert set(k2b["bwd"]["scaled_errs"]) == set(chip_smoke._COTANGENTS)
    # K2f, K2b, K5 and K9+K10 run twice, bit-equal; they (and K12, on
    # K2f's launches) carry the bound of their 3xTF32 products beside the
    # f32 one
    assert k2b["bwd"]["bitwise"] and k5["bitwise"]
    assert k2b["fwd"]["bitwise"]
    assert all(k2[m]["bitwise"] for m in ("conv1_in", "recompute"))
    assert res["k9k10"]["bitwise"]
    assert all(res["k2_flagship"][d][f"{part}_bitwise"]
               for d in ("fwd", "bwd") for part in ("fwd", "bwd"))
    # K3, K4, K6+K7, K8 and K11 too; each runs twice, bit-equal
    assert all(res[k]["bitwise"] for k in ("k3", "k4", "k6k7", "k8", "k11"))
    tc_kernels = ("fused_window_fwd", "fused_window_bwd", "fused_final_fwd",
                  "fused_final_bwd_loss", "fused_final_bwd_layer",
                  "bi_layer_fwd", "bi_loss_fwd", "bi_layer_bwd",
                  "fused_eval_ranks", "fused_window_mb_fwd")
    for rec in line["kernels"]:
        assert rec["bound_share"] == rec["bound_ms"] / rec["ms"]
        tc = rec["name"] in tc_kernels
        assert ("bound_tc_ms" in rec) == tc
        if tc:
            # at this size the forward's bytes may bound it at both rates
            assert 0 < rec["bound_tc_ms"] <= rec["bound_ms"]
            assert rec["name"] == "fused_window_mb_fwd" or rec["bitwise"]
        if rec["name"] in ("fused_window_bwd", "fused_final_bwd_layer"):
            assert rec["bound_tc_ms"] < rec["bound_ms"]
    for mode in ("train_mode", "recompute_mode"):
        r = line["kernels"][2][mode]
        assert r["bitwise"] and 0 < r["bound_tc_ms"] <= r["bound_ms"]
    for k in (2, 3):
        for d in ("fwd", "bwd"):
            r = line["kernels"][k]["flagship_mode"][d]
            assert r["bitwise"] and 0 < r["bound_tc_ms"] <= r["bound_ms"]
    # the K2 flagship check differentiates the plain window through the
    # kernels' ReLU pattern, and counts where the two forwards disagree
    assert all(res["k2_flagship"][d]["relu_flips"] == 0
               for d in ("fwd", "bwd"))
    # K3's layer launches and score launch apart, and K11's layer launches
    # and rank launch: their bounds here, their times only on the card
    for k, parts in ((4, ("layers", "scores")), (10, ("layers", "ranks"))):
        for part in parts:
            r = line["kernels"][k][part]
            assert r["ms"] is None and r["bound_share"] is None
            assert 0 < r["bound_tc_ms"] <= r["bound_ms"]
    # K9+K10's GRU launch alone: its bounds here, its time only on the card
    gru = line["kernels"][9]["gru_launch"]
    assert gru["ms"] is None and gru["bound_share"] is None
    assert 0 < gru["bound_tc_ms"] <= gru["bound_ms"]
    # both layers, from the loss's cotangent and from a unit-scale one, each
    # error beside the largest entry it is held against
    assert len(k5["errors"]) == 4 * len(chip_smoke._LAYER_COTANGENTS)
    for e in list(k4["errors"].values()) + list(k5["errors"].values()):
        assert e["abs"] == 0.0 and e["max_ref"] > 0
    assert set(train["params"]["max_rel_gaps"]) == {
        "fused/plain", "fused/unfused", "unfused/plain"}
    assert train["params"]["largest_change"] > 0
    assert k5["final_step_fused_ms"] > 0 and k5["final_step_unfused_ms"] > 0
    assert path["kernels"]["mrr"] == path["plain"]["mrr"]
    assert path["same_rank_share"] == 1.0
    # K1 at its three shapes over the data's tables and sorted in the call
    assert set(k1) == {"final", "table", "train"} and set(k1b) == {
        "train", "final"}
    for rec in list(k1.values()) + list(k1b.values()):
        assert rec["bitwise"] and rec["max_abs_err"] == 0.0
        assert rec["in_call_ms"] > 0 and rec["bound_ms"] > 0
    assert ctx["k1_tables_mb"]["glob"] > 0 and ctx["k1_tables_mb"]["comp"] > 0
    for run in (path["kernels"], train["unfused"],
                res["flagship_path"]["kernels"],
                res["flagship_train"]["unfused"]):
        assert run["k1_csr_builds"] == 0
    assert {"in_call_ms", "bitwise", "table", "train"} <= set(
        line["kernels"][0])
    assert {"in_call_ms", "bitwise", "final"} <= set(line["kernels"][1])
    # the same plain forward on both paths; the updates then differ by the
    # rounding of the hand-written backward against autograd's
    assert train["fused"]["losses"][0] == train["plain"]["losses"][0]
    assert max(train["max_rel_gaps"].values()) <= chip_smoke.TRAIN_TOL
    assert len(train["fused"]["losses"]) == 2
    assert 0.0 < train["eval"]["mrr"] <= 1.0
    # the flagship's phases: both windows in the new modes, both layers'
    # forward and backward from two upstream cotangents
    assert set(res["k2_flagship"]) == {"fwd", "bwd"}
    assert all(res["k2_flagship"][d]["fwd_max_abs_err"] == 0.0
               for d in ("fwd", "bwd"))
    assert len(res["k9k10"]["errors"]) == 2 * (16 + 13)
    for e in list(res["k6k7"]["errors"].values()) + list(
            res["k9k10"]["errors"].values()):
        assert e["abs"] == 0.0
    ft = res["flagship_train"]
    assert ft["fused"]["losses"][0] == ft["plain"]["losses"][0]
    assert max(ft["max_rel_gaps"].values()) <= chip_smoke.TRAIN_TOL
    assert 0.0 < ft["eval"]["mrr"] <= 1.0
    assert res["flagship_path"]["kernels"]["mrr"] == res["flagship_path"][
        "plain"]["mrr"]
    # K11: the plain version on both sides, the planted copies not counted
    k11 = res["k11"]
    assert k11["rank_mismatches"] == 0 and k11["bce_rel_err"] == 0.0
    assert k11["planted"] == 3 and k11["planted_plain_agrees"] == 3
    assert k11["unfused_ms"] > 0
    pf = res["path_fused_eval"]
    assert pf["kernels"]["mrr"] == pf["plain"]["mrr"]
    assert pf["mrr_gap_to_path"] <= chip_smoke.MRR_TOL
    assert pf["kernels"]["n"] == path["kernels"]["n"]
    # K12: the same arithmetic as the runs without the switch
    mb = res["mb"]
    assert mb["k12"]["same_as_k2f"] and mb["k12"]["max_abs_err"] == 0.0
    assert mb["train"]["bitwise"] and mb["flagship_train"]["bitwise"]
    assert mb["eval"]["ranks_equal"]
    paths = set(line["kernels"][0]["launches_by_path"])
    assert {"eval_fused", "eval_mb", "train_fused_mb",
            "flagship_train_fused_mb", "ring_eval", "ring_train"} <= paths
    # K13: the plain version on both sides, at both shapes; the ring paths
    # agree with the unpartitioned ones on the regrouped data, walking the
    # data's tables (no sort in a call)
    for tag in ("final", "window"):
        assert res["k13"][tag]["max_abs_err"] == 0.0
        assert res["k13"][tag]["isolated_rows_zero"]
        assert res["k13"][tag]["bitwise_in_call"]
        # K13's backward is ring_spmm_bwd_plain on the CPU, held to
        # autograd through the plain ring by scaled_errs
        bwd = res["k13"][f"bwd_{tag}"]
        assert bwd["max_abs_err"] == 0.0 and len(bwd["scaled_errs"]) == 4
    assert max(res["ring_path"]["mrr_gaps"].values()) <= chip_smoke.MRR_TOL
    assert res["ring_path"]["kernels"]["csr_builds"] == 0
    rt = res["ring_train"]
    assert max(rt["max_rel_gaps"].values()) <= chip_smoke.TRAIN_TOL
    assert len(rt["ring"]["losses"]) == 2
    assert set(rt["params"]["max_rel_gaps"]) == {
        "ring/plain", "ring/unpartitioned", "unpartitioned/plain"}
    # the flagship's bfloat16 modes: K2's three (both windows where they
    # have two), K6+K7, K8, K4 on the bi table and K9+K10, the plain
    # versions against themselves on the CPU, run twice
    bfk = res["bf16_flagship_kernels"]
    modes = [m for m, *_ in chip_smoke._K2_BF16_MODES]
    assert set(modes) == {"flagship_fwd", "flagship_bwd", "a", "b_fwd",
                          "b_bwd"}
    assert set(bfk) == {f"k2_{m}_{p}" for m in modes for p in ("fwd", "bwd")
                        } | {"k6k7", "k8", "k4_bi", "k9k10"}
    for name, r in bfk.items():
        assert r["bitwise"] and r["max_abs_err"] == 0.0, name
        assert 0 < r["bound_ms"] <= r["bound_tf32_ms"], name
        if name != "k8":
            assert all(x == 0.0 for x in r["rms_ratios"].values()), name
    assert len(bfk["k9k10"]["rms_ratios"]) == 16 + 13
    assert set(bfk["k2_flagship_fwd_bwd"]["rms_ratios"]) == set(
        chip_smoke._COTANGENTS)
    assert len(bfk["k2_a_fwd"]["rms_ratios"]) == 3
    assert len(bfk["k2_b_fwd_fwd"]["rms_ratios"]) == 2
    assert bfk["k8"]["loss_rel_err"] == 0.0 and bfk["k9k10"]["relu_flips"] == 0
    bfp = res["bf16_flagship_path"]
    assert bfp["max_rel_gaps"] == {"fused": 0.0, "unfused": 0.0}
    assert all(bfp["params"][k]["max_rel_gaps"][f"{k}/{pl}"] < 1e-5
               for k, pl in (("fused", "plain"),
                             ("unfused", "unfused_plain")))
    assert bfp["same_rank_share"] == 1.0 and len(bfp["fused"]["losses"]) == 2
    assert bfp["eval_kernels"]["mrr"] == bfp["eval_plain"]["mrr"] > 0
    bv = res["bf16_variants"]
    assert {t: r["model"] for t, r in bv.items()} == {
        "ted": "PostBiDynamicRGCNModel",
        "bigrrgcn_aggregation": "PostBiDynamicRGCNModel",
        "bigrrgcn": "BiDynamicRGCNModel",
        "grrgcn_impute": "PostDynamicRGCNModel",
        "grrgcn_random_dropout": "DynamicRGCNModel",
        "grrgcn_edge_dropout": "DynamicRGCNModel"}
    for r in bv.values():
        assert r["eval"]["mrr_kernels"] == r["eval"]["mrr_plain"] > 0
        assert r["eval"]["same_rank_share"] == 1.0
        assert r["train"]["max_rel_gap"] == 0.0
        assert r["loss_gap_to_f32"] > 0
    # K11, K12, K13 and K13b in bfloat16: the plain versions on both sides,
    # run twice; the fused eval, the batched window and the ring in
    # bfloat16 held to the runs without them / their plain versions
    b11, b12, b13, bri = (res[k] for k in ("bf16_k11", "bf16_mb",
                                           "bf16_k13", "bf16_ring"))
    assert b11["rms_ratio"] == 0.0 and b11["rank_mismatches"] == 0
    assert b11["bitwise"] and max(b11["mrr_gaps"].values()) <= (
        chip_smoke.MRR_TOL)
    assert b11["layers"]["ms"] is None and b11["layers"]["bound_ms"] > 0
    for tag in ("train", "eval"):
        assert b12[tag]["bitwise"] and b12[tag]["per_element_bitwise"]
        assert b12[tag]["rms_ratio"] == 0.0
    assert b12["train_steps"]["bitwise"]
    assert b12["flagship_train_steps"]["bitwise"]
    assert b12["eval_sweep"]["ranks_equal"]
    for tag in ("final", "window", "bwd_final", "bwd_window"):
        assert b13[tag]["bitwise"] and b13[tag]["rms_ratio"] == 0.0
        assert b13[tag]["bound_ms"] > 0 and b13[tag]["library_ms"] > 0
    assert bri["max_rel_gap"] == 0.0 and bri["same_rank_share"] == 1.0
    assert bri["eval_kernels"]["csr_builds"] == 0
    assert bri["loss_gap_to_f32"] > 0
    by_name = {k["name"]: k for k in line["kernels"]}
    assert {"bf16_eval_fused", "bf16_train_fused_mb", "bf16_ring_train"} \
        <= set(by_name["ring_spmm_fwd_bf16"]["launches_by_path"])
    assert set(by_name["fused_eval_ranks_bf16"]) >= {"layers", "ranks"}
    for name in ("fused_window_fwd_bf16", "fused_window_bwd_bf16"):
        assert set(by_name[name]["flagship_modes"]) == set(modes)
    assert by_name["fused_final_bwd_loss_bf16"]["bi_table"]["bitwise"]
    for name in ("bi_layer_fwd_bf16", "bi_loss_fwd_bf16", "bi_layer_bwd_bf16",
                 "fused_window_fwd_bf16"):
        assert {"bf16_flagship_train_fused", "bf16_flagship_eval"} <= set(
            by_name[name]["launches_by_path"])
    # K2's two new modes: (a) three buffers, no ReLU; (b) two, the ReLU,
    # both windows; the plain versions on both sides, run twice
    km = res["k2_modes"]
    assert set(km) == {"a", "b_fwd", "b_bwd"}
    for mode, r in km.items():
        assert r["fwd"]["max_abs_err"] == 0.0 and r["relu_flips"] == 0
        assert r["fwd"]["bitwise"] and r["bwd"]["bitwise"]
        assert set(r["bwd"]["errors"]) == set(chip_smoke._COTANGENTS)
        assert all(e == 0.0 for e in r["bwd"]["errors"].values())
        assert ("n_buf=3" in r["shape"]) == (mode == "a")
        for part in ("fwd", "bwd"):
            assert 0 < r[part]["bound_tc_ms"] <= r[part]["bound_ms"]
    for k in (2, 3):
        extra = line["kernels"][k]["extra_modes"]
        assert set(extra) == set(km)
        assert all(m["bitwise"] and m["bound_ms"] > 0 for m in extra.values())
    # TED: its sweep (the gated eval's loss 0), its steps, the gates trained
    tp, tt = res["ted_path"], res["ted_train"]
    assert tp["kernels"]["mrr"] == tp["plain"]["mrr"] > 0
    assert tp["kernels"]["loss"] == 0.0 and tctx["freq_s"] > 0
    assert len(tt["kernels"]["losses"]) == 2
    assert tt["kernels"]["losses"][0] == tt["plain"]["losses"][0]
    assert tt["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert set(tt["params"]["max_rel_gaps"]) == {"kernels/plain"}
    assert tt["gate_leaves"] == 8 and tt["gate_leaves_moved"] == 8
    assert tt["ms_per_step"] > 0
    # the other variants, kernels against plain
    va = res["variants"]
    assert {t: r["model"] for t, r in va.items()} == {
        "grrgcn_impute_ensemble": "PostDynamicRGCNModel",
        "bigrrgcn_aggregation": "PostBiDynamicRGCNModel",
        "bigrrgcn": "BiDynamicRGCNModel"}
    for r in va.values():
        assert r["eval"]["mrr_kernels"] == r["eval"]["mrr_plain"] > 0
        assert r["eval"]["same_rank_share"] == 1.0
        assert len(r["train"]["kernels"]["losses"]) == 2
        assert r["train"]["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert va["bigrrgcn"]["train"]["gate_leaves"] == 0
    assert {"ted_eval", "ted_train", "bigrrgcn_train",
            "grrgcn_impute_ensemble_eval"} <= paths
    # the attention models: K1 at their history's shapes, their steps,
    # sweeps and variants, kernels against plain
    sk = res["sa_k1"]
    assert set(sk["fwd"]) == set(sk["bwd"]) == {
        "history", "history_edge", "compact"}
    for r in list(sk["fwd"].values()) + list(sk["bwd"].values()):
        assert r["bitwise"] and r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
    assert "B=3 " in sk["fwd"]["history"]["shape"]
    for k in (0, 1):
        assert {"sa_history", "sa_history_edge", "sa_compact",
                "rrgcn_window", "rrgcn_window_sub"} <= set(
            line["kernels"][k])
    for tag in ("sa", "bisa"):
        tr_, pa = res[f"{tag}_train"], res[f"{tag}_path"]
        assert len(tr_["kernels"]["losses"]) == 2
        assert tr_["kernels"]["losses"][0] == tr_["plain"]["losses"][0]
        assert tr_["max_rel_gap"] <= chip_smoke.TRAIN_TOL
        assert tr_["kernels"]["k1_csr_builds"] == 0
        assert pa["kernels"]["mrr"] == pa["plain"]["mrr"] > 0
        assert pa["same_rank_share"] == 1.0
        assert {f"{tag}_train", f"{tag}_eval"} <= paths
    sv = res["sa_variants"]
    assert {t: r["model"] for t, r in sv.items()} == {
        "post_sargcn": "PostSelfAttentionRGCNModel",
        "post_bisargcn": "PostBiSelfAttentionRGCNModel",
        "sargcn_compact_lambda_ema": "SelfAttentionRGCNModel"}
    for r in sv.values():
        assert r["eval"]["mrr_kernels"] == r["eval"]["mrr_plain"] > 0
        assert r["train"]["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert sv["post_sargcn"]["train"]["gate_leaves"] == 16
    # K1 at the linear recurrence's window step: the batch's graphs side
    # by side, each at its own time position
    rk = res["rrgcn_k1"]
    assert set(rk["fwd"]) == set(rk["bwd"]) == {"window", "window_sub"}
    for r in list(rk["fwd"].values()) + list(rk["bwd"].values()):
        assert r["bitwise"] and r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
    assert "B=3 " in rk["fwd"]["window"]["shape"]
    # the linear-recurrence and static models: their steps and sweeps,
    # kernels against plain, and K1's launches a step (batch 3, L1 = 3
    # here: 2 a window step and window, 2 an element)
    for tag, per in (("rrgcn", 12), ("birrgcn", 18), ("srgcn", 6)):
        tr_, pa = res[f"{tag}_train"], res[f"{tag}_path"]
        assert tr_["k1_launches_a_step"] == per
        assert len(tr_["kernels"]["losses"]) == 2
        assert tr_["kernels"]["losses"][0] == tr_["plain"]["losses"][0]
        assert tr_["max_rel_gap"] <= chip_smoke.TRAIN_TOL
        assert tr_["kernels"]["k1_csr_builds"] == 0
        assert pa["kernels"]["mrr"] == pa["plain"]["mrr"] > 0
        assert pa["same_rank_share"] == 1.0
        assert {f"{tag}_train", f"{tag}_eval"} <= paths
    # the recurrent options, each on its model and final-step path
    rv = res["rec_variants"]
    assert {t: r["model"] for t, r in rv.items()} == {
        "grrgcn_type1_lambda_temb": "DynamicRGCNModel",
        "grrgcn_rec_only": "DynamicRGCNModel",
        "grrgcn_edge_dropout": "DynamicRGCNModel",
        "grrgcn_random_dropout": "DynamicRGCNModel",
        "bigrrgcn_impute_edge_dropout": "PostBiDynamicRGCNModel",
        "bigrrgcn_aggregation_temb": "PostBiDynamicRGCNModel",
        "rrgcn_random_dropout": "DynamicRGCNModel",
        "drgcn": "DRGCNModel"}
    for r in rv.values():
        assert r["eval"]["mrr_kernels"] == r["eval"]["mrr_plain"] > 0
        assert r["eval"]["same_rank_share"] == 1.0
        assert len(r["train"]["kernels"]["losses"]) == 2
        assert r["train"]["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    drop = {t for t, r in rv.items() if "drop_rates_s" in r}
    assert drop == {"grrgcn_edge_dropout", "bigrrgcn_impute_edge_dropout"}
    assert all(rv[t]["drop_rates_s"] > 0 for t in drop)
    assert {f"{t}_{p}" for t in rv for p in ("train", "eval")} <= paths
    # TimeDynamicRGCN: its steps and sweep, kernels against plain, and the
    # launches the card must show (L1 = 3, batch 3 here)
    tt, tp = res["tdyn_train"], res["tdyn_path"]
    assert len(tt["kernels"]["losses"]) == 2
    assert tt["kernels"]["losses"][0] == tt["plain"]["losses"][0]
    assert tt["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert tp["kernels"]["mrr"] == tp["plain"]["mrr"] > 0
    assert tp["same_rank_share"] == 1.0
    assert chip_smoke.tdyn_launches({"L1": 3, "cfg": ctx["cfg"]}, 2, 4) == {
        "train": {"spmm_fwd": 12, "spmm_bwd": 12, "fused_window_fwd": 12,
                  "fused_window_bwd": 34},
        "eval": {"spmm_fwd": 4 * 2 * ctx["cfg"].eval_batch,
                 "fused_window_fwd": 24}}
    # the other decoders and pools on their models, kernels against plain
    zv = res["zoo_variants"]
    assert {t: r["model"] for t, r in zv.items()} == {
        "grrgcn_distmult": "DynamicRGCNModel",
        "grrgcn_transe": "DynamicRGCNModel",
        "grrgcn_shared": "DynamicRGCNModel",
        "grrgcn_per_query": "DynamicRGCNModel",
        "bigrrgcn_impute_transe_per_query": "PostBiDynamicRGCNModel",
        "grrgcn_ted_transe_shared": "PostDynamicRGCNModel",
        "sargcn_distmult": "SelfAttentionRGCNModel"}
    for r in zv.values():
        assert r["eval"]["mrr_kernels"] == r["eval"]["mrr_plain"] > 0
        assert r["eval"]["same_rank_share"] == 1.0
        assert len(r["train"]["kernels"]["losses"]) == 2
        assert r["train"]["kernels"]["losses"][0] == r["train"]["plain"][
            "losses"][0]
        assert r["train"]["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    # the baselines: the "card" and the CPU are one device here
    bl = res["baselines"]
    assert {m: r["model"] for m, r in bl.items()} == {
        "Static": "StaticModel", "DE": "DiachronicEmbeddingModel",
        "ATiSE": "AtiSEModel", "Hyte": "HyteModel",
        "SimplE": "SimplEModel"}
    assert bl["Hyte"]["score_function"] == "transE"
    for m, r in bl.items():
        assert r["cpu_steps"] == 2 and r["max_rel_gap"] == 0.0
        assert r["cpu_losses"] == r["train"]["losses"]
        assert r["params"]["max_rel_gaps"] == {"card/cpu": 0.0}
        assert 0.0 < r["eval"]["mrr"] <= 1.0 and r["eval"]["n"] > 0
        assert not any(r["train"]["launches"].values())
        assert {f"{m}_train", f"{m}_eval"} <= paths
    assert bl["SimplE"]["eval"]["loss"] == 0.0
    # the Aggregator: its gates trained, its submodels as loaded
    at, ap = res["agg_train"], res["agg_path"]
    assert at["gate_leaves"] == at["gate_leaves_moved"] == 8
    assert at["max_rel_gap"] <= chip_smoke.TRAIN_TOL
    assert ap["rank_diffs"] == 0 and ap["n"] > 0
    assert ap["mrr_kernels"] == ap["mrr_plain"] > 0
    assert {"agg_train", "agg_eval", "tdyn_train", "tdyn_eval",
            "grrgcn_transe_train", "Hyte_eval"} <= paths
    # the run around the model: the native data build, preemption and
    # resume in process and through the CLI, predictions, a trace
    dn = res["data_native"]
    assert dn["facts"] == 12 * 30 * 3 // 2 and dn["build_native_s"] > 0
    assert dn["gdelt_lines"] == 2000
    pr = res["preempt"]
    assert pr["bitwise"] and pr["handlers_restored"]
    assert pr["steps_an_epoch"] == 1 and pr["tb_writes"] == 6
    assert pr["save_last_s"] > 0 and len(pr["val_mrr"]) == 3
    pc = res["preempt_cli"]
    assert (pc["stopped_exit"], pc["resumed_exit"]) == (75, 0)
    assert 0 < pc["stopped_after_epochs"] < chip_smoke.CLI_EPOCHS
    pd = res["predictions"]
    assert pd["records"] == 2 * pd["facts"] == pd["kernels"]["n"] > 0
    assert pd["rank_diffs"] == pd["near_ties"] == 0
    assert pd["kernels"]["mrr"] == pd["plain"]["mrr"] == path["kernels"][
        "mrr"]
    prof = res["profiling"]
    assert prof["events"] > 0 and prof["memory"] == {}
    assert {"fit_train", "fit_eval", "predictions_eval"} <= paths


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
