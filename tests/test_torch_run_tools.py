"""The port's run tools against the JAX package's (CPU): the TensorBoard
event writer, preprocessing, the native data packer, the profiling helpers
and the predictions CLI (``temp_tpu_torch.test`` against the root
``test.py`` on the same weights and data).

Equal means equal: event-file bytes, preprocessed files, packed arrays and
the predictions pickle. The metrics of the predictions CLI agree within
1e-6 (ranks equal, float32 scores in another order).
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import pickle
import sys
import time

import jax
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data import native as jax_native
from temp_tpu.data import preprocess as jax_preprocess
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.train.loop import Trainer as JaxTrainer
from temp_tpu.utils import tbevents as jax_tb
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data import native
from temp_tpu_torch.data import preprocess
from temp_tpu_torch.data.quadruples import load_quadruples
from temp_tpu_torch.data.snapshots import (
    _filter_tables, _split_edges, _time_pos_lut, _to_npz, build_tkg_data,
    make_synthetic, synthetic_quads,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.test import predict
from temp_tpu_torch.train.checkpoint import save_checkpoint
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.utils import profiling, tbevents
from test_torch_preemption import TB_TAGS
from test_torch_train import _write_dataset

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- TensorBoard scalars ------------------------------------------------------

_STEPS = [(0, {"train/loss": 1.5, "val/mrr": 0.25}),
          (1, {"train/loss": 1.25, "val/mrr": 0.5, "time/eval_s": 3})]


def _write_events(mod, logdir, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    w = mod.EventWriter(str(logdir))
    for step, scalars in _STEPS:
        w.add_scalars(step, scalars)
    monkeypatch.undo()
    return w.path


def test_event_file_bytes_equal_the_jax_writers(tmp_path, monkeypatch):
    ours = _write_events(tbevents, tmp_path / "port", monkeypatch)
    ref = _write_events(jax_tb, tmp_path / "jax", monkeypatch)
    assert os.path.basename(ours) == os.path.basename(ref)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    events = jax_tb.read_scalars(ours)
    assert [e[0] for e in events] == [0, 1]
    assert events[1][1] == pytest.approx(_STEPS[1][1])
    assert tbevents.read_scalars(ref) == events
    assert tbevents.encode_scalar_event(7, {"a": 0.5}, 12.0) == \
        jax_tb.encode_scalar_event(7, {"a": 0.5}, 12.0)


def test_crc32c_check_value_and_framing():
    # crc32c("123456789") = 0xE3069283, the Castagnoli check value
    assert tbevents._crc32c(b"123456789") == 0xE3069283
    crc = tbevents._crc32c(b"abc")
    assert tbevents._masked_crc(b"abc") == (
        ((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    assert tbevents.frame_record(b"payload") == \
        jax_tb.frame_record(b"payload")


def test_fit_writes_eight_scalars_an_epoch(tmp_path):
    cfg = TKGConfig(module="SRGCN", embed_size=8, hidden_size=8, n_bases=4,
                    train_seq_len=2, batch_size=2, negative_rate=4,
                    neg_oversample=4, num_pos_facts=16)
    data = make_synthetic(num_ents=20, num_rels=3, num_times=6,
                          edges_per_time=12, edge_pad_multiple=8)
    tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data,
                 run_dir=str(tmp_path))
    out = tr.fit(max_epochs=2, log_fn=lambda *_: None)
    files = glob.glob(os.path.join(str(tmp_path), "tb",
                                   "events.out.tfevents.*"))
    assert len(files) == 1
    events = jax_tb.read_scalars(files[0])
    assert [e[0] for e in events] == [0, 1]
    for (_, scalars), rec in zip(events, out["history"]):
        assert set(scalars) == TB_TAGS
        assert scalars["val/hit_10"] == np.float32(rec["val"]["hit_10"])


# -- preprocessing ------------------------------------------------------------

def _named_dataset(path):
    rs = np.random.RandomState(4)
    names = [f"Entity {i}" for i in range(9)]
    rels = ["Make statement", "Host a visit", "Criticize"]
    os.makedirs(path)
    for split, n in (("train", 40), ("valid", 8), ("test", 8)):
        with open(os.path.join(path, f"{split}.txt"), "w") as f:
            for _ in range(n):
                day = f"2014-{rs.randint(1, 13):02d}-{rs.randint(1, 29):02d}"
                f.write(f"{names[rs.randint(9)]}\t{rels[rs.randint(3)]}\t"
                        f"{names[rs.randint(9)]}\t{day}\n")
            f.write("a short line\n")
    return str(path)


def test_preprocess_writes_the_jax_packages_files(tmp_path, monkeypatch):
    raw = _named_dataset(tmp_path / "raw")
    ref = jax_preprocess.preprocess_interpolation(raw, str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", [
        "preprocess", "--input-dir", raw, "--output-dir",
        str(tmp_path / "port")])
    preprocess.main()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "entity2id.txt", "relation2id.txt", "stat.txt", "test.txt",
        "train.txt", "valid.txt"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert ref == preprocess.preprocess_interpolation(
        raw, str(tmp_path / "again"))
    intervals = [(1990 + i % 25, 1991 + i % 30) for i in range(400)] + [
        (-1, 2001), (1995, -1)]
    for min_count in (1, 30, 300, 10000):
        classes = preprocess.bucket_years(intervals, min_count)
        assert classes == jax_preprocess.bucket_years(intervals, min_count)
        for y in (1989, 1990, 2004, 2030):
            assert preprocess.year_to_class(classes, y) == \
                jax_preprocess.year_to_class(classes, y)


# -- the native data packer ---------------------------------------------------

def _quads_file(tmp_path):
    train, _, _ = synthetic_quads(50, 6, 9, 20, seed=2)
    path = str(tmp_path / "train.txt")
    np.savetxt(path, train, fmt="%d", delimiter="\t")
    return train, path


def test_native_entry_points_match_numpy_and_jax(tmp_path):
    train, path = _quads_file(tmp_path)
    native.reset()
    got = native.parse_quads(path)
    assert native.used()
    np.testing.assert_array_equal(got, train)
    np.testing.assert_array_equal(got, jax_native.parse_quads(path))
    with native.disabled():
        native.reset()
        assert native.parse_quads(path) is None
        np.testing.assert_array_equal(
            load_quadruples(str(tmp_path), "train.txt")[0], train)
        assert not native.used()
    times = np.unique(train[:, 3])
    lut = _time_pos_lut(times)
    T, e_pad, r2 = len(times), 48, 12
    packed = native.pack_snapshots(train, lut, T, e_pad)
    with native.disabled():
        ref = _split_edges(train, times, e_pad)
        tables = _filter_tables(train, times, 6, 16)
    f_pad = tables[0].grp.shape[1]
    for a, b, c in zip(packed, (ref.src, ref.rel, ref.dst, ref.emask,
                                ref.n_edges),
                       jax_native.pack_snapshots(train, lut, T, e_pad)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for mode, table in zip(("tail", "head"), tables):
        grp, val = native.filter_pairs(train, lut, T, f_pad, mode, r2)
        np.testing.assert_array_equal(grp, table.grp)
        np.testing.assert_array_equal(val, table.val)
        jg, jv = jax_native.filter_pairs(train, lut, T, f_pad, mode, r2)
        np.testing.assert_array_equal(grp, jg)
        np.testing.assert_array_equal(val, jv)
    # errors inside a call raise: a bucket over its pad width
    with pytest.raises(ValueError):
        native.pack_snapshots(train, lut, T, 4)
    with pytest.raises(ValueError):
        native.filter_pairs(train, lut, T, 4, "tail", r2)
    with pytest.raises(OSError):
        native.parse_quads(str(tmp_path / "missing.txt"))
    late = train.copy()
    late[0, 3] = times.max() + 1  # a time value without a position
    for call in (lambda: native.pack_snapshots(late, lut, T, e_pad),
                 lambda: native.filter_pairs(late, lut, T, f_pad, "head",
                                             r2),
                 lambda: native.pack_snapshots(train[:, :3], lut, T, e_pad)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("dataset_dir", ["interpolation", "extrapolation"])
def test_build_tkg_data_with_and_without_the_library(tmp_path, dataset_dir):
    root = _write_dataset(tmp_path / "data")
    if dataset_dir == "extrapolation":
        os.symlink(os.path.join(root, "interpolation"),
                   os.path.join(root, "extrapolation"))
    cfg = TKGConfig(data_root=root, dataset="tiny", dataset_dir=dataset_dir,
                    edge_pad_multiple=16)
    native.reset()
    fast = build_tkg_data(cfg, cache=False)
    assert native.used()
    with native.disabled():
        native.reset()
        slow = build_tkg_data(cfg, cache=False)
        assert not native.used()
    a, b = _to_npz(fast), _to_npz(slow)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- profiling ----------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path, monkeypatch):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as d:
        y = (x @ x).relu().sum()
    files = glob.glob(os.path.join(d, "trace.*.json"))
    assert len(files) == 1
    trace = json.load(open(files[0]))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    # the EMA of step times on a fake clock
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    timer, emas = profiling.StepTimer(alpha=0.1), []
    for dt in (0.5, 0.25, 1.0):
        timer.start()
        clock[0] += dt
        assert timer.stop(sync_on=[y, torch.device("cpu")]) == dt
        emas.append(timer.ema)
    assert emas == pytest.approx([0.5, 0.475, 0.5275])
    assert profiling.device_memory_stats() == {}


# -- the predictions CLI ------------------------------------------------------

KW = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
          train_seq_len=4, batch_size=3, dataset="tiny",
          edge_pad_multiple=16, seed=0)


def _jax_test_cli():
    """The root test.py as a module (its name would shadow the standard
    library's ``test`` package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same seeded GRRGCN weights as a JAX run (best.ckpt) and a port
    run (best.pt) on one text dataset; JAX's test.py run on the first."""
    from temp_tpu.data.snapshots import build_tkg_data as jax_build

    tmp = tmp_path_factory.mktemp("predictions")
    root = _write_dataset(tmp / "data")
    jcfg = JaxConfig(data_root=root, **KW)
    data = jax_build(jcfg, cache=False)
    model = jax_get_model(jcfg, data)
    params = model.init_params(jax.random.PRNGKey(0))
    jax_run = str(tmp / "jax_run")
    JaxTrainer(jcfg, model, jax.device_put(data), run_dir=jax_run
               ).save_checkpoint(params, None, 0, {"mrr": 0.5})
    with open(os.path.join(jax_run, "config.json"), "w") as f:
        f.write(jcfg.to_json())
    argv = sys.argv
    sys.argv = ["test.py", "--checkpoint-path", jax_run, "--split", "test"]
    try:
        _jax_test_cli().main()
    finally:
        sys.argv = argv
    port_run = str(tmp / "port_run")
    os.makedirs(port_run)
    with open(os.path.join(port_run, "config.json"), "w") as f:
        f.write(TKGConfig(data_root=root, **KW).to_json())
    save_checkpoint(os.path.join(port_run, "checkpoints", "best.pt"),
                    params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             params),
                                      device="cpu"), None, 0, {"mrr": 0.5})
    return root, jax_run, port_run


def _load(run, split):
    with open(os.path.join(run, f"{split}_predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    return preds, json.load(open(os.path.join(run, f"{split}_metrics.json")))


def test_predictions_pickle_equals_the_jax_clis(runs, capsys):
    root, jax_run, port_run = runs
    from temp_tpu_torch.test import main

    m = main(["--checkpoint-path", port_run, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored GRRGCN (epoch 0, val mrr 0.5000)" in out
    assert "test: mrr=" in out and "queries/s" in out
    (ref, ref_m), (got, got_m) = _load(jax_run, "test"), _load(port_run,
                                                                "test")
    assert got_m == m
    assert got == ref
    assert all(type(x) is int for rec in got for x in rec[:4] + rec[5:])
    assert [r[4] for r in got[:2]] == ["head", "tail"]
    times = [r[3] for r in got]
    assert times == sorted(times)
    assert got_m["n"] == ref_m["n"] == len(got)
    for k in ("mrr", "hit_1", "hit_3", "hit_10"):
        assert abs(got_m[k] - ref_m[k]) <= 1e-6, k
    assert got_m["eval_s"] > 0


def test_predictions_cli_without_pickle_and_on_valid(runs):
    root, _, port_run = runs
    m, records, ranks, mask = predict(port_run, "valid", data_root=root,
                                      device="cpu", predictions=False,
                                      log_fn=lambda *_: None)
    assert records == [] and not os.path.exists(
        os.path.join(port_run, "valid_predictions.pkl"))
    assert json.load(open(os.path.join(port_run, "valid_metrics.json"))) == m
    # the Trainer's own sweep gives the number the early stopper sees
    cfg = TKGConfig(data_root=root, **KW)
    data = build_tkg_data(cfg)
    tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data)
    from temp_tpu_torch.train.loop import load_checkpoint_params

    _, params, _ = load_checkpoint_params(port_run, device="cpu")
    ref = tr.run_eval(params, "valid")
    assert {k: m[k] for k in ref} == ref


def test_link_prediction_analysis_reads_the_ports_pickle(runs):
    root, _, port_run = runs
    spec = importlib.util.spec_from_file_location(
        "link_prediction_analysis",
        os.path.join(ROOT, "link_prediction_analysis.py"))
    lpa = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lpa)
    preds, m = _load(port_run, "test")
    train_q, _ = load_quadruples(os.path.join(root, "interpolation", "tiny"),
                                 "train.txt")
    report, _, by_time = lpa.analyze(preds, train_q, 3)
    assert report["overall"]["all"]["n"] == m["n"]
    assert report["overall"]["all"]["mrr"] == pytest.approx(m["mrr"],
                                                            abs=1e-12)
    assert sum(len(v) for v in by_time.values()) == len(preds)
