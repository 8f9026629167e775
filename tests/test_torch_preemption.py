"""Preemption and resume of the port's Trainer and CLI (CPU, tiny; the
JAX package's counterpart is tests/test_preemption.py).

A SIGTERM or SIGUSR1 during ``Trainer.fit`` saves the last training state
(params, optimizer, early-stop counters) to checkpoints/last.pt at the end
of that epoch and leaves the loop; ``load_last`` resumes it, and since
every epoch's randomness comes from (seed, epoch, step) alone, the resumed
run replays the uninterrupted one bit for bit. The CLI exits 75 after a
stop and 0 after the resumed run.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import param_leaves
from temp_tpu_torch.utils.tbevents import read_scalars
from test_torch_train import _write_dataset

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TB_TAGS = {"train/loss", "val/mrr", "val/hit_1", "val/hit_3", "val/hit_10",
           "val/loss", "time/train_s", "time/eval_s"}


def small_cfg(**kw):
    base = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=4,
                train_seq_len=4, batch_size=3, negative_rate=8,
                neg_oversample=8, num_pos_facts=100, patience=50, seed=11)
    base.update(kw)
    return TKGConfig(**base)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(num_ents=30, num_rels=4, num_times=10,
                          edges_per_time=25, edge_pad_multiple=16)


def _trainer(cfg, data, run_dir):
    return Trainer(cfg, get_model(cfg, data, device="cpu"), data,
                   run_dir=str(run_dir))


def _opt_tensors(optimizer):
    return [t for st in optimizer.state_dict()["state"].values()
            for t in st.values()]


def test_sigterm_resume_matches_uninterrupted(data, tmp_path):
    cfg = small_cfg()
    tr_a = _trainer(cfg, data, tmp_path / "control")
    out_a = tr_a.fit(max_epochs=4, log_fn=lambda *_: None)
    assert not out_a["preempted"] and out_a["last_epoch"] == 3
    assert not os.path.exists(tr_a.last_ckpt_path())

    # SIGTERM lands after epoch 1's line: the state is saved, the loop ends
    tr_b = _trainer(cfg, data, tmp_path / "interrupted")
    lines = []

    def kill_after_epoch1(msg):
        lines.append(msg)
        if msg.startswith("epoch 1:"):
            os.kill(os.getpid(), signal.SIGTERM)

    out_b = tr_b.fit(max_epochs=4, log_fn=kill_after_epoch1)
    assert out_b["preempted"] and out_b["last_epoch"] == 1
    assert os.path.exists(tr_b.last_ckpt_path())
    assert lines[-1] == (f"preempted at epoch 1: training state saved to "
                         f"{tr_b.last_ckpt_path()}; rerun with --resume")

    # the resumed run replays epochs 2 and 3
    tr_c = _trainer(cfg, data, tmp_path / "interrupted")
    params, optimizer, start_epoch, best = tr_c.load_last()
    assert start_epoch == 2 and best == (out_b["best_mrr"],
                                         out_b["best_epoch"])
    out_c = tr_c.fit(params, optimizer, max_epochs=4,
                     start_epoch=start_epoch, best=best,
                     log_fn=lambda *_: None)
    assert not out_c["preempted"] and out_c["last_epoch"] == 3
    assert not os.path.exists(tr_c.last_ckpt_path())
    assert out_c["best_mrr"] == pytest.approx(out_a["best_mrr"], abs=0)
    assert out_c["best_epoch"] == out_a["best_epoch"]
    for x, y in zip(param_leaves(out_a["params"]),
                    param_leaves(out_c["params"])):
        assert torch.equal(x.detach(), y.detach())
    for x, y in zip(_opt_tensors(out_a["optimizer"]),
                    _opt_tensors(out_c["optimizer"])):
        assert torch.equal(x, y)
    hist_a = {r["epoch"]: r["val"]["mrr"] for r in out_a["history"]}
    hist_c = {r["epoch"]: r["val"]["mrr"] for r in out_c["history"]}
    assert sorted(hist_c) == [2, 3]
    for e in (2, 3):
        assert hist_c[e] == pytest.approx(hist_a[e], abs=0)
    # the best checkpoint the two runs left behind holds the same weights
    best_a = torch.load(tr_a.ckpt_path(), weights_only=True)
    best_c = torch.load(tr_c.ckpt_path(), weights_only=True)
    assert best_a["epoch"] == best_c["epoch"]
    for x, y in zip(param_leaves(best_a["params"]),
                    param_leaves(best_c["params"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("sig", ["SIGTERM", "SIGUSR1"])
def test_signal_handlers_restored(data, tmp_path, sig):
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    cfg = small_cfg(fast_dev_run=True)
    tr = _trainer(cfg, data, tmp_path)

    def stop(msg):
        if msg.startswith("epoch 0:"):
            os.kill(os.getpid(), getattr(signal, sig))

    out = tr.fit(max_epochs=3, log_fn=stop)
    assert out["preempted"] and out["last_epoch"] == 0
    for s, h in prev.items():
        assert signal.getsignal(s) is h
    out = tr.fit(max_epochs=1, log_fn=lambda *_: None)
    assert not out["preempted"]
    for s, h in prev.items():
        assert signal.getsignal(s) is h


def test_last_state_written_only_on_a_stop(data, tmp_path):
    """No last.pt after an epoch that saw no signal; a stale one is removed
    when the run ends without a stop. The tb file holds the 8 scalars of
    each epoch."""
    tr = _trainer(small_cfg(), data, tmp_path)
    os.makedirs(os.path.dirname(tr.last_ckpt_path()))
    with open(tr.last_ckpt_path(), "wb") as f:
        f.write(b"stale")
    seen = []

    def check(msg):
        seen.append(os.path.getsize(tr.last_ckpt_path()))

    out = tr.fit(max_epochs=2, log_fn=check)
    assert seen == [5, 5]  # the stale file untouched during the run
    assert not out["preempted"]
    assert not os.path.exists(tr.last_ckpt_path())
    files = glob.glob(os.path.join(str(tmp_path), "tb",
                                   "events.out.tfevents.*"))
    assert len(files) == 1
    events = read_scalars(files[0])
    assert [e[0] for e in events] == [0, 1]
    for (_, scalars), rec in zip(events, out["history"]):
        assert set(scalars) == TB_TAGS
        assert scalars["val/mrr"] == np.float32(rec["val"]["mrr"])
        assert scalars["train/loss"] == np.float32(rec["train_loss"])


def test_cli_sigterm_and_resume(tmp_path):
    """python -m temp_tpu_torch.main: SIGTERM after the first epoch's
    metrics line -> exit 75 with last.pt; --resume continues at the next
    epoch, tests, exits 0 and leaves no last.pt."""
    root = _write_dataset(tmp_path / "data")
    exp = str(tmp_path / "runs")
    args = [sys.executable, "-m", "temp_tpu_torch.main", "-c",
            os.path.join(ROOT, "grid", "icews14", "config_grrgcn.json"),
            "--device", "cpu", "--data-root", root, "--dataset", "tiny",
            "--edge-pad-multiple", "16", "--embed-size", "16",
            "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
            "--batch-size", "2", "--negative-rate", "8",
            "--neg-oversample", "8", "--patience", "50",
            "--max-nb-epochs", "6", "--experiments-dir", exp,
            "--model-name", "preempt"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    run = os.path.join(exp, "preempt")
    metrics = os.path.join(run, "metrics.jsonl")
    deadline = time.time() + 240
    while time.time() < deadline:
        if os.path.exists(metrics) and open(metrics).read().count("\n"):
            break
        if proc.poll() is not None:
            raise AssertionError(
                f"trainer exited early:\n{proc.stdout.read()}")
        time.sleep(0.02)
    else:
        proc.kill()
        raise AssertionError("first epoch never completed")
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 75, out
    assert "preempted at epoch" in out and "test: mrr=" not in out
    last = os.path.join(run, "checkpoints", "last.pt")
    assert os.path.exists(last)
    done = open(metrics).read().count("\n")
    assert done < 6

    out2 = subprocess.run(args + ["--resume"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert out2.returncode == 0, out2.stdout + out2.stderr
    assert f"resumed preempted run at epoch {done}" in out2.stdout
    assert "test: mrr=" in out2.stdout
    assert not os.path.exists(last)
    epochs = [json.loads(line)["epoch"] for line in
              open(metrics).read().splitlines()]
    assert epochs == list(range(6))
