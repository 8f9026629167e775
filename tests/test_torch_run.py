"""The plumbing around the port's numbers against the JAX package's: run
directory names, --resume from the best checkpoint, config values the port
refuses (and the kernels' switches it accepts), and the gradient clip
(CPU)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.config import encode_run_name as jax_encode_run_name
from temp_tpu_torch import main as port_main
from temp_tpu_torch.config import TKGConfig, encode_run_name
from temp_tpu_torch.data.snapshots import make_synthetic
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import clip_by_global_norm, param_leaves
from test_torch_train import ROOT, _write_dataset

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

FLAG_SETS = [{}, {"impute": True},
             {"rec_only_last_layer": True, "ema": True},
             {"edge_dropout": True, "random_dropout": True, "type1": True},
             {"use_time_embedding": True, "post_ensemble": True,
              "post_aggregation": True, "learnable_lambda": True}]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_run_name_matches_reference(flags):
    kw = dict(dataset="interpolation/icews14", lr=0.003, negative_rate=50,
              n_bases=64, **flags)
    name = encode_run_name(TKGConfig(**kw))
    assert name == jax_encode_run_name(JaxConfig(**kw))
    cfg = TKGConfig(embed_size=16, hidden_size=16, n_bases=16)
    data = make_synthetic(num_ents=20, num_rels=3, num_times=6,
                          edges_per_time=10)
    tr = Trainer(cfg, get_model(cfg, data, device="cpu"), data)
    assert tr.run_dir == os.path.join("experiments", encode_run_name(cfg))


def test_resume_from_best_restarts_epochs_as_reference(tmp_path,
                                                       monkeypatch):
    """Without a last-state checkpoint, --resume restores the best
    checkpoint's parameters and optimizer state and trains from epoch 0
    with no best yet (the JAX package's main.py:139-143)."""
    root = _write_dataset(tmp_path / "data")
    argv = ["-c", os.path.join(ROOT, "grid", "icews14", "config_grrgcn.json"),
            "--device", "cpu", "--data-root", root, "--dataset", "tiny",
            "--edge-pad-multiple", "16", "--embed-size", "16",
            "--hidden-size", "16", "--n-bases", "16", "--train-seq-len", "3",
            "--batch-size", "4", "--max-nb-epochs", "1",
            "--experiments-dir", str(tmp_path / "runs"), "--model-name", "r"]
    port_main.main(argv)
    run = tmp_path / "runs" / "r"
    assert not os.path.exists(run / "checkpoints" / "last.pt")
    best = torch.load(run / "checkpoints" / "best.pt", weights_only=True)
    seen = {}
    fit = Trainer.fit

    def spy(self, params=None, optimizer=None, **kw):
        seen.update(kw, params=[p.detach().clone()
                                for p in param_leaves(params)],
                    opt_state=optimizer.state_dict()["state"])
        return fit(self, params, optimizer, **kw)

    monkeypatch.setattr(Trainer, "fit", spy)
    port_main.main(argv + ["--resume"])
    assert "start_epoch" not in seen and "best" not in seen
    assert seen["opt_state"]  # Adam moments restored
    for got, want in zip(seen["params"], param_leaves(best["params"])):
        assert torch.equal(got, want)
    epochs = [json.loads(line)["epoch"] for line in
              open(run / "metrics.jsonl").read().splitlines()]
    assert epochs == [0, 0]  # the resumed run trained epoch 0 again


@pytest.mark.parametrize("field,value,what", [
    ("fused_window_mb", True, "K12"), ("fused_eval", "auto", "K11"),
    ("dp_size", 2, "data parallelism"), ("mp_size", 4, "model parallelism"),
    ("distributed", True, "multi-process"), ("edge_partition", True, "K13"),
    ("compute_dtype", "bfloat16", "SARGCN")])
def test_unported_config_values_raise(field, value, what):
    """Values that need an unported kernel or module raise, naming it. K11
    (fused_eval) and K12 (fused_window_mb) are ported: their values are
    accepted and resolve as the JAX package's do, "auto" on for the
    accelerator and off for the CPU (the JAX backend here is the CPU);
    so is bfloat16 for every module (SARGCN's among them)."""
    if what in ("K11", "K12"):
        cfg = TKGConfig(**{field: value})
        on = getattr(cfg, f"{field}_on")
        jax_on = getattr(JaxConfig(**{field: value}), f"{field}_on")
        assert on("cpu") == jax_on == (value is True)
        assert on("cuda")
        assert not getattr(TKGConfig(), f"{field}_on")("cuda")  # default off
        return
    if field == "compute_dtype":
        # every module has its bfloat16 mode now: the config builds
        assert TKGConfig(**{field: value}, module=what).hot_dtype == (
            torch.bfloat16)
        return
    if field in ("dp_size", "edge_partition"):
        # ported: the data axis, and the boundary exchange (K1 a rank)
        # that a bare edge_partition selects, as in the JAX package
        cfg = TKGConfig(**{field: value})
        assert getattr(cfg, field) == value
        assert cfg.edge_partition_mode == JaxConfig(
            **{field: value}).edge_partition_mode
        if field == "dp_size":
            cfg, _ = port_main.parse_args(["--dp-size", "2"])
            assert cfg.dp_size == 2 and not cfg.partitioned
        return
    more = {}
    with pytest.raises(NotImplementedError, match=what):
        TKGConfig(**{field: value}, **more)
    TKGConfig(**{field: getattr(TKGConfig(), field)}, **more)
    if field == "dp_size":
        with pytest.raises(NotImplementedError, match=what):
            port_main.parse_args(["--dp-size", "2"])
    assert TKGConfig(compute_dtype="float32", fused_eval="off").dp_size == 1


def test_cli_takes_a_bare_edge_partition():
    """A bare ``--edge-partition`` is True, the boundary exchange, as the
    JAX package's CLI takes it (``nargs="?"``), not argparse's exit 2. A
    mode's name and a boolean word parse as before."""
    cfg, _ = port_main.parse_args(["--edge-partition", "--mp-size", "4"])
    assert cfg.edge_partition is True and cfg.partitioned
    assert cfg.edge_partition_mode == "boundary"
    cfg, _ = port_main.parse_args(["--edge-partition"])
    assert cfg.edge_partition_mode == "boundary" and not cfg.partitioned
    cfg, _ = port_main.parse_args(["--edge-partition", "ring_pallas",
                                   "--mp-size", "4"])
    assert cfg.edge_partition_mode == "ring_pallas" and cfg.partitioned
    cfg, _ = port_main.parse_args(["--edge-partition", "false"])
    assert cfg.edge_partition_mode is None


@pytest.mark.parametrize("scale", [0.4, 2.0])
def test_clip_matches_optax(scale):
    """optax.clip_by_global_norm's formula, active (max below the norm) and
    not. The values lie on a grid of 1/8, so every square and sum is exact
    in float32 and both sides see the same norm: the clipped values then
    agree to 1e-7 relative (torch's clip_grad_norm_, which divides by
    norm + 1e-6, misses by about 4e-7 here)."""
    rs = np.random.RandomState(0)
    leaves = [rs.randint(-8, 9, s).astype(np.float32) / 8
              for s in ((5, 3), (7,), (2, 2, 2))]
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                             for x in leaves)))
    max_norm = scale * norm
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in leaves], None)
    got = [torch.from_numpy(x.copy()) for x in leaves]
    clip_by_global_norm(got, max_norm)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=0)
    if scale < 1.0:
        old = [torch.from_numpy(x.copy()).requires_grad_() for x in leaves]
        for t, x in zip(old, leaves):
            t.grad = torch.from_numpy(x.copy())
        torch.nn.utils.clip_grad_norm_(old, max_norm)
        assert any(not np.allclose(t.grad.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=0) for t, b in zip(old, ref))
