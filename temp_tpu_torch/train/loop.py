"""The Trainer: training steps and epochs, early stopping on val MRR, the
best checkpoint and the last state of a preempted run, metric logging
(metrics.jsonl and TensorBoard scalars), and filtered evaluation sweeps.

Every random choice of an epoch comes from (cfg.seed, epoch) alone: the
shuffle of the target times from a numpy RandomState, and each step's draws
from a torch.Generator seeded with (seed, epoch, step). So a run resumed at
epoch k replays the epochs an uninterrupted run would have run.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig, encode_run_name
from temp_tpu_torch.data.snapshots import TKGData, to_device
from temp_tpu_torch.models.objectives import metrics_from_ranks
from temp_tpu_torch.parallel.edge_partition import (
    EdgePartitionedModel, check_ring_layout,
)
from temp_tpu_torch.parallel.mesh import make_mesh
from temp_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from temp_tpu_torch.train.optim import (
    clip_and_step, make_optimizer, param_leaves,
)
from temp_tpu_torch.utils.tbevents import EventWriter


def batched_time_positions(num_times: int, batch_size: int,
                           rng: Optional[np.random.RandomState]):
    """Yield (t_pos [B], t_valid [B]) covering all time positions; the last
    batch is padded with position 0 marked invalid."""
    order = np.arange(num_times)
    if rng is not None:
        rng.shuffle(order)
    for i in range(0, num_times, batch_size):
        chunk = order[i:i + batch_size]
        valid = np.ones(len(chunk), bool)
        if len(chunk) < batch_size:
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.zeros(pad, np.int64)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        yield chunk.astype(np.int32), valid


class Trainer:
    def __init__(self, cfg: TKGConfig, model, data: TKGData,
                 run_dir: Optional[str] = None, mesh=None):
        """`data` is the host (numpy) dataset; it is moved to the model's
        device once here. Runs write under `run_dir` (default
        <experiments_dir>/<model_name or encode_run_name(cfg)>).

        With an edge partition in `cfg` and mp_size > 1 the model runs
        wrapped in ``EdgePartitionedModel`` over `mesh` (default: a
        dp_size x mp_size mesh of the visible cards, or of the CPU for a
        CPU model); the model's device is the controller. The ring and
        boundary modes need `data` in their layout (``ring_regroup_data``;
        the boundary mode also its exchange tables, ``ring_layout``) and
        raise otherwise. A data axis (dp_size > 1) splits each batch of
        target times over its rows under a partition, and needs the batch
        to divide, as the JAX package's Trainer does; without a partition
        it computes what dp_size 1 does, as the JAX package's GSPMD split
        of the batch does. The eval batch is rounded down to a multiple of
        dp (at least dp)."""
        self.cfg = cfg
        self.mesh = None
        dp = int(cfg.dp_size)
        if cfg.partitioned or dp > 1:
            if mesh is None:
                mp = int(cfg.mp_size)
                on_cpu = model.device.type == "cpu"
                mesh = make_mesh(dp, mp, devices=[model.device] * (dp * mp)
                                 if on_cpu else None)
            self.mesh = mesh
            dp = mesh.shape["data"]
        if dp > 1 and cfg.edge_partition_mode is not None \
                and cfg.batch_size % dp:
            raise ValueError(
                f"edge_partition={cfg.edge_partition!r} needs batch_size "
                f"({cfg.batch_size}) divisible by the mesh data axis ({dp}); "
                f"adjust batch_size or dp_size")
        if cfg.partitioned:
            mode = cfg.edge_partition_mode
            if mode in ("ring", "ring_pallas", "boundary"):
                check_ring_layout(data, mesh.shape["model"])
            if mode == "boundary" and data.bnd_g is None:
                raise ValueError(
                    "the boundary edge partition needs the data's exchange "
                    "tables; build the data with data.snapshots.ring_layout")
            model = EdgePartitionedModel(model, mesh, mode=mode)
        self.model = model
        self.device = model.device
        self.data = to_device(data, self.device)
        self.run_dir = run_dir or os.path.join(
            cfg.experiments_dir, cfg.model_name or encode_run_name(cfg))
        self.history: list = []

    # -- training -----------------------------------------------------------

    def init_state(self, seed: Optional[int] = None):
        """Seeded parameters (requiring grad) and their Adam optimizer."""
        params = self.model.init_params(
            self.cfg.seed if seed is None else seed)
        for p in param_leaves(params):
            p.requires_grad_(True)
        return params, make_optimizer(self.cfg, params)

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        """The generator of one step's draws, seeded from (seed, epoch,
        step) alone."""
        seed = np.random.SeedSequence(
            [int(self.cfg.seed), int(epoch), int(step)]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def train_step(self, params, optimizer, t_pos, t_valid, gen=None,
                   draws=None):
        """One optimizer step on the batch of targets t_pos (t_valid marks
        the real ones). Returns the loss as a 0-d tensor on the device."""
        optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(params, self.data, t_pos, t_valid, gen=gen,
                               draws=draws)
        if loss.requires_grad:
            loss.backward()
        clip_and_step(optimizer, self.cfg)
        return loss.detach()

    def epoch_batches(self, epoch: int):
        """The epoch's [n, B] schedule of target times and validity."""
        cfg = self.cfg
        np_rng = np.random.RandomState(
            (cfg.seed * 1000003 + 7919 * epoch) % (2 ** 32))
        batches = list(batched_time_positions(self.data.num_times,
                                              cfg.batch_size, np_rng))
        if cfg.fast_dev_run:
            batches = batches[:1]
        elif cfg.debug:  # about 10% of the batches
            batches = batches[:max(1, len(batches) // 10)]
        return batches

    def train_epoch(self, params, optimizer, epoch: int):
        """All batches of one epoch. Returns the per-step losses (host
        floats)."""
        losses = [self.train_step(params, optimizer, t_pos, t_valid,
                                  gen=self.step_generator(epoch, i))
                  for i, (t_pos, t_valid) in enumerate(
                      self.epoch_batches(epoch))]
        return torch.stack(losses).cpu().tolist()

    def fit(self, params=None, optimizer=None,
            max_epochs: Optional[int] = None, log_fn=print,
            start_epoch: int = 0, best: Optional[tuple] = None):
        """Train to early stop on val MRR (patience epochs without a new
        best). Writes config.json, one metrics.jsonl line an epoch, the
        epoch's TensorBoard scalars under tb/, and the best checkpoint at
        every new best.

        SIGTERM or SIGUSR1 during the fit (a scheduler's preemption) only
        requests a stop: at the end of that epoch the last state (params,
        optimizer, early-stop counters) goes to checkpoints/last.pt and the
        loop ends with "preempted" set; ``load_last`` resumes from it, and
        the resumed run replays the epochs the uninterrupted one would have
        run. The previous handlers are restored at the end. A fit that ends
        without a stop removes any last.pt it finds."""
        cfg = self.cfg
        if params is None:
            params, optimizer = self.init_state()
        best_mrr, best_epoch = best if best is not None else (-1.0, -1)
        max_epochs = max_epochs or cfg.max_nb_epochs
        os.makedirs(self.run_dir, exist_ok=True)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        tb = EventWriter(os.path.join(self.run_dir, "tb"))

        self._stop_requested = False

        def request_stop(signum, frame):
            self._stop_requested = True

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev_handlers[sig] = signal.signal(sig, request_stop)
            except (ValueError, OSError):
                pass  # not the main thread, or no such signal here

        preempted = False
        epoch = start_epoch - 1
        try:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.time()
                losses = self.train_epoch(params, optimizer, epoch)
                train_s = time.time() - t0
                t1 = time.time()
                val = self.run_eval(params, "valid")
                rec = {"epoch": epoch, "train_loss": float(np.mean(losses)),
                       "val": val, "train_s": round(train_s, 3),
                       "eval_s": round(time.time() - t1, 3)}
                self.history.append(rec)
                with open(os.path.join(self.run_dir, "metrics.jsonl"),
                          "a") as f:
                    f.write(json.dumps(rec) + "\n")
                tb.add_scalars(epoch, {
                    "train/loss": rec["train_loss"],
                    "val/mrr": val["mrr"], "val/hit_1": val["hit_1"],
                    "val/hit_3": val["hit_3"], "val/hit_10": val["hit_10"],
                    "val/loss": val.get("loss", float("nan")),
                    "time/train_s": train_s, "time/eval_s": rec["eval_s"]})
                log_fn(f"epoch {epoch}: loss={rec['train_loss']:.4f} "
                       f"val_mrr={val['mrr']:.4f} h1={val['hit_1']:.4f} "
                       f"h3={val['hit_3']:.4f} h10={val['hit_10']:.4f} "
                       f"({train_s:.1f}s train, {rec['eval_s']:.1f}s eval)")
                if val["mrr"] > best_mrr:
                    best_mrr, best_epoch = val["mrr"], epoch
                    self.save_checkpoint(params, optimizer, epoch, val)
                if self._stop_requested:
                    preempted = True
                    self.save_last(params, optimizer, epoch, best_mrr,
                                   best_epoch)
                    log_fn(f"preempted at epoch {epoch}: training state "
                           f"saved to {self.last_ckpt_path()}; rerun with "
                           f"--resume")
                    break
                if epoch - best_epoch >= cfg.patience:
                    log_fn(f"early stop at epoch {epoch} (best mrr "
                           f"{best_mrr:.4f} @ epoch {best_epoch})")
                    break
                if cfg.fast_dev_run:
                    break
        finally:
            for sig, h in prev_handlers.items():
                try:
                    signal.signal(sig, h if h is not None else signal.SIG_DFL)
                except (ValueError, OSError):
                    pass
        if not preempted and os.path.exists(self.last_ckpt_path()):
            # a finished run leaves no mid-training state for a later
            # --resume to restart from
            os.unlink(self.last_ckpt_path())
        return {"best_mrr": best_mrr, "best_epoch": best_epoch,
                "params": params, "optimizer": optimizer,
                "history": self.history, "preempted": preempted,
                "last_epoch": epoch}

    # -- checkpoints --------------------------------------------------------

    def ckpt_path(self) -> str:
        return os.path.join(self.run_dir, "checkpoints", "best.pt")

    def last_ckpt_path(self) -> str:
        return os.path.join(self.run_dir, "checkpoints", "last.pt")

    def save_checkpoint(self, params, optimizer, epoch: int, metrics: Dict):
        save_checkpoint(self.ckpt_path(), params, optimizer, epoch, metrics)
        with open(os.path.join(self.run_dir, "checkpoints", "meta.json"),
                  "w") as f:
            json.dump({"epoch": epoch, "metrics": metrics}, f, indent=2)

    def load_checkpoint(self, path: Optional[str] = None):
        """(params requiring grad, their optimizer with its state restored,
        {"epoch", "metrics"}) from a checkpoint (default: the best)."""
        params, opt_state, extra = load_checkpoint(
            path or self.ckpt_path(), self.device)
        for p in param_leaves(params):
            p.requires_grad_(True)
        optimizer = make_optimizer(self.cfg, params)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        return params, optimizer, extra

    def save_last(self, params, optimizer, epoch: int, best_mrr: float,
                  best_epoch: int):
        """The state a preempted run resumes from: params and optimizer at
        the end of `epoch`, with the early-stop counters. Randomness needs
        no state: every epoch's draws come from (seed, epoch, step)."""
        save_checkpoint(self.last_ckpt_path(), params, optimizer, epoch,
                        {"best_mrr": best_mrr, "best_epoch": best_epoch})

    def load_last(self):
        """(params, optimizer, start_epoch, (best_mrr, best_epoch)) from the
        last-state checkpoint, or None when there is none."""
        if not os.path.exists(self.last_ckpt_path()):
            return None
        params, optimizer, extra = self.load_checkpoint(self.last_ckpt_path())
        m = extra["metrics"]
        return (params, optimizer, int(extra["epoch"]) + 1,
                (float(m["best_mrr"]), int(m["best_epoch"])))

    # -- evaluation ---------------------------------------------------------

    def eval_batch(self) -> int:
        """The sweep's batch of target times: ``cfg.eval_batch``, with a
        mesh rounded down to a multiple of its data axis (at least one
        target a row), as the JAX package's Trainer keeps the split
        legal."""
        eb = self.cfg.eval_batch
        if self.mesh is not None:
            dp = self.mesh.shape["data"]
            eb = max(dp, (eb // dp) * dp)
        return eb

    @torch.no_grad()
    def eval_sweep(self, params, split: str = "valid"):
        """Ranks of every query of `split`, one batch of target times at a
        time: (ranks [n_batches, B, 2Q], mask [n_batches, B, 2Q], per-batch
        mean BCE [n_batches]), on the model's device."""
        model, data = self.model, self.data
        # layer-1 convs do not depend on the target: computed once a sweep
        conv1_all = (model.precompute_eval_conv1(params, data)
                     if self.cfg.eval_conv1 else None)
        ranks, masks, bces = [], [], []
        for t_pos, t_valid in batched_time_positions(
                data.num_times, self.eval_batch(), None):
            r, m, bce = model.eval_ranks(params, data, t_pos, t_valid, split,
                                         conv1_all=conv1_all)
            ranks.append(r)
            masks.append(m)
            bces.append(bce)
        return torch.stack(ranks), torch.stack(masks), torch.stack(bces)

    def run_eval(self, params, split: str = "valid") -> Dict[str, Any]:
        """MRR, Hits@1/3/10, the query count and the mean BCE eval loss of
        one sweep over `split`."""
        ranks, mask, bces = self.eval_sweep(params, split)
        m = metrics_from_ranks(ranks.cpu().numpy(), mask.cpu().numpy())
        m["loss"] = float(bces.mean())
        return m


def load_checkpoint_params(run_dir: str, device="cuda"):
    """(cfg, params on `device`, blob) of a run directory the Trainer
    wrote: its config.json and the parameters of checkpoints/best.pt; blob
    holds "params", "opt_state" (the optimizer's state dict), "epoch" and
    "metrics"."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = TKGConfig.from_dict(json.load(f))
    params, opt_state, extra = load_checkpoint(
        os.path.join(run_dir, "checkpoints", "best.pt"), device)
    blob = {"params": params, "opt_state": opt_state, **extra}
    return cfg, params, blob
