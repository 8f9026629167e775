"""Training CLI of the port.

    python -m temp_tpu_torch.main -c grid/icews14/config_grrgcn.json \
        [--device cuda|cpu] [--field value | --flag | --no-flag ...]

Every TKGConfig field is a flag (``--field value``, or ``--flag`` /
``--no-flag`` for booleans). The run trains with ``Trainer.fit`` (early stop
on val MRR, best checkpoint, metrics.jsonl under
<experiments_dir>/<model name>/), then evaluates the best checkpoint on the
test split and writes its metrics to test_metrics.json beside it; the
process exits 0. SIGTERM or SIGUSR1 stops the run at the end of the epoch
with its last state in checkpoints/last.pt, skips the test evaluation, and
exits 75 (EX_TEMPFAIL), for the scheduler to requeue it with ``--resume``.
``--resume`` continues from the last-state checkpoint at the epoch after
it; without one it restores the best checkpoint's parameters and optimizer
state and trains from epoch 0 with no best yet, as the JAX package's
main.py does. In process, ``main(argv)`` returns the test metrics, or
{"preempted": True, "last_epoch": k} after a stop. ``--device`` defaults
to cuda; ``--device cpu`` runs every kernel's plain version.
``--compute-dtype`` defaults to "auto": bfloat16 on the card, float32 with
``--device cpu``, as the JAX package's "auto" resolves on its backend.
``--edge-partition psum|ring|ring_pallas|boundary --mp-size M`` partitions
every SpMM over M ranks (``parallel/``; a bare ``--edge-partition`` is the
boundary exchange), which take the visible cards in turn, several ranks a
card when there are fewer cards (on the CPU with ``--device cpu``);
``--dp-size D`` adds a data axis of D rows, each taking 1/D of a batch's
target times. The run prints the ranks' placement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

EX_TEMPFAIL = 75


def parse_args(argv=None):
    from temp_tpu_torch.config import TKGConfig

    parser = argparse.ArgumentParser(description="temp_tpu_torch trainer")
    parser.add_argument("--config", "-c", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    for f in dataclasses.fields(TKGConfig):
        name = "--" + f.name.replace("_", "-")
        if f.name == "edge_partition":
            # a mode's name or a boolean word; bare, True (the boundary
            # exchange), as the JAX package's CLI takes it
            parser.add_argument(name, nargs="?", const=True, default=None,
                                help="false|psum|ring|ring_pallas|boundary")
        elif isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=None)
        else:
            parser.add_argument(name, type=str, default=None)
    args = parser.parse_args(argv)

    raw = {}
    if args.config:
        with open(args.config) as fh:
            raw.update(json.load(fh))
    for f in dataclasses.fields(TKGConfig):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        if f.name == "edge_partition":
            pass  # a mode's name or a boolean word (TKGConfig reads both)
        elif not isinstance(v, bool) and f.default is not None:
            v = {int: int, float: float}.get(type(f.default), str)(v)
        raw[f.name] = v
    return TKGConfig.from_dict(raw), args.device


def main(argv=None):
    cfg, device = parse_args(argv)
    from temp_tpu_torch.data.snapshots import build_tkg_data
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    print(f"config: module={cfg.module} dataset={cfg.dataset} "
          f"seq_len={cfg.train_seq_len} device={device}")
    data = build_tkg_data(cfg)
    print(f"data: {data.num_ents} entities, {data.num_rels} relations, "
          f"{data.num_times} timestamps, train edge pad "
          f"{data.train.src.shape[1]}")
    model = get_model(cfg, data, device=device)
    trainer = Trainer(cfg, model, data)
    if trainer.mesh is not None:
        print(f"mesh: {trainer.mesh.placement()} "
              f"(edge_partition={cfg.edge_partition_mode}, controller "
              f"{model.device})")
    kw = {}
    if cfg.resume:
        last = trainer.load_last()
        if last is not None:
            # a preempted run's last state: training continues at the epoch
            # after it, with its early-stop counters
            params, optimizer, start_epoch, best = last
            kw = dict(params=params, optimizer=optimizer,
                      start_epoch=start_epoch, best=best)
            print(f"resumed preempted run at epoch {start_epoch} (best mrr "
                  f"{best[0]:.4f} @ epoch {best[1]})")
        elif os.path.exists(trainer.ckpt_path()):
            params, optimizer, extra = trainer.load_checkpoint()
            kw = dict(params=params, optimizer=optimizer)
            print(f"resumed from epoch {extra['epoch']} (val mrr "
                  f"{extra['metrics'].get('mrr', 0):.4f})")
    result = trainer.fit(**kw)
    print(f"best val mrr {result['best_mrr']:.4f} @ epoch "
          f"{result['best_epoch']}")
    if result["preempted"]:
        return {"preempted": True, "last_epoch": result["last_epoch"]}
    params = result["params"]
    if os.path.exists(trainer.ckpt_path()):
        params, _, _ = trainer.load_checkpoint()
    test = trainer.run_eval(params, "test")
    print(f"test: mrr={test['mrr']:.4f} h1={test['hit_1']:.4f} "
          f"h3={test['hit_3']:.4f} h10={test['hit_10']:.4f} n={test['n']}")
    with open(os.path.join(trainer.run_dir, "test_metrics.json"), "w") as f:
        json.dump(test, f, indent=2)
    return test


def exit_code(result) -> int:
    """The process's exit code for `main`'s result: EX_TEMPFAIL (75) after
    a preemption, so that the scheduler requeues the job with --resume;
    0 after a finished run."""
    return EX_TEMPFAIL if result.get("preempted") else 0


if __name__ == "__main__":
    sys.exit(exit_code(main()))
