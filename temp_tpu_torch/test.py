"""Checkpoint inference CLI of the port: restore a run, evaluate a split,
write its metrics and per-query predictions.

    python -m temp_tpu_torch.test --checkpoint-path experiments/<run> \
        [--split valid|test] [--data-root DIR] [--no-predictions] \
        [--device cuda|cpu]

Restores config.json and checkpoints/best.pt of a run directory the
Trainer wrote (``load_checkpoint_params``, any ``--module``), runs the
Trainer's own ``eval_sweep`` over the split (so the MRR printed is the one
the early stopper saw) and writes, beside the checkpoint,
``{split}_metrics.json`` (MRR, Hits@1/3/10, the query count, the eval
loss, ``eval_s``, ``queries_per_s``) and ``{split}_predictions.pkl``: a
list of (head, rel, tail, raw time, "head" or "tail", rank) six-tuples of
Python ints and strings, each real query's head rank and then its tail
rank, queries in time order, as the JAX package's root ``test.py`` writes
it, for ``link_prediction_analysis.py``, ``aggregated_analysis.py`` and
``greedy_classifier.py``. ``--device`` defaults to cuda; ``--device cpu``
runs every kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time


def prediction_records(data, split: str, ranks, eval_batch: int) -> list:
    """The six-tuples of every real query of `split` (host TKGData) from an
    eval sweep's ranks [n_batches, eval_batch, 2Q] (numpy, [head, tail]
    layout), in time order."""
    from temp_tpu_torch.train.loop import batched_time_positions

    edges = getattr(data, split)
    Q = edges.src.shape[1]
    if ranks.shape[-1] != 2 * Q:
        raise ValueError(f"ranks of {ranks.shape[-1]} queries for a split "
                         f"of {Q} edge slots a time")
    records = []
    for bi, (t_pos, t_valid) in enumerate(batched_time_positions(
            data.num_times, eval_batch, None)):
        for b, tp in enumerate(t_pos):
            if not t_valid[b]:
                continue
            q = int(edges.n_edges[tp])
            src = edges.src[tp, :q].tolist()
            rel = edges.rel[tp, :q].tolist()
            dst = edges.dst[tp, :q].tolist()
            t_raw = int(data.times[tp])
            head = [int(r) for r in ranks[bi, b, :Q][:q]]
            tail = [int(r) for r in ranks[bi, b, Q:][:q]]
            for i in range(q):
                records.append((src[i], rel[i], dst[i], t_raw, "head",
                                head[i]))
                records.append((src[i], rel[i], dst[i], t_raw, "tail",
                                tail[i]))
    return records


def predict(run_dir: str, split: str = "test", data_root=None,
            device="cuda", predictions: bool = True, log_fn=print,
            **cfg_over):
    """Evaluate the best checkpoint of `run_dir` on `split` and write its
    metrics (and, with `predictions`, the predictions pickle) beside it;
    `cfg_over` replaces config fields (say ``kernels=False``). Returns
    (metrics, records, ranks, mask); ranks and mask are the sweep's
    (numpy)."""
    import torch

    from temp_tpu_torch.data.snapshots import build_tkg_data
    from temp_tpu_torch.models.objectives import metrics_from_ranks
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer, load_checkpoint_params

    cfg, params, blob = load_checkpoint_params(run_dir, device)
    if data_root:
        cfg_over["data_root"] = data_root
    cfg = cfg.replace(**cfg_over)
    log_fn(f"restored {cfg.module} (epoch {blob['epoch']}, val mrr "
           f"{blob['metrics'].get('mrr', float('nan')):.4f})")
    data = build_tkg_data(cfg)
    model = get_model(cfg, data, device=device)
    trainer = Trainer(cfg, model, data, run_dir=run_dir)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ranks, mask, bces = trainer.eval_sweep(params, split)
    ranks, mask = ranks.cpu().numpy(), mask.cpu().numpy()
    eval_s = time.perf_counter() - t0
    m = metrics_from_ranks(ranks, mask)
    m["loss"] = float(bces.mean())
    log_fn(f"{split}: mrr={m['mrr']:.4f} h1={m['hit_1']:.4f} "
           f"h3={m['hit_3']:.4f} h10={m['hit_10']:.4f} (n={m['n']}, "
           f"{eval_s:.1f}s sweep, {m['n'] / eval_s:.0f} queries/s)")
    m["eval_s"] = round(eval_s, 3)
    m["queries_per_s"] = m["n"] / eval_s
    with open(os.path.join(run_dir, f"{split}_metrics.json"), "w") as f:
        json.dump(m, f, indent=2)
    records = []
    if predictions:
        records = prediction_records(data, split, ranks,
                                     trainer.eval_batch())
        path = os.path.join(run_dir, f"{split}_predictions.pkl")
        with open(path, "wb") as f:
            pickle.dump(records, f)
        log_fn(f"wrote {len(records)} predictions to {path}")
    return m, records, ranks, mask


def main(argv=None):
    ap = argparse.ArgumentParser(description="temp_tpu_torch inference")
    ap.add_argument("--checkpoint-path", required=True,
                    help="run directory holding config.json and "
                         "checkpoints/best.pt")
    ap.add_argument("--split", default="test", choices=["valid", "test"])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--no-predictions", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    m, _, _, _ = predict(args.checkpoint_path, args.split, args.data_root,
                         args.device, not args.no_predictions)
    return m


if __name__ == "__main__":
    main()
