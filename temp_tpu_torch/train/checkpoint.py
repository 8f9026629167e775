"""Checkpoints: the parameter tree and the optimizer state in one
``torch.save`` file, with the run's ``config.json`` beside them in the run
directory (``<run_dir>/checkpoints/best.pt`` and ``last.pt``).

A checkpoint is written to a private file and renamed into place, so a
reader never sees half of one. Tensors are stored on the CPU and restored
onto any device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def save_checkpoint(path: str, params, optimizer, epoch: int,
                    metrics: Dict[str, float]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {"params": _tree_map(lambda t: t.detach().cpu(), params),
            "opt_state": (None if optimizer is None
                          else optimizer.state_dict()),
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, device) -> Tuple[Any, Any, Dict[str, Any]]:
    """(params on `device`, the optimizer's state dict or None, {"epoch",
    "metrics"}). Load the state dict into an optimizer made over the
    restored params (``make_optimizer``) to resume."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    params = _tree_map(lambda t: t.to(device), blob["params"])
    return params, blob["opt_state"], {"epoch": blob["epoch"],
                                       "metrics": blob["metrics"]}
