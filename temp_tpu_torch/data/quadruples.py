"""Raw quadruple file loading.

Parses the ``(head, rel, tail, time)`` text format of the interpolation
datasets (column order head, rel, tail, time), through the native parser
(``data/native.py``) where it is available and ``np.loadtxt`` elsewhere.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from temp_tpu_torch.data import native


def load_quadruples(dataset_path: str, *filenames: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load one or more quadruple files; returns (quads [M, 4], sorted unique
    times). A missing split file counts as empty."""
    rows = []
    for fname in filenames:
        if fname is None:
            continue
        path = os.path.join(dataset_path, fname)
        if not os.path.exists(path):
            continue
        arr = native.parse_quads(path)
        if arr is None:
            arr = np.loadtxt(path, dtype=np.int64, ndmin=2)
        if arr.size == 0:
            continue
        rows.append(arr[:, :4])
    if rows:
        quads = np.concatenate(rows, axis=0)
    else:
        quads = np.zeros((0, 4), dtype=np.int64)
    times = np.unique(quads[:, 3]) if quads.size else np.zeros((0,), np.int64)
    return quads, times


def load_stat(dataset_path: str) -> Tuple[int, int, int]:
    """Read stat.txt -> (num_entities, num_relations, num_timestamps)."""
    with open(os.path.join(dataset_path, "stat.txt")) as f:
        parts = f.read().split()
    num_ents, num_rels = int(parts[0]), int(parts[1])
    num_times = int(parts[2]) if len(parts) > 2 else 0
    return num_ents, num_rels, num_times


def load_id_maps(dataset_path: str, num_rels: int) -> Tuple[Dict[int, str], Dict[int, str]]:
    """Entity/relation id -> name maps, with ``_inv`` names for inverse
    relations."""
    id2ent: Dict[int, str] = {}
    id2rel: Dict[int, str] = {}
    with open(os.path.join(dataset_path, "entity2id.txt")) as f:
        for line in f:
            name, idx = line.strip().rsplit("\t", 1)
            id2ent[int(idx)] = name
    with open(os.path.join(dataset_path, "relation2id.txt")) as f:
        for line in f:
            name, idx = line.strip().rsplit("\t", 1)
            id2rel[int(idx)] = name
            id2rel[int(idx) + num_rels] = f"{name}_inv"
    return id2ent, id2rel
