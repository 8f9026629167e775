"""The ranks of the model-parallel axis, and the context that partitions
every relational SpMM over them.

The JAX package runs a partitioned model as one ``shard_map`` over a device
mesh; this package runs it from a single controller. A mesh is a grid of
torch devices, [data][model]. The model's dense math runs once, on the
controller (the model's device), and every ``rel_spmm`` inside
``manual_partition`` splits its edges over the ranks of the model axis:
rank i owns its share of the edges (in the ring and boundary modes, the
edges whose destination row it owns) and, in the ring modes, a row shard of
the entity states. When there are fewer cards than ranks, ranks share a
card; each rank still runs on its own CUDA streams. A data axis of dp rows
splits the batch of target times into dp shards, shard d on the model
axis of row d (``parallel/edge_partition.py`` ``EdgePartitionedModel``).

The GSPMD helpers of the JAX package (``constrain``, ``shard_entity``,
``vary_carry``) mark XLA shardings and have no counterpart here; its
entity sharding without an edge partition (``mp_size > 1`` alone) is not
ported (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

# (axis, size, mode, devices) while a partitioned model runs; see
# manual_partition
_MANUAL: Optional[tuple] = None


@dataclass(frozen=True)
class Mesh:
    """A [dp][mp] grid of the ranks' devices."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def placement(self) -> str:
        """"4 ranks on cuda:0" ("2 x 4 ranks on ..." with a data axis), or
        the devices in rank order when they differ."""
        flat = [str(d) for row in self.devices for d in row]
        where = flat[0] if len(set(flat)) == 1 else ", ".join(flat)
        dp, mp = self.shape["data"], self.shape["model"]
        count = f"{dp} x {mp}" if dp > 1 else f"{mp}"
        return f"{count} ranks on {where}"


def make_mesh(dp: int, mp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A [dp][mp] mesh of `devices` in order (given, they must be enough).
    Without `devices` the ranks take the visible cards in order, round
    robin when there are fewer cards than ranks; with no card this raises:
    ranks go to the CPU only when the caller names CPU devices."""
    n = dp * mp
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices "
                "(for example ['cpu'] * n) to place the ranks elsewhere")
        devices = [torch.device("cuda", i % cards) for i in range(n)]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) < n:
        raise ValueError(f"make_mesh: {len(devices)} devices for a "
                         f"{dp} x {mp} mesh")
    return Mesh(tuple(tuple(devices[i * mp:(i + 1) * mp])
                      for i in range(dp)))


def _indexed(dev: torch.device) -> torch.device:
    """"cuda" as the card it means now ("cuda:0"), so placements name it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def manual_partition(axis: str, size: int, mode: str = "psum",
                     devices: Optional[Sequence] = None):
    """Partition every rel_spmm in the enclosed code over the `size` ranks
    of mesh axis `axis` with exchange `mode` ("psum", "ring",
    "ring_pallas" or "boundary"), rank i on ``devices[i]`` (default: each
    call's own device for every rank)."""
    global _MANUAL
    prev = _MANUAL
    _MANUAL = (axis, size, mode,
               None if devices is None else tuple(devices))
    try:
        yield
    finally:
        _MANUAL = prev


def manual_axis() -> Optional[tuple]:
    """(axis, size, mode) inside ``manual_partition``, else None."""
    return None if _MANUAL is None else _MANUAL[:3]


def rank_devices(default: torch.device) -> Tuple[torch.device, ...]:
    """The ranks' devices inside ``manual_partition``: those it was given,
    or `default` for every rank."""
    size, devices = _MANUAL[1], _MANUAL[3]
    return devices if devices is not None else (default,) * size


def boundary_gather(x):
    """The entity table `x` [n, ...] as every rank holds it after the
    JAX package's ``boundary_gather``: `x` itself.

    Under the JAX package's "boundary" exchange each device holds an
    entity-indexed table correct only in its own row shard (the
    valid-slice contract of its ``_rel_spmm_boundary``: its own output
    rows are exact, the others garbage-finite), and the models call
    ``boundary_gather`` once a forward to re-replicate it: each device
    contributes its own rows to an all-gather. Here one controller holds
    the table, and ``ops.segment._rel_spmm_boundary`` assembles each
    SpMM's output from the ranks' own rows (each exact, computed as the
    JAX device computes it), so the controller's table is that assembled
    table already and the gather is the identity on values. The models
    call it where the JAX package does, so the two read alike."""
    return x
