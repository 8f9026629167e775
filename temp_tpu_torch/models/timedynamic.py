"""TimeDynamicRGCN: GRRGCN with diachronic input embeddings.

Reference: the JAX package's ``models/timedynamic.py`` (after the
reference's models/TimeDynamicRGCN.py). The recurrent pipeline is GRRGCN's;
only the input entity features change with the snapshot's time position t:
their first 80% of columns are the static embedding, the other 20% the
static embedding times sin(t * w_temp + b_temp), w_temp and b_temp
[N, d - floor(0.8 d)] per entity.

Both input hooks of ``DynamicRGCNModel`` take these features: the windows'
(``input_embeddings_rows``, each step at its clamped time position, so a
window that runs off t = 0 reads position 0 for its masked steps), whose
gradient K2b returns through the sine into ent_embeds, w_temp and b_temp;
and the final step's and the inactive rows' (``input_embeddings``). The
model is not ``DynamicRGCNModel`` itself, so its final step runs one
element at a time through K1 (no K3-K5, no K11, no K12) and eval has no
precomputed layer-1 convs, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import DynamicRGCNModel
from temp_tpu_torch.models.layers import RELU_GAIN, xavier_uniform


def diachronic(static, w, b, t, static_size: int):
    """static [..., d] with its columns from `static_size` on times
    sin(t * w + b) (w, b [..., d - static_size]; t broadcast against
    them)."""
    temp = torch.sin(t * w + b)
    return torch.cat([static[..., :static_size],
                      static[..., static_size:] * temp], dim=-1)


class TimeDynamicRGCNModel(DynamicRGCNModel):
    """TimeDynamicRGCN (reference models/TimeDynamicRGCN.py)."""

    partitionable = False

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        # GRRGCN's layers and windows
        if cfg.module == "TimeDynamicRGCN":
            cfg = cfg.replace(module="GRRGCN")
        super().__init__(cfg, data, device=device)
        self.static_size = math.floor(0.8 * cfg.embed_size)
        self.temporal_size = cfg.embed_size - self.static_size

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        """GRRGCN's tree and "w_temp" and "b_temp" [N, d - floor(0.8 d)],
        xavier-uniform (ReLU gain), drawn after it."""
        p = super().init_tree(gen)
        shape = (self.num_ents, self.temporal_size)
        p["w_temp"] = xavier_uniform(gen, shape, RELU_GAIN)
        p["b_temp"] = xavier_uniform(gen, shape, RELU_GAIN)
        return p

    def input_embeddings(self, params, t_pos):
        """The diachronic features [N, d] at time position t_pos."""
        t = torch.as_tensor(t_pos, dtype=torch.float32, device=self.device)
        return diachronic(params["ent_embeds"], params["w_temp"],
                          params["b_temp"], t, self.static_size)

    def input_embeddings_rows(self, params, t_idx, rows):
        """The diachronic features [..., A, d] of the ids rows [..., A] at
        the time positions t_idx [...]; the padding id num_ents reads the
        last row of each table (``_rows``)."""
        idx = rows.long().clamp(max=self.num_ents - 1)
        t = t_idx.to(torch.float32)[..., None, None]
        return diachronic(params["ent_embeds"][idx], params["w_temp"][idx],
                          params["b_temp"][idx], t, self.static_size)
