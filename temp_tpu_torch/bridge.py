"""Parameters of the JAX package as the port's state.

``params_from_numpy`` takes the JAX ``init_params`` pytree after
``np.asarray`` on every leaf (nested dicts and lists of numpy arrays) and
returns the same structure of float32 torch tensors on `device`. The
layouts already agree: relation weights [R2, d], self-loop weights
[d_in, d_out] applied as ``h @ W``, GRU weights in torch's own [3H, in]
layout with gate order r, z, n (one list under "gru", or under "gru_fwd"
and "gru_bwd" in the Bi models), and the impute scalars as 0-d tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    # np.array keeps a 0-d leaf (the impute scalars) 0-d, where
    # np.ascontiguousarray would make it [1]
    return torch.from_numpy(np.array(arr, order="C")).to(device)
