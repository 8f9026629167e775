"""Kernel K2's plain version against the JAX whole-window kernel.

The JAX side runs ``fused_window_scan`` in Pallas interpret mode on the CPU
(f32, Precision.HIGHEST), as tests/test_fused_window.py does; the port runs
the same windows as one batch. Outputs are GRU states in (-1, 1) after at
most three recurrent steps of float32 arithmetic, so 1e-5 absolute covers
the differences in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.dynamic import gather_window
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.fused_window import fused_window_scan as jax_scan
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.ops.fused_window import fused_window_fwd, fused_window_scan
from test_torch_post import _xla_unoptimized

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
T_POS = [5, 7, 2, 0]
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
          batch_size=3, seed=0, dropout=0.0)


@pytest.fixture(scope="module")
def setup():
    data = jax.device_put(jax_synthetic(num_ents=30, num_rels=4,
                                        num_times=10, edges_per_time=25))
    model = jax_get_model(JaxConfig(fused_window=True, **KW), data)
    params = model.init_params(jax.random.PRNGKey(0))
    return data, model, params


def _window_inputs(data, model, params, conv1_in):
    L = model.eval_len
    L1 = L - 1
    rng = np.random.RandomState(7)
    out = []
    for t in T_POS:
        win = gather_window(data, jnp.int32(t), L)
        prev_step = model.tbl_fwd.prev_step[t]
        prev_row = model.tbl_fwd.prev_row[t]
        pos = jnp.arange(L1, dtype=jnp.int32)[:, None]
        A = win.act_idx.shape[1]
        if conv1_in:
            h0 = jnp.asarray(rng.standard_normal((L1, A, 16)), jnp.float32)
        else:
            h0 = params["ent_embeds"][win.act_idx[:L1]]
        out.append(dict(
            h0_xs=h0, src=win.src_loc[:L1], dst=win.dst_loc[:L1],
            rel=win.rel[:L1], emask=win.emask[:L1], prev_step=prev_step,
            prev_row=prev_row, live=prev_step >= 0,
            dt=(pos - jnp.maximum(prev_step, 0)).astype(jnp.float32)))
    return out


@pytest.mark.parametrize("conv1_in", [True, False])
def test_plain_k2_matches_pallas_interpret(setup, conv1_in):
    data, model, params = setup
    elems = _window_inputs(data, model, params, conv1_in)
    cfg = JaxConfig(fused_window=True, **KW)

    def one(e):
        return jax_scan(params["encoder"], cfg, model.lc2, e["h0_xs"],
                        e["src"], e["dst"], e["rel"], e["emask"],
                        e["prev_step"], e["prev_row"], e["dt"], e["live"],
                        None, False, 2, interpret=True, conv1_in=conv1_in)

    # the windows under vmap, one compile (eager interpret mode is slow)
    stacked = {k: jnp.stack([e[k] for e in elems]) for k in elems[0]}
    with _xla_unoptimized():
        bufs = jax.jit(jax.vmap(one))(stacked)
    refs = [tuple(b[i] for b in bufs) for i in range(len(elems))]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()}
    enc = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                   params["encoder"]),
                            device="cpu")
    before = fused_window_fwd.launches
    b1, b2 = fused_window_scan(enc, TKGConfig(**KW), conv1_in=conv1_in,
                               **batch)
    assert fused_window_fwd.launches == before  # CPU: the plain version
    for i, (r1, r2) in enumerate(refs):
        np.testing.assert_allclose(b1[i].numpy(), np.asarray(r1), atol=ATOL)
        np.testing.assert_allclose(b2[i].numpy(), np.asarray(r2), atol=ATOL)
    plain1, plain2 = fused_window_scan(enc, TKGConfig(**KW),
                                       conv1_in=conv1_in, kernels=False,
                                       **batch)
    np.testing.assert_array_equal(plain1.numpy(), b1.numpy())
    np.testing.assert_array_equal(plain2.numpy(), b2.numpy())
