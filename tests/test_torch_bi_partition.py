"""BiGRRGCN and the flagship BiGRRGCN ``--impute`` of temp_tpu_torch under
every edge partition, against the JAX package (CPU, float32).

The port's model over 4 CPU ranks in the modes "boundary", "ring",
"ring_pallas" (K13's plain version) and "psum", on the JAX package's
weights and the draws of its scan windows (``jax_draws_scan``: inside a
partition both packages run both windows step by step and the bi-center
+ impute final step one element at a time, as the fused paths are off):
the summed loss and every gradient within 1e-5 relative to max(1, the
largest entry) of the JAX package's same model over 4 virtual devices:
the flagship's under "boundary" (for the port's "boundary") and "ring"
(for the other three), plain BiGRRGCN's under "boundary" (for all four;
in float32 the modes compute one function); the eval ranks of the valid
split equal to the JAX package's unpartitioned ranks, which its own
tests hold equal to its partitioned ones. The JAX references compile
once a model and mode (10-14 s each with XLA's optimizations off), so
the file takes about 60 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.parallel import edge_partition as jep
from temp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from temp_tpu.parallel.mesh import replicated, use_mesh
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.parallel.edge_partition import EdgePartitionedModel
from temp_tpu_torch.parallel.mesh import make_mesh, manual_partition
from temp_tpu_torch.train.optim import param_leaves
import test_torch_ring as tr
from test_torch_boundary_dp import _jax_data
from test_torch_post import _open, _xla_unoptimized, jax_draws_scan
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _close, _pairs, _torch_params

pytestmark = pytest.mark.usefixtures("one_thread")

M = tr.M
MODELS = {"flagship": {"module": "BiGRRGCN", "impute": True},
          "bigrrgcn": {"module": "BiGRRGCN"}}
# the JAX modes each model is compiled in
JAX_MODES = {"flagship": ("boundary", "ring"), "bigrrgcn": ("boundary",)}
KW = dict(tr.KW, batch_size=2, train_seq_len=2)
T_POS = [4, 6]
T_EVAL = [3, 4, 5, 6]


@pytest.fixture(scope="module")
def jax_bi():
    """model -> the JAX package's loss and gradients of T_POS under its
    ``JAX_MODES`` on a (1, 4) mesh (one compile each), its unpartitioned
    eval of T_EVAL, the params and its scan windows' draws."""
    data = jax.device_put(_jax_data())
    rng = jax.random.PRNGKey(3)
    tp = jnp.asarray(T_POS, jnp.int32)
    tv = jnp.ones(len(T_POS), bool)
    mesh = jax_make_mesh(1, M)
    out = {}
    for name, flags in MODELS.items():
        cfg = JaxConfig(edge_partition="boundary", **{**KW, **flags})
        model = jax_get_model(cfg, data)
        params = _open(model.init_params(jax.random.PRNGKey(0)), flags)
        res = {"params": jax.tree_util.tree_map(np.asarray, params),
               "draws": jax_draws_scan(cfg, data, T_POS, rng)}
        with use_mesh(mesh), _xla_unoptimized():
            sp = jax.device_put(params, replicated(mesh))
            sd = jax.device_put(data, replicated(mesh))
            for mode in JAX_MODES[name]:
                wrapped = jep.EdgePartitionedModel(model, mesh, mode=mode)
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p, w=wrapped: w.loss(p, sd, tp, tv, rng)))(sp)
                res[mode] = (float(loss),
                             jax.tree_util.tree_map(np.asarray, grads))
        with _xla_unoptimized():
            ranks, mask, _ = jax.jit(lambda p, m=model: m.eval_ranks(
                p, data, jnp.asarray(T_EVAL, jnp.int32), jnp.ones(4, bool),
                "valid"))(params)
        res["ranks"], res["mask"] = np.asarray(ranks), np.asarray(mask)
        out[name] = res
    return out


def _port(name, mode):
    """The port's model wrapped over 4 CPU ranks in `mode`, on the data
    regrouped for the ranks (the JAX side's layout; "psum" takes any)."""
    cfg = TKGConfig(edge_partition=mode, **{**KW, **MODELS[name]})
    data = ring_layout(cfg if mode != "psum" else cfg.replace(
        edge_partition="ring"), make_synthetic(**tr.DATA))
    model = get_model(cfg, data, device="cpu")
    mesh = make_mesh(1, M, devices=tr.CPU4)
    return EdgePartitionedModel(model, mesh, mode=mode), to_device(data,
                                                                   "cpu")


@pytest.mark.parametrize("mode", ["boundary", "ring", "ring_pallas", "psum"])
@pytest.mark.parametrize("name", list(MODELS))
def test_bi_models_under_a_partition_match_jax(jax_bi, name, mode):
    """The loss and every gradient of one batch over 4 CPU ranks against
    the JAX package's (``JAX_MODES``: the same mode where compiled, else
    "ring", else "boundary") on its weights and draws, within 1e-5
    relative to max(1, the largest entry); the fused switches asked for
    stay off inside the partition (K6-K10 for the flagship)."""
    js = jax_bi[name]
    wrapped, data = _port(name, mode)
    params = _torch_params(js["params"])
    with manual_partition("model", M, mode, tr.CPU4):
        assert not (wrapped.fused_final_on() or wrapped.fused_window_on())
    loss = wrapped.loss(params, data, T_POS, [True, True],
                        draws=js["draws"])
    loss.backward()
    ref_mode = next(m for m in (mode, "ring", "boundary")
                    if m in JAX_MODES[name])
    ref_loss, ref_grads = js[ref_mode]
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = 0
    for path, g_ref, p in _pairs(ref_grads, params):
        _close((torch.zeros_like(p) if p.grad is None else p.grad).numpy(),
               np.asarray(g_ref), f"{name} {mode} {path}")
        n += 1
    assert n == len(param_leaves(params))


@pytest.mark.parametrize("mode", ["boundary", "ring_pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_bi_models_eval_under_a_partition_match_jax(jax_bi, name, mode):
    """The filtered ranks of the valid split under the partition equal
    the JAX package's unpartitioned ranks on the same data."""
    js = jax_bi[name]
    wrapped, data = _port(name, mode)
    params = _torch_params(js["params"])
    with torch.no_grad():
        ranks, mask, _ = wrapped.eval_ranks(params, data, T_EVAL,
                                            [True] * 4, "valid")
    np.testing.assert_array_equal(mask.numpy(), js["mask"])
    np.testing.assert_array_equal(ranks.numpy()[js["mask"]],
                                  js["ranks"][js["mask"]])
