"""temp_tpu_torch config and data against the JAX package (CPU, numpy-exact).

The data build is integer bookkeeping, so every array must be EQUAL, not
close, to the JAX package's for the same seed.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data import snapshots as jsnap
from temp_tpu.train.loop import batched_time_positions as jax_batches
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data import snapshots as psnap
from temp_tpu_torch.train.loop import batched_time_positions

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = np.asarray(v)
    return out


def test_config_fields_extend_the_reference():
    ref = {f.name for f in dataclasses.fields(JaxConfig)}
    port = {f.name for f in dataclasses.fields(TKGConfig)}
    assert ref <= port
    assert port - ref == {"eval_conv1", "kernels"}
    ref_defaults = JaxConfig()
    port_defaults = TKGConfig()
    # data_root is a deployment path, not a model setting: each package
    # keeps its own default
    for name in ref - {"data_root"}:
        assert getattr(port_defaults, name) == getattr(ref_defaults, name), name


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "grid", "*", "config_*.json"))),
    ids=lambda p: os.path.relpath(p, os.path.join(ROOT, "grid")))
def test_grid_config_loads_like_reference(path):
    ref = JaxConfig.from_json_file(path)
    port = TKGConfig.from_json_file(path)
    for f in dataclasses.fields(JaxConfig):
        if f.name != "data_root":  # a deployment path; see above
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_auto_flags_resolve_on_the_port_device():
    cfg = TKGConfig()
    assert cfg.fused_window_on("cuda") and not cfg.fused_window_on("cpu")
    assert TKGConfig(fused_window=True).fused_window_on("cpu")
    assert not TKGConfig(fused_window="off").fused_window_on("cuda")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tkgdata_equals_reference(seed):
    kw = dict(num_ents=37, num_rels=5, num_times=11, edges_per_time=29,
              seed=seed)
    ref = _flat(jsnap.make_synthetic(**kw))
    port = _flat(psnap.make_synthetic(**kw))
    assert sorted(port) == sorted(k for k in ref if not k.startswith(("bnd", "tbl")))
    for k, v in port.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("backward", [False, True])
def test_history_tables_equal_reference(backward):
    jd = jsnap.make_synthetic(num_ents=30, num_rels=4, num_times=9, seed=4)
    pd = psnap.make_synthetic(num_ents=30, num_rels=4, num_times=9, seed=4)
    ref = _flat(jsnap.build_history_tables(jd, 4, backward=backward))
    port = _flat(psnap.build_history_tables(pd, 4, backward=backward))
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_add_reverse_edges_equals_reference():
    rng = np.random.RandomState(0)
    q = np.stack([rng.randint(0, 9, 20), rng.randint(0, 3, 20),
                  rng.randint(0, 9, 20), rng.randint(0, 5, 20)], 1)
    np.testing.assert_array_equal(psnap.add_reverse_edges(q, 3),
                                  jsnap.add_reverse_edges(q, 3))
    assert len(psnap.add_reverse_edges(q[:0], 3)) == 0


def test_build_from_quads_with_reverse_edges_equals_reference():
    rng = np.random.RandomState(5)

    def quads(n):
        return np.stack([rng.randint(0, 25, n), rng.randint(0, 4, n),
                         rng.randint(0, 25, n), rng.randint(0, 7, n)], 1)

    tr, va, te = quads(90), quads(20), quads(20)
    args = [psnap.add_reverse_edges(q, 4) for q in (tr, va, te)]
    ref = _flat(jsnap.build_tkg_data_from_quads(*args, 25, 4, 16))
    port = _flat(psnap.build_tkg_data_from_quads(*args, 25, 4, 16))
    for k, v in port.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("num_times,batch", [(10, 3), (9, 3), (1, 4)])
def test_batched_time_positions_equal_reference(num_times, batch):
    ref = list(jax_batches(num_times, batch, None))
    port = list(batched_time_positions(num_times, batch, None))
    assert len(ref) == len(port)
    for (rp, rv), (pp, pv) in zip(ref, port):
        np.testing.assert_array_equal(pp, rp)
        np.testing.assert_array_equal(pv, rv)


def test_to_device_gives_tensors_of_the_same_values():
    data = psnap.make_synthetic(seed=1)
    dev = psnap.to_device(data, "cpu")
    assert isinstance(dev.train.src, torch.Tensor)
    assert dev.num_ents == data.num_ents
    np.testing.assert_array_equal(dev.total_head.val.numpy(),
                                  data.total_head.val)
    np.testing.assert_array_equal(dev.act_mask.numpy(), data.act_mask)
