"""The boundary exchange, the data axis, "auto" on the card and the SpMM
method "onehot" in bfloat16 of temp_tpu_torch, against the JAX package
(CPU).

- ``boundary_tables`` equal to the JAX package's arrays, and the data's
  K1 tables of the ranks' edge slices (``boundary_data``);
- one boundary SpMM (``_rel_spmm_boundary``, K1's plain version a rank on
  4 CPU ranks) against the JAX package's under ``shard_map`` on the
  virtual CPU devices of tests/conftest.py, with ``boundary_gather``:
  output and cotangents within 1e-5 in float32; in bfloat16 the output
  within 1e-5 (the cut rows rounded alike, float32 sums in another
  order) and the cotangents by the rule of tests/test_torch_bf16.py,
  RMS(port - JAX bf16) <= 0.1 RMS(JAX bf16 - JAX f32);
- GRRGCN under "boundary" with mp = 4, on a (1, 4) and a (2, 4) mesh
  (the data axis: each shard its own draws, the JAX side's
  ``fold_in(rng, shard)`` rebuilt), the loss and every gradient within
  1e-5 relative to max(1, the largest entry) of the JAX package's, on
  its draws; the eval ranks equal to the JAX package's (2, 4) boundary
  ranks, the weighted BCE within 1e-5; in bfloat16 the loss and
  gradients by the rule, each leaf allowed JAX's own distance between its
  "boundary" and "psum" gradients (its shard_map rounds each device's
  part of a cotangent upstream of the exchange, the port their sum, as in
  tests/test_torch_bf16_k11_k12_k13.py for the ring);
- the Trainer on a (2, 4) mesh (the JAX package's
  ``test_trainer_integration_boundary`` setup), the batch-divisibility
  error, and a data axis without a partition computing what dp = 1 does;
- "onehot" in bfloat16 against the JAX package's ``_rel_spmm_onehot``
  with ``dtype=bfloat16``: output and both cotangents within 1e-6 of the
  largest entry (measured: bit-equal);
- ``compute_dtype="auto"`` resolving to bfloat16 for CUDA and float32 for
  the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.segment import _rel_spmm_onehot, in_degree_norm
from temp_tpu.ops.segment import rel_spmm as jax_rel_spmm
from temp_tpu.parallel import edge_partition as jep
from temp_tpu.parallel.mesh import boundary_gather as jax_boundary_gather
from temp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from temp_tpu.parallel.mesh import manual_partition as jax_manual_partition
from temp_tpu.parallel.mesh import replicated, use_mesh
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    make_synthetic, ring_layout, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import segment
from temp_tpu_torch.ops.spmm import spmm_fwd
from temp_tpu_torch.parallel.edge_partition import (
    BoundaryData, EdgePartitionedModel, boundary_tables, ring_regroup_data,
    shard_generator,
)
from temp_tpu_torch.parallel.mesh import make_mesh, manual_partition
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import param_leaves
import test_torch_ring as tr
from test_torch_bf16 import BF, RULE, _f32, _lookup, _rms, _rule
from test_torch_post import _xla_unoptimized
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _close, _pairs, _torch_params

# the port's side on one intra-op thread (``one_thread``)
pytestmark = pytest.mark.usefixtures("one_thread")

M = tr.M
CPU4 = tr.CPU4
KW = dict(tr.KW, batch_size=2, train_seq_len=2)
T_POS = [4, 7]
T_EVAL = [4, 5, 6, 7]


def _jax_data():
    """The JAX package's boundary data (tests/test_boundary_mode.py)."""
    data = jep.ring_regroup_data(jax_synthetic(**tr.DATA), M)
    bnd_c, bnd_g = jep.boundary_tables(data, M)
    return data.replace(bnd_c=bnd_c, bnd_g=bnd_g)


def _port_data():
    cfg = TKGConfig(edge_partition="boundary", **KW)
    return ring_layout(cfg, make_synthetic(**tr.DATA))


# -- the exchange tables ------------------------------------------------------

def test_boundary_tables_match_jax():
    """``boundary_tables`` gives the JAX package's bnd_c and bnd_g, and
    ``ring_layout`` attaches them (``TKGData.bnd_c``/``bnd_g``) with K1's
    tables of each rank's edge slice: block t * M + i of a space's tables
    holds exactly the kept edges of slice i of snapshot t, by
    destination."""
    ref_c, ref_g = jep.boundary_tables(
        jep.ring_regroup_data(jax_synthetic(**tr.DATA), M), M)
    got_c, got_g = boundary_tables(
        ring_regroup_data(make_synthetic(**tr.DATA), M), M)
    np.testing.assert_array_equal(got_c, np.asarray(ref_c))
    np.testing.assert_array_equal(got_g, np.asarray(ref_g))
    data = _port_data()
    assert isinstance(data.ring, BoundaryData)
    np.testing.assert_array_equal(data.bnd_c, got_c)
    np.testing.assert_array_equal(data.bnd_g, got_g)
    tr_ = data.train
    T, E = tr_.src.shape
    cap = E // M
    tab = data.ring.glob
    assert tab.fwd_ptr.shape == (T * M, 1, data.num_ents + 1)
    for t in (0, 5):
        for i in range(M):
            sl = slice(i * cap, (i + 1) * cap)
            ptr, edge = tab.fwd_ptr[t * M + i, 0], tab.fwd_edge[t * M + i, 0]
            keep = np.asarray(tr_.emask[t, sl])
            got = np.sort(edge[:ptr[-1], 2])
            np.testing.assert_array_equal(got, np.nonzero(keep)[0])
            for v in np.unique(tr_.dst[t, sl][keep])[:5]:
                slots = edge[ptr[v]:ptr[v + 1], 2]
                assert np.all(tr_.dst[t, sl][slots] == v)


# -- one boundary SpMM --------------------------------------------------------

def _spmm_case(seed=0):
    """Snapshot 5 of the boundary data in global ids, random h, w and a
    cotangent."""
    data = _port_data()
    rs = np.random.RandomState(seed)
    N, d = data.num_ents, 16
    h = rs.randn(N, d).astype(np.float32)
    w = rs.randn(2 * data.num_rels, d).astype(np.float32)
    cot = rs.randn(N, d).astype(np.float32)
    return data, 5, h, w, cot


@pytest.fixture(scope="module")
def jax_spmm():
    """dtype -> (out, dh, dw) of the JAX package's boundary SpMM of
    ``_spmm_case`` under shard_map on 4 virtual devices, its output
    re-replicated with ``boundary_gather``; None: float32."""
    data, t, h, w, cot = _spmm_case()
    N, d = h.shape
    tr_ = data.train
    edges = [jnp.asarray(np.asarray(x[t])) for x in (tr_.src, tr_.dst,
                                                      tr_.rel, tr_.emask)]
    bnd = jnp.asarray(data.bnd_g[t])
    mesh = jax_make_mesh(1, M)
    out = {}
    for dt in (None, jnp.bfloat16):
        def fn(h, w, bnd, dt=dt):
            with jax_manual_partition("model", M, "boundary"):
                return jax_boundary_gather(jax_rel_spmm(
                    h, *edges, w, d, d, N, bnd=bnd, dtype=dt))

        shard = partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                        out_specs=P(), check_vma=False)
        with use_mesh(mesh), _xla_unoptimized():
            res = jax.jit(lambda h, w, g, fn=fn: (lambda o, vjp: (
                o, *vjp(g)))(*jax.vjp(lambda h, w: shard(fn)(h, w, bnd),
                                      h, w)))(
                jnp.asarray(h), jnp.asarray(w), jnp.asarray(cot))
        out[dt] = tuple(np.asarray(x) for x in res)
    return out


@pytest.mark.parametrize("dtype", [None, BF], ids=["f32", "bf16"])
def test_boundary_spmm_matches_jax(jax_spmm, dtype):
    """One boundary SpMM over 4 CPU ranks (K1's plain version each, the
    data's exchange and K1 tables of the snapshot) against the JAX
    package's, forward and both cotangents. In bfloat16 the cut rows
    arrive rounded on both sides; the cotangents by the rule."""
    data, t, h, w, cot = _spmm_case()
    N, d = h.shape
    dd = to_device(data, "cpu")
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    e = [x[t] for x in (dd.train.src, dd.train.dst, dd.train.rel,
                        dd.train.emask)]
    before = spmm_fwd.launches
    with manual_partition("model", M, "boundary", CPU4):
        out = segment.rel_spmm(th, *e, tw, d, d, N, t_pos=torch.tensor(t),
                               tables=dd.ring, dtype=dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    assert spmm_fwd.launches == before  # the CPU runs the plain version
    ref = jax_spmm[None if dtype is None else jnp.bfloat16]
    _close(out.detach().numpy(), ref[0], "out")
    if dtype is None:
        _close(th.grad.numpy(), ref[1], "dh")
        _close(tw.grad.numpy(), ref[2], "dw")
        return
    f32 = jax_spmm[None]
    assert _rms(ref[1] - f32[1]) > 0  # the rounding reaches dh
    _rule(th.grad, ref[1], f32[1], "dh")
    _rule(tw.grad, ref[2], f32[2], "dw")
    # the rows a rank reads from the others arrive rounded: unrounded
    # they give the float32 function
    with manual_partition("model", M, "boundary", CPU4):
        plain = segment.rel_spmm(th.detach(), *e, tw.detach(), d, d, N,
                                 t_pos=torch.tensor(t), tables=dd.ring)
    assert not torch.equal(plain, out.detach())


def test_boundary_needs_the_exchange_tables():
    """A boundary call without the data's exchange tables raises, as the
    JAX package's asserts."""
    data, t, h, w, _ = _spmm_case()
    dd = to_device(data, "cpu")
    e = [x[t] for x in (dd.train.src, dd.train.dst, dd.train.rel,
                        dd.train.emask)]
    with manual_partition("model", M, "boundary", CPU4):
        with pytest.raises(ValueError, match="exchange tables"):
            segment.rel_spmm(torch.from_numpy(h), *e, torch.from_numpy(w),
                             16, 16, h.shape[0])


# -- GRRGCN under "boundary": (1, 4) and (2, 4) ------------------------------

def _jax_loss(model, data, params, mode, dp, rng):
    mesh = jax_make_mesh(dp, M)
    tp = jnp.asarray(T_POS, jnp.int32)
    tv = jnp.ones(len(T_POS), bool)
    with use_mesh(mesh), _xla_unoptimized():
        wrapped = jep.EdgePartitionedModel(model, mesh, mode=mode)
        sp = jax.device_put(params, replicated(mesh))
        sd = jax.device_put(data, replicated(mesh))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: wrapped.loss(p, sd, tp, tv, rng)))(sp)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_grrgcn():
    """The JAX package's GRRGCN on the boundary data: the loss and
    gradients of T_POS under "boundary" on a (1, 4) and a (2, 4) mesh in
    float32, under "boundary" and "psum" in bfloat16 on (1, 4), the
    draws (per data shard on (2, 4)), and the (2, 4) eval of T_EVAL."""
    data = jax.device_put(_jax_data())
    out = {}
    rng = jax.random.PRNGKey(5)
    for dt in ("float32", "bfloat16"):
        cfg = JaxConfig(edge_partition="boundary", compute_dtype=dt, **KW)
        model = jax_get_model(cfg, data)
        if dt == "float32":
            params = model.init_params(jax.random.PRNGKey(0))
            out["f32", 1] = _jax_loss(model, data, params, "boundary", 1,
                                      rng)
            out["f32", 2] = _jax_loss(model, data, params, "boundary", 2,
                                      rng)
            mesh = jax_make_mesh(2, M)
            with use_mesh(mesh), _xla_unoptimized():
                wrapped = jep.EdgePartitionedModel(model, mesh,
                                                   mode="boundary")
                sd = jax.device_put(data, replicated(mesh))
                ranks, mask, bce = jax.jit(lambda p: wrapped.eval_ranks(
                    p, sd, jnp.asarray(T_EVAL, jnp.int32),
                    jnp.ones(4, bool), "valid"))(
                        jax.device_put(params, replicated(mesh)))
            out["eval"] = tuple(np.asarray(x) for x in (ranks, mask, bce))
            out["draws", 1] = tr.scan_draws(cfg, data, T_POS, rng)
            out["draws", 2] = [tr.scan_draws(
                cfg, data, T_POS[d:d + 1], jax.random.fold_in(rng, d))
                for d in range(2)]
        else:
            out["bf16"] = _jax_loss(model, data, params, "boundary", 1, rng)
            out["bf16", "psum"] = _jax_loss(model, data, params, "psum", 1,
                                            rng)
    out["params"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _port_wrapped(dp=1, **over):
    cfg = TKGConfig(edge_partition="boundary", **{**KW, **over})
    data = _port_data()
    model = get_model(cfg, data, device="cpu")
    mesh = make_mesh(dp, M, devices=CPU4 * dp)
    return EdgePartitionedModel(model, mesh, mode="boundary"), to_device(
        data, "cpu")


@pytest.mark.parametrize("dp", [1, 2])
def test_grrgcn_boundary_matches_jax(jax_grrgcn, dp):
    """GRRGCN's summed loss and every gradient under "boundary" on a
    (dp, 4) mesh of CPU ranks, against the JAX package's on the same
    weights and draws (dp = 2: each shard's, from the JAX side's
    fold_in(rng, shard)): within 1e-5 relative to max(1, the largest
    entry)."""
    js = jax_grrgcn
    wrapped, data = _port_wrapped(dp)
    assert wrapped.dp == dp and not wrapped.fused_final_on()
    params = _torch_params(js["params"])
    loss = wrapped.loss(params, data, T_POS, [True, True],
                        draws=js["draws", dp])
    loss.backward()
    ref_loss, ref_grads = js["f32", dp]
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = 0
    for path, g_ref, p in _pairs(ref_grads, params):
        _close((torch.zeros_like(p) if p.grad is None else p.grad).numpy(),
               np.asarray(g_ref), path)
        n += 1
    assert n == len(param_leaves(params))


@pytest.mark.parametrize("dp", [1, 2])
def test_eval_ranks_match_jax(jax_grrgcn, dp):
    """The valid ranks of T_EVAL under "boundary" on a (dp, 4) mesh equal
    the JAX package's on its (2, 4) mesh, and the BCE, the mean over the
    shards weighted by their elements with queries, within 1e-5."""
    wrapped, data = _port_wrapped(dp)
    params = _torch_params(jax_grrgcn["params"])
    with torch.no_grad():
        ranks, mask, bce = wrapped.eval_ranks(params, data, T_EVAL,
                                              [True] * 4, "valid")
    r_ref, m_ref, bce_ref = jax_grrgcn["eval"]
    np.testing.assert_array_equal(mask.numpy(), m_ref)
    np.testing.assert_array_equal(ranks.numpy()[m_ref], r_ref[m_ref])
    assert abs(bce.item() - float(bce_ref)) <= 1e-5


def test_grrgcn_boundary_bf16_matches_jax(jax_grrgcn):
    """GRRGCN with compute_dtype="bfloat16" under "boundary" (1, 4): the
    loss and every gradient against the JAX package's by the rule, the
    float32 boundary run the yardstick; each gradient leaf also allowed
    the distance between the JAX package's own "boundary" and "psum"
    gradients in bfloat16 (its shard_map rounds each device's part of a
    cotangent upstream of the exchange, the port their sum)."""
    js = jax_grrgcn
    wrapped, data = _port_wrapped(compute_dtype="bfloat16")
    params = _torch_params(js["params"])
    loss = wrapped.loss(params, data, T_POS, [True, True],
                        draws=js["draws", 1])
    loss.backward()
    ref_loss, ref = js["bf16"]
    _rule(np.float64(loss.item()), ref_loss, js["f32", 1][0], "loss")
    n = 0
    for path, g_ref, p in _pairs(ref, params):
        got = _f32(torch.zeros_like(p) if p.grad is None else p.grad)
        g_ref = np.asarray(g_ref, np.float64)
        yard = _rms(g_ref - np.asarray(_lookup(js["f32", 1][1], path),
                                       np.float64))
        slack = _rms(g_ref - np.asarray(_lookup(js["bf16", "psum"][1], path),
                                        np.float64))
        assert _rms(got - g_ref) <= RULE * yard + slack, (path, yard, slack)
        n += 1
    assert n == len(param_leaves(params))


# -- the Trainer on a (2, 4) mesh ---------------------------------------------

def test_trainer_on_a_data_and_model_mesh(tmp_path):
    """The JAX package's ``test_trainer_integration_boundary`` setup: the
    Trainer on a (2, 4) mesh with edge_partition="boundary" wraps the
    model, fits an epoch with finite losses, saves the config as given
    ("auto"), and its sweep's MRR equals the unpartitioned sweep's of the
    trained weights. A batch that does not split over the data axis
    raises, as the JAX package's Trainer does; the eval batch rounds down
    to a multiple of dp."""
    import json

    cfg = TKGConfig(edge_partition="boundary", dp_size=2, patience=5,
                    fast_dev_run=True, **{**KW, "batch_size": 4})
    data = _port_data()
    trainer = Trainer(cfg, get_model(cfg, data, device="cpu"), data,
                      run_dir=str(tmp_path / "run"))
    assert trainer.model.mode == "boundary" and trainer.model.dp == 2
    assert trainer.mesh.placement() == "2 x 4 ranks on cpu"
    out = trainer.fit(max_epochs=1, log_fn=lambda *_: None)
    assert np.isfinite(out["history"][0]["train_loss"])
    assert np.isfinite(out["best_mrr"]) and out["best_mrr"] > 0
    saved = json.load(open(tmp_path / "run" / "config.json"))
    assert saved["compute_dtype"] == "auto" and saved["dp_size"] == 2
    m = trainer.run_eval(out["params"], "valid")
    assert 0 < m["mrr"] <= 1
    plain = TKGConfig(**{**KW, "mp_size": 1})
    m_ref = Trainer(plain, get_model(plain, data, device="cpu"),
                    data).run_eval(out["params"], "valid")
    assert m["n"] == m_ref["n"] and abs(m["mrr"] - m_ref["mrr"]) <= 1e-6
    odd = cfg.replace(batch_size=3)
    with pytest.raises(ValueError, match="divisible"):
        Trainer(odd, get_model(odd, data, device="cpu"), data)
    assert Trainer(cfg.replace(eval_batch_size=5),
                   get_model(cfg, data, device="cpu"),
                   data).eval_batch() == 4


def test_data_axis_without_a_partition_is_dp1():
    """dp_size = 2 without an edge partition: a mesh of two CPU rows, the
    model unwrapped, and a training step's loss equal to dp_size 1's on
    the same generator (the JAX package's GSPMD split of the batch
    computes the same numbers). Each data shard of a partitioned step
    draws from a stream of its own, a function of the step's seed and
    the shard."""
    base = dict(KW, mp_size=1, batch_size=4)
    data = make_synthetic(**tr.DATA)
    losses = []
    for dp in (1, 2):
        cfg = TKGConfig(dp_size=dp, **base)
        trainer = Trainer(cfg, get_model(cfg, data, device="cpu"), data)
        assert (trainer.mesh is None) == (dp == 1)
        assert not isinstance(trainer.model, EdgePartitionedModel)
        params, opt = trainer.init_state()
        losses.append(trainer.train_step(
            params, opt, np.array([4, 5, 2, 7]), np.ones(4, bool),
            gen=trainer.step_generator(0, 0)).item())
    assert losses[0] == losses[1]
    gen = torch.Generator().manual_seed(11)
    a, b = shard_generator(gen, 0), shard_generator(gen, 1)
    again = shard_generator(torch.Generator().manual_seed(11), 1)
    assert a.initial_seed() != b.initial_seed() == again.initial_seed()


# -- "onehot" in bfloat16 -----------------------------------------------------

@pytest.mark.parametrize("n_bases", [16, 8], ids=["diagonal", "blocks"])
def test_onehot_bf16_matches_jax(n_bases):
    """``rel_spmm(method="onehot")`` in bfloat16 (diagonal weights: K1's
    "onehot" rounding mode, its plain version on the CPU, through the
    autograd function and through autograd on the plain forward; blocks:
    torch ops in the same roundings) against the JAX package's
    ``_rel_spmm_onehot(dtype=bfloat16)`` and its vjp: within 1e-6 of the
    largest entry."""
    rs = np.random.RandomState(3)
    N, E, R, d = 40, 90, 7, 16
    h = rs.standard_normal((N, d)).astype(np.float32)
    w = rs.standard_normal((R, d * d // n_bases)).astype(np.float32)
    edges = (rs.randint(0, N, E).astype(np.int32),
             rs.randint(0, N, E).astype(np.int32),
             rs.randint(0, R, E).astype(np.int32), rs.rand(E) < 0.8)
    cot = rs.standard_normal((N, d)).astype(np.float32)
    je = [jnp.asarray(x) for x in edges]
    norm = in_degree_norm(je[1], je[3], N)
    out, vjp = jax.vjp(lambda a, b: _rel_spmm_onehot(
        a, *je, b, n_bases, d, N, norm, jnp.bfloat16), jnp.asarray(h),
        jnp.asarray(w))
    ref = [np.asarray(x) for x in (out,) + vjp(jnp.asarray(cot))]
    for kernels in (True, False):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        got = segment.rel_spmm(th, *map(torch.from_numpy, edges), tw,
                               n_bases, d, N, kernels=kernels, dtype=BF,
                               method="onehot")
        (got * torch.from_numpy(cot)).sum().backward()
        for name, a, b in zip(("out", "dh", "dw"),
                              (got.detach(), th.grad, tw.grad), ref):
            a = a.numpy().astype(np.float64)
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), (
                name, kernels, np.abs(a - b).max())


# -- "auto" -------------------------------------------------------------------

def test_auto_resolves_per_device():
    """compute_dtype="auto" resolves as the JAX package's does on its
    backend: bfloat16 for CUDA, float32 for the CPU (the JAX backend
    here); ``get_model`` resolves the model's config, and an explicit
    dtype stays as given."""
    assert JaxConfig(compute_dtype="auto").hot_dtype is None
    cfg = TKGConfig(**{**KW, "mp_size": 1})
    assert cfg.compute_dtype == "auto" and cfg.hot_dtype is None
    assert cfg.for_device("cuda").hot_dtype == BF
    assert cfg.for_device(torch.device("cuda", 0)).compute_dtype == "bfloat16"
    assert cfg.for_device("cpu").compute_dtype == "float32"
    for dt in ("float32", "bfloat16"):
        assert cfg.replace(compute_dtype=dt).for_device("cuda") \
            .compute_dtype == dt
    model = get_model(cfg, make_synthetic(**tr.DATA), device="cpu")
    assert model.cfg.compute_dtype == "float32"
