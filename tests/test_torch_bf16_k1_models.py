"""compute_dtype="bfloat16" of temp_tpu_torch against the JAX package's
bfloat16 path (CPU), the last slice: kernel K1's bfloat16 mode (the JAX
package's ``rel_spmm_pallas`` with ``dtype=bfloat16``), the SpMM method
switch of ``ops.segment.rel_spmm``, and every model, decoder, pool and
recurrent option in bfloat16.

K1: its bfloat16 plain versions (and autograd through the forward's)
against the Pallas kernel in interpret mode and its jitted vjp, within
1e-5 of the largest entry (the same roundings of the same values, float32
sums in another order). The switch: every method in float32 and bfloat16,
by argument and by ``TEMP_TPU_SPMM_METHOD`` (the JAX side's
``_METHOD_OVERRIDE`` patched here), against the JAX package's
``rel_spmm`` within 1e-5; "pallas" with block weights raises.

The models: each config of ``CASES`` (every module of the registry that
the earlier bfloat16 files do not hold, every decoder, pool and option,
RRGCN and SARGCN under the method "pallas") on the same weights and the
JAX loss's draws: the loss and every gradient leaf by the rule of
tests/test_torch_bf16.py, RMS(port bf16 - JAX bf16) <= 0.1 RMS(JAX bf16
- f32), with the port's float32 run of the same config as the f32 side
(the float32 files hold it to the JAX package's within 1e-5 relative, so
one JAX compile a config suffices); and one eval batch's ranks equal to
the JAX package's bfloat16 ranks but for at most MAX_FLIPS queries (each
a rank that moves where two candidates' bfloat16 scores lie within
rounding of each other). Both sides run their windows step by step (the
JAX XLA scan) and their final steps one element at a time. Measured on
these fixtures (RMS(port - JAX bf16) over the f32 distance): the losses
at most 0.059, the gradients at most 0.0062; a leaf whose path takes no
rounding (TransE's L1 scores) agrees with JAX within float32's 1e-5
relative; K1's bfloat16 plain versions equal the Pallas kernel's bit
for bit on the float32 h of ``_graph(0)``. The file takes about 100 s
alone (one JAX compile a config).
"""

import importlib.util
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import temp_tpu.ops.segment as jax_segment
from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.pallas_spmm import rel_spmm_pallas
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, ring_layout
from temp_tpu_torch.data.snapshots import to_device
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import segment
from temp_tpu_torch.ops.spmm import (
    spmm, spmm_bwd, spmm_bwd_plain, spmm_fwd, spmm_fwd_plain,
)
from temp_tpu_torch.train.optim import param_leaves
from test_torch_baselines import _to_numpy, _write_run
from test_torch_bf16 import _lookup, _rule
from test_torch_decoders import jax_draws_neg
from test_torch_post import _xla_unoptimized, jax_draws_scan
from test_torch_recurrent import _open, jax_draws_static
from test_torch_selfattn import jax_draws_sa
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _close, _pairs, _torch_params

# the port's side on one intra-op thread (``one_thread``)
pytestmark = pytest.mark.usefixtures("one_thread")

BF = torch.bfloat16
RULE = 0.1
TOL = 1e-5
MAX_FLIPS = 2


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile
    (``_xla_unoptimized``)."""
    with _xla_unoptimized():
        yield


@contextmanager
def spmm_method(method):
    """Both packages' ``TEMP_TPU_SPMM_METHOD`` set to `method` (None: not
    set) inside."""
    old = (jax_segment._METHOD_OVERRIDE, segment._METHOD_OVERRIDE)
    jax_segment._METHOD_OVERRIDE = segment._METHOD_OVERRIDE = method
    try:
        yield
    finally:
        jax_segment._METHOD_OVERRIDE, segment._METHOD_OVERRIDE = old


def _near(a, b, what):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30), (
        what, np.abs(a - b).max(), np.abs(b).max())


# -- K1 in bfloat16 against the Pallas kernel -------------------------------

def _graph(seed, N=40, E=90, R=7, d=16):
    rs = np.random.RandomState(seed)
    h = rs.standard_normal((N, d)).astype(np.float32)
    w = rs.standard_normal((R, d)).astype(np.float32)
    edges = (rs.randint(0, N, E).astype(np.int32),
             rs.randint(0, N, E).astype(np.int32),
             rs.randint(0, R, E).astype(np.int32), rs.rand(E) < 0.8)
    g = rs.standard_normal((N, d)).astype(np.float32)
    return h, w, edges, g


def _pallas(h, w, edges, g, dtype):
    """The JAX kernel's (out, dh, dw) in interpret mode, its vjp jitted."""
    jedges = [jnp.asarray(x) for x in edges]

    def fn(h, w):
        return rel_spmm_pallas(h, *jedges, w, h.shape[0], dtype=dtype,
                               interpret=True)

    out = jax.jit(lambda h, w, g: (lambda o, vjp: (o, *vjp(g)))(
        *jax.vjp(fn, h, w)))(jnp.asarray(h), jnp.asarray(w), jnp.asarray(g))
    return tuple(np.array(x, np.float32) for x in out)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_k1_bf16_plain_versions_match_the_pallas_kernel(h_dtype):
    """``spmm_fwd_plain``/``spmm_bwd_plain`` with hot=bfloat16, the
    autograd ``SpMM`` (its CPU route) and autograd through the plain
    forward against ``rel_spmm_pallas(dtype=bfloat16)`` and its vjp; h
    given in float32 or already in bfloat16 (read as it is, as JAX pads
    it to float32 first). Masked edges add neither a message nor a
    degree; rows without in-edges are 0."""
    h, w, edges, g = _graph(0)
    if h_dtype == "bfloat16":
        h = np.asarray(torch.from_numpy(h).to(BF).float())
    ref = _pallas(h, w, edges, g, jnp.bfloat16)
    src, dst, rel, em = (torch.from_numpy(x) for x in edges)
    th = torch.from_numpy(h).to(getattr(torch, h_dtype))
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    out = spmm_fwd_plain(th, src, dst, rel, em, tw, BF)
    assert out.dtype == torch.float32
    _near(out, ref[0], "out")
    deg = np.bincount(edges[1][edges[3]], minlength=h.shape[0])
    n2 = torch.from_numpy(np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
                          ** 2).float()
    dh, dw = spmm_bwd_plain(tg, n2, th, src, dst, rel, em, tw, BF)
    _near(dh, ref[1], "dh")
    _near(dw, ref[2], "dw")
    assert bool((out[torch.from_numpy(deg == 0)] == 0).all())
    # the CPU wrappers are the plain versions, no launch
    before = (spmm_fwd.launches, spmm_bwd.launches)
    assert torch.equal(spmm_fwd(th, src, dst, rel, em, tw, hot=BF), out)
    assert all(torch.equal(a, b) for a, b in zip(
        spmm_bwd(tg, n2, th, src, dst, rel, em, tw, hot=BF), (dh, dw)))
    assert (spmm_fwd.launches, spmm_bwd.launches) == before
    for through in ("SpMM", "plain"):
        ah = th.clone().requires_grad_()
        aw = tw.clone().requires_grad_()
        got = (spmm(ah, src, dst, rel, em, aw, hot=BF) if through == "SpMM"
               else spmm_fwd_plain(ah, src, dst, rel, em, aw, BF))
        (got * tg).sum().backward()
        assert ah.grad.dtype == th.dtype
        _near(ah.grad.float(), (torch.from_numpy(ref[1]).to(th.dtype)
                                .float()), f"dh {through}")
        _near(aw.grad, ref[2], f"dw {through}")
    # the float32 mode against the float32 kernel
    ref32 = _pallas(h, w, edges, g, None)
    _near(spmm_fwd_plain(th.float(), src, dst, rel, em, tw), ref32[0],
          "out f32")


def test_k1_bf16_launches_match_the_library_signatures(monkeypatch):
    """With the library replaced by a recorder and the device check and
    the card's stream by stand-ins, the autograd ``SpMM`` on CPU tensors
    in the bfloat16 mode calls the bfloat16 launchers (``name_bf16``, from
    csrc/spmm_bf16.cu) with the arguments ``_build.SIGNATURES`` declares
    for ``name``, one forward and one backward launch, each counted in
    ``launches`` and ``launches_bf16``, on h and w as given (no copy; the
    launchers' h_bf16 0 for a float32 h, 1 for a bfloat16 h; onehot 1
    in the "onehot" rounding, counted in ``launches_onehot`` too); in
    float32 the float32 launchers, h_bf16 0, counted in ``launches`` only,
    and a bfloat16 h refused; a bfloat16 weight is refused in both
    modes."""
    import ctypes
    import re

    from temp_tpu_torch import _build
    from temp_tpu_torch.ops import spmm as sp

    bf16_src = open(os.path.join(os.path.dirname(_build.SOURCES[0]),
                                 "spmm_bf16.cu")).read()
    renamed = re.findall(r"#define (\w+) \1_bf16", bf16_src)
    assert renamed == ["spmm_fwd_launch", "spmm_bwd_launch"]
    assert set(renamed) <= set(_build.BF16_LAUNCHERS)
    kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
             ctypes.c_longlong: int}
    calls = []

    class Recorder:
        def __getattr__(self, name):
            base = name[:-len("_bf16")] if name.endswith("_bf16") else name
            sig = _build.SIGNATURES[base]

            def launch(*args):
                assert len(args) == len(sig), name
                for a, t in zip(args, sig):
                    assert isinstance(a, kinds[t]) and not isinstance(
                        a, bool), (name, a)
                calls.append((name, args[-3], args[-2]))
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(sp, "_device_kind", lambda name, t: "cuda")
    h, w, edges, _ = _graph(3)
    e = [torch.from_numpy(x) for x in edges]
    names = ["spmm_fwd_launch", "spmm_bwd_launch"]
    for hot, h_dtype, flag, onehot in ((BF, torch.float32, 0, False),
                                       (BF, BF, 1, False),
                                       (BF, torch.float32, 0, True),
                                       (None, torch.float32, 0, False)):
        calls.clear()
        before = (spmm_fwd.launches, spmm_fwd.launches_bf16,
                  spmm_bwd.launches, spmm_bwd.launches_bf16,
                  spmm_fwd.launches_onehot, spmm_bwd.launches_onehot)
        th = torch.from_numpy(h).to(h_dtype).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        spmm(th, *e, tw, hot=hot, onehot=onehot).sum().backward()
        suffix = "" if hot is None else "_bf16"
        assert calls == [(n + suffix, flag, int(onehot)) for n in names]
        n, o = int(hot is not None), int(onehot)
        assert (spmm_fwd.launches, spmm_fwd.launches_bf16,
                spmm_bwd.launches, spmm_bwd.launches_bf16,
                spmm_fwd.launches_onehot, spmm_bwd.launches_onehot) == (
            before[0] + 1, before[1] + n, before[2] + 1, before[3] + n,
            before[4] + o, before[5] + o)
        assert th.grad.dtype == h_dtype and tw.grad.dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16 mode"):
        spmm(torch.from_numpy(h), *e, torch.from_numpy(w), onehot=True)
    with pytest.raises(TypeError, match="mode"):
        spmm(torch.from_numpy(h).to(BF), *e, torch.from_numpy(w))
    with pytest.raises(TypeError, match="float32 weight"):
        spmm(torch.from_numpy(h), *e, torch.from_numpy(w).to(BF), hot=BF)


# -- the method switch --------------------------------------------------------

def _switch_case(n_bases=16):
    h, w, edges, _ = _graph(1, d=16)
    if n_bases != 16:
        w = np.random.RandomState(2).standard_normal(
            (w.shape[0], 16 * 16 // n_bases)).astype(np.float32)
    return h, w, edges


def _both(h, w, edges, n_bases, method, dtype):
    """(the port's rel_spmm, the JAX package's) of the same call."""
    jdt = None if dtype is None else jnp.bfloat16
    ref = jax_segment.rel_spmm(jnp.asarray(h), *map(jnp.asarray, edges),
                               jnp.asarray(w), n_bases, h.shape[1],
                               h.shape[0], method=method, dtype=jdt)
    got = segment.rel_spmm(torch.from_numpy(h),
                           *map(torch.from_numpy, edges),
                           torch.from_numpy(w), n_bases, h.shape[1],
                           h.shape[0], dtype=dtype, method=method)
    return got, np.asarray(ref, np.float32)


@pytest.mark.parametrize("dtype", [None, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("method", list(segment.METHODS))
def test_spmm_method_switch_follows_the_jax_package(method, dtype):
    """Each method in each dtype, by argument and through the environment
    variable (with method "auto"): the JAX package's ``rel_spmm`` of the
    same method within 1e-5. "segment" and "auto" ignore the dtype (K1 in
    float32); the bfloat16 "pallas" is K1's bfloat16 mode and the
    bfloat16 "onehot" its "onehot" rounding, which differ from it."""
    h, w, edges = _switch_case()
    for via in ("argument", "environment"):
        arg, env = (method, None) if via == "argument" else ("auto", method)
        if method == "auto" and via == "environment":
            env = None
        with spmm_method(env):
            got, ref = _both(h, w, edges, 16, arg, dtype)
        assert got.dtype == torch.float32
        _near(got, ref, f"{method} {via}")
        src, dst, rel, em = (torch.from_numpy(x) for x in edges)
        th, tw = torch.from_numpy(h), torch.from_numpy(w)
        rounded = method in ("pallas", "onehot")
        hot = dtype if rounded else None
        assert torch.equal(got, spmm_fwd_plain(
            th, src, dst, rel, em, tw, hot,
            onehot=method == "onehot" and dtype is not None))
        if dtype is not None:
            f32 = spmm_fwd_plain(th, src, dst, rel, em, tw)
            assert torch.equal(got, f32) == (not rounded)


def test_spmm_method_switch_refusals_and_environment(monkeypatch):
    """"pallas" with block weights raises (the JAX kernel is the diagonal
    one), where "segment" runs them; an unknown method raises; and the
    module reads ``TEMP_TPU_SPMM_METHOD`` once, at import, as the JAX
    package does."""
    h, w, edges = _switch_case(n_bases=8)
    got, ref = _both(h, w, edges, 8, "segment", BF)
    _near(got, ref, "segment, blocks")
    with pytest.raises(ValueError, match="diagonal"):
        segment.rel_spmm(torch.from_numpy(h), *map(torch.from_numpy, edges),
                         torch.from_numpy(w), 8, 16, h.shape[0], dtype=BF,
                         method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        segment.resolve_method("rows", None, True)
    assert segment.resolve_method("auto", BF, True) == (
        segment._METHOD_OVERRIDE or "segment")
    # a fresh copy of the module, imported with the variable set
    monkeypatch.setenv("TEMP_TPU_SPMM_METHOD", "pallas")
    spec = importlib.util.spec_from_file_location("segment_env",
                                                  segment.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh._METHOD_OVERRIDE == "pallas"
    assert fresh.resolve_method("auto", None, True) == "pallas"


# -- every model, decoder, pool and option in bfloat16 ----------------------

KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=3,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1,
          negative_rate=8, neg_oversample=8, fused_window=False,
          fused_final=False)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
# t = 1's window of 3 runs off t = 0
T_POS = [5, 1]
EVAL_T = [4, 7]
# tag -> (flags, the draws' derivation, the SpMM method)
CASES = {
    "rrgcn_pallas": ({"module": "RRGCN", "score_function": "distmult",
                      "negative_pool": "shared", "learnable_lambda": True},
                     "scan", "pallas"),
    "birrgcn_options": ({"module": "BiRRGCN", "rec_only_last_layer": True,
                         "use_time_embedding": True,
                         "score_function": "transE",
                         "negative_pool": "per_query"}, "scan", None),
    "type1_lambda": ({"module": "GRRGCN", "type1": True,
                      "learnable_lambda": True}, "scan", None),
    "srgcn": ({"module": "SRGCN"}, "static", None),
    "drgcn_temb": ({"module": "DRGCN", "use_time_embedding": True,
                    "use_embed_for_non_active": True}, "static", None),
    "sargcn_pallas": ({"module": "SARGCN"}, "sa", "pallas"),
    "post_bisargcn": ({"module": "BiSARGCN", "post_aggregation": True},
                      "sa", None),
    "static": ({"module": "Static"}, "base", None),
    "de": ({"module": "DE", "negative_pool": "per_query"}, "base", None),
    "atise": ({"module": "ATiSE", "score_function": "distmult"}, "base",
              None),
    "hyte": ({"module": "Hyte", "negative_pool": "shared"}, "base", None),
    "simple": ({"module": "SimplE"}, "base", None),
    "tdyn": ({"module": "TimeDynamicRGCN"}, "scan", None),
    "agg": ({"module": "Aggregator", "temporal_module": "BiGRRGCN"}, "base",
            None),
}


def _port(tag, dtype="bfloat16", runs=None):
    flags = dict(CASES[tag][0])
    if runs is not None:
        flags.update(spatial_checkpoint=runs["spatial"],
                     temporal_checkpoint=runs["temporal"])
    cfg = TKGConfig(compute_dtype=dtype, **KW, **flags)
    data = ring_layout(cfg, make_synthetic(**DATA))
    return cfg, data, get_model(cfg, data, device="cpu")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """tag -> the JAX model in bfloat16, its config, data, params (the
    port's seeded init; the Aggregator's debug path, whose submodels the
    port loads from run directories written here), draws and "out": one
    compiled function's ((loss, grads) of the batch T_POS at key 1,
    (ranks, mask, loss) of the valid batch EVAL_T), under the case's SpMM
    method; built on first use (one compile a case)."""
    cache = {}

    def get(tag):
        if tag in cache:
            return cache[tag]
        flags, kind, method = CASES[tag]
        cfg = JaxConfig(compute_dtype="bfloat16", **KW, **flags)
        data = jax.device_put(jax_synthetic(**DATA))
        key = jax.random.PRNGKey(1)
        with spmm_method(method):
            model = jax_get_model(cfg, data)
            runs = None
            if tag == "agg":
                params = model.init_params(jax.random.PRNGKey(0))
                root = tmp_path_factory.mktemp("agg_bf16")
                runs = {name: _write_run(
                    root / name, TKGConfig(compute_dtype="bfloat16",
                                           module=module, **KW),
                    _to_numpy(sub))
                    for name, module, sub in (
                        ("spatial", "SRGCN", model.spatial_params),
                        ("temporal", "BiGRRGCN", model.temporal_params))}
            else:
                params = _open(jax.tree_util.tree_map(
                    lambda t: jnp.asarray(t.numpy()),
                    _port(tag)[2].init_params(0)), flags)
            tp, tv = jnp.asarray(T_POS, jnp.int32), jnp.asarray([True, True])
            te = jnp.asarray(EVAL_T, jnp.int32)

            def run(p, r):
                return (jax.value_and_grad(
                    lambda q: model.loss(q, data, tp, tv, r))(p),
                    model.eval_ranks(p, data, te, jnp.ones(len(EVAL_T), bool),
                                     "valid"))

            out = jax.jit(run).lower(params, key).compile()(params, key)
        cache[tag] = dict(cfg=cfg, data=data, model=model, params=params,
                          out=out, runs=runs, draws=_draws(kind, cfg, data,
                                                           model, key))
        return cache[tag]

    return get


def _draws(kind, cfg, data, model, key):
    """The JAX loss's draws of the batch T_POS, as the port takes them."""
    if kind == "scan":
        draws = jax_draws_scan(cfg, data, T_POS, key,
                               (model.drop_past, model.drop_future))
    elif kind == "static":
        draws = jax_draws_static(cfg, data, T_POS, key)
    elif kind == "sa":
        draws = jax_draws_sa(cfg, data, T_POS, key)
    else:
        draws = {"pos": torch.from_numpy(np.stack([np.asarray(
            jax_subsample_pos(jax.random.split(r, 3)[0],
                              data.train.emask[t], cfg.num_pos_facts))
            for t, r in zip(T_POS, jax.random.split(key, len(T_POS)))]))}
    draws.update(jax_draws_neg(cfg, data, T_POS, key,
                               split_fwd=kind != "base"))
    return draws


def _port_loss(tag, js, dtype):
    """The port's (params, loss) of the batch with `dtype`, backward run."""
    cfg, data, model = _port(tag, dtype, js["runs"])
    params = _torch_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    with spmm_method(CASES[tag][2]):
        loss = model.loss(params, to_device(data, "cpu"), T_POS,
                          [True, True], draws=js["draws"])
        loss.backward()
    return model, data, params, loss


@pytest.mark.parametrize("tag", list(CASES))
def test_bf16_config_matches_jax(jax_side, tag):
    js = jax_side(tag)
    (ref_loss, ref_grads), (ref_ranks, ref_mask, ref_bce) = js["out"]
    model, data, params, loss = _port_loss(tag, js, "bfloat16")
    assert model.cfg.hot_dtype == BF and not model.fused_final_on()
    _, _, params32, loss32 = _port_loss(tag, js, "float32")
    _rule(np.float64(loss.item()), ref_loss, np.float64(loss32.item()),
          f"{tag} loss")
    f32 = jax.tree_util.tree_map(
        lambda p: np.zeros(p.shape, np.float32) if p.grad is None
        else p.grad.numpy(), params32)
    n = moved = 0
    for path, ref, p in _pairs(ref_grads, params):
        got = np.zeros(p.shape, np.float32) if p.grad is None else (
            p.grad.numpy())
        yard = _lookup(f32, path)
        if np.array_equal(got, yard):
            # no rounding on the leaf's path (TransE's L1 scores stay
            # float32): the JAX package's float32 agreement
            _close(got, np.asarray(ref, np.float32), f"{tag} {path}")
        else:
            _rule(got, ref, yard, f"{tag} {path}")
        n += 1
        moved += bool(np.abs(np.asarray(ref, np.float32)).max() > 0)
    assert n == len(param_leaves(params)) and moved >= 1
    with spmm_method(CASES[tag][2]), torch.no_grad():
        ranks, mask, bce = model.eval_ranks(
            params, to_device(data, "cpu"), EVAL_T,
            np.ones(len(EVAL_T), bool), "valid")
    ref_mask = np.asarray(ref_mask)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    flips = int((ranks.numpy() != np.asarray(ref_ranks))[ref_mask].sum())
    assert ref_mask.sum() > 0 and flips <= MAX_FLIPS, (tag, flips)


@pytest.mark.parametrize("module", [
    "GRRGCN", "RRGCN", "BiGRRGCN", "BiRRGCN", "SRGCN", "DRGCN", "SARGCN",
    "BiSARGCN", "Static", "DE", "ATiSE", "AtiSE", "Hyte", "SimplE", "Simple",
    "TimeDynamicRGCN", "Aggregator"])
def test_every_module_builds_in_bf16(module):
    """Every ``--module`` of the registry builds a bfloat16 config and
    model, with every decoder and pool, and "auto" stays float32."""
    for name, pool in (("complex", "all"), ("distmult", "shared"),
                       ("transE", "per_query")):
        cfg = TKGConfig(compute_dtype="bfloat16", module=module,
                        score_function=name, negative_pool=pool, **KW)
        assert cfg.hot_dtype == BF
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    assert model.cfg.hot_dtype == BF
    assert TKGConfig(module=module, **KW).hot_dtype is None
