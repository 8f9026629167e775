"""The fused filtered eval (kernel K11) and the batched window (kernel K12)
of temp_tpu_torch against the JAX package on the CPU, float32.

The JAX side runs its Pallas kernels in interpret mode: ``_eval_kernel``
under ``fused_eval=True`` and ``_fwd_kernel_mb`` under
``fused_window_mb=True``, at the sizes of tests/test_fused_final.py and
tests/test_fused_window_mb.py. The port's kernels are not reached on the
CPU: every wrapper runs its plain version (K11: the port's unfused eval
arithmetic batched over the eval batch; K12: the per-element plain window).

Tolerances: eval ranks EQUAL (the float paths agree to about 1e-6, far from
any rank-changing gap at these seeds); the per-batch BCE, losses and
gradients within 1e-5 relative to max(1, the largest entry), the helper of
tests/test_torch_train.py (float32 sums in another order).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.train.loop import Trainer as JaxTrainer
from temp_tpu_torch import _build
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import (
    build_answer_lists, make_synthetic, to_device,
)
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops import fused_final as ff
from temp_tpu_torch.ops import fused_window_mb as fmb
from temp_tpu_torch.ops.fused_window import fused_window_fwd
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.scores import complex_all
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import param_leaves
from test_torch_flagship import _open_impute, jax_draws_bi
from test_torch_post import _xla_unoptimized
from test_torch_train import _close, _pairs, _torch_params, jax_draws

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """XLA's optimizations off while this file's JAX references compile
    (``_xla_unoptimized``: about a third less compile time; the same
    arithmetic up to float32 rounding)."""
    with _xla_unoptimized():
        yield


# the sizes of tests/test_fused_final.py and tests/test_fused_window_mb.py
DATA = dict(num_ents=30, num_rels=4, num_times=10, edges_per_time=25,
            edge_pad_multiple=16)
KW = dict(module="GRRGCN", embed_size=16, hidden_size=16, n_bases=16,
          train_seq_len=4, batch_size=3, negative_rate=8, neg_oversample=8,
          num_pos_facts=100, seed=0)


def _jax_sweep(cfg, data, params, split):
    """(ranks of the real queries in sweep order, per-batch BCE) of the JAX
    trainer's eval sweep."""
    tr = JaxTrainer(cfg, jax_get_model(cfg, data), data, run_dir=None)
    tp, tv = tr._stack_batches(data.num_times, cfg.eval_batch, None)
    ranks, mask, bces = tr.eval_epoch(params, tr.data, tp, tv, split)
    mask = np.asarray(mask)
    return np.asarray(ranks)[mask], np.asarray(bces)


@pytest.fixture(scope="module")
def jax_eval():
    """(noact, split) -> {"xla": ..., "fused": ...} sweeps of the JAX
    package (fused_eval off and on; the XLA window), and the numpy params,
    computed on first use."""
    data = jax.device_put(jax_synthetic(**DATA))
    cache = {}

    def get(noact, split):
        if (noact, split) not in cache:
            base = dict(KW, dropout=0.0, fused_window=False,
                        fused_final=True, use_embed_for_non_active=noact)
            xla = JaxConfig(fused_eval=False, **base)
            params = jax_get_model(xla, data).init_params(
                jax.random.PRNGKey(0))
            cache[(noact, split)] = (
                {"xla": _jax_sweep(xla, data, params, split),
                 "fused": _jax_sweep(JaxConfig(fused_eval=True, **base), data,
                                     params, split)},
                jax.tree_util.tree_map(np.asarray, params))
        return cache[(noact, split)]

    return get


# -- (a) GRRGCN's eval through K11 -------------------------------------------

@pytest.mark.parametrize("eval_conv1", [True, False])
@pytest.mark.parametrize("noact", [False, True])
@pytest.mark.parametrize("split", ["valid", "test"])
def test_fused_eval_ranks_match_jax(jax_eval, split, noact, eval_conv1):
    """A whole sweep of `split` (the last batch padded with t_valid False)
    with fused_eval on: ranks equal to the JAX package's fused eval and to
    its XLA eval, the per-batch BCE within 1e-5."""
    refs, np_params = jax_eval(noact, split)
    cfg = TKGConfig(fused_eval=True, fused_window=True, dropout=0.0,
                    use_embed_for_non_active=noact, eval_conv1=eval_conv1,
                    **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.fused_eval_on() and not model.fused_window_mb_on(4)
    tr = Trainer(cfg, model, data)
    before = ff.fused_eval_ranks.launches
    ranks, mask, bces = tr.eval_sweep(params_from_numpy(np_params, "cpu"),
                                      split)
    assert ff.fused_eval_ranks.launches == before  # the CPU: plain
    got = ranks.numpy()[mask.numpy()]
    for name, (ref_ranks, ref_bces) in refs.items():
        np.testing.assert_array_equal(got, ref_ranks, err_msg=name)
        _close(bces.numpy(), ref_bces, name)
    assert len(got) == 2 * int(getattr(data, split).emask.sum()) > 0


def test_eval_answer_lists_match_total_filter_tables():
    """Each valid and test query slot's list is exactly its query's row of
    the TOTAL filter table's membership mask (padded slots: empty); the
    train table would miss the other splits' facts."""
    data = make_synthetic(**DATA)
    r2 = 2 * data.num_rels
    missed = 0
    for split in ("valid", "test"):
        edges = getattr(data, split)
        answers = build_answer_lists(data, split)
        for ptr, val, tbl, train_tbl, grp_ids in (
                (answers.tail_ptr, answers.tail_val, data.total_tail,
                 data.train_tail, edges.src),
                (answers.head_ptr, answers.head_val, data.total_head,
                 data.train_head, edges.dst)):
            assert ptr.shape == (data.num_times, edges.src.shape[1] + 1)
            for t in range(data.num_times):
                q = torch.from_numpy(grp_ids[t].astype(np.int64) * r2
                                     + edges.rel[t])
                mask, train_mask = (true_answer_mask(
                    torch.from_numpy(tb.grp[t]), torch.from_numpy(tb.val[t]),
                    q, data.num_ents).numpy() for tb in (tbl, train_tbl))
                for e in range(edges.src.shape[1]):
                    lst = val[ptr[t, e]:ptr[t, e + 1]]
                    want = (np.nonzero(mask[e])[0] if edges.emask[t, e]
                            else np.zeros(0, np.int64))
                    np.testing.assert_array_equal(lst, want)
                    if edges.emask[t, e]:
                        missed += int(mask[e].sum() - train_mask[e].sum())
    assert missed > 0


def test_planted_target_copies_do_not_count():
    """K11's plain ranking half on a table where a query's target row is
    copied into columns that scored below it: the copies score exactly as
    the target does and do not count, so the rank stays as it was; the
    target itself never counts."""
    data = to_device(make_synthetic(**DATA), "cpu")
    cfg = TKGConfig(fused_eval=True, **KW)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    tp = torch.tensor([5, 7, 2])
    B, N, d = 3, data.num_ents, cfg.embed_size
    _, q = ff.final_graph_eval(data, model.eval_answers["valid"], tp,
                               torch.zeros(B, N), 0.1, 4, False, "valid")
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(B, N, d, generator=gen)
    rtab = torch.randn(2 * data.num_rels, d, generator=gen)
    ranks, mask, _ = ff.table_ranks_plain(table, rtab, q)
    Q = q.src.shape[1]
    planted = table.clone()
    checked = []
    # one query an element, so no planted column changes another's rank
    for b, direction in enumerate(("tail", "head", "tail")):
        qi = int(torch.nonzero(q.mask[b] > 0)[0, 0])
        s, o, r = (int(x[b, qi]) for x in (q.src, q.dst, q.rel))
        target = o if direction == "tail" else s
        scores = complex_all(table[b, s if direction == "tail" else o][None],
                             rtab[r][None], table[b], direction)[0]
        ptr, ans = ((q.tail_ptr, q.tail_ans) if direction == "tail"
                    else (q.head_ptr, q.head_ans))
        known = set(ans[int(ptr[b, qi]):int(ptr[b, qi + 1])].tolist())
        below = [c for c in torch.argsort(scores).tolist()
                 if c not in known | {s, o}
                 and scores[c] < scores[target] - 1e-3][:3]
        assert len(below) == 3
        planted[b, below] = table[b, target]
        checked.append((b, qi + (Q if direction == "tail" else 0)))
    got, _, _ = ff.table_ranks_plain(planted, rtab, q)
    for b, col in checked:
        assert int(got[b, col]) == int(ranks[b, col]), (b, col)
    assert bool((ranks[mask] >= 1).all())


def test_flagship_evaluates_through_its_own_path_under_fused_eval(tmp_path):
    """BiGRRGCN --impute lies outside K11's envelope: with fused_eval on it
    evaluates one element at a time, as the JAX package does, with ranks
    equal to JAX's (which falls back too)."""
    kw = dict(KW, module="BiGRRGCN", impute=True, train_seq_len=3,
              batch_size=2, dropout=0.0, fused_eval=True)
    jdata = jax_synthetic(**DATA)
    jcfg = JaxConfig(fused_window=False, fused_final=True, **kw)
    jmodel = jax_get_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(2))
    ref, _ = _jax_sweep(jcfg, jax.device_put(jdata), params, "valid")
    cfg = TKGConfig(fused_window=True, **kw)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    assert cfg.fused_eval_on("cpu") and not model.fused_eval_on()
    assert model.eval_answers == {}
    tr = Trainer(cfg, model, make_synthetic(**DATA))
    ranks, mask, _ = tr.eval_sweep(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"), "valid")
    np.testing.assert_array_equal(ranks.numpy()[mask.numpy()], ref)


def test_fused_eval_envelope():
    cfg = TKGConfig(**KW)
    assert ff.fused_eval_supported(cfg, "GRRGCN")
    # unlike the training kernels, the eval needs no negative pool
    assert ff.fused_eval_supported(cfg.replace(negative_pool="per_query"),
                                   "GRRGCN")
    for out in (cfg.replace(score_function="distmult"),
                cfg.replace(n_bases=8), cfg.replace(learnable_lambda=True),
                cfg.replace(embed_size=24, hidden_size=24, n_bases=24),
                cfg.replace(embed_size=256, hidden_size=256, n_bases=256),
                cfg.replace(impute=True)):
        assert not ff.fused_eval_supported(out, "GRRGCN")
    assert not ff.fused_eval_supported(cfg, "GRRGCN", activation2="relu")
    assert not ff.fused_eval_supported(cfg, "SRGCN")
    data = make_synthetic(**DATA)
    assert not get_model(cfg, data, device="cpu").fused_eval_on()
    assert get_model(cfg.replace(fused_eval="on"), data,
                     device="cpu").fused_eval_on()
    assert cfg.replace(fused_eval="auto").fused_eval_on("cuda")
    assert not cfg.replace(fused_eval="auto").fused_eval_on("cpu")


# -- (e) the batched window, K12 ---------------------------------------------

T_MB = [5, 7, 2, 8]


@pytest.fixture(scope="module")
def jax_mb():
    """case -> (loss, grads, numpy params, draws) of the JAX package's
    batched-window path (fused_window_mb, fused final step), computed on
    first use; the flagship with impute scalars whose clamp is open."""
    data = jax.device_put(jax_synthetic(**DATA))
    cache = {}

    def get(case):
        if case not in cache:
            flagship, dropout = case
            kw = dict(KW, batch_size=4, dropout=dropout, fused_final=True,
                      fused_window=True, fused_window_mb=True)
            if flagship:
                kw.update(module="BiGRRGCN", impute=True)
            cfg = JaxConfig(**kw)
            model = jax_get_model(cfg, data)
            params = model.init_params(jax.random.PRNGKey(0))
            if flagship:
                params = _open_impute(params)
            assert model._use_mb(data, 4, cfg.train_seq_len, True,
                                 with_loc=flagship)
            rng = jax.random.PRNGKey(1)
            tv = jnp.asarray([True] * 4)
            loss, grads = jax.jit(jax.value_and_grad(lambda p: model.loss(
                p, data, jnp.asarray(T_MB, jnp.int32), tv, rng)))(params)
            draw = jax_draws_bi if flagship else jax_draws
            cache[case] = (float(loss), grads,
                           jax.tree_util.tree_map(np.asarray, params),
                           draw(cfg, data, T_MB, rng))
        return cache[case]

    return get


@pytest.mark.parametrize("case", [(False, 0.0), (False, 0.1), (True, 0.1)],
                         ids=["grrgcn-dropout0", "grrgcn-dropout0.1",
                              "flagship-dropout0.1"])
def test_batched_window_loss_and_grads_match_jax(jax_mb, case):
    flagship, dropout = case
    ref_loss, ref_grads, np_params, draws = jax_mb(case)
    kw = dict(KW, batch_size=4, dropout=dropout, fused_final=True,
              fused_window=True, fused_window_mb=True)
    if flagship:
        kw.update(module="BiGRRGCN", impute=True)
    data = make_synthetic(**DATA)
    model = get_model(TKGConfig(**kw), data, device="cpu")
    assert model.fused_window_mb_on(4, train=True)
    assert model.fused_window_mb_on(4) != flagship  # JAX: not in Post eval
    params = _torch_params(np_params)
    before = (fmb.fused_window_mb_fwd.launches, fused_window_fwd.launches)
    loss = model.loss(params, to_device(data, "cpu"), T_MB, [True] * 4,
                      draws=draws)
    loss.backward()
    assert (fmb.fused_window_mb_fwd.launches,
            fused_window_fwd.launches) == before  # the CPU: plain
    assert abs(loss.item() - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        n += 1
    assert n == len(param_leaves(params))


@pytest.mark.parametrize("eval_conv1", [True, False])
def test_batched_window_eval_ranks_match_jax(jax_eval, eval_conv1):
    """A valid sweep through K12 (and K11): ranks equal to JAX's."""
    refs, np_params = jax_eval(False, "valid")
    cfg = TKGConfig(fused_window_mb=True, fused_eval=True, fused_window=True,
                    dropout=0.0, eval_conv1=eval_conv1, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.fused_window_mb_on(4) and not model.fused_window_mb_on(1)
    tr = Trainer(cfg, model, data)
    ranks, mask, _ = tr.eval_sweep(params_from_numpy(np_params, "cpu"),
                                   "valid")
    np.testing.assert_array_equal(ranks.numpy()[mask.numpy()],
                                  refs["xla"][0])


def test_batched_window_refuses_drop_rates():
    """The JAX package's batched window drops per-step DropEdge rates
    without a word; the port refuses them."""
    cfg = TKGConfig(**KW)
    model = get_model(cfg, make_synthetic(**DATA), device="cpu")
    params = model.init_params(0)
    B, L1, A, E, d = 2, 3, 8, 5, 16
    z = torch.zeros(B, L1, E, dtype=torch.long)
    a = torch.zeros(B, L1, A, dtype=torch.long)
    args = (params["encoder"], cfg, model.lc2, torch.zeros(B, L1, A, d), z,
            z, z, z.bool(), a, a, a.float(), a.bool(), None, False, 2)
    bufs = fmb.fused_window_scan_mb(*args)
    assert len(bufs) == 2 and bufs[0].shape == (B, L1, A, d)
    with pytest.raises(NotImplementedError, match="drop rates"):
        fmb.fused_window_scan_mb(*args, drop_rates=torch.full((B, L1), 0.5))
    with pytest.raises(ValueError, match="eval-only"):
        fmb.fused_window_scan_mb(*args[:13], True, 2, conv1_in=True)


# -- (g) the K11 launches, without a card ------------------------------------

def test_k11_signatures_match_the_sources():
    src = "".join(open(p).read() for p in _build.SOURCES)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    for name in ("final_ranks_launch", "final_rank_reduce_launch"):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                      re.S)
        assert m, name
        types = [kinds[a.strip().rsplit(" ", 1)[0].strip()]
                 for a in m.group(1).split(",")]
        assert types == _build.SIGNATURES[name], name


def test_fused_eval_launches_match_the_library_signatures(monkeypatch):
    """The CUDA path's plumbing, rehearsed on the CPU: with the device check
    and the library replaced by a recorder, one eval batch with fused_eval
    on makes K3's two layer launches, then the rank and reduce launches,
    each with the argument count and types ``_build.SIGNATURES`` declares;
    K11's counter goes up by four."""
    kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
             ctypes.c_float: float}
    calls = []

    class Recorder:
        def __getattr__(self, name):
            sig = _build.SIGNATURES[name]

            def launch(*args):
                assert len(args) == len(sig), name
                for a, t in zip(args, sig):
                    assert isinstance(a, kinds[t]) and not isinstance(
                        a, bool), (name, a)
                calls.append(name)
                return 0
            return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(ff, "_device", lambda name, t: "cuda")
    cfg = TKGConfig(fused_eval=True, fused_window=False, dropout=0.0,
                    use_embed_for_non_active=True, **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    before = ff.fused_eval_ranks.launches
    ranks, mask, _ = model.eval_ranks(model.init_params(0),
                                      to_device(data, "cpu"), [5, 7, 2],
                                      [True, True, False], "test")
    assert calls == ["final_layer_launch"] * 2 + [
        "final_ranks_launch", "final_rank_reduce_launch"]
    assert ff.fused_eval_ranks.launches - before == 4
    Q = data.test.src.shape[1]
    assert ranks.shape == mask.shape == (3, 2 * Q)
    assert ranks.dtype == torch.int32 and not bool(mask[2].any())
