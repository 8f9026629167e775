"""The embedding baselines (Static, DE, ATiSE, Hyte, SimplE),
TimeDynamicRGCN and the Aggregator of temp_tpu_torch against the JAX
package on the CPU, float32, and their CLI runs.

Each model runs the JAX package's loss, gradients and eval ranks of one
compiled function on the port's seeded weights; the port gets the JAX
draws, rebuilt by each loss's key derivation: the baselines' and the
Aggregator's split(rng, B)[b] split into (k_pos, k_tail, k_head)
(temp_tpu/models/baselines.py, aggregator.py); TimeDynamicRGCN's as
GRRGCN's on the XLA scan (``test_torch_post.jax_draws_scan``), one of
its windows running off t = 0. The Aggregator takes its checkpoint path:
the JAX debug path's seeded submodels (SRGCN from the seed, BiGRRGCN from
seed + 1) are written as two port run directories, config.json and
checkpoints/best.pt, which the port's Aggregator loads.

Tolerances: 1e-5 relative to max(1, the largest entry) for losses and
gradients; eval ranks equal on the same mask; eval BCE within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.config import TKGConfig as JaxConfig
from temp_tpu.data.snapshots import make_synthetic as jax_synthetic
from temp_tpu.models.registry import get_model as jax_get_model
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu_torch.bridge import params_from_numpy
from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, to_device
from temp_tpu_torch.main import main
from temp_tpu_torch.models import aggregator, baselines, timedynamic
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.train.checkpoint import save_checkpoint
from temp_tpu_torch.train.loop import load_checkpoint_params
from temp_tpu_torch.train.optim import param_leaves
from test_torch_decoders import jax_draws_neg
from test_torch_post import _xla_unoptimized, jax_draws_scan
from test_torch_slice import one_thread  # noqa: F401
from test_torch_train import _close, _pairs, _torch_params, _write_dataset


# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embed_size=16, hidden_size=16, n_bases=16, train_seq_len=3,
          batch_size=2, seed=0, num_pos_facts=100, dropout=0.1,
          negative_rate=8, neg_oversample=8)
DATA = dict(num_ents=30, num_rels=4, num_times=10, edge_pad_multiple=16,
            edges_per_time=25)
# t = 1's window of 3 runs off t = 0
T_POS = [5, 1]
# tag -> (flags, the port's class)
CASES = {
    "static": ({"module": "Static"}, baselines.StaticModel),
    "de": ({"module": "DE", "negative_pool": "per_query"},
           baselines.DiachronicEmbeddingModel),
    "atise": ({"module": "AtiSE", "score_function": "distmult"},
              baselines.AtiSEModel),
    "hyte": ({"module": "Hyte", "negative_pool": "shared"},
             baselines.HyteModel),
    "simple": ({"module": "Simple"}, baselines.SimplEModel),
    "simple_shared": ({"module": "SimplE", "negative_pool": "shared"},
                      baselines.SimplEModel),
    "tdyn": ({"module": "TimeDynamicRGCN"},
             timedynamic.TimeDynamicRGCNModel),
    "agg": ({"module": "Aggregator", "temporal_module": "BiGRRGCN"},
            aggregator.AggregatorModel),
}


# the leaves the new models add (and the entity table): each learns
_OWN_LEAVES = ("ent_embeds", "w_temp", "b_temp", "time_embeds",
               "ent_embeds_inv", "rel_embeds_inv")


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_run(run_dir, cfg: TKGConfig, np_params):
    """A port run directory: config.json and checkpoints/best.pt."""
    run_dir.mkdir(parents=True)
    (run_dir / "config.json").write_text(cfg.to_json())
    save_checkpoint(str(run_dir / "checkpoints" / "best.pt"),
                    params_from_numpy(np_params, device="cpu"), None, 0,
                    {"mrr": 0.5})
    return str(run_dir)


def _port(tag, tmp_path_factory=None, js=None):
    """(cfg, data, model) of the port; the Aggregator from two run
    directories of the JAX side's submodels."""
    flags = CASES[tag][0]
    data = make_synthetic(**DATA)
    if tag == "agg":
        root = tmp_path_factory.mktemp("agg_runs")
        runs = {}
        for name, module, sub in (
                ("spatial", "SRGCN", js["model"].spatial_params),
                ("temporal", "BiGRRGCN", js["model"].temporal_params)):
            runs[name] = _write_run(
                root / name, TKGConfig(fused_window=True, module=module,
                                       **KW), _to_numpy(sub))
        flags = dict(flags, spatial_checkpoint=runs["spatial"],
                     temporal_checkpoint=runs["temporal"])
    cfg = TKGConfig(fused_window=True, fused_final=True, **KW, **flags)
    return cfg, data, get_model(cfg, data, device="cpu")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """tag -> the JAX model, config, data, params and "out": one compiled
    function's ((loss, grads) of the batch T_POS at key 1, (ranks, mask,
    loss) of an eval batch of every time on the valid split); the
    baselines and TimeDynamicRGCN on the port's seeded init, the
    Aggregator on its debug path's submodels and gates; built on first
    use (one compile a case)."""
    cache = {}

    def get(tag):
        if tag not in cache:
            flags = CASES[tag][0]
            cfg = JaxConfig(fused_window=False, fused_final=False, **KW,
                            **flags)
            data = jax.device_put(jax_synthetic(**DATA))
            model = jax_get_model(cfg, data)
            if tag == "agg":
                params = model.init_params(jax.random.PRNGKey(0))
            else:
                own = _port(tag)[2].init_params(0)
                params = jax.tree_util.tree_map(
                    lambda t: jnp.asarray(t.numpy()), own)
            tp = jnp.asarray(T_POS, jnp.int32)
            tv = jnp.asarray([True, True])
            T = data.num_times

            def run(p, r):
                return (jax.value_and_grad(
                    lambda q: model.loss(q, data, tp, tv, r))(p),
                    model.eval_ranks(p, data, jnp.arange(T, dtype=jnp.int32),
                                     jnp.ones(T, bool), "valid"))

            key = jax.random.PRNGKey(1)
            with _xla_unoptimized():
                out = jax.jit(run).lower(params, key).compile()(params, key)
            cache[tag] = dict(cfg=cfg, data=data, model=model, key=key,
                              params=params, out=out)
        return cache[tag]

    return get


def _draws(tag, js):
    """The JAX loss's draws of the batch T_POS, as the port takes them."""
    cfg, data, key = js["cfg"], js["data"], js["key"]
    if tag == "tdyn":
        draws = jax_draws_scan(cfg, data, T_POS, key)
    else:
        draws = {"pos": torch.from_numpy(np.stack([np.asarray(
            jax_subsample_pos(jax.random.split(r, 3)[0],
                              data.train.emask[t], cfg.num_pos_facts))
            for t, r in zip(T_POS, jax.random.split(key, len(T_POS)))]))}
    draws.update(jax_draws_neg(cfg, data, T_POS, key,
                               split_fwd=tag == "tdyn"))
    return draws


@pytest.mark.parametrize("tag", list(CASES))
def test_loss_and_grads_match_reference(jax_side, tmp_path_factory, tag,
                                        one_thread):
    js = jax_side(tag)
    (ref_loss, ref_grads), _ = js["out"]
    cfg, data, model = _port(tag, tmp_path_factory, js)
    assert type(model) is CASES[tag][1]
    assert not model.fused_final_on()
    assert model.precompute_eval_conv1(None, data) is None
    params = _torch_params(_to_numpy(js["params"]))
    loss = model.loss(params, to_device(data, "cpu"), T_POS, [True, True],
                      draws=_draws(tag, js))
    loss.backward()
    _close(loss.item(), float(ref_loss), "loss")
    n = 0
    for path, ref, got in _pairs(ref_grads, params):
        grad = torch.zeros_like(got) if got.grad is None else got.grad
        _close(grad.numpy(), np.asarray(ref), path)
        if path.split("/")[-1] in _OWN_LEAVES:
            assert float(grad.abs().max()) > 0, path
        n += 1
    assert n == len(param_leaves(params))
    if tag == "agg":
        # only the gates train; the submodels stay as their checkpoints
        assert set(params) == {"gates"}
        for sub, ref_sub in ((model.spatial_params,
                              js["model"].spatial_params),
                             (model.temporal_params,
                              js["model"].temporal_params)):
            for path, ref, got in _pairs(ref_sub, sub):
                assert not got.requires_grad and got.grad is None, path
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tag", list(CASES))
def test_eval_ranks_match_reference(jax_side, tmp_path_factory, tag):
    js = jax_side(tag)
    _, (ref_ranks, ref_mask, ref_loss) = js["out"]
    ref_ranks, ref_mask = np.asarray(ref_ranks), np.asarray(ref_mask)
    cfg, data, model = _port(tag, tmp_path_factory, js)
    params = params_from_numpy(_to_numpy(js["params"]), device="cpu")
    T = DATA["num_times"]
    with torch.no_grad():
        ranks, mask, loss = model.eval_ranks(
            params, to_device(data, "cpu"), np.arange(T, dtype=np.int32),
            np.ones(T, bool), "valid")
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    assert ref_mask.sum() > 0
    np.testing.assert_array_equal(ranks.numpy()[ref_mask],
                                  ref_ranks[ref_mask])
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    if tag in ("simple", "simple_shared", "agg"):
        # no eval loss, as in the reference
        assert float(ref_loss) == 0.0 == float(loss)


def test_time_dynamic_inputs_follow_the_time_position():
    """The diachronic features: 80% static columns, the rest times the
    sine at the time position, the padding id reading the last row, and
    the window's hook equal to the table's rows at each step's
    position."""
    cfg = TKGConfig(module="TimeDynamicRGCN", **KW)
    data = make_synthetic(**DATA)
    model = get_model(cfg, data, device="cpu")
    assert model.cfg.module == "GRRGCN" and model.static_size == 12
    p = model.init_params(0)
    assert tuple(p["w_temp"].shape) == (DATA["num_ents"], 4)
    at3 = model.input_embeddings(p, 3)
    assert torch.equal(at3[:, :12], p["ent_embeds"][:, :12])
    assert not torch.equal(at3, model.input_embeddings(p, 4))
    rows = torch.tensor([[0, 7, DATA["num_ents"]], [2, 2, 5]])
    got = model.input_embeddings_rows(p, torch.tensor([3, 0]), rows)
    assert torch.equal(got[0, :2], at3[[0, 7]])
    assert torch.equal(got[0, 2], at3[-1])
    assert torch.equal(got[1], model.input_embeddings(p, 0)[[2, 2, 5]])


def test_load_checkpoint_params_round_trip(tmp_path):
    cfg = TKGConfig(module="DE", **KW)
    data = make_synthetic(**DATA)
    params = get_model(cfg, data, device="cpu").init_params(3)
    run = _write_run(tmp_path / "run", cfg, _to_numpy(
        jax.tree_util.tree_map(lambda t: t.numpy(), params)))
    got_cfg, got, blob = load_checkpoint_params(run, device="cpu")
    assert got_cfg == cfg and blob["epoch"] == 0
    assert blob["metrics"] == {"mrr": 0.5} and blob["opt_state"] is None
    for path, ref, t in _pairs(params, got):
        assert torch.equal(ref, t), path


# -- the CLI ------------------------------------------------------------------

_CLI = ["--device", "cpu", "--fast-dev-run", "--dataset", "tiny",
        "--edge-pad-multiple", "16", "--embed-size", "16", "--hidden-size",
        "16", "--n-bases", "16", "--train-seq-len", "3", "--batch-size",
        "2", "--negative-rate", "8", "--neg-oversample", "8"]


def _cli(root, runs, name, *args):
    return main(["-c", os.path.join(ROOT, "grid", "icews14",
                                    "config_grrgcn.json"), "--data-root",
                 root, "--experiments-dir", runs, "--model-name", name,
                 *_CLI, *args])


@pytest.mark.parametrize("args", [
    ("--module", "DE"), ("--module", "Hyte"), ("--module", "SimplE"),
    ("--module", "TimeDynamicRGCN"),
    ("--score-function", "transE", "--negative-pool", "per_query")])
def test_main_cli_trains_on_cpu(tmp_path, args, capsys):
    root = _write_dataset(tmp_path / "data")
    test = _cli(root, str(tmp_path / "runs"), "run", *args)
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "test: mrr=" in out
    assert 0.0 < test["mrr"] <= 1.0 and test["n"] > 0


def test_main_cli_trains_the_aggregator_on_cpu(tmp_path, capsys):
    """Two runs the port wrote (SRGCN, BiGRRGCN), then the Aggregator on
    their checkpoints: only its gates in its own checkpoint."""
    root = _write_dataset(tmp_path / "data")
    runs = str(tmp_path / "runs")
    _cli(root, runs, "spatial", "--module", "SRGCN")
    _cli(root, runs, "temporal", "--module", "BiGRRGCN")
    test = _cli(root, runs, "agg", "--module", "Aggregator",
                "--spatial-checkpoint", f"{runs}/spatial",
                "--temporal-checkpoint", f"{runs}/temporal")
    assert "module=Aggregator" in capsys.readouterr().out
    assert 0.0 < test["mrr"] <= 1.0
    ckpt = torch.load(tmp_path / "runs" / "agg" / "checkpoints" / "best.pt",
                      weights_only=True)
    assert set(ckpt["params"]) == {"gates"}
    assert set(ckpt["params"]["gates"]) == {"subject", "object"}



# every --module of the JAX package's registry, the reference CLI's aliases
# among them (temp_tpu/models/registry.py)
_JAX_MODULES = ("GRRGCN", "RRGCN", "BiGRRGCN", "BiRRGCN", "SARGCN",
                "BiSARGCN", "SRGCN", "DRGCN", "Static", "DE", "Hyte",
                "SimplE", "Simple", "ATiSE", "AtiSE", "Aggregator",
                "TimeDynamicRGCN")


@pytest.mark.parametrize("module", _JAX_MODULES)
def test_registry_builds_every_module_decoder_and_pool(module):
    """get_model builds and initializes every module of the JAX registry
    with each decoder and each negative pool, as JAX's does; an unknown
    module raises as JAX's does; under an edge partition only GRRGCN and
    BiGRRGCN with ComplEx and the "all" pool run."""
    data = make_synthetic(**DATA)
    for name in ("complex", "distmult", "transE"):
        for pool in ("all", "shared", "per_query"):
            cfg = TKGConfig(module=module, score_function=name,
                            negative_pool=pool, **KW)
            model = get_model(cfg, data, device="cpu")
            jax_model = jax_get_model(JaxConfig(
                module=module, score_function=name, negative_pool=pool,
                **KW), jax_synthetic(**DATA))
            assert type(model).__name__ == type(jax_model).__name__, cfg
            assert model.init_params(0)
            part = cfg.replace(edge_partition="psum", mp_size=2)
            if (module in ("GRRGCN", "BiGRRGCN")
                    and (name, pool) == ("complex", "all")):
                get_model(part, data, device="cpu")
            else:
                with pytest.raises(NotImplementedError):
                    get_model(part, data, device="cpu")
    with pytest.raises(ValueError):
        get_model(TKGConfig(module=module + "X", **KW), data, device="cpu")
