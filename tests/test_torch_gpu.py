"""temp_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU; where there is none they skip (the fixture decides
at run time, so every worker collects the same tests). Run them on a card
with ``python -m pytest tests/test_torch_gpu.py -m gpu``.

Tolerance 1e-4 absolute: the kernels sum in another order than the plain
versions (f32, values of order one, up to 14 recurrent steps), and TF32 is
off for the plain versions' matrix products. Gradients that sum over many
rows (weight cotangents: up to B*L1*A = 71,680 rows) are held to 1e-4
relative to max(1, the largest entry): f32 sums of that many terms in
another order differ by about sqrt(n) * 6e-8 of the terms' size.
"""

import numpy as np
import pytest
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.ops.fused_window import (
    fused_window_bwd, fused_window_fwd, fused_window_scan,
)
from temp_tpu_torch.ops.spmm import (
    spmm, spmm_bwd, spmm_bwd_plain, spmm_fwd, spmm_fwd_plain,
)
from temp_tpu_torch.train.loop import Trainer
from temp_tpu_torch.train.optim import param_leaves

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, rel=1e-4):
    """max |a - b| <= rel * max(1, max |b|)."""
    return float((a - b).abs().max()) <= rel * max(1.0, float(b.abs().max()))


def _graph(n, e, r, d, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    w = torch.randn(r, d, generator=g)
    src = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, max(1, n // 2), (e,), generator=g,
                        dtype=torch.int32)  # half the rows get no edges
    rel = torch.randint(0, r, (e,), generator=g, dtype=torch.int32)
    em = torch.rand(e, generator=g) < 0.8
    return [t.to(dev) for t in (h, src, dst, rel, em, w)]


@pytest.mark.parametrize("n,e,r,d", [(7128, 256, 460, 128), (50, 0, 3, 32),
                                     (300, 5000, 7, 256), (33, 90, 4, 16)])
def test_spmm_kernel_matches_plain(cuda, n, e, r, d):
    args = _graph(n, e, r, d, cuda)
    before = spmm_fwd.launches
    out = spmm_fwd(*args)
    torch.cuda.synchronize()
    assert spmm_fwd.launches == before + 1
    ref = spmm_fwd_plain(*args)
    assert float((out - ref).abs().max()) <= TOL


def test_spmm_kernel_refuses_what_it_does_not_take(cuda):
    h, src, dst, rel, em, w = _graph(20, 30, 3, 16, cuda)
    with pytest.raises(TypeError):
        spmm_fwd(h.double(), src, dst, rel, em, w.double())
    with pytest.raises(ValueError):
        spmm_fwd(h.t(), src, dst, rel, em, w)
    with pytest.raises(ValueError):
        spmm_fwd(h, src.cpu(), dst, rel, em, w)
    big = torch.zeros(4, 512, device=cuda)
    with pytest.raises(ValueError):
        spmm_fwd(big, src[:2] % 4, dst[:2] % 4, rel[:2] % 3, em[:2],
                 torch.zeros(3, 512, device=cuda))


def _window_args(B, L1, A, E, d, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    prev_step = torch.randint(-1, L1, (B, L1, A), generator=g)
    prev_step = torch.minimum(prev_step,
                              torch.arange(L1)[None, :, None] - 1)
    kw = dict(
        h0_xs=torch.randn(B, L1, A, d, generator=g) * 0.5,
        src=torch.randint(0, A, (B, L1, E), generator=g),
        dst=torch.randint(0, A, (B, L1, E), generator=g),
        rel=torch.randint(0, 9, (B, L1, E), generator=g),
        emask=torch.rand(B, L1, E, generator=g) < 0.9,
        prev_step=prev_step,
        prev_row=torch.randint(0, A, (B, L1, A), generator=g),
    )
    kw["live"] = kw["prev_step"] >= 0
    kw["dt"] = (torch.arange(L1)[None, :, None]
                - kw["prev_step"].clamp(min=0)).float()
    kw = {k: v.to(dev) for k, v in kw.items()}

    def lin(*s):
        return (torch.rand(*s, generator=g) - 0.5).to(dev) * 0.5

    enc = {f"layer{i}": {"weight": lin(9, d), "loop_weight": lin(d, d),
                         "gru": [{"w_ih": lin(3 * d, d),
                                  "w_hh": lin(3 * d, d),
                                  "b_ih": lin(3 * d), "b_hh": lin(3 * d)}]}
           for i in (1, 2)}
    return enc, kw


@pytest.mark.parametrize("conv1_in", [True, False])
@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 37, 20, 16),
                                        (2, 3, 100, 300, 256)])
def test_window_kernel_matches_plain(cuda, conv1_in, B, L1, A, E, d):
    enc, kw = _window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    before = fused_window_fwd.launches
    k1, k2 = fused_window_scan(enc, cfg, conv1_in=conv1_in, **kw)
    torch.cuda.synchronize()
    assert fused_window_fwd.launches == before + 2 * L1
    p1, p2 = fused_window_scan(enc, cfg, conv1_in=conv1_in, kernels=False,
                               **kw)
    assert float((k1 - p1).abs().max()) <= TOL
    assert float((k2 - p2).abs().max()) <= TOL


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    enc, kw = _window_args(2, 3, 10, 8, 16, cuda)
    cfg = TKGConfig(embed_size=16, hidden_size=16, n_bases=16)
    with pytest.raises(TypeError):
        fused_window_scan(enc, cfg, **{**kw, "h0_xs": kw["h0_xs"].double()})
    with pytest.raises(ValueError):  # h0x batch does not match the edges
        fused_window_scan(enc, cfg, **{**kw, "h0_xs": kw["h0_xs"][:1]})


def test_run_eval_kernels_match_plain_path(cuda):
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    out = {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128,
                        train_seq_len=6, batch_size=4, kernels=kernels)
        model = get_model(cfg, data, device=cuda)
        params = model.init_params(0)
        spmm_fwd.launches = fused_window_fwd.launches = 0
        out[kernels] = Trainer(cfg, model, data).eval_sweep(params, "valid")
        if kernels:
            assert spmm_fwd.launches > 0 and fused_window_fwd.launches > 0
        else:
            assert spmm_fwd.launches == fused_window_fwd.launches == 0
    (rk, mk, bk), (rp, mp, bp) = out[True], out[False]
    assert torch.equal(mk, mp)
    same = float((rk[mk] == rp[mp]).float().mean())
    assert same >= 0.99
    assert float((bk - bp).abs().max()) <= TOL
    mrr_k = float((1.0 / rk[mk].double()).mean())
    mrr_p = float((1.0 / rp[mp].double()).mean())
    assert abs(mrr_k - mrr_p) <= TOL
    assert np.isfinite(mrr_k)


@pytest.mark.parametrize("n,e,r,d", [(7128, 128, 460, 128), (50, 0, 3, 32),
                                     (300, 5000, 7, 256), (33, 90, 4, 16)])
def test_spmm_bwd_kernel_matches_plain(cuda, n, e, r, d):
    h, src, dst, rel, em, w = _graph(n, e, r, d, cuda)
    g = torch.randn(n, d, device=cuda)
    deg = torch.zeros(n, device=cuda).index_add_(0, dst.long(), em.float())
    n2 = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0) ** 2
    before = spmm_bwd.launches
    dh, dw = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    torch.cuda.synchronize()
    assert spmm_bwd.launches == before + 1
    rh, rw = spmm_bwd_plain(g, n2, h, src, dst, rel, em, w)
    assert _close(dh, rh) and _close(dw, rw)


def test_spmm_autograd_matches_plain_autograd(cuda):
    h, src, dst, rel, em, w = _graph(400, 900, 11, 128, cuda)
    g = torch.randn(400, 128, device=cuda)
    grads = []
    for fn in (spmm, spmm_fwd_plain):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(hh, src, dst, rel, em, ww) * g).sum().backward()
        grads.append((hh.grad, ww.grad))
    (kh, kw), (ph, pw) = grads
    assert _close(kh, ph) and _close(kw, pw)


def _train_window_args(B, L1, A, E, d, dev, seed=0, rate=0.1):
    """Window inputs whose history tables come from simulated entity
    activity, as data/snapshots.build_history_tables makes them: each
    live row names the row of its entity's last earlier step, so no two
    live rows name the same row. Plus seeded dropout masks over keep."""
    enc, kw = _window_args(B, L1, A, E, d, dev, seed)
    rs = np.random.RandomState(seed)
    prev_step = np.full((B, L1, A), -1, np.int64)
    prev_row = np.zeros((B, L1, A), np.int64)
    for b in range(B):
        last = {}
        for k in range(L1):
            ents = rs.permutation(2 * A)[:A]
            for a, ent in enumerate(ents):
                if ent in last:
                    prev_step[b, k, a], prev_row[b, k, a] = last[ent]
            for a, ent in enumerate(ents):
                last[ent] = (k, a)
    kw["prev_step"] = torch.from_numpy(prev_step).to(dev)
    kw["prev_row"] = torch.from_numpy(prev_row).to(dev)
    kw["live"] = kw["prev_step"] >= 0
    kw["dt"] = (torch.arange(L1, device=dev)[None, :, None]
                - kw["prev_step"].clamp(min=0)).float()
    keep = 1.0 - rate
    g = torch.Generator(device=dev).manual_seed(seed)
    masks = tuple((torch.rand(B, L1, A, d, generator=g, device=dev) < keep)
                  .float() / keep for _ in range(2))
    return enc, kw, masks


def _leaves(enc, h0):
    return [h0] + param_leaves(enc)


@pytest.mark.parametrize("B,L1,A,E,d", [(8, 14, 640, 256, 128),
                                        (3, 4, 37, 20, 16),
                                        (2, 3, 100, 300, 64)])
def test_window_train_kernels_match_plain_autograd(cuda, B, L1, A, E, d):
    enc, kw, masks = _train_window_args(B, L1, A, E, d, cuda)
    cfg = TKGConfig(embed_size=d, hidden_size=d, n_bases=d)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = [torch.randn(B, L1, A, d, generator=gen, device=cuda)
           for _ in range(2)]
    res = {}
    for kernels in (True, False):
        e = {k: {"weight": v["weight"].clone().requires_grad_(),
                 "loop_weight": v["loop_weight"].clone().requires_grad_(),
                 "gru": [{n: t.clone().requires_grad_()
                          for n, t in v["gru"][0].items()}]}
             for k, v in enc.items()}
        h0 = kw["h0_xs"].clone().requires_grad_()
        fb, bb = fused_window_fwd.launches, fused_window_bwd.launches
        b1, b2 = fused_window_scan(e, cfg, kernels=kernels, masks=masks,
                                   **{**kw, "h0_xs": h0})
        ((b1 * cot[0]).sum() + (b2 * cot[1]).sum()).backward()
        torch.cuda.synchronize()
        if kernels:
            assert fused_window_fwd.launches == fb + 2 * L1
            assert fused_window_bwd.launches == bb + 5 * L1 + 2
        res[kernels] = (b1.detach(), b2.detach(),
                        [t.grad for t in _leaves(e, h0)])
    (k1, k2, kg), (p1, p2, pg) = res[True], res[False]
    assert float((k1 - p1).abs().max()) <= TOL
    assert float((k2 - p2).abs().max()) <= TOL
    assert len(kg) == 13  # h0x, and per layer weight, loop, 4 GRU tensors
    for a, b in zip(kg, pg):
        assert _close(a, b)


def test_window_bwd_refuses_what_it_does_not_take(cuda):
    enc, kw, masks = _train_window_args(2, 3, 10, 8, 16, cuda)
    cfg = TKGConfig(embed_size=16, hidden_size=16, n_bases=16)
    h0 = kw["h0_xs"].clone().requires_grad_()
    b1, b2 = fused_window_scan(enc, cfg, masks=masks, **{**kw, "h0_xs": h0})
    with pytest.raises(RuntimeError):  # conv1_in has no backward
        c1, _ = fused_window_scan(enc, cfg, conv1_in=True,
                                  **{**kw, "h0_xs": h0})
        c1.sum().backward()
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_window_scan(enc, cfg, masks=(masks[0][:1], masks[1]), **kw)
    enc2, kw2, masks2 = _train_window_args(1, 2, 8, 4, 256, cuda)
    cfg2 = TKGConfig(embed_size=256, hidden_size=256, n_bases=256)
    h2 = kw2["h0_xs"].clone().requires_grad_()
    out, _ = fused_window_scan(enc2, cfg2, masks=masks2,
                               **{**kw2, "h0_xs": h2})
    with pytest.raises(ValueError):  # d = 256: no backward kernel
        out.sum().backward()
    h, src, dst, rel, em, w = _graph(20, 30, 3, 16, cuda)
    n2 = torch.ones(20, device=cuda)
    with pytest.raises(ValueError):  # g of the wrong shape
        spmm_bwd(torch.zeros(20, 8, device=cuda), n2, h, src, dst, rel, em, w)
    with pytest.raises(TypeError):
        spmm_bwd(h.double(), n2.double(), h.double(), src, dst, rel, em,
                 w.double())


def test_training_steps_kernels_match_plain_path(cuda):
    data = make_synthetic(num_ents=300, num_rels=12, num_times=20,
                          edges_per_time=60, seed=1, edge_pad_multiple=128)
    losses, finals = {}, {}
    for kernels in (True, False):
        cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128,
                        train_seq_len=6, batch_size=4, kernels=kernels,
                        num_pos_facts=40)
        model = get_model(cfg, data, device=cuda)
        tr = Trainer(cfg, model, data)
        params, opt = tr.init_state(0)
        counts = (spmm_fwd.launches, spmm_bwd.launches,
                  fused_window_fwd.launches, fused_window_bwd.launches)
        losses[kernels] = []
        for step, (t_pos, t_valid) in enumerate(tr.epoch_batches(0)[:3]):
            gen = tr.step_generator(0, step)
            losses[kernels].append(float(tr.train_step(
                params, opt, t_pos, t_valid, gen=gen)))
        now = (spmm_fwd.launches, spmm_bwd.launches,
               fused_window_fwd.launches, fused_window_bwd.launches)
        if kernels:
            assert all(n > c for n, c in zip(now, counts))
        else:
            assert now == counts
        finals[kernels] = [p.detach() for p in param_leaves(params)]
    for a, b in zip(losses[True], losses[False]):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    for a, b in zip(finals[True], finals[False]):
        assert _close(a, b)


def test_backward_kernels_are_deterministic(cuda):
    """K1b and K2b use no atomics: two runs on the same inputs agree bit for
    bit."""
    h, src, dst, rel, em, w = _graph(7128, 256, 460, 128, cuda)
    g = torch.randn(7128, 128, device=cuda)
    n2 = torch.rand(7128, device=cuda)
    a = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    b = spmm_bwd(g, n2, h, src, dst, rel, em, w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    enc, kw, masks = _train_window_args(8, 14, 640, 256, 128, cuda)
    for t in param_leaves(enc):
        t.requires_grad_(True)
    cfg = TKGConfig(embed_size=128, hidden_size=128, n_bases=128)
    runs = []
    for _ in range(2):
        h0 = kw["h0_xs"].clone().requires_grad_()
        b1, b2 = fused_window_scan(enc, cfg, masks=masks,
                                   **{**kw, "h0_xs": h0})
        grads = torch.autograd.grad(b1.sum() + 2.0 * b2.sum(),
                                    [h0] + param_leaves(enc),
                                    allow_unused=True)
        runs.append(grads)
    for x, y in zip(*runs):
        assert (x is None and y is None) or torch.equal(x, y)
