"""On-card checks of the operator tail and the recurrent networks (marker
``cuda``).

What only a card can show: ``npx.rnn``'s cuDNN route in every mode, 1-2
layers, one or two directions, forward and backward, against its plain
loop (fp32, TF32 off: max |diff| within 1e-4 of max |plain| for values,
5e-4 for gradients); the routes of bf16 (the plain loop: cuDNN's RNN does
not take it), fp16, the state clip and a capturing stream (the eager
route); a hybridized LSTM layer (cuDNN inside the graphs) bit for bit
against the eager cuDNN call, and a bf16 one (the plain loop inside the
graphs) against its eager calls, each capturing beside the eager calls'
live graphs; a 2 x 650 LSTM hybridized after a recorded eager call
whose output is kept, its replayed gradients bit for bit the eager ones
(on cuDNN and on the plain loop); ``topk`` and ``box_nms`` keeping tied scores in index order on the
card; ``npx.multi_head_attention`` launching kernels 1-3 (one forward,
one dK/dV and one dQ launch a call) and agreeing with the plain
composition. They skip without a card (the ``cuda_device`` fixture).
This file imports neither JAX nor the JAX package, so it runs on the
card's machine with ``--noconftest``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import rnn as R
from mxnet_tpu_torch.ops.attention import _reference_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cuDNN route and the CUDA "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _share(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("mode", sorted(R.GATES))
@pytest.mark.parametrize("layers,bidir", [(1, False), (1, True), (2, False),
                                          (2, True)])
def test_cudnn_route_matches_the_plain_loop(cuda_device, mode, layers,
                                            bidir):
    g = torch.Generator().manual_seed(7)
    t, b, i, h = 9, 4, 24, 32
    ndir = 2 if bidir else 1
    n = sum(ndir * R.GATES[mode] * h * ((i if lyr == 0 else h * ndir) + h + 2)
            for lyr in range(layers))
    p = (torch.rand(n, generator=g) * 0.4 - 0.2).to(cuda_device)
    x = torch.randn(t, b, i, generator=g).to(cuda_device)
    h0 = torch.randn(layers * ndir, b, h, generator=g).to(cuda_device)
    c0 = torch.randn_like(h0) if mode == "lstm" else None
    res = {}
    for route in ("cudnn", "plain"):
        ps, xs = p.clone().requires_grad_(), x.clone().requires_grad_()
        w = R.unpack(ps, mode, h, layers, bidir, i)
        before = R.route_calls[route]
        with torch.backends.cudnn.flags(enabled=route == "cudnn",
                                        allow_tf32=False):
            out, hn, cn = R.rnn(xs, w, h0, c0, mode, layers, bidir)
        assert R.route_calls[route] == before + 1
        loss = out.square().sum() + hn.sum() + (cn.sum() if cn is not None
                                                else 0)
        res[route] = [out, hn] + ([cn] if cn is not None else []) + \
            list(torch.autograd.grad(loss, [ps, xs]))
    nval = 3 if mode == "lstm" else 2
    for k, (a, w) in enumerate(zip(res["cudnn"], res["plain"])):
        assert _share(a, w) <= (1e-4 if k < nval else 5e-4), (mode, k)


def test_routes_are_decided_before_the_launch(cuda_device):
    x = torch.zeros(2, 1, 4, device=cuda_device)
    w = [tuple(torch.zeros(s, device=cuda_device)
               for s in ((16, 4), (16, 4), (16,), (16,)))]
    assert R.route(x, w, "lstm", False) == "cudnn"
    assert R.route(x, w, "lstm", True) == "plain"
    assert R.route(x.bfloat16(), [tuple(v.bfloat16() for v in w[0])],
                   "lstm", False) == "plain"
    assert R.route(x.half(), [tuple(v.half() for v in w[0])], "lstm",
                   False) == "cudnn"
    assert R.route(x, [tuple(v.double() for v in w[0])], "lstm",
                   False) == "plain"           # mixed dtypes
    gph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gph):     # a capture takes the eager route
        assert R.route(x, w, "lstm", False) == "cudnn"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybridized_lstm_matches_eager(cuda_device, dtype):
    net = tmx.gluon.rnn.LSTM(32, 2, input_size=16, device=cuda_device)
    net.initialize(seed=3)
    net.cast(dtype)
    x = torch.randn(7, 5, 16, device=cuda_device, dtype=dtype)
    st = [torch.zeros(2, 5, 32, device=cuda_device, dtype=dtype)] * 2
    outs, held = [], []
    for hybrid in (False, True):
        net.hybridize(hybrid)
        for _ in range(2):
            xs = x.clone().requires_grad_()
            with tmx.autograd.record():
                out, (hn, cn) = net(xs, st)
                loss = out.float().square().sum() + hn.float().sum()
            tmx.autograd.backward(loss)
        outs.append([t.detach() for t in (out, hn, cn, xs.grad)]
                    + [net.l1_h2h_weight.grad.clone()])
        # the eager calls' graphs stay alive while the block captures
        held.append((out, hn, cn, loss))
        net.zero_grad()
    for a, w in zip(outs[1], outs[0]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("cudnn", [True, False])
def test_capture_beside_a_live_eager_graph(cuda_device, cudnn):
    """The smallest input of the capture fault: one recorded eager call
    of a 2 x 650 LSTM whose output (and so its graph) is kept, then
    hybridize() and a recorded call; the replayed gradients equal the
    eager ones bit for bit."""
    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
        net = tmx.gluon.rnn.LSTM(650, 2, input_size=650, device=cuda_device)
        net.initialize(seed=21)
        x = torch.randn(35, 20, 650, device=cuda_device)
        grads = []
        for hybrid in (False, True):
            net.hybridize(hybrid)
            with tmx.autograd.record():
                out = net(x)
                loss = out.square().sum()
            tmx.autograd.backward(loss)
            grads.append([p.grad().clone()
                          for p in net.collect_params().values()])
            if not hybrid:
                kept = out     # the eager graph stays alive
        assert kept.grad_fn is not None
        for a, w in zip(grads[1], grads[0]):
            assert torch.equal(a, w)


def test_tied_scores_keep_index_order_on_the_card(cuda_device):
    ties = torch.zeros(3, 4096, device=cuda_device)
    ties[:, ::7] = 1.0
    idx = tmx.npx.topk(ties, k=600, dtype="int64")
    want = torch.cat([torch.arange(0, 4096, 7), torch.tensor(
        [i for i in range(4096) if i % 7]), ])[:600]
    assert torch.equal(idx[0].cpu(), want) and torch.equal(idx[2].cpu(), want)
    rows = torch.zeros(1, 300, 6, device=cuda_device)
    rows[0, :, 1] = 0.5
    rows[0, :, 2] = torch.arange(300, device=cuda_device) * 2.0
    rows[0, :, 4] = rows[0, :, 2] + 1.0
    rows[0, :, 5] = 1.0
    out = tmx.npx.box_nms(rows)
    assert torch.equal(out[0, :, 2], rows[0, :, 2])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_reaches_kernels_1_to_3(cuda_device, dtype,
                                                      tol, causal):
    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(2, 128, 4 * 64, generator=g)
                   .to(cuda_device, dtype) for _ in range(4))
    res = []
    for fn in (tmx.npx.multi_head_attention, _reference_attention):
        before = [fa.flash_attention_fwd.launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches]
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        with tmx.autograd.record():
            out = fn(qs, ks, vs, 4, causal=causal)
        res.append([out] + list(torch.autograd.grad(out, [qs, ks, vs], do)))
        after = [fa.flash_attention_fwd.launches,
                 fa.flash_attention_bwd_dkv.launches,
                 fa.flash_attention_bwd_dq.launches]
        want = [1, 1, 1] if fn is tmx.npx.multi_head_attention else [0, 0, 0]
        assert [a - b for a, b in zip(after, before)] == want
    for a, w in zip(*res):
        assert _share(a, w) <= tol
    if dtype == torch.float32:     # mx.np arrays in, an array out
        with tmx.gpu(0):
            arr = tmx.npx.multi_head_attention(
                *(tmx.np.array(t.cpu().numpy()) for t in (q, k, v)), 4,
                causal=causal)
        assert isinstance(arr, tmx.np.ndarray)
        onp.testing.assert_allclose(arr.asnumpy(),
                                    res[0][0].detach().cpu().numpy(),
                                    rtol=0, atol=1e-6)
