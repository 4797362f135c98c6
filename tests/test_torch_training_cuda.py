"""On-card checks of this slice's training surface (marker ``cuda``).

What only a card can show: a hybridized block's recorded call (a
replayed CUDA graph) refuses ``grad(create_graph=True)`` with
``MXNetError`` instead of a silently wrong second derivative, while the
same block unhybridized gives the CPU's; the fused families' fused
update bit for bit with their per-parameter rule on the card; a small
BERT's bf16 LAMB step (``multi_precision``, ``clip_global_norm``, the
local kvstore) against the reference's rule in float64; the KVStore's
2-bit compression bit for bit with the CPU's; a Dense stack hybridized
after a recorded eager call whose output is kept (a capture beside a
live eager graph over the same parameters), its replayed gradients bit
for bit the eager ones; the cyclic collector paused through the
captures. They skip without a card
(decided in the ``cuda_device`` fixture). This file imports neither JAX
nor the JAX package, so it runs on the card's machine with
``--noconftest``.
"""
import copy

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _penalty(net, x):
    x = x.clone().requires_grad_()
    with tmx.autograd.record():
        y = net(x).sum()
        g = tmx.autograd.grad(y, x, create_graph=True)
        pen = (g * g).sum()
    tmx.autograd.backward(pen)
    return x.grad


def test_create_graph_through_a_replayed_graph_raises(cuda_device):
    net = tmx.gluon.nn.Dense(3, activation="tanh", in_units=2,
                             device="cpu")
    net.initialize(seed=0)
    x = torch.tensor([[0.1, 0.2], [0.3, -0.4]])
    want = _penalty(net, x)
    card = copy.deepcopy(net)
    card.reset_ctx(cuda_device)
    got = _penalty(card, x.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    card.hybridize()
    with pytest.raises(MXNetError, match="hybridized"):
        with tmx.autograd.record():
            y = card(x.to(cuda_device).requires_grad_()).sum()
            tmx.autograd.grad(y, [card.weight], create_graph=True)


@pytest.mark.parametrize("name", ["nag", "adamax", "adabelief", "nadam"])
def test_fused_family_bit_for_bit_on_the_card(cuda_device, name):
    nets, trainers = [], []
    for fused in (True, False):
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(64, in_units=32, device=cuda_device),
                tmx.gluon.nn.Dense(5, in_units=64, device=cuda_device))
        net.initialize(seed=2)
        kw = {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 1.0}
        if name == "nag":
            kw["momentum"] = 0.9
        tr = tmx.gluon.Trainer(net.collect_params(), name, kw)
        if not fused:
            tr._fused_update = False
        nets.append(net)
        trainers.append(tr)
    for s in range(4):
        for net in nets:
            for j, p in enumerate(net.collect_params().values()):
                gen = torch.Generator(device=cuda_device).manual_seed(s * 7
                                                                      + j)
                p.data().grad = torch.randn(p.shape, device=cuda_device,
                                            generator=gen)
        for tr in trainers:
            tr.step(3)
    assert trainers[0]._fused_update
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(a.data(), b.data())


def test_bert_lamb_bf16_step_matches_the_float64_rule(cuda_device):
    """A small BERT in bf16 under GluonNLP's recipe on the card
    (multi_precision LAMB on the local kvstore, ``clip_global_norm`` at
    1.0, ``wd_mult`` 0 on beta/gamma/bias): the second step's fp32 masters
    against the reference's LAMB rule recomputed in float64 from that
    step's snapshot (masters, clipped gradients, m, v), within 1e-5 of
    each tensor's largest value; every bf16 weight is its master
    rounded."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    net = BERTForPretraining(vocab_size=500, units=64, hidden_size=128,
                             num_layers=2, num_heads=4, max_length=32,
                             dropout=0.0, embed_dropout=0.0,
                             device=cuda_device).initialize(seed=0)
    net.cast("bfloat16")
    params = net.collect_params()
    for p in net.collect_params(".*beta|.*gamma|.*bias").values():
        p.wd_mult = 0.0
    tr = tmx.gluon.Trainer(params, "lamb", {"learning_rate": 1e-3,
                                            "wd": 0.01,
                                            "multi_precision": True},
                           kvstore="local")
    rs = onp.random.RandomState(0)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_backward():
        ids = torch.from_numpy(rs.randint(0, 500, (2, 16))).to(cuda_device)
        labels = torch.from_numpy(rs.randint(0, 500, (2, 16))) \
            .to(cuda_device)
        nsp = torch.tensor([0, 1], device=cuda_device)
        with tmx.autograd.record():
            mlm, ns = net(ids)
            loss = loss_fn(mlm, labels) + loss_fn(ns, nsp)
        tmx.autograd.backward(loss)
        tmx.gluon.utils.clip_global_norm(
            [p.grad() for p in params.values() if p.grad_req != "null"],
            1.0)

    forward_backward()
    tr.step(2)
    forward_backward()
    plist = list(params.values())
    snap = {i: [t.detach().double().clone() for t in (s[0], *s[1],
                                                      plist[i].grad())]
            for i, s in tr._updater.states.items()}
    opt = tr.optimizer
    t = opt.num_update + 1
    tr.step(2)
    b1, b2, eps, lr = opt.beta1, opt.beta2, opt.epsilon, opt.learning_rate
    for i, (w, m, v, g) in snap.items():
        g = g / 2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        r = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps) \
            + opt._get_wd(i) * w
        wn, rn = w.norm(), r.norm()
        ratio = wn / rn if wn > 0 and rn > 0 else 1.0
        want = w - lr * ratio * r
        master = tr._updater.states[i][0]
        err = (master.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() + 1e-12, (i, err)
        assert torch.equal(plist[i].data(), master.to(torch.bfloat16))


def test_compressed_pushes_bit_for_bit_with_the_cpu(cuda_device):
    rs = onp.random.RandomState(5)
    pushes = [rs.randn(33, 7).astype("float32") * 0.4 for _ in range(4)]
    res = []
    for d in (cuda_device, torch.device("cpu")):
        kv = tmx.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.25})
        kv.init("g", torch.zeros(33, 7, device=d))
        outs = []
        for g in pushes:
            o = torch.empty(33, 7, device=d)
            kv.pushpull("g", torch.from_numpy(g).to(d), out=o)
            outs.append(o.cpu())
        res.append(outs)
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_hybridized_batchnorm_with_global_statistics_refuses_capture(
        cuda_device):
    """A hybridized net whose BatchNorm takes the global batch's
    statistics (summed over the ranks in the forward) raises before
    anything is captured: a gloo collective cannot be captured in a CUDA
    graph. Eagerly the same net trains."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=6, device=cuda_device),
            nn.BatchNorm(in_channels=4, device=cuda_device))
    net.initialize(seed=0)
    net.hybridize()
    x = torch.rand(8, 6, device=cuda_device)
    # what a Trainer over a dist store does on more than one process
    params = list(net.collect_params().values())
    for p in params:
        p._sync_batch_stats = True
    try:
        with pytest.raises(MXNetError, match="cannot be captured"):
            with tmx.autograd.record():
                net(x)
    finally:
        for p in params:
            del p._sync_batch_stats
    with tmx.autograd.record():
        out = net(x)
    assert out.shape == (8, 4)


def test_capture_beside_a_live_eager_graph(cuda_device):
    """A hybridized Dense stack's first recorded call captures while an
    eager graph over its parameters is alive; the replayed gradients (two
    replays) equal the eager ones bit for bit."""
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(256, activation="relu", in_units=128,
                               device=cuda_device),
            tmx.gluon.nn.Dense(64, in_units=256, device=cuda_device))
    net.initialize(seed=21)
    x = torch.randn(32, 128, device=cuda_device)
    grads, kept = [], []
    for hybrid in (False, True, True):
        net.hybridize(hybrid)
        with tmx.autograd.record():
            out = net(x)
            loss = out.square().sum()
        tmx.autograd.backward(loss)
        grads.append([p.grad().clone()
                      for p in net.collect_params().values()])
        kept.append(out)       # every call's graph stays alive
    assert kept[0].grad_fn is not None
    for run in grads[1:]:
        for a, w in zip(run, grads[0]):
            assert torch.equal(a, w)



def test_captures_run_with_the_cyclic_collector_paused(cuda_device):
    """A hybridized block and its cached graphs form a reference cycle, so
    a dropped block's CUDA graphs are freed by the cyclic collector; one
    that ran during another block's capture would destroy a graph
    executable mid-capture and invalidate that capture (a capture failed
    so, now and then, in a process that had dropped hybridized blocks).
    The warm-up and the captures run with the collector paused, and it
    runs again after."""
    import gc

    class Probe(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = tmx.gluon.nn.Dense(8, in_units=16,
                                            device=cuda_device)
            self.seen = []

        def forward(self, x):
            self.seen.append(gc.isenabled())
            return self.dense(x)

    net = Probe()
    net.initialize(seed=0)
    x = torch.randn(4, 16, device=cuda_device)
    want = net(x).clone()
    net.hybridize()
    with tmx.autograd.record():
        loss = net(x).sum()
    tmx.autograd.backward(loss)
    assert torch.equal(net(x), want)
    # eager, then the recorded and the plain signatures' warm-ups and
    # captures: the collector paused in each
    assert net.seen[0] is True and len(net.seen) == 5
    assert not any(net.seen[1:])
    assert gc.isenabled()
