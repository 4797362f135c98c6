"""Port parity: training small ResNets through Gluon, JAX package ->
PyTorch port.

Small ``ResNetV1`` / ``ResNetV2`` nets (layers [1, 1, 1, 1], channels [16,
32, 64, 128, 256], 10 classes, ``thumbnail=True``) with ``BasicBlock`` and
``Bottleneck`` blocks are built in both packages with deferred shapes; one
forward of a 4 x 3 x 16 x 16 numpy batch finishes them, and the JAX
package's weights (running statistics included) are carried into the port
with ``functional.load_params`` under the same structural names. Then, on
the CPU, with ``fused_conv_bn`` "on" (the JAX Pallas kernel in interpret
mode, the port's kernel 8 through its plain version) and "off" in both:
the train-mode logits, the loss, every gradient, the running statistics
after the step, one SGD-momentum ``Trainer`` step, and the eval-mode
logits. Tolerances (float32, another summation order): logits, losses and
running statistics atol = rtol = 1e-4; gradients atol = rtol = 5e-4;
weights after the step atol 1e-5 + rtol 1e-4 (lr 0.05 times the gradient
tolerance).

A ReLU net's gradient is discontinuous at the kink: a pre-activation
within the packages' forward rounding of 0 (their fp32 batch statistics
differ by ~4e-6 relative) takes the other branch in one package, and that
one element moves whole channels' gradients by ~1e-2 (measured: the port
agrees with its own float64 run within 2e-6 there, the JAX package is off
by 1e-2, also in float64). So each comparison uses the first training
batch (seeds 1, 2, ...) whose smallest |pre-ReLU| value in the port's
forward is at least ``KINK_MARGIN``, and asserts that margin
(:func:`_train_batch`).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import numpy_extension as tnpx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

torch.set_num_threads(2)

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10
NETS = {
    "v1_basic": (1, "BasicBlockV1"), "v1_bottleneck": (1, "BottleneckV1"),
    "v2_basic": (2, "BasicBlockV2"), "v2_bottleneck": (2, "BottleneckV2"),
}
FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=5e-4, atol=5e-4)
KINK_MARGIN = 1e-5


def _batch(seed=0):
    rs = onp.random.RandomState(seed)
    x = rs.uniform(size=(4, 3, 16, 16)).astype("float32")
    return x, (onp.arange(4) % 3).astype("int32")


def _build(pkg, version, block, **kw):
    res = jres if pkg is mx else tres
    cls = res.ResNetV1 if version == 1 else res.ResNetV2
    return cls(getattr(res, block), LAYERS, CHANNELS, classes=CLASSES,
               thumbnail=True, **kw)


def _pair(name, seed=0):
    """(JAX net, port net on the CPU with the JAX net's weights)."""
    version, block = NETS[name]
    x, _ = _batch()
    mx.random.seed(seed)
    jnet = _build(mx, version, block)
    jnet.initialize()
    jnet(mx.np.array(x))
    tnet = _build(tmx, version, block, device="cpu")
    tnet.initialize()
    tnet(torch.from_numpy(x))
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _relu_margin(tnet, x):
    """The smallest |input| of any ReLU in the port's training forward
    (child by child)."""
    seen = []
    relu = tnpx._ACTS["relu"]

    def recording(v):
        seen.append(v.detach().abs().min().item())
        return relu(v)

    state = tfunctional.param_arrays(tnet)
    tnpx._ACTS["relu"] = recording
    tmx.config.set("fused_conv_bn", "off")
    try:
        with tmx.autograd.record():
            tnet(torch.from_numpy(x))
    finally:
        tnpx._ACTS["relu"] = relu
        tmx.config.reset("fused_conv_bn")
        tfunctional.load_params(tnet, state)  # the running statistics
    return min(seen)


def _train_batch(tnet):
    """The first batch (seed 1, 2, ...) that keeps every ReLU input at
    least ``KINK_MARGIN`` from the kink."""
    for seed in range(1, 21):
        x, y = _batch(seed)
        if _relu_margin(tnet, x) >= KINK_MARGIN:
            return x, y
    raise AssertionError("no batch keeps the ReLU inputs off the kink")


@pytest.fixture(params=["on", "off"])
def mode(request):
    """``fused_conv_bn`` in both packages."""
    mx.config.set("fused_conv_bn", request.param)
    tmx.config.set("fused_conv_bn", request.param)
    yield request.param
    mx.config.set("fused_conv_bn", "auto")
    tmx.config.reset("fused_conv_bn")


def _jax_step(jnet, x, y):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        logits = jnet(mx.np.array(x))
        loss = loss_fn(logits, mx.np.array(y))
    loss.backward()
    return logits.asnumpy(), loss.asnumpy()


def _port_step(tnet, x, y):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        logits = tnet(torch.from_numpy(x))
        loss = loss_fn(logits, torch.from_numpy(y))
    tmx.autograd.backward(loss)
    return logits.detach().float().numpy(), loss.detach().numpy()


def _stats(params, port):
    return {n: (p.data().detach().numpy() if port
                else p.data().asnumpy()).copy()
            for n, p in params.items() if "running" in n}


@pytest.mark.parametrize("name", sorted(NETS))
def test_training_step_matches_jax(name, mode):
    jnet, tnet = _pair(name)
    x, y = _train_batch(tnet)
    jlogits, jloss = _jax_step(jnet, x, y)
    tlogits, tloss = _port_step(tnet, x, y)
    onp.testing.assert_allclose(tlogits, jlogits, **FWD)
    onp.testing.assert_allclose(tloss, jloss, **FWD)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    for n, p in jp.items():
        if p.grad_req == "null":
            assert tp[n].grad_req == "null", n
            continue
        onp.testing.assert_allclose(tp[n].grad().numpy(),
                                    p.grad().asnumpy(), err_msg=n, **GRAD)
    jstats, tstats = _stats(jp, False), _stats(tp, True)
    assert sorted(tstats) == sorted(jstats) and tstats
    for n, v in jstats.items():
        onp.testing.assert_allclose(tstats[n], v, err_msg=n, **FWD)
    # one SGD-momentum step from the same gradients
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    mx.gluon.Trainer(jp, "sgd", opt).step(4)
    tmx.gluon.Trainer(tp, "sgd", opt).step(4)
    for n, p in jp.items():
        onp.testing.assert_allclose(tp[n].data().detach().numpy(),
                                    p.data().asnumpy(), rtol=1e-4,
                                    atol=1e-5, err_msg=n)
    # eval: running statistics, no update
    jeval = jnet(mx.np.array(x)).asnumpy()
    teval = tnet(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(teval, jeval, **FWD)
    for n, v in _stats(tp, True).items():
        onp.testing.assert_array_equal(v, tstats[n])


def test_fused_and_unfused_port_steps_agree():
    _, tnet = _pair("v1_bottleneck", seed=3)
    x, y = _batch(2)
    state = tfunctional.param_arrays(tnet)
    out = {}
    for m in ("on", "off"):
        tmx.config.set("fused_conv_bn", m)
        try:
            tfunctional.load_params(tnet, state)
            logits, loss = _port_step(tnet, x, y)
        finally:
            tmx.config.reset("fused_conv_bn")
        out[m] = (logits, loss, {
            n: (p.grad().numpy().copy() if p.grad_req != "null"
                else p.data().detach().numpy().copy())
            for n, p in tnet.collect_params().items()})
    onp.testing.assert_allclose(out["on"][0], out["off"][0], **FWD)
    onp.testing.assert_allclose(out["on"][1], out["off"][1], **FWD)
    for n, g in out["off"][2].items():
        onp.testing.assert_allclose(out["on"][2][n], g, err_msg=n, **GRAD)


def test_resnet50_fused_and_unfused_gradients_agree_in_float64():
    """``resnet50_v1`` at full width (batch 4 x 3 x 64 x 64, 1000 classes)
    in float64: the step-1 gradients of the fused route (kernel 8's plain
    version, all 16 triplets) and of the child-by-child route agree to
    1e-10 of each tensor's largest, where in float32 an untrained
    ResNet-50 already parts them by ~10% (one rounding flips ReLUs). A conv
    bias that feeds a BatchNorm has a zero gradient in exact arithmetic
    and is held against its conv weight's gradient."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 64, 64, generator=gen)
    y = torch.randint(0, 1000, (4,), generator=gen)
    net = tres.resnet50_v1(classes=1000, device="cpu")
    net.initialize(seed=0)
    net(x)
    net.double()
    params = net.collect_params()
    state = tfunctional.param_arrays(net)
    grads = {}
    for m in ("on", "off"):
        tmx.config.set("fused_conv_bn", m)
        try:
            tfunctional.load_params(net, state)
            with tmx.autograd.record():
                loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    net(x.double()), y)
            tmx.autograd.backward(loss)
        finally:
            tmx.config.reset("fused_conv_bn")
        grads[m] = {n: p.grad().clone() for n, p in params.items()
                    if p.grad_req != "null"}
    assert sum(isinstance(b, tnn.FusableSequential)
               for b in net.modules()) == 16
    for n, g in grads["off"].items():
        assert g.dtype == torch.float64, n
        ref = g
        if n.endswith(".bias") and "body" in n:
            ref = grads["off"][n[:-len("bias")] + "weight"]
        err = (grads["on"][n] - g).abs().max() / ref.abs().max()
        assert err <= 1e-10, (n, err.item())


@pytest.mark.parametrize("name", ["v1_basic", "v1_bottleneck"])
def test_six_sgd_steps_lower_the_loss(name):
    """Oracle: tests/test_fused_conv_bwd.py:168 (six fused steps), on the
    port's small ResNets."""
    _, tnet = _pair(name, seed=1)
    x, y = _batch(3)
    tmx.config.set("fused_conv_bn", "on")
    try:
        tr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
        losses = []
        for _ in range(6):
            _, loss = _port_step(tnet, x, y)
            tr.step(4)
            losses.append(float(loss.mean()))
    finally:
        tmx.config.reset("fused_conv_bn")
    assert onp.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_deferred_init_matches_jax():
    """Oracle: tests/test_gluon.py:23 (Dense) and the conv/BatchNorm
    shapes a forward infers."""
    x = onp.random.RandomState(0).uniform(size=(5, 7)).astype("float32")
    jl = jnn.Dense(4)
    jl.initialize()
    jout = jl(mx.np.array(x))
    tl = tnn.Dense(4, device="cpu")
    tl.initialize()
    assert tl.weight.shape == (4, 0) and not tl.collect_params()[
        "weight"].initialized
    tout = tl(torch.from_numpy(x))
    assert tout.shape == jout.shape == (5, 4)
    assert tl.weight.shape == jl.weight.shape == (4, 7)
    assert tl.collect_params()["weight"].initialized
    # flatten: the width is the product of the trailing axes
    t3 = tnn.Dense(2, device="cpu")
    t3.initialize()
    t3(torch.ones(3, 4, 5))
    assert t3.weight.shape == (2, 20)
    # a forward before initialize() raises, as the reference's does
    with pytest.raises(MXNetError, match="not initialized"):
        tnn.Dense(4, device="cpu")(torch.from_numpy(x))
    # conv and BatchNorm infer the input width
    jnet, tnet = _pair("v1_bottleneck")
    for n, p in jnet.collect_params().items():
        assert tnet.collect_params()[n].shape == p.shape, n
    # running_mean starts at zeros, running_var at ones (the name rule)
    bn = tnn.BatchNorm(device="cpu")
    bn.initialize()
    bn(torch.randn(2, 3, 4, 4))
    assert torch.equal(bn.running_mean, torch.zeros(3))
    assert torch.equal(bn.running_var, torch.ones(3))
    assert torch.equal(bn.gamma, torch.ones(3))
    with pytest.raises(MXNetError, match="cannot update shape"):
        tl.collect_params()["weight"]._finish_deferred_init((4, 8))


def test_collect_params_names_match_jax():
    """Oracle: tests/test_gluon.py:32."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=3, device="cpu"),
            tnn.Dense(2, in_units=4, device="cpu"))
    assert set(net.collect_params()) == {"0.weight", "0.bias", "1.weight",
                                         "1.bias"}
    assert set(net.collect_params(".*weight")) == {"0.weight", "1.weight"}
    for name in NETS:
        jnet, tnet = _pair(name)
        assert list(tnet.collect_params()) == list(jnet.collect_params())
        for sel in (".*running_.*", "features.1.*", ".*weight"):
            assert sorted(tnet.collect_params(sel)) == sorted(
                jnet.collect_params(sel)), (name, sel)


def test_layers_match_jax():
    """Oracles: tests/test_gluon.py:83 (Conv2D), 118 (pooling) and 133
    (BatchNorm train / eval), across the packages."""
    rs = onp.random.RandomState(3)
    x = rs.uniform(size=(2, 3, 16, 16)).astype("float32")
    mx.random.seed(0)
    for kw in ({"kernel_size": 3, "padding": 1}, {"kernel_size": 3,
                                                   "strides": 2},
               {"kernel_size": (1, 3), "dilation": 2, "use_bias": False}):
        jl = jnn.Conv2D(8, **kw)
        jl.initialize()
        want = jl(mx.np.array(x)).asnumpy()
        tl = tnn.Conv2D(8, device="cpu", **kw)
        tl.initialize()
        tl(torch.from_numpy(x))
        tfunctional.load_params(tl, {n: onp.asarray(v) for n, v in
                                     jfunctional.param_arrays(jl).items()})
        got = tl(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        onp.testing.assert_allclose(got, want, **FWD)
    for j, t in ((jnn.MaxPool2D(3, 2, 1), tnn.MaxPool2D(3, 2, 1)),
                 (jnn.MaxPool2D(2), tnn.MaxPool2D(2)),
                 (jnn.GlobalAvgPool2D(), tnn.GlobalAvgPool2D())):
        onp.testing.assert_allclose(t(torch.from_numpy(-x)).numpy(),
                                    j(mx.np.array(-x)).asnumpy(), **FWD)
    xb = rs.uniform(1, 3, size=(8, 4, 5, 5)).astype("float32")
    jbn = jnn.BatchNorm(in_channels=4)
    jbn.initialize()
    tbn = tnn.BatchNorm(in_channels=4, device="cpu")
    tbn.initialize()
    with mx.autograd.record():
        jtrain = jbn(mx.np.array(xb)).asnumpy()
    with tmx.autograd.record():
        ttrain = tbn(torch.from_numpy(xb)).detach().numpy()
    onp.testing.assert_allclose(ttrain, jtrain, **FWD)
    assert abs(float(ttrain.mean())) < 0.2
    onp.testing.assert_allclose(tbn.running_mean.numpy(),
                                jbn.running_mean.data().asnumpy(), **FWD)
    onp.testing.assert_allclose(tbn.running_var.numpy(),
                                jbn.running_var.data().asnumpy(), **FWD)
    onp.testing.assert_allclose(tbn(torch.from_numpy(xb)).numpy(),
                                jbn(mx.np.array(xb)).asnumpy(), **FWD)
    jflat = jnn.Flatten()(mx.np.array(xb)).asnumpy()
    onp.testing.assert_array_equal(tnn.Flatten()(torch.from_numpy(xb))
                                   .numpy(), jflat)


def test_resnet50_v1_structure_and_zoo():
    net = tres.resnet50_v1(classes=10, thumbnail=True, device="cpu")
    triplets = [b for b in net.modules()
                if isinstance(b, tnn.FusableSequential)]
    assert len(triplets) == 16
    assert sum(isinstance(b, tnn.Conv2D) for b in net.modules()) == 53
    jnet = jres.resnet50_v1(classes=10, thumbnail=True)
    x = onp.zeros((1, 3, 8, 8), "float32")
    jnet.initialize()
    jnet(mx.np.array(x))
    net.initialize()
    net(torch.from_numpy(x))
    assert list(net.collect_params()) == list(jnet.collect_params())
    with pytest.raises(MXNetError, match="pretrained"):
        tres.resnet18_v1(pretrained=True, device="cpu")
    with pytest.raises(MXNetError, match="depth"):
        tres.get_resnet(1, 20, device="cpu")
    for fn in (tres.resnet18_v2, tres.resnet34_v1):
        assert isinstance(fn(device="cpu"), (tres.ResNetV1, tres.ResNetV2))


def test_param_arrays_copies_on_the_cpu():
    """ROADMAP fault 10: ``param_arrays`` returned the CPU parameters' own
    memory (``Tensor.numpy()``), so it followed later in-place updates
    (BatchNorm's running statistics, SGD steps)."""
    bn = tnn.BatchNorm(in_channels=2, device="cpu")
    bn.initialize()
    arrays = tfunctional.param_arrays(bn)
    with tmx.autograd.record():
        bn(torch.randn(4, 2, 3, 3) + 5.0)
    assert not torch.equal(bn.running_mean, torch.zeros(2))
    onp.testing.assert_array_equal(arrays["running_mean"], onp.zeros(2))
    onp.testing.assert_array_equal(arrays["running_var"], onp.ones(2))


def test_deferred_parameters_and_load_params():
    """A deferred parameter stays out of ``param_arrays`` until its shape
    is known, takes a fitting array's shape from ``load_params``, and
    never runs on storage its initialization did not fill."""
    src = tnn.BatchNorm(device="cpu")
    src.initialize()
    assert tfunctional.param_arrays(src) == {}
    with tmx.autograd.record():
        src(torch.randn(4, 3, 2, 2) + 2.0)
    arrays = tfunctional.param_arrays(src)
    assert sorted(arrays) == ["beta", "gamma", "running_mean", "running_var"]
    dst = tnn.BatchNorm(device="cpu")
    tfunctional.load_params(dst, arrays)
    assert dst.running_mean.shape == (3,)
    onp.testing.assert_array_equal(dst.running_mean.numpy(),
                                   arrays["running_mean"])
    with pytest.raises(MXNetError, match="mis-shaped"):
        tfunctional.load_params(tnn.BatchNorm(in_channels=4, device="cpu"),
                                arrays)
    # an empty array for a deferred parameter initializes nothing: its
    # first forward still raises until initialize()
    blank = tnn.BatchNorm(device="cpu")
    tfunctional.load_params(blank, {n: onp.zeros(0, "float32")
                                    for n in arrays})
    with pytest.raises(MXNetError, match="not initialized"):
        blank(torch.ones(2, 3, 2, 2))


@pytest.mark.parametrize("name", ["v1_basic", "v1_bottleneck"])
def test_training_step_under_amp_matches_jax(name, mode):
    """A small ResNetV1 under ``amp.init("bfloat16")``, fp32 parameters
    (the master weights), ``fused_conv_bn`` "on" (bf16 triplets through the
    JAX Pallas kernel in interpret mode and the port's kernel-8 plain
    version) and "off" (bf16 convolutions, fp32 BatchNorm): every block's
    output dtype in call order as the JAX package's, exactly; the logits
    and the loss within 2e-2 of their largest |value|; the running
    statistics within 1e-2 relative; every gradient fp32, the head's
    (no ReLU or BatchNorm between it and the loss) within 3e-2 of its
    largest |value|. The other gradients are held to the conditioning
    probe: this untrained net at batch 4 turns bf16 roundings into large
    gradient changes (ReLU inputs near 0 take the other branch, BatchNorm
    over 16 values at the last stage amplifies), so that the JAX package's
    own bf16 gradients differ from its fp32 ones from the same weights by
    20-65% of their largest |value| (measured). Each port gradient must be
    within 3e-2 of max|JAX| plus twice that change."""
    from mxnet_tpu import amp as jamp
    jnet, tnet = _pair(name)
    x, y = _train_batch(tnet)
    # the conditioning probe: the JAX package's fp32 gradients from the
    # same weights (a second net from the same seed) and batch
    jprobe = _pair(name)[0]
    _jax_step(jprobe, x, y)
    probe = {n: p.grad().asnumpy().copy()
             for n, p in jprobe.collect_params().items()
             if p.grad_req != "null"}
    seen = {"jax": [], "port": []}

    def jax_blocks(block, prefix=""):
        yield prefix, block
        for n, child in block._children.items():
            yield from jax_blocks(child, f"{prefix}.{n}" if prefix else n)

    def names(out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(str(o.dtype).replace("torch.", "") for o in outs)

    for n, blk in jax_blocks(jnet):
        blk.register_forward_hook(
            lambda b, a, o, n=n: seen["jax"].append((n, names(o))))
    for n, blk in tnet.named_modules():
        blk.register_forward_hook(
            lambda b, a, o, n=n: seen["port"].append((n, names(o))))
    jamp.init("bfloat16")
    tmx.amp.init("bfloat16")
    try:
        jlogits, jloss = _jax_step(jnet, x, y)
        tlogits, tloss = _port_step(tnet, x, y)
    finally:
        jamp._deactivate()
        tmx.amp._deactivate()
    assert seen["port"] == seen["jax"]
    assert dict(seen["port"])[""] == ("bfloat16",)  # the Dense head
    for got, want in ((tlogits, jlogits), (tloss, jloss)):
        got, want = onp.asarray(got, "float32"), onp.asarray(want, "float32")
        assert onp.abs(got - want).max() <= 2e-2 * onp.abs(want).max()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for n, p in jp.items():
        if p.grad_req == "null":
            continue
        g, ref = tp[n].grad(), p.grad().asnumpy()
        assert g.dtype == torch.float32 and tp[n].dtype == torch.float32, n
        allow = 3e-2 * onp.abs(ref).max()
        if not n.startswith("output."):
            allow += 2 * onp.abs(ref - probe[n]).max()
        assert onp.abs(g.numpy() - ref).max() <= allow, n
    for n, v in _stats(jp, False).items():
        got = _stats(tp, True)[n]
        assert onp.abs(got - v).max() <= 1e-2 * onp.abs(v).max(), n
