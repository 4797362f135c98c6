"""Port parity: mixed precision (bf16 AMP), JAX package -> PyTorch port.

The same numpy inputs (seeded) go through both packages: the AMP dtype
policy (``amp.init``, the op lists, the conditional fp32 ops, the
dtype-drift oracle of ``tests/test_amp.py``), ``convert_hybrid_block``,
``Block.cast`` / ``Parameter.cast``, the ``LossScaler``, ``scale_loss``
and ``unscale``, the promotion rules of ``npx.fully_connected`` and
``npx.layer_norm`` with mixed dtypes (faults 17 and 18 of the port's
record: bf16 x with an fp32 weight raised in ``fully_connected``, and
``layer_norm`` returned bf16 where the reference returns fp32), a tiny GPT
trained under ``amp.init("bfloat16")``, a small BERT's dtypes under it
(the fused ln_residual route "on" and "off"), ``multi_precision`` for SGD, Adam
and AdamW, and the Trainer's non-finite guard. Output dtypes are compared
exactly.

Tolerances: fp32 results of mixed-dtype ops 1e-5 of the largest |value|
(the port rounds where the reference's jnp rounds; only fp32 summation
order differs); bf16 results one bf16 ulp (rtol 2^-7) plus 2^-10 of the
largest |value| (a value on a rounding boundary may round the other way);
the tiny GPT's logits and loss 2e-2 relative to their largest |value|
(bf16 products summed in another order, attention's probabilities rounded
at other places: flash tiles here, the composition there) and its fp32
master gradients 3e-2 of each gradient's largest |value|; one
SGD-momentum step from those gradients lr x 3e-2 of the largest gradient
(Adam's first step turns the bf16 noise of tiny gradients into +-lr and is
not compared); ``multi_precision`` masters 1e-6 after 3 steps (the same
bf16 gradients, fp32 update arithmetic in another order) and bf16 weights
equal or one bf16 ulp apart where the masters differ.

An autouse fixture turns the policy off in both packages around every
test: under ``--dist loadfile`` the JAX package's own tests share the
worker, and a policy left on would change their dtypes.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import functional as jfunctional
from mxnet_tpu import npx as jnpx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.bert import BERTForPretraining as JBERT
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt

torch.set_num_threads(2)

BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10
FP32_SHARE = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.fixture(autouse=True)
def _policy_off():
    jamp._deactivate()
    tamp._deactivate()
    yield
    jamp._deactivate()
    tamp._deactivate()


def _name(dtype):
    """The dtype's name, for a torch or a JAX/numpy dtype."""
    return str(dtype).replace("torch.", "")


def _np(a):
    """fp32 numpy of a port tensor or a JAX ndarray."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return onp.asarray(a.astype("float32").asnumpy())


def _close(got, want, dtype):
    """Values by the result's dtype: fp32 within 1e-5 of max|want|; bf16
    one ulp plus 2^-10 of max|want|."""
    got, want = _np(got), _np(want)
    scale = onp.abs(want).max()
    if dtype == "bfloat16":
        allow = BF16_RTOL * onp.abs(want) + BF16_ATOL_SHARE * scale
    else:
        allow = FP32_SHARE * scale
    assert (onp.abs(got - want) <= allow).all(), \
        onp.abs(got - want).max() / scale


def _jarr(a, dtype="float32"):
    return mx.np.array(a).astype(dtype)


def _tarr(a, dtype="float32"):
    return torch.from_numpy(onp.asarray(a, "float32")).to(DTYPES[dtype])


# -- faults 17 and 18: mixed-dtype Dense and LayerNorm ------------------------

MIXED = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("float16", "float32"), ("float32", "float16"),
         ("float32", "float32"), ("bfloat16", "bfloat16")]


def _fault_inputs():
    rs = onp.random.RandomState(0)
    return (rs.randn(4, 8).astype("float32"), rs.randn(5, 8).astype("float32"),
            rs.randn(5).astype("float32"), rs.randn(8).astype("float32"),
            rs.randn(8).astype("float32"))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("xd,wd", MIXED)
def test_fully_connected_promotes_mixed_dtypes_like_jax(xd, wd, bias):
    """Fault 17: bf16 x with fp32 weight and bias raised ("mat1 and mat2
    must have the same dtype"); the reference promotes to fp32."""
    x, w, b, _, _ = _fault_inputs()
    want = jnpx.fully_connected(_jarr(x, xd), _jarr(w, wd),
                                _jarr(b, wd) if bias else None,
                                num_hidden=5, no_bias=not bias)
    got = tnpx.fully_connected(_tarr(x, xd), _tarr(w, wd),
                               _tarr(b, wd) if bias else None)
    assert _name(got.dtype) == _name(want.dtype)
    _close(got, want, _name(want.dtype))


@pytest.mark.parametrize("xd,wd", MIXED)
def test_layer_norm_returns_the_promoted_dtype_like_jax(xd, wd):
    """Fault 18: bf16 x with fp32 gamma and beta returned bf16; the
    reference returns fp32 (jnp promotes in the affine)."""
    x, _, _, g, b = _fault_inputs()
    want = jnpx.layer_norm(_jarr(x, xd), _jarr(g, wd), _jarr(b, wd))
    got = tnpx.layer_norm(_tarr(x, xd), _tarr(g, wd), _tarr(b, wd))
    assert _name(got.dtype) == _name(want.dtype)
    _close(got, want, _name(want.dtype))


def test_layer_norm_block_inherits_the_promoted_dtype():
    x, _, _, g, b = _fault_inputs()
    jln = jnn.LayerNorm(in_channels=8)
    jln.initialize()
    jln.gamma.set_data(mx.np.array(g))
    jln.beta.set_data(mx.np.array(b))
    tln = tnn.LayerNorm(in_channels=8, device="cpu")
    tln.initialize()
    tfunctional.load_params(tln, {"gamma": g, "beta": b})
    want = jln(_jarr(x, "bfloat16"))
    got = tln(_tarr(x, "bfloat16"))
    assert _name(got.dtype) == _name(want.dtype) == "float32"
    _close(got, want, "float32")


# -- the policy (tests/test_amp.py's cases in both packages) ------------------

def test_amp_inactive_by_default():
    assert not tamp.is_active() and not jamp.is_active()
    a = onp.ones((4, 4), "float32")
    assert _name(mx.np.matmul(_jarr(a), _jarr(a)).dtype) == "float32"
    assert tnpx.fully_connected(_tarr(a), _tarr(a)).dtype == torch.float32


def test_amp_init_casts_matmul_and_dense():
    """Target ops (matmul, fully_connected) run in bf16, as the
    reference's."""
    jamp.init()
    tamp.init()
    a = onp.random.RandomState(1).randn(4, 4).astype("float32")
    want = mx.np.matmul(_jarr(a), _jarr(a))
    ta, tb = tamp._maybe_cast_op_inputs("matmul", (_tarr(a), _tarr(a)))
    got = torch.matmul(ta, tb)
    assert _name(got.dtype) == _name(want.dtype) == "bfloat16"
    _close(got, want, "bfloat16")
    want = jnpx.fully_connected(_jarr(a), _jarr(a), num_hidden=4,
                                no_bias=True)
    got = tnpx.fully_connected(_tarr(a), _tarr(a))
    assert _name(got.dtype) == _name(want.dtype) == "bfloat16"
    _close(got, want, "bfloat16")


def test_amp_fp32_ops_stay_fp32():
    jamp.init()
    tamp.init()
    a = onp.random.RandomState(2).randn(4, 4).astype("float32")
    want = jnpx.softmax(_jarr(a, "bfloat16"))
    got = tnpx.softmax(_tarr(a, "bfloat16"))
    assert _name(got.dtype) == _name(want.dtype) == "float32"
    _close(got, want, "float32")


def test_amp_elementwise_unaffected():
    jamp.init()
    tamp.init()
    a = onp.ones((4, 4), "float32")
    assert _name((_jarr(a) + _jarr(a)).dtype) == "float32"
    assert (_tarr(a) + _tarr(a)).dtype == torch.float32


def _dense_pair(units, in_units, seed):
    rs = onp.random.RandomState(seed)
    w = (rs.randn(units, in_units) * 0.3).astype("float32")
    b = (rs.randn(units) * 0.1).astype("float32")
    jnet = jnn.Dense(units, in_units=in_units)
    jnet.initialize()
    jnet.weight.set_data(mx.np.array(w))
    jnet.bias.set_data(mx.np.array(b))
    tnet = tnn.Dense(units, in_units=in_units, device="cpu")
    tnet.initialize()
    tfunctional.load_params(tnet, {"weight": w, "bias": b})
    return jnet, tnet


def test_amp_dense_eager():
    jnet, tnet = _dense_pair(8, 16, 3)
    x = onp.random.RandomState(3).rand(2, 16).astype("float32")
    ref = tnet(_tarr(x))
    jamp.init()
    tamp.init()
    want, got = jnet(_jarr(x)), tnet(_tarr(x))
    assert _name(got.dtype) == _name(want.dtype) == "bfloat16"
    _close(got, want, "bfloat16")
    onp.testing.assert_allclose(_np(got), _np(ref), rtol=5e-2, atol=5e-2)


def test_amp_backward_master_weights_stay_fp32():
    """fp32 parameters under the policy: bf16 products, fp32 gradients,
    the reference's gradients within bf16 resolution."""
    jamp.init()
    tamp.init()
    jnet, tnet = _dense_pair(4, 8, 4)
    x = onp.random.RandomState(4).rand(2, 8).astype("float32")
    with jautograd.record():
        jloss = (jnet(_jarr(x)).astype("float32") ** 2).sum()
    jloss.backward()
    with tmx.autograd.record():
        tloss = (tnet(_tarr(x)).float() ** 2).sum()
    tmx.autograd.backward(tloss)
    for name in ("weight", "bias"):
        tp, jp = getattr(tnet, name), getattr(jnet, name)
        assert tp.dtype == torch.float32
        assert _name(jp.data().dtype) == "float32"
        g = tp.grad
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert g.abs().max() > 0
        want = jp.grad().asnumpy()
        assert onp.abs(g.numpy() - want).max() <= 2e-2 * onp.abs(want).max()


def test_amp_conv_cast():
    jamp.init()
    tamp.init()
    w = (onp.random.RandomState(5).randn(4, 3, 3, 3) * 0.2).astype("float32")
    jconv = jnn.Conv2D(4, kernel_size=3, in_channels=3)
    jconv.initialize()
    jconv.weight.set_data(mx.np.array(w))
    tconv = tnn.Conv2D(4, kernel_size=3, in_channels=3, device="cpu")
    tconv.initialize()
    tfunctional.load_params(tconv, {"weight": w,
                                    "bias": onp.zeros(4, "float32")})
    jconv.bias.set_data(mx.np.zeros(4))
    x = onp.ones((1, 3, 8, 8), "float32")
    want, got = jconv(_jarr(x)), tconv(_tarr(x))
    assert _name(got.dtype) == _name(want.dtype) == "bfloat16"
    _close(got, want, "bfloat16")


def test_convert_hybrid_block_casts_params():
    nets = []
    for nn_, kw in ((jnn, {}), (tnn, {"device": "cpu"})):
        net = nn_.HybridSequential()
        net.add(nn_.Dense(8, **kw), nn_.BatchNorm(**kw), nn_.Dense(4, **kw))
        net.initialize()
        nets.append(net)
    nets[0](mx.np.ones((2, 16)))
    nets[1](torch.ones(2, 16))
    jamp.convert_hybrid_block(nets[0])
    tamp.convert_hybrid_block(nets[1])
    jparams, tparams = (n.collect_params() for n in nets)
    assert list(jparams) == list(tparams)
    for name, p in tparams.items():
        want = _name(jparams[name].data().dtype)
        assert _name(p.dtype) == want, name
        assert want == ("float32" if name.endswith(
            ("gamma", "beta", "running_mean", "running_var")) else
            "bfloat16"), name


def test_loss_scaler_overflow_cycle():
    for scaler in (jamp.LossScaler(init_scale=2 ** 8, scale_factor=2.0,
                                   scale_window=2),
                   tamp.LossScaler(init_scale=2 ** 8, scale_factor=2.0,
                                   scale_window=2)):
        scaler.update_scale(True)
        assert scaler.loss_scale == 2 ** 7
        scaler.update_scale(False)
        scaler.update_scale(False)  # the window reached: grow
        assert scaler.loss_scale == 2 ** 8
        for _ in range(30):
            scaler.update_scale(True)
        assert scaler.loss_scale == 1  # the floor


def test_loss_scaler_detects_inf_grads():
    jnet, tnet = _dense_pair(2, 4, 6)
    x = onp.full((1, 4), 1e38, "float32")
    with jautograd.record():
        jloss = (jnet(_jarr(x)) * 1e38).sum()
    jloss.backward()
    with tmx.autograd.record():
        tloss = (tnet(_tarr(x)) * 1e38).sum()
    tmx.autograd.backward(tloss)
    assert jamp.LossScaler().has_overflow(
        list(jnet.collect_params().values()))
    assert tamp.LossScaler().has_overflow(
        list(tnet.collect_params().values()))
    # and a finite step has none
    tnet.zero_grad()
    with tmx.autograd.record():
        tloss = tnet(_tarr(onp.ones((1, 4), "float32"))).sum()
    tmx.autograd.backward(tloss)
    assert not tamp.LossScaler().has_overflow(
        list(tnet.collect_params().values()))


def test_scale_loss_scope_and_unscale():
    jnet, tnet = _dense_pair(2, 4, 7)

    class FakeTrainer:
        pass

    for amp_, net, loss in ((jamp, jnet, mx.np.ones((2,))),
                            (tamp, tnet, torch.ones(2))):
        tr = FakeTrainer()
        tr._params = list(net.collect_params().values())
        with amp_.scale_loss(loss, tr) as scaled:
            assert float(scaled.sum()) == pytest.approx(
                2 * tr._amp_loss_scaler.loss_scale)
    # unscale divides the port's gradients by the scale, in place
    tr = FakeTrainer()
    tr._params = list(tnet.collect_params().values())
    with tmx.autograd.record():
        loss = tnet(_tarr(onp.ones((1, 4), "float32"))).sum()
        with tamp.scale_loss(loss, tr) as scaled:
            tmx.autograd.backward(scaled)
    scaled_grad = tnet.weight.grad.clone()
    tamp.unscale(tr)
    torch.testing.assert_close(tnet.weight.grad,
                               scaled_grad / tr._amp_loss_scaler.loss_scale)


def test_amp_conditional_fp32_ops():
    """Conditional entries (op, attr, values) run fp32 only for the listed
    attr values (reference: CONDITIONAL_FP32_FUNCS)."""
    x = onp.random.RandomState(8).randn(4, 8).astype("float32")
    cases = [("activation", "softrelu", "float32"),
             ("activation", "relu", "bfloat16"),
             ("leaky_relu", "elu", "float32"),
             ("leaky_relu", "selu", "float32"),
             ("leaky_relu", "leaky", "bfloat16")]
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    for op, act, dtype in cases:
        want = getattr(jnpx, op)(_jarr(x, "bfloat16"), act_type=act)
        got = getattr(tnpx, op)(_tarr(x, "bfloat16"), act_type=act)
        assert _name(got.dtype) == _name(want.dtype) == dtype, (op, act)
        _close(got, want, dtype)
    # a user-supplied conditional triple
    jamp.init("bfloat16",
              conditional_fp32_ops=[("activation", "act_type", ["tanh"])])
    tamp.init("bfloat16",
              conditional_fp32_ops=[("activation", "act_type", ["tanh"])])
    want = jnpx.activation(_jarr(x, "bfloat16"), "tanh")
    got = tnpx.activation(_tarr(x, "bfloat16"), "tanh")
    assert _name(got.dtype) == _name(want.dtype) == "float32"
    _close(got, want, "float32")


def test_amp_dtype_drift_oracle():
    """A mixed chain under amp.init(): target ops -> bf16, fp32-listed ops
    -> fp32, unlisted ops keep their input's dtype, mixed elementwise ->
    the widest; every intermediate's dtype as the reference's."""
    rs = onp.random.RandomState(9)
    x = rs.randn(2, 3, 8, 8).astype("float32")
    w = rs.randn(4, 3, 3, 3).astype("float32")
    wfc = rs.randn(5, 64).astype("float32")
    stats = (onp.ones(4, "float32"), onp.zeros(4, "float32"),
             onp.zeros(4, "float32"), onp.ones(4, "float32"))
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    chains = []
    for npx_, arr in ((jnpx, _jarr), (tnpx, _tarr)):
        out = {}
        out["conv"] = npx_.convolution(arr(x), arr(w), kernel=(3, 3),
                                       num_filter=4, pad=(1, 1),
                                       no_bias=True)
        out["act"] = npx_.activation(out["conv"], "relu")
        out["bn"] = npx_.batch_norm(out["act"], *map(arr, stats),
                                    use_global_stats=True)
        half = (out["bn"].astype("bfloat16") if npx_ is jnpx
                else out["bn"].to(torch.bfloat16))
        out["pool"] = npx_.pooling(half, kernel=(2, 2), stride=(2, 2),
                                   pool_type="max")
        out["mixed"] = out["pool"] + out["bn"][:, :, ::2, ::2]
        flat = out["mixed"].reshape((2, -1))
        out["fc"] = npx_.fully_connected(flat, arr(wfc), num_hidden=5,
                                         no_bias=True) if npx_ is jnpx \
            else npx_.fully_connected(flat, arr(wfc))
        out["softmax"] = npx_.softmax(out["fc"])
        chains.append(out)
    want = {"conv": "bfloat16", "act": "bfloat16", "bn": "float32",
            "pool": "bfloat16", "mixed": "float32", "fc": "bfloat16",
            "softmax": "float32"}
    jout, tout = chains
    for k, dtype in want.items():
        assert _name(tout[k].dtype) == _name(jout[k].dtype) == dtype, k
    _close(tout["softmax"], jout["softmax"], "bfloat16")


def test_amp_policy_is_thread_local():
    import threading
    tamp.init()
    seen = []
    t = threading.Thread(target=lambda: seen.append(tamp.is_active()))
    t.start()
    t.join()
    assert seen == [False] and tamp.is_active()


# -- Block.cast / Parameter.cast -----------------------------------------------

def test_block_cast_keeps_grad_req_the_leaf_and_fp8_sites():
    net = tnn.Dense(4, in_units=3, device="cpu")
    net.initialize(seed=0)
    net.bias._mx_param.grad_req = "null"
    weight = net.weight
    before = weight.detach().clone()
    sites = {net.weight: "dense0"}
    assert net.cast("bfloat16") is net
    assert net.weight is weight  # the same leaf, still registered
    assert net.weight.dtype == net.bias.dtype == torch.bfloat16
    assert net.weight._mx_param.grad_req == "write"
    assert net.bias._mx_param.grad_req == "null"
    assert sites.get(net.weight) == "dense0"  # an fp8 site map still finds it
    torch.testing.assert_close(net.weight.float(),
                               before.to(torch.bfloat16).float())
    with tmx.autograd.record():
        loss = net(torch.ones(2, 3, dtype=torch.bfloat16)).float().sum()
    tmx.autograd.backward(loss)
    assert net.weight.grad.dtype == torch.bfloat16
    assert net.bias.grad is None


def test_deferred_parameter_takes_the_cast_dtype_when_materialised():
    jnet = jnn.Dense(4)
    jnet.initialize()
    jnet.cast("bfloat16")
    tnet = tnn.Dense(4, device="cpu")
    tnet.initialize(seed=0)
    tnet.cast("bfloat16")
    assert tnet.weight.shape == (4, 0)
    x = onp.ones((2, 3), "float32")
    want = jnet(_jarr(x, "bfloat16"))
    got = tnet(_tarr(x, "bfloat16"))
    assert tnet.weight.shape == (4, 3)
    assert _name(tnet.weight.dtype) == _name(jnet.weight.data().dtype) \
        == "bfloat16"
    assert _name(got.dtype) == _name(want.dtype) == "bfloat16"


# -- a tiny GPT under amp.init ----------------------------------------------------

GPT_CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
GPT_BATCH = 2


def _gpt_pair(seed=0):
    mx.random.seed(seed)
    jnet = JGPT(**GPT_CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **GPT_CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _gpt_batch(seed=0):
    ids = onp.random.RandomState(seed).randint(0, 101, (GPT_BATCH, 33))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _jax_blocks(block, prefix=""):
    yield prefix, block
    for name, child in block._children.items():
        yield from _jax_blocks(child, f"{prefix}.{name}" if prefix else name)


def _dtypes(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(_name(o.dtype) for o in outs if hasattr(o, "dtype"))


def test_gpt_under_amp_matches_jax_dtypes_values_and_gradients():
    """Every block's output dtype in call order, exactly; logits and loss
    within 2e-2 relative; the fp32 master gradients within 3e-2 of their
    largest |value|; one SGD-momentum step."""
    jnet, tnet = _gpt_pair(0)
    x, y = _gpt_batch(0)
    # the key projection's bias has a zero gradient in exact arithmetic
    # (softmax is shift invariant): both packages give rounding noise there
    for params in (jnet.collect_params(), tnet.collect_params()):
        for name, p in params.items():
            if "key_proj.bias" in name:
                p.grad_req = "null"
    seen = {"jax": [], "port": []}
    for name, blk in _jax_blocks(jnet):
        blk.register_forward_hook(
            lambda b, a, o, n=name: seen["jax"].append((n, _dtypes(o))))
    for name, blk in tnet.named_modules():
        blk.register_forward_hook(
            lambda b, a, o, n=name: seen["port"].append((n, _dtypes(o))))
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jautograd.record():
        jlogits = jnet(mx.np.array(x))
        jloss = jloss_fn(jlogits, mx.np.array(y))
    jloss.backward()
    with tmx.autograd.record():
        tlogits = tnet(torch.from_numpy(x))
        tloss = tloss_fn(tlogits, torch.from_numpy(y))
    tmx.autograd.backward(tloss)
    assert seen["port"] == seen["jax"]
    assert dict(seen["port"])[""] == ("bfloat16",)  # the head's "dot"
    assert ("backbone.final_ln", ("float32",)) in seen["port"]
    assert _name(tloss.dtype) == _name(jloss.dtype) == "float32"
    for got, want in ((tlogits, jlogits), (tloss, jloss)):
        want = _np(want)
        assert onp.abs(_np(got) - want).max() <= 2e-2 * onp.abs(want).max()
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    grads = {}
    for name, p in tparams.items():
        if p.grad_req == "null":
            continue
        g = p.grad()
        assert p.dtype == g.dtype == torch.float32, name
        want = jparams[name].grad().asnumpy()
        assert _name(jparams[name].grad().dtype) == "float32"
        assert torch.isfinite(g).all(), name
        scale = onp.abs(want).max()
        assert onp.abs(g.numpy() - want).max() <= 3e-2 * scale + 1e-7, name
        grads[name] = scale
    # one SGD-momentum step from these gradients
    hyper = {"learning_rate": 0.1, "momentum": 0.9}
    mx.gluon.Trainer(jparams, "sgd", dict(hyper)).step(GPT_BATCH)
    tmx.gluon.Trainer(tparams, "sgd", dict(hyper)).step(GPT_BATCH)
    ref = jfunctional.param_arrays(jnet)
    for name, w in tfunctional.param_arrays(tnet).items():
        allow = 0.1 / GPT_BATCH * 3e-2 * grads.get(name, 0.0) + 1e-6
        assert onp.abs(w - onp.asarray(ref[name])).max() <= allow, name


@pytest.mark.parametrize("fused", ["on", "off"])
def test_bert_under_amp_matches_jax_dtypes(fused):
    """A small BERT (128 units: the reference fuses only D % 128 == 0)
    under ``amp.init``: every block's output dtype in call order as the JAX
    package's, with the fused ln_residual route "on" (fp32 x after an fp32
    LayerNorm, bf16 h from the bf16 attention: both packages widen the
    pair and return fp32) and "off"; the MLM and NSP scores within 2e-2 of
    their largest |value|."""
    cfg = dict(vocab_size=1000, units=128, hidden_size=256, num_layers=2,
               num_heads=4, max_length=64, dropout=0.0, embed_dropout=0.0)
    rs = onp.random.RandomState(16)
    ids = rs.randint(0, 1000, (2, 32)).astype("int32")
    types = (onp.arange(32)[None, :] >= 12).astype("int32").repeat(2, 0)
    valid = onp.array([32, 21], dtype="int32")
    old = mx.config.get("fused_ln_residual")
    mx.config.set("fused_ln_residual", fused)
    tmx.config.set("fused_ln_residual", fused)
    try:
        mx.random.seed(16)
        jnet = JBERT(**cfg)
        jnet.initialize()
        jnet(mx.np.array(ids), mx.np.array(types), mx.np.array(valid))
        tnet = tbert.BERTForPretraining(device="cpu", **cfg)
        tfunctional.load_params(tnet, {
            k: onp.asarray(v)
            for k, v in jfunctional.param_arrays(jnet).items()})
        seen = {"jax": [], "port": []}
        for name, blk in _jax_blocks(jnet):
            blk.register_forward_hook(
                lambda b, a, o, n=name: seen["jax"].append((n, _dtypes(o))))
        for name, blk in tnet.named_modules():
            blk.register_forward_hook(
                lambda b, a, o, n=name: seen["port"].append((n, _dtypes(o))))
        jamp.init("bfloat16")
        tamp.init("bfloat16")
        with jautograd.record():
            jout = jnet(mx.np.array(ids), mx.np.array(types),
                        mx.np.array(valid))
        with tmx.autograd.record():
            tout = tnet(*(torch.from_numpy(a) for a in (ids, types, valid)))
    finally:
        mx.config.set("fused_ln_residual", old)
        tmx.config.reset("fused_ln_residual")
    assert seen["port"] == seen["jax"]
    cells = [d for n, d in seen["port"] if n.endswith("layer0")]
    assert cells == [("float32",)]
    for got, want in zip(tout, jout):
        assert _name(got.dtype) == _name(want.dtype)
        want = _np(want)
        assert onp.abs(_np(got) - want).max() <= 2e-2 * onp.abs(want).max()


# -- multi_precision -------------------------------------------------------------

MP_CASES = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
    "adam": {"learning_rate": 1e-2, "wd": 0.01},
    "adamw": {"learning_rate": 1e-2, "wd": 0.01},
}


def _bf16_ulp(a):
    """One bf16 ulp at each fp32 value of ``a``."""
    e = onp.floor(onp.log2(onp.maximum(onp.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", sorted(MP_CASES))
def test_update_multi_precision_matches_jax(name):
    """The same bf16 gradients fed to both packages'
    ``update_multi_precision`` for 3 steps: fp32 masters within 1e-6, bf16
    weights equal or one ulp apart where the masters differ."""
    rs = onp.random.RandomState(10)
    w0 = (rs.randn(6, 5) * 0.5).astype("float32")
    grads = [(rs.randn(6, 5) * 0.1).astype("float32") for _ in range(3)]
    jo = jopt.create(name, multi_precision=True, **MP_CASES[name])
    to = topt.create(name, multi_precision=True, **MP_CASES[name])
    jw, tw = _jarr(w0, "bfloat16"), _tarr(w0, "bfloat16")
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    assert ts[0].dtype == torch.float32
    for g in grads:
        js = jo.update_multi_precision(0, jw, _jarr(g, "bfloat16"), js)
        to.update_multi_precision(0, tw, _tarr(g, "bfloat16"), ts)
    jmaster, tmaster = js[0].asnumpy(), ts[0].numpy()
    assert tw.dtype == torch.bfloat16 and ts[0].dtype == torch.float32
    onp.testing.assert_allclose(tmaster, jmaster, atol=1e-6, rtol=0)
    wt, wj = _np(tw), _np(jw)
    diff = onp.abs(wt - wj)
    masters_differ = tmaster != jmaster
    assert ((diff == 0) | (masters_differ & (diff <= _bf16_ulp(wj)))).all()
    # the inner state lives in fp32 beside the master
    inner = ts[1] if isinstance(ts[1], tuple) else (ts[1],)
    assert all(s.dtype == torch.float32 for s in inner)


def _bf16_dense(seed):
    _, tnet = _dense_pair(3, 4, seed)
    tnet.cast("bfloat16")
    return tnet


def test_multi_precision_states_stay_fp32_through_save_and_load(tmp_path):
    net = _bf16_dense(11)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2, "multi_precision": True})
    x = _tarr(onp.random.RandomState(11).rand(2, 4), "bfloat16")
    for _ in range(2):
        with tmx.autograd.record():
            loss = net(x).float().sum()
        tmx.autograd.backward(loss)
        tr.step(2)
    tr.save_states(str(tmp_path / "states"))
    other = tmx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-2,
                               "multi_precision": True})
    other.load_states(str(tmp_path / "states"))
    for i, (master, (m, v)) in tr._updater.states.items():
        om, (omm, omv) = other._updater.states[i]
        for a, b in ((master, om), (m, omm), (v, omv)):
            assert b.dtype == torch.float32
            torch.testing.assert_close(b, a, atol=0, rtol=0)
        # the master is not the bf16 weight rounded
        assert not torch.equal(master, master.to(torch.bfloat16).float())


def test_cast_net_states_and_param_arrays_round_trip(tmp_path):
    """A bf16 net without multi_precision: its Adam states are bf16 and
    survive save_states / load_states bit for bit (numpy has no bf16: they
    are widened to fp32 on the way, exactly), and
    ``functional.param_arrays`` / ``load_params`` carry the bf16 weights
    across exactly."""
    net = _bf16_dense(15)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
    x = _tarr(onp.random.RandomState(15).rand(2, 4), "bfloat16")
    with tmx.autograd.record():
        loss = net(x).float().sum()
    tmx.autograd.backward(loss)
    tr.step(2)
    tr.save_states(str(tmp_path / "states"))
    other = tmx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-2})
    other.load_states(str(tmp_path / "states"))
    for i, (m, v) in tr._updater.states.items():
        om, ov = other._updater.states[i]
        assert m.dtype == om.dtype == torch.bfloat16
        assert torch.equal(om, m) and torch.equal(ov, v)
    arrays = tfunctional.param_arrays(net)
    copy = _bf16_dense(16)
    tfunctional.load_params(copy, arrays)
    for name, p in net.collect_params().items():
        assert torch.equal(copy.collect_params()[name].data(), p.data())


def test_multi_precision_load_states_by_name_from_jax_keeps_fp32():
    """A JAX trainer's multi-precision state (master, (mean, var)) carried
    by name: the port keeps every array in fp32, equal to the JAX one."""
    rs = onp.random.RandomState(12)
    w = (rs.randn(3, 4) * 0.5).astype("float32")
    b = (rs.randn(3) * 0.1).astype("float32")
    jnet = jnn.Dense(3, in_units=4)
    jnet.initialize()
    jnet.weight.set_data(mx.np.array(w))
    jnet.bias.set_data(mx.np.array(b))
    jnet.cast("bfloat16")
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam",
                           {"learning_rate": 1e-2, "multi_precision": True})
    with jautograd.record():
        loss = jnet(_jarr(rs.rand(2, 4), "bfloat16")).astype("float32").sum()
    loss.backward()
    jtr.step(2)
    names = list(jnet.collect_params())
    states = {names[i]: (s[0].asnumpy(), tuple(a.asnumpy() for a in s[1]))
              for i, s in jtr._updaters[0].states.items()}
    counts = {names[i]: c for i, c in
              jtr._optimizer._index_update_count.items()}
    tnet = _bf16_dense(12)
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-2, "multi_precision": True})
    ttr.load_states_by_name(states, counts)
    for i, (master, (m, v)) in ttr._updater.states.items():
        want = states[names[i]]
        for got, ref in ((master, want[0]), (m, want[1][0]),
                         (v, want[1][1])):
            assert got.dtype == torch.float32
            onp.testing.assert_array_equal(got.numpy(), ref)


# -- the Trainer's non-finite guard ------------------------------------------------

def _guard_step(amp_, record, backward, net, trainer, x):
    with record():
        loss = (net(x) ** 2).sum()
        with amp_.scale_loss(loss, trainer) as scaled:
            backward(scaled)
    trainer.step(1)


def test_trainer_guard_matches_jax_and_survives_state_dict():
    """Finite, inf, finite, NaN, finite steps under a loss scaler: a
    non-finite step leaves the weights as they are, halves the scale and
    counts itself, a clean one updates; weights, scale, window and count
    as the JAX Trainer's after every step. "add" gradients are cleared
    by a skipped step. The scaler and the count survive state_dict."""
    jnet, tnet = _dense_pair(3, 4, 13)
    jnet.bias.grad_req = "add"
    tnet.bias._mx_param.grad_req = "add"
    hyper = {"learning_rate": 1e-6, "momentum": 0.9}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(hyper))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(hyper))
    rs = onp.random.RandomState(13)
    xs = [rs.rand(2, 4).astype("float32") for _ in range(5)]
    xs[1][0, 2] = onp.inf
    xs[3][1, 1] = onp.nan
    for k, x in enumerate(xs):
        before = tnet.weight.detach().clone()
        _guard_step(jamp, jautograd.record, lambda l: l.backward(), jnet,
                    jtr, _jarr(x))
        _guard_step(tamp, tmx.autograd.record, tmx.autograd.backward, tnet,
                    ttr, _tarr(x))
        js, ts = jtr._amp_loss_scaler, ttr._amp_loss_scaler
        assert ts.state_dict() == js.state_dict(), k
        assert ttr.nonfinite_steps == jtr.nonfinite_steps, k
        if not onp.isfinite(x).all():
            assert torch.equal(tnet.weight, before), k
            assert not tnet.bias.grad.any(), k  # "add" cleared
            assert not jnet.bias.grad().asnumpy().any(), k
        ref = jfunctional.param_arrays(jnet)
        for name, w in tfunctional.param_arrays(tnet).items():
            onp.testing.assert_allclose(w, onp.asarray(ref[name]),
                                        rtol=1e-5, atol=1e-6,
                                        err_msg=f"{name} step {k}")
    assert ttr.nonfinite_steps == 2
    assert ttr._amp_loss_scaler.loss_scale == 2 ** 14
    state = ttr.state_dict()
    other = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                              {"learning_rate": 5.0})
    other.load_state_dict(state)
    assert other.nonfinite_steps == 2
    assert other._amp_loss_scaler.state_dict() == \
        ttr._amp_loss_scaler.state_dict()
    assert other.learning_rate == pytest.approx(1e-6)
    for i, mom in ttr._updater.states.items():
        torch.testing.assert_close(other._updater.states[i], mom, atol=0,
                                   rtol=0)


def test_trainer_guard_by_config_knob():
    """trainer.skip_nonfinite turns the guard on without a loss scaler;
    off (the default), a non-finite gradient reaches the weights."""
    _, net = _dense_pair(2, 3, 14)
    x = _tarr(onp.array([[1.0, onp.inf, 0.5]]))
    for skip in (True, False):
        tmx.config.set("trainer.skip_nonfinite", skip)
        try:
            tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
            with tmx.autograd.record():
                loss = net(x).sum()
            tmx.autograd.backward(loss)
            before = net.weight.detach().clone()
            tr.step(1)
            assert tr.nonfinite_steps == int(skip)
            assert torch.equal(net.weight, before) == skip
        finally:
            tmx.config.reset("trainer.skip_nonfinite")
