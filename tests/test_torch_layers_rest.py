"""Port parity: the layers of this slice (activations, the rest of
``basic_layers``, ``conv_layers`` and ``transformer``).

Each layer is built in both packages with the same arguments; the port's
parameters (random after the first forward, so offsets, slopes and
affines are exercised) are carried to the JAX package's by structural
name; then a recorded forward on the same seeded input and the gradient
of ``sum(out * ct)`` with respect to the input and every parameter,
at rtol 1e-5, atol 1e-5 (norms and deformable sampling through two
op orders). ``ceil_mode=True`` pools as the reference does (the "valid"
windows), ``Dropout(axes=)`` shares its draw along the axes,
``Embedding(sparse_grad=True)`` gives its weight the reference's
row-sparse gradient type (since sparse storage is ported), and the GELU
tanh form is held against its formula.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _pair(name, args, kwargs, children=None):
    tl = getattr(tnn, name)(*args, **kwargs)
    jl = getattr(jnn, name)(*args, **kwargs)
    for c in children or ():
        tl.add(getattr(tnn, c[0])(*c[1], **c[2]))
        jl.add(getattr(jnn, c[0])(*c[1], **c[2]))
    return tl, jl


def _carry(tl, jl, x, extra, seed):
    """First forward in both (deferred shapes), random port parameters,
    carried to the JAX layer by name."""
    tl.initialize(seed=seed)
    jl.initialize()
    tl(torch.from_numpy(x), *[torch.from_numpy(e) for e in extra])
    jl(mx.np.array(x), *[mx.np.array(e) for e in extra])
    rs = onp.random.RandomState(seed + 1)
    tparams, jparams = tl.collect_params(), jl.collect_params()
    assert set(tparams) == set(jparams), (set(tparams), set(jparams))
    for n, p in tparams.items():
        v = (rs.randn(*p.shape) * 0.3).astype("float32")
        if "running_var" in n:
            v = onp.abs(v) + 0.5
        p.set_data(torch.from_numpy(v))
        jparams[n].set_data(mx.np.array(v))
    return tparams, jparams


def _check(tl, jl, x, extra=(), seed=0, rtol=1e-5, atol=1e-5):
    tparams, jparams = _carry(tl, jl, x, extra, seed)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    with tmx.autograd.record():
        tout = tl(tx, *[torch.from_numpy(e) for e in extra])
    ct = onp.random.RandomState(seed + 2).randn(*tout.shape).astype(
        "float32")
    tmx.autograd.backward(tout, torch.from_numpy(ct))
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jout = jl(jx, *[mx.np.array(e) for e in extra])
    jout.backward(mx.np.array(ct))
    onp.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(),
                                rtol=rtol, atol=atol)
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                rtol=rtol, atol=atol)
    for n, p in tparams.items():
        if p.grad_req == "null":
            continue
        onp.testing.assert_allclose(p.grad().numpy(),
                                    jparams[n].grad().asnumpy(), rtol=rtol,
                                    atol=atol, err_msg=n)
    return tout


def _x(*shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


LAYERS = {
    # activations
    "leaky": ("LeakyReLU", (0.2,), {}, (4, 6)),
    "prelu": ("PReLU", (), {}, (4, 6)),
    "prelu_channels": ("PReLU", (), {"in_channels": 6}, (4, 6)),
    "elu": ("ELU", (0.7,), {}, (4, 6)),
    "selu": ("SELU", (), {}, (4, 6)),
    "gelu": ("GELU", (), {}, (4, 6)),
    "silu": ("SiLU", (), {}, (4, 6)),
    "swish": ("Swish", (1.5,), {}, (4, 6)),
    # basic layers
    "layernorm_axis": ("LayerNorm", (), {"axis": 1, "center": False},
                       (3, 5, 4)),
    "layernorm_deferred": ("LayerNorm", (), {"epsilon": 1e-3}, (3, 7)),
    "groupnorm": ("GroupNorm", (), {"num_groups": 2}, (2, 4, 3, 3)),
    "instancenorm": ("InstanceNorm", (), {"scale": True}, (2, 3, 5)),
    "identity": ("Identity", (), {}, (2, 3)),
    # convolutions
    "conv1d": ("Conv1D", (4, 3), {"padding": 1, "strides": 2}, (2, 3, 9)),
    "conv3d": ("Conv3D", (2, 2), {"activation": "relu"}, (1, 2, 4, 4, 4)),
    "conv1d_t": ("Conv1DTranspose", (3, 3), {"strides": 2}, (2, 4, 5)),
    "conv2d_t": ("Conv2DTranspose", (4, 3),
                 {"strides": 2, "padding": 1, "groups": 2}, (2, 4, 5, 5)),
    "conv3d_t": ("Conv3DTranspose", (2, 2), {"strides": 2},
                 (1, 3, 3, 3, 3)),
    "deformable": ("DeformableConvolution", (4,),
                   {"kernel_size": 3, "padding": 1}, (2, 3, 6, 6)),
    "deformable_groups": ("DeformableConvolution", (4,),
                          {"kernel_size": 3, "padding": 1, "strides": 2,
                           "num_deformable_group": 3}, (1, 3, 7, 7)),
    "modulated": ("ModulatedDeformableConvolution", (4,),
                  {"kernel_size": 3, "padding": 1}, (2, 3, 6, 6)),
    # pooling
    "maxpool1d": ("MaxPool1D", (3, 2, 1), {}, (2, 3, 10)),
    "maxpool3d": ("MaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    "avgpool1d": ("AvgPool1D", (3, 2, 1), {"count_include_pad": False},
                  (2, 3, 10)),
    "avgpool2d": ("AvgPool2D", (3, 2, 1), {}, (2, 3, 7, 7)),
    "avgpool2d_ceil": ("AvgPool2D", (3, 2), {"ceil_mode": True},
                       (2, 3, 8, 8)),
    "maxpool2d_ceil": ("MaxPool2D", (3, 2), {"ceil_mode": True},
                       (2, 3, 8, 8)),
    "avgpool3d": ("AvgPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    "gmaxpool1d": ("GlobalMaxPool1D", (), {}, (2, 3, 6)),
    "gmaxpool2d": ("GlobalMaxPool2D", (), {}, (2, 3, 4, 5)),
    "gmaxpool3d": ("GlobalMaxPool3D", (), {}, (1, 2, 3, 4, 5)),
    "gavgpool1d": ("GlobalAvgPool1D", (), {}, (2, 3, 6)),
    "gavgpool3d": ("GlobalAvgPool3D", (), {}, (1, 2, 3, 4, 5)),
    "reflection": ("ReflectionPad2D", (2,), {}, (1, 2, 5, 6)),
    "reflection4": ("ReflectionPad2D", ((1, 2, 0, 3),), {}, (1, 2, 5, 6)),
    "pixel1d": ("PixelShuffle1D", (3,), {}, (2, 6, 4)),
    "pixel2d": ("PixelShuffle2D", ((2, 3),), {}, (2, 12, 3, 4)),
    "pixel3d": ("PixelShuffle3D", (2,), {}, (1, 16, 2, 3, 2)),
    # transformer
    "ffn_relu": ("PositionwiseFFN", (8, 16), {"activation": "relu"},
                 (2, 3, 8)),
    "ffn_tanh": ("PositionwiseFFN", (8, 16), {"activation": "tanh"},
                 (2, 3, 8)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    name, args, kwargs, shape = LAYERS[case]
    tl, jl = _pair(name, args, kwargs)
    _check(tl, jl, _x(*shape, seed=len(case)), seed=len(case))


@pytest.mark.parametrize("kind", ["HybridSequential", "Sequential",
                                  "HybridConcatenate", "Concatenate"])
def test_containers_match_jax(kind):
    args = (1,) if "Concatenate" in kind else ()
    children = [("Dense", (5,), {"activation": "tanh"}),
                ("Dense", (5,), {})]
    if "Concatenate" not in kind:
        children[1] = ("Dense", (3,), {})
    tl, jl = _pair(kind, args, {}, children)
    _check(tl, jl, _x(4, 6))


@pytest.mark.parametrize("kind", ["BatchNormReLU", "SyncBatchNorm"])
def test_batchnorm_variants_match_jax(kind):
    kw = {} if kind == "BatchNormReLU" else {"in_channels": 3}
    tl, jl = _pair(kind, (), kw)
    x = _x(4, 3, 5, 5)
    _check(tl, jl, x)
    for n in ("running_mean", "running_var"):
        onp.testing.assert_allclose(
            tl.collect_params()[n].data().numpy(),
            jl.collect_params()[n].data().asnumpy(), rtol=1e-5, atol=1e-6)


def test_lambdas_match_jax():
    for tl, jl in ((tnn.HybridLambda("tanh"), jnn.HybridLambda("tanh")),
                   (tnn.Lambda(lambda x: x * x), jnn.Lambda(lambda x: x * x))):
        _check(tl, jl, _x(3, 4))
    tl = tnn.Lambda("tanh")
    tl.hybridize()
    assert not tl._active


def test_decoder_cell_matches_jax():
    tl = tnn.TransformerDecoderCell(8, 16, 2, device="cpu")
    jl = jnn.TransformerDecoderCell(8, 16, 2)
    _check(tl, jl, _x(2, 3, 8), extra=(_x(2, 4, 8, seed=1),), atol=2e-5)


def test_positional_encoding_matches_jax():
    got = tnn.positional_encoding(7, 6)
    assert got.device == tmx.cpu()
    onp.testing.assert_array_equal(
        got.asnumpy(), jnn.transformer.positional_encoding(7, 6).asnumpy())


def test_gelu_tanh_and_rrelu():
    x = torch.from_numpy(_x(3, 5))
    want = 0.5 * x * (1 + torch.tanh((2 / torch.pi) ** 0.5
                                     * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(tnn.GELU("tanh")(x), want)
    # rrelu: the midpoint slope outside training (the reference's),
    # a draw in [lower, upper] from the given generator in training
    want = mx.npx.leaky_relu(mx.np.array(x.numpy()), act_type="rrelu")
    got = tmx.npx.leaky_relu(x, act_type="rrelu")
    onp.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    with tmx.autograd.train_mode():
        y = tmx.npx.leaky_relu(x, act_type="rrelu", generator=gen)
    neg = x < 0
    slope = (y[neg] / x[neg])
    assert ((slope >= 0.125) & (slope <= 0.334)).all()
    assert torch.equal(y[~neg], x[~neg])


def test_dropout_axes_share_the_draw():
    drop = tnn.Dropout(0.5, axes=(1,))
    drop.generator = torch.Generator().manual_seed(1)
    x = torch.ones(8, 6, 3)
    with tmx.autograd.record():
        y = drop(x)
    assert torch.equal(y, y[:, :1].expand_as(y))
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(drop(x), x)  # identity outside training


def test_embedding_sparse_grad_still_raises():
    """No longer raises (sparse storage is ported): the weight's gradient
    storage type is the reference's "row_sparse"."""
    got = tnn.Embedding(10, 4, sparse_grad=True, device="cpu")
    want = jnn.Embedding(10, 4, sparse_grad=True)
    assert got.weight._mx_param.grad_stype == "row_sparse" \
        == want.weight._grad_stype


def test_every_reference_layer_exists():
    names = {n for n in dir(jnn) if isinstance(getattr(jnn, n), type)}
    missing = names - set(dir(tnn)) - {"Block", "SymbolBlock", "MoEDense"}
    assert not missing, missing
