"""Port parity: the initializers, JAX package -> PyTorch port.

The deterministic initializers give the JAX package's values exactly:
``Zero``, ``One``, ``Constant``, ``Bilinear``, ``LSTMBias``, ``Load`` (a
dict and an ``npx.save`` file, with ``arg:`` / ``aux:`` prefixes),
``Mixed``'s routing by pattern, the name dispatch (``gamma`` ones,
``bias`` / ``beta`` / ``mean`` zeros, ``running_var`` ones) and an
``InitDesc`` whose ``__init__`` attribute overrides it. The random ones
draw torch's streams, so they are held by their rule: ``Xavier`` (each
``rnd_type`` and ``factor_type``) and ``MSRAPrelu`` stay inside the bound
of the reference's fan rule, and their spread is the rule's (uniform:
max |w| within 2% of the bound and std within 5% of bound / sqrt(3);
gaussian: std within 5% of it, at 65536+ draws); ``Normal``'s std within
5%; ``Orthogonal`` gives ``scale`` times orthonormal rows (W W^T =
scale^2 I within 1e-5). ``Dense(weight_initializer=, bias_initializer=)``
and ``Conv2D(weight_initializer=)`` initialize as the reference's layers
do (the parameter's own initializer before ``initialize(init)``, and the
name dispatch still zeroing a bias).
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(make, name, shape):
    """``make(init_module)(name, array)`` in both packages, on zeros of
    ``shape``: (port values, reference values)."""
    out = []
    for m in (mx, tmx):
        arr = m.np.zeros(shape)
        make(m.init)(name, arr)
        out.append(arr.asnumpy())
    return out[1], out[0]


DETERMINISTIC = {
    "zero": (lambda i: i.Zero(), "weight", (3, 4)),
    "one": (lambda i: i.One(), "weight", (3, 4)),
    "constant": (lambda i: i.Constant(0.25), "dense0.weight", (3, 4)),
    "bilinear": (lambda i: i.Bilinear(), "up.weight", (2, 3, 4, 4)),
    "bilinear_odd": (lambda i: i.Bilinear(), "up.weight", (1, 2, 5, 3)),
    "lstmbias": (lambda i: i.LSTMBias(2.0), "lstm_i2h_weight", (8, 3)),
    "lstmbias_on_a_bias": (lambda i: i.LSTMBias(2.0), "lstm.i2h_bias", (8,)),
    "gamma": (lambda i: i.Uniform(), "bn.gamma", (5,)),
    "beta": (lambda i: i.Uniform(), "bn.beta", (5,)),
    "bias": (lambda i: i.Constant(3.0), "fc.bias", (5,)),
    "running_var": (lambda i: i.Uniform(), "bn.running_var", (5,)),
    "moving_mean": (lambda i: i.Uniform(), "bn.moving_mean", (5,)),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_deterministic_initializers_match_jax(case):
    make, name, shape = DETERMINISTIC[case]
    got, want = _both(make, name, shape)
    assert got.dtype == want.dtype
    onp.testing.assert_array_equal(got, want)


def test_initdesc_attr_overrides_the_name_rule_like_jax():
    """An ``InitDesc`` whose attrs name an initializer takes it: a bias
    comes out ones, not the name rule's zeros."""
    outs = []
    for m in (mx, tmx):
        arr = m.np.zeros((2, 3))
        desc = m.init.InitDesc("fc.bias", attrs={"__init__": "ones"})
        m.init.Uniform()(desc, arr)
        assert desc.global_init is not None
        outs.append(arr.asnumpy())
    onp.testing.assert_array_equal(outs[1], outs[0])
    assert (outs[1] == 1).all()


def test_the_one_argument_form_and_a_tensor_in_place():
    a = tmx.np.zeros((2, 2))
    v = a.version
    tmx.init.Constant(1.5)(a)
    assert a.version == v + 1 and (a.asnumpy() == 1.5).all()
    t = torch.zeros(2, 3)
    tinit.One()("w", t)
    assert (t == 1).all()


def test_load_matches_jax(tmp_path):
    src = {"arg:fc.weight": onp.arange(6, dtype="float32").reshape(2, 3),
           "aux:bn.running_mean": onp.ones(3, "float32")}
    path = str(tmp_path / "p.npz")
    mx.npx.save(path, {k: mx.np.array(v) for k, v in src.items()})
    for param in (src, path):
        outs = []
        for m in (mx, tmx):
            init = m.init.Load(param, default_init=m.init.Constant(7.0))
            w, rm, other = (m.np.zeros((2, 3)), m.np.zeros(3),
                            m.np.zeros((2, 2)))
            init("fc.weight", w)
            init("bn.running_mean", rm)
            init("fc2.weight", other)
            outs.append([x.asnumpy() for x in (w, rm, other)])
        for g, w in zip(*reversed(outs)):
            onp.testing.assert_array_equal(g, w)
    with pytest.raises(tmx.MXNetError, match="shape"):
        tmx.init.Load(src)("fc.weight", tmx.np.zeros((3, 3)))
    with pytest.raises(tmx.MXNetError, match="not found"):
        tmx.init.Load(src)("nope", tmx.np.zeros(1))


def test_mixed_routes_by_pattern_like_jax():
    names = ["fc1.weight", "fc1.bias", "conv.weight", "other.weight"]
    outs = []
    for m in (mx, tmx):
        init = m.init.Mixed([".*fc.*", ".*conv.*", ".*"],
                            [m.init.Constant(2.0), m.init.One(),
                             m.init.Zero()])
        arrs = [m.np.full((2, 2), 9.0) for _ in names]
        for n, a in zip(names, arrs):
            init(n, a)
        outs.append([a.asnumpy() for a in arrs])
    for g, w in zip(*reversed(outs)):
        onp.testing.assert_array_equal(g, w)
    with pytest.raises(tmx.MXNetError):
        tmx.init.Mixed(["^x$"], [tmx.init.One()])("y", tmx.np.zeros(1))


def _fan_bound(shape, factor_type, magnitude):
    hw = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    return math.sqrt(magnitude / factor)


@pytest.mark.parametrize("shape", [(256, 512), (64, 32, 3, 3), (512, 128)])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
def test_xavier_follows_the_reference_fan_rule(shape, factor_type, rnd_type):
    bound = _fan_bound(shape, factor_type, 3.0)
    tmx.random.seed(0)
    got = tmx.np.zeros(shape)
    tmx.init.Xavier(rnd_type, factor_type, 3)("w", got)
    got = got.asnumpy()
    assert tinit.Xavier(rnd_type, factor_type, 3).scale(shape) == \
        pytest.approx(bound, rel=1e-12)
    if rnd_type == "uniform":
        ref = mx.np.zeros(shape)
        mx.init.Xavier(rnd_type, factor_type, 3)("w", ref)
        ref = onp.abs(ref.asnumpy()).max()
        assert ref <= bound and onp.abs(got).max() <= bound
        assert onp.abs(got).max() > 0.98 * bound and ref > 0.98 * bound
        assert got.std() == pytest.approx(bound / math.sqrt(3), rel=0.05)
    else:
        assert got.std() == pytest.approx(bound, rel=0.05)
    assert abs(got.mean()) < 5 * got.std() / math.sqrt(got.size)


@pytest.mark.parametrize("slope", [0.0, 0.25])
def test_msraprelu_and_normal(slope):
    shape = (128, 64, 3, 3)
    got = tmx.np.zeros(shape)
    tmx.init.MSRAPrelu("in", slope)("w", got)
    want_std = _fan_bound(shape, "in", 2.0 / (1 + slope ** 2))
    assert got.asnumpy().std() == pytest.approx(want_std, rel=0.05)
    n = tmx.np.zeros((300, 300))
    tmx.init.Normal(0.02)("w", n)
    assert n.asnumpy().std() == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("shape", [(16, 64), (64, 64), (8, 4, 3, 3)])
def test_orthogonal_gives_orthonormal_rows(shape):
    w = tmx.np.zeros(shape)
    tmx.init.Orthogonal(scale=1.5)("w", w)
    flat = w.asnumpy().reshape(shape[0], -1).astype(onp.float64)
    onp.testing.assert_allclose(flat @ flat.T, 2.25 * onp.eye(shape[0]),
                                atol=1e-5)


def test_create_and_dumps_round_trip():
    for spec in ("zeros", "ones", "uniform", "normal", "xavier",
                 "msraprelu", "orthogonal", "lstmbias", "bilinear",
                 "constant"):
        assert isinstance(tinit.create(spec), tinit.Initializer), spec
    x = tinit.Xavier("gaussian", "in", 2)
    y = tinit.create(x.dumps())
    assert type(y) is tinit.Xavier and y.rnd_type == "gaussian" \
        and y.factor_type == "in" and y.magnitude == 2.0
    assert tinit.create(x) is x
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tinit.create("nope")


def _dense_weights(m, **kw):
    net = m.gluon.nn.Dense(3, in_units=4, **kw)
    net.initialize(init=m.init.Constant(9.0))
    return [p.data().asnumpy() if m is mx else p.data().detach().numpy()
            for p in net.collect_params().values()]


@pytest.mark.parametrize("kw", [
    {}, {"weight_initializer": "ones"},
    {"weight_initializer": "constant", "bias_initializer": "ones"},
    {"bias_initializer": "ones"}], ids=["default", "w_ones", "w_const",
                                        "b_ones"])
def test_dense_initializers_match_jax(kw):
    def conv(m):
        return {k: (m.init.Constant(0.3) if v == "constant" else v)
                for k, v in kw.items()}
    want = _dense_weights(mx, **conv(mx))
    got = _dense_weights(tmx, **conv(tmx))
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)


def test_conv2d_weight_initializer():
    outs = []
    for m in (mx, tmx):
        net = m.gluon.nn.Conv2D(4, 3, in_channels=2,
                                weight_initializer=m.init.Constant(0.5))
        net.initialize()
        outs.append([p.data().asnumpy() if m is mx
                     else p.data().detach().numpy()
                     for p in net.collect_params().values()])
    for g, w in zip(*reversed(outs)):
        onp.testing.assert_array_equal(g, w)
    net = tmx.gluon.nn.Conv2D(8, 3, in_channels=4,
                              weight_initializer=tmx.init.Xavier())
    net.initialize()
    bound = _fan_bound((8, 4, 3, 3), "avg", 3.0)
    w = net.weight.detach().abs().max().item()
    assert 0 < w <= bound
