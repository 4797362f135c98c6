"""Port parity: int8 post-training quantization, JAX package -> PyTorch port.

Inputs are made with numpy from a seed and go through both packages. The
JAX side runs as its own tests run it: ``quantize.fused_matmul="on"``
(the Pallas kernel in interpret mode) and "off" (the XLA chain). On the
CPU the port's wrappers take the plain versions. Tolerances:

1. ``quantized_matmul_plain`` vs the JAX ``_int8_kernel`` (interpret) and
   the XLA chain: bit for bit without bias (the same quantization, an
   exact integer product, one fp32 multiply), at the reference's shapes;
   atol 1e-5 with bias and for every activation (the reference's own
   tolerance between its kernel and its chain; the activations are
   torch's, not jnp's, and may differ in the last ulp); NaN, +-inf,
   values past the threshold and exact .5 ties bit for bit;
2. ``npx.quantize_v2`` / ``dequantize`` / ``quantized_fully_connected`` /
   ``quantized_dense_fused`` vs the JAX package: bit for bit where no bias
   is added, atol 1e-5 where one is;
3. the calibration functions (``_Stats.update`` with its re-binning,
   ``optimal_threshold``, ``_percentile_threshold``) and
   ``_quantize_weight``: bit for bit (the same numpy code on the same
   inputs);
4. ``quantize_net`` on a ``HybridSequential`` MLP and on a small
   ``BERTModel``: thresholds within 1e-6 relative (a layer's input is the
   previous fp32 layers' output, which the two packages round apart by an
   ulp), ``qweight``/``w_scale``/``bias_c`` bit for bit; with the JAX
   package's thresholds carried in, the MLP's output bit for bit and
   BERT's sequence and pooled outputs atol 1e-5 (measured 7.2e-7 and
   1.2e-7: the fp32 LayerNorm, attention and GELU between the layers
   differ by ulps across the packages);
5. ``copy.deepcopy`` of a port block and ``Constant``: exactly.
"""
import copy

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops.pallas import quant_matmul as jqm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.parameter import Constant
from mxnet_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

ACTS = ["relu", "sigmoid", "tanh", "gelu"]
SHAPES = [(24, 40, 12), (1, 7, 3), (5, 33, 7), (130, 257, 129)]  # (M, K, N)


def _rand(*shape, seed=0, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale).astype(
        "float32")


def _inputs(m, k, n, seed=0):
    """The reference's ``_fused_inputs``: x, int8 w, x_scale, w_scale."""
    x = _rand(m, k, seed=seed)
    qw, ws = jq._quantize_weight(_rand(n, k, seed=seed + 1, scale=0.5))
    return x, qw, onp.float32(onp.abs(x).max() / 127.0), ws


def _t(*arrays):
    return [torch.from_numpy(onp.ascontiguousarray(a)) for a in arrays]


def _route(mode, fn):
    """``fn()`` with ``quantize.fused_matmul`` set to ``mode`` in both
    packages."""
    old = mx.config.set("quantize.fused_matmul", mode)
    tmx.config.set("quantize.fused_matmul", mode)
    try:
        return fn()
    finally:
        mx.config.set("quantize.fused_matmul", old)
        tmx.config.reset("quantize.fused_matmul")


def _jax_fused(x, qw, xs, ws, mode, bias=None, act=None, flatten=True):
    args = [mx.np.array(a) for a in (x, qw)]
    return _route(mode, lambda: mx.npx.quantized_dense_fused(
        args[0], args[1], float(xs), mx.np.array(ws),
        bias=None if bias is None else mx.np.array(bias), act=act,
        flatten=flatten).asnumpy())


# -- 1. the plain matmul vs the JAX kernel and chain ---------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matmul_bit_for_bit_without_bias(m, k, n):
    x, qw, xs, ws = _inputs(m, k, n, seed=m)
    kernel = onp.asarray(jqm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), xs,
        interpret=True))
    chain = _jax_fused(x, qw, xs, ws, "off")
    got = tqm.quantized_matmul(*_t(x, qw, ws), float(xs))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    onp.testing.assert_array_equal(got.numpy(), kernel)
    onp.testing.assert_array_equal(got.numpy(), chain)


@pytest.mark.parametrize("act", [None] + ACTS)
def test_plain_matmul_with_bias_and_activation(act):
    x, qw, xs, ws = _inputs(24, 40, 12, seed=7)
    b = _rand(12, seed=8)
    kernel = onp.asarray(jqm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), xs,
        bias=jnp.asarray(b), act=act, interpret=True))
    chain = _jax_fused(x, qw, xs, ws, "off", bias=b, act=act)
    got = tqm.quantized_matmul(*_t(x, qw, ws), float(xs),
                               bias=torch.from_numpy(b), act=act).numpy()
    onp.testing.assert_allclose(got, kernel, rtol=0, atol=1e-5)
    onp.testing.assert_allclose(got, chain, rtol=0, atol=1e-5)
    if act == "relu":
        assert (got >= 0).all()


def _edge_x():
    """x / x_scale (x_scale 0.5) hits exact .5 ties of both parities,
    NaN, +-inf and values past +-127."""
    ties = onp.arange(-6.5, 7.0, 1.0) * 0.5  # v = -6.5 ... 6.5
    special = [onp.nan, onp.inf, -onp.inf, 200.0, -200.0, 63.75, -63.75,
               63.5, 0.0, -0.0]
    row = onp.concatenate([ties, special]).astype("float32")
    return onp.stack([row, row[::-1] * 0.5, -row]).astype("float32")


def test_plain_quantization_edges_match_jax():
    x = _edge_x()
    qw, ws = jq._quantize_weight(_rand(5, x.shape[1], seed=3))
    xs = onp.float32(0.5)
    q, _, _ = mx.npx.quantize_v2(mx.np.array(x), -63.5, 63.5)
    got_q = tqm.quantize_int8(torch.from_numpy(x), float(xs))
    assert got_q.dtype == torch.int8
    onp.testing.assert_array_equal(got_q.numpy(), q.asnumpy())
    row = got_q[0].tolist()
    assert row[:14] == [-6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6, 6]
    assert row[14:21] == [0, 127, -127, 127, -127, 127, -127]
    kernel = onp.asarray(jqm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), xs,
        interpret=True))
    got = tqm.quantized_matmul(*_t(x, qw, ws), float(xs)).numpy()
    assert onp.isfinite(got).all()
    onp.testing.assert_array_equal(got, kernel)


def test_matmul_validates():
    x, qw, xs, ws = _inputs(4, 16, 5)
    tx, tw, tws = _t(x, qw, ws)
    with pytest.raises(ValueError, match="unsupported fused activation"):
        tqm.quantized_matmul(tx, tw, tws, float(xs), act="softrelu")
    with pytest.raises(MXNetError, match="int8"):
        tqm.quantized_matmul(tx, tw.float(), tws, float(xs))
    with pytest.raises(MXNetError, match="takes x"):
        tqm.quantized_matmul(tx[:, :8], tw, tws, float(xs))
    with pytest.raises(MXNetError, match="w_scale"):
        tqm.quantized_matmul(tx, tw, tws[:-1], float(xs))
    with pytest.raises(MXNetError, match="scalar"):
        tqm.quantized_matmul(tx, tw, tws, torch.ones(2))


# -- 2. the npx operators ----------------------------------------------------

def test_quantize_v2_and_dequantize_match_jax():
    x = _rand(4, 16, seed=1, scale=3.0)
    for calib in ((None, None), (-2.0, 2.0), (-1.0, 4.0)):
        jqx, jmn, jmx = mx.npx.quantize_v2(mx.np.array(x), *calib)
        q, mn, mxr = tmx.npx.quantize_v2(torch.from_numpy(x), *calib)
        assert q.dtype == torch.int8
        onp.testing.assert_array_equal(q.numpy(), jqx.asnumpy())
        assert float(mn) == float(jmn.asnumpy())
        assert float(mxr) == float(jmx.asnumpy())
        back = tmx.npx.dequantize(q, mn, mxr)
        onp.testing.assert_array_equal(
            back.numpy(), mx.npx.dequantize(jqx, jmn, jmx).asnumpy())
    with pytest.raises(NotImplementedError):
        tmx.npx.quantize_v2(torch.from_numpy(x), out_type="uint8")


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fully_connected_matches_jax(flatten, bias):
    data = _rand(3, 4, 10, seed=2)
    k = 40 if flatten else 10
    _, qw, _, ws = _inputs(6, k, 9, seed=3)
    T = float(onp.abs(data).max())
    b = _rand(9, seed=4) if bias else None
    jx, _, _ = mx.npx.quantize_v2(mx.np.array(data), -T, T)
    want = mx.npx.quantized_fully_connected(
        jx, mx.np.array(qw), T / 127, mx.np.array(ws),
        bias=None if b is None else mx.np.array(b),
        flatten=flatten).asnumpy()
    tx, _, _ = tmx.npx.quantize_v2(torch.from_numpy(data), -T, T)
    got = tmx.npx.quantized_fully_connected(
        tx, torch.from_numpy(qw), T / 127, torch.from_numpy(ws),
        bias=None if b is None else torch.from_numpy(b), flatten=flatten)
    assert tuple(got.shape) == want.shape
    if bias:
        onp.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        onp.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("shape,flatten", [((7, 24), True), ((3, 4, 6), True),
                                           ((3, 4, 6), False)])
@pytest.mark.parametrize("act", [None, "tanh"])
def test_quantized_dense_fused_matches_jax(mode, shape, flatten, act):
    data = _rand(*shape, seed=5)
    k = 24 if flatten else 6
    _, qw, _, ws = _inputs(2, k, 11, seed=6)
    xs = onp.float32(onp.abs(data).max() / 127.0)
    want = _jax_fused(data, qw, xs, ws, "off", act=act, flatten=flatten)
    got = _route(mode, lambda: tmx.npx.quantized_dense_fused(
        torch.from_numpy(data), torch.from_numpy(qw), float(xs),
        torch.from_numpy(ws), act=act, flatten=flatten))
    assert tuple(got.shape) == want.shape
    if act is None:
        onp.testing.assert_array_equal(got.numpy(), want)
    else:
        onp.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    b = _rand(11, seed=7)
    want_b = _jax_fused(data, qw, xs, ws, "on", bias=b, act=act,
                        flatten=flatten)
    got_b = _route(mode, lambda: tmx.npx.quantized_dense_fused(
        torch.from_numpy(data), torch.from_numpy(qw), float(xs),
        torch.from_numpy(ws), bias=torch.from_numpy(b), act=act,
        flatten=flatten))
    onp.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=1e-5)


def test_quantized_dense_fused_routes_and_errors():
    x, qw, xs, ws = _inputs(4, 16, 5)
    tx, tw, tws = _t(x, qw, ws)
    with pytest.raises(ValueError, match="cannot be fused"):
        tmx.npx.quantized_dense_fused(tx, tw, float(xs), tws, act="softmax")
    with pytest.raises(MXNetError, match="CUDA tensor"):
        _route("on", lambda: tmx.npx.quantized_dense_fused(
            tx, tw, float(xs), tws))
    # a tensor off the CPU goes to the kernel's wrapper (which raises where
    # the kernel cannot run), never to the plain chain
    meta = torch.device("meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        tmx.npx.quantized_dense_fused(
            torch.empty(4, 16, device=meta),
            torch.empty(5, 16, dtype=torch.int8, device=meta), 0.5,
            torch.ones(5, device=meta))


# -- 3. calibration functions --------------------------------------------------

def _stats_pair(batches, want_hist):
    js, ts = jq._Stats(), tq._Stats()
    for b in batches:
        js.update(b, want_hist)
        ts.update(b, want_hist)
    return js, ts


def test_stats_update_and_thresholds_match_jax():
    # the max grows on the third batch: the histogram is re-binned
    batches = [_rand(50, 40, seed=s, scale=sc)
               for s, sc in ((0, 1.0), (1, 0.5), (2, 3.0), (3, 1.0))]
    js, ts = _stats_pair(batches, True)
    assert ts.abs_max == js.abs_max
    onp.testing.assert_array_equal(ts.hist, js.hist)
    onp.testing.assert_array_equal(ts.hist_edges, js.hist_edges)
    assert tq.optimal_threshold(ts.hist, ts.hist_edges) == \
        jq.optimal_threshold(js.hist, js.hist_edges)
    for pct in (99.0, 99.99):
        assert tq._percentile_threshold(ts.hist, ts.hist_edges, pct) == \
            jq._percentile_threshold(js.hist, js.hist_edges, pct)
    js, ts = _stats_pair(batches + [onp.zeros((0, 3), "float32")], False)
    assert ts.abs_max == js.abs_max and ts.hist is js.hist is None
    zero = onp.zeros(2048)
    assert tq.optimal_threshold(zero, onp.arange(2049.0)) == \
        jq.optimal_threshold(zero, onp.arange(2049.0)) == 2048.0


@pytest.mark.parametrize("shape", [(16, 20), (8, 3, 3, 3), (5, 7)])
def test_quantize_weight_matches_jax(shape):
    w = _rand(*shape, seed=9, scale=0.3)
    w[0] = 0.0  # an all-zero channel takes the 1e-12 floor
    q, scale = tq._quantize_weight(w)
    want_q, want_scale = jq._quantize_weight(w)
    assert q.dtype == onp.int8 and scale.dtype == onp.float32
    onp.testing.assert_array_equal(q, want_q)
    onp.testing.assert_array_equal(scale, want_scale)


# -- 4. quantize_net -------------------------------------------------------------

def _mlp_pair(seed=0, k=20):
    """(JAX MLP, port MLP on the CPU with the same weights): Dense(32,
    relu) -> Dense(10), as the reference's tests."""
    mx.random.seed(seed)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(32, activation="relu"), jnn.Dense(10))
    jnet.initialize()
    jnet(mx.np.array(_rand(2, k)))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(32, activation="relu", in_units=k, device="cpu"),
             tnn.Dense(10, in_units=32, device="cpu"))
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _calib(n=8, rows=64, k=20):
    return [_rand(rows, k, seed=i) for i in range(n)]


@pytest.mark.parametrize("mode", ["naive", "entropy", "percentile"])
def test_quantize_net_mlp_matches_jax(mode):
    jnet, tnet = _mlp_pair()
    calib = _calib()
    jqnet = jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib],
                            calib_mode=mode)
    tqnet = tq.quantize_net(tnet, calib_data=_t(*calib), calib_mode=mode)
    assert isinstance(tnet[0], tnn.Dense) and isinstance(tnet[1], tnn.Dense)
    assert all(isinstance(b, tq.QuantizedDense) for b in tqnet)
    assert len(tqnet) == 2 and tqnet[0]._fused_act == "relu"
    assert tqnet[0].qweight.dtype == torch.int8
    for i in range(2):
        onp.testing.assert_allclose(tqnet[i].threshold, jqnet[i].threshold,
                                    rtol=1e-6, atol=0)
    jarr = {n: onp.asarray(v) for n, v in
            jfunctional.param_arrays(jqnet).items()}
    tarr = tfunctional.param_arrays(tqnet)
    assert sorted(tarr) == sorted(jarr) == [
        f"{i}.{n}" for i in (0, 1) for n in ("bias_c", "qweight", "w_scale")]
    for name, v in jarr.items():
        assert tarr[name].dtype == v.dtype, name
        onp.testing.assert_array_equal(tarr[name], v, err_msg=name)
    # the reference's own checks (tests/test_quantization.py:83-107)
    x = _rand(64, 20, seed=9)
    want = tnet(torch.from_numpy(x)).numpy()
    got = tqnet(torch.from_numpy(x)).numpy()
    mean_rel = onp.abs(got - want).mean() / (onp.abs(want).mean() + 1e-9)
    assert mean_rel < (0.3 if mode != "naive" else 0.1), (mode, mean_rel)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.85
    if mode == "naive":
        assert onp.abs(got - want).max() / onp.abs(want).max() < 0.1
    # with the JAX package's thresholds the quantized nets agree exactly
    for i in range(2):
        tqnet[i].threshold = jqnet[i].threshold
    onp.testing.assert_array_equal(tqnet(torch.from_numpy(x)).numpy(),
                                   jqnet(mx.np.array(x)).asnumpy())


def test_quantize_net_exclude_batches_and_original():
    _, tnet = _mlp_pair(1)
    before = {n: v.copy() for n, v in tfunctional.param_arrays(tnet).items()}
    calib = [(c, onp.zeros(3)) for c in _t(*_calib(4))]  # tuples: first fed
    for kw in ({"exclude_layers": ["1"]}, {"exclude_layers_match": ["1"]}):
        q = tq.quantize_net(tnet, calib_data=calib, **kw)
        assert isinstance(q[0], tq.QuantizedDense)
        assert isinstance(q[1], tnn.Dense) and q[1] is not tnet[1]
    q = tq.quantize_net(tnet, calib_data=calib, exclude_layers_match=["0"],
                        exclude_layers=["1"])
    assert isinstance(q[0], tnn.Dense) and isinstance(q[1], tnn.Dense)
    assert all(isinstance(b, tnn.Dense) for b in tnet)
    for n, v in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_array_equal(v, before[n])
    # num_calib_batches caps the batches: the max over the first two only
    big = _t(*_calib(2)) + [torch.full((64, 20), 1e3)]
    q2 = tq.quantize_net(tnet, calib_data=big, num_calib_batches=2)
    assert q2[0].threshold == float(max(b.abs().max() for b in big[:2]))
    q3 = tq.quantize_net(tnet, calib_data=big)
    assert q3[0].threshold == 1e3


def test_quantize_net_errors():
    _, tnet = _mlp_pair()
    calib = _t(*_calib(1))
    with pytest.raises(NotImplementedError):
        tq.quantize_net(tnet, quantized_dtype="uint8", calib_data=calib)
    with pytest.raises(MXNetError, match="calib_mode"):
        tq.quantize_net(tnet, calib_data=calib, calib_mode="kl")
    with pytest.raises(MXNetError, match="calib_data is required"):
        tq.quantize_net(tnet)
    with pytest.raises(MXNetError, match="calibrated 0 of 2"):
        tq.quantize_net(tnet, calib_data=[])
    with pytest.raises(MXNetError, match="calibrated 0 of 2"):
        tq.quantize_net(tnet, calib_data=[torch.zeros(4, 20)])
    # a NaN batch is skipped by the abs-max, as the reference's `m > max`
    nan = torch.full((4, 20), float("nan"))
    q = tq.quantize_net(tnet, calib_data=[nan, calib[0], nan])
    assert q[0].threshold == float(calib[0].abs().max())


BERT = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
            num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
BERT_PATHS = [f"encoder.layer{i}.{b}" for i in range(2) for b in (
    "attention.query_proj", "attention.key_proj", "attention.value_proj",
    "attention.out_proj", "ffn.ffn_1", "ffn.ffn_2")] + ["pooler"]


def test_quantize_net_bert_matches_jax():
    mx.random.seed(0)
    jnet = jbert.BERTModel(**BERT)
    jnet.initialize()
    rs = onp.random.RandomState(0)
    calib = [rs.randint(0, 101, (4, 32)).astype("int32") for _ in range(2)]
    jnet(mx.np.array(calib[0]))
    tnet = tbert.BERTModel(device="cpu", **BERT)
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    jqnet = jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib])
    tqnet = tq.quantize_net(tnet, calib_data=_t(*calib))
    jl = {p: l for _, _, p, l in jq._walk_layers(jqnet)
          if isinstance(l, jq.QuantizedDense)}
    tl = {p: l for _, _, p, l in tq._walk_layers(tqnet)
          if isinstance(l, tq.QuantizedDense)}
    assert sorted(tl) == sorted(jl) == sorted(BERT_PATHS)
    assert tl["pooler"]._fused_act == "tanh"
    assert sum(isinstance(m, tnn.Dense) for m in tnet.modules()) == 13
    for p in BERT_PATHS:
        onp.testing.assert_allclose(tl[p].threshold, jl[p].threshold,
                                    rtol=1e-6, atol=0, err_msg=p)
    jarr = {n: onp.asarray(v) for n, v in
            jfunctional.param_arrays(jqnet).items()}
    tarr = tfunctional.param_arrays(tqnet)
    assert sorted(tarr) == sorted(jarr)
    for name, v in jarr.items():
        assert tarr[name].dtype == v.dtype, name
        onp.testing.assert_array_equal(tarr[name], v, err_msg=name)
    # the JAX quantized net's parameters and thresholds, carried across
    tfunctional.load_params(tqnet, jarr)
    for p in BERT_PATHS:
        tl[p].threshold = jl[p].threshold
    ids = rs.randint(0, 101, (3, 32)).astype("int32")
    types = (onp.arange(32)[None] >= 10).repeat(3, 0).astype("int32")
    valid = onp.array([32, 20, 7], "int32")
    jseq, jpooled = jqnet(mx.np.array(ids), mx.np.array(types),
                          mx.np.array(valid))
    seq, pooled = tqnet(*_t(ids, types, valid))
    onp.testing.assert_allclose(seq.numpy(), jseq.asnumpy(), rtol=0,
                                atol=1e-5)
    onp.testing.assert_allclose(pooled.numpy(), jpooled.asnumpy(), rtol=0,
                                atol=1e-5)


# -- 5. deep copy and Constant -------------------------------------------------

def test_deepcopy_keeps_parameters():
    """Before the repair the copy's collect_params() raised AttributeError:
    torch's deep copy of an nn.Parameter dropped ``_mx_param``."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=4, device="cpu"),
            tnn.Dense(4, in_units=4, device="cpu"),
            tnn.Dense(3, in_units=4, device="cpu"))
    net.initialize(seed=3)
    net[1].weight = net[0].weight  # tied: one tensor, listed once
    p = net.collect_params()
    assert list(p) == ["0.weight", "0.bias", "1.bias", "2.weight", "2.bias"]
    p["0.bias"].grad_req = "null"
    p["2.weight"].lr_mult, p["2.weight"].wd_mult = 0.5, 0.0
    c = copy.deepcopy(net)
    q = c.collect_params()
    assert list(q) == list(p)
    for name in p:
        assert q[name] is not p[name]
        assert q[name].data().data_ptr() != p[name].data().data_ptr()
        assert torch.equal(q[name].data(), p[name].data())
        assert (q[name].grad_req, q[name].lr_mult, q[name].wd_mult) == (
            p[name].grad_req, p[name].lr_mult, p[name].wd_mult)
        assert q[name].data()._mx_param is q[name]
    assert c[1].weight is c[0].weight
    assert not q["0.bias"].data().requires_grad
    assert q["0.weight"].data().requires_grad
    with torch.no_grad():
        c[0].weight.add_(1.0)
    assert not torch.equal(c[0].weight, net[0].weight)
    x = torch.randn(2, 4)
    assert torch.equal(c[2](x), net[2](x))
    assert copy.deepcopy(p["2.weight"]) is not p["2.weight"]


def test_constant_int8_survives_initialize_and_load():
    value = onp.arange(-6, 6, dtype=onp.int8).reshape(3, 4)
    block = tmx.gluon.HybridBlock()
    block.qweight = Constant(value, name="qweight", device="cpu").data()
    block.scale = Constant(onp.float32([0.5, 2.0]), device="cpu").data()
    p = block.collect_params()
    assert p["qweight"].grad_req == "null" and p["qweight"].initialized
    assert p["qweight"].dtype == torch.int8
    assert not block.qweight.requires_grad
    block.initialize()
    block.initialize(force_reinit=True)
    onp.testing.assert_array_equal(block.qweight.numpy(), value)
    with pytest.raises(MXNetError, match="not trainable"):
        p["qweight"].grad_req = "write"
    arrays = tfunctional.param_arrays(block)
    assert arrays["qweight"].dtype == onp.int8
    arrays["qweight"] = -arrays["qweight"]
    tfunctional.load_params(block, arrays)
    assert block.qweight.dtype == torch.int8
    onp.testing.assert_array_equal(block.qweight.numpy(), -value)
    c = copy.deepcopy(block).collect_params()
    assert type(c["qweight"]) is Constant
    assert torch.equal(c["qweight"].data(), block.qweight)


# -- 6. the int8 conv half: quantized_conv(_fused), QuantizedConv ------------

CONV_CASES = {  # (x shape, O, conv kwargs)
    "3x3_pad": ((2, 3, 8, 8), 4, dict(kernel=(3, 3), pad=(1, 1))),
    "1x1_stride": ((2, 6, 9, 7), 5, dict(kernel=(1, 1), stride=(2, 2))),
    "grouped_dilated": ((1, 4, 10, 10), 6, dict(kernel=(3, 3), dilate=(2, 2),
                                                num_group=2)),
    "wide_3x3": ((2, 512, 4, 4), 8, dict(kernel=(3, 3), pad=(1, 1))),
}


def _conv_inputs(case, seed=1):
    shape, o, kw = CONV_CASES[case]
    x = _rand(*shape, seed=seed)
    w = _rand(o, shape[1] // kw.get("num_group", 1), *kw["kernel"],
              seed=seed + 1, scale=0.3)
    qw, ws = jq._quantize_weight(w)
    return x, qw, ws, _rand(o, seed=seed + 2), dict(kw, num_filter=o)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_conv_matches_jax(case, bias):
    """Oracle: tests/test_quantization.py:56. The int8 sums are exact in
    both packages (the 512-channel 3x3 case sums 4608 products, past
    fp32's 2^24), so without bias the outputs agree bit for bit."""
    x, qw, ws, b, kw = _conv_inputs(case)
    T = float(onp.abs(x).max())
    jx, _, _ = mx.npx.quantize_v2(mx.np.array(x), -T, T)
    want = mx.npx.quantized_conv(
        jx, mx.np.array(qw), T / 127, mx.np.array(ws),
        bias=mx.np.array(b) if bias else None, **kw).asnumpy()
    tx, _, _ = tmx.npx.quantize_v2(torch.from_numpy(x), -T, T)
    got = tmx.npx.quantized_conv(
        tx, torch.from_numpy(qw), T / 127, torch.from_numpy(ws),
        bias=torch.from_numpy(b) if bias else None, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if bias:
        onp.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        onp.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("act", [None] + ACTS)
def test_quantized_conv_fused_matches_jax(case, act):
    """Oracle: tests/test_quantization.py:388: the fused op against the JAX
    one and against the port's own quantize -> quantized_conv chain."""
    x, qw, ws, b, kw = _conv_inputs(case, seed=4)
    x[0, 0, 0, :3] = [onp.nan, onp.inf, -onp.inf]
    xs = onp.float32(onp.nanmax(onp.abs(x[onp.isfinite(x)])) / 127.0)
    want = mx.npx.quantized_conv_fused(
        mx.np.array(x), mx.np.array(qw), float(xs), mx.np.array(ws),
        bias=mx.np.array(b), act=act, **kw).asnumpy()
    got = tmx.npx.quantized_conv_fused(
        torch.from_numpy(x), torch.from_numpy(qw), float(xs),
        torch.from_numpy(ws), bias=torch.from_numpy(b), act=act, **kw)
    onp.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    xq = tqm.quantize_int8(torch.from_numpy(x), float(xs))
    chain = tmx.npx.quantized_conv(xq, torch.from_numpy(qw), float(xs),
                                   torch.from_numpy(ws), **kw)
    chain = chain + torch.from_numpy(b).reshape(1, -1, 1, 1)
    if act is not None:
        chain = tmx.npx.activation(chain, act)
    onp.testing.assert_array_equal(got.numpy(), chain.numpy())
    with pytest.raises(ValueError, match="cannot be fused"):
        tmx.npx.quantized_conv_fused(
            torch.from_numpy(x), torch.from_numpy(qw), float(xs),
            torch.from_numpy(ws), act="softrelu", **kw)


def _qnet_arrays_match(jqnet, tqnet):
    jarr = {n: onp.asarray(v) for n, v in
            jfunctional.param_arrays(jqnet).items()}
    tarr = tfunctional.param_arrays(tqnet)
    assert sorted(tarr) == sorted(jarr)
    for name, v in jarr.items():
        assert tarr[name].dtype == v.dtype, name
        onp.testing.assert_array_equal(tarr[name], v, err_msg=name)
    return jarr


def test_quantize_net_convnet_matches_jax():
    """Oracle: tests/test_quantization.py:110 (a conv net with an excluded
    layer), across the packages."""
    mx.random.seed(0)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Conv2D(8, kernel_size=3, padding=1, activation="relu"),
             jnn.MaxPool2D(2, 2), jnn.Flatten(),
             jnn.Dense(16, activation="relu"), jnn.Dense(10))
    jnet.initialize()
    calib = [_rand(4, 3, 8, 8, seed=i) for i in range(3)]
    jnet(mx.np.array(calib[0]))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Conv2D(8, kernel_size=3, padding=1, activation="relu",
                        device="cpu"),
             tnn.MaxPool2D(2, 2), tnn.Flatten(),
             tnn.Dense(16, activation="relu", device="cpu"),
             tnn.Dense(10, device="cpu"))
    tnet.initialize()
    tnet(torch.from_numpy(calib[0]))
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    jqnet = jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib],
                            calib_mode="naive", exclude_layers=["4"])
    tqnet = tq.quantize_net(tnet, calib_data=_t(*calib), calib_mode="naive",
                            exclude_layers=["4"])
    assert isinstance(tqnet[0], tq.QuantizedConv)
    assert tqnet[0]._fused_act == "relu"
    assert isinstance(tqnet[3], tq.QuantizedDense)
    assert isinstance(tqnet[4], tnn.Dense)
    assert isinstance(tnet[0], tnn.Conv2D)
    for i in (0, 3):
        onp.testing.assert_allclose(tqnet[i].threshold, jqnet[i].threshold,
                                    rtol=1e-6, atol=0)
    _qnet_arrays_match(jqnet, tqnet)
    x = _rand(4, 3, 8, 8, seed=7)
    fp32 = tnet(torch.from_numpy(x)).numpy()
    got = tqnet(torch.from_numpy(x)).numpy()
    rel = onp.abs(got - fp32).max() / (onp.abs(fp32).max() + 1e-9)
    assert rel < 0.15, rel
    for i in (0, 3):
        tqnet[i].threshold = jqnet[i].threshold
    onp.testing.assert_allclose(tqnet(torch.from_numpy(x)).numpy(),
                                jqnet(mx.np.array(x)).asnumpy(), rtol=0,
                                atol=1e-5)


def test_quantize_net_small_resnet_matches_jax():
    """A small ResNetV1 (BottleneckV1, layers [1, 1, 1, 1]): every forward
    conv becomes a QuantizedConv and the Dense a QuantizedDense, with the
    JAX package's thresholds (1e-6 relative), int8 weights and scales (bit
    for bit); with the JAX thresholds carried in, the outputs within 1e-4
    (fp32 BatchNorm and pooling between the int8 layers differ by ulps, and
    an ulp can move a value across an int8 rounding boundary)."""
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
    args = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
    mx.random.seed(1)
    jnet = jres.ResNetV1(jres.BottleneckV1, *args, classes=10,
                         thumbnail=True)
    jnet.initialize()
    calib = [_rand(4, 3, 16, 16, seed=i, scale=0.5) for i in range(2)]
    jnet(mx.np.array(calib[0]))
    tnet = tres.ResNetV1(tres.BottleneckV1, *args, classes=10,
                         thumbnail=True, device="cpu")
    tnet.initialize()
    tnet(torch.from_numpy(calib[0]))
    tfunctional.load_params(tnet, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jnet).items()})
    jqnet = jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib])
    tqnet = tq.quantize_net(tnet, calib_data=_t(*calib))
    jl = {p: l for _, _, p, l in jq._walk_layers(jqnet)
          if isinstance(l, (jq.QuantizedDense, jq.QuantizedConv))}
    tl = {p: l for _, _, p, l in tq._walk_layers(tqnet)
          if isinstance(l, (tq.QuantizedDense, tq.QuantizedConv))}
    assert sorted(tl) == sorted(jl)
    # the stem, 4 x (1x1, 3x3, 1x1) and 4 downsample convs
    assert sum(isinstance(v, tq.QuantizedConv) for v in tl.values()) == 17
    assert isinstance(tl["output"], tq.QuantizedDense)
    assert not any(isinstance(m, tnn.Conv2D) for m in tqnet.modules())
    for p in jl:
        onp.testing.assert_allclose(tl[p].threshold, jl[p].threshold,
                                    rtol=1e-6, atol=0, err_msg=p)
    _qnet_arrays_match(jqnet, tqnet)
    for p in jl:
        tl[p].threshold = jl[p].threshold
    x = _rand(4, 3, 16, 16, seed=9, scale=0.5)
    onp.testing.assert_allclose(tqnet(torch.from_numpy(x)).numpy(),
                                jqnet(mx.np.array(x)).asnumpy(), rtol=0,
                                atol=1e-4)
