"""Port parity: low-bit serving, ``serve/quantize.py`` and the quantized
engines, JAX package -> PyTorch port.

The quantizers are held bit for bit against ``mxnet_tpu.serve.quantize``
on the same numpy weights: int8 values, packed int4 nibbles (even column in
the low nibble), fp32 scales, the metadata, the dequantized weights and
``quantized_bytes``, under the eligibility and group-size knobs. Then
engines over the reference tests' tiny GPT at the width their quantized
tests use (vocab 97, 64 units, FFN 128, 2 layers, 2 heads, buckets "4,8";
smaller weights fall under ``serve.quantize_min_elems``), weights carried
across with ``functional.load_params``: every quantize mode and their
combinations give the JAX engine's greedy tokens token for token, the same
byte accounting and an int8 cache with fp32 (slot, row, head) scales, and
the reference's refusals raise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.serve import quantize as jquant

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serve import quantize as tquant

torch.set_num_threads(2)

CFG = dict(vocab_size=97, units=64, hidden_size=128, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)
MODES = ["int8_weights", "int4_weights", "int8_kv", "int4_weights,int8_kv",
         "int8_weights,int8_kv"]


def _np(x):
    return onp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same_split(got, want):
    """Two (passthrough, quantized, meta) triples equal bit for bit."""
    (tp, tq, tm), (jp, jq, jm) = got, want
    assert list(tp) == list(jp) and list(tq) == list(jq) and tm == jm
    for name in jp:
        onp.testing.assert_array_equal(_np(tp[name]), _np(jp[name]))
    for name, (q, s) in jq.items():
        tqv, tsv = tq[name]
        assert _np(tqv).dtype == onp.asarray(q).dtype
        assert _np(tsv).dtype == onp.float32
        onp.testing.assert_array_equal(_np(tqv), onp.asarray(q))
        onp.testing.assert_array_equal(_np(tsv), onp.asarray(s))


def _params(seed):
    rs = onp.random.RandomState(seed)
    w = rs.randn(64, 256).astype("float32")
    w[3] = 0.0                                  # an all-zero row: scale 1
    w[5, :7] = [127.0, -63.5, 0.5, -0.5, 1.5, 2.5, -127.0]   # .5 ties
    return {"w": w,
            "odd": rs.randn(64, 129).astype("float32"),
            "narrow": rs.randn(128, 96).astype("float32"),
            "small": rs.randn(4, 4).astype("float32"),
            "vec": rs.randn(8192).astype("float32"),
            "big3d": rs.randn(4, 32, 64).astype("float32"),
            "ids": rs.randint(0, 9, (128, 128)).astype("int32")}


@pytest.fixture
def knob():
    """Set knobs in both packages for one test."""
    prev = []

    def setter(name, value):
        prev.append((name, mx.config.set(name, value),
                     tmx.config.set(name, value)))
    yield setter
    for name, jv, tv in reversed(prev):
        mx.config.set(name, jv)
        tmx.config.set(name, tv)


# -- quantizers ---------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    {}, {"min_elements": 1}, {"min_elements": 1, "ndim": 1},
    {"min_elements": 1, "ndim": 3}])
def test_quantize_int8_bit_for_bit(kwargs):
    params = _params(0)
    got = tquant.quantize_params_int8(
        {k: torch.from_numpy(v) for k, v in params.items()}, **kwargs)
    want = jquant.quantize_params_int8(params, **kwargs)
    _same_split(got, want)


@pytest.mark.parametrize("kwargs", [
    {}, {"min_elements": 1}, {"min_elements": 1, "group_size": 64},
    {"min_elements": 1, "group_size": 32}, {"min_elements": 1,
                                            "group_size": 0}])
def test_quantize_int4_bit_for_bit(kwargs):
    params = _params(1)
    got = tquant.quantize_params_int4(
        {k: torch.from_numpy(v) for k, v in params.items()}, **kwargs)
    want = jquant.quantize_params_int4(params, **kwargs)
    _same_split(got, want)
    for name, (packed, _) in got[1].items():
        assert packed.dtype == torch.uint8
        assert packed.shape[1] * 2 == params[name].shape[1]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dequantize_and_bytes_bit_for_bit(mode):
    params = _params(2)
    fn = {"int8": "quantize_params_int8", "int4": "quantize_params_int4"}[mode]
    tsplit = getattr(tquant, fn)(
        {k: torch.from_numpy(v) for k, v in params.items()}, min_elements=1)
    jsplit = getattr(jquant, fn)(params, min_elements=1)
    got = tquant.dequantize_params(*tsplit)
    want = jquant.dequantize_params(*jsplit)
    assert list(got) == list(want)
    for name in want:
        g, w = _np(got[name]), onp.asarray(want[name])
        assert g.dtype == w.dtype
        onp.testing.assert_array_equal(g, w)
    assert tquant.quantized_bytes(*tsplit) == jquant.quantized_bytes(*jsplit)


def test_unpack_int4_matches_jax():
    rs = onp.random.RandomState(3)
    packed = rs.randint(0, 256, (5, 8)).astype("uint8")
    onp.testing.assert_array_equal(
        tquant._unpack_int4(torch.from_numpy(packed), 16).numpy(),
        onp.asarray(jquant._unpack_int4(packed, 16)))


def test_quantize_knobs_match_jax(knob):
    """serve.quantize_min_elems / _ndim / _group_size read by both."""
    params = _params(4)
    knob("serve.quantize_min_elems", 512)
    knob("serve.quantize_ndim", 1)
    knob("serve.quantize_group_size", 64)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    _same_split(tquant.quantize_params_int8(tparams),
                jquant.quantize_params_int8(params))
    _same_split(tquant.quantize_params_int4(tparams),
                jquant.quantize_params_int4(params))
    for name, arr in params.items():
        assert tquant.eligible(name, torch.from_numpy(arr)) == bool(
            jquant.eligible(name, arr))


# -- engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """(JAX GPT, port GPT with its weights), shared: every JAX engine is an
    XLA compile."""
    mx.random.seed(15)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _work(seed=14, n=6):
    rs = onp.random.RandomState(seed)
    return [(rs.randint(1, 97, rs.randint(2, 9)).tolist(),
             int(rs.randint(3, 8))) for _ in range(n)]


def _run(eng, work):
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_matches_jax_engine(nets, mode):
    jnet, tnet = nets
    work = _work()
    jeng = mx.serve.load(jnet, max_slots=3, buckets="4,8", quantize=mode)
    teng = tmx.serve.load(tnet, max_slots=3, buckets="4,8", quantize=mode,
                          device="cpu", warmup=True)
    assert _run(teng, work) == _run(jeng, work)
    js, ts = jeng.stats(), teng.stats()
    for key in ("quantize", "cache_dtype", "weight_bytes", "weight_bytes_fp",
                "quantized_params", "passthrough_params", "completed",
                "tokens_out"):
        assert ts[key] == js[key], key
    assert ts["compiles"] == 3 and ts["post_warmup_compiles"] == 0
    if "weights" in mode:
        assert ts["quantized_params"] > 0
        assert ts["weight_bytes"] < (0.3 if "int8" in mode else 0.2) \
            * ts["weight_bytes_fp"]


def test_int8_kv_cache_arrays_are_int8(nets):
    _, tnet = nets
    eng = tmx.serve.load(tnet, max_slots=2, buckets="4,8",
                         quantize="int8_kv", device="cpu")
    assert eng.cache_dtype == "int8"
    for (kq, ks), (vq, vs) in eng._cache:
        assert kq.dtype == vq.dtype == torch.int8
        assert ks.dtype == vs.dtype == torch.float32
        assert tuple(ks.shape) == tuple(kq.shape[:3]) + (1,)


def test_cache_dtype_int8_without_quantize_matches_jax(nets):
    """``cache_dtype="int8"`` alone selects the int8 cache, as in the
    reference."""
    jnet, tnet = nets
    work = _work(seed=16, n=4)
    jeng = mx.serve.load(jnet, max_slots=2, buckets="4,8",
                         cache_dtype="int8")
    teng = tmx.serve.load(tnet, max_slots=2, buckets="4,8",
                          cache_dtype="int8", device="cpu")
    assert _run(teng, work) == _run(jeng, work)
    assert teng.stats()["cache_dtype"] == "int8"


@pytest.mark.parametrize("spec", ["int4", "int8_weights,int4_weights", ",",
                                  "int8_kv,fp8"])
def test_bad_quantize_modes_raise_like_jax(nets, spec):
    jnet, tnet = nets
    with pytest.raises(mx.MXNetError):
        mx.serve.load(jnet, max_slots=2, quantize=spec)
    with pytest.raises(MXNetError):
        tmx.serve.load(tnet, max_slots=2, quantize=spec, device="cpu")


@pytest.mark.parametrize("mode,allow,raises", [
    ("int4_weights", False, True), ("int4_weights", True, False),
    ("int4_weights,int8_kv", False, True), ("int8_weights", False, False),
    ("int8_kv", False, False)])
def test_int4_on_fp8_trained_refused_like_jax(nets, knob, mode, allow,
                                              raises):
    jnet, tnet = nets
    knob("serve.allow_fp8_requant", allow)
    jnet._fp8_trained = tnet._fp8_trained = True
    try:
        for load, net, err, kw in (
                (mx.serve.load, jnet, mx.MXNetError, {}),
                (tmx.serve.load, tnet, MXNetError, {"device": "cpu"})):
            if raises:
                with pytest.raises(err, match="fp8"):
                    load(net, max_slots=2, quantize=mode, **kw)
            else:
                load(net, max_slots=2, quantize=mode, **kw)
    finally:
        del jnet._fp8_trained, tnet._fp8_trained


@pytest.mark.parametrize("mode", ["int8_weights", "int4_weights,int8_kv"])
def test_quantized_weight_swap(nets, mode):
    """update_weights re-quantizes the new weights into the tensors the
    steps read (no new build), restore_weights brings the old ones back:
    each run's tokens equal a fresh engine's over the same weights. (The
    JAX engine's update_weights raises on a quantized engine: its
    signature check reads ``.shape`` of the (values, scales) pairs.)"""
    _, tnet = nets
    other = tgpt.GPTForCausalLM(device="cpu", **CFG).initialize(seed=3)
    work = _work(seed=17, n=5)

    def fresh(net):
        return _run(tmx.serve.load(net, max_slots=3, buckets="4,8",
                                   quantize=mode, device="cpu"), work)
    eng = tmx.serve.load(tnet, max_slots=3, buckets="4,8", quantize=mode,
                         device="cpu", warmup=True)
    base = _run(eng, work)
    eng.stop()
    old = eng.update_weights(tfunctional.param_arrays(other))
    eng.resume()
    assert _run(eng, work) == fresh(other)
    eng.restore_weights(old)
    assert _run(eng, work) == base == fresh(tnet)
    assert eng.compiles == 3 and eng.post_warmup_compiles == 0
    assert fresh(other) != base
