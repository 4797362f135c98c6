"""Port parity: fp8 training and the fp8 fused matmul, JAX package ->
PyTorch port.

Inputs are made with numpy from a seed and go through both packages:

1. the port's plain ``fp8_matmul`` against the JAX package's Pallas
   kernel in interpret mode (``fp8_matmul(..., interpret=True)``), both
   formats, every activation, with and without bias, ragged M/N/K, and
   inputs past the format's top (NaN in e4m3fn, inf in e5m2, where JAX
   puts them): fp32 sums of exact fp8 products in another order, so
   rtol 1e-5 plus atol 1e-5 of the output's largest |value|;
2. the cast rule alone, bit for bit, on a sweep around 448, 464, 57344,
   61440 and the subnormals;
3. ``npx.fp8_dense_fused`` on the "off" and "auto" routes (both plain on
   the CPU), flatten True and False, at the tolerance of 1, and the
   reference's error for an unknown format; a tensor off the CPU goes to
   the kernel wrapper (which raises where the kernel cannot run), never to
   the plain product, there and in ``fp8_linear``;
4. the ``amp.fp8`` state functions, exactly (fp32 scalar arithmetic);
5. ``fp8_linear``'s value and its gradients against ``jax.vjp`` with
   non-identity scales: the snapped operands bit for bit, the value, dx and
   dw at rtol 1e-5 plus atol 1e-6 of the largest |value| (fp32 sums of
   exact products in another order), db at 1e-5, the x/w scale gradients 0
   and the g_scale gradient equal to max |dy|;
6. ``ShardedTrainStep(precision="fp8")`` over 3 Adam steps of a small GPT
   (2 layers, 64 units, 4 heads, vocab 101, seq 32, batch 4, dropout 0),
   from zero histories and from histories copied in: losses, parameters
   and every site's histories. An fp32 difference in the last bit upstream
   (LayerNorm and Adam round differently in the two packages, so the amax
   histories and with them the scales differ by an ulp from step 2 on) can
   move a value across an fp8 rounding boundary, which changes it by a
   whole fp8 step (1/16 relative in e4m3). So: losses rtol 1e-4;
   parameters atol 1e-6 after the first step from zero histories (identity
   scales, no flip yet); after the third, 99% of each parameter's
   elements within 5e-4 and all within 3e-3 (Adam's steps are ~lr = 1e-3
   whatever the size of the gradient, so a flip that turns the sign of a
   small gradient element moves its weight by up to 2 lr a step);
   histories rtol 1e-3 for the amaxes of steps 1-2 and 5% for the third
   step's, which reads the weights the flips moved; and, with the loss
   scaled by 1e-4, the flush of step 1's dy below e5m2's smallest value
   (the same sites with a zero g amax, the same unmoved weights);
7. the fp32 step: losses atol 1e-5, parameters atol 1e-5;
8. the fp8 loss curve against fp32 (within 5% over 4 steps, as the
   reference's test); and the step's rejections.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.amp import fp8 as jfp8
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.ops.pallas import quant_matmul as jqm
from mxnet_tpu.ops.xent import sparse_softmax_xent as jxent
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.train import ShardedTrainStep as JStep
from jax.sharding import PartitionSpec as JP

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.amp import fp8 as tfp8
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import quant_matmul as tqm
from mxnet_tpu_torch.ops.xent import sparse_softmax_xent as txent
from mxnet_tpu_torch.parallel import MeshConfig, P, ShardedTrainStep
from mxnet_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
ACTS = [None, "relu", "sigmoid", "tanh", "gelu"]
SHAPES = [(1, 5, 100), (37, 130, 256), (130, 5, 100)]  # (M, N, K)


def _fp8_np(a, fmt):
    """A numpy float32 array cast to fp8 by JAX, as (jax array, port
    tensor of the same bits)."""
    dt, _ = jqm.FP8_FORMATS[fmt]
    j = jnp.asarray(a).astype(dt)
    bits = onp.asarray(j).view(onp.uint8)
    return j, torch.from_numpy(bits.copy()).view(tqm.FP8_FORMATS[fmt][0])


def _bits(t):
    return t.view(torch.uint8).numpy()


def _matmul_inputs(m, n, k, fmt, seed, overflow=False):
    rs = onp.random.RandomState(seed)
    _, absmax = jqm.FP8_FORMATS[fmt]
    x = rs.randn(m, k).astype("float32")
    w = (rs.randn(n, k) * 0.5).astype("float32")
    ws = (onp.abs(w).max(axis=1) / absmax).astype("float32")
    w_j, w_t = _fp8_np(w / ws[:, None], fmt)
    xs = onp.float32(onp.abs(x).max() / absmax)
    if overflow:  # past the top after x / xs: NaN (e4m3) or inf (e5m2)
        x[0, 3] = 2.5 * absmax * xs
        x[-1, 0] = -70000.0 * xs
    b = rs.randn(n).astype("float32")
    return x, w_j, w_t, ws, xs, b


def _close(got, want, rtol=1e-5, share=1e-5):
    fin = onp.isfinite(want)
    top = onp.abs(want[fin]).max() if fin.any() else 0.0
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=share * top,
                                equal_nan=True)


# -- 1. plain fp8_matmul vs the JAX kernel (interpret mode) ------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plain_matmul_matches_jax_kernel(m, n, k, fmt, act, bias):
    x, w_j, w_t, ws, xs, b = _matmul_inputs(m, n, k, fmt, seed=m + n + k)
    want = onp.asarray(jqm.fp8_matmul(
        jnp.asarray(x), w_j, jnp.asarray(ws), xs,
        bias=jnp.asarray(b) if bias else None, act=act, fmt=fmt,
        interpret=True))
    got = tqm.fp8_matmul(torch.from_numpy(x), w_t, torch.from_numpy(ws),
                         float(xs), bias=torch.from_numpy(b) if bias else None,
                         act=act, fmt=fmt)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got.numpy(), want)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_plain_matmul_overflow_matches_jax_kernel(fmt, act):
    """Inputs past the format's top: NaN (e4m3fn) or inf (e5m2) where the
    JAX cast puts them, and the rows they reach."""
    x, w_j, w_t, ws, xs, b = _matmul_inputs(37, 130, 256, fmt, seed=3,
                                            overflow=True)
    want = onp.asarray(jqm.fp8_matmul(
        jnp.asarray(x), w_j, jnp.asarray(ws), xs, bias=jnp.asarray(b),
        act=act, fmt=fmt, interpret=True))
    assert not onp.isfinite(want).all()
    got = tqm.fp8_matmul(torch.from_numpy(x), w_t, torch.from_numpy(ws),
                         float(xs), bias=torch.from_numpy(b), act=act,
                         fmt=fmt).numpy()
    onp.testing.assert_array_equal(onp.isnan(got), onp.isnan(want))
    onp.testing.assert_array_equal(onp.isinf(got), onp.isinf(want))
    _close(got, want)


def test_matmul_validates_like_the_reference():
    x, _, w_t, ws, xs, _ = _matmul_inputs(4, 5, 16, "e4m3", seed=0)
    args = (torch.from_numpy(x), w_t, torch.from_numpy(ws), float(xs))
    with pytest.raises(ValueError, match="unknown fp8 format"):
        tqm.fp8_matmul(*args, fmt="e3m4")
    with pytest.raises(ValueError, match="unsupported fused activation"):
        tqm.fp8_matmul(*args, act="softrelu")
    assert not tqm.fp8_capable(CPU)
    with pytest.raises(MXNetError, match="float8"):
        tqm.fp8_matmul(args[0], w_t.float(), *args[2:])


# -- 2. the cast rule ----------------------------------------------------------

def _sweep():
    v = [0.0, -0.0, 1.0, -1.0, float("inf"), -float("inf"), float("nan")]
    v += list(onp.arange(440.0, 480.0, 0.5)) + [463.99, 464.0, 464.01]
    v += list(onp.arange(56000.0, 63000.0, 64.0)) + [61439.9, 61440.0,
                                                    61440.1, 7e4]
    for e in range(-20, -5):  # subnormals of both formats and their ties
        v += [2.0 ** e * f for f in (0.5, 0.75, 1.0, 1.25, 1.5, 2.5)]
    v = onp.asarray(v, dtype="float32")
    return onp.concatenate([v, -v])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_cast_rule_matches_jax_bit_for_bit(fmt):
    v = _sweep()
    want = jnp.asarray(v).astype(jqm.FP8_FORMATS[fmt][0])
    got = tqm.quantize(torch.from_numpy(v), fmt)
    assert got.dtype == tqm.FP8_FORMATS[fmt][0]
    want_f = onp.asarray(want.astype(jnp.float32))
    got_f = got.float().numpy()
    onp.testing.assert_array_equal(onp.isnan(got_f), onp.isnan(want_f))
    fin = ~onp.isnan(want_f)
    onp.testing.assert_array_equal(_bits(got)[fin],
                                   onp.asarray(want).view(onp.uint8)[fin])
    if fmt == "e4m3":
        assert onp.isnan(got_f[v == 465.0]).all()
        assert (got_f[v == 463.0] == 448.0).all()
    else:
        assert onp.isinf(got_f[v == 7e4]).all()


# -- 3. npx.fp8_dense_fused ------------------------------------------------------

@pytest.fixture(params=["off", "auto"])
def route(request):
    old = mx.config.get("quantize.fused_matmul")
    mx.config.set("quantize.fused_matmul", request.param)
    tmx.config.set("quantize.fused_matmul", request.param)
    yield request.param
    mx.config.set("quantize.fused_matmul", old)
    tmx.config.reset("quantize.fused_matmul")


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("fmt,act", [("e4m3", None), ("e5m2", "gelu"),
                                     ("e4m3", "relu")])
def test_fp8_dense_fused_matches_jax(route, flatten, fmt, act):
    rs = onp.random.RandomState(5)
    data = rs.randn(3, 4, 24).astype("float32")
    k = 96 if flatten else 24
    _, w_j, w_t, ws, xs, b = _matmul_inputs(12, 10, k, fmt, seed=6)
    want = mx.npx.fp8_dense_fused(
        mx.np.array(data), mx.np.array(w_j), float(xs), mx.np.array(ws),
        bias=mx.np.array(b), act=act, flatten=flatten, fmt=fmt).asnumpy()
    got = tmx.npx.fp8_dense_fused(
        torch.from_numpy(data), w_t, float(xs), torch.from_numpy(ws),
        bias=torch.from_numpy(b), act=act, flatten=flatten, fmt=fmt)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)


def test_fp8_dense_fused_errors():
    x = torch.zeros(2, 16)
    _, _, w_t, ws, xs, _ = _matmul_inputs(2, 4, 16, "e4m3", seed=0)
    with pytest.raises(ValueError):
        tmx.npx.fp8_dense_fused(x, w_t, float(xs), torch.from_numpy(ws),
                                fmt="e3m4")
    with pytest.raises(ValueError):
        tmx.npx.fp8_dense_fused(x, w_t, float(xs), torch.from_numpy(ws),
                                act="softrelu")
    tmx.config.set("quantize.fused_matmul", "on")
    try:
        with pytest.raises(MXNetError, match="CUDA tensor"):
            tmx.npx.fp8_dense_fused(x, w_t, float(xs), torch.from_numpy(ws))
    finally:
        tmx.config.reset("quantize.fused_matmul")


def test_only_cpu_tensors_take_the_plain_product():
    """fp8_linear and npx.fp8_dense_fused on "auto" send every tensor off
    the CPU to the kernel wrapper, which raises where the kernel cannot
    run (a meta tensor here; a card of another compute capability in the
    card tests) instead of falling back to the plain product."""
    meta = torch.device("meta")
    x = torch.empty(4, 32, device=meta)
    one = torch.ones((), device=meta)
    with pytest.raises(MXNetError, match="unsupported device"):
        tfp8.fp8_linear(x, torch.empty(24, 32, device=meta), None, one, one,
                        one)
    wq = torch.empty(24, 32, dtype=torch.float8_e4m3fn, device=meta)
    with pytest.raises(MXNetError, match="unsupported device"):
        tmx.npx.fp8_dense_fused(x, wq, 0.5, torch.ones(24, device=meta))


# -- 4. amp.fp8 state functions --------------------------------------------------

def test_select_sites_matches_jax():
    shapes = {"dense0.weight": (32, 16), "dense0.bias": (32,),
              "tiny.weight": (8, 8), "emb.weight": (4, 8, 8),
              "weight": (16, 16), "gamma": (64, 64)}
    assert tfp8.select_sites(shapes) == jfp8.select_sites(shapes) == [
        "dense0.weight", "weight"]


def test_state_functions_match_jax():
    zero = tfp8.init_state(["s", "t"], history=3, device="cpu")
    for xs, ws, gs in tfp8.scales_from_state(zero).values():
        assert float(xs) == float(ws) == float(gs) == 1.0
    rs = onp.random.RandomState(2)
    obs = [rs.rand(5).astype("float32") * 10 for _ in range(3)]
    jstate, tstate = jfp8.init_state(["s", "t"], 3), zero
    for o in obs:  # "t" is not reached on the forward
        jstate = jfp8.roll_state(
            jstate, {"s": (jnp.float32(o[0]), jnp.float32(o[1]))},
            {"s": jnp.float32(o[2]), "t": jnp.float32(o[3])})
        tstate = tfp8.roll_state(
            tstate, {"s": (torch.tensor(o[0]), torch.tensor(o[1]))},
            {"s": torch.tensor(o[2]), "t": torch.tensor(o[3])})
    for s in ("s", "t"):
        for k in ("x", "w", "g"):
            onp.testing.assert_array_equal(tstate[s][k].numpy(),
                                           onp.asarray(jstate[s][k]))
    for margin in (1.0, 1.5):
        js = jfp8.scales_from_state(jstate, margin)
        ts = tfp8.scales_from_state(tstate, margin)
        for s in js:
            onp.testing.assert_array_equal(
                [float(v) for v in ts[s]], [float(v) for v in js[s]])
    a = {"s": (jnp.float32(1.0), jnp.float32(3.0))}
    b = {"s": (jnp.float32(2.0), jnp.float32(0.5)), "t": (jnp.float32(9.0),)}
    ta = {k: tuple(torch.tensor(float(u)) for u in v) for k, v in a.items()}
    tb = {k: tuple(torch.tensor(float(u)) for u in v) for k, v in b.items()}
    jm, tm = jfp8.merge_amax(a, b), tfp8.merge_amax(ta, tb)
    assert {k: [float(u) for u in v] for k, v in tm.items()} == {
        k: [float(u) for u in v] for k, v in jm.items()}


# -- 5. fp8_linear and its gradients -----------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_fp8_linear_matches_jax_vjp(bias):
    rs = onp.random.RandomState(0)
    x = rs.randn(3, 5, 32).astype("float32")
    w = (rs.randn(24, 32) * 0.1).astype("float32")
    b = rs.randn(24).astype("float32") if bias else None
    dy = (rs.randn(3, 5, 24) * 1e-3).astype("float32")
    xs, ws, gs = (onp.float32(v) for v in (448 / 3.1, 448 / 0.37, 57344 / 4e-3))
    jb = jnp.asarray(b) if bias else None
    y, vjp = jax.vjp(jfp8.fp8_linear, jnp.asarray(x), jnp.asarray(w), jb,
                     jnp.float32(xs), jnp.float32(ws), jnp.float32(gs))
    jgrads = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (x, w) + ((b,) if bias else ())]
    scales = [torch.tensor(v).requires_grad_() for v in (xs, ws, gs)]
    tb = leaves[2] if bias else None
    out = tfp8.fp8_linear(leaves[0], leaves[1], tb, *scales)
    out.backward(torch.from_numpy(dy))
    for src, scale in ((x, xs), (w, ws)):  # the snapped operands
        onp.testing.assert_array_equal(
            _bits(tfp8._qcast(torch.from_numpy(src), torch.tensor(scale),
                              "e4m3")),
            onp.asarray(jfp8._qcast(jnp.asarray(src), jnp.float32(scale),
                                    "e4m3")).view(onp.uint8))
    _close(out.detach().numpy(), onp.asarray(y), share=1e-6)
    _close(leaves[0].grad.numpy(), onp.asarray(jgrads[0]), share=1e-6)
    _close(leaves[1].grad.numpy(), onp.asarray(jgrads[1]), share=1e-6)
    if bias:
        _close(leaves[2].grad.numpy(), onp.asarray(jgrads[2]))
    assert float(scales[0].grad) == float(jgrads[3]) == 0.0
    assert float(scales[1].grad) == float(jgrads[4]) == 0.0
    assert float(scales[2].grad) == float(jgrads[5]) == float(
        onp.abs(dy).max())


# -- 6-8. the training step ----------------------------------------------------

CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
BATCH = 4
DENSE = [f"backbone.decoder.layer{i}.{blk}.weight" for i in range(2)
         for blk in ("attention.query_proj", "attention.key_proj",
                     "attention.value_proj", "attention.out_proj",
                     "ffn.ffn_1", "ffn.ffn_2")]
EMBED = ["backbone.position_embed.weight", "backbone.word_embed.weight"]


def _batch(seed=0):
    ids = onp.random.RandomState(seed).randint(0, 101, (BATCH, 33))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _jloss(logits, labels):
    return jnp.mean(jxent(logits, labels))


def _tloss(logits, labels):
    return txent(logits, labels).mean()


def _nets(seed=0):
    """(JAX GPT, port GPT on the CPU with the same weights); the key
    projection's bias (a zero gradient in exact arithmetic, which Adam
    turns into +-lr steps of float noise) frozen in both."""
    mx.random.seed(seed)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    for params in (jnet.collect_params(), tnet.collect_params()):
        for name, p in params.items():
            if "key_proj.bias" in name:
                p.grad_req = "null"
    return jnet, tnet


def _scaled(loss, scale):
    return loss if scale == 1.0 else (lambda out, y: loss(out, y) * scale)


def _steps(precision, seed=0, history=None, loss_scale=1.0):
    jnet, tnet = _nets(seed)
    jstep = JStep(jnet, _scaled(_jloss, loss_scale),
                  mx.optimizer.create("adam", learning_rate=1e-3),
                  jmake_mesh({"dp": 1}), (JP("dp", None), JP("dp", None)),
                  precision=precision)
    tstep = ShardedTrainStep(
        tnet, _scaled(_tloss, loss_scale),
        tmx.optimizer.create("adam", learning_rate=1e-3),
        make_mesh({"dp": 1}, devices=["cpu"]),
        MeshConfig(dp=1).batch_specs(2, 2), precision=precision)
    if history is not None:
        for site, h in history.items():
            for k, v in h.items():
                old = jstep.extra["fp8"][site][k]
                jstep.extra["fp8"][site][k] = jax.device_put(
                    jnp.asarray(v), old.sharding)
                tstep.extra["fp8"][site][k] = torch.from_numpy(v.copy())
    return jstep, tstep


def _history(seed=1):
    """Random positive histories for the Dense sites (slot 0 leads), zero
    for the embeddings, as a run would leave them."""
    rs = onp.random.RandomState(seed)
    out = {}
    for site in DENSE + EMBED:
        scale = {"x": 4.0, "w": 0.07, "g": 3e-3}
        out[site] = {k: (rs.uniform(0.5, 1.5, 16) * s).astype("float32")
                     if site in DENSE else onp.zeros(16, "float32")
                     for k, s in scale.items()}
    return out


def _params(step, port):
    if port:
        return {n: w.detach().numpy() for n, w in step.params.items()}
    return {n: onp.asarray(v) for n, v in step.trainable.items()}


@pytest.mark.parametrize("start", ["zero", "copied"])
def test_fp8_step_matches_jax(start):
    history = _history() if start == "copied" else None
    jstep, tstep = _steps("fp8", history=history)
    assert tstep._fp8_sites == jstep._fp8_sites == sorted(DENSE + EMBED)
    x, y = _batch(0)
    for i in range(3):
        lj = float(jstep(x, y).asnumpy())
        lt = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        onp.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {i}")
        if i == 0 and start == "zero":  # identity scales: no flip yet
            jp, tp = _params(jstep, False), _params(tstep, True)
            for name in jp:
                onp.testing.assert_allclose(tp[name], jp[name], atol=1e-6,
                                            rtol=0, err_msg=name)
    jp, tp = _params(jstep, False), _params(tstep, True)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        diff = onp.abs(tp[name] - jp[name])
        assert (diff > 5e-4).mean() < 0.01 and diff.max() <= 3e-3, (
            name, (diff > 5e-4).mean(), diff.max())
    for site in DENSE + EMBED:
        for k in ("x", "w", "g"):
            want = onp.asarray(jstep.extra["fp8"][site][k])
            got = tstep.extra["fp8"][site][k].numpy()
            # slot 0 is the third step's amax, measured after the flips
            onp.testing.assert_allclose(got[1:], want[1:], rtol=1e-3,
                                        atol=0, err_msg=f"{site} {k}")
            onp.testing.assert_allclose(got[0], want[0], rtol=0.05,
                                        err_msg=f"{site} {k}")
            if site in EMBED:
                assert not got.any(), f"{site} {k} left zero"
            elif start == "zero":
                assert (got[:3] > 0).all() and not got[3:].any()


def test_fp8_step_flushes_small_gradients_like_jax():
    """Step 1 from empty histories quantizes dy at the identity scale, and
    e5m2's smallest value is 2^-16. With the loss scaled by 1e-4 every dy
    lies below it: a site whose dy arrives only through another site's fp8
    backward product (query, key, value, ffn_1) sees all zeros, records a
    zero g amax and takes no step-1 update, in both packages alike. Step 2
    scales dy by step 1's amaxes, and no site is flushed. Parameters atol
    1e-6 after steps 1 and 2, as after the first step of
    test_fp8_step_matches_jax (measured 6e-8)."""
    jstep, tstep = _steps("fp8", loss_scale=1e-4)
    w0 = {n: w.copy() for n, w in _params(tstep, True).items()}
    x, y = _batch(0)
    flushed = [s for s in DENSE if s.split(".")[-2] in
               ("query_proj", "key_proj", "value_proj", "ffn_1")]
    for i in range(2):
        lj = float(jstep(x, y).asnumpy())
        lt = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        onp.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {i}")
        zero = {"jax": [s for s in DENSE if float(
                    onp.asarray(jstep.extra["fp8"][s]["g"])[0]) == 0.0],
                "port": [s for s in DENSE
                         if float(tstep.extra["fp8"][s]["g"][0]) == 0.0]}
        assert zero["port"] == zero["jax"] == (flushed if i == 0 else []), (
            i, zero)
        jp, tp = _params(jstep, False), _params(tstep, True)
        for name in jp:
            onp.testing.assert_allclose(tp[name], jp[name], atol=1e-6,
                                        rtol=0, err_msg=f"{name} step {i}")
        if i == 0:
            for site in flushed:
                onp.testing.assert_array_equal(tp[site], w0[site])
                onp.testing.assert_array_equal(jp[site], w0[site])


def test_fp32_step_matches_jax():
    jstep, tstep = _steps("fp32")
    x, y = _batch(1)
    for i in range(3):
        lj = float(jstep(x, y).asnumpy())
        lt = float(tstep(x, y))
        onp.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0,
                                    err_msg=f"step {i}")
    jp, tp = _params(jstep, False), _params(tstep, True)
    for name in jp:
        onp.testing.assert_allclose(tp[name], jp[name], atol=1e-5, rtol=0,
                                    err_msg=name)


def test_fp8_loss_curve_tracks_fp32():
    _, t32 = _steps("fp32", seed=3)
    _, t8 = _steps("fp8", seed=3)
    x, y = _batch(2)
    for _ in range(4):
        l32, l8 = float(t32(x, y)), float(t8(x, y))
        assert abs(l8 - l32) / abs(l32) < 0.05, (l8, l32)
    assert getattr(t8.block, "_fp8_trained", False)
    assert not getattr(t32.block, "_fp8_trained", False)


def test_site_lookup_survives_renaming():
    """collect_params() on a sub-block rewrites Parameter.name; the step
    keys its sites by tensor, so every Dense site still runs fp8."""
    _, tstep = _steps("fp8")
    x, y = _batch(0)
    tstep(x, y)
    names = tstep.block.backbone.decoder.collect_params()
    assert "layer0.ffn.ffn_1.weight" in names
    assert names["layer0.ffn.ffn_1.weight"].name == "layer0.ffn.ffn_1.weight"
    tstep(x, y)
    for site in DENSE:
        h = tstep.extra["fp8"][site]
        for k in ("x", "w", "g"):
            assert (h[k][:2] > 0).all(), (site, k)


def _tiny_step(**kw):
    net = tnn.Dense(32, in_units=16, device="cpu")
    net.initialize(seed=0)
    return ShardedTrainStep(
        net, lambda out, lab: (out.sum(-1) - lab).square().mean(), "sgd",
        kw.pop("mesh", MeshConfig(dp=1)), (P("dp"), P("dp")), **kw)


def test_step_rejections():
    with pytest.raises(MXNetError, match="multi-card"):
        MeshConfig(dp=2).build(["cpu"])
    with pytest.raises(MXNetError, match="multi-card"):
        make_mesh({"dp": 2, "tp": 1}, devices=["cpu"])
    with pytest.raises(MXNetError, match="multi-card"):
        _tiny_step(mesh=MeshConfig(dp=2))
    with pytest.raises(MXNetError, match="zero=1"):
        _tiny_step(zero=1)
    with pytest.raises(MXNetError, match="zero must be"):
        _tiny_step(zero=3)
    with pytest.raises(MXNetError, match="grad_accum=2"):
        _tiny_step(grad_accum=2)
    with pytest.raises(MXNetError, match="steps_per_call=2"):
        _tiny_step(steps_per_call=2)
    with pytest.raises(MXNetError, match="remat"):
        _tiny_step(remat=True)
    with pytest.raises(MXNetError, match="param_specs"):
        _tiny_step(param_specs={})
    with pytest.raises(MXNetError, match="precision"):
        _tiny_step(precision="bf16")
    with pytest.raises(MXNetError, match="grad_compress"):
        _tiny_step(grad_compress="fp4")
    assert _tiny_step(grad_compress="int8")._compress == "none"
    assert _tiny_step(precision="fp8")._fp8_sites == ["weight"]
    tmx.config.set("amp.fp8_min_elems", 1024)
    try:
        with pytest.raises(MXNetError, match="no eligible sites"):
            _tiny_step(precision="fp8")
    finally:
        tmx.config.reset("amp.fp8_min_elems")
    step = _tiny_step(precision="fp8")
    rs = onp.random.RandomState(0)
    loss = step(rs.randn(8, 16).astype("float32"),
                rs.randn(8).astype("float32"))
    assert loss.shape == () and torch.isfinite(loss)
