"""Port parity: the flash-attention backward and the autograd Function.

The port's plain backward (what the CUDA wrappers take for CPU tensors) is
held against the JAX package's Pallas backward, ``_flash_bwd`` run through
``jax.vjp`` of ``_flash(..., interpret=True)`` with 16-row tiles (so
several tiles and ragged last tiles) and a random cotangent (not
``grad(sum(out))``). The port's ``FlashAttentionFunction``, public
``flash_attention`` and ``multi_head_attention`` gradients are held
against the JAX package's. Inputs are drawn with numpy from a seed and
handed to both. Tolerance: float32, atol 2e-5 (same math, different
summation order; the gradients are O(1)); bfloat16 as stated at its test.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops.pallas import flash_attention as jflash
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

ATOL = 2e-5


def _arrays(bh, sq, sk, d, seed=0):
    """q, k, v and a random cotangent do, float32."""
    rs = onp.random.RandomState(seed)
    return (rs.randn(bh, sq, d).astype("float32"),
            rs.randn(bh, sk, d).astype("float32"),
            rs.randn(bh, sk, d).astype("float32"),
            rs.randn(bh, sq, d).astype("float32"))


def _jax_grads(q, k, v, do, causal):
    scale = 1.0 / (q.shape[-1] ** 0.5)

    def f(q, k, v):
        return jflash._flash(q, k, v, causal, scale, 16, 16, 16, 16, True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [onp.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_plain_grads(q, k, v, do, causal):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    return [g.numpy() for g in tflash.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal)]


def _assert_grads(got, ref):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, name
        onp.testing.assert_allclose(g, r, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [8, 37, 64])
@pytest.mark.parametrize("bh", [2, 4])
def test_plain_bwd_matches_pallas_kernel(bh, s, d, causal):
    q, k, v, do = _arrays(bh, s, s, d, seed=bh * 100 + s + d)
    _assert_grads(_port_plain_grads(q, k, v, do, causal),
                  _jax_grads(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(8, 37), (37, 64), (64, 8)])
def test_plain_bwd_unequal_lengths(sq, sk, causal):
    q, k, v, do = _arrays(2, sq, sk, 16, seed=sq * sk)
    _assert_grads(_port_plain_grads(q, k, v, do, causal),
                  _jax_grads(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_pallas_vjp(causal):
    q, k, v, do = _arrays(3, 37, 37, 32, seed=11)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tflash.attention(*ts, causal=causal)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    _assert_grads([t.grad.numpy() for t in ts],
                  _jax_grads(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_public_flash_attention_gradients_match(causal):
    rs = onp.random.RandomState(21)
    q, k, v, do = (rs.randn(2, 2, 37, 16).astype("float32")
                   for _ in range(4))

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [onp.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tflash.flash_attention(*ts, causal=causal).backward(
        torch.from_numpy(do))
    _assert_grads([t.grad.numpy() for t in ts], ref)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_gradients_match_jax(causal):
    rs = onp.random.RandomState(5)
    q, k, v, do = (rs.randn(2, 21, 4 * 16).astype("float32")
                   for _ in range(4))
    jx = [mx.np.array(a) for a in (q, k, v)]
    for a in jx:
        a.attach_grad()
    with mx.autograd.record():
        out = jattn.multi_head_attention(*jx, 4, causal=causal)
    out.backward(mx.np.array(do))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    with tautograd.record():
        tout = tattn.multi_head_attention(*ts, 4, causal=causal)
    tautograd.backward(tout, torch.from_numpy(do))
    onp.testing.assert_allclose(tout.detach().numpy(), out.asnumpy(),
                                atol=ATOL, rtol=0)
    _assert_grads([t.grad.numpy() for t in ts],
                  [a.grad.asnumpy() for a in jx])


def test_cpu_bwd_wrapper_takes_plain_version_without_counting():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, 37, 37, 16))
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    before = (tflash.flash_attention_bwd_dkv.launches,
              tflash.flash_attention_bwd_dq.launches)
    got = tflash.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    ref = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    delta = (do * out).sum(-1, keepdim=True)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    dq = tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    for g, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)
    assert (tflash.flash_attention_bwd_dkv.launches,
            tflash.flash_attention_bwd_dq.launches) == before


def _f32(a):
    """A JAX array (bf16 or fp32) as a float32 torch tensor, exactly."""
    return torch.from_numpy(onp.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 8, 8, 16), (2, 37, 37, 64), (2, 64, 64, 16), (4, 64, 64, 64),
    (4, 37, 37, 16), (2, 8, 37, 16), (2, 37, 64, 16), (2, 64, 8, 16)])
def test_bf16_plain_bwd_matches_pallas_kernel(bh, sq, sk, d, causal):
    """bf16 backward parity with the reference's roundings (p to bf16
    before dV, ds to bf16 before dK and dQ). The JAX forward's residuals
    (out, lse) go to both backwards, so the gap is the backward's alone.

    Tolerance, elementwise: 2^-7 |ref| (one bf16 ulp of the output) plus
    2^-12 max|ref| (a p or ds value that rounds the other way, summed into
    a small output). Measured worst gap over these cases: 1.2e-4 with
    max|dv| 1.2. Dropping either rounding breaks it in every case."""
    scale = 1.0 / (d ** 0.5)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in _arrays(bh, sq, sk, d, seed=bh * sq + sk + d))

    def f(q, k, v):
        return jflash._flash(q, k, v, causal, scale, 16, 16, 16, 16, True)

    _, vjp = jax.vjp(f, jq, jk, jv)
    ref = vjp(jdo)
    out, lse = jflash._fwd(jq, jk, jv, causal, scale, 16, 16, True)
    tq, tk, tv, tdo, tout = (_f32(a).bfloat16()
                             for a in (jq, jk, jv, jdo, out))
    got = tflash.flash_attention_bwd_reference(tq, tk, tv, tout, _f32(lse),
                                               tdo, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        r = _f32(r).numpy()
        onp.testing.assert_allclose(
            g.float().numpy(), r, rtol=2.0 ** -7,
            atol=2.0 ** -12 * onp.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse_dtype",
                                 "lse_shape", "contiguity", "out_shape"])
def test_bwd_wrapper_rejects_bad_input(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, 8, 8, 16))
    out, lse = tflash.flash_attention_fwd(q, k, v)
    if bad == "do_shape":
        do = do[:, :4]
    elif bad == "do_dtype":
        do = do.double()
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_shape":
        lse = lse[:, :, 0]
    elif bad == "contiguity":
        do = do.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        out = out[:, :4]
    with pytest.raises(MXNetError):
        tflash.flash_attention_bwd(q, k, v, out, lse, do)


def test_attention_dropout_follows_is_training():
    """Attention dropout is live only while autograd.is_training(): outside
    record() and under record(train_mode=False) the rate is ignored and
    the kernel path is taken; under record() the composition drops."""
    rs = onp.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(2, 16, 32).astype("float32"))
               for _ in range(3))
    plain = tattn.multi_head_attention(q, k, v, 2, causal=True)
    gen = torch.Generator().manual_seed(0)
    idle = tattn.multi_head_attention(q, k, v, 2, dropout_p=0.5,
                                      causal=True, generator=gen)
    with tautograd.record(train_mode=False):
        paused = tattn.multi_head_attention(q, k, v, 2, dropout_p=0.5,
                                            causal=True, generator=gen)
    with tautograd.record():
        live = tattn.multi_head_attention(q, k, v, 2, dropout_p=0.5,
                                          causal=True, generator=gen)
    assert torch.equal(idle, plain) and torch.equal(paused, plain)
    assert not torch.allclose(live, plain, atol=1e-3)
    with tautograd.record(), pytest.raises(MXNetError):
        tattn.multi_head_attention(q, k, v, 2, dropout_p=0.5)
