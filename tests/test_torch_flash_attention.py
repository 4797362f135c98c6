"""Port parity: flash-attention forward and attention dispatch.

The PyTorch port's plain flash-attention version (what the CUDA wrapper
takes for CPU tensors) is held against the JAX package's Pallas kernel run
in interpret mode, and the port's ``multi_head_attention`` against the JAX
package's. Inputs are drawn with numpy from a seed and handed to both.
Tolerance: atol 1e-5 in float32 (same math, different summation order).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops.pallas import flash_attention as jflash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

ATOL = 1e-5


def _qkv(bh, sq, sk, d, seed=0):
    rs = onp.random.RandomState(seed)
    return (rs.randn(bh, sq, d).astype("float32"),
            rs.randn(bh, sk, d).astype("float32"),
            rs.randn(bh, sk, d).astype("float32"))


def _jax_fwd(q, k, v, causal):
    d = q.shape[-1]
    # 16-row blocks: several tiles per sequence, ragged last tiles
    out, lse = jflash._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal, 1.0 / (d ** 0.5), 16, 16, True)
    return onp.asarray(out), onp.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [8, 37, 64])
@pytest.mark.parametrize("bh", [2, 4])
def test_plain_fwd_matches_pallas_kernel(bh, s, d, causal):
    q, k, v = _qkv(bh, s, s, d, seed=bh * 100 + s)
    ref_out, ref_lse = _jax_fwd(q, k, v, causal)
    out, lse = tflash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert tuple(lse.shape) == ref_lse.shape == (bh, s, 1)
    assert lse.dtype == torch.float32
    onp.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=0)
    onp.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(8, 37), (37, 64), (64, 8)])
def test_plain_fwd_unequal_lengths(sq, sk, causal):
    q, k, v = _qkv(2, sq, sk, 16, seed=sq + sk)
    ref_out, ref_lse = _jax_fwd(q, k, v, causal)
    out, lse = tflash.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    onp.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=0)
    onp.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_public_flash_attention_matches(d, causal):
    rs = onp.random.RandomState(d)
    q, k, v = (rs.randn(2, 2, 37, d).astype("float32") for _ in range(3))
    ref = onp.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    onp.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_cpu_wrapper_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 37, 37, 16))
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert tflash.flash_attention_fwd.launches == before


def test_bf16_plain_version_close_to_fp32():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 37, 37, 64))
    ref, _ = tflash.flash_attention_fwd(q, k, v, causal=True)
    out, lse = tflash.flash_attention_fwd(q.bfloat16(), k.bfloat16(),
                                          v.bfloat16(), causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # bf16 inputs carry ~3 significant digits
    onp.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 8, 8, 16))
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "rank":
        q = q[None]
    elif bad == "shape":
        v = v[:, :4]
    else:
        q = q.transpose(0, 1)
    with pytest.raises(MXNetError):
        tflash.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    rs = onp.random.RandomState(3)
    q, k, v = (rs.randn(2, 21, 4 * 16).astype("float32") for _ in range(3))
    ref = jattn.multi_head_attention(mx.np.array(q), mx.np.array(k),
                                     mx.np.array(v), 4,
                                     causal=causal).asnumpy()
    out = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 4, causal=causal)
    onp.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_masked_attention_takes_plain_composition():
    rs = onp.random.RandomState(4)
    q, k, v = (rs.randn(2, 9, 2 * 16).astype("float32") for _ in range(3))
    mask = rs.rand(2, 1, 9, 9) > 0.3
    mask[..., 0] = True
    ref = jattn.multi_head_attention(mx.np.array(q), mx.np.array(k),
                                     mx.np.array(v), 2,
                                     mask=mx.np.array(mask)).asnumpy()
    out = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 2,
                                     mask=torch.from_numpy(mask))
    onp.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_decode_attention_matches_jax_and_writes_in_place():
    rs = onp.random.RandomState(5)
    n, heads, d, max_seq = 3, 2, 16, 12
    q, k, v = (rs.randn(n, 1, heads * d).astype("float32") for _ in range(3))
    kc, vc = (rs.randn(n, max_seq, heads, d).astype("float32")
              for _ in range(2))
    pos = onp.array([0, 5, 40], dtype="int32")  # 40 clips to max_seq - 1
    ref_out, ref_kc, ref_vc = jattn.decode_attention(
        mx.np.array(q), mx.np.array(k), mx.np.array(v), mx.np.array(kc),
        mx.np.array(vc), mx.np.array(pos), heads)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, okc, ovc = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tkc,
        tvc, torch.from_numpy(pos), heads)
    assert okc is tkc and ovc is tvc
    onp.testing.assert_allclose(out.numpy(), ref_out.asnumpy(), atol=ATOL,
                                rtol=0)
    onp.testing.assert_array_equal(tkc.numpy(), ref_kc.asnumpy())
    onp.testing.assert_array_equal(tvc.numpy(), ref_vc.asnumpy())


def test_write_prefill_kv_matches_jax():
    rs = onp.random.RandomState(6)
    k, v = (rs.randn(1, 5, 2 * 16).astype("float32") for _ in range(2))
    kc = onp.zeros((3, 8, 2, 16), "float32")
    ref_k, ref_v = jattn.write_prefill_kv(
        mx.np.array(kc), mx.np.array(kc), mx.np.array(k), mx.np.array(v), 2,
        2)
    tk, tv = torch.zeros(3, 8, 2, 16), torch.zeros(3, 8, 2, 16)
    tattn.write_prefill_kv(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                           2, 2)
    onp.testing.assert_array_equal(tk.numpy(), ref_k.asnumpy())
    onp.testing.assert_array_equal(tv.numpy(), ref_v.asnumpy())
