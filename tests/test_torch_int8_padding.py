"""The int8 kernel's padded operands, on the CPU.

The CUDA kernel of ``ops.quant_matmul.quantized_matmul`` first quantizes x
into an s8 scratch whose rows are K rounded up to 16 values (zero in the
pad), and copies w the same way where K % 16 != 0; its GEMM then sums the
s8 products exactly in int32. ``int8_operands_plain`` is that prepare pass
in plain PyTorch. Checked here:

1. the padded operands: shapes, rows of a whole number of 16-byte units,
   zero pad columns, and the first K columns equal to ``quantize_int8``'s
   values and to ``w_q`` bit for bit (NaN, +-inf, values past +-127 and
   exact .5 ties planted in x);
2. the padded operands' exact product (float64: every partial sum is an
   integer below 2^53, as the kernel's int32 sum is exact) through the
   kernel's epilogue against the JAX package's ``quantized_matmul`` (the
   Pallas kernel in interpret mode, as ``tests/test_torch_quantization.py``
   runs it) at K = 100, 200, 768 and 784, with and without bias, for every
   activation. Without bias: bit for bit without an activation and with
   relu (both sum exactly and round ``acc * (x_scale * w_scale)`` alike),
   atol = rtol = 1e-6 for sigmoid, tanh and gelu (torch's activations
   against jnp's, an ulp apart). With bias, XLA on the CPU contracts the
   multiply and the add into one fused multiply-add (one rounding), where
   the kernel and the plain version round each (``__fmul_rn`` then
   ``__fadd_rn``): the JAX output is held bit for bit against that single
   rounding of the same exact product (computed in float64; without an
   activation and with relu), and the port's against the JAX output within
   what the skipped rounding can move, half an ulp of the product (2^-24
   |acc * x_scale * w_scale|, times 1.2 for the activations' slope) plus
   atol = rtol = 1e-6. The padded product also equals the port's plain
   version on the unpadded inputs bit for bit.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ops.pallas import quant_matmul as jqm

from mxnet_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

SHAPES = [(1, 100, 5), (37, 200, 130), (129, 784, 193), (8, 768, 16),
          (3, 0, 4), (5, 16, 3)]  # (M, K, N)
ACTS = [None, "relu", "sigmoid", "tanh", "gelu"]


def _inputs(m, k, n, seed):
    """x with exact .5 ties of x / x_scale (x_scale a power of two), NaN,
    +-inf and values past +-127 planted; w quantized per output channel as
    the reference does."""
    rs = onp.random.RandomState(seed)
    x = rs.randn(m, k).astype("float32")
    qw, ws = jq._quantize_weight(
        (rs.randn(n, k) * 0.5).astype("float32")) if k else (
        onp.zeros((n, 0), "int8"), onp.ones(n, "float32"))
    xs = onp.float32(2.0 ** round(onp.log2(
        max(onp.abs(x).max(initial=0.0), 1e-3) * 0.8 / 127)))
    if k >= 6 and m >= 2:
        x[0, :6] = onp.array([0.5, 1.5, 2.5, -2.5, -0.5, 126.5]) * xs
        x[-1, -4:] = [onp.nan, onp.inf, -onp.inf, 300.0 * xs]
    b = rs.randn(n).astype("float32")
    return x, qw, ws, xs, b


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_padded_operands_hold_the_int8_values(m, k, n):
    x, qw, _, xs, _ = _inputs(m, k, n, seed=m + k + n)
    tx, tw = torch.from_numpy(x), torch.from_numpy(qw)
    xp, wp = tqm.int8_operands_plain(tx, tw, float(xs))
    kp = max(-(-k // 16) * 16, 16)
    assert xp.shape == (m, kp) and wp.shape == (n, kp)
    assert xp.dtype == wp.dtype == torch.int8
    assert xp.stride(0) % 16 == 0 and wp.stride(0) % 16 == 0
    assert not xp[:, k:].any() and not wp[:, k:].any()
    assert torch.equal(xp[:, :k], tqm.quantize_int8(tx, float(xs)))
    assert torch.equal(wp[:, :k], tw)
    if k >= 6 and m >= 2:  # the planted ties (half to even), NaN, +-inf,
        # a value past +127
        assert xp[0, :6].tolist() == [0, 2, 2, -2, 0, 126]
        assert xp[-1, k - 4:k].tolist() == [0, 127, -127, 127]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [100, 200, 768, 784])
def test_padded_product_matches_jax_kernel(k, bias, act):
    m, n = 33, 70
    x, qw, ws, xs, b = _inputs(m, k, n, seed=k)
    b = b if bias else None
    want = onp.asarray(jqm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), xs,
        bias=None if b is None else jnp.asarray(b), act=act,
        interpret=True))
    xp, wp = tqm.int8_operands_plain(torch.from_numpy(x),
                                     torch.from_numpy(qw), float(xs))
    acc = xp.double() @ wp.double().t()
    got = tqm._int8_epilogue(acc, torch.tensor([xs]), torch.from_numpy(ws),
                             None if b is None else torch.from_numpy(b),
                             act).numpy()
    assert onp.array_equal(onp.isnan(got), onp.isnan(want))
    prod = acc.numpy() * (onp.float32(xs) * ws).astype("float64")
    if b is None and act in (None, "relu"):
        onp.testing.assert_array_equal(got, want)
    elif b is None:
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        if act in (None, "relu"):  # XLA's one rounding of acc * s + b
            fma = (prod + b).astype("float32")
            onp.testing.assert_array_equal(
                want, fma if act is None else onp.maximum(fma, 0))
        tol = 1.2 * 2.0 ** -24 * onp.abs(prod) + 1e-6 + 1e-6 * onp.abs(want)
        assert (onp.abs(got - want) <= tol).all()
    # the same product through the port's plain version, unpadded
    plain = tqm.quantized_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(ws),
        float(xs), bias=None if b is None else torch.from_numpy(b),
        act=act).numpy()
    onp.testing.assert_array_equal(got, plain)
