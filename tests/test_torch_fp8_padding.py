"""The fp8 kernel's padded operands, on the CPU.

The CUDA kernel of ``ops.quant_matmul.fp8_matmul`` first widens
``quantize(x / x_scale)`` and ``w_q`` to float16 and pads K with zero
columns up to the GEMM's k-tile of 64 values; ``fp8_operands_plain`` is
that pass in plain PyTorch. Checked here:

1. the padded operands: shapes, rows of a whole number of 16-byte units,
   zero pad columns, and the first K columns equal to the fp8 values bit
   for bit (NaN and inf included), e4m3 and e5m2;
2. zero padding leaves the product exact: the float64 product of the
   padded e4m3 operands equals that of the unpadded fp8 operands bit for
   bit (e4m3 products are multiples of 2^-18 below 2^18, so every partial
   sum of up to 2^16 of them is exact in float64, in any order); and
   ``fp8_matmul_plain`` on x and w padded with zero columns agrees with it
   on the unpadded inputs within the card tolerance, 2^-20 of the sum of
   |products| x |x_scale * w_scale| plus 1e-6 of |out|. Not bit for bit:
   the CPU's fp32 matmul sums K = 784 and K = 832 in different blocks;
3. the plain version against the JAX package's Pallas kernel in interpret
   mode at K = 100 and 784, where the kernel pads K: fp32 sums of exact
   products in another order, rtol 1e-5 plus atol 1e-5 of the output's
   largest |value| (as ``tests/test_torch_fp8.py``).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import quant_matmul as jqm

from mxnet_tpu_torch.ops import quant_matmul as tqm

SHAPES = [(1, 5, 100), (37, 130, 256), (129, 257, 784), (8, 16, 64),
          (3, 4, 0)]  # (M, N, K)


def _inputs(m, n, k, fmt, seed, overflow=False):
    rs = onp.random.RandomState(seed)
    _, absmax = tqm.FP8_FORMATS[fmt]
    x = rs.randn(m, k).astype("float32")
    w = (rs.randn(n, k) * 0.5).astype("float32")
    ws = (onp.abs(w).max(axis=1, initial=1e-3) / absmax).astype("float32")
    xs = onp.float32(max(onp.abs(x).max(initial=0.0), 1e-3) / absmax)
    if overflow and k > 3:
        x[0, 3] = 2.5 * absmax * xs
        x[-1, 0] = -70000.0 * xs
    wq = tqm.quantize(torch.from_numpy(w / ws[:, None]), fmt)
    return torch.from_numpy(x), wq, torch.from_numpy(ws), float(xs)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_padded_operands_hold_the_fp8_values(m, n, k, fmt):
    x, wq, _, xs = _inputs(m, n, k, fmt, seed=m + n + k, overflow=True)
    xp, wp = tqm.fp8_operands_plain(x, wq, xs, fmt)
    kp = max(-(-k // 64) * 64, 64)
    assert xp.shape == (m, kp) and wp.shape == (n, kp)
    assert xp.dtype == wp.dtype == torch.float16
    assert xp.stride(0) * 2 % 16 == 0 and wp.stride(0) * 2 % 16 == 0
    assert not _bits(xp[:, k:]).any() and not _bits(wp[:, k:]).any()
    want_x = tqm.quantize(x / torch.tensor([xs]), fmt).to(torch.float16)
    assert torch.equal(_bits(xp[:, :k]), _bits(want_x))
    assert torch.equal(_bits(wp[:, :k]), _bits(wq.to(torch.float16)))
    if k > 3:  # the planted overflow: NaN in e4m3fn, inf in e5m2
        assert (xp[0, 3].isnan() if fmt == "e4m3" else xp[0, 3].isinf())


@pytest.mark.parametrize("m,n,k", [s for s in SHAPES if s[2]])
def test_zero_padding_leaves_the_product_exact(m, n, k):
    x, wq, ws, xs = _inputs(m, n, k, "e4m3", seed=m * n + k)
    xp, wp = tqm.fp8_operands_plain(x, wq, xs, "e4m3")
    xq = tqm.quantize(x / torch.tensor([xs]), "e4m3")
    exact = xq.double() @ wq.double().t()
    assert torch.equal(xp.double() @ wp.double().t(), exact)

    kp = xp.shape[1]
    x_pad = torch.zeros((m, kp))
    x_pad[:, :k] = x
    w_pad = torch.zeros((n, kp), dtype=torch.uint8)
    w_pad[:, :k] = wq.view(torch.uint8)
    got = tqm.fp8_matmul_plain(x_pad, w_pad.view(torch.float8_e4m3fn), ws,
                               xs)
    want = tqm.fp8_matmul_plain(x, wq, ws, xs)
    mag = (xq.double().abs() @ wq.double().abs().t()) * (xs * ws.double())
    tol = 2.0 ** -20 * mag + 1e-6 * want.double().abs()
    assert bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.parametrize("act,bias", [(None, False), ("gelu", True)])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,n,k", [(127, 129, 100), (129, 257, 784)])
def test_plain_matmul_matches_jax_kernel_at_padded_k(m, n, k, fmt, act,
                                                     bias):
    x, wq, ws, xs = _inputs(m, n, k, fmt, seed=k + m)
    b = torch.from_numpy(
        onp.random.RandomState(k).randn(n).astype("float32"))
    w_j = jnp.asarray(wq.view(torch.uint8).numpy()).view(
        jqm.FP8_FORMATS[fmt][0])
    want = onp.asarray(jqm.fp8_matmul(
        jnp.asarray(x.numpy()), w_j, jnp.asarray(ws.numpy()),
        onp.float32(xs), bias=jnp.asarray(b.numpy()) if bias else None,
        act=act, fmt=fmt, interpret=True))
    got = tqm.fp8_matmul(x, wq, ws, xs, bias=b if bias else None, act=act,
                         fmt=fmt).numpy()
    top = onp.abs(want[onp.isfinite(want)]).max()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * top,
                                equal_nan=True)
