"""The arithmetic of the fp32 flash-attention kernels, on the CPU.

On the card, ``csrc/flash_attention_bwd.cu`` computes each fp32 product
of the backward (s = q k^T, dp = do v^T, dV = p^T do, dK = ds^T q,
dQ = ds k), and ``csrc/flash_attention_fwd.cu`` each of the forward
(s = q k^T, p v), on the TF32 tensor cores in the 3xTF32 split: each operand x
becomes hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
ties away from zero (``cvt.rna.tf32.f32`` on finite values), and each
k-step of 8 adds a.lo b.hi, a.hi b.lo and a.hi b.hi to its accumulator
in turn; only a.lo b.lo is dropped. Here that arithmetic is emulated in
plain PyTorch as the kernels order it:

- s and dp: each k-step's three products are summed from zero and added
  to the running sum with one fp32 add (the kernel's ``mma_rn``);
- p = exp(s * scale - lse), each operation rounded on its own, 0 where
  masked; ds = p (dp - delta) scale (fp32 p and ds are not rounded);
- dV, dK and dQ: the streamed rows go in tiles of 32; each tile's k-steps
  accumulate into a zeroed partial, which is added to the sum with one
  fp32 add (the kernel's ``add_products``);
- the forward: s as above, then the online softmax over tiles of 32 keys,
  m_new = max(m, rowmax(s * scale)), p = exp(s * scale - m_new) with each
  operation rounded on its own (0 where masked), corr = exp(m - m_new),
  l = corr l + rowsum(p), and acc = corr acc + the tile's p v products
  summed into a zeroed partial.

It is held, at the kernels' fp32 tolerance (atol = rtol = 1e-4), against
a float64 backward and forward built here from scratch and against the
JAX package's Pallas kernels (``_flash_bwd`` and ``_fwd`` in interpret
mode). A single TF32 pass in
the same order is shown to miss that tolerance, so the check can tell the
two apart. What this cannot see is the tensor core's accumulation inside
one instruction (emulated as round-to-nearest fp32 adds) and the order of
the 8 products of a k-step; the card tests
(``tests/test_torch_cuda_kernels.py``) hold the kernels themselves.
"""
import math

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import flash_attention as jflash
from mxnet_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

FP32_TOL = dict(atol=1e-4, rtol=1e-4)
K_STEP = 8   # the k of one m16n8k8 TF32 mma
TILE = 32    # rows of a streamed fp32 tile


def _tf32(x):
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero: add half of the dropped 13 bits' range to the
    magnitude bits and clear them (a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _terms(a, b, passes):
    """The (A, B) pairs of one product, in the kernel's order: 3xTF32
    (lo.hi, hi.lo, hi.hi) or one TF32 pass (hi.hi)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return [(a_hi, b_hi)]
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def _mma(c, terms, k0):
    """``c`` plus k-step ``k0`` of every term, added in turn."""
    for x, y in terms:
        c = c + x[..., k0:k0 + K_STEP] @ y[..., k0:k0 + K_STEP, :]
    return c


def _products_rn(a, b, passes):
    """``a @ b`` as s and dp take it: each k-step summed from zero, then
    added to the running sum."""
    terms = _terms(a, b, passes)
    zero = a.new_zeros(a.shape[:-1] + b.shape[-1:])
    out = zero
    for k0 in range(0, a.shape[-1], K_STEP):
        out = out + _mma(zero, terms, k0)
    return out


def _products_tiled(a, b, passes):
    """``a @ b`` as dV, dK and dQ take it: the k index in tiles of 32 rows,
    each summed into a zeroed partial that is then added."""
    terms = _terms(a, b, passes)
    zero = a.new_zeros(a.shape[:-1] + b.shape[-1:])
    out = zero
    for t0 in range(0, a.shape[-1], TILE):
        part = zero
        for k0 in range(t0, min(t0 + TILE, a.shape[-1]), K_STEP):
            part = _mma(part, terms, k0)
        out = out + part
    return out


def _emulated(q, k, v, do, causal, passes=3):
    """The fp32 kernels' backward (dq, dk, dv), from the port's plain fp32
    forward's (out, lse) as the kernels get them from the forward."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    out, lse = tflash.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do * out).sum(dim=-1, keepdim=True)
    s = _products_rn(q, k.transpose(1, 2), passes)
    p = torch.exp(s * scale - lse)
    if causal:
        valid = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        p = torch.where(valid, p, 0.0)
    dp = _products_rn(do, v.transpose(1, 2), passes)
    ds = p * (dp - delta) * scale
    return (_products_tiled(ds, k, passes),
            _products_tiled(ds.transpose(1, 2), q, passes),
            _products_tiled(p.transpose(1, 2), do, passes))


def _emulated_fwd(q, k, v, causal, passes=3):
    """The fp32 forward kernel's (out, lse), in its order of sums."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = _products_rn(q, k.transpose(1, 2), passes) * scale
    valid = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
    if causal:
        s = torch.where(valid, s, -1e30)
    m = torch.full(q.shape[:2] + (1,), -1e30)
    l = torch.zeros(q.shape[:2] + (1,))
    acc = torch.zeros_like(q)
    for t0 in range(0, sk, TILE):
        s_t = s[..., t0:t0 + TILE]
        m_new = torch.maximum(m, s_t.amax(dim=-1, keepdim=True))
        p = torch.exp(s_t - m_new)
        if causal:
            p = torch.where(valid[:, t0:t0 + TILE], p, 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + _products_tiled(p, v[:, t0:t0 + TILE], passes)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return acc / l_safe, m + torch.log(l_safe)


def _float64_fwd(q, k, v, causal):
    """The attention forward (out, lse) in float64, from the inputs."""
    q, k, v = (t.double() for t in (q, k, v))
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    s = q @ k.transpose(1, 2) / math.sqrt(d)
    if causal:
        valid = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = s.masked_fill(~valid, -math.inf)
    return (torch.softmax(s, dim=-1) @ v,
            torch.logsumexp(s, dim=-1, keepdim=True))


def _float64(q, k, v, do, causal):
    """The attention backward (dq, dk, dv) in float64, from the inputs."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = q @ k.transpose(1, 2) * scale
    if causal:
        valid = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = p @ v
    dp = do @ v.transpose(1, 2)
    ds = p * (dp - (do * out).sum(dim=-1, keepdim=True)) * scale
    return ds @ k, ds.transpose(1, 2) @ q, p.transpose(1, 2) @ do


def _inputs(bh, s, d, seed):
    rs = onp.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(bh, s, d).astype("float32"))
            for _ in range(4)]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    cases = [(one, one), (one + 2 ** -11, one + 2 ** -10),  # tie: away
             (one + 2 ** -12, one), (one + 3 * 2 ** -12, one + 2 ** -10),
             (-(one + 2 ** -11), -(one + 2 ** -10)),
             (2 - 2 ** -23, 2.0),  # carry into the exponent
             (0.0, 0.0)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(onp.random.RandomState(0).randn(4096)
                         .astype("float32"))
    hi, lo = _split(y)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    # hi + lo holds x to ~2^-22 of |x|: about 21 bits of each product
    assert ((hi + lo - y).abs() <= 2.0 ** -22 * y.abs()).all()


def test_float64_reference_is_the_attention_gradient():
    """The yardstick itself: autograd of float64 softmax attention."""
    q, k, v, do = (t.double().requires_grad_() for t in
                   _inputs(2, 40, 16, seed=3))
    for causal in (False, True):
        s = q @ k.transpose(1, 2) / 4.0
        if causal:
            s = s.masked_fill(torch.ones(40, 40).triu(1).bool(), -math.inf)
        out = torch.softmax(s, dim=-1) @ v
        want = torch.autograd.grad(out, (q, k, v), do.detach())
        got = _float64(q.detach(), k.detach(), v.detach(), do.detach(),
                       causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_3xtf32_backward_matches_float64(d, causal):
    q, k, v, do = _inputs(2, 1024, d, seed=d + causal)
    got = _emulated(q, k, v, do, causal)
    ref = _float64(q, k, v, do, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g.double(), r, msg=name, **FP32_TOL)


def test_one_tf32_pass_misses_the_fp32_tolerance():
    q, k, v, do = _inputs(2, 1024, 64, seed=1)
    got = _emulated(q, k, v, do, True, passes=1)
    ref = _float64(q, k, v, do, True)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert not torch.allclose(g.double(), r, **FP32_TOL), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_3xtf32_backward_matches_pallas_kernel(d, causal):
    q, k, v, do = _inputs(2, 128, d, seed=7 * d + causal)
    scale = 1.0 / math.sqrt(d)

    def f(q, k, v):
        return jflash._flash(q, k, v, causal, scale, 64, 64, 64, 64, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    ref = vjp(jnp.asarray(do.numpy()))
    got = _emulated(q, k, v, do, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g, torch.from_numpy(onp.array(r)),
                                   msg=name, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_3xtf32_forward_matches_float64(d, causal):
    q, k, v = _inputs(2, 1024, d, seed=d + causal)[:3]
    got = _emulated_fwd(q, k, v, causal)
    ref = _float64_fwd(q, k, v, causal)
    for name, g, r in zip(("out", "lse"), got, ref):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g.double(), r, msg=name, **FP32_TOL)


def test_one_tf32_pass_misses_the_fp32_tolerance_in_the_forward():
    q, k, v = _inputs(2, 1024, 64, seed=1)[:3]
    out, _ = _emulated_fwd(q, k, v, True, passes=1)
    ref, _ = _float64_fwd(q, k, v, True)
    assert not torch.allclose(out.double(), ref, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_3xtf32_forward_matches_pallas_kernel(d, causal):
    q, k, v = _inputs(2, 128, d, seed=5 * d + causal)[:3]
    ref = jflash._fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal,
                      1.0 / math.sqrt(d), 64, 64, True)
    got = _emulated_fwd(q, k, v, causal)
    for name, g, r in zip(("out", "lse"), got, ref):
        torch.testing.assert_close(g, torch.from_numpy(onp.array(r)),
                                   msg=name, **FP32_TOL)
