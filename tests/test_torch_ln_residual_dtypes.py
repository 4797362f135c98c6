"""Port parity: the ln_residual dtype rules (the reference's, not narrower).

The reference casts every input to fp32 inside its Pallas kernels
(``mxnet_tpu/ops/pallas/ln_residual.py``), writes ``out`` and ``dx`` in
x's dtype and ``dh`` in h's, casts dgamma/dbeta to gamma's (beta's)
dtype, and takes a keep mask of any 0/1 dtype. These tests hold the port's
``ln_residual_dropout`` on the CPU (the kernels' plain versions) against
the JAX ``ln_residual_dropout(..., interpret=True)`` and its ``jax.vjp``
where the dtypes differ: bf16 rows with fp32 gamma/beta (the AMP layout,
LayerNorm parameters kept in fp32), fp32 x with bf16 h and the reverse,
bf16 rows with an fp32 mask, fp16 rows (with fp16 or fp32 gamma), and
bool/uint8/float masks; each at p 0 and 0.1. The same numpy inputs go to
both; output dtypes are compared exactly.

Tolerances, by the dtype of each result: fp32 atol = rtol = 3e-5 (as
``tests/test_torch_ln_residual.py``'s ``F32``: fp32 sums in another
order); bf16 rtol 2^-7 (one bf16 ulp) plus atol 2^-10 of the largest
|value| (that file's ``BF16``: both round the same fp32 value once, and a
value on a rounding boundary may round the other way); fp16 rtol 2^-10
(one fp16 ulp) plus atol 2^-13 of the largest |value| (the same rule one
fp16 ulp down: 1/8 of the largest value's ulp, for values near zero whose
fp32 value differs by a few fp32 ulps of the O(1) terms). dgamma/dbeta in
fp32 take their atol as 3e-5 of their largest |value| (sums over the
rows in another order), as that file does.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas.ln_residual import _run_fwd
from mxnet_tpu.ops.pallas.ln_residual import ln_residual_dropout as jln

from mxnet_tpu_torch.ops import ln_residual as tln
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=3e-5, share=3e-5),
       "bfloat16": dict(rtol=2.0 ** -7, share=2.0 ** -10),
       "float16": dict(rtol=2.0 ** -10, share=2.0 ** -13)}

# (x, h, gamma/beta, mask) dtypes
CASES = {
    "bf16_rows_f32_gamma_bool_mask": ("bfloat16", "bfloat16", "float32",
                                      "bool"),
    "bf16_rows_f32_gamma_bf16_mask": ("bfloat16", "bfloat16", "float32",
                                      "bfloat16"),
    "f32_x_bf16_h": ("float32", "bfloat16", "float32", "float32"),
    "bf16_x_f32_h": ("bfloat16", "float32", "bfloat16", "uint8"),
    "bf16_rows_f32_mask": ("bfloat16", "bfloat16", "bfloat16", "float32"),
    "f16_rows": ("float16", "float16", "float16", "float16"),
    "f16_rows_f32_gamma_bool_mask": ("float16", "float16", "float32",
                                     "bool"),
}
SHAPES = [(16, 128), (37, 768)]  # the smallest diverging input; ragged


def _np(a, dtype):
    if dtype == "bfloat16":
        return onp.asarray(jnp.asarray(a, jnp.bfloat16))
    return a.astype(dtype)


def _torch(a):
    a = onp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype("float32")).to(torch.bfloat16)
    return torch.from_numpy(a)


def _inputs(rows, dim, p, dtypes, seed=0):
    """numpy (x, h, mask, gamma, beta, do) in the case's dtypes, from one
    seed; do in x's dtype (the output's)."""
    xd, hd, gd, md = dtypes
    rs = onp.random.RandomState(seed + rows + dim)
    x, h, do = (rs.randn(rows, dim).astype("float32") for _ in range(3))
    gamma = (rs.rand(dim) + 0.5).astype("float32")
    beta = rs.randn(dim).astype("float32")
    keep = rs.rand(rows, dim) >= p
    mask = keep if md == "bool" else _np(keep.astype("float32"), md)
    return (_np(x, xd), _np(h, hd), mask, _np(gamma, gd), _np(beta, gd),
            _np(do, xd))


def _tol(got, sums=False):
    """The tolerance of ``got``'s dtype (``got`` is compared against the
    JAX result of the same dtype): atol a share of max|want| for the sums
    and the 2-byte dtypes."""
    kind = str(got.dtype)[6:]
    tol = TOL[kind]
    return dict(rtol=tol["rtol"], atol=tol["share"],
                scale_atol=sums or kind != "float32")


@pytest.mark.parametrize("rows,dim", SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_dtypes_match_pallas_kernel(case, p, rows, dim):
    x, h, mask, g, b, _ = _inputs(rows, dim, p, CASES[case])
    jx, jh, jm, jg, jb = (jnp.asarray(a) for a in (x, h, mask, g, b))
    j_out, j_mean, j_rstd = _run_fwd(
        jx, jh, jm if p > 0 else jnp.ones_like(jx, jnp.float32), jg, jb, p,
        1e-5, 8, True)
    j_pub = jln(jx, jh, jg, jb, p=p, mask=jm if p > 0 else None,
                interpret=True)
    tm = _torch(mask) if p > 0 else None
    out, mean, rstd = tln.ln_residual_fwd(_torch(x), _torch(h), tm,
                                          _torch(g), _torch(b), p)
    assert_almost_equal(out, onp.asarray(j_out)[:rows], names=("out", "jax"),
                        check_dtype=True, **_tol(out, False))
    assert_almost_equal(out, j_pub, names=("out (ln_residual_dropout)", "jax"),
                        check_dtype=True, **_tol(out, False))
    assert_almost_equal(mean, onp.asarray(j_mean)[:rows],
                        names=("mean", "jax"), check_dtype=True,
                        **_tol(mean, False))
    assert_almost_equal(rstd, onp.asarray(j_rstd)[:rows],
                        names=("rstd", "jax"), check_dtype=True,
                        **_tol(rstd, False))
    got = tln.ln_residual_dropout(_torch(x), _torch(h), _torch(g),
                                  _torch(b), p=p, mask=tm)
    assert_almost_equal(got, j_pub,
                        names=("out (port's ln_residual_dropout)", "jax"),
                        check_dtype=True, **_tol(got, False))


@pytest.mark.parametrize("rows,dim", SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_dtypes_match_jax_vjp(case, p, rows, dim):
    """dx, dh, dgamma, dbeta of the port's Function against jax.vjp of the
    Pallas custom_vjp: values and dtypes."""
    x, h, mask, g, b, do = _inputs(rows, dim, p, CASES[case], seed=1)
    jm = jnp.asarray(mask) if p > 0 else None
    out, vjp = jax.vjp(
        lambda *a: jln(*a, p=p, mask=jm, interpret=True, block_rows=16),
        *(jnp.asarray(a) for a in (x, h, g, b)))
    want = vjp(jnp.asarray(do))
    leaves = [_torch(a).requires_grad_() for a in (x, h, g, b)]
    got = tln.ln_residual_dropout(*leaves, p=p,
                                  mask=_torch(mask) if p > 0 else None)
    got.backward(_torch(do))
    assert_almost_equal(got.detach(), out, names=("out", "jax"),
                        check_dtype=True, **_tol(got.detach(), False))
    for name, leaf, w in zip(("dx", "dh", "dgamma", "dbeta"), leaves, want):
        assert_almost_equal(leaf.grad, w, names=(name, "jax"),
                            check_dtype=True,
                            **_tol(leaf.grad, name in ("dgamma", "dbeta")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_wrapper_dtypes(case):
    """``ln_residual_bwd`` alone (the kernel's plain version on the CPU):
    dx in x's dtype, dh in h's, dgamma/dbeta in gamma's, equal to the
    values of an all-fp32 call rounded once."""
    x, h, mask, g, b, do = (_torch(a) for a in _inputs(16, 128, 0.1,
                                                       CASES[case], seed=2))
    _, mean, rstd = tln.ln_residual_fwd(x, h, mask, g, b, 0.1)
    got = tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)
    want = tln.ln_residual_bwd(x.float(), h.float(), mask.float(),
                               g.float(), mean, rstd, do.float(), 0.1)
    for name, t, w, like in zip(("dx", "dh", "dgamma", "dbeta"), got, want,
                                (x, h, g, g)):
        assert t.dtype == like.dtype, name
        torch.testing.assert_close(t, w.to(like.dtype), atol=0, rtol=0,
                                   msg=name)
