"""Port parity: the fused dropout + residual add + LayerNorm (ln_residual).

The plain versions of the port's two CUDA kernels (``ops/ln_residual.py``,
which the wrappers take for a CPU tensor) against the JAX package's Pallas
kernels run as its own tests run them on the CPU, in interpret mode:
``_run_fwd`` (out, mean, rstd) and ``ln_residual_dropout``, and
``jax.vjp`` of the latter with a random cotangent. The same numpy inputs
and explicit keep masks go to both. Also: ``gradcheck`` of the port's
``LnResidualFunction`` in float64; the ``fused_ln_residual`` gate's
routing on the CPU; a post-norm cell fused vs unfused under ``record()``
with live dropout; the default generators that dropout draws from when no
block generator is set (``random.seed``, the ``seed`` knob); and the
``npx`` activations the BERT heads use.

Tolerances: fp32 out/mean/rstd/dx/dh atol = rtol = 3e-5 (as
``tests/test_pallas_ln_residual.py:41``: fp32 sums in another order);
dgamma/dbeta rtol 3e-5 plus atol 3e-5 of their largest |value| (sums
over up to 600 rows, folded 8 rows wide by the Pallas kernel and column
by column here); bf16 outputs rtol 2^-7 (one bf16 ulp) plus atol 2^-10
of the largest |value| (both round the same fp32 value once, and a value
on a rounding boundary may round the other way); fused vs unfused in the
port atol = rtol = 1e-5 (``h*m*1.25`` against ``h*m/0.8``, and the plain
LayerNorm against ``F.layer_norm``).
"""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as jnpx
from mxnet_tpu.gluon.nn.transformer import valid_length_mask as jvlm
from mxnet_tpu.ops.pallas.ln_residual import _run_fwd
from mxnet_tpu.ops.pallas.ln_residual import ln_residual_dropout as jln

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import numpy_extension as tnpx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.nn import transformer as ttr
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import ln_residual as tln
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)

BF16 = dict(rtol=2.0 ** -7, share=2.0 ** -10)
F32 = dict(rtol=3e-5, share=3e-5)


def _inputs(rows, dim, p, dtype="float32", seed=1):
    """numpy (x, h, mask, gamma, beta, do), the mask a 0/1 keep mask in
    x's dtype (all ones at p = 0)."""
    rs = onp.random.RandomState(seed + rows + dim)
    x, h, do = (rs.randn(rows, dim).astype("float32") for _ in range(3))
    gamma = (rs.rand(dim) + 0.5).astype("float32")
    beta = rs.randn(dim).astype("float32")
    mask = (rs.rand(rows, dim) >= p).astype("float32")
    arrays = [x, h, mask, gamma, beta, do]
    if dtype == "bfloat16":  # round once, in numpy's view of bf16
        arrays = [onp.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays]
    return arrays


def _torch(a):
    a = onp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype("float32")).to(torch.bfloat16)
    return torch.from_numpy(a)


CASES = [(p, rows, dim) for p in (0.0, 0.3) for rows in (7, 600)
         for dim in (128, 768)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,rows,dim", CASES)
def test_plain_fwd_matches_pallas_kernel(p, rows, dim, dtype):
    x, h, mask, g, b, _ = _inputs(rows, dim, p, dtype)
    jx, jh, jm, jg, jb = (jnp.asarray(a) for a in (x, h, mask, g, b))
    block_rows = 8 if rows < 64 else 64  # 600 rows: a padded tail block
    j_out, j_mean, j_rstd = _run_fwd(jx, jh, jm if p > 0 else jnp.ones_like(
        jx, jnp.float32), jg, jb, p, 1e-5, block_rows, True)
    j_pub = jln(jx, jh, jg, jb, p=p, mask=jm if p > 0 else None,
                interpret=True)
    out, mean, rstd = tln.ln_residual_fwd(
        _torch(x), _torch(h), _torch(mask) if p > 0 else None, _torch(g),
        _torch(b), p)
    tol = BF16 if dtype == "bfloat16" else F32
    assert out.dtype == _torch(x).dtype and mean.dtype == torch.float32
    assert mean.shape == rstd.shape == (rows, 1)
    assert_almost_equal(out, onp.asarray(j_out, "float32"), rtol=tol["rtol"],
                        atol=tol["share"], scale_atol=tol is BF16,
                        names=("out", "jax"))
    assert_almost_equal(out, onp.asarray(j_pub, "float32"), rtol=tol["rtol"],
                        atol=tol["share"], scale_atol=tol is BF16,
                        names=("out (ln_residual_dropout)", "jax"))
    assert_almost_equal(mean,
                        onp.asarray(onp.asarray(j_mean)[:rows], "float32"),
                        rtol=F32["rtol"], atol=F32["share"], scale_atol=False,
                        names=("mean", "jax"))
    assert_almost_equal(rstd,
                        onp.asarray(onp.asarray(j_rstd)[:rows], "float32"),
                        rtol=F32["rtol"], atol=F32["share"], scale_atol=False,
                        names=("rstd", "jax"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,rows,dim", CASES)
def test_backward_matches_jax_vjp(p, rows, dim, dtype):
    """dx, dh, dgamma, dbeta of the port's Function against jax.vjp of
    the Pallas custom_vjp, for one random cotangent."""
    x, h, mask, g, b, do = _inputs(rows, dim, p, dtype, seed=2)
    jm = jnp.asarray(mask) if p > 0 else None
    out, vjp = jax.vjp(
        lambda *a: jln(*a, p=p, mask=jm, interpret=True, block_rows=64),
        *(jnp.asarray(a) for a in (x, h, g, b)))
    want = vjp(jnp.asarray(do))
    leaves = [_torch(a).requires_grad_() for a in (x, h, g, b)]
    got = tln.ln_residual_dropout(*leaves, p=p,
                                  mask=_torch(mask) if p > 0 else None)
    got.backward(_torch(do))
    tol = BF16 if dtype == "bfloat16" else F32
    assert_almost_equal(got.detach(), onp.asarray(out, "float32"),
                        rtol=tol["rtol"], atol=tol["share"],
                        scale_atol=tol is BF16, names=("out", "jax"))
    for name, leaf, w in zip(("dx", "dh", "dgamma", "dbeta"), leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        assert_almost_equal(leaf.grad, onp.asarray(w, "float32"),
                            rtol=tol["rtol"], atol=tol["share"],
                            scale_atol=(name in ("dgamma", "dbeta")
                                        or tol is BF16),
                            names=(name, "jax"))


def test_zero_variance_row_matches_pallas_kernel():
    """A constant row (var = 0): rstd = 1/sqrt(eps), out = beta, and its
    gradients, as the Pallas kernel gives them."""
    x, h, mask, g, b, do = _inputs(16, 128, 0.3, seed=3)
    x[0], h[0] = 0.75, 0.0
    jm = jnp.asarray(mask)
    out, vjp = jax.vjp(lambda *a: jln(*a, p=0.3, mask=jm, interpret=True),
                       *(jnp.asarray(a) for a in (x, h, g, b)))
    want = vjp(jnp.asarray(do))
    t_out, _, rstd = tln.ln_residual_fwd(_torch(x), _torch(h), _torch(mask),
                                         _torch(g), _torch(b), 0.3)
    assert rstd[0, 0].item() == pytest.approx(1e-5 ** -0.5, rel=1e-6)
    torch.testing.assert_close(t_out[0], _torch(b), atol=0, rtol=0)
    leaves = [_torch(a).requires_grad_() for a in (x, h, g, b)]
    tln.ln_residual_dropout(*leaves, p=0.3, mask=_torch(mask)).backward(
        _torch(do))
    assert_almost_equal(t_out, onp.asarray(out, "float32"), rtol=F32["rtol"],
                        atol=F32["share"], scale_atol=False,
                        names=("out", "jax"))
    for name, leaf, w in zip(("dx", "dh", "dgamma", "dbeta"), leaves, want):
        assert_almost_equal(leaf.grad, onp.asarray(w, "float32"),
                            rtol=F32["rtol"], atol=F32["share"],
                            scale_atol=True, names=(name, "jax"))


@pytest.mark.parametrize("dim", [128, 768])
def test_rows_far_from_zero_match_pallas_kernel(dim):
    """Rows whose mean (~100) dwarfs their spread (~1): the variance is
    taken in two passes, as the reference's ``(d*d).mean``; E[s^2] -
    mean^2 in fp32 would be off by ~1e-3 here."""
    x, h, _, g, b, _ = _inputs(16, dim, 0.0, seed=4)
    x = x + 100
    j_out, _, j_rstd = _run_fwd(
        jnp.asarray(x), jnp.asarray(h), jnp.ones((16, dim), jnp.float32),
        jnp.asarray(g), jnp.asarray(b), 0.0, 1e-5, 16, True)
    out, _, rstd = tln.ln_residual_fwd(_torch(x), _torch(h), None,
                                       _torch(g), _torch(b))
    assert_almost_equal(out, onp.asarray(j_out, "float32"), rtol=F32["rtol"],
                        atol=F32["share"], scale_atol=False,
                        names=("out", "jax"))
    onp.testing.assert_allclose(rstd.numpy(), onp.asarray(j_rstd),
                                rtol=1e-6, atol=0)


@pytest.mark.parametrize("mask_dtype", [None, torch.float64, torch.bool,
                                        torch.uint8])
def test_function_gradcheck_float64(mask_dtype):
    """The analytic backward (the backward kernel's plain version) against
    finite differences; ``None``: p = 0, no mask."""
    gen = torch.Generator().manual_seed(0)
    x, h = (torch.randn(5, 16, dtype=torch.float64, generator=gen,
                       requires_grad=True) for _ in range(2))
    g = (torch.rand(16, dtype=torch.float64, generator=gen) + 0.5) \
        .requires_grad_()
    b = torch.randn(16, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    p, mask = 0.0, None
    if mask_dtype is not None:
        p = 0.3
        mask = (torch.rand(5, 16, generator=gen) >= p).to(mask_dtype)
    assert torch.autograd.gradcheck(
        lambda *a: tln.LnResidualFunction.apply(a[0], a[1], mask, a[2], a[3],
                                                p, 1e-5),
        (x, h, g, b))


@pytest.mark.parametrize("bad", ["mask_shape", "mask_dtype", "contiguity",
                                 "dtype_mix", "gamma_shape", "rate",
                                 "stat_dtype"])
def test_wrappers_reject_bad_inputs(bad):
    x, h, mask, g, b, do = (_torch(a) for a in _inputs(6, 32, 0.3))
    p = 0.3
    if bad == "mask_shape":
        mask = mask[:, :16].contiguous()
    elif bad == "mask_dtype":
        mask = mask.to(torch.int32)
    elif bad == "contiguity":
        x = x.t().contiguous().t()
    elif bad == "dtype_mix":
        h = h.double()
    elif bad == "gamma_shape":
        g = g[:16]
    elif bad == "rate":
        p = 1.0
    if bad != "stat_dtype":
        with pytest.raises(MXNetError):
            tln.ln_residual_fwd(x, h, mask, g, b, p)
    mean, rstd = torch.zeros(6, 1), torch.ones(6, 1)
    if bad == "stat_dtype":
        mean = mean.double()
    with pytest.raises(MXNetError):
        tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, p)


def test_rate_without_mask_raises():
    x, h, _, g, b, _ = (_torch(a) for a in _inputs(4, 32, 0.1))
    with pytest.raises(ValueError):
        tln.ln_residual_dropout(x, h, g, b, p=0.1)
    with pytest.raises(MXNetError):
        tln.ln_residual_fwd(x, h, None, g, b, 0.1)
    # p = 0 reads no mask: a given one is ignored, as in the reference
    y = tln.ln_residual_dropout(x, h, g, b, mask=torch.zeros_like(x))
    torch.testing.assert_close(
        y, tln.ln_residual_fwd_reference(x, h, None, g, b)[0])


# -- the gate -----------------------------------------------------------------

@pytest.fixture
def knob():
    yield tmx.config.set
    tmx.config.reset("fused_ln_residual")


def _cell(pre_norm=False, dropout=0.2):
    cell = tnn.TransformerEncoderCell(32, 64, 4, dropout=dropout,
                                      attention_dropout=dropout,
                                      pre_norm=pre_norm, device="cpu")
    return cell.initialize(seed=3)


def _spy(monkeypatch):
    calls = []
    orig = ttr.ln_residual_dropout

    def spy(*args, **kwargs):
        calls.append(kwargs["p"])
        return orig(*args, **kwargs)
    monkeypatch.setattr(ttr, "ln_residual_dropout", spy)
    return calls


@pytest.mark.parametrize("mode,want", [
    ("off", [[], []]),
    # "auto" fuses only a CUDA tensor under live dropout: never here, as
    # the reference's "auto" never fuses off the TPU
    ("auto", [[], []]),
    # "on" fuses both residuals; the attention one drops only in training
    ("on", [[0.2, 0.0], [0.0, 0.0]]),
])
def test_gate_routing_on_the_cpu(monkeypatch, knob, mode, want):
    calls = _spy(monkeypatch)
    knob("fused_ln_residual", mode)
    cell = _cell()
    x = torch.from_numpy(onp.random.RandomState(0).randn(2, 5, 32)
                         .astype("float32"))
    with tmx.autograd.record():
        cell(x)
    seen = [list(calls)]
    calls.clear()
    cell(x)  # inference: dropout off
    seen.append(list(calls))
    assert seen == want
    calls.clear()
    with tmx.autograd.record():
        _cell(pre_norm=True)(x)  # the pre-norm layout has no such residual
    assert calls == []


def test_gate_rejects_an_unknown_mode(knob):
    knob("fused_ln_residual", "sometimes")
    x = torch.zeros(1, 3, 32)
    with pytest.raises(MXNetError):
        _cell()(x)


def test_fused_cell_matches_unfused_under_record(knob):
    """A post-norm cell with dropout 0.2 under record(): "on" and "off"
    from the same seed draw the same masks, so outputs and every gradient
    agree."""
    x0 = onp.random.RandomState(1).randn(3, 7, 32).astype("float32")
    runs = {}
    for mode in ("off", "on"):
        knob("fused_ln_residual", mode)
        cell = _cell()
        x = torch.tensor(x0, requires_grad=True)
        tmx.random.seed(42)
        with tmx.autograd.record():
            out = cell(x)
        tmx.autograd.backward(out, torch.from_numpy(
            onp.random.RandomState(2).randn(*out.shape).astype("float32")))
        runs[mode] = (out.detach(), x.grad,
                      {n: p.grad() for n, p in cell.collect_params().items()})
    (o_off, x_off, g_off), (o_on, x_on, g_on) = runs["off"], runs["on"]
    # live dropout: a different mask would move the output by O(1)
    assert (o_off - _cell()(torch.from_numpy(x0))).abs().max() > 0.1
    torch.testing.assert_close(o_on, o_off, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_on, x_off, atol=1e-5, rtol=1e-5)
    for name, g in g_off.items():
        torch.testing.assert_close(g_on[name], g, atol=1e-5, rtol=1e-5,
                                   msg=name)


# -- the default generators (no block generator) -----------------------------

def test_dropout_without_generator_is_reproducible_after_seed():
    drop = tnn.Dropout(0.5)
    x = torch.ones(32, 32)
    draws = []
    for _ in range(2):
        tmx.random.seed(7)
        with tmx.autograd.record():
            draws.append((drop(x), drop(x)))
    (a1, a2), (b1, b2) = draws
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2)
    assert set(torch.unique(a1).tolist()) == {0.0, 2.0}
    # an explicit generator still wins
    drop.generator = torch.Generator().manual_seed(7)
    with tmx.autograd.record():
        c1 = drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    with tmx.autograd.record():
        assert torch.equal(drop(x), c1)


def test_attention_dropout_without_generator_is_reproducible_after_seed():
    rs = onp.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 8, 16).astype("float32"))
               for _ in range(3))
    outs = []
    for _ in range(2):
        tmx.random.seed(5)
        with tmx.autograd.record():
            outs.append(tattn.multi_head_attention(q, k, v, 2,
                                                   dropout_p=0.5))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], tattn.multi_head_attention(q, k, v, 2),
                              atol=1e-3)


def test_seed_reseeds_every_default_generator():
    gen = tmx.random.default_generator("cpu")
    tmx.random.seed(11)
    first = torch.rand(4, generator=gen)
    tmx.random.seed(11)
    assert torch.equal(torch.rand(4, generator=gen), first)
    assert torch.equal(first, torch.rand(4, generator=tmx.random.generator(
        11)))
    tmx.random.seed(12, ctx="cpu")
    assert torch.equal(
        torch.rand(4, generator=tmx.random.default_generator("cpu")),
        torch.rand(4, generator=tmx.random.generator(12)))


def test_default_generator_starts_from_the_seed_knob():
    """MXNET_SEED seeds a process's default generators (reference:
    config.py ``seed``)."""
    code = ("import torch, mxnet_tpu_torch as mx; "
            "a = torch.rand(3, generator=mx.random.default_generator('cpu'));"
            " b = torch.rand(3, generator=mx.random.generator(9)); "
            "print(mx.config.get('seed'), torch.equal(a, b))")
    env = dict(os.environ, MXNET_SEED="9")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.split() == ["9", "True"], proc.stdout + proc.stderr


# -- small pieces of the BERT path ---------------------------------------------

def test_valid_length_mask_matches_jax():
    vl = onp.array([5, 1, 8], dtype="int32")
    want = onp.asarray(jvlm(mx.np.array(vl), 8).asnumpy())
    got = ttr.valid_length_mask(torch.from_numpy(vl), 8)
    assert got.dtype == torch.bool and got.shape == (3, 1, 1, 8)
    onp.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "silu", "log_sigmoid",
                                 "mish"])
def test_activation_matches_jax(act):
    x = onp.random.RandomState(4).randn(3, 17).astype("float32") * 3
    want = jnpx.activation(mx.np.array(x), act_type=act).asnumpy()
    got = tnpx.activation(torch.from_numpy(x), act_type=act)
    onp.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("act", ["leaky", "gelu"])
def test_leaky_relu_matches_jax(act):
    x = onp.random.RandomState(5).randn(3, 17).astype("float32") * 3
    want = jnpx.leaky_relu(mx.np.array(x), act_type=act).asnumpy()
    got = tnpx.leaky_relu(torch.from_numpy(x), act_type=act)
    onp.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    with pytest.raises(MXNetError):
        tnpx.leaky_relu(torch.from_numpy(x), act_type="rrelu")


def test_dense_activation_child_has_no_parameters():
    dense = tnn.Dense(4, activation="tanh", in_units=3, device="cpu")
    dense.initialize(seed=0)
    assert list(dense.collect_params()) == ["weight", "bias"]
    x = torch.randn(2, 3)
    torch.testing.assert_close(dense(x), torch.tanh(
        x @ dense.weight.t() + dense.bias))
