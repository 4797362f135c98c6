"""Port parity: the fused conv3x3 + BatchNorm + ReLU backward (kernel 8),
JAX package -> PyTorch port.

The port works in NCHW / OIHW, the JAX kernel in NHWC / HWIO: the same
numpy inputs go to both, transposed. On the CPU the port's wrapper takes
the kernel's plain version (dy recomputed from the stats vector, 9
shifted products each for dgrad and wgrad, fp32 sums); the JAX side runs
as its own tests run it: ``jax.vjp`` of ``conv3x3_bn_relu_ref`` and the
Pallas kernel in interpret mode. Tolerances: the kernel's gradients rtol =
atol = 5e-4, the reference's own (``tests/test_fused_conv_bwd.py:52-53``);
forwards and running statistics 1e-4 / 1e-5 (fp32 convolutions summed in
another order); the fused route against the child-by-child route at the
block level the reference's 1e-3 / 2e-3 (:103-107).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import pallas_conv_bwd as jcb

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.nn import fuse as tfuse
from mxnet_tpu_torch.ops import conv_bwd as tcb

torch.set_num_threads(2)

TOL = dict(rtol=5e-4, atol=5e-4)


def _nchw(a):
    return torch.from_numpy(onp.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(onp.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(shape, seed, o=None):
    """The reference test's inputs (NHWC x and da, HWIO w)."""
    n, h, w, c = shape
    o = c if o is None else o
    rs = onp.random.RandomState(seed)
    x = rs.randn(n, h, w, c).astype("float32")
    wt = (rs.randn(3, 3, c, o) * 0.2).astype("float32")
    gamma = (rs.rand(o) + 0.5).astype("float32")
    beta = (rs.randn(o) * 0.1).astype("float32")
    da = rs.randn(n, h, w, o).astype("float32")
    return x, wt, gamma, beta, da


@pytest.fixture
def fused_mode():
    """Sets ``fused_conv_bn`` in both packages; restores both after."""
    def set_mode(mode, jax_mode=None):
        mx.config.set("fused_conv_bn", jax_mode or mode)
        tmx.config.set("fused_conv_bn", mode)
    yield set_mode
    mx.config.set("fused_conv_bn", "auto")
    tmx.config.reset("fused_conv_bn")


@pytest.mark.parametrize("shape,o", [
    ((4, 8, 8, 16), None),   # the reference's single grid step
    ((16, 8, 8, 8), None),   # its multi-step dw accumulation
    ((2, 4, 4, 128), None),  # late stage: big C, tiny spatial
    ((3, 7, 9, 5), 11),      # odd sizes, C != O
])
def test_plain_bwd_matches_jax_vjp_and_pallas_kernel(shape, o):
    x, w, gamma, beta, da = _inputs(shape, seed=sum(shape), o=o)
    jx, jw, jg, jb, jda = map(jnp.asarray, (x, w, gamma, beta, da))
    _, vjp = jax.vjp(lambda *a: jcb.conv3x3_bn_relu_ref(*a)[0],
                     jx, jw, jg, jb)
    want_vjp = vjp(jda)
    _, jy, jmean, jvar = jcb.conv3x3_bn_relu_ref(jx, jw, jg, jb)
    want_kernel = jcb.fused_conv3x3_bn_relu_bwd(
        jda, jx, jy, jw, jg, jb, jmean, jvar, interpret=True)

    tx, tw = _nchw(x), _oihw(w)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    a, y, mean, var = tcb.conv3x3_bn_relu_ref(tx, tw, tg, tb)
    want_a = onp.asarray(jcb.conv3x3_bn_relu_ref(jx, jw, jg, jb)[0])
    onp.testing.assert_allclose(_to_nhwc(a), want_a, rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(_to_nhwc(y), onp.asarray(jy), rtol=1e-4,
                                atol=1e-4)
    onp.testing.assert_allclose(mean.numpy(), onp.asarray(jmean), rtol=1e-4,
                                atol=1e-5)
    onp.testing.assert_allclose(var.numpy(), onp.asarray(jvar), rtol=1e-4,
                                atol=1e-5)
    before = tcb.fused_conv3x3_bn_relu_bwd.launches
    dx, dw, dg, db = tcb.fused_conv3x3_bn_relu_bwd(_nchw(da), tx, y, tw, tg,
                                                   tb, mean, var)
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before  # CPU: plain
    got = [_to_nhwc(dx), dw.numpy().transpose(2, 3, 1, 0), dg.numpy(),
           db.numpy()]
    for want in (want_vjp, want_kernel):
        for name, g, ref in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
            assert g.shape == ref.shape, name
            onp.testing.assert_allclose(g, onp.asarray(ref), err_msg=name,
                                        **TOL)


def _non_finite_inputs(nan_at):
    """Inputs with an inf in x, an inf in w and, where ``nan_at`` is
    "live" or "dead", a NaN in da at a place the ReLU passes or blocks; y,
    mean and var from the finite inputs (JAX's forward), all as numpy."""
    x, w, gamma, beta, da = _inputs((2, 6, 5, 4), seed=21, o=3)
    _, y, mean, var = jcb.conv3x3_bn_relu_ref(*map(jnp.asarray,
                                                   (x, w, gamma, beta)))
    y, mean, var = (onp.array(t) for t in (y, mean, var))
    x[1, 0, 2, 3] = onp.inf      # a border pixel: its taps also leave the image
    w[2, 1, 3, 0] = -onp.inf
    if nan_at is not None:
        z = gamma * (y - mean) / onp.sqrt(var + 1e-5) + beta
        live = onp.argwhere((z > 0) == (nan_at == "live"))[0]
        da[tuple(live)] = onp.nan
    return x, w, gamma, beta, da, y, mean, var


@pytest.mark.parametrize("nan_at", [None, "live", "dead"])
def test_plain_bwd_keeps_non_finite_positions_of_the_pallas_kernel(nan_at):
    """inf in x and w and NaN in da: the port's plain version (the card
    kernel's yardstick) has the NaN and inf positions of the reference's
    Pallas kernel in interpret mode, in dx, dw, dgamma and dbeta."""
    x, w, gamma, beta, da, y, mean, var = _non_finite_inputs(nan_at)
    want = jcb.fused_conv3x3_bn_relu_bwd(
        *map(jnp.asarray, (da, x, y, w, gamma, beta, mean, var)),
        interpret=True)
    got = tcb.fused_conv3x3_bn_relu_bwd(
        _nchw(da), _nchw(x), _nchw(y), _oihw(w), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(mean),
        torch.from_numpy(var))
    got = [_to_nhwc(got[0]), got[1].numpy().transpose(2, 3, 1, 0),
           got[2].numpy(), got[3].numpy()]
    for name, g, ref in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        ref = onp.asarray(ref)
        onp.testing.assert_array_equal(onp.isnan(g), onp.isnan(ref),
                                       err_msg=name)
        onp.testing.assert_array_equal(onp.isinf(g), onp.isinf(ref),
                                       err_msg=name)
        onp.testing.assert_array_equal(onp.sign(g[onp.isinf(g)]),
                                       onp.sign(ref[onp.isinf(ref)]),
                                       err_msg=name)
    # the inputs reach every class: +-inf in dw, NaN (0 * inf) in dx
    assert onp.isinf(got[1]).any() and onp.isnan(got[0]).any()
    assert onp.isfinite(got[0]).any() or nan_at == "live"


def test_stats_vector_matches_the_reference_layout():
    x, w, gamma, beta, da = _inputs((2, 5, 6, 4), seed=3, o=6)
    tx, tw = _nchw(x), _oihw(w)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, y, mean, var = tcb.conv3x3_bn_relu_ref(tx, tw, tg, tb)
    dg, db, vec = tcb.bwd_stats(_nchw(da), y, tg, tb, mean, var)
    assert vec.shape == (8, 6) and vec.dtype == torch.float32
    inv = torch.rsqrt(var + 1e-5)
    m = 2 * 5 * 6
    for row, want in enumerate([mean, inv, tg, tb, db / m, dg / m,
                                tg * inv, torch.zeros(6)]):
        torch.testing.assert_close(vec[row], want, rtol=0, atol=0)


def test_fused_function_gradients_match_jax_fused_cbr_train():
    x, w, gamma, beta, da = _inputs((2, 6, 6, 8), seed=11)
    jargs = tuple(map(jnp.asarray, (x, w, gamma, beta)))
    (ja, jmean, jvar), vjp = jax.vjp(
        lambda *a: jcb.fused_cbr_train(*a, 1e-5, True), *jargs)
    want = vjp((jnp.asarray(da), jnp.zeros_like(jmean), jnp.zeros_like(jvar)))
    targs = [_nchw(x), _oihw(w), torch.from_numpy(gamma),
             torch.from_numpy(beta)]
    for t in targs:
        t.requires_grad_(True)
    a, mean, var = tcb.FusedCBRFunction.apply(*targs, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    onp.testing.assert_allclose(_to_nhwc(a), onp.asarray(ja), rtol=1e-4,
                                atol=1e-4)
    onp.testing.assert_allclose(mean.numpy(), onp.asarray(jmean), rtol=1e-4,
                                atol=1e-5)
    a.backward(_nchw(da))
    got = [_to_nhwc(targs[0].grad),
           targs[1].grad.numpy().transpose(2, 3, 1, 0),
           targs[2].grad.numpy(), targs[3].grad.numpy()]
    for name, g, ref in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        onp.testing.assert_allclose(g, onp.asarray(ref), err_msg=name, **TOL)


def test_fused_function_passes_gradcheck_in_float64():
    rs = onp.random.RandomState(4)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (
        rs.randn(2, 3, 4, 5), rs.randn(4, 3, 3, 3) * 0.3, rs.rand(4) + 0.5,
        rs.randn(4) * 0.1)]
    assert torch.autograd.gradcheck(
        lambda *a: tcb.FusedCBRFunction.apply(*a, 1e-5)[0], args,
        eps=1e-6, atol=1e-5, rtol=1e-4)


def _triplet_pair(c=8, seed=0):
    """(JAX, port) FusableSequential [Conv2D 3x3, BatchNorm, relu] with the
    same weights, shapes finished by one forward."""
    mx.random.seed(seed)
    jblk = jnn.FusableSequential()
    jblk.add(jnn.Conv2D(c, 3, padding=1, use_bias=False), jnn.BatchNorm(),
             jnn.Activation("relu"))
    jblk.initialize()
    tblk = tnn.FusableSequential()
    tblk.add(tnn.Conv2D(c, 3, padding=1, use_bias=False, device="cpu"),
             tnn.BatchNorm(device="cpu"), tnn.Activation("relu"))
    tblk.initialize()
    xv = onp.random.RandomState(seed).randn(2, c, 6, 6).astype("float32")
    jblk(mx.np.array(xv))
    tblk(torch.from_numpy(xv))
    tfunctional.load_params(tblk, {n: onp.asarray(v) for n, v in
                                   jfunctional.param_arrays(jblk).items()})
    return jblk, tblk, xv


@pytest.mark.parametrize("mode", ["on", "off"])
def test_running_stats_update_matches_jax(fused_mode, mode):
    """Oracle: tests/test_fused_conv_bwd.py:110, across the packages."""
    jblk, tblk, xv = _triplet_pair()
    fused_mode(mode)
    with mx.autograd.record():
        jout = jblk(mx.np.array(xv))
    with tmx.autograd.record():
        tout = tblk(torch.from_numpy(xv))
    onp.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(),
                                rtol=1e-4, atol=1e-4)
    for name in ("running_mean", "running_var"):
        want = getattr(jblk[1], name).data().asnumpy()
        got = getattr(tblk[1], name).detach().numpy()
        assert not onp.allclose(got, 1.0 if name == "running_var" else 0.0)
        onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                    err_msg=name)
        assert not getattr(tblk[1], name).requires_grad


def test_running_stats_fused_equal_unfused(fused_mode):
    _, tblk, xv = _triplet_pair(seed=1)
    bn = tblk[1]
    stats = {}
    for mode in ("on", "off"):
        bn.running_mean.data.zero_()
        bn.running_var.data.fill_(1.0)
        fused_mode(mode)
        with tmx.autograd.record():
            tblk(torch.from_numpy(xv))
        stats[mode] = (bn.running_mean.clone(), bn.running_var.clone())
    for a, b in zip(stats["on"], stats["off"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_eligible_triplet_matches_jax():
    """Oracle: tests/test_fused_conv_bwd.py:137."""
    def convs(nn, **kw):
        return [nn.Conv2D(8, 3, padding=1, use_bias=False, **kw),
                nn.Conv2D(8, 3, strides=2, padding=1, use_bias=False, **kw),
                nn.Conv2D(8, 7, padding=3, use_bias=False, **kw),
                nn.Conv2D(8, 3, padding=1, use_bias=True, **kw),
                nn.Conv2D(8, 3, padding=1, dilation=2, use_bias=False,
                          **kw),
                nn.Conv2D(8, 3, padding=1, groups=2, use_bias=False,
                          in_channels=8, **kw)]
    from mxnet_tpu.gluon.nn.fuse import _eligible_triplet as jelig
    cpu = {"device": "cpu"}
    for j, t in zip(convs(jnn), convs(tnn, **cpu)):
        for jbn, tbn in ((jnn.BatchNorm(), tnn.BatchNorm(**cpu)),
                         (jnn.BatchNorm(scale=False),
                          tnn.BatchNorm(scale=False, **cpu)),
                         (jnn.BatchNorm(use_global_stats=True),
                          tnn.BatchNorm(use_global_stats=True, **cpu))):
            for act in ("relu", "tanh"):
                want = jelig(j, jbn, jnn.Activation(act))
                got = tfuse._eligible_triplet(t, tbn, tnn.Activation(act))
                assert got == want, (j, jbn, act)
    assert tfuse._eligible_triplet(convs(tnn, **cpu)[0],
                                   tnn.BatchNorm(**cpu),
                                   tnn.Activation("relu"))


def _count_fused(monkeypatch):
    calls = []
    real = tmx.npx.fused_conv_bn_relu

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tmx.npx, "fused_conv_bn_relu", counting)
    return calls


def test_eval_auto_on_cpu_hooks_and_ineligible_take_the_children(
        fused_mode, monkeypatch):
    _, tblk, xv = _triplet_pair(seed=2)
    calls = _count_fused(monkeypatch)
    x = torch.from_numpy(xv)
    bn = tblk[1]
    rm0 = bn.running_mean.clone()
    fused_mode("on")
    tblk(x)  # eval: child by child, running statistics frozen
    assert not calls
    torch.testing.assert_close(bn.running_mean, rm0, rtol=0, atol=0)
    with tmx.autograd.record():
        tblk(x)
    assert len(calls) == 1
    fused_mode("auto")  # a CPU tensor under "auto": the children
    with tmx.autograd.record():
        tblk(x)
    assert len(calls) == 1
    fused_mode("off")
    with tmx.autograd.record():
        tblk(x)
    assert len(calls) == 1
    fused_mode("on")
    seen = []
    handle = tblk[0].register_forward_hook(lambda *a: seen.append(1))
    with tmx.autograd.record():
        tblk(x)
    handle.remove()
    assert len(calls) == 1 and seen == [1]
    fused_mode("bogus")
    with pytest.raises(MXNetError, match="fused_conv_bn"), \
            tmx.autograd.record():
        tblk(x)


def test_block_level_fused_matches_unfused(fused_mode):
    """Oracle: tests/test_fused_conv_bwd.py:93 (BasicBlockV1, fused vs
    child by child), in the port."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BasicBlockV1
    blk = BasicBlockV1(16, 1, False, 16, device="cpu")
    blk.initialize(seed=0)
    xv = onp.random.RandomState(5).randn(2, 16, 10, 10).astype("float32")
    out = {}
    for mode in ("off", "on"):
        fused_mode(mode)
        x = torch.from_numpy(xv).requires_grad_(True)
        with tmx.autograd.record():
            o = blk(x)
            loss = (o * o).sum()
        tmx.autograd.backward(loss)
        out[mode] = (o.detach(), x.grad.clone(), {
            k: p.grad().clone() for k, p in blk.collect_params().items()
            if p.grad_req != "null"})
    torch.testing.assert_close(out["on"][0], out["off"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out["on"][1], out["off"][1], rtol=1e-3,
                               atol=1e-3)
    for k, g in out["off"][2].items():
        torch.testing.assert_close(out["on"][2][k], g, rtol=2e-3, atol=2e-3,
                                   msg=k)


def test_small_fused_net_trains(fused_mode):
    """Oracle: tests/test_fused_conv_bwd.py:196, in the port."""
    fused_mode("on")
    tmx.random.seed(0)
    net = tnn.FusableSequential()
    for _ in range(2):
        net.add(tnn.Conv2D(8, 3, padding=1, use_bias=False, device="cpu"),
                tnn.BatchNorm(device="cpu"), tnn.Activation("relu"))
    net.add(tnn.GlobalAvgPool2D(), tnn.Dense(3, device="cpu"))
    net.initialize()
    rs = onp.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(size=(4, 8, 8, 8)).astype("float32"))
    y = torch.from_numpy(onp.arange(4) % 3)
    net(x)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(6):
        with tmx.autograd.record():
            loss = loss_fn(net(x), y)
        tmx.autograd.backward(loss)
        tr.step(4)
        losses.append(loss.mean().item())
    assert onp.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_wrapper_checks_shapes_and_devices():
    x, w, gamma, beta, da = _inputs((2, 4, 4, 3), seed=1, o=5)
    tx, tw = _nchw(x), _oihw(w)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, y, mean, var = tcb.conv3x3_bn_relu_ref(tx, tw, tg, tb)
    tda = _nchw(da)
    with pytest.raises(MXNetError, match="3x3"):
        tcb.fused_conv3x3_bn_relu_bwd(tda, tx, y, tw[:, :, :2], tg, tb,
                                      mean, var)
    with pytest.raises(MXNetError, match="shape mismatch"):
        tcb.fused_conv3x3_bn_relu_bwd(tda[:1], tx, y, tw, tg, tb, mean, var)
    with pytest.raises(MXNetError, match="gamma"):
        tcb.fused_conv3x3_bn_relu_bwd(tda, tx, y, tw, tg[:2], tb, mean, var)
    # a tensor off the CPU goes to the kernel's checks, never the plain
    # version
    meta = [t.to("meta") for t in (tda, tx, y, tw, tg, tb, mean, var)]
    with pytest.raises(MXNetError, match="unsupported device"):
        tcb.fused_conv3x3_bn_relu_bwd(*meta)


def test_fits_card_and_eligible(monkeypatch):
    assert tcb.eligible((3, 3), (1, 1), (1, 1), (1, 1), 1, False)
    assert not tcb.eligible((3, 3), (2, 2), (1, 1), (1, 1), 1, False)
    assert not tcb.eligible((3, 3), (1, 1), (1, 1), (1, 1), 1, True)
    # an H100 SXM's 132 SMs, read from the tensor's card in the port
    monkeypatch.setattr(tcb, "_sm_count", lambda index: 132)
    assert tcb.fits_card(torch.empty(32, 64, 56, 56, device="meta"), 64)
    assert not tcb.fits_card(torch.empty(2 ** 16, 64, 64, 64,
                                         device="meta"), 64)
    for shape in ((32, 56, 56, 64, 64), (32, 7, 7, 512, 512),
                  (3, 7, 9, 5, 11)):
        splits, rows = tcb.wgrad_splits(*shape, 132)
        m = shape[0] * shape[1] * shape[2]
        # a run is a whole number of wgrad's chunks (a patch of the image,
        # or _PIXELS consecutive pixels)
        pr, pc = tcb.wgrad_patch(shape[1], shape[2])
        step = pr * pc or tcb._PIXELS
        assert rows % step == 0 and (splits - 1) * rows < m <= splits * rows


@pytest.mark.parametrize("shape", [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                                   (32, 14, 14, 256, 256), (32, 7, 7, 512, 512),
                                   (5, 13, 11, 40, 24), (2, 9, 1, 3, 2),
                                   (3, 7, 9, 5, 11), (8, 14, 14, 64, 2048)])
def test_dgrad_splits_cover_every_chunk(shape):
    """dgrad's runs of output-channel chunks: none empty, all of them
    covered, none over _DG_RUN chunks, and more than one only where the
    tiles give fewer than about two blocks an SM of an H100 SXM (132 SMs)
    or the chunks exceed one run."""
    n, h, w, c, o = shape
    dsplits, cps = tcb.dgrad_splits(*shape, 132)
    chunks = -(-o // tcb._CHUNK)
    assert (dsplits - 1) * cps < chunks <= dsplits * cps
    assert cps <= tcb._DG_RUN
    tiles = -(-n * (h + 1) * (w + 1) // tcb._ROWS) * -(-c // tcb._COLS)
    assert dsplits == 1 or tiles * dsplits <= 2 * 132 or chunks > tcb._DG_RUN


def test_wgrad_patch_and_shared_memory(monkeypatch):
    """wgrad's chunk at ResNet-50's stages (8 x 8 and 4 x 14 patches at 56
    and 28, 64 consecutive pixels at 14 and 7) and the shared memory both
    kernels ask for, within the card's 227 KB for linear chunks up to W =
    99 and for patches beyond (128 x 128 takes 8 x 8 patches)."""
    assert tcb.wgrad_patch(56, 56) == (8, 8)
    assert tcb.wgrad_patch(28, 28) == (4, 14)
    assert tcb.wgrad_patch(14, 14) == (0, 0)
    assert tcb.wgrad_patch(7, 7) == (0, 0)
    assert tcb.wgrad_patch(13, 11) == (0, 0)
    for h, w in ((56, 56), (28, 28), (14, 14), (7, 7), (1, 1), (9, 1),
                 (1, 99), (99, 99)):
        assert max(tcb.smem_bytes(h, w)) <= tcb._SMEM_MAX, (h, w)
    assert max(tcb.smem_bytes(100, 100)) > tcb._SMEM_MAX
    monkeypatch.setattr(tcb, "_sm_count", lambda index: 132)
    assert tcb.fits_card(torch.empty(2, 8, 99, 99, device="meta"), 8)
    assert tcb.wgrad_patch(128, 128) == (8, 8)
    assert tcb.fits_card(torch.empty(2, 8, 128, 128, device="meta"), 8)
    assert tcb.wgrad_patch(101, 101) == (0, 0)
    assert not tcb.fits_card(torch.empty(2, 8, 101, 101, device="meta"), 8)


# -- bf16 (the reference at bf16: pallas_conv_bwd.py:61-95, 153-163) ----------

BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10


def _bf16_close(got, want, share=BF16_ATOL_SHARE, err_msg=""):
    """bf16 results: one bf16 ulp (rtol 2^-7) plus ``share`` of max|want|
    (a sum in another order may round to the other bf16 neighbour)."""
    got = onp.asarray(got, "float32")
    want = onp.asarray(want, "float32")
    allow = BF16_RTOL * onp.abs(want) + share * onp.abs(want).max()
    excess = (onp.abs(got - want) / allow).max()
    assert excess <= 1.0, (err_msg, excess)


def _bf16_inputs(shape, seed, o=None):
    """``_inputs`` rounded to bf16 (numpy fp32 holding bf16 values), and
    the JAX bf16 forward's y, mean and var."""
    x, w, gamma, beta, da = (onp.asarray(jnp.asarray(a, jnp.bfloat16)
                                         .astype(jnp.float32))
                             for a in _inputs(shape, seed, o))
    return x, w, gamma, beta, da


def _t16(a):
    return torch.from_numpy(onp.ascontiguousarray(a)).to(torch.bfloat16)


def _j16(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("shape,o", [((4, 8, 8, 16), None),
                                     ((2, 4, 4, 128), None),
                                     ((3, 7, 9, 5), 11)])
def test_plain_bwd_bf16_matches_pallas_kernel_and_jax_vjp(shape, o):
    """bf16 x, w, gamma, beta and da: the port's plain version (dy rounded
    to bf16, fp32 sums of bf16 products, dx and dw in bf16) against the
    Pallas kernel in interpret mode within one bf16 ulp plus 2^-10 of the
    largest |value| (the same roundings; only the fp32 sums' order
    differs), dgamma and dbeta likewise; and against ``jax.vjp`` of
    ``fused_cbr_train`` (the Pallas kernel behind a custom VJP) the same.
    Output dtypes as the reference's."""
    x, w, gamma, beta, da = _bf16_inputs(shape, sum(shape), o)
    jx, jw, jg, jb, jda = map(_j16, (x, w, gamma, beta, da))
    _, jy, jmean, jvar = jcb.conv3x3_bn_relu_ref(jx, jw, jg, jb)
    want = jcb.fused_conv3x3_bn_relu_bwd(jda, jx, jy, jw, jg, jb, jmean, jvar,
                                         interpret=True)
    (_, m_, v_), vjp = jax.vjp(lambda *a: jcb.fused_cbr_train(*a, 1e-5, True),
                               jx, jw, jg, jb)
    want_vjp = vjp((jda, jnp.zeros_like(m_), jnp.zeros_like(v_)))

    tx = _t16(x.transpose(0, 3, 1, 2))
    tw = _t16(w.transpose(3, 2, 0, 1))
    tg, tb = _t16(gamma), _t16(beta)
    # y, mean and var from the JAX forward, so that both backwards start
    # from the same values
    ty = _t16(onp.asarray(jy.astype(jnp.float32)).transpose(0, 3, 1, 2))
    tmean = torch.from_numpy(onp.asarray(jmean))
    tvar = torch.from_numpy(onp.asarray(jvar))
    before = tcb.fused_conv3x3_bn_relu_bwd.launches
    got = tcb.fused_conv3x3_bn_relu_bwd(_t16(da.transpose(0, 3, 1, 2)), tx,
                                        ty, tw, tg, tb, tmean, tvar)
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before  # CPU: plain
    got = [got[0].float().numpy().transpose(0, 2, 3, 1),
           got[1].float().numpy().transpose(2, 3, 1, 0),
           got[2].float().numpy(), got[3].float().numpy()]
    for ref_set in (want, want_vjp):
        for name, g, ref in zip(("dx", "dw", "dgamma", "dbeta"), got,
                                ref_set):
            assert str(ref.dtype) == "bfloat16", name
            _bf16_close(g, onp.asarray(ref.astype(jnp.float32)),
                        err_msg=name)


def test_plain_bwd_bf16_rounds_dy_where_the_reference_does():
    """The plain version's dy is rounded to bf16 before the products: its
    dx equals the fp32 plain dx of the bf16-rounded dy, not of the fp32
    dy."""
    x, w, gamma, beta, da = _bf16_inputs((2, 5, 5, 8), 3)
    tx, tw = _t16(x.transpose(0, 3, 1, 2)), _t16(w.transpose(3, 2, 0, 1))
    tg, tb = _t16(gamma), _t16(beta)
    tda = _t16(da.transpose(0, 3, 1, 2))
    _, y, mean, var = tcb.conv3x3_bn_relu_ref(tx, tw, tg, tb)
    _, _, vec = tcb.bwd_stats(tda, y, tg, tb, mean, var)
    dx, dw = tcb.fused_conv3x3_bn_relu_bwd_plain(tda, tx, y, tw, vec)
    assert dx.dtype == dw.dtype == torch.bfloat16
    # the same function in fp32 on the bf16 values, dy rounded by hand
    dy = tcb._dy(tda, y, vec)
    assert dy.dtype == torch.bfloat16
    dx32 = torch.nn.grad.conv2d_input(tx.shape, tw.float(), dy.float(),
                                      padding=1)
    dw32 = torch.nn.grad.conv2d_weight(tx.float(), tw.shape, dy.float(),
                                       padding=1)
    _bf16_close(dx.float().numpy(), dx32.numpy(), share=1e-5)
    _bf16_close(dw.float().numpy(), dw32.numpy(), share=1e-5)


def test_wrapper_routes_by_dtype_before_any_launch():
    """x, da, y and w of one dtype: an fp32 x with a bf16 w (or da) raises
    before any launch, on the CPU as on the card; fp64 (the CPU's
    gradcheck) and bf16 take the plain version on the CPU."""
    x, w, gamma, beta, da = _inputs((2, 4, 4, 3), seed=1, o=5)
    tx, tw = _nchw(x), _oihw(w)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, y, mean, var = tcb.conv3x3_bn_relu_ref(tx, tw, tg, tb)
    tda = _nchw(da)
    before = tcb.fused_conv3x3_bn_relu_bwd.launches
    for args in ((tda, tx, y, tw.bfloat16()), (tda.bfloat16(), tx, y, tw),
                 (tda.bfloat16(), tx.bfloat16(), y, tw.bfloat16())):
        with pytest.raises(MXNetError, match="one dtype"):
            tcb.fused_conv3x3_bn_relu_bwd(*args, tg, tb, mean, var)
    meta = [t.to("meta") for t in (tda, tx, y, tw, tg, tb, mean, var)]
    meta[3] = meta[3].bfloat16()
    with pytest.raises(MXNetError, match="one dtype"):
        tcb.fused_conv3x3_bn_relu_bwd(*meta)
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before
    out = tcb.fused_conv3x3_bn_relu_bwd(tda.bfloat16(), tx.bfloat16(),
                                        y.bfloat16(), tw.bfloat16(), tg, tb,
                                        mean, var)
    assert out[0].dtype == out[1].dtype == torch.bfloat16
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before


def test_bf16_shared_memory_and_splits():
    """The bf16 kernels' shared memory (smaller than fp32's at every
    shape, so fits_card's rule covers them) and dgrad's runs of 16-channel
    chunks."""
    for h, w in ((56, 56), (28, 28), (14, 14), (7, 7), (1, 1), (99, 99),
                 (128, 128)):
        d16, w16 = tcb.smem_bytes(h, w, torch.bfloat16)
        d32, w32 = tcb.smem_bytes(h, w)
        assert d16 < d32 and w16 < w32, (h, w)
    assert tcb.smem_bytes(56, 56, torch.bfloat16) == (46096, 14100)
    for shape in ((32, 7, 7, 512, 512), (4, 7, 7, 36, 520),
                  (32, 56, 56, 64, 64)):
        dsplits, cps = tcb.dgrad_splits(*shape, 132, tcb._CHUNK_BF16)
        chunks = -(-shape[4] // tcb._CHUNK_BF16)
        assert (dsplits - 1) * cps < chunks <= dsplits * cps
        assert cps <= tcb._DG_RUN


@pytest.mark.parametrize("mode", ["on", "off"])
def test_fused_route_under_amp_runs_the_triplet_in_bf16(fused_mode, mode):
    """Under amp.init the reference's fused_conv_bn_relu casts x, w, gamma
    and beta to bf16 (a target op) although x arrives in fp32, and the
    child-by-child route runs conv in bf16, BatchNorm in fp32: the output
    dtype, the value and the fp32 master gradients as the JAX package's;
    "auto" decides on the dtype after the policy."""
    from mxnet_tpu import amp as jamp
    jblk, tblk, xv = _triplet_pair(seed=2)
    fused_mode(mode)
    jamp.init("bfloat16")
    tmx.amp.init("bfloat16")
    try:
        assert tmx.amp._op_cast_dtype("fused_conv_bn_relu") == torch.bfloat16
        with mx.autograd.record():
            jout = jblk(mx.np.array(xv))
            jloss = (jout.astype("float32") ** 2).sum()
        jloss.backward()
        with tmx.autograd.record():
            tout = tblk(torch.from_numpy(xv))
            tloss = (tout.float() ** 2).sum()
        tmx.autograd.backward(tloss)
    finally:
        jamp._deactivate()
        tmx.amp._deactivate()
    want = "bfloat16" if mode == "on" else "float32"
    assert str(jout.dtype) == want
    assert tout.dtype == getattr(torch, want)
    _bf16_close(tout.detach().float().numpy(),
                onp.asarray(jout.astype("float32").asnumpy()), share=2e-2)
    for name, p in tblk.collect_params().items():
        if p.grad_req == "null":
            continue
        assert p.grad().dtype == torch.float32, name
        ref = jblk.collect_params()[name].grad().asnumpy()
        assert onp.abs(p.grad().numpy() - ref).max() \
            <= 3e-2 * onp.abs(ref).max(), name
