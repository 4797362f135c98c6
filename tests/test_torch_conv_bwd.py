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
