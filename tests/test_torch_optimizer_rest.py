"""Port parity: every optimizer the reference registers beyond SGD, Adam
and AdamW, and ``GroupAdaGrad``.

Each case runs 5 updates of two (5, 3) weights (the second with lr_mult
0.5 and wd_mult 3) by the optimizers directly, in the JAX package and the
port, from the same seeded numpy weights and gradients, over the cases'
momentum, wd, clip_gradient, rescale_grad, lr_scheduler and bf16
``multi_precision`` settings; the weights are held at rtol 2e-5, atol
2e-6 (fp32 through two op orders; bf16: the fp32 masters at that
tolerance and the bf16 weights within one bf16 ulp). SGLD draws its noise
from an RNG whose streams cannot match: both packages are given the same
noise arrays. The four optimizers of the fused families (NAG: "sgd";
Adamax, AdaBelief, Nadam: "adam") are held bit for bit, fused Trainer
against per-parameter Updater, and against the JAX Trainer. The reference's
pickled ``(states, optimizer)`` tuple loads into the port's Updater.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(2)

STEPS = 5
RTOL, ATOL = 2e-5, 2e-6

BASE = {
    "test": {},
    "nag": {"learning_rate": 0.1},
    "signum": {"learning_rate": 0.01},
    "sgld": {"learning_rate": 0.01},
    "adamax": {},
    "ftml": {},
    "adabelief": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "adagrad": {"learning_rate": 0.1},
    "adadelta": {},
    "rmsprop": {"learning_rate": 0.01},
    "ftrl": {},
    "lamb": {"learning_rate": 0.01},
    "lans": {"learning_rate": 0.01},
    "lars": {"learning_rate": 0.1},
    "dcasgd": {"learning_rate": 0.1},
    "groupadagrad": {"learning_rate": 0.1},
}
#: the momentum knob of each optimizer that has one
MOMENTUM = {"nag": 0.9, "signum": 0.5, "rmsprop": 0.8, "lars": 0.9,
            "dcasgd": 0.9}
VARIANTS = {
    "plain": {},
    "wd": {"wd": 0.01},
    "clip": {"clip_gradient": 0.5},
    "rescale": {"rescale_grad": 0.5},
    "sched": {"scheduler": True},
    "bf16": {"multi_precision": True},
}
EXTRA = {
    "signum_wdlh": ("signum", {"learning_rate": 0.01, "wd_lh": 0.1}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True}),
    "rmsprop_clip_weights": ("rmsprop", {"learning_rate": 0.01,
                                         "clip_weights": 0.6}),
    "lamb_bounds": ("lamb", {"learning_rate": 0.01, "lower_bound": 0.5,
                             "upper_bound": 2.0}),
    "lamb_no_bias_correction": ("lamb", {"learning_rate": 0.01,
                                         "bias_correction": False}),
    "ftrl_l1": ("ftrl", {"lamda1": 0.5, "beta": 0.5}),
    "lazy_update": ("adamax", {"lazy_update": True}),
}


def _cases():
    out = {}
    for name in BASE:
        for var, kw in VARIANTS.items():
            if name == "groupadagrad" and var == "wd":
                continue  # the reference raises for weight decay too
            out[f"{name}_{var}"] = (name, {**BASE[name], **kw})
        if name in MOMENTUM:
            out[f"{name}_momentum"] = (name, {**BASE[name], "wd": 0.01,
                                              "momentum": MOMENTUM[name]})
    out.update(EXTRA)
    return out


CASES = _cases()


def _hyper(kw, sched):
    kw = dict(kw)
    if kw.pop("scheduler", False):
        kw["lr_scheduler"] = sched.FactorScheduler(step=2, factor=0.5)
    return kw


def _data(case):
    rs = onp.random.RandomState(sum(map(ord, case)))
    ws = [rs.randn(5, 3).astype("float32") for _ in range(2)]
    gs = [[rs.randn(5, 3).astype("float32") for _ in range(2)]
          for _ in range(STEPS)]
    noise = [[rs.randn(5, 3).astype("float32") for _ in range(2)]
             for _ in range(STEPS)]
    return ws, gs, noise


def _bf16_np(a):
    return onp.asarray(a.asnumpy(), dtype="float32")


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case, monkeypatch):
    name, kw = CASES[case]
    ws, gs, noise = _data(case)
    jo = jopt.create(name, **_hyper(kw, jsched))
    to = topt.create(name, **_hyper(kw, tsched))
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({1: 3.0})
    bf16 = kw.get("multi_precision", False)
    if bf16:
        jw = [mx.np.array(w, dtype="bfloat16") for w in ws]
        tw = [torch.from_numpy(w).to(torch.bfloat16) for w in ws]
    else:
        jw = [mx.np.array(w) for w in ws]
        tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    if name == "sgld":
        flat = iter([n for step in noise for n in step])
        monkeypatch.setattr(
            jax.random, "normal",
            lambda key, shape, dtype: jnp.asarray(next(flat), dtype))
        tflat = iter([n for step in noise for n in step])
        to._noise = lambda w: torch.from_numpy(next(tflat)).to(w.dtype)
    for step in gs:
        for i in range(2):
            jo.update_multi_precision(i, jw[i], mx.np.array(step[i]), js[i])
            to.update_multi_precision(i, tw[i], torch.from_numpy(step[i]),
                                      ts[i])
    for i in range(2):
        if bf16:
            onp.testing.assert_allclose(ts[i][0].numpy(),
                                        js[i][0].asnumpy(), rtol=RTOL,
                                        atol=ATOL)
            onp.testing.assert_allclose(tw[i].float().numpy(),
                                        _bf16_np(jw[i]), rtol=2 ** -7,
                                        atol=0)
        else:
            onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                        rtol=RTOL, atol=ATOL)
    assert to.num_update == jo.num_update == STEPS


def test_every_reference_optimizer_is_registered():
    want = set(jopt.optimizer._registry.list())
    assert want == set(topt.optimizer._registry), want
    assert len(want) == 20
    for name in want:
        kw = {"momentum": 0.9} if name in MOMENTUM else {}
        assert type(topt.create(name, **kw)).__name__.lower() == name


def test_group_adagrad_refuses_wd_and_non_matrix():
    o = topt.create("groupadagrad", wd=0.1)
    w = torch.ones(4, 2)
    with pytest.raises(MXNetError):
        o.update(0, w, torch.ones(4, 2), o.create_state(0, w))
    with pytest.raises(MXNetError):
        o.create_state(0, torch.ones(3))


# -- the fused families: fused Trainer against the per-parameter Updater ----

FUSED = {
    "nag": {"learning_rate": 0.1},
    "nag_momentum": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
                     "clip_gradient": 0.5},
    "adamax": {"wd": 0.01},
    "adamax_clip": {"clip_gradient": 0.5, "rescale_grad": 0.5},
    "adabelief": {"learning_rate": 0.01, "wd": 0.01},
    "nadam": {"learning_rate": 0.01, "wd": 0.01, "scheduler": True},
}


def _port_net(seed=0):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="tanh", in_units=8, device="cpu"),
            tnn.Dense(4, in_units=16, device="cpu"))
    net.initialize(seed=seed)
    return net


def _grads(params, step):
    rs = onp.random.RandomState(100 + step)
    return {n: rs.randn(*p.shape).astype("float32")
            for n, p in params.items()}


def _multipliers(params):
    names = list(params)
    params[names[0]].lr_mult = 0.5
    params[names[-1]].wd_mult = 3.0


def _set_port_grads(params, grads):
    for n, p in params.items():
        p.data().grad = torch.from_numpy(grads[n].copy())


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_family_bit_for_bit(case):
    """The fused update of NAG, Adamax, AdaBelief and Nadam runs their own
    rule (not SGD's or Adam's): 5 steps bit for bit with the per-parameter
    Updater, weights and every state tensor."""
    name = case.split("_")[0]
    fused, plain = _port_net(), _port_net()
    fp, pp = fused.collect_params(), plain.collect_params()
    _multipliers(fp)
    _multipliers(pp)
    ftr = tmx.gluon.Trainer(fp, name, _hyper(FUSED[case], tsched))
    ptr = tmx.gluon.Trainer(pp, name, _hyper(FUSED[case], tsched))
    ptr._fused_update = False
    for step in range(STEPS):
        grads = _grads(fp, step)
        _set_port_grads(fp, grads)
        _set_port_grads(pp, grads)
        ftr.step(2)
        ptr.step(2)
        assert ftr._fused_update, "the fused update did not apply"
        for n in fp:
            assert torch.equal(fp[n].data(), pp[n].data()), (step, n)
        for i, s in ftr._updater.states.items():
            t = ptr._updater.states[i]
            for a, b in zip(s if isinstance(s, tuple) else (s,),
                            t if isinstance(t, tuple) else (t,)):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_family_matches_jax_trainer(case):
    """The same 5 steps through the JAX package's Trainer (its
    ``_FusedUpdate`` of ``type(opt)._rule``): weights at atol 1e-6."""
    name = case.split("_")[0]
    tnet = _port_net(1)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="tanh", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    arrays = tfunctional.param_arrays(tnet)
    for n, p in jnet.collect_params().items():
        p.set_data(mx.np.array(arrays[n]))
    tp, jp = tnet.collect_params(), jnet.collect_params()
    _multipliers(tp)
    _multipliers(jp)
    ttr = tmx.gluon.Trainer(tp, name, _hyper(FUSED[case], tsched))
    jtr = mx.gluon.Trainer(jp, name, _hyper(FUSED[case], jsched))
    for step in range(STEPS):
        grads = _grads(tp, step)
        _set_port_grads(tp, grads)
        for n, p in jp.items():
            p.grad()._rebind(mx.np.array(grads[n])._data)
        ttr.step(2)
        jtr.step(2)
        ref = jfunctional.param_arrays(jnet)
        for n, w in tfunctional.param_arrays(tnet).items():
            onp.testing.assert_allclose(w, onp.asarray(ref[n]), atol=1e-6,
                                        rtol=0, err_msg=f"{n} step {step}")
    assert ttr._fused_update and jtr._fused_update


@pytest.mark.parametrize("name", ["adamax", "lamb", "rmsprop"])
def test_updater_loads_the_reference_pickle(name):
    """The JAX package's ``get_states(dump_optimizer=True)`` after 2
    updates loads into the port's Updater (the optimizer as the port's
    class of the same name); 3 more updates then match the reference's."""
    ws, gs, _ = _data(name)
    jo = jopt.create(name, learning_rate=0.01)
    jup = jopt.get_updater(jo)
    jw = [mx.np.array(w) for w in ws]
    for step in gs[:2]:
        for i in range(2):
            jup(i, mx.np.array(step[i]), jw[i])
    blob = jup.get_states(dump_optimizer=True)
    assert isinstance(pickle.loads(blob), tuple)
    tw = [torch.from_numpy(w.asnumpy().copy()) for w in jw]
    tup = topt.get_updater(topt.create("sgd"))
    tup.set_states(blob, dict(enumerate(tw)))
    assert type(tup.optimizer) is type(topt.create(name))
    assert tup.optimizer.num_update == 2
    for step in gs[2:]:
        for i in range(2):
            jup(i, mx.np.array(step[i]), jw[i])
            tup(i, torch.from_numpy(step[i]), tw[i])
    for i in range(2):
        onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                    rtol=RTOL, atol=ATOL)
