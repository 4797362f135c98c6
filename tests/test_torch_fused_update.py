"""Port parity: the Trainer's fused multi-tensor update (``_FusedUpdate``).

``gluon.Trainer`` updates every parameter together through
``torch._foreach_*`` ops where the reference's ``_FusedUpdate.applicable()``
holds (SGD, Adam, AdamW with ``multi_precision`` off), else one
``Updater`` call each. Held here: the fused update against the port's
per-parameter rule on the same gradients, bit for bit (the same ops in the
same order; on the CPU ``torch._foreach_*`` runs them tensor by tensor);
against the JAX package's Trainer (its own jitted ``_FusedUpdate``) over
five steps of the same gradients at ``test_torch_gpt_train.py::
test_update_rules_match_jax``'s tolerance (atol 1e-6); where it applies;
and the optimizer state's round trips after fused steps.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu import lr_scheduler as jsched

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(2)

STEPS = 5

CASES = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "sgd_wd_clip1": ("sgd", {"learning_rate": 0.1, "wd": 0.01,
                             "clip_gradient": 1.0}),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 0.01}),
    "sgd_momentum_clip0": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                   "clip_gradient": 0.0}),
    "sgd_momentum_clipneg": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                     "clip_gradient": -1.0}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    "adam_clip1": ("adam", {"learning_rate": 0.01, "wd": 0.01,
                            "clip_gradient": 1.0, "rescale_grad": 0.5}),
    "adam_clip0": ("adam", {"learning_rate": 0.01, "clip_gradient": 0.0}),
    "adamw": ("adamw", {"learning_rate": 0.01, "wd": 0.1}),
    "adamw_clip1": ("adamw", {"learning_rate": 0.01, "wd": 0.1,
                              "clip_gradient": 1.0}),
    "adamw_clipneg": ("adamw", {"learning_rate": 0.01, "wd": 0.1,
                                "clip_gradient": -1.0}),
    "adam_scheduler": ("adam", {"learning_rate": 0.01, "wd": 0.01,
                                "scheduler": True}),
    "sgd_momentum_scheduler": ("sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9, "scheduler": True}),
}


def _hyper(case, pkg):
    name, kw = CASES[case]
    kw = dict(kw)
    if kw.pop("scheduler", False):
        kw["lr_scheduler"] = pkg.FactorScheduler(step=2, factor=0.5)
    return name, kw


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
    """lr_mult / wd_mult on two parameters, so the update has more than one
    (lr, wd) group."""
    names = list(params)
    params[names[0]].lr_mult = 0.5
    params[names[-1]].wd_mult = 3.0


def _set_port_grads(params, grads):
    for n, p in params.items():
        p.data().grad = torch.from_numpy(grads[n].copy()).to(p.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_per_parameter_rule(case):
    """Five steps of the same gradients through a fused Trainer and one
    held to the per-parameter ``Updater``: weights and every state tensor
    equal bit for bit after each step."""
    name, kw = _hyper(case, tsched)
    fused, plain = _port_net(), _port_net()
    fp, pp = fused.collect_params(), plain.collect_params()
    _multipliers(fp)
    _multipliers(pp)
    ftr = tmx.gluon.Trainer(fp, name, dict(kw))
    _, kw2 = _hyper(case, tsched)
    ptr = tmx.gluon.Trainer(pp, name, kw2)
    ptr._fused_update = False  # the per-parameter rule
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
    assert ftr.optimizer._index_update_count == \
        ptr.optimizer._index_update_count


def _jax_net(tnet):
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="tanh", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    arrays = tfunctional.param_arrays(tnet)
    for n, p in jnet.collect_params().items():
        p.set_data(mx.np.array(arrays[n]))
    return jnet


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_jax_trainer(case):
    """Five steps of the same gradients through the port's Trainer (fused)
    and the JAX package's (its jitted ``_FusedUpdate``): weights within
    atol 1e-6 after every step."""
    tnet = _port_net(1)
    jnet = _jax_net(tnet)
    tp, jp = tnet.collect_params(), jnet.collect_params()
    assert list(tp) == list(jp)
    _multipliers(tp)
    _multipliers(jp)
    name, tkw = _hyper(case, tsched)
    _, jkw = _hyper(case, jsched)
    ttr = tmx.gluon.Trainer(tp, name, tkw)
    jtr = mx.gluon.Trainer(jp, name, jkw)
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


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("adam", {}), ("adamw", {}),
    ("sgd", {"multi_precision": True}), ("adam", {"multi_precision": True}),
    ("adamw", {"multi_precision": True})])
def test_fused_applies_where_the_reference_does(name, kw):
    """The fused update applies exactly where the JAX Trainer's does: the
    "sgd" and "adam" families with ``multi_precision`` off."""
    tnet = _port_net(2)
    jnet = _jax_net(tnet)
    ttr = tmx.gluon.Trainer(tnet.collect_params(), name, dict(kw))
    jtr = mx.gluon.Trainer(jnet.collect_params(), name, dict(kw))
    _set_port_grads(tnet.collect_params(), _grads(tnet.collect_params(), 0))
    with mx.autograd.record():
        jnet(mx.np.ones((2, 8))).sum().backward()
    ttr.step(1)
    jtr.step(1)
    assert bool(ttr._fused_update) == bool(jtr._fused_update) \
        == (not kw.get("multi_precision"))


def test_multi_precision_takes_the_per_parameter_path():
    """bf16 weights with ``multi_precision``: the per-parameter Updater
    keeps fp32 masters (the fused update would have none)."""
    net = _port_net(3).cast("bfloat16")
    params = net.collect_params()
    tr = tmx.gluon.Trainer(params, "adamw", {"learning_rate": 0.01,
                                             "multi_precision": True})
    for step in range(2):
        _set_port_grads(params, _grads(params, step))
        tr.step(2)
    assert tr._fused_update is False
    masters = {s[0].dtype for s in tr._updater.states.values()}
    assert masters == {torch.float32}
    for i, p in enumerate(params.values()):
        assert torch.equal(p.data(), tr._updater.states[i][0].to(
            torch.bfloat16))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_states_round_trip_after_fused_steps(name, tmp_path):
    """After fused steps, ``save_states`` / ``load_states``,
    ``state_dict`` / ``load_state_dict`` and ``load_states_by_name`` give
    a trainer whose next steps equal the uninterrupted one's bit for
    bit."""
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if name == "sgd":
        kw["momentum"] = 0.9
    ref_net = _port_net(4)
    ref = tmx.gluon.Trainer(ref_net.collect_params(), name, dict(kw))
    for step in range(2):
        _set_port_grads(ref_net.collect_params(),
                        _grads(ref_net.collect_params(), step))
        ref.step(2)
    path = str(tmp_path / "states")
    ref.save_states(path)
    blob = ref.state_dict()
    names = list(ref_net.collect_params())
    by_name = {names[i]: tuple(t.numpy().copy() for t in s)
               if isinstance(s, tuple) else s.numpy().copy()
               for i, s in ref._updater.states.items()}
    counts = {names[i]: c for i, c in
              ref.optimizer._index_update_count.items()}
    resumed = []
    for how in ("load_states", "load_state_dict", "load_states_by_name"):
        net = _port_net(5)
        tfunctional.load_params(net, tfunctional.param_arrays(ref_net))
        tr = tmx.gluon.Trainer(net.collect_params(), name, dict(kw))
        if how == "load_states":
            tr.load_states(path)
        elif how == "load_state_dict":
            tr.load_state_dict(blob)
        else:
            tr.load_states_by_name(by_name, counts)
        resumed.append((net, tr))
    for step in range(2, 4):
        grads = _grads(ref_net.collect_params(), step)
        for net, tr in [(ref_net, ref)] + resumed:
            _set_port_grads(net.collect_params(), grads)
            tr.step(2)
            assert tr._fused_update
    want = tfunctional.param_arrays(ref_net)
    for net, _ in resumed:
        for n, w in tfunctional.param_arrays(net).items():
            onp.testing.assert_array_equal(w, want[n], err_msg=n)


def test_trainer_save_load_states_oracle(tmp_path):
    """``tests/test_optimizer.py::test_trainer_save_load_states`` on the
    port: an Adam step (fused), then save and load its states."""
    net = tnn.Dense(2, in_units=2, device="cpu")
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
    x = torch.ones((1, 2))
    with tmx.autograd.record():
        y = net(x).sum()
    tmx.autograd.backward(y)
    trainer.step(1)
    assert trainer._fused_update
    path = str(tmp_path / "trainer.states")
    trainer.save_states(path)
    trainer.load_states(path)
    assert trainer._fused_update is None  # rebuilt against the restored one
    with tmx.autograd.record():
        y = net(x).sum()
    tmx.autograd.backward(y)
    trainer.step(1)
    assert trainer._fused_update
    assert set(trainer.optimizer._index_update_count.values()) == {2}
