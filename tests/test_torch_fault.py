"""Port parity: ``mx.fault`` and its injection sites, JAX package -> port.

The same specs go through both packages and are compared: the parser's
API and refusals, ``describe()``, the fire sequences of ``at=`` and of the
seeded ``prob=`` streams (bit for bit, every point of ``POINTS``), the
``serialization.torn_write`` site, and ``invoke.nan_output`` on the
reference's ``_mlp()`` (weights carried across by ``functional``): the
same step is skipped by the Trainer's non-finite guard, every parameter is
unchanged bit for bit, ``fault.stats()`` is the same, and the next step
moves the weights as the reference's does. Under ``hybridize()`` the probe
is consumed on the run that makes a signature and corrupts nothing, as the
reference's tracer check leaves a traced call clean.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional

torch.set_num_threads(2)

PKGS = {"jax": mx, "torch": tmx}


def planes_off(pkg):
    pkg.profiler.set_state("stop")
    pkg.profiler._events.clear()
    pkg.telemetry.disable()
    pkg.telemetry.reset()
    pkg.trace.disable()
    pkg.trace.clear()
    pkg.fault.clear()
    pkg.fault.reset_stats()
    pkg.insight.disable()
    pkg.insight.reset()
    pkg.goodput.disable()
    pkg.goodput.reset()
    pkg.blackbox.disable()
    pkg.config.reset()


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in PKGS.values():
        planes_off(pkg)
    with tmx.cpu():
        yield
    for pkg in PKGS.values():
        planes_off(pkg)


def _mlp_pair(seed=0, classes=3):
    mx.random.seed(seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(32, activation="relu"),
             mx.gluon.nn.Dense(classes))
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.ones((1, 16)))
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(32, activation="relu"),
             tmx.gluon.nn.Dense(classes))
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return {"jax": jnet, "torch": tnet}


def _params(net):
    return {k: v.data().asnumpy().copy() if hasattr(v.data(), "asnumpy")
            else v.data().detach().numpy().copy()
            for k, v in net.collect_params().items()}


def test_points_are_the_reference_points():
    assert tmx.fault.POINTS == mx.fault.POINTS


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_spec_parse_api_and_refusals(pkg):
    f = PKGS[pkg].fault
    err = PKGS[pkg].base.MXNetError
    armed = f.configure(
        "invoke.nan_output:at=3,times=1;serialization.torn_write:prob=0.5")
    assert armed == ["invoke.nan_output", "serialization.torn_write"]
    assert f.active() and f.armed("invoke.nan_output")
    assert not f.armed("dataloader.worker_crash")
    assert "invoke.nan_output [at=3,times=1" in f.describe()
    f.clear()
    assert not f.active()
    with pytest.raises(err, match="unknown fault injection point"):
        f.configure("no.such.point:at=1")
    with pytest.raises(err, match="unknown key"):
        f.configure("invoke.nan_output:bogus=1")
    with pytest.raises(err, match="needs a trigger"):
        f.configure("invoke.nan_output")


def test_describe_matches_jax():
    spec = "invoke.nan_output:at=2,times=3;insight.drift:prob=0.25,seed=4"
    out = {}
    for name, pkg in PKGS.items():
        pkg.fault.configure(spec)
        for _ in range(5):
            pkg.fault.fire("invoke.nan_output")
            pkg.fault.fire("insight.drift")
        out[name] = (pkg.fault.describe(), pkg.fault.stats())
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("point", sorted(mx.fault.POINTS))
def test_fire_sequences_bit_for_bit(point):
    spec = f"{point}:prob=0.3,seed=11;" if point != "invoke.nan_output" \
        else f"{point}:at=5,prob=0.2,times=7,seed=2"
    seqs = {}
    for name, pkg in PKGS.items():
        pkg.fault.configure(spec)
        seqs[name] = ([pkg.fault.fire(point) for _ in range(200)],
                      [pkg.fault.fire(point, step=s) for s in range(50)],
                      pkg.fault.stats())
    assert seqs["torch"] == seqs["jax"]
    assert any(seqs["torch"][0]) and not all(seqs["torch"][0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fault_events_mirror_into_telemetry(pkg):
    p = PKGS[pkg]
    p.telemetry.enable()
    p.fault.configure("invoke.nan_output:at=1")
    p.fault.fire("invoke.nan_output")
    p.fault.record("trainer.nonfinite_skip", 2)
    assert p.telemetry.counters() == {
        'fault.events_total{event="injected.invoke.nan_output"}': 1,
        'fault.events_total{event="trainer.nonfinite_skip"}': 2}


def test_disabled_hooks_are_noops(tmp_path):
    assert not tmx.fault.active() and not tmx._hooks.on
    assert not tmx.fault.fire("invoke.nan_output")
    out = (tmx.np.ones((2, 2)) * 3).asnumpy()
    assert onp.isfinite(out).all()
    p = str(tmp_path / "x.bin")
    tmx.serialization.atomic_write_bytes(p, b"abcdef" * 100)
    assert os.path.getsize(p) == 600
    assert tmx.fault.stats() == {}


def test_nan_output_on_an_np_op_matches_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.fault.configure("invoke.nan_output:at=2,times=1")
        a = pkg.np.array(onp.arange(6, dtype="float32").reshape(2, 3))
        outs = [(a + 1).asnumpy(), (a * 2).asnumpy(), (a - 1).asnumpy(),
                pkg.np.argmax(a, axis=1).asnumpy()]
        got[name] = ([onp.isnan(o).all() for o in outs], pkg.fault.stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [False, True, False, False]


def _train(pkg, net, steps, fault_at_step=None, spec=None):
    pkg.config.set("trainer.skip_nonfinite", True)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    x = pkg.np.array(onp.random.RandomState(0).rand(4, 16)
                     .astype("float32"))
    y = pkg.np.array(onp.array([0, 1, 2, 0], dtype="int32"))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    snaps = []
    for i in range(steps):
        if i == fault_at_step:
            pkg.fault.configure(spec)
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        pkg.fault.clear()
        loss.backward()
        trainer.step(4)
        snaps.append((_params(net), trainer.nonfinite_steps))
    return snaps


def test_nan_output_skips_the_same_step_bit_for_bit():
    nets = _mlp_pair()
    runs = {}
    for name, pkg in PKGS.items():
        snaps = _train(pkg, nets[name], 3, fault_at_step=1,
                       spec="invoke.nan_output:at=1,times=1")
        runs[name] = (snaps, pkg.fault.stats())
    for name, (snaps, stats) in runs.items():
        assert [n for _, n in snaps] == [0, 1, 1], name
        for k in snaps[0][0]:
            onp.testing.assert_array_equal(snaps[1][0][k], snaps[0][0][k],
                                           err_msg=f"{name} {k} moved")
        assert any(not onp.array_equal(snaps[2][0][k], snaps[1][0][k])
                   for k in snaps[0][0])
        assert stats == {"injected.invoke.nan_output": 1,
                         "trainer.nonfinite_skip": 1}
    for step in (0, 2):
        for k, want in runs["jax"][0][step][0].items():
            onp.testing.assert_allclose(runs["torch"][0][step][0][k], want,
                                        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("at", [2, 3])
def test_nan_output_at_a_later_op_skips_as_jax(at):
    """``at=2`` hits the relu, ``at=3`` the second Dense: each poisons
    the step in both packages."""
    nets = _mlp_pair()
    out = {}
    for name, pkg in PKGS.items():
        snaps = _train(pkg, nets[name], 2, fault_at_step=1,
                       spec=f"invoke.nan_output:at={at},times=1")
        out[name] = ([n for _, n in snaps], pkg.fault.stats())
    assert out["torch"] == out["jax"] == (
        [0, 1], {"injected.invoke.nan_output": 1,
                 "trainer.nonfinite_skip": 1})


def test_hybridized_call_consumes_the_probe_without_corrupting():
    nets = _mlp_pair()
    got = {}
    for name, pkg in PKGS.items():
        net = nets[name]
        net.hybridize()
        pkg.fault.configure("invoke.nan_output:at=1,times=1")
        first = net(pkg.np.ones((4, 16))).asnumpy()
        second = net(pkg.np.ones((4, 16))).asnumpy()
        got[name] = (bool(onp.isfinite(first).all()),
                     bool(onp.isfinite(second).all()), pkg.fault.stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (True, True)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_torn_write_rejected_by_checksum(pkg, tmp_path):
    p_ = PKGS[pkg]
    net = _mlp_pair()[pkg]
    path = str(tmp_path / "w.params")
    net.save_parameters(path)
    p_.serialization.write_checksum(path)
    assert p_.serialization.verify_checksum(path) is True
    p_.fault.configure("serialization.torn_write:at=1,times=1")
    net.save_parameters(path)
    p_.fault.clear()
    assert p_.fault.stats()["injected.serialization.torn_write"] == 1
    with pytest.raises(p_.base.MXNetError, match="checksum mismatch"):
        p_.serialization.verify_checksum(path)
    with pytest.raises(p_.base.MXNetError, match="checksum mismatch"):
        net.load_parameters(path)


def test_log_stats_goes_through_the_port_logger(caplog):
    tmx.fault.record("trainer.nonfinite_skip")
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.fault"):
        snap = tmx.fault.log_stats(tmx.log.WARNING)
    assert snap == {"trainer.nonfinite_skip": 1}
    assert "trainer.nonfinite_skip" in caplog.text
