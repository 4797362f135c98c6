"""Port parity: ``mx.insight``, JAX package -> PyTorch port.

The same inputs through both packages: the roofline verdict (the ridge
point and the input-stall override), MFU for an explicit ``cost=`` on
the same measured step times (both on the CPU row of the peaks), the drift
detector's events on the same series (step change, ramp, noise, spike,
recovery), the ``insight.drift`` chaos point, the drift event's trace span
and fault record, and the fleet merge of the same snapshots. The port's
own cost counting (``insight.count``: ``torch.utils.flop_counter``'s
formulas plus the kernels' ``add_flops``) is held to the analytic count of a small MLP and
of the flash-attention formulas, and a hybridized block's capture lands in
the registry once with that cost (the reference also registers each
child's nested trace; the port captures one graph per outermost call, so
only the outermost block's entry is compared).
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import flash_attention as tfa

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


def test_peaks_are_the_h100_rows_and_the_reference_cpu_row():
    ins = tmx.insight
    assert ins.PEAK_FLOPS == {"h100": 989e12, "cpu": mx.insight.PEAK_FLOPS[
        "cpu"]}
    assert ins.PEAK_BYTES_PER_S == {"h100": 3.35e12,
                                    "cpu": mx.insight.PEAK_BYTES_PER_S["cpu"]}
    assert ins._peaks("nvidia h100 80gb hbm3") == (989e12, 3.35e12)
    assert ins._peaks() == mx.insight._peaks("cpu")
    assert ins._device_kind() == "cpu"


@pytest.mark.parametrize("args", [
    (1e9, 1e6, 1e11, 5e10), (10.0, 1e9, 1e11, 5e10), (None, 1e6, None, None),
    (1e9, 0, None, None), (2e9, 1e9, None, None), (1e9, 1e9, None, None)])
def test_roofline_verdict_matches_jax(args):
    flops, nbytes, pf, pb = args
    assert tmx.insight.roofline_verdict(
        flops, nbytes, peak_flops=pf, peak_bytes_per_s=pb) == \
        mx.insight.roofline_verdict(flops, nbytes, peak_flops=pf,
                                    peak_bytes_per_s=pb)


def test_input_stall_flips_the_verdict_like_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        for v in (0.2, 0.3, 0.25):
            pkg.telemetry.observe("pipeline.input_stall_seconds", v)
        got[name] = (pkg.insight.input_stall_p50(),
                     pkg.insight.roofline_verdict(1e9, 1e6,
                                                  step_seconds=0.1),
                     pkg.insight.roofline_verdict(1e9, 1e6,
                                                  step_seconds=10.0))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == "input"


def test_mfu_for_an_explicit_cost_matches_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.insight.enable()
        pkg.telemetry.enable()
        pkg.insight.register_executable(
            "demo.step", cost={"flops": 3e7, "bytes_accessed": 2e5,
                               "output_bytes": 1e4}, kind="demo")
        for s in (0.01, 0.02, 0.005):
            pkg.insight.note_step("demo.step", seconds=s, step=1)
        e = dict(pkg.insight.attribution()["executables"]["demo.step"])
        e.pop("registered_at")
        got[name] = (e, pkg.telemetry.snapshot()["gauges"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["mfu"] == pytest.approx(3e7 / 0.005 / 1e11)


def _series(kind):
    rs = onp.random.RandomState(4)
    if kind == "step":
        return [0.1] * 20 + [0.3] * 10
    if kind == "ramp":
        return [0.1] * 16 + [0.1 + 0.01 * i for i in range(40)]
    if kind == "noise":
        return list(0.1 + rs.normal(0, 0.005, 200))
    if kind == "spike":
        return [0.1] * 16 + [5.0] + [0.1] * 20
    return [0.1] * 16 + [0.4] * 6 + [0.1] * 60


@pytest.mark.parametrize("kind", ["step", "ramp", "noise", "spike",
                                  "recover"])
def test_drift_detector_matches_jax(kind):
    got = {}
    for name, pkg in PKGS.items():
        det = pkg.insight.DriftDetector("t", window=8, sigma=3.0)
        fired = [det.update(v) for v in _series(kind)]
        got[name] = (fired, det.state())
    assert got["torch"] == got["jax"]


def test_injected_slowdown_raises_drift_like_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.config.set("insight.drift_window", 8)
        pkg.insight.enable()
        pkg.telemetry.enable()
        pkg.trace.enable()
        for _ in range(12):
            pkg.telemetry.observe("trainer.step_seconds", 0.1)
        pkg.fault.configure("insight.drift:prob=1.0")
        for _ in range(4):
            pkg.telemetry.observe("trainer.step_seconds", 0.1)
        events = [{k: e[k] for k in ("source", "seconds", "count")}
                  for e in pkg.insight.drift_events()]
        got[name] = (events, pkg.insight.healthz(), pkg.fault.stats(),
                     [s["name"] for s in pkg.trace.spans()],
                     pkg.telemetry.counters(aggregate=True))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["ok"] is False and got["torch"][0]


def test_snapshot_merge_and_fleet_exposition_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        for rank, ewma in ((0, 0.1), (1, 0.25), (2, 0.11)):
            payload = {"rank": rank, "pid": 1, "time": 0.0,
                       "counters": {"trainer.steps_total": 10 + rank},
                       "gauges": {"insight.mfu": 0.1 * rank},
                       "insight": {"executables": {"x": {
                           "last_seconds": ewma}},
                           "drift": {"trainer.step": {
                               "ewma": ewma, "degraded": rank == 1,
                               "events": rank}},
                           "drift_events": []}}
            (d / f"insight-{rank}.json").write_text(json.dumps(payload))
        (d / "insight-7.json").write_text("{torn")
        merged = pkg.insight.merge_snapshots(str(d))
        merged.pop("time")
        merged.pop("snapshot_age_seconds")
        text = "\n".join(ln for ln in pkg.insight.fleet_exposition(
            str(d)).splitlines() if "snapshot_age" not in ln)
        got[name] = (merged, text, pkg.insight.relative_slowness(str(d)))
    assert got["torch"] == got["jax"]


def test_count_of_a_small_mlp_is_the_analytic_count():
    w1, w2 = torch.randn(32, 16), torch.randn(3, 32)
    x = torch.randn(4, 16, requires_grad=True)
    with tmx.insight.count([x, w1, w2]) as cost:
        h = torch.relu(x @ w1.T)
        out = h @ w2.T
        out.sum().backward()
        cost["outputs"] = out
    fwd = 2 * 4 * 16 * 32 + 2 * 4 * 32 * 3
    # the backward to x only (the weights need no gradient): dh, then dx
    assert cost["flops"] == fwd + 2 * 4 * 3 * 32 + 2 * 4 * 32 * 16
    assert cost["bytes_accessed"] == 4 * (4 * 16 + 32 * 16 + 3 * 32 + 4 * 3)
    assert cost["output_bytes"] == 4 * 4 * 3
    assert "outputs" not in cost and tmx.insight._counting == 0


def test_count_allows_autograd_grad_of_leaves_through_blocks():
    """A capture's warm-up takes ``torch.autograd.grad`` of a block's
    outputs with respect to its leaf parameters inside the count (the
    module tracker of ``FlopCounterMode`` refuses that)."""
    net = tmx.gluon.nn.Dense(3, in_units=16)
    net.initialize()
    x = torch.randn(4, 16)
    w = [p.data() for p in net.collect_params().values()]
    with tmx.autograd.record(), tmx.insight.count(w) as cost:
        out = net(x)
        grads = torch.autograd.grad(out.sum(), w)
    assert len(grads) == 2
    assert cost["flops"] == 2 * 4 * 16 * 3 + 2 * 4 * 3 * 16


def test_add_flops_reaches_every_running_count():
    with tmx.insight.count() as outer:
        tmx.insight.add_flops(10)
        with tmx.insight.count() as inner:
            tmx.insight.add_flops(5)
    assert (outer["flops"], inner["flops"]) == (15.0, 5.0)


@pytest.mark.parametrize("sq,sk,causal", [(16, 16, True), (16, 16, False),
                                          (5, 9, True), (9, 5, True)])
def test_flash_flop_formula_counts_visible_pairs(sq, sk, causal):
    want = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    assert tfa._pairs(sq, sk, causal) == want
    q = torch.zeros(6, sq, 64)
    k = torch.zeros(6, sk, 64)
    with tmx.insight.count() as cost:
        tfa._add_flops(4, q, k, causal)
    assert cost["flops"] == 4 * 64 * 6 * want


def test_cached_graph_capture_lands_in_registry_once():
    got = {}
    for name, pkg in PKGS.items():
        pkg.insight.enable()
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=16),
                pkg.gluon.nn.Dense(4, in_units=32))
        net.initialize(pkg.init.Xavier())
        net.hybridize()
        x = pkg.np.ones((4, 16))
        for _ in range(3):
            net(x)
        exes = pkg.insight.attribution()["executables"]
        e = exes["cached_graph.HybridSequential"]
        # the reference also registers the children's nested traces; the
        # port captures one graph per outermost call
        got[name] = (e["steps"], e["kind"], e["bound"],
                     any("float32[4,16]" in s for s in e["args"]))
        assert e["flops"] > 0
        if name == "torch":
            assert e["flops"] == 2 * 4 * 16 * 32 + 2 * 4 * 32 * 4
            assert e["bytes_accessed"] == 4 * (4 * 16 + 32 * 16 + 32
                                               + 4 * 32 + 4 + 4 * 4)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_hooks_are_noops(pkg):
    ins = PKGS[pkg].insight
    assert ins.register_executable("x", cost={"flops": 1.0}) is None
    ins.note_step("x")
    ins.note_step("x")
    assert ins.attribution()["executables"] == {}
    assert ins.last_summary() is None and ins.healthz()["ok"] is True
