"""Port parity: ``mx.servefleet``, JAX package -> port.

The reference tests' tiny GPT (tests/test_servefleet.py:35-58: vocab 97,
32 units, 2 layers, 2 heads, max_slots 2, buckets "4,8", greedy), its
weights carried into the port's factory. The JAX fleets run once for the
module (each JAX engine compiles its grid): a crash failover
(``serve.replica_crash:at=2``, 3 replicas, 8 requests), a stall failover
(a wedged replica whose drained work races its re-dispatch), a rolling
update to the reference's "+0.5" weights with its canary card, a bad
canary, and a sole-replica crash. The port's fleets must give the JAX
fleets' tokens request for request, complete every request exactly once,
and match their failover, re-dispatch, rollback and generation counts.
``rendezvous_route`` / ``_route_order`` equal the JAX package's over 1000
sessions and every removal of a replica; checkpoints published by either
package load in the other (the same ``params.npz`` + ``manifest.json``,
the symlink swap); the ``/servefleet`` JSON has the JAX report's keys.
The rest of the surface (the floor, a mid-rollout scale-out, ledger
eviction, scaling, leases, the hot-path gate) is held to the reference
tests' own assertions on the port.
"""
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.serve.engine import ServeEngine as JEngine

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import servefleet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serve.engine import EngineBusy, ServeEngine

torch.set_num_threads(2)

CFG = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)
PKGS = {"jax": mx, "torch": tmx}
#: the factory weights (the JAX package's seed-7 GPT), made once
WEIGHTS = {}


def _weights():
    if not WEIGHTS:
        WEIGHTS.update({k: onp.asarray(v) for k, v in
                        jfunctional.param_arrays(_jfactory()).items()})
    return WEIGHTS


def planes_off(pkg):
    pkg.fault.clear()
    pkg.fault.reset_stats()
    pkg.telemetry.stop_http()
    pkg.telemetry.disable()
    pkg.telemetry.reset()
    pkg.config.reset()


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in PKGS.values():
        planes_off(pkg)
    with tmx.cpu():
        yield
    for pkg in PKGS.values():
        planes_off(pkg)


def _jfactory():
    """tests/test_servefleet.py:35-44."""
    mx.random.seed(7)
    net = JGPT(**CFG)
    net.initialize()
    net(mx.np.zeros((1, 2), dtype="int32"))
    return net


def _tfactory():
    net = tgpt.GPTForCausalLM(device="cpu", **CFG)
    net.initialize(seed=0)
    tfunctional.load_params(net, _weights())
    return net


FLEET_KW = dict(max_slots=2, buckets="4,8", temperature=0.0)


def _fleet(pkg, **kw):
    kw = {**FLEET_KW, "replicas": 2, **kw}
    if pkg is mx:
        return mx.servefleet.ServeFleet(_jfactory, **kw)
    return servefleet.ServeFleet(_tfactory, **kw)


def _session_on(sf, rid, replica_ids, prefix="s"):
    for i in range(10000):
        s = f"{prefix}{i}"
        if sf.rendezvous_route(s, replica_ids) == rid:
            return s
    raise AssertionError(f"no session routes to {rid}")


def _counters(pkg):
    return {k: v for k, v in pkg.telemetry.counters(aggregate=True).items()
            if k.startswith("servefleet.")}


def _new_params():
    """tests/test_servefleet.py:288-295: the factory weights + 0.5, as
    numpy (what a training fleet publishes)."""
    return {k: v + 0.5 for k, v in _weights().items()}


# -- the scenarios, run on either package -------------------------------------

def _crash(pkg):
    """serve.replica_crash at tick 2 under 8 requests on 3 replicas."""
    pkg.telemetry.enable()
    pkg.fault.configure("serve.replica_crash:at=2")
    fleet = _fleet(pkg, replicas=3, min_replicas=2)
    try:
        frs = [fleet.submit([1 + (i % 7), 2, 3, 4], max_new_tokens=6,
                            session=f"c{i}") for i in range(8)]
        fleet.run(max_ticks=500)
        report = fleet.report()
        return {"tokens": [fr.tokens for fr in frs],
                "redispatches": [fr.redispatches for fr in frs],
                "counters": _counters(pkg),
                "dead": sorted(r.rid for r in fleet._replicas.values()
                               if r.state == "dead"),
                "live": len(fleet._live()),
                "injected": pkg.fault.stats()["injected.serve.replica_crash"],
                "report": report,
                "endpoint": pkg.servefleet.endpoint_report()}
    finally:
        fleet.close()


def _stall(pkg):
    """tests/test_servefleet.py:224-262: a wedged replica's dispatched work
    is drained after its request re-dispatched; the late duplicate is
    suppressed."""
    pkg.telemetry.enable()
    pkg.config.set("servefleet.stall_deadline", 0.05)
    fleet = _fleet(pkg, replicas=2, max_slots=1, drain_window=32)
    try:
        live = [r.rid for r in fleet._live()]
        s = _session_on(pkg.servefleet, live[0], live, prefix="stall-")
        fr = fleet.submit([1, 2, 3], max_new_tokens=4, session=s)
        routed = fr.replica_id == live[0]
        for _ in range(8):
            fleet.step()
        victim = fleet._replicas[live[0]]
        pending = (not fr.done) and victim.engine.pending
        victim.wedged = True
        time.sleep(0.1)
        fleet.run(max_ticks=500, tick_interval=0.002)
        for _ in range(200):
            if not any(r.engine.pending for r in fleet._live()):
                break
            fleet.step()
        return {"tokens": fr.tokens, "routed": routed, "pending": pending,
                "counters": _counters(pkg), "victim": victim.state}
    finally:
        fleet.close()


def _rolling(pkg):
    """tests/test_servefleet.py:298-325 and 328-356: a rolling update to
    the +0.5 weights with their canary card, then one whose card is the
    old weights' (it rolls back at the first replica)."""
    pkg.telemetry.enable()
    new = _new_params()
    engine = JEngine if pkg is mx else ServeEngine
    scratch = engine((_jfactory if pkg is mx else _tfactory)(), **FLEET_KW)
    old_card = pkg.servefleet.canary_card(scratch, [[1, 2, 3]], tokens=4)
    scratch.update_weights(new)
    card = pkg.servefleet.canary_card(scratch, [[1, 2, 3, 4]], tokens=4)
    out = {"cards": [old_card, card]}
    fleet = _fleet(pkg, replicas=2, min_replicas=1)
    try:
        report = fleet.rolling_update(new, canary=card)
        out["report"] = {**report, "updated": sorted(report["updated"])}
        out["generations"] = [r.generation for r in fleet._live()]
        out["captures"] = [r.engine.post_warmup_compiles
                           for r in fleet._live()]
        fr = fleet.submit([1, 2, 3, 4], max_new_tokens=4, session="g1")
        fleet.run(max_ticks=200)
        out["served"] = fr.tokens
    finally:
        fleet.close()
    fleet = _fleet(pkg, replicas=3, min_replicas=2)
    try:
        report = fleet.rolling_update(new, canary=old_card)
        out["bad"] = {k: v for k, v in report.items() if k != "reason"}
        out["bad_reason"] = "canary diverged" in report["reason"]
        out["bad_live"] = [(r.generation, r.engine.post_warmup_compiles)
                           for r in fleet._live()]
        fr = fleet.submit([1, 2, 3], max_new_tokens=4, session="after")
        fleet.run(max_ticks=200)
        out["bad_served"] = fr.tokens
    finally:
        fleet.close()
    out["counters"] = _counters(pkg)
    return out


def _sole(pkg):
    """tests/test_servefleet.py:391-415: the only replica crashes; its
    requests queue, the next tick rebuilds, all complete once."""
    pkg.telemetry.enable()
    pkg.fault.configure("serve.replica_crash:at=2")
    fleet = _fleet(pkg, replicas=1, min_replicas=1)
    try:
        frs = [fleet.submit([1, 2, 3], max_new_tokens=4, session=f"solo{i}")
               for i in range(3)]
        fleet.run(max_ticks=500)
        return {"tokens": [fr.tokens for fr in frs],
                "counters": _counters(pkg),
                "fleet_dead": pkg.fault.stats()["servefleet.fleet_dead"],
                "states": sorted(r.state for r in fleet._replicas.values())}
    finally:
        fleet.close()


SCENARIOS = {"crash": _crash, "stall": _stall, "rolling": _rolling,
             "sole": _sole}


@pytest.fixture(scope="module")
def jref():
    """The JAX package's fleets, once for the module."""
    _weights()
    out = {}
    for name, fn in SCENARIOS.items():
        planes_off(mx)
        out[name] = fn(mx)
    planes_off(mx)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_fleet(jref, name):
    want = jref[name]
    got = SCENARIOS[name](tmx)
    if name == "crash":
        assert got["tokens"] == want["tokens"]
        assert got["redispatches"] == want["redispatches"]
        assert got["counters"] == want["counters"]
        assert got["counters"]["servefleet.completed_total"] == 8
        assert got["counters"]["servefleet.failovers_total"] == 1
        assert got["dead"] == want["dead"] and got["live"] == 2
        assert got["injected"] == 1
        assert got["report"] == want["report"]
    elif name == "stall":
        assert got["routed"] and got["pending"] and want["pending"]
        assert got["tokens"] == want["tokens"] is not None
        # exactly once in both; the port fails over the wedged replica
        # only (a JAX step past the deadline may fail a survivor too)
        c, w = got["counters"], want["counters"]
        assert c["servefleet.completed_total"] == 1 == \
            w["servefleet.completed_total"]
        assert c["servefleet.failovers_total"] == 1 <= \
            w["servefleet.failovers_total"]
        assert c["servefleet.duplicates_suppressed_total"] >= 1
        assert w["servefleet.duplicates_suppressed_total"] >= 1
        assert got["victim"] == "dead"
    elif name == "rolling":
        assert got["cards"] == want["cards"]
        assert got["report"] == want["report"] == {
            "updated": [0, 1], "rolled_back": False, "generation": 1}
        assert got["generations"] == [1, 1] and got["captures"] == [0, 0]
        assert got["served"] == got["cards"][1]["expected"][0] \
            == want["served"]
        assert got["bad"] == want["bad"] and got["bad"]["rolled_back"]
        assert got["bad_reason"] and want["bad_reason"]
        assert got["bad_live"] == [(0, 0)] * 3
        assert got["bad_served"] == want["bad_served"] \
            == got["cards"][0]["expected"][0]
        assert got["counters"] == want["counters"]
    else:
        assert got == want
        assert got["states"] == ["dead", "live"]


def test_dead_replica_releases_its_engine():
    """The dead replica's record stays; its engine holds no graphs, cache,
    state or weights once its failover is done (after a crash at once,
    after the drain after a stall)."""
    tmx.fault.configure("serve.replica_crash:at=2")
    fleet = _fleet(tmx, replicas=2, min_replicas=1)
    try:
        frs = [fleet.submit([1, 2, 3], max_new_tokens=4, session=f"r{i}")
               for i in range(4)]
        fleet.run(max_ticks=200)
        assert all(fr.done for fr in frs)
        dead = [r for r in fleet._replicas.values() if r.state == "dead"]
        assert len(dead) == 1
        eng = dead[0].engine
        assert eng._exe == {} and eng._cache is None and eng.model is None
        assert eng._params == ({}, {}) and not len(eng._window)
        assert dead[0].snapshot()["state"] == "dead"
        with pytest.raises(EngineBusy):
            eng.submit([1, 2], max_new_tokens=1)
    finally:
        fleet.close()


# -- routing ------------------------------------------------------------------

def test_rendezvous_matches_jax_with_minimal_movement():
    ids = [0, 1, 2, 3, 4]
    sessions = [f"user-{i}" for i in range(1000)]
    for live in [ids] + [[i for i in ids if i != gone] for gone in ids]:
        for s in sessions:
            assert servefleet.rendezvous_route(s, live) == \
                mx.servefleet.rendezvous_route(s, live)
        for s in sessions[:100]:
            assert servefleet._route_order(s, live) == \
                mx.servefleet._route_order(s, live)
    before = {s: servefleet.rendezvous_route(s, ids) for s in sessions}
    after = {s: servefleet.rendezvous_route(s, [0, 1, 3, 4])
             for s in sessions}
    for s in sessions:
        assert after[s] == before[s] or before[s] == 2
    with pytest.raises(MXNetError):
        servefleet.rendezvous_route("s", [])


# -- checkpoints across the packages ------------------------------------------

def test_checkpoints_load_across_packages(tmp_path):
    params = _new_params()
    card = {"prompts": [[1, 2, 3]], "tokens": 2, "expected": [[5, 5]]}
    jpath = str(tmp_path / "from_jax")
    mx.servefleet.publish_checkpoint(jpath, params, canary=card, step=10)
    got, canary = servefleet.load_checkpoint(jpath)
    assert canary == card and sorted(got) == sorted(params)
    for k, v in params.items():
        assert isinstance(got[k], torch.Tensor)
        assert onp.array_equal(got[k].numpy(), v) and got[k].dtype == \
            torch.from_numpy(onp.asarray(v)).dtype, k
    tpath = str(tmp_path / "from_torch")
    servefleet.publish_checkpoint(
        tpath, {k: torch.from_numpy(onp.asarray(v)) for k, v in
                params.items()}, canary=card, step=11)
    back, canary = mx.servefleet.load_checkpoint(tpath)
    assert canary == card and sorted(back) == sorted(params)
    for k, v in params.items():
        assert onp.array_equal(onp.asarray(back[k]), v), k
    with open(os.path.join(tpath, "manifest.json")) as f:
        assert json.load(f)["format"] == mx.servefleet.CHECKPOINT_FORMAT
    with pytest.raises(MXNetError, match="manifest"):
        servefleet.load_checkpoint(str(tmp_path / "nope"))


def test_checkpoint_publish_swaps_symlink_never_missing(tmp_path):
    params = {"a": torch.ones(3), "b": torch.zeros(2, 2)}
    path = str(tmp_path / "ckpt")
    servefleet.publish_checkpoint(path, params, step=1)
    assert os.path.islink(path)
    first = os.path.realpath(path)
    servefleet.publish_checkpoint(path, params, step=2)
    assert os.path.islink(path) and os.path.realpath(path) != first
    assert not os.path.exists(first)
    legacy = str(tmp_path / "legacy")
    shutil.copytree(os.path.realpath(path), legacy)
    servefleet.publish_checkpoint(legacy, params, step=3)
    assert os.path.islink(legacy)
    for p in (path, legacy):
        loaded, _ = servefleet.load_checkpoint(p)
        assert sorted(loaded) == ["a", "b"]
        loaded, _ = mx.servefleet.load_checkpoint(p)
        assert sorted(loaded) == ["a", "b"]


# -- the rest of the surface, on the reference tests' assertions --------------

def test_affinity_idempotent_accept_and_spill():
    tmx.telemetry.enable()
    tmx.config.set("serve.max_queue", 1)
    fleet = _fleet(tmx, replicas=2, max_slots=1)
    try:
        live = [r.rid for r in fleet._live()]
        a = fleet.submit([1, 2], max_new_tokens=4, key="k1",
                         session=_session_on(servefleet, live[0], live,
                                             "pin-"))
        assert a.replica_id == live[0]
        assert fleet.submit([1, 2], max_new_tokens=4, key="k1") is a
        b = fleet.submit([1, 2], max_new_tokens=4, session=a.session)
        assert b.replica_id == live[1]
        with pytest.raises(EngineBusy) as ei:
            fleet.submit([1, 2], max_new_tokens=2, session=a.session)
        assert ei.value.reason == "queue_full" and \
            ei.value.retry_after_hint > 0
        fleet.run(max_ticks=300)
        assert a.done and b.done
        assert _counters(tmx)["servefleet.requests_total"] == 2
    finally:
        fleet.close()


def test_rolling_update_floor_and_mid_rollout_scale_out():
    fleet = _fleet(tmx, replicas=2, min_replicas=2, max_replicas=2)
    try:
        with pytest.raises(MXNetError, match="min_replicas"):
            fleet.rolling_update(_new_params())
        assert len(fleet._live()) == 2
    finally:
        fleet.close()
    fleet = _fleet(tmx, replicas=2, min_replicas=2, max_replicas=3)
    try:
        report = fleet.rolling_update(_new_params())
        live = fleet._live()
        assert report["rolled_back"] is False and len(live) == 3
        assert all(r.generation == 1 for r in live)
        assert sorted(report["updated"]) == sorted(r.rid for r in live)
        assert all(r.engine.post_warmup_compiles == 0 for r in live)
    finally:
        fleet.close()
    fleet = _fleet(tmx, replicas=2, temperature=0.8)
    try:
        with pytest.raises(MXNetError, match="greedy"):
            fleet.rolling_update(_new_params(), canary={
                "prompts": [[1, 2, 3]], "tokens": 2, "expected": [[1, 1]]})
        assert fleet._generation == 0
    finally:
        fleet.close()


def test_ledger_evicts_completed_beyond_retain():
    tmx.config.set("servefleet.ledger_retain", 4)
    fleet = _fleet(tmx, replicas=2)
    try:
        frs = {}
        for i in range(10):
            frs[f"key-{i}"] = fleet.submit([1, 2, 3], max_new_tokens=2,
                                           key=f"key-{i}", session=f"L{i}")
            fleet.run(max_ticks=200)
        assert all(fr.done for fr in frs.values())
        assert fleet._inflight == {} and len(fleet._completed) == 4
        assert fleet.submit([1, 2, 3], max_new_tokens=2,
                            key="key-9") is frs["key-9"]
        rep = fleet.report()
        assert rep["requests"] == 10 and rep["completed"] == 10
        assert rep["ledger_retained"] == 4
    finally:
        fleet.close()


def test_scale_out_on_burn_then_scale_in_park_and_unpark():
    tmx.telemetry.enable()
    tmx.config.set("serve.slo_ttft_ms", 0.0001)
    tmx.config.set("serve.slo_target", 0.9)
    tmx.config.set("servefleet.scale_patience", 2)
    fleet = _fleet(tmx, replicas=2, max_replicas=3)
    try:
        frs = [fleet.submit([1, 2, 3], max_new_tokens=3, session=f"b{i}")
               for i in range(4)]
        fleet.run(max_ticks=300)
        assert all(fr.done for fr in frs)
        for _ in range(6):
            fleet.step()
        assert len(fleet._live()) == 3
        assert tmx.telemetry.counters().get(
            'servefleet.scale_events_total{dir="out"}', 0) >= 1
    finally:
        fleet.close()
    tmx.config.reset("serve.slo_ttft_ms")
    tmx.telemetry.reset()
    tmx.config.set("servefleet.occupancy_floor", 1.0)
    fleet = _fleet(tmx, replicas=3, min_replicas=2)
    try:
        for _ in range(6):
            fleet.step()
        assert len(fleet._live()) == 2
        parked = fleet._parked()
        assert len(parked) == 1
        assert tmx.telemetry.counters().get(
            'servefleet.scale_events_total{dir="in"}', 0) == 1
        rep = fleet._scale_out(reason="test")
        assert rep is parked[0] and rep.state == "live"
        assert rep.engine.post_warmup_compiles == 0
        for _ in range(20):
            fleet.step()
        assert len(fleet._live()) >= 2
    finally:
        fleet.close()


def test_stale_lease_fails_over(tmp_path):
    tmx.telemetry.enable()
    fleet = _fleet(tmx, replicas=2, min_replicas=1, lease_dir=str(tmp_path))
    try:
        live = [r.rid for r in fleet._live()]
        for rid in live:
            path = tmp_path / f"host-{rid}.lease"
            for _ in range(200):
                if path.exists():
                    break
                time.sleep(0.01)
            assert path.exists(), rid
        victim = fleet._replicas[live[0]]
        fr = fleet.submit([1, 2, 3], max_new_tokens=4,
                          session=_session_on(servefleet, live[0], live,
                                              "lease-"))
        victim.plane._stop.set()
        victim.plane.timeout = 0.01
        (tmp_path / f"host-{victim.rid}.lease").write_text(json.dumps(
            {"rank": victim.rid, "pid": 0, "step": 0,
             "time": time.time() - 1.0}))
        fleet.run(max_ticks=300, tick_interval=0.002)
        assert victim.state == "dead" and fr.done
        assert _counters(tmx)["servefleet.failovers_total"] == 1
    finally:
        fleet.close()


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_servefleet_endpoint_keys_match_jax_and_close_drops_gate(jref):
    tmx.telemetry.enable()
    fleet = _fleet(tmx, replicas=2)
    try:
        fr = fleet.submit([1, 2, 3], max_new_tokens=3, session="ep")
        fleet.run(max_ticks=100)
        assert fr.done and servefleet._active is True
        srv = tmx.telemetry.serve_http(0)
        status, body = _get(srv.server_address[1], "/servefleet")
        assert status == 200
        d = json.loads(body)
        want = jref["crash"]["endpoint"]
        assert sorted(d) == sorted(want) and d["active"] is True
        assert len(d["fleets"]) == 1
        rep = d["fleets"][0]
        assert sorted(rep) == sorted(want["fleets"][0])
        assert sorted(rep["replicas"][0]) == sorted(
            want["fleets"][0]["replicas"][0])
        assert rep["live"] == 2 and rep["completed"] == 1
        status, body = _get(srv.server_address[1], "/nope")
        assert status == 404 and "/servefleet" in body
    finally:
        tmx.telemetry.stop_http()
        fleet.close()
    assert servefleet._active is False
    assert servefleet.endpoint_report() == {"active": False, "fleets": []}


def test_engine_hook_is_one_attribute_read_without_a_fleet():
    """``ServeEngine.step`` calls note_step only behind the module gate."""
    eng = ServeEngine(_tfactory(), **FLEET_KW)
    calls = []
    orig = servefleet.note_step
    servefleet.note_step = calls.append
    try:
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        assert calls == [] and servefleet._active is False
        servefleet._active = True
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        assert calls and all(c is eng for c in calls)
    finally:
        servefleet._active = False
        servefleet.note_step = orig
