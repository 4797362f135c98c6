"""Port parity: ``mx.fleet`` (leases, ``plan_layout``, the elastic
supervisor) and the stranded-rank repair of ``ShardedTrainStep``, JAX
package -> port.

``plan_layout`` equals the JAX package's choice (or both park) for every
target factorization over 1-16 devices, every survivor count and every
``min_dp`` in 1-4. The health plane, the supervisor over a fake step and
the goodput / blackbox / stream / insight fleet cases run the reference
tests' scripts (tests/test_fleet.py, test_goodput.py, test_blackbox.py,
test_stream.py, test_insight.py) in both packages: the same exceptions,
verdicts, fault and telemetry counters, capacity ratios, postmortem
names, shard reassignments and straggler ratios. The lease drill runs two
real processes over ``tests/torch_fleet_worker.py``.

Three gloo worlds over ``tests/torch_dist_worker.py``, started together:
``stranded`` (4 ranks, ``MeshConfig(dp=1, tp=2)``: ranks 2-3 raise on
every call, then all four rebuild onto dp2 x tp2 and restore the bundle
bit for bit; on the parent tree those ranks step as rank 0 and the world
hangs), ``fleet`` (8 ranks: the reference's degrade drill,
tests/test_fleet.py:292-335, held against the JAX drill on its 8-device
virtual mesh: each step's loss within 1e-5, the same degrade and
re-expand counts and layouts, every restore bit for bit equal to its
bundle) and ``fleet_lease`` (4 ranks, every rank a health plane: host 1's
leases go stale, and every rank loses it in the same probe). All start
from the JAX step's step-0 bundle through ``load_reference_state_dict``.
"""
import os
import pickle
import subprocess
import sys
import time
import warnings

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu.parallel.mesh import MeshConfig as JCfg
from mxnet_tpu.parallel.mesh import mesh_factorizations as jfactorizations

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel.mesh import MeshConfig as TCfg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": mx, "torch": tmx}
CFGS = {"jax": JCfg, "torch": TCfg}
LOSS_TOL = 1e-5   # the reference drill's bound (tests/test_fleet.py:331)


def planes_off(pkg):
    pkg.fault.clear()
    pkg.fault.reset_stats()
    pkg.telemetry.disable()
    pkg.telemetry.reset()
    pkg.telemetry.unregister_health("fleet")
    pkg.trace.disable()
    pkg.trace.clear()
    pkg.goodput.disable()
    pkg.goodput.reset()
    pkg.insight.disable()
    pkg.insight.reset()
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


def _shape(cfg):
    return None if cfg is None else (cfg.dp, cfg.tp, cfg.pp, cfg.sp)


# -- plan_layout --------------------------------------------------------------

@pytest.mark.parametrize("size", range(1, 17))
def test_plan_layout_matches_jax(size):
    for target in jfactorizations(size, max_sp=size):
        tt = TCfg(dp=target.dp, tp=target.tp, pp=target.pp, sp=target.sp)
        for devices in range(1, 17):
            for min_dp in range(1, 5):
                want = _shape(mx.fleet.plan_layout(target, devices, min_dp))
                got = _shape(tmx.fleet.plan_layout(tt, devices, min_dp))
                assert got == want, (_shape(target), devices, min_dp)


def test_plan_layout_reference_cases_and_min_dp_knob():
    cur = TCfg(dp=2, tp=2, pp=2)
    assert tmx.fleet.plan_layout(cur, 4) == TCfg(dp=1, tp=2, pp=2)
    assert tmx.fleet.plan_layout(cur, 6) == TCfg(dp=3, tp=2, pp=1)
    assert tmx.fleet.plan_layout(TCfg(dp=4, sp=2), 4) == TCfg(dp=2, sp=2)
    assert tmx.fleet.plan_layout(TCfg(dp=4, sp=2), 3) is None
    tmx.config.set("fleet.min_dp", 2)
    assert tmx.fleet.plan_layout(cur, 4) is None


# -- the health plane ---------------------------------------------------------

def _health_script(pkg, d):
    """tests/test_fleet.py:132-165 and a step-deadline case, on ``pkg``:
    what each verdict was, and the counters."""
    HP = pkg.fleet.HealthPlane
    pkg.telemetry.enable()
    out = {}
    # fleet.lease_lost turns /healthz red, and the heartbeat recovers
    hp = HP(rank=0, nprocs=1, lease_dir=os.path.join(d, "lost"))
    pkg.fault.configure("fleet.lease_lost:at=1")
    out["lost"] = [hp.beat(step=1), hp.healthz()["ok"], hp.beat(step=2),
                   hp.healthz()["ok"]]
    pkg.fault.clear()
    # a stale peer raises WorkerLost(op="lease") and turns /healthz red
    a = HP(rank=0, nprocs=2, lease_dir=os.path.join(d, "stale"),
           timeout=0.2)
    b = HP(rank=1, nprocs=2, lease_dir=os.path.join(d, "stale"))
    a.beat(step=1)
    b.beat(step=1)
    out["alive"] = a.check_peers()
    time.sleep(0.3)
    try:
        a.check_peers()
        out["stale"] = None
    except pkg.resilience.WorkerLost as e:
        out["stale"] = (e.op, e.key, e.rank, e.nprocs)
    out["stale_healthz"] = a.healthz()["ok"]
    # a clean stop is a departure, not a loss
    c = HP(rank=0, nprocs=2, lease_dir=os.path.join(d, "stop"), timeout=0.2)
    e2 = HP(rank=1, nprocs=2, lease_dir=os.path.join(d, "stop"))
    e2.beat(step=1)
    c.beat(step=1)
    out["departure"] = [sorted(c.peers()), (e2.stop(), c.peers())[1]]
    # the step deadline: slow (a straggler, kept) then wedged (raises)
    pkg.config.set("fleet.step_deadline", 0.4)
    pkg.config.set("fleet.slow_fraction", 0.25)
    f = HP(rank=0, nprocs=2, lease_dir=os.path.join(d, "deadline"))
    g = HP(rank=1, nprocs=2, lease_dir=os.path.join(d, "deadline"))
    f.beat(step=1)
    g.beat(step=3)
    f.check_peers()                      # progress noted
    time.sleep(0.2)
    g.beat(step=3)                       # fresh lease, stuck step
    out["slow"] = (f.check_peers(), sorted(f._stragglers))
    time.sleep(0.3)
    g.beat(step=3)
    try:
        f.check_peers()
        out["wedged"] = None
    except pkg.resilience.WorkerLost as e:
        out["wedged"] = (e.op, e.key)
    out["local_wedged"] = f.healthz().get("local")
    out["faults"] = pkg.fault.stats()
    out["counters"] = {k: v for k, v in
                       pkg.telemetry.counters(aggregate=True).items()
                       if k.startswith("fleet.")}
    for plane in (hp, a, b, c, f, g):
        plane.stop()
    return out


def test_health_plane_matches_jax(tmp_path):
    got = {name: _health_script(pkg, str(tmp_path / name))
           for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["lost"] == [False, False, True, True]
    assert t["stale"] == ("lease", "host-1", 0, 2)
    assert t["stale_healthz"] is False
    assert t["departure"] == [[1], {}]
    assert t["slow"] == ([1], [1]) and t["wedged"] == ("step_deadline",
                                                       "host-1")
    assert t["counters"]["fleet.lease_expiries_total"] == 1


def test_health_plane_restart_loop_leaks_no_threads(tmp_path):
    import threading
    plane = tmx.fleet.HealthPlane(rank=0, nprocs=1, lease_dir=str(tmp_path),
                                  interval=0.005)
    for _ in range(30):
        plane.start()
        plane.stop()
    plane.start()
    first = plane._thread
    plane.start()
    assert plane._thread is first
    plane.stop()
    assert plane._thread is None
    time.sleep(0.05)
    assert not any(t.name == "mx-fleet-heartbeat" and t.is_alive()
                   for t in threading.enumerate())


# -- the supervisor over a fake step ------------------------------------------

class _FakeStep:
    def __init__(self, cfg):
        self.mesh_config = cfg

    def rebuild(self, cfg, sync=False):
        time.sleep(0.02)
        return _FakeStep(cfg)


def _supervisor_script(pkg):
    """tests/test_fleet.py:104-127 on ``pkg``: park and unpark, a
    straggler, nobody left to lose, a degrade and its re-expand."""
    Sup, Cfg = pkg.fleet.FleetSupervisor, CFGS["jax" if pkg is mx
                                               else "torch"]
    pkg.telemetry.enable()
    out = {}
    sup = Sup(_FakeStep(Cfg(dp=2)), pkg.resilience.TrainState(), n_hosts=2,
              min_dp=2)
    pkg.fault.configure("fleet.host_loss:at=1")
    out["park"] = [sup.probe(1), sup.parked]
    sup.restore_hosts()
    out["unpark"] = [sup.parked, sup.alive_hosts()]
    pkg.fault.clear()
    sup = Sup(_FakeStep(Cfg(dp=2)), pkg.resilience.TrainState(), n_hosts=2)
    pkg.fault.configure("fleet.slow_host:at=1")
    out["slow"] = [sup.probe(1), sup.alive_hosts(), sup.degrades]
    pkg.fault.clear()
    sup = Sup(_FakeStep(Cfg(dp=2)), pkg.resilience.TrainState(), n_hosts=1)
    pkg.fault.configure("fleet.host_loss:at=1")
    out["nobody"] = [sup.probe(1), sorted(sup._lost)]
    pkg.fault.clear()
    sup = Sup(_FakeStep(Cfg(dp=4, tp=2)), pkg.resilience.TrainState(),
              n_hosts=4)
    pkg.fault.configure("fleet.host_loss:at=2")
    out["degrade"] = [sup.probe(1), sup.probe(2), _shape(sup.current),
                      sorted(sup._lost)]
    sup.restore_hosts()
    sup.probe(3)
    out["reexpand"] = [_shape(sup.current), sup.degrades, sup.reexpands]
    out["faults"] = pkg.fault.stats()
    snap = pkg.telemetry.snapshot()
    out["metrics"] = {k: v for k, v in
                      {**snap["counters"], **snap["gauges"]}.items()
                      if k.startswith("fleet.")}
    return out


def test_supervisor_state_machine_matches_jax():
    got = {name: _supervisor_script(pkg) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["park"] == [False, True] and t["unpark"] == [False, [0, 1]]
    assert t["slow"] == [True, [0, 1], 0] and t["nobody"] == [True, []]
    assert t["degrade"] == [True, True, (3, 2, 1, 1), [3]]
    assert t["reexpand"] == [(4, 2, 1, 1), 1, 1]
    assert t["faults"]["fleet.park"] == 1
    assert t["faults"]["fleet.straggler"] == 1


def test_supervisor_agrees_on_the_victim_in_a_world_of_ranks(monkeypatch):
    """Every rank of a world takes the reference controller's victim (the
    highest live host but 0), whatever its own host; losing host 0, or a
    host the smaller layout would need, raises."""
    import mxnet_tpu_torch.fleet as tfleet
    monkeypatch.setattr(tfleet, "_world", lambda: (8, 6))
    sup = tfleet.FleetSupervisor(_FakeStep(TCfg(dp=4, tp=2)),
                                 tmx.resilience.TrainState(), n_hosts=4)
    assert sup.host_index == 3
    tmx.fault.configure("fleet.host_loss:at=1")
    sup.probe(1)
    assert sup._lost == {3} and _shape(sup.current) == (3, 2, 1, 1)
    with pytest.raises(tmx.MXNetError, match="host 0 lost"):
        sup.lose_host(0)
    with pytest.raises(tmx.MXNetError, match="host 1 .* is lost"):
        sup.lose_host(1)


# -- the planes' fleet cases --------------------------------------------------

def test_goodput_host_loss_and_park_match_jax(tmp_path):
    """tests/test_goodput.py:220-285: the degrade is restart badput, every
    second at half capacity degraded_capacity, the re-expand restores the
    ratio; a park is an open bracket closed by restore_hosts; the
    heartbeat publishes a rate-limited snapshot."""
    got = {}
    for name, pkg in PKGS.items():
        Cfg = CFGS[name]
        pkg.goodput.enable()
        sup = pkg.fleet.FleetSupervisor(
            _FakeStep(Cfg(dp=2)), pkg.resilience.TrainState(), n_hosts=2)
        pkg.fault.configure("fleet.host_loss:at=1")
        degraded = [sup.probe(1), _shape(sup.current)]
        time.sleep(0.05)
        mid = pkg.goodput.summary()
        sup.restore_hosts()
        sup._maybe_reexpand()
        end = pkg.goodput.summary()
        pkg.fault.clear()
        pkg.goodput.reset()
        pkg.goodput.enable()
        park = pkg.fleet.FleetSupervisor(
            _FakeStep(Cfg(dp=2)), pkg.resilience.TrainState(), n_hosts=2,
            min_dp=2)
        pkg.fault.configure("fleet.host_loss:at=1")
        parked = [park.probe(1), park.parked]
        time.sleep(0.03)
        pmid = pkg.goodput.summary()["buckets"]["parked"]
        park.restore_hosts()
        at_restore = pkg.goodput.summary()["buckets"]["parked"]
        time.sleep(0.02)
        closed = pkg.goodput.summary()["buckets"]["parked"] - at_restore
        pkg.fault.clear()
        d = str(tmp_path / name)
        pkg.goodput.note("compute", 0.01)
        hp = pkg.fleet.HealthPlane(rank=0, nprocs=1, lease_dir=d)
        hp.beat(step=1)
        first = pkg.goodput.read_snapshots(d)[0]["time"]
        hp.beat(step=2)
        again = pkg.goodput.read_snapshots(d)[0]["time"]
        for s in (mid, end):
            total = sum(s["buckets"].values())
            assert abs(total - s["elapsed_s"]) < 1e-3, (name, s)
        assert mid["buckets"]["restart"] >= 0.015, name
        assert mid["buckets"]["degraded_capacity"] >= 0.02, name
        assert pmid >= 0.025 and abs(closed) < 5e-3, name
        got[name] = {
            "degraded": degraded, "parked": parked,
            "mid_ratio": mid["capacity_ratio"],
            "end_ratio": end["capacity_ratio"],
            "top": sorted(k for k, _ in mid["badput_top"]),
            "reexpanded": _shape(sup.current),
            "snapshot_rate_limited": first == again}
    assert got["torch"] == got["jax"]
    assert got["torch"]["mid_ratio"] == 0.5 and got["torch"][
        "end_ratio"] == 1.0
    assert set(got["torch"]["top"]) <= {"restart", "degraded_capacity"}


def test_blackbox_postmortem_attached_to_degrade_matches_jax(tmp_path):
    """tests/test_blackbox.py:259-283: the dead host's latest bundle rides
    the degrade decision and its trace span."""
    got = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        pkg.config.set("blackbox.dir", d)
        pkg.blackbox.enable()
        pkg.blackbox.dump(trigger="worker_lost", reason="host 1 went dark",
                          step=4, rank=1)
        dead = pkg.blackbox.latest_bundle(rank=1)
        pkg.trace.enable(buffer=256)
        sup = pkg.fleet.FleetSupervisor(
            _FakeStep(CFGS[name](dp=2)), pkg.resilience.TrainState(),
            n_hosts=2)
        pkg.fault.configure("fleet.host_loss:at=1")
        sup.probe(1)
        spans = [s for s in pkg.trace.spans(category="fleet")
                 if s["name"] == "fleet.degrade"]
        assert sup.postmortems == {1: dead}, name
        assert spans[-1]["args"]["postmortem"] == dead, name
        got[name] = {"degrades": sup.degrades,
                     "bundle": os.path.basename(dead),
                     "host": spans[-1]["args"]["postmortem_host"],
                     "span_names": sorted({s["name"] for s in
                                           pkg.trace.spans(
                                               category="fleet")})}
    assert got["torch"] == got["jax"]


def test_stream_shards_reassigned_on_host_loss_match_jax(tmp_path):
    """tests/test_stream.py:340-366: the dead host's unfinished shards
    move to the survivor even when the compute plane parks."""
    got = {}
    for name, pkg in PKGS.items():
        shards = str(tmp_path / f"data_{name}")
        with pkg.stream.ShardWriter(shards, 4) as w:
            for g in range(53):
                w.append(pkg.stream.pack_sample(
                    onp.full((3,), g, dtype=onp.float32), onp.int32(g % 5)))
        d = str(tmp_path / f"leases_{name}")
        pkg.telemetry.enable()
        dead = pkg.stream.StreamSampler(shards, batch_size=4, seed=7, dp=2,
                                        rank=1, cursor_dir=d)
        it = iter(dead)
        next(it)
        dead.publish_cursor(cursor=1)
        surv = pkg.stream.StreamSampler(shards, batch_size=4, seed=7, dp=2,
                                        rank=0, cursor_dir=d)
        first = next(iter(surv))
        pkg.config.set("fleet.lease_dir", d)
        sup = pkg.fleet.FleetSupervisor(
            _FakeStep(CFGS[name](dp=2)), pkg.resilience.TrainState(),
            n_hosts=2, min_dp=2, stream=surv)
        sup.lose_host(1)
        got[name] = {
            "reassigned": pkg.telemetry.counters().get(
                "stream.shards_reassigned_total", 0),
            "parked": sup.parked, "first": list(first),
            "faults": pkg.fault.stats()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["reassigned"] > 0 and got["torch"]["parked"]


def _fake_snapshot(pkg, d, rank, ewma, last_seconds):
    import json
    payload = {
        "rank": rank, "pid": 1000 + rank, "time": time.time(),
        "counters": {"trainer.steps_total": 5},
        "gauges": {"fleet.peers_alive": 2},
        "insight": {
            "executables": {"parallel.train_step": {
                "name": "parallel.train_step", "flops": 1e9,
                "last_seconds": last_seconds, "mfu": 0.1}},
            "drift": {"trainer.step": {"source": "trainer.step",
                                       "ewma": ewma, "degraded": False,
                                       "events": 0}},
            "drift_events": []}}
    with open(os.path.join(d, f"insight-{rank}.json"), "w") as f:
        f.write(json.dumps(payload))


def test_insight_straggler_ratio_and_heartbeat_snapshot_match_jax(
        tmp_path):
    """tests/test_insight.py:353-381: relative slowness marks host 1 a
    straggler (kept alive); the heartbeat writes a rate-limited
    snapshot."""
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        pkg.insight.enable()
        d = str(tmp_path / name)
        a = pkg.fleet.HealthPlane(rank=0, nprocs=2, lease_dir=d)
        b = pkg.fleet.HealthPlane(rank=1, nprocs=2, lease_dir=d)
        a.beat(step=1)
        b.beat(step=1)
        written = pkg.telemetry.counters(aggregate=True).get(
            "insight.snapshots_written_total", 0)
        a.beat(step=2)
        again = pkg.telemetry.counters(aggregate=True).get(
            "insight.snapshots_written_total", 0)
        _fake_snapshot(pkg, d, 0, 0.1, 0.10)
        _fake_snapshot(pkg, d, 1, 0.5, 0.25)
        rel = pkg.insight.relative_slowness(d)
        alive = a.check_peers()
        got[name] = {"rel": {k: round(v, 12) for k, v in rel.items()},
                     "alive": alive, "stragglers": sorted(a._stragglers),
                     "written": [written, again],
                     "gauge": pkg.telemetry.snapshot()["gauges"].get(
                         "fleet.stragglers")}
        a.stop()
        b.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"]["stragglers"] == [1]
    # one snapshot, then the heartbeats inside the interval write none
    assert got["torch"]["written"] == [1, 1]


# -- the two-process lease drill ----------------------------------------------

def test_multiprocess_lease_expiry_raises_worker_lost(tmp_path):
    """Two real processes share a lease dir; rank 1 heartbeats, then
    vanishes without a clean stop; rank 0's plane escalates WorkerLost."""
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in [k for k in env if k.startswith("DMLC_")]:
        env.pop(k)
    worker = os.path.join(REPO, "tests", "torch_fleet_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(tmp_path), str(rank), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[1].returncode == 0 and "FLEET_BEAT 1" in outs[1], outs[1]
    assert procs[0].returncode == 0, outs[0]
    assert "FLEET_LOST 0 lease host-1" in outs[0], outs[0]


# -- the gloo worlds: the stranded rank and the degrade drill -----------------

def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[..., None], axis=-1).mean()


def _jax_step(cfg):
    """tests/test_fleet.py:271-280."""
    from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM
    mx.random.seed(0)
    net = GPTForCausalLM(vocab_size=64, units=16, num_layers=2, num_heads=2,
                         max_length=8, dropout=0.0, embed_dropout=0.0)
    net.initialize()
    net(mx.np.array(W.fleet_batch(0)[0]))
    return JStep(net, _jax_loss, mx.optimizer.create(
        "sgd", learning_rate=0.01), cfg, cfg.batch_specs(2, 2), n_labels=1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    cfg = JCfg(dp=2, tp=2, pp=2)
    step_o = _jax_step(cfg)
    sd = step_o.state_dict()
    onp.savez(out / "fleet_init.npz", __n_step__=onp.asarray(sd["n_step"]),
              **{k: onp.asarray(v) for k, v in sd["arrays"].items()})
    env = {"OMP_NUM_THREADS": "1"}
    procs = {"stranded": W.launch(4, "stranded", out, env),
             "fleet": W.launch(8, "fleet", out, env),
             "fleet_lease": W.launch(4, "fleet_lease", out, env)}
    # the reference runs while the worlds train: the oracle, then the drill
    oracle = {s: float(step_o(*W.fleet_batch(s))) for s in range(1, 9)}
    step = _jax_step(cfg)
    state = mx.resilience.TrainState(path=str(out / "jax_run.bundle"),
                                     sharded_step=step)
    mx.telemetry.enable()
    mx.telemetry.reset()
    sup = mx.fleet.FleetSupervisor(step, state, n_hosts=2, host_index=0,
                                   checkpoint_every=1)
    mx.fault.configure("fleet.host_loss:at=4,times=1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        losses = sup.run(W.fleet_batch, 6)
        degraded = _shape(sup.current)
        bundle = pickle.loads(open(state.path, "rb").read())
        mid = sup.step.state_dict()
        bitwise = all(onp.array_equal(onp.asarray(mid["arrays"][k]),
                                      onp.asarray(v))
                      for k, v in bundle["sharded_step"]["arrays"].items())
        sup.restore_hosts()
        losses.update(sup.run(W.fleet_batch, 8))
    counts = mx.telemetry.counters(aggregate=True)
    mx.fault.clear()
    mx.telemetry.disable()
    jdrill = {"losses": {s: float(v) for s, v in losses.items()},
              "degraded": degraded, "final": _shape(sup.current),
              "degrades": sup.degrades, "reexpands": sup.reexpands,
              "bitwise": bitwise,
              "counts": [counts.get("fleet.degrades_total", 0),
                         counts.get("fleet.reexpands_total", 0)]}
    logs = {k: W.finish(p, 240) for k, p in procs.items()}
    return {"out": out, "oracle": oracle, "jax": jdrill, "logs": logs}


def _results(worlds, case, n):
    rc, stdout, stderr = worlds["logs"][case]
    assert rc == 0, f"stdout:\n{stdout[-3000:]}\nstderr:\n{stderr[-6000:]}"
    return [dict(onp.load(worlds["out"] / f"{case}_w{n}_r{r}.npz"))
            for r in range(n)]


def test_stranded_ranks_raise_then_rejoin(worlds):
    res = _results(worlds, "stranded", 4)
    oracle = worlds["oracle"]
    for r, d in enumerate(res):
        assert int(d["stranded"]) == int(d["flag"]) == (r >= 2)
        assert int(d["restored_bitwise"]) == 1 and int(
            d["restored_step"]) == 2
        if r >= 2:
            assert len(d["errors"]) == 4
            for msg in d["errors"]:
                assert msg.startswith(f"rank {r} is stranded"), msg
            assert d["losses"].tolist() == res[0]["losses"][2:].tolist()
        else:
            assert len(d["losses"]) == 3
            for s, loss in zip((1, 2, 3), d["losses"]):
                assert abs(loss - oracle[s]) < LOSS_TOL, (r, s, loss)


def test_degrade_drill_matches_jax(worlds):
    res = _results(worlds, "fleet", 8)
    j = worlds["jax"]
    assert j["degrades"] == 1 and j["reexpands"] == 1 and j["bitwise"]
    assert j["degraded"] == (1, 2, 2, 1) and j["final"] == (2, 2, 2, 1)
    assert sorted(j["losses"]) == list(range(1, 9))
    for r, d in enumerate(res):
        assert tuple(d["degraded_layout"]) == j["degraded"], r
        assert tuple(d["final_layout"]) == j["final"], r
        assert int(d["degrades"]) == j["degrades"]
        assert int(d["reexpands"]) == j["reexpands"]
        assert [int(d["counter_degrades"]),
                int(d["counter_reexpands"])] == j["counts"]
        assert int(d["step_mid"]) == 6
        stranded = r >= 4
        assert int(d["stranded_mid"]) == stranded
        # the layout's ranks restore bit for bit at the degrade and the
        # re-expand; a stranded rank restores only at the re-expand
        assert d["restores"].tolist() == ([-1, 1] if stranded else [1, 1])
        want = [1, 2, 3, 7, 8] if stranded else list(range(1, 9))
        assert d["steps"].tolist() == want, r
        for s, loss in zip(want, d["losses"]):
            assert abs(loss - j["losses"][s]) < LOSS_TOL, (r, s)
            assert abs(loss - worlds["oracle"][s]) < LOSS_TOL, (r, s)
        if stranded:
            assert str(d["stranded_call"]).startswith(
                f"rank {r} is stranded"), d["stranded_call"]


def test_lease_loss_is_agreed_across_ranks(worlds):
    """Host 1's leases go stale from step 3: the rank that sees it first
    decides for all (a max all-reduce each probe), so every rank loses
    host 1 in the same probe, degrades once, and re-expands once."""
    res = _results(worlds, "fleet_lease", 4)
    lost = {int(d["lost_at"][0]) for d in res}
    assert len(lost) == 1 and all(len(d["lost_at"]) == 1 for d in res)
    at = lost.pop()
    assert at in (4, 5)     # the probe after host 1's first stale lease
    for r, d in enumerate(res):
        assert tuple(d["degraded_layout"]) == (1, 2, 1, 1)
        assert int(d["degrades"]) == 1 and int(d["reexpands"]) == 1
        want = ([s for s in range(1, 9) if not at <= s <= 6] if r >= 2
                else list(range(1, 9)))
        assert d["steps"].tolist() == want, r
        for s, loss in zip(want, d["losses"]):
            assert abs(loss - worlds["oracle"][s]) < LOSS_TOL, (r, s)

