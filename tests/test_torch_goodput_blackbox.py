"""Port parity: ``mx.goodput`` and ``mx.blackbox``, JAX package -> port.

goodput: the sweep-line ``resolve_claims`` on the same random claims
(exactly), conservation (buckets sum to the elapsed wall clock), the
ledger's brackets and samples against a fixed clock, burn rates and the
``healthz`` verdict on the same history, and the fleet merge of the same
snapshots. blackbox: a manual bundle's fields, checksum and naming,
retention, the disabled gate, a torn bundle skipped, the event ring's
captured warnings and log records (the port's loggers), and the Trainer's
``nonfinite`` bundle on the reference's ``_mlp()``, with the same
trigger, reason and fault counters in both packages. The port's bundle
adds a ``device`` section (the card, its memory, the CUDA build).
"""
import json
import logging
import os
import warnings

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
    pkg.blackbox.set_context(rank=None, step=None, run=None, serve=None)
    pkg.blackbox._last_exc_id = None
    pkg.config.reset()


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in PKGS.values():
        planes_off(pkg)
    with tmx.cpu():
        yield
    for pkg in PKGS.values():
        planes_off(pkg)


@pytest.fixture
def bundle_dirs(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        pkg.config.set("blackbox.dir", str(d))
        out[name] = str(d)
    return out


# -- goodput -----------------------------------------------------------------

def _random_claims(rs, n, states):
    claims = []
    for _ in range(n):
        a = float(rs.uniform(0, 100))
        claims.append((a, a + float(rs.uniform(0.01, 20)),
                       states[rs.randint(len(states))]))
    return claims


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_claims_matches_jax_exactly(seed):
    rs = onp.random.RandomState(seed)
    claims = _random_claims(rs, 60, mx.goodput.PRIORITY)
    marks = sorted((float(rs.uniform(0, 100)), float(rs.uniform(0.2, 1)))
                   for _ in range(4))
    want = mx.goodput.resolve_claims(claims, 0.0, 110.0, marks)
    got = tmx.goodput.resolve_claims(claims, 0.0, 110.0, marks)
    assert got == want
    assert sum(got.values()) == pytest.approx(110.0, abs=1e-9)
    assert tmx.goodput.STATES == mx.goodput.STATES


def test_ledger_brackets_samples_and_summary_match_jax(monkeypatch):
    got = {}
    for name, pkg in PKGS.items():
        clock = [1000.0]
        monkeypatch.setattr(pkg.goodput.time, "monotonic", lambda: clock[0])
        pkg.config.set("goodput.target", 0.9)
        pkg.goodput.enable()
        pkg.goodput.set_devices(4)
        tok = pkg.goodput.begin("compile")
        clock[0] += 2.0
        pkg.goodput.end(tok)
        clock[0] += 1.0
        pkg.goodput.note("compute", 0.75)
        with pkg.goodput.phase("checkpoint_save"):
            clock[0] += 0.5
        pkg.goodput.set_capacity(2, 4)
        clock[0] += 3.0
        pkg.goodput.note("input_stall", 1.0)
        s = pkg.goodput.summary()
        got[name] = (s, pkg.goodput.burn_rates(), pkg.goodput.healthz(),
                     pkg.goodput.bench_fields())
        assert s["conservation_error_s"] == pytest.approx(0.0, abs=1e-9)
        monkeypatch.undo()
        pkg.goodput.disable()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_goodput_feeds_from_step_histograms(pkg, monkeypatch):
    p = PKGS[pkg]
    clock = [50.0]
    monkeypatch.setattr(p.goodput.time, "monotonic", lambda: clock[0])
    p.telemetry.enable()
    p.goodput.enable()
    for name in ("trainer.step_seconds", "serve.step_seconds",
                 "cached_graph.compile_seconds"):
        clock[0] += 1.0
        p.telemetry.observe(name, 0.25)
    b = p.goodput.summary()["buckets"]
    assert b == {"compute": 0.5, "compile": 0.25, "idle": 2.25}
    assert p.telemetry.health()[1]["goodput"]["ok"]
    p.goodput.disable()
    assert "goodput" not in p.telemetry.health()[1]


def test_snapshot_merge_matches_jax(tmp_path, monkeypatch):
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        for rank, (dev, comp) in enumerate(((4, 3.0), (2, 1.0))):
            payload = {"rank": rank, "pid": 1, "time": 0.0,
                       "summary": {"devices": dev, "elapsed_s": 4.0,
                                   "goodput_fraction": comp / 4.0,
                                   "buckets": {"compute": comp,
                                               "idle": 4.0 - comp}}}
            d.mkdir(exist_ok=True)
            (d / f"goodput-{rank}.json").write_text(json.dumps(payload))
        (d / "goodput-9.json").write_text("{torn")
        merged = pkg.goodput.merge_snapshots(pkg.goodput.read_snapshots(
            str(d)))
        for h in merged["by_host"].values():
            h.pop("age_s")
        got[name] = merged
    assert got["torch"] == got["jax"]
    assert got["torch"]["goodput_fraction"] == pytest.approx(14 / 24)


# -- blackbox ----------------------------------------------------------------

def test_manual_bundle_fields_match_jax(bundle_dirs):
    docs = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        pkg.trace.enable()
        pkg.blackbox.enable()
        pkg.blackbox.set_context(run="unit")
        pkg.telemetry.inc("trainer.steps_total", 2)
        with pkg.trace.span("work", category="test"):
            pass
        pkg.fault.record("trainer.nonfinite_skip")
        path = pkg.blackbox.dump(trigger="manual", reason="operator dump",
                                 step=7, rank=3)
        assert os.path.basename(path) == "blackbox-3-00000007.json"
        assert os.path.exists(path + ".sha256")
        assert pkg.blackbox.latest_bundle(rank=3) == path
        docs[name] = pkg.blackbox.read_bundle(path)
    j, t = docs["jax"], docs["torch"]
    assert set(t) == set(j) | {"device"}
    assert t["schema"] == j["schema"] == mx.blackbox.BUNDLE_SCHEMA
    for key in ("trigger", "reason", "shadow", "rank", "step"):
        assert t["meta"][key] == j["meta"][key], key
    assert t["context"] == j["context"] == {"run": "unit"}
    assert t["fault"] == j["fault"]
    assert t["counters_delta"] == j["counters_delta"]
    assert [s["name"] for s in t["spans"]] == [s["name"] for s in j["spans"]]
    assert t["sync_sites"] == j["sync_sites"]
    assert t["config"]["blackbox.window"] == j["config"]["blackbox.window"]
    assert t["device"]["name"] == "cpu" and t["device"]["memory"] == {}
    assert t["device"]["cuda"] == torch.version.cuda


def test_retention_and_endpoint_report_match_jax(bundle_dirs):
    got = {}
    for name, pkg in PKGS.items():
        pkg.config.set("blackbox.keep", 2)
        pkg.blackbox.enable()
        for s in range(5):
            pkg.blackbox.dump(trigger="manual", step=s, rank=0)
        pkg.blackbox.dump(trigger="manual", step=9, rank=1)
        report = pkg.blackbox.endpoint_report(last=2)
        got[name] = (
            [os.path.basename(p) for p in pkg.blackbox.list_bundles(rank=0)],
            len(pkg.blackbox.list_bundles(rank=1)),
            sorted(f for f in os.listdir(bundle_dirs[name])
                   if f.endswith(".sha256")),
            [(e["valid"], e["step"]) for e in report["bundles"]])
    assert got["torch"] == got["jax"]


def test_torn_bundle_is_skipped_like_jax(bundle_dirs):
    got = {}
    for name, pkg in PKGS.items():
        pkg.blackbox.enable()
        pkg.fault.configure("blackbox.torn_bundle:at=1")
        torn = pkg.blackbox.dump(trigger="manual", step=1, rank=0)
        good = pkg.blackbox.dump(trigger="worker_lost", reason="real crash",
                                 step=2, rank=0)
        with pytest.raises(pkg.base.MXNetError):
            pkg.blackbox.read_bundle(torn)
        got[name] = (pkg.blackbox.latest_bundle(rank=0) == good,
                     pkg.fault.stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is True


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_gate_and_missing_directory(pkg, bundle_dirs):
    p = PKGS[pkg]
    assert not p.blackbox.active()
    assert p.blackbox.list_bundles() == []
    p.config.set("blackbox.dir", "")
    p.blackbox.enable()
    assert p.blackbox.dump(trigger="manual") is None


def test_event_ring_captures_warnings_and_port_logs(bundle_dirs):
    tmx.telemetry.enable()
    tmx.blackbox.enable()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.warn("grad clipped hard", RuntimeWarning)
    logging.getLogger("mxnet_tpu_torch.test").warning("lease slow: %ds", 3)
    logging.getLogger("mxnet_tpu_torch.test").debug("below threshold")
    kinds = {(e["kind"], e["message"]) for e in tmx.telemetry.events()}
    assert any(k == "warning" and "grad clipped hard" in m
               for k, m in kinds)
    assert any(k == "log" and "lease slow: 3s" in m for k, m in kinds)
    assert not any("below threshold" in m for _, m in kinds)
    doc = tmx.blackbox.read_bundle(tmx.blackbox.dump(trigger="manual",
                                                     step=1, rank=0))
    assert any(e["kind"] == "warning" for e in doc["events"])
    tmx.blackbox.disable()
    assert not logging.getLogger("mxnet_tpu_torch").handlers


def test_uncaught_exception_hook_dumps_once(bundle_dirs, capsys):
    import sys
    tmx.blackbox.enable()
    try:
        raise ValueError("boom")
    except ValueError as e:
        sys.excepthook(type(e), e, e.__traceback__)
        sys.excepthook(type(e), e, e.__traceback__)
    paths = tmx.blackbox.list_bundles()
    assert len(paths) == 1
    doc = tmx.blackbox.read_bundle(paths[0])
    assert doc["meta"]["trigger"] == "excepthook"
    assert doc["exception"]["type"] == "ValueError"
    tmx.blackbox.disable()
    assert sys.excepthook is not tmx.blackbox._excepthook


def test_nonfinite_step_bundle_matches_jax(bundle_dirs):
    mx.random.seed(0)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(32, activation="relu"), mx.gluon.nn.Dense(3))
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.ones((1, 16)))
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(32, activation="relu"),
             tmx.gluon.nn.Dense(3))
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    got = {}
    for name, pkg, net in (("jax", mx, jnet), ("torch", tmx, tnet)):
        pkg.config.set("trainer.skip_nonfinite", True)
        pkg.telemetry.enable()
        pkg.blackbox.enable()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        pkg.fault.configure("invoke.nan_output:at=1,times=1")
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.np.ones((4, 16))),
                           pkg.np.array(onp.zeros(4, "int32")))
        pkg.fault.clear()
        loss.backward()
        trainer.step(4)
        paths = pkg.blackbox.list_bundles()
        assert len(paths) == 1
        doc = pkg.blackbox.read_bundle(paths[0])
        got[name] = ({k: doc["meta"][k] for k in ("trigger", "reason",
                                                  "rank", "step")},
                     doc["fault"], doc["counters_delta"].get(
                         "trainer.nonfinite_total"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["trigger"] == "nonfinite"
