"""Port parity: ``mx.telemetry`` and its wiring, JAX package -> PyTorch port.

The reference's scenarios (tests/test_telemetry.py) run through both
packages with the same inputs and are compared: the exposition text, the
``snapshot()`` keys and counts, ``quantiles`` on the same samples
(exactly), the recompile detector, the ``TrainingTelemetry`` records, the
plane knobs' declarations, the ops endpoint's routes, and the Gluon cases
with the weights carried across by ``functional``: ``_mlp()``'s forward
``invoke.ops_total``, the cached graph's hit, miss and compile counts, and
the Trainer's ``steps_total``, ``step_seconds`` count and ``grad_norm``
after ``drain_telemetry()``. Every test leaves every plane of both packages
off (autouse fixture), so no later file on the worker inherits one.
"""
import json
import urllib.error
import urllib.request
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
PLANE_KNOBS = [
    "profiler.autostart", "fault.spec", "telemetry.enable",
    "telemetry.recompile_limit", "telemetry.jsonl",
    "telemetry.step_interval", "telemetry.http_port",
    "telemetry.report_max_bytes", "telemetry.event_ring", "trace.enable",
    "trace.buffer", "pipeline.deferred_window", "insight.enable",
    "insight.drift_window", "insight.drift_sigma",
    "insight.snapshot_interval", "insight.input_bound_ratio",
    "insight.straggler_ratio", "blackbox.enable", "blackbox.dir",
    "blackbox.window", "blackbox.checkpoint_interval", "blackbox.keep",
    "goodput.enable", "goodput.target", "goodput.burn_threshold",
    "goodput.snapshot_interval", "serve.health_window",
    "serve.slo_ttft_ms", "serve.slo_tpot_ms", "serve.slo_target",
    "serve.phase_sampling", "fleet.lease_dir"]


def planes_off(pkg):
    """Every host plane of ``pkg`` off and emptied."""
    pkg.profiler.set_state("stop")
    pkg.profiler._events.clear()
    pkg.telemetry.stop_http()
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
    """The reference tests' ``_mlp()`` in both packages, same weights."""
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


def _record_same(pkg):
    t = pkg.telemetry
    t.enable()
    t.inc("kvstore.collective_total", op="allreduce")
    t.inc("kvstore.collective_total", 2, op="reconcile")
    t.set_gauge("dataloader.queue_depth", 4)
    for v in (0.0002, 0.003, 2.0, 0.04, 0.04, 7.5):
        t.observe("trainer.step_seconds", v)
    t.observe("trainer.grad_norm", 3.5)
    t.inc("auto.registered_total")
    return t


def test_registry_exposition_snapshot_and_quantiles_match_jax():
    out = {}
    for name, pkg in PKGS.items():
        t = _record_same(pkg)
        snap = t.snapshot()
        out[name] = (t.exposition(), snap["counters"], snap["gauges"],
                     snap["histograms"], t.quantiles("trainer.step_seconds"),
                     t.quantiles("trainer.step_seconds", qs=(0.1, 0.75)),
                     t.counters(aggregate=True), t.summary_line())
        json.dumps(snap)
    assert out["torch"] == out["jax"]
    assert out["torch"][4] is not None


def test_quantiles_exact_on_random_samples():
    rs = onp.random.RandomState(3)
    samples = rs.lognormal(-5, 2, 500).tolist()
    qs = (0.01, 0.5, 0.9, 0.95, 0.99, 0.999)
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        for v in samples:
            pkg.telemetry.observe("serve.ttft_seconds", v)
        got[name] = pkg.telemetry.quantiles("serve.ttft_seconds", qs=qs)
    assert got["torch"] == got["jax"]


def test_plane_knobs_match_reference_declarations():
    jk, tk = mx.config.knobs(), tmx.config.knobs()
    for name in PLANE_KNOBS:
        j, t = jk[name], tk[name]
        assert (t.typ, t.default, t.env, t.doc) == \
            (j.typ, j.default, j.env, j.doc), name


def test_catalog_declares_reference_metrics():
    """Every metric the ported planes declare carries the reference's
    kind and buckets (auto-registered names aside: another test may have
    recorded one)."""
    import mxnet_tpu.serve.engine  # noqa: F401  (declares serve.*)
    import mxnet_tpu_torch.serve.engine  # noqa: F401
    for name, (kind, doc, buckets) in tmx.telemetry.CATALOG.items():
        if name in mx.telemetry.CATALOG and doc != "(auto-registered)":
            jkind, _, jbuckets = mx.telemetry.CATALOG[name]
            assert (kind, buckets) == (jkind, jbuckets), name


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_hooks_are_noops(pkg):
    t = PKGS[pkg].telemetry
    assert not t.active()
    t.inc("trainer.steps_total")
    t.observe("trainer.step_seconds", 1.0)
    t.set_gauge("dataloader.queue_depth", 3)
    assert t.counters() == {} and t.exposition() == ""
    assert t.record_memory() == {}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_metric_kind_mismatch_raises(pkg):
    t = PKGS[pkg].telemetry
    t.enable()
    t.inc("trainer.steps_total")
    with pytest.raises(PKGS[pkg].base.MXNetError, match="is a counter"):
        t.observe("trainer.steps_total", 1.0)


def test_record_memory_without_card_is_empty():
    tmx.telemetry.enable()
    assert tmx.telemetry.record_memory() == {}
    assert tmx.telemetry.record_memory(devices=["cpu"]) == {}


def test_mlp_forward_counts_the_same_ops():
    nets = _mlp_pair()
    x = onp.random.RandomState(0).rand(4, 16).astype("float32")
    counts = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        nets[name](pkg.np.array(x))
        fwd = pkg.telemetry.counters(aggregate=True)["invoke.ops_total"]
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(nets[name](pkg.np.array(x)),
                           pkg.np.array(onp.array([0, 1, 2, 0], "int32")))
        loss.backward()
        counts[name] = (fwd, pkg.telemetry.counters(
            aggregate=True)["invoke.ops_total"])
    assert counts["torch"] == counts["jax"] == (3, 7)


def test_cached_graph_hit_miss_and_compile_counts_match_jax():
    nets = _mlp_pair()
    got = {}
    for name, pkg in PKGS.items():
        net = nets[name]
        net.hybridize()
        pkg.telemetry.enable()
        for bs in (4, 4, 4, 2, 4):
            net(pkg.np.ones((bs, 16)))
        # the JAX package's compile-cache counters aside
        agg = {k: v for k, v in pkg.telemetry.counters(
            aggregate=True).items() if not k.startswith("compile.")}
        hist = pkg.telemetry.snapshot()["histograms"][
            'cached_graph.compile_seconds{block="HybridSequential"}']
        gauges = pkg.telemetry.snapshot()["gauges"]
        got[name] = (agg, hist["count"],
                     gauges['cached_graph.signatures{block='
                            '"HybridSequential"}'])
        assert hist["sum"] > 0
    assert got["torch"] == got["jax"]
    agg = got["torch"][0]
    assert (agg["cached_graph.cache_miss_total"],
            agg["cached_graph.cache_hit_total"],
            agg["cached_graph.compile_total"],
            agg["invoke.ops_total"]) == (2, 3, 2, 6)


def test_recompile_detector_fires_exactly_once_in_both():
    nets = _mlp_pair()
    seen = {}
    for name, pkg in PKGS.items():
        pkg.config.set("telemetry.recompile_limit", 2)
        pkg.telemetry.enable()
        net = nets[name]
        net.hybridize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for bs in (1, 2, 3, 4, 5, 6):
                net(pkg.np.ones((bs, 16)))
        rec = [w.message for w in caught
               if issubclass(w.category, pkg.telemetry.RecompileWarning)]
        assert len(rec) == 1
        seen[name] = (rec[0].block, rec[0].limit, rec[0].compiles,
                      pkg.telemetry.counters(aggregate=True)[
                          "cached_graph.recompile_warnings_total"])
    assert seen["torch"] == seen["jax"] == ("HybridSequential", 2, 3, 1)


def test_trainer_step_metrics_and_grad_norm_match_jax():
    nets = _mlp_pair()
    x = onp.random.RandomState(1).rand(8, 16).astype("float32")
    y = onp.array([0, 1, 2, 0, 1, 2, 0, 1], "int32")
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        net = nets[name]
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1e-2})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.np.array(x)), pkg.np.array(y))
            loss.backward()
            trainer.step(8)
        before = pkg.telemetry.snapshot()["histograms"]
        trainer.drain_telemetry()
        snap = pkg.telemetry.snapshot()
        got[name] = (pkg.telemetry.counters(aggregate=True)[
            "trainer.steps_total"],
            snap["histograms"]["trainer.step_seconds"]["count"],
            "trainer.grad_norm" in before,
            snap["histograms"]["trainer.grad_norm"]["count"],
            snap["histograms"]["trainer.grad_norm"]["sum"])
    assert got["torch"][:4] == got["jax"][:4] == (3, 3, False, 3)
    assert got["torch"][4] == pytest.approx(got["jax"][4], rel=1e-5)


def test_grad_norm_is_deferred_no_host_sync_on_step():
    """With telemetry on, a step's grad norm waits in the DeferredWindow:
    the sync guard sees no host read until drain_telemetry()."""
    net = _mlp_pair()["torch"]
    tmx.telemetry.enable()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1e-2})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = tmx.np.ones((4, 16)), tmx.np.array(onp.zeros(4, "int32"))
    with tmx.pipeline.sync_guard() as g:
        for _ in range(3):
            with tmx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(4)
    assert g.count == 0, g.sites
    assert len(trainer._norm_window) == 3
    with tmx.pipeline.sync_guard() as g:
        trainer.drain_telemetry()
    assert len(trainer._norm_window) == 0
    assert tmx.telemetry.snapshot()["sync_sites"] == {}


def test_sync_site_counts_match_jax_deferred_window():
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        win = pkg.pipeline.DeferredWindow(window=2)
        seen = []
        for i in range(5):
            win.push(float(i), seen.append)
        win.drain()
        got[name] = (seen, pkg.telemetry.snapshot()["sync_sites"],
                     pkg.telemetry.counters(aggregate=True))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == {"deferred_evict": 3}


def test_training_telemetry_records_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        rep = pkg.telemetry.TrainingTelemetry(path=path, interval=2,
                                              run_id="r")
        for i in range(4):
            pkg.telemetry.inc("trainer.steps_total")
            rep.step(loss=float(i))
        rep.mark("epoch", epoch=1)
        report = rep.close()
        records = pkg.telemetry.TrainingTelemetry.read(path)
        # the planes the port lacks (autotune, analyze) aside: the
        # reference's report has them after an in-process run of either
        got[name] = ([(r["type"], r.get("step"), r.get("loss"))
                      for r in records],
                     sorted(k for k in report
                            if k not in ("autotune", "analyze")),
                     report["metrics"]["counters"])
        assert not pkg.telemetry.active()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_profiler_run_auto_enables_telemetry(pkg):
    p = PKGS[pkg]
    p.profiler.set_state("run")
    assert p.telemetry.active()
    p.profiler.set_state("stop")
    assert not p.telemetry.active()
    p.telemetry.enable()
    p.profiler.set_state("run")
    p.profiler.set_state("stop")
    assert p.telemetry.active()


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_ops_endpoint_routes_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        _record_same(pkg)
        pkg.trace.enable()
        with pkg.trace.span("a.b", category="cat"):
            pass
        pkg.config.set("blackbox.dir", str(tmp_path / name))
        port = pkg.telemetry.serve_http(0).server_address[1]
        res = {}
        for path in ("/metrics", "/healthz", "/trace?last=5&category=cat",
                     "/trace?last=x", "/insight", "/goodput", "/servefleet",
                     "/postmortem?last=2", "/nope"):
            code, ctype, body = _get(port, path)
            if path == "/metrics":
                body = body.count("\n")
            elif ctype == "application/json":
                doc = json.loads(body)
                body = sorted(doc)
                if path.startswith("/trace?last=5"):
                    body = [s["name"] for s in doc["spans"]]
                if path == "/servefleet":
                    body = doc
            res[path] = (code, ctype, body)
        got[name] = res
        pkg.telemetry.stop_http()
    assert got["torch"] == got["jax"]
    assert got["torch"]["/healthz"][0] == 200
    assert got["torch"]["/nope"][0] == 404
