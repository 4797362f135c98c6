"""Port parity: the serve engine's host planes, JAX package -> port.

The reference tests' 2-layer GPT (vocab 97, 32 units, 2 heads, buckets
"4,8"), weights carried across with ``functional.load_params``, serves the
same requests in both engines with telemetry, trace and the phase
reservoir on, and the planes are compared: the ``serve.*`` counters and
histogram counts (``invoke.ops_total`` aside: the port's GPT runs its
tensor arithmetic outside ``_invoke``, ``ROADMAP.md`` Queue 3), the
``stats()["phases"]`` keys, each request's span tree (a ``serve.request``
root with ``serve.enqueue``, ``serve.prefill``, ``serve.decode_step`` and
``serve.drain`` children), the SLO violations and burn rate, the
rejections of ``stop(drain=False)``, ``serve.prefix_evict`` (the same
outputs, no hits, the same evictions), ``/healthz`` (red while the loop
stalls, red after ``stop()``, the provider gone), the sync count with the
planes on against off, and ``insight.register_executable`` for every
built graph with ``post_warmup_compiles`` 0.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt

torch.set_num_threads(2)

PKGS = {"jax": mx, "torch": tmx}
CFG = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)


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
    pkg.telemetry.unregister_health("serve")


@pytest.fixture(autouse=True)
def _isolated():
    for pkg in PKGS.values():
        planes_off(pkg)
    with tmx.cpu(), _xla_cache_listeners_detached():
        yield
    for pkg in PKGS.values():
        planes_off(pkg)


@contextlib.contextmanager
def _xla_cache_listeners_detached():
    """Detach the JAX package's persistent-compilation-cache listeners
    for the test. Once any test of the process installs them
    (``tests/test_pipeline.py`` does, through
    ``mxnet_tpu._compile_cache._install_listeners``), they stay registered
    with ``jax.monitoring`` for the life of the process and add
    ``compile.persistent_cache_*`` counters to the JAX package's
    telemetry at every later XLA compile, the serve engine's included;
    the port compiles nothing with XLA. Under xdist's ``--dist loadfile``
    they leaked into this file whenever that file ran first on the same
    worker. They are registered again after the test."""
    from jax._src import monitoring
    pairs = ((monitoring.get_event_listeners,
              monitoring.unregister_event_listener,
              monitoring.register_event_listener),
             (monitoring.get_event_duration_listeners,
              monitoring.unregister_event_duration_listener,
              monitoring.register_event_duration_secs_listener))
    detached = []
    for get, unregister, register in pairs:
        for fn in list(get()):
            if getattr(fn, "__module__", "") == "mxnet_tpu._compile_cache":
                unregister(fn)
                detached.append((register, fn))
    try:
        yield
    finally:
        for register, fn in detached:
            register(fn)


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(7)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return {"jax": jnet, "torch": tnet}


def _engine(pkg, net, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("buckets", "4,8")
    if pkg is tmx:
        kw["device"] = "cpu"
    return pkg.serve.load(net, **kw)


def _prompts(n=6, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.randint(1, 97, size=rs.randint(2, 9)).tolist()
            for _ in range(n)]


def _shared(n=8, seed=0):
    rs = onp.random.RandomState(seed)
    shared = rs.randint(1, 97, size=4).tolist()
    return [shared + rs.randint(1, 97, size=rs.randint(2, 5)).tolist()
            for _ in range(n)]


def _serve(pkg, net, prompts, warm=True, max_new=6, **kw):
    eng = _engine(pkg, net, **kw)
    if warm:
        eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return eng, reqs


def _serve_metrics(pkg):
    snap = pkg.telemetry.snapshot()
    counters = {k: v for k, v in snap["counters"].items()
                if not k.startswith("invoke.")}
    hists = {k: v["count"] for k, v in snap["histograms"].items()
             if not k.startswith("cached_graph.")}
    return counters, hists, sorted(snap["gauges"])


def test_serve_counters_and_phases_match_jax(nets):
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        eng, reqs = _serve(pkg, nets[name], _prompts())
        st = eng.stats()
        counters, hists, gauges = _serve_metrics(pkg)
        got[name] = ([r.generated for r in reqs], counters, hists, gauges,
                     sorted(st["phases"]),
                     {k: v is None for k, v in st["phases"].items()},
                     # the port's stats() adds capture_seconds
                     sorted(k for k in st if k != "capture_seconds"))
        assert counters["serve.requests_total"] == len(reqs)
        assert counters["serve.completed_total"] == st["completed"]
        assert counters["serve.tokens_total"] == st["tokens_out"]
        assert hists["serve.ttft_seconds"] == len(reqs)
        assert st["post_warmup_compiles"] == 0
        eng.stop()
    assert got["torch"] == got["jax"]


def test_request_span_trees_match_jax(nets):
    got = {}
    for name, pkg in PKGS.items():
        eng = _engine(pkg, nets[name], warmup=True)
        pkg.trace.enable(buffer=8192)
        reqs = [eng.submit(p, max_new_tokens=4) for p in _prompts(3, 3)]
        eng.run()
        spans = pkg.trace.spans()
        by_id = {s["args"]["span_id"]: s for s in spans}
        trees = {}
        for s in spans:
            parent = by_id.get(s["args"].get("parent_id"))
            if s["name"] == "serve.request":
                assert s["args"]["trace_id"] == s["args"]["span_id"]
                trees.setdefault(s["args"]["request"], []).append(
                    ("root", s["args"]["prompt_tokens"], s["args"]["tokens"]))
            elif parent is not None and parent["name"] == "serve.request":
                assert s["args"]["trace_id"] == parent["args"]["trace_id"]
                assert s["args"]["request"] == parent["args"]["request"]
                trees.setdefault(parent["args"]["request"], []).append(
                    s["name"])
        got[name] = ({k: sorted(map(str, v)) for k, v in trees.items()},
                     sorted({s["name"] for s in spans}),
                     [len(r.generated) for r in reqs])
        for tree in trees.values():
            assert {"serve.enqueue", "serve.prefill", "serve.drain",
                    "serve.decode_step"} <= set(tree)
        eng.stop()
    assert got["torch"] == got["jax"]


def test_slo_violations_and_burn_match_jax(nets):
    got = {}
    for name, pkg in PKGS.items():
        for k, v in (("serve.slo_ttft_ms", 1e-4), ("serve.slo_tpot_ms", 1e-4),
                     ("serve.slo_target", 0.9)):
            pkg.config.set(k, v)
        pkg.telemetry.enable()
        eng, _ = _serve(pkg, nets[name], _prompts(3, 1), max_new=4)
        burn = eng.slo_burn()
        slo = eng.stats()["slo"]
        ok, checks = pkg.telemetry.health()
        viol = {k: v for k, v in pkg.telemetry.counters().items()
                if k.startswith("serve.slo_violations_total")}
        got[name] = (burn, slo, ok, checks["serve"]["state"], viol)
        eng.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {"ttft": 10.0, "tpot": 10.0}
    assert got["torch"][3] == "slo_burn"


def test_stop_without_drain_rejects_like_jax(nets):
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        pkg.trace.enable()
        eng = _engine(pkg, nets[name], max_slots=1)
        reqs = [eng.submit([1, 2, 3], max_new_tokens=2) for _ in range(4)]
        eng.step()
        eng.stop(drain=False)
        with pytest.raises(pkg.serve.engine.EngineBusy):
            eng.submit([4], max_new_tokens=1)
        rejected = {k: v for k, v in pkg.telemetry.counters().items()
                    if k.startswith("serve.rejected_total")}
        got[name] = ([(r.rejected, r.reject_reason) for r in reqs],
                     rejected,
                     sorted(s["args"].get("rejected", False)
                            for s in pkg.trace.spans()
                            if s["name"] == "serve.request"))
    assert got["torch"] == got["jax"]


def test_healthz_tracks_the_step_loop_and_stop(nets):
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        eng = _engine(pkg, nets[name])
        seen = [pkg.telemetry.health()[1]["serve"]["state"]]
        eng.submit([1, 2], max_new_tokens=2)
        pkg.config.set("serve.health_window", 0.0)
        ok, checks = pkg.telemetry.health()
        seen.append((ok, checks["serve"]["state"]))
        pkg.config.set("serve.health_window", 30.0)
        eng.run()
        seen.append(pkg.telemetry.health()[1]["serve"]["ok"])
        eng.stop()
        seen.append((eng._health(), "serve" in pkg.telemetry.health()[1]))
        eng.resume()
        seen.append(pkg.telemetry.health()[1]["serve"]["state"])
        eng.stop()
        got[name] = seen
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == ({"ok": False, "state": "stopping"}, False)


def test_prefix_evict_falls_back_to_full_prefill_like_jax(nets):
    got = {}
    for name, pkg in PKGS.items():
        pkg.config.set("serve.prefix_block", 4)
        plain, preqs = _serve(pkg, nets[name], _shared(), warm=False)
        base = [r.generated for r in preqs]
        plain.stop()
        pkg.telemetry.enable()
        pkg.fault.configure("serve.prefix_evict:prob=1")
        eng, reqs = _serve(pkg, nets[name], _shared(), prefix_cache=True)
        out = [r.generated for r in reqs]
        assert out == base
        st = eng.stats()["prefix"]
        counters = pkg.telemetry.counters()
        got[name] = (out, st, pkg.fault.stats(), {
            k: v for k, v in counters.items()
            if k.startswith("serve.prefix")})
        eng.stop()
    assert got["torch"] == got["jax"]
    st = got["torch"][1]
    assert st["hits"] == 0 and st["evictions"] >= 1
    assert got["torch"][3]["serve.prefix_evictions_total"] >= 1


def test_planes_add_no_host_syncs_to_the_serve_loop(nets):
    net = nets["torch"]

    def syncs(on):
        for plane in (tmx.telemetry, tmx.trace, tmx.insight, tmx.goodput):
            plane.enable(on)
        eng = _engine(tmx, net, warmup=True)
        with tmx.pipeline.sync_guard() as g:
            for p in _prompts(6, 5):
                eng.submit(p, max_new_tokens=5)
            eng.run()
        eng.stop()
        return g.count, g.sites
    off = syncs(False)
    assert syncs(True) == off
    assert off[0] > 0


def test_every_graph_is_registered_and_none_built_after_warmup(nets):
    tmx.telemetry.enable()
    tmx.trace.enable()
    tmx.insight.enable()
    tmx.goodput.enable()
    tmx.blackbox.enable()
    tmx.fault.configure("invoke.nan_output:prob=0.5")
    eng = _engine(tmx, nets["torch"], warmup=True)
    exes = tmx.insight.attribution()["executables"]
    assert sorted(exes) == ["serve.decode", "serve.prefill_4",
                            "serve.prefill_8"]
    assert all(e["kind"] == "serve" and e["flops"] > 0
               for e in exes.values())
    # the warm-up runs probe the fault point and corrupt nothing
    assert tmx.fault.stats().get("injected.invoke.nan_output", 0) > 0
    reqs = [eng.submit(p, max_new_tokens=4) for p in _prompts(5, 2)]
    eng.run()
    assert eng.post_warmup_compiles == 0
    assert all(0 <= t < CFG["vocab_size"] for r in reqs for t in r.generated)
    assert tmx.telemetry.counters(aggregate=True)[
        "cached_graph.compile_total"] == 3
    eng.stop()
    assert "drain" in tmx.goodput.summary()["buckets"]
