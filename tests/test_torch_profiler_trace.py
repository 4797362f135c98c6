"""Port parity: ``mx.profiler`` and ``mx.trace``, JAX package -> port.

The reference's scenarios (tests/test_profiler.py, tests/test_trace.py)
through both packages: op span names of eager ``mx.np`` ops, of every
ported ``npx`` op (given arrays, and given tensors as the layers call
them) and of the reference's ``_mlp()`` forward (the layers' ops under the
reference's ``_invoke`` names), the ``CachedOp:`` span of a hybridized call, the
``profile_imperative`` gate, scopes, ``dumps``; span trees by names and
links (nesting, async handles, ``emit``, ring eviction, export, profiler
mirroring, the Trainer's ``train.drain`` span); and, in the port alone,
the ``tensorboard_dir`` device trace, here over the CPU activity (a card
adds its kernels: ``tests/test_torch_planes_cuda.py``).
"""
import json
import os
import threading

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
    pkg.profiler.set_config(profile_imperative=True, profile_symbolic=True,
                            tensorboard_dir=None, filename="profile.json")
    pkg.telemetry.disable()
    pkg.telemetry.reset()
    pkg.trace.disable()
    pkg.trace.clear()
    pkg.trace.configure()
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


def _names(pkg, cat=None):
    return [e["name"] for e in pkg.profiler._events
            if cat is None or e["cat"] == cat]


def test_np_op_span_names_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        pkg.profiler.set_state("run")
        a = pkg.np.ones((8, 8))
        pkg.np.matmul(a, a)
        a + a
        pkg.np.tanh(a).sum()
        a.reshape(4, 16).T
        pkg.profiler.set_state("stop")
        f = tmp_path / f"{name}.json"
        pkg.profiler.set_config(filename=str(f))
        pkg.profiler.dump()
        with open(f) as fh:
            dumped = [e["name"] for e in json.load(fh)["traceEvents"]]
        got[name] = (_names(pkg, "operator"), dumped)
    assert got["torch"][0] == got["jax"][0]
    assert "matmul" in got["torch"][1]


def test_mlp_layer_op_span_names_match_jax():
    nets = _mlp_pair()
    x = onp.random.RandomState(0).rand(4, 16).astype("float32")
    got = {}
    for name, pkg in PKGS.items():
        pkg.profiler.set_state("run")
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss_fn(nets[name](pkg.np.array(x)),
                    pkg.np.array(onp.zeros(4, "int32")))
        pkg.profiler.set_state("stop")
        got[name] = _names(pkg, "operator")
    assert got["torch"] == got["jax"] == [
        "fully_connected", "activation:relu", "fully_connected",
        "sparse_softmax_xent"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_nothing_recorded_when_stopped(pkg):
    p = PKGS[pkg]
    a = p.np.ones((4, 4))
    p.np.matmul(a, a)
    assert not p.profiler._events


def test_cachedop_span_recorded_like_jax():
    got = {}
    for name, pkg in PKGS.items():
        net = pkg.gluon.nn.Dense(4, in_units=8)
        net.initialize()
        net.hybridize()
        x = pkg.np.ones((2, 8))
        net(x)
        pkg.profiler.set_state("run")
        net(x)
        net(x)
        pkg.profiler.set_state("stop")
        got[name] = [(e["name"], e["cat"]) for e in pkg.profiler._events]
    assert got["torch"] == got["jax"] == [("CachedOp:Dense", "symbolic")] * 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_profile_imperative_flag_gates_op_spans(pkg):
    p = PKGS[pkg]
    p.profiler.set_config(profile_imperative=False)
    p.profiler.set_state("run")
    a = p.np.ones((4, 4))
    p.np.matmul(a, a)
    p.profiler.set_state("stop")
    assert not any(e["name"] == "matmul" for e in p.profiler._events)


def test_scope_append_mode_and_event_tagging_match_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.profiler.set_state("run")
        with pkg.profiler.scope("outer:"):
            with pkg.profiler.scope("inner:", append_mode=True):
                assert pkg.profiler.current_scope() == "outer:inner"
                pkg.np.ones((4, 4)) + 1
            with pkg.profiler.scope("replaced:"):
                pass
        pkg.profiler.set_state("stop")
        got[name] = [(e["name"], e["cat"], e["args"].get("scope"))
                     for e in pkg.profiler._events]
    assert got["torch"] == got["jax"]


def test_dumps_json_rows_match_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.profiler.set_state("run")
        a = pkg.np.ones((8, 8))
        for _ in range(3):
            pkg.np.matmul(a, a)
        a + a
        pkg.profiler.set_state("stop")
        rows = json.loads(pkg.profiler.dumps(format="json",
                                             sort_by="calls"))["aggregates"]
        got[name] = [(r["name"], r["calls"]) for r in rows]
        table = pkg.profiler.dumps(sort_by="name", ascending=True)
        assert table.splitlines()[1].startswith("add")
        with pytest.raises(pkg.base.MXNetError):
            pkg.profiler.dumps(sort_by="bogus")
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_domain_task_counter_marker_event(pkg):
    p = PKGS[pkg].profiler
    p.set_state("run")
    dom = p.Domain("d")
    task = p.Task(dom, "t")
    task.start()
    task.stop()
    c = p.Counter(dom, "c", 1)
    c.increment(2)
    p.Marker(dom, "m").mark()
    ev = p.Event("e")
    ev.start()
    ev.stop()
    p.set_state("stop")
    assert [(e["name"], e["cat"]) for e in p._events] == [
        ("t", "task:d"), ("c", "counter:d"), ("m", "marker:d"),
        ("e", "event")]


def _tree(spans):
    """Span names with their parent's name, in record order."""
    by_id = {s["args"]["span_id"]: s["name"] for s in spans}
    return [(s["name"], s["cat"], by_id.get(s["args"].get("parent_id")),
             s["args"]["trace_id"] == s["args"]["span_id"]) for s in spans]


def test_span_trees_match_jax():
    got = {}
    for name, pkg in PKGS.items():
        tr = pkg.trace
        tr.enable()
        with tr.span("outer", category="test", step=1):
            with tr.span("inner", items=3):
                assert tr.current_context() is not None
        root = tr.begin("req", category="test", request=7)
        child = tr.begin("phase", parent=root.context, request=7)
        t = threading.Thread(target=child.end, kwargs={"tokens": 3})
        t.start()
        t.join()
        tr.emit("leaf", tr.clock_us() - 50, 40, parent=root.context,
                category="test", n=1)
        root.end()
        root.end()
        with tr.attach(root.context):
            with tr.span("attached"):
                pass
        assert tr.current_context() is None
        spans = tr.spans()
        got[name] = (_tree(spans), [s["args"].get("items") for s in spans],
                     spans[3]["dur"],
                     tr.stats())
    assert got["torch"] == got["jax"]


def test_ring_eviction_counts_dropped_like_jax():
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        pkg.trace.enable(buffer=8)
        for i in range(20):
            pkg.trace.emit(f"ev{i}", i, 1)
        got[name] = ([e["name"] for e in pkg.trace.spans()],
                     pkg.trace.stats(),
                     pkg.telemetry.counters(aggregate=True))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["dropped"] == 12


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_is_a_cheap_noop(pkg):
    tr = PKGS[pkg].trace
    sp = tr.span("never", x=1)
    with sp as got:
        assert got.set(y=2) is got
    assert tr.begin("never") is None
    tr.emit("never", 0, 0)
    assert tr.spans() == [] and tr.ingest([{}]) == 0


def test_export_and_profiler_mirroring_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        assert pkg.trace.clock_us is pkg.profiler.now_us
        pkg.trace.enable()
        pkg.profiler.set_state("run")
        with pkg.trace.span("mirrored", category="test"):
            pass
        pkg.profiler.set_state("stop")
        ev = pkg.trace.spans()[-1]
        mirrored = [e for e in pkg.profiler._events
                    if e["name"] == "mirrored"]
        assert mirrored[-1]["ts"] == ev["ts"]
        path = pkg.trace.export(str(tmp_path / f"{name}.json"))
        with open(path) as f:
            doc = json.load(f)
        got[name] = ([m["cat"] for m in mirrored], sorted(doc),
                     [e["name"] for e in doc["traceEvents"]])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["trace:test"]


def test_trainer_drain_span_and_pipeline_drain_like_jax():
    nets = _mlp_pair()
    got = {}
    for name, pkg in PKGS.items():
        pkg.telemetry.enable()
        pkg.trace.enable()
        net = nets[name]
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1e-2})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.np.ones((4, 16))),
                               pkg.np.array(onp.zeros(4, "int32")))
            loss.backward()
            trainer.step(4)
        trainer.drain_telemetry()
        spans = pkg.trace.spans()
        got[name] = (_tree(spans), [s["args"].get("pending")
                                    for s in spans])
    assert got["torch"] == got["jax"]
    assert [n for n, *_ in got["torch"][0]] == ["pipeline.drain",
                                                 "train.drain"]


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    p = tmx.profiler
    p.set_config(tensorboard_dir=str(tmp_path / "tb"))
    p.set_state("run")
    assert p._state["device_trace_dir"]
    a = tmx.np.ones((16, 16))
    tmx.np.matmul(a, a)
    tmx.trace.enable()
    with tmx.trace.span("annotated", category="test"):
        tmx.np.tanh(a)
    p.set_state("stop")
    path = p.device_trace_file()
    assert path and path.endswith(".pt.trace.json")
    assert os.path.dirname(path) == str(tmp_path / "tb")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the host spans are record_function ranges of the device trace
    assert {"matmul", "annotated", "tanh"} <= names
    assert "aten::mm" in names
    assert p._state["device_trace"] is None
    # spans enter nothing once the device trace stopped
    p.set_config(tensorboard_dir=None)
    p.set_state("run")
    with p.span("plain"):
        pass
    p.set_state("stop")
    assert p.device_trace_file() == path


def test_device_trace_that_cannot_start_raises(tmp_path):
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    tmx.profiler.set_config(tensorboard_dir=str(blocked / "tb"))
    with pytest.raises(OSError):
        tmx.profiler.set_state("run")
    assert tmx.profiler._state["device_trace"] is None
    assert not tmx.profiler.is_running() and not tmx.telemetry.active()


def _npx_calls(pkg, arr):
    """One call of each ``npx`` op the port has, the reference's way."""
    npx = pkg.npx
    x = arr(onp.random.RandomState(0).rand(2, 3, 8, 8).astype("float32"))
    w = arr(onp.random.RandomState(1).rand(4, 3, 3, 3).astype("float32"))
    v = arr(onp.random.RandomState(2).rand(2, 6).astype("float32"))
    g, b = arr(onp.ones(6, "float32")), arr(onp.zeros(6, "float32"))
    g3, b3 = arr(onp.ones(3, "float32")), arr(onp.zeros(3, "float32"))
    ids = arr(onp.array([[0, 2], [1, 3]], "int32"))
    table = arr(onp.random.RandomState(3).rand(5, 6).astype("float32"))
    return [
        lambda: npx.fully_connected(v, arr(onp.ones((4, 6), "float32")),
                                    arr(onp.zeros(4, "float32")),
                                    num_hidden=4),
        lambda: npx.convolution(x, w, None, kernel=(3, 3), num_filter=4,
                                no_bias=True),
        lambda: npx.pooling(x, kernel=(2, 2), pool_type="avg"),
        lambda: npx.pooling(x, kernel=(2, 2), pool_type="max"),
        lambda: npx.batch_norm(x, g3, b3, arr(onp.zeros(3, "float32")),
                               arr(onp.ones(3, "float32"))),
        lambda: npx.layer_norm(v, g, b),
        lambda: npx.softmax(v),
        lambda: npx.log_softmax(v),
        lambda: npx.activation(v, act_type="tanh"),
        lambda: npx.leaky_relu(v, act_type="elu"),
        lambda: npx.leaky_relu(v, act_type="gelu"),
        lambda: npx.embedding(ids, table, input_dim=5, output_dim=6),
        lambda: npx.pick(v, arr(onp.array([0, 5], "int32"))),
    ]


def test_npx_op_span_names_match_jax():
    """Every ported ``npx`` op called with arrays is named as the
    reference's ``_invoke`` names it; called with tensors (the layers'
    path, ``tensor_ops``), under the same name."""
    got = {}
    for name, pkg in PKGS.items():
        pkg.profiler.set_state("run")
        for call in _npx_calls(pkg, pkg.np.array):
            call()
        pkg.profiler.set_state("stop")
        got[name] = _names(pkg, "operator")
    assert got["torch"] == got["jax"]
    tmx.profiler._events.clear()
    tmx.profiler.set_state("run")
    ops = tmx.npx.tensor_ops

    class _Tensors:
        npx = ops
    for call in _npx_calls(_Tensors, torch.tensor):
        call()
    tmx.profiler.set_state("stop")
    assert _names(tmx, "operator") == got["jax"]
