"""On-card checks of the host planes (marker ``cuda``).

What only a card can show: the profiler's device trace holds the flash
kernels by their kernel names, next to the host's ``"operator"`` spans;
``telemetry.record_memory`` reads the allocator's counters as
``torch.cuda.memory_stats`` does; a hybridized block's ops count once per
capture, and an armed ``invoke.nan_output`` corrupts neither the capture
nor a replay; the serve engine's graphs are built and registered with
every plane on, their cost counted with the kernels' own FLOPs, and
nothing is built after ``warmup()``. They skip without a card (decided in
the ``cuda_device`` fixture). This file imports neither JAX nor the JAX
package, so it runs on the card's machine with ``--noconftest``.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)


def planes_off():
    tmx.profiler.set_state("stop")
    tmx.profiler._events.clear()
    tmx.profiler.set_config(tensorboard_dir=None)
    tmx.telemetry.disable()
    tmx.telemetry.reset()
    tmx.trace.disable()
    tmx.trace.clear()
    tmx.fault.clear()
    tmx.fault.reset_stats()
    tmx.insight.disable()
    tmx.insight.reset()
    tmx.goodput.disable()
    tmx.blackbox.disable()
    tmx.telemetry.unregister_health("serve")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    planes_off()


def _gpt(device, seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
    return GPTForCausalLM(device=device, **CFG).initialize(seed=seed)


def _batch(device):
    ids = torch.from_numpy(onp.random.RandomState(0).randint(
        0, CFG["vocab_size"], (2, 33))).to(device)
    return ids[:, :-1], ids[:, 1:]


def _step(net, x, y, trainer, loss_fn):
    with tmx.autograd.record():
        loss = loss_fn(net(x), y)
    tmx.autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss


def test_device_trace_holds_the_flash_kernels(cuda_device, tmp_path):
    net = _gpt(cuda_device)
    x, y = _batch(cuda_device)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adamw",
                                {"learning_rate": 1e-3})
    _step(net, x, y, trainer, loss_fn)  # kernel builds outside the trace
    tmx.profiler.set_config(tensorboard_dir=str(tmp_path / "tb"))
    tmx.profiler.set_state("run")
    for _ in range(2):
        _step(net, x, y, trainer, loss_fn)
    torch.cuda.synchronize()
    tmx.profiler.set_state("stop")
    with open(tmx.profiler.device_trace_file()) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        # the profiler drops device events now and then: at most the
        # launches, and most of them
        n = sum(name in k for k in kernels)
        assert CFG["num_layers"] <= n <= 2 * CFG["num_layers"], (name, n)
    ops = {e["name"] for e in tmx.profiler._events
           if e["cat"] == "operator"}
    assert {"fully_connected", "layer_norm"} <= ops, ops


def test_record_memory_reads_the_allocator(cuda_device):
    tmx.telemetry.enable()
    keep = torch.empty(1 << 20, device=cuda_device)
    got = tmx.telemetry.record_memory()
    stats = torch.cuda.memory_stats(cuda_device)
    entry = got[str(cuda_device.index)]
    assert entry["live"] == stats["allocated_bytes.all.current"]
    assert entry["peak"] == stats["allocated_bytes.all.peak"]
    assert entry["limit"] == torch.cuda.mem_get_info(cuda_device)[1]
    gauges = tmx.telemetry.snapshot()["gauges"]
    assert gauges['memory.bytes_in_use{device="0"}'] == entry["live"]
    del keep


def test_capture_counts_ops_once_and_never_corrupts(cuda_device):
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(32, activation="relu", in_units=16,
                               device=cuda_device),
            tmx.gluon.nn.Dense(3, in_units=32, device=cuda_device))
    net.initialize(tmx.init.Xavier())
    x = torch.ones((4, 16), device=cuda_device)
    want = net(x)
    net.hybridize()
    tmx.telemetry.enable()
    tmx.fault.configure("invoke.nan_output:prob=1.0")
    outs = [net(x) for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs:
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    agg = tmx.telemetry.counters(aggregate=True)
    assert agg["invoke.ops_total"] == 3  # the warm-up run's ops, once
    assert agg["cached_graph.compile_total"] == 1
    assert agg["cached_graph.cache_hit_total"] == 2
    assert tmx.fault.stats()["injected.invoke.nan_output"] == 3
    assert net._cached_graph.captures == 1


def test_serve_graphs_built_and_registered_with_every_plane_on(cuda_device):
    net = _gpt(cuda_device)
    for plane in (tmx.telemetry, tmx.trace, tmx.insight, tmx.goodput):
        plane.enable()
    tmx.fault.configure("invoke.nan_output:prob=1.0")
    eng = tmx.serve.load(net, max_slots=4, buckets="8,16", warmup=True)
    exes = tmx.insight.attribution()["executables"]
    assert sorted(exes) == ["serve.decode", "serve.prefill_16",
                            "serve.prefill_8"]
    assert exes["serve.prefill_16"]["flops"] > \
        exes["serve.prefill_8"]["flops"] > 0
    assert exes["serve.decode"]["flops"] > 0
    tmx.fault.clear()
    reqs = [eng.submit(list(range(1, n + 1)), max_new_tokens=4)
            for n in (3, 9, 14)]
    eng.run()
    assert eng.post_warmup_compiles == 0
    assert all(len(r.generated) == 4 for r in reqs)
    agg = tmx.telemetry.counters(aggregate=True)
    assert agg["serve.completed_total"] == 3
    assert tmx.telemetry.snapshot()["histograms"][
        "serve.ttft_seconds"]["count"] == 3
    eng.stop()


def test_count_adds_the_flash_kernels_flops(cuda_device):
    q, k, v = (torch.randn(6, 64, 64, device=cuda_device) for _ in range(3))
    with tmx.insight.count() as cost:
        out, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert cost["flops"] == 4 * 64 * 6 * (64 * 65 // 2)
