"""On-card checks of ``mx.servefleet`` (marker ``cuda``).

What only a card can show: a dead replica's graphs, their memory pool,
its KV cache and its weights give their card memory back once its
failover is done, so a crash-and-rebuild cycle ends holding one engine's
allocated bytes, not two (read as allocated bytes: the caching
allocator keeps reserved segments that earlier tests left partly used,
so the reservation need not fall back); and a 2-replica fleet of CUDA-graph engines gives
one engine's greedy tokens request for request, with nothing captured
after ``warmup()``. They skip without a card (decided in the
``cuda_device`` fixture). This file imports neither JAX nor the JAX
package, so it runs on the card's machine with ``--noconftest``.
"""
import gc

import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import servefleet

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=16384, units=768, hidden_size=3072, num_layers=4,
           num_heads=12, max_length=256, dropout=0.0, embed_dropout=0.0)
ENGINE_KW = dict(max_slots=4, buckets="8,16", temperature=0.0)
#: the allocated bytes after a sole replica's crash-and-rebuild over
#: those with that replica: the rebuilt replica's own plus at most this
#: share of one engine's, not two engines
MEM_SLACK = 0.1


def _allocated():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    yield torch.device("cuda", 0)
    tmx.fault.clear()
    tmx.fault.reset_stats()
    tmx.telemetry.unregister_health("serve")
    gc.collect()
    torch.cuda.empty_cache()


def _factory():
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
    return GPTForCausalLM(device="cuda:0", **CFG).initialize(seed=3)


def _prompts():
    g = torch.Generator().manual_seed(0)
    return [torch.randint(1, CFG["vocab_size"], (n,), generator=g).tolist()
            for n in (3, 7, 9, 14, 5, 16, 2, 11)]


def test_dead_replica_returns_its_card_memory(cuda_device):
    bare = _allocated()
    fleet = servefleet.ServeFleet(_factory, replicas=1, min_replicas=1,
                                  **ENGINE_KW)
    try:
        one = _allocated()
        tmx.fault.configure("serve.replica_crash:at=2")
        frs = [fleet.submit(p, max_new_tokens=8, session=f"s{i}")
               for i, p in enumerate(_prompts())]
        fleet.run(max_ticks=2000)
        assert all(fr.done and len(fr.tokens) == 8 for fr in frs)
        states = sorted(r.state for r in fleet._replicas.values())
        assert states == ["dead", "live"]
        dead = [r for r in fleet._replicas.values() if r.state == "dead"][0]
        assert dead.engine._exe == {} and dead.engine._cache is None
        after = _allocated()
        assert after <= one + MEM_SLACK * (one - bare), (bare, one, after)
    finally:
        fleet.close()


def test_two_replica_fleet_tokens_equal_one_engine(cuda_device):
    eng = tmx.serve.load(_factory(), **ENGINE_KW).warmup()
    prompts = _prompts()
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    want = [r.generated for r in reqs]
    del eng
    fleet = servefleet.ServeFleet(_factory, replicas=2, **ENGINE_KW)
    try:
        frs = [fleet.submit(p, max_new_tokens=8, session=f"u{i}")
               for i, p in enumerate(prompts)]
        fleet.run(max_ticks=2000)
        assert [fr.tokens for fr in frs] == want
        assert len({fr.replica_id for fr in frs}) == 2
        for rep in fleet._live():
            assert rep.engine.post_warmup_compiles == 0
    finally:
        fleet.close()
