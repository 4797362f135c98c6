"""Port parity: the radix prefix cache, speculative decoding, SLO classes
and weight swaps of the serve engine, JAX package -> PyTorch port.

``RadixIndex`` (a copy of ``mxnet_tpu/serve/prefix.py``) runs the five unit
oracles of tests/test_serve_prefix.py in both packages. The engines run
the reference tests' tiny GPT (vocab 97, 32 units, 2 layers, 2 heads,
buckets "4,8", ``serve.prefix_block`` 4), weights carried across with
``functional.load_params``, and are held to the JAX engine: the same
greedy tokens token for token, the same prefix hits, misses and reused
tokens, the same speculative rounds, proposals and acceptances, the same
admission order under SLO classes (strict priority, aging, per-class
queue bounds), the same tokens through an ``update_weights`` ->
``restore_weights`` cycle, and the reference's refusals.
"""
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.serve.engine import EngineBusy as JEngineBusy
from mxnet_tpu.serve.prefix import RadixIndex as JRadix

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serve.engine import EngineBusy
from mxnet_tpu_torch.serve.prefix import RadixIndex as TRadix

torch.set_num_threads(2)

CFG = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)
RADIX = {"jax": (JRadix, mx.MXNetError), "torch": (TRadix, MXNetError)}


# -- radix index unit oracles (tests/test_serve_prefix.py:99-162) -----------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_radix_insert_then_match_strict_prefix(pkg):
    RadixIndex, _ = RADIX[pkg]
    idx = RadixIndex(block=4)
    tokens = list(range(1, 13))
    path = idx.insert(tokens, slot=0)
    assert len(path) == 3 and len(idx) == 3
    assert len(idx.match(tokens + [50])) == 3
    assert len(idx.match(tokens)) == 2
    assert len(idx.match(tokens[:6])) == 1
    assert idx.match([99, 98, 97, 96]) == []


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_radix_diverging_suffix_splits(pkg):
    RadixIndex, _ = RADIX[pkg]
    idx = RadixIndex(block=4)
    pa = idx.insert([1, 2, 3, 4, 5, 6, 7, 8], slot=0)
    pb = idx.insert([1, 2, 3, 4, 9, 9, 9, 9], slot=1)
    assert pa[0] is pb[0]
    assert pa[1] is not pb[1] and len(idx) == 3
    assert pb[0].slot == 0 and pb[1].slot == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_radix_lru_evicts_only_unpinned_leaves(pkg):
    RadixIndex, _ = RADIX[pkg]
    idx = RadixIndex(block=2, capacity=2)
    pa = idx.insert([1, 2, 3, 4], slot=0)
    idx.acquire(pa)
    pb = idx.insert([5, 6, 7, 8], slot=1)
    assert pb == [] and idx.evictions == 0
    idx.release(pa)
    idx.match([1, 2, 9])
    pb = idx.insert([5, 6], slot=1)
    assert len(pb) == 1 and idx.evictions == 1
    assert len(idx.match([1, 2, 9])) == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_radix_refcount_underflow_raises(pkg):
    RadixIndex, err = RADIX[pkg]
    idx = RadixIndex(block=2)
    path = idx.insert([1, 2, 3, 4], slot=0)
    idx.acquire(path)
    idx.release(path)
    with pytest.raises(err, match="refcount"):
        idx.release(path)
    idx.acquire(path)
    idx.evict_slot(0)
    idx.release(path)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_radix_evict_slot_drops_whole_subtree(pkg):
    RadixIndex, _ = RADIX[pkg]
    idx = RadixIndex(block=2)
    idx.insert([1, 2, 3, 4], slot=0)
    idx.insert([1, 2, 5, 6], slot=1)
    assert idx.evict_slot(0) == 3
    assert len(idx) == 0 and idx.match([1, 2, 9]) == []


def test_radix_random_sequence_matches_jax():
    """A seeded run of inserts, matches, pins, releases and slot evictions
    through both indexes: the same paths, heats and counters."""
    rs = onp.random.RandomState(0)
    j, t = JRadix(block=2, capacity=6), TRadix(block=2, capacity=6)
    pins = []
    for _ in range(200):
        op = rs.randint(4)
        toks = rs.randint(1, 4, rs.randint(1, 9)).tolist()
        slot = int(rs.randint(3))
        if op == 0:
            jp, tp = j.insert(toks, slot), t.insert(toks, slot)
            assert [(n.slot, n.row) for n in jp] == \
                [(n.slot, n.row) for n in tp]
            if rs.rand() < 0.5:
                j.acquire(jp)
                t.acquire(tp)
                pins.append((jp, tp))
        elif op == 1:
            assert [(n.slot, n.row) for n in j.match(toks)] == \
                [(n.slot, n.row) for n in t.match(toks)]
        elif op == 2 and pins:
            jp, tp = pins.pop(rs.randint(len(pins)))
            j.release(jp)
            t.release(tp)
        else:
            assert j.evict_slot(slot) == t.evict_slot(slot)
        assert [j.slot_heat(s) for s in range(3)] == \
            [t.slot_heat(s) for s in range(3)]
        assert len(j) == len(t) and j.stats() == t.stats()


# -- engines -----------------------------------------------------------------

def _pair(seed):
    mx.random.seed(seed)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    """(JAX GPT, port GPT) shared by the module: every JAX engine is an XLA
    compile."""
    return _pair(7)


@pytest.fixture(scope="module")
def drafts():
    """A foreign draft: other weights, the same surface."""
    return _pair(8)


@pytest.fixture
def knobs():
    """Set config knobs in both packages for one test."""
    prev = []

    def setter(**kv):
        for name, value in kv.items():
            name = name.replace("__", ".")
            prev.append((name, mx.config.set(name, value),
                         tmx.config.set(name, value)))
    yield setter
    for name, jv, tv in reversed(prev):
        mx.config.set(name, jv)
        tmx.config.set(name, tv)


def _engines(nets, **kw):
    jnet, tnet = nets
    kw.setdefault("max_slots", 4)
    kw.setdefault("buckets", "4,8")
    tkw = dict(kw)
    if kw.get("draft") is not None:
        kw["draft"], tkw["draft"] = kw["draft"]
    return (mx.serve.load(jnet, **kw),
            tmx.serve.load(tnet, device="cpu", warmup=True, **tkw))


def _shared_prefix_work(n=8, prefix_tokens=4, seed=0):
    rng = onp.random.RandomState(seed)
    shared = rng.randint(1, 97, size=prefix_tokens).tolist()
    return [shared + rng.randint(1, 97, size=rng.randint(2, 5)).tolist()
            for _ in range(n)]


def _random_work(n, seed, lo=2, hi=9):
    rng = onp.random.RandomState(seed)
    return [rng.randint(1, 97, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _run(eng, prompts, max_new=6, **submit_kw):
    reqs = [eng.submit(p, max_new_tokens=max_new, **submit_kw)
            for p in prompts]
    eng.run()
    return [r.generated for r in reqs]


def _both(engines, prompts, **kw):
    jeng, teng = engines
    want = _run(jeng, prompts, **kw)
    assert _run(teng, prompts, **kw) == want
    assert teng.post_warmup_compiles == 0
    return want


@pytest.mark.parametrize("work", ["shared", "disjoint", "long_prefix"])
def test_prefix_cache_matches_jax_engine(nets, knobs, work):
    knobs(serve__prefix_block=4)
    prompts = {"shared": _shared_prefix_work(),
               "disjoint": _random_work(4, 3, 7, 8),
               "long_prefix": _shared_prefix_work(n=6, prefix_tokens=8,
                                                  seed=2)}[work]
    engines = _engines(nets, prefix_cache=True,
                       buckets="4,8,16" if work == "long_prefix" else "4,8")
    _both(engines, prompts)
    js, ts = (e.stats()["prefix"] for e in engines)
    assert ts == js
    assert engines[1].prefix_hits == engines[0].prefix_hits
    if work == "disjoint":
        assert ts["hits"] == 0 and ts["misses"] == 4
    else:
        assert ts["hits"] >= 4 and ts["tokens_reused"] >= 4 * ts["hits"]
    assert engines[1].compiles == 1 + 2 * len(engines[1].buckets)


def test_prefix_cache_equals_cache_off_and_repeats(nets, knobs):
    """A second pass over the same prompts hits every prompt and still
    gives the cache-off tokens."""
    knobs(serve__prefix_block=4)
    prompts = _shared_prefix_work(seed=5)
    _, tnet = nets
    plain = tmx.serve.load(tnet, max_slots=4, buckets="4,8", device="cpu")
    base = _run(plain, prompts)
    eng = tmx.serve.load(tnet, max_slots=4, buckets="4,8", device="cpu",
                         prefix_cache=True)
    assert _run(eng, prompts) == base
    assert _run(eng, prompts) == base
    st = eng.stats()["prefix"]
    assert st["hits"] == 2 * len(prompts) - 1


@pytest.mark.parametrize("mode", ["int4_weights,int8_kv", "int8_kv"])
def test_prefix_cache_with_quantization_matches_jax(nets, knobs, mode):
    knobs(serve__prefix_block=4, serve__quantize_min_elems=1024)
    engines = _engines(nets, prefix_cache=True, quantize=mode)
    _both(engines, _shared_prefix_work(seed=1))
    assert engines[1].stats()["prefix"] == engines[0].stats()["prefix"]
    assert engines[1].stats()["prefix"]["hits"] >= 4


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("which", ["self", "foreign"])
def test_spec_decoding_matches_jax_engine(nets, drafts, knobs, k, which):
    knobs(serve__spec_tokens=k)
    draft = nets if which == "self" else drafts
    engines = _engines(nets, draft=draft)
    assert engines[1]._spec_k == k
    prompts = _random_work(6, 1)
    base = _run(_engines(nets)[1], prompts, max_new=8)
    assert _both(engines, prompts, max_new=8) == base
    js, ts = (e.stats()["spec"] for e in engines)
    assert ts == js
    assert engines[1].spec_acceptance == engines[0].spec_acceptance
    if which == "self":
        assert 0.0 < ts["acceptance_rate"] <= (k - 1) / k
        st = engines[1].stats()
        assert st["spec"]["rounds"] * 2 <= st["tokens_out"]


def test_prefix_and_spec_compose_like_jax(nets, knobs):
    knobs(serve__prefix_block=4)
    engines = _engines(nets, prefix_cache=True, draft=nets)
    prompts = _shared_prefix_work()
    _both(engines, prompts)
    js, ts = (e.stats() for e in engines)
    assert ts["prefix"] == js["prefix"] and ts["spec"] == js["spec"]
    assert ts["prefix"]["hits"] >= 4 and ts["spec"]["rounds"] > 0
    assert engines[1].compiles == 5


def test_spec_int8_kv_matches_jax(nets, knobs):
    engines = _engines(nets, draft=nets, quantize="int8_kv")
    _both(engines, _random_work(5, 9))
    assert engines[1].stats()["spec"] == engines[0].stats()["spec"]


# -- refusals ----------------------------------------------------------------

class _NoSuffix:
    max_length = 32
    device = torch.device("cpu")
    initialized = True
    init_cache = prefill = decode_step = staticmethod(lambda *a, **k: None)
    collect_params = staticmethod(dict)


def test_refusals_raise_like_jax(nets, knobs):
    jnet, tnet = nets
    cases = [
        (dict(draft=(jnet, tnet), temperature=0.8), "temperature"),
        (dict(draft=("small", "small")), "init_cache"),
    ]
    for kw, match in cases:
        jkw, tkw = dict(kw), dict(kw)
        jkw["draft"], tkw["draft"] = kw["draft"]
        with pytest.raises(mx.MXNetError, match=match):
            mx.serve.load(jnet, max_slots=2, **jkw)
        with pytest.raises(MXNetError, match=match):
            tmx.serve.load(tnet, max_slots=2, device="cpu", **tkw)
    knobs(serve__prefix_block=4)
    with pytest.raises(mx.MXNetError, match="prefill_suffix"):
        mx.serve.ServeEngine(_NoSuffix(), max_slots=2, prefix_cache=True)
    with pytest.raises(MXNetError, match="prefill_suffix"):
        tmx.serve.ServeEngine(_NoSuffix(), max_slots=2, prefix_cache=True,
                              device="cpu")


def test_spec_needs_decode_multi_like_jax(nets):
    jnet, tnet = nets

    class JNoMulti(JGPT):
        decode_multi = None

    class TNoMulti(tgpt.GPTForCausalLM):
        decode_multi = None
    jm, tm = JNoMulti(**CFG), TNoMulti(device="cpu", **CFG).initialize()
    jm.initialize()
    with pytest.raises(mx.MXNetError, match="decode_multi"):
        mx.serve.load(jm, max_slots=2, draft=jnet)
    with pytest.raises(MXNetError, match="decode_multi"):
        tmx.serve.load(tm, max_slots=2, draft=tnet, device="cpu")


# -- SLO classes ---------------------------------------------------------------

def test_slo_strict_priority_admission_order_like_jax(nets, knobs):
    knobs(serve__slo_classes="gold,bronze")
    rng = onp.random.RandomState(5)
    work = ([(rng.randint(1, 97, 3).tolist(), "bronze") for _ in range(3)]
            + [(rng.randint(1, 97, 3).tolist(), "gold") for _ in range(3)]
            + [([3, 5, 7], None)])
    orders, outs = [], []
    for eng in _engines(nets, max_slots=1):
        reqs = [eng.submit(p, max_new_tokens=2, slo_class=c)
                for p, c in work]
        assert reqs[-1].slo_class == "bronze"
        eng.run()
        orders.append([r.id for r in sorted(reqs,
                                            key=lambda r: r.t_admitted)])
        outs.append([r.generated for r in reqs])
        cls = eng.stats()["classes"]
        assert cls["gold"]["completed"] == 3
        assert cls["bronze"]["completed"] == 4
    assert orders[0] == orders[1] == [3, 4, 5, 0, 1, 2, 6]
    assert outs[0] == outs[1]


def test_slo_unknown_class_rejected_like_jax(nets, knobs):
    knobs(serve__slo_classes="gold,bronze")
    for eng, err in zip(_engines(nets), (mx.MXNetError, MXNetError)):
        with pytest.raises(err, match="unknown slo_class"):
            eng.submit([3, 5, 7], slo_class="platinum")


def test_unknown_slo_class_without_classes_raises_like_jax(nets):
    """Without ``serve.slo_classes`` the one class is "default"."""
    for eng, err in zip(_engines(nets, max_slots=2), (mx.MXNetError,
                                                       MXNetError)):
        with pytest.raises(err, match="unknown slo_class"):
            eng.submit([1, 2], slo_class="interactive")
        assert eng.submit([1, 2], slo_class="default").slo_class == \
            "default"


def test_slo_aging_overrides_strict_priority_like_jax(nets, knobs):
    knobs(serve__slo_classes="gold,bronze", serve__class_aging_ms=30.0)
    for eng in _engines(nets, max_slots=1):
        rng = onp.random.RandomState(6)
        busy = eng.submit([1, 2, 3], max_new_tokens=2)
        eng.step()
        br = eng.submit(rng.randint(1, 97, 3).tolist(), max_new_tokens=2,
                        slo_class="bronze")
        time.sleep(0.05)
        g = eng.submit(rng.randint(1, 97, 3).tolist(), max_new_tokens=2,
                       slo_class="gold")
        eng.run()
        assert busy.finished and br.t_admitted < g.t_admitted
        assert eng.stats()["aged_admissions"] >= 1


def test_slo_per_class_queue_bound_like_jax(nets, knobs):
    knobs(serve__slo_classes="gold,bronze", serve__class_max_queue="gold=1")
    for eng, busy in zip(_engines(nets, max_slots=1),
                         (JEngineBusy, EngineBusy)):
        eng.submit([3, 5, 7], max_new_tokens=2)
        eng.step()
        eng.submit([4, 6, 8], max_new_tokens=2, slo_class="gold")
        with pytest.raises(busy) as ei:
            eng.submit([5, 7, 9], max_new_tokens=2, slo_class="gold")
        assert ei.value.reason == "class_queue_full"
        assert ei.value.max_queue == 1
        eng.submit([6, 8, 10], max_new_tokens=2, slo_class="bronze")
        eng.run()
        assert eng.stats()["completed"] == 3


@pytest.mark.parametrize("spec,cls", [("gold,gold", ""),
                                      ("gold,bronze", "silver=2"),
                                      ("gold,bronze", "gold=x")])
def test_bad_slo_config_raises_like_jax(nets, knobs, spec, cls):
    knobs(serve__slo_classes=spec, serve__class_max_queue=cls)
    jnet, tnet = nets
    with pytest.raises(mx.MXNetError):
        mx.serve.load(jnet, max_slots=2)
    with pytest.raises(MXNetError):
        tmx.serve.load(tnet, max_slots=2, device="cpu")


# -- weight swaps --------------------------------------------------------------

def test_weight_swap_cycle_matches_jax(nets, drafts):
    """stop -> update_weights -> resume -> run -> restore_weights -> run:
    the tokens of each run equal the JAX engine's through the same cycle
    and a fresh engine's over the same weights, with no new build."""
    (jnet, tnet), (jother, tother) = nets, drafts
    prompts = _random_work(5, 11)
    jeng, teng = _engines(nets, max_slots=3)
    base = _both((jeng, teng), prompts)
    builds = teng.compiles
    outs = []
    for eng, new in ((jeng, jfunctional.param_arrays(jother)),
                     (teng, tfunctional.param_arrays(tother))):
        eng.stop(drain=True)
        old = eng.update_weights(new)
        eng.resume()
        swapped = _run(eng, prompts)
        eng.restore_weights(old)
        outs.append((swapped, _run(eng, prompts)))
    assert outs[0] == outs[1]
    assert outs[1][1] == base and outs[1][0] != base
    fresh = tmx.serve.load(tother, max_slots=3, buckets="4,8", device="cpu")
    assert outs[1][0] == _run(fresh, prompts)
    assert teng.compiles == builds and teng.post_warmup_compiles == 0
    # the model itself keeps its weights: the engine swaps its own copy
    for name, p in tnet.collect_params().items():
        onp.testing.assert_array_equal(
            p.data().detach().numpy(),
            onp.asarray(jfunctional.param_arrays(jnet)[name]))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_update_weights_mismatch_raises_like_jax(nets, fault):
    jnet, tnet = nets
    jeng, teng = _engines(nets, max_slots=2)
    jnew = dict(jfunctional.param_arrays(jnet))
    tnew = tfunctional.param_arrays(tnet)
    name = "backbone.final_ln.gamma"
    if fault == "missing":
        del jnew[name], tnew[name]
    else:
        jnew[name] = mx.np.ones((31,)).asnumpy()
        tnew[name] = onp.ones((31,), dtype="float32")
    with pytest.raises(mx.MXNetError, match="update_weights"):
        jeng.update_weights(jnew)
    with pytest.raises(MXNetError, match="update_weights"):
        teng.update_weights(tnew)
    # nothing was written: the engine still serves its own weights
    prompts = _random_work(3, 12)
    assert _run(teng, prompts) == _run(jeng, prompts)
