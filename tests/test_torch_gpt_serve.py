"""Port parity: tiny GPT and the serve engine, JAX package -> PyTorch port.

A tiny ``mxnet_tpu`` GPT (vocab 97, units 32, FFN 64, 2 layers, 2 heads,
max_length 32, dropout 0, as tests/test_serve.py builds it) is initialized
by the JAX package and its weights are carried into the port with
``functional.load_params``. Forward, prefill and decode logits must agree
at the tolerances tests/test_serve.py holds the JAX package itself to
(atol 1e-5 / 1e-4), and the port's ServeEngine on the CPU must give the
same greedy tokens, one for one, as ``mxnet_tpu.serve``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.gluon.nn.transformer import TransformerEncoder as JEncoder

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.gluon.nn.transformer import TransformerEncoder as TEncoder
from mxnet_tpu_torch.serve.engine import EngineBusy, _parse_buckets

torch.set_num_threads(2)

CFG = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)


def _numpy_params(block):
    return {k: onp.asarray(v) for k, v in
            jfunctional.param_arrays(block).items()}


def _pair(seed=0):
    """(JAX GPT, port GPT on the CPU with the same weights)."""
    mx.random.seed(seed)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))  # materialize
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, _numpy_params(jnet))
    return jnet, tnet


def _t(a):
    return torch.from_numpy(onp.asarray(a))


# -- model: forward / prefill / decode ---------------------------------------

def test_forward_logits_match():
    jnet, tnet = _pair(0)
    ids = onp.random.RandomState(0).randint(0, 97, (2, 11)).astype("int32")
    ref = jnet(mx.np.array(ids)).asnumpy()
    out = tnet(_t(ids))
    onp.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_prefill_logits_match_into_slot():
    jnet, tnet = _pair(1)
    prompt = onp.random.RandomState(1).randint(1, 97, (1, 6)).astype("int32")
    ref, jcaches = jnet.prefill(mx.np.array(prompt),
                                jnet.init_cache(max_slots=3, max_seq=16), 1)
    caches = tnet.init_cache(max_slots=3, max_seq=16)
    out, caches = tnet.prefill(_t(prompt), caches, 1)
    onp.testing.assert_allclose(out.numpy(), ref.asnumpy(), atol=1e-5,
                                rtol=0)
    for (tk, tv), (jk, jv) in zip(caches, jcaches):
        onp.testing.assert_allclose(tk.numpy(), jk.asnumpy(), atol=1e-5,
                                    rtol=0)
        onp.testing.assert_allclose(tv.numpy(), jv.asnumpy(), atol=1e-5,
                                    rtol=0)


def test_decode_steps_match_in_slot():
    jnet, tnet = _pair(2)
    prompt = onp.array([[3, 14, 15, 9, 2]], dtype="int32")
    slot, slots = 2, 4
    jc = jnet.init_cache(max_slots=slots, max_seq=16)
    tc = tnet.init_cache(max_slots=slots, max_seq=16)
    jl, jc = jnet.prefill(mx.np.array(prompt), jc, slot)
    tl, tc = tnet.prefill(_t(prompt), tc, slot)
    seq = list(prompt[0]) + [int(jl.asnumpy()[0, -1].argmax())]
    assert int(tl[0, -1].argmax()) == seq[-1]
    for _ in range(5):
        tokens = onp.zeros((slots, 1), dtype="int32")
        tokens[slot, 0] = seq[-1]
        positions = onp.zeros((slots,), dtype="int32")
        positions[slot] = len(seq) - 1
        jl, jc = jnet.decode_step(mx.np.array(tokens), jc,
                                  mx.np.array(positions))
        tl, tc = tnet.decode_step(_t(tokens), tc, _t(positions))
        onp.testing.assert_allclose(tl.numpy(), jl.asnumpy(), atol=1e-4,
                                    rtol=0)
        seq.append(int(jl.asnumpy()[slot].argmax()))


def _encoder_pair(causal):
    mx.random.seed(7)
    jenc = JEncoder(2, 32, 64, 2, pre_norm=False, causal=causal)
    jenc.initialize()
    jenc(mx.np.array(onp.zeros((1, 3, 32), dtype="float32")))
    tenc = TEncoder(2, 32, 64, 2, pre_norm=False, causal=causal,
                    device="cpu")
    tfunctional.load_params(tenc, _numpy_params(jenc))
    return jenc, tenc


@pytest.mark.parametrize("causal", [False, True])
def test_post_norm_encoder_forward_matches(causal):
    jenc, tenc = _encoder_pair(causal)
    x = onp.random.RandomState(8).randn(2, 9, 32).astype("float32")
    ref = jenc(mx.np.array(x)).asnumpy()
    onp.testing.assert_allclose(tenc(_t(x)).numpy(), ref, atol=1e-5, rtol=0)


def test_post_norm_encoder_cache_surface_matches():
    jenc, tenc = _encoder_pair(True)
    rs = onp.random.RandomState(9)
    x = rs.randn(1, 5, 32).astype("float32")
    jc, tc = jenc.init_cache(3, 16), tenc.init_cache(3, 16)
    jy, jc = jenc.prefill(mx.np.array(x), jc, 1)
    ty, tc = tenc.prefill(_t(x), tc, 1)
    onp.testing.assert_allclose(ty.numpy(), jy.asnumpy(), atol=1e-5, rtol=0)
    for step in range(5):
        xs = rs.randn(3, 1, 32).astype("float32")
        pos = onp.array([0, 5 + step, 2], dtype="int32")
        jy, jc = jenc.decode_step(mx.np.array(xs), jc, mx.np.array(pos))
        ty, tc = tenc.decode_step(_t(xs), tc, _t(pos))
        onp.testing.assert_allclose(ty.numpy(), jy.asnumpy(), atol=1e-4,
                                    rtol=0)


def test_param_names_and_tied_head():
    jnet, tnet = _pair(3)
    names = list(tnet.collect_params())
    assert names == list(jfunctional.param_arrays(jnet))
    assert "backbone.decoder.layer1.attention.query_proj.weight" in names
    assert "backbone.decoder.layer0.attn_ln.gamma" in names
    # the LM head is the embedding itself, not a copy
    assert not any("head" in n or "lm" in n for n in names)
    with torch.no_grad():
        tnet.backbone.word_embed.weight[5].zero_()
    logits = tnet(_t(onp.array([[1, 2, 3]], dtype="int32")))
    assert torch.all(logits[..., 5] == 0)


def test_param_arrays_round_trip():
    _, tnet = _pair(4)
    arrays = tfunctional.param_arrays(tnet)
    other = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(other, arrays)
    for name, p in other.collect_params().items():
        onp.testing.assert_array_equal(p.data().detach().numpy(),
                                       arrays[name])


# -- engine vs engine --------------------------------------------------------

def _prompts(n, seed):
    rs = onp.random.RandomState(seed)
    return [(rs.randint(1, 97, rs.randint(1, 9)).astype("int32"),
             int(rs.randint(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("max_slots,n_requests", [(4, 7), (2, 9)])
def test_engine_tokens_match_jax_engine(max_slots, n_requests):
    jnet, tnet = _pair(5 + max_slots)
    work = _prompts(n_requests, seed=max_slots)
    jeng = mx.serve.load(jnet, max_slots=max_slots, buckets="4,8")
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in work]
    jeng.run()
    teng = tmx.serve.ServeEngine(tnet, max_slots=max_slots, buckets="4,8",
                                 device="cpu").warmup()
    treqs = [teng.submit(p, max_new_tokens=n) for p, n in work]
    teng.run()
    for (_, n), jr, tr in zip(work, jreqs, treqs):
        assert tr.finished and len(tr.generated) == n
        assert tr.generated == jr.generated
    st = teng.stats()
    assert st["completed"] == n_requests
    assert st["tokens_out"] == sum(n for _, n in work)
    assert st["ttft"]["p50"] is not None and st["tpot"]["p99"] is not None
    assert st["max_slots"] == max_slots and st["buckets"] == [4, 8]
    assert st["cache_dtype"] == "float32" and st["max_seq"] == 32


def test_engine_eos_stops_early_like_jax():
    jnet, tnet = _pair(6)
    prompt = onp.array([5, 6, 7], dtype="int32")
    probe = mx.serve.load(jnet, max_slots=2, buckets="4,8")
    r = probe.submit(prompt, max_new_tokens=6)
    probe.run()
    eos = r.generated[2]
    jeng = mx.serve.load(jnet, max_slots=2, buckets="4,8", eos_id=eos)
    teng = tmx.serve.load(tnet, max_slots=2, buckets="4,8", eos_id=eos,
                          device="cpu")
    jr = jeng.submit(prompt, max_new_tokens=6)
    tr = teng.submit(prompt, max_new_tokens=6)
    jeng.run()
    teng.run()
    assert tr.generated == jr.generated
    assert tr.output_ids == jr.output_ids and tr.generated[-1] == eos


# -- device, loading and slice rules ----------------------------------------

@pytest.mark.parametrize("entry", ["gpt2_124m", "GPTForCausalLM",
                                   "serve.load", "ServeEngine"])
def test_no_device_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is the card")
    _, tnet = _pair(0)
    calls = {
        "gpt2_124m": lambda: tgpt.gpt2_124m(),
        "GPTForCausalLM": lambda: tgpt.GPTForCausalLM(**CFG),
        "serve.load": lambda: tmx.serve.load(tnet),
        "ServeEngine": lambda: tmx.serve.ServeEngine(tnet),
    }
    with pytest.raises(MXNetError):
        calls[entry]()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_params_rejects_mismatch(fault):
    jnet, tnet = _pair(0)
    arrays = _numpy_params(jnet)
    if fault == "missing":
        arrays.pop("backbone.decoder.layer1.ffn.ffn_2.bias")
    elif fault == "extra":
        arrays["backbone.lm_head.weight"] = onp.zeros((97, 32), "float32")
    else:
        arrays["backbone.final_ln.gamma"] = onp.ones((31,), "float32")
    with pytest.raises(MXNetError):
        tfunctional.load_params(tnet, arrays)


def test_uninitialized_model_is_refused():
    net = tgpt.GPTForCausalLM(device="cpu", **CFG)
    with pytest.raises(MXNetError):
        tmx.serve.load(net, device="cpu")


def test_layers_need_their_input_width():
    """Dense and LayerNorm told no width defer their parameters' shape to
    the first forward, which needs initialize() first (as the JAX
    package's deferred initialization does)."""
    from mxnet_tpu_torch.gluon import nn as tnn
    with pytest.raises(MXNetError):
        tnn.Dense(4, device="cpu")(torch.ones(2, 3))
    with pytest.raises(MXNetError):
        tnn.LayerNorm(device="cpu")(torch.ones(2, 3))
    ln = tnn.LayerNorm(device="cpu")
    assert tuple(ln.gamma.shape) == (0,)
    ln.initialize()
    assert ln(torch.ones(2, 3)).shape == (2, 3)
    assert tuple(ln.gamma.shape) == tuple(ln.beta.shape) == (3,)
    dense = tnn.Dense(4, in_units=3, device="cpu")
    assert tuple(dense.weight.shape) == (4, 3)
    deferred = tnn.Dense(4, device="cpu")
    assert tuple(deferred.weight.shape) == (4, 0)
    deferred.initialize(seed=0)
    assert deferred(torch.ones(2, 3)).shape == (2, 4)
    assert tuple(deferred.weight.shape) == (4, 3)


def test_initialize_default_uniform_and_seeded():
    a = tgpt.GPTForCausalLM(device="cpu", **CFG).initialize(seed=3)
    b = tgpt.GPTForCausalLM(device="cpu", **CFG).initialize(seed=3)
    pa = {n: p.data() for n, p in a.collect_params().items()}
    pb = {n: p.data() for n, p in b.collect_params().items()}
    for name in pa:
        assert torch.equal(pa[name], pb[name])
    w = pa["backbone.decoder.layer0.ffn.ffn_1.weight"]
    assert w.abs().max() <= 0.07 and w.std() > 0.03
    assert torch.all(pa["backbone.final_ln.gamma"] == 1)
    assert torch.all(pa["backbone.final_ln.beta"] == 0)
    assert torch.all(pa["backbone.decoder.layer0.ffn.ffn_1.bias"] == 0)


@pytest.mark.parametrize("case", ["draft_without_surface", "unknown_class",
                                  "update_weights_mismatch"])
def test_cases_that_still_raise_like_jax(case):
    """The cases of the former slice checks that the reference raises on
    too (the features themselves: tests/test_torch_serve_*.py)."""
    jnet, tnet = _pair(0)
    calls = {
        "draft_without_surface": (
            lambda: mx.serve.ServeEngine(jnet, draft="small"),
            lambda: tmx.serve.ServeEngine(tnet, device="cpu",
                                          draft="small")),
        "unknown_class": (
            lambda: mx.serve.load(jnet, max_slots=2, buckets="4,8").submit(
                [1, 2], slo_class="interactive"),
            lambda: tmx.serve.load(tnet, max_slots=2, buckets="4,8",
                                   device="cpu").submit(
                [1, 2], slo_class="interactive")),
        "update_weights_mismatch": (
            lambda: mx.serve.load(jnet, max_slots=2,
                                  buckets="4,8").update_weights({}),
            lambda: tmx.serve.load(tnet, max_slots=2, buckets="4,8",
                                   device="cpu").update_weights({})),
    }
    jcall, tcall = calls[case]
    with pytest.raises(mx.MXNetError):
        jcall()
    with pytest.raises(MXNetError):
        tcall()


def test_engine_queue_bound_and_stop():
    _, tnet = _pair(0)
    tmx.config.set("serve.max_queue", 1)
    try:
        eng = tmx.serve.load(tnet, max_slots=2, buckets="4,8", device="cpu")
        eng.submit([1, 2], max_new_tokens=2)
        with pytest.raises(EngineBusy) as ei:
            eng.submit([3], max_new_tokens=2)
        assert ei.value.reason == "queue_full"
    finally:
        tmx.config.reset("serve.max_queue")
    eng.stop(drain=True)
    assert eng.stats()["completed"] == 1 and not eng.pending
    with pytest.raises(EngineBusy):
        eng.submit([1], max_new_tokens=2)


def test_engine_temperature_sampling_is_seeded():
    _, tnet = _pair(0)
    prompts = _prompts(5, seed=11)

    def run(seed):
        eng = tmx.serve.load(tnet, max_slots=2, buckets="4,8",
                             temperature=0.8, seed=seed, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
        eng.run()
        return [r.generated for r in reqs]

    first, again, other = run(1), run(1), run(2)
    assert first == again and first != other
    for (_, n), toks in zip(prompts, first):
        assert len(toks) == n and all(0 <= t < 97 for t in toks)


def test_engine_stop_without_drain_rejects_queued():
    _, tnet = _pair(0)
    eng = tmx.serve.load(tnet, max_slots=1, buckets="4,8", device="cpu")
    live = eng.submit([1, 2, 3], max_new_tokens=3)
    queued = eng.submit([4, 5], max_new_tokens=3)
    eng.step()
    eng.stop(drain=False)
    assert queued.rejected and queued.reject_reason == "stopping"
    assert not queued.generated and live.slot is not None
    with pytest.raises(EngineBusy):
        eng.submit([1], max_new_tokens=2)


def test_engine_rejects_long_prompt_and_bad_buckets():
    _, tnet = _pair(0)
    eng = tmx.serve.load(tnet, max_slots=2, buckets="4,8", device="cpu")
    with pytest.raises(MXNetError):
        eng.submit(list(range(1, 10)))
    with pytest.raises(MXNetError):
        eng.submit([])
    assert _parse_buckets("64,16, 32") == [16, 32, 64]
    for bad in ("", "0,4", "a,4"):
        with pytest.raises(MXNetError):
            _parse_buckets(bad)
