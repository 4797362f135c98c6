"""Port parity: the serve engine's KV-cache ops and the GPT cache surface.

Each of the nine ops ported from ``mxnet_tpu/ops/attention.py``
(``_quantize_kv_rows`` / ``write_prefill_kv_q8``, ``copy_cache_rows``,
``gather_cache_rows``, ``suffix_prefill_attention(_q8)``,
``decode_multi_attention(_q8)``, ``decode_attention_q8``) is held against
the JAX function on the same numpy inputs (seeded): fp32 outputs and cache
rows within atol = rtol = 1e-5, int8 values and fp32 scales bit for bit.
The port updates the caches in place and takes slot, start and row
operands as tensors (the engine's captured graphs pass device tensors).
Then the tiny GPT of tests/test_serve.py (vocab 97, 32 units, 2 layers,
2 heads), its weights carried across with ``functional.load_params``:
``init_cache("int8")``, the int8 ``prefill`` / ``decode_step``, and
``prefill_suffix``, ``decode_multi`` and ``copy_cache_rows`` on both cache
layouts against the JAX GPT.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM as JGPT
from mxnet_tpu.ops import attention as jatt

from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, embed_dropout=0.0)
SLOTS, MAX_SEQ, HEADS, D = 3, 16, 2, 8


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _t(a):
    return torch.from_numpy(onp.array(a))


def _j(a):
    return mx.np.array(onp.array(a))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    if want.dtype == onp.int8 or want.dtype == onp.uint8:
        onp.testing.assert_array_equal(got, want, err_msg=what)
    else:
        onp.testing.assert_allclose(got, want, err_msg=what, **TOL)


def _exact(got, want, what):
    onp.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _fp_cache(rs):
    shape = (SLOTS, MAX_SEQ, HEADS, D)
    return (rs.randn(*shape).astype("float32"),
            rs.randn(*shape).astype("float32"))


def _q8_cache(rs):
    """An int8 cache of quantized random rows (values, scales) x 2."""
    out = []
    for _ in range(2):
        x = rs.randn(SLOTS, MAX_SEQ, HEADS, D).astype("float32")
        q, s = jatt._quantize_kv_rows(x)
        out.append((onp.asarray(q), onp.asarray(s)))
    return tuple(out)


def _qkv(rs, n, t):
    return [rs.randn(n, t, HEADS * D).astype("float32") for _ in range(3)]


# -- the int8 row quantizer ----------------------------------------------------

@pytest.mark.parametrize("case", ["randn", "zero_rows", "ties", "large"])
def test_quantize_kv_rows_bit_for_bit(case):
    rs = onp.random.RandomState(0)
    x = rs.randn(4, 5, HEADS, D).astype("float32")
    if case == "zero_rows":
        x[1, 2] = 0.0
    elif case == "ties":
        # rows whose absmax is 127, so values at .5 round half to even
        x[:] = rs.randint(-254, 255, x.shape) / 2.0
        x[..., 0] = 127.0
    elif case == "large":
        x *= 1e4
    q, s = tatt._quantize_kv_rows(torch.from_numpy(x))
    jq, js = jatt._quantize_kv_rows(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _exact(q.numpy(), jq, "values")
    _exact(s.numpy(), js, "scales")


@pytest.mark.parametrize("slot", [0, 2])
def test_write_prefill_kv_q8_matches_jax(slot):
    rs = onp.random.RandomState(1 + slot)
    (kc, ks), (vc, vs) = _q8_cache(rs)
    _, k, v = _qkv(rs, 1, 5)
    want = jatt.write_prefill_kv_q8(_j(kc), _j(ks), _j(vc), _j(vs), _j(k),
                                    _j(v), slot, HEADS)
    tc = [_t(a) for a in (kc, ks, vc, vs)]
    got = tatt.write_prefill_kv_q8(*tc, _t(k), _t(v),
                                   torch.tensor(slot), HEADS)
    for g, w, c, name in zip(got, want, tc, ("k", "k_scale", "v",
                                             "v_scale")):
        assert g is c, "the cache is updated in place"
        _exact(g.numpy(), w, name)


@pytest.mark.parametrize("slot", [1, torch.tensor(1)])
def test_write_prefill_kv_takes_a_tensor_slot(slot):
    rs = onp.random.RandomState(3)
    kc, vc = _fp_cache(rs)
    _, k, v = _qkv(rs, 1, 6)
    want = jatt.write_prefill_kv(_j(kc), _j(vc), _j(k), _j(v), 1, HEADS)
    got = tatt.write_prefill_kv(_t(kc), _t(vc), _t(k), _t(v), slot, HEADS)
    for g, w in zip(got, want):
        _close(g.numpy(), w, "cache")


# -- block copies ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["fp", "q8"])
@pytest.mark.parametrize("src_slot,src_row,dst_slot,dst_row", [
    (0, 4, 2, 0), (1, 0, 1, 8), (2, 12, 0, 12), (0, 14, 1, 3)])
def test_copy_cache_rows_matches_jax(layout, src_slot, src_row, dst_slot,
                                     dst_row):
    rs = onp.random.RandomState(4)
    cache = _fp_cache(rs) if layout == "fp" else _q8_cache(rs)
    jtree = jax_tree(cache)
    want = jatt.copy_cache_rows(jtree, src_slot, src_row, dst_slot,
                                dst_row, 4)
    ttree = torch_tree(cache)
    got = tatt.copy_cache_rows(ttree, torch.tensor(src_slot), src_row,
                               torch.tensor(dst_slot), torch.tensor(dst_row),
                               4)
    assert got is ttree
    for g, w in zip(tatt._leaves(got), _jleaves(want)):
        _exact(g.numpy(), w, "leaf")


@pytest.mark.parametrize("layout", ["fp", "q8"])
@pytest.mark.parametrize("dst", [0, 2])
def test_gather_cache_rows_matches_jax(layout, dst):
    """Blocks from several donors, the destination among them (its own
    rows read before the write), identity rows past the prefix."""
    rs = onp.random.RandomState(5 + dst)
    cache = _fp_cache(rs) if layout == "fp" else _q8_cache(rs)
    src_slots = onp.full((MAX_SEQ,), dst, dtype=onp.int32)
    src_rows = onp.arange(MAX_SEQ, dtype=onp.int32)
    src_slots[:4], src_rows[:4] = 1, onp.arange(8, 12)
    src_slots[4:8], src_rows[4:8] = dst, onp.arange(12, 16)
    src_slots[8:12], src_rows[8:12] = 2 - dst, onp.arange(0, 4)
    want = jatt.gather_cache_rows(jax_tree(cache), _jnp(src_slots),
                                  _jnp(src_rows), dst)
    got = tatt.gather_cache_rows(torch_tree(cache), _t(src_slots.astype(
        onp.int64)), _t(src_rows.astype(onp.int64)), torch.tensor(dst))
    for g, w in zip(tatt._leaves(got), _jleaves(want)):
        _exact(g.numpy(), w, "leaf")


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def jax_tree(cache):
    if isinstance(cache[0], tuple):
        return tuple((_jnp(a), _jnp(b)) for a, b in cache)
    return tuple(_jnp(a) for a in cache)


def torch_tree(cache):
    if isinstance(cache[0], tuple):
        return tuple((_t(a), _t(b)) for a, b in cache)
    return tuple(_t(a) for a in cache)


def _jleaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree)


# -- suffix prefill, multi-token and int8 decode ---------------------------------

@pytest.mark.parametrize("layout", ["fp", "q8"])
@pytest.mark.parametrize("slot,start,ls", [(0, 0, 4), (1, 8, 5), (2, 4, 12),
                                           (1, 15, 1)])
def test_suffix_prefill_attention_matches_jax(layout, slot, start, ls):
    rs = onp.random.RandomState(10 + start)
    q, k, v = _qkv(rs, 1, ls)
    if layout == "fp":
        kc, vc = _fp_cache(rs)
        want = jatt.suffix_prefill_attention(_j(q), _j(k), _j(v), _j(kc),
                                             _j(vc), slot, start, HEADS)
        tc = [_t(kc), _t(vc)]
        got = tatt.suffix_prefill_attention(_t(q), _t(k), _t(v), *tc,
                                            torch.tensor(slot),
                                            torch.tensor(start), HEADS)
    else:
        (kc, ks), (vc, vs) = _q8_cache(rs)
        want = jatt.suffix_prefill_attention_q8(
            _j(q), _j(k), _j(v), _j(kc), _j(ks), _j(vc), _j(vs), slot,
            start, HEADS)
        tc = [_t(a) for a in (kc, ks, vc, vs)]
        got = tatt.suffix_prefill_attention_q8(
            _t(q), _t(k), _t(v), *tc, torch.tensor(slot),
            torch.tensor(start), HEADS)
    _close(got[0].numpy(), want[0], "out")
    for g, w, c in zip(got[1:], want[1:], tc):
        assert g is c
        _close(g.numpy(), w, "cache")


@pytest.mark.parametrize("layout", ["fp", "q8"])
@pytest.mark.parametrize("t", [1, 3, 4])
def test_decode_multi_attention_matches_jax(layout, t):
    """Per slot positions, one clipped at the end of the cache (its
    duplicate writes land above the slot's visible rows)."""
    rs = onp.random.RandomState(20 + t)
    q, k, v = _qkv(rs, SLOTS, t)
    pos = onp.array([0, 7, MAX_SEQ - 2], dtype=onp.int32)
    if layout == "fp":
        kc, vc = _fp_cache(rs)
        want = jatt.decode_multi_attention(_j(q), _j(k), _j(v), _j(kc),
                                           _j(vc), _j(pos), HEADS)
        got = tatt.decode_multi_attention(_t(q), _t(k), _t(v), _t(kc),
                                          _t(vc), _t(pos), HEADS)
    else:
        (kc, ks), (vc, vs) = _q8_cache(rs)
        want = jatt.decode_multi_attention_q8(
            _j(q), _j(k), _j(v), _j(kc), _j(ks), _j(vc), _j(vs), _j(pos),
            HEADS)
        got = tatt.decode_multi_attention_q8(
            _t(q), _t(k), _t(v), _t(kc), _t(ks), _t(vc), _t(vs), _t(pos),
            HEADS)
    # a row written twice by the clip (slot 2's last rows) holds one of the
    # values (which is unspecified): compare the rows written once and the
    # queries that see only such rows
    rows = onp.clip(pos[:, None] + onp.arange(t), 0, MAX_SEQ - 1)
    once = onp.ones((SLOTS, MAX_SEQ), dtype=bool)
    for i in range(SLOTS):
        r, c = onp.unique(rows[i], return_counts=True)
        once[i, r[c > 1]] = False
    seen = onp.arange(MAX_SEQ)[None, None, :] <= (pos[:, None, None]
                                                  + onp.arange(t)[:, None])
    clean = ~(seen & ~once[:, None, :]).any(axis=2)          # (slots, t)
    assert clean.any() and (t == 1 or not clean.all())
    _close(got[0].numpy()[clean], _np(want[0])[clean], "out")
    for g, w in zip(got[1:], want[1:]):
        _close(g.numpy()[once], _np(w)[once], "cache rows")


@pytest.mark.parametrize("positions", [[0, 5, 15], [3, 3, 9], [15, 0, 1]])
def test_decode_attention_q8_matches_jax(positions):
    rs = onp.random.RandomState(30 + positions[0])
    q, k, v = _qkv(rs, SLOTS, 1)
    pos = onp.array(positions, dtype=onp.int32)
    (kc, ks), (vc, vs) = _q8_cache(rs)
    want = jatt.decode_attention_q8(_j(q), _j(k), _j(v), _j(kc), _j(ks),
                                    _j(vc), _j(vs), _j(pos), HEADS)
    tc = [_t(a) for a in (kc, ks, vc, vs)]
    got = tatt.decode_attention_q8(_t(q), _t(k), _t(v), *tc, _t(pos), HEADS)
    _close(got[0].numpy(), want[0], "out")
    for g, w, c in zip(got[1:], want[1:], tc):
        assert g is c
        _close(g.numpy(), w, "cache")


# -- the GPT cache surface -------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    mx.random.seed(11)
    jnet = JGPT(**CFG)
    jnet.initialize()
    jnet(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    tnet = tgpt.GPTForCausalLM(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _cache_close(tc, jc):
    for g, w in zip(tatt._leaves(tc), _jleaves(jax_leaves(jc))):
        _close(g.detach().numpy(), w, "cache")


def jax_leaves(jc):
    import jax
    return jax.tree_util.tree_map(
        lambda a: a._data if hasattr(a, "_data") else a, jc,
        is_leaf=lambda x: hasattr(x, "_data"))


def test_init_cache_int8_layout_matches_jax(pair):
    jnet, tnet = pair
    jc = jnet.init_cache(SLOTS, MAX_SEQ, dtype="int8")
    tc = tnet.init_cache(SLOTS, MAX_SEQ, dtype="int8")
    assert len(tc) == len(jc) == CFG["num_layers"]
    for (tk, tv), (jk, jv) in zip(tc, jc):
        for (tq, ts), (jq, js) in ((tk, jk), (tv, jv)):
            assert tq.dtype == torch.int8 and ts.dtype == torch.float32
            assert tuple(tq.shape) == jq.shape
            assert tuple(ts.shape) == js.shape == (SLOTS, MAX_SEQ, 2, 1)
            _exact(tq.numpy(), jq, "values")
            _exact(ts.numpy(), js, "scales")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gpt_prefill_decode_suffix_multi_match_jax(pair, dtype):
    """prefill -> decode_step -> copy_cache_rows -> prefill_suffix ->
    decode_multi, every logit and cache row against the JAX GPT."""
    jnet, tnet = pair
    rs = onp.random.RandomState(40)
    jc = jnet.init_cache(SLOTS, MAX_SEQ, dtype=dtype)
    tc = tnet.init_cache(SLOTS, MAX_SEQ, dtype=dtype)
    prompt = rs.randint(1, 97, (1, 8)).astype("int32")
    jl, jc = jnet.prefill(_j(prompt), jc, 1)
    tl, tc = tnet.prefill(_t(prompt), tc, torch.tensor(1))
    _close(tl.numpy(), jl, "prefill logits")
    _cache_close(tc, jc)
    tokens = rs.randint(1, 97, (SLOTS, 1)).astype("int32")
    pos = onp.array([0, 8, 3], dtype="int32")
    jl, jc = jnet.decode_step(_j(tokens), jc, _j(pos))
    tl, tc = tnet.decode_step(_t(tokens), tc, _t(pos))
    _close(tl.numpy(), jl, "decode logits")
    _cache_close(tc, jc)
    # the first block of slot 1 into slot 0, then a suffix on top of it
    # the reference's copy maps raw arrays (the engine passes them so)
    jc = jnet.copy_cache_rows(jax_leaves(jc), 1, 0, 0, 0, 4)
    tc = tnet.copy_cache_rows(tc, torch.tensor(1), torch.tensor(0),
                              torch.tensor(0), torch.tensor(0), 4)
    _cache_close(tc, jc)
    suffix = rs.randint(1, 97, (1, 5)).astype("int32")
    jl, jc = jnet.prefill_suffix(_j(suffix), jc, 0, 4)
    tl, tc = tnet.prefill_suffix(_t(suffix), tc, torch.tensor(0),
                                 torch.tensor(4))
    _close(tl.numpy(), jl, "suffix logits")
    _cache_close(tc, jc)
    seq = rs.randint(1, 97, (SLOTS, 3)).astype("int32")
    pos = onp.array([9, 9, 4], dtype="int32")
    jl, jc = jnet.decode_multi(_j(seq), jc, _j(pos))
    tl, tc = tnet.decode_multi(_t(seq), tc, _t(pos))
    _close(tl.numpy(), jl, "decode_multi logits")
    _cache_close(tc, jc)


def test_gpt_positions_clamp_at_max_length(pair):
    """prefill_suffix and decode_multi clamp positions at max_length - 1,
    as the reference."""
    jnet, tnet = pair
    rs = onp.random.RandomState(41)
    ms = CFG["max_length"]
    jc = jnet.init_cache(2, ms)
    tc = tnet.init_cache(2, ms)
    seq = rs.randint(1, 97, (2, 4)).astype("int32")
    pos = onp.array([ms - 2, 3], dtype="int32")
    jl, _ = jnet.decode_multi(_j(seq), jc, _j(pos))
    tl, _ = tnet.decode_multi(_t(seq), tc, _t(pos))
    _close(tl.numpy(), jl, "decode_multi logits")
    suffix = rs.randint(1, 97, (1, 4)).astype("int32")
    jl, _ = jnet.prefill_suffix(_j(suffix), jnet.init_cache(2, ms), 1,
                                ms - 4)
    tl, _ = tnet.prefill_suffix(_t(suffix), tnet.init_cache(2, ms), 1,
                                ms - 4)
    _close(tl.numpy(), jl, "suffix logits")
