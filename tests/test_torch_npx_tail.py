"""Port parity: the ``npx`` operator tail, JAX package -> PyTorch port.

Every public non-module name of the JAX package's ``npx`` exists in the
port's (the surface lock), with ``npx.random`` and its fall-through to
``mx.np.random``. The elementwise, mask, indexing, shape, loss, cast,
and attention-entry ops take the same seeded numpy inputs in
both packages (``mx.np`` arrays, on the CPU): float32 values within rtol
1e-5 / atol 1e-6, integer and index outputs equal, dtypes equal, and the
gradients of the differentiable cases likewise. The reference's
out-of-range rules (``gather_nd`` clamps, ``one_hot`` gives off-value
rows, the scatters drop, a sequence length past the end reads NaN) and
``topk``'s tie order (lower index first) are held on purpose. Control
flow (``foreach`` with gradients to the data, the states and a
closed-over parameter, the empty loop, ``while_loop``, ``cond``), the
samplers (shapes, dtypes, moments) and the state helpers are held
against the reference's semantics. ``npx.rnn`` and the layers
are in ``test_torch_rnn.py``, the detection ops in
``test_torch_detection_ops.py``.
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.test_utils import assert_almost_equal
from test_op_coverage import REF_NPX

torch.set_num_threads(2)

RS = onp.random.RandomState(24)
X = RS.randn(3, 4, 5).astype("float32")
POS = (RS.rand(3, 4, 5) + 0.2).astype("float32")
UNIT = (RS.rand(3, 4, 5) * 1.8 - 0.9).astype("float32")
MASK = RS.rand(3, 4, 5) > 0.3
MASK[0, 0] = False                      # one row masked whole
A = RS.randn(2, 3, 4).astype("float32")
B = RS.randn(2, 4, 5).astype("float32")
IMG = RS.randn(2, 8, 4, 6).astype("float32")
SEQ = RS.randn(5, 3, 2).astype("float32")
LEN = onp.array([5, 2, 3], "int32")
TIES = onp.array([[1., 3., 3., 2., 3.], [0., 0., -1., 0., 2.]], "float32")
IDX = onp.array([[0, 2, -1, 5], [1, 0, 3, -4]], "int32")   # (2, 4)
ROWS = RS.randn(4, 5).astype("float32")
QKV = RS.randn(6, 2, 3 * 2 * 4).astype("float32")           # heads 2, dim 4
Q = RS.randn(5, 2, 8).astype("float32")
KV = RS.randn(6, 2, 2 * 2 * 4).astype("float32")
ATT_SELF = RS.rand(4, 6, 6).astype("float32")
ATT_ED = RS.rand(4, 5, 6).astype("float32")
@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _match(got, want, name, rtol=1e-5, atol=1e-6):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, tmx.np.ndarray), f"{name}[{i}]: {type(g)}"
        w = w.asnumpy()
        tol = (rtol, atol) if w.dtype.kind == "f" else (0, 0)
        assert_almost_equal(g, w, rtol=tol[0], atol=tol[1], equal_nan=True,
                            names=(f"{name}[{i}]", "jax"), check_dtype=True)


CASES = {
    "relu": lambda m, a: m.npx.relu(a(X)),
    "sigmoid": lambda m, a: m.npx.sigmoid(a(X)),
    "rsqrt": lambda m, a: m.npx.rsqrt(a(POS)),
    "rcbrt": lambda m, a: m.npx.rcbrt(a(X)),
    "erf": lambda m, a: m.npx.erf(a(X)),
    "erfinv": lambda m, a: m.npx.erfinv(a(UNIT)),
    "gamma": lambda m, a: m.npx.gamma(a(POS * 3)),
    "gammaln": lambda m, a: m.npx.gammaln(a(POS * 3)),
    "digamma": lambda m, a: m.npx.digamma(a(POS * 3)),
    "softmin": lambda m, a: m.npx.softmin(a(X), axis=1),
    "masked_softmax": lambda m, a: m.npx.masked_softmax(a(X), a(MASK),
                                                        temperature=2.0),
    "masked_log_softmax": lambda m, a: m.npx.masked_log_softmax(
        a(X), a(MASK), axis=-1),
    "l2_norm_instance": lambda m, a: m.npx.l2_normalization(a(IMG)),
    "l2_norm_channel": lambda m, a: m.npx.l2_normalization(a(IMG),
                                                           mode="channel"),
    "l2_norm_spatial": lambda m, a: m.npx.l2_normalization(a(IMG),
                                                           mode="spatial"),
    "one_hot": lambda m, a: m.npx.one_hot(a(IDX), 4),
    "one_hot_values": lambda m, a: m.npx.one_hot(
        a(IDX), 5, on_value=2.5, off_value=-1.0),
    "topk_indices": lambda m, a: m.npx.topk(a(TIES), k=3),
    "topk_both": lambda m, a: m.npx.topk(a(TIES), k=3, ret_typ="both"),
    "topk_ascend_axis0": lambda m, a: m.npx.topk(
        a(TIES), axis=0, k=2, ret_typ="both", is_ascend=True),
    "topk_value_int": lambda m, a: m.npx.topk(a(X), axis=1, k=2,
                                              ret_typ="value"),
    "topk_int32_index": lambda m, a: m.npx.topk(a(TIES), k=2,
                                                dtype="int32"),
    "gather_nd": lambda m, a: m.npx.gather_nd(a(X), a(IDX)),
    "gather_nd_float_idx": lambda m, a: m.npx.gather_nd(
        a(X), a(IDX[:1].astype("float32") + 0.7)),
    "scatter_nd": lambda m, a: m.npx.scatter_nd(
        a(ROWS), a(IDX), (3, 4, 5)),
    "scatter_nd_dupes": lambda m, a: m.npx.scatter_nd(
        a(onp.arange(4, dtype="float32")), a(onp.array([[1, 1, 2, 1]])),
        (4,)),
    "index_update": lambda m, a: m.npx.index_update(
        a(X), a(onp.array([[0, 2, 7], [1, 3, 0]])), a(onp.ones(5, "f4"))),
    "index_add": lambda m, a: m.npx.index_add(
        a(X), a(onp.array([[0, 0, -1], [1, 1, 9]])),
        a(onp.full((3, 5), 2.0, "f4"))),
    "sequence_mask": lambda m, a: m.npx.sequence_mask(
        a(SEQ), a(LEN), use_sequence_length=True, value=-2.0),
    "sequence_mask_axis1": lambda m, a: m.npx.sequence_mask(
        a(SEQ.transpose(1, 0, 2)), a(LEN), use_sequence_length=True,
        axis=1),
    "sequence_mask_off": lambda m, a: m.npx.sequence_mask(a(SEQ)),
    "sequence_last": lambda m, a: m.npx.sequence_last(
        a(SEQ), a(LEN), use_sequence_length=True),
    "sequence_last_nolen": lambda m, a: m.npx.sequence_last(a(SEQ), axis=1),
    "sequence_last_out_of_range": lambda m, a: m.npx.sequence_last(
        a(SEQ), a(onp.array([0, 7, 5], "int32")), use_sequence_length=True),
    "sequence_reverse_out_of_range": lambda m, a: m.npx.sequence_reverse(
        a(SEQ), a(onp.array([0, 7, 5], "int32")), use_sequence_length=True),
    "sequence_reverse": lambda m, a: m.npx.sequence_reverse(
        a(SEQ), a(LEN), use_sequence_length=True),
    "sequence_reverse_nolen": lambda m, a: m.npx.sequence_reverse(a(SEQ)),
    "reshape_like": lambda m, a: m.npx.reshape_like(a(X), a(X.reshape(12,
                                                                     5))),
    "arange_like": lambda m, a: m.npx.arange_like(a(X), start=1.5,
                                                  step=0.1),
    "arange_like_axis": lambda m, a: m.npx.arange_like(a(X), axis=1),
    "broadcast_like": lambda m, a: m.npx.broadcast_like(a(X[:, :1]),
                                                        a(X)),
    "slice": lambda m, a: m.npx.slice(a(X), (0, 1), (2, None), (1, 2)),
    "slice_like": lambda m, a: m.npx.slice_like(a(X), a(X[:2, :3]),
                                                axes=(0, 1)),
    "where": lambda m, a: m.npx.where(a(MASK), a(X), a(POS)),
    "batch_dot": lambda m, a: m.npx.batch_dot(a(A), a(B)),
    "batch_dot_t": lambda m, a: m.npx.batch_dot(
        a(A.transpose(0, 2, 1)), a(B.transpose(0, 2, 1)), transpose_a=True,
        transpose_b=True),
    "smooth_l1": lambda m, a: m.npx.smooth_l1(a(X), scalar=1.5),
    "softmax_xent_sparse": lambda m, a: m.npx.softmax_cross_entropy(
        a(X[0]), a(onp.array([0, 4, 2, 1], "int32"))),
    "softmax_xent_dense": lambda m, a: m.npx.softmax_cross_entropy(
        a(X[0]), a(POS[0] / POS[0].sum(-1, keepdims=True)),
        sparse_label=False),
    "reshape_codes": lambda m, a: m.npx.reshape(a(X), (0, -3)),
    "reshape_split": lambda m, a: m.npx.reshape(a(X), (-4, 1, 3, -2)),
    "reshape_infer": lambda m, a: m.npx.reshape(a(X), (-1, 5)),
    "reshape_copy": lambda m, a: m.npx.reshape(a(X), (3, -2)),
    "split_v2": lambda m, a: m.npx.split_v2(a(X), 2, axis=1),
    "split_v2_squeeze": lambda m, a: m.npx.split_v2(a(X), 3, axis=0,
                                                    squeeze_axis=True),
    "split_v2_indices": lambda m, a: m.npx.split_v2(a(X), (1, 3), axis=2),
    "space_to_depth": lambda m, a: m.npx.space_to_depth(a(IMG), 2),
    "depth_to_space": lambda m, a: m.npx.depth_to_space(a(IMG), 2),
    "shape_array": lambda m, a: m.npx.shape_array(a(X)),
    "size_array": lambda m, a: m.npx.size_array(a(X)),
    "nonzero": lambda m, a: m.npx.nonzero(a(MASK)),
    "constraint_check": lambda m, a: m.npx.constraint_check(a(POS > 0)),
    "amp_cast": lambda m, a: m.npx.amp_cast(a(X), dtype="float16"),
    "amp_cast_int": lambda m, a: m.npx.amp_cast(a(IDX), dtype="float16"),
    "amp_multicast": lambda m, a: m.npx.amp_multicast(
        a(X.astype("float16")), a(POS), a(IDX)),
    "selfatt_qk": lambda m, a: m.npx.interleaved_matmul_selfatt_qk(
        a(QKV), heads=2),
    "selfatt_valatt": lambda m, a: m.npx.interleaved_matmul_selfatt_valatt(
        a(QKV), a(ATT_SELF), heads=2),
    "encdec_qk": lambda m, a: m.npx.interleaved_matmul_encdec_qk(
        a(Q), a(KV), heads=2),
    "encdec_valatt": lambda m, a: m.npx.interleaved_matmul_encdec_valatt(
        a(KV), a(ATT_ED), heads=2),
    "multi_head_attention": lambda m, a: m.npx.multi_head_attention(
        a(Q.transpose(1, 0, 2)), a(Q.transpose(1, 0, 2)),
        a(Q.transpose(1, 0, 2)), 2),
    "multi_head_attention_causal": lambda m, a: m.npx.multi_head_attention(
        a(Q.transpose(1, 0, 2)), a(Q.transpose(1, 0, 2)),
        a(Q.transpose(1, 0, 2)), 2, causal=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_npx_tail_op_matches_jax(name):
    want = CASES[name](mx, mx.np.array)
    got = CASES[name](tmx, tmx.np.array)
    _match(got, want, name)


GRAD_CASES = ("sigmoid", "rcbrt", "erf", "gammaln", "softmin",
              "masked_softmax", "masked_log_softmax", "l2_norm_channel",
              "topk_both", "gather_nd", "scatter_nd", "index_update",
              "index_add", "sequence_mask", "sequence_last",
              "sequence_reverse", "where", "batch_dot_t", "smooth_l1",
              "softmax_xent_sparse", "softmax_xent_dense", "reshape_split",
              "space_to_depth", "selfatt_qk", "selfatt_valatt",
              "encdec_valatt", "multi_head_attention_causal")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_npx_tail_gradient_matches_jax(name):
    """The gradient of every float32 input of the case."""
    grads = []
    for m in (mx, tmx):
        inputs = []

        def arr(v, m=m, inputs=inputs):
            a = m.np.array(v)
            if a.dtype == onp.float32:
                a.attach_grad()
                inputs.append(a)
            return a
        with m.autograd.record():
            outs = _leaves(CASES[name](m, arr))
            y = sum((o * o).sum() for o in outs if o.dtype == onp.float32)
        y.backward()
        grads.append([a.grad for a in inputs])
    assert len(grads[0]) == len(grads[1])
    for i, (g, w) in enumerate(zip(grads[1], grads[0])):
        _match(g, w, f"{name} d{i}", rtol=1e-5, atol=1e-5)


def test_surface_lock():
    """Every public non-module name of the JAX npx, npx.random, and the
    op-coverage list REF_NPX."""
    ref = [n for n in dir(mx.npx) if not n.startswith("_")
           and not isinstance(getattr(mx.npx, n), types.ModuleType)]
    assert len(ref) >= 108
    missing = [n for n in ref + REF_NPX if not hasattr(tmx.npx, n)]
    assert not missing, missing
    assert isinstance(tmx.npx.random, types.ModuleType)
    for n in tmx.npx.random.__all__:
        assert getattr(tmx.npx.random, n) is getattr(tmx.npx, n)
    assert tmx.npx.random.gamma is tmx.np.random.gamma   # fall-through
    assert tmx.npx.clip_global_norm is tmx.gluon.utils.clip_global_norm


@pytest.mark.parametrize("op,name", [
    ("rnn", "rnn:gru"), ("gamma", "<lambda>"), ("index_add", "<lambda>"),
    ("softmin", "softmax"), ("reshape", "npx_reshape"), ("slice", "getitem"),
    ("softmax_cross_entropy", "sparse_softmax_xent"), ("topk", "topk"),
    ("box_nms", "box_nms"), ("multibox_target", "multibox_target")])
def test_host_plane_names_are_the_references(op, name):
    """The hooks (profiler span, fault probe, op counter) name each op as
    the reference's ``_invoke`` does."""
    fn = tmx.npx._PLAIN[op]
    args = (None,) * (2 if op == "softmax_cross_entropy" else 0)
    kwargs = {"mode": "gru"} if op == "rnn" else {}
    assert tmx.npx._ref_name(fn, args, kwargs) == name


def test_ops_count_in_telemetry():
    tmx.telemetry.enable()
    try:
        before = tmx.telemetry.snapshot()["counters"].get(
            "invoke.ops_total", 0)
        tmx.npx.topk(tmx.np.array(TIES), k=2)
        tmx.npx.smooth_l1(tmx.np.array(X))
        after = tmx.telemetry.snapshot()["counters"]["invoke.ops_total"]
    finally:
        tmx.telemetry.disable()
    assert after - before == 2


def test_tensor_calls_return_tensors():
    out = tmx.npx.topk(torch.from_numpy(TIES), k=2, ret_typ="both")
    assert all(type(o) is torch.Tensor for o in out)
    assert type(tmx.npx.gather_nd(torch.from_numpy(X),
                                  torch.from_numpy(IDX))) is torch.Tensor


def test_constraint_check_raises():
    for m in (mx, tmx):
        with pytest.raises(ValueError, match="bad input"):
            m.npx.constraint_check(m.np.array(X > 0), msg="bad input")


def test_savez_crosses_packages(tmp_path):
    for src, dst in ((mx, tmx), (tmx, mx)):
        path = str(tmp_path / f"{src.__name__}.npz")
        src.npx.savez(path, src.np.array(X), ids=src.np.array(IDX))
        got = dst.npx.load(path)
        assert sorted(got) == ["arr_0", "ids"]
        onp.testing.assert_array_equal(got["arr_0"].asnumpy(), X)
        onp.testing.assert_array_equal(got["ids"].asnumpy(), IDX)
        with pytest.raises(Exception, match="un-named"):
            src.npx.savez(path, src.np.array(X), arr_0=src.np.array(X))


def test_state_and_device_helpers():
    for m in (mx, tmx):
        m.npx.set_np()
        assert m.npx.is_np_array() and m.npx.is_np_shape()
        assert m.npx.is_np_default_dtype() is False
        m.npx.reset_np()
        m.npx.set_np()
        f = m.npx.use_np(lambda: 3)
        assert f() == 3 and m.npx.use_np_array(f) is f \
            and m.npx.use_np_shape(f) is f
        assert onp.dtype(m.npx.np_dtype("float32")) == onp.float32
    assert tmx.npx.cpu() == tmx.cpu() and tmx.npx.gpu(1) == tmx.gpu(1)
    assert tmx.npx.num_gpus() == tmx.num_gpus()


# -- control flow -----------------------------------------------------------

def test_foreach_matches_jax_with_gradients():
    """Values and gradients to the data, the initial state and a
    parameter the body closes over."""
    data = RS.rand(4, 3).astype("float32")
    w0 = onp.array([0.5, 2.0, 1.5], "float32")
    res = []
    for m in (mx, tmx):
        xs, s0, w = (m.np.array(v) for v in (data, onp.ones(3, "f4"), w0))
        for a in (xs, s0, w):
            a.attach_grad()
        with m.autograd.record():
            outs, final = m.npx.foreach(
                lambda x, s, w=w: (x * w + s, [s[0] * x, s[1] + x]), xs,
                [s0, s0 * 2])
            loss = (outs * outs).sum() + final[0].sum() + final[1].sum()
        loss.backward()
        res.append([outs, final[0], final[1], xs.grad, s0.grad, w.grad])
    for i, (g, w) in enumerate(zip(res[1], res[0])):
        _match(g, w, f"foreach[{i}]")


def test_foreach_list_outputs_and_empty_loop():
    for m in (mx, tmx):
        outs, final = m.npx.foreach(
            lambda x, s: ([x + s, x * s], s + x),
            [m.np.array(SEQ[:, 0]), m.np.array(SEQ[:, 1])][0],
            m.np.ones((2,)))
        assert [o.shape for o in outs] == [(5, 2), (5, 2)]
    ref = mx.npx.foreach(lambda x, s: (x + s, s + x), mx.np.zeros((0, 3)),
                         mx.np.ones((3,)))
    for record in (False, True):
        with tmx.autograd.record() if record else _null():
            outs, final = tmx.npx.foreach(lambda x, s: (x + s, s + x),
                                          tmx.np.zeros((0, 3)),
                                          tmx.np.ones((3,)))
        assert outs.shape == ref[0].shape == (0, 3)
        _match(final, ref[1], "foreach empty final")


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_while_loop_and_cond_match_jax():
    for m in (mx, tmx):
        outs, final = m.npx.while_loop(
            cond=lambda i, s: i < 5,
            func=lambda i, s: (i * 10, (i + 1, s + i)),
            loop_vars=(m.np.array(0), m.np.array(0)), max_iterations=100)
        assert [int(o) for o in outs.asnumpy()] == [0, 10, 20, 30, 40]
        assert int(final[0]) == 5 and int(final[1]) == 10
        outs, _ = m.npx.while_loop(lambda i: True, lambda i: (i, (i + 1,)),
                                   (m.np.array(0),), max_iterations=3)
        assert len(outs.asnumpy()) == 3
        x = m.np.array([2.0, -3.0])
        t = m.npx.cond(lambda a: a.sum() < 0, lambda a: a * 10,
                       lambda a: a + 1, [x])
        onp.testing.assert_allclose(t.asnumpy(), [20.0, -30.0])
        r = m.npx.cond(False, lambda: m.np.ones((2,)),
                       lambda: m.np.zeros((2,)))
        onp.testing.assert_allclose(r.asnumpy(), 0.0)


# -- samplers ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["bernoulli_prob", "bernoulli_logit",
                                  "uniform_n", "normal_n"])
def test_samplers_shapes_dtypes_moments(case):
    g = torch.Generator().manual_seed(24)
    n = 40000
    if case == "bernoulli_prob":
        s = tmx.npx.bernoulli(prob=tmx.np.array([0.2, 0.7]), size=(n, 2),
                              generator=g)
        ref = mx.npx.bernoulli(prob=mx.np.array([0.2, 0.7]), size=(n, 2))
        want_mean = [0.2, 0.7]
    elif case == "bernoulli_logit":
        s = tmx.npx.bernoulli(logit=0.0, size=(n,), dtype="int32",
                              generator=g)
        ref = mx.npx.bernoulli(logit=0.0, size=(n,), dtype="int32")
        want_mean = 0.5
    elif case == "uniform_n":
        s = tmx.npx.uniform_n(tmx.np.array([0.0, 2.0]), 3.0,
                              batch_shape=(n,), generator=g)
        ref = mx.npx.uniform_n(mx.np.array([0.0, 2.0]), 3.0,
                               batch_shape=(n,))
        want_mean = [1.5, 2.5]
    else:
        s = tmx.npx.normal_n(1.0, tmx.np.array([[1.0], [3.0]]),
                             batch_shape=n, generator=g)
        ref = mx.npx.normal_n(1.0, mx.np.array([[1.0], [3.0]]),
                              batch_shape=n)
        want_mean = [[1.0], [1.0]]
    assert s.shape == ref.shape and str(s.dtype) == str(ref.dtype)
    got = s.asnumpy().astype("float64")
    onp.testing.assert_allclose(got.mean(0), want_mean, atol=0.03)
    if case == "normal_n":
        onp.testing.assert_allclose(got.std(0), [[1.0], [3.0]], rtol=0.03)
    if case.startswith("bernoulli"):
        assert set(onp.unique(got)) <= {0.0, 1.0}
    with pytest.raises(tmx.MXNetError):
        tmx.npx.bernoulli(prob=0.5, logit=0.0)


def test_samplers_seeded_and_random_submodule():
    tmx.npx.seed(7)
    a = tmx.npx.random.uniform_n(batch_shape=(4,)).asnumpy()
    tmx.npx.random.seed(7)
    b = tmx.npx.uniform_n(batch_shape=(4,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    out = tmx.np.zeros((3,))
    tmx.npx.bernoulli(prob=tmx.np.array([1.0, 0.0, 1.0]), out=out)
    onp.testing.assert_array_equal(out.asnumpy(), [1.0, 0.0, 1.0])
