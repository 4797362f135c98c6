"""Port parity: the ``mx.np`` surface, JAX package -> PyTorch port.

The surface locks of ``tests/test_op_coverage.py`` (``REF_NP``,
``REF_RANDOM``, ``REF_LINALG``) on ``mxnet_tpu_torch.np``, and every case
of ``tests/test_numpy_op_sweep.py`` (its tables are imported) through both
packages: the same host inputs go to ``mxnet_tpu.np`` and
``mxnet_tpu_torch.np`` (on the CPU, ``with mx.cpu():``) and the port must
give the JAX package's result: the same structure, shapes and dtypes
exactly, integer and bool values exactly, floating values within rtol
1e-5 + atol 1e-6 (float32; the two libraries' transcendentals differ by a
few ulp), float16 rtol = atol 1e-3. The gradients of the sweep's
differentiable cases (its ``GRAD_CASES``, each run with the port's
``np`` in place of the reference's) are held against the JAX package's
``autograd`` at rtol 1e-5 + atol 1e-6.
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.test_utils import assert_almost_equal

import test_numpy_op_sweep as sweep
from test_op_coverage import REF_LINALG, REF_NP, REF_RANDOM

torch.set_num_threads(2)

TOL = {"float32": (1e-5, 1e-6), "float16": (1e-3, 1e-3),
       "float64": (1e-9, 1e-12), "complex64": (1e-5, 1e-6)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _to(ns, v):
    if isinstance(v, onp.ndarray):
        return ns.array(v)
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], onp.ndarray):
        return type(v)(ns.array(x) for x in v)
    return v


def _match(got, want, name):
    """The port's result against the reference's: structure, shape, dtype,
    values."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), f"{name}: {type(got)}"
        assert len(got) == len(want), f"{name}: {len(got)} vs {len(want)}"
        if hasattr(want, "_fields"):
            assert tuple(got._fields) == tuple(want._fields), name
        for g, w in zip(got, want):
            _match(g, w, name)
        return
    if not hasattr(want, "asnumpy"):
        assert got == want, f"{name}: {got!r} vs {want!r}"
        return
    w = want.asnumpy()
    rtol, atol = TOL.get(w.dtype.name, (0, 0))
    assert_almost_equal(got, w, rtol=rtol, atol=atol, names=(name, "jax"),
                        equal_nan=True, check_dtype=True)


# -- surface locks --------------------------------------------------------------

@pytest.mark.parametrize("namespace,names", [
    ("np", REF_NP), ("np.random", REF_RANDOM), ("np.linalg", REF_LINALG)])
def test_surface_is_the_references(namespace, names):
    ns = tnp if namespace == "np" else getattr(tnp, namespace[3:])
    missing = [n for n in names if not callable(getattr(ns, n, None))]
    assert not missing, f"mx.{namespace} missing: {missing}"


def test_an_unknown_np_name_raises():
    """No lazy fall-through to torch: a name outside the table raises."""
    for name in ("logaddexp", "nanmean", "fft"):
        with pytest.raises(AttributeError, match=name):
            getattr(tnp, name)
    with pytest.raises(AttributeError):
        tnp.linalg.cond


# -- forward: every case of the sweep -------------------------------------------

@pytest.mark.parametrize("name,case", sweep.FORWARD_CASES,
                         ids=sweep.FORWARD_IDS)
def test_forward_matches_jax(name, case):
    args, kwargs = case
    want = getattr(mx.np, name)(*[_to(mx.np, a) for a in args], **kwargs)
    got = getattr(tnp, name)(*[_to(tnp, a) for a in args], **kwargs)
    _match(got, want, name)


SECOND_DTYPE = [
    ("exp", "float16"), ("add", "float16"), ("multiply", "float16"),
    ("sum", "float16"), ("matmul", "float16"), ("tanh", "float16"),
    ("maximum", "float16"), ("abs", "float16"), ("sqrt", "float16"),
    ("mean", "float16"), ("exp", "float64"), ("sum", "float64"),
    ("add", "int8"), ("multiply", "int8"), ("maximum", "uint8"),
    ("sum", "int64")]


@pytest.mark.parametrize("name,dtype", SECOND_DTYPE)
def test_forward_second_dtype_matches_jax(name, dtype):
    """The sweep's second-dtype pass (``test_forward_second_dtype``):
    each op family in a non-default dtype, the 64-bit ones included."""
    rs = onp.random.RandomState(7)
    if onp.dtype(dtype).kind in "iu":
        a, b = (rs.randint(1, 5, size=(2, 3)).astype(dtype) for _ in "ab")
    else:
        a, b = (rs.uniform(0.5, 2.0, size=(2, 3)).astype(dtype)
                for _ in "ab")

    def run(np):
        x, y = np.array(a), np.array(b)
        if name == "matmul":
            return np.matmul(x, y.T)
        if name in ("add", "multiply", "maximum"):
            return getattr(np, name)(x, y)
        return getattr(np, name)(x)
    _match(run(tnp), run(mx.np), name)


def test_empty_shape_dtype_match_jax():
    for np_ in (mx.np, tnp):
        e = np_.empty((2, 3), dtype="float16")
        assert e.shape == (2, 3) and e.dtype == onp.float16
        el = np_.empty_like(np_.zeros((2, 2), dtype="int32"))
        assert el.shape == (2, 2) and el.dtype == onp.int32


# -- gradients: every differentiable case of the sweep ----------------------------

def _port_fn(f):
    """The sweep's case function with the port's ``np`` as its ``np``."""
    return types.FunctionType(f.__code__, {**f.__globals__, "np": tnp},
                              f.__name__, f.__defaults__, f.__closure__)


def _grads(ag, np_, arrays, f):
    xs = [np_.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with ag.record():
        out = f(xs)
    out.backward()
    return out, [x.grad for x in xs]


@pytest.mark.parametrize("name", sweep.GRAD_IDS)
def test_gradient_matches_jax(name):
    arrays, f = sweep.GRAD_CASES[name]
    want_out, want = _grads(mx.autograd, mx.np, arrays, f)
    got_out, got = _grads(tmx.autograd, tnp, arrays, _port_fn(f))
    _match(got_out, want_out, name)
    for i, (g, w) in enumerate(zip(got, want)):
        _match(g, w, f"{name} input {i}")


# -- beyond the sweep: dtype rules and options the sweep leaves out ---------------

_RS = onp.random.RandomState(3)
F34 = _RS.uniform(-2, 2, (3, 4)).astype("float32")
I34 = _RS.randint(-5, 6, (3, 4)).astype("int32")
L4 = onp.array([3, -1, 7, 2], dtype="int64")
B34 = F34 > 0

MORE = {
    "sum_int": ("sum", (I34,), {"axis": 0}),
    "sum_bool": ("sum", (B34,), {}),
    "sum_int8": ("sum", (I34.astype("int8"),), {}),
    "sum_uint8": ("sum", (onp.abs(I34).astype("uint8"),), {"axis": 1}),
    "sum_dtype": ("sum", (I34,), {"dtype": "float32"}),
    "prod_int": ("prod", (I34[:, :2] % 3 + 1,), {}),
    "cumsum_bool": ("cumsum", (B34,), {"axis": 1}),
    "mean_int": ("mean", (I34,), {"axis": 1}),
    "mean_int64": ("mean", (L4,), {}),
    "var_int": ("var", (I34,), {"ddof": 1}),
    "max_bool": ("max", (B34,), {"axis": 0}),
    "argmax_int64": ("argmax", (L4,), {}),
    "argmin_keepdims": ("argmin", (F34,), {"axis": 1, "keepdims": True}),
    "sqrt_int": ("sqrt", (onp.abs(I34),), {}),
    "exp_int64": ("exp", (L4 % 3,), {}),
    "ceil_int": ("ceil", (I34,), {}),
    "rint_int": ("rint", (I34,), {}),
    "round_int": ("round", (I34,), {}),
    "square_bool": ("square", (B34,), {}),
    "divide_int": ("true_divide", (I34, 3), {}),
    "add_bool_int": ("add", (B34, 1), {}),
    "add_int_float": ("add", (I34, 2.5), {}),
    "maximum_int_float": ("maximum", (I34, 0.5), {}),
    "clip_int_float": ("clip", (I34, -1.5, 2.5), {}),
    "mod_int": ("mod", (I34, 4), {}),
    "power_int": ("power", (onp.abs(I34), 2), {}),
    "ldexp_int": ("ldexp", (I34, onp.abs(I34) % 3), {}),
    "reciprocal_int": ("reciprocal", (onp.abs(I34) + 1,), {}),
    "fabs_int": ("fabs", (I34,), {}),
    "median_int": ("median", (I34,), {"axis": 1}),
    "median_even": ("median", (onp.array([4, 1, 3, 2], "int32"),), {}),
    "median_nan": ("median", (onp.array([1.0, onp.nan, 3.0], "float32"),),
                   {}),
    "percentile_lower": ("percentile", (F34, 40.0),
                         {"axis": 0, "method": "lower"}),
    "percentile_higher": ("percentile", (F34, 40.0), {"method": "higher"}),
    "percentile_nearest": ("percentile", (F34, 40.0), {"method": "nearest"}),
    "percentile_midpoint": ("percentile", (F34, 40.0),
                            {"method": "midpoint"}),
    "quantile_array": ("quantile", (F34, onp.array([0.1, 0.9], "float32")),
                       {"axis": 1}),
    "quantile_keepdims": ("quantile", (F34, 0.3), {"axis": 0,
                                                   "keepdims": True}),
    "average_axis": ("average", (F34,), {"axis": 1,
                                         "weights": onp.arange(1, 5.0)
                                         .astype("float32")}),
    "unique_2d": ("unique", (I34,), {"return_inverse": True}),
    "unique_int64": ("unique", (L4,), {"return_index": True}),
    "nonzero_int64": ("nonzero", (L4,), {}),
    "take_out_of_range": ("take", (F34.reshape(-1),
                                   onp.array([0, 20, -1], "int32")), {}),
    "take_clip": ("take", (F34, onp.array([0, 9], "int32")),
                  {"axis": 1, "mode": "clip"}),
    "take_wrap": ("take", (F34, onp.array([-5, 9], "int32")),
                  {"axis": 1, "mode": "wrap"}),
    "pad_edge": ("pad", (F34, ((1, 2), (2, 1))), {"mode": "edge"}),
    "pad_reflect": ("pad", (F34, ((2, 1), (1, 3))), {"mode": "reflect"}),
    "pad_symmetric": ("pad", (F34, 2), {"mode": "symmetric"}),
    "pad_wrap": ("pad", (F34, ((1, 1), (5, 0))), {"mode": "wrap"}),
    "pad_value": ("pad", (I34, 1), {"constant_values": 7}),
    "histogram_range": ("histogram", (F34, 4), {"range": (-1.0, 1.0)}),
    "diff_prepend": ("diff", (F34,), {"prepend": 1.0}),
    "diff_n2_append": ("diff", (F34,), {"axis": 0, "n": 2, "append": 2.0}),
    "diff_bool": ("diff", (onp.array([True, False, False]),), {}),
    "insert_axis": ("insert", (F34, 1, 9.0), {"axis": 1}),
    "insert_values": ("insert", (F34, 1, onp.array([7.0, 8.0, 9.0],
                                                   "float32")), {"axis": 1}),
    "insert_flat": ("insert", (F34, -1, 5.0), {}),
    "delete_axis": ("delete", (F34, onp.array([0, 2], "int32")),
                    {"axis": 1}),
    "roll_flat": ("roll", (F34, 5), {}),
    "rot90_k": ("rot90", (F34, 3), {"axes": (1, 0)}),
    "tile_short": ("tile", (F34, 2), {}),
    "repeat_flat": ("repeat", (F34, 2), {}),
    "concatenate_none": ("concatenate", ([F34, F34],), {"axis": None}),
    "cross_2d": ("cross", (F34[:, :2], F34[:, 2:]), {}),
    "cross_batch": ("cross", (F34[:, :3], F34[:, 1:]), {}),
    "dot_scalar": ("dot", (F34, 2.0), {}),
    "dot_nd": ("dot", (F34.reshape(3, 2, 2), F34[:2].reshape(2, 4)), {}),
    "inner_2d": ("inner", (F34, F34), {}),
    "matmul_int": ("matmul", (I34, I34.T), {}),
    "tensordot_int": ("tensordot", (F34, F34.T), {"axes": 1}),
    "trace_offset": ("trace", (F34,), {"offset": 1}),
    "eye_dtype": ("eye", (3,), {"k": -1, "dtype": "int32"}),
    "arange_float": ("arange", (0.0, 1.0, 0.25), {}),
    "arange_dtype": ("arange", (5,), {"dtype": "float32"}),
    "linspace_open": ("linspace", (0.0, 1.0, 4), {"endpoint": False}),
    "full_int": ("full", ((2, 2), 7), {}),
    "full_bool": ("full", ((2,), True), {}),
    "tri_k": ("tri", (3, 5), {"k": 1}),
    "tril_indices_m": ("tril_indices", (3,), {"k": 1, "m": 4}),
    "indices_dtype": ("indices", ((2, 2),), {"dtype": "float32"}),
    "hanning_1": ("hanning", (1,), {}),
    "blackman_0": ("blackman", (0,), {}),
    "bincount_minlength": ("bincount", (onp.array([1, 1, 2], "int32"),),
                           {"minlength": 5}),
    "bincount_weights": ("bincount", (onp.array([1, 1, 2], "int32"),),
                         {"weights": onp.array([0.5, 1.0, 2.0],
                                               "float32")}),
    "where_scalars": ("where", (B34, 1.0, 0.0), {}),
    "nan_to_num_args": ("nan_to_num", (onp.array([onp.nan, onp.inf,
                                                  -onp.inf], "float32"),),
                        {"nan": 1.0, "posinf": 2.0, "neginf": -2.0}),
    "fill_diagonal_tall": ("fill_diagonal", (onp.zeros((5, 2), "float32"),
                                             3.0), {}),
    "einsum_ellipsis": ("einsum", ("...j,kj->...k", F34, F34), {}),
}


@pytest.mark.parametrize("case", sorted(MORE))
def test_more_cases_match_jax(case):
    name, args, kwargs = MORE[case]
    want = getattr(mx.np, name)(*[_to(mx.np, a) for a in args], **kwargs)
    got = getattr(tnp, name)(*[_to(tnp, a) for a in args], **kwargs)
    _match(got, want, case)
