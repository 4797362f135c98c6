"""On-card tests of ``mx.np`` (marker ``cuda``).

They skip where no card is present (the decision is taken inside the
``gpu`` fixture, never at import). This file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_np_cuda.py

A sample of the ``mx.np`` surface runs on ``mx.gpu(0)`` and is held
against the port's own results on the CPU: shapes and dtypes exactly,
integers and bools exactly, floats at rtol = atol = 2e-5 (the sweep's
tolerance; the card's transcendentals differ from the host's by a few
ulp), linalg at rtol 1e-4 + atol 1e-5. An ``ndarray``'s gradients on the
card against the CPU's at the same tolerance. A block whose forward is
written in ``mx.np`` is captured into one CUDA graph and its forward and
gradients agree with the eager block's within 1e-5 of their largest
value (cuBLAS may pick another algorithm under capture).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.parameter import Parameter
from mxnet_tpu_torch.test_utils import assert_almost_equal

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)
RS = onp.random.RandomState(17)
A = RS.uniform(-2, 2, (3, 4)).astype("float32")
B = RS.uniform(-2, 2, (3, 4)).astype("float32")
P = RS.uniform(0.5, 3, (3, 4)).astype("float32")
I = RS.randint(-4, 5, (3, 4)).astype("int32")
M = RS.rand(3, 4) > 0.5
SQ = (RS.randn(4, 4) + 2 * onp.eye(4)).astype("float32")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return tmx.gpu(0)


SAMPLE = [
    ("add", (A, B), {}), ("subtract", (A, 1.5), {}), ("multiply", (A, B), {}),
    ("true_divide", (A, P), {}), ("power", (P, B), {}), ("mod", (A, P), {}),
    ("maximum", (A, B), {}), ("fmax", (A, 0.0), {}), ("hypot", (A, B), {}),
    ("arctan2", (A, P), {}), ("exp", (A,), {}), ("log", (P,), {}),
    ("sqrt", (P,), {}), ("cbrt", (P,), {}), ("tanh", (A,), {}),
    ("arcsinh", (A,), {}), ("sign", (A,), {}), ("rint", (A,), {}),
    ("equal", (I, 1), {}), ("logical_xor", (M, ~M), {}),
    ("bitwise_and", (I, 3), {}), ("gcd", (I, 6), {}),
    ("sum", (I,), {"axis": 0}), ("mean", (I,), {}), ("std", (A,),
                                                      {"ddof": 1}),
    ("prod", (P,), {"axis": 1}), ("cumsum", (A,), {"axis": 1}),
    ("argmax", (A,), {"axis": 1}), ("median", (A,), {"axis": 0}),
    ("percentile", (A, 30.0), {}), ("quantile", (A, 0.75), {"axis": 1}),
    ("sort", (A,), {}), ("argsort", (A,), {"axis": 0}),
    ("unique", (I,), {"return_index": True, "return_inverse": True,
                      "return_counts": True}),
    ("nonzero", (I,), {}), ("where", (M, A, B), {}), ("take", (A, I % 4),
                                                      {"axis": 1}),
    ("clip", (A, -1.0, 1.0), {}), ("pad", (A, ((1, 0), (2, 1))),
                                   {"mode": "reflect"}),
    ("concatenate", ([A, B],), {"axis": 1}), ("stack", ([A, B],), {}),
    ("split", (A, 2), {"axis": 1}), ("tile", (A, (2, 1)), {}),
    ("repeat", (A, 2), {"axis": 1}), ("roll", (A, 1), {}),
    ("flip", (A,), {"axis": 1}), ("diff", (A,), {}), ("histogram", (A, 4),
                                                      {}),
    ("bincount", (onp.abs(I).reshape(-1),), {}), ("interp", (
        A.reshape(-1), onp.array([-2.0, 0.0, 2.0], "float32"),
        onp.array([1.0, 0.0, 3.0], "float32")), {}),
    ("matmul", (A, B.T), {}), ("dot", (A, B.T), {}), ("einsum", (
        "ij,kj->ik", A, B), {}), ("kron", (A[:2, :2], B[:2, :2]), {}),
    ("tensordot", (A, B.T), {"axes": 1}), ("trace", (SQ,), {}),
    ("hanning", (6,), {}), ("blackman", (6,), {}), ("tri", (3, 4), {}),
    ("tril_indices", (4,), {}), ("arange", (0, 10, 3), {}),
    ("linspace", (0.0, 1.0, 7), {}), ("eye", (3, 4, 1), {}),
    ("full", ((2, 2), 7), {}), ("fill_diagonal", (SQ, 1.0), {}),
]


def _run(ctx, fn, args, kwargs):
    with ctx:
        xs = [tmx.np.array(a) if isinstance(a, onp.ndarray) else
              [tmx.np.array(x) for x in a] if isinstance(a, list) else a
              for a in args]
        return fn(*xs, **kwargs)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _compare(got, want, ctx, tol=TOL):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ctx == ctx
        exact = w.dtype.kind not in "fc" if hasattr(w.dtype, "kind") \
            else False
        assert_almost_equal(g, w, check_dtype=True,
                            **(dict(rtol=0, atol=0) if exact else tol))


@pytest.mark.parametrize("name,args,kwargs", SAMPLE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SAMPLE)])
def test_np_op_on_the_card_matches_the_cpu(gpu, name, args, kwargs):
    fn = getattr(tmx.np, name)
    _compare(_run(gpu, fn, args, kwargs), _run(tmx.cpu(), fn, args, kwargs),
             gpu)


LINALG = [("det", (SQ,), {}), ("inv", (SQ,), {}), ("solve", (SQ, A.T), {}),
          ("cholesky", (SQ @ SQ.T,), {}), ("slogdet", (SQ,), {}),
          ("eigvalsh", (SQ @ SQ.T,), {}), ("pinv", (A,), {}),
          ("norm", (A,), {"ord": "nuc"}), ("matrix_rank", (SQ,), {}),
          ("matrix_power", (SQ, 3), {}), ("lstsq", (A.T, A[0]), {})]


@pytest.mark.parametrize("name,args,kwargs", LINALG,
                         ids=[c[0] for c in LINALG])
def test_linalg_on_the_card_matches_the_cpu(gpu, name, args, kwargs):
    fn = getattr(tmx.np.linalg, name)
    _compare(_run(gpu, fn, args, kwargs), _run(tmx.cpu(), fn, args, kwargs),
             gpu, dict(rtol=1e-4, atol=1e-5))


def test_eig_runs_on_the_host_and_returns_on_the_card(gpu):
    w, v = _run(gpu, tmx.np.linalg.eig, (SQ,), {})
    assert w.ctx == v.ctx == gpu and str(w.dtype) == "complex64"
    onp.testing.assert_allclose(SQ @ v.asnumpy(), v.asnumpy() * w.asnumpy(),
                                atol=1e-4)


def test_the_default_context_is_the_card(gpu):
    assert tmx.np.zeros((2,)).ctx == gpu
    assert tmx.current_context() == gpu
    with tmx.cpu():
        assert tmx.np.ones((2,)).ctx == tmx.cpu()


def test_ndarray_gradients_on_the_card_match_the_cpu(gpu):
    grads = []
    for ctx in (gpu, tmx.cpu()):
        with ctx:
            x = tmx.np.array(A)
            x.attach_grad()
            with tmx.autograd.record():
                y = (tmx.np.tanh(x) @ tmx.np.array(B.T)).sum()
                y = y + tmx.np.linalg.norm(x) * 0.5
            y.backward()
            grads.append(x.grad)
    _compare(grads[0], grads[1], gpu)


def test_np_random_on_the_card(gpu):
    with gpu:
        tmx.np.random.seed(4)
        a = tmx.np.random.normal(size=(1000,))
        tmx.np.random.seed(4)
        b = tmx.np.random.normal(size=(1000,))
        assert a.ctx == gpu and torch.equal(a._data, b._data)
        c = tmx.np.random.randint(0, 7, size=(500,))
        assert c.dtype == onp.int32 and 0 <= int(c.min()) <= int(c.max()) < 7


class _NpBlock(tmx.gluon.HybridBlock):
    def __init__(self, device):
        super().__init__()
        self.w = Parameter((32, 16), device=device).data()

    def forward(self, x):
        h = tmx.np.tanh(x @ self.w)
        return tmx.np.sum(h * h + 0.5 * h, axis=1)


def test_an_np_forward_block_is_captured(gpu):
    """Forward and backward of a block written in ``mx.np``, hybridized:
    one graph each, against the eager block."""
    x = onp.random.RandomState(5).randn(8, 32).astype("float32")
    eager = _NpBlock(torch.device("cuda", 0)).initialize(seed=1)
    hybrid = _NpBlock(torch.device("cuda", 0)).initialize(seed=1)
    hybrid.hybridize()
    outs = []
    for block in (eager, hybrid):
        for _ in range(2):  # the second call replays the captured graphs
            xs = tmx.np.array(x, ctx=gpu)
            xs.attach_grad()
            with tmx.autograd.record():
                y = block(xs)
            y.backward()
        outs.append((y, xs.grad, block.w.grad.clone()))
    graph = hybrid._cached_graph
    assert graph.captures == 1
    entry = next(iter(graph._signatures.values()))
    assert entry.fwd is not None
    for g, w in zip(outs[1], outs[0]):
        g = getattr(g, "_data", g)
        w = getattr(w, "_data", w)
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale
