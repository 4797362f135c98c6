"""On-card checks of sparse storage (marker ``cuda``).

What only a card can show: ``sparse.dedupe_coo`` (the stable sort, the
prefix sum and ``index_add_`` on the device) and the CSR ``dot`` on
``cuda:0`` against their CPU results; the lazy updates of SGD with and
without momentum, Adam and GroupAdaGrad on the card against the CPU
(untouched rows bit for bit); ``Embedding(sparse_grad=True)`` trained
through the Trainer's store on the card against the CPU; and a step that
builds a ``RowSparseNDArray`` (``dedupe_coo``) and applies the lazy
update inside a captured CUDA graph, replayed on new ids against the
eager steps, which shows that nothing on that path reads the host.
They skip without a card (decided in the ``cuda_device`` fixture). This
file imports neither JAX nor the JAX package, so it runs on the card's
machine with ``--noconftest``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import sparse

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's sort, scans and "
                    "atomics have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _batch(seed, k=700, vocab=5000, width=64):
    rs = onp.random.RandomState(seed)
    return (torch.from_numpy(rs.randint(0, vocab, k)),
            torch.from_numpy(rs.randn(k, width).astype("float32")))


@pytest.mark.parametrize("k,vocab", [(700, 5000), (700, 40), (1, 3)])
def test_dedupe_coo_on_the_card_matches_the_cpu(cuda_device, k, vocab):
    ids, vals = _batch(0, k, vocab, 16)
    ci, cv = sparse.dedupe_coo(ids, vals, vocab)
    gi, gv = sparse.dedupe_coo(ids.to(cuda_device), vals.to(cuda_device),
                               vocab)
    assert torch.equal(gi.cpu(), ci)
    # duplicates are summed by atomics on the card: any order
    torch.testing.assert_close(gv.cpu(), cv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_on_the_card_matches_the_cpu(cuda_device, transpose_a):
    rs = onp.random.RandomState(1)
    d = rs.randn(300, 200).astype("float32")
    d[rs.rand(300, 200) < 0.9] = 0
    rhs = rs.randn(300 if transpose_a else 200, 5).astype("float32")
    with tmx.cpu():
        want = sparse.dot(sparse.csr_matrix(d), tmx.np.array(rhs),
                          transpose_a=transpose_a).asnumpy()
    with tmx.gpu(0):
        got = sparse.dot(sparse.csr_matrix(d), tmx.np.array(rhs),
                         transpose_a=transpose_a)
    assert got._data.is_cuda
    onp.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("groupadagrad", dict(learning_rate=0.1))])
def test_lazy_updates_on_the_card_match_the_cpu(cuda_device, name, kw):
    vocab, width = 5000, 64
    w0 = torch.randn(vocab, width, generator=torch.Generator()
                     .manual_seed(2))
    results, touched = [], set()
    for device in (torch.device("cpu"), cuda_device):
        o = tmx.optimizer.create(name, lazy_update=True, **kw)
        upd = tmx.optimizer.get_updater(o)
        w = w0.clone().to(device)
        for step in range(3):
            ids, vals = _batch(10 + step, 700, vocab, width)
            touched |= set(ids.tolist())
            uidx, uvals = sparse.dedupe_coo(ids.to(device), vals.to(device),
                                            vocab)
            upd(0, sparse.RowSparseNDArray(uvals, uidx, (vocab, width)), w)
        results.append(w.cpu())
    torch.testing.assert_close(results[1], results[0], rtol=1e-6, atol=1e-6)
    rest = torch.tensor(sorted(set(range(vocab)) - touched))
    assert torch.equal(results[1][rest], w0[rest])


def test_sparse_embedding_trainer_on_the_card_matches_the_cpu(cuda_device):
    ids = torch.from_numpy(onp.random.RandomState(3).randint(0, 300, (35, 20)))
    c = torch.randn(35, 20, 16, generator=torch.Generator().manual_seed(3))
    w0 = torch.randn(300, 16, generator=torch.Generator().manual_seed(4))
    weights = []
    for device in ("cpu", "cuda:0"):
        net = tmx.gluon.nn.Embedding(300, 16, sparse_grad=True,
                                     device=device)
        net.initialize()
        net.collect_params()["weight"].set_data(w0)
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01,
                                     "lazy_update": True})
        for _ in range(3):
            with tmx.autograd.record():
                loss = (net(ids.to(device)) * c.to(device)).sum()
            tmx.autograd.backward(loss)
            trainer.step(1)
        assert trainer._update_on_kvstore
        weights.append(net.collect_params()["weight"].data().detach().cpu())
    torch.testing.assert_close(weights[1], weights[0], rtol=1e-6, atol=1e-6)


def test_row_sparse_step_captures_in_a_cuda_graph(cuda_device):
    """dedupe_coo, the RowSparseNDArray and the lazy SGD-momentum update
    captured in one CUDA graph: a capture fails on any host read. The
    replays on new ids give the eager steps' indices exactly and their
    weights and momenta within 1e-6 (duplicates are summed by atomics)."""
    vocab, width, k = 5000, 64, 700
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               lazy_update=True)
    w0 = torch.randn(vocab, width, device=cuda_device)
    ids_buf = torch.zeros(k, dtype=torch.long, device=cuda_device)
    vals_buf = torch.zeros(k, width, device=cuda_device)

    def step(w, mom, ids, vals):
        uidx, uvals = sparse.dedupe_coo(ids, vals, vocab)
        rsp = sparse.RowSparseNDArray(uvals, uidx, (vocab, width))
        opt._lazy_update_impl(0, w, rsp, mom, 0.1, 0.0)
        return rsp

    w_g, m_g = w0.clone(), torch.zeros_like(w0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):      # warm-up: the sort's workspace
        ids, vals = _batch(20, k, vocab, width)
        ids_buf.copy_(ids)
        vals_buf.copy_(vals)
        step(w0.clone(), torch.zeros_like(w0), ids_buf, vals_buf)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rsp = step(w_g, m_g, ids_buf, vals_buf)
    assert isinstance(rsp, sparse.RowSparseNDArray)
    w_e, m_e = w0.clone(), torch.zeros_like(w0)
    for s in range(3):
        ids, vals = _batch(30 + s, k, vocab, width)
        ids_buf.copy_(ids)
        vals_buf.copy_(vals)
        graph.replay()
        step(w_e, m_e, ids.to(cuda_device), vals.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(rsp.indices._data, sparse.dedupe_coo(
            ids.to(cuda_device), vals.to(cuda_device), vocab)[0])
    torch.testing.assert_close(w_g, w_e, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m_g, m_e, rtol=1e-6, atol=1e-6)
