"""Port parity: ``mx.nd``, the legacy surface, JAX package -> PyTorch port.

Every name of ``tests/test_legacy_ops.py``'s surface lock resolves to a
callable in the port's ``mx.nd``, and each runs on the same seeded
inputs through both packages' ``mx.nd`` on the CPU (values within rtol
1e-5 + atol 1e-5 of the JAX results, indices exactly; the loss layers'
gradients too), with 1.x string attributes; ``out=`` writes through; the
``linalg_*`` family and the spatial samplers by the same oracles;
``mx.nd.save`` / ``load`` files read by the other package both ways
(the 1.x binary format, names, dtypes, the refusal of a bare array);
``LibSVMIter``'s batches as ``CSRNDArray`` components, equal to the JAX
package's; ``nd.contrib``'s control flow, FFT and ``dgl_*`` graph ops.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

torch.set_num_threads(2)

LEGACY_NAMES = [
    "Activation", "BatchNorm", "BlockGrad", "CTCLoss", "Cast", "Concat",
    "Convolution", "Crop", "Custom", "Deconvolution", "Dropout",
    "ElementWiseSum", "Embedding", "ExpandDims", "Flatten",
    "FullyConnected", "GroupNorm", "IdentityAttachKLSparseReg",
    "InstanceNorm", "L2Normalization", "LRN", "LayerNorm", "LeakyReLU",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "Pad", "Pooling", "RNN",
    "ROIPooling", "Reshape", "SequenceLast", "SequenceMask",
    "SequenceReverse", "SliceChannel", "Softmax", "SoftmaxOutput",
    "SwapAxis", "UpSampling",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "broadcast_greater", "broadcast_to", "broadcast_axis",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "stop_gradient", "argmax_channel", "ones_like", "zeros_like",
    "dot", "batch_dot", "one_hot", "pick", "topk", "gather_nd",
    "slice_axis", "slice_like", "sequence_mask", "clip", "take", "tile",
    "repeat", "where", "abs", "exp", "log", "sqrt", "square", "maximum",
    "minimum", "argmax", "argmin", "sum", "mean", "max", "min", "norm",
]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def test_legacy_surface_lock():
    missing = [n for n in LEGACY_NAMES if not callable(getattr(tmx.nd, n,
                                                               None))]
    assert not missing, missing
    with pytest.raises(tmx.MXNetError, match="mx.operator"):
        tmx.nd.Custom(tmx.nd.ones(2), op_type="square")


def _r(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype("float32")


def _grad_of(nd, autograd, fn, x):
    """fn(x) and x's gradient (the loss layers' backward ignores the head
    gradient)."""
    x = nd.array(x)
    x.attach_grad()
    with autograd.record():
        out = fn(x)
    out.backward()
    return out, x.grad


def _loss_case(op, label_fn=None, **kw):
    def case(nd, ag, rs):
        x = _r(rs, 4, 3)
        lab = label_fn(rs) if label_fn else _r(rs, 4, 3)
        return _grad_of(nd, ag, lambda v: getattr(nd, op)(
            v, nd.array(lab), **kw), x)
    return case


CASES = {
    "FullyConnected": lambda nd, ag, rs: nd.FullyConnected(
        nd.array(_r(rs, 4, 10)), nd.array(_r(rs, 3, 10)),
        nd.array(_r(rs, 3)), num_hidden=3),
    "FullyConnected_no_bias_strings": lambda nd, ag, rs: nd.FullyConnected(
        nd.array(_r(rs, 4, 10)), nd.array(_r(rs, 3, 10)),
        num_hidden="3", no_bias="True"),
    "Convolution_strings": lambda nd, ag, rs: nd.Convolution(
        nd.array(_r(rs, 2, 3, 8, 8)), nd.array(_r(rs, 4, 3, 3, 3, scale=.1)),
        nd.array(_r(rs, 4)), kernel="(3, 3)", num_filter="4",
        stride="(1, 1)", pad="(1, 1)"),
    "Deconvolution": lambda nd, ag, rs: nd.Deconvolution(
        nd.array(_r(rs, 2, 4, 5, 5)), nd.array(_r(rs, 4, 3, 3, 3, scale=.1)),
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=3),
    "BatchNorm_Activation_Pooling": lambda nd, ag, rs: nd.Pooling(
        nd.Activation(nd.BatchNorm(nd.array(_r(rs, 2, 4, 8, 8)),
                                   nd.ones(4), nd.zeros(4), nd.zeros(4),
                                   nd.ones(4), fix_gamma=True),
                      act_type="relu"),
        kernel=(2, 2), stride=(2, 2), pool_type="max"),
    "Pooling_avg_global": lambda nd, ag, rs: nd.Pooling(
        nd.array(_r(rs, 2, 3, 5, 5)), kernel=(2, 2), pool_type="avg",
        global_pool="True"),
    "LayerNorm": lambda nd, ag, rs: nd.LayerNorm(
        nd.array(_r(rs, 3, 6)), nd.array(_r(rs, 6)), nd.array(_r(rs, 6))),
    "GroupNorm": lambda nd, ag, rs: nd.GroupNorm(
        nd.array(_r(rs, 2, 4, 3, 3)), nd.array(_r(rs, 4)),
        nd.array(_r(rs, 4)), num_groups=2),
    "InstanceNorm": lambda nd, ag, rs: nd.InstanceNorm(
        nd.array(_r(rs, 2, 3, 4)), nd.array(_r(rs, 3)), nd.array(_r(rs, 3))),
    "L2Normalization": lambda nd, ag, rs: nd.L2Normalization(
        nd.array(_r(rs, 3, 5)), mode="instance"),
    "LeakyReLU": lambda nd, ag, rs: nd.LeakyReLU(nd.array(_r(rs, 3, 5)),
                                                 slope="0.1"),
    "Dropout_predict": lambda nd, ag, rs: nd.Dropout(
        nd.array(_r(rs, 3, 5)), p=0.5),
    "Embedding": lambda nd, ag, rs: nd.Embedding(
        nd.array(onp.array([[1, 4], [0, 2]], "int32")),
        nd.array(_r(rs, 5, 3)), input_dim=5, output_dim=3),
    "RNN_lstm": lambda nd, ag, rs: nd.RNN(
        nd.array(_r(rs, 4, 2, 3)),
        nd.array(_r(rs, 4 * 5 * (3 + 5) + 2 * 4 * 5, scale=.1)),
        nd.zeros((1, 2, 5)), nd.zeros((1, 2, 5)), mode="lstm",
        state_size=5, num_layers=1),
    "Reshape_codes": lambda nd, ag, rs: [
        nd.Reshape(nd.array(_r(rs, 2, 3, 4)), shape=s)
        for s in ((-1,), (0, -1), (-3, 0), "(0, -1)")],
    "Reshape_target_shape": lambda nd, ag, rs: nd.Reshape(
        nd.array(_r(rs, 2, 3, 4)), target_shape=(0, 12)),
    "Flatten": lambda nd, ag, rs: nd.Flatten(nd.array(_r(rs, 2, 3, 4))),
    "SliceChannel_Concat": lambda nd, ag, rs: [
        nd.Concat(*nd.SliceChannel(nd.array(_r(rs, 2, 6, 4)),
                                   num_outputs=3, axis=1), dim=1),
        nd.SliceChannel(nd.array(_r(rs, 2, 6, 4)), num_outputs=6, axis=1,
                        squeeze_axis=True)[2]],
    "SwapAxis_ExpandDims_Cast": lambda nd, ag, rs: [
        nd.SwapAxis(nd.array(_r(rs, 2, 3, 4)), dim1=0, dim2=2),
        nd.ExpandDims(nd.array(_r(rs, 2, 3)), axis=1),
        nd.Cast(nd.array(_r(rs, 2, 3)), dtype="float16")],
    "Pad_UpSampling": lambda nd, ag, rs: [
        nd.Pad(nd.array(_r(rs, 1, 2, 3, 3)), mode="constant",
               pad_width=(0, 0, 0, 0, 1, 1, 2, 2), constant_value=5),
        nd.Pad(nd.array(_r(rs, 1, 2, 3, 3)), mode="edge",
               pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
        nd.UpSampling(nd.array(_r(rs, 1, 2, 3, 3)), scale=2,
                      sample_type="nearest"),
        nd.UpSampling(nd.array(_r(rs, 1, 2, 3, 3)), scale=2,
                      sample_type="bilinear")],
    "Crop": lambda nd, ag, rs: [
        nd.Crop(nd.array(_r(rs, 1, 2, 6, 6)), offset=(1, 2), h_w=(3, 3)),
        nd.Crop(nd.array(_r(rs, 1, 2, 6, 6)), h_w=(4, 2),
                center_crop=True)],
    "ElementWiseSum": lambda nd, ag, rs: nd.ElementWiseSum(
        nd.array(_r(rs, 3)), nd.array(_r(rs, 3)), nd.array(_r(rs, 3))),
    "IdentityAttachKLSparseReg": lambda nd, ag, rs:
        nd.IdentityAttachKLSparseReg(nd.array(_r(rs, 3))),
    "LRN": lambda nd, ag, rs: nd.LRN(nd.array(_r(rs, 2, 8, 4, 4)),
                                     alpha=1e-3, beta=0.75, knorm=2,
                                     nsize=3),
    "ROIPooling": lambda nd, ag, rs: nd.ROIPooling(
        nd.array(_r(rs, 2, 3, 8, 8)),
        nd.array(onp.array([[0, 0, 0, 5, 5], [1, 2, 1, 7, 6]], "float32")),
        pooled_size=(1, 2), spatial_scale=1.0),
    "Sequence_ops": lambda nd, ag, rs: [
        nd.SequenceMask(nd.array(_r(rs, 5, 2, 3)),
                        nd.array(onp.array([2, 4], "float32")),
                        use_sequence_length=True, value=-1.0),
        nd.SequenceLast(nd.array(_r(rs, 5, 2, 3)),
                        nd.array(onp.array([2, 4], "float32")),
                        use_sequence_length=True),
        nd.SequenceReverse(nd.array(_r(rs, 5, 2, 3)),
                           nd.array(onp.array([2, 4], "float32")),
                           use_sequence_length=True)],
    "Softmax_single": lambda nd, ag, rs: nd.Softmax(nd.array(_r(rs, 3, 4))),
    "SoftmaxOutput_grad": _loss_case(
        "SoftmaxOutput", lambda rs: onp.array([0, 1, 2, 1], "float32")),
    "SoftmaxOutput_ignore_valid": _loss_case(
        "SoftmaxOutput", lambda rs: onp.array([0, -1, 2, 1], "float32"),
        use_ignore=True, ignore_label=-1, normalization="valid"),
    "LinearRegressionOutput": _loss_case("LinearRegressionOutput",
                                         grad_scale=2.0),
    "LogisticRegressionOutput": _loss_case("LogisticRegressionOutput"),
    "MAERegressionOutput": _loss_case("MAERegressionOutput"),
    "MakeLoss": lambda nd, ag, rs: _grad_of(
        nd, ag, lambda v: nd.MakeLoss(v * v, grad_scale=0.5,
                                      normalization="batch"),
        _r(rs, 4, 3)),
    "BlockGrad": lambda nd, ag, rs: _grad_of(
        nd, ag, lambda v: (nd.BlockGrad(v) * v).sum(), _r(rs, 3)),
    "CTCLoss": lambda nd, ag, rs: nd.CTCLoss(
        nd.array(_r(rs, 6, 2, 5)),
        nd.array(onp.array([[1, 2, 0], [3, 3, 4]], "float32"))),
    "broadcast_aliases": lambda nd, ag, rs: [
        getattr(nd, n)(nd.array(_r(rs, 2, 1, 4) + 2),
                       nd.array(_r(rs, 1, 3, 4) + 2))
        for n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
                  "broadcast_div", "broadcast_maximum", "broadcast_minimum",
                  "broadcast_power", "broadcast_greater")],
    "elemwise_aliases": lambda nd, ag, rs: [
        getattr(nd, n)(nd.array(_r(rs, 3, 4)), nd.array(_r(rs, 3, 4) + 3))
        for n in ("elemwise_add", "elemwise_sub", "elemwise_mul",
                  "elemwise_div")],
    "broadcast_to_axis": lambda nd, ag, rs: [
        nd.broadcast_to(nd.array(_r(rs, 2, 1, 4)), shape=(2, 3, 0)),
        nd.broadcast_axis(nd.array(_r(rs, 2, 1, 4)), axis=1, size=3)],
    "legacy_misc": lambda nd, ag, rs: [
        nd.stop_gradient(nd.array(_r(rs, 3))),
        nd.argmax_channel(nd.array(_r(rs, 3, 5))),
        nd.ones_like(nd.array(_r(rs, 2, 2))),
        nd.zeros_like(nd.array(_r(rs, 2, 2))),
        nd.norm(nd.array(_r(rs, 3, 4))),
        nd.norm(nd.array(_r(rs, 3, 4)), axis=1, keepdims=True)],
    "tensor_ops": lambda nd, ag, rs: [
        nd.dot(nd.array(_r(rs, 3, 4)), nd.array(_r(rs, 4, 2))),
        nd.batch_dot(nd.array(_r(rs, 2, 3, 4)), nd.array(_r(rs, 2, 4, 2))),
        nd.one_hot(nd.array(onp.array([0, 2, 1], "int32")), 3),
        nd.pick(nd.array(_r(rs, 3, 4)), nd.array(onp.array([0, 3, 1],
                                                          "int32"))),
        nd.topk(nd.array(_r(rs, 3, 4)), k=2),
        nd.gather_nd(nd.array(_r(rs, 3, 4)),
                     nd.array(onp.array([[0, 2], [1, 3]], "int32"))),
        nd.slice_axis(nd.array(_r(rs, 3, 4)), axis=1, begin=1, end=3),
        nd.slice_like(nd.array(_r(rs, 3, 4)), nd.zeros((2, 3))),
        nd.sequence_mask(nd.array(_r(rs, 4, 2)),
                         nd.array(onp.array([1, 3], "float32")),
                         use_sequence_length=True),
        nd.clip(nd.array(_r(rs, 5)), -0.5, 0.5),
        nd.take(nd.array(_r(rs, 4, 3)), nd.array(onp.array([3, 0],
                                                           "int32"))),
        nd.tile(nd.array(_r(rs, 2, 3)), (2, 1)),
        nd.repeat(nd.array(_r(rs, 2, 3)), 2, axis=0),
        nd.where(nd.array(onp.array([1, 0, 1], "float32")),
                 nd.array(_r(rs, 3)), nd.array(_r(rs, 3)))],
    "math_ops": lambda nd, ag, rs: [
        getattr(nd, n)(nd.array(onp.abs(_r(rs, 3, 4)) + 0.5))
        for n in ("abs", "exp", "log", "sqrt", "square", "argmax",
                  "argmin", "sum", "mean", "max", "min")] + [
        nd.maximum(nd.array(_r(rs, 3)), nd.array(_r(rs, 3))),
        nd.minimum(nd.array(_r(rs, 3)), nd.array(_r(rs, 3)))],
    "linalg": lambda nd, ag, rs: _linalg(nd, rs),
    "spatial": lambda nd, ag, rs: _spatial(nd, rs),
}


def _linalg(nd, rs):
    a = _r(rs, 3, 3)
    spd = (a @ a.T + 3 * onp.eye(3)).astype("float32")
    # one 3 x 3 shape throughout: each JAX op compiles once
    b, br, c0 = _r(rs, 3, 3), _r(rs, 3, 3), _r(rs, 3, 3)
    L = nd.linalg_potrf(nd.array(spd))
    out = [L, nd.linalg_gemm2(nd.array(a), nd.array(b), alpha=2.0),
           nd.linalg_gemm(nd.array(a), nd.array(b), nd.array(c0), beta=0.5),
           nd.linalg_potri(L), nd.linalg_trsm(L, nd.array(b)),
           nd.linalg_trsm(L, nd.array(br), rightside=True, transpose=True),
           nd.linalg_trmm(L, nd.array(b)),
           nd.linalg_trmm(nd.array(a), nd.array(b), lower=False),
           nd.linalg_sumlogdiag(nd.array(spd)),
           nd.linalg_makediag(nd.linalg_extractdiag(nd.array(spd))),
           nd.linalg_makediag(nd.array(_r(rs, 3)), offset=1),
           nd.linalg_syrk(nd.array(b)), nd.linalg_inverse(nd.array(spd)),
           nd.linalg_det(nd.array(spd)), *nd.linalg_slogdet(nd.array(spd))]
    for o, lo in [(1, True), (-2, False)]:
        tr = nd.linalg_extracttrian(nd.array(a), offset=o, lower=lo)
        out += [tr, nd.linalg_maketrian(tr, offset=o, lower=lo)]
    ut, w = nd.linalg_syevd(nd.array(spd))
    out.append(nd.array((ut.asnumpy().T * w.asnumpy()) @ ut.asnumpy()))
    lq, q = nd.linalg_gelqf(nd.array(br))
    out.append(nd.array(lq.asnumpy() @ q.asnumpy()))
    return out


def _spatial(nd, rs):
    x = _r(rs, 1, 2, 5, 5)
    theta = onp.array([[0.9, 0.1, 0.2, -0.1, 1.1, 0.3]], "float32")
    return [nd.GridGenerator(nd.array(theta), transform_type="affine",
                             target_shape=(4, 6)),
            nd.BilinearSampler(nd.array(x), nd.array(
                onp.clip(_r(rs, 1, 2, 5, 5), -1.2, 1.2))),
            nd.SpatialTransformer(nd.array(x), nd.array(theta),
                                  target_shape=(5, 5))]


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x.asnumpy()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_op_matches_jax(case):
    want = _flat(CASES[case](mx.nd, mx.autograd, onp.random.RandomState(0)))
    got = _flat(CASES[case](tmx.nd, tmx.autograd, onp.random.RandomState(0)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (case, i)
        if w.dtype.kind in "iub":
            onp.testing.assert_array_equal(g, w, err_msg=f"{case}[{i}]")
        else:
            onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                        err_msg=f"{case}[{i}]")


def test_out_writes_through_legacy_ops():
    a = onp.arange(6, dtype="float32").reshape(2, 3)
    d = tmx.nd.zeros((2, 3))
    r = tmx.nd.broadcast_add(tmx.nd.array(a), tmx.nd.ones((1, 3)), out=d)
    assert r is d and d.version == 1
    onp.testing.assert_allclose(d.asnumpy(), a + 1)
    e = tmx.nd.zeros((2, 2))
    tmx.nd.slice_axis(tmx.nd.array(a), axis=1, begin=0, end=2, out=e)
    onp.testing.assert_allclose(e.asnumpy(), a[:, :2])
    tmx.nd.waitall()


@pytest.mark.parametrize("kind", ["dict", "list", "single"])
def test_nd_save_load_cross_package(tmp_path, kind):
    rs = onp.random.RandomState(1)
    host = {"w": rs.randn(3, 4).astype("float32"),
            "i": rs.randint(0, 9, (5,)).astype("int32"),
            "h": rs.randn(2).astype("float16")}

    def payload(nd):
        if kind == "dict":
            return {k: nd.array(v) for k, v in host.items()}
        if kind == "list":
            return [nd.array(v) for v in host.values()]
        return nd.array(host["w"])
    for writer, reader in ((tmx.nd, mx.nd), (mx.nd, tmx.nd)):
        path = str(tmp_path / f"{writer.__name__}.params")
        writer.save(path, payload(writer))
        back = reader.load(path)
        if kind == "dict":
            assert sorted(back) == sorted(host)
            pairs = [(back[k], host[k]) for k in host]
        else:
            want = list(host.values()) if kind == "list" else [host["w"]]
            assert isinstance(back, list) and len(back) == len(want)
            pairs = list(zip(back, want))
        for got, w in pairs:
            assert got.asnumpy().dtype == w.dtype
            onp.testing.assert_array_equal(got.asnumpy(), w)
    with pytest.raises(tmx.MXNetError, match="expects an NDArray"):
        tmx.nd.save(str(tmp_path / "bad.params"), host["w"])


@pytest.mark.parametrize("batch,round_batch", [(2, True), (2, False),
                                               (3, True)])
def test_libsvm_iter_yields_csr_like_jax(tmp_path, batch, round_batch):
    sv = str(tmp_path / "t.libsvm")
    with open(sv, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n0 0:2.5\n1 1:1\n")
    got = {}
    for pkg in (mx, tmx):
        it = pkg.io.LibSVMIter(data_libsvm=sv, data_shape=(4,),
                               batch_size=batch, round_batch=round_batch)
        got[pkg.__name__] = [(b.data[0], b.label[0].asnumpy(), b.pad)
                             for b in it]
    assert len(got["mxnet_tpu_torch"]) == len(got["mxnet_tpu"])
    for (gd, gl, gp), (wd, wl, wp) in zip(got["mxnet_tpu_torch"],
                                          got["mxnet_tpu"]):
        assert isinstance(gd, tmx.nd.sparse.CSRNDArray)
        assert gd.shape == wd.shape and gp == wp
        onp.testing.assert_array_equal(gl, wl)
        for name in ("data", "indices", "indptr"):
            g, w = getattr(gd, name).asnumpy(), onp.asarray(
                getattr(wd, name)._data)
            assert g.dtype == w.dtype
            onp.testing.assert_array_equal(g, w)


def _contrib(nd, rs):
    def body(x, states):
        return x * 2, [states[0] + x]
    xs = nd.array(_r(rs, 4, 3))
    out, states = nd.contrib.foreach(body, xs, [nd.zeros(3)])
    loop = nd.contrib.while_loop(
        lambda i, s: i < 3, lambda i, s: ([s * 2], [i + 1, s + i]),
        [nd.array(onp.array(0.0, "float32")), nd.ones(2)],
        max_iterations=5)
    branch = nd.contrib.cond(nd.array(onp.array(1.0, "float32")) > 0,
                             lambda: nd.ones(2) * 3, lambda: nd.zeros(2))
    x = _r(rs, 2, 8)
    spec = nd.contrib.fft(nd.array(x))
    back = nd.contrib.ifft(spec)
    return [out, states, loop, branch, spec, back]


def test_contrib_control_flow_and_fft_match_jax():
    want = _flat(_contrib(mx.nd, onp.random.RandomState(2)))
    got = _flat(_contrib(tmx.nd, onp.random.RandomState(2)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _graph(pkg):
    rs = onp.random.RandomState(3)
    adj = (rs.rand(8, 8) < 0.35).astype("float32")
    onp.fill_diagonal(adj, 0)
    return pkg.nd.sparse.csr_matrix(adj * rs.rand(8, 8).astype("float32"))


def _csr_parts(x):
    return [onp.asarray(getattr(getattr(x, n), "_data"))
            for n in ("data", "indices", "indptr")]


def test_contrib_dgl_ops_match_jax():
    got = {}
    for pkg in (mx, tmx):
        g = _graph(pkg)
        adj = pkg.nd.contrib.dgl_adjacency(g)
        subs = pkg.nd.contrib.dgl_subgraph(g, pkg.nd.array(
            onp.array([0, 2, 5, 7], "int64")), pkg.nd.array(
            onp.array([1, 3], "int64")))
        onp.random.seed(11)
        ids, sub, layers = pkg.nd.contrib.dgl_csr_neighbor_uniform_sample(
            g, pkg.nd.array(onp.array([0, 4], "int64")), num_hops=2,
            num_neighbor=2, max_num_vertices=6)
        got[pkg.__name__] = [adj, *subs, sub, ids, layers]
    for g, w in zip(got["mxnet_tpu_torch"], got["mxnet_tpu"]):
        if hasattr(w, "stype") and w.stype == "csr":
            assert g.shape == w.shape
            for gp, wp in zip(_csr_parts(g), _csr_parts(w)):
                onp.testing.assert_array_equal(gp.astype(wp.dtype), wp)
        else:
            onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_negative_strided_host_arrays_like_jax():
    """A host view with negative strides (``a[:, ::-1]``) makes an array,
    as the reference's ``jnp.asarray`` takes it."""
    host = onp.arange(12, dtype="float32").reshape(3, 4)
    for view in (host[:, ::-1], host[::-2], host.T[::-1]):
        want = mx.nd.array(view).asnumpy()
        got = tmx.nd.array(view).asnumpy()
        onp.testing.assert_array_equal(got, want)
        onp.testing.assert_array_equal(got, view)
