"""Port parity: ``npx.rnn``, ``gluon.rnn``, ``gluon.Block``,
``gluon.contrib.nn`` and ``contrib.text``, JAX package -> PyTorch port.

``npx.rnn`` in every mode (lstm, gru, rnn_tanh, rnn_relu), 1-2 layers,
one or two directions, on the same seeded flat parameter vector and
states in both packages: outputs and states within 1e-5, the gradients of
the parameters, the data and the initial states within 1e-4; the LSTM
state clip likewise. The reference's ``npx.rnn`` reads ``p``,
``projection_size``, ``use_sequence_length`` and ``lstm_state_clip_nan``
nowhere, and the port mirrors that (pinned below: a dropout 0.5 LSTM
gives the same outputs in two recorded training calls and equals the
dropout 0 one). The layers (``RNN`` / ``LSTM`` / ``GRU``, TNC and NTC,
deferred input size), every cell (``unroll`` in NTC / TNC, unmerged
outputs, ``valid_length``) and the nine conv cells take the JAX package's
weights through ``functional.load_params`` (the reference's parameter
names) and agree within rtol 1e-5 / atol 1e-6, gradients likewise (of
the conv cells, the 2-d family's). The
dropout cells are held by their masks (random streams differ). A tiny
LSTM language model written as a ``gluon.Block`` (vocab 64, 2 x 16, bptt
5, batch 3, dropout 0) trains 3 SGD steps with ``clip_global_norm`` and
the hidden state carried and detached: each loss within 1e-5 relative of
the JAX package's, eager and hybridized.
"""
import collections
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.test_utils import assert_almost_equal

torch.set_num_threads(2)

RS = onp.random.RandomState(240)
T, N, I, H = 4, 3, 5, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _close(got, want, name, rtol=1e-5, atol=1e-6):
    got = got.asnumpy() if hasattr(got, "asnumpy") else \
        got.detach().numpy()
    assert_almost_equal(got, want.asnumpy(), rtol=rtol, atol=atol,
                        names=(name, "jax"))


def _n_params(mode, layers, bidir, insz=I, hid=H):
    ng, ndir = trnn.GATES[mode], 2 if bidir else 1
    n = 0
    for layer in range(layers):
        cur = insz if layer == 0 else hid * ndir
        n += ndir * (ng * hid * (cur + hid) + 2 * ng * hid)
    return n


def _rnn_run(m, mode, layers, bidir, arrays, **kw):
    """Outputs, states and the gradients of every input."""
    ins = [m.np.array(a) for a in arrays]
    for a in ins:
        a.attach_grad()
    with m.autograd.record():
        res = m.npx.rnn(ins[0], ins[1], ins[2],
                        ins[3] if mode == "lstm" else None, mode=mode,
                        state_size=H, num_layers=layers,
                        bidirectional=bidir, **kw)
        loss = (res[0] * res[0]).sum() + sum(r.sum() for r in res[1:])
    loss.backward()
    return list(res), [a.grad for a in ins]


RNN_CASES = [(mode, layers, bidir) for mode in trnn.GATES
             for layers, bidir in ((1, False), (2, True))] + \
    [("lstm", 2, False), ("gru", 1, True)]


@pytest.mark.parametrize("mode,layers,bidir", RNN_CASES)
def test_npx_rnn_matches_jax(mode, layers, bidir):
    ndir = 2 if bidir else 1
    arrays = [RS.randn(T, N, I).astype("f4"),
              (RS.randn(_n_params(mode, layers, bidir)) * 0.3).astype("f4"),
              RS.randn(layers * ndir, N, H).astype("f4"),
              RS.randn(layers * ndir, N, H).astype("f4")]
    want = _rnn_run(mx, mode, layers, bidir, arrays)
    got = _rnn_run(tmx, mode, layers, bidir, arrays)
    assert len(got[0]) == len(want[0]) == (3 if mode == "lstm" else 2)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape
        _close(g, w, f"out/state {i}", 1e-5, 1e-5)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if mode != "lstm" and i == 3:
            continue
        _close(g, w, f"grad {i}", 1e-4, 1e-4)


def test_npx_rnn_lstm_state_clip_and_ignored_arguments():
    arrays = [RS.randn(T, N, I).astype("f4") * 3,
              (RS.randn(_n_params("lstm", 2, False)) * 0.8).astype("f4"),
              RS.randn(2, N, H).astype("f4"), RS.randn(2, N, H).astype("f4")]
    clip = dict(lstm_state_clip_min=-0.3, lstm_state_clip_max=0.4)
    want = _rnn_run(mx, "lstm", 2, False, arrays, **clip)
    got = _rnn_run(tmx, "lstm", 2, False, arrays, **clip)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w, "clip", 1e-4, 1e-4)
    assert float(got[0][2].asnumpy().max()) <= 0.4 + 1e-6
    # the reference reads none of these: the same result
    loose = _rnn_run(tmx, "lstm", 2, False, arrays, p=0.7,
                     projection_size=3, use_sequence_length=True,
                     sequence_length=tmx.np.array([1, 2, 3]),
                     lstm_state_clip_nan=True, **clip)
    for g, w in zip(got[0], loose[0]):
        onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    plain = tmx.npx.rnn(*[tmx.np.array(a) for a in arrays], mode="lstm",
                        state_size=H, num_layers=2, state_outputs=False)
    assert isinstance(plain, tmx.np.ndarray) and plain.shape == (T, N, H)


def test_npx_rnn_rejects_a_wrong_vector_and_mode():
    x, h = tmx.np.zeros((T, N, I)), tmx.np.zeros((1, N, H))
    with pytest.raises(tmx.MXNetError, match="needs"):
        tmx.npx.rnn(x, tmx.np.zeros((7,)), h, mode="gru", state_size=H)
    with pytest.raises(tmx.MXNetError, match="mode"):
        trnn.rnn(x._data, [], h._data, None, "lstm2", 1, False)


def test_route_is_plain_on_the_cpu_and_under_the_clip():
    x = torch.zeros(T, N, I)
    assert trnn.route(x, [], "lstm", False) == "plain"
    before = dict(trnn.route_calls)
    tmx.npx.rnn(tmx.np.zeros((T, N, I)),
                tmx.np.zeros((_n_params("gru", 1, False),)),
                tmx.np.zeros((1, N, H)), mode="gru", state_size=H)
    assert trnn.route_calls["plain"] == before["plain"] + 1


# -- the layers ---------------------------------------------------------------

def _carry(jnet, tnet):
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})


LAYER_CASES = [("LSTM", "TNC", False, 2), ("LSTM", "NTC", True, 1),
               ("GRU", "TNC", True, 2), ("RNN", "NTC", False, 2),
               ("RNN_tanh", "TNC", True, 1)]


def _layer(m, name, layout, bidir, layers, input_size=I):
    kw = dict(layout=layout, bidirectional=bidir, input_size=input_size)
    if name.startswith("RNN"):
        kw["activation"] = "tanh" if name == "RNN_tanh" else "relu"
        return m.gluon.rnn.RNN(H, layers, **kw)
    return getattr(m.gluon.rnn, name)(H, layers, **kw)


@pytest.mark.parametrize("name,layout,bidir,layers", LAYER_CASES)
def test_rnn_layers_match_jax(name, layout, bidir, layers):
    mx.random.seed(3)
    jnet = _layer(mx, name, layout, bidir, layers)
    jnet.initialize()
    tnet = _layer(tmx, name, layout, bidir, layers)
    _carry(jnet, tnet)
    assert sorted(tnet.collect_params()) == sorted(jnet.collect_params())
    x = RS.randn(*((T, N, I) if layout == "TNC" else (N, T, I))) \
        .astype("f4")
    res = []
    for m, net in ((mx, jnet), (tmx, tnet)):
        xs = m.np.array(x)
        xs.attach_grad()
        states = net.begin_state(N)
        with m.autograd.record():
            out, st = net(xs, states)
            loss = (out * out).sum() + sum(s.sum() for s in st)
        loss.backward()
        grads = {k: p.grad() for k, p in net.collect_params().items()}
        res.append((out, st, xs.grad, grads, net(xs)))
    (jo, js, jg, jp, jd), (to, ts, tg, tp, td) = res
    assert isinstance(to, tmx.np.ndarray) and len(ts) == len(js)
    _close(to, jo, "out")
    _close(td, jd, "out without states")
    for g, w in zip(ts, js):
        _close(g, w, "state")
    _close(tg, jg, "dx", 1e-4, 1e-5)
    for k in jp:
        _close(tp[k], jp[k], k, 1e-4, 1e-5)


def test_rnn_layer_deferred_input_size_and_dropout_is_ignored():
    """input_size=0 defers; the reference's npx.rnn never reads p, so
    LSTM(dropout=0.5) gives the same outputs in two recorded training
    calls, equal to the dropout-0 layer's."""
    x = tmx.np.array(RS.randn(T, N, I).astype("f4"))
    net = tmx.gluon.rnn.LSTM(H, 2, dropout=0.5)
    net.initialize()
    with tmx.autograd.record():
        a = net(x)
    with tmx.autograd.record():
        b = net(x)
    onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert net.l0_i2h_weight.shape == (4 * H, I)
    twin = tmx.gluon.rnn.LSTM(H, 2, input_size=I)
    tfunctional.load_params(twin, tfunctional.param_arrays(net))
    onp.testing.assert_array_equal(twin(x).asnumpy(), a.asnumpy())
    assert [s["shape"] for s in net.state_info(7)] == [(2, 7, H)] * 2
    j = mx.gluon.rnn.LSTM(H, 2, dropout=0.5)
    j.initialize()
    with mx.autograd.record():
        ja, jb = j(mx.np.array(x.asnumpy())), j(mx.np.array(x.asnumpy()))
    onp.testing.assert_array_equal(ja.asnumpy(), jb.asnumpy())


# -- the cells ----------------------------------------------------------------

def _cells(m):
    r = m.gluon.rnn
    seq = r.SequentialRNNCell()
    seq.add(r.LSTMCell(H, input_size=I))
    seq.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
    seq.add(r.RNNCell(H, activation="relu", input_size=H))
    return {"rnn": r.RNNCell(H, input_size=I),
            "lstm": r.LSTMCell(H, input_size=I),
            "gru": r.GRUCell(H, input_size=I),
            "lstmp": r.LSTMPCell(H, 4, input_size=I),
            "sequential": seq,
            "bidirectional": r.BidirectionalCell(
                r.LSTMCell(H, input_size=I), r.GRUCell(H, input_size=I))}


CELL_CASES = [("rnn", "NTC", True, False), ("lstm", "TNC", True, False),
              ("gru", "NTC", False, False), ("lstmp", "NTC", True, False),
              ("sequential", "TNC", True, False),
              ("bidirectional", "NTC", True, False),
              ("lstm", "NTC", True, True), ("bidirectional", "TNC", True,
                                            True)]


@pytest.mark.parametrize("name,layout,merge,valid", CELL_CASES)
def test_cells_unroll_matches_jax(name, layout, merge, valid):
    mx.random.seed(5)
    jcell = _cells(mx)[name]
    jcell.initialize()
    tcell = _cells(tmx)[name]
    _carry(jcell, tcell)
    assert sorted(tcell.collect_params()) == sorted(jcell.collect_params())
    x = RS.randn(*((N, T, I) if layout == "NTC" else (T, N, I))) \
        .astype("f4")
    vl = onp.array([4, 2, 3], "int32")
    res = []
    for m, cell in ((mx, jcell), (tmx, tcell)):
        xs = m.np.array(x)
        xs.attach_grad()
        kw = {"valid_length": m.np.array(vl)} if valid else {}
        with m.autograd.record():
            out, st = cell.unroll(T, xs, layout=layout, merge_outputs=merge,
                                  **kw)
            outs = [out] if merge else list(out)
            loss = sum((o * o).sum() for o in outs) + \
                sum(s.sum() for s in st)
        loss.backward()
        grads = {k: p.grad() for k, p in cell.collect_params().items()}
        res.append((outs, st, xs.grad, grads))
    (jo, js, jg, jp), (to, ts, tg, tp) = res
    assert len(to) == len(jo) and len(ts) == len(js)
    for g, w in zip(to + ts, jo + js):
        _close(g, w, "out/state")
    _close(tg, jg, "dx", 1e-4, 1e-5)
    for k in jp:
        _close(tp[k], jp[k], k, 1e-4, 1e-5)


CONV_CELLS = [(f"Conv{d}D{k}Cell", d) for d in (1, 2, 3)
              for k in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("name,dims", CONV_CELLS)
def test_conv_cells_match_jax(name, dims):
    shape = (2,) + (4, 3, 2)[:dims]
    kw = dict(input_shape=shape, hidden_channels=3, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=1)
    mx.random.seed(7)
    jcell = getattr(mx.gluon.rnn, name)(**kw)
    jcell.initialize()
    tcell = getattr(tmx.gluon.rnn, name)(**kw)
    _carry(jcell, tcell)
    x = RS.randn(2, 2, *shape).astype("f4")   # (N, T, C, *spatial)
    res = []
    grads = dims == 2            # the 2-d family's gradients stand for all
    for m, cell in ((mx, jcell), (tmx, tcell)):
        xs = m.np.array(x)
        with m.autograd.record():
            out, st = cell.unroll(2, xs, layout="NTC")
            loss = (out * out).sum()
        if grads:
            loss.backward()
        res.append((out, st, {k: p.grad() for k, p in
                              cell.collect_params().items()} if grads
                    else {}))
    _close(res[1][0], res[0][0], "out")
    for g, w in zip(res[1][1], res[0][1]):
        _close(g, w, "state")
    for k in res[0][2]:
        _close(res[1][2][k], res[0][2][k], k, 1e-4, 1e-5)
    with pytest.raises(ValueError, match="odd"):
        getattr(tmx.gluon.rnn, name)(**{**kw, "h2h_kernel": 2})


def test_dropout_cells_by_their_masks():
    r = tmx.gluon.rnn
    x = tmx.np.ones((N, T, I))
    drop = r.DropoutCell(0.5)
    out, _ = drop.unroll(T, x)                       # not training
    onp.testing.assert_array_equal(out.asnumpy(), 1.0)
    base = r.RNNCell(H, input_size=I)
    base.initialize()
    vd = r.VariationalDropoutCell(base, drop_inputs=0.5, drop_outputs=0.5)
    with tmx.autograd.record():
        vd.unroll(T, x)
    m_in = vd.drop_inputs_mask
    assert set(onp.unique(m_in.numpy())) <= {0.0, 2.0}
    with tmx.autograd.record():                     # kept across steps
        vd(x[:, 0], vd.begin_state(N))
    assert vd.drop_inputs_mask is m_in
    vd.reset()
    assert vd.drop_inputs_mask is None
    zo = r.ZoneoutCell(r.GRUCell(H, input_size=I), zoneout_outputs=0.4,
                       zoneout_states=0.4)
    zo.initialize()
    eager, _ = zo.unroll(T, x)                      # not training: identity
    ref, _ = zo.base_cell.unroll(T, x)
    onp.testing.assert_array_equal(eager.asnumpy(), ref.asnumpy())
    with tmx.autograd.record():
        out, st = zo.unroll(T, x)
    assert out.shape == (N, T, H) and len(st) == 1
    assert tmx.gluon.rnn.HybridRecurrentCell is r.RecurrentCell
    assert tmx.gluon.rnn.HybridSequentialRNNCell is r.SequentialRNNCell


def test_surface_of_the_gluon_tail():
    for mod, ref in ((tmx.gluon.rnn, mx.gluon.rnn),
                     (tmx.gluon.contrib.nn, mx.gluon.contrib.nn),
                     (tmx.contrib.text, mx.contrib.text)):
        names = [n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), types.ModuleType)
                 and n not in ("annotations", "io", "os", "re", "onp",
                               "MXNetError", "HybridBlock", "ndarray")]
        missing = [n for n in names if not hasattr(mod, n)]
        assert not missing, (mod.__name__, missing)
    assert issubclass(tmx.gluon.HybridBlock, tmx.gluon.Block)
    assert issubclass(tmx.gluon.DeferredInitializationError, tmx.MXNetError)


# -- gluon.Block and the language model -----------------------------------

V, E, HID, BPTT, BATCH = 64, 12, 16, 5, 3


def _lm(m):
    class LM(m.gluon.Block):
        """Embedding -> Dropout -> LSTM -> Dropout -> Dense."""

        def __init__(self):
            super().__init__()
            self.embedding = m.gluon.nn.Embedding(V, E)
            self.drop_in = m.gluon.nn.Dropout(0.0)
            self.drop_out = m.gluon.nn.Dropout(0.0)
            self.rnn = m.gluon.rnn.LSTM(HID, 2, input_size=E, dropout=0.0)
            self.decoder = m.gluon.nn.Dense(V, flatten=False, in_units=HID)

        def forward(self, x, state):
            out, state = self.rnn(self.drop_in(self.embedding(x)), state)
            return self.decoder(self.drop_out(out)), state
    return LM()


def _train_lm(m, net, data, hybrid, steps=3):
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    if hybrid:
        net.hybridize()
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 1.0})
    state = net.rnn.begin_state(BATCH)
    losses = []
    for i in range(steps):
        x = m.np.array(data[i * BPTT:(i + 1) * BPTT])
        y = m.np.array(data[i * BPTT + 1:(i + 1) * BPTT + 1])
        state = [s.detach() for s in state]
        with m.autograd.record():
            out, state = net(x, state)
            loss = loss_fn(out.reshape(-1, V), y.reshape(-1))
        loss.backward()
        grads = [p.grad() for p in net.collect_params().values()]
        m.gluon.utils.clip_global_norm(grads, 5 * BPTT * BATCH)
        trainer.step(BPTT * BATCH)
        losses.append(float(loss.mean()))
    return losses


@pytest.mark.parametrize("hybrid", [False, True])
def test_lstm_language_model_trains_like_jax(hybrid):
    data = onp.random.RandomState(24).randint(0, V, (3 * BPTT + 1, BATCH)) \
        .astype("int32")
    mx.random.seed(11)
    jnet = _lm(mx)
    jnet.initialize(mx.init.Uniform(0.1))
    jnet(mx.np.array(data[:BPTT]), jnet.rnn.begin_state(BATCH))
    tnet = _lm(tmx)
    _carry(jnet, tnet)
    assert isinstance(tnet, tmx.gluon.Block)
    assert not isinstance(tnet, tmx.gluon.HybridBlock)
    want = _train_lm(mx, jnet, data, hybrid)
    got = _train_lm(tmx, tnet, data, hybrid)
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    if hybrid:   # hybridize() reached the children, not the Block itself
        assert tnet.rnn._cached_graph is not None
        assert tnet._cached_graph is None


def test_block_registers_children_and_deferred_errors():
    blk = tmx.gluon.Block()
    blk.register_child(tmx.gluon.nn.Dense(3, in_units=2))
    blk.register_child(tmx.gluon.nn.Dense(2), "head")
    assert sorted(blk.collect_params()) == ["0.bias", "0.weight",
                                            "head.bias", "head.weight"]
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        blk.head(torch.zeros(1, 3))


# -- contrib.nn and contrib.text ---------------------------------------------

def test_contrib_nn_matches_jax():
    nets = []
    mx.random.seed(2)
    for m in (mx, tmx):
        cn = m.gluon.contrib.nn
        net = cn.HybridConcurrent(axis=1)
        net.add(m.gluon.nn.Dense(3, in_units=4), cn.Identity(),
                m.gluon.nn.Dense(2, in_units=4))
        net.add(cn.SparseEmbedding(10, 4))
        nets.append(net)
    nets[0].initialize()
    _carry(*nets)
    x = RS.randn(4, 4).astype("f4")
    outs = []
    for m, net in zip((mx, tmx), nets):
        children = list(net._children.values()) if m is mx \
            else list(net._modules.values())
        emb = children[3](m.np.array(onp.array([1, 9, 0, 3], "int32")))
        cat = m.gluon.contrib.nn.HybridConcurrent(axis=1)
        cat.add(*children[:3])
        outs.append((cat(m.np.array(x)), emb))
    _close(outs[1][0], outs[0][0], "concurrent")
    _close(outs[1][1], outs[0][1], "sparse embedding")
    assert outs[1][0].shape == (4, 9)
    assert isinstance(tmx.gluon.contrib.nn.Concurrent(),
                      tmx.gluon.contrib.nn.HybridConcurrent)


def test_contrib_text_matches_jax(tmp_path, monkeypatch):
    src = "the cat sat\non the mat the end\nThe Cat"
    for m in (mx, tmx):
        c = m.contrib.text.count_tokens_from_str(src, to_lower=True)
        assert c == collections.Counter(src.lower().split())
    jv = mx.contrib.text.Vocabulary(
        mx.contrib.text.count_tokens_from_str(src), most_freq_count=4,
        reserved_tokens=["<pad>"])
    tv = tmx.contrib.text.Vocabulary(
        tmx.contrib.text.count_tokens_from_str(src), most_freq_count=4,
        reserved_tokens=["<pad>"])
    assert tv.idx_to_token == jv.idx_to_token
    assert tv.to_indices(["the", "dog"]) == jv.to_indices(["the", "dog"])
    assert tv.to_tokens([1, 2]) == jv.to_tokens([1, 2])
    path = tmp_path / "vecs.txt"
    path.write_text("the 0.1 0.2 0.3\ncat 1 2 3\nzebra -1 0 1\n")
    je = mx.contrib.text.CustomEmbedding(str(path), counter=collections
                                         .Counter(["cat", "dog"]))
    te = tmx.contrib.text.CustomEmbedding(str(path), counter=collections
                                          .Counter(["cat", "dog"]))
    assert te.idx_to_token == je.idx_to_token and te.vec_len == 3
    _close(te.idx_to_vec, je.idx_to_vec, "idx_to_vec")
    _close(te.get_vecs_by_tokens(["Cat", "zebra"], lower_case_backup=True),
           je.get_vecs_by_tokens(["Cat", "zebra"], lower_case_backup=True),
           "vecs")
    te.update_token_vectors("cat", tmx.np.array([[9.0, 9.0, 9.0]]))
    je.update_token_vectors("cat", mx.np.array([[9.0, 9.0, 9.0]]))
    _close(te.idx_to_vec, je.idx_to_vec, "updated")
    home = tmp_path / "home"
    (home / "embeddings" / "glove").mkdir(parents=True)
    (home / "embeddings" / "glove" / "g.txt").write_text("a 1 2\nb 3 4\n")
    monkeypatch.setenv("MXNET_HOME", str(home))
    assert tmx.contrib.text.get_pretrained_file_names("glove") == ["g.txt"]
    assert tmx.contrib.text.GloVe("g.txt").vec_len == 2
    with pytest.raises(tmx.MXNetError, match="not found"):
        tmx.contrib.text.FastText("missing.vec")
