"""Port parity: the one-card KVStore, gradient compression and the
Trainer's ``update_on_kvstore`` / ``compression_params``.

The store's operations (init, push of a list, pull into several outputs,
pushpull with and without an updater, broadcast, the optimizer inside
the store and its saved states) against the JAX package's local store,
exactly (fp32 sums of two to three values, the same order). Compression:
``GradientCompression.quantize`` with its residual and the
``pack_codes`` / ``unpack_codes`` wire bytes bit for bit against
``mxnet_tpu/kvstore/gradient_compression.py``, and the store's compressed
push against the JAX package's ``dist_sync`` store on one worker (the
reference applies compression there; its local store raises). The
Trainer: ``update_on_kvstore=True`` gives the weights of the local
update bit for bit and matches the JAX Trainer's (atol 1e-6), and
``compression_params`` matches the JAX Trainer on a one-worker
``dist_sync`` store (atol 1e-6).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.kvstore import gradient_compression as jgc

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.kvstore import gradient_compression as tgc

torch.set_num_threads(2)

RS = onp.random.RandomState(0)
A, B, C = (RS.randn(3, 4).astype("float32") for _ in range(3))


def _t(a):
    return torch.from_numpy(a.copy())


def test_create_and_types():
    for name in ("local", "device", "nccl"):
        kv = tmx.kv.create(name)
        assert kv.type == name and kv.rank == 0 and kv.num_workers == 1
        assert kv.is_capable("optimizer")
    # the distributed stores and the plugins, on a world of one process
    # (no launcher): rank 0 of 1, as the reference's degenerate store
    kinds = {"dist_sync": tmx.kv.DistKVStore,
             "dist_device_sync": tmx.kv.DistKVStore,
             "dist_async": tmx.kv.DistAsyncKVStore,
             "horovod": tmx.kv.Horovod, "byteps": tmx.kv.BytePS}
    for name, cls in kinds.items():
        kv = tmx.kv.create(name)
        assert type(kv) is cls and kv.type == name, name
        assert kv.rank == 0 and kv.num_workers == 1
        assert kv.type == mx.kv.create(name).type
    with pytest.raises(MXNetError):
        tmx.kv.create("no_such_store")
    assert tmx.kv.create("teststore").type == "teststore"
    assert tmx.kvstore is tmx.kv


def test_push_pull_match_jax():
    jkv, tkv = mx.kv.create("local"), tmx.kv.create("local")
    jkv.init("w", mx.np.array(A))
    tkv.init("w", _t(A))
    jkv.push("w", [mx.np.array(B), mx.np.array(C)])
    tkv.push("w", [_t(B), _t(C)])
    jo = [mx.np.zeros((3, 4)), mx.np.zeros((3, 4))]
    to = [torch.zeros(3, 4), tmx.np.zeros((3, 4), ctx=tmx.cpu())]
    jkv.pull("w", out=jo)
    tkv.pull("w", out=to)
    for j, t in zip(jo, to):
        onp.testing.assert_array_equal(getattr(t, "_data", t).numpy(),
                                       j.asnumpy())
    # pushpull without an updater writes the sum out, leaves the store
    jout, tout = mx.np.zeros((3, 4)), torch.zeros(3, 4)
    jkv.pushpull("w", [mx.np.array(A), mx.np.array(C)], out=jout)
    tkv.pushpull("w", [_t(A), _t(C)], out=tout)
    onp.testing.assert_array_equal(tout.numpy(), jout.asnumpy())
    jkv.pull("w", out=jout)
    tkv.pull("w", out=tout)
    onp.testing.assert_array_equal(tout.numpy(), jout.asnumpy())
    # broadcast: init then pull
    jb, tb = mx.np.zeros((3, 4)), torch.zeros(3, 4)
    jkv.broadcast("b", mx.np.array(C), out=jb)
    tkv.broadcast("b", _t(C), out=tb)
    onp.testing.assert_array_equal(tb.numpy(), jb.asnumpy())
    with pytest.raises(MXNetError):
        tkv.push("missing", _t(A))


@pytest.mark.parametrize("name,kw", [("test", {}),
                                     ("sgd", {"learning_rate": 0.1,
                                              "momentum": 0.9}),
                                     ("lamb", {"learning_rate": 0.01})])
def test_optimizer_in_the_store_matches_jax(name, kw, tmp_path):
    jkv, tkv = mx.kv.create("device"), tmx.kv.create("device")
    jkv.set_optimizer(mx.optimizer.create(name, **kw))
    tkv.set_optimizer(tmx.optimizer.create(name, **kw))
    for k in (0, 1):
        jkv.init(k, mx.np.array(A + k))
        tkv.init(k, _t(A + k))
    for step in range(3):
        g = [RS.randn(3, 4).astype("float32") for _ in range(2)]
        jkv.push(0, mx.np.array(g[0]))
        tkv.push(0, _t(g[0]))
        jout, tout = mx.np.zeros((3, 4)), torch.zeros(3, 4)
        jkv.pushpull(1, [mx.np.array(g[0]), mx.np.array(g[1])], out=jout)
        tkv.pushpull(1, [_t(g[0]), _t(g[1])], out=tout)
        onp.testing.assert_allclose(tout.numpy(), jout.asnumpy(),
                                    rtol=1e-6, atol=1e-7)
    jw, tw = mx.np.zeros((3, 4)), torch.zeros(3, 4)
    jkv.pull(0, out=jw)
    tkv.pull(0, out=tw)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                                atol=1e-7)
    # the states round-trip through a file
    path = str(tmp_path / "states")
    tkv.save_optimizer_states(path, dump_optimizer=True)
    other = tmx.kv.create("device")
    other.set_optimizer(tmx.optimizer.create("sgd"))
    for k in (0, 1):
        other.init(k, tkv._store[k])
    other.load_optimizer_states(path)
    assert type(other._updater.optimizer).__name__.lower() == name
    assert set(other._updater.states) == set(tkv._updater.states)


@pytest.mark.parametrize("mode", ["1bit", "2bit"])
def test_quantize_with_residual_bitwise(mode):
    jq = jgc.GradientCompression(type=mode, threshold=0.5)
    tq = tgc.GradientCompression(type=mode, threshold=0.5)
    rs = onp.random.RandomState(3)
    for _ in range(4):
        g = rs.uniform(-1.5, 1.5, size=(37,)).astype("float32")
        want = onp.asarray(jq.quantize("k", g))
        got = tq.quantize("k", _t(g))
        onp.testing.assert_array_equal(got.numpy(), want)
        onp.testing.assert_array_equal(tq._residual["k"].numpy(),
                                       onp.asarray(jq._residual["k"]))
        jp, jn = jgc.pack_codes(want, 0.5, mode=mode)
        tp, tn = tgc.pack_codes(got, 0.5, mode=mode)
        assert tn == jn == 37
        onp.testing.assert_array_equal(tp, jp)
        onp.testing.assert_array_equal(
            tgc.unpack_codes(tp, tn, 0.5, mode=mode),
            jgc.unpack_codes(jp, jn, 0.5, mode=mode))
    with pytest.raises(MXNetError):
        tgc.GradientCompression(type="4bit")
    with pytest.raises(MXNetError):
        tgc.GradientCompression(threshold=0)


def test_compressed_push_matches_one_worker_dist_sync():
    jkv, tkv = mx.kv.create("dist_sync"), tmx.kv.create("local")
    assert jkv.num_workers == 1
    params = {"type": "2bit", "threshold": 0.4}
    jkv.set_gradient_compression(params)
    tkv.set_gradient_compression(params)
    jkv.init(0, mx.np.zeros((3, 4)))
    tkv.init(0, torch.zeros(3, 4))
    rs = onp.random.RandomState(4)
    for _ in range(3):
        g = [rs.randn(3, 4).astype("float32") * 0.3 for _ in range(2)]
        jout, tout = mx.np.zeros((3, 4)), torch.zeros(3, 4)
        jkv.pushpull(0, [mx.np.array(x) for x in g], out=jout)
        tkv.pushpull(0, [_t(x) for x in g], out=tout)
        onp.testing.assert_array_equal(tout.numpy(), jout.asnumpy())
        jkv.push(0, [mx.np.array(x) for x in g])
        tkv.push(0, [_t(x) for x in g])
        jkv.pull(0, out=jout)
        tkv.pull(0, out=tout)
        onp.testing.assert_array_equal(tout.numpy(), jout.asnumpy())


# -- the Trainer ------------------------------------------------------------

def _nets(seed):
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(16, activation="tanh", in_units=8, device="cpu"),
             tnn.Dense(4, in_units=16, device="cpu"))
    tnet.initialize(seed=seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="tanh", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    arrays = tfunctional.param_arrays(tnet)
    for n, p in jnet.collect_params().items():
        p.set_data(mx.np.array(arrays[n]))
    return tnet, jnet


def _steps(tr_pairs, nets, steps=4):
    """The same gradients into every (trainer, net) and one step each."""
    for step in range(steps):
        rs = onp.random.RandomState(50 + step)
        params = [n.collect_params() for n in nets]
        grads = {k: rs.randn(*p.shape).astype("float32")
                 for k, p in params[0].items()}
        for tr, ps in zip(tr_pairs, params):
            for k, p in ps.items():
                if isinstance(p, tmx.gluon.Parameter):
                    p.data().grad = torch.from_numpy(grads[k].copy())
                else:
                    p.grad()._rebind(mx.np.array(grads[k])._data)
            tr.step(2)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01})])
def test_update_on_kvstore_gives_the_local_weights(name, kw):
    local, _ = _nets(0)
    onkv, jnet = _nets(0)
    tr_local = tmx.gluon.Trainer(local.collect_params(), name, dict(kw))
    tr_local._fused_update = False
    tr_kv = tmx.gluon.Trainer(onkv.collect_params(), name, dict(kw),
                              kvstore="local", update_on_kvstore=True)
    jtr = mx.gluon.Trainer(jnet.collect_params(), name, dict(kw),
                           kvstore="device", update_on_kvstore=True)
    _steps([tr_local, tr_kv, jtr], [local, onkv, jnet])
    assert tr_kv._kvstore is not None and tr_kv._update_on_kvstore
    ref = jfunctional.param_arrays(jnet)
    lw = tfunctional.param_arrays(local)
    for n, w in tfunctional.param_arrays(onkv).items():
        onp.testing.assert_array_equal(w, lw[n])
        onp.testing.assert_allclose(w, onp.asarray(ref[n]), atol=1e-6,
                                    rtol=0)
    with pytest.raises(MXNetError):
        tr_kv.update(2)


def test_update_on_kvstore_states_round_trip(tmp_path):
    net, _ = _nets(1)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01}, kvstore="device",
                           update_on_kvstore=True)
    _steps([tr], [net], steps=2)
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    other, _ = _nets(1)
    tr2 = tmx.gluon.Trainer(other.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore="device",
                            update_on_kvstore=True)
    tr2.load_states(path)
    assert tr2._updater is tr2._kvstore._updater
    for i, (m, v) in tr._updater.states.items():
        torch.testing.assert_close(tr2._updater.states[i][0], m, atol=0,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["1bit", "2bit"])
def test_compression_params_match_jax_one_worker(mode):
    tnet, jnet = _nets(2)
    comp = {"type": mode, "threshold": 0.5}
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(kw),
                            kvstore="local", compression_params=comp)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(kw),
                           kvstore="dist_sync", compression_params=comp)
    _steps([ttr, jtr], [tnet, jnet])
    ref = jfunctional.param_arrays(jnet)
    for n, w in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_allclose(w, onp.asarray(ref[n]), atol=1e-6,
                                    rtol=0)
    assert ttr._kvstore._gc is not None


def test_trainer_takes_a_kvstore_object():
    net, _ = _nets(3)
    kv = tmx.kv.create("local")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv,
                           update_on_kvstore=True)
    _steps([tr], [net], steps=1)
    assert tr._kvstore is kv and set(kv._store) == {0, 1, 2, 3}
