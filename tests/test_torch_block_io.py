"""Port parity: Block I/O and sharing (``save_parameters`` /
``load_parameters`` / ``save`` / ``load``, ``share_parameters``,
``reset_ctx``) and the port's copy of ``serialization.py``.

Files cross between the packages both ways, by structural name: npz,
safetensors and legacy Apache MXNet ``.params`` written by the JAX package
load into the port and the port's into the JAX package, values equal bit
for bit (float32, and bf16 widened to float32 exactly). The reference's
own tests are ported as oracles (``tests/test_gluon.py:188, 202``,
``tests/test_serialization.py:59, 76, 151, 180``), with the rules of its
``load_parameters``: ``allow_missing``, ``ignore_extra``, a ``.sha256``
sidecar verified first, ``arg:`` / ``aux:`` prefixes, unnamed arrays.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serialization as jser

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(2)


def _port_net(seed=0, dtype=torch.float32):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, in_units=4, device="cpu", dtype=dtype),
            tnn.BatchNorm(in_channels=8, device="cpu", dtype=dtype),
            tnn.Dense(3, in_units=8, device="cpu", dtype=dtype))
    net.initialize(seed=seed)
    return net


def _jax_net(seed=0):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, in_units=4),
            mx.gluon.nn.BatchNorm(in_channels=8),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize()
    # running statistics that are not their initial 0 / 1
    rs = onp.random.RandomState(seed)
    for name, p in net.collect_params().items():
        if "running" in name:
            p.set_data(mx.np.array(rs.rand(*p.shape).astype("float32")))
    return net


def _jax_arrays(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _port_arrays(net):
    return tfunctional.param_arrays(net)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        onp.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("fmt", ["npz", "safetensors", "legacy"])
def test_jax_files_load_into_the_port(fmt, tmp_path):
    jnet = _jax_net(1)
    want = _jax_arrays(jnet)
    if fmt == "legacy":
        path = str(tmp_path / "net.params")
        jser.save_legacy_params(path, {
            ("aux:" if "running" in n else "arg:") + n: a
            for n, a in want.items()})
    else:
        path = str(tmp_path / ("net.safetensors" if fmt == "safetensors"
                               else "net.params"))
        jnet.save_parameters(path)
    tnet = _port_net(2)
    tnet.load_parameters(path)
    _assert_same(_port_arrays(tnet), want)


@pytest.mark.parametrize("fmt", ["npz", "safetensors", "legacy"])
def test_port_files_load_into_jax(fmt, tmp_path):
    tnet = _port_net(3)
    want = _port_arrays(tnet)
    if fmt == "legacy":
        path = str(tmp_path / "net.params")
        tser.save_legacy_params(path, {"arg:" + n: a
                                       for n, a in want.items()})
    else:
        path = str(tmp_path / ("net.safetensors" if fmt == "safetensors"
                               else "net.params"))
        tnet.save_parameters(path)
    jnet = _jax_net(4)
    jnet.load_parameters(path)
    _assert_same(_jax_arrays(jnet), want)


def test_bf16_parameters_round_trip(tmp_path):
    """bf16 parameters are written widened to fp32 and rounded back
    exactly, in the port and from a JAX bf16 safetensors file."""
    tnet = _port_net(5, torch.bfloat16)
    x = torch.from_numpy(onp.random.RandomState(0).rand(2, 4)
                         .astype("float32")).to(torch.bfloat16)
    want = tnet(x)
    path = str(tmp_path / "bf16.params")
    tnet.save_parameters(path)
    with onp.load(path) as data:
        assert {data[k].dtype for k in data.files} == {onp.dtype("float32")}
    other = _port_net(6, torch.bfloat16)
    other.load_parameters(path)
    for a, b in zip(tnet.collect_params().values(),
                    other.collect_params().values()):
        assert b.dtype == torch.bfloat16 and torch.equal(a.data(), b.data())
    assert torch.equal(other(x), want)
    jnet = _jax_net(7).cast("bfloat16")
    jpath = str(tmp_path / "jax_bf16.safetensors")
    jnet.save_parameters(jpath)
    port = _port_net(8, torch.bfloat16)
    port.load_parameters(jpath)
    ref = {n: onp.asarray(p.data().asnumpy(), "float32")
           for n, p in jnet.collect_params().items()}
    _assert_same(_port_arrays(port), ref)
    port.save_parameters(str(tmp_path / "back.safetensors"))
    back = _jax_net(9).cast("bfloat16")
    back.load_parameters(str(tmp_path / "back.safetensors"))
    for n, p in back.collect_params().items():
        assert str(p.data().dtype) == "bfloat16"
        onp.testing.assert_array_equal(
            onp.asarray(p.data().asnumpy(), "float32"), ref[n], err_msg=n)


def test_missing_and_extra_raise_as_in_the_reference(tmp_path):
    path = str(tmp_path / "small.params")
    small = tnn.HybridSequential()
    small.add(tnn.Dense(8, in_units=4, device="cpu"))
    small.initialize()
    small.save_parameters(path)
    net = _port_net(10)
    before = _port_arrays(net)
    with pytest.raises(MXNetError, match="missing"):
        net.load_parameters(path)
    _assert_same(_port_arrays(net), before)  # nothing copied
    net.load_parameters(path, allow_missing=True)
    onp.testing.assert_array_equal(_port_arrays(net)["0.weight"],
                                   _port_arrays(small)["0.weight"])
    big = str(tmp_path / "big.params")
    _port_net(11).save_parameters(big)
    with pytest.raises(MXNetError, match="extra"):
        small.load_parameters(big)
    small.load_parameters(big, ignore_extra=True)
    # the JAX package raises on the same files
    jsmall = mx.gluon.nn.HybridSequential()
    jsmall.add(mx.gluon.nn.Dense(8, in_units=4))
    jsmall.initialize()
    with pytest.raises(mx.base.MXNetError, match="extra"):
        jsmall.load_parameters(big)
    with pytest.raises(mx.base.MXNetError, match="missing"):
        _jax_net(12).load_parameters(path)


def test_torn_file_with_checksum_sidecar_raises(tmp_path):
    path = str(tmp_path / "net.params")
    net = _port_net(13)
    net.save_parameters(path)
    tser.write_checksum(path)
    _port_net(14).load_parameters(path)  # intact: verified and loaded
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(MXNetError, match="checksum mismatch"):
        _port_net(15).load_parameters(path)
    with pytest.raises(mx.base.MXNetError, match="checksum mismatch"):
        _jax_net(16).load_parameters(path)


def test_legacy_name_in_both_arg_and_aux_raises(tmp_path):
    path = str(tmp_path / "dup.params")
    w = onp.ones((8, 4), "float32")
    tser.save_legacy_params(path, {"arg:0.weight": w, "aux:0.weight": w})
    with pytest.raises(MXNetError, match="both arg: and aux:"):
        _port_net(17).load_parameters(path)


def test_save_load_prefix(tmp_path):
    net = _port_net(18)
    net.save(str(tmp_path / "ckpt"))
    assert (tmp_path / "ckpt-model.params").exists()
    other = _port_net(19)
    other.load(str(tmp_path / "ckpt"))
    _assert_same(_port_arrays(other), _port_arrays(net))


def test_load_into_deferred_shapes(tmp_path):
    path = str(tmp_path / "net.params")
    _port_net(20).save_parameters(path)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, device="cpu"),
            tnn.BatchNorm(device="cpu"), tnn.Dense(3, device="cpu"))
    net.initialize()
    net.load_parameters(path)
    assert net[0].weight.shape == (8, 4) and net[1].gamma.shape == (8,)
    _assert_same(_port_arrays(net), _port_arrays(_port_net(20)))


# -- the reference's tests as oracles -----------------------------------------

def test_save_load_parameters_oracle(tmp_path):
    """``tests/test_gluon.py::test_save_load_parameters``."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=3, device="cpu"),
            tnn.Dense(2, in_units=4, device="cpu"))
    net.initialize()
    path = str(tmp_path / "net.params")
    net.save_parameters(path)
    net2 = tnn.HybridSequential()
    net2.add(tnn.Dense(4, in_units=3, device="cpu"),
             tnn.Dense(2, in_units=4, device="cpu"))
    net2.load_parameters(path)
    x = torch.rand(2, 3)
    torch.testing.assert_close(net(x), net2(x), atol=0, rtol=0)


def test_share_parameters_oracle():
    """``tests/test_gluon.py::test_share_parameters``, plus: the shared
    tensor is one object, so an update of one shows in the other."""
    a = tnn.Dense(4, in_units=3, device="cpu")
    b = tnn.Dense(4, in_units=3, device="cpu")
    a.initialize()
    assert b.share_parameters(a.collect_params()) is b
    x = torch.rand(1, 3)
    torch.testing.assert_close(a(x), b(x), atol=0, rtol=0)
    assert b.weight is a.weight
    with torch.no_grad():
        a.weight.add_(1.0)
    torch.testing.assert_close(a(x), b(x), atol=0, rtol=0)


def test_share_parameters_by_structural_name():
    """Sharing into a nested block by structural name, only where names
    match (the reference's rule)."""
    a, b = _port_net(21), _port_net(22)
    shared = {n: p for n, p in a.collect_params().items()
              if n.startswith("2.")}
    shared["no.such.param"] = a.collect_params()["0.weight"]
    b.share_parameters(shared)
    assert b[2].weight is a[2].weight and b[2].bias is a[2].bias
    assert b[0].weight is not a[0].weight


def test_block_save_load_safetensors_oracle(tmp_path):
    """``tests/test_serialization.py::test_block_save_load_safetensors``
    (deferred widths)."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, activation="relu", device="cpu"),
            tnn.Dense(3, device="cpu"))
    net.initialize()
    x = torch.ones((2, 5))
    want = net(x)
    p = str(tmp_path / "model.safetensors")
    net.save_parameters(p)
    net2 = tnn.HybridSequential()
    net2.add(tnn.Dense(8, activation="relu", device="cpu"),
             tnn.Dense(3, device="cpu"))
    net2.initialize()
    net2(x)
    net2.load_parameters(p)
    torch.testing.assert_close(net2(x), want, atol=0, rtol=1e-6)


def test_block_save_load_npz_oracle(tmp_path):
    """``tests/test_serialization.py::test_block_save_load_npz_still_
    works``."""
    net = tnn.Dense(4, device="cpu")
    net.initialize()
    x = torch.ones((1, 3))
    want = net(x)
    p = str(tmp_path / "m.params")
    net.save_parameters(p)
    net2 = tnn.Dense(4, device="cpu")
    net2.initialize()
    net2(x)
    net2.load_parameters(p)
    torch.testing.assert_close(net2(x), want, atol=0, rtol=1e-6)


def test_block_loads_mxnet1x_style_params_oracle(tmp_path):
    """``tests/test_serialization.py::test_block_loads_mxnet1x_style_
    params``."""
    net = tnn.Dense(3, in_units=2, device="cpu")
    net.initialize()
    net(torch.ones((1, 2)))
    w = net.weight.detach().numpy().copy()
    p = str(tmp_path / "net.params")
    tser.save_legacy_params(p, {"arg:weight": (w * 2).astype("float32"),
                                "arg:bias": onp.ones(3, "float32")})
    net.load_parameters(p)
    onp.testing.assert_allclose(net.weight.detach().numpy(), w * 2)
    onp.testing.assert_allclose(net.bias.detach().numpy(), onp.ones(3))


def test_block_load_unnamed_legacy_raises_oracle(tmp_path):
    """``tests/test_serialization.py::test_block_load_unnamed_legacy_
    raises``."""
    p = str(tmp_path / "u.params")
    tser.save_legacy_params(p, [onp.ones((2, 2), "float32")])
    net = tnn.Dense(2, device="cpu")
    net.initialize()
    net(torch.ones((1, 2)))
    with pytest.raises(MXNetError, match="unnamed"):
        net.load_parameters(p)


# -- reset_ctx --------------------------------------------------------------------

def test_reset_ctx_keeps_the_parameter_objects():
    net = _port_net(23)
    params = net.collect_params()
    vars_ = {n: p.data() for n, p in params.items()}
    versions = {n: p._storage_version for n, p in params.items()}
    with tmx.autograd.record():
        y = net(torch.rand(2, 4)).sum()
    tmx.autograd.backward(y)
    before = _port_arrays(net)
    net.reset_ctx("cpu")
    for n, p in params.items():
        assert p.data() is vars_[n] and p.device == torch.device("cpu")
        assert p._storage_version == versions[n] + 1
        assert p.data().grad is None
    _assert_same(_port_arrays(net), before)
    net.reset_device("cpu")  # the reference's alias
    assert params["0.weight"]._storage_version == versions["0.weight"] + 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_reset_ctx_to_an_absent_card_raises():
    with pytest.raises(MXNetError, match="CUDA"):
        _port_net(24).reset_ctx("cuda")


def test_load_parameters_device_moves_the_block(tmp_path):
    path = str(tmp_path / "net.params")
    _port_net(25).save_parameters(path)
    net = _port_net(26)
    versions = [p._storage_version for p in net.collect_params().values()]
    net.load_parameters(path, device="cpu")
    assert [p._storage_version for p in net.collect_params().values()] \
        == [v + 1 for v in versions]


# -- serialization: the copy against the JAX package's ---------------------------

def test_safetensors_bytes_equal_the_reference(tmp_path):
    rs = onp.random.RandomState(3)
    tensors = {"w": rs.randn(3, 5).astype("float32"),
               "b": rs.randn(5).astype("float64"),
               "i": rs.randint(0, 9, (2, 2)).astype("int64"),
               "m": rs.rand(4) > 0.5}
    tser.save_safetensors(str(tmp_path / "t.safetensors"), tensors,
                          metadata={"k": 1})
    jser.save_safetensors(str(tmp_path / "j.safetensors"), tensors,
                          metadata={"k": 1})
    assert (tmp_path / "t.safetensors").read_bytes() == \
        (tmp_path / "j.safetensors").read_bytes()
    back, meta = tser.load_safetensors(str(tmp_path / "j.safetensors"),
                                       return_metadata=True)
    assert meta == {"k": "1"}
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype
        onp.testing.assert_array_equal(back[k], v)


def test_legacy_bytes_equal_the_reference(tmp_path):
    rs = onp.random.RandomState(4)
    tensors = {"arg:w": rs.randn(4, 3).astype("float32"),
               "arg:b": rs.randn(4).astype("float64"),
               "aux:m": rs.randint(0, 9, (2, 2)).astype("int64"),
               "s": onp.float32(2.5).reshape(())}
    tser.save_legacy_params(str(tmp_path / "t.params"), tensors)
    jser.save_legacy_params(str(tmp_path / "j.params"), tensors)
    assert (tmp_path / "t.params").read_bytes() == \
        (tmp_path / "j.params").read_bytes()
    back = tser.load_legacy_params(str(tmp_path / "j.params"))
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype
        onp.testing.assert_array_equal(back[k], v)
    assert tser.is_legacy_params(str(tmp_path / "t.params"))
    assert not tser.is_legacy_params(str(tmp_path / "missing.params"))


def test_atomic_write_and_checksum(tmp_path):
    path = str(tmp_path / "f.bin")
    (tmp_path / "f.bin.tmp-999").write_bytes(b"stale")
    tser.atomic_write_bytes(path, b"abc")
    assert (tmp_path / "f.bin").read_bytes() == b"abc"
    assert not (tmp_path / "f.bin.tmp-999").exists()
    assert tser.verify_checksum(path) is None
    with pytest.raises(MXNetError, match="missing"):
        tser.verify_checksum(path, required=True)
    digest = tser.write_checksum(path)
    assert digest == jser.write_checksum(path)
    assert tser.verify_checksum(path, required=True) is True
