"""Port parity: BERT pretraining, JAX package -> PyTorch port.

A small ``mxnet_tpu`` BERT (vocab 1000, 128 units, FFN 512, 2 layers, 4
heads, max_length 64, dropout 0: the two packages' random streams cannot
give the same masks) is initialized by the JAX package and its weights
carried into the port with ``functional.load_params`` under the same
structural names (``mlm_bias`` included). One numpy batch (2 x 32
tokens, two segments, valid lengths 32 and 21, MLM positions as
``sample_weight``, NSP labels) goes through both packages with
``fused_ln_residual`` "on" in both (the JAX package's Pallas kernel in
interpret mode, the port's kernels' plain versions) and then "off" in
both: ``BERTModel``'s sequence and pooled outputs,
``BERTForPretraining``'s MLM and NSP scores, the MLM + NSP loss, every
gradient, and three AdamW ``Trainer`` steps. Tolerances (float32, another
summation order): outputs and losses atol 1e-5; gradients atol 1e-5 +
rtol 1e-4; weights after three steps atol 1e-5.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import functional as tfunctional
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

torch.set_num_threads(2)

CFG = dict(vocab_size=1000, units=128, hidden_size=512, num_layers=2,
           num_heads=4, max_length=64, dropout=0.0, embed_dropout=0.0)
BATCH, SEQ = 2, 32


@pytest.fixture(params=["on", "off"])
def mode(request):
    """``fused_ln_residual`` in both packages."""
    old = mx.config.get("fused_ln_residual")
    mx.config.set("fused_ln_residual", request.param)
    tmx.config.set("fused_ln_residual", request.param)
    yield request.param
    mx.config.set("fused_ln_residual", old)
    tmx.config.reset("fused_ln_residual")


def _batch(seed=0):
    rs = onp.random.RandomState(seed)
    ids = rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    valid = onp.array([SEQ, 21], dtype="int32")
    pos = onp.arange(SEQ)[None, :]
    types = ((pos >= onp.array([[12], [9]])) & (pos < valid[:, None])) \
        .astype("int32")
    weight = ((rs.rand(BATCH, SEQ) < 0.3) & (pos < valid[:, None])) \
        .astype("float32")
    labels = rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    nsp = onp.array([0, 1], dtype="int32")
    return ids, types, valid, labels, weight, nsp


def _pair(cls, seed=0):
    """(JAX model, port model on the CPU with the same weights)."""
    mx.random.seed(seed)
    jnet = getattr(jbert, cls)(**CFG)
    jnet.initialize()
    ids, types, valid = _batch(seed)[:3]
    jnet(mx.np.array(ids), mx.np.array(types), mx.np.array(valid))
    tnet = getattr(tbert, cls)(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    return jnet, tnet


def _jax_step(jnet, batch):
    ids, types, valid, labels, weight, nsp = (mx.np.array(a) for a in batch)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        mlm, nsp_scores = jnet(ids, types, valid)
        loss = loss_fn(mlm, labels, weight) + loss_fn(nsp_scores, nsp)
    loss.backward()
    return mlm.asnumpy(), nsp_scores.asnumpy(), loss.asnumpy()


def _port_step(tnet, batch):
    ids, types, valid, labels, weight, nsp = (torch.from_numpy(a)
                                              for a in batch)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        mlm, nsp_scores = tnet(ids, types, valid)
        loss = loss_fn(mlm, labels, weight) + loss_fn(nsp_scores, nsp)
    tmx.autograd.backward(loss)
    return (mlm.detach().numpy(), nsp_scores.detach().numpy(),
            loss.detach().numpy())


def test_bert_model_outputs_match_jax(mode):
    jnet, tnet = _pair("BERTModel", 1)
    ids, types, valid = _batch(1)[:3]
    jseq, jpooled = jnet(mx.np.array(ids), mx.np.array(types),
                         mx.np.array(valid))
    seq, pooled = tnet(*(torch.from_numpy(a) for a in (ids, types, valid)))
    assert seq.shape == (BATCH, SEQ, CFG["units"])
    assert pooled.shape == (BATCH, CFG["units"])
    onp.testing.assert_allclose(seq.numpy(), jseq.asnumpy(), atol=1e-5,
                                rtol=0)
    onp.testing.assert_allclose(pooled.numpy(), jpooled.asnumpy(),
                                atol=1e-5, rtol=0)
    # without token types or lengths: one segment, nothing masked
    onp.testing.assert_allclose(
        tnet(torch.from_numpy(ids))[0].numpy(),
        jnet(mx.np.array(ids))[0].asnumpy(), atol=1e-5, rtol=0)


def test_pretraining_loss_and_every_gradient_match_jax(mode):
    jnet, tnet = _pair("BERTForPretraining", 2)
    batch = _batch(2)
    jmlm, jnsp, jloss = _jax_step(jnet, batch)
    mlm, nsp, loss = _port_step(tnet, batch)
    assert mlm.shape == (BATCH, SEQ, CFG["vocab_size"])
    assert nsp.shape == (BATCH, 2) and loss.shape == (BATCH,)
    onp.testing.assert_allclose(mlm, jmlm, atol=1e-5, rtol=0)
    onp.testing.assert_allclose(nsp, jnsp, atol=1e-5, rtol=0)
    onp.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=0)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert list(tparams) == list(jparams)
    assert list(tparams)[0] == "mlm_bias"
    for name, p in tparams.items():
        g = p.grad().numpy()
        assert onp.isfinite(g).all(), name
        onp.testing.assert_allclose(g, jparams[name].grad().asnumpy(),
                                    atol=1e-5, rtol=1e-4, err_msg=name)


def test_pretraining_trainer_steps_match_jax(mode):
    """Three record/backward/AdamW steps: the losses of every step and the
    weights after the last agree."""
    jnet, tnet = _pair("BERTForPretraining", 3)
    batch = _batch(3)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    for params in (jparams, tparams):
        for name, p in params.items():
            if "key_proj.bias" in name:
                # zero gradient in exact arithmetic (softmax is shift
                # invariant): Adam would turn either package's summation
                # noise into +-lr steps
                p.grad_req = "null"
    # lr as the card's BERT step (chip_smoke phase 7); at 1e-3 Adam turns a
    # gradient element that is zero but for summation noise into a 1e-3
    # step in one package and not the other
    hyper = {"learning_rate": 1e-4, "wd": 0.01}
    jtr = mx.gluon.Trainer(jparams, "adamw", dict(hyper))
    ttr = tmx.gluon.Trainer(tparams, "adamw", dict(hyper))
    losses = []
    for _ in range(3):
        ref = _jax_step(jnet, batch)[2]
        jtr.step(BATCH)
        out = _port_step(tnet, batch)[2]
        ttr.step(BATCH)
        onp.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        losses.append(out.mean())
    assert losses[-1] < losses[0]
    ref_w = jfunctional.param_arrays(jnet)
    for wname, w in tfunctional.param_arrays(tnet).items():
        onp.testing.assert_allclose(w, onp.asarray(ref_w[wname]), atol=1e-5,
                                    rtol=0, err_msg=wname)


def test_constructors_and_aliases():
    assert tbert.bert_base is tbert.bert_12_768_12
    assert tbert.bert_large is tbert.bert_24_1024_16
    net = tbert.bert_12_768_12(vocab_size=50, max_length=16, device="cpu")
    assert net.encoder._num_layers == 12
    assert net.encoder.layer11.attention._heads == 12
    assert net.word_embed.weight.shape == (50, 768)
    head = tbert.BERTForPretraining(backbone=net)
    assert head.mlm_bias.shape == (50,)
    assert head.device == torch.device("cpu")


def test_dropout_is_live_and_reproducible_without_generators():
    """BERT at its own dropout (0.1): under record() every dropout site
    draws from the default generator, so after the same ``random.seed``
    the same forward comes out; outside record() dropout is off."""
    cfg = dict(CFG, dropout=0.1, embed_dropout=0.1)
    net = tbert.BERTForPretraining(device="cpu", **cfg).initialize(seed=0)
    ids, types, valid = (torch.from_numpy(a) for a in _batch(4)[:3])
    outs = []
    for _ in range(2):
        tmx.random.seed(3)
        with tmx.autograd.record():
            outs.append(net(ids, types, valid)[0].detach())
    idle = net(ids, types, valid)[0]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert (outs[0] - idle).abs().max() > 1e-2
