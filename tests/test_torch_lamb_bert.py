"""Port parity of the slice as a whole: BERT pretraining the way
GluonNLP's script drives it, JAX package -> PyTorch port.

A small BERT (vocab 1000, 64 units, FFN 256, 2 layers, 4 heads, dropout
0) is initialized by the JAX package and carried into the port by
structural name. Both take 3 steps of MLM + NSP loss on the same batches
through a ``Trainer`` with ``lamb`` (lr 1e-3, wd 0.01) on the "local"
kvstore, ``wd_mult`` 0 on every ``.*beta|.*gamma|.*bias`` parameter
(set on ``collect_params(".*beta|.*gamma|.*bias")``), and ``gluon.utils.clip_global_norm``
of the gradients at 1.0 before each step; a deferred ``metric.Accuracy``
on the NSP scores and a deferred ``metric.Perplexity`` on the MLM
probabilities run beside them. Held: the global norms (rtol 1e-4), every
weight after each step (atol 1e-5, rtol 1e-4: LAMB's trust ratio over
float32 gradients of two summation orders), and the metrics (rtol 1e-5),
with ``fused_ln_residual`` "on" and "off" and with
``update_on_kvstore=True``. The key projections' biases are frozen in
both: their gradient is zero in exact arithmetic, and Adam-style moments
turn its float noise into steps of either sign.
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

CFG = dict(vocab_size=1000, units=64, hidden_size=256, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0, embed_dropout=0.0)
BATCH, SEQ, STEPS = 2, 16, 3
OPT = {"learning_rate": 1e-3, "wd": 0.01}


def _batch(step):
    rs = onp.random.RandomState(10 + step)
    ids = rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    valid = onp.array([SEQ, 11], dtype="int32")
    pos = onp.arange(SEQ)[None, :]
    types = ((pos >= onp.array([[6], [5]])) & (pos < valid[:, None])) \
        .astype("int32")
    weight = ((rs.rand(BATCH, SEQ) < 0.4) & (pos < valid[:, None])) \
        .astype("float32")
    labels = rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    nsp = onp.array([0, 1], dtype="int32")
    return ids, types, valid, labels, weight, nsp


def _nets():
    mx.random.seed(0)
    jnet = jbert.BERTForPretraining(**CFG)
    jnet.initialize()
    ids, types, valid = _batch(0)[:3]
    jnet(mx.np.array(ids), mx.np.array(types), mx.np.array(valid))
    tnet = tbert.BERTForPretraining(device="cpu", **CFG)
    tfunctional.load_params(tnet, {k: onp.asarray(v) for k, v in
                                   jfunctional.param_arrays(jnet).items()})
    for net in (jnet, tnet):
        for p in net.collect_params(".*beta|.*gamma|.*bias").values():
            p.wd_mult = 0.0
        for p in net.collect_params(".*key_proj.bias").values():
            p.grad_req = "null"
    return jnet, tnet


def _selected(params):
    return [p.grad() for p in params.values() if p.grad_req != "null"]


@pytest.fixture(params=[("off", False), ("on", False), ("off", True)],
                ids=["unfused", "fused_ln", "update_on_kvstore"])
def setting(request):
    mode, on_kv = request.param
    old = mx.config.get("fused_ln_residual")
    mx.config.set("fused_ln_residual", mode)
    tmx.config.set("fused_ln_residual", mode)
    yield on_kv
    mx.config.set("fused_ln_residual", old)
    tmx.config.reset("fused_ln_residual")


def test_lamb_bert_steps_match_jax(setting):
    jnet, tnet = _nets()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert jp[next(iter(jp))].wd_mult == tp[next(iter(tp))].wd_mult
    assert sum(p.wd_mult == 0.0 for p in tp.values()) > 10
    jtr = mx.gluon.Trainer(jp, "lamb", dict(OPT), kvstore="local",
                           update_on_kvstore=setting)
    ttr = tmx.gluon.Trainer(tp, "lamb", dict(OPT), kvstore="local",
                            update_on_kvstore=setting)
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jacc, jppl = mx.gluon.metric.Accuracy(), mx.gluon.metric.Perplexity()
    tacc = tmx.gluon.metric.Accuracy().defer()
    tppl = tmx.gluon.metric.Perplexity().defer()
    for step in range(STEPS):
        batch = _batch(step)
        ids, types, valid, labels, weight, nsp = (mx.np.array(a)
                                                  for a in batch)
        with mx.autograd.record():
            mlm, nsp_scores = jnet(ids, types, valid)
            loss = jloss_fn(mlm, labels, weight) + jloss_fn(nsp_scores, nsp)
        loss.backward()
        jnorm = mx.gluon.utils.clip_global_norm(_selected(jp), 1.0)
        jtr.step(BATCH)
        jacc.update([nsp], [nsp_scores])
        jppl.update([labels.reshape(-1)],
                    [mx.npx.softmax(mlm).reshape(-1, CFG["vocab_size"])])

        ids, types, valid, labels, weight, nsp = (torch.from_numpy(a)
                                                  for a in batch)
        with tmx.autograd.record():
            mlm, nsp_scores = tnet(ids, types, valid)
            loss = tloss_fn(mlm, labels, weight) + tloss_fn(nsp_scores, nsp)
        tmx.autograd.backward(loss)
        tnorm = tmx.gluon.utils.clip_global_norm(_selected(tp), 1.0)
        ttr.step(BATCH)
        tacc.update([nsp], [nsp_scores])
        tppl.update([labels.reshape(-1)],
                    [torch.softmax(mlm, -1).reshape(-1, CFG["vocab_size"])])

        assert jnorm > 1.0  # the clip acts
        onp.testing.assert_allclose(tnorm, jnorm, rtol=1e-4)
        ref = jfunctional.param_arrays(jnet)
        for n, w in tfunctional.param_arrays(tnet).items():
            onp.testing.assert_allclose(w, onp.asarray(ref[n]), atol=1e-5,
                                        rtol=1e-4, err_msg=f"{n} step {step}")
    assert len(tacc._window) == STEPS and len(tppl._window) == STEPS
    onp.testing.assert_allclose(tacc.get()[1], jacc.get()[1], rtol=1e-5)
    onp.testing.assert_allclose(tppl.get()[1], jppl.get()[1], rtol=1e-5)
    assert ttr._update_on_kvstore == setting
    assert ttr._kvstore is not None and ttr._fused_update is False
