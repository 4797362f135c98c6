"""Port parity: the reference's losses beyond softmax cross-entropy, and
``ops.xent.chunked_lm_xent``.

Every loss of ``mxnet_tpu/gluon/loss.py`` with its options (``weight``,
``sample_weight``, ``batch_axis``, ``from_sigmoid``, ``pos_weight``,
``from_logits``, ``sparse_label=False`` with smoothed labels, CTC with and
without lengths and in both layouts, ...) runs in both packages on the
same seeded inputs (CTC against the reference's computation through
``optax.ctc_loss``, since the reference's block fails on an import): the per-sample losses and the gradient of their sum
with respect to the prediction(s), at rtol 1e-5, atol 1e-6 (CTC 1e-4 /
1e-5: a 12-step log-space recursion). ``chunked_lm_xent`` is held against
the JAX package's (loss, dh, dw) at chunk sizes that do and do not divide
the vocabulary, fp32 and bf16.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import xent as jxent

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import xent as txent

torch.set_num_threads(2)

RS = onp.random.RandomState(0)
P = RS.randn(4, 5).astype("float32")
LAB = RS.randn(4, 5).astype("float32")
SIGN = onp.sign(RS.randn(4, 5)).astype("float32")
BIN = (RS.rand(4, 5) > 0.5).astype("float32")
PROB = RS.uniform(0.05, 0.95, (4, 5)).astype("float32")
SW = RS.rand(4, 1).astype("float32")
POSW = RS.uniform(0.5, 2.0, (5,)).astype("float32")
SMOOTH = onp.full((4, 5), 0.1 / 4, "float32")
SMOOTH[onp.arange(4), [0, 2, 4, 1]] = 0.9 + 0.1 / 4
RATE = RS.uniform(0.5, 3.0, (4, 5)).round().astype("float32")

#: name -> (class name, constructor kwargs, predictions, other inputs,
#: forward kwargs given as arrays)
CASES = {
    "l2": ("L2Loss", {}, [P], [LAB], {}),
    "l2_weight_sw": ("L2Loss", {"weight": 0.5}, [P], [LAB],
                     {"sample_weight": SW}),
    "l1": ("L1Loss", {}, [P], [LAB], {}),
    "l1_batch_axis1": ("L1Loss", {"batch_axis": 1}, [P], [LAB], {}),
    "huber": ("HuberLoss", {"rho": 0.7}, [P], [LAB], {}),
    "sbce": ("SigmoidBinaryCrossEntropyLoss", {}, [P], [BIN], {}),
    "sbce_posw": ("SigmoidBCELoss", {}, [P], [BIN], {"pos_weight": POSW}),
    "sbce_from_sigmoid": ("SigmoidBCELoss", {"from_sigmoid": True}, [PROB],
                          [BIN], {}),
    "sbce_from_sigmoid_posw": ("SigmoidBCELoss", {"from_sigmoid": True},
                               [PROB], [BIN], {"pos_weight": POSW}),
    "softmax_dense_smoothed": ("SoftmaxCrossEntropyLoss",
                               {"sparse_label": False}, [P], [SMOOTH], {}),
    "softmax_ce_alias_sw": ("SoftmaxCELoss", {"weight": 2.0}, [P],
                            [onp.array([0, 3, 1, 4], "int32")],
                            {"sample_weight": SW[:, 0]}),
    "kldiv": ("KLDivLoss", {}, [onp.log(PROB)], [PROB], {}),
    "kldiv_logits": ("KLDivLoss", {"from_logits": False}, [P], [PROB], {}),
    "hinge": ("HingeLoss", {"margin": 0.8}, [P], [SIGN], {}),
    "squared_hinge": ("SquaredHingeLoss", {}, [P], [SIGN], {}),
    "logistic_signed": ("LogisticLoss", {}, [P], [SIGN], {}),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"}, [P],
                        [BIN], {}),
    "triplet": ("TripletLoss", {"margin": 0.5}, [P],
                [LAB, RS.randn(4, 5).astype("float32")], {}),
    "cosine_embedding": ("CosineEmbeddingLoss", {"margin": 0.1},
                         [P, LAB], [onp.array([1, -1, 1, -1], "float32")],
                         {}),
    "poisson": ("PoissonNLLLoss", {}, [P * 0.3], [RATE], {}),
    "poisson_rate_full": ("PoissonNLLLoss", {"from_logits": False,
                                             "compute_full": True},
                          [PROB * 3], [RATE], {}),
    "sdml": ("SDMLLoss", {"smoothing_parameter": 0.2}, [P, LAB], [], {}),
}


def _jax_run(cls, kw, preds, others, fkw):
    loss = getattr(jloss, cls)(**kw)
    jp = [mx.np.array(p) for p in preds]
    for p in jp:
        p.attach_grad()
    with mx.autograd.record():
        out = loss(*jp, *[mx.np.array(o) for o in others],
                   **{k: mx.np.array(v) for k, v in fkw.items()})
    out.backward()
    return out.asnumpy(), [p.grad.asnumpy() for p in jp]


def _port_run(cls, kw, preds, others, fkw):
    loss = getattr(tloss, cls)(**kw)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in preds]
    with tmx.autograd.record():
        out = loss(*tp, *[torch.from_numpy(o.copy()) for o in others],
                   **{k: torch.from_numpy(v.copy()) for k, v in fkw.items()})
    tmx.autograd.backward(out)
    return out.detach().numpy(), [p.grad.numpy() for p in tp]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    want, wgrads = _jax_run(*CASES[case])
    got, grads = _port_run(*CASES[case])
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w in zip(grads, wgrads):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def _ctc_inputs(seed):
    rs = onp.random.RandomState(seed)
    pred = rs.randn(3, 12, 6).astype("float32")
    label = onp.array([[1, 2, 2, 0], [3, 0, 0, 0], [5, 4, 3, 1]], "int32")
    return pred, label


def _optax_ctc(pred, label, pred_lengths, label_lengths):
    """The reference's ``CTCLoss.forward`` computation
    (``mxnet_tpu/gluon/loss.py:174-193``) on NTC inputs: ``optax.ctc_loss``
    with blank 0, its paddings built as the reference builds them. The
    reference's block itself cannot run: its forward imports
    ``mxnet_tpu.block``, which does not exist (ROADMAP.md Queue 3)."""
    import jax
    import jax.numpy as jnp
    import optax
    b, t = pred.shape[:2]
    lp = (jnp.zeros((b, t)) if pred_lengths is None else
          (jnp.arange(t)[None, :] >= jnp.asarray(pred_lengths)[:, None])
          .astype(jnp.float32))
    if label_lengths is not None:
        lpad = (jnp.arange(label.shape[1])[None, :]
                >= jnp.asarray(label_lengths)[:, None]).astype(jnp.float32)
    else:
        lpad = (jnp.asarray(label) == 0).astype(jnp.float32)

    def f(logits):
        return optax.ctc_loss(logits, lp, jnp.asarray(label, jnp.int32),
                              lpad, blank_id=0)
    loss, vjp = jax.vjp(f, jnp.asarray(pred))
    grad, = vjp(jnp.ones_like(loss))
    return onp.asarray(loss), onp.asarray(grad)


def test_reference_ctc_block_cannot_run():
    """Pinned so a repaired reference shows up here: the JAX package's
    ``CTCLoss`` raises on its own import line."""
    pred, label = _ctc_inputs(1)
    with pytest.raises(ModuleNotFoundError):
        jloss.CTCLoss()(mx.np.array(pred), mx.np.array(label))


@pytest.mark.parametrize("layout,lengths", [("NTC", False), ("NTC", True),
                                            ("TNC", False)])
def test_ctc_matches_jax(layout, lengths):
    """CTC on (3, 12, 6) logits and 4-label rows with repeats: labels of 0
    are padding without lengths; with lengths, 10 / 12 / 9 frames and
    3 / 1 / 4 labels. The oracle is the reference's computation, run
    through ``optax.ctc_loss`` directly (:func:`_optax_ctc`)."""
    pred, label = _ctc_inputs(1)
    pl = onp.array([10, 12, 9], "int32") if lengths else None
    ll = onp.array([3, 1, 4], "int32") if lengths else None
    want, wg = _optax_ctc(pred, label, pl, ll)
    tp = pred if layout == "NTC" else \
        onp.ascontiguousarray(pred.transpose(1, 0, 2))
    fkw = {} if not lengths else {"pred_lengths": pl, "label_lengths": ll}
    got, (g,) = _port_run("CTCLoss", {"layout": layout}, [tp], [label],
                          fkw)
    if layout == "TNC":
        g = g.transpose(1, 0, 2)
    assert got.shape == (3,)
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-5)


def test_every_reference_loss_exists():
    names = {n for n in dir(jloss) if n.endswith("Loss") and n != "Loss"}
    assert names <= set(dir(tloss)), names - set(dir(tloss))
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss


@pytest.mark.parametrize("dtype,chunk", [("float32", 8), ("float32", 7),
                                         ("bfloat16", 16)])
def test_chunked_lm_xent_matches_jax(dtype, chunk):
    rs = onp.random.RandomState(2)
    h = rs.randn(6, 16).astype("float32")
    w = (rs.randn(29, 16) * 0.3).astype("float32")
    lab = onp.array([0, 5, 28, 13, 40, -2], "int32")  # two clip
    jh, jw = mx.np.array(h, dtype=dtype), mx.np.array(w, dtype=dtype)
    jh.attach_grad()
    jw.attach_grad()
    with mx.autograd.record():
        jl = mx.numpy.multiarray._invoke(
            lambda a, b, c: jxent.chunked_lm_xent(a, b, c, chunk),
            (jh, jw, mx.np.array(lab)))
    jl.backward()
    td = getattr(torch, dtype)
    th = torch.from_numpy(h).to(td).requires_grad_()
    tw = torch.from_numpy(w).to(td).requires_grad_()
    tl = txent.chunked_lm_xent(th, tw, torch.from_numpy(lab), chunk)
    tl.sum().backward()
    assert tl.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), **tol)
    onp.testing.assert_allclose(th.grad.float().numpy(),
                                onp.asarray(jh.grad.asnumpy(), "float32"),
                                **tol)
    onp.testing.assert_allclose(tw.grad.float().numpy(),
                                onp.asarray(jw.grad.asnumpy(), "float32"),
                                **tol)
    # against the unchunked loss
    full = torch.nn.functional.cross_entropy(
        th.detach().float() @ tw.detach().float().t(),
        torch.from_numpy(lab).long().clamp(0, 28), reduction="none")
    onp.testing.assert_allclose(tl.detach().numpy(), full.numpy(), **tol)
