"""Port parity: the detection ops of ``npx`` (``ops/bbox.py``,
``ops/multibox.py``), JAX package -> PyTorch port.

``box_iou`` (corner and center), ``box_nms`` (class ids, ``topk``,
``valid_thresh``, ``force_suppress``), ``box_encode``, ``box_decode``
(with the log-delta clip), ``bipartite_matching`` (both directions,
``topk``), ``multibox_prior``, ``multibox_target`` (with hard-negative
mining) and ``multibox_detection`` take the same seeded numpy inputs in
both packages (``mx.np`` arrays, on the CPU): float32 values within rtol
1e-5 / atol 1e-6, dtypes equal, and the gradients of ``box_iou`` and
``box_decode`` likewise. Equal scores keep index order, as the
reference's stable sorts leave them: rows tied on score come out of NMS,
``topk`` and the detections lower index first.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from test_torch_npx_tail import _leaves, _match

torch.set_num_threads(2)

RS = onp.random.RandomState(2424)
X = RS.randn(1, 4, 4).astype("float32")
BOXES = onp.array([[[0.1, 0.1, 0.5, 0.6], [0.2, 0.15, 0.55, 0.7],
                    [0.6, 0.6, 0.9, 0.95], [0.0, 0.0, 0.3, 0.3]]],
                  "float32")
NMS = onp.array([[[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                  [0, 0.8, 0.12, 0.1, 0.52, 0.5],
                  [1, 0.8, 0.12, 0.1, 0.52, 0.5],
                  [0, 0.8, 0.6, 0.6, 0.9, 0.9],
                  [1, 0.05, 0.6, 0.6, 0.9, 0.9],
                  [0, 0.7, 0.61, 0.6, 0.9, 0.92]]], "float32")
AFF = onp.array([[0.5, 0.6, 0.1], [0.9, 0.2, 0.6], [0.3, 0.6, 0.0],
                 [0.1, 0.1, 0.05]], "float32")
LABEL = onp.array([[[1, 0.1, 0.1, 0.4, 0.4], [0, 0.5, 0.5, 0.9, 0.8],
                    [-1, -1, -1, -1, -1]],
                   [[2, 0.0, 0.2, 0.3, 0.7], [-1, -1, -1, -1, -1],
                    [-1, -1, -1, -1, -1]]], "float32")
FEAT = onp.zeros((2, 3, 4, 4), "float32")
CLS = RS.randn(2, 3, 64).astype("float32")




@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _anchors(m, a):
    return m.npx.multibox_prior(a(FEAT), sizes=(0.3, 0.5),
                                ratios=(1.0, 2.0, 0.5))


CASES = {
    "box_iou": lambda m, a: m.npx.box_iou(a(BOXES[0]), a(BOXES[0, :2])),
    "box_iou_center": lambda m, a: m.npx.box_iou(a(BOXES), a(BOXES),
                                                 format="center"),
    "box_nms": lambda m, a: m.npx.box_nms(a(NMS), overlap_thresh=0.5),
    "box_nms_ids": lambda m, a: m.npx.box_nms(
        a(NMS), overlap_thresh=0.3, valid_thresh=0.1, id_index=0,
        topk=4),
    "box_nms_force": lambda m, a: m.npx.box_nms(
        a(NMS), overlap_thresh=0.3, id_index=0, force_suppress=True),
    "box_encode": lambda m, a: m.npx.box_encode(
        a(onp.array([[1., -1., 0., 1.]], "f4")),
        a(onp.array([[0, 1, 0, 1]], "f4")), a(BOXES), a(BOXES[:, 1:3])),
    "box_encode_out_of_range": lambda m, a: m.npx.box_encode(
        a(onp.array([[1., 1., 1., -1.]], "f4")),
        a(onp.array([[-1, 5, 0, 9]], "f4")), a(BOXES), a(BOXES[:, 1:3])),
    "box_decode": lambda m, a: m.npx.box_decode(
        a(X[:1, :, :4] * 0.3), a(BOXES), clip=0.2),
    "box_decode_corner": lambda m, a: m.npx.box_decode(
        a(X[:1, :, :4] * 0.3), a(BOXES), format="corner"),
    "bipartite_matching": lambda m, a: m.npx.bipartite_matching(
        a(AFF), threshold=0.1),
    "bipartite_matching_ascend": lambda m, a: m.npx.bipartite_matching(
        a(AFF[None]), threshold=0.55, is_ascend=True, topk=2),
    "multibox_prior": _anchors,
    "multibox_prior_clip": lambda m, a: m.npx.multibox_prior(
        a(FEAT[:, :, :3]), sizes=(0.9,), ratios=(1.0, 3.0), clip=True,
        steps=(0.3, 0.25), offsets=(0.4, 0.6)),
    "multibox_target": lambda m, a: m.npx.multibox_target(
        _anchors(m, a), a(LABEL), a(CLS), overlap_threshold=0.3),
    "multibox_target_mining": lambda m, a: m.npx.multibox_target(
        _anchors(m, a), a(LABEL),
        a(onp.random.RandomState(3).randn(2, 3, 64).astype("float32")),
        negative_mining_ratio=3.0, minimum_negative_samples=2),
    "multibox_detection": lambda m, a: m.npx.multibox_detection(
        a(onp.random.RandomState(4).dirichlet(onp.ones(3), (2, 64))
          .transpose(0, 2, 1).astype("float32")),
        a(onp.random.RandomState(5).randn(2, 256).astype("float32") * 0.1),
        _anchors(m, a), threshold=0.2, nms_threshold=0.45),
    "multibox_detection_force": lambda m, a: m.npx.multibox_detection(
        a(onp.random.RandomState(6).dirichlet(onp.ones(3), (2, 64))
          .transpose(0, 2, 1).astype("float32")),
        a(onp.zeros((2, 256), "float32")), _anchors(m, a),
        force_suppress=True, nms_topk=20, clip=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detection_op_matches_jax(name):
    want = CASES[name](mx, mx.np.array)
    got = CASES[name](tmx, tmx.np.array)
    _match(got, want, name)


@pytest.mark.parametrize("name", ["box_iou", "box_iou_center",
                                  "box_decode", "box_encode"])
def test_detection_gradient_matches_jax(name):
    grads = []
    for m in (mx, tmx):
        inputs = []

        def arr(v, m=m, inputs=inputs):
            a = m.np.array(v)
            a.attach_grad()
            inputs.append(a)
            return a
        with m.autograd.record():
            y = sum((o * o).sum() for o in _leaves(CASES[name](m, arr)))
        y.backward()
        grads.append([a.grad for a in inputs])
    for i, (g, w) in enumerate(zip(grads[1], grads[0])):
        _match(g, w, f"{name} d{i}", atol=1e-5)


def test_equal_scores_keep_index_order():
    """Three rows tied on score, none overlapping: NMS keeps them in index
    order; topk of tied values lists the lower index first."""
    rows = onp.array([[[0, 0.5, 0.0, 0.0, 0.1, 0.1],
                       [0, 0.9, 0.2, 0.2, 0.3, 0.3],
                       [0, 0.5, 0.4, 0.4, 0.5, 0.5],
                       [0, 0.5, 0.6, 0.6, 0.7, 0.7]]], "float32")
    out = tmx.npx.box_nms(tmx.np.array(rows)).asnumpy()
    onp.testing.assert_array_equal(out[0, :, 2], rows[0, [1, 0, 2, 3], 2])
    idx = tmx.npx.topk(tmx.np.array(onp.zeros((2, 9), "float32")), k=9,
                       dtype="int32").asnumpy()
    onp.testing.assert_array_equal(idx, onp.tile(onp.arange(9), (2, 1)))
