"""Bounding-box ops.

Counterpart of ``mxnet_tpu/ops/bbox.py`` (reference:
src/operator/contrib/bounding_box.cc): ``box_iou``, ``box_nms``,
``box_encode``, ``box_decode`` and ``bipartite_matching``, over tensors,
with the reference's static output shapes: NMS keeps every row, sorted by
descending score, and fills a suppressed or invalid row with -1.

The order of equal scores is the reference's (``jnp.argsort`` is stable):
the lower index first, by a stable sort, on the card too. The greedy
passes (NMS over the sorted rows, the matching rounds) are loops of
whole-tensor steps on the device, as the reference's ``lax.fori_loop``s
are: no step reads the host.
"""
from __future__ import annotations

import torch

from ..numpy._ops import take_along_fill

__all__ = ["box_iou", "box_nms", "box_encode", "box_decode",
           "bipartite_matching"]


def corner(boxes, fmt):
    """Boxes as (x1, y1, x2, y2) from ``fmt`` "corner" or "center"
    (cx, cy, w, h)."""
    if fmt == "corner":
        return boxes
    cx, cy, w, h = boxes.split(1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def iou(lhs, rhs):
    """(..., N, 4) x (..., M, 4) corner boxes -> (..., N, M) IoU, 0 where
    the union is empty."""
    lt = torch.maximum(lhs[..., :, None, :2], rhs[..., None, :, :2])
    rb = torch.minimum(lhs[..., :, None, 2:], rhs[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (lhs[..., 2:] - lhs[..., :2]).clamp(min=0).prod(-1)
    area_r = (rhs[..., 2:] - rhs[..., :2]).clamp(min=0).prod(-1)
    union = area_l[..., :, None] + area_r[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def box_iou(lhs, rhs, format="corner"):  # noqa: A002 - reference name
    """Pairwise IoU (reference: _contrib_box_iou)."""
    return iou(corner(lhs, format), corner(rhs, format))


def greedy_keep(iou_m, keep, thresh, strict, same=None):
    """The greedy suppression pass over rows sorted best first: row ``i``,
    if still kept, drops every later row whose IoU with it is above
    ``thresh`` (at or above with ``strict`` False) and, where ``same`` is
    given, shares its class. Batched over the leading dims."""
    n = keep.shape[-1]
    later = torch.arange(n, device=keep.device)
    over = iou_m > thresh if strict else iou_m >= thresh
    if same is not None:
        over = over & same
    for i in range(n):
        sup = over[..., i, :] & (later > i) & keep[..., i:i + 1]
        keep = keep & ~sup
    return keep


def _stable_order(key):
    """Indices sorting ``key`` descending along the last axis, equal keys
    in index order."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner"):
    """Non-maximum suppression over (..., N, K) rows (reference:
    _contrib_box_nms): rows sorted by descending score, suppressed and
    invalid rows filled with -1."""
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:]))
    n = d.shape[1]
    scores = d[..., score_index]
    valid = scores > valid_thresh
    neg_inf = torch.full_like(scores, -float("inf"))
    order = _stable_order(torch.where(valid, scores, neg_inf))
    srt = torch.take_along_dim(d, order[..., None], dim=1)
    boxes = corner(srt[..., coord_start:coord_start + 4], in_format)
    iou_m = iou(boxes, boxes)
    if id_index >= 0 and not force_suppress:
        ids = srt[..., id_index]
        same = ids[..., :, None] == ids[..., None, :]
        iou_m = torch.where(same, iou_m, torch.zeros_like(iou_m))
    keep = torch.take_along_dim(valid, order, dim=1)
    if topk > 0:
        keep = keep & (torch.arange(n, device=d.device) < topk)
    keep = greedy_keep(iou_m, keep, overlap_thresh, True)
    out = torch.where(keep[..., None], srt, torch.full_like(srt, -1.0))
    return out.reshape(shape)


def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD-style targets (reference: _contrib_box_encode): corner anchors
    (B, N, 4) against the matched corner refs (B, M, 4), normalized
    (dx, dy, dw, dh), and the mask of positive samples (``samples`` >
    0.5); 0 where not positive."""
    ref = take_along_fill(refs, matches.long()[..., None], 1)
    ax1, ay1, ax2, ay2 = anchors.split(1, -1)
    rx1, ry1, rx2, ry2 = ref.split(1, -1)
    aw, ah = ax2 - ax1, ay2 - ay1
    acx, acy = ax1 + aw / 2, ay1 + ah / 2
    rw, rh = rx2 - rx1, ry2 - ry1
    rcx, rcy = rx1 + rw / 2, ry1 + rh / 2
    t = torch.cat([((rcx - acx) / aw - means[0]) / stds[0],
                   ((rcy - acy) / ah - means[1]) / stds[1],
                   (torch.log(rw / aw) - means[2]) / stds[2],
                   (torch.log(rh / ah) - means[3]) / stds[3]], -1)
    mask = (samples > 0.5)[..., None].to(t.dtype) * torch.ones_like(t)
    return torch.where(mask > 0, t, torch.zeros_like(t)), mask


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="center"):  # noqa: A002
    """(dx, dy, dw, dh) against anchors given in ``format`` -> corner
    boxes (reference: _contrib_box_decode); a positive ``clip`` caps the
    scaled log-deltas before the exponential."""
    if format == "corner":
        x1, y1, x2, y2 = anchors.split(1, -1)
        aw, ah = x2 - x1, y2 - y1
        acx, acy = x1 + aw / 2, y1 + ah / 2
    else:
        acx, acy, aw, ah = anchors.split(1, -1)
    dx, dy, dw, dh = data.split(1, -1)
    cx = dx * std0 * aw + acx
    cy = dy * std1 * ah + acy
    dw, dh = dw * std2, dh * std3
    if clip > 0:
        dw, dh = dw.clamp(max=clip), dh.clamp(max=clip)
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy matching on a (..., N, M) score matrix (reference:
    _contrib_bipartite_matching): each round takes the best remaining pair
    (the first in row-major order among equals) if it passes
    ``threshold``, then removes its row and column. Returns float32
    ``(row_match, col_match)``, -1 where unmatched."""
    shape = data.shape
    work = data.reshape((-1,) + tuple(shape[-2:])).clone()
    b, n, m = work.shape
    k = min(n, m) if topk <= 0 else min(topk, n, m)
    big = float("inf") if is_ascend else -float("inf")
    rows = torch.full((b, n), -1.0, device=data.device)
    cols = torch.full((b, m), -1.0, device=data.device)
    bi = torch.arange(b, device=data.device)
    for _ in range(k):
        flat = work.reshape(b, -1)
        pick = flat.argmin(1) if is_ascend else flat.argmax(1)
        i, j = pick // m, pick % m
        val = flat[bi, pick]
        good = val < threshold if is_ascend else val > threshold
        rows[bi, i] = torch.where(good, j.float(), rows[bi, i])
        cols[bi, j] = torch.where(good, i.float(), cols[bi, j])
        work[bi, i, :] = big
        work[bi, :, j] = big
    return rows.reshape(shape[:-1]), cols.reshape(shape[:-2] + shape[-1:])
