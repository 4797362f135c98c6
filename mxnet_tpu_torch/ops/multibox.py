"""SSD multibox ops.

Counterpart of ``mxnet_tpu/ops/multibox.py`` (reference:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc): anchors, training targets (greedy bipartite
matching, then threshold matching, then hard-negative mining) and
detections (decode, then per-class NMS), batched over the samples with
the reference's static shapes. Equal scores keep index order (stable
sorts); the matching rounds and the NMS pass are loops of whole-tensor
steps on the device.
"""
from __future__ import annotations

import math

import torch

from .bbox import greedy_keep, iou

__all__ = ["multibox_prior", "multibox_target", "multibox_detection"]


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes (1, H*W*K, 4), corner format, for the (N, C, H, W)
    ``data``'s grid (reference: MultiBoxPriorForward): per location every
    size at ``ratios[0]``, then ``ratios[1:]`` at ``sizes[0]``."""
    sizes = tuple(float(s) for s in sizes) or (1.0,)
    ratios = tuple(float(r) for r in ratios) or (1.0,)
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    r0 = math.sqrt(ratios[0])
    hw = [s * h / w * r0 / 2.0 for s in sizes]
    hh = [s / r0 / 2.0 for s in sizes]
    for r in ratios[1:]:
        rs = math.sqrt(r)
        hw.append(sizes[0] * h / w * rs / 2.0)
        hh.append(sizes[0] / rs / 2.0)
    hw = torch.tensor(hw, dtype=torch.float32, device=dev)
    hh = torch.tensor(hh, dtype=torch.float32, device=dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[..., None], cyg[..., None]
    out = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], -1)
    out = out.reshape(1, h * w * hw.shape[0], 4)
    return out.clamp(0.0, 1.0) if clip else out


def _bipartite(overlaps, valid_gt):
    """Stage 1 of the targets: each round matches the best remaining
    (anchor, gt) pair above 1e-6, over a batch of (A, M) overlaps."""
    b, a, m = overlaps.shape
    dev = overlaps.device
    bi = torch.arange(b, device=dev)
    match_iou = torch.full((b, a), -1.0, device=dev)
    match_gt = torch.full((b, a), -1, dtype=torch.long, device=dev)
    a_done = torch.zeros((b, a), dtype=torch.bool, device=dev)
    g_done = ~valid_gt
    neg = torch.full_like(overlaps, -1.0)
    for _ in range(m):
        work = torch.where(a_done[:, :, None] | g_done[:, None, :], neg,
                           overlaps)
        flat = work.reshape(b, -1).argmax(1)
        i, k = flat // m, flat % m
        val = work[bi, i, k]
        good = val > 1e-6
        match_iou[bi, i] = torch.where(good, val, match_iou[bi, i])
        match_gt[bi, i] = torch.where(good, k, match_gt[bi, i])
        a_done[bi, i] = a_done[bi, i] | good
        g_done[bi, k] = g_done[bi, k] | good
    return match_iou, match_gt, a_done


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference: _contrib_MultiBoxTarget): anchor
    (1, A, 4), label (N, M, 5+) with -1-padded rows, cls_pred (N, C, A).
    Returns ``[loc_target (N, A*4), loc_mask (N, A*4), cls_target (N,
    A)]``; class 0 is background, ``ignore_label`` marks the anchors that
    take no part."""
    anchors = anchor.reshape(-1, 4)
    b, m = label.shape[0], label.shape[1]
    a = anchors.shape[0]
    dev = label.device
    valid_gt = torch.cumprod((label[..., 0] != -1.0).int(), 1).bool()
    gt_boxes = label[..., 1:5]
    overlaps = iou(anchors.expand(b, a, 4), gt_boxes)
    overlaps = torch.where(valid_gt[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    match_iou, match_gt, matched = _bipartite(overlaps, valid_gt)
    best_iou, best_gt = overlaps.max(2)
    has_gt = valid_gt.sum(1, keepdim=True) > 0
    if overlap_threshold > 0:
        thresh_pos = ~matched & has_gt & (best_iou > overlap_threshold)
    else:
        thresh_pos = torch.zeros_like(matched)
    positive = matched | thresh_pos
    match_gt = torch.where(matched, match_gt, best_gt)
    match_iou = torch.where(matched, match_iou, best_iou)
    if negative_mining_ratio > 0:
        num_pos = positive.sum(1, keepdim=True)
        num_neg = torch.minimum((num_pos * negative_mining_ratio).int(),
                                a - num_pos.int())
        num_neg = num_neg.clamp(min=int(minimum_negative_samples))
        mx = cls_pred.max(1).values
        prob_bg = torch.exp(cls_pred[:, 0] - mx) \
            / torch.exp(cls_pred - mx[:, None]).sum(1)
        cand = ~positive & (match_iou < negative_mining_thresh) & has_gt
        key = torch.where(cand, prob_bg, torch.full_like(prob_bg,
                                                         float("inf")))
        order = torch.sort(key, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=dev).expand(b, a).contiguous())
        negative = cand & (rank < num_neg)
    else:
        negative = ~positive & has_gt
    g = torch.take_along_dim(gt_boxes, match_gt[..., None], dim=1)
    gw, gh = g[..., 2] - g[..., 0], g[..., 3] - g[..., 1]
    gx, gy = (g[..., 0] + g[..., 2]) * 0.5, (g[..., 1] + g[..., 3]) * 0.5
    aw, ah = anchors[:, 2] - anchors[:, 0], anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    enc = torch.stack([(gx - ax) / aw / variances[0],
                       (gy - ay) / ah / variances[1],
                       torch.log(torch.clamp(gw / aw, min=1e-12))
                       / variances[2],
                       torch.log(torch.clamp(gh / ah, min=1e-12))
                       / variances[3]], -1)
    pos = positive[..., None]
    loc_target = torch.where(pos, enc, torch.zeros_like(enc)).reshape(b, -1)
    loc_mask = pos.expand(b, a, 4).to(torch.float32).reshape(b, -1)
    gt_cls = torch.take_along_dim(label[..., 0], match_gt, dim=1)
    cls_target = torch.where(
        positive, gt_cls + 1.0,
        torch.where(negative, torch.zeros_like(gt_cls),
                    torch.full_like(gt_cls, float(ignore_label))))
    return loc_target, loc_mask, cls_target


def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Detections from predictions (reference: _contrib_MultiBoxDetection):
    cls_prob (N, C, A) with class 0 the background, loc_pred (N, A*4),
    anchor (1, A, 4) -> (N, A, 6) rows ``[class_id, score, x1, y1, x2,
    y2]`` by descending score, class_id -1 for invalid or suppressed
    rows."""
    if background_id != 0:
        raise NotImplementedError("background_id must be 0 (reference "
                                  "kernel has the same restriction)")
    anchors = anchor.reshape(-1, 4)
    b, _, a = cls_prob.shape
    fg = cls_prob[:, 1:]
    score, cid = fg.max(1)
    cid = cid.to(torch.float32)
    keep_id = score >= threshold
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    p = loc_pred.reshape(b, a, 4)
    ox = p[..., 0] * variances[0] * aw + ax
    oy = p[..., 1] * variances[1] * ah + ay
    ow = torch.exp(p[..., 2] * variances[2]) * aw / 2
    oh = torch.exp(p[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    minus = torch.full_like(cid, -1.0)
    rows = torch.cat([torch.where(keep_id, cid, minus)[..., None],
                      score[..., None], boxes], -1)
    key = torch.where(keep_id, score, torch.full_like(score, -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rows = torch.take_along_dim(rows, order[..., None], dim=1)
    valid = torch.take_along_dim(keep_id, order, dim=1)
    if nms_topk > 0:
        valid = valid & (torch.arange(a, device=rows.device) < nms_topk)
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1.0))
    if nms_threshold <= 0 or nms_threshold > 1:
        return rows
    iou_m = iou(rows[..., 2:6], rows[..., 2:6])
    same = rows[..., 0][..., :, None] == rows[..., 0][..., None, :]
    if force_suppress:
        same = torch.ones_like(same)
    keep = greedy_keep(iou_m, valid, nms_threshold, False, same)
    dropped = rows.clone()
    dropped[..., 0] = -1.0
    return torch.where(keep[..., None], rows, dropped)
