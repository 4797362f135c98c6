"""Deformable convolution (DCN v1 / v2) in plain PyTorch.

Counterpart of ``mxnet_tpu/ops/deformable.py`` (reference:
src/operator/contrib/deformable_convolution.cc and
modulated_deformable_convolution.cc; no Pallas kernel): the sampling grid
is built as dense index tensors, the four bilinear corners are four
gathers over the flattened H*W axis, and the reduction over channels and
kernel taps is one ``einsum``. Offsets use the reference's channel
layout: for deformable group ``dg`` and tap ``k = i*kw + j``, channel
``2*(dg*K + k)`` is the y offset and ``2*(dg*K + k) + 1`` the x offset;
mask channel (v2) ``dg*K + k``. A sample outside the image reads 0.
Differentiable in x, offset, mask, weight and bias by autograd.
"""
from __future__ import annotations

import torch

__all__ = ["deformable_conv2d"]


def _out_size(size, k, stride, pad, dilate):
    return (size + 2 * pad - (dilate * (k - 1) + 1)) // stride + 1


def deformable_conv2d(x, offset, weight, bias=None, *, kernel, stride=(1, 1),
                      pad=(0, 0), dilate=(1, 1), num_group=1,
                      num_deformable_group=1, mask=None):
    """x (N, C, H, W); offset (N, 2*ndg*K, Ho, Wo); weight
    (O, C/num_group, kh, kw); mask (N, ndg*K, Ho, Wo) for DCN v2.
    Returns (N, O, Ho, Wo) in x's dtype."""
    n, c, h, w = x.shape
    kh, kw = kernel
    k = kh * kw
    g, ndg = num_group, num_deformable_group
    ho = _out_size(h, kh, stride[0], pad[0], dilate[0])
    wo = _out_size(w, kw, stride[1], pad[1], dilate[1])
    dt, dev = x.dtype, x.device
    ky = (torch.arange(kh, device=dev) * dilate[0]).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilate[1]).repeat(kh)
    oy = torch.arange(ho, device=dev) * stride[0] - pad[0]
    ox = torch.arange(wo, device=dev) * stride[1] - pad[1]
    base_y = (ky[:, None, None] + oy[None, :, None]).float()   # (K, Ho, 1)
    base_x = (kx[:, None, None] + ox[None, None, :]).float()   # (K, 1, Wo)
    off = offset.reshape(n, ndg, k, 2, ho, wo).float()
    y = base_y + off[:, :, :, 0]                 # (N, ndg, K, Ho, Wo)
    xx = base_x + off[:, :, :, 1]
    y0, x0 = torch.floor(y), torch.floor(xx)
    wy1 = (y - y0)[:, :, None]                   # (N, ndg, 1, K, Ho, Wo)
    wx1 = (xx - x0)[:, :, None]
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    xg = x.reshape(n, ndg, c // ndg, h * w)

    def corner(cy, cx):
        inside = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        idx = (cy.clamp(0, h - 1).long() * w + cx.clamp(0, w - 1).long())
        flat = idx.reshape(n, ndg, 1, k * ho * wo).expand(
            n, ndg, c // ndg, k * ho * wo)
        v = torch.gather(xg, -1, flat).reshape(n, ndg, c // ndg, k, ho, wo)
        return v * inside[:, :, None].to(dt)

    sampled = (corner(y0, x0) * (wy0 * wx0).to(dt)
               + corner(y0, x0 + 1) * (wy0 * wx1).to(dt)
               + corner(y0 + 1, x0) * (wy1 * wx0).to(dt)
               + corner(y0 + 1, x0 + 1) * (wy1 * wx1).to(dt))
    if mask is not None:
        sampled = sampled * mask.reshape(n, ndg, 1, k, ho, wo).to(dt)
    o = weight.shape[0]
    sampled = sampled.reshape(n, g, c // g, k, ho * wo)
    wt = weight.reshape(g, o // g, c // g, k).to(dt)
    out = torch.einsum("ngckp,gock->ngop", sampled.float(), wt.float())
    out = out.reshape(n, o, ho, wo).to(dt)
    if bias is not None:
        out = out + bias.reshape(1, o, 1, 1).to(dt)
    return out
