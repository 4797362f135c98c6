"""Ring attention: sequence parallelism over a mesh axis.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py`` (Liu et al.'s ring
attention). Each rank of the ``sp`` axis holds one block of the sequence's
queries, keys and values; the key/value blocks travel around the ring
(rank i sends to i + 1), and each rank attends its queries to every block
in turn: at ring step i it holds the block of rank ``(my - i) % n``.

Two routes, one function:

- ``plain``: the reference's online softmax (``_block_attn``) in torch,
  differentiable through autograd, the key/value blocks moved by the
  differentiable ppermute (``_diff.permute``). The tests hold it against
  the JAX package; the CPU takes it.
- ``kernels`` (CUDA tensors of a dtype and head_dim the flash kernels
  take): kernel 1 (``flash_attention_fwd``) on each (query block,
  key/value block) pair, the pairs' ``(out, lse)`` merged by their lse in
  fp32. Under causal masking the diagonal pair is ``causal=True``, pairs
  with an earlier rank's block are full and pairs with a later rank's are
  skipped (no launch). The backward computes delta from the merged output
  and runs kernels 3 (dq) and 2 (dk / dv) on each computed pair with the
  GLOBAL lse, summing in fp32 (the kernels overwrite their outputs); the
  dk / dv accumulators travel with their key / value block and take one
  more permute home. On CPU tensors ``_kernels`` runs the kernels' plain
  versions (what the tests call to hold the merge against ``_plain``).
"""
from __future__ import annotations

import torch

from . import _diff
from . import collectives as _coll

__all__ = ["ring_attention", "block_attn"]


def block_attn(q, k, v, m_prev, l_prev, acc, scale, mask=None):
    """One online-softmax step (reference ``_block_attn``): q (b, h, sq,
    d), k / v (b, h, sk, d), m / l (b, h, sq, 1) fp32, acc like q in
    fp32; ``mask`` (sq, sk) bool, True where a key is visible. The scores
    are fp32 (the reference's input dtype; bf16 inputs widened, as the
    kernels do), p is rounded to v's dtype for the product with v."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    fin_new = torch.isfinite(m_new)
    m_safe = torch.where(fin_new, m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    fin_prev = torch.isfinite(m_prev)
    correction = torch.exp(torch.where(
        fin_prev, m_prev - m_safe, torch.full_like(m_prev, float("-inf"))))
    correction = torch.where(fin_prev, correction,
                             torch.zeros_like(correction))
    l_new = correction * l_prev + p.sum(dim=-1, keepdim=True)
    acc_new = correction * acc + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return m_new, l_new, acc_new


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _plain(q, k, v, mesh, axis, causal, scale):
    _, n, my = _coll._group_of(mesh, axis)
    b, h, sq, _ = q.shape
    dev = q.device
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=torch.float32,
                   device=dev)
    l_ = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    kc, vc = k, v
    for i in range(n):
        mask = None
        if causal:
            src = (my - i) % n
            sk = kc.shape[2]
            q_pos = my * sq + torch.arange(sq, device=dev)[:, None]
            k_pos = src * sk + torch.arange(sk, device=dev)[None, :]
            mask = q_pos >= k_pos
        m, l_, acc = block_attn(q, kc, vc, m, l_, acc, scale, mask)
        if i < n - 1:  # the reference's last permute feeds nothing
            kc = _diff.permute(kc, mesh, axis, _ring(n))
            vc = _diff.permute(vc, mesh, axis, _ring(n))
    return (acc / torch.clamp(l_, min=1e-20)).to(q.dtype)


def _pairs(n, my, causal):
    """[(ring step, causal flag)] of the pairs this rank computes: every
    step without causal masking; under it the diagonal (step 0, causal)
    and the earlier ranks' blocks (full), the later ranks' skipped."""
    out = []
    for i in range(n):
        src = (my - i) % n
        if not causal or src < my:
            out.append((i, False))
        elif src == my:
            out.append((i, True))
    return out


def _merge(out, lse, o, l_):
    """(out, lse) of two normalized partial attentions over disjoint key
    sets, in fp32."""
    new = torch.logaddexp(lse, l_)
    return (out * torch.exp(lse - new) + o.float() * torch.exp(l_ - new),
            new)


class _RingFlash(torch.autograd.Function):
    """The kernel route on (b*h, s, d) blocks."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        from ..ops import flash_attention as fa
        _, n, my = _coll._group_of(mesh, axis)
        pairs = dict(_pairs(n, my, causal))
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:2] + (1,), float("-inf"),
                         dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for i in range(n):
            if i in pairs:
                o, l_ = fa.flash_attention_fwd(q, kc, vc, pairs[i], scale)
                out, lse = _merge(out, lse, o, l_)
            if i < n - 1:
                kc = _coll.ppermute(kc, mesh, axis, _ring(n))
                vc = _coll.ppermute(vc, mesh, axis, _ring(n))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.scale = mesh, axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        from ..ops import flash_attention as fa
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, scale = ctx.mesh, ctx.axis, ctx.scale
        _, n, my = _coll._group_of(mesh, axis)
        pairs = dict(_pairs(n, my, ctx.causal))
        do = do.to(q.dtype).contiguous()
        delta = fa._delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for i in range(n):
            if i in pairs:
                dq += fa.flash_attention_bwd_dq(q, kc, vc, do, lse, delta,
                                                pairs[i], scale).float()
                dki, dvi = fa.flash_attention_bwd_dkv(q, kc, vc, do, lse,
                                                      delta, pairs[i], scale)
                dk += dki.float()
                dv += dvi.float()
            # the accumulators travel with their block; after the last
            # step one more permute takes them home
            if i < n - 1:
                kc = _coll.ppermute(kc, mesh, axis, _ring(n))
                vc = _coll.ppermute(vc, mesh, axis, _ring(n))
            dk = _coll.ppermute(dk, mesh, axis, _ring(n))
            dv = _coll.ppermute(dv, mesh, axis, _ring(n))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _kernels_take(q):
    from ..ops import flash_attention as fa
    if q.dtype not in fa._DTYPE_CODES:
        return False
    return q.device.type == "cpu" or q.shape[-1] in fa.HEAD_DIMS


def _kernels(q, k, v, mesh, axis, causal, scale):
    """The kernel route on (batch, heads, seq_local, head_dim) blocks."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    return _RingFlash.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), mesh, axis, bool(causal),
        scale).reshape(b, h, sq, d)


def ring_attention(q, k, v, mesh, axis="sp", causal=False, scale=None):
    """Sequence-sharded attention on this rank's blocks.

    q, k, v: (batch, heads, seq_local, head_dim) tensors (or ``mx.np``
    arrays), this rank's block of the sequence on ``axis`` of ``mesh``;
    returns this rank's block of the output, differentiable in q, k and v.
    CUDA tensors the flash kernels take go the kernel route, the rest the
    plain one."""
    wrap = hasattr(q, "_data")
    if wrap:
        q, k, v = q._data, k._data, v._data
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    route = _kernels if q.is_cuda and _kernels_take(q) else _plain
    out = route(q, k, v, mesh, axis, causal, scale)
    if wrap:
        from ..numpy.multiarray import _wrap
        return _wrap(out)
    return out
