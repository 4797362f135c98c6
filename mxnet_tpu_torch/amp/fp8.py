"""fp8 training with per-tensor delayed scaling.

Counterpart of ``mxnet_tpu/amp/fp8.py``, with the same formulas: Dense
matmuls run e4m3 forward / e5m2 backward with fp32 master weights and an
fp32 accumulator, and every quantization scale is delayed, derived from an
amax history the training step carries, not measured in line.

- ``parallel.ShardedTrainStep(precision="fp8")`` selects the eligible sites
  (:func:`select_sites`), keeps one ``{x, w, g}`` amax history per site
  (:func:`init_state`) and runs its forward under :func:`scope`, which the
  ``gluon.nn.Dense`` forward consults: a Dense whose weight is a site goes
  through :func:`dense_fp8` instead of ``npx.fully_connected``.
- The forward amaxes (max |x|, max |w|) are recorded into the scope. The
  gradient amax exists only in the backward, so :func:`fp8_linear`'s
  backward returns the measured ``max |dy|`` as the "gradient" of its
  otherwise unused ``g_scale`` input, and the step reads it there.
- :func:`roll_state` shifts each history one step and inserts the new
  amax; the scales of step N+1 come from steps <= N only.

The forward product of a CUDA tensor runs the CUDA fp8 kernel
(``ops/quant_matmul.py``), which raises on a card it was not built for; a
CPU tensor's operands are cast through the fp8 grid and multiplied in
fp32, the same values. The backward's two products are fp32
``torch.matmul``s of the fp8 values, as the reference's ``_dot`` is an XLA
dot outside any Pallas kernel.

One difference of interface: the port's ``Parameter.name`` is rewritten by
every ``collect_params()`` call, where the reference's structural name is
fixed at registration, so :class:`scope` also takes the map from each site's
weight tensor to its site name, which the caller captures once.
"""
from __future__ import annotations

import threading

import torch

from .. import config as _config
from ..context import resolve_device
from ..ops.quant_matmul import FP8_FORMATS, fp8_matmul

__all__ = ["FWD_FORMAT", "BWD_FORMAT", "fp8_linear", "dense_fp8",
           "select_sites", "init_state", "scales_from_state", "roll_state",
           "merge_amax", "scope", "current", "record"]

#: training formats per the standard recipe: e4m3 (more mantissa) for
#: activations/weights in the forward, e5m2 (more range) for gradients
FWD_FORMAT = "e4m3"
BWD_FORMAT = "e5m2"

_tls = threading.local()


class _Scope:
    """One forward's fp8 context: site -> (x_scale, w_scale, g_scale),
    weight tensor -> site, and the forward-amax collector."""

    __slots__ = ("scales", "sites", "amax")

    def __init__(self, scales, sites):
        self.scales = scales
        self.sites = sites
        self.amax = {}


class scope:
    """Context manager installing a :class:`_Scope` for the enclosed
    forward; ``Dense.forward`` reads it through :func:`current`.

    scales: {site: (x_scale, w_scale, g_scale)} 0-d fp32 tensors; sites:
    {weight tensor: site name} for every weight that is a site."""

    def __init__(self, scales, sites):
        self._scope = _Scope(scales, sites)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._scope
        return self._scope

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def current():
    """The active fp8 scope, or None."""
    return getattr(_tls, "ctx", None)


def record(site, x_amax, w_amax):
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.amax[site] = (x_amax, w_amax)


# -- quantize ------------------------------------------------------------------

def _qcast(v, scale, fmt):
    """Saturating cast through the fp8 grid: the scale maps the delayed
    amax onto the format's absmax, the clip guards inter-step amax growth
    (so the cast itself never overflows)."""
    dt, fmax = FP8_FORMATS[fmt]
    return torch.clamp(v.float() * scale, -fmax, fmax).to(dt)


# -- the fp8 linear primitive --------------------------------------------------

def _fwd_value(x, w, b, x_scale, w_scale):
    qx = _qcast(x, x_scale, FWD_FORMAT)
    qw = _qcast(w, w_scale, FWD_FORMAT)
    if x.device.type == "cpu":
        y = (qx.float() @ qw.float().t()) / (x_scale * w_scale)
    else:
        # the fused kernel dequantizes as acc * (xs * ws[n]) with the
        # DIVIDE convention, so it gets the reciprocal scales, and the
        # snapped values, which it quantizes again to the same bits; the
        # wrapper raises where the kernel cannot run
        lead = tuple(x.shape[:-1])
        h2 = qx.reshape(-1, x.shape[-1]).float() / x_scale
        inv_ws = torch.full((w.shape[0],), 1.0, dtype=torch.float32,
                            device=w.device) / w_scale
        out = fp8_matmul(h2, qw, inv_ws, 1.0 / x_scale, bias=None,
                         fmt=FWD_FORMAT)
        y = out.reshape(lead + (w.shape[0],))
    if b is not None:
        y = y + b
    return y, qx, qw


class _Fp8Linear(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` pair ``_fp8_linear_fwd`` /
    ``_fp8_linear_bwd``. Saves the fp8 operands, not fp32 copies."""

    @staticmethod
    def forward(ctx, x, w, b, x_scale, w_scale, g_scale):
        y, qx, qw = _fwd_value(x, w, b, x_scale, w_scale)
        ctx.save_for_backward(qx, qw, x_scale, w_scale, g_scale)
        ctx.has_b = b is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        qx, qw, x_scale, w_scale, g_scale = ctx.saved_tensors
        g_amax = dy.abs().amax().float()
        qdy = _qcast(dy, g_scale, BWD_FORMAT)
        # dx = dy @ w: contract dy's N with qw's leading N
        dx = (qdy.float() @ qw.float()) / (g_scale * w_scale)
        # dw = dy^T @ x over the flattened lead dims
        n, k = qw.shape
        dw = (qdy.reshape(-1, n).float().t() @ qx.reshape(-1, k).float()) \
            / (g_scale * x_scale)
        db = (dy.float().sum(dim=tuple(range(dy.ndim - 1)))
              if ctx.has_b else None)
        # zero gradients for the forward scales; g_scale's slot carries the
        # measured gradient amax out of the backward
        zero = torch.zeros((), dtype=torch.float32, device=dy.device)
        return dx, dw, db, zero, zero, g_amax


def fp8_linear(x, w, b, x_scale, w_scale, g_scale):
    """``x @ w.T + b`` through the fp8 grid with delayed scales.

    x: (..., K); w: (N, K) fp32 master; b: (N,) or None; scales: 0-d fp32
    tensors (fmt_absmax / delayed_amax). ``g_scale`` does not affect the
    value: the backward quantizes dy with it (e5m2), and returns the
    measured ``max |dy|`` as its gradient."""
    return _Fp8Linear.apply(x, w, b, x_scale, w_scale, g_scale)


def dense_fp8(x, w, b, site, flatten=False):
    """The Dense-forward entry: record the forward amaxes into the active
    scope and run :func:`fp8_linear` with the site's delayed scales."""
    ctx = current()
    xs, ws, gs = ctx.scales[site]
    h = x.reshape(x.shape[0], -1) if flatten and x.ndim > 2 else x
    record(site, h.detach().abs().amax().float(),
           w.detach().abs().amax().float())
    return fp8_linear(h, w, b, xs, ws, gs)


# -- delayed-scaling state -----------------------------------------------------

def select_sites(shapes):
    """Site names eligible for fp8: 2-D ``*.weight`` parameters of at
    least ``amp.fp8_min_elems`` elements, sorted for a deterministic state
    layout."""
    floor = int(_config.get("amp.fp8_min_elems"))
    out = []
    for name, shape in shapes.items():
        if not name.endswith(".weight") and name != "weight":
            continue
        if len(shape) != 2:
            continue
        if int(shape[0]) * int(shape[1]) < floor:
            continue
        out.append(name)
    return sorted(out)


def init_state(sites, history=None, device=None):
    """Fresh amax histories on ``device`` (``cuda:0`` by default):
    {site: {"x"|"w"|"g": zeros(H,)}}. All-zero means "no observation yet";
    :func:`scales_from_state` maps that to scale 1.0."""
    if history is None:
        history = int(_config.get("amp.fp8_history"))
    h = max(1, int(history))
    device = resolve_device(device)
    return {site: {k: torch.zeros((h,), dtype=torch.float32, device=device)
                   for k in ("x", "w", "g")}
            for site in sites}


def _scale(hist, fmax, margin):
    amax = hist.max() * margin
    # a true division: ``number / tensor`` is reciprocal() * number in torch
    fmax = amax.new_tensor(fmax)
    return torch.where(amax > 0.0, fmax / torch.clamp(amax, min=1e-30),
                       torch.ones_like(amax))


def scales_from_state(state, margin=None):
    """{site: (x_scale, w_scale, g_scale)} from the carried histories:
    scale = fmt_absmax / (margin * max(history))."""
    if margin is None:
        margin = float(_config.get("amp.fp8_margin"))
    _, fwd_max = FP8_FORMATS[FWD_FORMAT]
    _, bwd_max = FP8_FORMATS[BWD_FORMAT]
    return {site: (_scale(h["x"], fwd_max, margin),
                   _scale(h["w"], fwd_max, margin),
                   _scale(h["g"], bwd_max, margin))
            for site, h in state.items()}


def roll_state(state, fwd_amax, g_amax):
    """Shift every history one step and insert the step's measured amax
    at slot 0. Sites the forward never reached keep their history."""
    new = {}
    for site, h in state.items():
        upd = dict(h)
        if site in fwd_amax:
            xa, wa = fwd_amax[site]
            upd["x"] = torch.cat([xa.reshape(1), h["x"][:-1]])
            upd["w"] = torch.cat([wa.reshape(1), h["w"][:-1]])
        if site in g_amax:
            upd["g"] = torch.cat([g_amax[site].reshape(1), h["g"][:-1]])
        new[site] = upd
    return new


def _max_tree(a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_max_tree(u, v) for u, v in zip(a, b))
    return torch.maximum(a, b)


def merge_amax(a, b):
    """Elementwise max-merge of two amax observations (grad_accum
    microbatches roll the history once with the max over the scan)."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _max_tree(out[k], v) if k in out else v
    return out
