"""The fused multi-layer RNN of ``npx.rnn`` and ``gluon.rnn``'s layers.

Counterpart of ``npx.rnn`` in ``mxnet_tpu/numpy_extension/__init__.py``
(a ``lax.scan`` over time, outside any Pallas kernel; reference:
src/operator/rnn-inl.h, the cuDNN fused path). Modes ``lstm`` (gates
i, f, g, o), ``gru`` (r, z, n with n = tanh(Wx x + bx + r * (Wh h + bh))),
``rnn_tanh`` and ``rnn_relu``, any number of layers, one or two
directions; the reverse direction reads the sequence backwards and its
outputs are flipped back, and the directions' outputs are concatenated.

The weights come as one ``(wx, wh, bx, bh)`` tuple per layer and
direction, layer-major (:func:`unpack` cuts them from the reference's
flat vector: every ``[Wx, Wh]`` first, then every ``[bx, bh]``), so the
Gluon layers hand their own Parameters over without building that vector.

Two routes, chosen by :func:`route` before anything launches:

- ``"cudnn"``: PyTorch's cuDNN RNN (``torch._VF.lstm`` / ``gru`` /
  ``rnn_tanh`` / ``rnn_relu``) on a CUDA tensor whose dtype cuDNN's RNN
  takes (``torch.backends.cudnn.is_acceptable``: fp32, fp16, fp64) with
  every weight in that dtype and no LSTM state clip. The reference's op is
  not a Pallas kernel, so a library call stands in for it, as the port's
  convolutions do. A cuDNN failure raises: nothing falls back.
- ``"plain"``: the loop over time in PyTorch ops, the CPU path and the
  oracle: the input projection of every step in one product, then per
  step the recurrent product and the gates. It takes the LSTM state clip
  (cuDNN has none) and bf16 (cuDNN's RNN does not).

The route does not depend on whether the current stream captures a CUDA
graph: cuDNN's RNN forward and backward capture (a hybridized block's
graphs), and a capture must take the route of the eager warm-up before it,
whose calls set up the libraries the capture then uses (a cuBLAS handle
made during a capture fails the capture).

:data:`route_calls` counts the calls of each route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["GATES", "unpack", "route", "rnn", "rnn_plain", "rnn_cudnn",
           "route_calls"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}

#: calls of each route
route_calls = {"cudnn": 0, "plain": 0}


def unpack(params, mode, state_size, num_layers, bidirectional, input_size):
    """Views ``(wx, wh, bx, bh)`` per layer and direction of the flat
    vector ``params`` packed as the reference packs it (rnn-inl.h
    GetRnnParamSize): all weights layer-major, then all biases."""
    ng, h = GATES[mode], state_size
    ndir = 2 if bidirectional else 1
    need = sum(ndir * ng * h * ((input_size if layer == 0 else h * ndir)
                                + h + 2) for layer in range(num_layers))
    if need != params.numel():
        raise MXNetError(f"npx.rnn: parameters hold {params.numel()} values, "
                         f"mode {mode!r} with these sizes needs {need}")
    ws, off = [], 0
    for layer in range(num_layers):
        cur = input_size if layer == 0 else h * ndir
        for _ in range(ndir):
            wx = params[off:off + ng * h * cur].view(ng * h, cur)
            off += ng * h * cur
            wh = params[off:off + ng * h * h].view(ng * h, h)
            off += ng * h * h
            ws.append([wx, wh])
    for w in ws:
        w.append(params[off:off + ng * h])
        w.append(params[off + ng * h:off + 2 * ng * h])
        off += 2 * ng * h
    return [tuple(w) for w in ws]


def route(x, weights, mode, clip):
    """The route of one call, from the device, the dtypes and the state
    clip."""
    if x.device.type != "cuda" or clip:
        return "plain"
    if not torch.backends.cudnn.is_acceptable(x) \
            or any(t.dtype != x.dtype for w in weights for t in w):
        return "plain"
    return "cudnn"


def _step(mode, xw, h, c, wh, bh, clip_min, clip_max):
    """One step: ``xw`` is the step's input projection with its bias."""
    hw = F.linear(h, wh, bh)
    if mode == "gru":
        xr, xz, xn = xw.chunk(3, -1)
        hr, hz, hn = hw.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, None
    g = xw + hw
    if mode == "rnn_relu":
        return torch.relu(g), None
    if mode == "rnn_tanh":
        return torch.tanh(g), None
    i, f, gg, o = g.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    if clip_min is not None:
        c = torch.clamp(c, clip_min, clip_max)
    return torch.sigmoid(o) * torch.tanh(c), c


def rnn_plain(x, weights, h0, c0, mode, num_layers, bidirectional,
              clip_min=None, clip_max=None):
    """The loop over time (see the module docstring); returns ``(out, hT,
    cT)`` with ``cT`` None outside lstm."""
    ndir = 2 if bidirectional else 1
    inp = x
    h_fin, c_fin = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            li = layer * ndir + d
            wx, wh, bx, bh = weights[li]
            seq = inp if d == 0 else inp.flip(0)
            xw = F.linear(seq, wx, bx)
            h = h0[li]
            c = c0[li] if c0 is not None else None
            ys = []
            for t in range(seq.shape[0]):
                h, c = _step(mode, xw[t], h, c, wh, bh, clip_min, clip_max)
                ys.append(h)
            y = torch.stack(ys) if ys else xw.new_zeros(
                (0,) + tuple(h.shape))
            outs.append(y if d == 0 else y.flip(0))
            h_fin.append(h)
            c_fin.append(c)
        inp = torch.cat(outs, -1) if ndir == 2 else outs[0]
    c_t = torch.stack(c_fin) if mode == "lstm" else None
    return inp, torch.stack(h_fin), c_t


def rnn_cudnn(x, weights, h0, c0, mode, num_layers, bidirectional):
    """The cuDNN RNN on the same weights (no dropout between layers, as
    the reference's op, which never reads ``p``)."""
    flat = [t for w in weights for t in w]
    train = torch.is_grad_enabled() and (
        x.requires_grad or h0.requires_grad
        or (c0 is not None and c0.requires_grad)
        or any(t.requires_grad for t in flat))
    if mode == "lstm":
        out, h, c = torch._VF.lstm(x, (h0, c0), flat, True, num_layers, 0.0,
                                   train, bidirectional, False)
        return out, h, c
    fn = getattr(torch._VF, mode)
    out, h = fn(x, h0, flat, True, num_layers, 0.0, train, bidirectional,
                False)
    return out, h, None


def rnn(x, weights, h0, c0, mode, num_layers, bidirectional,
        clip_min=None, clip_max=None):
    """``(out, hT, cT)`` of the RNN over ``x`` (seq, batch, input) by the
    route :func:`route` picks."""
    if mode not in GATES:
        raise MXNetError(f"npx.rnn: unknown mode {mode!r}")
    if (mode == "lstm") != (c0 is not None):
        raise MXNetError("npx.rnn: mode 'lstm' takes state_cell, and only "
                         "it does")
    clip = mode == "lstm" and clip_min is not None
    r = route(x, weights, mode, clip)
    route_calls[r] += 1
    if r == "cudnn":
        return rnn_cudnn(x, weights, h0, c0, mode, num_layers,
                         bidirectional)
    return rnn_plain(x, weights, h0, c0, mode, num_layers, bidirectional,
                     clip_min if clip else None, clip_max if clip else None)
