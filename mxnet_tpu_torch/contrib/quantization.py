"""INT8 post-training quantization: ``quantize_net`` and its calibration.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference:
python/mxnet/contrib/quantization.py): ``quantize_net`` calibrates the
input range of every target layer over ``calib_data`` ('naive' abs-max,
'entropy' KL threshold, 'percentile') and returns a deep copy of the
network whose ``Dense`` layers are replaced by :class:`QuantizedDense`,
whose forward is one ``npx.quantized_dense_fused`` (on the card the
hand-written int8 kernel, ``csrc/int8_matmul.cu``), and whose forward
convolutions are replaced by :class:`QuantizedConv`, whose forward is one
``npx.quantized_conv_fused`` (the int8 products summed exactly; the
reference has no Pallas conv kernel).

    qnet = quantize_net(net, calib_data=batches, calib_mode="naive")
    y = qnet(x)          # every Dense and conv runs int8 x int8 -> int32

The calibration functions (``_Stats``, ``optimal_threshold``,
``_percentile_threshold``, ``_quantize_weight``) are the JAX package's
numpy code, copied, so thresholds and int8 weights agree bit for bit.
Calibration hooks are torch forward pre-hooks, removed through their
handles; in 'naive' mode the abs-max stays on the device until the
calibration batches are through. The calibration forwards run in
inference, so an ``nn.FusableSequential`` calls its children and every
conv's hook sees its input.
"""
from __future__ import annotations

import copy
import logging

import numpy as onp
import torch

from ..numpy_extension import tensor_ops as npx
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Constant

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv",
           "optimal_threshold"]

_INT8_MAX = 127.0


# --------------------------------------------------------------------------
# calibration collectors
# --------------------------------------------------------------------------

class _Stats:
    """Per-layer input statistics: abs-max always; histogram for
    entropy/percentile modes (reference: _LayerHistogramCollector)."""

    def __init__(self, num_bins=2048):
        self.num_bins = num_bins
        self.abs_max = 0.0
        self.hist = None
        self.hist_edges = None

    def update(self, arr: onp.ndarray, want_hist: bool):
        a = onp.abs(arr.astype(onp.float32)).ravel()
        m = float(a.max()) if a.size else 0.0
        if m > self.abs_max:
            self.abs_max = m
            if self.hist is not None:
                # re-bin the existing histogram into the wider range
                old_centers = 0.5 * (self.hist_edges[:-1]
                                     + self.hist_edges[1:])
                new_hist, new_edges = onp.histogram(
                    old_centers, bins=self.num_bins, range=(0, m),
                    weights=self.hist)
                self.hist, self.hist_edges = new_hist, new_edges
        if want_hist:
            h, edges = onp.histogram(a, bins=self.num_bins,
                                     range=(0, self.abs_max or 1e-8))
            if self.hist is None:
                self.hist, self.hist_edges = h.astype(onp.float64), edges
            else:
                self.hist += h


def _smooth_distribution(p, eps=0.0001):
    """Move a little mass onto zero entries so KL is finite (reference:
    contrib/quantization.py _smooth_distribution)."""
    is_zeros = (p == 0).astype(onp.float64)
    is_nonzeros = (p != 0).astype(onp.float64)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        raise ValueError("all-zero distribution")
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    return p.astype(onp.float64) + eps * is_zeros - eps1 * is_nonzeros


def _kl(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float((p[mask] * onp.log(p[mask] / q[mask])).sum())


def optimal_threshold(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence-minimizing threshold (reference:
    contrib/quantization.py _get_optimal_threshold /
    src/operator/quantization/calibrate.cc).

    `hist` is a histogram of |x| over [0, max].  For each candidate i the
    first i bins are taken as the reference distribution P (outlier mass
    clipped into the last bin) and Q is P merged down to
    num_quantized_bins levels and re-expanded; the i minimizing KL(P||Q)
    gives the threshold.
    """
    hist = onp.asarray(hist, onp.float64)
    n = len(hist)
    if hist.sum() == 0:
        return float(hist_edges[-1])
    best_kl, best_i = onp.inf, n
    for i in range(num_quantized_bins, n + 1):
        sliced = hist[:i]
        p = sliced.copy()
        p[i - 1] += hist[i:].sum()           # clip outliers into last bin
        is_nonzero = sliced != 0
        num_merged = i // num_quantized_bins
        q = onp.zeros(i, onp.float64)
        for j in range(num_quantized_bins):
            start = j * num_merged
            stop = i if j == num_quantized_bins - 1 \
                else (j + 1) * num_merged
            norm = is_nonzero[start:stop].sum()
            if norm:
                q[start:stop] = sliced[start:stop].sum() / norm
        q[~is_nonzero] = 0
        try:
            p = _smooth_distribution(p)
            q = _smooth_distribution(q)
        except ValueError:
            continue
        kl = _kl(p, q)
        if kl < best_kl:
            best_kl, best_i = kl, i
    return float(hist_edges[best_i])


def _percentile_threshold(hist, hist_edges, percentile=99.99):
    c = onp.cumsum(hist)
    if c[-1] == 0:
        return float(hist_edges[-1])
    idx = onp.searchsorted(c, c[-1] * percentile / 100.0)
    return float(hist_edges[min(idx + 1, len(hist_edges) - 1)])


# --------------------------------------------------------------------------
# quantized layer blocks
# --------------------------------------------------------------------------

def _quantize_weight(w: onp.ndarray):
    """Symmetric per-output-channel int8 (axis 0 = output channels)."""
    flat = onp.abs(w.reshape(w.shape[0], -1)).max(axis=1)
    scale = onp.maximum(flat, 1e-12) / _INT8_MAX
    q = onp.clip(onp.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                 -_INT8_MAX, _INT8_MAX).astype(onp.int8)
    return q, scale.astype(onp.float32)


def _fusable_act(act):
    """The layer's activation type when the fused epilogue can absorb it
    (see ops.quantization.FUSED_ACTS), else None — the Activation block
    then runs as a separate op after the fused matmul."""
    from ..ops.quantization import FUSED_ACTS
    t = getattr(act, "_act_type", None)
    return t if t in FUSED_ACTS else None


class QuantizedDense(HybridBlock):
    """int8 replacement for nn.Dense (reference:
    quantized_fully_connected.cc as rewritten by quantize_net).

    Its parameters are :class:`Constant` s on the layer's device, under the
    reference's names: ``qweight`` (int8, per output channel), ``w_scale``
    (fp32) and ``bias_c`` (fp32, or None). The forward is one
    ``npx.quantized_dense_fused`` with ``x_scale = threshold / 127`` and
    the layer's activation in the epilogue where it fuses."""

    def __init__(self, dense: nn.Dense, threshold: float):
        super().__init__()
        dev = dense.weight.device
        q, scale = _quantize_weight(dense.weight.detach().cpu().numpy())
        self.qweight = Constant(q, name="qweight", device=dev).data()
        self.w_scale = Constant(scale, name="w_scale", device=dev).data()
        self.bias_c = (Constant(dense.bias.detach().cpu(), name="bias",
                                device=dev).data()
                       if dense.bias is not None else None)
        self.threshold = float(threshold)
        self._units = dense._units
        self._flatten = dense._flatten
        self.act = dense.act
        self._fused_act = _fusable_act(dense.act)

    def forward(self, x):
        out = npx.quantized_dense_fused(
            x, self.qweight, self.threshold / _INT8_MAX, self.w_scale,
            bias=self.bias_c, act=self._fused_act, flatten=self._flatten)
        if self.act is not None and self._fused_act is None:
            out = self.act(out)
        return out

    def extra_repr(self):
        return f"{self._units}, T={self.threshold:.4g}"


class QuantizedConv(HybridBlock):
    """int8 replacement for a forward convolution (reference:
    quantized_conv.cc as rewritten by quantize_net): the :class:`Constant`
    s ``qweight`` (int8, per output channel), ``w_scale`` and ``bias_c``
    as :class:`QuantizedDense`'s, and the conv's own geometry. The forward
    is one ``npx.quantized_conv_fused`` with ``x_scale = threshold / 127``
    and the conv's activation in the epilogue where it fuses."""

    def __init__(self, conv, threshold: float):
        super().__init__()
        if conv._op_name != "convolution":
            raise MXNetError("only forward convolutions quantize")
        dev = conv.weight.device
        q, scale = _quantize_weight(conv.weight.detach().cpu().numpy())
        self.qweight = Constant(q, name="qweight", device=dev).data()
        self.w_scale = Constant(scale, name="w_scale", device=dev).data()
        self.bias_c = (Constant(conv.bias.detach().cpu(), name="bias",
                                device=dev).data()
                       if conv.bias is not None else None)
        self.threshold = float(threshold)
        self._conv_cfg = dict(kernel=conv._kernel, stride=conv._strides,
                              dilate=conv._dilation, pad=conv._padding,
                              num_filter=conv._channels,
                              num_group=conv._groups, layout=conv._layout)
        self.act = conv.act
        self._fused_act = _fusable_act(conv.act)

    def forward(self, x):
        out = npx.quantized_conv_fused(
            x, self.qweight, self.threshold / _INT8_MAX, self.w_scale,
            bias=self.bias_c, act=self._fused_act, **self._conv_cfg)
        if self.act is not None and self._fused_act is None:
            out = self.act(out)
        return out

    def extra_repr(self):
        cfg = self._conv_cfg
        return (f"{cfg['num_filter']}, kernel={cfg['kernel']}, "
                f"T={self.threshold:.4g}")


# --------------------------------------------------------------------------
# quantize_net
# --------------------------------------------------------------------------

def _walk_layers(block, prefix=""):
    """Yield (parent, child_key, structural_path, layer)."""
    for key, child in list(block._modules.items()):
        if child is None:
            continue
        path = f"{prefix}{key}"
        yield block, key, path, child
        yield from _walk_layers(child, path + ".")


def _is_target(layer):
    return isinstance(layer, nn.Dense) or (
        isinstance(layer, nn.conv_layers._Conv)
        and layer._op_name == "convolution")


def _first_array(batch):
    if isinstance(batch, (list, tuple)):
        return batch[0]
    return batch


def quantize_net(network, quantized_dtype="int8", exclude_layers=None,
                 exclude_layers_match=None, calib_data=None,
                 calib_mode="naive", num_calib_batches=None, logger=None):
    """Quantize a Gluon network's Dense and Conv layers to int8.

    Mirrors the reference `mx.contrib.quantization.quantize_net`: calibrates
    activation ranges over `calib_data` (an iterable of input batches or
    (data, ...) tuples, of which the first array is fed) with `calib_mode`
    in {'naive', 'entropy', 'percentile'}, then returns a **new** network
    (deep copy) whose targeted layers are replaced by QuantizedDense or
    QuantizedConv. The original network comes back unchanged.
    `exclude_layers` (structural paths) and `exclude_layers_match`
    (substrings of them) keep layers in fp32; `num_calib_batches` caps the
    calibration batches.
    """
    if quantized_dtype != "int8":
        raise NotImplementedError("the port quantizes to int8 only")
    if calib_mode not in ("naive", "entropy", "percentile"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    if calib_data is None:
        raise MXNetError("calib_data is required (post-training "
                         "quantization calibrates activation ranges)")
    log = logger or logging.getLogger(__name__)
    exclude_layers = set(exclude_layers or [])

    targets = {}
    for parent, key, path, layer in _walk_layers(network):
        if not _is_target(layer):
            continue
        if path in exclude_layers:
            continue
        if exclude_layers_match and any(m in path
                                        for m in exclude_layers_match):
            continue
        targets[path] = layer

    # -- calibration pass (hooks collect layer-input stats) ---------------
    want_hist = calib_mode in ("entropy", "percentile")
    stats = {path: _Stats() for path in targets}
    dev_max = {}  # 'naive': running max |x| per layer, on the device

    def mk(path):
        def hook(block, args):
            x = args[0].detach()
            if want_hist:
                stats[path].update(x.cpu().numpy(), True)
            elif x.numel():
                m = x.float().abs().max()
                prev = dev_max.get(path)
                # fmax skips a NaN batch, as the reference's `m > abs_max`
                dev_max[path] = m if prev is None else torch.fmax(prev, m)
        return hook

    handles = []
    try:
        for path, layer in targets.items():
            handles.append(layer.register_forward_pre_hook(mk(path)))
        for i, batch in enumerate(calib_data):
            if num_calib_batches is not None and i >= num_calib_batches:
                break
            network(_first_array(batch))
    finally:
        for h in handles:
            h.remove()
    for path, m in dev_max.items():
        stats[path].update(m.reshape(1).cpu().numpy(), False)

    thresholds = {}
    for path, st in stats.items():
        if st.abs_max == 0.0:
            log.warning("layer %s saw no calibration data; skipping", path)
            continue
        if calib_mode == "naive":
            thresholds[path] = st.abs_max
        elif calib_mode == "entropy":
            thresholds[path] = optimal_threshold(st.hist, st.hist_edges)
        else:
            thresholds[path] = _percentile_threshold(st.hist, st.hist_edges)
        log.debug("calibrated %s: T=%.5g (absmax %.5g)", path,
                  thresholds[path], st.abs_max)

    # -- rewrite on a deep copy -------------------------------------------
    qnet = copy.deepcopy(network)
    replaced = 0
    for parent, key, path, layer in list(_walk_layers(qnet)):
        if path not in thresholds or not _is_target(layer):
            continue
        cls = QuantizedDense if isinstance(layer, nn.Dense) \
            else QuantizedConv
        q = cls(layer, thresholds[path])
        q.initialize()
        setattr(parent, key, q)  # nn.Module keeps the child's place
        replaced += 1
    log.info("quantized %d/%d target layers", replaced, len(targets))
    if targets and replaced == 0:
        # returning an unquantized copy as "success" would be a silent
        # no-op (the iterable was empty or produced zero data)
        raise MXNetError(
            "quantize_net calibrated 0 of "
            f"{len(targets)} target layers: calib_data was empty or "
            "yielded all-zero batches.")
    return qnet
