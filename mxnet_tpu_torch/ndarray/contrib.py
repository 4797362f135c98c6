"""``mx.nd.contrib``: the contrib operator namespace.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (reference parity:
python/mxnet/ndarray/contrib.py, the control-flow helpers ``foreach`` /
``while_loop`` / ``cond``, and the contrib C++ ops: FFT, real (N, d) ->
interleaved real/imag (N, 2d), src/operator/contrib/fft-inl.h; the DGL
graph-sampling family, src/operator/contrib/dgl_graph.cc). The FFT runs
``torch.fft`` on the array's device; the DGL samplers run on the host
(their output sizes depend on the data, as the reference's CPU-only
implementations do). Any other name falls back to ``npx`` (the
``MultiBox*`` CamelCase names included).
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError
from ..numpy.multiarray import _wrap, array, ndarray


def _raw(x):
    return x._data if isinstance(x, ndarray) else torch.as_tensor(x)


# -- control flow (reference: ndarray/contrib.py foreach / while_loop / cond) ------

def foreach(body, data, init_states):
    from .. import numpy_extension as npx
    return npx.foreach(body, data, init_states)


def while_loop(cond, func, loop_vars, max_iterations=None):
    from .. import numpy_extension as npx
    return npx.while_loop(cond, func, loop_vars,
                          max_iterations=max_iterations)


def cond(pred, then_func, else_func):
    from .. import numpy_extension as npx
    return npx.cond(pred, then_func, else_func)


# -- FFT (reference: src/operator/contrib/fft-inl.h) -------------------------------

def fft(data, compute_size=128):
    """1-D FFT over the last axis: real (..., d) -> (..., 2d) interleaved
    [re0, im0, re1, im1, ...] (the reference's cuFFT layout), float32."""
    x = _raw(data)
    spec = torch.fft.fft(x.to(torch.complex64), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return _wrap(out.reshape(x.shape[:-1] + (2 * x.shape[-1],))
                 .to(torch.float32))


def ifft(data, compute_size=128):
    """The inverse of :func:`fft`: (..., 2d) interleaved -> real (..., d),
    unnormalized as cuFFT's inverse (``ifft(fft(x)) = d * x``)."""
    x = _raw(data)
    d = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (d, 2)).to(torch.float32)
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return _wrap((torch.fft.ifft(spec, dim=-1).real * d).to(torch.float32))


# -- DGL graph sampling (reference: src/operator/contrib/dgl_graph.cc) -------------

def _graph(csr):
    from .sparse import CSRNDArray
    if not isinstance(csr, CSRNDArray):
        raise MXNetError("expects a CSRNDArray graph")
    return csr.indptr.asnumpy(), csr.indices.asnumpy()


def _subgraph_csr(verts, indptr, indices, device):
    """The induced subgraph over ``verts`` (relabelled 0..n-1), ones as
    data, as a ``CSRNDArray``."""
    from .sparse import CSRNDArray
    pos = {int(v): i for i, v in enumerate(verts)}
    data, idx, ptr = [], [], [0]
    for v in verts:
        nbrs = sorted(pos[int(u)] for u in indices[indptr[v]:indptr[v + 1]]
                      if int(u) in pos)
        idx.extend(nbrs)
        data.extend([1.0] * len(nbrs))
        ptr.append(len(idx))
    return CSRNDArray(array(onp.asarray(data, "float32"), ctx=device),
                      onp.asarray(idx, "int64"), onp.asarray(ptr, "int64"),
                      (len(verts), len(verts)))


def dgl_csr_neighbor_uniform_sample(csr, seeds, num_hops=1, num_neighbor=2,
                                    max_num_vertices=100):
    """Uniform neighbor sampling from a CSR graph (reference:
    ``_contrib_dgl_csr_neighbor_uniform_sample``): ``(sampled_vertices,
    subgraph_csr, layer_ids)``; the vertices padded with -1 to
    ``max_num_vertices``, their count in the last slot. The neighbors are
    drawn from NumPy's global generator, as the reference draws them."""
    indptr, indices = _graph(csr)
    device = csr.data._data.device
    seed_ids = onp.asarray(_raw(seeds).cpu()).astype("int64").ravel()
    seed_ids = seed_ids[seed_ids >= 0]
    cap = max_num_vertices - 1
    # the seeds are admitted first and the cap is held during expansion,
    # so no seed is truncated out of the sample
    visited = {}
    for v in seed_ids[:cap]:
        visited[int(v)] = 0
    frontier = list(visited)
    for hop in range(1, num_hops + 1):
        nxt = []
        for v in frontier:
            nbrs = indices[indptr[v]:indptr[v + 1]]
            if len(nbrs) == 0:
                continue
            chosen = onp.random.choice(nbrs, size=min(num_neighbor,
                                                      len(nbrs)),
                                       replace=False)
            for u in chosen:
                u = int(u)
                if u not in visited and len(visited) < cap:
                    visited[u] = hop
                    nxt.append(u)
        frontier = nxt
        if len(visited) >= cap:
            break
    verts = sorted(visited)
    n_valid = len(verts)
    out_ids = onp.full((max_num_vertices,), -1, "int64")
    out_ids[:n_valid] = verts
    out_ids[-1] = n_valid      # the reference's count in the last slot
    layers = onp.full((max_num_vertices,), -1, "int64")
    layers[:n_valid] = [visited[v] for v in verts]
    return (array(out_ids, ctx=device),
            _subgraph_csr(verts, indptr, indices, device),
            array(layers, ctx=device))


def dgl_adjacency(csr):
    """The CSR adjacency with all-ones data (reference:
    ``_contrib_dgl_adjacency``)."""
    from .sparse import CSRNDArray
    _graph(csr)
    return CSRNDArray(torch.ones_like(csr.data._data, dtype=torch.float32),
                      csr.indices, csr.indptr, csr.shape)


def dgl_subgraph(graph, *vids, return_mapping=False):
    """The induced subgraph of each vertex set (reference:
    ``_contrib_dgl_subgraph``)."""
    indptr, indices = _graph(graph)
    device = graph.data._data.device
    outs = []
    for vid in vids:
        ids = onp.asarray(_raw(vid).cpu()).astype("int64").ravel()
        outs.append(_subgraph_csr(ids[ids >= 0], indptr, indices, device))
    return outs[0] if len(outs) == 1 else outs


_CAMEL = {
    # the legacy contrib CamelCase names (reference: _contrib_MultiBox*
    # surfaced as mx.nd.contrib.MultiBoxPrior, ...)
    "MultiBoxPrior": "multibox_prior",
    "MultiBoxTarget": "multibox_target",
    "MultiBoxDetection": "multibox_detection",
    "BipartiteMatching": "bipartite_matching",
}


def __getattr__(name):
    """The npx operator surface: the reference exposes every
    ``_contrib_*`` op here (box_nms, box_iou, multibox_*, ...)."""
    from .. import numpy_extension as _npx
    fn = getattr(_npx, _CAMEL.get(name, name), None)
    if fn is not None:
        return fn
    raise AttributeError(f"mxnet.ndarray.contrib has no op '{name}'")
