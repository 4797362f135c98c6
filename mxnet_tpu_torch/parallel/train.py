"""The training step of ``parallel``, data parallel over the process group.

Counterpart of ``mxnet_tpu/parallel/train.py`` (``ShardedTrainStep``,
``FunctionalOptimizer``, ``scan_steps``) over ``dp``. The reference
compiles forward, backward, reduce and update into one jitted program
over a mesh; here every rank is one process running them eagerly on its
own device, and the reduce is a collective of ``parallel.collectives``:

1. every rank passes the same GLOBAL batch (as the reference's
   ``__call__`` takes it) and keeps its part: each array's dimension
   named 'dp' by ``batch_specs`` cut into dp equal blocks (after the
   leading ``steps_per_call`` / ``grad_accum`` axes); a batch from
   :meth:`prefetch` is already this rank's;
2. the optimizer's ``num_update`` advances by ``steps_per_call`` on the
   host, and every update of the call takes the learning rate
   ``lr_scheduler(num_update + 1)`` (or ``lr``) and its own count ``t``;
3. per microbatch (``grad_accum`` K of them): under "fp8" the scales come
   from the amax histories, ``loss = loss_fn(block(*inputs), *labels)``
   (this rank's mean) under ``autograd.record()``, with ``remat``
   through ``gluon.block.remat_scope`` (each layer of the block's
   ``layer<N>`` family checkpointed on its own), then the backward; at
   dp > 1 BatchNorm takes the global batch's statistics
   (``collectives.sync_batch_stats``);
4. the gradients become the dp mean: each rank differentiates its loss /
   dp (the global mean's share, so dy is the reference's), the
   microbatches' gradients are summed, then one all-reduce (zero 0) or
   reduce-scatter (zero 1) of the flat buffer sums them over the ranks,
   / K; at ``zero=2`` each microbatch's gradients are reduce-scattered
   into the dp-sharded accumulator at once; with
   ``grad_compress`` each microbatch's gradients go through
   ``compressed_allreduce`` bucket by bucket (``comm.bucket_mb``),
   carrying the error-feedback residual;
5. the update is the optimizer's own rule (``_update_impl``, as
   ``FunctionalOptimizer.update`` does): on the whole weights in place
   (zero 0), or on this rank's flat padded shard of each weight, whose
   state lives only in that shard, and an all-gather of the new weights
   (zero 1, 2; ``_flat_pad`` of the reference). Every rank ends with the
   same weights, bit for bit;
6. under "fp8" the amaxes are the max over the ranks (the reference's
   amax is over the global tensor) and the histories roll once per
   update; the returned loss is the mean over the ranks (and over a
   call's updates).

``state_dict`` / ``load_state_dict`` / ``save_states`` / ``load_states``
use the reference's canonical gathered layout (``trainable/``, ``aux/``,
``state/<name>/<i>``, ``fp8/``, ``efresid/`` = the residuals summed over
the ranks), so a bundle moves between world sizes, ZeRO levels and the
two packages (:meth:`load_reference_state_dict`). With telemetry on, each
call feeds the reference's ``zero.*``, ``mesh.dp_gradient_bytes_total``,
``mesh.collective_bytes_total{axis="dp"}`` and ``comm.*`` counters with
its arithmetic. Tensor, pipeline and sequence parallelism
(``param_specs``, a tp / pp / sp axis), ``rebuild`` and ``autotune`` are
slice 22 of the port and raise.

Dropout: each rank draws from its own device's default generator, which
``mx.random.seed(s)`` seeds alike on every rank; seed each rank apart
(``seed + rank``) for independent masks across the global batch.

The host planes, as the reference's step feeds them: with the flight
recorder armed, each call sets the bundle context's ``step``; with
mx.insight on, the first call's cost is counted and registered as
``parallel.train_step``, and every call feeds ``insight.note_step``.
"""
from __future__ import annotations

import contextlib

import numpy as onp
import torch

from .. import autograd as _autograd
from .. import blackbox as _blackbox
from .. import config as _config
from .. import insight as _insight
from .. import telemetry as _telemetry
from ..amp import fp8 as _fp8
from ..base import MXNetError
from . import collectives as _coll
from .mesh import P, Mesh, MeshConfig, _dp_dim  # noqa: F401 (P)

__all__ = ["FunctionalOptimizer", "ShardedTrainStep", "scan_steps"]

_telemetry.declare_metric(
    "zero.reduce_scatter_bytes_total", "counter",
    "logical bytes reduce-scattered over the dp axis by ZeRO gradient "
    "partitioning (per optimizer update, padded flat layout)")
_telemetry.declare_metric(
    "zero.all_gather_bytes_total", "counter",
    "logical bytes all-gathered over the dp axis re-assembling ZeRO-updated "
    "parameters")
_telemetry.declare_metric(
    "zero.collective_bytes_total", "counter",
    "per-op breakdown of the ZeRO dp collectives, labeled "
    "op=reduce_scatter|all_gather")
_telemetry.declare_metric(
    "mesh.dp_gradient_bytes_total", "counter",
    "logical gradient bytes reduced over the dp axis per optimizer update "
    "(total trainable bytes)")
_telemetry.declare_metric(
    "mesh.collective_bytes_total", "counter",
    "per-axis logical collective bytes of the training step, labeled "
    "axis=dp; WIRE bytes at the compressed width when gradient "
    "compression is on")
_telemetry.declare_metric(
    "comm.compressed_bytes_total", "counter",
    "dp gradient bytes placed on the wire by error-feedback compression "
    "(int8 / bf16 payload + one fp32 scale per bucket per rank)")
_telemetry.declare_metric(
    "comm.uncompressed_bytes_total", "counter",
    "dp gradient bytes that would have moved without compression (fp32 "
    "per-microbatch reduce)")


class FunctionalOptimizer:
    """An Optimizer's update rule applied by name, outside
    ``Optimizer.update`` (reference: ``FunctionalOptimizer``): states key
    by structural name, and the step's count ``t`` and learning rate come
    from the caller. Updates the weights and states in place."""

    def __init__(self, optimizer):
        self.opt = optimizer

    def init(self, params):
        """{name: state} from ``create_state(name, weight)``."""
        return {name: self.opt.create_state(name, w)
                for name, w in params.items()}

    @torch.no_grad()
    def update(self, params, grads, states, lr, t):
        self.opt.num_update = t
        for name, g in grads.items():
            self.opt._update_impl(name, params[name], g, states[name], lr,
                                  self.opt._get_wd(name))


def scan_steps(step_fn, n_state):
    """K training steps in one call (reference: ``scan_steps`` over
    ``lax.scan``): ``step_fn(*state, *batch) -> (*state', metric)`` becomes
    ``loop(*state, *stacked) -> (*state', metric_mean)``, each array of
    ``stacked`` with a leading steps axis; here a plain loop."""

    def loop(*args):
        state, batches = list(args[:n_state]), args[n_state:]
        metrics = []
        for i in range(len(batches[0]) if batches else 0):
            out = step_fn(*state, *(b[i] for b in batches))
            state = list(out[:n_state])
            metrics.append(out[-1])
        return (*state, torch.mean(torch.stack(
            [torch.as_tensor(m, dtype=torch.float32) for m in metrics])))

    return loop


def _later(what):
    raise MXNetError(f"ShardedTrainStep: {what} is slice 22 of the port "
                     "(tensor, pipeline and sequence parallelism, rebuild, "
                     "autotune); this slice runs data parallelism")


def _leaves(state):
    """The tensors of an optimizer state in order, None dropped (the
    reference's ``jax.tree_util.tree_leaves``)."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    out = []
    for s in state:
        out.extend(_leaves(s))
    return out


def _host(t):
    """Host numpy of ``t``; bf16 widened to fp32 (exact: a load casts it
    back)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class ShardedTrainStep:
    """Data-parallel training step for a Block (reference: ``parallel/
    train.py`` ``ShardedTrainStep``).

    block: a HybridBlock on this rank's device, the same initial weights
        on every rank.
    loss_fn(outputs, *labels) -> scalar tensor (the mean).
    optimizer: an Optimizer instance, or a name for ``optimizer.create``.
    mesh: a MeshConfig (built over the world's ranks on the block's
        device) or a Mesh; only 'dp' may exceed 1.
    batch_specs: a spec per batch array (inputs then labels), e.g.
        ``cfg.batch_specs(2, 2)``: the dimension named 'dp' is split over
        the ranks.
    zero: 0 (replicated state), 1 (optimizer state in 1/dp flat shards:
        reduce-scatter, update the shard, all-gather) or 2 (also the
        reduced gradients and the ``grad_accum`` accumulator in shards).
    grad_accum: K microbatches (a leading K axis on every batch array),
        one update.
    steps_per_call: K updates a call (a leading K axis, outside the
        ``grad_accum`` one); returns the mean loss.
    remat: True, 'dots', 'dots_with_no_batch_dims' or a policy callable
        (``gluon.block.resolve_remat_policy``); None inherits
        ``hybridize(remat=...)``.
    precision: "fp32" or "fp8" (``amp.fp8``: eligible Dense matmuls e4m3
        forward / e5m2 backward with delayed scaling).
    grad_compress: None (the ``comm.compress`` knob), "none", "int8" or
        "bf16": error-feedback compression of each microbatch's dp reduce;
        off at dp = 1.
    donate: accepted for the reference's signature; no effect.
    """

    def __init__(self, block, loss_fn, optimizer, mesh, batch_specs,
                 n_labels=1, param_specs=None, donate=True,
                 steps_per_call=1, zero=0, grad_accum=1, remat=None,
                 dp_axis="dp", precision="fp32", grad_compress=None):
        from ..gluon.block import _REMAT_OFF, resolve_remat_policy
        from ..optimizer import optimizer as opt_mod
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self.block = block
        self.loss_fn = loss_fn
        self.device = block.device
        self.mesh_config = mesh if isinstance(mesh, MeshConfig) else None
        if self.mesh_config is not None:
            mesh = self.mesh_config.build([self.device])
        if not isinstance(mesh, Mesh):
            raise MXNetError(f"mesh must be a MeshConfig or a Mesh, got "
                             f"{type(mesh).__name__}")
        big = {a: s for a, s in mesh.shape.items()
               if a != dp_axis and int(s) > 1}
        if big:
            _later(f"a mesh axis above 1 other than '{dp_axis}' ({big})")
        if param_specs is not None:
            _later("param_specs (tensor-sharded parameters)")
        if mesh.devices and mesh.devices[0] != self.device:
            raise MXNetError(f"mesh device {mesh.devices[0]} is not the "
                             f"block's {self.device}")
        self.mesh = mesh
        self.dp = int(mesh.shape.get(dp_axis, 1))
        self.rank = int(mesh.rank or 0)
        if _blackbox._active and self.mesh_config is not None:
            _blackbox.note_mesh(self.mesh_config)
        self.n_labels = int(n_labels)
        self.dp_axis = dp_axis
        self.batch_specs = tuple(batch_specs)
        self.zero = int(zero)
        self.grad_accum = int(grad_accum)
        self.steps_per_call = int(steps_per_call)
        if self.zero not in (0, 1, 2):
            raise MXNetError(f"zero must be 0, 1 or 2, got {zero}")
        if self.grad_accum < 1:
            raise MXNetError(f"grad_accum must be >= 1, got {grad_accum}")
        if self.steps_per_call < 1:
            raise MXNetError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        self.precision = str(precision)
        if self.precision not in ("fp32", "fp8"):
            raise MXNetError(
                f"precision must be 'fp32' or 'fp8', got {precision!r}")
        self._fp8 = self.precision == "fp8"
        if grad_compress is None:
            grad_compress = _config.get("comm.compress")
        self._compress = str(grad_compress or "none").lower()
        if self._compress not in ("none", "int8", "bf16"):
            raise MXNetError(
                "grad_compress must be 'none', 'int8' or 'bf16', got "
                f"{grad_compress!r}")
        if self._compress != "none":
            for s in self.batch_specs:
                flat = []
                for e in tuple(s):
                    flat.extend(e if isinstance(e, tuple) else (e,))
                if dp_axis not in flat:
                    raise MXNetError(
                        f"grad_compress='{self._compress}' requires every "
                        f"batch arg sharded over '{dp_axis}'; got spec {s}")
            if self.dp <= 1:
                self._compress = "none"  # nothing to reduce: plain path
        if remat is None and isinstance(getattr(block, "_flags", None),
                                        dict):
            remat = block._flags.get("remat")
        self._remat_arg = remat
        self._remat_policy = resolve_remat_policy(remat)
        self._remat_on = self._remat_policy is not _REMAT_OFF

        params = block.collect_params()
        #: trainable parameters (grad_req != "null") by structural name
        self.params = {n: p.data() for n, p in params.items()
                       if p.grad_req != "null"}
        #: the rest (BatchNorm's running statistics), updated in place by
        #: the forward
        self.aux = {n: p.data() for n, p in params.items()
                    if p.grad_req == "null" and p.initialized}
        self.fopt = FunctionalOptimizer(optimizer)

        # -- ZeRO: flat padded shards (reference _flat_pad) --------------
        if self.zero and dp_axis not in mesh.shape:
            raise MXNetError(
                f"zero={self.zero} requires a '{dp_axis}' mesh axis; "
                f"mesh has {tuple(mesh.shape)}")
        if self.zero and not getattr(type(optimizer), "_zero_partitionable",
                                     True):
            raise MXNetError(
                f"{type(optimizer).__name__} is not elementwise "
                "(layer-wise norms / per-tensor RNG); it cannot run on "
                "ZeRO shards — use zero=0")
        #: name -> (shape, size, padded size); every trainable at zero > 0
        self._zero = {}
        if self.zero:
            for n, w in self.params.items():
                size = int(w.numel())
                self._zero[n] = (tuple(w.shape), size,
                                 -(-size // self.dp) * self.dp)
        if self._zero:
            self.states = {}
            for n, w in self.params.items():
                s = self.fopt.init({n: self._shard(n, w)})[n]
                chunk = self._zero[n][2] // self.dp
                bad = [tuple(x.shape) for x in _leaves(s)
                       if tuple(x.shape) != (chunk,)]
                if bad:
                    raise MXNetError(
                        f"{type(optimizer).__name__} state for '{n}' is "
                        f"not elementwise (leaf shapes {bad}); zero>0 "
                        "unsupported")
                self.states[n] = s
        else:
            self.states = self.fopt.init(self.params)

        # -- fp8 delayed-scaling state ------------------------------------
        self._fp8_sites = []
        self._fp8_margin = 1.0
        self._site_of = {}
        fp8_state = {}
        if self._fp8:
            shapes = {n: tuple(w.shape) for n, w in self.params.items()}
            self._fp8_sites = _fp8.select_sites(shapes)
            if not self._fp8_sites:
                raise MXNetError(
                    "precision='fp8' found no eligible sites (2-D "
                    "'*.weight' params with >= amp.fp8_min_elems "
                    f"elements) among {sorted(shapes)}")
            self._fp8_margin = float(_config.get("amp.fp8_margin"))
            fp8_state = _fp8.init_state(self._fp8_sites, device=self.device)
            # keyed by tensor: Parameter.name changes with every
            # collect_params() call on a sub-block
            self._site_of = {self.params[s]: s for s in self._fp8_sites}
            block._fp8_trained = True

        # -- error-feedback compression buckets ---------------------------
        self._buckets = []
        resid = {}
        if self._compress != "none":
            bucket_elems = max(1, int(
                float(_config.get("comm.bucket_mb")) * (1 << 20) / 4))
            cur, cur_sz = [], 0
            for n in sorted(self.params):
                size = int(self.params[n].numel())
                if cur and cur_sz + size > bucket_elems:
                    self._buckets.append(cur)
                    cur, cur_sz = [], 0
                cur.append((n, tuple(self.params[n].shape), size))
                cur_sz += size
            if cur:
                self._buckets.append(cur)
            # this rank's residual row of each bucket (the reference keeps
            # one (dp, bucket) array, a row per rank)
            for i, members in enumerate(self._buckets):
                resid[f"bucket{i}"] = torch.zeros(
                    (sum(s for _, _, s in members),), dtype=torch.float32,
                    device=self.device)
        self.extra = {"fp8": fp8_state, "resid": resid}

        # -- the analytic traffic of one update (the reference's counters)
        self._trainable_bytes = sum(int(w.numel()) * w.element_size()
                                    for w in self.params.values())
        if self._compress == "none":
            self._dp_wire_bytes = self._trainable_bytes
        else:
            width = 1 if self._compress == "int8" else 2
            payload = sum(sum(s for _, _, s in m) for m in self._buckets)
            self._dp_wire_bytes = (
                (payload * width + 4 * len(self._buckets)) * self.grad_accum)
        self._zero_bytes = sum(
            info[2] * self.params[n].element_size()
            for n, info in self._zero.items())
        # the plain reduce sums gradients of loss / dp: the gradient of
        # the global batch's mean, whose dy (and fp8 g amax) is the
        # reference's; the compressed reduce means each rank's own, as the
        # reference's shard_map does
        self._grad_scale = 1.0 / self.dp \
            if self.dp > 1 and self._compress == "none" else 1.0
        self._n_step = 0

    # -- layout helpers ------------------------------------------------------
    def _flat_pad(self, n, v):
        """``v`` raveled and zero-padded to its padded size (reference
        ``_flat_pad``)."""
        _, size, padded = self._zero[n]
        flat = v.reshape(-1)
        return torch.nn.functional.pad(flat, (0, padded - size)) \
            if padded != size else flat

    def _shard(self, n, v):
        """This rank's chunk of ``v``'s flat padded layout (a view of
        ``v`` where no padding was needed)."""
        chunk = self._zero[n][2] // self.dp
        return self._flat_pad(n, v)[self.rank * chunk:
                                    (self.rank + 1) * chunk]

    def _rows(self, tensors):
        """(dp, sum of chunks) buffer: row r is every parameter's r-th
        chunk, in ``self._zero`` order (what one reduce-scatter cuts)."""
        parts = [self._flat_pad(n, tensors[n].detach().to(torch.float32))
                 .reshape(self.dp, -1) for n in self._zero]
        return torch.cat(parts, dim=1)

    def _split_chunks(self, flat):
        """{name: chunk view} of a buffer of concatenated chunks."""
        out, off = {}, 0
        for n, (_, _, padded) in self._zero.items():
            c = padded // self.dp
            out[n] = flat[off:off + c]
            off += c
        return out

    def _local(self, b, spec, lead):
        """This rank's part of one global batch array on the device."""
        if getattr(b, "_mx_dp_local", False):
            return b
        raw = self._host_part(b, spec, lead)
        if isinstance(raw, torch.Tensor):
            return raw.to(self.device)
        return torch.as_tensor(onp.ascontiguousarray(raw),
                               device=self.device)

    def _host_part(self, b, spec, lead):
        """This rank's part of a global batch array, where it lies: the
        dimension ``spec`` names 'dp' (after ``lead`` leading axes) cut
        into dp equal blocks."""
        raw = getattr(b, "_data", b)
        dim = _dp_dim(spec) if spec is not None else None
        if dim is None or self.dp == 1:
            return raw
        dim += lead
        n = raw.shape[dim]
        if n % self.dp:
            raise MXNetError(f"batch dim {dim} ({n}) does not divide by "
                             f"dp={self.dp}")
        k = n // self.dp
        sl = [slice(None)] * raw.ndim
        sl[dim] = slice(self.rank * k, (self.rank + 1) * k)
        return raw[tuple(sl)]

    # -- one microbatch ------------------------------------------------------
    def _stats_scope(self):
        return _coll.sync_batch_stats(self.mesh, self.dp_axis) \
            if self.dp > 1 else contextlib.nullcontext()

    def _call_block(self, inputs):
        if self._remat_on:
            from ..gluon.block import remat_scope
            with remat_scope(self.block, self._remat_policy):
                return self.block(*inputs)
        return self.block(*inputs)

    def _forward(self, inputs, labels, scales):
        """Loss, and under fp8 the forward amaxes and the g_scale leaves."""
        if not self._fp8:
            with _autograd.record(), self._stats_scope():
                loss = self.loss_fn(self._call_block(inputs), *labels)
            return loss, {}, {}
        gsc = {s: scales[s][2].detach().clone().requires_grad_()
               for s in self._fp8_sites}
        sc = {s: (scales[s][0], scales[s][1], gsc[s]) for s in gsc}
        with _autograd.record(), self._stats_scope(), \
                _fp8.scope(sc, self._site_of) as ctx:
            loss = self.loss_fn(self._call_block(inputs), *labels)
        return loss, dict(ctx.amax), gsc

    def _fwd_bwd(self, mb, scales):
        """One microbatch: (loss, {name: grad}, fwd amax, g amax)."""
        inputs = mb[:len(mb) - self.n_labels]
        labels = mb[len(mb) - self.n_labels:]
        for w in self.params.values():
            w.grad = None
        loss, fwd_amax, gsc = self._forward(inputs, labels, scales)
        if loss.numel() != 1:
            raise MXNetError(f"loss_fn must return a scalar, got shape "
                             f"{tuple(loss.shape)}")
        # (the backward sums BatchNorm's statistics over the group its
        # forward saw)
        torch.autograd.backward((loss * self._grad_scale).reshape(()))
        grads = {n: w.grad if w.grad is not None else torch.zeros_like(w)
                 for n, w in self.params.items()}
        g_amax = {}
        if self._fp8:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            fwd_amax = {s: fwd_amax.get(s, (zero, zero)) for s in gsc}
            g_amax = {s: g.grad if g.grad is not None else zero
                      for s, g in gsc.items()}
        return loss.detach().reshape(()), grads, fwd_amax, g_amax

    # -- the reduce ----------------------------------------------------------
    def _allreduce_sum(self, grads):
        """{name: gradient summed over the ranks}: one all-reduce of the
        flat buffer."""
        names = list(grads)
        flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                          for n in names])
        flat = _coll.allreduce(flat, self.mesh, self.dp_axis, "sum",
                               donate=True)
        out, off = {}, 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].reshape(grads[n].shape).to(
                grads[n].dtype)
            off += k
        return out

    def _scatter_sum(self, grads):
        """{name: this rank's chunk of the gradient summed over the
        ranks}: one reduce-scatter of the (dp, chunks) buffer."""
        mine = _coll.reduce_scatter(self._rows(grads), self.mesh,
                                    self.dp_axis, donate=True)[0]
        return self._split_chunks(mine)

    def _compressed_mean(self, grads):
        """{name: dp-mean gradient} through ``compressed_allreduce`` bucket
        by bucket, carrying each bucket's residual."""
        out = {}
        for i, members in enumerate(self._buckets):
            key = f"bucket{i}"
            flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                              for n, _, _ in members])
            red, self.extra["resid"][key] = _coll.compressed_allreduce(
                flat, self.mesh, self.dp_axis, self._compress,
                residual=self.extra["resid"][key])
            off = 0
            for n, shape, size in members:
                out[n] = red[off:off + size].reshape(shape).to(
                    grads[n].dtype)
                off += size
        return out

    # -- one update ----------------------------------------------------------
    def _update(self, micro, lr, t, count_first=False):
        """Forward/backward over the microbatches, reduce, update; the
        mean loss over the microbatches and the ranks."""
        K = len(micro)
        scales = (_fp8.scales_from_state(self.extra["fp8"], self._fp8_margin)
                  if self._fp8 else {})
        zero2 = self.zero >= 2 and self.dp > 1
        acc, fa, ga, losses = None, {}, {}, []
        for k, mb in enumerate(micro):
            counting = count_first and k == 0
            with _insight.count([*mb, *self.params.values()]) if counting \
                    else contextlib.nullcontext({}) as cost:
                loss, grads, fwd_amax, g_amax = self._fwd_bwd(mb, scales)
                cost["outputs"] = loss
            if counting:
                self._insight_done = True
                _insight.register_executable(
                    getattr(self, "_insight_label", "parallel.train_step"),
                    args=list(mb), cost=cost, kind="train")
            if self._compress != "none":
                grads = self._compressed_mean(grads)
                if self._zero:
                    grads = self._split_chunks(
                        self._rows(grads)[self.rank].clone())
            elif zero2:
                grads = self._scatter_sum(grads)
            if acc is None:
                acc = grads
            else:
                # in place: the sum is acc[n] + grads[n] as before, with
                # no second accumulator alive
                for n in acc:
                    acc[n].add_(grads[n])
            # this microbatch's gradients go as the next one starts
            grads = None
            losses.append(loss)
            fa = _fp8.merge_amax(fa, fwd_amax)
            ga = _fp8.merge_amax(ga, g_amax)
        if K > 1:
            for a in acc.values():
                a.div_(K)
        grads = acc
        if self._compress == "none" and not zero2 and self.dp > 1:
            grads = (self._scatter_sum(grads) if self._zero
                     else self._allreduce_sum(grads))
        elif self._zero and self.dp == 1:
            grads = {n: self._flat_pad(n, g) for n, g in grads.items()}
        if self._fp8:
            if self.dp > 1:
                fa, ga = self._amax_max(fa, ga)
            self.extra["fp8"] = _fp8.roll_state(self.extra["fp8"], fa, ga)
        self._apply(grads, lr, t)
        loss = losses[0] if K == 1 else torch.mean(torch.stack(losses))
        if self.dp > 1:
            loss = _coll.allreduce(loss.reshape(1), self.mesh, self.dp_axis,
                                   "mean")[0]
        return loss

    def _amax_max(self, fa, ga):
        """The amaxes' max over the ranks, in one all-reduce."""
        sites = self._fp8_sites
        flat = torch.stack([v.reshape(()).to(torch.float32)
                            for s in sites for v in (*fa[s], ga[s])])
        flat = _coll.allreduce(flat, self.mesh, self.dp_axis, "max")
        fa = {s: (flat[3 * i], flat[3 * i + 1]) for i, s in enumerate(sites)}
        ga = {s: flat[3 * i + 2] for i, s in enumerate(sites)}
        return fa, ga

    @torch.no_grad()
    def _apply(self, grads, lr, t):
        """The optimizer's rule: on the whole weights (zero 0), or on this
        rank's shards and an all-gather of the new weights."""
        if not self._zero:
            self.fopt.update(self.params, grads, self.states, lr=lr, t=t)
            return
        # this rank's chunks in one buffer, the shards views of it: the
        # rule updates them in place and the buffer is what is gathered
        flat = torch.cat([self._shard(n, self.params[n])
                          for n in self._zero])
        self.fopt.update(self._split_chunks(flat), grads, self.states,
                         lr=lr, t=t)
        rows = (_coll.allgather(flat[None], self.mesh, self.dp_axis,
                                tiled=True) if self.dp > 1 else flat[None])
        off = 0
        for n, (shape, size, padded) in self._zero.items():
            c = padded // self.dp
            full = rows[:, off:off + c].reshape(-1)[:size]
            self.params[n].copy_(full.reshape(shape))
            off += c

    def __call__(self, *batch):
        """Run ``steps_per_call`` updates; returns the loss (the mean over
        the ranks and the call's updates) as a 0-d tensor on the device."""
        lead = int(self.steps_per_call > 1) + int(self.grad_accum > 1)
        specs = list(self.batch_specs) + [None] * (len(batch)
                                                   - len(self.batch_specs))
        batch = [self._local(b, s, lead) for b, s in zip(batch, specs)]
        opt = self.fopt.opt
        base = opt.num_update
        opt.num_update = base + self.steps_per_call
        if _blackbox._active:
            # keep the flight recorder's step current so a crash bundle
            # is named for (and attributes evidence to) the right step
            _blackbox.set_context(step=int(base) + self.steps_per_call)
        lr = opt.lr_scheduler(base + 1) if opt.lr_scheduler else opt.lr
        counting = _insight._active and not getattr(self, "_insight_done",
                                                    False)
        losses = []
        for i in range(self.steps_per_call):
            xs = [b[i] for b in batch] if self.steps_per_call > 1 else batch
            micro = ([[b[k] for b in xs] for k in range(self.grad_accum)]
                     if self.grad_accum > 1 else [xs])
            losses.append(self._update(micro, lr, base + 1 + i,
                                       count_first=counting and i == 0))
        self._n_step += self.steps_per_call
        self._count_traffic()
        if _insight._active:
            # steady-state loop time from call inter-arrival: measured on
            # wall clocks the caller already pays, no device sync
            _insight.note_step(getattr(self, "_insight_label",
                                       "parallel.train_step"))
        loss = losses[0] if len(losses) == 1 else torch.mean(
            torch.stack(losses))
        return loss.detach().reshape(())

    def _count_traffic(self):
        """The reference's analytic counters (train.py:1016-1050)."""
        if not _telemetry.active():
            return
        spc = self.steps_per_call
        if self._zero:
            rs_per_update = self.grad_accum if self.zero >= 2 else 1
            zb = self._zero_bytes
            _telemetry.inc("zero.reduce_scatter_bytes_total",
                           zb * spc * rs_per_update)
            _telemetry.inc("zero.all_gather_bytes_total", zb * spc)
            _telemetry.inc("zero.collective_bytes_total",
                           zb * spc * rs_per_update, op="reduce_scatter")
            _telemetry.inc("zero.collective_bytes_total", zb * spc,
                           op="all_gather")
        if self.dp > 1:
            _telemetry.inc("mesh.dp_gradient_bytes_total",
                           self._trainable_bytes * spc)
            wire = self._dp_wire_bytes * spc
            _telemetry.inc("mesh.collective_bytes_total", wire, axis="dp")
            if self._compress != "none":
                _telemetry.inc("comm.compressed_bytes_total", wire)
                _telemetry.inc("comm.uncompressed_bytes_total",
                               self._trainable_bytes * self.grad_accum
                               * spc)

    def prefetch(self, batches, depth=None, stall_timeout=None):
        """Wrap an iterable of global batches in a ``DevicePrefetcher``
        that stages only this rank's part of each (from pinned memory on a
        side stream), so the copy of batch N+1 overlaps step N:

            for batch in step.prefetch(loader):
                loss = step(*batch)
        """
        from .. import pipeline as _pipeline
        lead = int(self.steps_per_call > 1) + int(self.grad_accum > 1)
        specs = self.batch_specs

        def parts():
            for b in batches:
                b = b if isinstance(b, (tuple, list)) else (b,)
                yield tuple(self._host_part(x, s, lead)
                            for x, s in zip(b, list(specs) + [None] * (
                                len(b) - len(specs))))

        inner = _pipeline.DevicePrefetcher(
            parts(), shardings=self.device, depth=depth,
            stall_timeout=stall_timeout)

        def marked():
            for b in inner:
                for t in b:
                    t._mx_dp_local = True
                yield b
        return marked()

    def sync_to_block(self):
        """No-op: the step updates the block's parameters in place."""

    def rebuild(self, mesh=None, sync=True):
        _later("rebuild")

    def autotune(self, *args, **kwargs):
        _later("autotune")

    # -- checkpoint / resume -------------------------------------------------
    def state_dict(self):
        """Weights and optimizer state as host numpy in the reference's
        CANONICAL layout (every rank calls it; the sharded state is
        all-gathered, un-padded and reshaped to its weight's shape, the
        residuals summed over the ranks), so a bundle saved at one world
        size and ZeRO level restores bit for bit at another."""
        arrays = {}
        for n, w in self.params.items():
            arrays[f"trainable/{n}"] = _host(w)
        for n, v in self.aux.items():
            arrays[f"aux/{n}"] = _host(v)
        for n, s in self.states.items():
            for i, leaf in enumerate(_leaves(s)):
                if n in self._zero:
                    shape, size, _ = self._zero[n]
                    full = _coll.allgather(leaf, self.mesh, self.dp_axis) \
                        if self.dp > 1 else leaf
                    leaf = full[:size].reshape(shape)
                arrays[f"state/{n}/{i}"] = _host(leaf)
        for site, hist in self.extra["fp8"].items():
            for k, v in hist.items():
                arrays[f"fp8/{site}/{k}"] = _host(v)
        for bname, v in self.extra["resid"].items():
            # the residual that the ranks together still owe the
            # trajectory; a load puts it on rank 0
            total = _coll.allreduce(v, self.mesh, self.dp_axis, "sum") \
                if self.dp > 1 else v
            arrays[f"efresid/{bname}"] = _host(total)
        return {"arrays": arrays, "n_step": int(self._n_step)}

    @torch.no_grad()
    def load_state_dict(self, bundle):
        """Restore from a canonical bundle (this package's ``state_dict``
        or the reference's): values re-pad and re-partition per THIS
        step's dp size and ZeRO level."""
        arrays = bundle["arrays"]

        def put(dst, a):
            dst.copy_(torch.as_tensor(onp.asarray(a)).reshape(dst.shape)
                      .to(dst.dtype))

        for n, w in self.params.items():
            put(w, arrays[f"trainable/{n}"])
        for n, v in self.aux.items():
            put(v, arrays[f"aux/{n}"])
        for n, s in self.states.items():
            for i, leaf in enumerate(_leaves(s)):
                a = torch.as_tensor(onp.asarray(arrays[f"state/{n}/{i}"]))
                if n in self._zero:
                    a = self._shard(n, a.to(leaf.dtype))
                put(leaf, a)
        for site, hist in self.extra["fp8"].items():
            for k, v in hist.items():
                key = f"fp8/{site}/{k}"
                if key not in arrays:
                    continue  # a pre-fp8 bundle keeps the fresh history
                a = onp.asarray(arrays[key]).astype(onp.float32)
                h = int(v.shape[0])
                a = a[:h] if a.shape[0] >= h else onp.pad(
                    a, (0, h - a.shape[0]))
                put(v, a)
        for bname, v in self.extra["resid"].items():
            key = f"efresid/{bname}"
            if key not in arrays:
                continue
            if self.rank == 0:
                put(v, arrays[key])
            else:
                v.zero_()
        self._n_step = int(bundle["n_step"])
        # keep lr schedules / bias correction on the restored timeline
        self.fopt.opt.num_update = self._n_step

    def load_reference_state_dict(self, bundle):
        """Start from the JAX package's ``ShardedTrainStep.state_dict()``
        (numpy arrays in the same canonical layout: weights, optimizer
        states, fp8 histories, residuals, the update count) at any dp
        size: checks that every array this step holds is in it with its
        shape, then loads it."""
        arrays = bundle["arrays"]
        want = self.state_dict_keys()
        missing = sorted(k for k in want if k not in arrays)
        if missing:
            raise MXNetError(f"reference bundle lacks {missing[:4]} "
                             f"({len(missing)} arrays)")
        for k, shape in want.items():
            got = tuple(onp.shape(arrays[k]))
            if got != shape and not k.startswith("fp8/"):
                raise MXNetError(f"reference bundle {k}: shape {got}, this "
                                 f"step holds {shape}")
        self.load_state_dict(bundle)

    def state_dict_keys(self):
        """{canonical key: shape} of what :meth:`state_dict` writes."""
        out = {f"trainable/{n}": tuple(w.shape)
               for n, w in self.params.items()}
        out.update({f"aux/{n}": tuple(v.shape) for n, v in self.aux.items()})
        for n, s in self.states.items():
            for i, leaf in enumerate(_leaves(s)):
                out[f"state/{n}/{i}"] = (self._zero[n][0] if n in self._zero
                                         else tuple(leaf.shape))
        for site, hist in self.extra["fp8"].items():
            out.update({f"fp8/{site}/{k}": tuple(v.shape)
                        for k, v in hist.items()})
        out.update({f"efresid/{b}": tuple(v.shape)
                    for b, v in self.extra["resid"].items()})
        return out

    def save_states(self, fname):
        """Checkpoint weights + optimizer state + step count to one
        safetensors file in the canonical layout (reference:
        ``save_states``): every rank calls it (the gather is collective);
        rank 0 writes."""
        from .. import serialization
        bundle = self.state_dict()
        if self.rank != 0:
            return fname
        return serialization.save_safetensors(
            fname, bundle["arrays"],
            metadata={"n_step": bundle["n_step"], "zero": self.zero,
                      "precision": self.precision,
                      "grad_compress": self._compress})

    def load_states(self, fname):
        """Resume from ``save_states`` (at any dp size or ZeRO level)."""
        from .. import serialization
        loaded, meta = serialization.load_safetensors(
            fname, return_metadata=True)
        if str(meta.get("precision", "")) == "fp8":
            self.block._fp8_trained = True
        self.load_state_dict(
            {"arrays": loaded, "n_step": int(meta.get("n_step", 0))})

