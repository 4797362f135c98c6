"""The training step of ``parallel``: data, tensor, pipeline and sequence
parallel over the process group.

Counterpart of ``mxnet_tpu/parallel/train.py`` (``ShardedTrainStep``,
``FunctionalOptimizer``, ``megatron_specs``, ``scan_steps``). The reference
compiles forward, backward, reduce and update into one jitted program over
a mesh and GSPMD inserts the collectives; here every rank is one process
running them eagerly on its own device, with each collective written out
(``parallel.collectives``, and the differentiable ones of ``_diff``):

1. every rank passes the same GLOBAL batch (as the reference's
   ``__call__`` takes it) and keeps its part: each array's dimensions
   named by ``batch_specs`` cut by this rank's coordinates ('dp' the
   batch, 'sp' the sequence; after the leading ``steps_per_call`` /
   ``grad_accum`` axes); a batch from :meth:`prefetch` is already this
   rank's;
2. the optimizer's ``num_update`` advances by ``steps_per_call`` on the
   host, and every update of the call takes the learning rate
   ``lr_scheduler(num_update + 1)`` (or ``lr``) and its own count ``t``;
3. tensor parallelism (tp > 1): ``param_specs`` (default
   :func:`megatron_specs`) shard the Dense weights; each rank's block
   replaces the Parameter's storage and each Dense takes its role
   (``parallel.tp``: Megatron column / row pairs with local attention
   heads, any other sharded weight gathered), so the values are the
   reference's whatever the specs;
4. pipeline parallelism (pp > 1): each rank runs one stage of the model's
   ``layer<N>`` family (``pp.StagePlan``: stage 0 also the embedding,
   the last stage also the final LN, head and loss); the ``grad_accum``
   microbatches are the GPipe fill / drain schedule (all forwards, then
   all backwards, each tick's activations or cotangents moved by one
   ppermute along the stage pairs that carry a microbatch); a rank holds
   and updates only its stage's layers and the parameters every stage
   holds (the other stages' layers keep no storage while the block is
   sharded);
5. sequence parallelism (sp > 1): the activation rules
   (``MeshConfig.activation_rules``) are installed around the call, so
   attention runs as ring attention (or gathers keys and values) and the
   models offset their positions; each rank differentiates its loss
   divided by dp·sp, and gradients are summed over dp and sp;
6. per microbatch (non-pipelined): under "fp8" the scales come from the
   amax histories, ``loss = loss_fn(block(*inputs), *labels)`` under
   ``autograd.record()``, with ``remat`` through
   ``gluon.block.remat_scope``, then the backward; at dp > 1 BatchNorm
   takes the global batch's statistics (``collectives.sync_batch_stats``);
7. the gradients: summed over sp, the pp-replicated ones over pp, then
   the dp mean (each rank differentiated loss / (dp·sp)): one all-reduce
   (zero 0) or reduce-scatter (zero 1) of the flat buffer, / K; at
   ``zero=2`` each microbatch's gradients are reduce-scattered into the
   dp-sharded accumulator at once; with ``grad_compress`` (pure dp) each
   microbatch's gradients go through ``compressed_allreduce`` bucket by
   bucket, carrying the error-feedback residual;
8. the update is the optimizer's own rule (``_update_impl``): on the whole
   (local) weights in place (zero 0), or on this rank's shard and an
   all-gather of the new weights (zero 1, 2): a flat padded shard of a
   weight whose spec names no axis (``_flat_pad``), and for a weight
   whose spec names one (a tensor-parallel block, or at tp = 1 a weight
   the spec would cut) the reference's ZeRO×TP layout (``_insert_dp``:
   dp inserted into its largest free dimension; ``_zero_layout``);
9. under "fp8" the amaxes are the max over every rank that holds a piece
   of the site (dp, tp and sp) and the histories roll once per update;
   the returned loss is the mean over the ranks (and a call's updates).

``state_dict`` / ``load_state_dict`` / ``save_states`` / ``load_states``
use the reference's canonical gathered layout (``trainable/``, ``aux/``,
``state/<name>/<i>``, ``fp8/``, ``efresid/``): tensor-parallel blocks
gathered, pipeline stages' layers brought from their owners, ZeRO shards
unpadded, so a bundle moves bit for bit between layouts, world sizes,
ZeRO levels and the two packages (:meth:`load_reference_state_dict`).
:meth:`sync_to_block` makes the block whole again (every layer current on
every rank); the next call shards it again. :meth:`rebuild` constructs the
step around another ``MeshConfig``. On a layout smaller than the world the
ranks past it are ``stranded``: their step makes the layout's groups (a
collective over the world) and holds nothing else, and a call, a
``state_dict`` or a bundle on it raises; :meth:`rebuild` onto a layout
that holds the rank makes a step that trains. With telemetry on, each
call feeds the reference's ``zero.*``, ``mesh.*`` and ``comm.*`` counters
with its logical arithmetic. ``autotune`` needs ``mx.autotune`` (ROADMAP
Queue 1, item 5) and raises.

Dropout: each rank draws from its own device's default generator, which
``mx.random.seed(s)`` seeds alike on every rank; tensor-parallel ranks
must draw alike (their replicated activations' masks agree that way), dp
and sp ranks may be seeded apart for independent masks.

The host planes, as the reference's step feeds them: with the flight
recorder armed, each call sets the bundle context's ``step`` and the step
notes its mesh; with mx.insight on, the first call's cost is counted and
registered as ``parallel.train_step``, and every call feeds
``insight.note_step``.
"""
from __future__ import annotations

import contextlib
import math

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
from . import tp as _tp
from .mesh import (P, Mesh, MeshConfig, activation_sharding, local_part,
                   spec_cuts)
from .pp import StagePlan, _StageDone, hand_on

__all__ = ["FunctionalOptimizer", "ShardedTrainStep", "scan_steps",
           "megatron_specs"]

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
    "mesh.tp_allreduce_bytes_total", "counter",
    "estimated activation bytes allreduced over the tp axis per step "
    "(row-parallel layer outputs x tokens; logical estimate for "
    "token-shaped inputs)")
_telemetry.declare_metric(
    "mesh.pp_stage_transfer_bytes_total", "counter",
    "estimated residual-stream bytes handed stage-to-stage over the pp "
    "axis per step (forward + backward; logical estimate)")
_telemetry.declare_metric(
    "mesh.collective_bytes_total", "counter",
    "per-axis logical collective bytes of the training step, labeled "
    "axis=dp|tp|pp; WIRE bytes at the compressed width on dp when "
    "gradient compression is on")
_telemetry.declare_metric(
    "comm.compressed_bytes_total", "counter",
    "dp gradient bytes placed on the wire by error-feedback compression "
    "(int8 / bf16 payload + one fp32 scale per bucket per rank)")
_telemetry.declare_metric(
    "comm.uncompressed_bytes_total", "counter",
    "dp gradient bytes that would have moved without compression (fp32 "
    "per-microbatch reduce)")

# name-pattern Megatron rules for the transformer family (reference:
# parallel/train.py): column-parallel Dense (units sharded), row-parallel
# Dense (in_units sharded, outputs all-reduced)
_COLUMN_SUFFIXES = ("query_proj.weight", "key_proj.weight",
                    "value_proj.weight", "ffn_1.weight")
_ROW_SUFFIXES = ("out_proj.weight", "ffn_2.weight")
_COLUMN_BIAS = ("query_proj.bias", "key_proj.bias", "value_proj.bias",
                "ffn_1.bias")


def megatron_specs(param_shapes, tp_axis="tp"):
    """Specs for transformer parameters by structural-name pattern
    (reference: ``megatron_specs``)."""
    specs = {}
    for name, shape in param_shapes.items():
        if any(name.endswith(s) for s in _COLUMN_SUFFIXES) and len(shape) == 2:
            specs[name] = P(tp_axis, None)
        elif any(name.endswith(s) for s in _ROW_SUFFIXES) and len(shape) == 2:
            specs[name] = P(None, tp_axis)
        elif any(name.endswith(s) for s in _COLUMN_BIAS):
            specs[name] = P(tp_axis)
        else:
            specs[name] = P()
    return specs


def _insert_dp(spec, shape, dp_axis, dp_n):
    """The reference's ZeRO×TP state spec: ``spec`` with ``dp_axis`` in its
    largest free (replicated, evenly divisible) dimension; None when no
    dimension takes it."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    flat = []
    for e in entries:
        flat.extend(e if isinstance(e, tuple) else (e,))
    if dp_axis in flat:
        return None
    free = [i for i, e in enumerate(entries)
            if e is None and shape[i] % dp_n == 0 and shape[i] >= dp_n]
    if not free:
        return None
    best = max(free, key=lambda i: shape[i])
    entries[best] = dp_axis
    return P(*entries)


def _zero_layout(specs, shapes, dp_axis, dp_n):
    """The two ZeRO layouts (reference ``train.py:409-432``): a parameter
    whose spec names any axis is tensor-sharded (even where that axis has
    size 1) and cuts its state over dp along the dimension ``_insert_dp``
    picks (``ztp``: name -> dim; where none is free, its state stays like
    the weight); every other one joins the flat padded shards (``zero``:
    name -> (shape, size, padded size)). ``shapes`` may be this rank's tp
    blocks: only their free dimensions are read."""
    zero, ztp = {}, {}
    for n, shape in shapes.items():
        spec = specs.get(n, P())
        if any(e is not None for e in spec):
            ins = _insert_dp(spec, shape, dp_axis, dp_n)
            if ins is not None:
                ztp[n] = list(ins).index(dp_axis)
            continue
        size = math.prod(shape)
        zero[n] = (tuple(shape), size, -(-size // dp_n) * dp_n)
    return zero, ztp


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


def _axes_of(spec):
    out = []
    for e in tuple(spec):
        out.extend(e if isinstance(e, tuple) else (e,))
    return [a for a in out if a is not None]


class ShardedTrainStep:
    """Data, tensor, pipeline and sequence parallel training step for a
    Block (reference: ``parallel/train.py`` ``ShardedTrainStep``).

    block: a HybridBlock on this rank's device, the same initial weights
        on every rank.
    loss_fn(outputs, *labels) -> scalar tensor (the mean).
    optimizer: an Optimizer instance, or a name for ``optimizer.create``.
    mesh: a MeshConfig (built over the world's ranks on the block's
        device; its activation rules turn sp on) or a Mesh.
    batch_specs: a spec per batch array (inputs then labels), e.g.
        ``cfg.batch_specs(2, 2)``: the dimensions named 'dp' and 'sp' are
        split over those ranks.
    param_specs: {name: spec} sharding Dense weights over 'tp'; default
        ``megatron_specs`` on a mesh with a 'tp' axis, else replicated.
    zero: 0 (replicated state), 1 (optimizer state in 1/dp shards:
        reduce-scatter, update the shard, all-gather) or 2 (also the
        reduced gradients and the ``grad_accum`` accumulator in shards).
    grad_accum: K microbatches (a leading K axis on every batch array),
        one update; under pp the GPipe schedule's microbatches.
    steps_per_call: K updates a call (a leading K axis, outside the
        ``grad_accum`` one); returns the mean loss.
    remat: True, 'dots', 'dots_with_no_batch_dims' or a policy callable
        (``gluon.block.resolve_remat_policy``); None inherits
        ``hybridize(remat=...)``.
    precision: "fp32" or "fp8" (``amp.fp8``: eligible Dense matmuls e4m3
        forward / e5m2 backward with delayed scaling; not under pp).
    grad_compress: None (the ``comm.compress`` knob), "none", "int8" or
        "bf16": error-feedback compression of each microbatch's dp reduce
        (a pure-dp mesh); off at dp = 1.
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
        if mesh.devices and mesh.devices[0] != self.device:
            raise MXNetError(f"mesh device {mesh.devices[0]} is not the "
                             f"block's {self.device}")
        other = {a: s for a, s in mesh.shape.items()
                 if a not in (dp_axis, "tp", "pp", "sp") and int(s) > 1}
        if other:
            raise MXNetError(f"ShardedTrainStep runs dp, tp, pp and sp; the "
                             f"mesh also has {other} (expert parallelism "
                             "is ROADMAP Queue 1, item 9)")
        self.mesh = mesh
        self.dp = int(mesh.shape.get(dp_axis, 1))
        self.tp = int(mesh.shape.get("tp", 1))
        self.pp = int(mesh.shape.get("pp", 1))
        self.sp = int(mesh.shape.get("sp", 1))
        #: this process outside a layout smaller than the world: it made
        #: the layout's groups (collective over the world) and takes part
        #: in nothing else of it
        self.stranded = mesh.rank is None
        self.rank = None if self.stranded else int(mesh.rank)
        self._act_rules = (self.mesh_config.activation_rules()
                           if self.mesh_config is not None else {})
        if _blackbox._active and self.mesh_config is not None:
            # postmortems answer "what mesh was this host running?"
            _blackbox.note_mesh(self.mesh_config)
        self.n_labels = int(n_labels)
        self.dp_axis = dp_axis
        self.batch_specs = tuple(batch_specs)
        self.zero = int(zero)
        self.grad_accum = int(grad_accum)
        self.steps_per_call = int(steps_per_call)
        self._donate = bool(donate)
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
        if self._fp8 and self.pp > 1:
            raise MXNetError("precision='fp8' under pp > 1 is not ported: "
                             "fp8 runs under dp, tp and sp")
        if grad_compress is None:
            grad_compress = _config.get("comm.compress")
        self._compress = str(grad_compress or "none").lower()
        if self._compress not in ("none", "int8", "bf16"):
            raise MXNetError(
                "grad_compress must be 'none', 'int8' or 'bf16', got "
                f"{grad_compress!r}")
        if self._compress != "none":
            others = {a: s for a, s in mesh.shape.items()
                      if a != dp_axis and int(s) > 1}
            if others:
                raise MXNetError(
                    f"grad_compress='{self._compress}' needs a pure-dp "
                    f"mesh (the compressed reduce runs over '{dp_axis}' "
                    f"only); mesh also has {others}")
            for s in self.batch_specs:
                if dp_axis not in _axes_of(s):
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
        self.fopt = FunctionalOptimizer(optimizer)
        self._sharded = False
        self._n_step = 0
        if self.stranded:
            # the block stays whole and unsharded; rebuild() onto a layout
            # that holds this rank makes a step that trains
            return

        all_params = block.collect_params()
        held = [n for n, m in block.named_modules()
                if getattr(m, "_tp", None) is not None]
        if held:
            raise MXNetError(
                f"the block's {held[:2]} hold tensor-parallel blocks of "
                "another step or of parallel.tp; make it whole first "
                "(that step's sync_to_block(), or tp.unshard)")
        #: every parameter's whole shape and dtype, by structural name
        self._shapes = {n: tuple(p.shape) for n, p in all_params.items()}
        self._dtypes = {n: p.dtype for n, p in all_params.items()}
        train_names = [n for n, p in all_params.items()
                       if p.grad_req != "null"]
        aux_names = [n for n, p in all_params.items()
                     if p.grad_req == "null" and p.initialized]
        if param_specs is None:
            param_specs = (megatron_specs(self._shapes)
                           if "tp" in mesh.shape else {})
        specs = {n: P(*tuple(param_specs.get(n, P()))) for n in all_params}
        for n, s in specs.items():
            big = [a for a in _axes_of(s) if int(mesh.shape.get(a, 1)) > 1]
            if any(a != "tp" for a in big):
                raise MXNetError(
                    f"param_specs[{n!r}] = {s}: parameters shard over 'tp' "
                    "(pipeline stages come from the layer families, the "
                    "sequence from the batch)")
        self.param_specs = specs

        # -- pipeline stages: the layer family's blocks ---------------------
        self._plan = StagePlan(block, self._shapes, mesh) \
            if self.pp > 1 else None
        self._stage = self._plan.stage if self._plan is not None else 0
        #: trainable and aux names in block order, every stage's
        self._train_names, self._aux_names = train_names, aux_names

        # -- tensor parallelism: blocks and roles ---------------------------
        #: {name: (dim, role kind)} of the parameters held as tp blocks
        self._tp_layout = {}
        self._shard_block()

        #: trainable parameters this rank holds and updates (its stage's
        #: layers and every parameter outside the layer family)
        self.params = {n: all_params[n].data() for n in train_names
                       if self._owned(n)}
        #: the rest (BatchNorm's running statistics), updated in place by
        #: the forward
        self.aux = {n: all_params[n].data() for n in aux_names
                    if self._owned(n)}
        #: names every pp stage holds (their gradients summed over pp)
        self._pp_rep = [n for n in self.params
                        if self._plan is not None
                        and self._plan.owner(n) is None]

        # -- ZeRO: flat padded shards, and ZeRO×TP for tp blocks ------------
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
        #: name -> (shape, size, padded size): flat ZeRO shards (a weight
        #: whole on this rank)
        self._zero = {}
        #: name -> dim: ZeRO×TP, a tensor-sharded parameter's state cut
        #: over dp along dim
        self._ztp = {}
        if self.zero:
            self._zero, self._ztp = _zero_layout(
                specs, {n: tuple(w.shape) for n, w in self.params.items()},
                dp_axis, self.dp)
        self.states = {}
        for n, w in self.params.items():
            if n in self._zero:
                s = self.fopt.init({n: self._shard(n, w)})[n]
                want = (self._zero[n][2] // self.dp,)
            elif n in self._ztp:
                s = self.fopt.init({n: self._ztp_chunk(n, w)})[n]
                want = tuple(self._ztp_chunk(n, w).shape)
            else:
                s = self.fopt.init({n: w})[n]
                want = tuple(w.shape) if (
                    n in self._tp_layout or self._plan is not None) else None
            if want is not None:
                bad = [tuple(x.shape) for x in _leaves(s)
                       if tuple(x.shape) != want]
                if bad:
                    raise MXNetError(
                        f"{type(optimizer).__name__} state for '{n}' is "
                        f"not elementwise (leaf shapes {bad}); ZeRO and "
                        "the gathered tp / pp state need it")
            self.states[n] = s
        #: {name: [(shape, dtype)]} of every trainable's state leaves, the
        #: whole weight's (what the canonical bundle holds)
        self._state_meta = {}
        for n in train_names:
            meta = torch.empty(self._shapes[n], dtype=self._dtypes[n],
                               device="meta")
            self._state_meta[n] = [
                (tuple(x.shape), x.dtype)
                for x in _leaves(optimizer.create_state(n, meta))]

        # -- fp8 delayed-scaling state ------------------------------------
        self._fp8_sites = []
        self._fp8_margin = 1.0
        self._site_of = {}
        fp8_state = {}
        if self._fp8:
            shapes = {n: self._shapes[n] for n in train_names}
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
        self._count_plan()
        # the plain reduce sums gradients of loss / (dp sp): the gradient
        # of the global batch's mean, whose dy (and fp8 g amax) is the
        # reference's; the compressed reduce means each rank's own, as the
        # reference's shard_map does
        self._grad_scale = 1.0 / (self.dp * self.sp) \
            if self._compress == "none" else 1.0

    # -- layout ----------------------------------------------------------------
    def _member(self, what):
        """Raise where this rank is stranded (outside the layout): it takes
        part in no step, state or bundle collective of it."""
        if not self.stranded:
            return
        from .mesh import _world
        world, rank = _world()
        layout = self.mesh_config if self.mesh_config is not None else \
            self.mesh.shape
        used = math.prod(int(v) for v in self.mesh.shape.values())
        raise MXNetError(
            f"rank {rank} is stranded: {layout} uses ranks 0-{used - 1} of "
            f"a world of {world}, so this rank takes part in no {what} of "
            "it; rebuild() the step onto a layout that holds it")

    def _owned(self, name):
        return self._plan is None or self._plan.owner(name) in (
            None, self._stage)

    def _shard_block(self):
        """Cut the block's tp-sharded parameters to this rank's blocks and
        give its Dense layers their roles, and drop the storage of the
        other pp stages' layers (a no-op when already cut)."""
        if self._sharded:
            return
        if self.tp > 1:
            self._tp_layout = _tp.megatron_roles(
                self.block, self.param_specs, self.mesh, "tp")
        if self._plan is not None:
            # one element expanded to the (local) shape: the shape stays
            # known, the storage goes; sync_to_block brings the values
            params = self.block.collect_params()
            for n in self._train_names + self._aux_names:
                if not self._owned(n):
                    v = params[n].data()
                    params[n]._replace(torch.zeros(
                        (), dtype=v.dtype, device=v.device).expand(v.shape))
        self._sharded = True

    def _ztp_chunk(self, n, v):
        """This rank's dp chunk of the tp block ``v`` along its ZeRO dim."""
        d = self._ztp[n]
        k = v.shape[d] // self.dp
        return v.narrow(d, self.mesh.axis_index(self.dp_axis) * k,
                        k).contiguous()

    def _dp_index(self):
        return self.mesh.axis_index(self.dp_axis) if self.dp > 1 else 0

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
        r = self._dp_index()
        return self._flat_pad(n, v)[r * chunk:(r + 1) * chunk]

    def _rows(self, tensors):
        """(dp, sum of chunks) buffer: row r is every flat-ZeRO
        parameter's r-th chunk, in ``self._zero`` order (what one
        reduce-scatter cuts)."""
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
        """This rank's part of a global batch array, where it lies: each
        dimension ``spec`` names by axes above 1 (after ``lead`` leading
        axes) cut by this rank's coordinates."""
        raw = getattr(b, "_data", b)
        if spec is None:
            return raw
        try:
            return local_part(raw, spec_cuts(spec, self.mesh), lead)
        except MXNetError as e:
            raise MXNetError(f"batch spec {spec}: {e}") from None

    # -- one microbatch ------------------------------------------------------
    def _stats_scope(self):
        return _coll.sync_batch_stats(self.mesh, self.dp_axis) \
            if self.dp > 1 else contextlib.nullcontext()

    @contextlib.contextmanager
    def _scopes(self, inputs, stats=True):
        """The forward's scopes: tp roles in place, the activation rules
        (sp), hybridized blocks run plain (no captured collectives), and
        BatchNorm's global statistics (dp; ``stats``, the forward only:
        the backward sums over the group its forward saw)."""
        from ..gluon.cached_graph import plain_scope
        self._shard_block()
        with contextlib.ExitStack() as stack:
            if self._act_rules:
                s = inputs[0].shape[1] if inputs and inputs[0].ndim > 1 \
                    else None
                stack.enter_context(activation_sharding(
                    self.mesh, local={"sp": s}, **self._act_rules))
            if self.tp > 1 or self.sp > 1 or self.pp > 1:
                stack.enter_context(plain_scope())
            if stats:
                stack.enter_context(self._stats_scope())
            yield

    def _call_block(self, inputs):
        if self._remat_on:
            from ..gluon.block import remat_scope
            with remat_scope(self.block, self._remat_policy):
                return self.block(*inputs)
        return self.block(*inputs)

    def _forward(self, inputs, labels, scales):
        """Loss, and under fp8 the forward amaxes and the g_scale leaves."""
        if not self._fp8:
            with _autograd.record(), self._scopes(inputs):
                loss = self.loss_fn(self._call_block(inputs), *labels)
            return loss, {}, {}
        gsc = {s: scales[s][2].detach().clone().requires_grad_()
               for s in self._fp8_sites}
        sc = {s: (scales[s][0], scales[s][1], gsc[s]) for s in gsc}
        with _autograd.record(), self._scopes(inputs), \
                _fp8.scope(sc, self._site_of) as ctx:
            loss = self.loss_fn(self._call_block(inputs), *labels)
        return loss, dict(ctx.amax), gsc

    def _grads(self):
        return {n: w.grad if w.grad is not None else torch.zeros_like(w)
                for n, w in self.params.items()}

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
        with self._scopes(inputs, stats=False):
            torch.autograd.backward((loss * self._grad_scale).reshape(()))
        grads = self._grads()
        g_amax = {}
        if self._fp8:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            fwd_amax = {s: fwd_amax.get(s, (zero, zero)) for s in gsc}
            g_amax = {s: g.grad if g.grad is not None else zero
                      for s, g in gsc.items()}
        return loss.detach().reshape(()), grads, fwd_amax, g_amax

    # -- the GPipe schedule ----------------------------------------------------
    def _pipeline(self, micro):
        """All microbatches through this rank's stage, fill then drain
        (reference: the ``M + S - 1`` ticks of ``gpipe``): the summed
        gradients of this stage's parameters (in ``.grad``) and the last
        stage's mean loss on every pp rank. ``gpipe`` cannot run it: its
        stages are one function of equal-shape activations, while here
        stage 0 takes the batch's token ids and the last stage returns
        the loss. Each microbatch's backward runs on its own, as GPipe
        drains, from a detached leaf of the activation it received."""
        plan, S, s = self._plan, self.pp, self._stage
        M = len(micro)
        for w in self.params.values():
            w.grad = None
        saved = [None] * M
        recv, shape = None, None
        ticks = M + S - 1
        for t in range(ticks):
            m = t - s
            y = None
            if 0 <= m < M:
                mb = micro[m]
                inputs = mb[:len(mb) - self.n_labels]
                labels = mb[len(mb) - self.n_labels:]
                leaf = recv.detach().requires_grad_() if s > 0 else None
                with _autograd.record(), self._scopes(inputs), \
                        plan.scope(leaf):
                    try:
                        y = self.loss_fn(self._call_block(inputs), *labels)
                    except _StageDone:
                        y = plan.out
                saved[m] = (leaf, y)
            if shape is None:
                shape = self._act_shape(y if s < S - 1 else None)
            pairs = hand_on(t, S, M) if t < ticks - 1 else []
            if any(s in pair for pair in pairs):
                # y, or the receive buffer's shape where this rank sends
                # nothing
                send = y.detach() if (y is not None and s < S - 1) else \
                    torch.empty(shape[0], dtype=shape[1],
                                device=self.device)
                recv = _coll.ppermute(send.contiguous(), self.mesh, "pp",
                                      pairs)
        losses = []
        grad = None
        for u in range(ticks):
            m = M - 1 - (u - (S - 1 - s))
            gx = None
            if 0 <= m < M:
                leaf, y = saved[m]
                saved[m] = None
                if s == S - 1:
                    losses.append(y.detach().reshape(()))
                    root, cot = (y * self._grad_scale).reshape(()), None
                else:
                    root, cot = y, grad
                with self._scopes(micro[m][:len(micro[m]) - self.n_labels],
                                  stats=False):
                    torch.autograd.backward(root, cot)
                if leaf is not None:
                    gx = leaf.grad
            # backward tick u sends what forward tick ticks - 2 - u
            # received, back along its pairs
            pairs = [(d, src) for src, d in hand_on(ticks - 2 - u, S, M)] \
                if u < ticks - 1 else []
            if any(s in pair for pair in pairs):
                send = gx if gx is not None else torch.empty(
                    shape[0], dtype=shape[1], device=self.device)
                grad = _coll.ppermute(send.contiguous(), self.mesh, "pp",
                                      pairs)
        if s == S - 1:
            loss = torch.mean(torch.stack(losses[::-1]))
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        loss = _coll.broadcast(loss.float(), self.mesh, "pp", S - 1)
        return loss

    def _act_shape(self, y):
        """(shape, dtype) of the activation the stages hand on, from stage
        0's first output (a small broadcast over pp, once a call)."""
        codes = [torch.float32, torch.bfloat16, torch.float16,
                 torch.float64]
        head = torch.zeros(8, dtype=torch.int64, device=self.device)
        if y is not None and self._stage == 0:
            head[0] = y.ndim
            head[1:1 + y.ndim] = torch.tensor(y.shape)
            head[7] = codes.index(y.dtype)
        head = _coll.broadcast(head, self.mesh, "pp", 0).tolist()
        return tuple(head[1:1 + head[0]]), codes[head[7]]

    # -- the reduce ----------------------------------------------------------
    def _allreduce_sum(self, grads, names, axis):
        """The gradients of ``names`` summed over ``axis``: one all-reduce
        of their flat buffer."""
        if not names:
            return grads
        flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                          for n in names])
        flat = _coll.allreduce(flat, self.mesh, axis, "sum", donate=True)
        out, off = dict(grads), 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].reshape(grads[n].shape).to(
                grads[n].dtype)
            off += k
        return out

    def _sum_other(self, grads, names=None):
        """Sum over sp (every parameter of ``names``, default all) and over
        pp (those every stage holds): what precedes the dp reduce."""
        names = list(grads) if names is None else list(names)
        if self.sp > 1:
            grads = self._allreduce_sum(grads, names, "sp")
        if self.pp > 1:
            rep = set(self._pp_rep)
            grads = self._allreduce_sum(
                grads, [n for n in names if n in rep], "pp")
        return grads

    def _scatter_sum(self, grads):
        """{name: this rank's chunk of the gradient summed over dp}: one
        reduce-scatter of the (dp, chunks) buffer for the flat ZeRO names
        (when ``grads`` holds them), one a ZeRO×TP name along its dim."""
        out = {}
        if self._zero and next(iter(self._zero)) in grads:
            mine = _coll.reduce_scatter(self._rows(grads), self.mesh,
                                        self.dp_axis, donate=True)[0]
            out.update(self._split_chunks(mine))
        for n, d in self._ztp.items():
            if n not in grads:
                continue
            g = grads[n].movedim(d, 0).contiguous()
            out[n] = _coll.reduce_scatter(g, self.mesh, self.dp_axis,
                                          donate=True).movedim(0, d)
        return out

    def _dp_reduce(self, grads):
        """The dp sum: ZeRO names reduce-scattered to their chunks, the
        rest all-reduced (at dp = 1 the ZeRO names cut to their whole
        chunk)."""
        rest = [n for n in grads if n not in self._zero
                and n not in self._ztp]
        if self.dp > 1:
            out = self._allreduce_sum({n: grads[n] for n in rest}, rest,
                                      self.dp_axis)
            if self._zero or self._ztp:
                out.update(self._scatter_sum(grads))
            return out
        out = {n: grads[n] for n in rest}
        out.update({n: self._flat_pad(n, grads[n]) for n in self._zero
                    if n in grads})
        out.update({n: grads[n] for n in self._ztp if n in grads})
        return out

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
        fa, ga = {}, {}
        if self._plan is not None:
            loss = self._pipeline(micro)
            grads = self._grads()
            if K > 1:
                for g in grads.values():
                    g.div_(K)
            grads = self._dp_reduce(self._sum_other(grads))
        else:
            zero2 = self.zero >= 2 and self.dp > 1 and bool(self._zero)
            acc, losses = None, []
            for k, mb in enumerate(micro):
                counting = count_first and k == 0
                with _insight.count([*mb, *self.params.values()]) \
                        if counting else contextlib.nullcontext({}) as cost:
                    loss, grads, fwd_amax, g_amax = self._fwd_bwd(mb,
                                                                  scales)
                    cost["outputs"] = loss
                if counting:
                    self._insight_done = True
                    _insight.register_executable(
                        getattr(self, "_insight_label",
                                "parallel.train_step"),
                        args=list(mb), cost=cost, kind="train")
                if self._compress != "none":
                    grads = self._compressed_mean(grads)
                    if self._zero:
                        rows = self._rows(grads)[self._dp_index()].clone()
                        grads.update(self._split_chunks(rows))
                elif zero2:
                    # this microbatch's flat-ZeRO gradients go to their dp
                    # chunks at once; the rest accumulate whole
                    grads = self._sum_other(grads, self._zero)
                    chunks = _coll.reduce_scatter(
                        self._rows(grads), self.mesh, self.dp_axis,
                        donate=True)[0]
                    grads.update(self._split_chunks(chunks))
                if acc is None:
                    acc = grads
                else:
                    # in place: the sum is acc[n] + grads[n] as before,
                    # with no second accumulator alive
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
            if self._compress == "none":
                if zero2:
                    rest = {n: g for n, g in grads.items()
                            if n not in self._zero}
                    red = self._dp_reduce(self._sum_other(rest))
                    grads = {**{n: grads[n] for n in self._zero}, **red}
                else:
                    grads = self._dp_reduce(self._sum_other(grads))
            elif self._zero and self.dp == 1:
                grads = {n: self._flat_pad(n, g) for n, g in grads.items()}
            loss = losses[0] if K == 1 else torch.mean(torch.stack(losses))
        if self._fp8:
            fa, ga = self._amax_max(fa, ga)
            self.extra["fp8"] = _fp8.roll_state(self.extra["fp8"], fa, ga)
        self._apply(grads, lr, t)
        for axis, n in ((self.dp_axis, self.dp), ("sp", self.sp)):
            if n > 1:
                loss = _coll.allreduce(loss.reshape(1), self.mesh, axis,
                                       "mean")[0]
        return loss

    def _amax_max(self, fa, ga):
        """The amaxes' max over every rank holding a piece of the sites
        (dp, tp, sp), one all-reduce an axis."""
        sites = self._fp8_sites
        flat = torch.stack([v.reshape(()).to(torch.float32)
                            for s in sites for v in (*fa[s], ga[s])])
        for axis, n in ((self.dp_axis, self.dp), ("tp", self.tp),
                        ("sp", self.sp)):
            if n > 1:
                flat = _coll.allreduce(flat, self.mesh, axis, "max")
        fa = {s: (flat[3 * i], flat[3 * i + 1]) for i, s in enumerate(sites)}
        ga = {s: flat[3 * i + 2] for i, s in enumerate(sites)}
        return fa, ga

    @torch.no_grad()
    def _apply(self, grads, lr, t):
        """The optimizer's rule: on the whole (local) weights, or on this
        rank's ZeRO shards and an all-gather of the new weights."""
        rest = [n for n in self.params if n not in self._zero
                and n not in self._ztp]
        if rest:
            self.fopt.update(self.params, {n: grads[n] for n in rest},
                             self.states, lr=lr, t=t)
        if self._ztp:
            chunks = {n: self._ztp_chunk(n, self.params[n])
                      for n in self._ztp}
            self.fopt.update(chunks, {n: grads[n] for n in self._ztp},
                             self.states, lr=lr, t=t)
            for n, d in self._ztp.items():
                c = chunks[n].movedim(d, 0).contiguous()
                full = (_coll.allgather(c, self.mesh, self.dp_axis)
                        if self.dp > 1 else c)
                self.params[n].copy_(full.movedim(0, d))
        if not self._zero:
            return
        # this rank's chunks in one buffer, the shards views of it: the
        # rule updates them in place and the buffer is what is gathered
        flat = torch.cat([self._shard(n, self.params[n])
                          for n in self._zero])
        self.fopt.update(self._split_chunks(flat),
                         {n: grads[n] for n in self._zero}, self.states,
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
        self._member("training step")
        lead = int(self.steps_per_call > 1) + int(self.grad_accum > 1)
        specs = list(self.batch_specs) + [None] * (len(batch)
                                                   - len(self.batch_specs))
        tokens = int(onp.prod(getattr(batch[0], "shape", ()))) \
            if batch else 0
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
        self._count_traffic(tokens)
        if _insight._active:
            # steady-state loop time from call inter-arrival: measured on
            # wall clocks the caller already pays, no device sync
            _insight.note_step(getattr(self, "_insight_label",
                                       "parallel.train_step"))
        loss = losses[0] if len(losses) == 1 else torch.mean(
            torch.stack(losses))
        return loss.detach().reshape(())

    # -- the reference's analytic counters ------------------------------------
    def _count_plan(self):
        """The byte counts a call feeds, with the reference's layout
        arithmetic (train.py:346-460, 560-577): its stacked pp families,
        its spec classes (a spec naming any axis is tensor-sharded, flat
        ZeRO otherwise), whole shapes."""
        spec = dict(self.param_specs)
        shapes = {n: self._shapes[n] for n in self._train_names}
        item = {n: torch.empty((), dtype=self._dtypes[n]).element_size()
                for n in shapes}
        ref = {n: (shapes[n], spec.get(n, P()), item[n]) for n in shapes}
        if self._plan is not None:
            for (pre, suf), members in self._plan.families.items():
                if members[0] not in ref:
                    continue  # an aux family
                base = spec.get(members[0], P())
                shape = (len(members),) + shapes[members[0]]
                for m in members:
                    ref.pop(m)
                ref[f"{pre}*.{suf}"] = (shape, P("pp", *tuple(base)),
                                        item[members[0]])
        self._trainable_bytes = sum(
            int(onp.prod(sh)) * it for sh, _, it in ref.values())
        zero_b = ztp_b = 0
        if self.zero:
            zero, ztp = _zero_layout({n: sp for n, (_, sp, _) in ref.items()},
                                     {n: sh for n, (sh, _, _) in ref.items()},
                                     self.dp_axis, self.dp)
            zero_b = sum(padded * ref[n][2]
                         for n, (_, _, padded) in zero.items())
            ztp_b = sum(math.prod(ref[n][0]) * ref[n][2] for n in ztp)
        self._zero_bytes, self._zero_tp_bytes = zero_b, ztp_b
        if self._compress == "none":
            self._dp_wire_bytes = self._trainable_bytes
        else:
            width = 1 if self._compress == "int8" else 2
            payload = sum(sum(s for _, _, s in m) for m in self._buckets)
            self._dp_wire_bytes = (
                (payload * width + 4 * len(self._buckets)) * self.grad_accum)
        self._tp_row_units = sum(
            sh[0] if len(sh) == 2 else sh[0] * sh[1]
            for n, (sh, _, _) in ref.items()
            if any(n.endswith(s) for s in _ROW_SUFFIXES)) \
            if self.tp > 1 else 0
        self._pp_width = 0
        if self._plan is not None:
            for n, (sh, _, _) in ref.items():
                if "*." in n and n.endswith("ln.gamma"):
                    self._pp_width = int(sh[-1])
                    break

    def _count_traffic(self, tokens):
        """The reference's analytic counters (train.py:1016-1060)."""
        if not _telemetry.active():
            return
        spc = self.steps_per_call
        if self.zero and (self._zero_bytes or self._zero_tp_bytes):
            rs_per_update = self.grad_accum if self.zero >= 2 else 1
            zb = self._zero_bytes + self._zero_tp_bytes
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
        if self._tp_row_units and tokens:
            b = tokens * self._tp_row_units * 4
            _telemetry.inc("mesh.tp_allreduce_bytes_total", b)
            _telemetry.inc("mesh.collective_bytes_total", b, axis="tp")
        if self.pp > 1 and self._pp_width and tokens:
            b = tokens * self._pp_width * 4 * (self.pp - 1) * 2
            _telemetry.inc("mesh.pp_stage_transfer_bytes_total", b)
            _telemetry.inc("mesh.collective_bytes_total", b, axis="pp")

    def prefetch(self, batches, depth=None, stall_timeout=None):
        """Wrap an iterable of global batches in a ``DevicePrefetcher``
        that stages only this rank's part of each (from pinned memory on a
        side stream), so the copy of batch N+1 overlaps step N:

            for batch in step.prefetch(loader):
                loss = step(*batch)
        """
        self._member("prefetch")
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

    # -- the block, whole --------------------------------------------------------
    @torch.no_grad()
    def sync_to_block(self):
        """Make the block whole: tp blocks gathered into its parameters
        (the roles cleared) and every pp stage's layers brought from their
        owner, so ``save_parameters`` or an eager forward sees the trained
        weights on every rank (every rank calls it: collectives). The next
        call shards the block again."""
        if not self._sharded:
            return
        if self.tp > 1:
            _tp.unshard(self.block)
            _tp.clear_roles(self.block)
        self._sharded = False
        if self._plan is not None:
            params = self.block.collect_params()
            for n in self._train_names + self._aux_names:
                owner = self._plan.owner(n)
                if owner is None:
                    continue
                full = _coll.broadcast(params[n].data(), self.mesh, "pp",
                                       owner)
                if owner != self._stage:
                    params[n]._replace(full)

    def rebuild(self, mesh=None, sync=True):
        """This step constructed again around a :class:`MeshConfig` (same
        block, loss, optimizer, zero, grad_accum, remat, precision and
        compression; batch and param specs re-derived from the new layout,
        the optimizer state fresh, as the reference's ``rebuild``).
        ``mesh=None`` rebuilds on this step's own layout. ``sync=True``
        writes the trained weights into the block first; ``sync=False``
        (a bundle restore follows) gives the block its whole shapes back
        as zeros where it holds blocks. Every rank calls it."""
        if mesh is None:
            mesh = self.mesh_config
            if mesh is None:
                raise MXNetError(
                    "rebuild() without a mesh needs a step built from a "
                    "MeshConfig (this one was built from a raw mesh)")
        if not isinstance(mesh, MeshConfig):
            raise MXNetError(
                f"rebuild needs a MeshConfig, got {type(mesh).__name__}")
        if sync:
            self.sync_to_block()
        elif self._sharded:
            params = self.block.collect_params()
            for n in self._train_names + self._aux_names:
                if n in self._tp_layout or not self._owned(n):
                    p = params[n]
                    p._replace(torch.zeros(self._shapes[n], dtype=p.dtype,
                                           device=p.device))
            _tp.clear_roles(self.block)
            self._sharded = False
        batch_specs = mesh.batch_specs(
            *[len(s) if s is not None else 2 for s in self.batch_specs])
        rebuilt = ShardedTrainStep(
            self.block, self.loss_fn, self.fopt.opt, mesh, batch_specs,
            n_labels=self.n_labels, param_specs=None, donate=self._donate,
            steps_per_call=self.steps_per_call, zero=self.zero,
            grad_accum=self.grad_accum, remat=self._remat_arg,
            dp_axis="dp", precision=self.precision,
            grad_compress=self._compress)
        rebuilt._n_step = self._n_step
        return rebuilt

    def autotune(self, *args, **kwargs):
        raise MXNetError(
            "ShardedTrainStep.autotune searches with mx.autotune, which is "
            "not ported yet (ROADMAP Queue 1, item 5)")

    # -- checkpoint / resume -------------------------------------------------
    def _whole(self, n, t, dim_of_dp=None):
        """The whole value of ``t`` (this rank's view of parameter ``n``
        or of one of its state leaves) on the device: the ZeRO chunk
        gathered over dp, the tp block over tp."""
        if dim_of_dp is not None and self.dp > 1:
            if dim_of_dp == "flat":
                shape, size, _ = self._zero[n]
                t = _coll.allgather(t, self.mesh, self.dp_axis)[:size] \
                    .reshape(shape)
            else:
                c = t.movedim(dim_of_dp, 0).contiguous()
                t = _coll.allgather(c, self.mesh, self.dp_axis).movedim(
                    0, dim_of_dp)
        elif dim_of_dp == "flat":
            shape, size, _ = self._zero[n]
            t = t[:size].reshape(shape)
        if n in self._tp_layout:
            d = self._tp_layout[n][0]
            c = t.movedim(d, 0).contiguous()
            t = _coll.allgather(c, self.mesh, "tp").movedim(0, d)
        return t

    def _from_owner(self, n, t, shape, dtype):
        """``t`` from the pp stage that owns ``n`` (every pp rank gets
        it); ``t`` itself where every stage holds ``n``."""
        owner = self._plan.owner(n) if self._plan is not None else None
        if owner is None:
            return t
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        return _coll.broadcast(t.contiguous(), self.mesh, "pp", owner)

    def state_dict(self):
        """Weights and optimizer state as host numpy in the reference's
        CANONICAL layout (every rank calls it: tp blocks gathered, each
        pp stage's layers brought from their owner, ZeRO shards gathered,
        un-padded and reshaped, the residuals summed over the ranks), so a
        bundle saved at one layout restores bit for bit at another."""
        self._member("state_dict")
        arrays = {}
        for n in self._train_names:
            w = self.params.get(n)
            w = self._whole(n, w) if w is not None else None
            arrays[f"trainable/{n}"] = _host(self._from_owner(
                n, w, self._shapes[n], self._dtypes[n]))
        for n in self._aux_names:
            v = self.aux.get(n)
            v = self._whole(n, v) if v is not None else None
            arrays[f"aux/{n}"] = _host(self._from_owner(
                n, v, self._shapes[n], self._dtypes[n]))
        for n in self._train_names:
            s = self.states.get(n)
            leaves = _leaves(s) if n in self.params else None
            for i, (shape, dtype) in enumerate(self._state_meta[n]):
                leaf = None
                if leaves is not None:
                    how = ("flat" if n in self._zero
                           else self._ztp.get(n))
                    leaf = self._whole(n, leaves[i], how)
                arrays[f"state/{n}/{i}"] = _host(self._from_owner(
                    n, leaf, shape, dtype))
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

    def _local_of(self, n, a, dtype):
        """This rank's block of the canonical array ``a`` of parameter
        ``n`` (its tp block where it holds one)."""
        t = torch.as_tensor(onp.asarray(a)).to(dtype)
        if n in self._tp_layout:
            d = self._tp_layout[n][0]
            k = t.shape[d] // self.tp
            t = t.narrow(d, self.mesh.axis_index("tp") * k, k)
        return t

    @torch.no_grad()
    def load_state_dict(self, bundle):
        """Restore from a canonical bundle (this package's ``state_dict``
        or the reference's): values re-cut per THIS step's tp blocks, pp
        stage, dp size and ZeRO level."""
        self._member("load_state_dict")
        arrays = bundle["arrays"]
        self._shard_block()

        def put(dst, t):
            dst.copy_(t.reshape(dst.shape).to(dst.dtype))

        for n, w in self.params.items():
            put(w, self._local_of(n, arrays[f"trainable/{n}"], w.dtype))
        for n, v in self.aux.items():
            put(v, self._local_of(n, arrays[f"aux/{n}"], v.dtype))
        for n, s in self.states.items():
            for i, leaf in enumerate(_leaves(s)):
                a = self._local_of(n, arrays[f"state/{n}/{i}"], leaf.dtype)
                if n in self._zero:
                    a = self._shard(n, a)
                elif n in self._ztp:
                    a = self._ztp_chunk(n, a)
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
                put(v, torch.as_tensor(a))
        for bname, v in self.extra["resid"].items():
            key = f"efresid/{bname}"
            if key not in arrays:
                continue
            if self._dp_index() == 0:
                put(v, torch.as_tensor(onp.asarray(arrays[key])))
            else:
                v.zero_()
        self._n_step = int(bundle["n_step"])
        # keep lr schedules / bias correction on the restored timeline
        self.fopt.opt.num_update = self._n_step

    def load_reference_state_dict(self, bundle):
        """Start from the JAX package's ``ShardedTrainStep.state_dict()``
        (numpy arrays in the same canonical layout: weights, optimizer
        states, fp8 histories, residuals, the update count) at any
        layout: checks that every array this step holds is in it with its
        shape, then loads it."""
        self._member("load_reference_state_dict")
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
        self._member("state_dict_keys")
        out = {f"trainable/{n}": self._shapes[n] for n in self._train_names}
        out.update({f"aux/{n}": self._shapes[n] for n in self._aux_names})
        for n in self._train_names:
            for i, (shape, _) in enumerate(self._state_meta[n]):
                out[f"state/{n}/{i}"] = shape
        for site, hist in self.extra["fp8"].items():
            out.update({f"fp8/{site}/{k}": tuple(v.shape)
                        for k, v in hist.items()})
        out.update({f"efresid/{b}": tuple(v.shape)
                    for b, v in self.extra["resid"].items()})
        return out

    def save_states(self, fname):
        """Checkpoint weights + optimizer state + step count to one
        safetensors file in the canonical layout (reference:
        ``save_states``): every rank calls it (the gathers are
        collective); rank 0 writes."""
        self._member("save_states")
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
        """Resume from ``save_states`` (at any layout or ZeRO level)."""
        self._member("load_states")
        from .. import serialization
        loaded, meta = serialization.load_safetensors(
            fname, return_metadata=True)
        if str(meta.get("precision", "")) == "fp8":
            self.block._fp8_trained = True
        self.load_state_dict(
            {"arrays": loaded, "n_step": int(meta.get("n_step", 0))})

