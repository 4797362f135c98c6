"""The training step of ``parallel``, one card.

Counterpart of ``mxnet_tpu/parallel/train.py`` (``ShardedTrainStep``,
``FunctionalOptimizer``) for the one-card layout, in fp32 and in fp8
(``amp.fp8``). The reference compiles forward, backward and update into
one jitted program over a mesh; here one call runs them eagerly on the
block's device:

1. the optimizer's ``num_update`` advances on the host, and the step's
   learning rate is ``lr_scheduler(num_update)`` or ``lr`` (no
   ``lr_mult``, as in the reference);
2. under "fp8" the scales come from the amax histories
   (``amp.fp8.scales_from_state``), and the forward runs under
   ``amp.fp8.scope`` with each site's ``g_scale`` a leaf that requires
   grad;
3. ``loss = loss_fn(block(*inputs), *labels)`` (a scalar, the mean) under
   ``autograd.record()``, then ``torch.autograd.backward``;
4. every trainable parameter is updated in place by the optimizer's own
   rule (``_update_impl`` with the step's ``num_update``, as
   ``FunctionalOptimizer.update`` does: not ``Optimizer.update``, whose
   per-index counts the reference's step never touches);
5. under "fp8" the histories roll with the forward amaxes and the
   ``g_scale`` gradients (the measured max |dy| of each site).

Weights are updated in place in the block's own parameters, so
``sync_to_block()`` has nothing to do (in the reference the block stays
stale until it is called). What raises, naming the missing piece: a mesh
axis above 1, ``zero``, ``grad_accum``, ``steps_per_call``, ``remat`` and
``param_specs``. Not ported: ``prefetch``, ``autotune``, ``rebuild``,
``state_dict``/``save_states``, telemetry.
"""
from __future__ import annotations

import torch

from .. import autograd as _autograd
from .. import config as _config
from ..amp import fp8 as _fp8
from ..base import MXNetError
from .mesh import Mesh, MeshConfig

__all__ = ["FunctionalOptimizer", "ShardedTrainStep"]


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


def _later(what):
    raise MXNetError(f"ShardedTrainStep: {what} is not part of this slice of "
                     "the port (one card, no ZeRO, one update per call)")


class ShardedTrainStep:
    """Training step for a Block on one card (reference: ``parallel/
    train.py`` ``ShardedTrainStep``).

    block: a HybridBlock, on the device the step runs on.
    loss_fn(outputs, *labels) -> scalar tensor (the mean).
    optimizer: an Optimizer instance, or a name for ``optimizer.create``.
    mesh: a MeshConfig, built over the block's device, or a Mesh; every
        axis must be 1.
    batch_specs: a spec per batch array (inputs then labels), e.g.
        ``cfg.batch_specs(2, 2)``; read by ``grad_compress``'s validation.
    precision: "fp32" or "fp8" (eligible Dense matmuls e4m3 forward /
        e5m2 backward with per-tensor delayed scaling, ``amp.fp8``; master
        weights, accumulation and the update stay fp32).
    grad_compress: None or "none", "int8" or "bf16"; off at dp = 1, which
        is the only layout here (the reference's ``comm.compress`` knob
        comes with the multi-card slice).
    donate: accepted for the reference's signature; no effect.
    """

    def __init__(self, block, loss_fn, optimizer, mesh, batch_specs,
                 n_labels=1, param_specs=None, donate=True,
                 steps_per_call=1, zero=0, grad_accum=1, remat=None,
                 dp_axis="dp", precision="fp32", grad_compress=None):
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
        big = {a: s for a, s in mesh.shape.items() if int(s) > 1}
        if big:
            _later(f"a mesh axis above 1 ({big})")
        if mesh.devices[0] != self.device:
            raise MXNetError(f"mesh device {mesh.devices[0]} is not the "
                             f"block's {self.device}")
        self.mesh = mesh
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
        self.precision = str(precision)
        if self.precision not in ("fp32", "fp8"):
            raise MXNetError(
                f"precision must be 'fp32' or 'fp8', got {precision!r}")
        self._fp8 = self.precision == "fp8"
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
            self._compress = "none"  # dp = 1: nothing to reduce
        if self.zero:
            _later(f"zero={self.zero} (ZeRO optimizer-state partitioning)")
        if self.grad_accum > 1:
            _later(f"grad_accum={self.grad_accum}")
        if self.steps_per_call != 1:
            _later(f"steps_per_call={self.steps_per_call}")
        if remat:
            _later("remat (activation rematerialization)")
        if param_specs is not None:
            _later("param_specs (tensor-sharded parameters)")

        params = block.collect_params()
        #: trainable parameters (grad_req != "null") by structural name
        self.params = {n: p.data() for n, p in params.items()
                       if p.grad_req != "null"}
        self.fopt = FunctionalOptimizer(optimizer)
        self.states = self.fopt.init(self.params)

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
        self.extra = {"fp8": fp8_state, "resid": {}}

    def _forward(self, inputs, labels):
        """Loss, and under fp8 the forward amaxes and the g_scale leaves."""
        if not self._fp8:
            with _autograd.record():
                loss = self.loss_fn(self.block(*inputs), *labels)
            return loss, {}, {}
        scales = _fp8.scales_from_state(self.extra["fp8"], self._fp8_margin)
        gsc = {s: scales[s][2].detach().clone().requires_grad_()
               for s in self._fp8_sites}
        sc = {s: (scales[s][0], scales[s][1], gsc[s]) for s in gsc}
        with _autograd.record(), _fp8.scope(sc, self._site_of) as ctx:
            loss = self.loss_fn(self.block(*inputs), *labels)
        return loss, dict(ctx.amax), gsc

    def __call__(self, *batch):
        """Run one update; returns the loss as a 0-d tensor on the card."""
        batch = [torch.as_tensor(b, device=self.device) for b in batch]
        inputs = batch[:len(batch) - self.n_labels]
        labels = batch[len(batch) - self.n_labels:]
        opt = self.fopt.opt
        base = opt.num_update
        opt.num_update = base + 1
        lr = opt.lr_scheduler(base + 1) if opt.lr_scheduler else opt.lr
        for w in self.params.values():
            w.grad = None
        loss, fwd_amax, gsc = self._forward(inputs, labels)
        if loss.numel() != 1:
            raise MXNetError(f"loss_fn must return a scalar, got shape "
                             f"{tuple(loss.shape)}")
        torch.autograd.backward(loss.reshape(()))
        grads = {n: w.grad if w.grad is not None else torch.zeros_like(w)
                 for n, w in self.params.items()}
        self.fopt.update(self.params, grads, self.states, lr=lr, t=base + 1)
        if self._fp8:
            # sites the forward never reached roll in zeros, as the
            # reference's fixed-structure amax dicts do
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            fwd_amax = {s: fwd_amax.get(s, (zero, zero)) for s in gsc}
            g_amax = {s: g.grad if g.grad is not None else zero
                      for s, g in gsc.items()}
            self.extra["fp8"] = _fp8.roll_state(self.extra["fp8"], fwd_amax,
                                                g_amax)
        return loss.detach().reshape(())

    def sync_to_block(self):
        """No-op: the step updates the block's parameters in place."""
