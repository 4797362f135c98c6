"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis.

Counterpart of ``mxnet_tpu/parallel/pp.py``. Each rank of the ``pp`` axis
runs one stage; microbatch activations move stage to stage in the
reference's ``M + S - 1`` ticks (at tick t stage s computes microbatch
t - s), by the differentiable ppermute of ``_diff`` (its backward sends
the cotangents back along the inverse pairs). Every rank returns the last
stage's outputs.

:func:`gpipe` is the reference's function. The training step pipelines a
model's layer family instead (:class:`StagePlan`): each stage runs only
its contiguous block of ``layer<N>`` layers inside their container (a
``TransformerEncoder``), stage 0 also the modules before it (the
embedding: the later stages skip them), the last stage also those after
(final LN, head, loss); the step runs the GPipe fill / drain schedule
itself (all forwards, then all backwards). Both schedules move a tick's
activations (or cotangents) only along the stage pairs that carry a
microbatch at that tick (:func:`hand_on`).
"""
from __future__ import annotations

import contextlib
import re

import torch

from ..base import MXNetError
from . import _diff
from . import collectives as _coll

__all__ = ["gpipe", "stack_stage_params", "shard_stages", "StagePlan",
           "layer_families", "hand_on"]


def _leaves(tree):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k]))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for t in tree:
            out.extend(_leaves(t))
        return out
    return [] if tree is None else [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def hand_on(t, n_stages, n_micro):
    """The ``(src, dst)`` stage pairs of forward tick ``t`` that carry a
    microbatch: stage i hands microbatch ``t - i`` on to stage i + 1 (the
    wrap from the last stage to the first carries none)."""
    return [(i, i + 1) for i in range(n_stages - 1) if 0 <= t - i < n_micro]


def gpipe(stage_fn, stage_params, xs, mesh, axis="pp"):
    """Run a pipeline of S identical-shape stages over M microbatches.

    stage_fn(params_slice, x) -> y        one stage's forward; x, y alike
    stage_params: a tree (dicts / lists) of tensors with leading dim S
        (stacked stages, :func:`stack_stage_params`); this rank runs row
        ``axis_index(axis)``.
    xs: (M, mb, ...) microbatched input (every rank passes it; stage 0
        reads it).
    Returns (M, mb, ...) outputs of the last stage on every rank,
    differentiable in ``stage_params`` and ``xs``: the cotangent of the
    (replicated) result counts once, so a replicated loss gives each
    stage's rows their true gradient.
    """
    _, n_stages, stage = _coll._group_of(mesh, axis)
    n_stages = int(mesh.shape[axis])
    n_micro = xs.shape[0]
    for leaf in _leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != pp axis size "
                f"{n_stages}: each device holds exactly one stage (a "
                f"divisible multiple would silently drop stages)")
    params = _map(lambda p: p[stage], stage_params)
    first = torch.tensor(stage == 0, device=xs.device)
    buf = torch.zeros_like(xs[0])
    ys = [None] * n_micro
    y = None
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        # stage 0 ingests microbatch t; the others the permuted carry. The
        # carry stays in stage 0's graph too (a zero cotangent), so every
        # rank runs each tick's permute backward, in one order (a rank in
        # none of the tick's pairs moves nothing)
        x_in = torch.where(first, xs[min(t, n_micro - 1)], buf)
        y = stage_fn(params, x_in)
        mb = t - stage
        if stage == n_stages - 1 and 0 <= mb < n_micro:
            ys[mb] = y
        if t < ticks - 1:
            buf = _diff.permute(y, mesh, axis,
                                hand_on(t, n_stages, n_micro))
    if stage == n_stages - 1:
        out = torch.stack(ys)
    else:
        # zeros, tied to this rank's last tick (a zero cotangent) so its
        # permutes' backward runs
        out = torch.zeros((n_micro,) + tuple(y.shape), dtype=y.dtype,
                          device=y.device) + 0.0 * y.sum()
    return _diff.broadcast(out, mesh, axis, n_stages - 1, replicated=True)


def stack_stage_params(param_list):
    """Stack per-stage trees (a list of S trees of one structure) into one
    tree with a leading stage dim."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in param_list])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in param_list])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(p) for p in param_list])


def shard_stages(stacked, mesh, axis="pp"):
    """The stacked tree placed for :func:`gpipe` on ``mesh``: each leaf's
    leading dim must be the axis size (every rank keeps the tree; gpipe
    reads its own stage's row)."""
    n = int(mesh.shape[axis])
    for leaf in _leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(f"stacked leading dim {leaf.shape[0]} != pp "
                             f"axis size {n}")
    dev = mesh.devices[0] if mesh.devices else None
    return _map(lambda x: x.to(dev) if dev is not None else x, stacked)


# -- the training step's pipeline ---------------------------------------------

# a parameter named <prefix>layer<i>.<suffix> belongs to the layer family
# <prefix>layer*.<suffix> (reference: parallel/train.py _PP_LAYER_RE)
_PP_LAYER_RE = re.compile(r"^(?P<pre>.*\blayer)(?P<idx>\d+)\.(?P<suf>.+)$")


def layer_families(names):
    """{(prefix, suffix): {index: name}} of the names around a 'layerN.'
    segment."""
    groups = {}
    for n in names:
        m = _PP_LAYER_RE.match(n)
        if m:
            key = (m.group("pre"), m.group("suf"))
            groups.setdefault(key, {})[int(m.group("idx"))] = n
    return groups


def _pre_modules(block, path):
    """[(name, module)] registered before the container on its path from
    ``block`` (at each level, the siblings ahead of the next module on
    the path): what the model runs on its way in, its embedding."""
    out, m, prefix = [], block, ""
    for part in path.split(".") if path else []:
        for name, child in m.named_children():
            if name == part:
                break
            out.append((prefix + name, child))
        m = getattr(m, part)
        prefix += part + "."
    return out


class _StageDone(Exception):
    """Raised out of a stage's last layer on every stage but the last: the
    rest of the model's forward belongs to later stages."""


class StagePlan:
    """Which layers this pp rank runs, and the scope that runs them.

    ``shapes``: {name: shape} of the block's parameters. The layer
    families (``layer_families``; holes in the index range or shapes that
    differ make no family, as in the reference) must divide into the pp
    size and share one container (the module holding ``layer0``...);
    stage s owns layers [s*L/S, (s+1)*L/S) and the parameters under them.
    """

    def __init__(self, block, shapes, mesh, axis="pp"):
        self.mesh, self.axis = mesh, axis
        self.S = int(mesh.shape[axis])
        self.stage = mesh.axis_index(axis)
        fams = {}
        for (pre, suf), idx_map in layer_families(shapes).items():
            L = len(idx_map)
            if sorted(idx_map) != list(range(L)):
                continue
            members = [idx_map[i] for i in range(L)]
            if len({tuple(shapes[m]) for m in members}) != 1:
                continue
            if L % self.S:
                raise MXNetError(
                    f"pp={self.S}: layer family '{pre}N.{suf}' has {L} "
                    f"layers — not divisible into {self.S} pipeline stages")
            fams[(pre, suf)] = members
        if not fams:
            raise MXNetError(
                f"pp={self.S} needs repeated 'layerN.' parameter families "
                "of identical shape to place on pipeline stages; none "
                "found in this block")
        pres = {pre for pre, _ in fams}
        if len(pres) != 1:
            raise MXNetError(f"pp={self.S}: layer families under more than "
                             f"one container {sorted(pres)}; the pipeline "
                             "cuts one layer stack")
        self.families = fams
        pre = pres.pop()
        path = pre[:-len("layer")].rstrip(".")
        self.container = block.get_submodule(path) if path else block
        self.pre = _pre_modules(block, path)
        self.prefix = pre
        L = 0
        while hasattr(self.container, f"layer{L}"):
            L += 1
        self.L = L
        per = L // self.S
        self.lo, self.hi = self.stage * per, (self.stage + 1) * per
        self._per = per
        self.recv = None
        self.out = None

    def owner(self, name):
        """The stage that owns ``name`` (None: every stage holds it)."""
        if not name.startswith(self.prefix):
            return None
        m = re.match(r"(\d+)\.", name[len(self.prefix):])
        if m is None or int(m.group(1)) >= self.L:
            return None
        return int(m.group(1)) // self._per

    @contextlib.contextmanager
    def scope(self, recv=None):
        """Within: the container runs only this stage's layers, on
        ``recv`` (the previous stage's activation; stage 0 its own input),
        and every stage but the last raises :class:`_StageDone` after
        them, keeping its output in ``self.out``. On every stage but the
        first, the modules before the container (``self.pre``) compute
        nothing: each returns a zero scalar on the host, which reaches
        only the container's ignored input."""
        container, plan = self.container, self
        plan.recv, plan.out = recv, None
        entered = []

        def staged(x, *args, **kwargs):
            entered.append(True)
            if plan.stage > 0:
                x = plan.recv
            for i in range(plan.lo, plan.hi):
                x = getattr(container, f"layer{i}")(x, *args, **kwargs)
            if plan.stage < plan.S - 1:
                plan.out = x
                raise _StageDone
            return x

        def skipped(name):
            def forward(*args, **kwargs):
                if entered:
                    raise MXNetError(
                        f"pp: '{name}' is registered before the layer "
                        "container but runs after it; a later stage "
                        "cannot skip it")
                return torch.zeros(())
            return forward

        skip = self.pre if self.stage > 0 else []
        container.forward = staged
        for name, m in skip:
            m.forward = skipped(name)
        try:
            yield self
        finally:
            del container.forward
            for _, m in skip:
                del m.forward
            plan.recv = None
