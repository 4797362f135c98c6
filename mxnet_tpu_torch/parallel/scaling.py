"""Data-parallel scaling harness over the launcher.

Counterpart of ``mxnet_tpu/parallel/scaling.py``. The reference runs its
weak-scaling table in one program over sub-meshes of its devices; here a
rank is a process, so every row launches ``n`` ranks through
``tools/launch.py`` and reads rank 0's line:

- :func:`weak_scaling_table`: ``ShardedTrainStep`` over dp = n on a small
  ResNet at a FIXED per-rank batch (ideal: constant step time,
  ``efficiency = t_1 / t_n``), with the gradient-sized all-reduce timed
  alone (``collective_ms``);
- :func:`multiprocess_overhead_table`: per-rank matmul compute against
  ``allreduce_across_processes`` at 1 MiB and 16 MiB.

Ranks run on the CPU over gloo (``device="cpu"``, the launcher's local
mode) or on the cards (``device="cuda"``, ``MXTPU_DIST_DEVICE=cuda``).
Where ranks outnumber the cards (or share the host's cores) the rows say
so (``shared_device`` / ``shared_cores``): such ranks contend for one
device, so these numbers bound overhead and are not scaling.

    python -m mxnet_tpu_torch.parallel._scaling_proc --proc weak  # a rank
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

__all__ = ["weak_scaling_table", "multiprocess_overhead_table"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _launch(n, args, device, timeout):
    """Run this module's ``--proc`` entry on ``n`` ranks; rank 0's row or
    an {'n', 'error'} row."""
    launcher = os.path.join(_REPO, "tools", "launch.py")
    if not os.path.exists(launcher):
        return {"n": n, "error": f"no launcher at {launcher}"}
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, launcher, "-n", str(n)]
    if device == "cuda":
        cmd += ["--env", "MXTPU_DIST_DEVICE=cuda"]
    cmd += [sys.executable, "-m", "mxnet_tpu_torch.parallel._scaling_proc",
            *args]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=_REPO)
    except subprocess.TimeoutExpired:
        return {"n": n, "error": f"timeout {timeout}s"}
    for line in r.stdout.splitlines():
        if line.startswith("SCALING_ROW "):
            return json.loads(line[len("SCALING_ROW "):])
    return {"n": n, "error": (r.stderr or r.stdout)[-300:] or "no output"}


def weak_scaling_table(ns=(1, 2), per_device_batch=4, image=24, classes=10,
                       iters=8, warmup=3, device="cpu", timeout=600):
    """ShardedTrainStep over dp = n for each n in ``ns`` (n launched
    ranks), ResNet-18 v1 at ``per_device_batch`` images of ``image``^2 a
    rank; rows {n, global_batch, ms_per_step, images_per_s, efficiency,
    collective_ms, shared_device}."""
    rows, t1 = [], None
    for n in ns:
        row = _launch(n, ["--proc", "weak", "--batch", str(per_device_batch),
                          "--image", str(image), "--classes", str(classes),
                          "--iters", str(iters), "--warmup", str(warmup)],
                      device, timeout)
        if "error" not in row:
            if t1 is None:
                t1 = row["ms_per_step"]
            row["efficiency"] = t1 / row["ms_per_step"]
        rows.append(row)
    if rows and "error" not in rows[0]:
        rows[0]["decomposition"] = (
            "ms_per_step(n=1) is one rank's compute; collective_ms times "
            "the gradient-sized all-reduce alone at each n; ranks that "
            "share a device or the host's cores contend for it, so the "
            "rest of the growth is contention, not scaling")
    return rows


def multiprocess_overhead_table(ns=(2, 4), timeout=420, device="cpu"):
    """n launched ranks: per-rank matmul compute ms against the
    all-reduce of 1 MiB and 16 MiB (``allreduce_across_processes``)."""
    rows = []
    for n in ns:
        row = _launch(n, ["--proc", "overhead"], device, timeout)
        if "error" not in row and (os.cpu_count() or 1) < n:
            row["shared_cores"] = True
        rows.append(row)
    return rows


# -- the rank side ------------------------------------------------------------

def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_device():
    """This rank's device: the one bring-up chose, else (a world of one)
    the card when the launcher asked for one, else the CPU."""
    import torch

    import mxnet_tpu_torch as mx
    dev = mx.parallel.rank_device()
    if dev is not None:
        return dev
    if os.environ.get("MXTPU_DIST_DEVICE") == "cuda":
        return torch.device("cuda", 0)
    return torch.device("cpu")


def _shared(world, dev):
    """Whether the ranks share one device (the CPU, or fewer cards)."""
    import torch
    return dev.type == "cpu" or world > torch.cuda.device_count()


def _weak(a):
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu_torch.ops.xent import sparse_softmax_xent
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    from mxnet_tpu_torch.parallel import collectives as coll

    world, dev = mx.parallel.world_size(), _rank_device()
    with (mx.gpu(dev.index or 0) if dev.type == "cuda" else mx.cpu()):
        mx.random.seed(0)
        net = get_resnet(1, 18, classes=a.classes)
        net.initialize()
        net(torch.zeros((2, 3, a.image, a.image), device=dev))
        cfg = MeshConfig(dp=world)
        step = ShardedTrainStep(
            net, lambda o, y: sparse_softmax_xent(o, y).mean(),
            mx.optimizer.create("sgd", learning_rate=0.05, momentum=0.9),
            cfg, batch_specs=cfg.batch_specs(4, 1))
        bs = a.batch * world
        x = onp.random.RandomState(0).uniform(
            size=(bs, 3, a.image, a.image)).astype("float32")
        y = onp.zeros((bs,), "int64")
        for _ in range(max(a.warmup, 1)):
            step(x, y)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(a.iters):
            step(x, y)
        _sync(dev)
        dt = (time.perf_counter() - t0) / a.iters
        nparams = sum(w.numel() for w in step.params.values())
        v = torch.ones(nparams, device=dev)
        coll.allreduce(v)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            coll.allreduce(v)
        _sync(dev)
        ar = (time.perf_counter() - t0) / 5
    return {"n": world, "global_batch": bs, "ms_per_step": dt * 1e3,
            "images_per_s": bs / dt, "collective_ms": ar * 1e3,
            "backend": mx.parallel.backend(), "device": str(dev),
            "shared_device": _shared(world, dev)}


def _overhead(a):
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import collectives as coll

    world, dev = mx.parallel.world_size(), _rank_device()
    m = torch.rand(512, 512, device=dev)
    for _ in range(3):
        m @ m
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        m @ m
    _sync(dev)
    compute = (time.perf_counter() - t0) / 10
    rows = []
    for nbytes in (1 << 20, 1 << 24):
        v = torch.ones(nbytes // 4, device=dev)
        coll.allreduce_across_processes(v)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            coll.allreduce_across_processes(v)
        _sync(dev)
        rows.append({"bytes": nbytes,
                     "allreduce_ms": (time.perf_counter() - t0) / 5 * 1e3})
    return {"n": world, "compute_ms": compute * 1e3, "allreduce": rows,
            "backend": mx.parallel.backend(), "device": str(dev),
            "shared_device": _shared(world, dev)}


def _main(argv=None):
    p = argparse.ArgumentParser(description="one rank of the scaling "
                                "harness (started by tools/launch.py)")
    p.add_argument("--proc", choices=("weak", "overhead"), required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--image", type=int, default=24)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--warmup", type=int, default=3)
    a = p.parse_args(argv)
    row = _weak(a) if a.proc == "weak" else _overhead(a)
    import mxnet_tpu_torch as mx
    if mx.parallel.rank() == 0:
        print("SCALING_ROW " + json.dumps(row), flush=True)

