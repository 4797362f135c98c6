"""Process-group bring-up at import time.

Counterpart of ``mxnet_tpu/_dist_init.py`` (reference: importing mxnet in
a DMLC-launched job connects the ps-lite van from the DMLC_* variables
before any work happens). Here the process group is
``torch.distributed``'s: ``mxnet_tpu_torch/__init__`` calls
:func:`ensure_distributed` first thing, and it is a no-op without the
launcher's environment or with a world of one.

The environment is the reference's: ``DMLC_PS_ROOT_URI`` /
``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` (what
``tools/launch.py`` sets), or ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``. Rank 0 hosts the rendezvous
store at the coordinator's address.

Where the ranks run and over which backend is decided here, from the
environment and the device count, before any collective (never by
catching a failure):

- ``MXTPU_DIST_DEVICE=cpu`` (``tools/launch.py``'s local mode): every rank
  on the CPU, gloo;
- otherwise rank r on ``cuda:(r % device_count)``; NCCL when the ranks do
  not outnumber the cards, gloo when ranks share a card (NCCL refuses two
  ranks on one device). :func:`backend` says which was chosen.
"""
from __future__ import annotations

import atexit
import os

__all__ = ["ensure_distributed", "world_size", "rank", "backend",
           "rank_device", "abandon", "check_usable"]

#: the placement chosen at bring-up: (backend, torch.device) or None
_placement = None
#: why the process group was given up, or None
_abandoned = None


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


def _plan(nproc, pid):
    """(backend, device) for rank ``pid`` of ``nproc``, from the
    environment and the device count alone."""
    import torch
    from .base import MXNetError
    if os.environ.get("MXTPU_DIST_DEVICE", "") == "cpu":
        return "gloo", torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError(
            "distributed launch without a CUDA device: set "
            "MXTPU_DIST_DEVICE=cpu to run the ranks on the CPU over gloo "
            "(tools/launch.py does this in its local mode)")
    dev = torch.device("cuda", pid % n)
    return ("nccl" if nproc <= n else "gloo"), dev


def ensure_distributed():
    """Join the process group from DMLC-style or native env vars; a no-op
    without them, with a world of one, or when already joined."""
    global _placement
    coord = (os.environ.get("JAX_COORDINATOR_ADDRESS")
             or os.environ.get("DMLC_PS_ROOT_URI"))
    nproc = _env_int("DMLC_NUM_WORKER", "JAX_NUM_PROCESSES")
    pid = _env_int("DMLC_WORKER_ID", "JAX_PROCESS_ID")
    if not (coord and nproc and nproc > 1):
        return
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if pid is None:
        # `rank=pid or 0` would make EVERY worker rank 0: N processes each
        # claiming rank 0 corrupt the reduce instead of failing the launch
        from .base import MXNetError
        raise MXNetError(
            f"distributed launch env is incomplete: coordinator={coord!r} "
            f"and num_processes={nproc} are set but this process has no "
            "rank. Set DMLC_WORKER_ID (DMLC-style) or JAX_PROCESS_ID "
            "(native) to this worker's 0-based index — tools/launch.py "
            "does this automatically.")
    be, dev = _plan(nproc, pid)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    port = os.environ.get("DMLC_PS_ROOT_PORT", "1234")
    addr = coord if ":" in coord else f"{coord}:{port}"
    kw = {"device_id": dev} if be == "nccl" else {}
    dist.init_process_group(be, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid, **kw)
    _placement = (be, dev)
    # tear the group down before the interpreter does: a gloo group left
    # to the C++ destructors at exit can abort the process
    atexit.register(_shutdown)


def _shutdown():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def abandon(reason):
    """Give the process group up: a collective was abandoned while still
    in flight in it, so this rank's next collective would pair with it on
    a peer. Every later collective of the port raises
    (:func:`check_usable`); the world has to be started again. A no-op
    without a group."""
    global _abandoned
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        _abandoned = reason


def check_usable():
    """Raise if the process group was given up (:func:`abandon`)."""
    if _abandoned is not None:
        from .base import MXNetError
        raise MXNetError(f"the process group was given up ({_abandoned}); "
                         "no further collective can run in it: start the "
                         "world again")


def world_size():
    """Processes in the group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    """This process's rank (0 without a group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def backend():
    """The backend the group runs ("gloo" or "nccl"), None without one."""
    import torch.distributed as dist
    return dist.get_backend() if dist.is_initialized() else None


def rank_device():
    """The device this rank was placed on at bring-up (None without a
    launcher; callers then take their own default)."""
    return None if _placement is None else _placement[1]
