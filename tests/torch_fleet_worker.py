"""Subprocess body for the port's multi-process fleet lease drill.

Counterpart of ``tests/fleet_worker.py`` over ``mxnet_tpu_torch`` (it
imports no JAX and nothing of ``mxnet_tpu``).

Usage: python tests/torch_fleet_worker.py <lease_dir> <rank> <nprocs>

Rank 0 is the survivor: it publishes its own lease, waits until it has
seen every peer, then watches the health plane until a peer's lease goes
stale and the structured WorkerLost escalation fires — printing the
``FLEET_LOST`` sentinel the test greps for.  Every other rank publishes
a few heartbeats and then exits WITHOUT ``stop()`` — a crash, not a
departure, so its lease is left behind to expire.
"""
import sys
import time

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.fleet import HealthPlane

INTERVAL = 0.05
TIMEOUT = 0.6


def main(lease_dir, rank, nprocs):
    hp = HealthPlane(rank=rank, nprocs=nprocs, lease_dir=lease_dir,
                     interval=INTERVAL, timeout=TIMEOUT)
    if rank != 0:
        for step in range(1, 4):
            hp.beat(step=step)
            time.sleep(INTERVAL)
        print(f"FLEET_BEAT {rank}", flush=True)
        return 0    # vanish silently: no stop(), the lease stays to rot

    deadline = time.monotonic() + 30.0
    hp.beat(step=0)
    while len(hp.peers()) < nprocs - 1:     # wait for every peer's lease
        if time.monotonic() > deadline:
            print("FLEET_TIMEOUT waiting for peers", flush=True)
            return 1
        time.sleep(INTERVAL)
    while time.monotonic() < deadline:
        hp.beat(step=0)
        try:
            hp.check_peers()
        except mx.resilience.WorkerLost as e:
            assert not hp.healthz()["ok"], "stale peer must turn /healthz red"
            print(f"FLEET_LOST {rank} {e.op} {e.key}", flush=True)
            return 0
        time.sleep(INTERVAL)
    print("FLEET_TIMEOUT waiting for lease expiry", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
