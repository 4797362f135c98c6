"""The port's multi-process serving drill: three CPU processes, one
``ServeEngine`` replica and one lease each, driven by
``tests/torch_servefleet_worker.py drive`` (the counterpart of the
reference's CI stage, ci/run.sh:572-576): the busiest replica SIGKILLed
mid-stream and detected by lease expiry alone, its unfinished keys
re-dispatched by the rendezvous hash, every key completed exactly once
with greedy parity against a driver-side engine, a rolling update from a
published checkpoint with zero post-warmup captures and canary parity,
and a bad canary rolled back."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sigkill_failover_rolling_update_and_rollback(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_servefleet_worker.py"),
         "drive", str(tmp_path / "drill")],
        capture_output=True, text=True, env=env, timeout=240)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-4000:]
    assert "SERVEFLEET_DRILL_OK keys=16" in p.stdout, out[-4000:]
    assert "rollback=ok compiles=0" in p.stdout, out[-4000:]
