"""Multi-process chaos drill for the port's mx.servefleet.

Counterpart of ``tests/servefleet_worker.py`` over ``mxnet_tpu_torch`` (it
imports no JAX and nothing of ``mxnet_tpu``), on the CPU.

Usage:
    python tests/torch_servefleet_worker.py worker <root> <rank> <nprocs>
    python tests/torch_servefleet_worker.py drive  <root>

``drive`` spawns N=3 worker processes, each hosting ONE ServeEngine
replica of the same deterministic tiny GPT plus a HealthPlane lease,
speaking a file protocol under ``<root>``:

- ``inbox-<rank>/<key>.json``      request {key, prompt, max_new_tokens}
- ``completions-<rank>.jsonl``     fsync'd append, one {key, tokens} per
                                   FIRST finish on that replica
- ``control-<rank>.json``          driver commands (seq-guarded):
                                   update (rolling weight swap from a
                                   published checkpoint) / exit
- ``update-<rank>-<seq>.json``     per-update verdict {ok, reason, ...}
- ``stats-<rank>.json``            final {post_warmup_compiles, ...}

The drill then exercises the whole robustness surface for real — three
OS processes, no shared memory:

1. routes a batch of keyed requests by the SAME rendezvous hash the
   in-process router uses (deterministic across processes),
2. SIGKILLs the busiest replica mid-stream, detects the death by lease
   expiry alone, re-dispatches its unfinished keys to the survivors,
   and proves the completion union is exactly-once with greedy parity
   against a driver-side oracle engine,
3. rolls the survivors one at a time to a published checkpoint
   (staged tmp+rename publish, canary card in the manifest), proving
   zero post-warmup compiles, canary parity, and service continuity —
   live traffic lands on the other replica while one is updating,
4. publishes a checkpoint whose canary card disagrees with its weights
   and proves the replica auto-rolls back and keeps serving the old
   generation.

Prints ``SERVEFLEET_DRILL_OK ...`` on success (the CI gate greps it).
"""
import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPROCS = 3
SEED = 7
MAX_NEW = 24
LEASE_INTERVAL = 0.2
LEASE_TIMEOUT = 1.5
ENGINE_KW = dict(max_slots=2, buckets="4,8", temperature=0.0,
                 device="cpu")


def build_model():
    """Deterministic replica weights: same seed -> bitwise-identical
    params in every process, so greedy decode is a cross-process parity
    oracle."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    net = gpt.GPTForCausalLM(vocab_size=512, units=64, hidden_size=256,
                             num_layers=2, num_heads=4, max_length=128,
                             dropout=0.0, embed_dropout=0.0, device="cpu")
    net.initialize(seed=SEED)
    return net


def _write_json(path, payload):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _lease_path(root, rank):
    return os.path.join(root, f"host-{rank}.lease")


def _completions_path(root, rank):
    return os.path.join(root, f"completions-{rank}.jsonl")


# ---------------------------------------------------------------------------
# worker: one replica = one engine + one lease
# ---------------------------------------------------------------------------

def worker(root, rank, nprocs):
    import torch

    from mxnet_tpu_torch import servefleet
    from mxnet_tpu_torch.fleet import HealthPlane
    from mxnet_tpu_torch.serve.engine import ServeEngine

    torch.set_num_threads(1)

    eng = ServeEngine(build_model(), **ENGINE_KW)
    eng.warmup()
    # lease appears only after warmup: lease presence == ready to serve
    hp = HealthPlane(rank=rank, nprocs=nprocs, lease_dir=root,
                     interval=LEASE_INTERVAL, timeout=LEASE_TIMEOUT).start()

    inbox = os.path.join(root, f"inbox-{rank}")
    seen, reqs, logged = set(), {}, set()
    last_seq = 0

    def flush():
        for key, req in reqs.items():
            if key not in logged and req.finished:
                logged.add(key)
                with open(_completions_path(root, rank), "a") as f:
                    f.write(json.dumps(
                        {"key": key,
                         "tokens": [int(t) for t in req.generated]}) + "\n")
                    f.flush()
                    os.fsync(f.fileno())

    def do_update(cmd):
        """One replica's leg of a rolling update: drain -> in-place
        swap -> re-warmup (must capture nothing) -> greedy
        canary against the checkpoint's card -> auto-rollback on any
        divergence or capture."""
        params, canary = servefleet.load_checkpoint(cmd["checkpoint"])
        eng.stop(drain=True)
        flush()  # drained requests finished under the OLD weights
        before = eng.post_warmup_compiles
        old = eng.update_weights(params)
        eng.resume()
        eng.warmup()
        ok = eng.post_warmup_compiles == before
        reason = None if ok else "post_warmup_compiles"
        if ok and canary:
            for prompt, expected in zip(canary["prompts"],
                                        canary["expected"]):
                req = eng.submit(prompt, max_new_tokens=canary["tokens"])
                eng.run()
                if [int(t) for t in req.generated] != list(expected):
                    ok, reason = False, "canary diverged"
                    break
        if not ok:
            eng.restore_weights(old)
        _write_json(os.path.join(root, f"update-{rank}-{cmd['seq']}.json"),
                    {"ok": ok, "reason": reason,
                     "post_warmup_compiles": eng.post_warmup_compiles})

    while True:
        for fn in sorted(os.listdir(inbox)):
            if not fn.endswith(".json") or fn in seen:
                continue
            try:
                with open(os.path.join(inbox, fn)) as f:
                    r = json.load(f)
            except (OSError, ValueError):
                continue  # torn read is impossible (rename) — be safe
            seen.add(fn)
            reqs[r["key"]] = eng.submit(r["prompt"], r["max_new_tokens"])
        if eng.pending:
            eng.step()
        flush()
        try:
            with open(os.path.join(root, f"control-{rank}.json")) as f:
                cmd = json.load(f)
        except (OSError, ValueError):
            cmd = None
        if cmd and int(cmd.get("seq", 0)) > last_seq:
            last_seq = int(cmd["seq"])
            if cmd["cmd"] == "update":
                do_update(cmd)
            elif cmd["cmd"] == "exit":
                eng.stop(drain=True)
                flush()
                _write_json(
                    os.path.join(root, f"stats-{rank}.json"),
                    {"post_warmup_compiles": eng.post_warmup_compiles,
                     "completed": len(logged)})
                hp.stop()
                return 0
        time.sleep(0.02)  # pace decode: the kill must land mid-stream


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _fail(msg):
    print(f"SERVEFLEET_DRILL_FAIL {msg}", flush=True)
    return 1


def _read_completions(root, ranks):
    """-> (first: key->tokens, occurrences: key->count) across all
    replica logs — the exactly-once oracle reads every line."""
    first, occurrences = {}, {}
    for r in ranks:
        try:
            with open(_completions_path(root, r)) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            rec = json.loads(line)
            occurrences[rec["key"]] = occurrences.get(rec["key"], 0) + 1
            first.setdefault(rec["key"], rec["tokens"])
    return first, occurrences


def drive(root):
    import numpy as onp

    import torch

    from mxnet_tpu_torch import functional, servefleet
    from mxnet_tpu_torch.serve.engine import ServeEngine

    torch.set_num_threads(2)

    os.makedirs(root, exist_ok=True)
    for r in range(NPROCS):
        os.makedirs(os.path.join(root, f"inbox-{r}"), exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_")}   # no process group
    procs = {r: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", root,
         str(r), str(NPROCS)], env=env) for r in range(NPROCS)}

    def check_alive(ranks):
        for r in ranks:
            if procs[r].poll() is not None:
                raise RuntimeError(f"worker {r} exited rc={procs[r].poll()}")

    try:
        deadline = time.monotonic() + 300
        while not all(os.path.exists(_lease_path(root, r))
                      for r in range(NPROCS)):
            check_alive(range(NPROCS))
            if time.monotonic() > deadline:
                return _fail("workers never published leases")
            time.sleep(0.1)
        print("drill: all replicas leased", flush=True)

        # driver-side parity oracle: same deterministic weights
        net = build_model()
        oracle = ServeEngine(build_model(), **ENGINE_KW)
        expected_cache = {}

        def expected(eng, prompt, n=MAX_NEW):
            key = (id(eng), tuple(prompt), n)
            if key not in expected_cache:
                req = eng.submit(prompt, max_new_tokens=n)
                eng.run()
                expected_cache[key] = [int(t) for t in req.generated]
            return expected_cache[key]

        # -- phase 1: keyed load through the rendezvous router ---------
        rng = onp.random.RandomState(3)
        requests, assign = {}, {r: [] for r in range(NPROCS)}
        live = list(range(NPROCS))
        for i in range(12):
            key, session = f"req-{i}", f"sess-{i}"
            prompt = rng.randint(1, 512, size=rng.randint(2, 8)).tolist()
            rank = servefleet.rendezvous_route(session, live)
            requests[key] = {"key": key, "session": session,
                             "prompt": prompt, "max_new_tokens": MAX_NEW}
            assign[rank].append(key)
            _write_json(os.path.join(root, f"inbox-{rank}", f"{key}.json"),
                        requests[key])
        victim = max(range(NPROCS), key=lambda r: (len(assign[r]), -r))
        survivors = [r for r in range(NPROCS) if r != victim]
        print(f"drill: dispatched 12 keys, victim=replica-{victim} "
              f"({len(assign[victim])} keys)", flush=True)

        # -- phase 2: SIGKILL the victim mid-stream --------------------
        deadline = time.monotonic() + 120
        while True:
            check_alive(range(NPROCS))
            done, _ = _read_completions(root, [victim])
            if done:
                break  # first completion landed; more are in flight
            if time.monotonic() > deadline:
                return _fail("victim produced no completions to race")
            time.sleep(0.05)
        incomplete = [k for k in assign[victim]
                      if k not in _read_completions(root, [victim])[0]]
        if not incomplete:
            return _fail("victim finished everything before the kill")
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait()
        print(f"drill: SIGKILLed replica-{victim} with "
              f"{len(incomplete)} keys in flight", flush=True)

        # detect the death by lease expiry ALONE (no process knowledge)
        deadline = time.monotonic() + 60
        while True:
            with open(_lease_path(root, victim)) as f:
                age = time.time() - float(json.load(f).get("time", 0))
            if age > LEASE_TIMEOUT:
                break
            if time.monotonic() > deadline:
                return _fail("victim lease never expired")
            time.sleep(0.1)
        if len(survivors) < 2:
            return _fail("fleet fell below min replicas after failover")

        # re-dispatch the dead replica's unfinished keys (same
        # idempotency key, survivors-only rendezvous rank)
        done_on_victim, _ = _read_completions(root, [victim])
        redispatched = 0
        for key in assign[victim]:
            if key in done_on_victim:
                continue
            r = requests[key]
            rank = servefleet.rendezvous_route(r["session"], survivors)
            _write_json(os.path.join(root, f"inbox-{rank}",
                                     f"{key}.json"), r)
            assign[rank].append(key)
            redispatched += 1
        print(f"drill: lease expired, re-dispatched {redispatched} keys",
              flush=True)

        deadline = time.monotonic() + 120
        while True:
            check_alive(survivors)
            first, occurrences = _read_completions(root, range(NPROCS))
            if all(k in first for k in requests):
                break
            if time.monotonic() > deadline:
                missing = [k for k in requests if k not in first]
                return _fail(f"keys never completed: {missing}")
            time.sleep(0.05)
        if any(n != 1 for n in occurrences.values()):
            dupes = {k: n for k, n in occurrences.items() if n != 1}
            return _fail(f"exactly-once violated: {dupes}")
        for key, r in requests.items():
            if first[key] != expected(oracle, r["prompt"]):
                return _fail(f"greedy parity broke on {key}: "
                             f"{first[key]}")
        print("drill: 12/12 exactly-once with greedy parity", flush=True)

        # -- phase 3: rolling update from a published checkpoint -------
        params = dict(functional.param_arrays(net))
        params2 = {k: v + 0.5 for k, v in params.items()}
        scratch = ServeEngine(build_model(), **ENGINE_KW)
        scratch.update_weights(params2)
        canary_prompts = [[1, 2, 3], [9, 8, 7, 6]]
        card = servefleet.canary_card(scratch, canary_prompts, tokens=8)
        ckpt = servefleet.publish_checkpoint(
            os.path.join(root, "ckpt-gen1"), params2, canary=card, step=1)

        seq, extra = 0, 0
        for rank in survivors:
            seq += 1
            other = [r for r in survivors if r != rank][0]
            _write_json(os.path.join(root, f"control-{rank}.json"),
                        {"seq": seq, "cmd": "update", "checkpoint": ckpt})
            # service continuity: while this replica updates, live
            # traffic lands on the other one — the fleet never goes dark
            lkey = f"live-{seq}"
            lprompt = rng.randint(1, 512, size=5).tolist()
            _write_json(os.path.join(root, f"inbox-{other}",
                                     f"{lkey}.json"),
                        {"key": lkey, "prompt": lprompt,
                         "max_new_tokens": 8})
            extra += 1
            vpath = os.path.join(root, f"update-{rank}-{seq}.json")
            deadline = time.monotonic() + 120
            while not os.path.exists(vpath):
                check_alive(survivors)
                if time.monotonic() > deadline:
                    return _fail(f"update verdict never landed for "
                                 f"replica-{rank}")
                time.sleep(0.05)
            with open(vpath) as f:
                verdict = json.load(f)
            if not verdict["ok"]:
                return _fail(f"rolling update failed on replica-{rank}: "
                             f"{verdict['reason']}")
            if verdict["post_warmup_compiles"]:
                return _fail(f"replica-{rank} compiled post-warmup "
                             "during the rolling update")
        # every replica now serves generation 2: prove it with traffic
        pkey, pprompt = "postroll-0", [5, 4, 3, 2]
        rank = servefleet.rendezvous_route("postroll", survivors)
        _write_json(os.path.join(root, f"inbox-{rank}", f"{pkey}.json"),
                    {"key": pkey, "prompt": pprompt, "max_new_tokens": 8})
        extra += 1
        deadline = time.monotonic() + 60
        while True:
            check_alive(survivors)
            first, _ = _read_completions(root, survivors)
            if pkey in first:
                break
            if time.monotonic() > deadline:
                return _fail("post-rollout request never completed")
            time.sleep(0.05)
        if first[pkey] != expected(scratch, pprompt, 8):
            return _fail(f"post-rollout parity broke: {first[pkey]}")
        print("drill: rolling update landed on both survivors, "
              "zero compiles, new-generation parity", flush=True)

        # -- phase 4: bad canary -> auto-rollback ----------------------
        # find a perturbation that provably changes the greedy output,
        # so the gen-2 canary card genuinely disagrees with the weights
        scratch3 = ServeEngine(build_model(), **ENGINE_KW)
        params3 = None
        for perturb in (lambda v: -v, lambda v: v * 3.0,
                        lambda v: v + 7.0):
            cand = {k: perturb(v) for k, v in params2.items()}
            scratch3.update_weights(cand)
            for prompt, want in zip(card["prompts"], card["expected"]):
                req = scratch3.submit(prompt,
                                      max_new_tokens=card["tokens"])
                scratch3.run()
                if [int(t) for t in req.generated] != list(want):
                    params3 = cand
                    break
            if params3 is not None:
                break
        if params3 is None:
            return _fail("could not construct divergent bad weights")
        ckpt_bad = servefleet.publish_checkpoint(
            os.path.join(root, "ckpt-gen2"), params3, canary=card, step=2)
        seq += 1
        canary_rank = survivors[0]
        _write_json(os.path.join(root, f"control-{canary_rank}.json"),
                    {"seq": seq, "cmd": "update", "checkpoint": ckpt_bad})
        vpath = os.path.join(root, f"update-{canary_rank}-{seq}.json")
        deadline = time.monotonic() + 120
        while not os.path.exists(vpath):
            check_alive(survivors)
            if time.monotonic() > deadline:
                return _fail("rollback verdict never landed")
            time.sleep(0.05)
        with open(vpath) as f:
            verdict = json.load(f)
        if verdict["ok"] or "canary" not in str(verdict["reason"]):
            return _fail(f"bad canary was not rolled back: {verdict}")
        # rolled back == still serving generation 2, token-for-token
        rkey, rprompt = "rollback-0", [6, 6, 6]
        _write_json(os.path.join(root, f"inbox-{canary_rank}",
                                 f"{rkey}.json"),
                    {"key": rkey, "prompt": rprompt, "max_new_tokens": 8})
        extra += 1
        deadline = time.monotonic() + 60
        while True:
            check_alive(survivors)
            first, _ = _read_completions(root, survivors)
            if rkey in first:
                break
            if time.monotonic() > deadline:
                return _fail("post-rollback request never completed")
            time.sleep(0.05)
        if first[rkey] != expected(scratch, rprompt, 8):
            return _fail("replica served wrong generation after rollback")
        print("drill: bad canary rolled back, old generation intact",
              flush=True)

        # -- teardown + compile audit ----------------------------------
        for rank in survivors:
            seq += 1
            _write_json(os.path.join(root, f"control-{rank}.json"),
                        {"seq": seq, "cmd": "exit"})
        compiles = 0
        for rank in survivors:
            spath = os.path.join(root, f"stats-{rank}.json")
            deadline = time.monotonic() + 60
            while not os.path.exists(spath):
                if procs[rank].poll() not in (None, 0):
                    return _fail(f"worker {rank} died in teardown")
                if time.monotonic() > deadline:
                    return _fail(f"worker {rank} never wrote stats")
                time.sleep(0.05)
            with open(spath) as f:
                compiles += json.load(f)["post_warmup_compiles"]
            procs[rank].wait(timeout=60)
        if compiles:
            return _fail(f"survivors compiled post-warmup: {compiles}")

        print(f"SERVEFLEET_DRILL_OK keys={len(requests) + extra} "
              f"redispatched={redispatched} updates={len(survivors)} "
              f"rollback=ok compiles=0", flush=True)
        return 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        sys.exit(worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(drive(sys.argv[2]))
