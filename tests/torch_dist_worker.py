"""One rank of the port's multi-process tests (run under tools/launch.py).

Counterpart of ``tests/dist_worker.py`` for ``mxnet_tpu_torch``: it
imports the port and numpy only (never JAX or ``mxnet_tpu``, whose import
would join a JAX world from the same DMLC_* variables), runs on the CPU
over gloo (the launcher's local mode), and either asserts exact results
itself or writes what it computed to ``<out>/<case>_w<world>_r<rank>.npz``
for the test to hold against the JAX package. Every case prints
``CASE_OK <name> <rank>`` as it passes and ``TORCH_DIST_OK <case> <rank>``
at the end.

    python tools/launch.py -n 2 python tests/torch_dist_worker.py \
        kvstore <out dir>

Cases: ``collectives`` (each collective on the inputs of
:func:`coll_inputs`), ``kvstore`` (the dist stores, compression, the
optimizer on the store, dist_async, Horovod, the Trainer over dist_sync),
``retry`` (an injected collective timeout on rank 0, retried to the exact
sum), ``dp`` (``ShardedTrainStep`` over dp for every spec in
``<out>/dp_cases.json``, from the weights and data the test wrote) and
``mesh`` (the composed layouts of ``<out>/mesh_cases.json``: tp, pp, sp
steps, bundles across layouts, rebuild, ring attention, gpipe).
"""
import json
import os
import sys

import numpy as onp
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import collectives as coll



def ok(name):
    print(f"CASE_OK {name} {tmx.parallel.rank()}", flush=True)


def save(out, case, arrays):
    world, rank = tmx.parallel.world_size(), tmx.parallel.rank()
    onp.savez(os.path.join(out, f"{case}_w{world}_r{rank}.npz"), **arrays)


# -- the test side: start a world, collect it ----------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(n, case, out, env_extra=None):
    """Start ``tools/launch.py -n n`` over this script in a session of its
    own (so :func:`finish` can end every rank); the launcher's env never
    reaches the caller."""
    import subprocess
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
           str(n)]
    for k, v in (env_extra or {}).items():
        cmd += ["--env", f"{k}={v}"]
    cmd += [sys.executable, os.path.abspath(__file__), case, str(out)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO, start_new_session=True)


def finish(p, timeout):
    """(returncode, stdout, stderr) of a :func:`launch`; past ``timeout``
    every process of the world is killed and the run fails."""
    import signal
    import subprocess
    try:
        stdout, stderr = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        stdout, stderr = p.communicate()
        stderr += f"\n[world killed after {timeout} s]"
    return p.returncode, stdout, stderr


# -- inputs shared with the tests ---------------------------------------------

def coll_inputs(n):
    """Every rank's inputs of the collectives case, as global stacks
    (row r is rank r's)."""
    rs = onp.random.RandomState(0)
    return {
        "x": rs.randn(n, 3, 4).astype("float32"),
        "blocks": rs.randn(n * 2, 5).astype("float32"),
        "full": rs.randn(n * 3, 2).astype("float32"),
        "ring": rs.randn(n, 4).astype("float32"),
        "c": (rs.randn(n, 37) * 3).astype("float32"),
        "res": (rs.randn(n, 37) * 0.01).astype("float32"),
        "c2": (rs.randn(n, 37) * 3).astype("float32"),
    }


def trainer_data():
    """The Trainer case's global batch: 8 samples of 6 features."""
    rs = onp.random.RandomState(3)
    return (rs.randn(8, 6).astype("float32"),
            rs.randint(0, 4, (8,)).astype("int64"))


def trainer_net(weights=None):
    """Dense(8, relu) -> BatchNorm -> Dense(4) on the CPU."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=6, device="cpu"),
            nn.BatchNorm(in_channels=8, device="cpu"),
            nn.Dense(4, in_units=8, device="cpu"))
    net.initialize(seed=5)
    if weights is not None:
        tmx.functional.load_params(net, weights)
    return net


def fused_data():
    """The kernel-8 case's global batch: 8 images of 3 x 6 x 6."""
    rs = onp.random.RandomState(4)
    return (rs.randn(8, 3, 6, 6).astype("float32"),
            rs.randint(0, 3, (8,)).astype("int64"))


def fused_net():
    """[Conv2D 3x3 -> BatchNorm -> ReLU] fused (kernel 8's route, its
    plain version on the CPU), then Dense(3), from seed 2."""
    from mxnet_tpu_torch.gluon import nn
    body = nn.FusableSequential()
    body.add(nn.Conv2D(5, 3, padding=1, in_channels=3, use_bias=False,
                       device="cpu"),
             nn.BatchNorm(in_channels=5, device="cpu"),
             nn.Activation("relu"))
    net = nn.HybridSequential()
    net.add(body, nn.Dense(3, in_units=5 * 36, device="cpu"))
    net.initialize(seed=2)
    return net


def fused_train(net, kvstore, x, y, batch):
    """Two SGD-momentum steps with kernel 8's route forced on; the
    parameters after them, by name."""
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore=kvstore)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tmx.config.set("fused_conv_bn", "on")
    try:
        for _ in range(2):
            with tmx.autograd.record():
                loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
            tmx.autograd.backward(loss)
            tr.step(batch)
    finally:
        tmx.config.reset("fused_conv_bn")
    return {n: p.data().detach().numpy().copy()
            for n, p in net.collect_params().items()}


# -- collectives ----------------------------------------------------------------

def case_collectives(out):
    n, r = tmx.parallel.world_size(), tmx.parallel.rank()
    inp = {k: torch.from_numpy(v) for k, v in coll_inputs(n).items()}
    got = {}
    for op in ("sum", "max", "min", "mean"):
        got[f"allreduce_{op}"] = coll.allreduce(inp["x"][r], op=op)
    block = inp["blocks"][2 * r:2 * r + 2]
    got["allgather_tiled"] = coll.allgather(block)
    got["allgather_stacked"] = coll.allgather(block, tiled=False)
    got["reduce_scatter"] = coll.reduce_scatter(inp["full"])
    got["reduce_scatter_distinct"] = coll.reduce_scatter(inp["full"] + r)
    mesh = tmx.parallel.make_mesh({"dp": n}, devices=["cpu"])
    ring = [(i, (i + 1) % n) for i in range(n)]
    got["ppermute_ring"] = coll.ppermute(inp["ring"][r], mesh, "dp", ring)
    got["ppermute_partial"] = coll.ppermute(inp["ring"][r], mesh, "dp",
                                            [(0, 1)])
    for mode in ("int8", "bf16"):
        red, res = coll.compressed_allreduce(inp["c"][r], mesh, "dp", mode,
                                             residual=inp["res"][r])
        red2, res2 = coll.compressed_allreduce(inp["c2"][r], mesh, "dp",
                                               mode, residual=res)
        got.update({f"compressed_{mode}": red, f"compressed_{mode}_res": res,
                    f"compressed_{mode}_2": red2,
                    f"compressed_{mode}_res_2": res2})
    got["across_processes"] = coll.allreduce_across_processes(inp["x"][r])
    # a mesh smaller than the world strands ranks: a warning and the
    # mesh.unused_devices gauge (reference: tests/test_mesh_compose.py:104)
    import warnings
    tmx.telemetry.enable()
    tmx.telemetry.reset()
    gauges = []
    for dp in (1, n):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m = tmx.parallel.make_mesh({"dp": dp}, devices=["cpu"])
        gauges.append([sum("stranded" in str(x.message) for x in w),
                       tmx.telemetry.snapshot()["gauges"][
                           "mesh.unused_devices"],
                       -1 if m.rank is None else m.rank])
    tmx.telemetry.disable()
    got["stranded"] = torch.tensor(gauges)
    save(out, "collectives", {k: v.numpy() for k, v in got.items()})
    ok("collectives")


# -- the dist stores ------------------------------------------------------------

def check_eq(arr, expect, what):
    got = arr.numpy() if isinstance(arr, torch.Tensor) else arr.asnumpy()
    assert onp.array_equal(got, onp.full(got.shape, expect, got.dtype)), \
        f"{what}: expected {expect}, got {got.ravel()[:4]}"


def case_kvstore(out):
    from mxnet_tpu_torch import kvstore
    kv = kvstore.create("dist_sync")
    n, rank = kv.num_workers, kv.rank
    assert n > 1, "launcher did not create a multi-process world"
    shape = (4, 3)

    # SyncBatchNorm: the running statistics of the global batch; a plain
    # BatchNorm (no dist Trainer updates its parameters): its rank's own
    from mxnet_tpu_torch.gluon import nn
    xb = torch.from_numpy(trainer_data()[0])
    k = len(xb) // n

    def bn_stats(kind):
        bn = (nn.SyncBatchNorm if kind == "sync" else nn.BatchNorm)(
            in_channels=6, device="cpu")
        bn.initialize()
        with tmx.autograd.record():
            bn(xb[rank * k:(rank + 1) * k])
        return {f"{kind}/mean": bn.running_mean.detach().numpy().copy(),
                f"{kind}/var": bn.running_var.detach().numpy().copy()}

    save(out, "syncbn", {**bn_stats("sync"), **bn_stats("local")})
    ok("sync_batchnorm")

    # plain sync push/pull and pushpull: exact sums across workers
    kv.init("w0", torch.zeros(shape))
    kv.push("w0", torch.full(shape, float(rank + 1)))
    o = torch.empty(shape)
    kv.pull("w0", out=o)
    check_eq(o, sum(range(1, n + 1)), "push/pull sum")
    kv.pushpull("w0", torch.ones(shape), out=o)
    check_eq(o, float(n), "pushpull")
    ok("exact_sum")

    # mx.np arrays through dist_device_sync
    kvd = kvstore.create("dist_device_sync")
    kvd.init(7, tmx.np.zeros(shape))
    a = tmx.np.zeros(shape)
    kvd.pushpull(7, tmx.np.full(shape, 2.0 * (rank + 1)), out=a)
    check_eq(a, 2.0 * sum(range(1, n + 1)), "dist_device_sync np arrays")
    ok("device_sync_np")

    # 2-bit compression: quantize with the residual before the reduce
    kv2 = kvstore.DistKVStore("dist_sync")
    kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv2.init("c0", torch.zeros(shape))
    kv2.push("c0", torch.full(shape, 0.3))
    kv2.pull("c0", out=o)
    check_eq(o, 0.0, "2bit first push (all residual)")
    kv2.push("c0", torch.full(shape, 0.3))
    kv2.pull("c0", out=o)
    check_eq(o, 0.5 * n, "2bit second push (residual crossed threshold)")
    ok("compression_2bit")

    # the optimizer on the store: the update runs on every rank after the
    # reduce, so the stored weights are equal everywhere
    kv3 = kvstore.DistKVStore("dist_sync")
    kv3.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1))
    kv3.init(3, torch.zeros(shape))
    kv3.push(3, torch.full(shape, 1.0))
    kv3.pull(3, out=o)
    check_eq(o, onp.float32(-0.1) * n, "sgd on kvstore")
    ok("update_on_kvstore")

    # dist_async: a push updates only the local replica; a pull reconciles
    kv4 = kvstore.create("dist_async")
    assert isinstance(kv4, kvstore.DistAsyncKVStore)
    kv4.set_optimizer(tmx.optimizer.create("sgd", learning_rate=1.0))
    kv4.init("a0", torch.zeros(shape))
    kv4.push("a0", torch.full(shape, float(rank + 1)))
    local = kv4._store["a0"].numpy()
    assert onp.allclose(local, -(rank + 1)), \
        f"async push leaked across workers: {local.ravel()[:3]}"
    kv4.pull("a0", out=o)
    check_eq(o, onp.float32(-sum(range(1, n + 1))) / n,
             "async pull reconciliation")
    ok("dist_async_reconcile")

    # Horovod: broadcast_parameters from rank 0, then an all-reduce push
    hv = kvstore.create("horovod")
    p = {"h": torch.full(shape, float(rank + 10))}
    hv.broadcast_parameters(p)
    check_eq(p["h"], 10.0, "horovod broadcast")
    hv.pushpull("h", torch.full(shape, 1.0), out=o)
    check_eq(o, float(n), "horovod pushpull")
    assert kvstore.create("byteps").num_workers == n
    ok("horovod")

    # telemetry: each completed collective counted with its payload
    tmx.telemetry.enable()
    tmx.telemetry.reset()
    kv.pushpull("w0", torch.ones(shape), out=o)
    c = tmx.telemetry.counters("kvstore.")
    assert c.get('kvstore.collective_total{op="allreduce"}') == 1, c
    assert c.get("kvstore.payload_bytes_total") == 4 * 12, c
    tmx.telemetry.disable()
    ok("telemetry")

    # the Trainer over dist_sync: each rank its half of the global batch,
    # global BatchNorm statistics, gradients summed before the update
    weights = dict(onp.load(os.path.join(out, "trainer_init.npz")))
    x, y = trainer_data()
    k = len(x) // n
    res = {}
    for tag, kw in (("plain", {}), ("on_kvstore",
                                    {"update_on_kvstore": True})):
        net = trainer_net(weights)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore="dist_sync", **kw)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        xs = torch.from_numpy(x[rank * k:(rank + 1) * k])
        ys = torch.from_numpy(y[rank * k:(rank + 1) * k])
        for _ in range(2):
            with tmx.autograd.record():
                loss = loss_fn(net(xs), ys)
            tmx.autograd.backward(loss)
            tr.step(len(x))
        for name, prm in net.collect_params().items():
            res[f"{tag}/{name}"] = prm.data().detach().numpy()
    save(out, "trainer", res)
    # the Trainers above marked only their own parameters: a BatchNorm
    # outside them still takes its rank's own statistics
    save(out, "bn_outside", bn_stats("local"))
    ok("trainer_dist_sync")

    # kernel 8's route (its plain version here) under dist_sync: the
    # forward's statistics and the stats pass's sums are the global batch's
    from mxnet_tpu_torch.ops import conv_bwd
    calls = []
    orig = conv_bwd.fused_conv3x3_bn_relu_bwd_plain

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    conv_bwd.fused_conv3x3_bn_relu_bwd_plain = counted
    try:
        x, y = fused_data()
        got = fused_train(fused_net(), "dist_sync",
                          x[rank * 4:(rank + 1) * 4],
                          y[rank * 4:(rank + 1) * 4], len(x))
    finally:
        conv_bwd.fused_conv3x3_bn_relu_bwd_plain = orig
    assert len(calls) == 2, calls  # one triplet, two steps
    save(out, "fused", got)
    ok("trainer_kernel8_route")


def case_retry(out):
    """Retries that keep the ranks' collectives in step: an injected
    timeout on rank 0 (its attempt never reached the group) issued again
    to the exact sum; a peer slower than the watchdog, whose sum rank 0
    still gets by waiting again for its attempt, with the next collective
    in step; a peer slower than rank 0's whole budget: rank 0 raises
    WorkerLost, gives the group up and refuses later collectives instead
    of pairing them with the abandoned one."""
    import time
    from mxnet_tpu_torch import kvstore
    kv = kvstore.create("dist_sync")
    n, rank = kv.num_workers, kv.rank
    assert n == 2, "launcher did not create a world of two"
    shape = (4, 3)
    total = sum(range(1, n + 1))

    def pushpull(key, scale=1.0):
        o = torch.empty(shape)
        kv.pushpull(key, torch.full(shape, scale * (rank + 1)), out=o)
        return o

    def stats():
        return tmx.fault.stats()

    # 1. an injected timeout on rank 0: issued again, the exact sum
    if rank == 0:
        tmx.config.set("kvstore.async_timeout", 4.0)
        tmx.config.set("kvstore.retry_backoff", 0.2)
        tmx.config.set("kvstore.rejoin_timeout", 2.0)
        tmx.fault.configure("kvstore.collective_timeout:at=1")
    else:
        tmx.config.set("kvstore.async_timeout", 120.0)
    kv.init("r0", torch.zeros(shape))
    check_eq(pushpull("r0"), total, "retried push/pull sum")
    if rank == 0:
        st = stats()
        assert st.get("resilience.collective_retry", 0) == 1, st
        assert st.get("kvstore.collective_timeout_raised", 0) == 1, st
        tmx.fault.clear()
    ok("retry")
    # 2. rank 1 slower than rank 0's watchdog: rank 0 waits again for
    # the attempt already in the group (issuing it again would pair with
    # rank 1's next collective), gets the exact sum, and stays in step
    tmx.fault.reset_stats()
    tmx.config.set("kvstore.async_timeout", 2.0)
    tmx.config.set("kvstore.retry_backoff", 0.1)
    tmx.config.set("kvstore.rejoin_timeout", 1.0)
    tmx.config.set("kvstore.retry_max", 2)
    kv.init("s0", torch.zeros(shape))
    kv.init("s1", torch.zeros(shape))
    if rank == 1:
        time.sleep(3.0)
    check_eq(pushpull("s0"), total, "slow peer: sum")
    check_eq(pushpull("s1", 10.0), 10.0 * total, "slow peer: next sum")
    if rank == 0:
        st = stats()
        assert st.get("resilience.collective_retry", 0) >= 1, st
    ok("retry_slow_peer")
    # 3. rank 1 slower than rank 0's whole budget: WorkerLost on rank 0,
    # the group given up, the next collective refused (not paired with
    # rank 1's late push)
    kv.init("c0", torch.zeros(shape))
    kv.init("c1", torch.zeros(shape))
    # rank 0 stays up until rank 1 is done (its attempt at c0 is the one
    # rank 1's late push pairs with); the store is outside the group
    store = torch.distributed.distributed_c10d._get_default_store()
    if rank == 0:
        tmx.config.set("kvstore.async_timeout", 1.5)
        tmx.config.set("kvstore.retry_max", 1)
        tmx.config.set("kvstore.rejoin_timeout", 0.5)
        try:
            pushpull("c0")
            raise AssertionError("rank 0 got a sum it cannot have")
        except tmx.resilience.WorkerLost as e:
            assert e.attempts == 2, e.attempts
        for call in (lambda: pushpull("c1"),
                     lambda: coll.allreduce(torch.ones(2))):
            try:
                call()
                raise AssertionError("a collective ran in a given-up group")
            except tmx.MXNetError as e:
                assert "given up" in str(e), e
        store.wait(["retry_rank1_done"])
    else:
        time.sleep(5.0)
        # pairs with rank 0's attempt, which was still in the group
        check_eq(pushpull("c0"), total, "late peer: sum")
        tmx.config.set("kvstore.async_timeout", 1.0)
        tmx.config.set("kvstore.retry_max", 0)
        try:
            pushpull("c1")
            raise AssertionError("rank 1 got a sum rank 0 never sent")
        except tmx.kv.CollectiveTimeout:
            pass
        store.set("retry_rank1_done", "1")
    ok("retry_given_up")


# -- ShardedTrainStep over dp ----------------------------------------------------

def dp_loss(model):
    if model in ("gpt", "gpt_fp8"):
        from mxnet_tpu_torch.ops.xent import sparse_softmax_xent

        def loss(out, y):
            return sparse_softmax_xent(out, y.long()).mean()
        return loss
    if model == "bn":
        return lambda out, y: ((out - y) ** 2).mean()

    def ce(out, y):
        logp = torch.log_softmax(out.float(), -1)
        return -logp.gather(-1, y.long()[:, None]).mean()
    return ce


def dp_model(model):
    from mxnet_tpu_torch.gluon import nn
    if model == "dense":
        net = nn.Dense(10, in_units=8, device="cpu")
    elif model == "bn":
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=6, device="cpu"),
                nn.BatchNorm(in_channels=4, device="cpu"))
    else:
        from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
        cfg = (dict(vocab_size=64, units=16, num_layers=2, num_heads=2,
                    max_length=8) if model == "gpt" else
               dict(vocab_size=101, units=64, hidden_size=128,
                    num_layers=2, num_heads=4, max_length=32))
        net = GPTForCausalLM(device="cpu", dropout=0.0, embed_dropout=0.0,
                             **cfg)
    net.initialize(seed=0)
    return net


def dp_step(spec, out, mesh=None):
    """The port's step of ``spec`` from the test's initial weights."""
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    net = dp_model(spec["model"])
    init = dict(onp.load(os.path.join(out, f"init_{spec['model']}.npz")))
    tmx.functional.load_params(net, init)
    for name, p in net.collect_params().items():
        if "key_proj.bias" in name:
            p.grad_req = "null"
    if spec.get("hybridize_remat"):
        net.hybridize(remat=spec["hybridize_remat"])
    cfg = mesh or MeshConfig(dp=tmx.parallel.world_size())
    specs = ((("dp", None), ("dp", None))
             if spec["model"] in ("gpt", "gpt_fp8") else (("dp",), ("dp",)))
    return ShardedTrainStep(
        net, dp_loss(spec["model"]),
        tmx.optimizer.create(spec["opt"], **spec.get("opt_kw", {})), cfg,
        specs, **spec.get("kw", {}))


def dp_batches(spec, out):
    data = onp.load(os.path.join(out, f"data_{spec['name']}.npz"))
    return [(data[f"x{i}"], data[f"y{i}"]) for i in range(spec["steps"])]


def dp_run(step, spec, out, batches=None):
    losses = []
    for x, y in batches or dp_batches(spec, out):
        losses.append(float(step(x, y)))
    return losses


def dp_result(step, losses):
    res = {"losses": onp.asarray(losses, "float64")}
    for n, w in step.params.items():
        res[f"w/{n}"] = w.detach().numpy()
    for n, v in step.aux.items():
        res[f"aux/{n}"] = v.detach().numpy()
    for site, hist in step.extra["fp8"].items():
        for k, v in hist.items():
            res[f"fp8/{site}/{k}"] = v.numpy()
    return res


def case_dp(out):
    world = tmx.parallel.world_size()
    with open(os.path.join(out, "dp_cases.json")) as f:
        cases = json.load(f)
    for spec in cases:
        if world not in spec["worlds"]:
            continue
        name = spec["name"]
        counters = spec.get("counters")
        if counters:
            tmx.telemetry.enable()
            tmx.telemetry.reset()
        step = dp_step(spec, out)
        losses = dp_run(step, spec, out)
        res = dp_result(step, losses)
        if counters:
            for k, v in tmx.telemetry.counters().items():
                if k.startswith(("zero.", "mesh.", "comm.")):
                    res[f"counter/{k}"] = onp.asarray(v)
            tmx.telemetry.disable()
        save(out, f"dp_{name}", res)
        ok(f"dp_{name}")
    dp_bundles(out, world)
    print(f"TORCH_DIST_OK dp {tmx.parallel.rank()}", flush=True)


def dp_bundles(out, world):
    """Checkpoints across layouts, TrainState, prefetch and the
    reference's bundle."""
    spec = {"name": "bundle", "model": "dense", "opt": "adam",
            "opt_kw": {"learning_rate": 0.05}, "steps": 4}
    batches = dp_batches(spec, out)
    # a canonical bundle written by a one-process zero=0 step loads bit for
    # bit into this world at every ZeRO level and continues alike
    src = os.path.join(out, "bundle_w1.safetensors")
    for zero in (0, 1, 2):
        step = dp_step({**spec, "kw": {"zero": zero}}, out)
        step.load_states(src)
        canon = step.state_dict()["arrays"]
        got = {k: canon[k] for k in canon}
        losses = dp_run(step, spec, out, batches[2:])
        save(out, f"bundle_load_z{zero}", {
            **{f"canon/{k}": v for k, v in got.items()},
            **dp_result(step, losses)})
    ok("bundle_load")
    # this world saves at zero=2 after two steps (the test loads it into a
    # one-process zero=0 step)
    step = dp_step({**spec, "kw": {"zero": 2}}, out)
    dp_run(step, spec, out, batches[:2])
    step.save_states(os.path.join(out, f"bundle_w{world}.safetensors"))
    save(out, "bundle_saved", {f"canon/{k}": v for k, v in
                               step.state_dict()["arrays"].items()})
    ok("bundle_save")
    # TrainState(sharded_step=...): an interrupted run resumes bit for bit
    full = dp_step({**spec, "kw": {"zero": 1}}, out)
    want = dp_run(full, spec, out, batches[:3])
    part = dp_step({**spec, "kw": {"zero": 1}}, out)
    path = os.path.join(out, f"run_w{world}.bundle")
    state = tmx.resilience.TrainState(sharded_step=part, path=path)
    dp_run(part, spec, out, batches[:2])
    state.step = 2
    state.save()  # every rank gathers; rank 0 writes
    torch.distributed.barrier()
    fresh = dp_step({**spec, "kw": {"zero": 1}}, out)
    state2 = tmx.resilience.TrainState(sharded_step=fresh, path=path)
    state2.load()
    assert state2.step == 2 and fresh._n_step == 2
    got = dp_run(fresh, spec, out, batches[2:3])
    assert got == want[2:], (got, want)
    for n, w in full.params.items():
        assert torch.equal(w, fresh.params[n]), n
    ok("trainstate")
    # prefetch stages this rank's part; the steps equal direct calls
    a = dp_step({**spec, "kw": {"zero": 1}}, out)
    b = dp_step({**spec, "kw": {"zero": 1}}, out)
    la = dp_run(a, spec, out, batches[:2])
    lb = [float(b(*bt)) for bt in b.prefetch(iter(batches[:2]))]
    assert la == lb, (la, lb)
    for n, w in a.params.items():
        assert torch.equal(w, b.params[n]), n
    ok("prefetch")
    # the JAX package's bundle (saved at dp=4) continues here
    ref = dict(onp.load(os.path.join(out, "ref_bundle.npz")))
    n_step = int(ref.pop("__n_step__"))
    step = dp_step({**spec, "kw": {"zero": 1}}, out)
    step.load_reference_state_dict({"arrays": ref, "n_step": n_step})
    losses = dp_run(step, spec, out, batches[2:])
    save(out, "ref_bundle_cont", dp_result(step, losses))
    ok("reference_bundle")



# -- composed layouts: tp, pp, sp ---------------------------------------------

def mesh_model(spec, out):
    """The port's model of a composed-layout case from the test's initial
    weights (the attention key projection's bias frozen, as the dp cases
    freeze it: its gradient is zero in exact arithmetic)."""
    from mxnet_tpu_torch.gluon import nn
    model = spec["model"]
    if model == "dense256":
        net = nn.Dense(256, in_units=128, device="cpu")
        net.initialize(seed=0)
    elif model == "bert":
        from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
        net = BERTForPretraining(device="cpu", dropout=0.0,
                                 embed_dropout=0.0, **BERT_CFG)
        net.initialize(seed=0)
    else:
        net = dp_model(model)
    tmx.functional.load_params(
        net, dict(onp.load(os.path.join(out, f"init_{model}.npz"))))
    return net


BERT_CFG = dict(vocab_size=96, units=64, hidden_size=128, num_layers=2,
                num_heads=4, max_length=32)


def mesh_loss(model):
    if model == "dense256":
        return lambda o, t: ((o - t) ** 2).mean()
    if model == "bert":
        from mxnet_tpu_torch.ops.xent import sparse_softmax_xent

        def loss(outputs, labels):
            return sparse_softmax_xent(outputs[0], labels.long()).mean()
        return loss
    return dp_loss(model)


def mesh_step(spec, out, cfg=None, **over):
    """The port's ShardedTrainStep of a composed-layout case."""
    from mxnet_tpu_torch.parallel import MeshConfig, P, ShardedTrainStep
    net = mesh_model(spec, out)
    if spec["model"] != "dense256":
        for name, p in net.collect_params().items():
            if "key_proj.bias" in name:
                p.grad_req = "null"
    cfg = cfg or MeshConfig(**spec["cfg"])
    kw = {**spec.get("kw", {}), **over}
    if "param_specs" in spec:
        kw["param_specs"] = {k: P(*v) for k, v in
                             spec["param_specs"].items()}
    specs = [P(*s) for s in spec["batch_specs"]] if "batch_specs" in spec \
        else cfg.batch_specs(2, 2)
    return ShardedTrainStep(
        net, mesh_loss(spec["model"]),
        tmx.optimizer.create(spec["opt"], **spec.get("opt_kw", {})), cfg,
        specs, **kw)


def mesh_batches(spec, out):
    data = onp.load(os.path.join(out, f"data_{spec['data']}.npz"))
    n = len([k for k in data.files if k.startswith("b0_")])
    return [tuple(data[f"b{i}_{j}"] for j in range(n))
            for i in range(spec["steps"])]


def state_bytes_rank(step):
    """Bytes of optimizer state this rank holds."""
    from mxnet_tpu_torch.parallel.train import _leaves
    return sum(x.numel() * x.element_size()
               for s in step.states.values() for x in _leaves(s))


def canon(step):
    return {f"canon/{k}": v for k, v in step.state_dict()["arrays"].items()}


def run_mesh_case(spec, out):
    counters = spec.get("counters")
    if counters:
        tmx.telemetry.enable()
        tmx.telemetry.reset()
    step = mesh_step(spec, out)
    losses = [float(step(*b)) for b in mesh_batches(spec, out)]
    params = step.block.collect_params()
    others = [params[n].data() for n in params if not step._owned(n)]
    res = {"losses": onp.asarray(losses, "float64"), **canon(step),
           "state_bytes": onp.asarray(state_bytes_rank(step)),
           # the other pp stages' layers: how many, and the storage they
           # keep while the block is sharded
           "other_stage": onp.asarray(
               [len(others), sum(v.untyped_storage().nbytes()
                                 for v in others),
                sum(v.element_size() for v in others)])}
    if counters:
        for k, v in tmx.telemetry.counters().items():
            if k.startswith(("zero.", "mesh.", "comm.")):
                res[f"counter/{k}"] = onp.asarray(v)
        tmx.telemetry.disable()
    return step, res


def case_mesh(out):
    """Every case of ``<out>/mesh_cases.json`` whose world is this one."""
    torch.set_num_threads(1)
    world, rank = tmx.parallel.world_size(), tmx.parallel.rank()
    with open(os.path.join(out, "mesh_cases.json")) as f:
        cases = json.load(f)
    for spec in cases:
        if spec["world"] != world:
            continue
        kind = spec.get("kind", "step")
        res = {"bundles": mesh_bundles, "rebuild": mesh_rebuild,
               "ring": mesh_ring, "gpipe": mesh_gpipe,
               "tp_fns": mesh_tp_fns,
               "step": lambda s, o: run_mesh_case(s, o)[1]}[kind](spec, out)
        save(out, spec["name"], res)
        ok(spec["name"])
    print(f"TORCH_DIST_OK mesh {rank}", flush=True)


def _assert_same(a, b, what):
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b))[:4])
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, \
            (what, k)
        assert onp.array_equal(a[k], b[k]), (what, k)


def mesh_bundles(spec, out):
    """Bundles across layouts (dp4 x tp2 zero 1 <-> dp2 x tp2 x pp2), the
    JAX package's bundle, and TrainState over a composed step."""
    from mxnet_tpu_torch.parallel import MeshConfig
    bt = mesh_batches(spec, out)
    a_cfg, b_cfg = MeshConfig(dp=4, tp=2), MeshConfig(dp=2, tp=2, pp=2)
    a = mesh_step(spec, out, a_cfg, zero=1)
    for b in bt[:2]:
        a(*b)
    f1 = os.path.join(out, "mesh_a.safetensors")
    a.save_states(f1)
    torch.distributed.barrier()
    b = mesh_step(spec, out, b_cfg)
    b.load_states(f1)
    sa, sb = a.state_dict()["arrays"], b.state_dict()["arrays"]
    _assert_same(sa, sb, "dp4tp2 -> dp2tp2pp2")
    la = [float(a(*x)) for x in bt[2:4]]
    lb = [float(b(*x)) for x in bt[2:4]]
    f2 = os.path.join(out, "mesh_b.safetensors")
    b.save_states(f2)
    torch.distributed.barrier()
    c = mesh_step(spec, out, a_cfg, zero=1)
    c.load_states(f2)
    _assert_same(b.state_dict()["arrays"], c.state_dict()["arrays"],
                 "dp2tp2pp2 -> dp4tp2")
    # TrainState carries a composed step
    d = mesh_step(spec, out, b_cfg)
    d(*bt[0])
    path = os.path.join(out, "mesh_run.bundle")
    st = tmx.resilience.TrainState(sharded_step=d, path=path)
    st.step = 1
    st.save()
    torch.distributed.barrier()
    e = mesh_step(spec, out, a_cfg, zero=1)
    st2 = tmx.resilience.TrainState(sharded_step=e, path=path)
    st2.load()
    assert st2.step == 1 and e._n_step == 1
    _assert_same(d.state_dict()["arrays"], e.state_dict()["arrays"],
                 "TrainState")
    # the JAX package's bundle (dp4 x tp2 zero 1 after 2 steps) into
    # dp2 x tp2 x pp2, its canonical arrays bit for bit
    ref = dict(onp.load(os.path.join(out, "ref_mesh_bundle.npz")))
    n_step = int(ref.pop("__n_step__"))
    f = mesh_step(spec, out, b_cfg)
    f.load_reference_state_dict({"arrays": ref, "n_step": n_step})
    got = f.state_dict()["arrays"]
    for k, v in ref.items():
        assert onp.array_equal(got[k], v), ("reference bundle", k)
    lf = [float(f(*x)) for x in bt[2:4]]
    return {"la": onp.asarray(la), "lb": onp.asarray(lb),
            "lf": onp.asarray(lf), **{f"a/{k}": v for k, v in sa.items()}}


def mesh_rebuild(spec, out):
    """dp2 x tp2 x pp2 for two steps, rebuilt to dp4 x tp2, one more."""
    from mxnet_tpu_torch.parallel import MeshConfig
    bt = mesh_batches(spec, out)
    a = mesh_step(spec, out, MeshConfig(dp=2, tp=2, pp=2))
    losses = [float(a(*b)) for b in bt[:2]]
    a.sync_to_block()
    whole = dict(tmx.functional.param_arrays(a.block))
    r = a.rebuild(MeshConfig(dp=4, tp=2))
    assert r._n_step == 2 and r.mesh.shape["dp"] == 4
    losses += [float(r(*b)) for b in bt[2:3]]
    return {"losses": onp.asarray(losses), **canon(r),
            **{f"whole/{k}": v for k, v in whole.items()}}


def mesh_ring(spec, out):
    """ring_attention's plain and kernel routes on this rank's block."""
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.ring_attention import _kernels, _plain
    routes = {"plain": _plain, "kernels": _kernels}
    n = spec["sp"]
    mesh = make_mesh({"sp": n}, devices=["cpu"])
    data = dict(onp.load(os.path.join(out, "ring_inputs.npz")))
    res = {}
    if mesh.rank is None:
        return res
    r = mesh.rank
    for causal in (False, True):
        for route in ("plain", "kernels"):
            ts = []
            for key in ("q", "k", "v"):
                full = torch.from_numpy(data[key])
                s = full.shape[2] // n
                ts.append(full[:, :, r * s:(r + 1) * s].clone()
                          .requires_grad_())
            o = routes[route](*ts, mesh, "sp", causal,
                              1.0 / ts[0].shape[-1] ** 0.5)
            cot = torch.from_numpy(data["cot"])
            s = cot.shape[2] // n
            (o * cot[:, :, r * s:(r + 1) * s]).sum().backward()
            tag = f"{int(causal)}_{route}"
            res[f"out_{tag}"] = o.detach().numpy()
            for key, t in zip("qkv", ts):
                res[f"d{key}_{tag}"] = t.grad.numpy()
    return res


def mesh_tp_fns(spec, out):
    """parallel.tp's functions on a 2-layer MLP over tp = the world: the
    output and the input's gradient as the whole MLP's, and unshard gives
    back its weights bit for bit."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import make_mesh, tp
    mesh = make_mesh({"tp": tmx.parallel.world_size()}, devices=["cpu"])

    def mlp():
        net = nn.HybridSequential()
        net.add(nn.Dense(256, in_units=128, activation="relu",
                         device="cpu"),
                nn.Dense(128, in_units=256, device="cpu"))
        net.initialize(seed=3)
        return net

    x = torch.from_numpy(onp.random.RandomState(0).randn(4, 128)
                         .astype("float32"))
    res = {}
    for how in ("column_row", "mlp", "auto"):
        ref, net = mlp(), mlp()
        if how == "column_row":
            tp.shard_dense_column(net[0], mesh)
            tp.shard_dense_row(net[1], mesh)
        elif how == "mlp":
            tp.shard_mlp(net[0], net[1], mesh)
        else:
            tp.auto_shard_block(net, mesh, tp_axis="tp")
        assert all(m._tp is not None for m in (net[0], net[1])), how
        outs = []
        for m in (ref, net):
            xi = x.clone().requires_grad_()
            with tmx.autograd.record():
                y = m(xi)
            (y * torch.arange(128.0)).sum().backward()
            outs.append((y.detach().numpy(), xi.grad.numpy()))
        res[f"{how}/y"], res[f"{how}/dx"] = outs[1]
        res[f"{how}/y_ref"], res[f"{how}/dx_ref"] = outs[0]
        tp.unshard(net)
        for a, b in zip(net.collect_params().values(),
                        ref.collect_params().values()):
            assert torch.equal(a.data(), b.data()), how
    return res


def mesh_gpipe(spec, out):
    """gpipe over pp = the world: values and the stacked weights'
    gradient (rank rows summed over pp), and the stage-count rejection."""
    from mxnet_tpu_torch.parallel import (gpipe, make_mesh, shard_stages,
                                          stack_stage_params)
    from mxnet_tpu_torch.parallel import collectives as c
    data = dict(onp.load(os.path.join(out, "gpipe_inputs.npz")))
    S = tmx.parallel.world_size()
    mesh = make_mesh({"pp": S}, devices=["cpu"])
    ws = [{"w": torch.from_numpy(data[f"w{i}"])} for i in range(S)]
    params = shard_stages(stack_stage_params(ws), mesh)
    params["w"].requires_grad_()
    xs = torch.from_numpy(data["xs"])

    def stage(p, x):
        return torch.tanh(x @ p["w"])

    ys = gpipe(stage, params, xs, mesh)
    ys.sum().backward()
    grad = c.allreduce(params["w"].grad, mesh, "pp")
    rejected = 0
    try:
        gpipe(lambda p, x: x @ p["w"], stack_stage_params(
            [{"w": torch.ones(4, 4)} for _ in range(8)]),
            torch.ones(2, 2, 4), mesh)
    except ValueError as e:
        rejected = int("pp axis size" in str(e))
    return {"ys": ys.detach().numpy(), "grad": grad.numpy(),
            "rejected": onp.asarray(rejected)}

def main():
    case, out = sys.argv[1], sys.argv[2]
    with tmx.cpu():
        {"collectives": case_collectives, "kvstore": case_kvstore,
         "retry": case_retry, "dp": case_dp, "mesh": case_mesh}[case](out)
    if case not in ("dp", "mesh"):
        print(f"TORCH_DIST_OK {case} {tmx.parallel.rank()}", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
