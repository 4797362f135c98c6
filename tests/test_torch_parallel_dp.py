"""``ShardedTrainStep`` over dp in real 2- and 4-rank worlds against the
JAX package's step on the 8-device virtual mesh.

The models are the reference tests' (``tests/test_zero.py:26-56``: Dense(10,
in 8) under a softmax cross entropy, batch 16; ``tests/test_mesh_compose.
py:29-60``: a tiny GPT, vocab 64, 16 units, 2 layers, 2 heads, seq 8, batch
8; ``tests/test_parallel.py:420``: Dense -> BatchNorm; the fp8 GPT of
``test_torch_fp8.py``). This process writes each model's initial weights
(from the JAX package) and each case's batches, starts one launch of
``torch_dist_worker.py dp`` a world (2 and 4 ranks, together), runs the
reference at the same dp meanwhile, and compares.

Tolerances, and why: the reference reduces over the global batch in one
XLA program; a rank here takes the mean of its shard and the ranks' sum
follows, another order of fp32 sums. Losses rtol 1e-5 / atol 1e-6 and
weights rtol 1e-5 / atol 1e-5 after 3 Adam or SGD updates (the
reference's own ZeRO-vs-replicated bounds); BatchNorm's running
statistics rtol 1e-5 / atol 1e-6. The GPT cases take Adam at lr 1e-3, as
``test_torch_fp8.py``'s one-card comparison does: Adam turns the float
noise of a near-zero gradient into steps of up to +-lr, so at the
reference test's lr 0.01 a few elements in 50k differ by ~4e-5 whatever
the layout. fp8 as ``test_torch_fp8.py`` holds one
card (losses rtol 1e-4; weights: under 1% of elements off by more than
5e-4, none by more than 3e-3). Bit for bit: the weights across ranks,
remat against no remat, bundles across world sizes and ZeRO levels
(state_dict arrays), TrainState resume, prefetch against direct calls.
"""
import json
import os
import sys

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.train import ShardedTrainStep as JStep

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

ADAM = {"opt": "adam", "opt_kw": {"learning_rate": 0.05}}
SGD = {"opt": "sgd", "opt_kw": {"learning_rate": 0.1, "momentum": 0.9}}
CASES = [
    {"name": "dense_z0", "model": "dense", **ADAM, "kw": {}, "steps": 3,
     "worlds": [2, 4]},
    {"name": "dense_z1", "model": "dense", **ADAM, "kw": {"zero": 1},
     "steps": 3, "worlds": [2, 4], "counters": True},
    {"name": "dense_z2_accum2", "model": "dense", **ADAM,
     "kw": {"zero": 2, "grad_accum": 2}, "steps": 3, "worlds": [2, 4],
     "counters": True},
    {"name": "dense_accum4", "model": "dense", **ADAM,
     "kw": {"grad_accum": 4}, "steps": 3, "worlds": [2]},
    {"name": "dense_spc3_z1", "model": "dense", **ADAM,
     "kw": {"steps_per_call": 3, "zero": 1}, "steps": 2, "worlds": [2]},
    {"name": "dense_remat_dots", "model": "dense", **ADAM,
     "kw": {"remat": "dots"}, "steps": 3, "worlds": [2]},
    {"name": "dense_remat_true", "model": "dense", **ADAM,
     "kw": {"remat": True}, "steps": 3, "worlds": [2]},
    {"name": "dense_int8", "model": "dense", **SGD,
     "kw": {"grad_compress": "int8"}, "steps": 3, "worlds": [2, 4],
     "counters": True},
    {"name": "dense_bf16_z1", "model": "dense", **SGD,
     "kw": {"grad_compress": "bf16", "zero": 1}, "steps": 3,
     "worlds": [2]},
    {"name": "gpt_z1", "model": "gpt", "opt": "adam",
     "opt_kw": {"learning_rate": 1e-3}, "kw": {"zero": 1}, "steps": 3,
     "worlds": [2, 4]},
    {"name": "gpt_z2_hybrid_remat", "model": "gpt", "opt": "adam",
     "opt_kw": {"learning_rate": 1e-3}, "kw": {"zero": 2},
     "hybridize_remat": "dots", "steps": 2, "worlds": [2]},
    {"name": "gpt_fp8", "model": "gpt_fp8", "opt": "adam",
     "opt_kw": {"learning_rate": 1e-3}, "kw": {"precision": "fp8"},
     "steps": 3, "worlds": [2]},
    {"name": "bn", "model": "bn", "opt": "sgd", "opt_kw": {},
     "kw": {}, "steps": 2, "worlds": [2, 4]},
]
BY_NAME = {c["name"]: c for c in CASES}
BUNDLE = {"name": "bundle", "model": "dense", **ADAM, "kw": {}, "steps": 4}
PAIRS = [(c["name"], n) for c in CASES for n in c["worlds"]]


# -- models and data ----------------------------------------------------------

def _jax_model(model):
    from mxnet_tpu.gluon import nn
    mx.random.seed(7 if model == "dense" else 0 if model != "bn" else 13)
    if model == "dense":
        net = nn.Dense(10, in_units=8)
        net.initialize()
        return net
    if model == "bn":
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=6), nn.BatchNorm())
        net.initialize()
        net(mx.np.zeros((2, 6)))
        return net
    from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM
    cfg = (dict(vocab_size=64, units=16, num_layers=2, num_heads=2,
                max_length=8) if model == "gpt" else
           dict(vocab_size=101, units=64, hidden_size=128, num_layers=2,
                num_heads=4, max_length=32))
    net = GPTForCausalLM(dropout=0.0, embed_dropout=0.0, **cfg)
    net.initialize()
    net(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    for name, p in net.collect_params().items():
        if "key_proj.bias" in name:
            p.grad_req = "null"
    return net


def _jax_loss(model):
    if model in ("gpt", "gpt_fp8"):
        from mxnet_tpu.ops.xent import sparse_softmax_xent
        return lambda out, y: jnp.mean(sparse_softmax_xent(out, y))
    if model == "bn":
        return lambda out, y: jnp.mean((out - y) ** 2)

    def ce(logits, labels):
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))
    return ce


def _one_batch(model, rs):
    if model == "dense":
        return (rs.randn(16, 8).astype("float32"),
                rs.randint(0, 10, (16,)).astype("int32"))
    if model == "bn":
        return ((rs.randn(16, 6) * 3 + 1).astype("float32"),
                rs.randn(16, 4).astype("float32"))
    vocab, b, s = (64, 8, 8) if model == "gpt" else (101, 4, 32)
    ids = rs.randint(0, vocab, (b, s + 1))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _batches(spec):
    """Each call's (x, y): the global batch, with a leading grad_accum
    and a leading steps_per_call axis where the case has them."""
    rs = onp.random.RandomState(1)
    kw = spec["kw"]
    spc, k = kw.get("steps_per_call", 1), kw.get("grad_accum", 1)
    out = []
    for _ in range(spec["steps"]):
        xs, ys = zip(*[_one_batch(spec["model"], rs) for _ in range(spc)])
        x, y = onp.stack(xs), onp.stack(ys)
        if k > 1:
            x = x.reshape((spc, k, -1) + x.shape[2:])
            y = y.reshape((spc, k, -1) + y.shape[2:])
        out.append((x if spc > 1 else x[0], y if spc > 1 else y[0]))
    return out


def _jax_step(spec, n):
    net = _jax_model(spec["model"])
    mesh = jmake_mesh({"dp": n}, jax.devices()[:n])
    specs = ((JP("dp", None), JP("dp", None))
             if spec["model"] in ("gpt", "gpt_fp8") else (JP("dp"),
                                                         JP("dp")))
    if spec.get("hybridize_remat"):
        net.hybridize(remat=spec["hybridize_remat"])
    return JStep(net, _jax_loss(spec["model"]),
                 mx.optimizer.create(spec["opt"], **spec["opt_kw"]), mesh,
                 batch_specs=specs, n_labels=1, **spec["kw"])


def _jax_run(spec, n):
    step = _jax_step(spec, n)
    if spec.get("counters"):
        jtelemetry.enable()
        jtelemetry.reset()
    losses = [float(step(x, y).asnumpy()) for x, y in _batches(spec)]
    counters = {}
    if spec.get("counters"):
        counters = {k: v for k, v in jtelemetry.counters().items()
                    if k.startswith(("zero.", "mesh.", "comm."))}
        jtelemetry.disable()
    return {"losses": losses, "step": step, "counters": counters}


def _port_step_1(spec, out, zero=0):
    """The port's one-process step of ``spec`` (dp = 1) on the CPU."""
    mesh = tmx.parallel.make_mesh({"dp": 1}, devices=["cpu"])
    return W.dp_step({**spec, "kw": {"zero": zero}}, str(out), mesh)


# -- the runs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    for model in ("dense", "gpt", "gpt_fp8", "bn"):
        net = _jax_model(model)
        onp.savez(out / f"init_{model}.npz",
                  **{k: onp.asarray(v) for k, v in
                     jfunctional.param_arrays(net).items()})
    for spec in CASES + [BUNDLE]:
        bt = _batches(spec)
        onp.savez(out / f"data_{spec['name']}.npz",
                  **{f"x{i}": x for i, (x, _) in enumerate(bt)},
                  **{f"y{i}": y for i, (_, y) in enumerate(bt)})
    with open(out / "dp_cases.json", "w") as f:
        json.dump(CASES, f)
    # a one-process port bundle after 2 steps (the worlds load it) and the
    # JAX package's bundle at dp=4 after 2 steps (world 2 continues it)
    bundle = _batches(BUNDLE)
    with tmx.cpu():
        one = _port_step_1(BUNDLE, out)
        for x, y in bundle[:2]:
            one(x, y)
        one.save_states(str(out / "bundle_w1.safetensors"))
    jref = _jax_step({**BUNDLE, "kw": {"zero": 1}}, 4)
    for x, y in bundle[:2]:
        jref(x, y)
    sd = jref.state_dict()
    onp.savez(out / "ref_bundle.npz", __n_step__=onp.asarray(sd["n_step"]),
              **sd["arrays"])
    procs = {n: W.launch(n, "dp", out) for n in (2, 4)}
    # the reference runs while the worlds train
    refs = {pair: _jax_run(BY_NAME[pair[0]], pair[1]) for pair in PAIRS}
    ref_cont = [float(jref(x, y).asnumpy()) for x, y in bundle[2:]]
    logs = {n: W.finish(p, 300) for n, p in procs.items()}
    return {"out": out, "refs": refs, "logs": logs, "jref": jref,
            "ref_cont": ref_cont}


def _world(runs, n):
    rc, stdout, stderr = runs["logs"][n]
    assert rc == 0, f"stdout:\n{stdout[-3000:]}\nstderr:\n{stderr[-6000:]}"
    return stdout


def _load(runs, case, n):
    _world(runs, n)
    return [dict(onp.load(runs["out"] / f"{case}_w{n}_r{r}.npz"))
            for r in range(n)]


def _jax_weights(step):
    return {**{f"w/{k}": onp.asarray(v) for k, v in step.trainable.items()},
            **{f"aux/{k}": onp.asarray(v) for k, v in step.aux.items()}}


@pytest.mark.parametrize("name,n", PAIRS)
def test_dp_step_matches_jax(runs, name, n):
    spec = BY_NAME[name]
    got = _load(runs, f"dp_{name}", n)
    ref = runs["refs"][(name, n)]
    for r in range(1, n):  # every rank holds the same state, bit for bit
        for k, v in got[0].items():
            if not k.startswith("counter/"):
                onp.testing.assert_array_equal(got[r][k], v, err_msg=k)
    want = _jax_weights(ref["step"])
    assert {k for k in got[0] if k.startswith(("w/", "aux/"))} == set(want)
    if spec["model"] == "gpt_fp8":
        onp.testing.assert_allclose(got[0]["losses"], ref["losses"],
                                    rtol=1e-4)
        for k, w in want.items():
            diff = onp.abs(got[0][k] - w)
            assert (diff > 5e-4).mean() < 0.01 and diff.max() <= 3e-3, (
                k, (diff > 5e-4).mean(), diff.max())
        for site, hist in ref["step"].extra["fp8"].items():
            for k, v in hist.items():
                onp.testing.assert_allclose(
                    got[0][f"fp8/{site}/{k}"][1:], onp.asarray(v)[1:],
                    rtol=1e-3, err_msg=f"{site} {k}")
        return
    onp.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5,
                                atol=1e-6)
    for k, w in want.items():
        atol = 1e-6 if k.startswith("aux/") else 1e-5
        onp.testing.assert_allclose(got[0][k], w, rtol=1e-5, atol=atol,
                                    err_msg=k)


@pytest.mark.parametrize("name,n", [p for p in PAIRS
                                    if BY_NAME[p[0]].get("counters")])
def test_dp_byte_counters_match_jax(runs, name, n):
    """zero.*, mesh.dp_gradient_bytes_total, mesh.collective_bytes_total
    {axis="dp"} and comm.*: the reference's arithmetic, equal."""
    got = _load(runs, f"dp_{name}", n)[0]
    want = runs["refs"][(name, n)]["counters"]
    assert want
    have = {k[len("counter/"):]: float(v) for k, v in got.items()
            if k.startswith("counter/")}
    assert have == {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("remat", ["dots", "true"])
def test_remat_bit_for_bit(runs, remat):
    """remat recomputes the same arithmetic: losses and weights equal the
    un-remat step's bit for bit."""
    a = _load(runs, "dp_dense_z0", 2)[0]
    b = _load(runs, f"dp_dense_remat_{remat}", 2)[0]
    for k, v in a.items():
        onp.testing.assert_array_equal(b[k], v, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("zero", [0, 1, 2])
def test_bundle_loads_across_world_sizes(runs, n, zero):
    """A one-process zero=0 bundle loads bit for bit into a world of n at
    every ZeRO level (its canonical state_dict equal), and continues as
    the one-process step does (within the dp tolerance)."""
    got = _load(runs, f"bundle_load_z{zero}", n)
    with tmx.cpu():
        one = _port_step_1(BUNDLE, runs["out"])
        one.load_states(str(runs["out"] / "bundle_w1.safetensors"))
        canon = one.state_dict()["arrays"]
        losses = [float(one(x, y)) for x, y in _batches(BUNDLE)[2:]]
    for g in got:
        for k, v in canon.items():
            onp.testing.assert_array_equal(g[f"canon/{k}"], v, err_msg=k)
        onp.testing.assert_allclose(g["losses"], losses, rtol=1e-5,
                                    atol=1e-6)
        for k, w in one.params.items():
            onp.testing.assert_allclose(g[f"w/{k}"], w.detach().numpy(),
                                        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("zero", [0, 2])
def test_bundle_saved_by_world_loads_in_one_process(runs, n, zero):
    """A world of n's zero=2 bundle loads bit for bit into a one-process
    step at zero 0 and 2."""
    want = _load(runs, "bundle_saved", n)[0]
    with tmx.cpu():
        one = _port_step_1(BUNDLE, runs["out"], zero=zero)
        one.load_states(str(runs["out"] / f"bundle_w{n}.safetensors"))
        got = one.state_dict()["arrays"]
    assert one._n_step == 2 and one.fopt.opt.num_update == 2
    assert {f"canon/{k}" for k in got} == set(want)
    for k, v in got.items():
        onp.testing.assert_array_equal(v, want[f"canon/{k}"], err_msg=k)


@pytest.mark.parametrize("case", ["trainstate", "prefetch", "bundle_save",
                                  "bundle_load", "reference_bundle"])
@pytest.mark.parametrize("n", [2, 4])
def test_world_case(runs, case, n):
    stdout = _world(runs, n)
    for r in range(n):
        assert f"CASE_OK {case} {r}" in stdout


def test_reference_bundle_continues(runs):
    """The JAX package's zero=1 bundle saved at dp=4 loads into the port
    at 2 ranks; both continue 2 steps alike."""
    got = _load(runs, "ref_bundle_cont", 2)
    jref = runs["jref"]
    for g in got:
        onp.testing.assert_allclose(g["losses"], runs["ref_cont"],
                                    rtol=1e-5, atol=1e-6)
        for k, v in jref.trainable.items():
            onp.testing.assert_allclose(g[f"w/{k}"], onp.asarray(v),
                                        rtol=1e-5, atol=1e-5, err_msg=k)


def test_reference_bundle_checked_before_load(tmp_path):
    """A bundle without this step's arrays, or with other shapes, is
    refused before anything is loaded."""
    spec = {**BUNDLE, "kw": {}}
    net = _jax_model("dense")
    onp.savez(tmp_path / "init_dense.npz",
              **{k: onp.asarray(v) for k, v in
                 jfunctional.param_arrays(net).items()})
    with tmx.cpu():
        step = _port_step_1(spec, tmp_path)
        sd = step.state_dict()
        bad = dict(sd["arrays"])
        bad.pop("state/weight/0")
        with pytest.raises(tmx.MXNetError, match="lacks"):
            step.load_reference_state_dict({"arrays": bad, "n_step": 1})
        bad = dict(sd["arrays"], **{"trainable/bias": onp.zeros(3, "f")})
        with pytest.raises(tmx.MXNetError, match="shape"):
            step.load_reference_state_dict({"arrays": bad, "n_step": 1})
        w = step.params["weight"].clone()
        step.load_reference_state_dict(sd)
        assert torch.equal(step.params["weight"], w)


def test_hybridize_remat_flag_flows_into_step(tmp_path):
    """hybridize(remat=...) is the knob the step inherits; bad policies
    fail at hybridize time (reference: tests/test_zero.py:148)."""
    from mxnet_tpu_torch.gluon.block import _REMAT_OFF, resolve_remat_policy
    net = tmx.gluon.nn.Dense(10, in_units=8, device="cpu")
    net.initialize(seed=0)
    net.hybridize(remat="dots")
    assert net._flags.get("remat") == "dots"
    step = tmx.parallel.ShardedTrainStep(
        net, W.dp_loss("dense"), "adam",
        tmx.parallel.make_mesh({"dp": 1}, devices=["cpu"]),
        batch_specs=(("dp",), ("dp",)))
    assert step._remat_on
    with pytest.raises(tmx.MXNetError):
        resolve_remat_policy("not_a_policy")
    assert resolve_remat_policy(False) is _REMAT_OFF
    with pytest.raises(tmx.MXNetError, match="not elementwise"):
        tmx.parallel.ShardedTrainStep(
            net, W.dp_loss("dense"), "lamb",
            tmx.parallel.make_mesh({"dp": 1}, devices=["cpu"]),
            batch_specs=(("dp",), ("dp",)), zero=1)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_checkpoints_each_layer(tmp_path, monkeypatch, remat):
    """remat checkpoints each layer of the GPT's layer family on its own
    (one checkpoint a layer a microbatch), with the un-remat losses and
    weights bit for bit."""
    import torch.utils.checkpoint as ckpt
    from mxnet_tpu_torch.gluon.block import remat_targets
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    net = _jax_model("gpt")
    onp.savez(tmp_path / "init_gpt.npz",
              **{k: onp.asarray(v) for k, v in
                 jfunctional.param_arrays(net).items()})
    spec = {**BY_NAME["gpt_z1"], "kw": {"grad_accum": 2}, "steps": 2}
    (x, y), = _batches({**spec, "steps": 1})
    res = {}
    with tmx.cpu():
        for r in (None, remat):
            step = W.dp_step({**spec, "kw": {**spec["kw"], "remat": r}},
                             str(tmp_path),
                             tmx.parallel.make_mesh({"dp": 1},
                                                    devices=["cpu"]))
            layers = remat_targets(step.block)
            assert [type(m).__name__ for m in layers] == \
                ["TransformerEncoderCell"] * 2
            res[r] = [float(step(x, y)) for _ in range(2)], {
                n: w.detach().clone() for n, w in step.params.items()}
    assert len(calls) == 2 * 2 * 2  # layers x microbatches x steps
    assert res[remat][0] == res[None][0]
    for n, w in res[None][1].items():
        assert torch.equal(res[remat][1][n], w), n


def test_scan_steps_is_a_loop_like_jax():
    """scan_steps(step_fn, n_state): K steps over the leading axis of the
    batches, the state carried, the metric's mean returned (reference:
    lax.scan)."""
    from mxnet_tpu.parallel.train import scan_steps as jscan
    from mxnet_tpu_torch.parallel import scan_steps

    def jstep(w, acc, x):
        w = w * 0.5 + x.sum()
        return w, acc + w, (w * x).mean()

    def tstep(w, acc, x):
        w = w * 0.5 + x.sum()
        return w, acc + w, (w * x).mean()

    xs = onp.random.RandomState(2).randn(5, 3).astype("float32")
    want = jscan(jstep, 2)(jnp.float32(1.0), jnp.float32(0.0),
                           jnp.asarray(xs))
    got = scan_steps(tstep, 2)(torch.tensor(1.0), torch.tensor(0.0),
                               torch.from_numpy(xs))
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), rtol=1e-6)
