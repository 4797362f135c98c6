"""Sequence and pipeline parallelism (ring attention, gpipe, GPT dp2 x
sp2, BERT dp2 x tp2 x sp2 with and without ``valid_length``) and fp8
under dp2 x tp2, in 2-, 4- and 8-rank gloo worlds against the JAX
package on its 8-device virtual mesh.

Sizes are the reference tests': ``ring_attention`` at b 2, h 4, s 64,
d 16 (``tests/test_parallel.py:49``) over sp 2, 4 and 8; ``gpipe`` at 4
stages, 6 microbatches of 2 x 8 (``:149``); BERT at vocab 96, 64 units,
hidden 128, 2 layers, 4 heads, batch 8 x seq 16 (``:71``, run here without
its ``slow`` marker); the tiny GPT of ``tests/test_mesh_compose.py`` for
dp2 x sp2 and the fp8 GPT of ``test_torch_fp8.py``. This process writes
the inputs and initial weights, starts the worlds together (one torch
thread a rank), runs the reference meanwhile, and compares.

Tolerances: ring attention's values atol 2e-5 (the reference test's
bound), its gradients atol 1e-5; the kernel route (kernels 1-3's plain
versions on the CPU) against the plain route atol 1e-5; gpipe's values
atol 1e-5 and gradients atol 1e-4 (the reference test's); the steps as
``test_torch_parallel_mesh.py`` (losses rtol 1e-5 / atol 1e-6, weights
rtol 1e-5 / atol 1e-5 after 3 Adam updates at lr 1e-3), fp8 as
``test_torch_parallel_dp.py`` holds it.
"""
import json
import os
import sys

import numpy as onp
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import functional as jfunctional
from mxnet_tpu.parallel import MeshConfig as JCfg
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.train import ShardedTrainStep as JStep

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402
from test_torch_parallel_mesh import (  # noqa: E402
    _close_weights, _gpt_batches, _jax_net, _port_one, _weights)

ADAM = {"opt": "adam", "opt_kw": {"learning_rate": 1e-3}}
BERT_SPECS = {"plain": [["dp", "sp"], ["dp", "sp"]],
              "valid_length": [["dp", "sp"], ["dp", "sp"], ["dp"],
                               ["dp", "sp"]]}
CASES = (
    [{"name": f"ring_sp{n}", "kind": "ring", "sp": n, "world": n}
     for n in (2, 4, 8)]
    + [{"name": "gpipe", "kind": "gpipe", "world": 4},
       {"name": "tp_fns", "kind": "tp_fns", "world": 2},
       {"name": "gpt_dp2_sp2", "model": "gpt", **ADAM, "steps": 3,
        "cfg": {"dp": 2, "sp": 2}, "kw": {}, "data": "gpt", "world": 4},
       {"name": "gpt_fp8_dp2_tp2", "model": "gpt_fp8", **ADAM, "steps": 3,
        "cfg": {"dp": 2, "tp": 2}, "kw": {"precision": "fp8"},
        "data": "gpt_fp8", "world": 4}]
    + [{"name": f"bert_{k}", "model": "bert", **ADAM, "steps": 3,
        "cfg": {"dp": 2, "tp": 2, "sp": 2}, "kw": {}, "data": f"bert_{k}",
        "batch_specs": v, "world": 8} for k, v in BERT_SPECS.items()])
BY_NAME = {c["name"]: c for c in CASES}
WORLDS = (2, 4, 8)


def _data():
    rs = onp.random.RandomState(5)
    ids = [rs.randint(0, 96, (8, 16)).astype("int32") for _ in range(3)]
    types = onp.zeros((8, 16), "int32")
    vls = [rs.randint(6, 17, (8,)).astype("int32") for _ in range(3)]
    # test_torch_fp8.py's batch, three steps of it, as that file holds
    # the one-card fp8 step
    t = onp.random.RandomState(0).randint(0, 101, (4, 33))
    fp8 = [(t[:, :-1].astype("int32"), t[:, 1:].astype("int32"))] * 3
    return {"gpt": _gpt_batches(3),
            "gpt_fp8": fp8,
            "bert_plain": [(x, x) for x in ids],
            "bert_valid_length": [(x, types, v, x)
                                  for x, v in zip(ids, vls)]}


def _ring_inputs():
    rs = onp.random.RandomState(0)
    b, h, s, d = 2, 4, 64, 16
    return {k: rs.randn(b, h, s, d).astype("float32")
            for k in ("q", "k", "v", "cot")}


def _gpipe_inputs():
    rs = onp.random.RandomState(0)
    out = {f"w{i}": (rs.randn(8, 8) * 0.5).astype("float32")
           for i in range(4)}
    out["xs"] = rs.randn(6, 2, 8).astype("float32")
    return out


def _jax_bert():
    from mxnet_tpu.gluon.model_zoo.bert import BERTForPretraining
    mx.random.seed(0)
    net = BERTForPretraining(vocab_size=96, units=64, hidden_size=128,
                             num_layers=2, num_heads=4, max_length=32,
                             dropout=0.0, embed_dropout=0.0)
    net.initialize()
    net(mx.np.zeros((4, 16), dtype="int32"))
    for name, p in net.collect_params().items():
        if "key_proj.bias" in name:
            p.grad_req = "null"
    return net


def _jax_gpt_fp8():
    from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM
    mx.random.seed(0)
    net = GPTForCausalLM(vocab_size=101, units=64, hidden_size=128,
                         num_layers=2, num_heads=4, max_length=32,
                         dropout=0.0, embed_dropout=0.0)
    net.initialize()
    net(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    for name, p in net.collect_params().items():
        if "key_proj.bias" in name:
            p.grad_req = "null"
    return net


def _jax_loss(model):
    from mxnet_tpu.ops.xent import sparse_softmax_xent
    if model == "bert":
        return lambda out, y: jnp.mean(sparse_softmax_xent(out[0], y))
    return lambda out, y: jnp.mean(sparse_softmax_xent(out, y))


def _jax_step_run(spec, batches):
    net = {"bert": _jax_bert, "gpt_fp8": _jax_gpt_fp8,
           "gpt": lambda: _jax_net("gpt")}[spec["model"]]()
    cfg = JCfg(**spec["cfg"])
    specs = tuple(JP(*s) for s in spec["batch_specs"]) \
        if "batch_specs" in spec else cfg.batch_specs(2, 2)
    step = JStep(net, _jax_loss(spec["model"]),
                 mx.optimizer.create(spec["opt"], **spec["opt_kw"]), cfg,
                 batch_specs=specs, n_labels=1, **spec["kw"])
    losses = [float(step(*b).asnumpy()) for b in batches]
    return {"losses": losses, "sd": step.state_dict()["arrays"],
            "step": step}


def _jax_ring(n, inp):
    from mxnet_tpu.parallel import ring_attention
    mesh = jmake_mesh({"sp": n}, jax.devices()[:n])
    q, k, v, cot = (jnp.asarray(inp[x]) for x in ("q", "k", "v", "cot"))
    out = {}
    for causal in (False, True):
        def f(a, b, c, causal=causal):
            o, vjp = jax.vjp(lambda a, b, c: ring_attention(
                a, b, c, mesh, axis="sp", causal=causal), a, b, c)
            return o, vjp(cot)
        # jitted: the eager vjp of the shard_map traces op by op (~40 s)
        o, g = jax.jit(f)(q, k, v)
        out[causal] = (onp.asarray(o), [onp.asarray(x) for x in g])
    return out


def _jax_gpipe(inp):
    from mxnet_tpu.parallel.pp import gpipe, shard_stages, stack_stage_params
    mesh = jmake_mesh({"pp": 4}, jax.devices()[:4])
    params = shard_stages(stack_stage_params(
        [{"w": jnp.asarray(inp[f"w{i}"])} for i in range(4)]), mesh)
    xs = jnp.asarray(inp["xs"])

    def stage(p, x):
        return jnp.tanh(x @ p["w"])

    ys = gpipe(stage, params, xs, mesh)
    g = jax.grad(lambda p: gpipe(stage, p, xs, mesh).sum())(params)
    return onp.asarray(ys), onp.asarray(g["w"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    inits = {"gpt": _jax_net("gpt"), "bert": _jax_bert(),
             "gpt_fp8": _jax_gpt_fp8()}
    for model, net in inits.items():
        onp.savez(out / f"init_{model}.npz",
                  **{k: onp.asarray(v) for k, v in
                     jfunctional.param_arrays(net).items()})
    data = _data()
    for name, bt in data.items():
        onp.savez(out / f"data_{name}.npz",
                  **{f"b{i}_{j}": a for i, b in enumerate(bt)
                     for j, a in enumerate(b)})
    ring, gp = _ring_inputs(), _gpipe_inputs()
    onp.savez(out / "ring_inputs.npz", **ring)
    onp.savez(out / "gpipe_inputs.npz", **gp)
    with open(out / "mesh_cases.json", "w") as f:
        json.dump(CASES, f)
    procs = {n: W.launch(n, "mesh", out, {"OMP_NUM_THREADS": "1"})
             for n in WORLDS}
    # the reference runs while the worlds train
    refs = {c["name"]: _jax_step_run(c, data[c["data"]])
            for c in CASES if "model" in c}
    refs.update({f"ring_sp{n}": _jax_ring(n, ring) for n in (2, 4, 8)})
    refs["gpipe"] = _jax_gpipe(gp)
    one = _port_one(BY_NAME["gpt_dp2_sp2"], out, data["gpt"])
    one_fp8 = _port_one(BY_NAME["gpt_fp8_dp2_tp2"], out, data["gpt_fp8"])
    logs = {n: W.finish(p, 300) for n, p in procs.items()}
    return {"out": out, "refs": refs, "logs": logs, "one": one,
            "one_fp8": one_fp8}


def _load(runs, case):
    n = BY_NAME[case]["world"]
    rc, stdout, stderr = runs["logs"][n]
    assert rc == 0, f"stdout:\n{stdout[-3000:]}\nstderr:\n{stderr[-6000:]}"
    return [dict(onp.load(runs["out"] / f"{case}_w{n}_r{r}.npz"))
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(runs, n, causal):
    """Each rank's block of the output and of dq / dk / dv (the cotangent
    ``cot``) from the plain route against the JAX package's ring, and the
    kernel route (kernels 1-3's plain versions here) against the plain."""
    got = _load(runs, f"ring_sp{n}")
    want_o, want_g = runs["refs"][f"ring_sp{n}"][causal]
    s = want_o.shape[2] // n
    tag = int(causal)
    for r, g in enumerate(got):
        blk = slice(r * s, (r + 1) * s)
        onp.testing.assert_allclose(g[f"out_{tag}_plain"],
                                    want_o[:, :, blk], atol=2e-5)
        for key, w in zip("qkv", want_g):
            onp.testing.assert_allclose(g[f"d{key}_{tag}_plain"],
                                        w[:, :, blk], atol=1e-5,
                                        err_msg=f"d{key} rank {r}")
        for k in ("out", "dq", "dk", "dv"):
            onp.testing.assert_allclose(g[f"{k}_{tag}_kernels"],
                                        g[f"{k}_{tag}_plain"], atol=1e-5,
                                        err_msg=f"{k} rank {r}")


def test_gpipe_matches_jax(runs):
    """gpipe's outputs on every rank and the stacked stage weights'
    gradient (each stage's row from its rank) against the JAX package's
    gpipe; a stacked tree of 8 stages on 4 is refused."""
    got = _load(runs, "gpipe")
    ys, g = runs["refs"]["gpipe"]
    for r in got:
        onp.testing.assert_allclose(r["ys"], ys, atol=1e-5)
        onp.testing.assert_allclose(r["grad"], g, atol=1e-4)
        assert int(r["rejected"]) == 1


@pytest.mark.parametrize("name", ["gpt_dp2_sp2", "bert_plain",
                                  "bert_valid_length"])
def test_sequence_parallel_step_matches_jax(runs, name):
    """GPT dp2 x sp2 (ring attention, causal) and BERT dp2 x tp2 x sp2
    without a mask (ring) and with ``valid_length`` (keys and values
    gathered over sp): losses and weights as the JAX package's step at
    the same layout, the same on every rank; GPT also as the port's
    one-rank step."""
    got = _load(runs, name)
    ref = runs["refs"][name]
    for r in got[1:]:
        onp.testing.assert_array_equal(r["losses"], got[0]["losses"])
    onp.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5,
                                atol=1e-6)
    _close_weights(_weights(got[0], "canon/"), _weights(ref["sd"]), "jax")
    if name == "gpt_dp2_sp2":
        one_losses, one_sd = runs["one"]
        onp.testing.assert_allclose(got[0]["losses"], one_losses, rtol=1e-5,
                                    atol=1e-6)
        _close_weights(_weights(got[0], "canon/"), _weights(one_sd),
                       "one rank")


def test_tp_functions_keep_the_values(runs):
    """shard_dense_column + shard_dense_row (each gathering), shard_mlp
    (the Megatron pair) and auto_shard_block over tp=2: the MLP's output
    and its input's gradient as the whole MLP's on every rank (fp32 sums
    in another order), and unshard gives its weights back bit for bit
    (the ranks assert it)."""
    for r in _load(runs, "tp_fns"):
        for how in ("column_row", "mlp", "auto"):
            for k in ("y", "dx"):
                onp.testing.assert_allclose(r[f"{how}/{k}"],
                                            r[f"{how}/{k}_ref"], rtol=1e-5,
                                            atol=1e-5, err_msg=f"{how} {k}")


def test_fp8_under_tensor_parallelism(runs):
    """precision="fp8" at dp2 x tp2 on test_torch_fp8.py's batch: against
    the port's one-rank fp8 step (losses rtol 1e-5, weights rtol 1e-5 /
    atol 1e-5: tp moves only fp32 sums), and against the JAX package's fp8
    step at the same layout as test_torch_fp8.py holds one card: losses
    rtol 1e-4; weights: under 1% of elements off by more than 5e-4, none by
    more than 3e-3; the amax histories of the first two steps rtol
    1e-3."""
    got = _load(runs, "gpt_fp8_dp2_tp2")[0]
    one_losses, one_sd = runs["one_fp8"]
    onp.testing.assert_allclose(got["losses"], one_losses, rtol=1e-5)
    _close_weights(_weights(got, "canon/"), _weights(one_sd), "one rank")
    ref = runs["refs"]["gpt_fp8_dp2_tp2"]
    onp.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    want = _weights(ref["sd"])
    have = _weights(got, "canon/")
    assert set(have) == set(want)
    for k, w in want.items():
        diff = onp.abs(have[k] - w)
        assert (diff > 5e-4).mean() < 0.01 and diff.max() <= 3e-3, (
            k, (diff > 5e-4).mean(), diff.max())
    for k, v in ref["sd"].items():
        if k.startswith("fp8/"):
            onp.testing.assert_allclose(got[f"canon/{k}"][1:], v[1:],
                                        rtol=1e-3, err_msg=k)
