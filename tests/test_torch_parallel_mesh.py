"""Composed layouts of ``ShardedTrainStep`` (dp x tp x pp) in an 8-rank
gloo world against the JAX package's step on its 8-device virtual mesh.

The models are the reference tests' (``tests/test_mesh_compose.py:29-60``:
a tiny GPT, vocab 64, 16 units, 2 layers, 2 heads, seq 8, batch 8;
``:165``: Dense(256, in 128) for ZeRO x TP). This process writes the
initial weights (from the JAX package) and the batches, starts one launch
of ``torch_dist_worker.py mesh`` (8 ranks, one torch thread each), runs the
reference meanwhile, and compares: dp2 x tp2 x pp2, dp4 x tp2 with zero=1,
dp2 x tp2 x pp2 with zero=2 and grad_accum=2 (held to one big-batch
step), their byte counters, ZeRO x TP's state bytes, bundles across
layouts and packages, TrainState, and rebuild.

Tolerances (test_torch_parallel_dp.py's, after 3 Adam updates at lr
1e-3): losses rtol 1e-5 / atol 1e-6, weights rtol 1e-5 / atol 1e-5 (fp32
sums in another order: tp's partial products, the ranks' reduces). The attention key
projection's bias is frozen in both packages, as the dp tests freeze it:
its gradient is zero in exact arithmetic, and Adam turns its float noise
into steps of up to lr. Bit for bit: bundles (state_dict arrays) across
layouts, TrainState, and the JAX package's bundle.
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
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.parallel import MeshConfig as JCfg
from mxnet_tpu.parallel.train import ShardedTrainStep as JStep

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

VOCAB, SEQ, BATCH = 64, 8, 8
ADAM = {"opt": "adam", "opt_kw": {"learning_rate": 1e-3}}
LAYOUTS = [
    {"name": "gpt_dp2_tp2_pp2", "cfg": {"dp": 2, "tp": 2, "pp": 2},
     "kw": {}},
    {"name": "gpt_dp4_tp2_z1", "cfg": {"dp": 4, "tp": 2},
     "kw": {"zero": 1}},
    {"name": "gpt_dp2_tp2_pp2_z2_acc2", "cfg": {"dp": 2, "tp": 2, "pp": 2},
     "kw": {"zero": 2, "grad_accum": 2}, "data": "gpt_acc2"},
]
ZTP = {"model": "dense256", "cfg": {"dp": 4, "tp": 2}, "opt": "adam",
       "opt_kw": {"learning_rate": 0.01}, "data": "dense", "steps": 2,
       "param_specs": {"weight": ["tp", None], "bias": ["tp"]},
       "batch_specs": [["dp"], ["dp"]], "world": 8}
CASES = ([{**c, "model": "gpt", **ADAM, "steps": 3, "world": 8,
           "counters": True, "data": c.get("data", "gpt")}
          for c in LAYOUTS]
         + [{**ZTP, "name": "ztp_z0", "kw": {}},
            {**ZTP, "name": "ztp_z1", "kw": {"zero": 1}},
            {"name": "bundles", "kind": "bundles", "model": "gpt", **ADAM,
             "data": "gpt", "steps": 4, "world": 8},
            {"name": "rebuild", "kind": "rebuild", "model": "gpt",
             "opt": "sgd", "opt_kw": {"learning_rate": 0.1, "momentum": 0.9},
             "data": "gpt", "steps": 3, "world": 8}])
BY_NAME = {c["name"]: c for c in CASES}


def _gpt_batches(n=4):
    rs = onp.random.RandomState(1)
    out = []
    for _ in range(n):
        ids = rs.randint(0, VOCAB, (BATCH, SEQ + 1))
        out.append((ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")))
    return out


def _data():
    gpt = _gpt_batches()
    rs = onp.random.RandomState(0)
    dense = [(rs.randn(16, 128).astype("float32"),
              rs.randn(16, 256).astype("float32")) for _ in range(2)]
    acc2 = [(x.reshape(2, 4, SEQ), y.reshape(2, 4, SEQ)) for x, y in gpt]
    return {"gpt": gpt, "dense": dense, "gpt_acc2": acc2}


def _jax_net(model):
    from mxnet_tpu.gluon import nn
    if model == "dense256":
        mx.random.seed(7)
        net = nn.Dense(256, in_units=128)
        net.initialize()
        return net
    from mxnet_tpu.gluon.model_zoo.gpt import GPTForCausalLM
    mx.random.seed(0)
    net = GPTForCausalLM(vocab_size=VOCAB, units=16, num_layers=2,
                         num_heads=2, max_length=SEQ, dropout=0.0,
                         embed_dropout=0.0)
    net.initialize()
    net(mx.np.array(onp.zeros((1, 2), dtype="int32")))
    for name, p in net.collect_params().items():
        if "key_proj.bias" in name:
            p.grad_req = "null"
    return net


def _jax_loss(model):
    if model == "dense256":
        return lambda o, t: jnp.mean((o - t) ** 2)
    from mxnet_tpu.ops.xent import sparse_softmax_xent
    return lambda out, y: jnp.mean(sparse_softmax_xent(out, y))


def _jax_step(spec, cfg=None, **over):
    cfg = JCfg(**(cfg or spec["cfg"]))
    kw = {**spec.get("kw", {}), **over}
    if "param_specs" in spec:
        kw["param_specs"] = {k: JP(*v) for k, v in
                             spec["param_specs"].items()}
    specs = tuple(JP(*s) for s in spec["batch_specs"]) \
        if "batch_specs" in spec else cfg.batch_specs(2, 2)
    return JStep(_jax_net(spec["model"]), _jax_loss(spec["model"]),
                 mx.optimizer.create(spec["opt"], **spec["opt_kw"]), cfg,
                 batch_specs=specs, n_labels=1, **kw)


def _jax_run(spec, batches):
    if spec.get("counters"):
        jtelemetry.enable()
        jtelemetry.reset()
    step = _jax_step(spec)
    losses = [float(step(*b).asnumpy()) for b in batches]
    counters = {}
    if spec.get("counters"):
        counters = {k: v for k, v in jtelemetry.counters().items()
                    if k.startswith(("zero.", "mesh.", "comm."))}
        jtelemetry.disable()
    return {"losses": losses, "sd": step.state_dict()["arrays"],
            "counters": counters, "step": step}


def _port_one(spec, out, batches):
    """The port's one-process step of ``spec`` (one rank, no ZeRO, the
    microbatches as one batch) on the CPU: its losses and canonical
    arrays."""
    kw = {k: v for k, v in spec["kw"].items()
          if k not in ("zero", "grad_accum")}
    with tmx.cpu():
        step = W.mesh_step({**spec, "kw": kw}, str(out),
                           tmx.parallel.MeshConfig())
        if spec["kw"].get("grad_accum"):
            batches = [tuple(a.reshape((-1,) + a.shape[2:]) for a in b)
                       for b in batches]
        losses = [float(step(*b)) for b in batches]
        return losses, step.state_dict()["arrays"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    for model in ("gpt", "dense256"):
        onp.savez(out / f"init_{model}.npz",
                  **{k: onp.asarray(v) for k, v in
                     jfunctional.param_arrays(_jax_net(model)).items()})
    data = _data()
    for name, bt in data.items():
        onp.savez(out / f"data_{name}.npz",
                  **{f"b{i}_{j}": a for i, b in enumerate(bt)
                     for j, a in enumerate(b)})
    # the JAX package's dp4 x tp2 zero=1 bundle after 2 steps
    jb = _jax_step(BY_NAME["bundles"], {"dp": 4, "tp": 2}, zero=1)
    for b in data["gpt"][:2]:
        jb(*b)
    sd = jb.state_dict()
    onp.savez(out / "ref_mesh_bundle.npz",
              __n_step__=onp.asarray(sd["n_step"]), **sd["arrays"])
    with open(out / "mesh_cases.json", "w") as f:
        json.dump(CASES, f)
    proc = W.launch(8, "mesh", out, {"OMP_NUM_THREADS": "1"})
    # the reference runs while the world trains
    refs = {c["name"]: _jax_run(c, data[c["data"]][:c["steps"]])
            for c in CASES if c.get("kind", "step") == "step"}
    refs["bundle_cont"] = [float(jb(*b).asnumpy()) for b in data["gpt"][2:4]]
    jr = _jax_step(BY_NAME["rebuild"], {"dp": 2, "tp": 2, "pp": 2})
    rl = [float(jr(*b).asnumpy()) for b in data["gpt"][:2]]
    jr = jr.rebuild(JCfg(dp=4, tp=2))
    rl.append(float(jr(*data["gpt"][2]).asnumpy()))
    refs["rebuild"] = {"losses": rl, "sd": jr.state_dict()["arrays"]}
    one = {c["name"]: _port_one(c, out, data[c["data"]][:c["steps"]])
           for c in CASES[:3]}
    log = W.finish(proc, 300)
    return {"out": out, "refs": refs, "log": log, "one": one, "data": data}


def _load(runs, case):
    rc, stdout, stderr = runs["log"]
    assert rc == 0, f"stdout:\n{stdout[-3000:]}\nstderr:\n{stderr[-6000:]}"
    return [dict(onp.load(runs["out"] / f"{case}_w8_r{r}.npz"))
            for r in range(8)]


def _weights(arrays, prefix=""):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix + "trainable/")
            or k.startswith(prefix + "aux/")}


def _close_weights(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:4])
    for k, w in want.items():
        onp.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                    err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", [c["name"] for c in LAYOUTS])
def test_layout_matches_jax_and_one_rank(runs, name):
    """Each composed layout against the JAX package's step at the same
    layout and against the port's one-rank step (the accumulated one
    against one big-batch step); every rank returns the same loss and
    the same canonical bundle."""
    got = _load(runs, name)
    for r in range(1, 8):
        onp.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
        for k, v in got[0].items():
            if k.startswith("canon/"):
                onp.testing.assert_array_equal(got[r][k], v, err_msg=k)
    ref = runs["refs"][name]
    onp.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5,
                                atol=1e-6)
    _close_weights(_weights(got[0], "canon/"), _weights(ref["sd"]), "jax")
    one_losses, one_sd = runs["one"][name]
    onp.testing.assert_allclose(got[0]["losses"], one_losses, rtol=1e-5,
                                atol=1e-6)
    _close_weights(_weights(got[0], "canon/"), _weights(one_sd), "one rank")


@pytest.mark.parametrize("name", [c["name"] for c in LAYOUTS
                                  if c["cfg"].get("pp", 1) > 1])
def test_pp_stage_drops_other_stages_layers(runs, name):
    """While the step holds the block sharded, a pp rank keeps one
    element of storage for each parameter of another stage's layers."""
    for r, got in enumerate(_load(runs, name)):
        count, nbytes, one_each = (int(x) for x in got["other_stage"])
        assert count > 0, r
        assert nbytes == one_each, (r, nbytes, one_each)


@pytest.mark.parametrize("name", [c["name"] for c in LAYOUTS])
def test_byte_counters_match_jax(runs, name):
    """zero.*, mesh.dp_gradient_bytes_total, mesh.tp_allreduce_bytes_total,
    mesh.pp_stage_transfer_bytes_total and mesh.collective_bytes_total
    {axis=dp|tp|pp}: the reference's arithmetic, equal."""
    got = _load(runs, name)[0]
    want = runs["refs"][name]["counters"]
    assert want.get("mesh.tp_allreduce_bytes_total", 0) > 0
    have = {k[len("counter/"):]: float(v) for k, v in got.items()
            if k.startswith("counter/")}
    assert have == {k: float(v) for k, v in want.items()}


def test_zero_tp_partitions_state(runs):
    """ZeRO x TP (reference: tests/test_mesh_compose.py:165): the
    tensor-sharded Dense's state bytes on rank 0 at zero=1 are at most
    0.6x those at zero=0; both match the JAX package's losses."""
    z0, z1 = _load(runs, "ztp_z0"), _load(runs, "ztp_z1")
    for name, got in (("ztp_z0", z0), ("ztp_z1", z1)):
        onp.testing.assert_allclose(got[0]["losses"],
                                    runs["refs"][name]["losses"],
                                    rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(z1[0]["losses"], z0[0]["losses"],
                                rtol=1e-5, atol=1e-6)
    b0, b1 = int(z0[0]["state_bytes"]), int(z1[0]["state_bytes"])
    assert b1 <= 0.6 * b0, (b0, b1)


def test_bundles_move_between_layouts_and_packages(runs):
    """dp4 x tp2 (zero 1) -> dp2 x tp2 x pp2 -> dp4 x tp2 bit for bit (the
    ranks assert it), both continue alike; TrainState carries a composed
    step; the JAX package's bundle loads bit for bit and continues as the
    reference does; the port's dp4 x tp2 bundle loads bit for bit into
    the JAX package's step."""
    got = _load(runs, "bundles")
    stdout = runs["log"][1]
    for r in range(8):
        assert f"CASE_OK bundles {r}" in stdout
    g = got[0]
    onp.testing.assert_allclose(g["la"], g["lb"], rtol=0, atol=1e-5)
    onp.testing.assert_allclose(g["lf"], runs["refs"]["bundle_cont"],
                                rtol=1e-5, atol=1e-6)
    port = {k[2:]: v for k, v in g.items() if k.startswith("a/")}
    js = _jax_step(BY_NAME["bundles"], {"dp": 4, "tp": 2}, zero=1)
    js.load_state_dict({"arrays": port, "n_step": 2})
    back = js.state_dict()["arrays"]
    assert set(back) == set(port)
    for k, v in port.items():
        onp.testing.assert_array_equal(back[k], v, err_msg=k)


def test_rebuild_continues_on_another_layout(runs):
    """dp2 x tp2 x pp2 for two steps, rebuild(MeshConfig(dp=4, tp=2)), one
    more step: losses and weights as the JAX package's rebuild; between
    the two the block is whole on every rank. SGD with momentum: a rebuilt
    step starts its optimizer state afresh (as the reference's), and
    Adam's first step moves a near-zero gradient's element by about lr
    whatever its float noise."""
    got = _load(runs, "rebuild")
    ref = runs["refs"]["rebuild"]
    onp.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5,
                                atol=1e-6)
    _close_weights(_weights(got[0], "canon/"), _weights(ref["sd"]),
                   "rebuilt")
    for r in range(1, 8):
        for k, v in got[0].items():
            if k.startswith("whole/"):
                onp.testing.assert_array_equal(got[r][k], v, err_msg=k)
    assert got[0]["whole/backbone.decoder.layer1.ffn.ffn_1.weight"].shape \
        == (3072, 16)


@pytest.mark.parametrize("model", ["gpt", "dense256"])
def test_megatron_specs_match_jax(model):
    """megatron_specs names the same columns, rows and biases as the
    reference's for every parameter of the model (and replicates the
    rest)."""
    from mxnet_tpu.parallel.train import megatron_specs as jspecs
    shapes = {k: v.shape for k, v in
              jfunctional.param_arrays(_jax_net(model)).items()}
    got = tmx.parallel.megatron_specs(shapes)
    want = jspecs(shapes)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k]) == tuple(v), k


@pytest.mark.parametrize("model,cfg,zero", [
    ("gpt", {"dp": 2}, 1), ("gpt", {"dp": 4, "tp": 2}, 1),
    ("gpt", {"dp": 2, "tp": 2}, 2), ("dense256", {"dp": 4, "tp": 2}, 1)])
def test_zero_layout_matches_jax(model, cfg, zero):
    """Which parameters take flat ZeRO shards and which cut their state
    over dp along a dimension (ZeRO x TP) is the reference's: a spec
    naming any axis keeps a parameter out of the flat shards, at tp = 1
    too (megatron_specs' column biases under MeshConfig(dp=2))."""
    from mxnet_tpu_torch.parallel.train import _zero_layout
    spec = ({**ZTP, "kw": {}} if model == "dense256" else
            {"model": "gpt", **ADAM, "kw": {}})
    ref = _jax_step(spec, cfg, zero=zero)
    shapes = {n: tuple(v.shape) for n, v in ref.trainable.items()}
    if "param_specs" in spec:
        specs = {k: tmx.parallel.P(*v)
                 for k, v in spec["param_specs"].items()}
    else:
        specs = tmx.parallel.megatron_specs(shapes)
    got_zero, got_ztp = _zero_layout(specs, shapes, "dp", cfg["dp"])
    assert {n: v for n, v in got_zero.items()} == ref._zero
    assert got_ztp == {n: list(s).index("dp")
                       for n, s in ref._zero_tp.items()}
    if cfg.get("tp", 1) == 1 and model == "gpt":
        assert any(n.endswith("ffn_1.bias") for n in shapes)
        assert not any(n.endswith("ffn_1.bias")
                       for n in (*got_zero, *got_ztp))


@pytest.mark.parametrize("stages,micro", [(2, 1), (2, 2), (3, 2), (4, 5)])
def test_hand_on_carries_each_microbatch_once(stages, micro):
    """The pipeline's pairs: over the M + S - 1 ticks every microbatch
    crosses each stage boundary once, in order, at the tick after the
    sending stage computed it; no pair wraps from the last stage."""
    from mxnet_tpu_torch.parallel.pp import hand_on
    seen = {}
    for t in range(micro + stages - 1):
        for src, dst in hand_on(t, stages, micro):
            assert dst == src + 1 < stages
            seen.setdefault(src, []).append(t - src)
    assert seen == {i: list(range(micro)) for i in range(stages - 1)}


class _StageMesh:
    def __init__(self, stage, stages=2):
        self.shape, self._stage = {"pp": stages}, stage

    def axis_index(self, axis):
        return self._stage


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_later_stage_runs_from_the_received_activation(model):
    """A later pipeline stage runs its layers on the received activation
    and skips the modules before the layer container (the embedding):
    token ids past the vocabulary, which any lookup would reject, give
    its layers, the final LN / pooler and the heads on what it
    received."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo import bert, gpt
    from mxnet_tpu_torch.parallel.pp import StagePlan
    tmx.random.seed(0)
    with tmx.cpu():
        if model == "gpt":
            net = gpt.GPTForCausalLM(vocab_size=VOCAB, units=16,
                                     num_layers=2, num_heads=2,
                                     max_length=SEQ, dropout=0.0,
                                     embed_dropout=0.1)
        else:
            net = bert.BERTForPretraining(vocab_size=VOCAB, units=16,
                                          hidden_size=32, num_layers=2,
                                          num_heads=2, max_length=SEQ,
                                          dropout=0.0, embed_dropout=0.1)
        net.initialize()
        net(torch.zeros((1, 2), dtype=torch.long))
    shapes = {n: tuple(p.shape) for n, p in net.collect_params().items()}
    plan = StagePlan(net, shapes, _StageMesh(1))
    assert [n for n, _ in plan.pre][:3] == [
        "backbone.word_embed", "backbone.position_embed",
        "backbone.embed_dropout"] if model == "gpt" else [
        "backbone.word_embed", "backbone.token_type_embed",
        "backbone.position_embed"]
    assert (plan.lo, plan.hi) == (1, 2)
    recv = torch.randn(2, SEQ, 16)
    ids = torch.full((2, SEQ), VOCAB + 7, dtype=torch.long)
    with tmx.autograd.record(), plan.scope(recv):
        got = net(ids)
    assert "forward" not in vars(net.backbone.word_embed)
    container = net.backbone.decoder if model == "gpt" \
        else net.backbone.encoder
    with tmx.autograd.record():
        h = container.layer1(recv)
        if model == "gpt":
            want = net._head(net.backbone.final_ln(h))
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            pooled = net.backbone.pooler(h[:, 0, :])
            torch.testing.assert_close(got[1], net.nsp_classifier(pooled),
                                       rtol=0, atol=0)
