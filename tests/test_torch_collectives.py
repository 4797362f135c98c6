"""The port's collectives (``mxnet_tpu_torch.parallel.collectives``) at 2
and 4 gloo ranks against the JAX package's on the 8-device virtual mesh.

One launch of ``tools/launch.py -n N`` a world runs every collective on
the inputs of ``torch_dist_worker.coll_inputs`` (rank r takes row r of
each global stack, the reference the stack itself); the tests compare
rank r's results with row r (or the replicated value) of the reference's.

Tolerances: sums of 2 or 4 fp32 values in another order, rtol 1e-6
(exact for max / min, the gathers and the permutes, compared bit for
bit); ``compressed_allreduce`` "int8" bit for bit (an exact integer sum
times the shared scale, over n, in the reference's order of operations)
with its residual; "bf16" rtol 1e-6 (bf16 payloads summed in fp32 in rank
order).
"""
import os
import sys

import numpy as onp
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu.parallel import make_mesh as jmake_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [rank r's results]} of one launch per world, started together."""
    procs = {}
    for n in WORLDS:
        out = tmp_path_factory.mktemp(f"coll{n}")
        procs[n] = (out, W.launch(n, "collectives", out))
    res = {}
    for n, (out, p) in procs.items():
        rc, stdout, stderr = W.finish(p, 240)
        assert rc == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        res[n] = [dict(onp.load(os.path.join(
            out, f"collectives_w{n}_r{r}.npz"))) for r in range(n)]
    return res


def _mesh(n):
    return jmake_mesh({"dp": n}, jax.devices()[:n])


def _ref(n):
    inp = W.coll_inputs(n)
    mesh = _mesh(n)
    out = {}
    for op in ("sum", "max", "min", "mean"):
        out[f"allreduce_{op}"] = onp.asarray(
            jcoll.allreduce(jnp.asarray(inp["x"]), mesh, op=op))
    out["allgather_tiled"] = onp.asarray(
        jcoll.allgather(jnp.asarray(inp["blocks"]), mesh))
    out["allgather_stacked"] = onp.asarray(
        jcoll.allgather(jnp.asarray(inp["blocks"]), mesh, tiled=False))
    out["reduce_scatter"] = onp.asarray(
        jcoll.reduce_scatter(jnp.asarray(inp["full"]), mesh))
    ring = [(i, (i + 1) % n) for i in range(n)]
    out["ppermute_ring"] = onp.asarray(
        jcoll.ppermute(jnp.asarray(inp["ring"]), mesh, "dp", ring))
    out["ppermute_partial"] = onp.asarray(
        jcoll.ppermute(jnp.asarray(inp["ring"]), mesh, "dp", [(0, 1)]))
    for mode in ("int8", "bf16"):
        red, res = jcoll.compressed_allreduce(
            jnp.asarray(inp["c"]), mesh, mode=mode,
            residual=jnp.asarray(inp["res"]))
        red2, res2 = jcoll.compressed_allreduce(
            jnp.asarray(inp["c2"]), mesh, mode=mode, residual=res)
        out.update({f"compressed_{mode}": onp.asarray(red),
                    f"compressed_{mode}_res": onp.asarray(res),
                    f"compressed_{mode}_2": onp.asarray(red2),
                    f"compressed_{mode}_res_2": onp.asarray(res2)})
    return out


_REFS = {}


def ref(n):
    if n not in _REFS:
        _REFS[n] = _ref(n)
    return _REFS[n]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_allreduce(worlds, n, op):
    want = ref(n)[f"allreduce_{op}"]
    for r, got in enumerate(worlds[n]):
        if op in ("max", "min"):
            onp.testing.assert_array_equal(got[f"allreduce_{op}"], want[r])
        else:
            onp.testing.assert_allclose(got[f"allreduce_{op}"], want[r],
                                        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("tiled", [True, False])
def test_allgather(worlds, n, tiled):
    key = "allgather_tiled" if tiled else "allgather_stacked"
    want = ref(n)[key]
    for got in worlds[n]:
        onp.testing.assert_array_equal(got[key], want)


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter(worlds, n):
    want = ref(n)["reduce_scatter"]
    k = want.shape[0] // n
    full = W.coll_inputs(n)["full"]
    for r, got in enumerate(worlds[n]):
        onp.testing.assert_allclose(got["reduce_scatter"],
                                    want[r * k:(r + 1) * k], rtol=1e-6)
        # distinct contributions (rank r adds r): the numpy sum
        distinct = sum(full + q for q in range(n))[r * k:(r + 1) * k]
        onp.testing.assert_allclose(got["reduce_scatter_distinct"],
                                    distinct, rtol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("perm", ["ring", "partial"])
def test_ppermute(worlds, n, perm):
    want = ref(n)[f"ppermute_{perm}"]
    for r, got in enumerate(worlds[n]):
        onp.testing.assert_array_equal(got[f"ppermute_{perm}"], want[r])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compressed_allreduce(worlds, n, mode):
    want = ref(n)
    for r, got in enumerate(worlds[n]):
        for sfx in ("", "_2"):
            red = got[f"compressed_{mode}{sfx}"]
            res = got[f"compressed_{mode}_res{sfx}"]
            wred = want[f"compressed_{mode}{sfx}"]
            wres = want[f"compressed_{mode}_res{sfx}"][r]
            if mode == "int8" or n == 2:
                onp.testing.assert_array_equal(red, wred)
            else:
                onp.testing.assert_allclose(red, wred, rtol=1e-6)
            onp.testing.assert_array_equal(res, wres)


@pytest.mark.parametrize("n", WORLDS)
def test_allreduce_across_processes(worlds, n):
    want = W.coll_inputs(n)["x"].sum(axis=0)
    for got in worlds[n]:
        onp.testing.assert_allclose(got["across_processes"], want,
                                    rtol=1e-6)


def test_single_process_degenerates():
    """No launcher: every collective is the one-rank arithmetic (the
    identity for the reductions and gathers)."""
    import torch
    import mxnet_tpu_torch as tmx
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tmx.parallel.allreduce(x, op="max"), x)
    assert torch.equal(tmx.parallel.allgather(x), x)
    assert tmx.parallel.allgather(x, tiled=False).shape == (1, 3, 2)
    assert torch.equal(tmx.parallel.reduce_scatter(x), x)
    assert torch.equal(tmx.parallel.allreduce_across_processes(x), x)
    mesh = tmx.parallel.make_mesh({"dp": 1}, devices=["cpu"])
    assert torch.equal(tmx.parallel.ppermute(x, mesh, "dp", [(0, 0)]), x)
    c = torch.from_numpy(W.coll_inputs(1)["c"][0])
    red, res = tmx.parallel.compressed_allreduce(c, mesh, mode="int8")
    jred, jres = jcoll.compressed_allreduce(jnp.asarray(c.numpy()[None]),
                                            _mesh(1), mode="int8")
    onp.testing.assert_array_equal(red.numpy(), onp.asarray(jred))
    onp.testing.assert_array_equal(res.numpy(), onp.asarray(jres)[0])


def test_weak_scaling_table_over_launcher():
    """Rows at n = 1 and 2 launched ranks, a fixed per-rank batch, the
    efficiency against n = 1 (reference: tests/test_parallel.py:458). The
    ranks share this host's CPU, and the rows say so."""
    from mxnet_tpu_torch.parallel.scaling import weak_scaling_table
    rows = weak_scaling_table(ns=(1, 2), per_device_batch=1, image=16,
                              iters=2, warmup=1, timeout=240)
    assert [r.get("n") for r in rows] == [1, 2], rows
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["ms_per_step"] > 0 and r["collective_ms"] >= 0
        assert r["global_batch"] == r["n"]
        assert r["shared_device"] is True and r["device"] == "cpu"
    assert rows[1]["backend"] == "gloo"


def test_multiprocess_overhead_table_two_ranks():
    """Two launched ranks: matmul compute against the all-reduce at 1 MiB
    and 16 MiB (reference: tests/test_dist.py:141)."""
    from mxnet_tpu_torch.parallel.scaling import multiprocess_overhead_table
    rows = multiprocess_overhead_table(ns=(2,), timeout=240)
    assert len(rows) == 1 and "error" not in rows[0], rows
    row = rows[0]
    assert row["n"] == 2 and row["compute_ms"] > 0
    assert [r["bytes"] for r in row["allreduce"]] == [1 << 20, 1 << 24]
    assert all(r["allreduce_ms"] > 0 for r in row["allreduce"])


@pytest.mark.parametrize("n", WORLDS)
def test_make_mesh_strands_warn_and_gauge(worlds, n):
    """A dp=1 mesh in a world of n warns, sets mesh.unused_devices to
    n - 1 and leaves the other ranks out (rank None); a dp=n mesh warns
    not and sets 0 (reference: tests/test_mesh_compose.py:104)."""
    for r, got in enumerate(worlds[n]):
        (warned1, gauge1, rank1), (warned_n, gauge_n, rank_n) = \
            got["stranded"].tolist()
        assert (warned1, gauge1) == (1, n - 1)
        assert rank1 == (0 if r == 0 else -1)
        assert (warned_n, gauge_n, rank_n) == (0, 0, r)


def test_mesh_config_matches_jax():
    """MeshConfig's validation, identity, specs and factorizations, and
    the world-size checks, as the reference's (tests/test_mesh_compose.py:
    62-100; one process here, so a mesh of 2 needs a launcher)."""
    import mxnet_tpu.parallel as jpar
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.parallel import MeshConfig, P
    for bad in ({"dp": 0}, {"tp": 2.5}):
        with pytest.raises(tmx.MXNetError):
            MeshConfig(**bad)
    assert MeshConfig(dp=2, tp=2) == MeshConfig(tp=2, dp=2)
    assert hash(MeshConfig(dp=2)) == hash(MeshConfig(dp=2))
    assert MeshConfig(dp=2) != MeshConfig(dp=2, pp=2)
    assert MeshConfig(dp=4).replace(dp=1) == MeshConfig()
    with pytest.raises(tmx.MXNetError, match="unknown axis"):
        MeshConfig().replace(ep=2)
    with pytest.raises(tmx.MXNetError, match="needs 2 ranks"):
        MeshConfig(dp=2).build(["cpu"])
    cfg = MeshConfig(dp=2, sp=2)
    assert cfg.batch_spec(1) == P("dp") and cfg.batch_spec(2) == P("dp",
                                                                   "sp")
    assert MeshConfig(dp=4).batch_spec(2) == P("dp", None)
    for n, sp in ((8, 1), (8, 2), (6, 1), (1, 1)):
        got = [c.shape for c in tmx.parallel.mesh_factorizations(n, sp)]
        want = [c.shape for c in jpar.mesh_factorizations(n, max_sp=sp)]
        assert got == want, (n, sp)
    mesh = tmx.parallel.make_mesh({"dp": 1}, devices=["cpu"])
    assert tmx.parallel.set_mesh(mesh) is tmx.parallel.current_mesh()
    tmx.parallel.set_mesh(None)
    x = onp.arange(12.0).reshape(4, 3)
    assert tmx.parallel.shard(x, mesh, P("dp", None)) is x
    assert tmx.parallel.replicate(x, mesh) is x
    # a sequence axis builds like any other (the worlds of
    # test_torch_parallel_sp.py run it); in a world of one it needs ranks
    with pytest.raises(tmx.MXNetError, match="needs 2 ranks"):
        tmx.parallel.make_mesh({"dp": 1, "sp": 2}, devices=["cpu"])
    for c in ({"dp": 2, "sp": 2}, {"dp": 4}, {"tp": 2, "pp": 2}):
        assert MeshConfig(**c).activation_rules() == {
            k: P(*v) for k, v in
            jpar.MeshConfig(**c).activation_rules().items()}
    one = tmx.parallel.make_mesh({"dp": 1, "sp": 1}, devices=["cpu"])
    assert one.axis_index("sp") == 0 and one.axis_group("sp") is None
