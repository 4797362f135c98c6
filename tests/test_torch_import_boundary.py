"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

Every module of ``mxnet_tpu_torch/`` (the ``amp`` package's too),
``chip_smoke.py`` and the port's
tools (``tools/fp8_loss_curves.py``, ``flash_digest.py``, ``serve_ab.py``,
``train_ab.py``, ``fleet_phases.py``, ``tail_phases.py``)
is scanned for
imports of ``jax``, ``jaxlib`` or ``mxnet_tpu`` (``mxnet_tpu_torch`` itself
is allowed), and a fresh interpreter that imports the port must end up
with neither ``jax`` nor ``mxnet_tpu`` loaded. A DataLoader's spawned
worker, which unpickles the dataset and imports the port, ends up with
neither too (run from a fresh interpreter, so this process's JAX is not
what is checked).
"""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "fp8_loss_curves.py",
    ROOT / "tools" / "flash_digest.py", ROOT / "tools" / "serve_ab.py",
    ROOT / "tools" / "train_ab.py", ROOT / "tools" / "fleet_phases.py",
    ROOT / "tools" / "tail_phases.py"]
BANNED = ("jax", "jaxlib", "mxnet_tpu")


def _banned(module):
    top = module.split(".")[0]
    return top in BANNED


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.ops.attention, mxnet_tpu_torch.functional, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.gluon.trainer, "
            "mxnet_tpu_torch.gluon.loss, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.ops.xent, mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch.ops.ln_residual, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.gluon.model_zoo.bert, mxnet_tpu_torch.amp.fp8, "
            "mxnet_tpu_torch.parallel, mxnet_tpu_torch.ops.quant_matmul, "
            "mxnet_tpu_torch.ops.quantization, "
            "mxnet_tpu_torch.contrib.quantization, "
            "mxnet_tpu_torch.ops.conv_bwd, mxnet_tpu_torch.gluon.nn.fuse, "
            "mxnet_tpu_torch.gluon.nn.conv_layers, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, mxnet_tpu_torch.amp, "
            "mxnet_tpu_torch.amp.lists, mxnet_tpu_torch.amp.loss_scaler, "
            "mxnet_tpu_torch.serialization, "
            "mxnet_tpu_torch.gluon.cached_graph, mxnet_tpu_torch.gluon.block, "
            "mxnet_tpu_torch.serve.engine, mxnet_tpu_torch.serve.quantize, "
            "mxnet_tpu_torch.serve.prefix, mxnet_tpu_torch.numpy, "
            "mxnet_tpu_torch.numpy.random, mxnet_tpu_torch.numpy.linalg, "
            "mxnet_tpu_torch.util, mxnet_tpu_torch.dlpack, "
            "mxnet_tpu_torch.test_utils, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.log, mxnet_tpu_torch.telemetry, "
            "mxnet_tpu_torch.fault, mxnet_tpu_torch.profiler, "
            "mxnet_tpu_torch.trace, mxnet_tpu_torch.pipeline, "
            "mxnet_tpu_torch.goodput, mxnet_tpu_torch.insight, "
            "mxnet_tpu_torch.blackbox, mxnet_tpu_torch._hooks, "
            "mxnet_tpu_torch.kvstore, mxnet_tpu_torch.kvstore.kvstore, "
            "mxnet_tpu_torch.kvstore.gradient_compression, "
            "mxnet_tpu_torch.optimizer.contrib, "
            "mxnet_tpu_torch.gluon.metric, mxnet_tpu_torch.gluon.utils, "
            "mxnet_tpu_torch.gluon.nn.activations, "
            "mxnet_tpu_torch.ops.deformable, mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch.gluon.data.dataloader, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.gluon.data.vision.datasets, "
            "mxnet_tpu_torch.gluon.contrib.estimator, "
            "mxnet_tpu_torch.numpy_extension.image, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.recordio, mxnet_tpu_torch.stream, "
            "mxnet_tpu_torch.resilience, mxnet_tpu_torch.io; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_spawned_dataloader_worker_loads_neither_jax_nor_reference():
    code = (
        "import os, sys\n"
        "import numpy as onp\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.gluon import data\n"
        "from mxnet_tpu_torch.gluon.data.vision import transforms as T\n"
        "ds = data.ArrayDataset(onp.zeros((4, 4, 4, 3), 'uint8'))"
        ".transform(T.ToTensor())\n"
        "with mx.cpu():\n"
        "    dl = data.DataLoader(ds, batch_size=2, num_workers=1,"
        " thread_pool=False)\n"
        "    assert len(list(dl)) == 2\n"
        "pool = dl._get_proc_pool()\n"
        "pids = {pool.submit(os.getpid).result()}\n"
        "bad = pool.submit(eval, \"sorted(m for m in __import__('sys')"
        ".modules if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))\")"
        ".result()\n"
        "dl.close()\n"
        "assert os.getpid() not in pids\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
