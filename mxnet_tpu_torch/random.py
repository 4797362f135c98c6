"""Seeded generators.

Counterpart of ``mxnet_tpu/random.py``. Where the JAX package splits one
process-global threefry key, the port hands every sampler an explicit
``torch.Generator`` built here from a seed, and keeps no global RNG state.
"""
from __future__ import annotations

import torch

__all__ = ["generator"]


def generator(seed=0, device="cpu"):
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
