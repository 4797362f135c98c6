"""On-card tests of the port's CUDA kernels (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where no card is present
(the decision is taken inside the ``cuda_device`` fixture, never at
import). This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 atol=rtol=1e-4 (fp32 FMAs, another summation order than
cuBLAS), bf16 atol 2e-2 (bf16 output rounding).
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(bh, sq, sk, d, dtype, device, seed=0):
    rs = onp.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(bh, n, d).astype("float32"))
                 .to(device=device, dtype=dtype) for n in (sq, sk, sk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [(2, 8, 8, 16), (3, 37, 37, 32),
                                        (12, 200, 200, 64),
                                        (2, 130, 70, 128),
                                        (4, 65, 257, 64)])
def test_kernel_matches_plain_version(cuda_device, bh, sq, sk, d, causal,
                                      dtype):
    q, k, v = _qkv(bh, sq, sk, d, dtype, cuda_device, seed=sq + sk + d)
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, causal)
    assert out.dtype == dtype and lse.shape == (bh, sq, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                                   rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["head_dim", "float16", "cpu_mix"])
def test_kernel_wrapper_raises(cuda_device, bad):
    if bad == "head_dim":
        q, k, v = _qkv(2, 8, 8, 48, torch.float32, cuda_device)
    elif bad == "float16":
        q, k, v = _qkv(2, 8, 8, 64, torch.float16, cuda_device)
    else:
        q, k, v = _qkv(2, 8, 8, 64, torch.float32, cuda_device)
        k = k.cpu()
    with pytest.raises(MXNetError):
        tflash.flash_attention_fwd(q, k, v)


def test_gpt_on_card_matches_cpu(cuda_device):
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
    cfg = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
               num_heads=2, max_length=64, dropout=0.0, embed_dropout=0.0)
    cpu = GPTForCausalLM(device="cpu", **cfg).initialize(seed=1)
    gpu = GPTForCausalLM(device=cuda_device, **cfg)
    functional.load_params(gpu, functional.param_arrays(cpu))
    ids = torch.randint(0, 97, (2, 40), generator=torch.Generator()
                        .manual_seed(0))
    before = tflash.flash_attention_fwd.launches
    out = gpu(ids.to(cuda_device))
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 2
    torch.testing.assert_close(out.cpu(), cpu(ids), atol=1e-4, rtol=1e-4)
