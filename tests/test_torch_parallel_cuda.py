"""On-card tests of the kernels on a second card (marker ``cuda``).

Each kernel launches on its tensors' device and that device's current
stream, whatever the thread's current device: a rank of a multi-card
world (one rank a card) runs them on ``cuda:r``. These run every kernel
on ``cuda:1`` with ``cuda:0`` current, against its plain version on the
same tensors, at the tolerances of ``tests/test_torch_cuda_kernels.py``
(whose inputs and checks they reuse). They skip where there is only one
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_parallel_cuda.py
"""
import os
import sys

import pytest
import torch

from mxnet_tpu_torch.ops import conv_bwd as tcb
from mxnet_tpu_torch.ops import flash_attention as tflash
from mxnet_tpu_torch.ops import ln_residual as tln
from mxnet_tpu_torch.ops import quant_matmul as tqm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_cuda_kernels as K  # noqa: E402

pytestmark = pytest.mark.cuda

#: the flash kernels' fp32 tolerance (their 3xTF32 products)
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
KERNELS = ["flash_fwd", "flash_bwd", "ln_residual", "fp8_matmul",
           "int8_matmul", "conv_bwd"]


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the kernels run on cuda:1 here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def _on(dev, *ts):
    return all(t.device == dev for t in ts if t is not None)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_runs_on_a_second_card(second_card, kernel):
    dev = second_card
    if kernel == "flash_fwd":
        q, k, v = K._qkv(12, 200, 200, 64, torch.float32, dev)
        out, lse = tflash.flash_attention_fwd(q, k, v, True)
        ref, rlse = tflash.flash_attention_fwd_reference(q, k, v, True)
        assert _on(dev, out, lse)
        torch.testing.assert_close(out, ref, **FP32_TOL)
        torch.testing.assert_close(lse, rlse, **FP32_TOL)
    elif kernel == "flash_bwd":
        q, k, v = K._qkv(12, 200, 200, 64, torch.float32, dev)
        out, lse = tflash.flash_attention_fwd_reference(q, k, v, True)
        do = torch.randn_like(out)
        got = tflash.flash_attention_bwd(q, k, v, out, lse, do, True)
        want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                    True)
        assert _on(dev, *got)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **FP32_TOL)
    elif kernel == "ln_residual":
        x, h, mask, gamma, beta, do = K._ln_inputs(600, 768, 0.1,
                                                   torch.float32, dev)
        fwd = tln.ln_residual_fwd(x, h, mask, gamma, beta, 0.1)
        ref = tln.ln_residual_fwd_reference(x, h, mask, gamma, beta, 0.1)
        out, mean, rstd = fwd
        bwd = tln.ln_residual_bwd(x, h, mask, gamma, mean, rstd, do, 0.1)
        want = tln.ln_residual_bwd_reference(x, h, mask, gamma, ref[1],
                                             ref[2], do, 0.1)
        assert _on(dev, *fwd, *bwd)
        K._ln_check(tuple(fwd) + tuple(bwd), tuple(ref) + tuple(want))
    elif kernel == "fp8_matmul":
        x, wq, ws, xs, b = K._fp8_inputs(256, 192, 320, "e4m3", "e4m3", dev,
                                         seed=3)
        out = tqm.fp8_matmul(x, wq, ws, xs, bias=b, act="gelu")
        ref = tqm.fp8_matmul_plain(x, wq, ws, xs, bias=b, act="gelu")
        assert _on(dev, out)
        K.fp8_check(out, ref, x, wq, ws, xs, "e4m3")
    elif kernel == "int8_matmul":
        x, wq, ws, xs, b = K._int8_inputs(256, 320, 192, dev, seed=3)
        out = tqm.quantized_matmul(x, wq, ws, xs, bias=b, act="relu")
        ref = tqm.quantized_matmul_plain(x, wq, ws, xs, bias=b, act="relu")
        assert _on(dev, out)
        K.int8_check(out, ref, "relu")
    else:
        args = K._cbr_inputs(2, 14, 14, 64, 64, dev, seed=5)
        dx, dw, dg, db = tcb.fused_conv3x3_bn_relu_bwd(*args)
        da, x, y, wt, gamma, beta, mean, var = args
        pg, pb, vec = tcb.bwd_stats(da, y, gamma, beta, mean, var)
        pdx, pdw = tcb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)
        assert _on(dev, dx, dw, dg, db)
        assert K._rel(dx, pdx) <= 2e-4 and K._rel(dw, pdw) <= 2e-4
        assert torch.equal(dg, pg) and torch.equal(db, pb)
    torch.cuda.synchronize(dev)
