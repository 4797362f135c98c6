"""On-card tests of the port's CUDA kernels (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where no card is present
(the decision is taken inside the ``cuda_device`` fixture, never at
import). This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 atol=rtol=1e-4 (fp32 FMAs, another summation order than
cuBLAS); bf16 forward atol 2e-2 (bf16 output rounding); bf16 backward
rtol 2^-7 (one bf16 ulp of the output) plus atol 2^-10 of the output's
largest value (p and ds are rounded to bf16 before the products, and a
value on a rounding boundary may round the other way than in the plain
version). ln_residual: fp32 atol = rtol = 1e-5 for out, mean, rstd, dx
and dh (fp32 sums in another order; the plain version is the same
arithmetic), dgamma/dbeta atol 1e-5 of their largest |value| (sums over
up to 4096 rows in another order); bf16 rtol 2^-7 plus atol 2^-10 of the
largest |value|, as above. BERT on the card vs the CPU: losses atol =
rtol = 1e-4, gradients atol 1e-4 + rtol 1e-3, weights atol 1e-4 (as the
GPT comparison).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tflash
from mxnet_tpu_torch.ops import ln_residual as tln

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


SHAPES = [(2, 8, 8, 16), (3, 37, 37, 32), (12, 200, 200, 64),
          (2, 130, 70, 128), (4, 65, 257, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
def test_bwd_kernels_match_plain_version(cuda_device, bh, sq, sk, d, causal,
                                         dtype):
    q, k, v = _qkv(bh, sq, sk, d, dtype, cuda_device, seed=sq * sk + d)
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    do = torch.from_numpy(onp.random.RandomState(d).randn(bh, sq, d)
                          .astype("float32")).to(cuda_device, dtype)
    dkv0 = tflash.flash_attention_bwd_dkv.launches
    dq0 = tflash.flash_attention_bwd_dq.launches
    grads = tflash.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd_dkv.launches == dkv0 + 1
    assert tflash.flash_attention_bwd_dq.launches == dq0 + 1
    refs = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                causal)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == ref.shape, name
        if dtype == torch.float32:
            tol = dict(atol=1e-4, rtol=1e-4)
        else:
            tol = dict(atol=2.0 ** -10 * ref.float().abs().max().item(),
                       rtol=2.0 ** -7)
        torch.testing.assert_close(g.float(), ref.float(), msg=name, **tol)


@pytest.mark.parametrize("bad", ["head_dim", "float16", "cpu_mix"])
def test_bwd_wrapper_raises(cuda_device, bad):
    d = 48 if bad == "head_dim" else 64
    dtype = torch.float16 if bad == "float16" else torch.float32
    q, k, v = _qkv(2, 8, 8, d, dtype, cuda_device)
    do = torch.ones_like(q)
    lse = torch.zeros(2, 8, 1, device=cuda_device)
    delta = lse.cpu() if bad == "cpu_mix" else lse
    with pytest.raises(MXNetError):
        tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    with pytest.raises(MXNetError):
        tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_gradients_on_card_match_cpu(cuda_device, causal):
    """Attention on the card records its backward: the q/k/v gradients
    through ``multi_head_attention`` equal the CPU's."""
    rs = onp.random.RandomState(7)
    arrays = [rs.randn(2, 45, 4 * 32).astype("float32") for _ in range(4)]
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in arrays[:3])
        out = tattn.multi_head_attention(q, k, v, 4, causal=causal)
        out.backward(torch.tensor(arrays[3], device=dev))
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
    for g_card, g_cpu in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(g_card, g_cpu, atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_gpt_training_on_card_matches_cpu(cuda_device, optimizer):
    """Two record/backward/Trainer.step cycles of a small GPT on the card
    and on the CPU from the same weights: losses, every gradient and the
    weights agree, and each step launches every attention kernel once per
    layer."""
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
    cfg = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
               num_heads=2, max_length=64, dropout=0.0, embed_dropout=0.0)
    cpu = GPTForCausalLM(device="cpu", **cfg).initialize(seed=2)
    arrays = functional.param_arrays(cpu)
    ids = torch.from_numpy(onp.random.RandomState(3).randint(0, 97, (2, 41)))
    hyper = {"learning_rate": 1e-3, "wd": 0.01}
    if optimizer == "sgd":
        hyper["momentum"] = 0.9
    runs = {}
    for dev in ("cpu", cuda_device):
        net = GPTForCausalLM(device=dev, **cfg)
        functional.load_params(net, arrays)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        params = net.collect_params()
        for name, p in params.items():
            if "key_proj.bias" in name:
                # its gradient is zero in exact arithmetic (softmax is
                # shift invariant); Adam would turn the summation noise
                # into +-lr steps that differ between devices
                p.grad_req = "null"
        trainer = tmx.gluon.Trainer(params, optimizer, dict(hyper))
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        counts = [tflash.flash_attention_fwd.launches,
                  tflash.flash_attention_bwd_dkv.launches,
                  tflash.flash_attention_bwd_dq.launches]
        losses, grads = [], None
        for _ in range(2):
            with tmx.autograd.record():
                loss = loss_fn(net(x), y)
            tmx.autograd.backward(loss)
            if grads is None:
                grads = {n: p.grad().cpu().clone()
                         for n, p in params.items() if p.grad_req != "null"}
            trainer.step(2)
            losses.append(loss.detach().cpu())
        after = [tflash.flash_attention_fwd.launches,
                 tflash.flash_attention_bwd_dkv.launches,
                 tflash.flash_attention_bwd_dq.launches]
        if dev != "cpu":
            assert [a - c for a, c in zip(after, counts)] == [4, 4, 4]
        runs[str(dev)] = (losses, grads, functional.param_arrays(net))
    card, ref = runs[str(cuda_device)], runs["cpu"]
    for a, b in zip(card[0], ref[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for name, g in ref[1].items():
        assert torch.isfinite(card[1][name]).all(), name
        torch.testing.assert_close(card[1][name], g, atol=1e-4, rtol=1e-3,
                                   msg=name)
    for name, w in ref[2].items():
        onp.testing.assert_allclose(card[2][name], w, atol=1e-4, rtol=0,
                                    err_msg=name)


def _ln_inputs(n, d, p, dtype, device, mask_dtype=None, seed=0):
    rs = onp.random.RandomState(seed + n + d)
    x, h, do = (torch.from_numpy(rs.randn(n, d).astype("float32"))
                .to(device, dtype) for _ in range(3))
    gamma = torch.from_numpy((rs.rand(d) + 0.5).astype("float32")).to(
        device, dtype)
    beta = torch.from_numpy(rs.randn(d).astype("float32")).to(device, dtype)
    mask = None
    if p > 0:
        mask = torch.from_numpy(rs.rand(n, d) >= p).to(device,
                                                       mask_dtype or dtype)
    return x, h, mask, gamma, beta, do


LN_SHAPES = [(n, d) for n in (7, 600, 4096) for d in (128, 200, 768, 1024)]
LN_SHAPES += [(600, 199), (600, 2000)]  # no 16-byte path; a block per row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("n,d", LN_SHAPES)
def test_ln_residual_kernels_match_plain_version(cuda_device, n, d, p,
                                                 dtype):
    mask_dtype = (None, torch.bool, torch.uint8)[(n + d) % 3]
    x, h, mask, g, b, do = _ln_inputs(n, d, p, dtype, cuda_device,
                                      mask_dtype)
    f0, b0 = tln.ln_residual_fwd.launches, tln.ln_residual_bwd.launches
    out, mean, rstd = tln.ln_residual_fwd(x, h, mask, g, b, p)
    grads = tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, p)
    torch.cuda.synchronize()
    assert (tln.ln_residual_fwd.launches, tln.ln_residual_bwd.launches) \
        == (f0 + 1, b0 + 1)
    want = tln.ln_residual_fwd_reference(x, h, mask, g, b, p) \
        + tln.ln_residual_bwd_reference(x, h, mask, g, mean, rstd, do, p)
    names = ("out", "mean", "rstd", "dx", "dh", "dgamma", "dbeta")
    for name, got, ref in zip(names, (out, mean, rstd) + grads, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        top = ref.float().abs().max().item()
        if dtype == torch.bfloat16 and name not in ("mean", "rstd"):
            tol = dict(rtol=2.0 ** -7, atol=2.0 ** -10 * top)
        elif name in ("dgamma", "dbeta"):
            tol = dict(rtol=1e-5, atol=1e-5 * top)
        else:
            tol = dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got.float(), ref.float(), msg=name, **tol)


@pytest.mark.parametrize("bad", ["float16", "mask_shape", "contiguity",
                                 "too_wide", "no_mask"])
def test_ln_residual_wrappers_raise(cuda_device, bad):
    dtype = torch.float16 if bad == "float16" else torch.float32
    d = tln.MAX_DIM + 8 if bad == "too_wide" else 64
    x, h, mask, g, b, do = _ln_inputs(8, d, 0.1, dtype, cuda_device)
    if bad == "mask_shape":
        mask = mask[:4]
    elif bad == "contiguity":
        x = x.t().contiguous().t()
    elif bad == "no_mask":
        mask = None
    mean = torch.zeros(8, 1, device=cuda_device)
    rstd = torch.ones(8, 1, device=cuda_device)
    with pytest.raises(MXNetError):
        tln.ln_residual_fwd(x, h, mask, g, b, 0.1)
    with pytest.raises(MXNetError):
        tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)


def test_bert_training_on_card_matches_cpu(cuda_device):
    """Two record/backward/AdamW steps of a small BERT (dropout 0, so the
    two devices' random streams do not matter) with ``fused_ln_residual``
    "on", on the card and on the CPU from the same weights: losses, every
    gradient and the weights agree, and each step launches both
    ln_residual kernels twice per layer (the attention and the FFN
    residual)."""
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    cfg = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
               num_heads=2, max_length=64, dropout=0.0, embed_dropout=0.0)
    cpu = BERTForPretraining(device="cpu", **cfg).initialize(seed=4)
    arrays = functional.param_arrays(cpu)
    rs = onp.random.RandomState(5)
    ids = torch.from_numpy(rs.randint(0, 97, (2, 40)))
    types = torch.from_numpy((onp.arange(40) >= 17)[None].repeat(2, 0)
                             .astype("int64"))
    valid = torch.tensor([40, 29])
    labels = torch.from_numpy(rs.randint(0, 97, (2, 40)))
    weight = torch.from_numpy((rs.rand(2, 40) < 0.2).astype("float32"))
    nsp = torch.tensor([1, 0])
    tmx.config.set("fused_ln_residual", "on")
    try:
        runs = {}
        for dev in ("cpu", cuda_device):
            net = BERTForPretraining(device=dev, **cfg)
            functional.load_params(net, arrays)
            params = net.collect_params()
            for name, p in params.items():
                if "key_proj.bias" in name:
                    p.grad_req = "null"  # zero gradient in exact arithmetic
            trainer = tmx.gluon.Trainer(params, "adamw",
                                        {"learning_rate": 1e-4, "wd": 0.01})
            loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
            batch = [t.to(dev) for t in (ids, types, valid, labels, weight,
                                         nsp)]
            counts = (tln.ln_residual_fwd.launches,
                      tln.ln_residual_bwd.launches)
            losses, grads = [], None
            for _ in range(2):
                with tmx.autograd.record():
                    mlm, ns = net(*batch[:3])
                    loss = loss_fn(mlm, batch[3], batch[4]) \
                        + loss_fn(ns, batch[5])
                tmx.autograd.backward(loss)
                if grads is None:
                    grads = {n: p.grad().cpu().clone()
                             for n, p in params.items()
                             if p.grad_req != "null"}
                trainer.step(2)
                losses.append(loss.detach().cpu())
            if dev != "cpu":
                assert (tln.ln_residual_fwd.launches - counts[0],
                        tln.ln_residual_bwd.launches - counts[1]) == (8, 8)
            runs[str(dev)] = (losses, grads, functional.param_arrays(net))
    finally:
        tmx.config.reset("fused_ln_residual")
    card, ref = runs[str(cuda_device)], runs["cpu"]
    for a, b in zip(card[0], ref[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for name, g in ref[1].items():
        assert torch.isfinite(card[1][name]).all(), name
        torch.testing.assert_close(card[1][name], g, atol=1e-4, rtol=1e-3,
                                   msg=name)
    for name, w in ref[2].items():
        onp.testing.assert_allclose(card[2][name], w, atol=1e-4, rtol=0,
                                    err_msg=name)
