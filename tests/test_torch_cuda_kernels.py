"""On-card tests of the port's CUDA kernels (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where no card is present
(the decision is taken inside the ``cuda_device`` fixture, never at
import). This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 atol=rtol=1e-4 (the flash kernels' 3xTF32 tensor-core
products, in another summation order than cuBLAS;
tests/test_torch_flash_tf32_split.py pins the split's arithmetic at that
tolerance on the CPU, forward and backward); the forward and the backward
at tile edges, at the GPT training shape, and two launches bit for bit
(no atomics); NaN and inf in the outputs where the plain version has them
(non-causal); bf16 forward and backward rtol 2^-7 (one bf16 ulp of the
output) plus atol 2^-10 of the output's largest value (p and ds are
rounded to bf16 before the products, as in the plain version, and a value
on a rounding boundary may round the other way). ln_residual: fp32 atol = rtol = 1e-5 for out, mean, rstd, dx
and dh (fp32 sums in another order; the plain version is the same
arithmetic), dgamma/dbeta atol 1e-5 of their largest |value| (sums over
up to 65536 rows in another order); bf16 rtol 2^-7 plus atol 2^-10 of the
largest |value|, as above; fp16 rtol 2^-10 (one fp16 ulp) plus atol
2^-13 of it; a second backward launch bit for bit, and one device kernel
a backward call. BERT on the card vs the CPU: losses atol =
rtol = 1e-4, gradients atol 1e-4 + rtol 1e-3, weights atol 1e-4 (as the
GPT comparison). fp8 matmul kernel vs its plain version: the same NaN and
inf positions, and elsewhere |err| <= 2^-20 of the sum of |products| x
|x_scale * w_scale| plus 1e-6 of |out| (exact fp8 products, as f16
values in the f16 wgmma, summed in the tensor core's fp32 accumulator in
another order than torch's fp32 matmul, measured at most 8.4e-8, about
2^-23.5, of that sum on the H100; the epilogue is the same arithmetic),
at ragged shapes around the kernel's tiles, the training shapes (a second
launch bit for bit) and x off 16 bytes. fp8 training on the card vs
the CPU: losses rtol 1e-4, weights after two Adam steps 99% within 5e-4
and all within 2e-3, and the second step's amaxes 5%: an ulp of
difference upstream can move a value across an fp8 rounding boundary
(see tests/test_torch_fp8.py). int8 matmul kernel vs its plain version:
bit for bit without activation and with relu (both sum exactly and round
the epilogue alike), atol = rtol = 1e-6 for sigmoid, tanh and gelu (the
card's expf/tanhf against torch's), at both GEMM tile widths, with a
second launch equal bit for bit and the prepare pass's s8 scratch equal
to ``int8_operands_plain``. A small quantized BERT on the card:
the kernel route's sequence output equals the plain chain's on the card
bit for bit; against the CPU, thresholds rtol 1e-5 and the outputs within
1% of their largest |value| (an ulp of the fp32 ops between the layers can
move a value across an int8 rounding boundary, a step of ~1e-3 here; the
int8 error itself is ~0.4%). Kernel 8 (conv3x3+BN+ReLU backward) vs its
plain version: dx and dw within max|diff| / max|plain| <= 2e-4 (3xTF32
tensor-core sums of up to 9*512 products in another order), dgamma and
dbeta bit for bit (one stats-pass function computes them for both), two
launches bit for bit (no atomics), and with an inf in x and w and a NaN
in da the plain version's NaN and inf positions. A BasicBlockV1 on the card (kernel 8 under "auto")
vs the CPU (the plain version under "on"): the reference's block-level
tolerances, output 1e-4, input gradient 1e-3, parameter gradients 2e-3.
Attention at a head_dim or dtype the flash kernels lack: the plain
composition, equal to the CPU's within 1e-5 (fp32) / 2e-2 (fp16 and bf16).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tflash
from mxnet_tpu_torch.ops import ln_residual as tln
from mxnet_tpu_torch.ops import quant_matmul as tqm

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
    assert out.dtype == dtype and lse.shape == (bh, sq, 1)
    _check_fwd(q, k, v, causal, out, lse)


def _check_fwd(q, k, v, causal, out, lse, msg=""):
    """The kernel's (out, lse) against the plain version's: fp32 atol =
    rtol = 1e-4, bf16 rtol 2^-7 plus atol 2^-10 max|ref|, lse 1e-4; NaN
    and inf at the plain version's positions."""
    ref_out, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, causal)
    if q.dtype == torch.float32:
        tol = dict(atol=1e-4, rtol=1e-4)
    else:
        fin = ref_out.float().isfinite()
        scale = ref_out.float()[fin].abs().max().item() if fin.any() else 0.0
        tol = dict(atol=2.0 ** -10 * scale, rtol=2.0 ** -7)
    torch.testing.assert_close(out.float(), ref_out.float(), equal_nan=True,
                               msg=f"out {msg}", **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4,
                               equal_nan=True, msg=f"lse {msg}")


# lengths around the forward's tiles (32 key rows in fp32, 64 in bf16 and
# 64 query rows a block), every pair of them, causal included
FWD_EDGE_LENGTHS = (1, 15, 17, 63, 65, 200, 712)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_fwd_kernel_cuts_tile_edges(cuda_device, d, causal, dtype):
    for sq in FWD_EDGE_LENGTHS:
        for sk in FWD_EDGE_LENGTHS:
            q, k, v = _qkv(3, sq, sk, d, dtype, cuda_device, seed=sq * sk + d)
            out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            _check_fwd(q, k, v, causal, out, lse, f"sq={sq} sk={sk}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_kernel_at_the_training_shape(cuda_device, dtype):
    # GPT-2 124M at batch 8 x seq 1024: b*h 96, d 64, causal
    q, k, v = _qkv(96, 1024, 1024, 64, dtype, cuda_device, seed=11)
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    _check_fwd(q, k, v, True, out, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_kernel_repeats_bit_for_bit(cuda_device, causal, dtype):
    """Two launches on the same inputs agree bit for bit."""
    q, k, v = _qkv(12, 255, 255, 64, dtype, cuda_device, seed=12)
    first = tflash.flash_attention_fwd(q, k, v, causal=causal)
    again = tflash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), first, again):
        assert torch.equal(a, b), name


def test_fwd_kernel_takes_a_misaligned_view(cuda_device):
    """A contiguous view that does not start on 16 bytes is copied before
    the 16-byte row copies; the result is the aligned inputs'."""
    q, k, v = _qkv(2, 37, 37, 16, torch.float32, cuda_device, seed=13)
    flat = torch.empty(k.numel() + 1, device=cuda_device)
    moved = flat[1:].view_as(k)
    moved.copy_(k)
    assert moved.data_ptr() % 16 != 0 and moved.is_contiguous()
    want = tflash.flash_attention_fwd(q, k, v, causal=True)
    got = tflash.flash_attention_fwd(q, moved, v, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["nan_q", "inf_k"])
def test_fwd_kernel_keeps_non_finite_positions(cuda_device, where, dtype):
    """A NaN made on the card (0/0 there is 0x7FFFFFFF in fp32) in q, or an
    inf in k: out and lse hold NaN and inf where the plain version holds
    them (a NaN row; a row whose score meets +inf is NaN, -inf gives p = 0),
    and the finite values keep the usual tolerances. Non-causal: a causal
    tile wholly above the diagonal is skipped, as the reference skips it."""
    bh, s, d = 2, 129, 64
    q, k, v = _qkv(bh, s, s, d, dtype, cuda_device, seed=5)
    zero = torch.zeros((), device=cuda_device)
    if where == "nan_q":
        q[0, 70, 3] = zero / zero
    else:
        k[0, 100, 3] = float("inf")
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=False)
    ref_out, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, False)
    torch.cuda.synchronize()
    for name, g, ref in (("out", out.float(), ref_out.float()),
                         ("lse", lse, ref_lse)):
        assert torch.equal(g.isnan(), ref.isnan()), name
        assert torch.equal(g.isinf(), ref.isinf()), name
        assert torch.equal(g[g.isinf()], ref[ref.isinf()]), name
        assert not ref[0].isfinite().all() and ref[1].isfinite().all(), name
    _check_fwd(q, k, v, False, out, lse)


def _bwd_inputs(bh, sq, sk, d, causal, dtype, device):
    """q, k, v, the forward kernel's (out, lse) and a random cotangent."""
    q, k, v = _qkv(bh, sq, sk, d, dtype, device, seed=sq * sk + d)
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    do = torch.from_numpy(onp.random.RandomState(d).randn(bh, sq, d)
                          .astype("float32")).to(device, dtype)
    return q, k, v, out, lse, do


def _check_bwd(bh, sq, sk, d, causal, dtype, device):
    q, k, v, out, lse, do = _bwd_inputs(bh, sq, sk, d, causal, dtype,
                                        device)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
def test_bwd_kernels_match_plain_version(cuda_device, bh, sq, sk, d, causal,
                                         dtype):
    _check_bwd(bh, sq, sk, d, causal, dtype, cuda_device)


# lengths one short of and one past the kernels' 64-row tiles (and their
# 32-row streamed tiles at d = 128), causal and not, at d 16 and 128; then
# seq_q != seq_k both ways, non-causal
BWD_EDGE_CASES = [
    (bh, s, s, d, causal) for bh, s in ((3, 127), (3, 129), (2, 255))
    for d in (16, 128) for causal in (False, True)] + [
    (2, 127, 255, 64, False), (2, 255, 129, 64, False),
    (2, 129, 127, 16, False), (2, 127, 129, 128, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", BWD_EDGE_CASES)
def test_bwd_kernels_cut_tile_edges(cuda_device, bh, sq, sk, d, causal,
                                    dtype):
    _check_bwd(bh, sq, sk, d, causal, dtype, cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_at_the_training_shape(cuda_device, dtype):
    # GPT-2 124M at batch 8 x seq 1024: b*h 96, d 64, causal
    _check_bwd(96, 1024, 1024, 64, True, dtype, cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernels_repeat_bit_for_bit(cuda_device, causal, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, out, lse, do = _bwd_inputs(12, 255, 255, 64, causal, dtype,
                                        cuda_device)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    first = (*tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal),
             tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal))
    again = (*tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal),
             tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), first, again):
        assert torch.equal(a, b), name


def test_bwd_kernels_take_a_misaligned_view(cuda_device):
    """A contiguous view that does not start on 16 bytes is copied before
    the 16-byte row copies; the result is the aligned inputs'."""
    q, k, v, out, lse, do = _bwd_inputs(2, 37, 37, 16, True, torch.float32,
                                        cuda_device)
    flat = torch.empty(q.numel() + 1, device=cuda_device)
    moved = flat[1:].view_as(q)
    moved.copy_(q)
    assert moved.data_ptr() % 16 != 0 and moved.is_contiguous()
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    want = tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    got = tflash.flash_attention_bwd_dkv(moved, k, v, do, lse, delta, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        tflash.flash_attention_bwd_dq(moved, k, v, do, lse, delta, True),
        tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["nan_q", "neg_nan_do", "inf_k",
                                   "nan_lse"])
def test_bwd_kernels_keep_non_finite_positions(cuda_device, where, dtype):
    """A NaN made on the card (0/0 there is 0x7FFFFFFF in fp32) in q, its
    negation in do, an inf in k, or a NaN in lse alone (finite tiles, so
    only p and ds carry it): the gradients hold NaN and inf where the
    plain version holds them, and the finite values keep the usual
    tolerances. Non-causal: a causal tile wholly above the diagonal is
    skipped, as the reference skips it, where the plain version multiplies
    its zero p by the non-finite value."""
    bh, s, d = 2, 129, 64
    q, k, v = _qkv(bh, s, s, d, dtype, cuda_device, seed=5)
    do = torch.from_numpy(onp.random.RandomState(6).randn(bh, s, d)
                          .astype("float32")).to(cuda_device, dtype)
    zero = torch.zeros((), device=cuda_device)
    nan = zero / zero
    if where == "nan_q":
        q[0, 70, 3] = nan
    elif where == "neg_nan_do":
        do[0, 70, 3] = -nan
    elif where == "inf_k":
        k[0, 100, 3] = float("inf")
    out, lse = tflash.flash_attention_fwd_reference(q, k, v, False)
    if where == "nan_lse":
        lse[0, 70] = nan
    grads = tflash.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    refs = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, False)
    torch.cuda.synchronize()
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        g, ref = g.float(), ref.float()
        assert torch.equal(g.isnan(), ref.isnan()), name
        assert torch.equal(g.isinf(), ref.isinf()), name
        assert torch.equal(g[g.isinf()], ref[ref.isinf()]), name
        fin = ref.isfinite()
        assert not fin[0].all() and fin[1].all(), name
        if dtype == torch.float32:
            tol = dict(atol=1e-4, rtol=1e-4)
        else:
            tol = dict(atol=2.0 ** -10 * ref[fin].abs().max().item(),
                       rtol=2.0 ** -7)
        torch.testing.assert_close(g[fin], ref[fin], msg=name, **tol)


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


def _ln_inputs(n, d, p, dtype, device, mask_dtype=None, seed=0,
               h_dtype=None, g_dtype=None):
    rs = onp.random.RandomState(seed + n + d)
    x, h, do = (torch.from_numpy(rs.randn(n, d).astype("float32"))
                .to(device, t) for t in (dtype, h_dtype or dtype, dtype))
    gamma = torch.from_numpy((rs.rand(d) + 0.5).astype("float32")).to(
        device, g_dtype or dtype)
    beta = torch.from_numpy(rs.randn(d).astype("float32")).to(
        device, g_dtype or dtype)
    mask = None
    if p > 0:
        mask = torch.from_numpy(rs.rand(n, d) >= p).to(device,
                                                       mask_dtype or dtype)
    return x, h, mask, gamma, beta, do


def _ln_check(got, want, names=("out", "mean", "rstd", "dx", "dh", "dgamma",
                                "dbeta")):
    """Kernel results against the plain version's, by each result's dtype:
    bf16 rtol 2^-7 plus atol 2^-10 of the largest |value|, fp16 rtol 2^-10
    plus atol 2^-13 of it, fp32 1e-5 (dgamma/dbeta atol 1e-5 of it)."""
    for name, g, ref in zip(names, got, want):
        assert g.dtype == ref.dtype and g.shape == ref.shape, name
        top = ref.float().abs().max().item()
        if g.dtype == torch.bfloat16:
            tol = dict(rtol=2.0 ** -7, atol=2.0 ** -10 * top)
        elif g.dtype == torch.float16:
            tol = dict(rtol=2.0 ** -10, atol=2.0 ** -13 * top)
        elif name in ("dgamma", "dbeta"):
            tol = dict(rtol=1e-5, atol=1e-5 * top)
        else:
            tol = dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(g.float(), ref.float(), msg=name, **tol)


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
    _ln_check((out, mean, rstd) + grads, want)


# (x, h, gamma/beta, mask) dtypes: the reference's rule, each its own
LN_DTYPE_CASES = {
    "f16_rows": (torch.float16, torch.float16, torch.float16,
                 torch.float16),
    "bf16_rows_f32_gamma": (torch.bfloat16, torch.bfloat16, torch.float32,
                            torch.bool),
    "f32_x_bf16_h": (torch.float32, torch.bfloat16, torch.float32,
                     torch.float32),
    "bf16_x_f32_h": (torch.bfloat16, torch.float32, torch.bfloat16,
                     torch.uint8),
    "bf16_rows_f32_mask": (torch.bfloat16, torch.bfloat16, torch.bfloat16,
                           torch.float32),
    "f16_rows_f32_gamma": (torch.float16, torch.float16, torch.float32,
                           torch.bool),
    "f32_rows_f16_gamma": (torch.float32, torch.float32, torch.float16,
                           torch.float16),
}


@pytest.mark.parametrize("n,d", [(600, 768), (131, 200), (64, 1999)])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(LN_DTYPE_CASES))
def test_ln_residual_dtypes_match_plain_version(cuda_device, case, p, n, d):
    """Rows, gamma/beta and the mask each in its own dtype, fp16 rows
    included: the kernels take them all, with the plain version's output
    dtypes and values."""
    x_t, h_t, g_t, m_t = LN_DTYPE_CASES[case]
    x, h, mask, g, b, do = _ln_inputs(n, d, p, x_t, cuda_device, m_t,
                                      h_dtype=h_t, g_dtype=g_t)
    f0, b0 = tln.ln_residual_fwd.launches, tln.ln_residual_bwd.launches
    out, mean, rstd = tln.ln_residual_fwd(x, h, mask, g, b, p)
    grads = tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, p)
    torch.cuda.synchronize()
    assert (tln.ln_residual_fwd.launches, tln.ln_residual_bwd.launches) \
        == (f0 + 1, b0 + 1)
    assert (out.dtype, grads[0].dtype, grads[1].dtype, grads[2].dtype,
            grads[3].dtype) == (x_t, x_t, h_t, g_t, g_t)
    want = tln.ln_residual_fwd_reference(x, h, mask, g, b, p) \
        + tln.ln_residual_bwd_reference(x, h, mask, g, mean, rstd, do, p)
    _ln_check((out, mean, rstd) + grads, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,d", [(1, 768), (131, 768), (133, 768),
                                 (4097, 768), (65536, 768), (600, 8192),
                                 (600, 1999)])
def test_ln_residual_bwd_repeats_bit_for_bit(cuda_device, n, d, dtype):
    """Ragged n around the backward's row groups and blocks, many waves of
    blocks (65536 rows), a block per row and no 16-byte path: against the
    plain version, and a second launch equal bit for bit (dgamma/dbeta are
    summed in a fixed order, without float atomics); the barrier's ticket
    count is left zero (its generation word counts the calls)."""
    x, h, mask, g, b, do = _ln_inputs(n, d, 0.1, dtype, cuda_device)
    _, mean, rstd = tln.ln_residual_fwd(x, h, mask, g, b, 0.1)
    first = tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)
    again = tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)
    torch.cuda.synchronize()
    names = ("dx", "dh", "dgamma", "dbeta")
    for name, a, b2 in zip(names, first, again):
        assert torch.equal(a, b2), name
    _ln_check(first, tln.ln_residual_bwd_reference(x, h, mask, g, mean,
                                                   rstd, do, 0.1), names)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert tln._tickets_for(cuda_device, stream)[0].item() == 0


@pytest.mark.parametrize("dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16)])
def test_ln_residual_bwd_is_one_device_kernel(cuda_device, dtype, g_dtype):
    """A backward call runs exactly one device kernel (torch.profiler): no
    sum, cast or memset around the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, h, mask, g, b, do = _ln_inputs(4096, 768, 0.1, dtype, cuda_device,
                                      g_dtype=g_dtype)
    _, mean, rstd = tln.ln_residual_fwd(x, h, mask, g, b, 0.1)
    tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tln.ln_residual_bwd(x, h, mask, g, mean, rstd, do, 0.1)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "ln_residual_bwd_kernel" in kernels[0], \
        kernels


@pytest.mark.parametrize("bad", ["float64", "mask_shape", "contiguity",
                                 "too_wide", "no_mask"])
def test_ln_residual_wrappers_raise(cuda_device, bad):
    dtype = torch.float64 if bad == "float64" else torch.float32
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


# -- fp8 matmul (kernel 7) ---------------------------------------------------

# (M, N, K); the last four cut the kernel's 128 x 128 output tile and
# 64-value k-tile: M and N of tile +- 1, N % 4 != 0, K = 100 (padded) and
# K = 784 (a partial last k-tile)
FP8_SHAPES = [(1, 5, 100), (37, 130, 256), (130, 5, 100), (200, 300, 768),
              (127, 127, 784), (129, 129, 784), (129, 132, 100),
              (255, 130, 784)]
FP8_TRAIN_SHAPES = [(8192, 768, 768), (8192, 3072, 768), (8192, 768, 3072)]
FP8_ACTS = [None, "relu", "sigmoid", "tanh", "gelu"]


def _fp8_inputs(m, n, k, fmt, wfmt, device, seed, overflow=False,
                offset=False):
    """``offset``: x 4 bytes into its buffer (contiguous, not 16-byte
    aligned)."""
    rs = onp.random.RandomState(seed)
    wdt, wmax = tqm.FP8_FORMATS[wfmt]
    _, absmax = tqm.FP8_FORMATS[fmt]
    x = rs.randn(m, k).astype("float32")
    w = (rs.randn(n, k) * 0.5).astype("float32")
    ws = (onp.abs(w).max(axis=1) / wmax).astype("float32")
    xs = float(onp.abs(x).max() / absmax)
    if overflow:
        x[0, 3] = 2.5 * absmax * xs
        x[-1, 0] = -70000.0 * xs
    wq = tqm.quantize(torch.from_numpy(w / ws[:, None]), wfmt)
    b = torch.from_numpy(rs.randn(n).astype("float32"))
    xt = torch.from_numpy(x).to(device)
    if offset:
        buf = torch.empty(m * k + 1, device=device)
        buf[1:] = xt.reshape(-1)
        xt = buf[1:].view(m, k)
    return (xt, wq.to(device), torch.from_numpy(ws).to(device), xs,
            b.to(device))


def fp8_check(out, ref, x, wq, ws, xs, fmt):
    """The kernel's output against the plain version's at the tolerance of
    the module docstring; returns max |err| over the finite values."""
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert torch.equal(out[torch.isinf(out)], ref[torch.isinf(ref)])
    fin = torch.isfinite(ref)
    mag = (tqm.quantize(x / xs, fmt).float().abs().nan_to_num(0, 0, 0)
           @ wq.float().abs().t()) * (xs * ws).abs()
    err = (out - ref).abs()
    tol = 2.0 ** -20 * mag + 1e-6 * ref.abs()
    assert bool((err[fin] <= tol[fin]).all()), float(err[fin].max())
    return float(err[fin].max()) if fin.any() else 0.0


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", FP8_ACTS)
@pytest.mark.parametrize("fmt,wfmt", [("e4m3", "e4m3"), ("e5m2", "e5m2"),
                                      ("e4m3", "e5m2"), ("e5m2", "e4m3")])
@pytest.mark.parametrize("m,n,k", FP8_SHAPES)
def test_fp8_kernel_matches_plain_version(cuda_device, m, n, k, fmt, wfmt,
                                          act, bias):
    x, wq, ws, xs, b = _fp8_inputs(m, n, k, fmt, wfmt, cuda_device,
                                   seed=m + n + k)
    b = b if bias else None
    before = tqm.fp8_matmul.launches
    out = tqm.fp8_matmul(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    torch.cuda.synchronize()
    assert tqm.fp8_matmul.launches == before + 1
    ref = tqm.fp8_matmul_plain(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    fp8_check(out, ref, x, wq, ws, xs, fmt)


@pytest.mark.parametrize("m,n,k", FP8_TRAIN_SHAPES)
def test_fp8_kernel_at_the_training_shapes(cuda_device, m, n, k):
    """The GPT-2 fp8 step's shapes (e4m3, no bias, no activation): within
    the tolerance, and a second launch bit for bit (no split-K, no
    atomics)."""
    x, wq, ws, xs, _ = _fp8_inputs(m, n, k, "e4m3", "e4m3", cuda_device,
                                   seed=k)
    out = tqm.fp8_matmul(x, wq, ws, xs)
    again = tqm.fp8_matmul(x, wq, ws, xs)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    fp8_check(out, tqm.fp8_matmul_plain(x, wq, ws, xs), x, wq, ws, xs,
              "e4m3")


def test_fp8_kernel_takes_a_misaligned_x(cuda_device):
    """x 4 bytes into its buffer (no 16-byte loads): the aligned copy's
    result bit for bit."""
    x, wq, ws, xs, b = _fp8_inputs(129, 132, 784, "e4m3", "e4m3",
                                   cuda_device, seed=5, offset=True)
    assert x.data_ptr() % 16 != 0
    out = tqm.fp8_matmul(x, wq, ws, xs, bias=b, act="gelu")
    aligned = tqm.fp8_matmul(x.clone(), wq, ws, xs, bias=b, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(out, aligned)
    fp8_check(out, tqm.fp8_matmul_plain(x, wq, ws, xs, bias=b, act="gelu"),
              x, wq, ws, xs, "e4m3")


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_kernel_overflow_matches_plain_version(cuda_device, fmt, act):
    """Past the format's top the kernel's cast gives NaN (e4m3fn) or inf
    (e5m2) where the plain version's JAX rule does, not a saturated
    value."""
    x, wq, ws, xs, b = _fp8_inputs(37, 130, 256, fmt, fmt, cuda_device,
                                   seed=3, overflow=True)
    out = tqm.fp8_matmul(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    ref = tqm.fp8_matmul_plain(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    torch.cuda.synchronize()
    assert not torch.isfinite(ref).all()
    fp8_check(out, ref, x, wq, ws, xs, fmt)


def test_fp8_kernel_quantizes_the_training_operands_bit_for_bit(
        cuda_device):
    """The capable branch of fp8_linear hands the kernel qx / x_scale and
    1 / x_scale; the kernel's own cast of that must give qx back bit for
    bit. Probed through an identity weight (acc = the quantized value,
    times xs * ws = 1 within an ulp, which rounds back to the same fp8
    value), then the branch's output against the fallback's."""
    from mxnet_tpu_torch.amp import fp8 as tfp8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(64, 768, device=cuda_device, generator=gen) * 3
    w = torch.randn(768, 768, device=cuda_device, generator=gen) * 0.07
    xs = torch.tensor(448.0 / 9.5, device=cuda_device)
    ws = torch.tensor(448.0 / 0.3, device=cuda_device)
    qx = tfp8._qcast(x, xs, "e4m3")
    h2 = qx.float() / xs
    eye = torch.eye(768, device=cuda_device).to(torch.float8_e4m3fn)
    probe = tqm.fp8_matmul(h2, eye, torch.full((768,), 1.0,
                                               device=cuda_device) * xs,
                           1.0 / xs, fmt="e4m3")
    assert torch.equal(probe.to(torch.float8_e4m3fn).view(torch.uint8),
                       qx.view(torch.uint8))
    before = tqm.fp8_matmul.launches
    y, qx2, qw = tfp8._fwd_value(x, w, None, xs, ws)
    torch.cuda.synchronize()
    assert tqm.fp8_matmul.launches == before + 1
    assert torch.equal(qx2.view(torch.uint8), qx.view(torch.uint8))
    fallback = (qx.float() @ qw.float().t()) / (xs * ws)
    mag = (qx.float().abs() @ qw.float().abs().t()) / (xs * ws)
    assert bool(((y - fallback).abs() <= 2.0 ** -20 * mag
                 + 1e-6 * fallback.abs()).all())


@pytest.mark.parametrize("bad", ["float16", "w_float32", "cpu_mix",
                                 "contiguity", "ws_shape", "fmt"])
def test_fp8_wrapper_raises(cuda_device, bad):
    x, wq, ws, xs, _ = _fp8_inputs(16, 32, 64, "e4m3", "e4m3", cuda_device,
                                   seed=0)
    if bad == "float16":
        x = x.half()
    elif bad == "w_float32":
        wq = wq.float()
    elif bad == "cpu_mix":
        wq = wq.cpu()
    elif bad == "contiguity":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif bad == "ws_shape":
        ws = ws[:-1]
    err = ValueError if bad == "fmt" else MXNetError
    with pytest.raises(err):
        tqm.fp8_matmul(x, wq, ws, xs, fmt="e3m4" if bad == "fmt" else "e4m3")


def test_fp8_routes_raise_on_a_card_the_kernel_was_not_built_for(
        cuda_device, monkeypatch):
    """No fallback hides the kernel: with fp8_capable False (a card of
    another compute capability), a Dense under fp8.scope and
    npx.fp8_dense_fused on "auto" raise, and launch nothing."""
    from mxnet_tpu_torch.amp import fp8 as tfp8
    from mxnet_tpu_torch.gluon import nn
    monkeypatch.setattr(tqm, "fp8_capable", lambda device=None: False)
    net = nn.Dense(64, in_units=32, device=cuda_device)
    net.initialize(seed=0)
    one = torch.ones((), device=cuda_device)
    before = tqm.fp8_matmul.launches
    with tfp8.scope({"weight": (one, one, one)}, {net.weight: "weight"}):
        with pytest.raises(MXNetError, match="compute capability"):
            net(torch.randn(8, 32, device=cuda_device))
    x, wq, ws, xs, _ = _fp8_inputs(16, 32, 64, "e4m3", "e4m3", cuda_device,
                                   seed=0)
    with pytest.raises(MXNetError, match="compute capability"):
        tmx.npx.fp8_dense_fused(x, wq, xs, ws)
    assert tqm.fp8_matmul.launches == before


def test_fp8_training_on_card_matches_cpu(cuda_device):
    """Two Adam steps of ShardedTrainStep(precision="fp8") over a small GPT
    on the card and on the CPU from the same weights: every Dense site
    launches the kernel once a step, and losses, weights and amax
    histories agree at the module docstring's tolerances."""
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM
    from mxnet_tpu_torch.ops.xent import sparse_softmax_xent
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    cfg = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
               num_heads=2, max_length=64, dropout=0.0, embed_dropout=0.0)
    arrays = functional.param_arrays(
        GPTForCausalLM(device="cpu", **cfg).initialize(seed=6))
    ids = torch.from_numpy(onp.random.RandomState(7).randint(0, 97, (4, 41)))
    runs = {}
    for dev in ("cpu", cuda_device):
        net = GPTForCausalLM(device=dev, **cfg)
        functional.load_params(net, arrays)
        for name, p in net.collect_params().items():
            if "key_proj.bias" in name:
                p.grad_req = "null"  # zero gradient in exact arithmetic
        cfg_mesh = MeshConfig(dp=1)
        step = ShardedTrainStep(
            net, lambda out, y: sparse_softmax_xent(out, y).mean(), "adam",
            cfg_mesh, cfg_mesh.batch_specs(2, 2), precision="fp8")
        before = tqm.fp8_matmul.launches
        losses = [step(ids[:, :-1], ids[:, 1:]).cpu() for _ in range(2)]
        if dev != "cpu":
            assert tqm.fp8_matmul.launches - before == 2 * 12
        hist = {s: {k: v.cpu() for k, v in h.items()}
                for s, h in step.extra["fp8"].items()}
        runs[str(dev)] = (losses, functional.param_arrays(net), hist)
    card, ref = runs[str(cuda_device)], runs["cpu"]
    for a, b in zip(card[0], ref[0]):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-4)
    for name, w in ref[1].items():
        diff = onp.abs(card[1][name] - w)
        assert (diff > 5e-4).mean() < 0.01 and diff.max() <= 2e-3, name
    for site, h in ref[2].items():
        for k, v in h.items():
            torch.testing.assert_close(card[2][site][k][1:], v[1:], atol=0,
                                       rtol=1e-3)
            torch.testing.assert_close(card[2][site][k][0], v[0], atol=0,
                                       rtol=0.05)


# -- int8 matmul (kernel 6) --------------------------------------------------

INT8_SHAPES = [(1, 100, 5), (37, 256, 130), (130, 100, 5), (64, 200, 70),
               (200, 768, 300)]  # (M, K, N)
INT8_ACTS = [None, "relu", "sigmoid", "tanh", "gelu"]


def _int8_inputs(m, k, n, device, seed, offset=False):
    """x with NaN, +-inf, a value past +-127 and exact .5 ties of
    x / x_scale (x_scale a power of two); ``offset``: x 4 bytes into its
    buffer (contiguous, not 16-byte aligned)."""
    rs = onp.random.RandomState(seed)
    buf = rs.randn(m * k + 1).astype("float32")
    x = (buf[1:] if offset else buf[:-1]).reshape(m, k)
    xs = float(2.0 ** round(onp.log2(onp.abs(x).max() * 0.8 / 127)))
    x[0, :6] = onp.array([0.5, 1.5, 2.5, -2.5, -0.5, 126.5]) * xs
    x[-1, -1], x[m // 2, 0], x[0, -1] = onp.nan, onp.inf, -onp.inf
    x[-1, 0] = 300.0 * xs
    w = (rs.randn(n, k) * 0.5).astype("float32")
    ws = (onp.abs(w).max(axis=1) / 127).astype("float32")
    wq = onp.clip(onp.round(w / ws[:, None]), -127, 127).astype("int8")
    b = rs.randn(n).astype("float32")
    tbuf = torch.from_numpy(buf).to(device)  # x is a view of buf
    return ((tbuf[1:] if offset else tbuf[:-1]).view(m, k),
            torch.from_numpy(wq).to(device),
            torch.from_numpy(ws).to(device), xs,
            torch.from_numpy(b).to(device))


def int8_check(out, ref, act):
    assert torch.equal(out.isnan(), ref.isnan())
    fin = ~ref.isnan()
    if act in (None, "relu"):
        assert torch.equal(out[fin], ref[fin])
    else:
        torch.testing.assert_close(out[fin], ref[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", INT8_ACTS)
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_kernel_matches_plain_version(cuda_device, m, k, n, act, bias,
                                           offset):
    x, wq, ws, xs, b = _int8_inputs(m, k, n, cuda_device, seed=m + k + n,
                                    offset=offset)
    assert (x.data_ptr() % 16 != 0) == offset
    b = b if bias else None
    before = tqm.quantized_matmul.launches
    out = tqm.quantized_matmul(x, wq, ws, xs, bias=b, act=act)
    torch.cuda.synchronize()
    assert tqm.quantized_matmul.launches == before + 1
    ref = tqm.quantized_matmul_plain(x, wq, ws, xs, bias=b, act=act)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    int8_check(out, ref, act)


@pytest.mark.parametrize("tile_n", [0, 128, 192])
@pytest.mark.parametrize("m,k,n", [(4096, 768, 768), (200, 768, 300)])
def test_int8_kernel_repeats_bit_for_bit(cuda_device, m, k, n, tile_n):
    """A second launch gives the same bits (no split-K, no atomics), at
    the kernel's own tile choice and at each tile width."""
    x, wq, ws, xs, b = _int8_inputs(m, k, n, cuda_device, seed=m + n)
    tqm.quantized_matmul.tile_n = tile_n
    try:
        out = tqm.quantized_matmul(x, wq, ws, xs, bias=b)
        again = tqm.quantized_matmul(x, wq, ws, xs, bias=b)
    finally:
        tqm.quantized_matmul.tile_n = 0
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    int8_check(out, tqm.quantized_matmul_plain(x, wq, ws, xs, bias=b), None)


@pytest.mark.parametrize("tile_n", [128, 192])
@pytest.mark.parametrize("n", [190, 192])
def test_int8_kernel_both_epilogues_at_a_ragged_m(cuda_device, n, tile_n):
    """N % 4 != 0 takes the epilogue that stores straight from the
    registers, N % 4 == 0 the TMA store; M = 129 cuts a row tile."""
    x, wq, ws, xs, b = _int8_inputs(129, 784, n, cuda_device, seed=n)
    tqm.quantized_matmul.tile_n = tile_n
    try:
        out = tqm.quantized_matmul(x, wq, ws, xs, bias=b, act="relu")
    finally:
        tqm.quantized_matmul.tile_n = 0
    torch.cuda.synchronize()
    int8_check(out, tqm.quantized_matmul_plain(x, wq, ws, xs, bias=b,
                                               act="relu"), "relu")


@pytest.mark.parametrize("m,k,n,offset", [(64, 768, 768, False),
                                          (37, 200, 200, True)])
def test_int8_kernel_quantizes_x_like_int8_operands_plain(cuda_device, m, k,
                                                          n, offset):
    """The prepare pass's s8 scratch, probed through an identity weight
    (acc = the quantized value, times x_scale * w_scale = 1 exactly, with
    x_scale a power of two), equals int8_operands_plain bit for bit; and
    the scratch itself (x's, and w's where K % 16 != 0), pad included, read
    back from a launch with the scratch handed in."""
    x, _, _, xs, _ = _int8_inputs(m, k, n, cuda_device, seed=k,
                                  offset=offset)
    eye = torch.eye(k, device=cuda_device).to(torch.int8)
    ones = torch.full((k,), 1.0 / xs, device=cuda_device)
    xq, wq = tqm.int8_operands_plain(x, eye, xs)
    probe = tqm.quantized_matmul(x, eye, ones, xs)
    torch.cuda.synchronize()
    assert torch.equal(probe, xq[:, :k].float())
    got_x = torch.full_like(xq, 99)
    got_w = None if k % 16 == 0 else torch.full_like(wq, 99)
    out = torch.empty((m, k), device=cuda_device)
    tqm._int8_launch(x, eye, ones, tqm._scale_tensor(xs, cuda_device), None,
                     None, out, got_x, got_w)
    torch.cuda.synchronize()
    assert torch.equal(got_x, xq)
    assert got_w is None or torch.equal(got_w, wq)
    assert torch.equal(out, probe)


@pytest.mark.parametrize("bad", ["float16", "w_float32", "cpu_mix",
                                 "contiguity", "ws_shape", "act"])
def test_int8_wrapper_raises(cuda_device, bad):
    x, wq, ws, xs, _ = _int8_inputs(16, 64, 32, cuda_device, seed=0)
    if bad == "float16":
        x = x.half()
    elif bad == "w_float32":
        wq = wq.float()
    elif bad == "cpu_mix":
        wq = wq.cpu()
    elif bad == "contiguity":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif bad == "ws_shape":
        ws = ws[:-1]
    before = tqm.quantized_matmul.launches
    with pytest.raises(ValueError if bad == "act" else MXNetError):
        tqm.quantized_matmul(x, wq, ws, xs,
                             act="softrelu" if bad == "act" else None)
    assert tqm.quantized_matmul.launches == before


def test_int8_routes_raise_on_a_card_the_kernel_was_not_built_for(
        cuda_device, monkeypatch):
    """No fallback hides the kernel: on a card of compute capability 8.0
    (faked), a QuantizedDense and npx.quantized_dense_fused on "auto"
    raise, and launch nothing."""
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=32,
                     device=cuda_device))
    net.initialize(seed=0)
    x = torch.randn(8, 32, device=cuda_device)
    qnet = cq.quantize_net(net, calib_data=[x])
    monkeypatch.setattr(tqm, "_capability", lambda index: (8, 0))
    before = tqm.quantized_matmul.launches
    with pytest.raises(MXNetError, match="compute capability"):
        qnet(x)
    wq, ws = qnet[0].qweight, qnet[0].w_scale
    with pytest.raises(MXNetError, match="compute capability"):
        tmx.npx.quantized_dense_fused(x, wq, 0.1, ws)
    assert tqm.quantized_matmul.launches == before


def test_int8_bert_on_card_matches_cpu(cuda_device):
    """quantize_net over a small BERT on the card and on the CPU from the
    same weights and calibration batches: the same thresholds and int8
    weights, 13 kernel launches a forward, the kernel route's sequence
    output equal to the plain chain's on the card bit for bit, and the
    outputs near the CPU's (module docstring)."""
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    cfg = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
               num_heads=2, max_length=64, dropout=0.0, embed_dropout=0.0)
    arrays = functional.param_arrays(
        BERTModel(device="cpu", **cfg).initialize(seed=2))
    rs = onp.random.RandomState(3)
    calib = [torch.from_numpy(rs.randint(0, 97, (4, 40))) for _ in range(2)]
    batch = (torch.from_numpy(rs.randint(0, 97, (4, 40))),
             torch.from_numpy((onp.arange(40) >= 15)[None].repeat(4, 0)
                              .astype("int64")),
             torch.tensor([40, 33, 20, 9]))
    runs = {}
    for dev in ("cpu", cuda_device):
        net = BERTModel(device=dev, **cfg)
        functional.load_params(net, arrays)
        qnet = cq.quantize_net(net, calib_data=[c.to(dev) for c in calib])
        layers = {p: b for _, _, p, b in cq._walk_layers(qnet)
                  if isinstance(b, cq.QuantizedDense)}
        before = tqm.quantized_matmul.launches
        out = qnet(*(t.to(dev) for t in batch))
        runs[str(dev)] = (qnet, layers, out)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tqm.quantized_matmul.launches - before == 13
            tmx.config.set("quantize.fused_matmul", "off")
            try:
                off = qnet(*(t.to(dev) for t in batch))
            finally:
                tmx.config.reset("quantize.fused_matmul")
            assert torch.equal(out[0], off[0])
            torch.testing.assert_close(out[1], off[1], atol=1e-6, rtol=1e-6)
    card, ref = runs[str(cuda_device)], runs["cpu"]
    assert sorted(card[1]) == sorted(ref[1]) and len(ref[1]) == 13
    for p, layer in ref[1].items():
        assert card[1][p].threshold == pytest.approx(layer.threshold,
                                                     rel=1e-5), p
    card_arrays = functional.param_arrays(card[0])
    for name, v in functional.param_arrays(ref[0]).items():
        onp.testing.assert_array_equal(card_arrays[name], v, err_msg=name)
    for got, want in zip(card[2], ref[2]):
        got = got.cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-2 * want.abs().max()


# -- kernel 8: conv3x3 + BN + ReLU backward ------------------------------------

from mxnet_tpu_torch.ops import conv_bwd as tcb  # noqa: E402

CONV_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
               (32, 14, 14, 256, 256), (32, 7, 7, 512, 512),
               (3, 7, 9, 5, 11), (2, 9, 7, 70, 33), (2, 1, 3, 3, 2),
               # pixel chunks across images, N*H*W not a multiple of the
               # chunk; W = 1; 4 x 14 patches; C and O off the channel
               # chunks; a dgrad split over output channels
               (5, 13, 11, 40, 24), (2, 9, 1, 3, 2), (2, 28, 28, 20, 12),
               (1, 2, 2, 7, 13), (4, 7, 7, 36, 520)]


def _cbr_inputs(n, h, w, c, o, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, c, h, w, device=device, generator=gen)
    wt = torch.randn(o, c, 3, 3, device=device, generator=gen) \
        * (2.0 / (9 * c)) ** 0.5
    gamma = torch.rand(o, device=device, generator=gen) + 0.5
    beta = torch.randn(o, device=device, generator=gen) * 0.1
    a, y, mean, var = tcb.conv3x3_bn_relu_ref(x, wt, gamma, beta)
    da = torch.randn(n, o, h, w, device=device, generator=gen)
    return da, x, y, wt, gamma, beta, mean, var


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("n,h,w,c,o", CONV_SHAPES)
def test_conv_bwd_kernel_matches_plain_version(cuda_device, n, h, w, c, o):
    args = _cbr_inputs(n, h, w, c, o, cuda_device, seed=h * w + c)
    before = tcb.fused_conv3x3_bn_relu_bwd.launches
    dx, dw, dg, db = tcb.fused_conv3x3_bn_relu_bwd(*args)
    torch.cuda.synchronize()
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before + 1
    da, x, y, wt, gamma, beta, mean, var = args
    pg, pb, vec = tcb.bwd_stats(da, y, gamma, beta, mean, var)
    pdx, pdw = tcb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)
    assert dx.shape == x.shape and dw.shape == wt.shape
    assert _rel(dx, pdx) <= 2e-4 and _rel(dw, pdw) <= 2e-4
    assert torch.equal(dg, pg) and torch.equal(db, pb)
    again = tcb.fused_conv3x3_bn_relu_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("nan_at", [None, "live", "dead"])
def test_conv_bwd_kernel_keeps_non_finite_positions(cuda_device, nan_at):
    """An inf in x (a border pixel) and in w, and a NaN in da where the
    ReLU passes or blocks it: dx, dw, dgamma and dbeta have the plain
    version's NaN and inf positions and signs, and the finite dx agrees."""
    args = list(_cbr_inputs(2, 6, 5, 4, 3, cuda_device, seed=7))
    da, x, y, wt, gamma, beta, mean, var = args
    x[1, 3, 0, 2] = float("inf")
    wt[0, 3, 2, 1] = -float("inf")
    if nan_at is not None:
        z = ((y - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
             * gamma[:, None, None] + beta[:, None, None])
        at = torch.nonzero((z > 0) == (nan_at == "live"))[0]
        da[tuple(at.tolist())] = float("nan")
    got = tcb.fused_conv3x3_bn_relu_bwd(*args)
    torch.cuda.synchronize()
    pg, pb, vec = tcb.bwd_stats(da, y, gamma, beta, mean, var)
    want = tcb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec) + (pg, pb)
    for g, r in zip(got, want):
        assert torch.equal(g.isnan(), r.isnan())
        assert torch.equal(g.isinf(), r.isinf())
        assert torch.equal(g[g.isinf()].sign(), r[r.isinf()].sign())
    assert got[1].isinf().any() and got[0].isnan().any()
    finite = torch.isfinite(got[0]) & torch.isfinite(want[0])
    if finite.any():
        assert _rel(got[0][finite], want[0][finite]) <= 2e-4


@pytest.mark.parametrize("bad", ["cpu_mix", "float64", "bfloat16"])
def test_conv_bwd_wrapper_raises(cuda_device, bad):
    args = list(_cbr_inputs(2, 5, 5, 4, 4, cuda_device, seed=1))
    if bad == "cpu_mix":
        args[2] = args[2].cpu()
    else:
        dtype = getattr(torch, bad)
        args[:4] = [t.to(dtype) for t in args[:4]]
    before = tcb.fused_conv3x3_bn_relu_bwd.launches
    with pytest.raises(MXNetError):
        tcb.fused_conv3x3_bn_relu_bwd(*args)
    assert tcb.fused_conv3x3_bn_relu_bwd.launches == before


def test_basic_block_on_card_matches_cpu(cuda_device):
    from mxnet_tpu_torch import functional
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BasicBlockV1
    xv = onp.random.RandomState(5).randn(2, 16, 10, 10).astype("float32")
    cpu = BasicBlockV1(16, 1, False, 16, device="cpu").initialize(seed=0)
    cpu(torch.from_numpy(xv))  # finishes the BatchNorms' deferred shapes
    arrays = functional.param_arrays(cpu)
    runs = {}
    for dev, mode in (("cpu", "on"), (cuda_device, "auto")):
        blk = BasicBlockV1(16, 1, False, 16, device=dev)
        functional.load_params(blk, arrays)
        x = torch.tensor(xv, device=dev, requires_grad=True)
        tmx.config.set("fused_conv_bn", mode)
        before = tcb.fused_conv3x3_bn_relu_bwd.launches
        try:
            with tmx.autograd.record():
                out = blk(x)
                loss = (out * out).sum()
            tmx.autograd.backward(loss)
        finally:
            tmx.config.reset("fused_conv_bn")
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tcb.fused_conv3x3_bn_relu_bwd.launches == before + 1
        runs[str(dev)] = (out.detach().cpu(), x.grad.cpu(), {
            k: p.grad().cpu() for k, p in blk.collect_params().items()
            if p.grad_req != "null"}, functional.param_arrays(blk))
    card, ref = runs[str(cuda_device)], runs["cpu"]
    torch.testing.assert_close(card[0], ref[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card[1], ref[1], rtol=1e-3, atol=1e-3)
    for k, g in ref[2].items():
        torch.testing.assert_close(card[2][k], g, rtol=2e-3, atol=2e-3,
                                   msg=k)
    for k, v in ref[3].items():
        if "running" in k:
            onp.testing.assert_allclose(card[3][k], v, rtol=1e-4, atol=1e-5)


# -- ROADMAP fault 9: attention the flash kernels have no instantiation for --

@pytest.mark.parametrize("d,dtype", [(48, torch.float32),
                                     (64, torch.float16),
                                     (80, torch.bfloat16)])
def test_attention_without_an_instantiation_takes_the_composition(
        cuda_device, d, dtype):
    rs = onp.random.RandomState(d)
    q, k, v = (rs.randn(2, 8, 2 * d).astype("float32") for _ in range(3))
    counts = (tflash.flash_attention_fwd.launches,
              tflash.flash_attention_bwd_dkv.launches,
              tflash.flash_attention_bwd_dq.launches)
    outs = {}
    for dev in ("cpu", cuda_device):
        ts = [torch.tensor(a, device=dev, dtype=dtype if dev != "cpu"
                           or dtype != torch.float16 else torch.float32)
              for a in (q, k, v)]
        for t in ts:
            t.requires_grad_(True)
        out = tattn.multi_head_attention(*ts, 2, causal=True)
        out.float().sum().backward()
        outs[str(dev)] = (out.float().detach().cpu(),
                          [t.grad.float().cpu() for t in ts])
    torch.cuda.synchronize()
    assert counts == (tflash.flash_attention_fwd.launches,
                      tflash.flash_attention_bwd_dkv.launches,
                      tflash.flash_attention_bwd_dq.launches)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    card, ref = outs[str(cuda_device)], outs["cpu"]
    torch.testing.assert_close(card[0], ref[0], **tol)
    for g_card, g_cpu in zip(card[1], ref[1]):
        torch.testing.assert_close(g_card, g_cpu, **tol)
