"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Build every kernel from ``mxnet_tpu_torch/csrc`` (``nvcc`` for sm_90a,
   one process per source, all started together): the flash-attention
   forward and the two backward kernels (dK/dV, dQ). Print the build time,
   each kernel's ptxas registers and spills, the card and CUDA.
2. Hold each kernel against its plain PyTorch version on the card, at
   b*h 12, d 64, seq 16 / 200 (ragged) / 512 / 1024 and seq_q != seq_k
   (200 x 712, non-causal), causal and not, and at d 32 and 128 (seq 200,
   causal, backward only), fp32 (atol=rtol=1e-4) and bf16 (forward atol
   2e-2; backward rtol 2^-7, one bf16 ulp, plus atol 2^-10 of the
   output's largest value); the backward with a random cotangent. Then
   the backward once more at the training path's own shape (b*h 96, seq
   1024, d 64, causal, fp32).
3. Serving at full GPT-2 124M width (vocab 50257, 768 units, 12 layers,
   12 heads, max_length 1024, fp32, seeded Uniform(0.07) weights):
   ``serve.load(net, max_slots=8)`` with the default buckets, ``warmup()``,
   then 16 greedy requests of 32 new tokens whose prompts land in every
   bucket up to 512. Launch counters are zeroed just before the run and
   read just after. Every request must finish with 32 tokens, and a
   tie-aware greedy check feeds two requests' prompt + output once through
   the full forward: at each generated position the chosen token's logit
   must be within 1e-3 of the row maximum.
4. Serving times beside the card's name and power limit: tokens/s and TTFT
   (synchronized host clock), decode ms/step and prefill ms per bucket
   (CUDA events), and the forward kernel at the serving shape against its
   plain version and one PyTorch call computing the same function (timed
   here only, never used by the port).
5. Training at full GPT-2 124M width (as bench.py's
   gpt2_124m_pretrain_bs8_seq1024: batch 8 x seq 1024, fp32, dropout 0,
   tied head, seeded Uniform(0.07) weights) through the user's entry
   points: ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``autograd.backward`` -> ``gluon.Trainer(..., "adamw", {"learning_rate":
   1e-4, "wd": 0.01}).step(8)`` on one fixed batch from RandomState(0).
   One warm-up step (after which every trainable parameter must hold a
   finite, nonzero gradient), then timed steps with the counters zeroed
   just before and read just after: each kernel must launch 12 times per
   step, every loss must be finite and the last below the first. Prints
   step ms, tokens/s, the fp32 model-FLOP share (6 N tokens / step time /
   67 TFLOP/s), peak memory and the device busy share with the top kernels
   (``torch.profiler``).
6. Kernel times at the training shape (b*h 96, seq 1024, d 64, causal;
   fp32, and bf16 beside it): device ms (``torch.profiler``) and per-call
   ms (CUDA events) of each kernel, of its plain version and of one
   PyTorch call as the yardstick (``scaled_dot_product_attention``'s
   forward, and its backward for the dK/dV + dQ pair), beside each
   kernel's bound on an H100 SXM.

The line before the last is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN so that fp32 means fp32 throughout.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time

import numpy as onp
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 2e-2
BF16_BWD_RTOL, BF16_BWD_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10
GREEDY_TOL = 1e-3
N_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 4
TRAIN_BH = TRAIN_BATCH * 12  # the training path's b*h (12 heads)
SOURCE = "mxnet_tpu_torch/csrc/{}.cu"
TPU_FLASH = "mxnet_tpu/ops/pallas/flash_attention.py:{}"


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, bracketed by CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters, warmup=3, top=5):
    """Device time of ``fn()`` from ``torch.profiler``, free of host launch
    overhead: (mean ms per call summed over every CUDA kernel and copy,
    the ``top`` kernels by time as (name, ms per call)). The first is None
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(per.values()) / iters / 1e3
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return (total or None), [(n[:60], us / iters / 1e3) for n, us in ranked]


def device_ms(fn, iters, warmup=3):
    return device_profile(fn, iters, warmup)[0]


def flash_bound_ms(bh, sq, sk, d, causal, dtype):
    """Least time on an H100 SXM for one flash-attention forward on these
    inputs: each input read once and each output written once over the
    memory rate, against the products this data needs (2 matmuls x 2
    flops x d per visible (q, k) pair) over the peak rate of the dtype."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * bh * d * (2 * sq + 2 * sk) + 4 * bh * sq
    return bound(nbytes, 4 * d * pairs(sq, sk, causal) * bh, dtype)


def pairs(sq, sk, causal):
    """Visible (q, k) pairs of one head (top-left causal)."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def bound(nbytes, flops, dtype):
    """(ms, what bounds it) for an H100 SXM."""
    t_mem, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def bwd_bound_ms(kind, bh, sq, sk, d, causal, dtype):
    """Least time on an H100 SXM for one backward kernel on these inputs.
    dK/dV reads q, k, v, do, lse, delta once and writes dk, dv; its
    products are 8 d flops per visible pair (s and dp recomputed, dV and
    dK). dQ reads the same and writes dq; 6 d flops per pair (s, dp,
    dQ)."""
    esize = torch.finfo(dtype).bits // 8
    n_in = esize * bh * d * (2 * sq + 2 * sk) + 2 * 4 * bh * sq
    if kind == "dkv":
        nbytes, per_pair = n_in + esize * bh * d * 2 * sk, 8 * d
    else:
        nbytes, per_pair = n_in + esize * bh * d * sq, 6 * d
    return bound(nbytes, per_pair * pairs(sq, sk, causal) * bh, dtype)


def ptxas_summary(log):
    """One line per compiled kernel: function, registers, spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            kind = next((k for k in ("dkv", "dq", "fwd")
                         if f"flash_{'bwd_' if k != 'fwd' else ''}{k}"
                         in mangled), "?")
            dtype = "bf16" if "bfloat16" in mangled else "fp32"
            dim = re.search(r"Li(\d+)E", mangled)
            dim = dim.group(1) if dim else "?"
            name = f"{kind} {dtype} d={dim}"
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"  {name}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name = None
    return out


def phase_build():
    from mxnet_tpu_torch import _native
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    libs = _native.build(["flash_attention_fwd", "flash_attention_bwd"])
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"built {name}: {path.name}")
        log = _native.build_logs.get(name)
        if log is None:
            print("  (cached build)")
            continue
        for line in ptxas_summary(log):
            print(line)
        for line in log.splitlines():
            if "error" in line or "warning" in line:
                print(f"  {line.strip()}")
    print(f"build seconds: {dt:.2f}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    return card


def phase_kernel_vs_plain(dev):
    from mxnet_tpu_torch.ops import flash_attention as fa
    print("== phase 2: flash_attention_fwd kernel vs plain version",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(16, 16), (200, 200), (512, 512), (1024, 1024), (200, 712)]
    for sq, sk in cases:
        for causal in (False, True):
            if causal and sq != sk:
                continue  # seq_q != seq_k is checked non-causal
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(12, n, 64, device=dev,
                                       generator=gen).to(dtype)
                           for n in (sq, sk, sk))
                out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                torch.cuda.synchronize()
                ref_out, ref_lse = fa.flash_attention_fwd_reference(
                    q, k, v, causal)
                check(torch.isfinite(out.float()).all().item()
                      and torch.isfinite(lse).all().item(),
                      f"non-finite kernel output sq={sq} sk={sk}")
                e_out = (out.float() - ref_out.float()).abs().max().item()
                e_lse = (lse - ref_lse).abs().max().item()
                if dtype == torch.float32:
                    ok = (torch.allclose(out, ref_out, **FP32_TOL)
                          and torch.allclose(lse, ref_lse, **FP32_TOL))
                else:
                    ok = (e_out <= BF16_ATOL
                          and torch.allclose(lse, ref_lse, **FP32_TOL))
                name = str(dtype).split(".")[-1]
                print(f"  bh=12 sq={sq:4d} sk={sk:4d} d=64 causal={causal!s:5}"
                      f" {name:8s} max|out err|={e_out:.3e} "
                      f"max|lse err|={e_lse:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with plain version at sq={sq} "
                          f"sk={sk} causal={causal} {dtype}")
                errs[dtype] = max(errs[dtype], e_out, e_lse)
    return errs


def bwd_case(fa, dev, gen, bh, sq, sk, causal, dtype, d=64):
    """One backward comparison: (max |dk, dv err|, max |dq err|)."""
    q, k, v, do = (torch.randn(bh, n, d, device=dev, generator=gen)
                   .to(dtype) for n in (sq, sk, sk, sq))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(torch.isfinite(got.float()).all().item(),
              f"non-finite {name} bh={bh} sq={sq} sk={sk}")
        if dtype == torch.float32:
            tol = FP32_TOL
        else:  # one bf16 ulp, plus a share of the output's scale
            tol = dict(rtol=BF16_BWD_RTOL, atol=BF16_BWD_ATOL_SHARE
                       * want.float().abs().max().item())
        ok = torch.allclose(got.float(), want.float(), **tol)
        err = (got.float() - want.float()).abs().max().item()
        check(ok, f"{name} kernel disagrees with plain version at bh={bh} "
                  f"sq={sq} sk={sk} causal={causal} {dtype}: {err:.3e}")
        errs.append(err)
    name = str(dtype).split(".")[-1]
    print(f"  bh={bh:3d} sq={sq:4d} sk={sk:4d} d={d:3d} causal={causal!s:5} "
          f"{name:8s} max|dq err|={errs[0]:.3e} max|dk err|={errs[1]:.3e} "
          f"max|dv err|={errs[2]:.3e} ok")
    return max(errs[1:]), errs[0]


def phase_bwd_vs_plain(dev):
    """The dK/dV and dQ kernels against the plain backward, random do."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    print("== phase 2b: flash_attention_bwd kernels vs plain version",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {k: {torch.float32: 0.0, torch.bfloat16: 0.0}
            for k in ("dkv", "dq")}
    cases = [(16, 16), (200, 200), (512, 512), (1024, 1024), (200, 712)]
    for sq, sk in cases:
        for causal in (False, True):
            if causal and sq != sk:
                continue  # seq_q != seq_k is checked non-causal
            for dtype in (torch.float32, torch.bfloat16):
                e_kv, e_q = bwd_case(fa, dev, gen, 12, sq, sk, causal,
                                     dtype)
                errs["dkv"][dtype] = max(errs["dkv"][dtype], e_kv)
                errs["dq"][dtype] = max(errs["dq"][dtype], e_q)
    # head dims whose scale is not a power of two (no bit identity there)
    for d in (32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            e_kv, e_q = bwd_case(fa, dev, gen, 12, 200, 200, True, dtype, d)
            errs["dkv"][dtype] = max(errs["dkv"][dtype], e_kv)
            errs["dq"][dtype] = max(errs["dq"][dtype], e_q)
    # the training path's own shape
    e_kv, e_q = bwd_case(fa, dev, gen, TRAIN_BH, TRAIN_SEQ, TRAIN_SEQ, True,
                         torch.float32)
    errs["dkv"][torch.float32] = max(errs["dkv"][torch.float32], e_kv)
    errs["dq"][torch.float32] = max(errs["dq"][torch.float32], e_q)
    return errs


def counters(fa):
    return [fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches]


def zero_counters(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    fa.flash_attention_bwd_dq.launches = 0


def prompt_lengths(rs, buckets, n):
    """``n`` seeded prompt lengths cycling through every bucket range."""
    lows = [1] + [b + 1 for b in buckets[:-1]]
    return [int(rs.randint(lows[i % len(buckets)],
                           buckets[i % len(buckets)] + 1)) for i in range(n)]


def phase_main_path(dev):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    from mxnet_tpu_torch.ops import flash_attention as fa
    print("== phase 3: ServeEngine over GPT-2 124M (full width)", flush=True)
    vocab, n_layers = 50257, 12
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=1024, dropout=0.0, embed_dropout=0.0,
        device=dev)).initialize(seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"parameters: {n_params} on {net.device}")
    eng = mx.serve.load(net, max_slots=8)
    t0 = time.perf_counter()
    eng.warmup()
    print(f"warmup seconds: {time.perf_counter() - t0:.2f} "
          f"(buckets {eng.buckets})")
    rs = onp.random.RandomState(0)
    lengths = prompt_lengths(rs, [b for b in eng.buckets if b <= 512], 16)
    check(max(lengths) > 256, "no prompt above 256 tokens")
    prompts = [rs.randint(0, vocab, n) for n in lengths]
    print(f"prompt lengths: {lengths}")

    zero_counters(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    check(counters(fa)[1:] == [0, 0],
          "serving launched a backward kernel")
    check(all(p.data().grad is None for p in net.collect_params().values()),
          "serving left a gradient behind")

    for r in reqs:
        check(r.finished and len(r.generated) == 32,
              f"request {r.id} finished={r.finished} with "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < vocab for t in r.generated),
              f"request {r.id} produced an out-of-vocabulary token")
    n_prefill = len(reqs)
    check(launches == n_layers * n_prefill and launches > 0,
          f"flash kernel launched {launches} times in the main path, "
          f"expected {n_layers} x {n_prefill} prefills")

    # tie-aware greedy check through the full forward
    for r in (reqs[0], max(reqs, key=lambda x: len(x.prompt))):
        seq = list(r.prompt) + r.generated[:-1]
        with torch.no_grad():
            logits = net(torch.tensor([seq], device=dev))[0]
        check(logits.shape == (len(seq), vocab)
              and torch.isfinite(logits).all().item(),
              "full forward logits not finite / wrong shape")
        rows = logits[len(r.prompt) - 1:]
        chosen = rows.gather(1, torch.tensor(r.generated, device=dev)[:, None])
        gap = (rows.max(dim=1).values - chosen[:, 0]).max().item()
        print(f"  greedy check request {r.id} (prompt {len(r.prompt)}): max "
              f"gap to row max {gap:.3e}")
        check(gap <= GREEDY_TOL, f"request {r.id}: a generated token is "
                                 f"{gap:.3e} below its row max")
    check(fa.flash_attention_fwd.launches == n_layers * (n_prefill + 2),
          "full forwards did not go through the flash kernel")

    st = eng.stats()
    tokens = st["tokens_out"]
    print(f"served {st['completed']} requests, {tokens} tokens, "
          f"{st['steps']} decode steps in {wall:.3f} s")
    return net, eng, st, wall, launches


def phase_times(dev, net, eng, st, wall, card):
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f"== phase 4: times on {card}", flush=True)
    e2e = {
        "tokens_per_s": st["tokens_out"] / wall,
        "ttft_p50_ms": st["ttft"]["p50"] * 1e3,
        "ttft_p99_ms": st["ttft"]["p99"] * 1e3,
        "tpot_p50_ms": st["tpot"]["p50"] * 1e3,
    }
    caches = net.init_cache(eng.max_slots, eng.max_seq)
    tokens = torch.randint(0, 50257, (eng.max_slots, 1), device=dev)
    positions = torch.arange(eng.max_slots, device=dev) * 100 + 50
    ids512 = torch.randint(0, 50257, (1, eng.buckets[-1]), device=dev)
    programs = {
        "decode_step": lambda: net.decode_step(tokens, caches, positions),
        f"prefill_{eng.buckets[-1]}": lambda: net.prefill(ids512, caches, 0),
    }
    with torch.no_grad():
        e2e["decode_ms_per_step"] = cuda_ms(programs["decode_step"], 20)
        prefill = {}
        for b in eng.buckets:
            ids = torch.randint(0, 50257, (1, b), device=dev)
            prefill[b] = cuda_ms(lambda: net.prefill(ids, caches, 0), 5)
        e2e["prefill_ms"] = prefill
        print("end to end: " + json.dumps(e2e))
        for name, fn in programs.items():
            call = cuda_ms(fn, 10)
            busy, top = device_profile(fn, 10)
            if busy is None:
                print(f"{name}: {call:.3f} ms per call, device time not "
                      "measured (profiler saw no kernels)")
                continue
            print(f"{name}: {call:.3f} ms per call, device busy "
                  f"{busy:.3f} ms ({busy / call:.1%}), top kernels (ms): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in top))

    gen = torch.Generator(device=dev).manual_seed(1)
    timing = {}
    for dtype, seqs in ((torch.float32, (512, 16)), (torch.bfloat16, (512,))):
        for s in seqs:
            q, k, v = (torch.randn(12, s, 64, device=dev, generator=gen)
                       .to(dtype) for _ in range(3))
            q4, k4, v4 = (t.view(1, 12, s, 64) for t in (q, k, v))
            calls = {
                "kernel": lambda: fa.flash_attention_fwd(q, k, v, True),
                "plain": lambda: fa.flash_attention_fwd_reference(
                    q, k, v, True),
                "sdpa": lambda: torch.nn.functional
                .scaled_dot_product_attention(q4, k4, v4, is_causal=True),
            }
            row = {}
            for name, fn in calls.items():
                row[name + "_call_ms"] = cuda_ms(fn, 50)
                row[name + "_device_ms"] = device_ms(fn, 20)
            bound, by = flash_bound_ms(12, s, s, 64, True, dtype)
            row.update(bound_ms=bound, bound_by=by)
            timing[(dtype, s)] = row
            print(f"flash_attention_fwd {str(dtype)[6:]} causal bh=12 s={s} "
                  f"d=64 [{card}]: " + json.dumps(row))
    row = timing[(torch.float32, 512)]
    return dict(shape="bh=12 s=512 d=64 causal fp32", ms=pick(row, "kernel"),
                plain_ms=pick(row, "plain"), library_ms=pick(row, "sdpa"),
                bound_ms=row["bound_ms"])


def pick(row, name):
    """Device ms where the profiler saw the kernels, else per-call ms."""
    dev_ms = row[name + "_device_ms"]
    return dev_ms if dev_ms is not None else row[name + "_call_ms"]


def phase_train(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f"== phase 5: training GPT-2 124M (full width, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, fp32) on {card}", flush=True)
    vocab = 50257
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})
    ids = torch.from_numpy(onp.random.RandomState(0).randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    print(f"parameters: {n_params} ({len(params)} tensors); optimizer "
          "adamw lr 1e-4 wd 0.01; one fixed batch from RandomState(0)")

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.autograd.backward(loss)
        trainer.step(TRAIN_BATCH)
        return loss.detach().mean()

    t0 = time.perf_counter()
    first = step().item()
    print(f"warm-up step: loss {first:.6f}, "
          f"{time.perf_counter() - t0:.2f} s")
    bad = []
    for name, p in params.items():
        g = p.grad()
        if not (torch.isfinite(g).all().item() and g.abs().max().item() > 0):
            bad.append(name)
    check(not bad, f"parameters without a finite, nonzero gradient after "
                   f"step 1: {bad[:6]} ({len(bad)} in all)")
    print(f"every one of the {len(params)} parameters has a finite, "
          "nonzero gradient after step 1")

    torch.cuda.reset_peak_memory_stats()
    zero_counters(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first] + [v.item() for v in losses]
    print(f"losses: {losses}")
    check(all(onp.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    want = N_LAYERS * TRAIN_STEPS
    check(launches == [want] * 3,
          f"kernel launches {launches} in {TRAIN_STEPS} steps, expected "
          f"{want} each (12 per step)")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    e2e = {
        "step_ms": step_ms,
        "tokens_per_s": tokens * TRAIN_STEPS / wall,
        "fp32_model_flop_share": 6 * n_params * tokens / (step_ms / 1e3)
        / PEAK_FLOPS[torch.float32],
        "peak_memory_gb": peak_gb,
        "launches_per_step": [n // TRAIN_STEPS for n in launches],
    }
    print(f"training end to end [{card}]: " + json.dumps(e2e))
    busy, top = device_profile(step, 2, warmup=0, top=10)
    if busy is None:
        print("device busy share not measured (profiler saw no kernels)")
    else:
        e2e["device_busy_share"] = busy / step_ms
        print(f"device time per step {busy:.3f} ms of {step_ms:.3f} ms "
              f"({busy / step_ms:.1%} busy); top kernels (ms per step): "
              + ", ".join(f"{n} {t:.3f}" for n, t in top))
    return launches, e2e


def phase_kernel_times(dev, card):
    """Each kernel, its plain version and one PyTorch call at the training
    shape (b*h 96, seq 1024, d 64, causal)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f"== phase 6: kernel times at the training shape on {card}",
          flush=True)
    F = torch.nn.functional
    bh, s, d = TRAIN_BH, TRAIN_SEQ, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(bh, s, d, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        q4, k4, v4, do4 = (t.view(TRAIN_BATCH, 12, s, d)
                           for t in (q, k, v, do))
        leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        programs = {
            "fwd": {
                "kernel": lambda: fa.flash_attention_fwd(q, k, v, True),
                "plain": lambda: fa.flash_attention_fwd_reference(
                    q, k, v, True),
                "library": lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True),
            },
            "dkv": {
                "kernel": lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, True),
                "plain": lambda: fa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do, True),
                "library": lambda: torch.autograd.grad(
                    lib_out, leaves, do4, retain_graph=True),
            },
            "dq": {
                "kernel": lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, True),
            },
        }
        for kind, calls in programs.items():
            row = {}
            for name, fn in calls.items():
                iters = 5 if name == "plain" else 10
                row[name + "_call_ms"] = cuda_ms(fn, iters, warmup=2)
                row[name + "_device_ms"] = device_ms(fn, iters, warmup=1)
            if kind == "fwd":
                row["bound_ms"], row["bound_by"] = flash_bound_ms(
                    bh, s, s, d, True, dtype)
            else:
                row["bound_ms"], row["bound_by"] = bwd_bound_ms(
                    kind, bh, s, s, d, True, dtype)
            rows[(kind, dtype)] = row
            print(f"{kind} {str(dtype)[6:]} causal bh={bh} s={s} d={d} "
                  f"[{card}]: " + json.dumps(row))
        del leaves, lib_out
    # the plain backward and SDPA's backward compute dq, dk and dv
    # together: both kernels of the pair are held against them
    for dtype in (torch.float32, torch.bfloat16):
        for key in ("plain_call_ms", "plain_device_ms", "library_call_ms",
                    "library_device_ms"):
            rows[("dq", dtype)][key] = rows[("dkv", dtype)][key]
    return rows


def kernel_entry(kind, launches, errs, rows, extra=None):
    names = {"fwd": ("flash_attention_fwd", "flash_attention_fwd", 23),
             "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd", 156),
             "dq": ("flash_attention_bwd_dq", "flash_attention_bwd", 190)}
    name, src, line = names[kind]
    row = rows[(kind, torch.float32)]
    entry = {
        "name": name,
        "route": "cuda",
        "source": SOURCE.format(src),
        "replaces": TPU_FLASH.format(line),
        "launches": launches,
        "max_abs_err": errs[torch.float32],
        "max_err_fp32": errs[torch.float32],
        "max_err_bf16": errs[torch.bfloat16],
        "ms": pick(row, "kernel"),
        "plain_ms": pick(row, "plain"),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": pick(row, "library"),
        "shape": f"bh={TRAIN_BH} s={TRAIN_SEQ} d=64 causal fp32",
        "bf16_ms": pick(rows[(kind, torch.bfloat16)], "kernel"),
    }
    if kind != "fwd":
        entry["plain_and_library_compute"] = "dq, dk and dv together"
    entry.update(extra or {})
    return entry


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_build()
    errs = phase_kernel_vs_plain(dev)
    bwd_errs = phase_bwd_vs_plain(dev)
    net, eng, st, wall, serve_launches = phase_main_path(dev)
    serve_shape = phase_times(dev, net, eng, st, wall, card)
    del net, eng
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_e2e = phase_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase_kernel_times(dev, card)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": [
        kernel_entry("fwd", serve_launches + train_launches[0], errs, rows,
                     {"launches_by_path": {"serve": serve_launches,
                                           "train": train_launches[0]},
                      "serve_shape": serve_shape}),
        kernel_entry("dkv", train_launches[1], bwd_errs["dkv"], rows,
                     {"launches_by_path": {"train": train_launches[1]}}),
        kernel_entry("dq", train_launches[2], bwd_errs["dq"], rows,
                     {"launches_by_path": {"train": train_launches[2]}}),
    ], "train": train_e2e}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
