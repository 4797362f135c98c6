"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Build every kernel of the serving path from ``mxnet_tpu_torch/csrc``
   (``nvcc`` for sm_90a) and print the build time, the card and CUDA.
2. Hold each kernel against its plain PyTorch version on the card:
   flash-attention forward at b*h 12, d 64, seq 16 / 200 (ragged) / 512 /
   1024 and seq_q != seq_k, causal and not, fp32 (atol=rtol=1e-4) and bf16
   (atol 2e-2).
3. Drive the main path at full GPT-2 124M width (vocab 50257, 768 units,
   12 layers, 12 heads, max_length 1024, fp32, seeded Uniform(0.07)
   weights): ``serve.load(net, max_slots=8)`` with the default buckets,
   ``warmup()``, then 16 greedy requests of 32 new tokens whose prompts
   land in every bucket up to 512. Launch counters are zeroed just before
   the run and read just after. Every request must finish with 32 tokens,
   and a tie-aware greedy check feeds two requests' prompt + output once
   through the full forward: at each generated position the chosen
   token's logit must be within 1e-3 of the row maximum.
4. Times beside the card's name and power limit: tokens/s and TTFT
   (synchronized host clock), decode ms/step and prefill ms per bucket
   (CUDA events), and each kernel against its plain version and one
   PyTorch call computing the same function (timed here only, never used
   by the port), per call (CUDA events) and as device time
   (``torch.profiler``), beside its bound on an H100 SXM.

The line before the last is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN so that fp32 means fp32 throughout.
"""
from __future__ import annotations

import json
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
GREEDY_TOL = 1e-3


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
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * d * pairs * bh
    t_mem, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def phase_build():
    from mxnet_tpu_torch import _native
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    libs = _native.build(["flash_attention_fwd"])
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"built {name}: {path.name}")
        for line in _native.build_logs.get(name, "(cached)").splitlines():
            if "ptxas info" in line or "spill" in line or "error" in line:
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

    fa.flash_attention_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches

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
                row[name + "_call_ms"] = cuda_ms(fn, 100)
                row[name + "_device_ms"] = device_ms(fn, 50)
            bound, by = flash_bound_ms(12, s, s, 64, True, dtype)
            row.update(bound_ms=bound, bound_by=by)
            timing[(dtype, s)] = row
            print(f"flash_attention_fwd {str(dtype)[6:]} causal bh=12 s={s} "
                  f"d=64 [{card}]: " + json.dumps(row))
    row = timing[(torch.float32, 512)]
    pick = (lambda name: row[name + "_device_ms"]
            if row[name + "_device_ms"] is not None
            else row[name + "_call_ms"])
    return dict(ms=pick("kernel"), plain_ms=pick("plain"),
                library_ms=pick("sdpa"), bound_ms=row["bound_ms"],
                bound_by=row["bound_by"])


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
    net, eng, st, wall, launches = phase_main_path(dev)
    t512 = phase_times(dev, net, eng, st, wall, card)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:23",
        "launches": launches,
        "max_abs_err": errs[torch.float32],
        "max_err_fp32": errs[torch.float32],
        "max_err_bf16": errs[torch.bfloat16],
        "ms": t512["ms"],
        "plain_ms": t512["plain_ms"],
        "bound_ms": t512["bound_ms"],
        "bound_by": t512["bound_by"],
        "library_ms": t512["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
