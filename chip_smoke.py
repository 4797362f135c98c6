"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Build every kernel from ``mxnet_tpu_torch/csrc`` (``nvcc`` for sm_90a,
   one process per source, all started together): the flash-attention
   forward and the two backward kernels (dK/dV, dQ), the ln_residual
   forward and backward, the fp8 matmul, the int8 matmul and kernel 8,
   the conv3x3+BN+ReLU backward (weight split, dgrad, wgrad and the
   reduce; and its bf16 instantiation: weight copy, dgrad, wgrad, reduce). Print the build time, each kernel's ptxas registers and
   spills, the card and CUDA, and the count of tensor-core instructions
   (HMMA / HGMMA, from ``cuobjdump -sass`` beside ``nvcc``) in each of the
   24 flash kernels (forward, dK/dV and dQ, fp32 and bf16, d 16 / 32 / 64
   / 128), of ``wgmma`` instructions (HGMMA) in the two fp8 GEMM kernels
   (TMA-store and direct-store epilogue), of s8 ``wgmma`` instructions
   (IGMMA) in the four int8 GEMM kernels (128 x 128 and 128 x 192 tiles,
   each with both epilogues) and of HMMA in kernel 8's four kernels with
   their spill bytes (and the bf16 instantiation's four): the run fails if
   a flash, fp8 GEMM, int8 GEMM or kernel-8 product kernel (dgrad, wgrad,
   fp32 and bf16) has none, or if an ln_residual
   instantiation, an fp8 matmul, int8 matmul or kernel-8 kernel spills.
   Every phase prints its wall time.
2. Hold each kernel against its plain PyTorch version on the card, at
   b*h 12, d 64, seq 16 / 200 (ragged) / 512 / 1024 and seq_q != seq_k
   (200 x 712, non-causal), causal and not, and at d 16, 32 and 128 (seq
   200, causal), fp32 (atol=rtol=1e-4) and bf16 (rtol 2^-7, one bf16 ulp,
   plus atol 2^-10 of the output's largest value: the plain version
   rounds p to bf16 where the kernel and the reference do); lse within
   1e-4; the backward with a random cotangent. The forward also at ragged
   lengths (seq_q x seq_k of 1, 17, 65 and 712, every pair, causal and
   not, d 64) and on a key tensor that does not start on 16 bytes (equal
   bit for bit to the aligned copy's result). Then the forward and the
   backward once more at the training path's own shape (b*h 96, seq 1024,
   d 64, causal), fp32 and bf16, where a second launch of each kernel
   must agree with the first bit for bit.
2c. The ln_residual forward and backward kernels against their plain
   versions, with a random cotangent and an explicit keep mask: rows 7 /
   600 / 4096 x D 128 / 200 / 768 / 1024, plus D 199 and 1999 (no 16-byte
   path), 2000 and 8192 (a block per row), p 0 and 0.1, rows of fp32,
   bf16 and fp16, the mask in turn in x's dtype, bool, uint8, fp32, bf16
   and fp16; the dtypes apart (``LN_MIXED``: bf16 rows with fp32
   gamma/beta, fp32 x with bf16 h and the reverse, an fp32 mask with bf16
   rows, fp16 rows with fp32 gamma, fp16 gamma with fp32 rows, fp16 x with
   bf16 h) at 600 x 768 and 131 x 200; one row of zero variance; rows
   offset by 100; and, run twice and equal bit for bit (out, mean, rstd,
   dx, dh, dgamma, dbeta), ragged n of 1, 131, 133 and 4097, BERT's 4096,
   65536 rows (many waves of the backward's blocks), D 8192 and D 1999
   (``LN_REPEAT``, fp32, bf16 and fp16). Tolerances, by each result's
   dtype:
   fp32 atol = rtol = 1e-5 for out, mean, rstd, dx and dh (fp32 sums in
   another order than torch's; the plain version is the same arithmetic);
   dgamma/dbeta atol 1e-5 of their largest |value| (sums over up to 65536
   rows in another order); the zero-variance row's dx/dh likewise 1e-5 of
   the largest |value| (its rstd = 1/sqrt(eps) ~ 316 scales the
   summation-order error of mean(dxhat)); rows offset by 100 (a
   one-pass E[s^2] - mean^2 would be off by ~1e-3 there) atol 1e-4 for
   out, dx and dh (the fp32 sum of values ~100 in another order moves the
   mean by up to ~2e-5); bf16 rtol 2^-7 (one bf16 ulp of
   the output) plus atol 2^-10 of the largest |value| (a value on a
   rounding boundary may round the other way); fp16 likewise one fp16
   ulp, rtol 2^-10, plus atol 2^-13 of the largest |value|.
2d. The fp8 matmul kernels (prepare pass and GEMM) against their plain
   version (the JAX cast rule, an fp32 matmul of the fp8 values, the same
   epilogue): M/N/K 1/5/100, 37/130/256 and 130/5/100, e4m3 and e5m2,
   every activation, with and without bias; inputs past the format's top
   (the same NaN and inf positions); ragged edges of the GEMM's 128 x 128
   tile and 64-value k-tile (``FP8_RAGGED``: M and N of tile +- 1, N % 4
   != 0 for the direct-store epilogue, K = 100 and 784); x 4 bytes into
   its buffer; all four format pairs at (200, 300, 768); and the three fp8
   training shapes (M, K, N) = (8192, 768, 768), (8192, 768, 3072),
   (8192, 3072, 768), where a second launch must agree bit for bit.
   Tolerance: |err| <= 2^-20 of the sum of |products| x |x_scale *
   w_scale| plus 1e-6 of |out| (exact products of the fp8 values, widened
   to f16, summed in the tensor core's fp32 accumulator in another order;
   the largest err / that sum read 8.4e-8, about 2^-23.5, on the H100);
   the largest err / that sum is printed.
2e. The int8 matmul kernels (prepare pass and GEMM) against their plain
   version (``quantize_int8``, the int8 product summed exactly as float64,
   the same epilogue): (M, K, N) = (1, 100, 5), (37, 256, 130), (130, 100,
   5), (64, 200, 70) (K not a multiple of 16: w copied into the padded
   scratch), (37, 256, 130) with x at an offset that is not 16-byte
   aligned, every activation, with and without bias; the GEMM's tile edges
   (``INT8_RAGGED``: M and N of tile +- 1, N % 4 != 0, K = 100, 200 and
   784) at both tile widths, 128 x 128 and 128 x 192; then the pooler's
   (32, 768, 768) with tanh and the three BERT-base shapes (4096, 768,
   768), (4096, 768, 3072), (4096, 3072, 768) with bias. Every edge and
   BERT case is launched twice and must give the same bits. x_scale is a power of two, so the planted exact .5 ties of x /
   x_scale round half to even; NaN, +-inf and values past +-127 are
   planted too. No activation and relu: bit for bit (both sides sum
   exactly and round the epilogue alike); sigmoid, tanh and gelu: atol =
   rtol = 1e-6 (the card's tanhf/expf against torch's). The largest
   error is printed.
2f. Kernel 8 against its plain version (dy recomputed from the stats
   vector, 9 shifted fp32 products each for dgrad and wgrad): the four
   3x3 stride-1 stage shapes of ResNet-50 at batch 32 ((56, 56, 64),
   (28, 28, 128), (14, 14, 256), (7, 7, 512), C = O), three input sets
   each, and the kernels' edges (``CONV_EDGES``: pixel chunks across
   images with N*H*W off the chunk, W = 1, C and O off the channel chunks,
   patches with empty slots, 4 x 14 patches, a dgrad split over output
   channels). dx and dw within max|diff| / max|plain| <= 2e-4 (3xTF32
   tensor-core sums of up to 9*512 products in another order), dgamma
   and dbeta bit for bit (one stats-pass function computes them for
   both), and a second launch bit for bit (no atomics); the shared memory
   and wgrad chunk the source computes equal to the wrapper's rule. Then
   an inf in x and in w and a NaN in da (none, where the ReLU passes it,
   where it blocks it): the NaN and inf positions and signs of dx, dw,
   dgamma and dbeta equal to the plain version's. Then kernel 8's bf16
   instantiation on bf16 x, w, gamma, beta and da (y from the bf16
   forward): the four stage shapes (two input sets each) and
   ``CONV_EDGES``, dx and dw elementwise within one bf16 ulp of the plain
   value (rtol 2^-7) plus ``CONV_BF16_SHARE`` (1e-5) of max|plain| (bf16
   products are exact in fp32; only the order of the fp32 sums differs),
   dgamma/dbeta and a second launch bit for bit, its shared memory equal
   to the wrapper's rule, and the non-finite cases with the plain
   version's NaN and inf positions.
3. Serving at full GPT-2 124M width (vocab 50257, 768 units, 12 layers,
   12 heads, max_length 1024, fp32, seeded Uniform(0.07) weights):
   ``serve.load(net, max_slots=8)`` with the default buckets and
   ``warmup()``, which captures every step as a CUDA graph (the decode
   step and one prefill per bucket: 7 graphs; its seconds, the reserved
   memory), then 16 greedy requests of 32 new tokens whose prompts land in
   every bucket up to 512. The kernel wrappers' counters are zeroed just
   before the run and must read 0 just after (a replay runs no wrapper);
   the same mix once more under ``torch.profiler`` must show 12 flash
   forward kernel events a prefill (192; a window short of it is measured
   again, up to three), and its device time over the timed run's wall is
   the busy share. No graph may be captured after ``warmup()``. Every
   request must finish with 32 tokens, and a tie-aware greedy check feeds
   two requests' prompt + output once through the full forward: at each
   generated position the chosen token's logit must be within 1e-3 of the
   row maximum. Then the host's runtime calls a decode step with all 8
   slots live (``torch.profiler``'s CPU events over 4 steps:
   ``cudaGraphLaunch``, ``cudaLaunchKernel``, copies, synchronizations).
4. Serving times beside the card's name and power limit: tokens/s, TTFT
   p50/p99 and TPOT p50 (synchronized host clock), decode ms/step and
   prefill ms per bucket as graph replays and as the same model's eager
   calls (CUDA events), and the forward kernel at the serving shape
   against its plain version and one PyTorch call computing the same
   function (timed here only, never used by the port).
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
   kernel's bound on an H100 SXM. Each kernel also prints its achieved
   TFLOP/s and its share of each bound: in fp32 the 67 TFLOP/s bound of
   fp32 FMAs and the bound at the rate its 3xTF32 products use (three
   TF32 products per product at 495 TFLOP/s); both go into the kernels
   line.
7. BERT-base pretraining at full width (as bench.py's
   bert_base_pretrain_bs32_seq128_drop0.1: vocab 30522, 768 units, FFN
   3072, 12 layers, 12 heads, max_length 512, batch 32 x seq 128) at
   BERT's own dropout 0.1 and embed dropout 0.1, fp32 (bf16/AMP is not
   ported), seeded Uniform(0.07) weights and ``random.seed(0)``, through
   ``autograd.record()`` -> MLM + NSP ``SoftmaxCrossEntropyLoss`` ->
   ``autograd.backward`` -> ``Trainer(..., "adamw", ...)`` on one fixed
   batch from RandomState(0) (two segments, valid lengths 64..128, 15%
   MLM positions as ``sample_weight``, NSP labels). One warm-up step (after
   which every parameter must hold a finite, nonzero gradient), then timed
   steps with the counters zeroed just before and read just after: the
   ln_residual forward and backward must launch 12 times per step (the
   attention residual of each post-norm cell; live dropout and the
   valid-length mask send attention to the plain composition, so the
   flash kernels launch 0 times), every loss must be finite and the last
   below the first (9 timed steps: without warm-up the post-norm model's
   loss rises on steps 2-3 before it falls). Then, from the same weights and seed, one step each
   with ``fused_ln_residual`` "off" and "on": their first-step losses must
   equal the "auto" run's within 1e-5 relative (the masks are the same
   draws); each mode's first three losses are printed. Each mode's step ms (three steps, four times, in turns) and
   device ms per step (``torch.profiler``) are printed.
8. ln_residual kernel times at the BERT shape (4096 x 768, p 0.1, fp32
   and bf16, the mask in x's dtype as the BERT gate passes it): device
   and per-call ms of each kernel's whole call, of the kernel alone, of
   its plain version and of the unfused composition the "off" route runs
   (``F.layer_norm(x + h*m*scale)`` and its autograd backward: no single
   PyTorch call computes this function), beside each kernel's bound and
   its share of it. Each call must run exactly one device kernel
   (``torch.profiler``): the backward sums dgamma/dbeta inside it.
9. fp8 training of GPT-2 124M at full width (as bench.py's
   gpt2_train_bs8_seq1024_fp8 on one card: batch 8 x seq 1024, dropout 0,
   seeded Uniform(0.07) weights, ``adam`` lr 1e-3, one fixed batch from
   RandomState(0)) through ``parallel.ShardedTrainStep(net, loss, "adam",
   MeshConfig(dp=1), ..., precision="fp8")``, beside an fp32
   ``ShardedTrainStep`` from the same weights, 4 steps of each in turns.
   Counters are zeroed just before each fp8 step and read just after: the
   fp8 kernel must launch 72 times a step (12 layers x query, key, value,
   out, ffn_1, ffn_2) and each flash kernel 12 times. After step 1 every
   parameter's gradient is finite. At every step the fp8 step's loss must
   be within 5e-3 relative of the fp32 forward of the same weights (run
   just before it, no graph); after step 4 the fp8 loss must be below its
   first, the 72 Dense sites hold nonzero x/w amaxes in history slots 0-3
   and g in slots 0-2, and the two embedding sites (selected, never a
   Dense) all zeros. Step 1's g amax may be 0, but only at a query, key,
   value or ffn_1 site: its scales are the identity (empty histories, as
   in the reference), and a dy that reaches a site only through another
   site's fp8 backward product is flushed there by e5m2, whose smallest
   value is 2^-16, as the JAX package does (tests/test_torch_fp8.py); the
   count of such sites is printed.
   The fp8 and fp32 trajectories' losses are printed side by side, not
   held to 5%: at adam lr 1e-3 without warm-up both spike within a few
   steps, at different steps (PERF.md). Then step ms (in turns),
   tokens/s, device ms per step and the busy share with the top kernels
   (``torch.profiler``) and peak memory of both.
10. fp8 matmul kernel times at the three training shapes (fp32 x, e4m3 w,
   no bias, no activation; three input sets in turn, so that the working
   set exceeds the 50 MB L2): device ms of the kernel's call (prepare
   pass and GEMM) and of the prepare pass on its own, of its plain
   version and of the composition quantize -> ``torch._scaled_mm`` ->
   epilogue (a yardstick only, never used by the port; null where the
   card's torch has no ``_scaled_mm``), beside the bound: bytes (x read,
   w read, out written) over 3.35 TB/s against 2 M N K over the 1979
   TFLOP/s dense fp8 rate; and the call's TFLOP/s and its share of the
   bound.
11. int8 inference of BERT-base at full width, the int8 slice's main
   path: ``bert_12_768_12`` (vocab 30522, 768 units, FFN 3072, 12 layers,
   12 heads, max_length 512, fp32, seeded Uniform(0.07) weights) through
   ``contrib.quantization.quantize_net(net, calib_data=<2 batches of 32 x
   128 ids from RandomState(1)>, calib_mode="naive")``, which must
   replace 73 Dense layers (12 x query, key, value, out, ffn_1, ffn_2 and
   the tanh pooler) and leave ``net`` with its 73 Dense layers. The batch
   is phase 7's ids, token types and valid lengths (64..128), in
   inference. Counters are zeroed just before the quantized forward and
   read just after: the int8 kernel must launch 73 times, the flash,
   ln_residual and fp8 kernels 0 times (valid lengths mask attention; no
   dropout). The same forward with ``quantize.fused_matmul="off"`` (the
   plain chain on the card) must give a bit-identical sequence output and
   the pooled output within atol = rtol = 1e-6 (tanh in the epilogue).
   The int8-vs-fp32 error of both outputs (max |diff| / max |fp32|) is
   printed and held under ``INT8_VS_FP32_TOL``. Then the fp32 and the
   int8 forward in turns: ms per forward (synchronized host clock and CUDA
   events), samples/s, device ms and busy share with the top kernels
   (``torch.profiler``), peak memory.
12. int8 matmul kernel times at the BERT-base shapes (4096, 768, 768),
   (4096, 768, 3072), (4096, 3072, 768) and the pooler's (32, 768, 768)
   (fp32 x, int8 w, bias; tanh at the pooler; three input sets in turn):
   device ms of the kernel, of its plain version and of the composition
   ``quantize_int8`` -> ``torch._int_mm`` -> ``* (xs * ws) + b`` (a
   yardstick only, never used by the port; null where ``_int_mm``
   refuses the shape), beside the bound: bytes (x read, w, w_scale and
   bias read, out written) over 3.35 TB/s against 2 M N K over the 1979
   TOP/s dense int8 rate; the prepare pass's and the GEMM's device ms
   apart, and the call's TOP/s and share of the bound.

13. ResNet-50 v1 training at full width, as bench.py's resnet50_train
   (bench.py:258-266) in fp32: ``resnet50_v1(classes=1000)``,
   ``initialize(seed=0)``, one inference forward to finish the deferred
   shapes, then ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``autograd.backward`` -> ``Trainer(..., "sgd", {"learning_rate": 0.05,
   "momentum": 0.9}).step(32)`` on one fixed batch of 32 x 3 x 224 x 224
   (``torch.randn`` from a seeded generator, labels ``randint(0, 1000)``).
   From the same start weights, with ``fused_conv_bn`` "auto" (kernel 8)
   and "off" (the cuDNN chain) in turns (auto, off, off, auto): a warm-up
   step, then 24 timed steps with every count zeroed just before and read
   just after. Holds: 16 kernel-8 calls a step under "auto" (3 / 4 / 6 /
   3 by stage, and each of its CUDA kernels counted: weight split, dgrad
   and wgrad once a call, the reduce of dx and of dw where the wrapper's
   split rules cut the reduction) and 0 under "off"; no launch of
   kernels 1-7; the losses finite and the last below the first (24 timed
   steps: momentum SGD on one fixed batch overshoots on steps 3-7 before
   it falls, under both routes); the running statistics after step 1
   within 1e-4 of each other (two-pass vs single-pass variance); the
   step-1 gradients of "auto" within max|diff| / max|off| <= 1e-3 of
   "off" for every parameter, or within twice what the conditioning probe
   shows: the untrained net at batch 32 turns a one-rounding change of
   the input (x * (1 +- 2^-24), three draws, "off" route) into gradient
   changes of up to ~1e-1 of max|off| in the last stages, so no fp32
   route can agree with another to 1e-3 there. Prints step ms,
   images/s, the fp32 model-FLOP share (32 x 6 x 4.089e9 / step / 67
   TFLOP/s, as bench.py:44-46 counts), device ms and busy share with the
   top kernels (``torch.profiler``) and peak memory of both.
14. Kernel 8 times at the four stage shapes (three input sets in turn):
   its CUDA kernels alone and the whole wrapper with its stats pass, its
   plain version, and as yardstick the autograd backward of ``F.conv2d``
   -> ``F.batch_norm(training=True)`` -> relu (cuDNN, TF32 off; never
   called by the port), beside the bounds: da, y, x read, dx, dw written
   over 3.35 TB/s against 36 M C O flops at the fp32 rate, and against
   three TF32 products each at 495 TFLOP/s (the kernels' 3xTF32). The
   same in bf16 for the bf16 instantiation, beside the cuDNN bf16
   composition (a bf16 convolution, BatchNorm with fp32 gamma and beta,
   relu), against bytes at 2 a value over 3.35 TB/s and 36 M C O flops at
   989 TFLOP/s.
15. int8 ResNet-50 v1 inference: ``quantize_net(resnet50_v1(),
   calib_data=[one uniform batch 32 x 3 x 224 x 224],
   calib_mode="naive")`` as bench.py:305-308 does, which must replace 53
   convolutions and the Dense; one forward of a second uniform batch
   (RandomState(1), the calibration's distribution) must launch kernel 6
   once and no other kernel, the "off" route must give the same output
   bit for bit, and the output must be finite. Prints the
   int8-vs-fp32 error (max|diff| / max|fp32|, top-1 agreement), and the
   fp32 and int8 forwards in turns: ms, images/s, device ms and busy
   share, peak memory.
16. bf16 training of GPT-2 124M, the bf16 slice's main path: phase 5's
   model, batch and AdamW, under ``amp.init("bfloat16")`` (fp32 master
   weights; Dense, attention and the head's product in bf16, LayerNorm and
   the loss in fp32). The fp32 forward of the same weights gives the
   reference loss; the bf16 step's first loss must be within
   ``BF16_LOSS_TOL`` (2e-2) relative of it. One warm-up step (every
   gradient fp32 and finite, nonzero but for the key projection's bias,
   whose exact gradient is 0), then 4 timed steps with every count zeroed
   just before and read just after: each flash kernel (its bf16
   instantiation) 12 launches a step, no other kernel; the losses finite
   and falling. Prints step ms, device ms and busy share, tokens/s, the
   model-FLOP share at the bf16 rate (989 TFLOP/s) and at the fp32 rate
   (67), peak memory, and the flash kernels' own profiler events a step.
17. bf16 training of BERT-base: phase 7's model, batch and dropout 0.1
   through ``net.cast("bfloat16")`` and ``Trainer(..., "adamw",
   {"multi_precision": True})`` (bf16 weights, fp32 masters in the
   optimizer state). The first loss against the fp32 forward of the same
   weights and seed (2e-2); 9 timed steps: ln_residual forward and
   backward 12 launches a step each on bf16 rows with bf16 gamma and
   beta, no other kernel; the losses finite and falling; the same
   numbers as phase 16, and samples/s.
18. bf16 training of ResNet-50 v1: phase 13's model, batch and SGD under
   ``amp.init("bfloat16")``, ``fused_conv_bn`` "on" (kernel 8's bf16
   instantiation, 16 calls a step, 3 / 4 / 6 / 3 by stage) and "off"
   (cuDNN bf16 convolutions, fp32 BatchNorm) in turns (on, off, off, on),
   24 timed steps each from the same start weights; each run's first loss
   against the fp32 forward (2e-2), the losses finite and falling, no
   other kernel; then "auto" for 2 steps, which must launch kernel 8 as
   its rule for bf16 says. Prints step ms, device ms of every run,
   images/s, both model-FLOP shares and peak memory of "on" and "off".
19. GPT-2 124M bf16 hybridized: phase 16's model, batch and weights under
   ``amp.init``, ``net.hybridize()`` and ``loss.hybridize()`` (CUDA graphs
   of each forward and backward), AdamW through the Trainer's fused
   multi-tensor update. From the same start weights 2 eager and 2
   hybridized steps and 2 eager steps again: the losses and every
   parameter equal bit for bit.
   Then timed runs in turns (eager, hybrid, hybrid, eager) of 4 steps:
   step ms, device ms, busy share, tokens/s,
   host launch calls a step (the profiler's ``cudaLaunchKernel`` /
   ``cudaGraphLaunch`` / ... runtime events), capture seconds and peak
   memory (allocated and reserved). Last, the path's launch window: one
   profiled window of 4 hybridized steps, each flash kernel 48 launches
   by profiler events (a replay leaves the wrappers' counts alone); the
   kernels line reports these counts. Then ``save_parameters`` ->
   ``load_parameters`` of the model cast to bf16 into a fresh one: logits
   equal bit for bit.
20. BERT-base bf16 hybridized: phase 17's model, batch and dropout 0.1
   (``net.cast``, ``multi_precision`` AdamW, whose update stays per
   parameter), the same comparison from the same weights and generator
   state (bit for bit, the dropout generator's state after the steps
   equal to eager's), the same timed runs, and both ln_residual kernels
   48 launches in the launch window (the backward's cooperative launch
   inside the graph).
21. ResNet-50 v1 fp32 hybridized: phase 13's model, batch and SGD momentum
   (fused), ``fused_conv_bn`` "auto": the same comparison, bit for bit
   (parameters and running statistics), with cuDNN's deterministic
   algorithms in the compared steps (its default fp32 backward
   algorithms differ from run to run); their graphs are then dropped, so
   the timed runs capture with the default algorithms. The same timed
   runs, and kernel 8 (weight split, dgrad, wgrad) 64 launches in the
   launch window.
22. The fused update against the per-parameter rule at GPT-2 124M's
   parameter shapes: 10 steps of the same gradients each for SGD
   (momentum 0 and 0.9), Adam and AdamW (wd 0.01, clip 1.0): bit for bit
   or the largest difference in ulp and absolute (held to 1e-6), and the
   host launch calls and device kernels of one update either way.
23. Quantized serving: phase 3's model (the same seed), requests and
   tokens under ``quantize=`` "int8_weights", "int4_weights", "int8_kv"
   and "int4_weights,int8_kv", each engine's 7 graphs captured at
   ``warmup()`` and none after. ``weight_bytes / weight_bytes_fp`` within
   0.25-0.27 (int8) and 0.13-0.14 (int4), the reference's accounting; the
   int8 cache int8 with fp32 (slot, row, head) scales; two requests'
   tokens (the first and the longest prompt) through the tie-aware check
   against an eager decode on the card of the same model through the
   engine's own dequantized weights and cache layout (8 slots, the prompt
   padded to its bucket, one step at a time, no graph); 12 flash forward
   kernel events a prefill in a profiled prefill-only run. Prints
   tokens/s, TTFT p50/p99, TPOT p50 and decode ms/step of each mode beside
   fp32's.
24. The radix prefix cache: 16 prompts sharing a 256-token prefix, each
   followed by a 16-200-token suffix, ``serve.prefix_block`` 16, through
   the cache-off engine and the prefix-cache engine (13 graphs: the
   decode step, 6 prefills, 6 fused block-gather + suffix prefills): 15
   hits and 15 x 256 tokens reused, tokens tie-aware against the cache-off
   engine's (equal, or a first difference where both tokens are within
   1e-3 of the full forward's row maximum). Prints TTFT p50/p99 with the
   cache and without.
25. Speculative decoding with ``serve.spec_tokens`` 4: a self-draft (the
   model itself) and a foreign draft (a 2-layer GPT of the same widths,
   seeded weights) on phase 3's requests, tokens tie-aware against phase
   3's; the self-draft needs fewer rounds than tokens. Prints acceptance,
   rounds, tokens/s. Then the prefix cache and the self-draft together on
   phase 24's prompts (15 hits, tokens tie-aware against phase 24's
   cache-off engine), and a weight swap: an engine's ``stop`` ->
   ``update_weights`` (a second seeded GPT-2's weights) -> ``resume`` ->
   run -> ``restore_weights`` -> run gives, bit for bit, the tokens of
   fresh engines over each weight set, with no new capture.
26. The ``mx.np`` surface on the card: every function of the reference's
   frontend (``NP_REF``: the 187 of ``tests/test_op_coverage.py``
   ``REF_NP``, ``LINALG_REF``'s 19, ``RANDOM_REF``'s 20, copied here) runs
   on ``mx.gpu(0)`` on a case table this script carries (``np_cases``,
   the sweep's cases, ``linalg_cases``) and is held against the port's
   own CPU results: structure, shapes and dtypes exactly, integers and
   bools exactly, float values at the sweep's tolerance (rtol = atol =
   2e-5), linalg at rtol 1e-4 + atol 1e-5, factorizations by their
   sign-free invariants; every sampler reproducible under its seed on the
   card, its dtype as on the CPU, and its mean within 5 standard errors
   and its variance within 5% at 1000000 draws. Prints the counts of each
   namespace.
27. GPT-2 124M bf16 trained from ``mx.np`` arrays, the reference's way:
   phase 16's model, batch, seed-0 weights, ``amp.init`` and fused AdamW,
   the tokens made by ``mx.np.array(..., ctx=mx.gpu(0))``, ``out =
   net(x)``, ``loss.backward()``, ``trainer.step()``, ``loss.asnumpy()``.
   Two steps eager and two hybridized, each from the same weights as two
   tensor-driven steps (phases 16 / 19's path), losses and every
   parameter equal bit for bit; kernels 1-3 12 launches each a step
   (the wrappers' counts eager, profiler events in a window of 4
   hybridized steps). Timed in turns (tensors, mx.np, mx.np, tensors) of
   4 steps, eager and hybridized: wall, device ms, busy share, host
   launch calls a step. Last, a block whose forward is written in
   ``mx.np`` (``@``, ``np.tanh``, ``np.sum``) hybridized: captured once
   into a CUDA graph, its replays equal, and within 1e-5 of max|eager|
   of the eager forward.
28. Serving under every host plane: phase 3's model (the same seed) and
   16 requests, a new engine built with telemetry, trace, goodput,
   insight and blackbox on, ``serve.slo_ttft_ms`` / ``slo_tpot_ms``
   armed and the ops endpoint on an ephemeral loopback port. insight
   registers every bucket's graph; the counters equal ``stats()``
   (requests, completions, tokens, the TTFT histogram's count); each
   request's span tree has its ``serve.request`` root with
   ``serve.enqueue``, ``serve.prefill`` and ``serve.drain`` children;
   ``/metrics``, ``/healthz`` and ``/trace`` answer; ``slo_burn()`` is
   finite; nothing is built after ``warmup()``; the greedy tokens are
   phase 3's. One profiled run with the planes off and one with them on
   give the same synchronizing runtime calls and ``cudaMemcpy*`` runtime
   calls (host events, which the profiler does not drop; the device's
   copy events it does), and 192 flash forward events. Then tokens/s and TPOT p50 in turns
   (off, on, on, off), printed without a bound.
29. Phase 27's GPT-2 124M bf16 step from ``mx.np`` arrays under the
   planes: two eager steps under ``profiler.set_state("run")`` with a
   ``tensorboard_dir``: the dumped Chrome file has ``"operator"`` spans of
   the layers' ops, and the device trace kernels 1-3 by their kernel
   names, 12 each a step (the wrappers' counts too). Hybridized: the
   ``CachedOp:`` spans; ``record_memory()`` equal to
   ``torch.cuda.memory_stats`` read beside it; the FLOPs mx.insight
   counted on the captures' warm-up (aten ops and the flash kernels' own)
   within 5% of 6 x N_mm x tokens plus attention's (N_mm: the weights
   that enter a matrix product, the tied LM head in, the position
   embedding out), printed beside bench.py's 6 x N x tokens and
   ``insight.mfu``. Then ``trainer.skip_nonfinite`` with
   ``invoke.nan_output:at=1,times=1``: that step skipped with every
   parameter unchanged bit for bit, ``fault.stats()`` one injection and
   one skip, a blackbox ``nonfinite`` bundle that reads back with its
   checksum, and the next step moves the weights.
30. The planes' host cost: a tight eager loop of 10000 ``mx.np``
   elementwise ops on the card and phase 27's eager step (2 steps a run),
   every plane off against telemetry and trace on, in turns (off, on, on,
   off, twice; medians of 8 loop and 4 step runs each), with the cost
   added per op. The off state against the parent commit is
   ``tools/train_ab.py``'s (``--loop``, ``--np``).
31. BERT-base bf16 pretraining as GluonNLP's script drives it: phase 20's
   model, batch and dropout, ``wd_mult`` 0 on every beta, gamma and bias,
   multi_precision LAMB (lr 1e-4, wd 0.01) on the "local" kvstore,
   ``gluon.utils.clip_global_norm`` at 1.0 before each step, deferred
   ``metric.Accuracy`` (NSP) and ``metric.Perplexity`` (masked MLM
   positions). ``hybrid_ab``: 2 eager and 2 hybridized steps bit for bit,
   then wall / device ms, busy share and host launch calls a step,
   printed beside phase 20's AdamW numbers of the same run; kernels 4-5
   12 each a step (one eager step by the wrappers, a window of 4
   hybridized steps by profiler events). One step's fp32 masters against
   the reference's LAMB rule recomputed in float64 on the card from the
   step's snapshot (masters, clipped gradients, m and v): within 1e-5 of
   each tensor's largest value and 1e-2 of its step; the bf16 weights are
   their masters rounded. ``update_on_kvstore=True`` gives the local
   update's weights bit for bit over 2 steps.
32. ResNet-50 v1 fp32 as GluonCV's ImageNet script drives it: phase 21's
   model and batch with ``fused_conv_bn`` "auto", NAG (lr 0.1, momentum
   0.9, wd 1e-4), ``SoftmaxCrossEntropyLoss(sparse_label=False)`` on
   labels smoothed by 0.1, deferred ``Accuracy`` and ``TopKAccuracy(5)``.
   ``hybrid_ab`` as in 31 (cuDNN's deterministic algorithms for the
   compared steps); kernel 8 16 times a step; the fused NAG bit for bit
   with the per-parameter Updater over 3 steps of the same gradients.
33. This slice's surface at small shapes, each on the card against the
   port's own CPU result from the same inputs (rtol 1e-4, atol 1e-5):
   every registered optimizer for 3 steps (fp32, and bf16 with
   ``multi_precision``: masters at the tolerance, weights their masters
   rounded), the fused families fused against per-parameter on the card
   bit for bit; every new loss (value, gradient); every new layer
   (forward, input and parameter gradients); every metric, eager and
   deferred (top-k also on scores tied on the k-th value);
   ``clip_global_norm``; the KVStore with 2-bit compression and
   an optimizer inside; ``grad(create_graph=True)`` to third order, and
   through a hybridized block the documented ``MXNetError`` (a replayed
   CUDA graph is first-order only).
34. ResNet-50 v1 fp32 fed from disk: 512 seeded 224 x 224 x 3 uint8
   images with labels of 1000 classes in one ``.rec`` / ``.idx`` pair
   (``recordio.pack_img``, the ``.npy`` codec), read by
   ``ImageRecordDataset(...).transform_first(Compose([RandomFlipLeftRight(),
   ToTensor(), Normalize(mean, std)]))`` through ``DataLoader(batch_size=32,
   shuffle=True, num_workers=4, pin_memory=True, prefetch_to_device=True,
   last_batch="discard")`` with spawned process workers and the
   shared-memory ring; the loader alone first, threads against processes
   (images/s of a second epoch). Phase 32's model and recipe hybridized,
   driven by ``Estimator.fit`` with a ``ResilienceHandler``, cuDNN's
   deterministic algorithms: one uninterrupted epoch (16 steps); then
   ``resilience.preempt:at=5``, and a fresh net, trainer and loader from
   the same seed restore the bundle and finish the epoch: every loss after
   step 5 and every weight at the end equal bit for bit. Then, with the
   default algorithms: wall ms a step of the loader-fed fit and of a
   device-resident batch in turns, device ms and busy share of both,
   ``pipeline.input_stall_seconds``, the side stream's host-to-device
   copies overlapping compute kernels (profiler events), 0 host syncs in
   the fit loop (the sync guard, and the synchronizing runtime calls of
   the loop's thread), the bundle's bytes and save / load seconds, kernel
   8 16 times a hybridized step (profiler events).
35. GPT-2 124M bf16 fed from stream shards: 96 seeded sequences of 1025
   int32 tokens in 4 checksummed shards (``ShardWriter``, a manifest),
   ``StreamDataset`` + ``StreamSampler`` through ``DataLoader(num_workers=2,
   prefetch_to_device=True)``, phase 27's hybridized bf16 AdamW step
   driven by ``resilience.run``: one uninterrupted epoch (12 steps); then a
   run that saves its bundle at step 4 and meets ``stream.shard_unreadable``
   past ``stream.open_retries`` on its next shard open: ``run`` restores
   the bundle and re-enters, and the losses of steps 5-12 equal the
   uninterrupted run's bit for bit. Kernels 1-3 12 times each a hybridized
   step (profiler events); wall ms a step fed from the shards against a
   device-resident batch.
36. GPT-2 124M fp32 through ``parallel.ShardedTrainStep(MeshConfig())``
   on one card (phase 5's batch 8 x 1024 from RandomState(0) at every
   step, SGD lr 0.01 momentum 0.9): the plain step for 4 updates (the
   reference of phases 40-42; again at 6 layers, phase 37's), then
   ``zero=2, grad_accum=4,
   steps_per_call=2`` (2 calls of 2 updates of 4 microbatches of 2) with
   remat off, ``True`` and ``'dots'`` (each layer of the decoder
   checkpointed on its own), each after a warm-up call: the accumulated
   losses within 1e-5 of the plain step's mean and its updates within
   1e-3 (relative L2) of the plain step's after 2 and 4 updates; remat
   bit for bit with off (losses and weights); flash launches 12 a
   microbatch (the forward 24 under remat); ms an update and peak
   allocated memory a setting.
37. GPT-2 124M's width at 6 of its 12 layers (``DP_LAYERS``: the
   script's time; phases 40-42 run all 12), fp32, on two ranks sharing
   the card
   (``tools/launch.py -n 2 --env MXTPU_DIST_DEVICE=cuda``, each rank this
   script with ``--dp-rank gpt``; gloo, after a probe of whether NCCL
   takes two ranks on one device): ``ShardedTrainStep(MeshConfig(dp=2))``
   at zero 0, 1 and 2 and ``grad_compress="int8"``, 4 updates of the
   global batch each from the same start: losses within 1e-5 (int8 1e-3)
   of phase 36's plain step, the update within 1e-3 (int8 0.5) relative
   L2 of it, weights equal bit for bit across ranks (rank 0 broadcasts),
   the ``zero.*`` / ``mesh.*`` / ``comm.*`` counters equal to the
   analytic count, flash launches 6 a step a rank; per rank ms a step,
   collective seconds a step (``collectives.timing``), peak memory; the
   zero=2 bundle saved at world 2 loads bit for bit into a one-card
   step, which continues; a ``dist_sync`` store on the card's tensors
   sums exactly, also through one injected ``kvstore.collective_timeout``
   retried on rank 0.
38. ResNet-50 v1 fp32 on two ranks sharing the card through
   ``Trainer(kvstore="dist_device_sync")``, phase 13's batch of 32 (16 a
   rank), kernel 8 with the global batch's statistics: one compared step
   (cuDNN deterministic) against the one-card step on the 32: the loss
   within 1e-5, the update within the larger of 1e-3 and twice the
   conditioning probe (the one-card update with the batch moved by one
   fp32 rounding) relative L2, the running statistics likewise within
   1e-4 of their max; weights and statistics equal bit for bit across
   ranks; kernel 8 16 calls a rank-step; ms a step of 3 timed steps.
39. Ring attention over sp=2 on two ranks sharing the card (each rank
   this script with ``--dp-rank ring``): b 8, h 12, s 1024 (512 a rank),
   d 64, fp32 and bf16, causal and not: the card route (kernel 1 on each
   ring pair merged by lse, kernels 2-3 with the global lse) against the
   plain route on the same tensors, output and dq / dk / dv within 1e-4
   (fp32) / 2^-5 (bf16) of max|plain|; kernel launches a call 2 of each,
   causal 1 / 2 on ranks 0 / 1.
40-42. Phases 36-37's GPT-2 (and phase 42's BERT-base) on ranks sharing
   the card, each against a one-card ``ShardedTrainStep`` of the same
   weights and batches (phase 36's for GPT): losses within 1e-5, the
   update within 1e-3 relative L2 (the block made whole by
   ``sync_to_block``), whole weights equal across ranks, the kernels'
   launches a rank-step, per rank ms a step, collective seconds, peak
   memory and the tp / pp byte counters. 40: ``MeshConfig(tp=2)``
   (heads / 2 local heads), then ``MeshConfig(sp=2)`` (ring attention,
   causal: kernel 1 one / two pairs a layer on ranks 0 / 1); 41:
   ``MeshConfig(pp=2)`` with ``grad_accum=2`` (the GPipe schedule; its
   bundle loads bit for bit into a one-card step, which continues); 42,
   four ranks: ``MeshConfig(dp=2, tp=2)`` zero=1, then BERT-base (phase
   7's batch, dropout 0, ``fused_ln_residual`` "on", MLM + NSP loss) at
   ``MeshConfig(tp=2, sp=2)`` without a mask (ring) and with
   ``valid_length`` (keys gathered), kernels 4-5 two a layer a
   rank-step. Phases 40-42 run all 12 layers.
43. The elastic training fleet (``mx.fleet``) on four ranks sharing the
   card (``--dp-rank fleet``): GPT-2 124M fp32 at all 12 layers, phase
   42's batch (a different RandomState batch each step), SGD lr 0.01,
   target ``MeshConfig(dp=2, tp=2)`` over 2 hosts of 2 ranks, a bundle
   every step; ``fleet.host_loss`` at step 4 degrades to
   ``MeshConfig(dp=1, tp=2)`` on ranks 0-1 (ranks 2-3 stranded: they make
   the groups and step no more), ``restore_hosts()`` after step 6
   re-expands, 8 steps. Each step's loss within 1e-5 of the uninterrupted
   run at the target layout on the same ranks; every restore bit for bit
   the bundle it read (``state_dict`` against the file); 1 degrade and 1
   re-expand; kernels 1-3 12 launches a rank-step, 0 on the stranded
   ranks while degraded. Per rank: the degrade and re-expand downtime
   (rebuild + restore, s), goodput's ``restart`` badput, step ms at each
   layout, bundle save s, peak GB.
44. The serving fleet (``mx.servefleet``) in this process: 3 replicas of
   phase 3's engine (GPT-2 124M fp32, max_slots 8, buckets 16-512) from
   phase 3's seed, phase 3's 16 greedy requests each in its own session:
   tokens equal phase 3's (or a tie the full forward shows), tokens/s,
   TTFT and TPOT beside phase 3's single engine; kernel 1 12 launches a
   full prefill inside the replicas' prefill graphs (each graph's
   captured launches over its replays in a run of 16 prefills, the
   profiler's device events of that run beside them); host calls and
   host us a decode step with the fleet's gate on and off.
   ``serve.replica_crash``: every request completes once with phase 3's
   tokens, the dead replica's graphs and cache released. A rolling update
   to phase 25's swap weights, published with ``publish_checkpoint`` and
   their canary card: generation 1, 0 captures after warmup on every
   replica, the fleet's tokens equal the card. A checkpoint whose canary
   disagrees rolls back at the first replica and aborts. The crash frees
   the dead replica's tensors (allocated memory falls by nine tenths of
   an engine's or more); the sole replica crashes and is rebuilt: the
   allocated memory comes back within a tenth of an engine's of the
   one-replica reading, the reservation within one engine's reservation
   (late in the script the caching allocator cannot return every freed
   segment). ``serve.replica_stall``
   (drain window 64, 3 tokens a request): one failover, every request
   once with phase 3's first tokens, the late duplicates suppressed.
   Reserved GB after each drill.
45. The ``npx`` operator tail: each new op (56: the elementwise, mask,
   indexing, sequence, shape, loss, cast, interleaved-attention and
   detection ops and the control flow) on ``cuda:0`` against its CPU
   result (values within rtol 1e-5 + atol 1e-5 of max |cpu|, index
   outputs equal); the samplers on the card (2^20 draws: shape, dtype,
   device, mean and std within 0.01 of the distribution's);
   ``npx.rnn``'s cuDNN route against its plain loop in every mode, 1-2
   layers, both directions, at the LM's shapes (35 x 20 x 650), forward
   and backward (max |diff| within 1e-4 of max |plain|, gradients 5e-4;
   fp32, TF32 off), and the routes of bf16 (plain), fp16, the state clip
   (plain) and a capturing stream (cuDNN, as eager);
   ``npx.multi_head_attention`` at BERT-base width (8 x 512, 12 heads x
   64), causal and not, fp32 and bf16, forward and backward against the
   plain composition (2e-4 / 2e-2 of max |plain|), one kernel 1, 2 and 3
   launch a call (the kernels line's ``npx_multi_head_attention``), and
   the call's ms beside the composition's.
46. The "medium" LSTM language model of Zaremba et al. 2014 as a
   ``gluon.Block`` (Embedding 10000 x 650 -> Dropout -> ``rnn.LSTM(650,
   2)`` -> Dropout -> Dense 10000, untied, dropout 0, Uniform(0.05) from a
   seed, 19.78M parameters), batch 20 x bptt 35 of seeded token ids, SGD
   1.0, ``clip_global_norm`` 5 (on the summed gradients: 5 x 700), the
   hidden state carried and detached: eager on the cuDNN route, eager on
   the plain loop (cuDNN off) and hybridized (cuDNN inside the CUDA
   graphs), each from the same weights. First loss about ln 10000; the
   routes' first losses within 1e-5 relative (the first three within
   1e-4); hybridized bit for bit with eager. Per run: step ms (median of
   6), device ms and busy share (2 profiled steps), host launch calls a
   step, peak GB, tokens/s, routes taken.

The line before the last is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN so that fp32 means fp32 throughout.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as onp
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float8_e4m3fn: 1979e12, torch.int8: 1979e12}
# the fp32 flash kernels take each product as three TF32 products
# (3xTF32) on the tensor cores, at this rate
PEAK_TF32 = 495e12
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10
GREEDY_TOL = 1e-3
N_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 4
TRAIN_BH = TRAIN_BATCH * 12  # the training path's b*h (12 heads)
SOURCE = "mxnet_tpu_torch/csrc/{}.cu"
TPU_FLASH = "mxnet_tpu/ops/pallas/flash_attention.py:{}"
TPU_LN = "mxnet_tpu/ops/pallas/ln_residual.py:{}"
LN_TOL = dict(atol=1e-5, rtol=1e-5)
LN_SHARE = 1e-5  # of max |ref|: dgamma/dbeta, the zero-variance row
LN_OFFSET_TOL = dict(atol=1e-4, rtol=1e-5)  # rows with mean ~100
F16_RTOL, F16_ATOL_SHARE = 2.0 ** -10, 2.0 ** -13  # fp16 ln_residual results
LN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (x, h, gamma/beta, mask) dtypes where they differ (the reference's rule:
# each its own)
LN_MIXED = [
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.bool),
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16, torch.uint8),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float32, torch.bool),
    (torch.float32, torch.float32, torch.float16, torch.float16),
    (torch.float16, torch.bfloat16, torch.float32, torch.bfloat16),
]
# (n, D) run twice, bit for bit: ragged n around the backward's row groups
# and blocks, BERT's shape, many waves of blocks, a block per row, no
# 16-byte path
LN_REPEAT = [(1, 768), (131, 768), (133, 768), (4097, 768), (4096, 768),
             (65536, 768), (600, 8192), (600, 1999)]
BERT_VOCAB, BERT_BATCH, BERT_SEQ, BERT_STEPS = 30522, 32, 128, 9
BERT_UNITS = 768
BERT_MASK_ID = 103  # [MASK] in BERT's uncased vocabulary
LN_ROWS, LN_DIM, LN_P = BERT_BATCH * BERT_SEQ, 768, 0.1
TPU_QMM = "mxnet_tpu/ops/pallas/quant_matmul.py:{}"
FP8_TOL_SHARE = 2.0 ** -20  # of the sum of |products| x |xs * ws|
FP8_TOL_REL = 1e-6
FP8_SITES_PER_STEP = 72  # 12 layers x (query, key, value, out, ffn_1, ffn_2)
FP8_TRAIN_SHAPES = [(8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768)]
# (M, N, K) around the kernel's 128 x 128 output tile and 64-value k-tile:
# M and N of tile +- 1, N % 4 != 0, K = 100 (padded) and 784 (a partial
# last k-tile)
FP8_RAGGED = [(127, 127, 784), (129, 129, 784), (128, 128, 768),
              (129, 132, 100), (127, 124, 100), (255, 130, 784),
              (1, 768, 784), (257, 3, 100)]
# fp8 step loss vs the fp32 forward of the same weights: ~10x the largest
# reading, 3.1e-4, on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W)
FP8_SAME_WEIGHTS_TOL = 5e-3
# Dense sites whose dy arrives only through another site's fp8 backward
# product (tests/test_torch_fp8.py: test_fp8_step_flushes_small_gradients_
# like_jax), so that step 1 at the identity scale may flush it to zero
FP8_FLUSHABLE = ("query_proj", "key_proj", "value_proj", "ffn_1")
# int8 kernel vs its plain version for sigmoid, tanh and gelu
INT8_ACT_TOL = dict(atol=1e-6, rtol=1e-6)
# (M, K, N) of the int8 BERT-base forward and its launches per forward
INT8_BERT_SHAPES = {(4096, 768, 768): 48, (4096, 768, 3072): 12,
                    (4096, 3072, 768): 12, (32, 768, 768): 1}
INT8_LAYERS = 73
# (M, K, N) around the int8 GEMM's 128 x 128 / 128 x 192 tiles and 128-value
# k-stage: M and N of tile +- 1, N % 4 != 0 (direct-store epilogue), K =
# 100 and 200 (w copied into the padded scratch) and 784 (a partial stage)
INT8_RAGGED = [(127, 784, 191), (129, 784, 193), (255, 100, 130),
               (200, 768, 300), (1, 200, 3), (257, 768, 384)]
# the int8 GEMM's instantiations, as phase 1 names them
INT8_GEMM_KERNELS = tuple(f"int8_gemm n{bn} {store} store" for bn in (128, 192)
                          for store in ("tma", "direct"))
# int8 vs fp32 BERT-base outputs, max |diff| / max |fp32|: over 2x the
# first reading, 0.0515 and 0.148, on an H100 SXM (NVIDIA H100 80GB HBM3,
# 700 W)
INT8_VS_FP32_TOL = {"sequence": 0.12, "pooled": 0.35}
TPU_CONV = "mxnet_tpu/ops/pallas_conv_bwd.py:{}"
# the serving mix of phases 3-4 and 23-25: 16 greedy requests of 32 tokens
SERVE_VOCAB, SERVE_REQUESTS, SERVE_NEW_TOKENS = 50257, 16, 32
SERVE_QUANT_MODES = ("int8_weights", "int4_weights", "int8_kv",
                     "int4_weights,int8_kv")
# weight_bytes / weight_bytes_fp by weight mode (the reference's own
# accounting: int8 values + fp32 row scales; int4 nibbles + fp32 scales a
# group of 128; the biases and LayerNorm vectors stay fp32)
WEIGHT_RATIOS = {"int8_weights": (0.25, 0.27), "int4_weights": (0.13, 0.14)}
# phase 24: prompts share a 256-token prefix, indexed in 16-token blocks
PREFIX_SHARED, PREFIX_BLOCK = 256, 16
# ResNet-50 v1 training as bench.py's resnet50_train (bench.py:258-266)
RESNET_BATCH, RESNET_CLASSES, RESNET_STEPS = 32, 1000, 24
RESNET_SIZE = 224
RESNET50_TRAIN_FLOPS = 3 * 2 * 4.089e9  # per image (bench.py:44-46)
# (N, H, W, C = O) of the 3x3 stride-1 triplets, and the count a step that
# phase 13 expects of each (it reads the count from the wrapper)
CONV_STAGES = [(32, 56, 56, 64), (32, 28, 28, 128), (32, 14, 14, 256),
               (32, 7, 7, 512)]
RESNET_STAGE_TRIPLETS = dict(zip(CONV_STAGES, (3, 4, 6, 3)))
# kernel 8's CUDA kernels, as phase 1 names them: fp32, then the bf16
# instantiation
CONV_KERNELS = ("conv_bwd wsplit", "conv_bwd dgrad", "conv_bwd wgrad",
                "conv_bwd reduce", "conv_bwd wcopy bf16", "conv_bwd dgrad bf16",
                "conv_bwd wgrad bf16", "conv_bwd reduce bf16")
RESNET_TRIPLETS = 16
# kernel 8 vs its plain version, max|diff| / max|plain| of dx and dw: fp32
# sums of up to 9*512 products in another order
CONV_TOL = 2e-4
# (N, H, W, C, O) at the kernels' edges: pixel chunks across images with
# N*H*W not a multiple of the chunk, W = 1, C and O not multiples of 8 or
# of the channel chunks, patches of 63 pixels with empty slots (7 x 9),
# 4 x 14 patches (28 x 28) and a dgrad split over output channels
CONV_EDGES = [(5, 13, 11, 40, 24), (2, 9, 1, 3, 2), (3, 7, 9, 5, 11),
              (2, 9, 7, 70, 33), (2, 28, 28, 20, 12), (1, 2, 2, 7, 13),
              (4, 7, 7, 36, 520)]
# the non-finite case of phase 2f
CONV_NON_FINITE = (2, 6, 5, 4, 3)
# kernel 8 in bf16 vs its plain version, elementwise: |diff| <= one bf16
# ulp of the plain value (rtol 2^-7) plus this share of max|plain| (the
# bf16 products are exact in fp32, so only the order of the fp32 sums
# differs, and a sum on a rounding boundary may round to the other bf16
# neighbour)
CONV_BF16_SHARE = 1e-5
# step-1 gradients of the kernel route vs the cuDNN chain, max|diff| /
# max|off| per parameter, or twice the conditioning probe's change where
# that is larger (phase 13)
RESNET_GRAD_TOL = 1e-3
RESNET_PROBES = 3
# step-1 gradients of the kernel route vs the same fused forward with
# autograd's (cuDNN) backward, max|diff| / max|ref| per parameter: with the
# forward shared, no ReLU flips, and only the backward's fp32 summation
# order differs (first reading 7.1e-5 on an H100 SXM, 700 W)
RESNET_WIRING_TOL = 1e-3
# running statistics after step 1, max|diff| / max|off| per tensor: the
# fused forward's two-pass variance against BatchNorm's single-pass one
RESNET_STAT_TOL = 1e-4
INT8_RESNET_CONVS = 53  # the stem, 16 x 3 bottleneck convs, 4 downsample
RESNET_FWD_ITERS = 20  # forwards in each timed window of phase 15
# the bf16 step's first loss vs the fp32 forward of the same weights,
# relative (phases 16-18)
BF16_LOSS_TOL = 2e-2
BF16_TRAIN_STEPS = 4  # timed steps of phase 16


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


def device_profile(fn, iters, warmup=3, top=5, match=""):
    """Device time of ``fn()`` from ``torch.profiler``, free of host launch
    overhead: (mean ms per call summed over every CUDA kernel and copy
    whose name contains ``match``, the ``top`` kernels by time as (name, ms
    per call)). The first is None when the profiler records no such
    device activity."""
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
        if e.device_type == DeviceType.CUDA and match in e.name:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(per.values()) / iters / 1e3
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return (total or None), [(n[:60], us / iters / 1e3) for n, us in ranked]


def device_ms(fn, iters, warmup=3):
    return device_profile(fn, iters, warmup)[0]


def device_kernels(fn, iters, match, warmup=3):
    """Device kernels (and copies) of ``fn()`` from ``torch.profiler``:
    (kernels a call, ms of one ``match`` kernel, events seen a call).
    Kernels a call is counted against the ``match`` kernel's own events
    (all events over its events), and its ms is the mean of its events,
    so that neither moves where the profiler drops some events (it did
    drop up to a quarter of them in a window of 30 calls on the H100). A
    window in which it recorded no ``match`` event at all (it happened
    once on the H100, for a kernel whose launches the wrapper counted) is
    measured again, up to three windows; None where none recorded one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for window in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        mine = [e.time_range.elapsed_us() for e in events if match in e.name]
        if mine:
            return (len(events) / len(mine), sum(mine) / len(mine) / 1e3,
                    len(events) / iters)
        print(f"  (profiler window {window + 1}: no {match} event among "
              f"{len(events)} device events; measured again)")
    return None, None, len(events) / iters


def busy_share(device, wall):
    """Profiled device ms over unprofiled wall ms, or None where either is
    missing or the device time exceeds the wall time (the profiler's own
    cost or a slower window: not a share that was measured)."""
    if device is None or not wall or device > wall:
        return None
    return device / wall


def fwd_flops(bh, sq, sk, d, causal):
    """Products of one flash-attention forward on these inputs: 2 matmuls
    x 2 flops x d per visible (q, k) pair."""
    return 4 * d * pairs(sq, sk, causal) * bh


def flash_bound_ms(bh, sq, sk, d, causal, dtype, tf32x3=False):
    """Least time on an H100 SXM for one flash-attention forward on these
    inputs: each input read once and each output written once over the
    memory rate, against its products over the peak rate of the dtype (67
    TFLOP/s of fp32 FMAs for fp32), or with ``tf32x3`` at the rate the
    fp32 kernel uses: three TF32 products per product at 495 TFLOP/s."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * bh * d * (2 * sq + 2 * sk) + 4 * bh * sq
    flops = fwd_flops(bh, sq, sk, d, causal)
    if tf32x3:
        return bound(nbytes, 3 * flops, dtype, rate=PEAK_TF32)
    return bound(nbytes, flops, dtype)


def pairs(sq, sk, causal):
    """Visible (q, k) pairs of one head (top-left causal)."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def bound(nbytes, flops, dtype, rate=None):
    """(ms, what bounds it) for an H100 SXM, at the dtype's peak rate or
    at ``rate`` FLOP/s."""
    t_mem = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (rate or PEAK_FLOPS[dtype])
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def bwd_flops(kind, bh, sq, sk, d, causal):
    """Products of one backward kernel on these inputs: 8 d flops per
    visible pair for dK/dV (s and dp recomputed, dV and dK), 6 d for dQ
    (s, dp, dQ)."""
    return (8 if kind == "dkv" else 6) * d * pairs(sq, sk, causal) * bh


def bwd_bound_ms(kind, bh, sq, sk, d, causal, dtype, tf32x3=False):
    """Least time on an H100 SXM for one backward kernel on these inputs.
    dK/dV reads q, k, v, do, lse, delta once and writes dk, dv; dQ reads
    the same and writes dq. The products at the dtype's peak (67 TFLOP/s
    of fp32 FMAs for fp32), or with ``tf32x3`` at the rate the fp32
    kernels use: three TF32 products per product at 495 TFLOP/s."""
    esize = torch.finfo(dtype).bits // 8
    n_in = esize * bh * d * (2 * sq + 2 * sk) + 2 * 4 * bh * sq
    nbytes = n_in + esize * bh * d * (2 * sk if kind == "dkv" else sq)
    flops = bwd_flops(kind, bh, sq, sk, d, causal)
    if tf32x3:
        return bound(nbytes, 3 * flops, dtype, rate=PEAK_TF32)
    return bound(nbytes, flops, dtype)


def ptxas_summary(log):
    """One line per compiled kernel: function, registers, spills; for the
    ln_residual instantiations one line per direction (register range,
    largest spill)."""
    out, name, spill = [], None, ""
    ln = {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            if "fp8_matmul_cu" in mangled:
                name = fp8_kernel_name(mangled)
                continue
            if "int8_prepare_kernel" in mangled or \
                    "int8_gemm_kernel" in mangled:
                name = int8_kernel_name(mangled)
                continue
            if "conv_bwd" in mangled:
                name = conv_kernel_name(mangled)
                continue
            if "ln_residual" in mangled:
                name = ln_kernel_name(mangled)
                continue
            name = flash_kernel_name(mangled)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            if name.startswith("ln_"):
                regs = int(re.search(r"Used (\d+) registers", line)[1])
                spilled = int(re.search(r"(\d+) bytes spill stores",
                                        spill)[1]) if spill else 0
                lo, hi, worst, n = ln.get(name, (regs, regs, 0, 0))
                ln[name] = (min(lo, regs), max(hi, regs),
                            max(worst, spilled), n + 1)
            else:
                out.append(f"  {name}: {line.split(':', 1)[1].strip()}; "
                           f"{spill}")
            name = None
    for name, (lo, hi, worst, n) in sorted(ln.items()):
        out.append(f"  {name}: {n} instantiations, {lo}-{hi} registers, "
                   f"largest spill {worst} bytes")
    return out


def ln_kernel_name(mangled):
    """``ln_fwd`` / ``ln_bwd`` for a mangled ln_residual kernel name."""
    if "ln_residual" not in mangled:
        return None
    return "ln_fwd" if "fwd" in mangled else "ln_bwd"


def flash_kernel_name(mangled):
    """``dkv fp32 d=64`` for a mangled flash-attention kernel name."""
    kind = next((k for k in ("dkv", "dq", "fwd")
                 if f"flash_{'bwd_' if k != 'fwd' else ''}{k}" in mangled),
                "?")
    dtype = "bf16" if "bfloat16" in mangled else "fp32"
    dim = re.search(r"Li(\d+)E", mangled)
    return f"{kind} {dtype} d={dim.group(1) if dim else '?'}"


def fp8_kernel_name(mangled):
    """``fp8_prepare x e4m3 w e5m2`` or ``fp8_gemm tma store`` for a
    mangled kernel name of ``fp8_matmul.cu``."""
    fmts = ("e4m3", "e5m2")
    tpl = re.search(r"fp8_prepare_kernelILi(\d)ELi(\d)E", mangled)
    if tpl:
        return f"fp8_prepare x {fmts[int(tpl[1])]} w {fmts[int(tpl[2])]}"
    tpl = re.search(r"fp8_gemm_kernelILb(\d)E", mangled)
    if tpl:
        return f"fp8_gemm {'tma' if tpl[1] == '1' else 'direct'} store"
    return "fp8_matmul ?"


def int8_kernel_name(mangled):
    """``int8_prepare`` or ``int8_gemm n192 tma store`` for a mangled kernel
    name of ``int8_matmul.cu``."""
    if "int8_prepare_kernel" in mangled:
        return "int8_prepare"
    tpl = re.search(r"int8_gemm_kernelILi(\d+)ELb(\d)E", mangled)
    if tpl:
        return (f"int8_gemm n{tpl[1]} "
                f"{'tma' if tpl[2] == '1' else 'direct'} store")
    return "int8_matmul ?"


def int8_gemm_name(mangled):
    return int8_kernel_name(mangled) if "int8_gemm_kernel" in mangled else None


def conv_kernel_name(mangled):
    """``conv_bwd dgrad`` (``conv_bwd dgrad bf16`` for the bf16
    instantiation, both of its output types; the reduce storing bf16 is
    ``conv_bwd reduce bf16``) for a mangled kernel name of
    ``conv_bwd.cu``."""
    part = re.search(r"conv_bwd_(wsplit|wcopy|dgrad|wgrad|reduce)(_bf16)?"
                     r"_kernel", mangled)
    if not part:
        return "conv_bwd ?"
    bf16 = part[2] or "bfloat16" in mangled
    return f"conv_bwd {part[1]}{' bf16' if bf16 else ''}"


def conv_name(mangled):
    return conv_kernel_name(mangled) if "conv_bwd_" in mangled else None


def spill_bytes(log, namer):
    """{kernel: spill store bytes} from a ptxas report, for the kernels
    ``namer`` names."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = namer(line.split("'")[1])
        elif name and "spill stores" in line:
            out[name] = max(out.get(name, 0), int(
                re.search(r"(\d+) bytes spill stores", line)[1]))
    return out


def tensor_core_counts(lib, namer, pattern=r"\bHG?MMA\."):
    """{kernel: count of tensor-core SASS instructions (HMMA / HGMMA, or
    ``pattern``)} of the kernels ``namer`` names in a built library, from
    ``cuobjdump -sass`` beside ``nvcc``."""
    from pathlib import Path

    from mxnet_tpu_torch import _native
    tool = Path(_native._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = namer(line.split("Function :")[1].strip())
            if name:
                counts[name] = 0
        elif name and re.search(pattern, line):
            counts[name] += 1
    return counts


def flash_name(mangled):
    return (flash_kernel_name(mangled)
            if re.search(r"flash_(bwd|fwd)_", mangled) else None)


def fp8_gemm_name(mangled):
    return fp8_kernel_name(mangled) if "fp8_gemm_kernel" in mangled else None


def phase_build():
    from mxnet_tpu_torch import _native
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    libs = _native.build(["flash_attention_fwd", "flash_attention_bwd",
                          "ln_residual", "fp8_matmul", "int8_matmul",
                          "conv_bwd"])
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
    counts = {**tensor_core_counts(libs["flash_attention_fwd"], flash_name),
              **tensor_core_counts(libs["flash_attention_bwd"], flash_name)}
    want = {f"{kind} {dtype} d={d}" for kind in ("fwd", "dkv", "dq")
            for dtype in ("fp32", "bf16") for d in (16, 32, 64, 128)}
    print("tensor-core SASS (HMMA/HGMMA) in the flash kernels: "
          + ", ".join(f"{n} {c}" for n, c in sorted(counts.items())))
    check(set(counts) == want, f"flash kernels in the libraries: "
                               f"{sorted(counts)}, expected {sorted(want)}")
    check(all(counts.values()), "a flash kernel has no tensor-core "
                                f"instruction: {counts}")
    hgmma = tensor_core_counts(libs["fp8_matmul"], fp8_gemm_name,
                               r"\bHGMMA\.")
    print("wgmma SASS (HGMMA) in the fp8 GEMM kernels: "
          + ", ".join(f"{n} {c}" for n, c in sorted(hgmma.items())))
    check(set(hgmma) == {"fp8_gemm tma store", "fp8_gemm direct store"}
          and all(hgmma.values()), f"fp8 GEMM kernels without HGMMA: {hgmma}")
    log = _native.build_logs.get("ln_residual")
    if log is not None:
        spills = spill_bytes(log, ln_kernel_name)
        check(set(spills) == {"ln_fwd", "ln_bwd"}
              and not any(spills.values()),
              f"an ln_residual instantiation spills: {spills}")
    log = _native.build_logs.get("fp8_matmul")
    if log is not None:
        spills = spill_bytes(log, lambda m: fp8_kernel_name(m)
                             if "fp8_matmul_cu" in m else None)
        check(spills and not any(spills.values()),
              f"an fp8 matmul kernel spills: {spills}")
    igmma = tensor_core_counts(libs["int8_matmul"], int8_gemm_name,
                               r"\bIGMMA\.")
    print("wgmma SASS (IGMMA) in the int8 GEMM kernels: "
          + ", ".join(f"{n} {c}" for n, c in sorted(igmma.items())))
    check(set(igmma) == set(INT8_GEMM_KERNELS) and all(igmma.values()),
          f"int8 GEMM kernels without IGMMA: {igmma}, expected "
          f"{sorted(INT8_GEMM_KERNELS)}")
    log = _native.build_logs.get("int8_matmul")
    if log is not None:
        spills = spill_bytes(log, lambda m: int8_kernel_name(m)
                             if "int8_" in m and "_kernel" in m else None)
        check(set(spills) == set(INT8_GEMM_KERNELS) | {"int8_prepare"}
              and not any(spills.values()),
              f"an int8 matmul kernel spills: {spills}")
    hmma = tensor_core_counts(libs["conv_bwd"], conv_name, r"\bHMMA\.")
    log = _native.build_logs.get("conv_bwd")
    spills = spill_bytes(log, conv_name) if log is not None else None
    print("tensor-core SASS (HMMA) in the conv_bwd kernels: "
          + ", ".join(f"{n} {c}" for n, c in sorted(hmma.items()))
          + "; spill store bytes: "
          + (", ".join(f"{n} {b}" for n, b in sorted(spills.items()))
             if spills is not None else "(cached build)"))
    check(set(hmma) == set(CONV_KERNELS), f"conv_bwd kernels in the library: "
                                          f"{sorted(hmma)}, expected "
                                          f"{sorted(CONV_KERNELS)}")
    check(all(hmma[f"conv_bwd {k}"] for k in ("dgrad", "wgrad", "dgrad bf16",
                                              "wgrad bf16")),
          f"a conv_bwd product kernel has no HMMA: {hmma}")
    check(spills is None or (set(spills) == set(CONV_KERNELS)
                             and not any(spills.values())),
          f"a conv_bwd kernel spills: {spills}")
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


def fwd_case(fa, dev, gen, bh, sq, sk, causal, dtype, d=64, quiet=False,
             repeat=False):
    """One forward comparison: the larger of max |out err| and max |lse
    err|; with ``repeat``, a second launch must agree bit for bit."""
    q, k, v = (torch.randn(bh, n, d, device=dev, generator=gen).to(dtype)
               for n in (sq, sk, sk))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    if repeat:
        again = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"a second launch of the forward kernel differs at bh={bh} "
              f"sq={sq} {dtype}")
        print(f"  bh={bh:3d} sq={sq:4d} {str(dtype)[6:]}: a second launch "
              "of the forward kernel agrees bit for bit")
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    check(torch.isfinite(out.float()).all().item()
          and torch.isfinite(lse).all().item(),
          f"non-finite kernel output sq={sq} sk={sk}")
    e_out = (out.float() - ref_out.float()).abs().max().item()
    e_lse = (lse - ref_lse).abs().max().item()
    if dtype == torch.float32:
        tol = FP32_TOL
    else:  # one bf16 ulp, plus a share of the output's scale
        tol = dict(rtol=BF16_RTOL, atol=BF16_ATOL_SHARE
                   * ref_out.float().abs().max().item())
    ok = (torch.allclose(out.float(), ref_out.float(), **tol)
          and torch.allclose(lse, ref_lse, **FP32_TOL))
    if not quiet or not ok:
        name = str(dtype).split(".")[-1]
        print(f"  bh={bh:3d} sq={sq:4d} sk={sk:4d} d={d:3d} "
              f"causal={causal!s:5} {name:8s} max|out err|={e_out:.3e} "
              f"max|lse err|={e_lse:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel disagrees with plain version at sq={sq} sk={sk} "
              f"d={d} causal={causal} {dtype}")
    return max(e_out, e_lse)


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
                continue  # seq_q != seq_k is checked non-causal here
            for dtype in (torch.float32, torch.bfloat16):
                errs[dtype] = max(errs[dtype], fwd_case(
                    fa, dev, gen, 12, sq, sk, causal, dtype))
    # the other head dims (at 32 and 128 the scale is not a power of two)
    for d in (16, 32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            errs[dtype] = max(errs[dtype], fwd_case(
                fa, dev, gen, 12, 200, 200, True, dtype, d))
    # ragged lengths around the tiles, every pair, causal with sq != sk
    lengths = (1, 17, 65, 712)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            worst = max(fwd_case(fa, dev, gen, 3, sq, sk, causal, dtype,
                                 quiet=True)
                        for sq in lengths for sk in lengths)
            errs[dtype] = max(errs[dtype], worst)
            print(f"  bh=  3 seq_q x seq_k in {lengths}^2 d= 64 "
                  f"causal={causal!s:5} {str(dtype)[6:]:8s} largest error "
                  f"{worst:.3e} ok")
    # a key tensor that does not start on 16 bytes is copied by the wrapper
    q, k, v = (torch.randn(2, 37, 16, device=dev, generator=gen)
               for _ in range(3))
    moved = torch.empty(k.numel() + 1, device=dev)[1:].view_as(k)
    moved.copy_(k)
    check(moved.data_ptr() % 16 != 0, "the misaligned view is aligned")
    same = all(torch.equal(a, b) for a, b in zip(
        fa.flash_attention_fwd(q, moved, v, True),
        fa.flash_attention_fwd(q, k, v, True)))
    check(same, "a misaligned key view changes the forward's result")
    print("  a key view off 16 bytes gives the aligned result bit for bit")
    # the training path's own shape (its grid spans all 96 heads), and two
    # launches there agree bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = max(errs[dtype], fwd_case(
            fa, dev, gen, TRAIN_BH, TRAIN_SEQ, TRAIN_SEQ, True, dtype,
            repeat=True))
    return errs


def bwd_case(fa, dev, gen, bh, sq, sk, causal, dtype, d=64, repeat=False):
    """One backward comparison: (max |dk, dv err|, max |dq err|); with
    ``repeat``, a second launch of each kernel must agree bit for bit."""
    q, k, v, do = (torch.randn(bh, n, d, device=dev, generator=gen)
                   .to(dtype) for n in (sq, sk, sk, sq))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    if repeat:
        again = (*fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             causal),
                 fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal))
        torch.cuda.synchronize()
        for name, a, b in zip(("dk", "dv", "dq"), (dk, dv, dq), again):
            check(torch.equal(a, b), f"a second launch of the {name} kernel "
                                     f"differs at bh={bh} sq={sq} {dtype}")
        print(f"  bh={bh:3d} sq={sq:4d} {str(dtype)[6:]}: a second launch "
              "of each backward kernel agrees bit for bit")
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(torch.isfinite(got.float()).all().item(),
              f"non-finite {name} bh={bh} sq={sq} sk={sk}")
        if dtype == torch.float32:
            tol = FP32_TOL
        else:  # one bf16 ulp, plus a share of the output's scale
            tol = dict(rtol=BF16_RTOL, atol=BF16_ATOL_SHARE
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
    # the other head dims (at 32 and 128 the scale is not a power of two)
    for d in (16, 32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            e_kv, e_q = bwd_case(fa, dev, gen, 12, 200, 200, True, dtype, d)
            errs["dkv"][dtype] = max(errs["dkv"][dtype], e_kv)
            errs["dq"][dtype] = max(errs["dq"][dtype], e_q)
    # the training path's own shape, and two launches of each kernel there
    # agree bit for bit (no atomics)
    for dtype in (torch.float32, torch.bfloat16):
        e_kv, e_q = bwd_case(fa, dev, gen, TRAIN_BH, TRAIN_SEQ, TRAIN_SEQ,
                             True, dtype, repeat=True)
        errs["dkv"][dtype] = max(errs["dkv"][dtype], e_kv)
        errs["dq"][dtype] = max(errs["dq"][dtype], e_q)
    return errs


def ln_inputs(dev, gen, n, d, p, dtype, mask_dtype=None, h_dtype=None,
              g_dtype=None):
    """Seeded (x, h, mask, gamma, beta, do) of one ln_residual case: x and
    do in ``dtype``, h in ``h_dtype``, gamma/beta in ``g_dtype`` and the
    keep mask in ``mask_dtype`` (each x's by default); the mask None at
    p = 0."""
    x, h, do = (torch.randn(n, d, device=dev, generator=gen).to(t)
                for t in (dtype, h_dtype or dtype, dtype))
    g_dtype = g_dtype or dtype
    gamma = (torch.rand(d, device=dev, generator=gen) + 0.5).to(g_dtype)
    beta = torch.randn(d, device=dev, generator=gen).to(g_dtype)
    mask = None
    if p > 0:
        keep = torch.rand(n, d, device=dev, generator=gen) >= p
        mask = keep.to(mask_dtype or dtype)
    return x, h, mask, gamma, beta, do


def ln_tol(name, got, want, flat, offset):
    """The tolerance of one ln_residual result, by its dtype (module
    docstring, phase 2c)."""
    top = want.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        return dict(rtol=BF16_RTOL, atol=BF16_ATOL_SHARE * top)
    if got.dtype == torch.float16:
        return dict(rtol=F16_RTOL, atol=F16_ATOL_SHARE * top)
    if name in ("dgamma", "dbeta") or (flat and name in ("dx", "dh")):
        return dict(rtol=LN_TOL["rtol"], atol=LN_SHARE * top)
    return LN_OFFSET_TOL if offset else LN_TOL


def ln_case(lr, dev, gen, n, d, p, dtype, mask_dtype=None, flat=False,
            offset=0.0, h_dtype=None, g_dtype=None, repeat=False):
    """One ln_residual comparison, kernels vs plain versions on the same
    inputs (the backward from the forward kernel's mean and rstd), with a
    random cotangent: (max |fwd err|, max |bwd err|). ``flat``: row 0 has
    zero variance; ``offset`` is added to x (rows far from zero);
    ``repeat``: both kernels run a second time and must give the same
    bits."""
    x, h, mask, gamma, beta, do = ln_inputs(dev, gen, n, d, p, dtype,
                                            mask_dtype, h_dtype, g_dtype)
    x += offset
    if flat:
        x[0], h[0] = 0.75, 0.0
    out, mean, rstd = lr.ln_residual_fwd(x, h, mask, gamma, beta, p)
    grads = lr.ln_residual_bwd(x, h, mask, gamma, mean, rstd, do, p)
    got = (out, mean, rstd) + tuple(grads)
    if repeat:
        again = lr.ln_residual_fwd(x, h, mask, gamma, beta, p) + tuple(
            lr.ln_residual_bwd(x, h, mask, gamma, mean, rstd, do, p))
    torch.cuda.synchronize()
    want_fwd = lr.ln_residual_fwd_reference(x, h, mask, gamma, beta, p)
    want_bwd = lr.ln_residual_bwd_reference(x, h, mask, gamma, mean, rstd,
                                            do, p)
    errs = []
    names = ("out", "mean", "rstd", "dx", "dh", "dgamma", "dbeta")
    what = (f"n={n} D={d} p={p} x {dtype} h {h.dtype} gamma {gamma.dtype} "
            f"mask {None if mask is None else mask.dtype}")
    for name, g, want in zip(names, got, want_fwd + want_bwd):
        check(g.dtype == want.dtype and g.shape == want.shape
              and torch.isfinite(g.float()).all().item(),
              f"ln_residual {name}: {g.dtype} {tuple(g.shape)} "
              f"non-finite or unlike the plain version's at {what}")
        err = (g.float() - want.float()).abs().max().item()
        check(torch.allclose(g.float(), want.float(),
                             **ln_tol(name, g, want, flat, offset)),
              f"ln_residual {name} kernel disagrees with plain version at "
              f"{what}: {err:.3e}")
        errs.append(err)
    if repeat:
        same = [torch.equal(a, b) for a, b in zip(got, again)]
        check(all(same), f"ln_residual: a second launch differs at {what}: "
                         f"{dict(zip(names, same))}")
    mname = "-" if mask is None else str(mask.dtype)[6:]
    mixed = "" if (h.dtype, gamma.dtype) == (dtype, dtype) else (
        f" h {str(h.dtype)[6:]} gamma {str(gamma.dtype)[6:]}")
    print(f"  n={n:5d} D={d:5d} p={p:.1f} {str(dtype)[6:]:8s} mask={mname:8s}"
          f"{mixed}{' flat row' if flat else ''}"
          f"{f' offset {offset:g}' if offset else ''}"
          f"{' repeat bit for bit' if repeat else ''} max|err| "
          f"out {errs[0]:.2e} mean {errs[1]:.2e} rstd {errs[2]:.2e} "
          f"dx {errs[3]:.2e} dh {errs[4]:.2e} dgamma {errs[5]:.2e} "
          f"dbeta {errs[6]:.2e} ok")
    return max(errs[:3]), max(errs[3:])


def phase_ln_vs_plain(dev):
    """The ln_residual forward and backward kernels against their plain
    versions on the card."""
    from mxnet_tpu_torch.ops import ln_residual as lr
    print("== phase 2c: ln_residual kernels vs plain versions", flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {k: {t: 0.0 for t in LN_DTYPES} for k in ("fwd", "bwd")}

    def run(dtype, *args, **kw):
        e_f, e_b = ln_case(lr, dev, gen, *args[:3], dtype, *args[3:], **kw)
        errs["fwd"][dtype] = max(errs["fwd"][dtype], e_f)
        errs["bwd"][dtype] = max(errs["bwd"][dtype], e_b)

    shapes = [(n, d) for n in (7, 600, LN_ROWS) for d in (128, 200, 768,
                                                         1024)]
    shapes += [(600, 199), (600, 1999), (600, 2000), (600, 8192)]
    masks = (None, torch.bool, torch.uint8, torch.float32, torch.bfloat16,
             torch.float16)  # None: x's dtype
    i = 0
    for n, d in shapes:
        for p in (0.0, LN_P):
            for dtype in LN_DTYPES:
                run(dtype, n, d, p, masks[i % len(masks)])
                i += 1
    for n, d in ((600, 768), (131, 200)):
        for x_t, h_t, g_t, m_t in LN_MIXED:
            run(x_t, n, d, LN_P, m_t, h_dtype=h_t, g_dtype=g_t)
    for dtype in (torch.float32, torch.bfloat16):
        run(dtype, 600, 768, LN_P, flat=True)
    run(torch.float32, 600, 768, LN_P, offset=100.0)
    for n, d in LN_REPEAT:
        for dtype in LN_DTYPES:
            run(dtype, n, d, LN_P, repeat=True)
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


def serve_run(eng, prompts, n_new=SERVE_NEW_TOKENS):
    """Submit every prompt (greedy, ``n_new`` tokens), run the engine to
    the end: (requests, synchronized wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def serve_profiled(label, eng, prompts, want_per_prefill,
                   n_new=SERVE_NEW_TOKENS):
    """The same prompts once more under ``torch.profiler`` (``n_new``
    tokens each; 1: the prefills alone, a shorter trace): (flash forward
    kernel events, device ms of every kernel and copy, full prefills run).
    A replayed graph runs no wrapper, so its kernels are counted as
    profiler events; a window short of ``want_per_prefill`` a full prefill
    (the profiler drops events now and then) is measured again, up to three
    windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for window in range(3):
        misses0 = eng.stats().get("prefix", {}).get("misses")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve_run(eng, prompts, n_new)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        flash = sum("flash_fwd" in e.name for e in events)
        device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        prefills = (len(prompts) if misses0 is None
                    else eng.stats()["prefix"]["misses"] - misses0)
        print(f"  {label}: profiled run {window + 1}: {flash} flash forward "
              f"kernel events, {prefills} full prefills, device "
              f"{device_ms:.2f} ms")
        if flash == want_per_prefill * prefills:
            break
    return flash, device_ms, prefills


def serve_e2e(st, wall, device_ms=None):
    """End-to-end serving numbers of one run from the engine's stats."""
    row = {"tokens_per_s": st["tokens_out"] / wall,
           "ttft_p50_ms": st["ttft"]["p50"] * 1e3,
           "ttft_p99_ms": st["ttft"]["p99"] * 1e3,
           "tpot_p50_ms": st["tpot"]["p50"] * 1e3,
           "wall_s": wall, "decode_steps": st["steps"]}
    if device_ms is not None:
        row["device_ms"] = device_ms
        row["device_busy_share"] = busy_share(device_ms, wall * 1e3)
    return row


def greedy_gap(net, dev, prompt, generated, vocab):
    """Tie-aware greedy check through the full forward: the largest gap
    between a generated token's logit and its row's maximum."""
    seq = list(prompt) + generated[:-1]
    with torch.no_grad():
        logits = net(torch.tensor([seq], device=dev))[0]
    check(logits.shape == (len(seq), vocab)
          and torch.isfinite(logits).all().item(),
          "full forward logits not finite / wrong shape")
    rows = logits[len(prompt) - 1:]
    chosen = rows.gather(1, torch.tensor(generated, device=dev)[:, None])
    return (rows.max(dim=1).values - chosen[:, 0]).max().item()


def same_or_tie(net, dev, prompt, a, b, vocab, label):
    """Two engines' greedy tokens for one prompt: equal, or equal up to a
    first difference where both tokens' logits in the full forward are
    within ``GREEDY_TOL`` of the row maximum (a tie that fp32 summation
    order may break either way). Returns the tie's gap (0 when equal)."""
    if a == b:
        return 0.0
    i = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
    with torch.no_grad():
        row = net(torch.tensor([list(prompt) + a[:i]], device=dev))[0, -1]
    top = row.max()
    gap = max((top - row[a[i]]).item(), (top - row[b[i]]).item())
    print(f"  {label}: tokens differ first at {i} ({a[i]} vs {b[i]}), gap "
          f"to the row max {gap:.3e}")
    check(gap <= GREEDY_TOL, f"{label}: tokens differ at {i} where the "
                             f"logits are {gap:.3e} apart (no tie)")
    return gap


def serve_net(dev, num_layers=N_LAYERS, seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, GPTModel
    return GPTForCausalLM(backbone=GPTModel(
        vocab_size=SERVE_VOCAB, units=768, hidden_size=3072,
        num_layers=num_layers, num_heads=12, max_length=1024, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=seed)


def serve_warmup(label, eng):
    """``warmup()`` (every graph captured), timed: (seconds, reserved GB)."""
    t0 = time.perf_counter()
    eng.warmup()
    sec = time.perf_counter() - t0
    st = eng.stats()
    reserved = torch.cuda.memory_reserved() / 1e9
    print(f"  {label}: warmup {sec:.2f} s, {st['compiles']} graphs "
          f"captured ({st['capture_seconds']:.2f} s with their warm-up "
          f"runs), reserved {reserved:.2f} GB")
    return sec, reserved


def phase_main_path(dev):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa
    print("== phase 3: ServeEngine over GPT-2 124M (full width), every "
          "step a CUDA graph", flush=True)
    net = serve_net(dev)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"parameters: {n_params} on {net.device}")
    eng = mx.serve.load(net, max_slots=8)
    warm_s, reserved = serve_warmup("fp32", eng)
    check(eng.compiles == 1 + len(eng.buckets),
          f"warmup built {eng.compiles} graphs, expected the decode step "
          f"and {len(eng.buckets)} prefill buckets")
    rs = onp.random.RandomState(0)
    lengths = prompt_lengths(rs, [b for b in eng.buckets if b <= 512],
                             SERVE_REQUESTS)
    check(max(lengths) > 256, "no prompt above 256 tokens")
    prompts = [rs.randint(0, SERVE_VOCAB, n) for n in lengths]
    print(f"prompt lengths: {lengths}")

    zero_counters(fa)
    reqs, wall = serve_run(eng, prompts)
    check(counters(fa) == [0, 0, 0],
          f"the graphed engine ran a kernel wrapper: {counters(fa)} (a "
          "replay runs none)")
    check(all(p.data().grad is None for p in net.collect_params().values()),
          "serving left a gradient behind")
    for r in reqs:
        check(r.finished and len(r.generated) == SERVE_NEW_TOKENS,
              f"request {r.id} finished={r.finished} with "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < SERVE_VOCAB for t in r.generated),
              f"request {r.id} produced an out-of-vocabulary token")
    st = eng.stats()
    launches, device_ms, _ = serve_profiled("fp32", eng, prompts, N_LAYERS)
    check(launches == N_LAYERS * len(prompts),
          f"flash kernel events {launches} in the serving run, expected "
          f"{N_LAYERS} x {len(prompts)} prefills")
    check(eng.post_warmup_compiles == 0,
          f"{eng.post_warmup_compiles} graphs captured after warmup")

    # tie-aware greedy check through the full forward
    for r in (reqs[0], max(reqs, key=lambda x: len(x.prompt))):
        gap = greedy_gap(net, dev, r.prompt, r.generated, SERVE_VOCAB)
        print(f"  greedy check request {r.id} (prompt {len(r.prompt)}): max "
              f"gap to row max {gap:.3e}")
        check(gap <= GREEDY_TOL, f"request {r.id}: a generated token is "
                                 f"{gap:.3e} below its row max")
    check(fa.flash_attention_fwd.launches == N_LAYERS * 2,
          "full forwards did not go through the flash kernel")

    calls = decode_launch_calls(eng, prompts)
    e2e = serve_e2e(st, wall, device_ms)
    e2e.update(warmup_s=warm_s, capture_s=st["capture_seconds"],
               graphs=st["compiles"],
               post_warmup_compiles=eng.post_warmup_compiles,
               reserved_gb_after_warmup=reserved,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               host_calls_per_decode_step=calls,
               flash_fwd_events=launches)
    print(f"served {st['completed']} requests, {st['tokens_out']} tokens, "
          f"{st['steps']} decode steps in {wall:.3f} s")
    return net, eng, e2e, reqs, prompts, launches


def decode_launch_calls(eng, prompts, steps=4):
    """Host runtime calls a decode step (``torch.profiler``'s CPU events:
    kernel and graph launches, copies, synchronizations) with every slot
    live and nothing queued, over ``steps`` steps."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(p, max_new_tokens=steps + 8)
            for p in prompts[:eng.max_slots]]
    eng.step()  # admits every request and runs one decode step
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.name.startswith(("cuda", "cu")) and e.name != "cudaDeviceSynchronize":
            counts[e.name] = counts.get(e.name, 0) + 1
    eng.run()
    check(all(r.finished for r in reqs), "launch-count requests unfinished")
    return {k: v / steps for k, v in sorted(counts.items())}


def phase_times(dev, net, eng, e2e, card):
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f"== phase 4: times on {card}", flush=True)
    caches = net.init_cache(eng.max_slots, eng.max_seq)
    tokens = torch.randint(0, SERVE_VOCAB, (eng.max_slots, 1), device=dev)
    positions = torch.arange(eng.max_slots, device=dev) * 100 + 50
    ids512 = torch.randint(0, SERVE_VOCAB, (1, eng.buckets[-1]), device=dev)
    programs = {
        "decode_step graph": lambda: eng._run("decode"),
        "decode_step eager": lambda: net.decode_step(tokens, caches,
                                                     positions),
        f"prefill_{eng.buckets[-1]} eager": lambda: net.prefill(
            ids512, caches, 0),
    }
    with torch.no_grad():
        # every slot is done: a replay advances nothing and rewrites rows
        # at or past each slot's position counter
        e2e["decode_ms_per_step"] = cuda_ms(programs["decode_step graph"],
                                            20)
        e2e["decode_ms_per_step_eager"] = cuda_ms(
            programs["decode_step eager"], 20)
        prefill, prefill_eager = {}, {}
        for b in eng.buckets:
            ids = torch.randint(0, SERVE_VOCAB, (1, b), device=dev)
            host = eng._pack_prefill(onp.zeros(b, dtype=onp.int64), b, 0, b,
                                     b)
            prefill[b] = cuda_ms(lambda: eng._run(("prefill", b), host), 5)
            prefill_eager[b] = cuda_ms(lambda: net.prefill(ids, caches, 0),
                                       5)
        e2e["prefill_ms"] = prefill
        e2e["prefill_ms_eager"] = prefill_eager
        print(f"end to end [{card}]: " + json.dumps(e2e))
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


def eager_decode_gap(net, eng, req):
    """The engine's tokens for ``req`` against an eager decode of the same
    model through the engine's own (dequantized) weights and cache layout
    (a fresh cache of the engine's slots and dtype, the prompt padded to
    its bucket in slot 0, then one decode step at a time, no graph): the
    largest gap between a generated token's logit and its row maximum."""
    from mxnet_tpu_torch import functional

    def call(method, *args):
        (out, _), _ = functional.functional_call(net, full, *args,
                                                 method=method)
        return out
    dev, n = eng.device, eng.max_slots
    with torch.no_grad():
        full = eng._full_params()
        cache = net.init_cache(n, eng.max_seq, dtype=eng.cache_dtype)
        length, bucket = len(req.prompt), eng.bucket_for(len(req.prompt))
        ids = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        ids[0, :length] = torch.tensor(req.prompt, device=dev)
        row = call("prefill", ids, cache, 0)[0, length - 1]
        tokens = torch.zeros((n, 1), dtype=torch.long, device=dev)
        positions = torch.zeros((n,), dtype=torch.long, device=dev)
        gap = 0.0
        for i, tok in enumerate(req.generated):
            gap = max(gap, (row.max() - row[tok]).item())
            tokens[0, 0], positions[0] = tok, length + i
            row = call("decode_step", tokens, cache, positions)[0]
    return gap


def phase_serve_quantized(dev, card, net, prompts, fp32):
    """Phase 3's mix under each quantize mode (phase 23)."""
    import mxnet_tpu_torch as mx
    print(f"== phase 23: quantized serving of GPT-2 124M on {card}",
          flush=True)
    out = {"fp32": {k: fp32[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
        "decode_ms_per_step")}}
    for mode in SERVE_QUANT_MODES:
        eng = mx.serve.load(net, max_slots=8, quantize=mode)
        warm_s, reserved = serve_warmup(mode, eng)
        reqs, wall = serve_run(eng, prompts)
        st = eng.stats()
        for r in reqs:
            check(r.finished and len(r.generated) == SERVE_NEW_TOKENS,
                  f"{mode}: request {r.id} finished={r.finished} with "
                  f"{len(r.generated)} tokens")
        ratio = st["weight_bytes"] / st["weight_bytes_fp"]
        weight = mode.split(",")[0]
        lo, hi = WEIGHT_RATIOS.get(weight, (1.0, 1.0))
        check(lo <= ratio <= hi, f"{mode}: weight_bytes / weight_bytes_fp "
                                 f"{ratio:.4f} outside [{lo}, {hi}]")
        if "int8_kv" in mode:
            (kq, ks), (vq, vs) = eng._cache[0]
            check(kq.dtype == vq.dtype == torch.int8
                  and ks.dtype == vs.dtype == torch.float32
                  and tuple(ks.shape) == tuple(kq.shape[:3]) + (1,),
                  f"{mode}: the cache is not int8 with fp32 (slot, row, "
                  f"head) scales")
        gaps = [eager_decode_gap(net, eng, r)
                for r in (reqs[0], max(reqs, key=lambda x: len(x.prompt)))]
        print(f"  {mode}: eager one-request decode through the same "
              f"weights and cache layout: max gaps {gaps}")
        check(max(gaps) <= GREEDY_TOL, f"{mode}: a generated token is "
                                       f"{max(gaps):.3e} below its row max")
        launches, _, _ = serve_profiled(mode, eng, prompts, N_LAYERS, 1)
        check(launches == N_LAYERS * len(prompts),
              f"{mode}: flash kernel events {launches}, expected "
              f"{N_LAYERS * len(prompts)}")
        check(eng.post_warmup_compiles == 0,
              f"{mode}: {eng.post_warmup_compiles} graphs captured after "
              "warmup")
        with torch.no_grad():
            decode_ms = cuda_ms(lambda: eng._run("decode"), 20)
        row = serve_e2e(st, wall)
        row.update(decode_ms_per_step=decode_ms, weight_bytes=st[
            "weight_bytes"], weight_bytes_fp=st["weight_bytes_fp"],
            weight_ratio=ratio, quantized_params=st["quantized_params"],
            cache_dtype=st["cache_dtype"], warmup_s=warm_s,
            reserved_gb_after_warmup=reserved, max_eager_gap=max(gaps),
            flash_fwd_events=launches)
        out[mode] = row
        print(f"serve {mode} [{card}]: " + json.dumps(row))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def prefix_prompts(rs, n=SERVE_REQUESTS):
    """``n`` prompts sharing one PREFIX_SHARED-token prefix, each followed
    by a 16-200-token suffix."""
    shared = rs.randint(0, SERVE_VOCAB, PREFIX_SHARED).tolist()
    return [shared + rs.randint(0, SERVE_VOCAB, rs.randint(16, 201)).tolist()
            for _ in range(n)]


def phase_serve_prefix(dev, card, net):
    """The radix prefix cache (phase 24)."""
    import mxnet_tpu_torch as mx
    print(f"== phase 24: the radix prefix cache on GPT-2 124M on {card}",
          flush=True)
    prompts = prefix_prompts(onp.random.RandomState(3))
    prev = mx.config.set("serve.prefix_block", PREFIX_BLOCK)
    try:
        runs = {}
        for on in (False, True):
            label = "prefix cache" if on else "cache off"
            eng = mx.serve.load(net, max_slots=8, prefix_cache=on)
            warm_s, _ = serve_warmup(label, eng)
            check(eng.compiles == (2 if on else 1) * len(eng.buckets) + 1,
                  f"{label}: {eng.compiles} graphs after warmup")
            reqs, wall = serve_run(eng, prompts)
            st = eng.stats()
            row = serve_e2e(st, wall)
            if on:
                pf = st["prefix"]
                check(pf["hits"] == len(prompts) - 1
                      and pf["tokens_reused"] == (len(prompts) - 1)
                      * PREFIX_SHARED,
                      f"prefix cache: {pf['hits']} hits, "
                      f"{pf['tokens_reused']} tokens reused, expected "
                      f"{len(prompts) - 1} and "
                      f"{(len(prompts) - 1) * PREFIX_SHARED}")
                row["prefix"] = pf
                for r, base in zip(reqs, runs["cache off"]["tokens"]):
                    same_or_tie(net, dev, r.prompt, r.generated, base,
                                SERVE_VOCAB, f"prefix cache request {r.id}")
                row["tokens_equal_cache_off"] = sum(
                    r.generated == b for r, b in
                    zip(reqs, runs["cache off"]["tokens"]))
            launches, _, prefills = serve_profiled(
                label, eng, prompts, N_LAYERS, 1)
            check(launches == N_LAYERS * prefills,
                  f"{label}: flash kernel events {launches}, expected "
                  f"{N_LAYERS} x {prefills} full prefills")
            check(eng.post_warmup_compiles == 0,
                  f"{label}: graphs captured after warmup")
            row.update(warmup_s=warm_s, graphs=eng.compiles,
                       profiled_run_full_prefills=prefills,
                       flash_fwd_events=launches)
            row["tokens"] = [r.generated for r in reqs]
            runs[label] = row
            print(f"serve {label} [{card}]: " + json.dumps(
                {k: v for k, v in row.items() if k != "tokens"}))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        mx.config.set("serve.prefix_block", prev)
    return prompts, runs


def phase_serve_spec(dev, card, net, prompts, base_reqs, pprompts, pruns):
    """Speculative decoding and weight swaps (phase 25)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import functional
    print(f"== phase 25: speculative decoding and weight swaps on GPT-2 124M "
          f"on {card}", flush=True)
    out = {}
    foreign = serve_net(dev, num_layers=2, seed=1)
    base = [r.generated for r in base_reqs]
    for label, draft, per_prefill in (("self draft", net, 2 * N_LAYERS),
                                      ("foreign draft", foreign,
                                       N_LAYERS + 2)):
        eng = mx.serve.load(net, max_slots=8, draft=draft)
        warm_s, _ = serve_warmup(label, eng)
        reqs, wall = serve_run(eng, prompts)
        st = eng.stats()
        for r, b in zip(reqs, base):
            check(len(r.generated) == SERVE_NEW_TOKENS,
                  f"{label}: request {r.id} has {len(r.generated)} tokens")
            same_or_tie(net, dev, r.prompt, r.generated, b, SERVE_VOCAB,
                        f"{label} request {r.id}")
        sp = st["spec"]
        if draft is net:
            check(sp["rounds"] < st["tokens_out"],
                  f"self draft: {sp['rounds']} rounds for "
                  f"{st['tokens_out']} tokens")
        launches, _, _ = serve_profiled(label, eng, prompts, per_prefill, 1)
        check(launches == per_prefill * len(prompts),
              f"{label}: flash kernel events {launches}, expected "
              f"{per_prefill * len(prompts)}")
        check(eng.post_warmup_compiles == 0,
              f"{label}: graphs captured after warmup")
        row = serve_e2e(st, wall)
        row.update(spec=sp, acceptance=eng.spec_acceptance, warmup_s=warm_s,
                   tokens_equal_plain=sum(r.generated == b
                                          for r, b in zip(reqs, base)),
                   flash_fwd_events=launches)
        out[label] = row
        print(f"serve {label} [{card}]: " + json.dumps(row))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del foreign

    prev = mx.config.set("serve.prefix_block", PREFIX_BLOCK)
    try:
        eng = mx.serve.load(net, max_slots=8, draft=net, prefix_cache=True)
        serve_warmup("prefix_and_spec_compose", eng)
        reqs, wall = serve_run(eng, pprompts)
        st = eng.stats()
        check(st["prefix"]["hits"] == len(pprompts) - 1,
              f"prefix_and_spec_compose: {st['prefix']['hits']} hits")
        for r, b in zip(reqs, pruns["cache off"]["tokens"]):
            same_or_tie(net, dev, r.prompt, r.generated, b, SERVE_VOCAB,
                        f"prefix_and_spec_compose request {r.id}")
        check(eng.post_warmup_compiles == 0,
              "prefix_and_spec_compose: graphs captured after warmup")
        row = serve_e2e(st, wall)
        row.update(prefix=st["prefix"], spec=st["spec"])
        out["prefix_and_spec_compose"] = row
        print(f"serve prefix_and_spec_compose [{card}]: " + json.dumps(row))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        mx.config.set("serve.prefix_block", prev)

    # weight swap: update -> run -> restore -> run, no new capture; each
    # run's tokens equal a fresh engine's over the same weights, bit for bit
    other = serve_net(dev, seed=2)
    fresh = mx.serve.load(other, max_slots=8).warmup()
    want_b, _ = serve_run(fresh, prompts)
    del fresh
    eng = mx.serve.load(net, max_slots=8).warmup()
    want_a, _ = serve_run(eng, prompts)
    graphs = eng.compiles
    eng.stop(drain=True)
    t0 = time.perf_counter()
    old = eng.update_weights({n: p.data() for n, p in
                              other.collect_params().items()})
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    eng.resume()
    got_b, _ = serve_run(eng, prompts)
    eng.restore_weights(old)
    got_a, _ = serve_run(eng, prompts)
    check([r.generated for r in got_b] == [r.generated for r in want_b],
          "weight swap: tokens under the new weights differ from a fresh "
          "engine's")
    check([r.generated for r in got_a] == [r.generated for r in want_a],
          "weight swap: tokens after restore_weights differ from the "
          "original weights' engine")
    check(eng.compiles == graphs and eng.post_warmup_compiles == 0,
          f"weight swap captured again: {eng.compiles - graphs} graphs")
    check([r.generated for r in want_a] != [r.generated for r in want_b],
          "weight swap: the two weight sets gave the same tokens")
    out["weight_swap"] = {"swap_s": swap_s, "graphs": graphs,
                          "new_captures": eng.compiles - graphs,
                          "tokens_equal_fresh_engines": True}
    print(f"weight swap [{card}]: " + json.dumps(out["weight_swap"]))
    del eng, other, old
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
        e2e["device_busy_share"] = busy_share(busy, step_ms)
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
                flops = fwd_flops(bh, s, s, d, True)
                bound_ms = functools.partial(flash_bound_ms, bh, s, s, d,
                                             True, dtype)
            else:
                flops = bwd_flops(kind, bh, s, s, d, True)
                bound_ms = functools.partial(bwd_bound_ms, kind, bh, s, s, d,
                                             True, dtype)
            row["bound_ms"], row["bound_by"] = bound_ms()
            if dtype == torch.float32:
                row["bound_3xtf32_ms"], row["bound_3xtf32_by"] = bound_ms(
                    tf32x3=True)
            rows[(kind, dtype)] = row
            print(f"{kind} {str(dtype)[6:]} causal bh={bh} s={s} d={d} "
                  f"[{card}]: " + json.dumps(row))
            ms = pick(row, "kernel")
            shares = {"bound": row["bound_ms"] / ms}
            if dtype == torch.float32:
                shares = {"fp32-SIMT bound (67 TFLOP/s)": shares["bound"],
                          "3xTF32 bound (3 x 495 TFLOP/s)":
                              row["bound_3xtf32_ms"] / ms}
            print(f"  {kind} {str(dtype)[6:]}: {flops / ms / 1e9:.1f} "
                  "TFLOP/s achieved; share of "
                  + ", ".join(f"{n} {v:.1%}" for n, v in shares.items()))
        del leaves, lib_out
    # the plain backward and SDPA's backward compute dq, dk and dv
    # together: both kernels of the pair are held against them
    for dtype in (torch.float32, torch.bfloat16):
        for key in ("plain_call_ms", "plain_device_ms", "library_call_ms",
                    "library_device_ms"):
            rows[("dq", dtype)][key] = rows[("dkv", dtype)][key]
    return rows


def ln_counters(lr):
    return [lr.ln_residual_fwd.launches, lr.ln_residual_bwd.launches]


def zero_ln_counters(lr):
    lr.ln_residual_fwd.launches = 0
    lr.ln_residual_bwd.launches = 0


def bert_batch(dev):
    """One fixed pretraining batch from RandomState(0): token ids with the
    MLM positions (15% of the valid ones) replaced by [MASK], two segments
    per row, valid lengths in 64..128, MLM labels and weights, NSP
    labels."""
    rs = onp.random.RandomState(0)
    b, s = BERT_BATCH, BERT_SEQ
    ids = rs.randint(1000, BERT_VOCAB, (b, s))
    valid = rs.randint(64, s + 1, b)
    pos = onp.arange(s)[None, :]
    split = rs.randint(8, valid - 8)[:, None]
    types = ((pos >= split) & (pos < valid[:, None])).astype("int64")
    weight = ((rs.rand(b, s) < 0.15) & (pos < valid[:, None]))
    labels = ids.copy()
    ids = onp.where(weight, BERT_MASK_ID, ids)
    nsp = rs.randint(0, 2, b)
    arrays = (ids, types, valid, labels, weight.astype("float32"), nsp)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def phase_bert(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import ln_residual as lr
    print(f"== phase 7: BERT-base pretraining (full width, batch "
          f"{BERT_BATCH} x seq {BERT_SEQ}, dropout 0.1, fp32; bf16/AMP is "
          f"not ported) on {card}", flush=True)
    net = BERTForPretraining(
        vocab_size=BERT_VOCAB, units=768, hidden_size=3072, num_layers=12,
        num_heads=12, max_length=512, dropout=0.1, embed_dropout=0.1,
        device=dev).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    start = {n: p.data().detach().clone() for n, p in params.items()}
    ids, types, valid, labels, weight, nsp = bert_batch(dev)
    mlm_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    print(f"parameters: {n_params} ({len(params)} tensors); adamw lr 1e-4 "
          f"wd 0.01; valid lengths {int(valid.min())}..{int(valid.max())}, "
          f"{int(weight.sum())} MLM positions; fused_ln_residual="
          f"{mx.config.get('fused_ln_residual')}")

    def fresh_start(mode):
        """Weights back to their start, a new trainer, seed 0."""
        mx.config.set("fused_ln_residual", mode)
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])
        mx.random.seed(0)
        return mx.gluon.Trainer(params, "adamw",
                                {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        with mx.autograd.record():
            mlm, nsp_scores = net(ids, types, valid)
            loss = mlm_loss(mlm, labels, weight) + nsp_loss(nsp_scores, nsp)
        mx.autograd.backward(loss)
        trainer.step(BERT_BATCH)
        return loss.detach().mean()

    trainer = fresh_start("auto")
    t0 = time.perf_counter()
    first = step().item()
    print(f"warm-up step: loss {first:.6f}, "
          f"{time.perf_counter() - t0:.2f} s")
    bad = [name for name, p in params.items()
           if not (torch.isfinite(p.grad()).all().item()
                   and p.grad().abs().max().item() > 0)]
    check(not bad, f"parameters without a finite, nonzero gradient after "
                   f"step 1: {bad[:6]} ({len(bad)} in all)")
    print(f"every one of the {len(params)} parameters has a finite, "
          "nonzero gradient after step 1")

    torch.cuda.reset_peak_memory_stats()
    zero_counters(fa)
    zero_ln_counters(lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ln_launches, fa_launches = ln_counters(lr), counters(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first] + [v.item() for v in losses]
    print(f"losses: {losses}")
    check(all(onp.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    want = N_LAYERS * BERT_STEPS
    check(ln_launches == [want] * 2,
          f"ln_residual launches {ln_launches} in {BERT_STEPS} steps, "
          f"expected {want} each (12 per step)")
    check(fa_launches == [0, 0, 0],
          f"flash kernels launched {fa_launches} times in the BERT step")
    print(f"launches in {BERT_STEPS} steps: ln_residual fwd/bwd "
          f"{ln_launches} (the attention residual of each of the 12 "
          f"post-norm cells; the FFN residual has p = 0, which 'auto' leaves "
          f"unfused); flash fwd/dkv/dq {fa_launches} (live attention dropout "
          f"and the valid-length mask take the plain composition)")
    step_ms = wall / BERT_STEPS * 1e3
    tokens = BERT_BATCH * BERT_SEQ
    e2e = {
        "step_ms": step_ms,
        "samples_per_s": BERT_BATCH * BERT_STEPS / wall,
        "tokens_per_s": tokens * BERT_STEPS / wall,
        "fp32_model_flop_share": 6 * n_params * tokens / (step_ms / 1e3)
        / PEAK_FLOPS[torch.float32],
        "peak_memory_gb": peak_gb,
        "launches_per_step": {"ln_residual_fwd": ln_launches[0]
                              // BERT_STEPS,
                              "ln_residual_bwd": ln_launches[1]
                              // BERT_STEPS,
                              "flash": [n // BERT_STEPS
                                        for n in fa_launches]},
    }
    print(f"BERT training end to end [{card}]: " + json.dumps(e2e))
    busy, top = device_profile(step, 2, warmup=0, top=10)
    if busy is None:
        print("device busy share not measured (profiler saw no kernels)")
    else:
        e2e["device_busy_share"] = busy_share(busy, step_ms)
        print(f"device time per step {busy:.3f} ms of {step_ms:.3f} ms "
              f"({busy / step_ms:.1%} busy); top kernels (ms per step): "
              + ", ".join(f"{n} {t:.3f}" for n, t in top))

    # the same start and seed under each routing of the residual: the
    # first three losses, then step times in turns (the step is partly
    # host-bound, so wall times spread) and device ms per step
    modes = ("off", "on", "auto")
    ab = {mode: {"step_ms": []} for mode in modes}
    for mode in modes:
        trainer = fresh_start(mode)
        head = [step().item() for _ in range(3)]
        rel = abs(head[0] - first) / abs(first)
        check(rel <= 1e-5, f"fused_ln_residual={mode}: first-step loss "
                           f"{head[0]} vs {first} under 'auto' ({rel:.2e} "
                           "relative)")
        ab[mode].update(first_losses=head, rel_diff_vs_auto=rel)
    for mode in modes + modes[::-1] + modes + modes[::-1]:
        mx.config.set("fused_ln_residual", mode)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        ab[mode]["step_ms"].append((time.perf_counter() - t0) / 3 * 1e3)
    for mode in modes:
        mx.config.set("fused_ln_residual", mode)
        ab[mode]["device_ms_per_step"] = device_profile(step, 2, warmup=1)[0]
        ab[mode]["step_ms_median"] = float(onp.median(ab[mode]["step_ms"]))
    mx.config.reset("fused_ln_residual")
    print(f"fused_ln_residual A/B, same weights and seed [{card}]: "
          + json.dumps(ab))
    e2e["fused_ln_residual_ab"] = ab
    return ln_launches, e2e


def ln_bound_ms(n, d, dtype, mask_dtype, kind):
    """Least time on an H100 SXM for one ln_residual call: each input read
    once and each output written once over the memory rate, against ~10
    (forward) or ~20 (backward) fp32 operations per element over the fp32
    rate (the arithmetic is fp32 for bf16 rows too)."""
    esize = torch.finfo(dtype).bits // 8
    msize = torch.finfo(mask_dtype).bits // 8
    rows = esize * n * d
    if kind == "fwd":  # x, h, m, gamma, beta -> out, mean, rstd
        nbytes = 3 * rows + msize * n * d + 2 * esize * d + 2 * 4 * n
        flops = 10 * n * d
    else:  # x, h, m, gamma, mean, rstd, do -> dx, dh, dgamma, dbeta
        nbytes = 5 * rows + msize * n * d + 3 * esize * d + 2 * 4 * n
        flops = 20 * n * d
    return bound(nbytes, flops, torch.float32)


def phase_ln_times(dev, card):
    """Each ln_residual kernel, its plain version and the unfused
    composition at the BERT shape, over three input sets taken in turn so
    that the working set exceeds the 50 MB L2."""
    import itertools
    from mxnet_tpu_torch.ops import ln_residual as lr
    print(f"== phase 8: ln_residual kernel times at n={LN_ROWS} D={LN_DIM} "
          f"p={LN_P} on {card}", flush=True)
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 1.0 / (1.0 - LN_P)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        sets = []
        for _ in range(3):
            x, h, m, g, b, do = ln_inputs(dev, gen, LN_ROWS, LN_DIM, LN_P,
                                          dtype)
            _, mean, rstd = lr.ln_residual_fwd(x, h, m, g, b, LN_P)
            leaves = [t.clone().requires_grad_() for t in (x, h, g, b)]
            comp = F.layer_norm(leaves[0] + leaves[1] * m * scale,
                                (LN_DIM,), leaves[2], leaves[3], 1e-5)
            sets.append((x, h, m, g, b, do, mean, rstd, leaves, comp))
        turn = itertools.cycle(sets)

        def call(fn):
            return lambda: fn(*next(turn))

        programs = {
            "fwd": {
                "kernel": call(lambda x, h, m, g, b, *_: lr.ln_residual_fwd(
                    x, h, m, g, b, LN_P)),
                "plain": call(lambda x, h, m, g, b, *_:
                              lr.ln_residual_fwd_reference(x, h, m, g, b,
                                                           LN_P)),
                "composition": call(lambda x, h, m, g, b, *_:
                                    F.layer_norm(x + h * m * scale, (LN_DIM,),
                                                 g, b, 1e-5)),
            },
            "bwd": {
                "kernel": call(lambda x, h, m, g, b, do, mean, rstd, *_:
                               lr.ln_residual_bwd(x, h, m, g, mean, rstd, do,
                                                  LN_P)),
                "plain": call(lambda x, h, m, g, b, do, mean, rstd, *_:
                              lr.ln_residual_bwd_reference(
                                  x, h, m, g, mean, rstd, do, LN_P)),
                "composition": call(
                    lambda x, h, m, g, b, do, mean, rstd, leaves, comp:
                    torch.autograd.grad(comp, leaves, do,
                                        retain_graph=True)),
            },
        }
        for kind, calls in programs.items():
            row = {}
            for name, fn in calls.items():
                row[name + "_call_ms"] = cuda_ms(fn, 30, warmup=3)
                row[name + "_device_ms"] = device_ms(fn, 30, warmup=3)
            # the kernel alone beside the whole call (kernel_device_ms):
            # one device kernel a call, no sum, cast or memset around it
            per_call, alone, seen = device_kernels(
                calls["kernel"], 30, f"ln_residual_{kind}_kernel")
            row["kernel_alone_device_ms"] = alone
            row["device_kernels_per_call"] = per_call
            row["profiled_events_per_call"] = seen
            row["bound_ms"], row["bound_by"] = ln_bound_ms(
                LN_ROWS, LN_DIM, dtype, dtype, kind)
            whole = row["kernel_device_ms"]
            row["bound_share"] = row["bound_ms"] / whole if whole else None
            check(per_call == 1, f"ln_residual_{kind} {dtype}: {per_call} "
                                 "device kernels a call, expected 1")
            rows[(kind, dtype)] = row
            print(f"ln_residual_{kind} {str(dtype)[6:]} n={LN_ROWS} "
                  f"D={LN_DIM} p={LN_P} [{card}]: " + json.dumps(row))
        del sets, turn
    return rows


def fp8_inputs(qm, dev, gen, m, n, k, fmt, overflow=False, wfmt=None,
               offset=False):
    """Seeded (x, w_q, ws, xs) of one fp8 matmul case: w quantized per
    output channel (in ``wfmt``, by default ``fmt``), xs mapping max |x|
    onto the format's top; with ``overflow`` two values of x past the top
    after x / xs; ``offset`` puts x 4 bytes into its buffer (contiguous,
    not 16-byte aligned)."""
    _, absmax = qm.FP8_FORMATS[fmt]
    wfmt = wfmt or fmt
    if offset:
        x = torch.randn(m * k + 1, device=dev, generator=gen)[1:].view(m, k)
    else:
        x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(n, k, device=dev, generator=gen) * 0.5
    ws = w.abs().amax(dim=1) / qm.FP8_FORMATS[wfmt][1]
    wq = qm.quantize(w / ws[:, None], wfmt)
    xs = x.abs().max().item() / absmax
    if overflow:
        x[0, 3] = 2.5 * absmax * xs
        x[-1, 0] = -70000.0 * xs
    return x, wq, ws, xs


def fp8_case(qm, dev, gen, m, n, k, fmt, act=None, bias=False,
             overflow=False, wfmt=None, offset=False, repeat=False):
    """The fp8 kernel against its plain version on the same inputs: (max
    |err| over the finite values, max err / sum of |products|); with
    ``repeat`` a second launch must agree bit for bit."""
    x, wq, ws, xs = fp8_inputs(qm, dev, gen, m, n, k, fmt, overflow, wfmt,
                               offset)
    b = torch.randn(n, device=dev, generator=gen) if bias else None
    out = qm.fp8_matmul(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    tag = (f"M={m} N={n} K={k} {fmt} x {wfmt or fmt} act={act} bias={bias}"
           + (" x+4 bytes" if offset else ""))
    if repeat:
        again = qm.fp8_matmul(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
              f"fp8_matmul {tag}: a second launch differs")
    torch.cuda.synchronize()
    ref = qm.fp8_matmul_plain(x, wq, ws, xs, bias=b, act=act, fmt=fmt)
    check(torch.equal(torch.isnan(out), torch.isnan(ref))
          and torch.equal(torch.isinf(out), torch.isinf(ref))
          and torch.equal(out[torch.isinf(out)], ref[torch.isinf(ref)]),
          f"fp8_matmul {tag}: NaN/inf positions differ from the plain "
          "version's")
    if overflow:
        check(not torch.isfinite(ref).all().item(),
              f"fp8_matmul {tag}: the overflow case overflowed nothing")
    fin = torch.isfinite(ref)
    mag = ((qm.quantize(x / xs, fmt).float().abs().nan_to_num(0, 0, 0)
            @ wq.float().abs().t()) * (xs * ws).abs())[fin]
    err = (out - ref).abs()[fin]
    ok = bool((err <= FP8_TOL_SHARE * mag + FP8_TOL_REL
               * ref[fin].abs()).all())
    e = err.max().item() if err.numel() else 0.0
    share = (err / mag.clamp_min(1e-30)).max().item() if err.numel() else 0.0
    print(f"  {tag}{' overflow' if overflow else ''}: max|err| {e:.3e}, "
          f"err/sum|products| {share:.2e} {'ok' if ok else 'FAIL'}"
          + (", a second launch bit for bit" if repeat else ""))
    check(ok, f"fp8_matmul kernel disagrees with its plain version at {tag}")
    return e, share


def phase_fp8_vs_plain(dev):
    """The fp8 matmul kernel against its plain version on the card."""
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print("== phase 2d: fp8_matmul kernel vs plain version", flush=True)
    check(qm.fp8_capable(dev), f"{torch.cuda.get_device_name(0)} is not "
                               "compute capability 9.0")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs, shares = [], []

    def run(*args, **kw):
        e, r = fp8_case(qm, dev, gen, *args, **kw)
        errs.append(e)
        shares.append(r)

    for m, n, k in ((1, 5, 100), (37, 130, 256), (130, 5, 100)):
        for fmt in ("e4m3", "e5m2"):
            for act in (None, "relu", "sigmoid", "tanh", "gelu"):
                for bias in (False, True):
                    run(m, n, k, fmt, act, bias)
    for fmt in ("e4m3", "e5m2"):
        for act in (None, "relu"):
            run(37, 130, 256, fmt, act, True, overflow=True)
    for m, n, k in FP8_RAGGED:
        run(m, n, k, "e4m3", "gelu", True)
    run(37, 130, 256, "e4m3", offset=True)
    run(8192, 768, 768, "e4m3", offset=True)
    for fmt, wfmt in (("e4m3", "e4m3"), ("e4m3", "e5m2"), ("e5m2", "e4m3"),
                      ("e5m2", "e5m2")):
        run(200, 300, 768, fmt, "gelu", True, wfmt=wfmt)
    for m, k, n in FP8_TRAIN_SHAPES:
        run(m, n, k, "e4m3", repeat=True)
    return {"max_abs_err": max(errs), "max_err_share": max(shares),
            "cases": len(errs)}


def fp8_counters(fa, qm):
    return [qm.fp8_matmul.launches] + counters(fa)


def zero_fp8_counters(fa, qm):
    qm.fp8_matmul.launches = 0
    zero_counters(fa)


def fp8_train_loss(logits, labels):
    from mxnet_tpu_torch.ops.xent import sparse_softmax_xent
    return sparse_softmax_xent(logits, labels).mean()


def fp8_train_steps(dev, lr=1e-3):
    """Phase 9's pair (also ``tools/fp8_loss_curves.py``'s): an fp8 and an
    fp32 ``ShardedTrainStep`` (``adam`` at ``lr``, ``MeshConfig(dp=1)``),
    each over its own GPT-2 124M from the same seeded weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    cfg = MeshConfig(dp=1)

    def make(precision):
        net = GPTForCausalLM(backbone=gpt2_124m(
            vocab_size=50257, max_length=TRAIN_SEQ, dropout=0.0,
            embed_dropout=0.0, device=dev)).initialize(seed=0)
        return ShardedTrainStep(
            net, fp8_train_loss, mx.optimizer.create("adam",
                                                     learning_rate=lr),
            cfg, cfg.batch_specs(2, 2), n_labels=1, precision=precision)

    return make("fp8"), make("fp32")


def fp8_train_batch(dev, shifted=False):
    """One fixed (x, y) from RandomState(0): drawn apart, as bench.py's
    fp8 row (bench.py:621-623), or y as x shifted by one token."""
    rs = onp.random.RandomState(0)
    if shifted:
        ids = rs.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ + 1))
        x, y = ids[:, :-1], ids[:, 1:]
    else:
        x, y = (rs.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ))
                for _ in range(2))
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_fp8_train(dev, card):
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print(f"== phase 9: fp8 training of GPT-2 124M (full width, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}) through ShardedTrainStep on "
          f"{card}", flush=True)
    loss_fn = fp8_train_loss
    s8, s32 = fp8_train_steps(dev)
    sites = s8._fp8_sites
    dense = [s for s in sites if "embed" not in s]
    embed = [s for s in sites if "embed" in s]
    check(len(dense) == FP8_SITES_PER_STEP and len(embed) == 2,
          f"{len(dense)} Dense sites and {len(embed)} embedding sites")
    check(all(torch.equal(s8.params[n], s32.params[n]) for n in s8.params),
          "the fp8 and fp32 steps do not start from the same weights")
    x, y = fp8_train_batch(dev)
    print(f"{len(s8.params)} trainable tensors, {len(sites)} fp8 sites "
          f"({len(dense)} Dense, {len(embed)} embeddings); adam lr 1e-3; "
          "one fixed batch from RandomState(0)")

    losses8, losses32, same_w, launches = [], [], [], [0, 0, 0, 0]
    for i in range(TRAIN_STEPS):
        # the fp32 forward of the fp8 step's own weights (no scope, no
        # graph): the fp8 numerics alone, free of the two trajectories'
        # divergence
        same_w.append(loss_fn(s8.block(x), y).item())
        zero_fp8_counters(fa, qm)
        torch.cuda.synchronize()
        losses8.append(s8(x, y).item())
        got = fp8_counters(fa, qm)
        check(got == [FP8_SITES_PER_STEP, N_LAYERS, N_LAYERS, N_LAYERS],
              f"fp8 step {i + 1} launched fp8/flash fwd/dkv/dq {got}, "
              f"expected [{FP8_SITES_PER_STEP}, 12, 12, 12]")
        launches = [a + b for a, b in zip(launches, got)]
        if i == 0:
            bad = [n for n, w in s8.params.items()
                   if w.grad is None or not torch.isfinite(w.grad).all()]
            check(not bad, f"parameters without a finite gradient after "
                           f"fp8 step 1: {bad[:6]} ({len(bad)} in all)")
            print(f"every one of the {len(s8.params)} trainable tensors "
                  "has a finite gradient after fp8 step 1")
        losses32.append(s32(x, y).item())
    print(f"fp8 step losses {losses8}\nfp32 step losses {losses32}\n"
          f"fp32 forward of the fp8 step's weights {same_w}")
    check(all(onp.isfinite(losses8 + losses32 + same_w)),
          "a loss is not finite")
    check(losses8[-1] < losses8[0], f"the fp8 loss did not fall: {losses8}")
    same = [abs(a - b) / abs(b) for a, b in zip(losses8, same_w)]
    parity = abs(losses8[-1] - losses32[-1]) / abs(losses32[-1])
    print(f"fp8 vs fp32 on the same weights, each step: "
          f"{[f'{v:.3e}' for v in same]} (limit {FP8_SAME_WEIGHTS_TOL}); "
          f"the two trajectories after {TRAIN_STEPS} steps: {parity:.4e} "
          "(reported: at adam lr 1e-3 without warm-up both trajectories "
          "spike within a few steps, at different steps)")
    check(max(same) <= FP8_SAME_WEIGHTS_TOL, f"fp8 loss vs the fp32 forward "
                                             f"of the same weights: {same}")
    hist = s8.extra["fp8"]
    for site in dense:
        for k, slots in (("x", TRAIN_STEPS), ("w", TRAIN_STEPS),
                         ("g", TRAIN_STEPS - 1)):
            check(bool((hist[site][k][:slots] > 0).all()),
                  f"{site} {k} history {hist[site][k][:TRAIN_STEPS]}")
    for site in embed:
        check(all(not h.any() for h in hist[site].values()),
              f"embedding site {site} has a nonzero history")
    g0 = sorted(s for s in dense if hist[s]["g"][TRAIN_STEPS - 1] == 0)
    # out_proj and ffn_2 take dy from the residual stream itself, so their
    # max |dy| is measured before any fp8 product can flush it
    check(all(s.split(".")[-2] in FP8_FLUSHABLE for s in g0),
          f"step 1's g amax is 0 at a site fed by the residual stream: "
          f"{[s for s in g0 if s.split('.')[-2] not in FP8_FLUSHABLE]}")
    print(f"{len(dense)} Dense sites hold nonzero x/w amaxes in slots "
          f"0-{TRAIN_STEPS - 1} and g in 0-{TRAIN_STEPS - 2}; the "
          f"{len(embed)} embedding sites hold zeros. Step 1's g amax is 0 at "
          f"{len(g0)} sites, whose dy reached them only through an fp8 "
          "backward product at the identity scale, where e5m2 flushes "
          f"|dy| < 2^-16 to zero: {g0[:4]}...")

    steps = {"fp8": lambda: s8(x, y), "fp32": lambda: s32(x, y)}
    times = {k: [] for k in steps}
    for name in ("fp8", "fp32", "fp32", "fp8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            steps[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 2 * 1e3)
    e2e = {"losses_fp8": losses8, "losses_fp32": losses32,
           "fp32_forward_of_fp8_weights": same_w,
           "same_weights_rel_diff": same, "trajectory_rel_diff": parity,
           "sites_with_zero_step1_g_amax": len(g0),
           "launches_per_step": {
               "fp8_matmul": launches[0] // TRAIN_STEPS,
               "flash": [n // TRAIN_STEPS for n in launches[1:]]}}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for name, fn in steps.items():
        step_ms = float(onp.median(times[name]))
        torch.cuda.reset_peak_memory_stats()
        busy, top = device_profile(fn, 2, warmup=1, top=12)
        row = {"step_ms": step_ms, "step_ms_runs": times[name],
               "tokens_per_s": tokens / step_ms * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "device_ms_per_step": busy,
               "device_busy_share": busy_share(busy, step_ms),
               "top_kernels_ms": top}
        e2e[name] = row
        print(f"{name} step [{card}]: " + json.dumps(row))
    return launches, e2e


def fp8_bound_ms(m, k, n):
    """Least time on an H100 SXM for one fp8 matmul: x (fp32) and w (fp8)
    read once, out (fp32) written once, against 2 M N K operations at the
    dense fp8 rate."""
    nbytes = 4 * m * k + n * k + 4 * n + 4 * m * n
    return bound(nbytes, 2 * m * n * k, torch.float8_e4m3fn)


def phase_fp8_times(dev, card):
    """The fp8 kernel, its plain version and the quantize -> _scaled_mm ->
    epilogue composition at the three training shapes."""
    import itertools
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print(f"== phase 10: fp8_matmul kernel times on {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    scaled_mm = getattr(torch, "_scaled_mm", None)
    one = torch.ones((), device=dev)
    rows = {}
    for m, k, n in FP8_TRAIN_SHAPES:
        sets = []
        for _ in range(3):
            x, wq, ws, xs = fp8_inputs(qm, dev, gen, m, n, k, "e4m3")
            sets.append((x, wq, ws, torch.tensor([xs], device=dev)))
        turn = itertools.cycle(sets)

        def call(fn):
            return lambda: fn(*next(turn))

        def composition(x, wq, ws, xs):
            xq = (x / xs).to(torch.float8_e4m3fn)
            acc = scaled_mm(xq, wq.t(), scale_a=one, scale_b=one,
                            out_dtype=torch.float32)
            return acc * (xs * ws)

        calls = {"kernel": call(qm.fp8_matmul),
                 "plain": call(qm.fp8_matmul_plain)}
        if scaled_mm is not None:
            calls["composition"] = call(composition)
        row = {}
        for name, fn in calls.items():
            iters = 5 if name == "plain" else 30
            row[name + "_call_ms"] = cuda_ms(fn, iters, warmup=3)
            row[name + "_device_ms"] = device_ms(fn, iters, warmup=3)
        if scaled_mm is None:
            row["composition_call_ms"] = row["composition_device_ms"] = None
        row["bound_ms"], row["bound_by"] = fp8_bound_ms(m, k, n)
        # the prepare pass (x quantized and widened, w widened) on its own
        row["prepare_device_ms"] = device_profile(
            calls["kernel"], 30, warmup=3, match="fp8_prepare")[0]
        ms = pick(row, "kernel")
        row["tflops"] = 2 * m * n * k / (ms * 1e-3) / 1e12
        row["share_of_bound"] = row["bound_ms"] / ms
        rows[(m, k, n)] = row
        print(f"fp8_matmul (M, K, N) = ({m}, {k}, {n}) e4m3 [{card}]: "
              + json.dumps(row))
        del sets, turn
    return rows


def int8_inputs(qm, dev, gen, m, k, n, offset=False):
    """Seeded (x, w_q, ws, xs, b) of one int8 matmul case: w quantized per
    output channel, xs a power of two near 0.8 max |x| / 127 (so that some
    values clip, and v * xs / xs == v for the planted ties), x with NaN,
    +-inf, a value past +-127 and exact .5 ties; ``offset`` puts x 4 bytes
    into its buffer (contiguous, not 16-byte aligned)."""
    buf = torch.randn(m * k + 1, device=dev, generator=gen)
    x = (buf[1:] if offset else buf[:-1]).view(m, k)
    w = torch.randn(n, k, device=dev, generator=gen) * 0.5
    ws = w.abs().amax(dim=1) / 127
    wq = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
    xs = 2.0 ** round(float(torch.log2(x.abs().max() * 0.8 / 127)))
    ties = torch.tensor([0.5, 1.5, 2.5, -2.5, -0.5, 126.5], device=dev)
    x[0, :6] = ties * xs
    x[-1, -1] = float("nan")
    x[m // 2, 0] = float("inf")
    x[0, -1] = -float("inf")
    x[-1, 0] = 300.0 * xs
    b = torch.randn(n, device=dev, generator=gen)
    return x, wq, ws, xs, b


def int8_case(qm, dev, gen, m, k, n, act=None, bias=False, offset=False,
              repeat=False):
    """The int8 kernel against its plain version on the same inputs:
    max |err|. With ``repeat`` a second launch must give the same bits."""
    x, wq, ws, xs, b = int8_inputs(qm, dev, gen, m, k, n, offset)
    b = b if bias else None
    out = qm.quantized_matmul(x, wq, ws, xs, bias=b, act=act)
    torch.cuda.synchronize()
    if repeat:
        again = qm.quantized_matmul(x, wq, ws, xs, bias=b, act=act)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
              f"int8_matmul M={m} K={k} N={n}: a second launch gave other "
              "bits")
    ref = qm.quantized_matmul_plain(x, wq, ws, xs, bias=b, act=act)
    tag = (f"M={m} K={k} N={n} act={act} bias={bias}"
           f"{' offset x' if offset else ''}"
           f"{' (second launch: equal bits)' if repeat else ''}")
    check(torch.equal(out.isnan(), ref.isnan()),
          f"int8_matmul {tag}: NaN positions differ from the plain version's")
    fin = ~ref.isnan()
    err = (out - ref)[fin].abs()
    e = err.max().item() if err.numel() else 0.0
    if act in (None, "relu"):
        ok = torch.equal(out[fin], ref[fin])
    else:
        ok = torch.allclose(out[fin], ref[fin], **INT8_ACT_TOL)
    print(f"  {tag}: max|err| {e:.3e} "
          f"{'bit for bit' if e == 0 else ''} {'ok' if ok else 'FAIL'}")
    check(ok, f"int8_matmul kernel disagrees with its plain version at {tag}")
    return e


def phase_int8_vs_plain(dev):
    """The int8 matmul kernel against its plain version on the card."""
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print("== phase 2e: int8_matmul kernel vs plain version", flush=True)
    gen = torch.Generator(device=dev).manual_seed(8)
    errs = []
    for m, k, n, offset in ((1, 100, 5, False), (37, 256, 130, False),
                            (130, 100, 5, False), (64, 200, 70, False),
                            (37, 256, 130, True)):
        for act in (None, "relu", "sigmoid", "tanh", "gelu"):
            for bias in (False, True):
                errs.append(int8_case(qm, dev, gen, m, k, n, act, bias,
                                      offset))
    # the GEMM's tile edges at both tile widths
    try:
        for bn in (128, 192):
            qm.quantized_matmul.tile_n = bn
            print(f"  tile 128 x {bn}:")
            for m, k, n in INT8_RAGGED:
                for act, bias in ((None, True), ("gelu", False)):
                    errs.append(int8_case(qm, dev, gen, m, k, n, act, bias,
                                          repeat=True))
    finally:
        qm.quantized_matmul.tile_n = 0
    for (m, k, n) in INT8_BERT_SHAPES:
        act = "tanh" if m == BERT_BATCH else None
        errs.append(int8_case(qm, dev, gen, m, k, n, act, True,
                              repeat=True))
    return {"max_abs_err": max(errs), "cases": len(errs)}


def int8_counters(fa, lr, qm):
    return ([qm.quantized_matmul.launches] + counters(fa) + ln_counters(lr)
            + [qm.fp8_matmul.launches])


def zero_int8_counters(fa, lr, qm):
    qm.quantized_matmul.launches = 0
    qm.fp8_matmul.launches = 0
    zero_counters(fa)
    zero_ln_counters(lr)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_bert_int8(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import ln_residual as lr
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print(f"== phase 11: BERT-base int8 inference through quantize_net (full "
          f"width, batch {BERT_BATCH} x seq {BERT_SEQ}) on {card}", flush=True)
    net = bert_12_768_12(vocab_size=BERT_VOCAB, max_length=512,
                         device=dev).initialize(seed=0)
    rs = onp.random.RandomState(1)
    calib = [torch.from_numpy(rs.randint(1000, BERT_VOCAB,
                                         (BERT_BATCH, BERT_SEQ))).to(dev)
             for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qnet = cq.quantize_net(net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    n_q = sum(isinstance(b, cq.QuantizedDense) for b in qnet.modules())
    n_dense = sum(isinstance(b, nn.Dense) for b in net.modules())
    check(n_q == INT8_LAYERS and n_dense == INT8_LAYERS
          and not any(isinstance(b, nn.Dense) for b in qnet.modules())
          and not any(isinstance(b, cq.QuantizedDense)
                      for b in net.modules()),
          f"quantize_net replaced {n_q} layers (the net keeps {n_dense} "
          f"Dense), expected {INT8_LAYERS}")
    pooler = qnet.pooler
    print(f"quantize_net (naive, 2 calibration batches): {n_q} QuantizedDense "
          f"layers in {t_quant:.2f} s; the fp32 net keeps its {n_dense} Dense; "
          f"pooler act fused: {pooler._fused_act}, T={pooler.threshold:.5g}")
    ids, types, valid = bert_batch(dev)[:3]

    zero_int8_counters(fa, lr, qm)
    torch.cuda.synchronize()
    seq, pooled = qnet(ids, types, valid)
    torch.cuda.synchronize()
    got = int8_counters(fa, lr, qm)
    want = [INT8_LAYERS, 0, 0, 0, 0, 0, 0]
    check(got == want, f"int8 forward launched int8/flash fwd/dkv/dq/"
                       f"ln fwd/bwd/fp8 {got}, expected {want}")
    launches = got[0]
    check(seq.shape == (BERT_BATCH, BERT_SEQ, BERT_UNITS)
          and pooled.shape == (BERT_BATCH, BERT_UNITS)
          and torch.isfinite(seq).all().item()
          and torch.isfinite(pooled).all().item(),
          f"int8 outputs {tuple(seq.shape)}, {tuple(pooled.shape)} not "
          "finite or of the wrong shape")
    mx.config.set("quantize.fused_matmul", "off")
    try:
        seq_off, pooled_off = qnet(ids, types, valid)
    finally:
        mx.config.reset("quantize.fused_matmul")
    torch.cuda.synchronize()
    check(qm.quantized_matmul.launches == INT8_LAYERS,
          "the 'off' route launched the int8 kernel")
    seq_same = torch.equal(seq, seq_off)
    pooled_err = (pooled - pooled_off).abs().max().item()
    print(f"kernel route vs the plain chain on the card: sequence output "
          f"{'bit for bit' if seq_same else 'DIFFERS'}, pooled max|err| "
          f"{pooled_err:.3e}")
    check(seq_same, "the int8 kernel route's sequence output is not the "
                    "plain chain's bit for bit")
    check(torch.allclose(pooled, pooled_off, **INT8_ACT_TOL),
          f"pooled output off the plain chain's by {pooled_err:.3e}")
    seq32, pooled32 = net(ids, types, valid)
    err = {"sequence": rel_err(seq, seq32), "pooled": rel_err(pooled,
                                                              pooled32)}
    print(f"int8 vs fp32, max|diff| / max|fp32|: {json.dumps(err)} (limits "
          f"{json.dumps(INT8_VS_FP32_TOL)})")
    check(all(err[k] <= INT8_VS_FP32_TOL[k] for k in err),
          f"int8 vs fp32 error {err} above {INT8_VS_FP32_TOL}")

    fwd = {"fp32": lambda: net(ids, types, valid),
           "int8": lambda: qnet(ids, types, valid)}
    wall = {k: [] for k in fwd}
    for name in ("fp32", "int8", "int8", "fp32"):
        fwd[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fwd[name]()
        torch.cuda.synchronize()
        wall[name].append((time.perf_counter() - t0) / 3 * 1e3)
    e2e = {"quantize_net_s": t_quant, "int8_vs_fp32_rel_err": err,
           "pooled_kernel_vs_plain_err": pooled_err,
           "launches_per_forward": {"int8_matmul": launches, "flash": got[1:4],
                                    "ln_residual": got[4:6],
                                    "fp8_matmul": got[6]}}
    for name, fn in fwd.items():
        ms = float(onp.median(wall[name]))
        torch.cuda.reset_peak_memory_stats()
        event_ms = cuda_ms(fn, 5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy, top = device_profile(fn, 3, warmup=1, top=8)
        row = {"forward_ms": ms, "forward_ms_runs": wall[name],
               "forward_event_ms": event_ms,
               "samples_per_s": BERT_BATCH / ms * 1e3,
               "device_ms": busy,
               "device_busy_share": busy_share(busy, ms),
               "peak_memory_gb": peak, "top_kernels_ms": top}
        e2e[name] = row
        print(f"BERT-base {name} forward [{card}]: " + json.dumps(row))
    e2e["weights_gb"] = {name: sum(
        p.data().numel() * p.data().element_size()
        for p in n.collect_params().values()) / 1e9
        for name, n in (("fp32", net), ("int8", qnet))}
    print(f"both nets are resident on the card, and each peak counts both: "
          f"weights {json.dumps(e2e['weights_gb'])} GB")
    return launches, e2e


def int8_bound_ms(m, k, n):
    """Least time on an H100 SXM for one int8 matmul: x (fp32) read, w
    (int8), w_scale and bias (fp32) read, out (fp32) written, against 2 M N
    K operations at the dense int8 rate."""
    nbytes = 4 * m * k + n * k + 8 * n + 4 * m * n
    return bound(nbytes, 2 * m * n * k, torch.int8)


def phase_int8_times(dev, card):
    """The int8 kernel, its plain version and the quantize_int8 ->
    torch._int_mm -> epilogue composition at the BERT-base shapes."""
    import itertools
    from mxnet_tpu_torch.ops import quant_matmul as qm
    print(f"== phase 12: int8_matmul kernel times on {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    for (m, k, n) in INT8_BERT_SHAPES:
        act = "tanh" if m == BERT_BATCH else None
        sets = []
        for _ in range(3):
            x = torch.randn(m, k, device=dev, generator=gen)
            w = torch.randn(n, k, device=dev, generator=gen) * 0.05
            ws = w.abs().amax(dim=1) / 127
            wq = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
            xs = torch.tensor([x.abs().max().item() / 127], device=dev)
            b = torch.randn(n, device=dev, generator=gen)
            sets.append((x, wq, ws, xs, b))
        turn = itertools.cycle(sets)

        def call(fn):
            return lambda: fn(*next(turn))

        def kernel(x, wq, ws, xs, b):
            return qm.quantized_matmul(x, wq, ws, xs, bias=b, act=act)

        def plain(x, wq, ws, xs, b):
            return qm.quantized_matmul_plain(x, wq, ws, xs, bias=b, act=act)

        def composition(x, wq, ws, xs, b):
            acc = torch._int_mm(qm.quantize_int8(x, xs), wq.t())
            out = acc * (xs * ws) + b
            return out if act is None else torch.tanh(out)

        calls = {"kernel": call(kernel), "plain": call(plain)}
        try:
            composition(*sets[0])
            calls["composition"] = call(composition)
        except RuntimeError as e:  # a yardstick only: record that it refused
            print(f"  torch._int_mm refuses (M, K, N) = ({m}, {k}, {n}): "
                  f"{str(e).splitlines()[0][:120]}")
        row = {}
        for name, fn in calls.items():
            iters = 5 if name == "plain" else 30
            row[name + "_call_ms"] = cuda_ms(fn, iters, warmup=3)
            row[name + "_device_ms"] = device_ms(fn, iters, warmup=3)
        if "composition" not in calls:
            row["composition_call_ms"] = row["composition_device_ms"] = None
        row["bound_ms"], row["bound_by"] = int8_bound_ms(m, k, n)
        # the prepare pass (x quantized once) and the GEMM apart
        for part in ("prepare", "gemm"):
            row[part + "_device_ms"] = device_profile(
                calls["kernel"], 30, warmup=3, match=f"int8_{part}")[0]
        ms = pick(row, "kernel")
        row["tops"] = 2 * m * n * k / (ms * 1e-3) / 1e12
        row["share_of_bound"] = row["bound_ms"] / ms
        rows[(m, k, n)] = row
        print(f"int8_matmul (M, K, N) = ({m}, {k}, {n}) act={act} bias "
              f"[{card}]: " + json.dumps(row))
        del sets, turn
    return rows


# -- kernel 8 and the ResNet-50 phases ----------------------------------------

CONV_COUNTS = ("calls", "wsplit", "dgrad", "dgrad_reduce", "wgrad",
               "wgrad_reduce")


def conv_counters(cb):
    """[wrapper calls, then launches of wsplit, dgrad, dgrad_reduce, wgrad,
    wgrad_reduce] of kernel 8."""
    k = cb.fused_conv3x3_bn_relu_bwd.kernel_launches
    return [cb.fused_conv3x3_bn_relu_bwd.launches] + [k[n] for n in
                                                      CONV_COUNTS[1:]]


def conv_launches_per_call(cb, n, h, w, c, o):
    """Kernel 8's launches in one call at this shape on this card, by the
    wrapper's own split rules: [1, wsplit, dgrad, dgrad_reduce, wgrad,
    wgrad_reduce]."""
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    dsplits, _ = cb.dgrad_splits(n, h, w, c, o, sm)
    splits, _ = cb.wgrad_splits(n, h, w, c, o, sm)
    return [1, 1, 1, int(dsplits > 1), 1, int(splits > 1)]


def zero_conv_counters(cb):
    cb.fused_conv3x3_bn_relu_bwd.launches = 0
    cb.fused_conv3x3_bn_relu_bwd.bf16_launches = 0
    cb.fused_conv3x3_bn_relu_bwd.shape_launches.clear()
    for name in cb.fused_conv3x3_bn_relu_bwd.kernel_launches:
        cb.fused_conv3x3_bn_relu_bwd.kernel_launches[name] = 0


def other_counters():
    """Launches of kernels 1-7: flash fwd/dkv/dq, ln fwd/bwd, fp8, int8."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import ln_residual as lr
    from mxnet_tpu_torch.ops import quant_matmul as qm
    return (counters(fa) + ln_counters(lr) + [qm.fp8_matmul.launches,
                                              qm.quantized_matmul.launches])


def zero_all_counters():
    from mxnet_tpu_torch.ops import conv_bwd as cb
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import ln_residual as lr
    from mxnet_tpu_torch.ops import quant_matmul as qm
    zero_int8_counters(fa, lr, qm)
    zero_conv_counters(cb)


def conv_inputs(cb, dev, gen, n, h, w, c, o, dtype=torch.float32):
    """(da, x, y, w, gamma, beta, mean, var) of one fused triplet: He-scaled
    weights, the training forward's y and batch statistics; x, w, gamma,
    beta and da drawn in fp32 and cast to ``dtype`` (the triplet's dtype
    under ``amp.init``), y from the forward in that dtype."""
    x = torch.randn(n, c, h, w, device=dev, generator=gen)
    wt = torch.randn(o, c, 3, 3, device=dev, generator=gen) \
        * (2.0 / (9 * c)) ** 0.5
    gamma = torch.rand(o, device=dev, generator=gen) + 0.5
    beta = torch.randn(o, device=dev, generator=gen) * 0.1
    x, wt, gamma, beta = (t.to(dtype) for t in (x, wt, gamma, beta))
    _, y, mean, var = cb.conv3x3_bn_relu_ref(x, wt, gamma, beta)
    da = torch.randn(n, o, h, w, device=dev, generator=gen).to(dtype)
    return da, x, y, wt, gamma, beta, mean, var


def bf16_excess(got, want, share):
    """The largest |got - want| over its allowance, 2^-7 |want| (one bf16
    ulp) plus ``share`` of max|want|, compared in fp32: at most 1 passes."""
    got, want = got.float(), want.float()
    allow = BF16_RTOL * want.abs() + share * want.abs().max()
    return ((got - want).abs() / allow).max().item()


def conv_non_finite_inputs(cb, dev, gen, nan_at, dtype=torch.float32):
    """Phase 2f's non-finite case: finite inputs and their forward, then an
    inf in x (a border pixel), a -inf in w and, where ``nan_at`` is "live"
    or "dead", a NaN in da where the ReLU passes or blocks it."""
    args = list(conv_inputs(cb, dev, gen, *CONV_NON_FINITE, dtype=dtype))
    da, x, y, wt, gamma, beta, mean, var = args
    x[1, 3, 0, 2] = float("inf")
    wt[0, 3, 2, 1] = -float("inf")
    if nan_at is not None:
        z = (y - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
        z = z * gamma[:, None, None] + beta[:, None, None]
        at = torch.nonzero((z > 0) == (nan_at == "live"))[0]
        da[tuple(at.tolist())] = float("nan")
    return args


def phase_conv_vs_plain(dev):
    """Kernel 8 against its plain version on the card."""
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print("== phase 2f: conv3x3_bn_relu_bwd kernel (kernel 8) vs plain "
          "version", flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = {"dx": 0.0, "dw": 0.0}
    max_abs = 0.0
    cases = [(n, h, w, c, c) for (n, h, w, c) in CONV_STAGES] + CONV_EDGES
    lib = _native.load("conv_bwd", cb._bind)
    for (n, h, w, c, o) in cases:
        # the shared memory and wgrad's chunk the source computes, against
        # the wrapper's own rule (fits_card decides by the latter)
        dsm, wsm = ctypes.c_size_t(), ctypes.c_size_t()
        pr, pc = ctypes.c_int(), ctypes.c_int()
        lib.conv3x3_bn_relu_bwd_smem(h, w, dsm, wsm, pr, pc)
        got = ((dsm.value, wsm.value), (pr.value, pc.value))
        want = (cb.smem_bytes(h, w), cb.wgrad_patch(h, w))
        check(got == want, f"kernel 8 at H={h} W={w}: the source's shared "
                           f"memory and patch {got}, the wrapper's {want}")
        sets = 3 if n == RESNET_BATCH else 1
        for s in range(sets):
            args = conv_inputs(cb, dev, gen, n, h, w, c, o)
            dx, dw, dg, db = cb.fused_conv3x3_bn_relu_bwd(*args)
            again = cb.fused_conv3x3_bn_relu_bwd(*args)
            torch.cuda.synchronize()
            da, x, y, wt, gamma, beta, mean, var = args
            pg, pb, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
            pdx, pdw = cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)
            e = {"dx": rel_err(dx, pdx), "dw": rel_err(dw, pdw)}
            same = all(torch.equal(a, b) for a, b in zip(again, (dx, dw, dg,
                                                                db)))
            stats = torch.equal(dg, pg) and torch.equal(db, pb)
            finite = all(torch.isfinite(t).all().item() for t in (dx, dw))
            ok = (max(e.values()) <= CONV_TOL and same and stats and finite)
            print(f"  N={n} H={h} W={w} C={c} O={o} set {s} (wgrad chunk "
                  f"{want[1][0]}x{want[1][1] or 64}): max|diff| / "
                  f"max|plain| dx {e['dx']:.3e} dw {e['dw']:.3e}; dgamma/"
                  f"dbeta {'bit for bit' if stats else 'DIFFER'}; repeat "
                  f"{'bit for bit' if same else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel 8 disagrees with its plain version at N={n} "
                      f"H={h} W={w} C={c} O={o}: {e}, repeat equal {same}, "
                      f"stats equal {stats}, finite {finite}")
            for k in worst:
                worst[k] = max(worst[k], e[k])
            max_abs = max(max_abs, (dx - pdx).abs().max().item(),
                          (dw - pdw).abs().max().item())
            del args, dx, dw, again, pdx, pdw
    # inf in x and w, NaN in da: the NaN and inf positions (and the signs of
    # the infs) of dx, dw, dgamma and dbeta are the plain version's
    for nan_at in (None, "live", "dead"):
        args = conv_non_finite_inputs(cb, dev, gen, nan_at)
        got = cb.fused_conv3x3_bn_relu_bwd(*args)
        torch.cuda.synchronize()
        da, x, y, wt, gamma, beta, mean, var = args
        pg, pb, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
        want = cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec) + (pg,
                                                                       pb)
        counts = []
        for name, g, r in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
            same = (torch.equal(g.isnan(), r.isnan())
                    and torch.equal(g.isinf(), r.isinf())
                    and torch.equal(g[g.isinf()].sign(), r[r.isinf()].sign()))
            counts.append(f"{name} {int(g.isnan().sum())} NaN "
                          f"{int(g.isinf().sum())} inf")
            check(same, f"kernel 8's non-finite {name} (NaN in da: {nan_at}) "
                        f"differs from the plain version's: "
                        f"{int(g.isnan().sum())} / {int(r.isnan().sum())} "
                        f"NaN, {int(g.isinf().sum())} / "
                        f"{int(r.isinf().sum())} inf")
        finite = torch.isfinite(got[0]) & torch.isfinite(want[0])
        e = (rel_err(got[0][finite], want[0][finite]) if finite.any()
             else 0.0)  # a NaN the ReLU passes reaches every dx
        print(f"  non-finite inputs (inf in x and w, NaN in da: {nan_at}) "
              f"{CONV_NON_FINITE}: {', '.join(counts)}, the plain version's "
              f"positions; finite dx max|diff| / max|plain| {e:.3e}")
        check(e <= CONV_TOL, f"kernel 8's finite dx off by {e:.3e} beside "
                             f"non-finite inputs")
    bf16 = conv_bf16_vs_plain(dev, cb, lib, gen)
    return {"max_rel_err": worst, "max_abs_err": max_abs,
            "cases": len(cases) + 2 * len(CONV_STAGES) + 3, "bf16": bf16}


def conv_bf16_vs_plain(dev, cb, lib, gen):
    """Kernel 8's bf16 instantiation against its plain version on the same
    bf16 inputs: the four stage shapes (two input sets each) and
    ``CONV_EDGES``, dx and dw elementwise within one bf16 ulp plus
    ``CONV_BF16_SHARE`` of max|plain|, dgamma/dbeta bit for bit, a second
    launch bit for bit; the shared memory the source computes equal to the
    wrapper's rule; then the non-finite inputs with the plain version's
    NaN and inf positions."""
    print("  bf16 instantiation:", flush=True)
    cases = [(n, h, w, c, c) for (n, h, w, c) in CONV_STAGES] + CONV_EDGES
    worst, max_abs, excess = {"dx": 0.0, "dw": 0.0}, 0.0, 0.0
    before = cb.fused_conv3x3_bn_relu_bwd.bf16_launches
    for (n, h, w, c, o) in cases:
        dsm, wsm = ctypes.c_size_t(), ctypes.c_size_t()
        lib.conv3x3_bn_relu_bwd_bf16_smem(h, w, dsm, wsm)
        got = (dsm.value, wsm.value)
        want = cb.smem_bytes(h, w, torch.bfloat16)
        check(got == want, f"kernel 8 bf16 at H={h} W={w}: the source's "
                           f"shared memory {got}, the wrapper's {want}")
        for s in range(2 if n == RESNET_BATCH else 1):
            args = conv_inputs(cb, dev, gen, n, h, w, c, o, torch.bfloat16)
            dx, dw, dg, db = cb.fused_conv3x3_bn_relu_bwd(*args)
            again = cb.fused_conv3x3_bn_relu_bwd(*args)
            torch.cuda.synchronize()
            da, x, y, wt, gamma, beta, mean, var = args
            pg, pb, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
            pdx, pdw = cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)
            ex = max(bf16_excess(dx, pdx, CONV_BF16_SHARE),
                     bf16_excess(dw, pdw, CONV_BF16_SHARE))
            e = {"dx": rel_err(dx.float(), pdx.float()),
                 "dw": rel_err(dw.float(), pdw.float())}
            same = all(torch.equal(a, b) for a, b in zip(again, (dx, dw, dg,
                                                                db)))
            stats = torch.equal(dg, pg) and torch.equal(db, pb)
            types = (dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16)
            finite = all(torch.isfinite(t).all().item() for t in (dx, dw))
            ok = ex <= 1.0 and same and stats and types and finite
            print(f"  bf16 N={n} H={h} W={w} C={c} O={o} set {s}: max|diff|"
                  f" / max|plain| dx {e['dx']:.3e} dw {e['dw']:.3e}, "
                  f"largest diff over its allowance {ex:.3f}; dgamma/dbeta "
                  f"{'bit for bit' if stats else 'DIFFER'}; repeat "
                  f"{'bit for bit' if same else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel 8 bf16 disagrees with its plain version at "
                      f"N={n} H={h} W={w} C={c} O={o}: {e}, over the "
                      f"allowance x{ex:.3f}, repeat equal {same}, stats "
                      f"equal {stats}, dtypes {dx.dtype} {dw.dtype}, finite "
                      f"{finite}")
            for k in worst:
                worst[k] = max(worst[k], e[k])
            excess = max(excess, ex)
            max_abs = max(max_abs, (dx.float() - pdx.float()).abs().max()
                          .item(), (dw.float() - pdw.float()).abs().max()
                          .item())
            del args, dx, dw, again, pdx, pdw
    launched = cb.fused_conv3x3_bn_relu_bwd.bf16_launches - before
    check(launched == 2 * (2 * len(CONV_STAGES) + len(CONV_EDGES)),
          f"the bf16 kernel launched {launched} times in its checks")
    for nan_at in (None, "live", "dead"):
        args = conv_non_finite_inputs(cb, dev, gen, nan_at, torch.bfloat16)
        got = cb.fused_conv3x3_bn_relu_bwd(*args)
        torch.cuda.synchronize()
        da, x, y, wt, gamma, beta, mean, var = args
        pg, pb, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
        want = cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec) + (pg,
                                                                       pb)
        counts = []
        for name, g, r in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
            same = (torch.equal(g.isnan(), r.isnan())
                    and torch.equal(g.isinf(), r.isinf())
                    and torch.equal(g[g.isinf()].sign(), r[r.isinf()].sign()))
            counts.append(f"{name} {int(g.isnan().sum())} NaN "
                          f"{int(g.isinf().sum())} inf")
            check(same, f"kernel 8 bf16's non-finite {name} (NaN in da: "
                        f"{nan_at}) differs from the plain version's: "
                        f"{int(g.isnan().sum())} / {int(r.isnan().sum())} "
                        f"NaN, {int(g.isinf().sum())} / "
                        f"{int(r.isinf().sum())} inf")
        finite = torch.isfinite(got[0]) & torch.isfinite(want[0])
        ex = (bf16_excess(got[0][finite], want[0][finite], CONV_BF16_SHARE)
              if finite.any() else 0.0)
        print(f"  bf16 non-finite inputs (NaN in da: {nan_at}): "
              f"{', '.join(counts)}, the plain version's positions; finite "
              f"dx over its allowance {ex:.3f}")
        check(ex <= 1.0, f"kernel 8 bf16's finite dx off by x{ex:.3f} of its "
                         f"allowance beside non-finite inputs")
    return {"max_rel_err": worst, "max_abs_err": max_abs,
            "max_excess_over_allowance": excess,
            "cases": 2 * len(CONV_STAGES) + len(CONV_EDGES) + 3}


def conv_bound_ms(n, h, w, c, o, tf32x3=False, dtype=torch.float32):
    """Least time on an H100 SXM for kernel 8's work on one triplet: da, y
    and x read once, w read, dx and dw written (in ``dtype``; the (8, O)
    stats vector fp32), against 36 M C O flops (dgrad and wgrad, 9 taps
    each, M = N H W) at ``dtype``'s rate (fp32 67, bf16 989 TFLOP/s), or
    with ``tf32x3`` at the rate the fp32 kernels use: three TF32 products
    per product at 495 TFLOP/s."""
    m = n * h * w
    if dtype == torch.bfloat16:
        nbytes = 2 * (2 * m * o + 2 * m * c + 2 * 9 * c * o) + 4 * 8 * o
        return bound(nbytes, 36 * m * c * o, torch.bfloat16)
    nbytes = 4 * (2 * m * o + 2 * m * c + 2 * 9 * c * o + 8 * o)
    if tf32x3:
        return bound(nbytes, 3 * 36 * m * c * o, torch.float32,
                     rate=PEAK_TF32)
    return bound(nbytes, 36 * m * c * o, torch.float32)


def resnet_batch(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE, device=dev,
                    generator=gen)
    y = torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), device=dev,
                      generator=gen)
    return x, y


def phase_resnet_train(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print(f"== phase 13: ResNet-50 v1 training (full width, batch "
          f"{RESNET_BATCH} x 3 x {RESNET_SIZE} x {RESNET_SIZE}, "
          f"{RESNET_CLASSES} classes, fp32, "
          f"SGD lr 0.05 momentum 0.9) on {card}", flush=True)
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev).initialize(seed=0)
    x, y = resnet_batch(dev)
    t0 = time.perf_counter()
    net(x)  # finishes the deferred shapes (inference: no statistics update)
    torch.cuda.synchronize()
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values()
                   if p.grad_req != "null")
    triplets = sum(isinstance(b, nn.FusableSequential)
                   for b in net.modules())
    print(f"deferred shapes finished in {time.perf_counter() - t0:.2f} s: "
          f"{len(params)} parameter tensors, {n_params} trainable values, "
          f"{triplets} bottleneck bodies")
    start = {n: p.data().detach().clone() for n, p in params.items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def start_grads(inp):
        """The "off" route's gradients from the start weights on ``inp``."""
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])
        mx.config.set("fused_conv_bn", "off")
        try:
            with mx.autograd.record():
                loss = loss_fn(net(inp), y)
            mx.autograd.backward(loss)
        finally:
            mx.config.reset("fused_conv_bn")
        return {n: p.grad().clone() for n, p in params.items()
                if p.grad_req != "null"}

    def run(mode):
        """From the start weights: a warm-up step (its gradients kept), then
        the timed steps with every count zeroed just before."""
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])
        mx.config.set("fused_conv_bn", mode)
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                                   "momentum": 0.9})

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            return loss.detach().mean()

        try:
            zero_all_counters()
            first = step().item()
            torch.cuda.synchronize()
            warm = conv_counters(cb)
            grads = {n: p.grad().clone() for n, p in params.items()
                     if p.grad_req != "null"}
            stats = {n: p.data().detach().clone() for n, p in params.items()
                     if "running" in n}
            torch.cuda.reset_peak_memory_stats()
            zero_all_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step() for _ in range(RESNET_STEPS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, others = conv_counters(cb), other_counters()
            shapes = dict(cb.fused_conv3x3_bn_relu_bwd.shape_launches)
            peak = torch.cuda.max_memory_allocated() / 1e9
            busy, top = device_profile(step, 2, warmup=0, top=8)
        finally:
            mx.config.reset("fused_conv_bn")
        losses = [first] + [v.item() for v in losses]
        return dict(first_step_launches=warm, grads=grads, stats=stats,
                    losses=losses, wall=wall, launches=launches,
                    shapes=shapes, others=others, peak=peak, busy=busy,
                    top=top)

    # kernel 8's calls and launches a step under "auto", by stage
    per_step = [0] * len(CONV_COUNTS)
    for stage, triplets in RESNET_STAGE_TRIPLETS.items():
        per_call = conv_launches_per_call(cb, *stage, stage[-1])
        per_step = [a + triplets * b for a, b in zip(per_step, per_call)]
    runs = {}
    for mode in ("auto", "off", "off", "auto"):
        r = run(mode)
        want = ([k * RESNET_STEPS for k in per_step] if mode == "auto"
                else [0] * len(CONV_COUNTS))
        want_shapes = ({(n, h, w, c, c): t * RESNET_STEPS for (n, h, w, c), t
                        in RESNET_STAGE_TRIPLETS.items()}
                       if mode == "auto" else {})
        print(f"{mode}: losses {r['losses']}; kernel 8 calls / wsplit / "
              f"dgrad / dgrad reduce / wgrad / wgrad reduce launches in "
              f"{RESNET_STEPS} steps {r['launches']}; calls by (N, H, W, C, "
              f"O) {r['shapes']}; kernels 1-7 {r['others']}")
        check(r["launches"] == want,
              f"'{mode}': kernel 8 calls and launches {r['launches']} in "
              f"{RESNET_STEPS} steps, expected {want}")
        check(r["shapes"] == want_shapes,
              f"'{mode}': kernel 8 calls by (N, H, W, C, O) {r['shapes']} in "
              f"{RESNET_STEPS} steps, expected {want_shapes}")
        check(r["first_step_launches"] == [w // RESNET_STEPS
                                           for w in want],
              f"'{mode}': warm-up step launched kernel 8 "
              f"{r['first_step_launches']}")
        check(not any(r["others"]), f"'{mode}': kernels 1-7 launched "
                                    f"{r['others']}, expected none")
        check(all(onp.isfinite(r["losses"])) and r["losses"][-1]
              < r["losses"][0], f"'{mode}': the loss is not finite or did "
                                f"not fall: {r['losses']}")
        if mode in runs:
            runs[mode]["wall_runs"].append(r["wall"])
            runs[mode]["grads2"] = r["grads"]
        else:
            r["wall_runs"] = [r["wall"]]
            runs[mode] = r
    auto, off = runs["auto"], runs["off"]
    # a conv bias that feeds a BatchNorm over batch statistics has a zero
    # gradient in exact arithmetic (the mean removes it): both routes give
    # fp32 noise there, so its difference is held against the scale of the
    # same conv's weight gradient
    zero_bias = {}
    for path, m in net.named_modules():
        if isinstance(m, nn.HybridSequential):
            kids = list(m._modules.items())
            for (k, a), (_, b) in zip(kids, kids[1:]):
                if (isinstance(a, nn.Conv2D) and a.bias is not None
                        and isinstance(b, nn.BatchNorm)):
                    zero_bias[f"{path}.{k}.bias"] = f"{path}.{k}.weight"
    # the conditioning probe: the "off" route's step-1 gradients from the
    # same weights on the batch moved by one fp32 rounding (x * (1 +- 2^-24))
    probes = []
    for seed in range(RESNET_PROBES):
        sign = torch.randint(0, 2, x.shape, device=dev, generator=torch.
                             Generator(device=dev).manual_seed(100 + seed))
        probes.append(start_grads(x * (1 + (2 * sign - 1) * 2.0 ** -24)))
    rows = []
    for n, g in off["grads"].items():
        scale = (off["grads"][zero_bias[n]] if n in zero_bias
                 else g).abs().max().item()
        d = {"auto_vs_off": (auto["grads"][n] - g).abs().max().item(),
             "off_vs_off": (off["grads2"][n] - g).abs().max().item(),
             "auto_vs_auto": (auto["grads2"][n]
                              - auto["grads"][n]).abs().max().item(),
             "probe": max((pg[n] - g).abs().max().item() for pg in probes)}
        floor = max(d["probe"], d["off_vs_off"])
        limit = max(RESNET_GRAD_TOL * scale, 2 * floor)
        rows.append((d["auto_vs_off"] / scale, n, {k: v / scale for k, v
                                                   in d.items()},
                     d["auto_vs_off"] <= limit,
                     d["auto_vs_off"] <= RESNET_GRAD_TOL * scale))
    rows.sort(key=lambda r: -r[0])
    strict = sum(r[4] for r in rows)
    print(f"step-1 gradients, 'auto' (kernel 8) vs 'off' (cuDNN chain), "
          f"max|diff| / max|off| per parameter: {strict} of {len(rows)} "
          f"within {RESNET_GRAD_TOL}; the largest (with the conditioning "
          f"probe, off vs off and auto vs auto on the same scale):")
    for ratio, n, d, ok, _ in rows[:8]:
        print(f"  {n}: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + ("" if ok else "  FAIL"))
    bad = [r[1] for r in rows if not r[3]]
    check(not bad, f"step-1 gradients of {bad[:4]} ({len(bad)} in all) off "
                   f"by more than {RESNET_GRAD_TOL} of max|off| and twice "
                   "the conditioning probe")
    worst = rows[0][0]
    # the wiring under a tight limit: the same fused forward with autograd's
    # backward (cuDNN's conv and torch's BatchNorm backward) in place of
    # kernel 8, so the two routes share every forward value and part only
    # by the backward's summation order
    ref_cbr = cb.FusedCBRFunction

    class AutogradCBR:
        @staticmethod
        def apply(inp, w, gamma, beta, eps):
            a, _, mean, var = cb.conv3x3_bn_relu_ref(inp, w, gamma, beta, eps)
            return a, mean.detach(), var.detach()

    with torch.no_grad():
        for n, p in params.items():
            p.data().copy_(start[n])
    zero_all_counters()
    cb.FusedCBRFunction = AutogradCBR
    try:
        with mx.autograd.record():
            ref_loss = loss_fn(net(x), y)
        mx.autograd.backward(ref_loss)
    finally:
        cb.FusedCBRFunction = ref_cbr
    torch.cuda.synchronize()
    check(conv_counters(cb)[0] == 0 and not any(other_counters()),
          f"the autograd route launched kernel 8 {conv_counters(cb)} or "
          f"kernels 1-7 {other_counters()}")
    wiring = {}
    for n, g in auto["grads"].items():
        ref = params[n].grad()
        scale = (params[zero_bias[n]].grad() if n in zero_bias
                 else ref).abs().max().item()
        wiring[n] = (g - ref).abs().max().item() / scale
    wired = sorted(wiring, key=lambda n: -wiring[n])
    same_loss = ref_loss.mean().item() == auto["losses"][0]
    print(f"step-1 gradients, 'auto' (kernel 8) vs the same fused forward "
          f"with autograd's backward, max|diff| / max|ref| per parameter: "
          f"largest {wiring[wired[0]]:.3e} ({wired[0]}), "
          f"{sum(v <= RESNET_WIRING_TOL for v in wiring.values())} of "
          f"{len(wiring)} within {RESNET_WIRING_TOL}; step-1 losses "
          f"{'equal' if same_loss else 'DIFFER'}")
    check(wiring[wired[0]] <= RESNET_WIRING_TOL,
          f"step-1 gradients of {wired[:4]} off the autograd route's by "
          f"{[wiring[n] for n in wired[:4]]}, more than {RESNET_WIRING_TOL}")
    stat_err = max(rel_err(auto["stats"][n], v) for n, v in
                   off["stats"].items())
    print(f"running statistics after step 1, 'auto' vs 'off': largest "
          f"max|diff| / max|off| {stat_err:.3e} (limit {RESNET_STAT_TOL})")
    check(stat_err <= RESNET_STAT_TOL, f"running statistics differ by "
                                       f"{stat_err:.3e}")
    e2e = {"step1_grad_rel_err": worst,
           "step1_grad_within_tol": [strict, len(rows)],
           "step1_grad_vs_autograd_rel_err": wiring[wired[0]],
           "step1_grad_worst": {r[1]: r[2] for r in rows[:4]},
           "running_stats_rel_err": stat_err, "parameters": n_params}
    for mode, r in runs.items():
        step_ms = [w / RESNET_STEPS * 1e3 for w in r["wall_runs"]]
        ms = float(onp.median(step_ms))
        row = {"step_ms": ms, "step_ms_runs": step_ms,
               "images_per_s": RESNET_BATCH / ms * 1e3,
               "fp32_model_flop_share": RESNET_BATCH * RESNET50_TRAIN_FLOPS
               / (ms / 1e3) / PEAK_FLOPS[torch.float32],
               "device_ms": r["busy"],
               "device_busy_share": busy_share(r["busy"], ms),
               "peak_memory_gb": r["peak"], "losses": r["losses"],
               "kernel8_launches_per_step": dict(zip(
                   CONV_COUNTS, [n // RESNET_STEPS for n in r["launches"]])),
               "kernel8_calls_per_step_by_shape": {
                   "N={} H={} W={} C={} O={}".format(*k): v / RESNET_STEPS
                   for k, v in r["shapes"].items()},
               "top_kernels_ms": r["top"]}
        e2e[mode] = row
        print(f"ResNet-50 training '{mode}' [{card}]: " + json.dumps(row))
    e2e["launches"] = auto["launches"][0]
    per_shape = {k: v // RESNET_STEPS for k, v in auto["shapes"].items()}
    del start, runs
    return e2e, per_shape


def phase_conv_times(dev, card):
    """Kernel 8 (its CUDA kernels and the whole wrapper), its plain version
    and the cuDNN composition at the four ResNet-50 stage shapes, fp32 and
    bf16 (the bf16 composition: a bf16 convolution, BatchNorm with fp32
    gamma and beta, relu)."""
    import itertools
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print(f"== phase 14: conv3x3_bn_relu_bwd (kernel 8) times on {card}",
          flush=True)
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    for (n, h, w, c), dtype in itertools.product(
            CONV_STAGES, (torch.float32, torch.bfloat16)):
        sets = [conv_inputs(cb, dev, gen, n, h, w, c, c, dtype)
                for _ in range(3)]
        graphs = []
        for da, x, y, wt, gamma, beta, mean, var in sets:
            leaves = [t.clone().requires_grad_() for t in (
                x, wt, gamma.float(), beta.float())]
            out = F.relu(F.batch_norm(
                F.conv2d(leaves[0], leaves[1], padding=1), None, None,
                leaves[2], leaves[3], training=True, eps=1e-5))
            graphs.append((out, leaves, da))
        turn = itertools.cycle(range(3))

        def call(fn):
            return lambda: fn(next(turn))

        def kernel(i):
            return cb.fused_conv3x3_bn_relu_bwd(*sets[i])

        def plain(i):
            da, x, y, wt, gamma, beta, mean, var = sets[i]
            _, _, vec = cb.bwd_stats(da, y, gamma, beta, mean, var)
            return cb.fused_conv3x3_bn_relu_bwd_plain(da, x, y, wt, vec)

        def composition(i):
            out, leaves, da = graphs[i]
            return torch.autograd.grad(out, leaves, da, retain_graph=True)

        row = {}
        for name, fn in (("kernel", kernel), ("plain", plain),
                         ("composition", composition)):
            iters = 5 if name == "plain" else 20
            row[name + "_call_ms"] = cuda_ms(call(fn), iters, warmup=3)
            row[name + "_device_ms"] = device_ms(call(fn), iters, warmup=1)
        row["cuda_kernels_ms"] = device_profile(call(kernel), 20, warmup=2,
                                                match="conv_bwd_")[0]
        row["bound_ms"], row["bound_by"] = conv_bound_ms(n, h, w, c, c,
                                                         dtype=dtype)
        if dtype == torch.float32:
            row["bound_3xtf32_ms"], row["bound_3xtf32_by"] = conv_bound_ms(
                n, h, w, c, c, tf32x3=True)
            rows[(n, h, w, c)] = row
        else:
            rows[(n, h, w, c, "bf16")] = row
        print(f"kernel 8 N={n} H={h} W={w} C=O={c} {str(dtype)[6:]} "
              f"[{card}]: " + json.dumps(row))
        del sets, graphs, turn
    return rows


def phase_resnet_int8(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print(f"== phase 15: ResNet-50 v1 int8 inference through quantize_net "
          f"(full width, batch {RESNET_BATCH} x 3 x {RESNET_SIZE} x "
          f"{RESNET_SIZE}) on {card}",
          flush=True)
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev).initialize(seed=0)
    calib = torch.from_numpy(onp.random.RandomState(0).rand(
        RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype("float32")).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qnet = cq.quantize_net(net, calib_data=[calib], calib_mode="naive")
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    n_conv = sum(isinstance(b, cq.QuantizedConv) for b in qnet.modules())
    n_dense = sum(isinstance(b, cq.QuantizedDense) for b in qnet.modules())
    kept = (sum(isinstance(b, nn.Conv2D) for b in net.modules()),
            sum(isinstance(b, nn.Dense) for b in net.modules()))
    print(f"quantize_net (naive, 1 calibration batch): {n_conv} "
          f"QuantizedConv and {n_dense} QuantizedDense in {t_quant:.2f} s; "
          f"the fp32 net keeps {kept[0]} Conv2D and {kept[1]} Dense")
    check(n_conv == INT8_RESNET_CONVS and n_dense == 1
          and kept == (INT8_RESNET_CONVS, 1)
          and not any(isinstance(b, (nn.Conv2D, nn.Dense))
                      for b in qnet.modules()),
          f"quantize_net gave {n_conv} QuantizedConv and {n_dense} "
          f"QuantizedDense (the net keeps {kept}), expected "
          f"{INT8_RESNET_CONVS} and 1")
    # a second batch from the calibration's distribution (bench.py's
    # normal batch would fall outside the calibrated ranges at the stem)
    x = torch.from_numpy(onp.random.RandomState(1).rand(
        RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype("float32")).to(dev)
    zero_all_counters()
    torch.cuda.synchronize()
    out = qnet(x)
    torch.cuda.synchronize()
    got = other_counters() + conv_counters(cb)
    want = [0, 0, 0, 0, 0, 0, 1] + [0] * len(CONV_COUNTS)
    check(got == want, f"int8 forward launched flash fwd/dkv/dq, ln "
                       f"fwd/bwd, fp8, int8, kernel 8 {got}, expected {want}")
    check(out.shape == (RESNET_BATCH, RESNET_CLASSES)
          and torch.isfinite(out).all().item(),
          f"int8 output {tuple(out.shape)} not finite or of the wrong shape")
    mx.config.set("quantize.fused_matmul", "off")
    try:
        out_off = qnet(x)
    finally:
        mx.config.reset("quantize.fused_matmul")
    torch.cuda.synchronize()
    same = torch.equal(out, out_off)
    print(f"kernel route vs the plain chain on the card: "
          f"{'bit for bit' if same else 'DIFFERS'}")
    check(same, "the int8 kernel route's output is not the plain chain's "
                "bit for bit")
    out32 = net(x)
    err = rel_err(out, out32)
    agree = (out.argmax(-1) == out32.argmax(-1)).float().mean().item()
    print(f"int8 vs fp32: max|diff| / max|fp32| {err:.4f}; top-1 agreement "
          f"{agree:.3f}")
    # windows of RESNET_FWD_ITERS forwards in turns, each timed on the host
    # clock and by CUDA events around the same calls
    fwd = {"fp32": lambda: net(x), "int8": lambda: qnet(x)}
    wall = {k: [] for k in fwd}
    event = {k: [] for k in fwd}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in ("fp32", "int8", "int8", "fp32", "fp32", "int8"):
        fwd[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(RESNET_FWD_ITERS):
            fwd[name]()
        end.record()
        torch.cuda.synchronize()
        wall[name].append((time.perf_counter() - t0) / RESNET_FWD_ITERS
                          * 1e3)
        event[name].append(start.elapsed_time(end) / RESNET_FWD_ITERS)
    e2e = {"quantize_net_s": t_quant, "int8_vs_fp32_rel_err": err,
           "top1_agreement": agree, "launches_per_forward": got}
    for name, fn in fwd.items():
        ms = float(onp.median(wall[name]))
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy, top = device_profile(fn, 2, warmup=1, top=8)
        row = {"forward_ms": ms, "forward_ms_runs": wall[name],
               "forward_event_ms": float(onp.median(event[name])),
               "forward_event_ms_runs": event[name],
               "images_per_s": RESNET_BATCH / ms * 1e3, "device_ms": busy,
               "device_busy_share": busy_share(busy, ms),
               "peak_memory_gb": peak, "top_kernels_ms": top}
        e2e[name] = row
        print(f"ResNet-50 {name} forward [{card}]: " + json.dumps(row))
    e2e["launches"] = got[6]
    return e2e


# -- the bf16 training paths (phases 16-18) -----------------------------------

def all_launches():
    """Every kernel wrapper's count: flash fwd/dkv/dq, ln fwd/bwd, fp8,
    int8, kernel 8 fp32 calls and kernel 8 bf16 calls."""
    from mxnet_tpu_torch.ops import conv_bwd as cb
    c = cb.fused_conv3x3_bn_relu_bwd
    return other_counters() + [c.launches - c.bf16_launches, c.bf16_launches]


LAUNCH_NAMES = ("flash_fwd", "flash_dkv", "flash_dq", "ln_fwd", "ln_bwd",
                "fp8", "int8", "conv_fp32", "conv_bf16")


def kernel_events(fn, iters, names, warmup=1):
    """{name: device events a call of the kernels whose names contain
    ``name``}, from ``torch.profiler``: the kernels' own events (the
    profiler drops some now and then, so these can read low; the wrapper
    counts are the ones held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return {n: sum(n in e for e in events) / iters for n in names}


def bf16_e2e(card, label, wall, steps, n_params, tokens, samples, step_fn,
             peak_gb, flops_per_step, extra=None):
    """The end-to-end numbers of a bf16 training path: step ms, device ms
    and busy share (``torch.profiler``), tokens/s (and samples/s), the
    model-FLOP share at the bf16 dense rate (989 TFLOP/s) and, beside it,
    at the fp32 rate (67), and peak memory."""
    step_ms = wall / steps * 1e3
    busy, top = device_profile(step_fn, 2, warmup=0, top=10)
    row = {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "bf16_model_flop_share": flops_per_step / (step_ms / 1e3)
           / PEAK_FLOPS[torch.bfloat16],
           "fp32_model_flop_share": flops_per_step / (step_ms / 1e3)
           / PEAK_FLOPS[torch.float32],
           "device_ms": busy, "device_busy_share": busy_share(busy, step_ms),
           "peak_memory_gb": peak_gb, "top_kernels_ms": top,
           "parameters": n_params}
    if samples is not None:
        row["samples_per_s"] = samples / (step_ms / 1e3)
    row.update(extra or {})
    print(f"{label} end to end [{card}]: " + json.dumps(row))
    return row


def check_first_loss(label, bf16_loss, fp32_loss):
    rel = abs(bf16_loss - fp32_loss) / abs(fp32_loss)
    print(f"{label}: first-step loss of the bf16 step {bf16_loss:.6f} vs "
          f"the fp32 forward of the same weights {fp32_loss:.6f} "
          f"({rel:.3e} relative, limit {BF16_LOSS_TOL})")
    check(rel <= BF16_LOSS_TOL, f"{label}: the bf16 step's first loss "
                                f"{bf16_loss} is {rel:.3e} relative off the "
                                f"fp32 forward's {fp32_loss}")
    return rel


def phase_gpt_bf16(dev, card):
    """GPT-2 124M trained in bf16 under amp.init (the slice's main path)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 16: bf16 training of GPT-2 124M under amp.init (full "
          f"width, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, fp32 master "
          f"weights, AdamW) on {card}", flush=True)
    vocab = 50257
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = torch.from_numpy(onp.random.RandomState(0).randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    with torch.no_grad():
        ref = loss_fn(net(x), y).mean().item()
    trainer = mx.gluon.Trainer(params, "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.autograd.backward(loss)
        trainer.step(TRAIN_BATCH)
        return loss.detach().mean()

    mx.amp.init("bfloat16")
    try:
        with torch.no_grad():
            logits = net(x[:1, :16])
        check(logits.dtype == torch.bfloat16,
              f"the head's logits are {logits.dtype} under amp.init")
        zero_all_counters()
        first = step().item()
        warm = all_launches()
        rel = check_first_loss("GPT-2 124M", first, ref)
        dtypes = {str(p.data().dtype) for p in params.values()}
        check(dtypes == {"torch.float32"}, f"the master weights are "
                                           f"{dtypes}, expected float32")
        bad = [n for n, p in params.items()
               if not (torch.isfinite(p.grad()).all().item() and (
                   "key_proj.bias" in n or p.grad().abs().max().item() > 0))]
        check(not bad, f"parameters without a finite, nonzero fp32 gradient "
                       f"after step 1: {bad[:6]} ({len(bad)} in all)")
        torch.cuda.reset_peak_memory_stats()
        zero_all_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step() for _ in range(BF16_TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        events = kernel_events(step, 1, ("flash_fwd", "flash_bwd_dkv",
                                         "flash_bwd_dq"))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        e2e = bf16_e2e(card, "GPT-2 124M bf16 training", wall,
                       BF16_TRAIN_STEPS, n_params, tokens, None, step, peak,
                       6 * n_params * tokens)
    finally:
        mx.amp._deactivate()
    losses = [first] + [v.item() for v in losses]
    per_step = dict(zip(LAUNCH_NAMES, [n / BF16_TRAIN_STEPS
                                       for n in launches]))
    print(f"losses {losses}; launches a step {per_step}; the flash kernels' "
          f"own profiler events in one step {events}")
    check(all(onp.isfinite(losses)) and losses[-1] < losses[0],
          f"the bf16 GPT loss is not finite or did not fall: {losses}")
    want = [N_LAYERS] * 3 + [0] * 6
    check(launches == [w * BF16_TRAIN_STEPS for w in want]
          and warm == want, f"launches {launches} in {BF16_TRAIN_STEPS} "
                            f"steps (warm-up {warm}), expected {want} a step")
    e2e.update(first_loss=first, fp32_forward_loss=ref,
               first_loss_rel_diff=rel, losses=losses,
               launches_per_step=per_step, profiler_events_per_step=events)
    return launches, e2e


def phase_bert_bf16(dev, card):
    """BERT-base trained in bf16: net.cast("bfloat16") and multi_precision
    AdamW (fp32 masters in the optimizer state)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    print(f"== phase 17: bf16 training of BERT-base through net.cast("
          f"'bfloat16') and multi_precision AdamW (full width, batch "
          f"{BERT_BATCH} x seq {BERT_SEQ}, dropout 0.1) on {card}",
          flush=True)
    net = BERTForPretraining(
        vocab_size=BERT_VOCAB, units=768, hidden_size=3072, num_layers=12,
        num_heads=12, max_length=512, dropout=0.1, embed_dropout=0.1,
        device=dev).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    ids, types, valid, labels, weight, nsp = bert_batch(dev)
    mlm_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_loss():
        mlm, nsp_scores = net(ids, types, valid)
        return mlm_loss(mlm, labels, weight) + nsp_loss(nsp_scores, nsp)

    mx.random.seed(0)
    with mx.autograd.train_mode():
        ref = forward_loss().mean().item()
    net.cast("bfloat16")
    dtypes = {str(p.data().dtype) for p in params.values()}
    check(dtypes == {"torch.bfloat16"}, f"net.cast left {dtypes}")
    trainer = mx.gluon.Trainer(params, "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01,
                                "multi_precision": True})

    def step():
        with mx.autograd.record():
            loss = forward_loss()
        mx.autograd.backward(loss)
        trainer.step(BERT_BATCH)
        return loss.detach().mean()

    mx.random.seed(0)
    zero_all_counters()
    first = step().item()
    warm = all_launches()
    rel = check_first_loss("BERT-base", first, ref)
    masters = {str(s[0].dtype) for s in trainer._updater.states.values()}
    check(masters == {"torch.float32"}, f"the optimizer's masters are "
                                        f"{masters}, expected float32")
    bad = [n for n, p in params.items()
           if not (torch.isfinite(p.grad()).all().item()
                   and p.grad().abs().max().item() > 0)]
    check(not bad, f"parameters without a finite, nonzero gradient after "
                   f"step 1: {bad[:6]} ({len(bad)} in all)")
    torch.cuda.reset_peak_memory_stats()
    zero_all_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    events = kernel_events(step, 1, ("ln_residual_fwd", "ln_residual_bwd"))
    losses = [first] + [v.item() for v in losses]
    per_step = dict(zip(LAUNCH_NAMES, [n / BERT_STEPS for n in launches]))
    print(f"losses {losses}; launches a step {per_step}; the ln_residual "
          f"kernels' own profiler events in one step {events}")
    check(all(onp.isfinite(losses)) and losses[-1] < losses[0],
          f"the bf16 BERT loss is not finite or did not fall: {losses}")
    want = [0, 0, 0, N_LAYERS, N_LAYERS, 0, 0, 0, 0]
    check(launches == [w * BERT_STEPS for w in want] and warm == want,
          f"launches {launches} in {BERT_STEPS} steps (warm-up {warm}), "
          f"expected {want} a step")
    tokens = BERT_BATCH * BERT_SEQ
    e2e = bf16_e2e(card, "BERT-base bf16 training", wall, BERT_STEPS,
                   n_params, tokens, BERT_BATCH, step, peak,
                   6 * n_params * tokens,
                   {"first_loss": first, "fp32_forward_loss": ref,
                    "first_loss_rel_diff": rel, "losses": losses,
                    "launches_per_step": per_step,
                    "profiler_events_per_step": events})
    del net, trainer
    return launches, e2e


def phase_resnet_bf16(dev, card):
    """ResNet-50 v1 trained in bf16 under amp.init, fused_conv_bn "on"
    (kernel 8's bf16 instantiation) and "off" (cuDNN bf16) from the same
    weights, then "auto" by its rule."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn import fuse
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print(f"== phase 18: bf16 training of ResNet-50 v1 under amp.init (full "
          f"width, batch {RESNET_BATCH} x 3 x {RESNET_SIZE} x {RESNET_SIZE}, "
          f"fp32 master weights, SGD lr 0.05 momentum 0.9) on {card}",
          flush=True)
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev).initialize(seed=0)
    x, y = resnet_batch(dev)
    net(x)  # finishes the deferred shapes (inference: no statistics update)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values()
                   if p.grad_req != "null")
    start = {n: p.data().detach().clone() for n, p in params.items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    with mx.autograd.train_mode():
        ref = loss_fn(net(x), y).mean().item()
    restore()

    def run(mode, steps):
        restore()
        mx.config.set("fused_conv_bn", mode)
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                                   "momentum": 0.9})

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            return loss.detach().mean()

        mx.amp.init("bfloat16")
        try:
            zero_all_counters()
            first = step().item()
            warm = all_launches()
            torch.cuda.reset_peak_memory_stats()
            zero_all_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step() for _ in range(steps)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = all_launches()
            kernels = dict(cb.fused_conv3x3_bn_relu_bwd.kernel_launches)
            shapes = dict(cb.fused_conv3x3_bn_relu_bwd.shape_launches)
            peak = torch.cuda.max_memory_allocated() / 1e9
            busy, top = device_profile(step, 2, warmup=0, top=8)
        finally:
            mx.amp._deactivate()
            mx.config.reset("fused_conv_bn")
        return dict(first=first, warm=warm, wall=wall, launches=launches,
                    kernels=kernels, shapes=shapes, peak=peak, busy=busy,
                    top=top, losses=[first] + [v.item() for v in losses])

    want_shapes = {(n, h, w, c, c): t for (n, h, w, c), t
                   in RESNET_STAGE_TRIPLETS.items()}
    runs = {}
    for mode in ("on", "off", "off", "on"):
        r = run(mode, RESNET_STEPS)
        fused = mode == "on"
        want = [0] * 8 + [RESNET_TRIPLETS if fused else 0]
        print(f"{mode}: losses {r['losses']}; launches in {RESNET_STEPS} "
              f"steps {dict(zip(LAUNCH_NAMES, r['launches']))}; kernel 8's "
              f"CUDA kernels {r['kernels']}; calls by (N, H, W, C, O) "
              f"{r['shapes']}")
        check(r["launches"] == [k * RESNET_STEPS for k in want]
              and r["warm"] == want, f"'{mode}': launches {r['launches']} in "
                                     f"{RESNET_STEPS} steps (warm-up "
                                     f"{r['warm']}), expected {want} a step")
        check(r["shapes"] == ({k: v * RESNET_STEPS for k, v
                               in want_shapes.items()} if fused else {}),
              f"'{mode}': kernel 8 bf16 calls by shape {r['shapes']}")
        check(all(onp.isfinite(r["losses"])) and r["losses"][-1]
              < r["losses"][0], f"'{mode}': the loss is not finite or did "
                                f"not fall: {r['losses']}")
        check_first_loss(f"ResNet-50 '{mode}'", r["first"], ref)
        if mode in runs:
            runs[mode]["wall_runs"].append(r["wall"])
            runs[mode]["device_runs"].append(r["busy"])
        else:
            r["wall_runs"], r["device_runs"] = [r["wall"]], [r["busy"]]
            runs[mode] = r
    auto_fuses = torch.bfloat16 in fuse._AUTO_DTYPES
    auto = run("auto", 2)
    check(auto["launches"][8] == (RESNET_TRIPLETS * 2 if auto_fuses else 0),
          f"'auto' launched kernel 8 bf16 {auto['launches'][8]} times in 2 "
          f"steps; its rule {'fuses' if auto_fuses else 'does not fuse'} "
          "bf16 triplets")
    e2e = {"fp32_forward_loss": ref, "auto_fuses_bf16": auto_fuses,
           "parameters": n_params}
    for mode, r in runs.items():
        step_ms = float(onp.median([w / RESNET_STEPS * 1e3
                                    for w in r["wall_runs"]]))
        dev_ms = [d for d in r["device_runs"] if d is not None]
        row = {"step_ms": step_ms,
               "step_ms_runs": [w / RESNET_STEPS * 1e3
                                for w in r["wall_runs"]],
               "images_per_s": RESNET_BATCH / step_ms * 1e3,
               "bf16_model_flop_share": RESNET_BATCH * RESNET50_TRAIN_FLOPS
               / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
               "fp32_model_flop_share": RESNET_BATCH * RESNET50_TRAIN_FLOPS
               / (step_ms / 1e3) / PEAK_FLOPS[torch.float32],
               "device_ms": float(onp.median(dev_ms)) if dev_ms else None,
               "device_ms_runs": r["device_runs"],
               "device_busy_share": busy_share(
                   float(onp.median(dev_ms)) if dev_ms else None, step_ms),
               "peak_memory_gb": r["peak"], "losses": r["losses"],
               "first_loss": r["first"],
               "first_loss_rel_diff": abs(r["first"] - ref) / abs(ref),
               "kernel8_bf16_calls_per_step": r["launches"][8]
               // RESNET_STEPS,
               "kernel8_launches_per_step": {
                   k: v // RESNET_STEPS for k, v in r["kernels"].items()
                   if k.endswith("_bf16")},
               "top_kernels_ms": r["top"]}
        e2e[mode] = row
        print(f"ResNet-50 bf16 training '{mode}' [{card}]: "
              + json.dumps(row))
    e2e["launches"] = runs["on"]["launches"][8]
    per_shape = {k: v // RESNET_STEPS for k, v in runs["on"]["shapes"].items()}
    del start, runs
    return e2e, per_shape


# -- hybridize() and the fused update (phases 19-22) --------------------------

HYBRID_STEPS = 4  # timed steps of each run in phases 19-21
#: the host's kernel and graph launch calls, as the profiler names the
#: CUDA API events
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def host_launch_calls(fn):
    """{API name: calls} of one call of ``fn()``: the host's kernel and
    graph launches, from ``torch.profiler``'s runtime API events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.name in HOST_LAUNCH_CALLS:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def launch_window(label, fn, names, want, steps):
    """{name: device kernels whose names contain ``name``} over one
    profiled window of ``steps`` calls of ``fn()``, started just before
    them: a hybridized path's launches (a replay runs no wrapper, so no
    counter moves; a kernel inside a replayed CUDA graph is a profiler
    event of its own). The profiler drops events now and then: a window
    short of ``want`` a call is measured again, up to three windows, each
    printed; the counts of the last window measured are returned."""
    for window in range(3):
        counts = {n: int(round(c * steps)) for n, c in
                  kernel_events(fn, steps, names, warmup=0).items()}
        print(f"  {label}: profiled window {window + 1} of {steps} "
              f"hybridized steps: kernel events {counts}")
        if all(counts[n] == want[n] * steps for n in names):
            break
    return counts


def params_snapshot(params):
    return {n: p.data().detach().clone() for n, p in params.items()}


def tensor_diffs(a, b):
    """{name: max|a - b|} of the dicts' tensors that differ."""
    return {n: (a[n].float() - b[n].float()).abs().max().item()
            for n in a if not torch.equal(a[n], b[n])}


def worst(diffs, ref):
    """(the largest max|a - b| / max|a| of ``diffs``, the tensor, its
    max|a - b|)."""
    rows = [(d / max(ref[n].float().abs().max().item(), 1e-30), n, d)
            for n, d in diffs.items()]
    return max(rows) if rows else (0.0, None, 0.0)


def graph_stats(blocks):
    """Signatures, captures and capture seconds of hybridized blocks."""
    graphs = [b._cached_graph for b in blocks if b._cached_graph]
    entries = [e for g in graphs for e in g._signatures.values()]
    return {"signatures": len(entries),
            "captures": sum(g.captures for g in graphs),
            "capture_s": sum(e.capture_s for e in entries)}


def set_hybrid(blocks, on):
    for b in blocks:
        b.hybridize(on, clear=False)


def hybrid_ab(label, card, blocks, make_step, restore, params, seed, names,
              want, tokens, samples, flops, extra_state=None,
              deterministic=False):
    """The hybridized path against the eager one on one model: from the
    same start weights (and generator state), 2 eager, 2 hybridized and
    again 2 eager steps, whose losses and parameters (and
    ``extra_state()``) must be equal bit for bit; where ``deterministic``,
    these steps take cuDNN's deterministic algorithms, and the graphs they
    captured are dropped after them. Then timed runs in turns (eager,
    hybrid, hybrid, eager) of ``HYBRID_STEPS`` steps each: wall ms,
    profiled device ms, busy share, host launch calls a step, peak memory;
    last, the launches of ``names`` in one profiled window of
    ``HYBRID_STEPS`` hybridized steps, ``want`` a step."""
    runs, peaks = {}, {}
    cudnn_default = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or cudnn_default
    try:
        for on in (False, True, "again"):
            restore()
            seed()
            set_hybrid(blocks, on is True)
            step = make_step()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            losses = [step() for _ in range(2)]
            torch.cuda.synchronize()
            peaks[on] = (torch.cuda.max_memory_allocated() / 1e9,
                         torch.cuda.max_memory_reserved() / 1e9)
            runs[on] = ([v.item() for v in losses],
                        params_snapshot(params),
                        extra_state() if extra_state else None)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = cudnn_default
    (le, pe, se), (lh, ph, sh) = runs[False], runs[True]
    loss_diff = max(abs(a - b) / max(abs(a), 1e-30) for a, b in zip(le, lh))
    hybrid_d = tensor_diffs(pe, ph)
    eager_d = tensor_diffs(pe, runs["again"][1])
    diff, where, diff_abs = worst(hybrid_d, pe)
    spread = worst(eager_d, pe)
    stats = graph_stats(blocks)
    print(f"{label}: eager losses {le}, hybridized {lh} (largest relative "
          f"difference {loss_diff:.3e}); parameters after 2 steps "
          + ("equal bit for bit" if not hybrid_d else
             f"differ in {len(hybrid_d)} tensors, by up to {diff:.3e} of "
             f"a tensor's largest value ({diff_abs:.3e} in {where})")
          + "; eager against eager: " + (
              "equal bit for bit" if not eager_d else
              f"{len(eager_d)} tensors differ, by up to {spread[0]:.3e} "
              f"({spread[2]:.3e} in {spread[1]})")
          + f"; graphs {stats}")
    check(le == lh and not hybrid_d and not eager_d,
          f"{label}: the hybridized losses {lh} or {len(hybrid_d)} "
          f"parameters differ from the eager steps' ({le}), or "
          f"{len(eager_d)} parameters from the eager steps' again")
    if extra_state:
        check(se == sh, f"{label}: {se} eager, {sh} hybridized")
    del runs, pe, ph
    if deterministic:  # the timed graphs take the default algorithms
        for blk in blocks:
            blk._clear_cached_graphs()
    step = make_step()
    rows = {False: [], True: []}
    for on in (False, True, True, False):
        set_hybrid(blocks, on)
        step()  # the first of a mode may capture or warm up: not timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(HYBRID_STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / HYBRID_STEPS * 1e3
        peak = (torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.max_memory_reserved() / 1e9)
        busy, top = device_profile(step, 2, warmup=0, top=6)
        rows[on].append(dict(wall=wall, busy=busy, peak=peak, top=top,
                             host=host_launch_calls(step)))
    # the main path's run for the kernels line
    set_hybrid(blocks, True)
    captures = graph_stats(blocks)["captures"]
    window = launch_window(label, step, names, want, HYBRID_STEPS)
    check(graph_stats(blocks)["captures"] == captures,
          f"{label}: the launch window captured again instead of replaying")
    set_hybrid(blocks, False)
    events = {n: window[n] / HYBRID_STEPS for n in names}
    out = {"eager_losses": le, "hybrid_losses": lh,
           "loss_rel_diff": loss_diff, "param_max_rel_diff": diff,
           "param_max_abs_diff": diff_abs, "param_max_diff_in": where,
           "params_bit_identical": not hybrid_d,
           "tensors_differing": len(hybrid_d),
           "eager_rerun_param_max_rel_diff": spread[0],
           "eager_rerun_tensors_differing": len(eager_d),
           "compared_deterministic_cudnn": deterministic,
           "launch_window_steps": HYBRID_STEPS,
           "launch_window_kernel_events": window,
           "kernel_events_per_hybrid_step": events, **graph_stats(blocks)}
    for on, name in ((False, "eager"), (True, "hybrid")):
        r = rows[on]
        wall = float(onp.median([x["wall"] for x in r]))
        dev = [x["busy"] for x in r if x["busy"] is not None]
        dev_ms = float(onp.median(dev)) if dev else None
        out[name] = {
            "step_ms": wall, "step_ms_runs": [x["wall"] for x in r],
            "device_ms": dev_ms, "device_ms_runs": [x["busy"] for x in r],
            "device_busy_share": busy_share(dev_ms, wall),
            "tokens_per_s": tokens / (wall / 1e3),
            "samples_per_s": None if samples is None
            else samples / (wall / 1e3),
            "model_flop_share_bf16": flops / (wall / 1e3)
            / PEAK_FLOPS[torch.bfloat16],
            "host_launch_calls_per_step": r[-1]["host"],
            # the first two steps (a hybridized one captures), then the
            # timed runs (graphs kept in both modes once captured)
            "first_steps_peak_allocated_gb": peaks[on][0],
            "first_steps_peak_reserved_gb": peaks[on][1],
            "timed_peak_allocated_gb": max(x["peak"][0] for x in r),
            "timed_peak_reserved_gb": max(x["peak"][1] for x in r),
            "top_kernels_ms": r[-1]["top"]}
    print(f"{label} [{card}]: " + json.dumps(out))
    check(events == want, f"{label}: kernels a hybridized step by profiler "
                          f"events {events} (a window of {HYBRID_STEPS} "
                          f"steps), expected {want}")
    return out


def phase_gpt_hybrid(dev, card):
    """GPT-2 124M bf16 (phase 16's model, batch and weights) hybridized:
    net.hybridize() and loss.hybridize(), AdamW through _FusedUpdate; then
    save_parameters -> load_parameters of the bf16 model."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 19: GPT-2 124M bf16 training hybridized (CUDA graphs "
          f"of the forward and backward, fused AdamW; batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}) on {card}", flush=True)
    vocab = 50257

    def gpt(seed):
        return GPTForCausalLM(backbone=gpt2_124m(
            vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
            embed_dropout=0.0, device=dev)).initialize(seed=seed)

    net = gpt(0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    start = params_snapshot(params)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = torch.from_numpy(onp.random.RandomState(0).randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def make_step():
        trainer = mx.gluon.Trainer(params, "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01})

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(TRAIN_BATCH)
            check(trainer._fused_update, "AdamW under amp.init did not take "
                                         "the fused update")
            return loss.detach().mean()
        return step

    tokens = TRAIN_BATCH * TRAIN_SEQ
    mx.amp.init("bfloat16")
    try:
        e2e = hybrid_ab("GPT-2 124M bf16", card, [net, loss_fn], make_step,
                        restore, params, lambda: None,
                        ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
                        {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
                         "flash_bwd_dq": N_LAYERS}, tokens, None,
                        6 * n_params * tokens)
    finally:
        mx.amp._deactivate()
    del start
    net.hybridize(False)  # frees the graphs
    loss_fn.hybridize(False)
    gc.collect()
    torch.cuda.empty_cache()
    net.cast("bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/gpt2.params"
        t0 = time.perf_counter()
        net.save_parameters(path)
        saved = time.perf_counter() - t0
        fresh = gpt(1).cast("bfloat16")
        t0 = time.perf_counter()
        fresh.load_parameters(path)
        loaded = time.perf_counter() - t0
    with torch.no_grad():
        a, b = net(x[:2]), fresh(x[:2])
    same = torch.equal(a, b)
    print(f"save_parameters -> load_parameters of the bf16 GPT-2 124M: "
          f"logits {a.dtype} {tuple(a.shape)} "
          f"{'equal bit for bit' if same else 'DIFFER'} "
          f"(save {saved:.2f} s, load {loaded:.2f} s)")
    check(same, "the reloaded bf16 GPT-2 gives other logits")
    e2e["round_trip"] = {"logits_bit_identical": same, "save_s": saved,
                         "load_s": loaded}
    del net, fresh, a, b
    return e2e


def phase_bert_hybrid(dev, card):
    """BERT-base bf16 (phase 17's model, batch and dropout 0.1: net.cast and
    multi_precision AdamW, whose update stays per parameter) hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    print(f"== phase 20: BERT-base bf16 training hybridized (net.cast, "
          f"multi_precision AdamW, dropout 0.1; batch {BERT_BATCH} x seq "
          f"{BERT_SEQ}) on {card}", flush=True)
    net = BERTForPretraining(
        vocab_size=BERT_VOCAB, units=768, hidden_size=3072, num_layers=12,
        num_heads=12, max_length=512, dropout=0.1, embed_dropout=0.1,
        device=dev).initialize(seed=0)
    net.cast("bfloat16")
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    start = params_snapshot(params)
    ids, types, valid, labels, weight, nsp = bert_batch(dev)
    mlm_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = mx.random.default_generator(dev)

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def make_step():
        trainer = mx.gluon.Trainer(params, "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01,
                                    "multi_precision": True})

        def step():
            with mx.autograd.record():
                mlm, nsp_scores = net(ids, types, valid)
                loss = mlm_loss(mlm, labels, weight) \
                    + nsp_loss(nsp_scores, nsp)
            mx.autograd.backward(loss)
            trainer.step(BERT_BATCH)
            check(trainer._fused_update is False, "multi_precision took the "
                                                  "fused update")
            return loss.detach().mean()
        return step

    tokens = BERT_BATCH * BERT_SEQ
    e2e = hybrid_ab("BERT-base bf16", card, [net, mlm_loss, nsp_loss],
                    make_step, restore, params, lambda: mx.random.seed(0),
                    ("ln_residual_fwd", "ln_residual_bwd"),
                    {"ln_residual_fwd": N_LAYERS,
                     "ln_residual_bwd": N_LAYERS}, tokens, BERT_BATCH,
                    6 * n_params * tokens,
                    extra_state=lambda: gen.get_state().tolist())
    print("the dropout generator's state after 2 hybridized steps equals "
          "the eager steps' (fresh masks each replay, as eager draws them)")
    del net, start
    return e2e


def phase_resnet_hybrid(dev, card):
    """ResNet-50 v1 fp32 (phase 13's model, batch and SGD momentum) with
    fused_conv_bn "auto" (kernel 8) hybridized: BatchNorm's running
    statistics updated inside the graph."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    print(f"== phase 21: ResNet-50 v1 fp32 training hybridized "
          f"(fused_conv_bn 'auto', SGD momentum; batch {RESNET_BATCH} x 3 x "
          f"{RESNET_SIZE} x {RESNET_SIZE}) on {card}", flush=True)
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev).initialize(seed=0)
    x, y = resnet_batch(dev)
    net(x)  # finishes the deferred shapes
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values()
                   if p.grad_req != "null")
    start = params_snapshot(params)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def make_step():
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                                   "momentum": 0.9})

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            check(trainer._fused_update, "SGD momentum did not take the "
                                         "fused update")
            return loss.detach().mean()
        return step

    e2e = hybrid_ab("ResNet-50 fp32 'auto'", card, [net, loss_fn],
                    make_step, restore, params, lambda: None,
                    ("conv_bwd_wsplit_kernel", "conv_bwd_dgrad_kernel",
                     "conv_bwd_wgrad_kernel"),
                    {"conv_bwd_wsplit_kernel": RESNET_TRIPLETS,
                     "conv_bwd_dgrad_kernel": RESNET_TRIPLETS,
                     "conv_bwd_wgrad_kernel": RESNET_TRIPLETS},
                    RESNET_BATCH, RESNET_BATCH,
                    RESNET_BATCH * RESNET50_TRAIN_FLOPS, deterministic=True)
    running = [n for n in params if "running" in n]
    print(f"{len(running)} running statistics among the parameters held "
          f"equal above")
    del net, start
    return e2e


FUSED_CASES = (("sgd", {"momentum": 0.0}), ("sgd", {"momentum": 0.9}),
               ("adam", {}), ("adamw", {}))


def phase_fused_update(dev, card):
    """The Trainer's fused multi-tensor update against the per-parameter
    rule at GPT-2 124M's parameter shapes: 10 steps of the same gradients
    each, wd 0.01, clip 1.0."""
    import copy
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 22: _FusedUpdate vs the per-parameter rule (GPT-2 124M's "
          f"parameters, 10 steps) on {card}", flush=True)
    base = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=50257, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    gen = torch.Generator(device=dev)
    out = {}
    for name, kw in FUSED_CASES:
        label = name + ("_momentum" if kw.get("momentum") else "")
        nets = [copy.deepcopy(base), copy.deepcopy(base)]
        trainers = [mx.gluon.Trainer(n.collect_params(), name,
                                     dict(kw, learning_rate=1e-3, wd=0.01,
                                          clip_gradient=1.0))
                    for n in nets]
        trainers[1]._fused_update = False  # the per-parameter rule
        plist = [list(n.collect_params().values()) for n in nets]

        def grads(step):
            gen.manual_seed(step)
            for a, b in zip(*plist):
                g = torch.randn(a.shape, device=dev, generator=gen)
                a.data().grad = g
                b.data().grad = g.clone()

        for step in range(10):
            grads(step)
            for tr in trainers:
                tr.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        worst_ulp, worst_abs, equal = 0, 0.0, True
        for a, b in zip(*plist):
            wa, wb = a.data().detach(), b.data().detach()
            if not torch.equal(wa, wb):
                equal = False
                worst_abs = max(worst_abs, (wa - wb).abs().max().item())
                worst_ulp = max(worst_ulp, (wa.view(torch.int32).long()
                                            - wb.view(torch.int32).long())
                                .abs().max().item())
        calls = []
        for tr in trainers:
            grads(10)
            calls.append(host_launch_calls(lambda t=tr: t.step(TRAIN_BATCH)))
            grads(11)
            calls.append(device_kernels(lambda t=tr: t.step(TRAIN_BATCH), 1,
                                        "", warmup=0)[2])
        row = {"bit_identical": equal, "max_abs_diff": worst_abs,
               "max_ulp_diff": worst_ulp,
               "fused_host_launch_calls": calls[0],
               "fused_device_kernels": calls[1],
               "per_param_host_launch_calls": calls[2],
               "per_param_device_kernels": calls[3]}
        out[label] = row
        print(f"{label} [{card}]: " + json.dumps(row))
        check(trainers[0]._fused_update, f"{label}: not fused")
        check(worst_abs <= 1e-6, f"{label}: the fused update is "
                                 f"{worst_abs} off the per-parameter rule")
        del nets, trainers, plist
    del base
    return out


# -- the array core and mx.np (phases 26-27) ----------------------------------

#: the reference frontend's functions (the JAX package's
#: tests/test_op_coverage.py REF_NP / REF_LINALG / REF_RANDOM, copied: this
#: script imports nothing of the JAX package)
NP_REF = """
abs absolute add all amax amin any append arange arccos arccosh arcsin
arcsinh arctan arctan2 arctanh argmax argmin argsort around array
array_split atleast_1d atleast_2d atleast_3d average bincount bitwise_and
bitwise_invert bitwise_not bitwise_or bitwise_xor blackman broadcast_to
cbrt ceil clip column_stack concatenate copysign cos cosh cross cumsum
deg2rad degrees delete diag diagflat diagonal diff divide dot dsplit dstack
ediff1d einsum empty empty_like equal exp expand_dims expm1 eye fabs
fill_diagonal fix flatnonzero flip fliplr flipud floor fmax fmin fmod full
full_like gcd greater greater_equal hamming hanning histogram hsplit hstack
hypot identity indices inner insert interp invert isfinite isinf isnan
isneginf isposinf kron lcm ldexp less less_equal linspace log log10 log1p
log2 logical_and logical_not logical_or logical_xor logspace matmul max
maximum mean median min minimum mod moveaxis multiply nan_to_num nanprod
nansum negative nonzero not_equal ones ones_like outer pad percentile
polyval power prod quantile rad2deg radians ravel reciprocal remainder
repeat reshape resize rint roll rollaxis rot90 round row_stack sign sin
sinh sort split sqrt square squeeze stack std subtract sum swapaxes take
tan tanh tensordot tile trace transpose tri tril tril_indices triu
triu_indices true_divide trunc unique unravel_index var vdot vsplit vstack
where zeros zeros_like
""".split()
LINALG_REF = """cholesky det eig eigh eigvals eigvalsh inv lstsq matrix_power
matrix_rank multi_dot norm pinv qr slogdet solve svd tensorinv
tensorsolve""".split()
RANDOM_REF = """beta chisquare choice exponential f gamma gumbel logistic
lognormal multinomial multivariate_normal normal pareto power randint
rayleigh shuffle uniform weibull rand""".split()
#: phase 26's tolerance: the sweep's (tests/test_numpy_op_sweep.py), for
#: float32 values on the card against the port's own CPU results; linalg
#: factorizations rtol 1e-4 + atol 1e-5 (cuSOLVER against LAPACK)
NP_TOL = dict(rtol=2e-5, atol=2e-5)
LINALG_TOL = dict(rtol=1e-4, atol=1e-5)
NP_SAMPLES = 1000000  # draws of each sampler's moment check on the card


def np_cases():
    """(name, args, kwargs) of every ``mx.np`` function of ``NP_REF`` on
    seeded host inputs (the sweep's cases, carried here)."""
    rs = onp.random.RandomState(42)

    def f(shape, lo=-2.0, hi=2.0):
        return rs.uniform(lo, hi, size=shape).astype(onp.float32)

    def i(shape, lo=-4, hi=5):
        return rs.randint(lo, hi, size=shape).astype(onp.int32)

    a23, a34, b34, v4, p23 = f((2, 3)), f((3, 4)), f((3, 4)), f((4,)), \
        f((2, 3), 0.5, 3.0)
    w4, i23, j23 = f((4,), 0.5, 3.0), i((2, 3)), i((2, 3))
    bl, bm = rs.rand(2, 3) > 0.5, rs.rand(2, 3) > 0.5
    nan = onp.array([1.0, onp.nan, onp.inf, -onp.inf], onp.float32)
    cases = []
    smooth = {"sin": a23, "cos": a23, "tan": f((2, 3), -1, 1), "sinh": a23,
              "cosh": a23, "tanh": a23, "exp": a23, "expm1": a23,
              "log": p23, "log10": p23, "log1p": p23, "log2": p23,
              "sqrt": p23, "cbrt": p23, "square": a23, "negative": a23,
              "reciprocal": p23, "arcsin": f((2, 3), -0.9, 0.9),
              "arccos": f((2, 3), -0.9, 0.9), "arctan": a23,
              "arcsinh": a23, "arccosh": f((2, 3), 1.5, 3.0),
              "arctanh": f((2, 3), -0.9, 0.9), "deg2rad": a23,
              "rad2deg": a23, "degrees": a23, "radians": a23, "abs": a23,
              "absolute": a23, "fabs": a23, "ceil": a23, "floor": a23,
              "rint": a23, "fix": a23, "trunc": a23, "sign": a23,
              "nan_to_num": nan, "isfinite": nan, "isinf": nan,
              "isnan": nan, "isneginf": nan, "isposinf": nan,
              "logical_not": bl, "invert": i23, "bitwise_not": i23,
              "bitwise_invert": bl}
    cases += [(n, (x,), {}) for n, x in smooth.items()]
    binary = {"add": (a23, b34[:2, :3]), "subtract": (a23, b34[:2, :3]),
              "multiply": (a23, b34[:2, :3]), "divide": (a23, p23),
              "true_divide": (a23, p23), "power": (p23, f((2, 3), -1.5, 1.5)),
              "maximum": (a23, b34[:2, :3]), "minimum": (a23, b34[:2, :3]),
              "fmax": (a23, b34[:2, :3]), "fmin": (a23, b34[:2, :3]),
              "copysign": (a23, b34[:2, :3]), "hypot": (p23, p23),
              "arctan2": (a23, p23), "mod": (a23, p23),
              "remainder": (a23, p23), "fmod": (a23, p23),
              "ldexp": (a23, i((2, 3), -2, 3)),
              "gcd": (i((2, 3), 1, 20), i((2, 3), 1, 20)),
              "lcm": (i((2, 3), 1, 10), i((2, 3), 1, 10)),
              "bitwise_and": (i23, j23), "bitwise_or": (i23, j23),
              "bitwise_xor": (i23, j23), "logical_and": (bl, bm),
              "logical_or": (bl, bm), "logical_xor": (bl, bm)}
    for n in ("equal", "not_equal", "less", "less_equal", "greater",
              "greater_equal"):
        binary[n] = (a23, b34[:2, :3])
    cases += [(n, xy, {}) for n, xy in binary.items()]
    cases += [(n, (a23, b34[:1, :3]), {}) for n in ("add", "maximum")]
    cases += [(n, (a34,), kw) for n, kw in (
        ("sum", {}), ("sum", {"axis": 1, "keepdims": True}), ("mean", {}),
        ("mean", {"axis": -1}), ("max", {"axis": 0}), ("min", {}),
        ("amax", {"axis": 0}), ("amin", {"axis": 0}), ("std", {}),
        ("std", {"axis": 0, "ddof": 1}), ("var", {"axis": 0, "ddof": 1}),
        ("median", {"axis": 0}), ("average", {}), ("cumsum", {"axis": 1}),
        ("argmax", {"axis": 1}), ("argmin", {}), ("argsort", {"axis": 1}),
        ("sort", {"axis": 0}), ("diff", {"axis": 0}), ("ravel", {}),
        ("transpose", {}), ("fliplr", {}), ("flipud", {}), ("rot90", {}),
        ("diagonal", {}), ("tril", {}), ("triu", {}), ("trace", {}),
        ("around", {}), ("percentile", {"q": 50.0}),
        ("quantile", {"q": 0.25, "axis": 0}), ("round", {"decimals": 1}))]
    cases += [("prod", (p23,), {"axis": 0}), ("all", (bl,), {"axis": 0}),
              ("any", (bl,), {}), ("nansum", (nan[:2],), {}),
              ("nanprod", (nan[:2],), {}), ("median", (v4,), {}),
              ("average", (v4,), {"weights": w4}),
              ("reshape", (a34, (4, 3)), {}), ("swapaxes", (a34, 0, 1), {}),
              ("moveaxis", (f((2, 3, 4)), 0, -1), {}),
              ("rollaxis", (f((2, 3, 4)), 2), {}),
              ("squeeze", (f((1, 3, 1)),), {}),
              ("expand_dims", (a34, 1), {}), ("broadcast_to", (v4, (3, 4)),
                                              {}),
              ("repeat", (a34, 2), {"axis": 0}), ("tile", (a34, (2, 1)), {}),
              ("flip", (a34,), {"axis": 0}), ("roll", (a34, 2), {"axis": 1}),
              ("concatenate", ([a34, b34],), {"axis": 1}),
              ("stack", ([a34, b34],), {"axis": -1}),
              ("vstack", ([a34, b34],), {}), ("hstack", ([a34, b34],), {}),
              ("dstack", ([a34, b34],), {}), ("row_stack", ([a34, b34],), {}),
              ("column_stack", ([v4, w4],), {}),
              ("split", (a34, 2), {"axis": 1}),
              ("array_split", (f((5, 2)), 2), {}), ("hsplit", (a34, 2), {}),
              ("vsplit", (f((4, 3)), 2), {}), ("dsplit", (f((2, 3, 4)), 2),
                                               {}),
              ("atleast_1d", (onp.float32(1.5),), {}),
              ("atleast_2d", (v4,), {}), ("atleast_3d", (a34,), {}),
              ("append", (a34, b34), {"axis": 0}), ("delete", (v4, 1), {}),
              ("insert", (v4, 1, 9.0), {}), ("resize", (a34, (2, 5)), {}),
              ("pad", (a34, ((1, 1), (0, 2))), {}),
              ("take", (a34, onp.array([0, 2], onp.int32)), {"axis": 1}),
              ("where", (bl, a23, p23), {}),
              ("nonzero", (onp.array([[1, 0], [0, 2]], onp.int32),), {}),
              ("flatnonzero", (onp.array([1, 0, 2, 0], onp.int32),), {}),
              ("unique", (onp.array([3, 1, 3, 2], onp.int32),),
               {"return_index": True, "return_inverse": True,
                "return_counts": True}),
              ("unravel_index", (onp.array([5, 7], onp.int32), (3, 4)), {}),
              ("diag", (v4,), {}), ("diagflat", (v4,), {}),
              ("tri", (3, 4), {}), ("tril_indices", (3,), {}),
              ("triu_indices", (3,), {}), ("indices", ((2, 3),), {}),
              ("clip", (a34, -0.5, 0.5), {}), ("ediff1d", (v4,), {}),
              ("bincount", (onp.array([0, 1, 1, 3], onp.int32),), {}),
              ("histogram", (v4, 3), {}),
              ("interp", (onp.array([0.5, 1.5], onp.float32),
                          onp.array([0.0, 1.0, 2.0], onp.float32),
                          onp.array([0.0, 10.0, 20.0], onp.float32)), {}),
              ("polyval", (v4, w4), {}),
              ("dot", (a23, a34[:3, :2]), {}), ("matmul", (a23, a34), {}),
              ("inner", (v4, w4), {}), ("outer", (v4, w4), {}),
              ("vdot", (v4, w4), {}), ("kron", (a23, f((2, 2))), {}),
              ("cross", (f((3,)), f((3,))), {}),
              ("tensordot", (f((2, 3, 4)), f((4, 3, 2))),
               {"axes": ((2,), (0,))}),
              ("einsum", ("ij,jk->ik", a23, a34), {}),
              ("blackman", (5,), {}), ("hamming", (5,), {}),
              ("hanning", (5,), {}), ("zeros", ((2, 3),), {}),
              ("ones", ((2, 3),), {}), ("full", ((2, 3), 7.0), {}),
              ("empty", ((2, 3),), {}), ("eye", (3, 4, 1), {}),
              ("identity", (3,), {}), ("arange", (1, 7, 2), {}),
              ("linspace", (0.0, 1.0, 5), {}), ("logspace", (0.0, 2.0, 4), {}),
              ("array", ([[1, 2], [3, 4]],), {}),
              ("zeros_like", (a34,), {}), ("ones_like", (a34,), {}),
              ("full_like", (a34, 3.0), {}), ("empty_like", (i23,), {}),
              ("fill_diagonal", (f((3, 3)), 5.0), {})]
    return cases


def _np_on(np_mod, ctx, value):
    if isinstance(value, onp.ndarray):
        return np_mod.array(value, ctx=ctx)
    if isinstance(value, list) and value and isinstance(value[0],
                                                        onp.ndarray):
        return [np_mod.array(v, ctx=ctx) for v in value]
    return value


def _np_run(np_mod, ctx, name, args, kwargs, fn=None):
    with ctx:
        fn = fn or getattr(np_mod, name)
        return fn(*[_np_on(np_mod, ctx, a) for a in args], **kwargs)


def _np_leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _np_leaves(o)]
    return [out]


def _np_compare(name, got, want, tol, card_ctx):
    """A card result against the CPU result: structure, shape, dtype,
    values (integers and bools exactly); returns the largest float
    difference."""
    g, w = _np_leaves(got), _np_leaves(want)
    check(len(g) == len(w), f"mx.np.{name}: {len(g)} outputs on the card, "
                            f"{len(w)} on the CPU")
    worst = 0.0
    for a, b in zip(g, w):
        check(a.ctx == card_ctx, f"mx.np.{name}: a result on {a.ctx}")
        check(a.shape == b.shape and str(a.dtype) == str(b.dtype),
              f"mx.np.{name}: {a.shape} {a.dtype} on the card, {b.shape} "
              f"{b.dtype} on the CPU")
        x, y = a.asnumpy(), b.asnumpy()
        if y.dtype.kind in "fc":
            bad = ~onp.isclose(x, y, equal_nan=True, **tol)
            check(not bad.any(), f"mx.np.{name}: the card's values differ "
                                 f"from the CPU's beyond {tol}: {x} vs {y}")
            fin = onp.isfinite(y) & onp.isfinite(x)
            if fin.any():
                worst = max(worst, float(onp.abs(x[fin] - y[fin]).max()))
        else:
            check(onp.array_equal(x, y), f"mx.np.{name}: {x} on the card, "
                                         f"{y} on the CPU")
    return worst


def linalg_cases():
    rs = onp.random.RandomState(7)
    a = (rs.randn(4, 4) + 2 * onp.eye(4)).astype(onp.float32)
    b = rs.randn(4, 4).astype(onp.float32)
    spd = (b @ b.T + 4 * onp.eye(4)).astype(onp.float32)
    rect = rs.randn(5, 3).astype(onp.float32)
    t3 = (rs.randn(2, 3, 6) + 1.0).astype(onp.float32)
    ts = (rs.randn(6, 2, 3) + onp.eye(6).reshape(6, 2, 3)).astype(
        onp.float32)
    return [("cholesky", (spd,), {}), ("det", (a,), {}),
            ("eig", (a,), {}), ("eigh", (spd,), {}), ("eigvals", (a,), {}),
            ("eigvalsh", (spd,), {}), ("inv", (a,), {}),
            ("lstsq", (rect, rect[:, 0] + 1), {"rcond": None}),
            ("matrix_power", (a, 3), {}), ("matrix_rank", (a,), {}),
            ("multi_dot", ([rect, rect.T, rect],), {}),
            ("norm", (a,), {}), ("norm", (a,), {"ord": "nuc"}),
            ("pinv", (rect,), {}), ("qr", (rect,), {}),
            ("slogdet", (a,), {}), ("solve", (a, rect[:4]), {}),
            ("svd", (rect,), {"full_matrices": False}),
            ("tensorinv", (t3,), {"ind": 2}),
            ("tensorsolve", (ts, onp.arange(6, dtype=onp.float32)), {})]


def _linalg_invariant(name, out, args):
    """The sign- and phase-free form of a factorization's result."""
    a = args[0]
    if name == "eigh":
        w, v = out.eigenvalues.asnumpy(), out.eigenvectors.asnumpy()
        return [w, onp.abs(a @ v - v * w).max()]
    if name == "eig":
        w, v = out.eigenvalues.asnumpy(), out.eigenvectors.asnumpy()
        return [onp.sort_complex(w), onp.abs(a @ v - v * w).max()]
    if name == "eigvals":
        return [onp.sort_complex(out.asnumpy()), 0.0]
    if name == "qr":
        q, r = out.Q.asnumpy(), out.R.asnumpy()
        return [onp.abs(r), onp.abs(q @ r - a).max()]
    if name == "svd":
        u, s, vh = (x.asnumpy() for x in out)
        return [s, onp.abs((u * s) @ vh - a).max()]
    return None


SAMPLER_CALLS = {
    "uniform": lambda r, n: r.uniform(-1.0, 3.0, size=n),
    "rand": lambda r, n: r.rand(n),
    "normal": lambda r, n: r.normal(1.0, 2.0, size=n),
    "randint": lambda r, n: r.randint(0, 10, size=n),
    "choice": lambda r, n: r.choice(4, size=n, p=onp.array(
        [0.1, 0.2, 0.3, 0.4])),
    "exponential": lambda r, n: r.exponential(2.0, size=n),
    "gamma": lambda r, n: r.gamma(2.0, 1.5, size=n),
    "beta": lambda r, n: r.beta(2.0, 3.0, size=n),
    "chisquare": lambda r, n: r.chisquare(3.0, size=n),
    "f": lambda r, n: r.f(5.0, 10.0, size=n),
    "gumbel": lambda r, n: r.gumbel(0.0, 1.0, size=n),
    "logistic": lambda r, n: r.logistic(1.0, 2.0, size=n),
    "lognormal": lambda r, n: r.lognormal(0.0, 0.5, size=n),
    "pareto": lambda r, n: r.pareto(5.0, size=n),
    "power": lambda r, n: r.power(2.0, size=n),
    "rayleigh": lambda r, n: r.rayleigh(2.0, size=n),
    "weibull": lambda r, n: r.weibull(2.0, size=n),
    "multinomial": lambda r, n: r.multinomial(20, [0.1, 0.3, 0.6],
                                              size=(n,))[:, 2],
    "multivariate_normal": lambda r, n: r.multivariate_normal(
        onp.array([1.0, -1.0]), onp.array([[2.0, 0.6], [0.6, 1.0]]),
        size=(n,))[:, 0],
}
_G15 = math.gamma(1.5)
#: (mean, variance) of each draw of ``SAMPLER_CALLS``
SAMPLER_MOMENTS = {
    "uniform": (1.0, 16 / 12), "rand": (0.5, 1 / 12), "normal": (1.0, 4.0),
    "randint": (4.5, 99 / 12), "choice": (2.0, 1.0),
    "exponential": (2.0, 4.0), "gamma": (3.0, 4.5), "beta": (0.4, 0.04),
    "chisquare": (3.0, 6.0), "f": (1.25, 2 * 100 * 13 / (5 * 64 * 6)),
    "gumbel": (0.5772156649, math.pi ** 2 / 6),
    "logistic": (1.0, 4 * math.pi ** 2 / 3),
    "lognormal": (math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
    "pareto": (0.25, 5 / 48), "power": (2 / 3, 0.5 - 4 / 9),
    "rayleigh": (2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4.0),
    "weibull": (_G15, 1.0 - _G15 ** 2), "multinomial": (12.0, 4.8),
    "multivariate_normal": (1.0, 2.0),
}


def phase_np_surface(dev, card):
    """Every ``mx.np``, ``mx.np.linalg`` and ``mx.np.random`` function of
    the reference's frontend on ``mx.gpu(0)``, against the port's CPU
    results (phase 26)."""
    import mxnet_tpu_torch as mx
    np = mx.np
    print(f"== phase 26: the mx.np surface on {card} against the CPU",
          flush=True)
    gpu, cpu = mx.gpu(dev.index or 0), mx.cpu()
    missing = ([n for n in NP_REF if not callable(getattr(np, n, None))]
               + [f"linalg.{n}" for n in LINALG_REF
                  if not callable(getattr(np.linalg, n, None))]
               + [f"random.{n}" for n in RANDOM_REF
                  if not callable(getattr(np.random, n, None))])
    check(not missing, f"mx.np lacks {missing}")
    cases = np_cases()
    covered = {c[0] for c in cases}
    check(covered >= set(NP_REF), f"phase 26's table misses "
                                  f"{sorted(set(NP_REF) - covered)}")
    worst = {}
    for name, args, kwargs in cases:
        if name in ("empty", "empty_like"):  # values are unspecified
            g = _np_run(np, gpu, name, args, kwargs)
            w = _np_run(np, cpu, name, args, kwargs)
            check(g.shape == w.shape and g.dtype == w.dtype
                  and g.ctx == gpu, f"mx.np.{name}: {g.shape} {g.dtype}")
            continue
        got = _np_run(np, gpu, name, args, kwargs)
        want = _np_run(np, cpu, name, args, kwargs)
        worst[name] = max(worst.get(name, 0.0),
                          _np_compare(name, got, want, NP_TOL, gpu))
    np_row = {"functions": len(covered), "cases": len(cases),
              "max_abs_diff": max(worst.values()),
              "max_abs_diff_op": max(worst, key=worst.get)}
    print(f"mx.np on {card}: {np_row['functions']} functions, "
          f"{np_row['cases']} cases, every value, dtype and shape as on the "
          f"CPU (largest float difference {np_row['max_abs_diff']:.3e}, in "
          f"{np_row['max_abs_diff_op']})")
    lworst = 0.0
    lcases = linalg_cases()
    for name, args, kwargs in lcases:
        fn = getattr(np.linalg, name)
        got = _np_run(np, gpu, name, args, kwargs, fn)
        want = _np_run(np, cpu, name, args, kwargs, fn)
        gi = _linalg_invariant(name, got, args)
        if gi is None:
            lworst = max(lworst, _np_compare(f"linalg.{name}", got, want,
                                             LINALG_TOL, gpu))
            continue
        for a, b in zip(_np_leaves(got), _np_leaves(want)):
            check(a.shape == b.shape and str(a.dtype) == str(b.dtype),
                  f"linalg.{name}: {a.shape} {a.dtype} vs {b.shape} "
                  f"{b.dtype}")
        wi = _linalg_invariant(name, want, args)
        check(onp.allclose(gi[0], wi[0], **LINALG_TOL) and gi[1] < 1e-3,
              f"linalg.{name}: {gi} on the card, {wi} on the CPU")
        lworst = max(lworst, float(onp.abs(gi[0] - wi[0]).max()))
    check({c[0] for c in lcases} == set(LINALG_REF), "linalg cases")
    linalg_row = {"functions": len(LINALG_REF), "cases": len(lcases),
                  "max_abs_diff": lworst}
    print(f"mx.np.linalg on {card}: {len(LINALG_REF)} functions, "
          f"{len(lcases)} cases as on the CPU (largest difference "
          f"{lworst:.3e}; eig / eigvals on the host, as the reference)")
    moments = {}
    with gpu:
        for name, call in SAMPLER_CALLS.items():
            mx.random.seed(5)
            a = call(np.random, NP_SAMPLES)
            np.random.seed(5)
            b = call(np.random, NP_SAMPLES)
            check(a.ctx == gpu and torch.equal(a._data, b._data),
                  f"np.random.{name}: the same seed gave other draws on "
                  f"{a.ctx}")
            with cpu:
                c = call(np.random, 8)
            check(str(a.dtype) == str(c.dtype), f"np.random.{name}: "
                                                f"{a.dtype} vs {c.dtype}")
            x = a.asnumpy().astype(onp.float64)
            mean, var = SAMPLER_MOMENTS[name]
            z = (x.mean() - mean) / math.sqrt(var / x.size)
            rel_var = x.var() / var - 1
            moments[name] = {"mean_z": float(z), "var_rel": float(rel_var)}
            check(abs(z) < 5 and abs(rel_var) < 0.05,
                  f"np.random.{name} on {card}: mean {x.mean()} (want "
                  f"{mean}, z {z:.2f}), var {x.var()} (want {var})")
        x = np.arange(12, dtype="float32").reshape(6, 2)
        np.random.shuffle(x)
        check(x.ctx == gpu and x.version == 1 and sorted(
            x.asnumpy()[:, 0].tolist()) == list(range(0, 12, 2)),
              "np.random.shuffle on the card")
    covered = set(SAMPLER_CALLS) | {"shuffle"}
    check(covered >= set(RANDOM_REF), f"phase 26 misses samplers "
                                      f"{sorted(set(RANDOM_REF) - covered)}")
    random_row = {"samplers": len(covered), "draws": NP_SAMPLES,
                  "worst_mean_z": max(abs(m["mean_z"])
                                      for m in moments.values()),
                  "worst_var_rel": max(abs(m["var_rel"])
                                       for m in moments.values())}
    print(f"mx.np.random on {card}: {len(covered)} samplers, each "
          f"reproducible under its seed on the card, dtypes as on the CPU, "
          f"moments of {NP_SAMPLES} draws: worst |z| of the mean "
          f"{random_row['worst_mean_z']:.2f}, worst variance "
          f"{random_row['worst_var_rel']:+.4f} relative")
    return {"np": np_row, "linalg": linalg_row, "random": random_row,
            "moments": moments}


def np_forward_block(mx, dev):
    """A small block whose forward is written in ``mx.np`` (phase 27)."""
    from mxnet_tpu_torch.gluon.parameter import Parameter

    class NpMLP(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = Parameter((256, 512), device=dev).data()

        def forward(self, x):
            h = mx.np.tanh(x @ self.w)
            return mx.np.sum(h * h + 0.5 * h, axis=1)
    return NpMLP().initialize(seed=3)


def _gpt_step_fn(mx, net, loss_fn, x, y, as_np):
    """One AdamW step of phase 16's path: from tensors, or the reference's
    way from mx.np arrays (``loss.backward()``, ``loss.asnumpy()``)."""
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        if as_np:
            loss.backward()
        else:
            mx.autograd.backward(loss)
        trainer.step(TRAIN_BATCH)
        return loss
    return step


def phase_gpt_np(dev, card):
    """GPT-2 124M bf16 trained from mx.np arrays (phase 27)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 27: GPT-2 124M bf16 trained from mx.np arrays (batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, amp.init, fused AdamW) on "
          f"{card}", flush=True)
    vocab = 50257
    gpu = mx.gpu(dev.index or 0)
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    start = params_snapshot(params)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = onp.random.RandomState(0).randint(0, vocab,
                                            (TRAIN_BATCH, TRAIN_SEQ + 1))
    tids = torch.from_numpy(ids).to(dev)
    nids = mx.np.array(ids, ctx=gpu)
    check(nids.dtype == onp.int64 and nids.ctx == gpu,
          f"the tokens are {nids.dtype} on {nids.ctx}")
    inputs = {False: (tids[:, :-1], tids[:, 1:]),
              True: (nids[:, :-1], nids[:, 1:])}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def make(as_np):
        return _gpt_step_fn(mx, net, loss_fn, *inputs[as_np], as_np)

    compared, launches = {}, {}
    mx.amp.init("bfloat16")
    try:
        for hybrid in (False, True):
            net.hybridize(hybrid, clear=False)
            loss_fn.hybridize(hybrid, clear=False)
            runs = {}
            for as_np in (False, True):
                restore()
                step = make(as_np)
                zero_all_counters()
                losses = [step() for _ in range(2)]
                torch.cuda.synchronize()
                counts = all_launches()
                if as_np:
                    check(all(type(v) is mx.np.ndarray for v in losses),
                          "the mx.np-driven step gave no ndarray loss")
                    losses = [v.asnumpy() for v in losses]
                else:
                    losses = [v.detach().float().cpu().numpy()
                              for v in losses]
                runs[as_np] = (losses, params_snapshot(params), counts)
            (lt, pt, ct), (ln, pn, cn) = runs[False], runs[True]
            same_loss = all(onp.array_equal(a, b) for a, b in zip(lt, ln))
            diffs = tensor_diffs(pt, pn)
            mode = "hybridized" if hybrid else "eager"
            print(f"{mode}: mx.np-driven losses "
                  f"{[float(v.mean()) for v in ln]}, tensor-driven "
                  f"{[float(v.mean()) for v in lt]}: "
                  + ("equal bit for bit" if same_loss else "DIFFER")
                  + "; parameters after 2 steps "
                  + ("equal bit for bit" if not diffs else
                     f"differ in {len(diffs)} tensors"))
            check(same_loss and not diffs, f"{mode}: the mx.np-driven "
                                           "steps differ from the "
                                           "tensor-driven steps")
            compared[mode] = {"losses_bit_identical": same_loss,
                              "params_bit_identical": not diffs,
                              "losses": [float(v.mean()) for v in ln]}
            if not hybrid:
                want = [N_LAYERS * 2] * 3 + [0] * 6
                check(cn == want and ct == want,
                      f"eager: wrapper launches {cn} (mx.np) and {ct} "
                      f"(tensors) in 2 steps, expected {want}")
                launches["eager"] = cn
            del runs, pt, pn
        timed = {}
        for hybrid in (False, True):
            net.hybridize(hybrid, clear=False)
            loss_fn.hybridize(hybrid, clear=False)
            rows = {False: [], True: []}
            for as_np in (False, True, True, False):
                step = make(as_np)
                step()  # the first of a run may capture or warm up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HYBRID_STEPS):
                    step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / HYBRID_STEPS * 1e3
                busy, _ = device_profile(step, 2, warmup=0, top=1)
                rows[as_np].append({"wall": wall, "device": busy,
                                    "host": host_launch_calls(step)})
            mode = "hybridized" if hybrid else "eager"
            timed[mode] = {}
            for as_np, label in ((False, "tensors"), (True, "mx_np")):
                r = rows[as_np]
                wall = float(onp.median([x["wall"] for x in r]))
                devs = [x["device"] for x in r if x["device"] is not None]
                dev_ms = float(onp.median(devs)) if devs else None
                timed[mode][label] = {
                    "step_ms": wall, "step_ms_runs": [x["wall"] for x in r],
                    "device_ms": dev_ms,
                    "device_ms_runs": [x["device"] for x in r],
                    "device_busy_share": busy_share(dev_ms, wall),
                    "host_launch_calls_per_step": r[-1]["host"],
                    "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall / 1e3)}
            t, n = timed[mode]["tensors"], timed[mode]["mx_np"]
            print(f"{mode} step [{card}]: mx.np {n['step_ms']:.2f} ms "
                  f"(device {n['device_ms']}, busy "
                  f"{n['device_busy_share']}), tensors {t['step_ms']:.2f} "
                  f"ms (device {t['device_ms']}, busy "
                  f"{t['device_busy_share']}); host launch calls a step "
                  f"{n['host_launch_calls_per_step']} vs "
                  f"{t['host_launch_calls_per_step']}", flush=True)
        # the main path's hybridized run: kernels 1-3 by profiler events
        net.hybridize(True, clear=False)
        loss_fn.hybridize(True, clear=False)
        step = make(True)
        step()
        names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
        window = launch_window("GPT-2 124M bf16 from mx.np", step, names,
                               {n: N_LAYERS for n in names}, HYBRID_STEPS)
        events = {n: window[n] / HYBRID_STEPS for n in names}
        check(events == {n: N_LAYERS for n in names},
              f"hybridized mx.np steps: kernels a step by profiler events "
              f"{events}, expected {N_LAYERS} each")
        launches["hybridized_window"] = window
    finally:
        mx.amp._deactivate()
        net.hybridize(False)
        loss_fn.hybridize(False)
    # a user block whose forward is written in mx.np, captured
    block = np_forward_block(mx, dev)
    x = mx.np.array(onp.random.RandomState(4).randn(64, 256)
                    .astype("float32"), ctx=gpu)
    eager = block(x)
    block.hybridize()
    captured = block(x)
    again = block(x)
    graph = block._cached_graph
    check(graph is not None and graph.captures == 1
          and all(e.fwd is not None for e in graph._signatures.values()),
          "the mx.np-forward block was not captured into a CUDA graph")
    check(isinstance(captured, mx.np.ndarray) and captured.ctx == gpu,
          f"the captured forward gave {type(captured)}")
    diff = float(onp.abs(captured.asnumpy() - eager.asnumpy()).max())
    same = torch.equal(captured._data, eager._data)
    check(torch.equal(again._data, captured._data) and diff <= 1e-5 * float(
        onp.abs(eager.asnumpy()).max()), f"the captured mx.np forward is "
                                         f"{diff} off the eager one")
    print(f"a block with an mx.np forward (@, np.tanh, np.sum), captured: "
          f"{'equal bit for bit' if same else f'max |diff| {diff:.3e}'} to "
          f"eager; {graph.captures} capture")
    del net, start
    return {"compared": compared, "timed": timed, "launches": launches,
            "events_per_hybrid_step": events, "parameters": n_params,
            "np_forward_block": {"captures": graph.captures,
                                 "bit_identical": same, "max_abs_diff": diff}}


# -- phases 28-30: the host planes --------------------------------------------

#: the serving SLO objectives phase 28 arms (milliseconds)
PLANE_SLO = {"serve.slo_ttft_ms": 2000.0, "serve.slo_tpot_ms": 200.0}
#: the host's synchronizing runtime calls, as the profiler names them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
NP_LOOP_OPS = 10000  # elementwise mx.np ops of phase 30's tight loop
FLOP_TOL = 0.05  # counted FLOPs a step against the analytic count


def set_planes(mx, on):
    """Switch the planes phases 28-30 drive on or off together."""
    for plane in (mx.telemetry, mx.trace, mx.goodput, mx.insight):
        plane.enable(on)
    mx.blackbox.enable(on)


def sync_events(fn):
    """One call of ``fn()`` under ``torch.profiler``: ({runtime call:
    count} of the synchronizing calls, the host's ``cudaMemcpy*`` runtime
    calls (copies of every direction), flash forward kernel events). The
    first two are host runtime events; only the third is a device event,
    which the profiler drops now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    calls, copies, flash = {}, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            flash += "flash_fwd" in e.name
        elif e.name in SYNC_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
        elif e.name.startswith("cudaMemcpy"):
            copies += 1
    return calls, copies, flash


def run_stats(reqs, wall):
    """tokens/s and TPOT p50 of one serving run's own requests."""
    tpots = [r.tpot for r in reqs if r.tpot is not None]
    return {"tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
            "tpot_p50_ms": float(onp.median(tpots)) * 1e3, "wall_s": wall}


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def phase_serve_planes(dev, card, net, prompts, base_reqs):
    """Phase 3's model and requests served with every host plane on."""
    import tempfile
    import mxnet_tpu_torch as mx
    print(f"== phase 28: GPT-2 124M serving under every host plane "
          f"(telemetry, trace, goodput, insight, blackbox, SLOs, the ops "
          f"endpoint) on {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="planes-")
    mx.config.set("blackbox.dir", tmp)
    mx.config.set("trace.buffer", 16384)
    for knob, value in PLANE_SLO.items():
        mx.config.set(knob, value)
    mx.trace.configure()
    set_planes(mx, True)
    port = mx.telemetry.serve_http(0).server_address[1]
    try:
        eng = mx.serve.load(net, max_slots=8)
        warm_s, _ = serve_warmup("planes on", eng)
        exes = sorted(mx.insight.attribution()["executables"])
        want = sorted(["serve.decode"] + [f"serve.prefill_{b}"
                                          for b in eng.buckets])
        check(exes == want, f"insight registered {exes}, expected {want}")
        mx.telemetry.reset()
        mx.trace.clear()
        reqs, wall = serve_run(eng, prompts)
        st = eng.stats()
        agg = mx.telemetry.counters(aggregate=True)
        ttft = mx.telemetry.snapshot()["histograms"]["serve.ttft_seconds"]
        got = (agg["serve.requests_total"], agg["serve.completed_total"],
               agg["serve.tokens_total"], ttft["count"])
        want = (len(prompts), st["completed"], st["tokens_out"],
                len(prompts))
        check(got == want, f"serve counters {got} vs stats() {want}")
        check([r.generated for r in reqs] ==
              [r.generated for r in base_reqs],
              "the planes changed phase 3's greedy tokens")
        spans = mx.trace.spans()
        check(mx.trace.stats()["dropped"] == 0, "the span ring dropped")
        by_id = {s["args"]["span_id"]: s for s in spans}
        trees = {}
        for s in spans:
            parent = by_id.get(s["args"].get("parent_id"))
            if parent is not None and parent["name"] == "serve.request":
                trees.setdefault(parent["args"]["request"], set()).add(
                    s["name"])
        roots = [s for s in spans if s["name"] == "serve.request"]
        check(len(roots) == len(prompts) and all(
            {"serve.enqueue", "serve.prefill", "serve.drain"} <=
            trees.get(s["args"]["request"], set()) for s in roots),
            f"request span trees incomplete: {len(roots)} roots")
        code_m, body = http_get(port, "/metrics")
        code_h, health = http_get(port, "/healthz")
        code_t, tr = http_get(port, "/trace?last=5&category=serve")
        health = json.loads(health)
        check(code_m == code_h == code_t == 200
              and "mxnet_serve_requests_total" in body
              and health["checks"]["serve"]["ok"]
              and len(json.loads(tr)["spans"]) == 5,
              f"the ops endpoint: {code_m} {code_h} {code_t} {health}")
        burn = eng.slo_burn()
        check(all(math.isfinite(v) for v in burn.values()),
              f"slo_burn() {burn}")
        check(eng.post_warmup_compiles == 0,
              f"{eng.post_warmup_compiles} graphs built after warmup")
        # the same run profiled with the planes off and on: the same syncs
        for window in range(3):
            set_planes(mx, False)
            off = sync_events(lambda: serve_run(eng, prompts))
            set_planes(mx, True)
            on = sync_events(lambda: serve_run(eng, prompts))
            print(f"  profiled runs {window + 1}: planes off {off}, on {on} "
                  "(sync calls, memcpy calls, flash forward events)")
            if on[2] == N_LAYERS * len(prompts):
                break
        check(on[:2] == off[:2], f"the planes changed the host syncs: off "
                                 f"{off[:2]}, on {on[:2]}")
        check(on[2] == N_LAYERS * len(prompts),
              f"flash forward events {on[2]} with the planes on, expected "
              f"{N_LAYERS * len(prompts)}")
        turns = {False: [], True: []}
        for state in (False, True, True, False):
            set_planes(mx, state)
            r, w = serve_run(eng, prompts)
            turns[state].append(run_stats(r, w))
        eng.stop()
    finally:
        set_planes(mx, False)
        mx.telemetry.stop_http()
        mx.config.reset()
        mx.trace.configure()
    row = {"card": card, "warmup_s": warm_s, "executables": exes,
           "counters": dict(zip(("requests", "completed", "tokens",
                                 "ttft_count"), got)),
           "request_span_trees": len(roots), "slo_burn": burn,
           "sync_calls_off": off[0], "sync_calls_on": on[0],
           "memcpy_calls_off": off[1], "memcpy_calls_on": on[1],
           "flash_fwd_events": on[2],
           "post_warmup_compiles": eng.post_warmup_compiles}
    for state, label in ((False, "off"), (True, "on")):
        for key in ("tokens_per_s", "tpot_p50_ms"):
            vals = [t[key] for t in turns[state]]
            row[f"planes_{label}_{key}"] = vals
            row[f"planes_{label}_{key}_median"] = float(onp.median(vals))
    print(f"serving under the planes [{card}]: " + json.dumps(row))
    return row


def mm_weights(params):
    """Elements of the weights that enter a matrix product: every 2-D
    ``*.weight`` but the position embedding (a lookup only); the word
    embedding is the tied LM head."""
    return sum(p.data().numel() for n, p in params.items()
               if n.endswith(".weight") and p.data().dim() == 2
               and "position_embed" not in n)


def trace_kernels(path, names):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}


def phase_train_planes(dev, card):
    """Phase 27's GPT-2 124M bf16 step under the profiler and faults."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 29: GPT-2 124M bf16 training from mx.np arrays under "
          f"the profiler (device trace), insight and the fault plane on "
          f"{card}", flush=True)
    vocab = 50257
    gpu = mx.gpu(dev.index or 0)
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    n_mm = mm_weights(params)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = onp.random.RandomState(0).randint(0, vocab,
                                            (TRAIN_BATCH, TRAIN_SEQ + 1))
    x, y = mx.np.array(ids[:, :-1], ctx=gpu), mx.np.array(ids[:, 1:],
                                                          ctx=gpu)
    trainer = mx.gluon.Trainer(params, "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(TRAIN_BATCH)
        return loss

    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    tmp = tempfile.mkdtemp(prefix="planes-")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mx.amp.init("bfloat16")
    try:
        step()
        # eager, two steps under the profiler with a device trace
        mx.profiler.set_config(tensorboard_dir=os.path.join(tmp, "tb"),
                               filename=os.path.join(tmp, "profile.json"))
        for window in range(3):
            mx.profiler._events.clear()
            zero_all_counters()
            mx.profiler.set_state("run")
            step()
            step()
            torch.cuda.synchronize()
            mx.profiler.set_state("stop")
            wrapper = all_launches()[:3]
            trace_file = mx.profiler.device_trace_file()
            in_trace = trace_kernels(trace_file, names)
            print(f"  eager window {window + 1}: wrapper launches "
                  f"{wrapper}, device-trace kernel events {in_trace}")
            if list(in_trace.values()) == [2 * N_LAYERS] * 3:
                break
        check(wrapper == [2 * N_LAYERS] * 3,
              f"wrapper launches {wrapper} in 2 steps")
        check(list(in_trace.values()) == [2 * N_LAYERS] * 3,
              f"device trace kernels {in_trace} in 2 steps, expected "
              f"{N_LAYERS} each a step")
        with open(mx.profiler.dump()) as f:
            ops = {e["name"] for e in json.load(f)["traceEvents"]
                   if e["cat"] == "operator"}
        want_ops = {"fully_connected", "layer_norm", "sparse_softmax_xent"}
        check(want_ops <= ops, f"operator spans {sorted(ops)} lack "
                               f"{sorted(want_ops - ops)}")
        mx.profiler.set_config(tensorboard_dir=None)
        # record_memory against the allocator read beside it
        mx.telemetry.enable()
        mem = mx.telemetry.record_memory()[str(dev.index or 0)]
        stats = torch.cuda.memory_stats(dev)
        check((mem["live"], mem["peak"]) ==
              (stats["allocated_bytes.all.current"],
               stats["allocated_bytes.all.peak"]),
              f"record_memory {mem} vs memory_stats")
        # hybridized: CachedOp spans, and the counted cost of the graphs
        mx.insight.enable()
        net.hybridize()
        loss_fn.hybridize()
        step()
        mx.profiler._events.clear()
        mx.profiler.set_state("run")
        step()
        torch.cuda.synchronize()
        mx.profiler.set_state("stop")
        cached = sorted({e["name"] for e in mx.profiler._events
                         if e["name"].startswith("CachedOp:")})
        check(cached == ["CachedOp:GPTForCausalLM",
                         "CachedOp:SoftmaxCrossEntropyLoss"],
              f"hybridized spans {cached}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HYBRID_STEPS):
            step()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / HYBRID_STEPS
        mx.insight.note_step("cached_graph.GPTForCausalLM", seconds=step_s)
        exes = mx.insight.attribution()["executables"]
        graph = exes["cached_graph.GPTForCausalLM"]
        # the loss graph holds no matrix product (its FLOPs read None)
        counted = graph["flops"] + (exes[
            "cached_graph.SoftmaxCrossEntropyLoss"]["flops"] or 0)
        bh = TRAIN_BATCH * 12
        attention = 18 * 64 * pairs(TRAIN_SEQ, TRAIN_SEQ, True) * bh \
            * N_LAYERS
        analytic = 6 * n_mm * tokens + attention
        rel = abs(counted - analytic) / analytic
        print(f"counted FLOPs a step {counted:.6e} vs analytic "
              f"6*N_mm*tokens + attention {analytic:.6e} ({rel:.3e} "
              f"relative; N_mm {n_mm}, attention {attention:.6e}); "
              f"6*N*tokens over every parameter {6 * n_params * tokens:.6e} "
              f"(N {n_params}); insight.mfu {graph['mfu']} at "
              f"{step_s * 1e3:.2f} ms a step [{card}]")
        check(rel <= FLOP_TOL, f"counted FLOPs {counted} are {rel:.3e} off "
                               f"the analytic {analytic}")
        mx.insight.disable()
        mx.telemetry.disable()
        # a NaN injected into the first op of an eager forward
        net.hybridize(False, clear=False)
        loss_fn.hybridize(False, clear=False)
        mx.config.set("trainer.skip_nonfinite", True)
        mx.config.set("blackbox.dir", tmp)
        mx.blackbox.enable()
        mx.fault.reset_stats()
        before = params_snapshot(params)
        mx.fault.configure("invoke.nan_output:at=1,times=1")
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.fault.clear()
        loss.backward()
        trainer.step(TRAIN_BATCH)
        fstats = mx.fault.stats()
        diffs = tensor_diffs(before, params_snapshot(params))
        check(trainer.nonfinite_steps == 1 and not diffs,
              f"the injected step: skipped {trainer.nonfinite_steps}, "
              f"{len(diffs)} tensors moved")
        check(fstats == {"injected.invoke.nan_output": 1,
                         "trainer.nonfinite_skip": 1},
              f"fault.stats() {fstats}")
        bundles = mx.blackbox.list_bundles()
        check(len(bundles) == 1, f"blackbox bundles {bundles}")
        doc = mx.blackbox.read_bundle(bundles[0])
        check(doc["meta"]["trigger"] == "nonfinite"
              and doc["device"]["name"] == torch.cuda.get_device_name(0),
              f"bundle meta {doc['meta']}")
        step()
        moved = tensor_diffs(before, params_snapshot(params))
        check(len(moved) > 0, "the step after the skipped one moved nothing")
        mx.blackbox.disable()
    finally:
        mx.amp._deactivate()
        mx.profiler.set_state("stop")
        mx.profiler.set_config(tensorboard_dir=None,
                               filename="profile.json")
        for plane in (mx.telemetry, mx.insight, mx.blackbox):
            plane.disable()
        mx.fault.clear()
        mx.config.reset()
        net.hybridize(False)
        loss_fn.hybridize(False)
    row = {"card": card, "wrapper_launches_2_steps": wrapper,
           "device_trace_kernels_2_steps": in_trace,
           "operator_spans": sorted(ops), "cached_op_spans": cached,
           "record_memory": mem, "counted_flops_per_step": counted,
           "analytic_flops_per_step": analytic, "flops_rel_diff": rel,
           "six_n_tokens_all_params": 6 * n_params * tokens,
           "n_mm": n_mm, "n_params": n_params, "hybrid_step_ms":
           step_s * 1e3, "insight_mfu": graph["mfu"],
           "nonfinite_skip": fstats, "blackbox_bundle":
           os.path.basename(bundles[0]), "params_moved_after": len(moved)}
    print(f"training under the planes [{card}]: " + json.dumps(row))
    del net
    return row


def np_loop(mx, a, n):
    """``n`` elementwise mx.np ops on ``a``, each one ``_invoke``."""
    for _ in range(n // 2):
        a = a * 1.0001
        a = a + 0.5
    return a


def timed_runs(fn, repeats):
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def phase_disabled_cost(dev, card):
    """The host cost of the planes: off, then telemetry and trace on."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 30: the planes' host cost: a tight eager mx.np loop "
          f"({NP_LOOP_OPS} ops) and phase 27's eager step, every plane off "
          f"and then telemetry and trace on, on {card}", flush=True)
    gpu = mx.gpu(dev.index or 0)
    a = mx.np.ones((64,), ctx=gpu)
    np_loop(mx, a, 200)
    vocab = 50257
    net = GPTForCausalLM(backbone=gpt2_124m(
        vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids = onp.random.RandomState(0).randint(0, vocab,
                                            (TRAIN_BATCH, TRAIN_SEQ + 1))
    x, y = mx.np.array(ids[:, :-1], ctx=gpu), mx.np.array(ids[:, 1:],
                                                          ctx=gpu)
    step = _gpt_step_fn(mx, net, loss_fn, x, y, True)
    labels = {False: "off", True: "telemetry_trace_on"}
    runs = {label: {"loop_s": [], "step_ms": []} for label in
            labels.values()}
    mx.amp.init("bfloat16")
    try:
        for _ in range(3):
            step()
            np_loop(mx, a, NP_LOOP_OPS)
        # in turns (off, on, on, off), twice: the host's clock drifts
        for on in (False, True, True, False) * 2:
            mx.telemetry.enable(on)
            mx.trace.enable(on)
            runs[labels[on]]["loop_s"] += timed_runs(
                lambda: np_loop(mx, a, NP_LOOP_OPS), 2)
            runs[labels[on]]["step_ms"] += [w / 2 * 1e3 for w in timed_runs(
                lambda: [step() for _ in range(2)], 1)]
            mx.trace.clear()
    finally:
        mx.amp._deactivate()
        mx.telemetry.disable()
        mx.telemetry.reset()
        mx.trace.disable()
    out = {"card": card}
    for label, r in runs.items():
        out[label] = dict(r, loop_s_median=float(onp.median(r["loop_s"])),
                          step_ms_median=float(onp.median(r["step_ms"])))
    out["added_us_per_op"] = (out["telemetry_trace_on"]["loop_s_median"]
                              - out["off"]["loop_s_median"]) \
        / NP_LOOP_OPS * 1e6
    out["off_us_per_op"] = out["off"]["loop_s_median"] / NP_LOOP_OPS * 1e6
    print(f"the planes' host cost [{card}]: " + json.dumps(out))
    del net
    return out


# -- the rest of training (phases 31-33) --------------------------------------

#: GluonNLP's BERT pretraining optimizer (phase 31)
LAMB_OPT = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}
#: a master against the float64 LAMB rule: of the tensor's largest value,
#: and of the step's largest magnitude
LAMB_MASTER_TOL, LAMB_STEP_TOL = 1e-5, 1e-2
#: GluonCV's ImageNet ResNet optimizer and label smoothing (phase 32)
NAG_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LABEL_SMOOTHING = 0.1


def trainable_grads(params):
    return [p.grad() for p in params.values() if p.grad_req != "null"]


def lamb_float64_check(params, trainer, forward_backward):
    """One LAMB step against the reference's rule recomputed in float64
    on the card from the step's snapshot (each fp32 master, its clipped
    gradient and its (m, v)): (worst master error of the tensor's largest
    value, worst error of the step's largest magnitude, tensors, whether
    every bf16 weight is its master rounded)."""
    forward_backward()
    opt = trainer.optimizer
    snap = {}
    plist = list(params.values())
    for i, p in enumerate(plist):
        if p.grad_req == "null":
            continue
        master, (m, v) = trainer._updater.states[i]
        snap[i] = [t.detach().double().clone()
                   for t in (master, m, v, p.grad())]
    t = opt.num_update + 1
    rescale = trainer._scale / BERT_BATCH
    trainer.step(BERT_BATCH)
    b1, b2, eps, lr = opt.beta1, opt.beta2, opt.epsilon, opt.learning_rate
    worst_w, worst_step, rounded = 0.0, 0.0, True
    for i, (w, m, v, g) in snap.items():
        g = g * rescale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        r = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps) \
            + opt._get_wd(i) * w
        wn, rn = w.norm(), r.norm()
        ratio = torch.where((wn > 0) & (rn > 0), wn / rn,
                            torch.ones_like(wn))
        ref = w - lr * ratio * r
        master = trainer._updater.states[i][0]
        err = (master.double() - ref).abs().max()
        worst_w = max(worst_w, (err / ref.abs().max().clamp_min(1e-30))
                      .item())
        worst_step = max(worst_step, (err / (ref - w).abs().max()
                                      .clamp_min(1e-30)).item())
        rounded &= torch.equal(plist[i].data(),
                               master.to(plist[i].dtype))
    return worst_w, worst_step, len(snap), rounded


def phase_bert_lamb(dev, card, adamw):
    """BERT-base bf16 pretraining as GluonNLP's script drives it (phase
    31): phase 20's model, batch and dropout; ``wd_mult`` 0 on every beta,
    gamma and bias; LAMB with ``multi_precision`` on the local kvstore;
    ``clip_global_norm`` at 1.0; deferred Accuracy (NSP) and Perplexity
    (MLM) metrics. Eager against hybridized (``hybrid_ab``), the LAMB
    masters against the float64 rule, ``update_on_kvstore=True`` against
    the local update."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    from mxnet_tpu_torch.ops import ln_residual as lr
    print(f"== phase 31: BERT-base bf16 pretraining under LAMB (net.cast, "
          f"wd_mult 0 on beta/gamma/bias, multi_precision LAMB on the "
          f"local kvstore, clip_global_norm 1.0, deferred metrics; batch "
          f"{BERT_BATCH} x seq {BERT_SEQ}) on {card}", flush=True)
    net = BERTForPretraining(
        vocab_size=BERT_VOCAB, units=768, hidden_size=3072, num_layers=12,
        num_heads=12, max_length=512, dropout=0.1, embed_dropout=0.1,
        device=dev).initialize(seed=0)
    net.cast("bfloat16")
    no_decay = net.collect_params(".*beta|.*gamma|.*bias")
    for p in no_decay.values():
        p.wd_mult = 0.0
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    start = params_snapshot(params)
    ids, types, valid, labels, weight, nsp = bert_batch(dev)
    # the masked positions, read once here (no host read in a step)
    sel = weight.reshape(-1).nonzero().squeeze(1)
    mlm_labels = labels.reshape(-1).index_select(0, sel)
    mlm_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = mx.random.default_generator(dev)
    made = {}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def forward_backward():
        with mx.autograd.record():
            mlm, nsp_scores = net(ids, types, valid)
            loss = mlm_loss(mlm, labels, weight) + nsp_loss(nsp_scores, nsp)
        mx.autograd.backward(loss)
        mx.gluon.utils.clip_global_norm(trainable_grads(params), 1.0)
        return loss, mlm, nsp_scores

    def make_step(update_on_kvstore=False):
        trainer = mx.gluon.Trainer(params, "lamb", dict(LAMB_OPT),
                                   kvstore="local",
                                   update_on_kvstore=update_on_kvstore)
        acc = mx.gluon.metric.Accuracy().defer()
        ppl = mx.gluon.metric.Perplexity().defer()
        made.update(trainer=trainer, acc=acc, ppl=ppl)

        def step():
            loss, mlm, nsp_scores = forward_backward()
            trainer.step(BERT_BATCH)
            acc.update([nsp], [nsp_scores])
            probs = torch.softmax(mlm.reshape(-1, BERT_VOCAB)
                                  .index_select(0, sel).float(), -1)
            ppl.update([mlm_labels], [probs])
            check(trainer._fused_update is False,
                  "LAMB took a fused update")
            return loss.detach().mean()
        return step

    tokens = BERT_BATCH * BERT_SEQ
    e2e = hybrid_ab("BERT-base bf16 LAMB", card, [net, mlm_loss, nsp_loss],
                    make_step, restore, params, lambda: mx.random.seed(0),
                    ("ln_residual_fwd", "ln_residual_bwd"),
                    {"ln_residual_fwd": N_LAYERS,
                     "ln_residual_bwd": N_LAYERS}, tokens, BERT_BATCH,
                    6 * n_params * tokens,
                    extra_state=lambda: gen.get_state().tolist())
    metrics = dict([made["acc"].get(), made["ppl"].get()])
    # the main path's eager step by the wrappers' counts
    step = make_step()
    zero_all_counters()
    step()
    torch.cuda.synchronize()
    eager = ln_counters(lr)
    print(f"one eager LAMB step: ln_residual fwd / bwd launches {eager}; "
          f"metrics over the hybrid_ab steps {metrics}")
    check(eager == [N_LAYERS, N_LAYERS], f"phase 31: ln_residual launches "
                                         f"{eager} a step, expected "
                                         f"{N_LAYERS} each")
    check(all(math.isfinite(v) for v in metrics.values())
          and metrics["perplexity"] > 1, f"phase 31 metrics {metrics}")
    # the masters against the float64 rule, on the second step
    restore()
    mx.random.seed(0)
    make_step()()
    worst_w, worst_step, n_checked, rounded = lamb_float64_check(
        params, made["trainer"], forward_backward)
    print(f"LAMB step 2 against the float64 rule: {n_checked} masters, "
          f"worst {worst_w:.3e} of a tensor's largest value, "
          f"{worst_step:.3e} of the step's largest magnitude; bf16 weights "
          f"{'equal' if rounded else 'DIFFER from'} their masters rounded")
    check(worst_w <= LAMB_MASTER_TOL and worst_step <= LAMB_STEP_TOL
          and rounded, f"phase 31: LAMB masters {worst_w:.3e} / "
                       f"{worst_step:.3e} off the float64 rule")
    # update_on_kvstore=True: the same weights as the local update
    after = []
    for on_kv in (False, True):
        restore()
        mx.random.seed(0)
        step = make_step(on_kv)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        check((made["trainer"]._kvstore is not None)
              and made["trainer"]._update_on_kvstore == on_kv,
              "phase 31: the kvstore was not used as asked")
        after.append(params_snapshot(params))
    kv_diffs = tensor_diffs(*after)
    print("update_on_kvstore=True after 2 steps: "
          + ("every weight equal bit for bit to the local update"
             if not kv_diffs else f"{len(kv_diffs)} tensors DIFFER"))
    check(not kv_diffs, f"phase 31: update_on_kvstore differs in "
                        f"{len(kv_diffs)} tensors")
    side = {k: {m: adamw[m][k] for m in ("eager", "hybrid")}
            for k in ("step_ms", "device_ms", "device_busy_share",
                      "host_launch_calls_per_step")}
    print(f"phase 20 (AdamW) beside phase 31 (LAMB), same run [{card}]: "
          + json.dumps({"adamw": side, "lamb": {
              k: {m: e2e[m][k] for m in ("eager", "hybrid")} for k in side}}))
    e2e.update(eager_step_ln_launches=eager, metrics=metrics,
               lamb_master_max_rel_err=worst_w,
               lamb_step_max_rel_err=worst_step,
               lamb_masters_checked=n_checked,
               update_on_kvstore_bit_identical=not kv_diffs,
               adamw_phase_20=side)
    del net, start, after
    return e2e


def phase_resnet_nag(dev, card):
    """ResNet-50 v1 fp32 as GluonCV's ImageNet script drives it (phase
    32): phase 21's model and batch with ``fused_conv_bn`` "auto", NAG
    (momentum 0.9, wd 1e-4), ``SoftmaxCrossEntropyLoss(sparse_label=
    False)`` on labels smoothed by 0.1, deferred Accuracy and
    TopKAccuracy(5); eager against hybridized; the fused NAG against the
    per-parameter Updater on the same gradients."""
    import copy
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import conv_bwd as cb
    print(f"== phase 32: ResNet-50 v1 fp32 under NAG with label smoothing "
          f"{LABEL_SMOOTHING} (fused_conv_bn 'auto', top-1/top-5 metrics; "
          f"batch {RESNET_BATCH} x 3 x {RESNET_SIZE} x {RESNET_SIZE}) on "
          f"{card}", flush=True)
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev).initialize(seed=0)
    x, y = resnet_batch(dev)
    net(x)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values()
                   if p.grad_req != "null")
    start = params_snapshot(params)
    smooth = torch.nn.functional.one_hot(y, RESNET_CLASSES).float() \
        * (1 - LABEL_SMOOTHING) + LABEL_SMOOTHING / RESNET_CLASSES
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)
    made = {}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(start[n])

    def make_step():
        trainer = mx.gluon.Trainer(params, "nag", dict(NAG_OPT))
        acc = mx.gluon.metric.Accuracy().defer()
        top5 = mx.gluon.metric.TopKAccuracy(5).defer()
        made.update(trainer=trainer, acc=acc, top5=top5)

        def step():
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, smooth)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            check(trainer._fused_update, "NAG did not take the fused "
                                         "update")
            acc.update([y], [out])
            top5.update([y], [out])
            return loss.detach().mean()
        return step

    e2e = hybrid_ab("ResNet-50 fp32 NAG", card, [net, loss_fn], make_step,
                    restore, params, lambda: None,
                    ("conv_bwd_wsplit_kernel", "conv_bwd_dgrad_kernel",
                     "conv_bwd_wgrad_kernel"),
                    {"conv_bwd_wsplit_kernel": RESNET_TRIPLETS,
                     "conv_bwd_dgrad_kernel": RESNET_TRIPLETS,
                     "conv_bwd_wgrad_kernel": RESNET_TRIPLETS},
                    RESNET_BATCH, RESNET_BATCH,
                    RESNET_BATCH * RESNET50_TRAIN_FLOPS, deterministic=True)
    metrics = dict([made["acc"].get(), made["top5"].get()])
    step = make_step()
    zero_all_counters()
    step()
    torch.cuda.synchronize()
    eager = cb.fused_conv3x3_bn_relu_bwd.launches
    print(f"one eager NAG step: kernel 8 launches {eager}; metrics over "
          f"the hybrid_ab steps {metrics}")
    check(eager == RESNET_TRIPLETS, f"phase 32: kernel 8 launched {eager} "
                                    f"times a step, expected "
                                    f"{RESNET_TRIPLETS}")
    check(all(0 <= v <= 1 for v in metrics.values()), f"phase 32 metrics "
                                                      f"{metrics}")
    # the fused NAG against the per-parameter Updater, the same gradients
    grads = {n: p.grad().detach().clone() for n, p in params.items()
             if p.grad_req != "null"}
    nets = [copy.deepcopy(net), copy.deepcopy(net)]
    trainers = [mx.gluon.Trainer(n.collect_params(), "nag", dict(NAG_OPT))
                for n in nets]
    trainers[1]._fused_update = False
    plist = [n.collect_params() for n in nets]
    for s in range(3):
        for ps in plist:
            for n, g in grads.items():
                ps[n].data().grad = g * (1 + s)
        for tr in trainers:
            tr.step(RESNET_BATCH)
    torch.cuda.synchronize()
    same = tensor_diffs(params_snapshot(plist[0]), params_snapshot(plist[1]))
    states = sum(not torch.equal(a, b) for i, a in
                 trainers[0]._updater.states.items()
                 for b in [trainers[1]._updater.states[i]] if a is not None)
    print(f"fused NAG against the per-parameter Updater, 3 steps of the "
          f"same gradients: weights "
          + ("equal bit for bit" if not same else f"{len(same)} DIFFER")
          + f", momentum buffers differing: {states}")
    check(trainers[0]._fused_update and not same and not states,
          f"phase 32: the fused NAG differs from the per-parameter rule "
          f"({len(same)} weights, {states} states)")
    e2e.update(eager_step_kernel8_launches=eager, metrics=metrics,
               fused_nag_bit_identical=not same and not states)
    del net, nets, trainers, plist, start, grads
    return e2e


#: phase 34: images in the .rec, loader workers, the preempted step, the
#: loader's normalization (ImageNet's), the timed loader-fed steps
PIPE_IMAGES, PIPE_WORKERS, PIPE_PREEMPT, PIPE_SEED = 512, 4, 5, 34
PIPE_MEAN, PIPE_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
PIPE_TIMED = 12
#: phase 35: sequences in the shards, the shards, the step whose bundle
#: the restart restores
STREAM_RECORDS, STREAM_SHARDS, STREAM_SAVE_AT, STREAM_SEED = 96, 4, 4, 35


def pipe_rec(root):
    """PIPE_IMAGES seeded 224 x 224 x 3 uint8 images and labels of
    RESNET_CLASSES classes in one .rec / .idx pair (the .npy codec)."""
    from mxnet_tpu_torch import recordio
    rec = os.path.join(root, "train.rec")
    rs = onp.random.RandomState(PIPE_SEED)
    w = recordio.MXIndexedRecordIO(os.path.join(root, "train.idx"), rec, "w")
    for i in range(PIPE_IMAGES):
        img = rs.randint(0, 256, (RESNET_SIZE, RESNET_SIZE, 3),
                         dtype=onp.uint8)
        label = float(rs.randint(RESNET_CLASSES))
        w.write_idx(i, recordio.pack_img((0, label, i, 0), img,
                                         img_fmt=".npy"))
    w.close()
    return rec


def pipe_loader(mx, rec, threads=False):
    """Phase 34's loader; numpy's global state and mx.random are seeded
    first, since ``shuffle=True`` draws each epoch's order from the one
    and the loader each epoch's augmentation seed from the other."""
    T = mx.gluon.data.vision.transforms
    onp.random.seed(PIPE_SEED)
    mx.random.seed(PIPE_SEED)
    ds = mx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
        T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                   T.Normalize(PIPE_MEAN, PIPE_STD)]))
    return mx.gluon.data.DataLoader(
        ds, batch_size=RESNET_BATCH, shuffle=True, num_workers=PIPE_WORKERS,
        thread_pool=threads, pin_memory=True, prefetch_to_device=True,
        last_batch="discard")


def loss_recorder(est, sync_at=()):
    """A batch-end handler keeping each step's mean loss on the card (read
    after the fit: no host sync in the loop) and the host time of each
    batch end; at the batch ends numbered in ``sync_at`` (from 1) it
    waits for the card first, so that a time taken there closes a step
    (a timed window)."""
    class Recorder(est.BatchEnd):
        # after the optimizer step (-2000), before the ResilienceHandler
        # (-1500), which raises Preempted at its batch end
        priority = -1600

        def __init__(self):
            self.losses, self.times = [], []

        def batch_end(self, estimator, *args, **kwargs):
            self.losses.append(kwargs["loss"][0]._data.detach().mean())
            if len(self.losses) in sync_at:
                torch.cuda.synchronize()
            self.times.append(time.perf_counter())

        def step_ms(self):
            """ms a step from the first synced batch end to the last."""
            a, b = (self.times[i - 1] for i in sync_at)
            return (b - a) / (sync_at[1] - sync_at[0]) * 1e3
    return Recorder()


def smoothed_processor(mx, est):
    """Phase 32's step as an Estimator batch processor: int labels smoothed
    by LABEL_SMOOTHING on the card, SoftmaxCrossEntropyLoss(sparse_label=
    False)."""
    class Smoothed(est.BatchProcessor):
        def fit_batch(self, estimator, batch, batch_axis=0):
            x, y = batch
            label = y._data.long()
            smooth = torch.nn.functional.one_hot(
                label, RESNET_CLASSES).float() * (1 - LABEL_SMOOTHING) \
                + LABEL_SMOOTHING / RESNET_CLASSES
            with mx.autograd.record():
                pred = estimator.net(x)
                loss = estimator.loss(pred, smooth)
            mx.autograd.backward(loss)
            return [x], [label], [pred], [loss]
    return Smoothed()


def copy_overlap(events):
    """(host-to-device copy ms, of it the ms overlapping a compute kernel)
    of profiler device events: a copy on the prefetcher's side stream runs
    while the step's kernels run on the consumer's."""
    copies, kernels = [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(r)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(r)
    kernels.sort()
    total = over = 0.0
    for a, b in copies:
        total += b - a
        cover = []
        for ka, kb in kernels:
            if kb <= a:
                continue
            if ka >= b:
                break
            cover.append((max(a, ka), min(b, kb)))
        end = a
        for ca, cb in sorted(cover):
            if cb > end:
                over += cb - max(ca, end)
                end = cb
    return total / 1e3, over / 1e3


def profiled_fit(fn, names=()):
    """One call of ``fn()`` under ``torch.profiler``, the card synchronized
    after it: {"compute_ms": device ms of the compute kernels, "copy_ms":
    host-to-device copy ms, "overlap_ms": the part of it overlapping
    compute, "syncs": cudaStreamSynchronize and cudaDeviceSynchronize
    calls made while ``fn()`` ran (a host read in the loop makes one),
    "staging_waits": cudaEventSynchronize calls then (the prefetch
    thread's waits on a staging buffer), "syncs_after": the synchronizing
    calls after it (the window's own closing synchronize: proof that the
    profiler records such calls), "kernels": {name: device kernels whose
    names contain it} for ``names``, "value": what ``fn()`` returned}.
    The window's span is a ``record_function``, whose annotation on each
    stream the card ran is left out of the device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = "chip_smoke.fed_window"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(mark):
            value = fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == mark and e.device_type != DeviceType.CUDA)
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and e.name != mark]
    syncs = [(e.name, e.time_range.start) for e in events
             if e.device_type != DeviceType.CUDA and e.name in SYNC_CALLS]
    inside = [n for n, t in syncs if span.start <= t <= span.end]
    copy_ms, overlap_ms = copy_overlap(dev)
    return {"compute_ms": sum(
                e.time_range.elapsed_us() for e in dev
                if "Memcpy" not in e.name and "Memset" not in e.name) / 1e3,
            "copy_ms": copy_ms, "overlap_ms": overlap_ms,
            "syncs": sum(n != "cudaEventSynchronize" for n in inside),
            "staging_waits": inside.count("cudaEventSynchronize"),
            "syncs_after": sum(t > span.end for _, t in syncs),
            "kernels": {n: sum(n in e.name for e in dev) for n in names},
            "value": value}


def fed_window(label, fn, steps, want, blocks):
    """:func:`profiled_fit` of ``fn()``, which runs ``steps`` steps of a
    path fed from disk: the launches of the kernels of ``want`` ({name: a
    step}) by their device events (a replay runs no wrapper, so no
    counter moves). The profiler drops events now and then: a window
    short of ``want`` is measured again, up to three windows, each
    printed; the last is returned. The hybridized ``blocks`` must not
    capture in it (the window replays their graphs)."""
    captures = graph_stats(blocks)["captures"]
    for window in range(3):
        r = profiled_fit(fn, tuple(want))
        print(f"  {label}: profiled window {window + 1} of {steps} fed "
              f"steps: kernel events {r['kernels']}")
        if all(r["kernels"][n] == want[n] * steps for n in want):
            break
    check(graph_stats(blocks)["captures"] == captures,
          f"{label}: the fed window captured again instead of replaying")
    return r


def phase_resnet_pipeline(dev, card):
    """ResNet-50 v1 fp32 fed from a RecordIO file through the loader's
    spawned workers, the shared-memory ring and the pinned side-stream
    prefetcher, driven by Estimator.fit with a ResilienceHandler (phase
    34)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib import estimator as est
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.numpy.multiarray import _wrap
    print(f"== phase 34: ResNet-50 v1 fp32 fed from a .rec of {PIPE_IMAGES} "
          f"images (batch {RESNET_BATCH} x 3 x {RESNET_SIZE} x "
          f"{RESNET_SIZE}, {PIPE_WORKERS} spawned workers, pinned "
          f"side-stream prefetch, Estimator + ResilienceHandler) on {card}",
          flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase34_")
    out = {}
    try:
        t0 = time.perf_counter()
        rec = pipe_rec(root)
        out["rec_bytes"] = os.path.getsize(rec)
        out["rec_write_s"] = time.perf_counter() - t0
        # the loader alone: a second epoch (pools warm) of each mode
        rates = {}
        for mode in ("threads", "processes"):
            loader = pipe_loader(mx, rec, threads=mode == "threads")
            check(loader._resolve_worker_mode() == mode,
                  f"phase 34: the loader took {loader._resolve_worker_mode()}")
            for _ in range(2):
                t0 = time.perf_counter()
                n = 0
                for x, y in loader:
                    n += x.shape[0]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            check(x._data.device == dev and x.shape == (
                RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)
                and x.dtype == onp.float32,
                f"phase 34: a batch is {x.shape} {x.dtype} on {x._data.device}")
            rates[mode] = n / secs
            loader.close()
        out["loader_images_per_s"] = rates
        print(f"the loader alone, {PIPE_WORKERS} workers, a second epoch of "
              f"{n} images to the card: " + ", ".join(
                  f"{m} {r:.1f} images/s" for m, r in rates.items()))

        warm = torch.zeros(1, 3, RESNET_SIZE, RESNET_SIZE, device=dev)

        def make(bundle):
            net = resnet50_v1(classes=RESNET_CLASSES,
                              device=dev).initialize(seed=0)
            net(warm)  # the deferred shapes, before any capture
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss(
                sparse_label=False)
            net.hybridize()
            loss_fn.hybridize()
            trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                                       dict(NAG_OPT))
            loader = pipe_loader(mx, rec)
            e = est.Estimator(
                net, loss_fn,
                train_metrics=[mx.gluon.metric.Accuracy().defer()],
                trainer=trainer,
                batch_processor=smoothed_processor(mx, est))
            e.train_metrics[-1] = e.train_metrics[-1].defer()
            return e, loader, est.ResilienceHandler(bundle, loader=loader)

        steps = PIPE_IMAGES // RESNET_BATCH
        cudnn_default = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            e, loader, rh = make(os.path.join(root, "whole.bundle"))
            rec_truth = loss_recorder(est)
            zero_all_counters()
            e.fit(loader, epochs=1, event_handlers=[rh, rec_truth])
            torch.cuda.synchronize()
            main_launches = all_launches()
            truth = [v.item() for v in rec_truth.losses]
            final = params_snapshot(e.net.collect_params())
            loader.close()
            check(len(truth) == steps and rh.state.step == steps,
                  f"phase 34: {len(truth)} steps in the epoch, expected "
                  f"{steps}")
            check(main_launches[7] > 0, "phase 34: kernel 8 never launched "
                                        "on the loader-fed path")
            bundle = os.path.join(root, "run.bundle")
            e, loader, rh = make(bundle)
            first = loss_recorder(est)
            mx.fault.configure(f"resilience.preempt:at={PIPE_PREEMPT}")
            try:
                e.fit(loader, epochs=1, event_handlers=[rh, first])
                fail("phase 34: the preemption did not stop the fit")
            except mx.resilience.Preempted as p:
                check(p.step == PIPE_PREEMPT and p.path == bundle,
                      f"phase 34: preempted at {p.step} into {p.path}")
            finally:
                mx.fault.clear()
                mx.resilience.clear_preempt()
            loader.close()
            head = [v.item() for v in first.losses]
            del e, loader, rh, first
            gc.collect()
            torch.cuda.empty_cache()
            e, loader, rh = make(bundle)
            after = loss_recorder(est)
            e.fit(loader, epochs=1, event_handlers=[rh, after])
            torch.cuda.synchronize()
            rest = [v.item() for v in after.losses]
            diffs = tensor_diffs(final, params_snapshot(
                e.net.collect_params()))
        finally:
            torch.backends.cudnn.deterministic = cudnn_default
        same = head == truth[:PIPE_PREEMPT] and rest == truth[PIPE_PREEMPT:]
        print(f"uninterrupted losses {truth}; preempted at step "
              f"{PIPE_PREEMPT} and resumed: " + (
                  "every loss equal bit for bit" if same else
                  f"DIFFER: {head} + {rest}") + "; weights at the end "
              + ("equal bit for bit" if not diffs else
                 f"differ in {len(diffs)} tensors"))
        check(rh.resumed and same and not diffs,
              f"phase 34: the resumed run differs from the uninterrupted "
              f"one ({len(diffs)} tensors)")
        check(all(math.isfinite(v) for v in truth), "phase 34: a loss is "
                                                    "not finite")
        out.update(losses=truth, resume_bit_identical=True,
                   wrapper_launches_uninterrupted_epoch=main_launches[7])
        # the bundle: bytes, save and load seconds
        path = os.path.join(root, "timed.bundle")
        t0 = time.perf_counter()
        rh.state.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rh.state.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        out.update(bundle_bytes=os.path.getsize(path), bundle_save_s=save_s,
                   bundle_load_s=load_s)
        # the timed steps, with the default algorithms: Estimator.fit fed by
        # the loader and fed by a list repeating one batch already on the
        # card, in turns; the same handlers, so the difference is the
        # loader's
        net, loss_fn, trainer = e.net, e.loss, e.trainer
        for blk in (net, loss_fn):
            blk._clear_cached_graphs()
        xd, yd = resnet_batch(dev)
        dev_batch = (_wrap(xd), _wrap(yd.float()))

        def fit_on(source, n, sync_at=()):
            """Estimator.fit over ``n`` batches of ``source``."""
            rec_n = loss_recorder(est, sync_at)
            e.fit(source, batches=n, event_handlers=[rec_n])
            return rec_n

        def source(kind, n):
            return loader if kind == "loader" else [dev_batch] * n

        for kind in ("loader", "device_batch"):
            fit_on(source(kind, 2), 2)  # captures with the default algorithms
        torch.cuda.synchronize()
        rows = {"loader": [], "device_batch": []}
        n = PIPE_TIMED + 1
        mx.telemetry.enable()
        mx.telemetry.reset()
        try:
            for kind in ("loader", "device_batch", "device_batch",
                         "loader") * 3:
                # from the end of a finished first step to the end of a
                # finished last one: the start-up of the epoch and the
                # loader's teardown after the fit stay out
                rows[kind].append(
                    fit_on(source(kind, n), n, (1, n)).step_ms())
            torch.cuda.synchronize()
            hist = mx.telemetry.snapshot()["histograms"].get(
                "pipeline.input_stall_seconds", {})
        finally:
            mx.telemetry.disable()
            mx.telemetry.reset()
        with mx.pipeline.sync_guard() as guard:
            fit_on(loader, PIPE_TIMED)
        torch.cuda.synchronize()
        fed = fed_window("phase 34", lambda: fit_on(loader, PIPE_TIMED),
                         PIPE_TIMED,
                         {"conv_bwd_dgrad_kernel": RESNET_TRIPLETS},
                         (net, loss_fn))
        ctl = profiled_fit(
            lambda: fit_on(source("device_batch", PIPE_TIMED), PIPE_TIMED))
        loader.close()
        fed_ms = float(onp.median(rows["loader"]))
        dev_wall = float(onp.median(rows["device_batch"]))
        fed_dev = fed["compute_ms"] / PIPE_TIMED
        dev_ms = ctl["compute_ms"] / PIPE_TIMED
        window = fed["kernels"]
        out.update(
            step_ms_loader=fed_ms, step_ms_loader_runs=rows["loader"],
            step_ms_device_batch=dev_wall,
            step_ms_device_batch_runs=rows["device_batch"],
            input_pipeline_cost_ms=fed_ms - dev_wall,
            device_ms_loader=fed_dev, device_ms_device_batch=dev_ms,
            busy_share_loader=busy_share(fed_dev, fed_ms),
            busy_share_device_batch=busy_share(dev_ms, dev_wall),
            input_stall_seconds={"count": hist.get("count"),
                                 "sum": hist.get("sum"),
                                 "quantiles": hist.get("quantiles")},
            h2d_copy_ms=fed["copy_ms"],
            h2d_copy_overlapping_compute_ms=fed["overlap_ms"],
            staging_waits=fed["staging_waits"],
            host_syncs_sync_guard=guard.count,
            host_sync_calls_loop=fed["syncs"],
            host_sync_calls_device_batch=ctl["syncs"],
            host_sync_calls_after_loop=fed["syncs_after"],
            launch_window_steps=PIPE_TIMED,
            launch_window_kernel_events=window)
        print(f"phase 34 [{card}]: " + json.dumps(out))
        check(window["conv_bwd_dgrad_kernel"] == RESNET_TRIPLETS
              * PIPE_TIMED, f"phase 34: kernel 8 events {window} in "
                            f"{PIPE_TIMED} loader-fed steps, expected "
                            f"{RESNET_TRIPLETS} a step")
        check(guard.count == 0 and fed["syncs"] == 0
              and fed["syncs_after"] >= 1,
              f"phase 34: host syncs in the fit loop: guard {guard.sites}, "
              f"{fed['syncs']} synchronizing runtime calls (and "
              f"{fed['syncs_after']} after it, where the window's closing "
              f"synchronize is one)")
        check(fed["copy_ms"] > 0 and fed["overlap_ms"] > 0,
              f"phase 34: host-to-device copies {fed['copy_ms']:.3f} ms, "
              f"{fed['overlap_ms']:.3f} ms of it beside compute")
        check(hist.get("count"), "phase 34: no input stall was recorded")
        del e, net, loss_fn, trainer
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _split_tokens(payload):
    """A stream record -> (inputs, next-token labels), int32."""
    from mxnet_tpu_torch import stream
    seq = stream.unpack_sample(payload)
    return seq[:-1], seq[1:]


def phase_gpt_stream(dev, card):
    """GPT-2 124M bf16 fed from checksummed stream shards, driven by
    resilience.run through an injected shard loss (phase 35)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import stream
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, gpt2_124m
    print(f"== phase 35: GPT-2 124M bf16 fed from {STREAM_SHARDS} stream "
          f"shards of {STREAM_RECORDS} sequences (batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, hybridized, resilience.run) on {card}", flush=True)
    vocab = 50257
    root = tempfile.mkdtemp(prefix="chip_smoke_phase35_")
    out = {}
    try:
        rs = onp.random.RandomState(STREAM_SEED)
        with stream.ShardWriter(root, STREAM_SHARDS) as w:
            for _ in range(STREAM_RECORDS):
                w.append(stream.pack_sample(
                    rs.randint(0, vocab, TRAIN_SEQ + 1).astype(onp.int32)))
        manifest = stream.ShardManifest.load(root)
        check(stream.validate_manifest(manifest)["ok"],
              "phase 35: the shards do not validate")
        steps = STREAM_RECORDS // TRAIN_BATCH
        mx.config.set("stream.open_backoff", 0.001)
        net = GPTForCausalLM(backbone=gpt2_124m(
            vocab_size=vocab, max_length=TRAIN_SEQ, dropout=0.0,
            embed_dropout=0.0, device=dev)).initialize(seed=0)
        params = net.collect_params()
        start = params_snapshot(params)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        mx.amp.init("bfloat16")
        net.hybridize()
        loss_fn.hybridize()

        def step_on(trainer, x, y):
            with mx.autograd.record():
                loss = loss_fn(net(x._data.long()), y._data.long())
            mx.autograd.backward(loss)
            trainer.step(TRAIN_BATCH)
            return loss.detach().mean()

        def run(inject, batches=None):
            """One resilience.run of the stream-fed loop (or of the same
            loop over ``batches``): (losses by step, the steps done at
            each entry, ms a step from a finished first step to a
            finished last one, the loader, the trainer)."""
            with torch.no_grad():
                for n, p in params.items():
                    p.data().copy_(start[n])
            trainer = mx.gluon.Trainer(params, "adamw",
                                       {"learning_rate": 1e-4, "wd": 0.01})
            ds = stream.StreamDataset(manifest, transform=_split_tokens)
            # thread workers share the dataset's shard readers, so the
            # injection below reaches them; 2 batches in the pump and 1 in
            # the device queue keep the fetches after step STREAM_SAVE_AT
            # behind the injection
            loader = mx.gluon.data.DataLoader(
                ds, batch_sampler=stream.StreamSampler(
                    manifest, batch_size=TRAIN_BATCH, seed=STREAM_SEED),
                num_workers=2, thread_pool=True, prefetch=2,
                prefetch_to_device=True, device_prefetch_depth=1)
            state = mx.resilience.TrainState(
                net=net, trainer=trainer, loader=loader,
                path=os.path.join(root, f"run{int(inject)}.bundle"))
            losses, entries, ends = {}, [], []

            def train():
                entries.append(state.step)
                for x, y in (loader if batches is None else batches):
                    loss = step_on(trainer, x, y)
                    state.step += 1
                    losses[state.step] = loss
                    if len(ends) in (0, steps - 1):
                        torch.cuda.synchronize()  # the timed span's ends
                    ends.append(time.perf_counter())
                    if inject and state.step == STREAM_SAVE_AT \
                            and len(entries) == 1:
                        state.save()
                        # the next shard open fails past the retry budget
                        ds._readers.clear()
                        mx.fault.configure(
                            "stream.shard_unreadable:prob=1,times="
                            f"{mx.config.get('stream.open_retries') + 1}")
                return state.step

            try:
                mx.resilience.run(train, state=state, max_restarts=1)
            finally:
                mx.fault.clear()
            wall = (ends[steps - 1] - ends[0]) / (steps - 1)
            loader.close()
            return ({k: v.item() for k, v in losses.items()}, entries,
                    wall * 1e3, loader, trainer)

        try:
            zero_all_counters()
            truth, _, _, loader, _ = run(False)
            main_launches = all_launches()
            mx.fault.reset_stats()
            got, entries1, _, _, _ = run(True)
            stats = mx.fault.stats()
            # the stream-fed loop and the same loop over a list repeating
            # one batch already on the card, in turns
            x, y = next(iter(loader))
            loader.close()
            rows = {"stream": [], "device_batch": []}
            for kind in ("stream", "device_batch", "device_batch", "stream"):
                rows[kind].append(run(False, None if kind == "stream"
                                      else [(x, y)] * steps)[2])
            fed = fed_window(
                "phase 35", lambda: run(False)[0], steps,
                {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
                 "flash_bwd_dq": N_LAYERS}, (net, loss_fn))
        finally:
            mx.amp._deactivate()
            mx.config.reset("stream.open_backoff")
            net.hybridize(False)
            loss_fn.hybridize(False)
        same = [got[k] for k in range(1, steps + 1)] == \
            [truth[k] for k in range(1, steps + 1)]
        print(f"uninterrupted losses {[truth[k] for k in sorted(truth)]}; "
              f"entries of the restarted run {entries1} (steps done at "
              f"each), events {stats}; losses "
              + ("equal bit for bit" if same else "DIFFER"))
        check(len(truth) == steps, f"phase 35: {len(truth)} steps")
        check(entries1 == [0, STREAM_SAVE_AT] and same,
              f"phase 35: the restarted run entered at {entries1} or its "
              f"losses differ")
        check(stats.get("resilience.restart") == 1
              and stats.get("stream.shard_lost") == 1,
              f"phase 35: recovery events {stats}")
        window = fed["kernels"]
        check(all(n > 0 for n in main_launches[:3]),
              f"phase 35: flash wrapper launches {main_launches[:3]}")
        check(all(window[n] == N_LAYERS * steps for n in window),
              f"phase 35: flash events {window} in {steps} stream-fed "
              f"steps, expected {N_LAYERS} each a step")
        check(fed["value"] == truth, "phase 35: the profiled stream-fed "
                                     "run's losses differ from the first")
        stream_ms = float(onp.median(rows["stream"]))
        dev_wall = float(onp.median(rows["device_batch"]))
        fed_dev = fed["compute_ms"] / steps
        out.update(losses=[truth[k] for k in sorted(truth)],
                   resume_bit_identical=True, recovery_events=stats,
                   wrapper_launches_uninterrupted_epoch=main_launches[:3],
                   step_ms_stream=stream_ms,
                   step_ms_stream_runs=rows["stream"],
                   step_ms_device_batch=dev_wall,
                   step_ms_device_batch_runs=rows["device_batch"],
                   device_ms_stream=fed_dev,
                   busy_share_stream=busy_share(fed_dev, stream_ms),
                   launch_window_steps=steps,
                   launch_window_kernel_events=window)
        print(f"phase 35 [{card}]: " + json.dumps(out))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: phase 33's tolerance, card against the port's CPU result (fp32 through
#: other kernels and summation orders)
SURFACE_TOL = dict(rtol=1e-4, atol=1e-5)
#: a small setting of each optimizer (3 steps, wd on all but GroupAdaGrad)
SURFACE_OPT = {"nag": {"momentum": 0.9}, "signum": {"momentum": 0.5},
               "rmsprop": {"centered": True}, "lars": {"momentum": 0.9},
               "dcasgd": {"momentum": 0.9}, "sgd": {"momentum": 0.9},
               "lamb": {"lower_bound": 0.1, "upper_bound": 10.0}}
FUSED_FAMILY = ("sgd", "nag", "adam", "adamw", "adamax", "adabelief",
                "nadam")


def surface_optimizers(mx, dev):
    """Every registered optimizer, 3 steps on the card and on the CPU
    (fp32, and bf16 weights with ``multi_precision``); the fused
    families also through the Trainer, fused against per-parameter on the
    card, bit for bit. Returns {case: worst relative difference}."""
    from mxnet_tpu_torch.optimizer.optimizer import _registry
    out = {}
    rs = onp.random.RandomState(0)
    ws = [rs.randn(64, 33).astype("float32"), rs.randn(17, 3)
          .astype("float32")]
    gs = [[rs.randn(*w.shape).astype("float32") for w in ws]
          for _ in range(3)]
    noise = [[rs.randn(*w.shape).astype("float32") for w in ws]
             for _ in range(3)]
    for name in sorted(_registry):
        kw = dict(SURFACE_OPT.get(name, {}), learning_rate=0.01,
                  clip_gradient=2.0, rescale_grad=0.5,
                  wd=0.0 if name == "groupadagrad" else 0.01)
        for dtype in (torch.float32, torch.bfloat16):
            res = []
            for d in (dev, torch.device("cpu")):
                opt = mx.optimizer.create(
                    name, multi_precision=dtype != torch.float32, **kw)
                opt.set_lr_mult({1: 0.5})
                if name == "sgld":
                    flat = iter([n for step in noise for n in step])
                    opt._noise = lambda w, f=flat: torch.from_numpy(
                        next(f)).to(w.device, w.dtype)
                up = mx.optimizer.get_updater(opt)
                tw = [torch.from_numpy(w.copy()).to(d, dtype) for w in ws]
                for step in gs:
                    for i, g in enumerate(step):
                        up(i, torch.from_numpy(g).to(d, dtype), tw[i])
                masters = [s[0] if dtype != torch.float32 else w
                           for s, w in zip(
                               [up.states.get(i) for i in range(2)], tw)]
                res.append((tw, masters))
            label = f"{name}_{'fp32' if dtype == torch.float32 else 'bf16'}"
            worst = 0.0
            for a, b in zip(res[0][1], res[1][1]):
                a = a.float().cpu()
                b = b.float()
                check(torch.allclose(a, b, **SURFACE_TOL),
                      f"phase 33: {label} card and CPU differ by "
                      f"{(a - b).abs().max().item():.3e}")
                worst = max(worst, ((a - b).abs().max()
                                    / b.abs().max()).item())
            if dtype != torch.float32:
                for a, b in zip(*res[0]):
                    check(torch.equal(a, b.to(a.dtype)), f"phase 33: "
                          f"{label}: a bf16 weight is not its master")
            out[label] = worst
    # the fused families: fused against per-parameter, on the card
    for name in FUSED_FAMILY:
        kw = dict(SURFACE_OPT.get(name, {}), learning_rate=0.01, wd=0.01,
                  clip_gradient=2.0)
        nets, trainers = [], []
        for fused in (True, False):
            net = mx.gluon.nn.HybridSequential()
            net.add(mx.gluon.nn.Dense(33, in_units=64, device=dev),
                    mx.gluon.nn.Dense(3, in_units=33, device=dev))
            net.initialize(seed=1)
            tr = mx.gluon.Trainer(net.collect_params(), name, dict(kw))
            if not fused:
                tr._fused_update = False
            nets.append(net)
            trainers.append(tr)
        for s in range(3):
            for net in nets:
                for j, p in enumerate(net.collect_params().values()):
                    gen = torch.Generator(device=dev).manual_seed(10 * s + j)
                    p.data().grad = torch.randn(p.shape, device=dev,
                                                generator=gen)
            for tr in trainers:
                tr.step(2)
        diffs = tensor_diffs(params_snapshot(nets[0].collect_params()),
                             params_snapshot(nets[1].collect_params()))
        check(trainers[0]._fused_update and not diffs,
              f"phase 33: fused {name} differs from its per-parameter rule "
              f"in {len(diffs)} tensors")
        out[f"{name}_fused_bit_identical"] = not diffs
    return out


def surface_losses(mx):
    """{loss: (forward factory, inputs)}: every new loss of this slice and
    the dense-label softmax loss."""
    L = mx.gluon.loss
    rs = onp.random.RandomState(1)
    p = rs.randn(6, 7).astype("float32")
    lab = rs.randn(6, 7).astype("float32")
    sign = onp.sign(rs.randn(6, 7)).astype("float32")
    binary = (rs.rand(6, 7) > 0.5).astype("float32")
    prob = rs.uniform(0.05, 0.95, (6, 7)).astype("float32")
    smooth = onp.full((6, 7), 0.1 / 6, "float32")
    smooth[onp.arange(6), rs.randint(0, 7, 6)] += 0.9
    ctc_p = rs.randn(3, 10, 5).astype("float32")
    ctc_l = onp.array([[1, 2, 2], [3, 0, 0], [4, 1, 3]], "int32")
    return {
        "L2Loss": (L.L2Loss(), [p], [lab]),
        "L1Loss": (L.L1Loss(), [p], [lab]),
        "HuberLoss": (L.HuberLoss(rho=0.5), [p], [lab]),
        "SigmoidBCELoss": (L.SigmoidBCELoss(), [p], [binary]),
        "SigmoidBCELoss_from_sigmoid": (L.SigmoidBCELoss(from_sigmoid=True),
                                        [prob], [binary]),
        "SoftmaxCELoss_dense": (L.SoftmaxCELoss(sparse_label=False), [p],
                                [smooth]),
        "KLDivLoss": (L.KLDivLoss(from_logits=False), [p], [prob]),
        "CTCLoss": (L.CTCLoss(), [ctc_p], [ctc_l]),
        "HingeLoss": (L.HingeLoss(), [p], [sign]),
        "SquaredHingeLoss": (L.SquaredHingeLoss(), [p], [sign]),
        "LogisticLoss": (L.LogisticLoss(), [p], [sign]),
        "TripletLoss": (L.TripletLoss(), [p], [lab, prob]),
        "CosineEmbeddingLoss": (L.CosineEmbeddingLoss(), [p, lab],
                                [sign[:, 0]]),
        "PoissonNLLLoss": (L.PoissonNLLLoss(compute_full=True), [p * 0.3],
                           [onp.round(prob * 3)]),
        "SDMLLoss": (L.SDMLLoss(), [p, lab], []),
    }


def surface_layers(mx):
    """{layer: (block factory, input shapes)}: the layers of this slice."""
    nn = mx.gluon.nn
    return {
        "LeakyReLU": (lambda: nn.LeakyReLU(0.2), [(4, 6)]),
        "PReLU": (lambda: nn.PReLU(in_channels=6), [(4, 6)]),
        "ELU": (lambda: nn.ELU(), [(4, 6)]),
        "SELU": (lambda: nn.SELU(), [(4, 6)]),
        "GELU": (lambda: nn.GELU(), [(4, 6)]),
        "GELU_tanh": (lambda: nn.GELU("tanh"), [(4, 6)]),
        "SiLU": (lambda: nn.SiLU(), [(4, 6)]),
        "Swish": (lambda: nn.Swish(1.5), [(4, 6)]),
        "LayerNorm_axis1": (lambda: nn.LayerNorm(axis=1), [(3, 5, 4)]),
        "GroupNorm": (lambda: nn.GroupNorm(2), [(2, 4, 3, 3)]),
        "InstanceNorm": (lambda: nn.InstanceNorm(scale=True), [(2, 3, 5)]),
        "BatchNormReLU": (lambda: nn.BatchNormReLU(), [(4, 3, 5, 5)]),
        "SyncBatchNorm": (lambda: nn.SyncBatchNorm(), [(4, 3, 5, 5)]),
        "HybridConcatenate": (lambda: _concat(nn), [(4, 6)]),
        "Conv1D": (lambda: nn.Conv1D(4, 3, padding=1), [(2, 3, 9)]),
        "Conv3D": (lambda: nn.Conv3D(2, 2), [(1, 2, 4, 4, 4)]),
        "Conv1DTranspose": (lambda: nn.Conv1DTranspose(3, 3, strides=2),
                            [(2, 4, 5)]),
        "Conv2DTranspose": (lambda: nn.Conv2DTranspose(
            4, 3, strides=2, padding=1, groups=2), [(2, 4, 5, 5)]),
        "Conv3DTranspose": (lambda: nn.Conv3DTranspose(2, 2, strides=2),
                            [(1, 3, 3, 3, 3)]),
        "DeformableConvolution": (lambda: nn.DeformableConvolution(
            4, 3, padding=1), [(2, 3, 6, 6)]),
        "ModulatedDeformableConvolution": (
            lambda: nn.ModulatedDeformableConvolution(4, 3, padding=1),
            [(2, 3, 6, 6)]),
        "MaxPool1D": (lambda: nn.MaxPool1D(3, 2, 1), [(2, 3, 10)]),
        "AvgPool2D_ceil": (lambda: nn.AvgPool2D(3, 2, 1, ceil_mode=True,
                                                count_include_pad=False),
                           [(2, 3, 7, 7)]),
        "AvgPool3D": (lambda: nn.AvgPool3D(2), [(1, 2, 4, 4, 4)]),
        "GlobalMaxPool2D": (lambda: nn.GlobalMaxPool2D(), [(2, 3, 4, 5)]),
        "GlobalAvgPool1D": (lambda: nn.GlobalAvgPool1D(), [(2, 3, 6)]),
        "ReflectionPad2D": (lambda: nn.ReflectionPad2D(2), [(1, 2, 5, 6)]),
        "PixelShuffle2D": (lambda: nn.PixelShuffle2D((2, 3)),
                           [(2, 12, 3, 4)]),
        "PixelShuffle3D": (lambda: nn.PixelShuffle3D(2),
                           [(1, 16, 2, 3, 2)]),
        "PositionwiseFFN_relu": (lambda: nn.PositionwiseFFN(
            8, 16, activation="relu"), [(2, 3, 8)]),
        "TransformerDecoderCell": (lambda: nn.TransformerDecoderCell(
            8, 16, 2), [(2, 3, 8), (2, 4, 8)]),
    }


def _concat(nn):
    block = nn.HybridConcatenate(axis=1)
    block.add(nn.Dense(5, activation="tanh"), nn.Dense(3))
    return block


def _run_block(mx, block, args, cts):
    """Recorded forward and the gradients of sum(out * ct) for the inputs
    and every trainable parameter."""
    xs = [a.clone().requires_grad_() for a in args]
    with mx.autograd.record():
        out = block(*xs)
    mx.autograd.backward(out, cts)
    grads = [x.grad for x in xs] + [
        p.grad() for p in block.collect_params().values()
        if p.grad_req != "null"]
    return [out.detach()] + grads


def surface_compare(label, got, want, tol=SURFACE_TOL):
    """Hold each card tensor against its CPU counterpart at ``tol``;
    return the largest max|a - b| over max|b| (max|b| at least atol)."""
    worst = 0.0
    for a, b in zip(got, want):
        a = a.detach().float().cpu()
        b = b.detach().float().cpu()
        check(a.shape == b.shape, f"phase 33: {label}: shapes {a.shape} "
                                  f"on the card, {b.shape} on the CPU")
        diff = (a - b).abs().max().item() if a.numel() else 0.0
        check(torch.allclose(a, b, **tol), f"phase 33: {label}: card and "
                                           f"CPU differ by {diff:.3e}")
        scale = max(b.abs().max().item() if b.numel() else 0.0,
                    tol["atol"])
        worst = max(worst, diff / scale)
    return worst


def phase_surface(dev, card):
    """The new surface on the card at small shapes, each against the
    port's own CPU result from the same inputs (phase 33)."""
    import copy
    import mxnet_tpu_torch as mx
    print(f"== phase 33: this slice's optimizers, losses, layers, metrics, "
          f"clip_global_norm, KVStore with compression and higher-order "
          f"autograd on {card} against the CPU", flush=True)
    cpu = torch.device("cpu")
    out = {"optimizers": surface_optimizers(mx, dev)}
    # losses: value and the gradient of their sum
    losses = {}
    with mx.cpu():
        table = surface_losses(mx)
    for name, (loss, preds, others) in table.items():
        res = []
        for d in (dev, cpu):
            ps = [torch.from_numpy(p).to(d).requires_grad_() for p in preds]
            with mx.autograd.record():
                val = loss(*ps, *[torch.from_numpy(o).to(d) for o in others])
            mx.autograd.backward(val)
            res.append([val.detach()] + [p.grad for p in ps])
        losses[name] = surface_compare(f"loss {name}", *res)
    out["losses"] = losses
    # layers: built on the CPU, a copy moved to the card
    layers = {}
    rs = onp.random.RandomState(2)
    with mx.cpu():
        table = surface_layers(mx)
    for name, (factory, shapes) in table.items():
        args = [torch.from_numpy(rs.randn(*s).astype("float32"))
                for s in shapes]
        with mx.cpu():
            block = factory()
            block.initialize(seed=3)
            block(*args)
            for p in block.collect_params().values():
                if "running" not in p.name:
                    p.set_data(torch.from_numpy(
                        (rs.randn(*p.shape) * 0.3).astype("float32")))
        card_block = copy.deepcopy(block)
        card_block.reset_ctx(dev)
        with mx.cpu():
            ct = torch.from_numpy(rs.randn(*block(*args).shape)
                                  .astype("float32"))
            want = _run_block(mx, block, args, ct)
        got = _run_block(mx, card_block, [a.to(dev) for a in args],
                         ct.to(dev))
        layers[name] = surface_compare(f"layer {name}", got, want)
    out["layers"] = layers
    # metrics: eager and deferred on card tensors against the CPU's eager
    metrics = {}
    rs = onp.random.RandomState(3)
    scores = rs.rand(64, 10).astype("float32")
    probs = scores / scores.sum(-1, keepdims=True)
    cls = rs.randint(0, 10, 64).astype("float32")
    reg = rs.randn(64, 4).astype("float32")
    reg_l = rs.randn(64, 4).astype("float32")
    tied = rs.randint(0, 4, (64, 10)).astype("float32") / 4
    inputs = {"acc": (cls, scores), "top_k_accuracy": (cls, scores),
              "top_k_accuracy_ties": (cls, tied),  # ties on the k-th score
              "mae": (reg_l, reg), "mse": (reg_l, reg), "rmse": (reg_l, reg),
              "ce": (cls, probs), "perplexity": (cls, probs),
              "f1": ((cls > 4).astype("float32"), scores[:, :2]),
              "mcc": ((cls > 4).astype("float32"), scores[:, :2]),
              "pcc": (cls, scores), "loss": (reg_l, reg),
              "binaryaccuracy": ((cls > 4).astype("float32"), scores[:, 0]),
              "pearsoncorrelation": (reg_l, reg),
              "meanpairwisedistance": (reg_l, reg),
              "meancosinesimilarity": (reg_l, reg)}
    for key, (label, pred) in inputs.items():
        name = "top_k_accuracy" if key.startswith("top_k") else key
        kw = {"top_k": 3} if name == "top_k_accuracy" else {}
        want = mx.gluon.metric.create(name, **kw)
        want.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        for view in ("eager", "deferred"):
            m = mx.gluon.metric.create(name, **kw)
            m = m.defer() if view == "deferred" else m
            m.update([torch.from_numpy(label).to(dev)],
                     [torch.from_numpy(pred).to(dev)])
            a, b = m.get()[1], want.get()[1]
            check(abs(a - b) <= 1e-5 * max(abs(b), 1.0),
                  f"phase 33: metric {key} {view}: {a} on the card, {b} "
                  f"on the CPU")
            metrics[f"{key}_{view}"] = a
    out["metrics"] = metrics
    # clip_global_norm
    arrays = [rs.randn(300, 7).astype("float32"), rs.randn(11)
              .astype("float32")]
    res = []
    for d in (dev, cpu):
        ts = [torch.from_numpy(a.copy()).to(d) for a in arrays]
        norm = mx.gluon.utils.clip_global_norm(ts, 1.0)
        res.append(([torch.tensor(norm)] + ts))
    out["clip_global_norm"] = surface_compare("clip_global_norm", *res)
    # the KVStore: ops, the optimizer inside, 2-bit compression
    pushes = [[rs.randn(5, 6).astype("float32") * 0.2 for _ in range(2)]
              for _ in range(3)]
    res = []
    for d in (dev, cpu):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.3})
        kv.init(0, torch.zeros(5, 6, device=d))
        kv.init(1, torch.from_numpy(arrays[0][:5, :6].copy()).to(d))
        outs = []
        for g in pushes:
            kv.push(0, [torch.from_numpy(a).to(d) for a in g])
            o = torch.empty(5, 6, device=d)
            kv.pull(0, out=o)
            outs.append(o)
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
        o = torch.empty(5, 6, device=d)
        kv.pushpull(1, [outs[0], outs[1]], out=o)
        res.append(outs + [o])
    out["kvstore_2bit"] = surface_compare("kvstore", *res, tol=dict(
        rtol=1e-6, atol=1e-7))
    # grad(create_graph=True) to third order, and through a hybridized
    # block (a replayed CUDA graph is first-order only: MXNetError)
    xs = torch.tensor([0.3, 1.1, -0.7], device=dev, requires_grad=True)
    with mx.autograd.record():
        y = torch.sin(xs)
        g1 = mx.autograd.grad(y, xs, create_graph=True)
        g2 = mx.autograd.grad(g1, xs, create_graph=True)
        g3 = mx.autograd.grad(g2, xs)
    x0 = xs.detach()
    third = surface_compare("create_graph", [g1, g2, g3],
                            [x0.cos(), -x0.sin(), -x0.cos()])
    net = mx.gluon.nn.Dense(3, activation="tanh", in_units=2, device=dev)
    net.initialize(seed=4)
    net.hybridize()
    x = torch.tensor([[0.1, 0.2], [0.3, -0.4]], device=dev,
                     requires_grad=True)
    raised = None
    try:
        with mx.autograd.record():
            yh = net(x).sum()
            mx.autograd.grad(yh, x, create_graph=True)
    except mx.MXNetError as e:
        raised = str(e)
    check(raised is not None and "hybridized" in raised,
          "phase 33: create_graph through a replayed graph did not raise")
    out["create_graph_third_order"] = third
    out["create_graph_hybridized"] = "MXNetError: " + raised[:80]
    print(f"phase 33 [{card}]: " + json.dumps(out))
    return out

# -- phases 36-38: data parallel ----------------------------------------------
#
# Phase 36 runs in this process; phases 37-38 start two ranks on the card
# through tools/launch.py -n 2 --env MXTPU_DIST_DEVICE=cuda, each rank this
# script with ``--dp-rank <gpt|resnet> <dir>``: the ranks share cuda:0, so
# the process group is gloo (NCCL refuses two ranks on one device), and
# nothing measured here is scaling. The ranks read what they need from
# ``<dir>/dp_config.json`` and the one-card references this process wrote
# there, and write their results back. They build nothing: the kernels of
# phase 1 are in the build directory.

# GPT-2 124M fp32 at phase 5's global batch: the updates compared between
# the one-card step (phase 36) and two ranks (phase 37), plain SGD so that
# the comparisons see the reduce and not Adam's amplified float noise
DP_STEPS = 4
# phase 37 runs GPT-2 124M at full width and 6 of its 12 layers: the
# script's time limit (its ranks share one card over gloo, five runs);
# phase 36 runs its one-card reference at that depth too. Phases 40-42
# run all 12
DP_LAYERS = 6
DP_SGD = {"learning_rate": 0.01, "momentum": 0.9}
DP_ACCUM, DP_SPC = 4, 2
DP_REMATS = (None, True, "dots")
# the one-card step against the accumulated one (4 microbatches of 2, 2
# updates a call) and the two ranks against the one card, zero 0/1/2:
# losses rtol; the update (weights after - before) as one vector, the L2
# norm of its difference over the one card's: fp32 sums of the gradient
# in another order and other GEMM shapes. Per tensor the difference is
# larger where the gradient is small at initialization (a query
# projection's max moved 6.3e-3 of its update on the H100), so per-tensor
# maxima are printed, not held
DP_LOSS_RTOL = 1e-5
DP_UPDATE_TOL = 1e-3
# int8 gradients with error feedback: the update's L2 distance from the
# one card's over its L2 norm, and the losses, rtol. The limits sit
# between int8 with its residual and a control run that drops the
# residual after every update, measured on the H100: the update 9.76e-3
# against the control's 4.16e-2 (limit about twice the sound reading);
# the losses differ from the one card's by 1.7e-7 and 3.4e-7 (2 and 4
# fp32 roundings of a loss of 11.4: four SGD steps barely move it), so
# the loss is held to rounding noise and the update tells the two apart.
# The control must fail, or the limits would not discriminate
DP_INT8_UPDATE_TOL = 2e-2
DP_INT8_LOSS_RTOL = 1e-6
# ResNet-50 v1 at phase 13's batch (16 a rank) through the dist store:
# two compared steps, then timed ones
# one compared step (from the same weights), then timed ones. ResNet-50's
# fp32 update at initialization is ill-conditioned: moving the batch by
# one fp32 rounding (x * (1 +- 2^-24), phase 13's probe) moves it by
# ~1.8e-2 (relative L2, 64 x 64 images on the CPU), so the update and the
# running statistics are held within the larger of a fixed bound and
# twice that probe's change, measured in the same run
DP_RESNET_STEPS, DP_RESNET_TIMED = 1, 3
DP_RESNET_LOSS_RTOL = 1e-5    # step 1: the same weights, global statistics
DP_RESNET_UPDATE_TOL = 1e-3   # relative L2 of the whole update
DP_RESNET_STAT_TOL = 1e-4     # running statistics, max|diff| / max|ref|
DP_LAUNCH_TIMEOUT = 420
# the column biases of megatron_specs (parallel/train.py)
COLUMN_BIASES = ("query_proj.bias", "key_proj.bias", "value_proj.bias",
                 "ffn_1.bias")


def dp_config():
    """What the ranks of phases 37-38 read: the model sizes, the batches
    and the device (GPT-2 124M and ResNet-50 at phases 5 and 13's
    batches on the card)."""
    return {"device": "cuda", "vocab": 50257, "units": 768, "hidden": 3072,
            "layers": N_LAYERS, "heads": 12, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": DP_STEPS, "dp_layers": DP_LAYERS,
            "resnet_batch": RESNET_BATCH, "resnet_size": RESNET_SIZE,
            "resnet_classes": RESNET_CLASSES, "resnet_layers": 50}


def dp_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_peak_reset(dev):
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def dp_peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def _frame(f):
    path = f["filename"]
    cut = path.rfind("mxnet_tpu_torch/")
    path = path[cut:] if cut >= 0 else os.path.basename(path)
    return f"{path}:{f['line']} {f['name']}"


@contextlib.contextmanager
def dp_memory_trace(dev, top=8):
    """Within: the CUDA caching allocator records its history. The yielded
    dict is filled at the exit with what set the peak: ``resident_gb``
    (allocated at the entry: weights and what the step was built with),
    ``peak_gb``, the Python frames of the allocation that reached the
    peak, and the allocations live at that moment grouped by their
    innermost frame of the port, largest first. Empty on the CPU."""
    out = {}
    if dev.type != "cuda":
        yield out
        return
    dp_sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(
        "all", context="alloc", stacks="python", max_entries=2_000_000)
    try:
        yield out
        dp_sync(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = [e for e in snap["device_traces"][dev.index]
              if e["action"] in ("alloc", "free_completed")]

    def replay(stop):
        live, cur, best, at = {}, 0, 0, -1
        for i, e in enumerate(events[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
            else:
                live.pop(e["addr"], None)
                cur -= e["size"]
            if cur > best:
                best, at = cur, i
        return live, best, at

    _, best, at = replay(len(events))
    live, _, _ = replay(at + 1)
    groups = {}
    for e in live.values():
        port = [f for f in e["frames"] if "mxnet_tpu_torch/" in f["filename"]]
        # no Python frame: made on autograd's thread (the gradients)
        key = _frame(port[0]) if port else (
            _frame(e["frames"][0]) if e["frames"] else "autograd thread")
        g = groups.setdefault(key, [0, 0])
        g[0] += e["size"]
        g[1] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
    out.update({
        "resident_gb": base / 1e9,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "above_resident_at_peak_gb": best / 1e9,
        "peak_reached_in": [
            _frame(f) for f in events[at]["frames"]
            if "mxnet_tpu_torch/" in f["filename"]][:4] if at >= 0 else [],
        "live_at_peak": [[k, v[0] / 1e9, v[1]] for k, v in ranked]})


def dp_gpt_cfg(cfg):
    """``cfg`` at phase 37's GPT depth."""
    return {**cfg, "layers": cfg["dp_layers"]}


def dp_gpt_net(dev, cfg):
    """GPT-2 124M (phase 5's model) from seed 0 at ``cfg``'s sizes."""
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTForCausalLM, GPTModel
    return GPTForCausalLM(backbone=GPTModel(
        vocab_size=cfg["vocab"], units=cfg["units"],
        hidden_size=cfg["hidden"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], max_length=cfg["seq"], dropout=0.0,
        embed_dropout=0.0, device=dev)).initialize(seed=0)


def dp_resnet(dev, cfg):
    """ResNet-50 v1 (phase 13's model) from seed 0 and its global batch."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    net = get_resnet(1, cfg["resnet_layers"], classes=cfg["resnet_classes"],
                     device=dev).initialize(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    size = cfg["resnet_size"]
    x = torch.randn(cfg["resnet_batch"], 3, size, size, device=dev,
                    generator=gen)
    y = torch.randint(0, cfg["resnet_classes"], (cfg["resnet_batch"],),
                      device=dev, generator=gen)
    net(x[:2])  # finishes the deferred shapes (no statistics update)
    return net, x, y


def dp_gpt_batches(cfg):
    """The steps' global batches: phase 5's fixed batch (batch x seq + 1
    tokens from RandomState(0)) at every step."""
    ids = onp.random.RandomState(0).randint(
        0, cfg["vocab"], (cfg["batch"], cfg["seq"] + 1))
    x, y = ids[:, :-1].astype(onp.int64), ids[:, 1:].astype(onp.int64)
    return [(x, y)] * cfg["steps"]


def dp_loss(out, y):
    from mxnet_tpu_torch.ops.xent import sparse_softmax_xent
    return sparse_softmax_xent(out, y).mean()


def dp_snapshot(params):
    """The parameters' values, copied to the host (so the device's peak
    memory is the step's own)."""
    return {n: p.data().detach().to("cpu", copy=True)
            for n, p in params.items()}


def dp_restore(params, snap):
    with torch.no_grad():
        for n, p in params.items():
            p.data().copy_(snap[n])


def _on_card(t):
    """``t`` (a host snapshot) on the card for the comparisons, one tensor
    at a time."""
    return t.to("cuda") if torch.cuda.is_available() else t


def dp_update_diff(after, before, ref_after, names=None):
    """(max over tensors of max|d - d_ref| / max|d_ref|, the tensor), d the
    update after - before; d_ref the reference's. The attention key
    projection's bias is left out: its gradient is zero in exact
    arithmetic (softmax is shift invariant), so its update is fp32 noise
    on either side."""
    worst, at = 0.0, None
    for n in names or ref_after:
        if n.endswith("key_proj.bias"):
            continue
        a, b, ra = (_on_card(t[n]) for t in (after, before, ref_after))
        d = a.float() - b.float()
        dr = ra.float() - b.float()
        scale = dr.abs().max().item()
        r = (d - dr).abs().max().item() / scale if scale else 0.0
        if r > worst:
            worst, at = r, n
    return worst, at


def dp_update_l2(after, before, ref_after):
    """||d - d_ref||_2 / ||d_ref||_2 over every tensor together."""
    num = den = 0.0
    for n in ref_after:
        a, b, ra = (_on_card(t[n]) for t in (after, before, ref_after))
        d = a.double() - b.double()
        dr = ra.double() - b.double()
        num += float(((d - dr) ** 2).sum())
        den += float((dr ** 2).sum())
    return (num / den) ** 0.5 if den else 0.0


def phase_gpt_sharded(dev, card, root, cfg):
    """Phase 36: GPT-2 124M through ShardedTrainStep on one card: the plain
    step (DP_STEPS updates, the reference of phases 40-42, and at
    DP_LAYERS phase 37's), then zero=2, grad_accum=4, steps_per_call=2
    under each remat setting."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    print(f"== phase 36: GPT-2 124M fp32 through ShardedTrainStep on one "
          f"card (batch {cfg['batch']} x seq {cfg['seq']}, SGD "
          f"{DP_SGD}): the plain step, then zero=2, grad_accum={DP_ACCUM}, "
          f"steps_per_call={DP_SPC} with remat off / True / 'dots' on "
          f"{card}", flush=True)
    net = dp_gpt_net(dev, cfg)
    params = net.collect_params()
    start = dp_snapshot(params)
    batches = dp_gpt_batches(cfg)
    mesh = MeshConfig()
    specs = mesh.batch_specs(2, 2)
    step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), mesh, specs)
    plain, after2, times = [], None, []
    for i, (x, y) in enumerate(batches):
        dp_sync(dev)
        t0 = time.perf_counter()
        plain.append(float(step(x, y)))
        times.append(time.perf_counter() - t0)
        if i == DP_SPC - 1:
            after2 = dp_snapshot(params)
    # the first update pays the warm-up (cuBLAS handles, kernel loads)
    plain_ms = float(onp.median(times[1:])) * 1e3
    final = dp_snapshot(params)
    check(all(onp.isfinite(plain)) and plain[-1] < plain[0],
          f"phase 36: the plain step's loss is not finite or did not fall: "
          f"{plain}")
    torch.save({"losses": plain, "start": {n: t.cpu() for n, t in
                                           start.items()},
                "final": {n: t.cpu() for n, t in final.items()}},
               os.path.join(root, "gpt_one_card.pt"))
    print(f"plain step: losses {plain}, {plain_ms:.1f} ms an update")
    # the reference of phase 37: the same plain step at its depth
    mcfg = dp_gpt_cfg(cfg)
    mnet = dp_gpt_net(dev, mcfg)
    mparams = mnet.collect_params()
    mstart = dp_snapshot(mparams)
    mstep = ShardedTrainStep(mnet, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), mesh, specs)
    mlosses = [float(mstep(x, y)) for x, y in batches]
    torch.save({"losses": mlosses, "start": mstart,
                "final": dp_snapshot(mparams)},
               os.path.join(root, "gpt_one_card_dp.pt"))
    print(f"plain step at {mcfg['layers']} layers (phase 37's "
          f"reference): losses {mlosses}")
    del mstep, mnet, mparams, mstart

    def stacked(part):
        xs = onp.stack([b[0] for b in part]).reshape(
            DP_SPC, DP_ACCUM, -1, cfg["seq"])
        ys = onp.stack([b[1] for b in part]).reshape(
            DP_SPC, DP_ACCUM, -1, cfg["seq"])
        return xs, ys

    calls = [stacked(batches[i:i + DP_SPC])
             for i in range(0, len(batches), DP_SPC)]
    rows, ref = {}, None
    def accumulated(remat):
        dp_restore(params, start)
        return ShardedTrainStep(
            net, dp_loss, mx.optimizer.create("sgd", **DP_SGD), mesh,
            specs, zero=2, grad_accum=DP_ACCUM, steps_per_call=DP_SPC,
            remat=remat)

    for remat in DP_REMATS:
        # a warm-up call first: a setting's first call pays one-time
        # costs (checkpointing's first use imports torch's compiler
        # front end, ~3 s on the H100 host). It runs under the
        # allocator's history (what sets the peak), which the timed calls
        # do not pay
        dp_peak_reset(dev)
        with dp_memory_trace(dev) as trace:
            accumulated(remat)(*calls[0])
        step = accumulated(remat)
        dp_peak_reset(dev)
        zero_counters(fa)
        wall, losses, snaps = 0.0, [], []
        for x, y in calls:
            dp_sync(dev)
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            dp_sync(dev)
            wall += time.perf_counter() - t0
            snaps.append(dp_snapshot(params))
        row = {"losses": losses,
               "ms_per_update": wall / (len(calls) * DP_SPC) * 1e3,
               "peak_allocated_gb": dp_peak_gb(dev),
               "flash_launches": counters(fa), "memory_trace": trace}
        label = "off" if remat is None else str(remat)
        if ref is None:
            ref = (losses, snaps)
            # the accumulated updates against the plain step's
            check(math.isclose(losses[0], sum(plain[:DP_SPC]) / DP_SPC,
                               rel_tol=DP_LOSS_RTOL),
                  f"phase 36: accumulated loss {losses[0]} vs the plain "
                  f"step's {plain[:DP_SPC]}")
            for k, (snap, want) in enumerate(((snaps[0], after2),
                                              (snaps[1], final))):
                l2 = dp_update_l2(snap, start, want)
                worst, at = dp_update_diff(snap, start, want)
                row[f"accum_vs_plain_update_{(k + 1) * DP_SPC}"] = {
                    "l2": l2, "max_tensor": [worst, at]}
                check(l2 <= DP_UPDATE_TOL,
                      f"phase 36: after {(k + 1) * DP_SPC} updates the "
                      f"accumulated update is {l2:.3e} (relative L2) from "
                      f"the plain step's")
        else:
            check(losses == ref[0], f"phase 36: remat={remat!r} losses "
                                    f"{losses} vs off {ref[0]}")
            for a, b in zip(snaps, ref[1]):
                bad = [n for n in a if not torch.equal(a[n], b[n])]
                check(not bad, f"phase 36: remat={remat!r} weights differ "
                               f"from off: {bad[:4]}")
            row["bit_for_bit_with_off"] = True
        n_micro = len(calls) * DP_SPC * DP_ACCUM
        want = [cfg["layers"] * n_micro * (1 if remat is None else 2),
                cfg["layers"] * n_micro, cfg["layers"] * n_micro]
        check(dev.type != "cuda" or row["flash_launches"] == want,
              f"phase 36: remat={remat!r} flash launches "
              f"{row['flash_launches']}, expected {want}")
        rows[label] = row
        print(f"remat {label}: " + json.dumps(row))
    del step, net, params
    dp_peak_reset(dev)
    return {"plain_losses": plain, "plain_ms_per_update": plain_ms,
            "remat": rows,
            "launches": [sum(r["flash_launches"][i] for r in rows.values())
                         for i in range(3)]}


def dp_launch(root, kind, timeout=DP_LAUNCH_TIMEOUT, n=2):
    """``n`` ranks of this script through tools/launch.py -n n (on the
    card: --env MXTPU_DIST_DEVICE=cuda): (launcher rc, output). Every
    process of the world ends on a timeout, which fails the run."""
    import signal
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "dp_config.json")) as f:
        where = json.load(f)["device"]
    cmd = [sys.executable, os.path.join(repo, "tools", "launch.py"), "-n",
           str(n), "--env", f"MXTPU_DIST_DEVICE={where}", sys.executable,
           os.path.abspath(__file__), "--dp-rank", kind, root]
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=repo, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        print(out[-8000:])
        fail(f"the {n} {kind} ranks did not finish in {timeout} s")
    return p.returncode, out


def dp_world(root, kind, n=2):
    """The ranks' results of a phase: their output printed, a rank's
    failure the phase's (the launcher's rc is checked)."""
    t0 = time.perf_counter()
    rc, out = dp_launch(root, kind, n=n)
    for line in out.splitlines():
        if "socket.cpp" not in line and "FutureWarning" not in line \
                and "return func(" not in line:
            print(f"  {line}")
    check(rc == 0, f"the {n} {kind} ranks failed (launcher rc {rc})")
    res = []
    for r in range(n):
        with open(os.path.join(root, f"{kind}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res, time.perf_counter() - t0


def phase_gpt_dp(dev, card, root, cfg):
    """Phase 37: GPT-2 124M fp32 dp=2 on two ranks sharing the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serialization
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    print(f"== phase 37: GPT-2 124M's width at {cfg['dp_layers']} of its "
          f"{cfg['layers']} layers, fp32, dp=2 on two ranks sharing {card} "
          f"(tools/launch.py -n 2 --env MXTPU_DIST_DEVICE=cuda): zero "
          f"0/1/2 and grad_compress='int8', global batch {cfg['batch']} "
          f"({cfg['batch'] // 2} a rank) x seq {cfg['seq']}, against "
          f"phase 36's one-card step", flush=True)
    probe = None
    if cfg["device"] == "cuda":
        # does NCCL take two ranks on one card? (the backend rule gives
        # such ranks gloo either way)
        rc, out = dp_launch(root, "nccl_probe", timeout=120)
        probe = [ln.split(" ", 1)[1] for ln in out.splitlines()
                 if ln.startswith("NCCL_PROBE ")]
        print(f"NCCL with two ranks on one card (launcher rc {rc}): {probe}")
    res, wall = dp_world(root, "gpt")
    # the world-2 bundle loads bit for bit into a one-card step, which
    # continues
    net = dp_gpt_net(dev, dp_gpt_cfg(cfg))
    one = MeshConfig()
    step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), one, one.batch_specs(2, 2))
    path = os.path.join(root, "gpt_w2.safetensors")
    step.load_states(path)
    saved = serialization.load_safetensors(path)
    got = step.state_dict()["arrays"]
    bad = [k for k in saved if not onp.array_equal(saved[k], got[k])]
    check(set(saved) == set(got) and not bad,
          f"phase 37: the world-2 bundle did not load bit for bit: "
          f"{bad[:4]}")
    x, y = dp_gpt_batches(cfg)[0]
    cont = float(step(x, y))
    check(math.isfinite(cont), "phase 37: the one-card step continuing the "
                               "world-2 bundle gave a non-finite loss")
    print(f"world-2 zero=2 bundle: {len(saved)} arrays loaded bit for bit "
          f"into a one-card zero=0 step at update {step._n_step - 1}; it "
          f"continued with loss {cont:.6f}")
    del step, net
    dp_peak_reset(dev)
    return {"ranks": res, "launch_seconds": wall,
            "bundle_arrays_bit_for_bit": len(saved),
            "one_card_continued_loss": cont,
            "backend": res[0]["backend"], "nccl_two_ranks_one_card": probe,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(3)]}


def phase_resnet_dp(dev, card, root, cfg):
    """Phase 38: ResNet-50 v1 through Trainer(kvstore='dist_device_sync')
    on two ranks sharing the card, against the one-card step."""
    import mxnet_tpu_torch as mx
    print(f"== phase 38: ResNet-50 v1 fp32 through Trainer(kvstore="
          f"'dist_device_sync') over FusableSequential on two ranks sharing "
          f"{card}, global batch {cfg['resnet_batch']} "
          f"({cfg['resnet_batch'] // 2} a rank), kernel 8 with the global "
          f"batch's statistics, against the one-card step (cuDNN "
          f"deterministic)", flush=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        net, x, y = dp_resnet(dev, cfg)
        params = net.collect_params()
        start = dp_snapshot(params)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def run(inp):
            dp_restore(params, start)
            trainer = mx.gluon.Trainer(params, "sgd", {
                "learning_rate": 0.05, "momentum": 0.9})
            losses = []
            for _ in range(DP_RESNET_STEPS):
                with mx.autograd.record():
                    loss = loss_fn(net(inp), y)
                mx.autograd.backward(loss)
                trainer.step(len(inp))
                losses.append(loss.detach().mean().item())
            return losses, dp_snapshot(params)

        losses, final = run(x)
        sign = torch.randint(0, 2, x.shape, device=dev, generator=torch.
                             Generator(device=dev).manual_seed(100))
        _, moved = run(x * (1 + (2 * sign - 1) * 2.0 ** -24))
        trained = [n for n, p in params.items() if p.grad_req != "null"]
        probe = dp_update_l2({n: moved[n] for n in trained},
                             {n: start[n] for n in trained},
                             {n: final[n] for n in trained})
        probe_stat = max(((moved[n] - final[n]).abs().max()
                          / final[n].abs().max()).item()
                         for n in final if "running" in n)
        torch.save({"losses": losses, "probe_update": probe,
                    "probe_stat": probe_stat,
                    "start": {n: t.cpu() for n, t in start.items()},
                    "final": {n: t.cpu() for n, t in final.items()}},
                   os.path.join(root, "resnet_one_card.pt"))
        print(f"one card: losses {losses}; the batch moved by one fp32 "
              f"rounding moves the update by {probe:.3e} (relative L2) and "
              f"the running statistics by {probe_stat:.3e} of their max")
        del net, params, start, final, moved
        dp_peak_reset(dev)
    finally:
        torch.backends.cudnn.deterministic = False
    res, wall = dp_world(root, "resnet")
    return {"one_card_losses": losses, "probe_update_l2": probe,
            "probe_running_stats": probe_stat, "ranks": res,
            "launch_seconds": wall, "backend": res[0]["backend"],
            "launches": sum(r["launches"] for r in res)}


# -- the rank side ------------------------------------------------------------

def dp_equal_across_ranks(tensors):
    """Names of tensors that differ from rank 0's (rank 0 broadcasts)."""
    import torch.distributed as dist
    bad = []
    for n, t in tensors.items():
        mine = t.detach().contiguous()
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        if not torch.equal(mine, theirs):
            bad.append(n)
    return bad


def dp_rank_gpt(root, cfg):
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    from mxnet_tpu_torch.parallel import collectives as coll
    cfg = dp_gpt_cfg(cfg)
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    check(world == 2 and dev.type == cfg["device"],
          f"rank {rank}: world {world} on {dev}")
    out = {"rank": rank, "backend": mx.parallel.backend(),
           "device": str(dev)}
    net = dp_gpt_net(dev, cfg)
    params = net.collect_params()
    start = dp_snapshot(params)
    check(not dp_equal_across_ranks(start), "the ranks' initial weights "
                                            "differ")
    batches = dp_gpt_batches(cfg)
    one = torch.load(os.path.join(root, "gpt_one_card_dp.pt"))
    mesh = MeshConfig(dp=world)
    specs = mesh.batch_specs(2, 2)
    trained = [p.data() for p in params.values() if p.grad_req != "null"]
    nbytes = sum(w.numel() * w.element_size() for w in trained)
    # the reference's ZeRO arithmetic (train.py:346-460): a MeshConfig
    # step takes megatron_specs, whose column biases (P('tp'): no
    # dimension is free for dp) keep replicated state and count in no
    # zero.* bytes; every other tensor padded to a multiple of dp
    padded = sum(-(-p.data().numel() // world) * world
                 * p.data().element_size() for n, p in params.items()
                 if p.grad_req != "null" and not n.endswith(COLUMN_BIASES))
    steps = len(batches)
    runs = {}
    for label, kw in (("zero0", {}), ("zero1", {"zero": 1}),
                      ("zero2", {"zero": 2}),
                      ("int8", {"grad_compress": "int8"}),
                      ("int8_no_feedback", {"grad_compress": "int8"})):
        dp_restore(params, start)
        step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
            "sgd", **DP_SGD), mesh, specs, **kw)
        mx.telemetry.enable()
        mx.telemetry.reset()
        dp_peak_reset(dev)
        zero_counters(fa)

        def update(x, y):
            losses.append(float(step(x, y)))
            if label == "int8_no_feedback":
                # the control: the error-feedback residual dropped after
                # every update
                for r in step.extra["resid"].values():
                    r.zero_()

        losses = []
        # the first update under the allocator's history (what sets the
        # peak), the others timed without it; both ranks start the clock
        # together (rank 0 alone writes the zero=2 bundle)
        with dp_memory_trace(dev) as trace:
            update(*batches[0])
        dp_sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        with coll.timing() as tm:
            for x, y in batches[1:]:
                update(x, y)
            dp_sync(dev)
        wall = time.perf_counter() - t0
        launches = counters(fa)
        counts = {k: v for k, v in mx.telemetry.counters().items()
                  if k.startswith(("zero.", "mesh.", "comm."))}
        mx.telemetry.disable()
        final = dp_snapshot(params)
        bad = dp_equal_across_ranks(final)
        check(not bad, f"{label}: weights differ across ranks: {bad[:4]}")
        # the analytic count (the reference's arithmetic, train.py:1016-
        # 1050): every gradient's bytes a step; at zero > 0 the ZeRO
        # tensors above; int8 one byte a value and a 4-byte scale a
        # bucket
        want = {"mesh.dp_gradient_bytes_total": nbytes * steps}
        wire = nbytes * steps
        if label.startswith("int8"):
            wire = (nbytes // 4 + 4 * len(step._buckets)) * steps
            want.update({"comm.compressed_bytes_total": wire,
                         "comm.uncompressed_bytes_total": nbytes * steps})
        want['mesh.collective_bytes_total{axis="dp"}'] = wire
        if kw.get("zero"):
            z = padded * steps
            want.update({"zero.reduce_scatter_bytes_total": z,
                         "zero.all_gather_bytes_total": z,
                         'zero.collective_bytes_total{op="all_gather"}': z,
                         'zero.collective_bytes_total{op="reduce_scatter"}':
                             z})
        check(counts == want, f"{label}: byte counters {counts} vs the "
                              f"analytic {want}")
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, one["losses"]))
        ref = one["final"]
        at = None
        if label.startswith("int8"):
            diff = dp_update_l2(final, start, ref)
            # the control must fall outside the limits that int8 with
            # its residual is held to, or they would not tell them apart
            within = (diff <= DP_INT8_UPDATE_TOL
                      and loss_rel <= DP_INT8_LOSS_RTOL)
            check(within == (label == "int8"),
                  f"{label}: the update is {diff:.3e} (relative L2, limit "
                  f"{DP_INT8_UPDATE_TOL}) and the losses {loss_rel:.3e} "
                  f"(relative, limit {DP_INT8_LOSS_RTOL}) from the one "
                  "card's")
        else:
            check(loss_rel <= DP_LOSS_RTOL,
                  f"{label}: losses {losses} vs one card {one['losses']} "
                  f"(rtol {DP_LOSS_RTOL})")
            diff = dp_update_l2(final, start, ref)
            at = dp_update_diff(final, start, ref)
            check(diff <= DP_UPDATE_TOL,
                  f"{label}: the update is {diff:.3e} (relative L2) from "
                  "the one card's")
        del ref
        want_l = [cfg["layers"] * steps] * 3
        check(dev.type != "cuda" or launches == want_l,
              f"{label}: flash launches {launches}, expected {want_l}")
        runs[label] = {
            "losses": losses, "ms_per_step": wall / (steps - 1) * 1e3,
            "collective_seconds_per_step":
                sum(v[0] for v in tm.values()) / (steps - 1),
            "collective_calls_bytes": {k: v[1:] for k, v in tm.items()},
            "peak_allocated_gb": dp_peak_gb(dev),
            "counters": counts, "flash_launches": launches,
            "update_vs_one_card": diff, "losses_vs_one_card": loss_rel,
            "worst_tensor": at, "weights_equal_across_ranks": True,
            "memory_trace": trace}
        if label == "zero2":
            step.save_states(os.path.join(root, "gpt_w2.safetensors"))
        del step
    out["runs"] = runs
    out["launches"] = [sum(r["flash_launches"][i] for r in runs.values())
                       for i in range(3)]
    # the dist_sync store on the card's tensors: exact sums, and one
    # injected collective timeout on rank 0 retried to the exact sum
    kv = mx.kv.create("dist_sync")
    kv.init("w", torch.zeros(4, 3, device=dev))
    kv.push("w", torch.full((4, 3), float(rank + 1), device=dev))
    o = torch.empty(4, 3, device=dev)
    kv.pull("w", out=o)
    check(bool((o == 3.0).all()), f"dist_sync sum on {dev}: {o}")
    if rank == 0:
        mx.config.set("kvstore.async_timeout", 4.0)
        mx.config.set("kvstore.retry_backoff", 0.2)
        mx.config.set("kvstore.rejoin_timeout", 2.0)
        mx.fault.configure("kvstore.collective_timeout:at=1")
    else:
        mx.config.set("kvstore.async_timeout", 120.0)
    kv.pushpull("w", torch.full((4, 3), float(rank + 1), device=dev), out=o)
    check(bool((o == 3.0).all()), f"retried dist_sync sum on {dev}: {o}")
    if rank == 0:
        st = mx.fault.stats()
        check(st.get("resilience.collective_retry", 0) == 1
              and st.get("kvstore.collective_timeout_raised", 0) == 1,
              f"the injected timeout was not retried once: {st}")
        mx.fault.clear()
    out["kvstore_exact_sums"] = out["kvstore_retried_timeout"] = True
    return out


def dp_rank_resnet(root, cfg):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import conv_bwd as cb
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    net, x, y = dp_resnet(dev, cfg)
    k = len(x) // world
    xl, yl = x[rank * k:(rank + 1) * k], y[rank * k:(rank + 1) * k]
    params = net.collect_params()
    start = dp_snapshot(params)
    check(not dp_equal_across_ranks(start), "the ranks' initial weights "
                                            "differ")
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                               "momentum": 0.9},
                               kvstore="dist_device_sync")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(xl), yl)
        mx.autograd.backward(loss)
        trainer.step(len(x))
        return mx.parallel.allreduce(loss.detach().mean().reshape(1),
                                     op="mean")

    zero_conv_counters(cb)
    losses = [step().item() for _ in range(DP_RESNET_STEPS)]
    calls = cb.fused_conv3x3_bn_relu_bwd.launches
    check(dev.type != "cuda" or calls == RESNET_TRIPLETS * DP_RESNET_STEPS,
          f"kernel 8 calls {calls} in {DP_RESNET_STEPS} rank-steps, "
          f"expected {RESNET_TRIPLETS} each")
    shapes = dict(cb.fused_conv3x3_bn_relu_bwd.shape_launches)
    final = dp_snapshot(params)
    bad = dp_equal_across_ranks(final)
    check(not bad, f"ResNet weights or statistics differ across ranks: "
                   f"{bad[:4]}")
    one = torch.load(os.path.join(root, "resnet_one_card.pt"))
    lbad = [(a, b) for a, b in zip(losses, one["losses"])
            if not math.isclose(a, b, rel_tol=DP_RESNET_LOSS_RTOL)]
    check(not lbad, f"losses {losses} vs one card {one['losses']}")
    ref = one["final"]
    stats = [n for n in ref if "running" in n]
    trained = [n for n, p in params.items() if p.grad_req != "null"]
    upd = dp_update_l2({n: final[n] for n in trained},
                       {n: start[n] for n in trained},
                       {n: ref[n] for n in trained})
    limit = max(DP_RESNET_UPDATE_TOL, 2 * one["probe_update"])
    check(upd <= limit, f"the update is {upd:.3e} (relative L2) from the "
                        f"one card's, above {limit:.3e}")
    worst_upd, at_upd = dp_update_diff(final, start, ref, trained)
    worst_stat, at_stat = 0.0, None
    for n in stats:
        scale = ref[n].abs().max().item()
        r = (final[n] - ref[n]).abs().max().item() / scale if scale else 0.0
        if r > worst_stat:
            worst_stat, at_stat = r, n
    limit_stat = max(DP_RESNET_STAT_TOL, 2 * one["probe_stat"])
    check(worst_stat <= limit_stat,
          f"running statistics {at_stat} off by {worst_stat:.3e} of max, "
          f"above {limit_stat:.3e}")
    # timed steps (cuDNN's own choice again), kernel 8 still 16 a step
    torch.backends.cudnn.deterministic = False
    zero_conv_counters(cb)
    dp_peak_reset(dev)
    dp_sync(dev)
    t0 = time.perf_counter()
    for _ in range(DP_RESNET_TIMED):
        step()
    dp_sync(dev)
    wall = time.perf_counter() - t0
    timed_calls = cb.fused_conv3x3_bn_relu_bwd.launches
    check(dev.type != "cuda"
          or timed_calls == RESNET_TRIPLETS * DP_RESNET_TIMED,
          f"timed steps: kernel 8 calls {timed_calls}")
    return {"rank": rank, "backend": mx.parallel.backend(),
            "losses": losses,
            "kernel8_calls_per_rank_step": calls // DP_RESNET_STEPS,
            "kernel8_calls_by_shape": {str(k): v for k, v in shapes.items()},
            "launches": calls + timed_calls,
            "update_vs_one_card_l2": upd,
            "update_vs_one_card_max": [worst_upd, at_upd],
            "running_stats_vs_one_card": [worst_stat, at_stat],
            "weights_equal_across_ranks": True,
            "ms_per_step": wall / DP_RESNET_TIMED * 1e3,
            "peak_allocated_gb": dp_peak_gb(dev)}


# -- phases 39-42: tensor, pipeline and sequence parallelism ------------------

# ring attention on the card: b 8, h 12, s 1024 over sp 2 (512 a rank), d 64
RING_B, RING_H, RING_S, RING_D = 8, 12, 1024, 64
# the card route (kernel 1 on each pair, merged by lse in fp32; kernels 2-3
# with the global lse) against the plain route (online softmax in torch,
# fp32 scores): max |card - plain| over max |plain|, per output and
# gradient. fp32: the kernels' 3xTF32 products against fp32 FMA; bf16: both
# round p to bf16 for the product with v, the plain route rounds each
# block's p.v to bf16 before the fp32 sum, the kernels once at the end
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
# launches a rank a ring call under causal masking (the diagonal pair, the
# earlier ranks' pairs; a later rank's skipped): rank 0 one, rank 1 two
RING_CAUSAL_PAIRS = (1, 2)
MESH_TIMEOUT = 420


def mesh_config(cfg):
    """What the ranks of phases 39-42 read, beside dp_config: BERT-base at
    phase 7's batch and sequence (dropout 0 for the comparisons)."""
    return {**cfg, "bert_vocab": BERT_VOCAB, "bert_batch": BERT_BATCH,
            "bert_seq": BERT_SEQ, "bert_layers": N_LAYERS,
            "ring": [RING_B, RING_H, RING_S, RING_D]}


def mesh_batches_bert(cfg, dev=None):
    """Phase 7's pretraining batch at ``cfg``'s sizes, host numpy (ids,
    token types, valid lengths, MLM labels, NSP labels)."""
    rs = onp.random.RandomState(0)
    b, s, v = cfg["bert_batch"], cfg["bert_seq"], cfg["bert_vocab"]
    ids = rs.randint(min(1000, v // 2), v, (b, s))
    valid = rs.randint(s // 2, s + 1, b)
    pos = onp.arange(s)[None, :]
    split = rs.randint(s // 16, valid - s // 16)[:, None]
    types = ((pos >= split) & (pos < valid[:, None])).astype("int64")
    return (ids.astype("int64"), types, valid.astype("int64"),
            ids.astype("int64"), rs.randint(0, 2, b).astype("int64"))


def mesh_bert_net(dev, cfg):
    """BERT-base (phase 7's model) from seed 0, dropout 0."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTForPretraining
    return BERTForPretraining(
        vocab_size=cfg["bert_vocab"], units=cfg["units"],
        hidden_size=cfg["hidden"], num_layers=cfg["bert_layers"],
        num_heads=cfg["heads"], max_length=512, dropout=0.0,
        embed_dropout=0.0, device=dev).initialize(seed=0)


def mesh_bert_loss(outputs, labels, nsp):
    """MLM over every position plus NSP: the pooler's broadcast under sp
    is on the path."""
    from mxnet_tpu_torch.ops.xent import sparse_softmax_xent
    mlm, nsp_scores = outputs
    return (sparse_softmax_xent(mlm, labels).mean()
            + sparse_softmax_xent(nsp_scores, nsp).mean())


def mesh_bert_args(arrays, masked):
    """The step's batch: (ids, types[, valid length], labels, nsp) and its
    specs' names."""
    ids, types, valid, labels, nsp = arrays
    if masked:
        return ((ids, types, valid, labels, nsp),
                [("dp", "sp"), ("dp", "sp"), ("dp",), ("dp", "sp"),
                 ("dp",)])
    return ((ids, types, labels, nsp),
            [("dp", "sp"), ("dp", "sp"), ("dp", "sp"), ("dp",)])


def phase_ring(dev, card, root, cfg):
    """Phase 39: ring attention on the card, two ranks sharing it."""
    print(f"== phase 39: ring attention over sp=2 on two ranks sharing "
          f"{card}: b {RING_B}, h {RING_H}, s {RING_S} ({RING_S // 2} a "
          f"rank), d {RING_D}, causal and not, fp32 and bf16: the card "
          f"route (kernel 1 on each pair, kernels 2-3 with the global lse) "
          f"against its plain version, values and gradients", flush=True)
    res, wall = dp_world(root, "ring")
    return {"ranks": res, "launch_seconds": wall,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(3)]}


def phase_gpt_mesh(dev, card, root, cfg):
    """Phase 40: GPT-2 124M fp32 at tp=2, then sp=2, two ranks."""
    print(f"== phase 40: GPT-2 124M fp32 through ShardedTrainStep on two "
          f"ranks sharing {card}: MeshConfig(tp=2) "
          f"({cfg['heads'] // 2} local heads a rank), "
          f"then MeshConfig(sp=2) (ring attention, {cfg['seq'] // 2} "
          f"positions a rank), batch {cfg['batch']} x seq {cfg['seq']}, "
          f"SGD {DP_SGD}, against phase 36's one-card step", flush=True)
    res, wall = dp_world(root, "gpt_mesh")
    return {"ranks": res, "launch_seconds": wall,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(3)]}


def phase_gpt_pp(dev, card, root, cfg):
    """Phase 41: GPT-2 124M fp32 at pp=2 with grad_accum=2; its bundle
    loads into a one-card step, which continues."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serialization
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    print(f"== phase 41: GPT-2 124M fp32, MeshConfig(pp=2) with "
          f"grad_accum=2 (the GPipe schedule: 2 microbatches of "
          f"{cfg['batch'] // 2}, {cfg['layers'] // 2} layers a stage) on two "
          f"ranks sharing {card}, against phase 36's one-card step; its bundle into a "
          f"one-card step", flush=True)
    res, wall = dp_world(root, "gpt_pp")
    net = dp_gpt_net(dev, cfg)
    one = MeshConfig()
    step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), one, one.batch_specs(2, 2))
    path = os.path.join(root, "gpt_pp2.safetensors")
    step.load_states(path)
    saved = serialization.load_safetensors(path)
    got = step.state_dict()["arrays"]
    bad = [k for k in saved if not onp.array_equal(saved[k], got[k])]
    check(set(saved) == set(got) and not bad,
          f"phase 41: the pp=2 bundle did not load bit for bit: {bad[:4]}")
    x, y = dp_gpt_batches(cfg)[0]
    cont = float(step(x, y))
    check(math.isfinite(cont), "phase 41: the one-card step continuing the "
                               "pp=2 bundle gave a non-finite loss")
    print(f"pp=2 bundle: {len(saved)} arrays loaded bit for bit into a "
          f"one-card step at update {step._n_step - 1}; it continued with "
          f"loss {cont:.6f}")
    del step, net
    dp_peak_reset(dev)
    return {"ranks": res, "launch_seconds": wall,
            "bundle_arrays_bit_for_bit": len(saved),
            "one_card_continued_loss": cont,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(3)]}


def phase_mesh4(dev, card, root, cfg):
    """Phase 42: four ranks: GPT-2 124M dp2 x tp2 zero=1, then BERT-base
    tp2 x sp2 without a mask (ring) and with valid_length, against a
    one-card BERT-base step run here first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    print(f"== phase 42: four ranks sharing {card}: GPT-2 124M fp32 "
          f"MeshConfig(dp=2, tp=2) zero=1; BERT-base fp32 (dropout 0, "
          f"fused_ln_residual 'on') MeshConfig(tp=2, sp=2), batch "
          f"{cfg['bert_batch']} x seq {cfg['bert_seq']} ({cfg['bert_seq'] // 2}"
          f" a rank), no mask (ring) then valid_length (keys gathered), "
          f"against the one-card BERT-base step", flush=True)
    from mxnet_tpu_torch.ops import ln_residual as lr
    ones = {}
    mx.config.set("fused_ln_residual", "on")
    try:
        for masked in (False, True):
            net = mesh_bert_net(dev, cfg)
            params = net.collect_params()
            start = dp_snapshot(params)
            args, names = mesh_bert_args(mesh_batches_bert(cfg), masked)
            cfg1 = MeshConfig()
            step = ShardedTrainStep(
                net, mesh_bert_loss, mx.optimizer.create("sgd", **DP_SGD),
                cfg1, [tuple(n if n != "sp" else None for n in s)
                       for s in names], n_labels=2)
            zero_ln_counters(lr)
            losses = [float(step(*args)) for _ in range(DP_STEPS)]
            ln = ln_counters(lr)
            check(dev.type != "cuda" or ln == [cfg["bert_layers"] * 2
                                               * DP_STEPS] * 2,
                  f"phase 42: one-card BERT ln_residual launches {ln}")
            tag = "valid_length" if masked else "plain"
            torch.save({"losses": losses, "start": start,
                        "final": dp_snapshot(params)},
                       os.path.join(root, f"bert_one_card_{tag}.pt"))
            ones[tag] = losses
            print(f"one-card BERT-base ({tag}): losses {losses}")
            del step, net, params
            dp_peak_reset(dev)
    finally:
        mx.config.reset("fused_ln_residual")
    res, wall = dp_world(root, "mesh4", 4)
    return {"one_card_bert_losses": ones, "ranks": res,
            "launch_seconds": wall,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(5)]}


# -- the rank side of phases 39-42 --------------------------------------------

def mesh_rank_run(label, step, batches, one, params, start, dev,
                  update_names=None, want_launches=None):
    """DP_STEPS updates of ``step`` on ``batches``: the first untimed,
    the rest timed (steps 2..DP_STEPS after a barrier), with the
    collectives' seconds and bytes, the byte counters, the peak memory and
    the kernels' launches in all of them (``want_launches`` a step); then
    the block made whole and held
    against the one-card run ``one`` (losses rtol DP_LOSS_RTOL, the update
    relative L2 DP_UPDATE_TOL). Returns the row."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import collectives as coll
    mx.telemetry.enable()
    mx.telemetry.reset()
    dp_peak_reset(dev)
    zero_all_counters()
    losses = [float(step(*batches[0]))]
    dp_sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    with coll.timing() as tm:
        for b in batches[1:]:
            losses.append(float(step(*b)))
        dp_sync(dev)
    wall = time.perf_counter() - t0
    launches = other_counters()[:5]
    counts = {k: v for k, v in mx.telemetry.counters().items()
              if k.startswith(("zero.", "mesh.", "comm."))}
    mx.telemetry.disable()
    peak = dp_peak_gb(dev)
    step.sync_to_block()
    final = dp_snapshot(params)
    bad = dp_equal_across_ranks(final)
    check(not bad, f"{label}: whole weights differ across ranks: {bad[:4]}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
    check(loss_rel <= DP_LOSS_RTOL,
          f"{label}: losses {losses} vs one card {one['losses']} (rtol "
          f"{DP_LOSS_RTOL})")
    names = update_names or list(one["final"])
    diff = dp_update_l2({n: final[n] for n in names},
                        {n: start[n] for n in names},
                        {n: one["final"][n] for n in names})
    at = dp_update_diff(final, start, one["final"], names)
    check(diff <= DP_UPDATE_TOL, f"{label}: the update is {diff:.3e} "
                                 "(relative L2) from the one card's")
    if want_launches is not None:
        want = [w * len(batches) for w in want_launches]
        check(dev.type != "cuda" or launches == want,
              f"{label}: launches in {len(batches)} steps {launches}, "
              f"expected {want}")
    row = {"losses": losses, "losses_vs_one_card": loss_rel,
           "update_vs_one_card": diff, "worst_tensor": at,
           "ms_per_step": wall / (len(batches) - 1) * 1e3,
           "collective_seconds_per_step":
               sum(v[0] for v in tm.values()) / (len(batches) - 1),
           "collective_calls_bytes": {k: v[1:] for k, v in tm.items()},
           "peak_allocated_gb": peak, "counters": counts,
           "launches": launches,
           "weights_whole_equal_across_ranks": True}
    return row


def dp_rank_ring(root, cfg):
    """Phase 39's rank: the card route against the plain route."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.ring_attention import _kernels, _plain
    routes = {"plain": _plain, "kernels": _kernels}
    dev = mx.parallel.rank_device()
    rank = mx.parallel.rank()
    mesh = make_mesh({"sp": 2}, devices=[dev])
    b, h, s, d = cfg["ring"]
    sl = s // 2
    out = {"rank": rank, "backend": mx.parallel.backend(), "cases": {},
           "launches": [0, 0, 0]}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(7)
        full = [torch.randn(b, h, s, d, device=dev, generator=gen)
                .to(dtype) for _ in range(4)]
        mine = [t[:, :, rank * sl:(rank + 1) * sl].contiguous()
                for t in full]
        for causal in (False, True):
            res = {}
            for route in ("plain", "kernels"):
                ts = [t.clone().requires_grad_() for t in mine[:3]]
                if route == "kernels":
                    zero_counters(fa)
                    dp_sync(dev)
                    t0 = time.perf_counter()
                o = routes[route](*ts, mesh, "sp", causal, d ** -0.5)
                (o.float() * mine[3].float()).sum().backward()
                if route == "kernels":
                    dp_sync(dev)
                    res["card_ms"] = (time.perf_counter() - t0) * 1e3
                    res["launches"] = counters(fa)
                res[route] = [o.detach()] + [t.grad for t in ts]
            errs = []
            for a, p in zip(res["kernels"], res["plain"]):
                scale = p.float().abs().max().item()
                errs.append((a.float() - p.float()).abs().max().item()
                            / scale)
            tag = f"{str(dtype)[6:]} causal={causal}"
            want = ([RING_CAUSAL_PAIRS[rank]] * 3 if causal else [2] * 3)
            check(dev.type != "cuda" or res["launches"] == want,
                  f"ring {tag}: launches {res['launches']}, expected {want}")
            check(max(errs) <= RING_TOL[dtype],
                  f"ring {tag}: card route off its plain version by "
                  f"{errs} of max (out, dq, dk, dv), limit {RING_TOL[dtype]}")
            out["cases"][tag] = {"max_err_over_max": errs,
                                 "launches": res["launches"],
                                 "card_fwd_bwd_ms": res["card_ms"]}
            out["launches"] = [a + c for a, c in zip(out["launches"],
                                                     res["launches"])]
            print(f"rank {rank} ring {tag}: {json.dumps(out['cases'][tag])}",
                  flush=True)
    return out


def _gpt_one(root):
    """Phase 36's one-card plain step: losses and weights."""
    return torch.load(os.path.join(root, "gpt_one_card.pt"))


def dp_rank_gpt_mesh(root, cfg):
    """Phase 40's rank: GPT-2 124M at tp=2, then sp=2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    one = _gpt_one(root)
    batches = dp_gpt_batches(cfg)
    out = {"rank": rank, "backend": mx.parallel.backend(), "runs": {}}
    L = cfg["layers"]
    for label, mcfg, want in (
            ("tp2", MeshConfig(tp=2), [L] * 3),
            ("sp2", MeshConfig(sp=2), [L * RING_CAUSAL_PAIRS[rank]] * 3)):
        net = dp_gpt_net(dev, cfg)
        params = net.collect_params()
        start = dp_snapshot(params)
        step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
            "sgd", **DP_SGD), mcfg, mcfg.batch_specs(2, 2))
        out["runs"][label] = mesh_rank_run(
            f"GPT-2 {label}", step, batches, one, params, start, dev,
            want_launches=want + [0, 0])
        del step, net, params
        dp_peak_reset(dev)
    out["launches"] = [sum(r["launches"][i]
                           for r in out["runs"].values()) for i in range(3)]
    return out


def dp_rank_gpt_pp(root, cfg):
    """Phase 41's rank: GPT-2 124M at pp=2 with grad_accum=2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    one = _gpt_one(root)
    batches = [tuple(a.reshape(2, -1, cfg["seq"]) for a in b)
               for b in dp_gpt_batches(cfg)]
    net = dp_gpt_net(dev, cfg)
    params = net.collect_params()
    start = dp_snapshot(params)
    mcfg = MeshConfig(pp=2)
    step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), mcfg, mcfg.batch_specs(2, 2), grad_accum=2)
    per = cfg["layers"] // 2 * 2
    row = mesh_rank_run("GPT-2 pp2 grad_accum=2", step, batches, one,
                        params, start, dev,
                        want_launches=[per] * 3 + [0, 0])
    # the stage shapes the schedule handed on, and the bundle
    step.save_states(os.path.join(root, "gpt_pp2.safetensors"))
    out = {"rank": rank, "backend": mx.parallel.backend(),
           "stage_layers": [step._plan.lo, step._plan.hi],
           "runs": {"pp2_accum2": row},
           "launches": row["launches"][:3]}
    return out


def dp_rank_mesh4(root, cfg):
    """Phase 42's rank: GPT-2 124M dp2 x tp2 zero=1, then BERT-base
    tp2 x sp2 without a mask and with valid_length."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    check(world == 4, f"rank {rank}: world {world}, expected 4")
    out = {"rank": rank, "backend": mx.parallel.backend(), "runs": {}}
    L = cfg["layers"]
    net = dp_gpt_net(dev, cfg)
    params = net.collect_params()
    start = dp_snapshot(params)
    mcfg = MeshConfig(dp=2, tp=2)
    step = ShardedTrainStep(net, dp_loss, mx.optimizer.create(
        "sgd", **DP_SGD), mcfg, mcfg.batch_specs(2, 2), zero=1)
    out["runs"]["gpt_dp2_tp2_zero1"] = mesh_rank_run(
        "GPT-2 dp2 x tp2 zero=1", step, dp_gpt_batches(cfg), _gpt_one(root),
        params, start, dev, want_launches=[L] * 3 + [0, 0])
    del step, net, params
    dp_peak_reset(dev)
    mx.config.set("fused_ln_residual", "on")
    BL = cfg["bert_layers"]
    for masked in (False, True):
        tag = "valid_length" if masked else "plain"
        one = torch.load(os.path.join(root, f"bert_one_card_{tag}.pt"))
        net = mesh_bert_net(dev, cfg)
        params = net.collect_params()
        start = dp_snapshot(params)
        mcfg = MeshConfig(tp=2, sp=2)
        args, names = mesh_bert_args(mesh_batches_bert(cfg), masked)
        step = ShardedTrainStep(
            net, mesh_bert_loss, mx.optimizer.create("sgd", **DP_SGD), mcfg,
            names, n_labels=2)
        # no mask: every pair of the ring a layer (2), the flash backward
        # alike; valid_length: keys gathered, the plain attention; the
        # fused ln_residual twice a layer either way
        flash = 0 if masked else 2 * BL
        trained = [n for n, p in params.items() if p.grad_req != "null"]
        out["runs"][f"bert_tp2_sp2_{tag}"] = mesh_rank_run(
            f"BERT-base tp2 x sp2 {tag}", step, [args] * DP_STEPS, one,
            params, start, dev, update_names=trained,
            want_launches=[flash] * 3 + [2 * BL] * 2)
        del step, net, params
        dp_peak_reset(dev)
    mx.config.reset("fused_ln_residual")
    out["launches"] = [sum(r["launches"][i]
                           for r in out["runs"].values()) for i in range(5)]
    return out


def dp_nccl_probe():
    """Whether NCCL takes two ranks on one card: an all-reduce over a
    group of this process and the launcher's other one, both on cuda:0.
    Returns the outcome's text (the finding either way)."""
    import datetime
    import torch.distributed as dist
    rank = int(os.environ["DMLC_WORKER_ID"])
    store = dist.TCPStore("127.0.0.1", int(os.environ["DMLC_PS_ROOT_PORT"]),
                          2, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    try:
        pg = dist.ProcessGroupNCCL(store, rank, 2)
        t = torch.ones(4, device="cuda:0")
        pg.allreduce([t]).wait(timeout=datetime.timedelta(seconds=60))
        torch.cuda.synchronize()
        return f"accepted: all_reduce gave {t.tolist()}"
    except Exception as e:  # noqa: BLE001 - the outcome is the finding
        return (f"refused: {type(e).__name__}: "
                f"{str(e).strip().splitlines()[0][:300]}")


def dp_rank_main(kind, root):
    """A rank of phase 37 (``gpt``), 38 (``resnet``), 39 (``ring``), 40
    (``gpt_mesh``), 41 (``gpt_pp``), 42 (``mesh4``), 43 (``fleet``) or the
    NCCL probe;
    writes ``<root>/<kind>_rank<r>.json``."""
    if kind == "nccl_probe":
        # the port is not imported: its import would join the gloo group
        print(f"NCCL_PROBE {dp_nccl_probe()}", flush=True)
        return
    with open(os.path.join(root, "dp_config.json")) as f:
        cfg = json.load(f)
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"gpt": dp_rank_gpt, "resnet": dp_rank_resnet,
           "ring": dp_rank_ring, "gpt_mesh": dp_rank_gpt_mesh,
           "gpt_pp": dp_rank_gpt_pp, "mesh4": dp_rank_mesh4,
           "fleet": dp_rank_fleet}[kind](root, cfg)
    with open(os.path.join(root, f"{kind}_rank{mx.parallel.rank()}.json"),
              "w") as f:
        json.dump(out, f)
    head = {k: v for k, v in out.items() if k != "runs"}
    print(f"rank {mx.parallel.rank()} {kind}: {json.dumps(head)}",
          flush=True)
    for label, row in out.get("runs", {}).items():
        print(f"rank {mx.parallel.rank()} {label}: {json.dumps(row)}",
              flush=True)


# -- phases 43-44: the elastic fleets -----------------------------------------
#
# Phase 43 starts four ranks on the card (``--dp-rank fleet``): GPT-2 124M
# fp32 at all 12 layers under ``FleetSupervisor`` (``mx.fleet``), the
# reference drill's schedule at full width. Phase 44 runs in this process:
# ``ServeFleet`` (``mx.servefleet``) over replicas of phase 3's engine.

#: the drill's schedule (tests/test_fleet.py:292-335): 8 steps, host 1
#: lost at step 4, the hosts back after step 6; plain SGD 0.01
FLEET_STEPS, FLEET_LOSS_AT, FLEET_RESTORE_AFTER = 8, 4, 6
FLEET_SGD = {"learning_rate": 0.01}
#: each step's loss against the uninterrupted run at the target layout,
#: absolute: the reference drill's bound (tests/test_fleet.py:331)
FLEET_LOSS_TOL = 1e-5
#: phase 44: replicas of phase 3's engine, the stall deadline of its stall
#: drill and the tokens a stalled request asks for (small, so the wedged
#: replica's dispatched work holds finished requests when it is drained)
SERVE_FLEET_REPLICAS, SERVE_STALL_DEADLINE, SERVE_STALL_NEW = 3, 0.5, 3
#: the live tensors after a sole replica's crash-and-rebuild cycle, over
#: those with that one replica before it: the rebuilt replica's own plus
#: at most a tenth of one engine's (the dead one's are all freed). The
#: reservation is held to less than one engine's more: late in the
#: script the caching allocator cannot return every freed segment (on one
#: H100: 0.8 GB reserved with 0.2 GB allocated before the phase)
SERVE_FLEET_MEM_SLACK = 0.1


def fleet_batch(cfg, s):
    """The global batch of drill step ``s``: batch x seq + 1 tokens from
    RandomState(1000 + s), a different batch each step (a replay after a
    rollback must feed the same one)."""
    ids = onp.random.RandomState(1000 + s).randint(
        0, cfg["vocab"], (cfg["batch"], cfg["seq"] + 1))
    return ids[:, :-1].astype(onp.int64), ids[:, 1:].astype(onp.int64)


def _bundle_equal(step, path):
    """Whether ``step``'s canonical state equals the TrainState bundle at
    ``path`` bit for bit (collective over the step's ranks)."""
    import pickle
    with open(path, "rb") as f:
        want = pickle.loads(f.read())["sharded_step"]
    got = step.state_dict()
    return got["n_step"] == want["n_step"] and set(got["arrays"]) == set(
        want["arrays"]) and all(
        onp.array_equal(got["arrays"][k], want["arrays"][k])
        for k in want["arrays"])


def phase_gpt_fleet(dev, card, root, cfg):
    """Phase 43: the training fleet drill on four ranks sharing the card."""
    print(f"== phase 43: GPT-2 124M fp32 ({cfg['layers']} layers) under "
          f"mx.fleet.FleetSupervisor on four ranks sharing {card}: target "
          f"MeshConfig(dp=2, tp=2), 2 hosts of 2 ranks, checkpoint every "
          f"step, fleet.host_loss at step {FLEET_LOSS_AT} -> "
          f"MeshConfig(dp=1, tp=2) on ranks 0-1 (ranks 2-3 stranded), "
          f"restore_hosts() after step {FLEET_RESTORE_AFTER} -> re-expand, "
          f"{FLEET_STEPS} steps of batch {cfg['batch']} x seq {cfg['seq']}, "
          f"SGD {FLEET_SGD}, against the uninterrupted run at the target "
          "layout", flush=True)
    res, wall = dp_world(root, "fleet", 4)
    return {"ranks": res, "launch_seconds": wall,
            "launches": [sum(r["launches"][i] for r in res)
                         for i in range(3)]}


def dp_rank_fleet(root, cfg):
    """Phase 43's rank: the oracle at the target layout, then the drill."""
    import warnings
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.fleet import FleetSupervisor
    from mxnet_tpu_torch.parallel import MeshConfig, ShardedTrainStep
    dev = mx.parallel.rank_device()
    rank, world = mx.parallel.rank(), mx.parallel.world_size()
    check(world == 4, f"rank {rank}: world {world}, expected 4")
    target, L = MeshConfig(dp=2, tp=2), cfg["layers"]

    def make_step():
        return ShardedTrainStep(
            dp_gpt_net(dev, cfg), dp_loss,
            mx.optimizer.create("sgd", **FLEET_SGD), target,
            target.batch_specs(2, 2))

    # the uninterrupted run at the target layout
    step = make_step()
    oracle = {s: float(step(*fleet_batch(cfg, s)))
              for s in range(1, FLEET_STEPS + 1)}
    del step
    dp_peak_reset(dev)

    # instruments: each step's ms by layout, each bundle save's seconds
    times, saves, marks, transitions = {}, [], [], []
    call, save = ShardedTrainStep.__call__, mx.resilience.TrainState.save

    def timed_call(self, *batch):
        dp_sync(dev)
        t0 = time.perf_counter()
        out = call(self, *batch)
        dp_sync(dev)
        times.setdefault(f"dp{self.dp} x tp{self.tp}", []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def timed_save(self, *a, **k):
        t0 = time.perf_counter()
        out = save(self, *a, **k)
        saves.append(time.perf_counter() - t0)
        return out

    class Drill(FleetSupervisor):
        def _restore(self):
            t0 = time.perf_counter()
            super()._restore()
            dp_sync(dev)
            self._restore_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            self._bitwise = (None if self.stranded else
                             _bundle_equal(self.step, self.state.path))
            self._check_s = time.perf_counter() - t1

        def _apply(self, cfg_, kind):
            dp_sync(dev)
            t0 = time.perf_counter()
            super()._apply(cfg_, kind)
            dp_sync(dev)
            total = time.perf_counter() - t0
            transitions.append({
                "kind": kind, "layout": [cfg_.dp, cfg_.tp, cfg_.pp, cfg_.sp],
                "stranded": self.stranded, "step": self.state.step,
                "downtime_s": total - self._check_s,
                "restore_s": self._restore_s,
                "restored_bit_for_bit": self._bitwise,
                "launches_at": other_counters()[:3]})

    def batch_fn(s):
        marks.append((s, other_counters()[:3]))
        return fleet_batch(cfg, s)

    ShardedTrainStep.__call__ = timed_call
    mx.resilience.TrainState.save = timed_save
    try:
        zero_all_counters()
        dp_peak_reset(dev)
        mx.goodput.enable()
        step = make_step()
        state = mx.resilience.TrainState(
            path=os.path.join(root, "fleet.bundle"), sharded_step=step)
        sup = Drill(step, state, n_hosts=2, checkpoint_every=1)
        del step
        mx.fault.configure(f"fleet.host_loss:at={FLEET_LOSS_AT},times=1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the degraded mesh strands 2
            losses = sup.run(batch_fn, FLEET_RESTORE_AFTER)
            degraded = [sup.current.dp, sup.current.tp, sup.current.pp,
                        sup.current.sp]
            stranded = sup.stranded
            sup.restore_hosts()
            losses.update(sup.run(batch_fn, FLEET_STEPS))
        dp_sync(dev)
        end = other_counters()[:3]
        mx.fault.clear()
        restart_s = mx.goodput.summary()["buckets"].get("restart", 0.0)
        mx.goodput.disable()
        peak = dp_peak_gb(dev)
        losses = {s: float(v) for s, v in losses.items()}
    finally:
        ShardedTrainStep.__call__ = call
        mx.resilience.TrainState.save = save
    check(sup.degrades == 1 and sup.reexpands == 1,
          f"rank {rank}: {sup.degrades} degrades, {sup.reexpands} "
          "re-expands, expected 1 and 1")
    # each computed step's launches (a batch_fn call to the next, or to
    # the end), and those while the layout strands ranks 2-3
    nexts = [c for _, c in marks[1:]] + [end]
    per_step = {s: [b - a for a, b in zip(c, n)]
                for (s, c), n in zip(marks, nexts)}
    deg, rex = transitions
    window = [b - a for a, b in zip(deg["launches_at"], rex["launches_at"])]
    want_steps = ([1, 2, 3, 7, 8] if rank >= 2
                  else list(range(1, FLEET_STEPS + 1)))
    check(degraded == [1, 2, 1, 1] and stranded == (rank >= 2),
          f"rank {rank}: degraded to {degraded}, stranded {stranded}")
    check(sorted(losses) == want_steps,
          f"rank {rank}: computed steps {sorted(losses)}, expected "
          f"{want_steps}")
    gaps = {s: abs(losses[s] - oracle[s]) for s in losses}
    check(max(gaps.values()) < FLEET_LOSS_TOL,
          f"rank {rank}: losses {losses} vs the uninterrupted run {oracle} "
          f"(bound {FLEET_LOSS_TOL})")
    for t in transitions:
        check(t["stranded"] or t["restored_bit_for_bit"],
              f"rank {rank}: the {t['kind']} restore is not bit for bit "
              "the bundle")
    check(dev.type != "cuda" or all(v == [L] * 3 for v in per_step.values()),
          f"rank {rank}: launches a step {per_step}, expected {L} each")
    check(dev.type != "cuda" or window == ([0] * 3 if rank >= 2 else
                                           [3 * L] * 3),
          f"rank {rank}: launches while ranks 2-3 are stranded {window}")
    return {"rank": rank, "backend": mx.parallel.backend(),
            "oracle_losses": oracle, "losses": losses,
            "max_loss_gap": max(gaps.values()), "degraded_layout": degraded,
            "stranded_while_degraded": stranded,
            "transitions": transitions,
            "step_ms_median": {k: float(onp.median(v))
                               for k, v in times.items()},
            "step_ms": times, "bundle_save_s": saves,
            "goodput_restart_s": restart_s, "peak_allocated_gb": peak,
            "launches_per_step": per_step,
            "launches_while_degraded": window,
            "launches": end}


def fleet_ttft_tpot(fleet, since):
    """TTFT and TPOT p50 (ms) over the replicas' requests completed past
    ``since`` ({rid: completed count})."""
    reqs = [r for rep in fleet._replicas.values()
            for r in rep.engine._completed[since.get(rep.rid, 0):]]
    ttft = [r.ttft for r in reqs if r.ttft is not None]
    tpot = [r.tpot for r in reqs if r.tpot is not None]
    return (float(onp.percentile(ttft, 50)) * 1e3,
            float(onp.percentile(tpot, 50)) * 1e3)


def fleet_run(fleet, prompts, n_new, prefix, **submit):
    """Submit every prompt in its own session, run the fleet to the end:
    (fleet requests, synchronized wall seconds, completions before)."""
    since = {rep.rid: len(rep.engine._completed)
             for rep in fleet._replicas.values()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frs = [fleet.submit(p, max_new_tokens=n_new, session=f"{prefix}{i}",
                        key=f"{prefix}{i}", **submit)
           for i, p in enumerate(prompts)]
    fleet.run()
    torch.cuda.synchronize()
    return frs, time.perf_counter() - t0, since


def fleet_tokens_check(label, net, dev, prompts, frs, base, n_new):
    """Every request completed once, with phase 3's greedy tokens (or a
    tie the full forward shows): the count equal."""
    equal = 0
    for fr, p, b in zip(frs, prompts, base):
        check(fr.done and len(fr.tokens) == n_new,
              f"{label}: {fr.key} done={fr.done} with "
              f"{len(fr.tokens or [])} tokens")
        equal += fr.tokens == b[:n_new]
        same_or_tie(net, dev, p, fr.tokens, b[:n_new], SERVE_VOCAB,
                    f"{label} {fr.key}")
    return equal


def decode_host_us(eng, prompts, steps=24):
    """Host microseconds a decode step with every slot live (the calls
    dispatch graph replays; no sync inside the timed loop)."""
    reqs = [eng.submit(p, max_new_tokens=steps + 8)
            for p in prompts[:eng.max_slots]]
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    host = (time.perf_counter() - t0) / steps * 1e6
    eng.run()
    check(all(r.finished for r in reqs), "host-cost requests unfinished")
    return host


@contextlib.contextmanager
def graph_launch_ledger():
    """Within: each serve-engine graph records the kernel-1 launches its
    capture recorded (the wrapper counts a launch under capture, a replay
    runs no wrapper), and every replay of a prefill graph adds them to the
    yielded ``{"replays": n, "flash": n}``: kernel 1's launches inside the
    replayed graphs, counted without the profiler's device events."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serve import engine as _engine
    capture, call = _engine._Step.capture, _engine._Step.__call__
    ledger = {"replays": 0, "flash": 0, "per_graph": set()}

    def counted_capture(self, *args, **kwargs):
        before = fa.flash_attention_fwd.launches
        capture(self, *args, **kwargs)
        self._flash_nodes = fa.flash_attention_fwd.launches - before
        if self.n_in:
            ledger["per_graph"].add(self._flash_nodes)

    def counted_call(self, host=None):
        if self.graph is not None and self.n_in:
            ledger["replays"] += 1
            ledger["flash"] += self._flash_nodes
        return call(self, host)

    _engine._Step.capture = counted_capture
    _engine._Step.__call__ = counted_call
    try:
        yield ledger
    finally:
        _engine._Step.capture = capture
        _engine._Step.__call__ = call


def card_gb():
    """(allocated, reserved) GB once the caching allocator has returned
    its free segments."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated() / 1e9,
            torch.cuda.memory_reserved() / 1e9)


def reserved_gb():
    """The caching allocator's reservation (GB), its free segments
    returned."""
    return card_gb()[1]


def phase_serve_fleet(dev, card, root, prompts, base, serve_row):
    """Phase 44: ``ServeFleet`` over replicas of phase 3's engine."""
    from mxnet_tpu_torch import servefleet
    print(f"== phase 44: mx.servefleet.ServeFleet of "
          f"{SERVE_FLEET_REPLICAS} replicas of phase 3's engine (GPT-2 "
          f"124M fp32, max_slots 8, every step a CUDA graph) on {card}: "
          "phase 3's 16 greedy requests, one session each; crash and stall "
          "failover, a rolling update with a canary, a bad canary, a sole "
          "replica's crash-and-rebuild", flush=True)
    base_gb = card_gb()
    with graph_launch_ledger() as ledger:
        fleet = servefleet.ServeFleet(lambda: serve_net(dev),
                                      replicas=SERVE_FLEET_REPLICAS,
                                      min_replicas=1, max_slots=8)
        return phase_serve_fleet_drills(dev, card, root, prompts, base,
                                        serve_row, fleet, base_gb, ledger)


def phase_serve_fleet_drills(dev, card, root, prompts, base, serve_row,
                             fleet, base_gb, ledger):
    """Phase 44's drills on ``fleet`` (its graphs in ``ledger``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import servefleet
    out = {}
    n_new = SERVE_NEW_TOKENS
    built = card_gb()
    out["reserved_gb"] = {"before": base_gb[1], "built": built[1]}
    #: one replica's live tensors and reservation, from the fleet's build
    n = len(fleet._replicas)
    engine_alloc = (built[0] - base_gb[0]) / n
    engine_res = (built[1] - base_gb[1]) / n
    # the full forward of the tie checks: phase 3's weights, a model of its
    # own (a replica's would outlive its release)
    ref_net = serve_net(dev)
    frs, wall, since = fleet_run(fleet, prompts, n_new, "t")
    ttft, tpot = fleet_ttft_tpot(fleet, since)
    equal = fleet_tokens_check("fleet", ref_net, dev, prompts, frs, base,
                               n_new)
    tokens = sum(len(fr.tokens) for fr in frs)
    out["e2e"] = {"tokens_per_s": tokens / wall, "ttft_p50_ms": ttft,
                  "tpot_p50_ms": tpot, "wall_s": wall,
                  "tokens_equal_phase3": equal,
                  "replicas_used": len({fr.replica_id for fr in frs}),
                  "phase3_single_engine": {
                      k: serve_row[k] for k in ("tokens_per_s",
                                                "ttft_p50_ms",
                                                "tpot_p50_ms", "wall_s")}}
    print(f"fleet e2e [{card}]: " + json.dumps(out["e2e"]))
    # kernel 1 inside the replicas' prefill graphs: each prefill graph's
    # captured launches over its replays in a run of 16 full prefills,
    # and the profiler's device events of the same run (which the
    # profiler can drop now and then: printed, held only above 0)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    check(ledger["per_graph"] == {N_LAYERS},
          f"fleet: prefill graphs hold {ledger['per_graph']} kernel-1 "
          f"launches, expected {N_LAYERS} each")
    r0, f0 = ledger["replays"], ledger["flash"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fleet_run(fleet, prompts, 1, "p")
    events = sum("flash_fwd" in e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    replays, flash = ledger["replays"] - r0, ledger["flash"] - f0
    print(f"  profiled fleet run: {replays} prefill graph replays holding "
          f"{flash} kernel-1 launches, {events} flash forward kernel "
          "events from the profiler")
    check(replays == len(prompts) and flash == N_LAYERS * len(prompts)
          and events > 0,
          f"fleet: {replays} prefills, {flash} kernel-1 launches in them, "
          f"{events} device events; expected {len(prompts)} and "
          f"{N_LAYERS} x {len(prompts)}")
    out["flash_fwd_launches"] = flash
    out["flash_fwd_events"] = events
    # the hook's cost: host calls and host us a decode step, the module
    # gate on (a fleet runs) and off, in turns
    eng = fleet._live()[0].engine
    calls_on = decode_launch_calls(eng, prompts)
    servefleet._active = False
    calls_off = decode_launch_calls(eng, prompts)
    host = {"on": [], "off": []}
    for on in (True, False, False, True):
        servefleet._active = on
        host["on" if on else "off"].append(decode_host_us(eng, prompts))
    servefleet._active = True
    out["decode_step"] = {"host_calls_gate_on": calls_on,
                          "host_calls_gate_off": calls_off,
                          "host_us_gate_on": host["on"],
                          "host_us_gate_off": host["off"]}
    print(f"decode step [{card}]: " + json.dumps(out["decode_step"]))

    # crash failover: serve.replica_crash two ticks on
    pre = card_gb()
    mx.telemetry.enable()
    mx.telemetry.reset()
    mx.fault.configure(f"serve.replica_crash:at={fleet._tick + 2}")
    frs, _, _ = fleet_run(fleet, prompts, n_new, "c")
    mx.fault.clear()
    cnt = mx.telemetry.counters(aggregate=True)
    equal = fleet_tokens_check("crash", ref_net, dev, prompts, frs, base,
                               n_new)
    dead = [r for r in fleet._replicas.values() if r.state == "dead"]
    check(len(dead) == 1 and cnt.get("servefleet.failovers_total") == 1,
          f"crash: {len(dead)} dead replicas, counters {cnt}")
    check(cnt.get("servefleet.completed_total") == len(prompts)
          and cnt.get("servefleet.duplicates_suppressed_total", 0) == 0,
          f"crash: not exactly once: {cnt}")
    post = card_gb()
    check(dead[0].engine._exe == {} and dead[0].engine._cache is None
          and post[0] <= pre[0] - (1 - SERVE_FLEET_MEM_SLACK) * engine_alloc,
          f"crash: the dead replica was not released: {pre[0]:.3f} -> "
          f"{post[0]:.3f} GB allocated ({engine_alloc:.3f} GB an engine)")
    out["crash"] = {"redispatched": cnt.get("servefleet.redispatched_total"),
                    "tokens_equal_phase3": equal,
                    "allocated_gb": [pre[0], post[0]],
                    "reserved_gb": [pre[1], post[1]]}
    print(f"crash drill [{card}]: " + json.dumps(out["crash"]))

    # rolling update to phase 25's swap weights, published with their card
    other = serve_net(dev, seed=2)
    scratch = mx.serve.load(other, max_slots=8).warmup()
    canary_prompts = [list(map(int, p)) for p in prompts[:2]]
    card_new = servefleet.canary_card(scratch, canary_prompts, tokens=8)
    t0 = time.perf_counter()
    ckpt = servefleet.publish_checkpoint(
        os.path.join(root, "ckpt"),
        {n: p.data() for n, p in other.collect_params().items()},
        canary=card_new, step=1)
    publish_s = time.perf_counter() - t0
    del scratch, other
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, canary = servefleet.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t0
    graphs = {r.rid: r.engine.compiles for r in fleet._live()}
    t0 = time.perf_counter()
    report = fleet.rolling_update(params, canary=canary)
    roll_s = time.perf_counter() - t0
    live = fleet._live()
    check(not report["rolled_back"] and report["generation"] == 1
          and sorted(report["updated"]) == sorted(r.rid for r in live),
          f"rolling update: {report}")
    check(all(r.generation == 1 and r.engine.post_warmup_compiles == 0
              and r.engine.compiles == graphs[r.rid] for r in live),
          "rolling update: a replica captured a graph or missed the "
          "generation")
    frs, _, _ = fleet_run(fleet, canary_prompts, 8, "g")
    check([fr.tokens for fr in frs] == card_new["expected"],
          "rolling update: the fleet's tokens differ from the canary card")
    out["rolling_update"] = {
        "report": report, "publish_s": publish_s, "load_s": load_s,
        "rollout_s": roll_s, "post_warmup_captures": [
            r.engine.post_warmup_compiles for r in live],
        "canaries_equal": True, "reserved_gb": reserved_gb()}
    del live
    print(f"rolling update [{card}]: " + json.dumps(out["rolling_update"]))
    # a checkpoint whose canary disagrees (the original weights, the new
    # weights' card): rolled back at the first replica, the rollout aborted
    orig = serve_net(dev)
    bad = servefleet.publish_checkpoint(
        os.path.join(root, "ckpt_bad"),
        {n: p.data() for n, p in orig.collect_params().items()},
        canary=card_new, step=2)
    del orig
    params, canary = servefleet.load_checkpoint(bad)
    report = fleet.rolling_update(params, canary=canary)
    check(report["rolled_back"] and "canary diverged" in report["reason"]
          and report["updated"] == [] and fleet._generation == 1,
          f"bad canary: {report}")
    check(all(r.generation == 1 and r.engine.post_warmup_compiles == 0
              for r in fleet._live()), "bad canary: a replica left gen 1")
    frs, _, _ = fleet_run(fleet, canary_prompts, 8, "b")
    check([fr.tokens for fr in frs] == card_new["expected"],
          "bad canary: the fleet does not serve the kept generation")
    out["bad_canary"] = {"rolled_back": True, "replica": report["replica"],
                         "reserved_gb": reserved_gb()}
    print(f"bad canary [{card}]: " + json.dumps(out["bad_canary"]))
    del params, canary, ref_net, eng
    fleet.close()
    del fleet
    torch.cuda.empty_cache()
    out["reserved_gb"]["closed"] = reserved_gb()

    # the sole replica crashes and is rebuilt: its memory comes back
    bare = card_gb()
    fleet = servefleet.ServeFleet(lambda: serve_net(dev), replicas=1,
                                  min_replicas=1, max_slots=8)
    one = card_gb()
    mx.telemetry.reset()
    mx.fault.configure("serve.replica_crash:at=2")
    frs, _, _ = fleet_run(fleet, prompts[:8], n_new, "s")
    mx.fault.clear()
    cnt = mx.telemetry.counters(aggregate=True)
    after = card_gb()
    rebuilt = fleet._live()[0]
    equal = fleet_tokens_check("sole", rebuilt.engine.model, dev,
                               prompts[:8], frs, base, n_new)
    check(sorted(r.state for r in fleet._replicas.values())
          == ["dead", "live"] and cnt.get("servefleet.completed_total") == 8,
          f"sole replica: {cnt}")
    engine_alloc = one[0] - bare[0]
    check(after[0] <= one[0] + SERVE_FLEET_MEM_SLACK * engine_alloc,
          f"sole replica: {after[0]:.3f} GB allocated after the crash-and-"
          f"rebuild, {one[0]:.3f} GB with the one replica "
          f"({engine_alloc:.3f} GB an engine)")
    check(after[1] < one[1] + engine_res,
          f"sole replica: {after[1]:.3f} GB reserved after the crash-and-"
          f"rebuild, {one[1]:.3f} GB with the one replica "
          f"({engine_res:.3f} GB an engine's reservation)")
    out["sole_crash"] = {"allocated_gb": {"before": bare[0], "one": one[0],
                                          "after_rebuild": after[0]},
                         "reserved_gb": {"before": bare[1], "one": one[1],
                                         "after_rebuild": after[1]},
                         "engine_allocated_gb": engine_alloc,
                         "engine_reserved_gb": engine_res,
                         "tokens_equal_phase3": equal}
    print(f"sole replica crash [{card}]: " + json.dumps(out["sole_crash"]))
    fleet.close()
    del fleet, rebuilt
    torch.cuda.empty_cache()

    # stall failover: the wedged replica's dispatched work drains after its
    # requests re-dispatched; the late duplicates are suppressed
    mx.config.set("servefleet.stall_deadline", SERVE_STALL_DEADLINE)
    fleet = servefleet.ServeFleet(lambda: serve_net(dev), replicas=2,
                                  min_replicas=1, max_slots=8,
                                  drain_window=64)
    mx.telemetry.reset()
    mx.fault.configure("serve.replica_stall:at=4")
    frs = [fleet.submit(p, max_new_tokens=SERVE_STALL_NEW, session=f"w{i}")
           for i, p in enumerate(prompts)]
    fleet.run(tick_interval=0.01)
    for _ in range(400):
        if not any(r.engine.pending for r in fleet._live()):
            break
        fleet.step()
    mx.fault.clear()
    cnt = mx.telemetry.counters(aggregate=True)
    equal = sum(fr.tokens == b[:SERVE_STALL_NEW]
                for fr, b in zip(frs, base))
    check(all(fr.done for fr in frs) and equal == len(prompts),
          f"stall: {equal} of {len(prompts)} requests with phase 3's tokens")
    check(cnt.get("servefleet.completed_total") == len(prompts)
          and cnt.get("servefleet.failovers_total") == 1
          and cnt.get("servefleet.duplicates_suppressed_total", 0) >= 1,
          f"stall: {cnt}")
    out["stall"] = {k.split(".")[1]: v for k, v in cnt.items()
                    if k.startswith("servefleet.")}
    out["stall"]["reserved_gb"] = reserved_gb()
    print(f"stall drill [{card}]: " + json.dumps(out["stall"]))
    fleet.close()
    mx.config.reset("servefleet.stall_deadline")
    mx.telemetry.disable()
    del fleet
    torch.cuda.empty_cache()
    return out


def conv_entry(errs, rows, launches, per_shape, bf16_launches,
               bf16_per_shape):
    """Kernel 8's entry; ``per_shape`` is phase 13's read of the calls a
    step by (N, H, W, C, O), which weights the per-step sums;
    ``bf16_per_shape`` phase 18's for the bf16 instantiation."""
    per_step = sum(per_shape.values())
    row = rows[CONV_STAGES[0]]
    row16 = rows[CONV_STAGES[0] + ("bf16",)]

    def calls(n, h, w, c):
        return per_shape.get((n, h, w, c, c), 0)

    def calls16(n, h, w, c):
        return bf16_per_shape.get((n, h, w, c, c), 0)

    def step_sum(value, tag=(), count=calls):
        vals = [value(rows[s + tag]) for s in CONV_STAGES]
        if None in vals:
            return None
        return sum(count(*s) * v for s, v in zip(CONV_STAGES, vals))

    def kernel_ms(r):
        return (r["cuda_kernels_ms"] if r["cuda_kernels_ms"] is not None
                else pick(r, "kernel"))

    return {
        "name": "conv3x3_bn_relu_bwd",
        "route": "cuda",
        "source": SOURCE.format("conv_bwd"),
        "replaces": TPU_CONV.format(40),
        "launches": launches + bf16_launches,
        "launches_by_path": {"resnet_train": launches,
                             "resnet_int8_infer": 0,
                             "resnet_bf16_train": bf16_launches},
        "launches_per_step": {"resnet_train": per_step,
                              "resnet_bf16_train": sum(
                                  bf16_per_shape.values())},
        "cuda_kernels_per_launch": ["conv_bwd_wsplit_kernel",
                                    "conv_bwd_dgrad_kernel",
                                    "conv_bwd_reduce_kernel (dx, where the "
                                    "output channels split)",
                                    "conv_bwd_wgrad_kernel",
                                    "conv_bwd_reduce_kernel (dw, where the "
                                    "pixels split)"],
        "max_abs_err": errs["max_abs_err"],
        "max_rel_err": errs["max_rel_err"],
        "ms": kernel_ms(row),
        "call_ms_with_stats_pass": pick(row, "kernel"),
        "plain_ms": pick(row, "plain"),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_3xtf32_ms": row["bound_3xtf32_ms"],
        "bound_3xtf32_by": row["bound_3xtf32_by"],
        "library_ms": None,
        "composition_ms": pick(row, "composition"),
        "composition": "autograd backward of F.conv2d -> F.batch_norm("
                       "training=True) -> relu (cuDNN, TF32 off): no single "
                       "PyTorch call computes this function",
        "shape": "N=32 H=W=56 C=O=64 fp32",
        "by_shape": {f"N={n} H={h} W={w} C=O={c}": {
            "ms": kernel_ms(r), "call_ms_with_stats_pass": pick(r, "kernel"),
            "plain_ms": pick(r, "plain"), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "bound_3xtf32_ms": r["bound_3xtf32_ms"],
            "composition_ms": pick(r, "composition"),
            "launches_per_step": calls(n, h, w, c)}
            for (n, h, w, c), r in ((s, rows[s]) for s in CONV_STAGES)},
        "ms_per_step": step_sum(kernel_ms),
        "composition_ms_per_step": step_sum(lambda r: pick(r,
                                                           "composition")),
        "bound_ms_per_step": step_sum(lambda r: r["bound_ms"]),
        "bound_3xtf32_ms_per_step": step_sum(lambda r: r["bound_3xtf32_ms"]),
        "call_ms_with_stats_pass_per_step": step_sum(lambda r: pick(
            r, "kernel")),
        "bf16_cuda_kernels_per_launch": [
            "conv_bwd_wcopy_bf16_kernel", "conv_bwd_dgrad_bf16_kernel",
            "conv_bwd_reduce_kernel<bf16> (dx, where the output channels "
            "split)", "conv_bwd_wgrad_bf16_kernel",
            "conv_bwd_reduce_kernel<bf16> (dw, where the pixels split)"],
        "bf16_max_abs_err": errs["bf16"]["max_abs_err"],
        "bf16_max_rel_err": errs["bf16"]["max_rel_err"],
        "bf16_max_excess_over_one_ulp_allowance":
            errs["bf16"]["max_excess_over_allowance"],
        "bf16_ms": kernel_ms(row16),
        "bf16_call_ms_with_stats_pass": pick(row16, "kernel"),
        "bf16_plain_ms": pick(row16, "plain"),
        "bf16_bound_ms": row16["bound_ms"],
        "bf16_bound_by": row16["bound_by"],
        "bf16_composition_ms": pick(row16, "composition"),
        "bf16_composition": "autograd backward of F.conv2d (bf16) -> "
                            "F.batch_norm(training=True, fp32 gamma and "
                            "beta) -> relu (cuDNN)",
        "bf16_by_shape": {f"N={n} H={h} W={w} C=O={c}": {
            "ms": kernel_ms(r), "call_ms_with_stats_pass": pick(r, "kernel"),
            "plain_ms": pick(r, "plain"), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "composition_ms": pick(r, "composition"),
            "launches_per_step": calls16(n, h, w, c)}
            for (n, h, w, c), r in ((s, rows[s + ("bf16",)])
                                    for s in CONV_STAGES)},
        "bf16_ms_per_step": step_sum(kernel_ms, ("bf16",), calls16),
        "bf16_composition_ms_per_step": step_sum(
            lambda r: pick(r, "composition"), ("bf16",), calls16),
        "bf16_bound_ms_per_step": step_sum(lambda r: r["bound_ms"],
                                           ("bf16",), calls16),
    }


def int8_entry(launches, errs, rows):
    def composition_ms(r):
        return (pick(r, "composition") if r["composition_call_ms"] is not None
                else None)

    def forward_sum(value):
        vals = [value(rows[s]) for s in INT8_BERT_SHAPES]
        if None in vals:
            return None
        return sum(INT8_BERT_SHAPES[s] * v for s, v in zip(INT8_BERT_SHAPES,
                                                            vals))

    row = rows[next(iter(INT8_BERT_SHAPES))]
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": SOURCE.format("int8_matmul"),
        "replaces": TPU_QMM.format(77),
        "launches": launches,
        "launches_by_path": {"bert_int8_infer": launches},
        "launches_per_forward": INT8_LAYERS,
        "max_abs_err": errs["max_abs_err"],
        "ms": pick(row, "kernel"),
        "plain_ms": pick(row, "plain"),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "composition_ms": composition_ms(row),
        "composition": "quantize_int8 -> torch._int_mm -> * (xs * ws) + b: "
                       "no single PyTorch call computes this function",
        "shape": "M=4096 K=768 N=768 fp32 x, int8 w, bias",
        "by_shape": {f"M={m} K={k} N={n}": {
            "ms": pick(r, "kernel"), "prepare_ms": r["prepare_device_ms"],
            "gemm_ms": r["gemm_device_ms"], "plain_ms": pick(r, "plain"),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "share_of_bound": r["share_of_bound"],
            "composition_ms": composition_ms(r)}
            for (m, k, n), r in rows.items()},
        "ms_per_forward": forward_sum(lambda r: pick(r, "kernel")),
        "composition_ms_per_forward": forward_sum(composition_ms),
        "bound_ms_per_forward": forward_sum(lambda r: r["bound_ms"]),
    }


def fp8_entry(launches, errs, rows):
    per_step = {s: (4 if s[1] == s[2] else 1) * 12 for s in rows}
    row = rows[FP8_TRAIN_SHAPES[0]]

    def step_sum(name):
        vals = [pick(rows[s], name) if rows[s][name + "_call_ms"] is not None
                else None for s in rows]
        if None in vals:
            return None
        return sum(per_step[s] * v for s, v in zip(rows, vals))

    return {
        "name": "fp8_matmul",
        "route": "cuda",
        "source": SOURCE.format("fp8_matmul"),
        "replaces": TPU_QMM.format(146),
        "launches": launches,
        "launches_by_path": {"fp8_train": launches, "bert_int8_infer": 0},
        "launches_per_step": {"fp8_train": FP8_SITES_PER_STEP},
        "max_abs_err": errs["max_abs_err"],
        "max_err_share_of_sum_abs_products": errs["max_err_share"],
        "ms": pick(row, "kernel"),
        "plain_ms": pick(row, "plain"),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "composition_ms": (pick(row, "composition")
                           if row["composition_call_ms"] is not None
                           else None),
        "composition": "(x / xs).to(e4m3) -> torch._scaled_mm -> * (xs * ws)"
        ": no single PyTorch call computes this function",
        "shape": "M=8192 K=768 N=768 fp32 x, e4m3 w",
        "by_shape": {f"M={m} K={k} N={n}": {
            "ms": pick(r, "kernel"), "plain_ms": pick(r, "plain"),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "composition_ms": (pick(r, "composition")
                               if r["composition_call_ms"] is not None
                               else None),
            "prepare_ms": r["prepare_device_ms"], "tflops": r["tflops"],
            "share_of_bound": r["share_of_bound"]}
            for (m, k, n), r in rows.items()},
        "ms_per_step": step_sum("kernel"),
        "bound_ms_per_step": sum(per_step[s] * rows[s]["bound_ms"]
                                 for s in rows),
    }


def ln_entry(kind, launches, errs, rows):
    row = rows[(kind, torch.float32)]
    return {
        "name": f"ln_residual_{kind}",
        "route": "cuda",
        "source": SOURCE.format("ln_residual"),
        "replaces": TPU_LN.format(28 if kind == "fwd" else 46),
        "launches": launches,
        "launches_by_path": {"bert_train": launches, "bert_int8_infer": 0},
        "max_abs_err": errs[kind][torch.float32],
        "max_err_fp32": errs[kind][torch.float32],
        "max_err_bf16": errs[kind][torch.bfloat16],
        "max_err_fp16": errs[kind][torch.float16],
        "ms": pick(row, "kernel"),
        "plain_ms": pick(row, "plain"),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "kernel_alone_ms": row["kernel_alone_device_ms"],
        "device_kernels_per_call": row["device_kernels_per_call"],
        "bound_share": row["bound_share"],
        "composition_ms": pick(row, "composition"),
        "composition": "F.layer_norm(x + h*m*scale)" + (
            "" if kind == "fwd" else ", its autograd backward")
        + ": no single PyTorch call computes this function",
        "shape": f"n={LN_ROWS} D={LN_DIM} p={LN_P} fp32, float mask",
        "bf16_ms": pick(rows[(kind, torch.bfloat16)], "kernel"),
        "bf16_kernel_alone_ms":
            rows[(kind, torch.bfloat16)]["kernel_alone_device_ms"],
        "bf16_bound_ms": rows[(kind, torch.bfloat16)]["bound_ms"],
        "bf16_bound_share": rows[(kind, torch.bfloat16)]["bound_share"],
        "bf16_composition_ms": pick(rows[(kind, torch.bfloat16)],
                                    "composition"),
    }


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
        "bound_3xtf32_ms": row["bound_3xtf32_ms"],
        "bound_3xtf32_by": row["bound_3xtf32_by"],
        "bf16_ms": pick(rows[(kind, torch.bfloat16)], "kernel"),
        "bf16_bound_ms": rows[(kind, torch.bfloat16)]["bound_ms"],
        "bf16_library_ms": pick(rows[(kind, torch.bfloat16)], "library"),
    }
    if kind != "fwd":
        entry["plain_and_library_compute"] = "dq, dk and dv together"
    entry.update(extra or {})
    return entry


# -- phases 45-46: the operator tail and recurrent networks ------------------

#: the npx.rnn comparisons: cuDNN against the plain loop, max |diff| as a
#: share of max |plain| (outputs and states; gradients), fp32, TF32 off
RNN_TOL, RNN_GRAD_TOL = 1e-4, 5e-4
#: the attention entry against the plain composition at BERT-base width,
#: max |diff| as a share of max |plain| (fp32 3xTF32 kernels; bf16)
MHA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
MHA_SHAPE = (8, 512, 12, 64)   # batch, seq, heads, head dim
#: the LSTM language model: Zaremba, Sutskever & Vinyals 2014, "medium"
LM_VOCAB, LM_UNITS, LM_LAYERS = 10000, 650, 2
LM_BATCH, LM_BPTT, LM_LR, LM_CLIP = 20, 35, 1.0, 5.0
LM_STEPS = 6        # timed steps of each run
LM_LOSS_TOL = 1e-5  # first loss, cuDNN route against the plain loop
LM_ROUTE_TOL = 1e-4  # the first 3 losses, cuDNN against the plain loop


def share_err(got, want):
    """max |got - want| over max |want| (float64), 0 for an all-zero
    want."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale else err


def tail_cases(mx, rs):
    """(name, function of the npx module, host inputs) of the new ops at
    small shapes (the CPU parity tests' shapes); a case runs inside the
    context whose arrays it makes."""
    x = rs.randn(3, 4, 5).astype("float32")
    pos = (rs.rand(3, 4, 5) + 0.2).astype("float32")
    unit = (rs.rand(3, 4, 5) * 1.8 - 0.9).astype("float32")
    mask = rs.rand(3, 4, 5) > 0.3
    ties = onp.array([[1., 3., 3., 2., 3.], [0., 0., -1., 0., 2.]],
                     "float32")
    idx = onp.array([[0, 2, -1, 5], [1, 0, 3, -4]], "int32")
    img = rs.randn(2, 8, 4, 6).astype("float32")
    seq = rs.randn(5, 3, 2).astype("float32")
    ln = onp.array([5, 2, 3], "int32")
    qkv = rs.randn(6, 2, 24).astype("float32")
    boxes = rs.rand(2, 6, 4).astype("float32")
    boxes[..., 2:] += boxes[..., :2]
    nms = onp.concatenate([rs.randint(0, 2, (2, 6, 1)),
                           rs.rand(2, 6, 1).round(1), boxes], -1) \
        .astype("float32")
    label = onp.array([[[1, 0.1, 0.1, 0.4, 0.4], [0, 0.5, 0.5, 0.9, 0.8],
                        [-1, -1, -1, -1, -1]]] * 2, "float32")
    feat = onp.zeros((2, 3, 4, 4), "float32")
    cls = rs.randn(2, 3, 64).astype("float32")
    prob = rs.dirichlet(onp.ones(3), (2, 64)).transpose(0, 2, 1) \
        .astype("float32")
    loc = (rs.randn(2, 256) * 0.1).astype("float32")

    def anchors(n):
        return n.multibox_prior(mx.np.array(feat), sizes=(0.3, 0.5),
                                ratios=(1, 2, .5))
    return [
        ("relu", lambda n, a: n.relu(*a), [x]),
        ("sigmoid", lambda n, a: n.sigmoid(*a), [x]),
        ("rsqrt", lambda n, a: n.rsqrt(*a), [pos]),
        ("rcbrt", lambda n, a: n.rcbrt(*a), [x]),
        ("erf", lambda n, a: n.erf(*a), [x]),
        ("erfinv", lambda n, a: n.erfinv(*a), [unit]),
        ("gamma", lambda n, a: n.gamma(*a), [pos * 3]),
        ("gammaln", lambda n, a: n.gammaln(*a), [pos * 3]),
        ("digamma", lambda n, a: n.digamma(*a), [pos * 3]),
        ("softmin", lambda n, a: n.softmin(*a, axis=1), [x]),
        ("masked_softmax", lambda n, a: n.masked_softmax(*a), [x, mask]),
        ("masked_log_softmax", lambda n, a: n.masked_log_softmax(*a),
         [x, mask]),
        ("l2_normalization", lambda n, a: n.l2_normalization(
            *a, mode="channel"), [img]),
        ("one_hot", lambda n, a: n.one_hot(*a, 4), [idx]),
        ("topk", lambda n, a: n.topk(*a, k=3, ret_typ="both"), [ties]),
        ("gather_nd", lambda n, a: n.gather_nd(*a), [x, idx]),
        ("scatter_nd", lambda n, a: n.scatter_nd(*a, (3, 4, 5)),
         [x[0], idx]),
        ("index_update", lambda n, a: n.index_update(*a),
         [x, idx[:, :3], onp.ones(5, "float32")]),
        ("index_add", lambda n, a: n.index_add(*a),
         [x, idx, onp.full((4, 5), 2.0, "float32")]),
        ("sequence_mask", lambda n, a: n.sequence_mask(
            *a, use_sequence_length=True), [seq, ln]),
        ("sequence_last", lambda n, a: n.sequence_last(
            *a, use_sequence_length=True), [seq, ln]),
        ("sequence_reverse", lambda n, a: n.sequence_reverse(
            *a, use_sequence_length=True), [seq, ln]),
        ("reshape_like", lambda n, a: n.reshape_like(*a),
         [x, x.reshape(12, 5)]),
        ("arange_like", lambda n, a: n.arange_like(*a, step=0.1), [x]),
        ("broadcast_like", lambda n, a: n.broadcast_like(*a),
         [x[:, :1], x]),
        ("slice", lambda n, a: n.slice(*a, (0, 1), (2, None)), [x]),
        ("slice_like", lambda n, a: n.slice_like(*a), [x, x[:2, :3]]),
        ("where", lambda n, a: n.where(*a), [mask, x, pos]),
        ("batch_dot", lambda n, a: n.batch_dot(*a, transpose_b=True),
         [x, pos]),
        ("smooth_l1", lambda n, a: n.smooth_l1(*a), [x]),
        ("softmax_cross_entropy", lambda n, a: n.softmax_cross_entropy(*a),
         [x[0], onp.array([0, 4, 2, 1], "int32")]),
        ("reshape", lambda n, a: n.reshape(*a, (-4, 1, 3, -2)), [x]),
        ("split_v2", lambda n, a: n.split_v2(*a, 2, axis=1), [x]),
        ("space_to_depth", lambda n, a: n.space_to_depth(*a, 2), [img]),
        ("depth_to_space", lambda n, a: n.depth_to_space(*a, 2), [img]),
        ("shape_array", lambda n, a: n.shape_array(*a), [x]),
        ("size_array", lambda n, a: n.size_array(*a), [x]),
        ("nonzero", lambda n, a: n.nonzero(*a), [mask]),
        ("constraint_check", lambda n, a: n.constraint_check(*a), [pos > 0]),
        ("amp_cast", lambda n, a: n.amp_cast(*a, dtype="float16"), [x]),
        ("amp_multicast", lambda n, a: n.amp_multicast(*a),
         [x.astype("float16"), pos]),
        ("interleaved_matmul_selfatt_qk",
         lambda n, a: n.interleaved_matmul_selfatt_qk(*a, heads=2), [qkv]),
        ("interleaved_matmul_selfatt_valatt",
         lambda n, a: n.interleaved_matmul_selfatt_valatt(*a, heads=2),
         [qkv, rs.rand(4, 6, 6).astype("float32")]),
        ("interleaved_matmul_encdec_qk",
         lambda n, a: n.interleaved_matmul_encdec_qk(*a, heads=2),
         [qkv[:5, :, :8], qkv[:, :, :16]]),
        ("interleaved_matmul_encdec_valatt",
         lambda n, a: n.interleaved_matmul_encdec_valatt(*a, heads=2),
         [qkv[:, :, :16], rs.rand(4, 5, 6).astype("float32")]),
        ("box_iou", lambda n, a: n.box_iou(*a), [boxes, boxes]),
        ("box_nms", lambda n, a: n.box_nms(*a, overlap_thresh=0.3,
                                           id_index=0), [nms]),
        ("box_encode", lambda n, a: n.box_encode(*a),
         [onp.array([[1., -1., 0., 1., 1., 0.]] * 2, "float32"),
          onp.array([[0, 1, 0, 1, 2, 3]] * 2, "float32"), boxes, boxes[:, :4]]),
        ("box_decode", lambda n, a: n.box_decode(*a, clip=0.2),
         [x[:2, :, :4] * 0.3, boxes[:, :4]]),
        ("bipartite_matching", lambda n, a: n.bipartite_matching(
            *a, threshold=0.1), [pos[0]]),
        ("multibox_prior", lambda n, a: anchors(n), []),
        ("multibox_target", lambda n, a: n.multibox_target(
            anchors(n), *a, negative_mining_ratio=3.0), [label, cls]),
        ("multibox_detection", lambda n, a: n.multibox_detection(
            *a, anchors(n), threshold=0.2), [prob, loc]),
        ("foreach", lambda n, a: n.foreach(
            lambda xt, st: (xt * st[0] + st[1], [st[0] + xt, st[1] * 0.5]),
            a[0], [a[1], a[1] * 2]), [seq[:, 0], onp.ones(2, "float32")]),
        ("while_loop", lambda n, a: n.while_loop(
            lambda i, v: i < 4, lambda i, v: (v * i, (i + 1, v + 1)),
            (mx.np.array(0), a[0])), [x[0]]),
        ("cond", lambda n, a: n.cond(lambda v: v.sum() < 0,
                                     lambda v: v * 10, lambda v: v + 1, a),
         [x[0]]),
    ]


def tail_leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in tail_leaves(o)]
    return [out._data if hasattr(out, "_data") else out]


def tail_ops_vs_cpu(mx, dev):
    """Every new op on the card against its CPU result (values within
    rtol 1e-5 + atol 1e-5 of max|cpu|, index outputs equal)."""
    rs = onp.random.RandomState(45)
    worst = {}
    for name, fn, host in tail_cases(mx, rs):
        outs = []
        for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
            with ctx:
                res = fn(mx.npx, [mx.np.array(h) for h in host])
            outs.append([t.detach().cpu() for t in tail_leaves(res)])
        got, want = outs
        check(len(got) == len(want), f"npx.{name}: {len(got)} outputs on "
                                     f"the card, {len(want)} on the CPU")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"npx.{name}: card {g.shape} {g.dtype}, CPU {w.shape} "
                  f"{w.dtype}")
            if w.is_floating_point():
                e = share_err(g, w)
                check(torch.allclose(g.double(), w.double(), rtol=1e-5,
                                     atol=1e-5 * max(1.0, float(
                                         w.abs().max())), equal_nan=True),
                      f"npx.{name} on the card against the CPU: {e:.3g}")
                err = max(err, e if e == e else 0.0)
            else:
                check(torch.equal(g, w), f"npx.{name}: index outputs differ "
                                         "on the card")
        worst[name] = err
    return worst


def tail_samplers(mx, dev):
    """The extension samplers on the card: shape, dtype, device and the
    mean (and the normal's std) of 2^20 draws within 0.01 of the
    distribution's (4.8 standard errors at the widest)."""
    g = torch.Generator(device=dev).manual_seed(45)
    n = 1 << 20
    with mx.gpu(dev.index or 0):
        draws = {"bernoulli": (mx.npx.bernoulli(prob=0.3, size=(n,),
                                                generator=g), 0.3, None),
                 "uniform_n": (mx.npx.uniform_n(-1.0, 3.0, batch_shape=n,
                                                generator=g), 1.0, None),
                 "normal_n": (mx.npx.normal_n(0.5, 2.0, batch_shape=n,
                                              generator=g), 0.5, 2.0)}
    out = {}
    for name, (arr, mean, std) in draws.items():
        t = arr._data
        check(t.shape == (n,) and t.dtype == torch.float32
              and t.device == dev, f"npx.{name}: {t.shape} {t.dtype} "
                                   f"{t.device}")
        m = float(t.double().mean())
        sd = float(t.double().std()) if std else None
        check(abs(m - mean) < 0.01 * max(1.0, std or 1.0)
              and (std is None or abs(sd - std) < 0.01 * std),
              f"npx.{name}: mean {m}, std {sd}")
        out[name] = {"mean": m, "std": sd}
    return out


def rnn_routes_vs_plain(mx, dev):
    """npx.rnn's cuDNN route against its plain loop, every mode, 1-2
    layers, both directions, at the LM's shapes (35 x 20 x 650), forward
    and backward; the routes of bf16, fp16, the clip and a capture (the
    eager route)."""
    from mxnet_tpu_torch.ops import rnn as R
    g = torch.Generator(device="cpu").manual_seed(45)
    t, b, h = LM_BPTT, LM_BATCH, LM_UNITS
    rows = {}
    for mode in R.GATES:
        for layers in (1, 2):
            for bidir in (False, True):
                ndir = 2 if bidir else 1
                ng = R.GATES[mode]
                n = sum(ndir * ng * h * ((h if lyr == 0 else h * ndir) + h
                                         + 2) for lyr in range(layers))
                p = (torch.rand(n, generator=g) * 0.1 - 0.05).to(dev)
                x = torch.randn(t, b, h, generator=g).to(dev)
                h0 = torch.randn(layers * ndir, b, h, generator=g).to(dev)
                c0 = torch.randn_like(h0) if mode == "lstm" else None
                res = {}
                for route in ("cudnn", "plain"):
                    ps, xs = p.clone().requires_grad_(), \
                        x.clone().requires_grad_()
                    w = R.unpack(ps, mode, h, layers, bidir, h)
                    before = dict(R.route_calls)
                    with torch.backends.cudnn.flags(
                            enabled=route == "cudnn", allow_tf32=False):
                        out, hn, cn = R.rnn(xs, w, h0, c0, mode, layers,
                                            bidir)
                    check(R.route_calls[route] == before[route] + 1,
                          f"npx.rnn {mode}: the {route} route was not taken")
                    loss = out.square().sum() + hn.sum() \
                        + (cn.sum() if cn is not None else 0)
                    gp, gx = torch.autograd.grad(loss, [ps, xs])
                    res[route] = ([out, hn] + ([cn] if cn is not None
                                               else []), [gp, gx])
                vals = max(share_err(a, b) for a, b in
                           zip(res["cudnn"][0], res["plain"][0]))
                grads = max(share_err(a, b) for a, b in
                            zip(res["cudnn"][1], res["plain"][1]))
                key = f"{mode} L{layers}{' bi' if bidir else ''}"
                rows[key] = {"values": vals, "grads": grads}
                check(vals <= RNN_TOL and grads <= RNN_GRAD_TOL,
                      f"npx.rnn {key}: cuDNN against the plain loop "
                      f"{vals:.3g} / {grads:.3g} (limits {RNN_TOL} / "
                      f"{RNN_GRAD_TOL})")
    x = torch.zeros(2, 1, 4, device=dev)
    w = [tuple(torch.zeros(s, device=dev) for s in
               ((16, 4), (16, 4), (16,), (16,)))]
    routes = {"bf16": R.route(x.bfloat16(), [tuple(v.bfloat16() for v in
                                                    w[0])], "lstm", False),
              "fp16": R.route(x.half(), [tuple(v.half() for v in w[0])],
                              "lstm", False),
              "fp32": R.route(x, w, "lstm", False),
              "fp32 state clip": R.route(x, w, "lstm", True)}
    gph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gph):
        routes["fp32 capturing"] = R.route(x, w, "lstm", False)
    print(f"  npx.rnn routes: {routes}")
    check(routes == {"bf16": "plain", "fp16": "cudnn", "fp32": "cudnn",
                     "fp32 state clip": "plain", "fp32 capturing": "cudnn"},
          f"npx.rnn routes: {routes}")
    return rows, routes


def mha_vs_plain(mx, dev, fa):
    """npx.multi_head_attention at BERT-base width, causal and not, fp32
    and bf16, forward and backward, against the plain composition; the
    kernel 1-3 launches of those calls; ms of the call and of the plain
    composition's."""
    from mxnet_tpu_torch.ops.attention import _reference_attention
    b, s, heads, d = MHA_SHAPE
    g = torch.Generator(device="cpu").manual_seed(46)
    rows, launches = {}, [0, 0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            q, k, v = (torch.randn(b, s, heads * d, generator=g)
                       .to(dev, dtype) for _ in range(3))
            do = torch.randn(b, s, heads * d, generator=g).to(dev, dtype)

            def run(fn, q=q, k=k, v=v, do=do, causal=causal):
                qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
                with mx.autograd.record():
                    out = fn(qs, ks, vs, heads, causal=causal)
                return [out] + list(torch.autograd.grad(out, [qs, ks, vs],
                                                        do))
            zero_counters(fa)
            got = run(mx.npx.multi_head_attention)
            n = counters(fa)
            launches = [a + c for a, c in zip(launches, n)]
            check(n == [1, 1, 1], f"npx.multi_head_attention {dtype} causal="
                                  f"{causal}: kernel 1-3 launches {n}")
            want = run(lambda *a, causal: _reference_attention(
                *a, causal=causal))
            errs = [share_err(a, w) for a, w in zip(got, want)]
            key = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            check(max(errs) <= MHA_TOL[dtype],
                  f"npx.multi_head_attention {key}: {errs} against the "
                  f"plain composition (limit {MHA_TOL[dtype]})")
            rows[key] = {
                "max_share_err_out_dq_dk_dv": errs,
                "fwd_bwd_ms": cuda_ms(lambda: run(
                    mx.npx.multi_head_attention), 5, 1),
                "plain_fwd_bwd_ms": cuda_ms(lambda: run(
                    lambda *a, causal: _reference_attention(
                        *a, causal=causal)), 5, 1)}
    zero_counters(fa)
    return rows, launches


def phase_npx_tail(dev, card):
    """Phase 45: this slice's npx ops on the card against the CPU, npx.rnn's
    cuDNN route against its plain loop, and npx.multi_head_attention on
    kernels 1-3 at BERT-base width."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f"== phase 45: the npx operator tail on {card} (against the CPU, "
          "npx.rnn cuDNN against the plain loop, the attention entry on "
          "kernels 1-3)", flush=True)
    ops = tail_ops_vs_cpu(mx, dev)
    print(f"  {len(ops)} ops on the card against the CPU, worst share "
          f"{max(ops.values()):.3g} ({max(ops, key=ops.get)})")
    samplers = tail_samplers(mx, dev)
    print(f"  samplers on the card: {json.dumps(samplers)}")
    rnn_rows, routes = rnn_routes_vs_plain(mx, dev)
    for key, row in rnn_rows.items():
        print(f"  npx.rnn {key}: cuDNN vs plain values {row['values']:.3g}, "
              f"grads {row['grads']:.3g}")
    mha, launches = mha_vs_plain(mx, dev, fa)
    for key, row in mha.items():
        print(f"  npx.multi_head_attention {key} (8 x 512, 12 x 64): "
              f"{json.dumps(row)}")
    print(f"  kernel 1-3 launches under npx.multi_head_attention: "
          f"{launches}")
    return {"card": card, "ops_worst_share_err": ops, "samplers": samplers,
            "rnn": rnn_rows,
            "rnn_routes": routes, "multi_head_attention": mha,
            "launches": launches}


def lstm_lm(mx, dev, sparse_grad=False):
    """The "medium" LSTM LM of Zaremba et al. 2014 as a ``gluon.Block``:
    Embedding -> Dropout -> LSTM(650, 2) -> Dropout -> Dense(10000),
    untied, dropout 0 (the comparisons need the same draws);
    ``sparse_grad`` gives the embedding a row-sparse gradient."""
    class LSTMLM(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.embedding = mx.gluon.nn.Embedding(LM_VOCAB, LM_UNITS,
                                                   device=dev,
                                                   sparse_grad=sparse_grad)
            self.drop_in = mx.gluon.nn.Dropout(0.0)
            self.drop_out = mx.gluon.nn.Dropout(0.0)
            self.rnn = mx.gluon.rnn.LSTM(LM_UNITS, LM_LAYERS,
                                         input_size=LM_UNITS, dropout=0.0,
                                         device=dev)
            self.decoder = mx.gluon.nn.Dense(LM_VOCAB, flatten=False,
                                             in_units=LM_UNITS, device=dev)

        def forward(self, x, state):
            out, state = self.rnn(self.drop_in(self.embedding(x)), state)
            return self.decoder(self.drop_out(out)), state
    return LSTMLM()


def lm_run(mx, net, snap, data, hybrid, cudnn, steps, held=None):
    """Train ``steps`` windows from the weights ``snap``: the losses, the
    step function (for the timed and profiled windows) and the routes
    taken. ``held`` (a list) keeps the last step's output and loss with
    their graphs."""
    from mxnet_tpu_torch.ops import rnn as R
    params = net.collect_params()
    with torch.no_grad():
        for name, p in params.items():
            p.data().copy_(snap[name])
    net.hybridize(hybrid)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": LM_LR})
    state = [torch.zeros(LM_LAYERS, LM_BATCH, LM_UNITS, device=data.device)
             for _ in range(2)]
    pos = [0]

    def step():
        nonlocal state
        i = pos[0] % (data.shape[0] // LM_BPTT - 1)
        pos[0] += 1
        x = data[i * LM_BPTT:(i + 1) * LM_BPTT]
        y = data[i * LM_BPTT + 1:(i + 1) * LM_BPTT + 1]
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            with mx.autograd.record():
                out, state = net(x, state)
                loss = loss_fn(out.reshape(-1, LM_VOCAB), y.reshape(-1))
            mx.autograd.backward(loss)
        if held is not None:
            held[:] = [out, loss]    # this step's graph stays alive
        # truncated backpropagation: the state is carried detached
        state = [s.detach() for s in state]
        mx.gluon.utils.clip_global_norm(
            [p.grad() for p in params.values()],
            LM_CLIP * LM_BPTT * LM_BATCH)
        trainer.step(LM_BPTT * LM_BATCH)
        return loss.detach()
    before = dict(R.route_calls)
    losses = [float(step().detach().mean()) for _ in range(steps)]
    routes = {k: R.route_calls[k] - before[k] for k in before}
    return losses, step, routes


def phase_lstm_lm(dev, card):
    """Phase 46: the 2 x 650 LSTM LM trained eager (the cuDNN route, then
    the plain loop with cuDNN off) and hybridized (cuDNN inside the CUDA
    graphs) from the same weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as R
    print(f"== phase 46: LSTM LM 2 x {LM_UNITS}, vocab {LM_VOCAB}, batch "
          f"{LM_BATCH} x bptt {LM_BPTT}, SGD {LM_LR}, clip_global_norm "
          f"{LM_CLIP}, on {card}", flush=True)
    net = lstm_lm(mx, dev)
    net.initialize(mx.init.Uniform(0.05), seed=46)
    snap = {n: p.data().detach().clone()
            for n, p in net.collect_params().items()}
    n_params = sum(p.numel() for p in snap.values())
    gen = torch.Generator(device="cpu").manual_seed(46)
    data = torch.randint(0, LM_VOCAB, (8 * LM_BPTT + 1, LM_BATCH),
                         generator=gen).to(dev)
    flops = 6 * LM_BPTT * LM_BATCH * (
        LM_LAYERS * 4 * LM_UNITS * 2 * LM_UNITS + LM_UNITS * LM_VOCAB)
    out = {"card": card, "n_params": n_params,
           "model_flops_per_step": flops}
    runs = {"eager cudnn": (False, True), "eager plain": (False, False),
            "hybridized": (True, True)}
    first = {}
    # the eager runs' last outputs and losses, graphs and all, stay alive
    # while the block is hybridized and captures beside them
    held = {label: [] for label in runs}
    for label, (hybrid, cudnn) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step, routes = lm_run(mx, net, snap, data, hybrid, cudnn, 3,
                                      held[label])
        first[label] = losses
        check(all(math.isfinite(v) for v in losses),
              f"LSTM LM {label}: losses {losses}")
        walls = timed_runs(step, LM_STEPS)
        dev_ms = device_ms(step, 2, warmup=0)
        launches = host_launch_calls(step)
        wall = sorted(walls)[len(walls) // 2] * 1e3
        row = {"losses_first_3": losses, "routes_first_3_steps": routes,
               "step_ms_median": wall, "step_ms_all": [w * 1e3
                                                       for w in walls],
               "device_ms": dev_ms, "busy_share": busy_share(dev_ms, wall),
               "host_launch_calls_a_step": sum(launches.values()),
               "host_launch_calls": launches,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "tokens_per_s": LM_BPTT * LM_BATCH / wall * 1e3,
               "fp32_model_flop_share": flops / (wall * 1e-3)
               / PEAK_FLOPS[torch.float32]}
        out[label] = row
        print(f"  {label}: {json.dumps(row)}", flush=True)
        net.hybridize(False)
    check(abs(first["eager cudnn"][0] - math.log(LM_VOCAB)) < 0.05,
          f"LSTM LM first loss {first['eager cudnn'][0]}, expected about "
          f"ln {LM_VOCAB}")
    rel = abs(first["eager cudnn"][0] - first["eager plain"][0]) \
        / abs(first["eager plain"][0])
    check(rel <= LM_LOSS_TOL, f"LSTM LM first loss, cuDNN against the plain "
                              f"loop: {rel:.3g} relative")
    cudnn_vs_plain = max(abs(a - b) / abs(b) for a, b in
                         zip(first["eager cudnn"], first["eager plain"]))
    check(cudnn_vs_plain <= LM_ROUTE_TOL, f"LSTM LM cuDNN against the plain "
                                          f"loop: {cudnn_vs_plain:.3g}")
    # the same route eager and hybridized: bit for bit
    check(first["hybridized"] == first["eager cudnn"],
          f"LSTM LM hybridized {first['hybridized']} against eager "
          f"{first['eager cudnn']}")
    check(all(held[k] and held[k][1].grad_fn is not None
              for k in ("eager cudnn", "eager plain")),
          "LSTM LM: the eager runs' graphs were not kept alive")
    check(out["eager cudnn"]["routes_first_3_steps"]["plain"] == 0
          and out["hybridized"]["routes_first_3_steps"]["plain"] == 0
          and out["eager plain"]["routes_first_3_steps"]["cudnn"] == 0,
          f"LSTM LM routes: {[out[k]['routes_first_3_steps'] for k in runs]}")
    out.update(first_loss_cudnn_vs_plain_rel=rel,
               cudnn_vs_plain_max_rel=cudnn_vs_plain,
               hybridized_equals_eager_bit_for_bit=True,
               eager_graphs_alive_during_capture=True,
               route_eager="cudnn", route_hybridized="cudnn")
    print(f"  first loss cuDNN vs plain {rel:.3g} relative; hybridized bit "
          f"for bit with eager (cuDNN both); cuDNN vs plain over 3 steps "
          f"{cudnn_vs_plain:.3g}; parameters {n_params}")
    return out

# phase 47: sparse storage. The 1B-word vocabulary (Jozefowicz et al.
# 2016; MXNet's large_word_lm example trains it with a row-sparse
# embedding) at 512 units; Criteo's LibSVM width and field count.
SP_VOCAB, SP_DIM, SP_STEPS = 793471, 512, 10
SP_LR = 1e-3
CRITEO_ROWS, CRITEO_COLS, CRITEO_NNZ = 8192, 1_000_000, 39
SP_LOSS_TOL = 1e-6   # the sparse LM's losses against the dense control
SP_ROW_TOL = 1e-6    # touched rows: relative to the rows' largest value
SP_ADAM_TOL = 1e-6   # the lazy Adam rows against float64 (absolute)
SP_DOT_TOL = 1e-5    # CSR dot against the dense product, relative


def sync_debug_error(fn):
    """``fn()`` with any host synchronization raising
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def event_ms(fn, iters):
    """Medians of ``iters`` calls of ``fn(mark)`` by CUDA events (host
    included): the whole call's ms and the ms after ``fn`` calls
    ``mark()``, and every call's readings of both."""
    walls, tails = [], []
    for _ in range(iters):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        marked = []
        e0.record()
        fn(lambda: marked.append(e1.record()))
        e2.record()
        e2.synchronize()
        walls.append(e0.elapsed_time(e2))
        tails.append(e1.elapsed_time(e2) if marked else walls[-1])
    med = sorted(walls)[len(walls) // 2]
    return med, sorted(tails)[len(tails) // 2], walls, tails


def sparse_lm(mx, dev):
    """(a) The 2 x 650 LSTM LM with Embedding(sparse_grad=True) under lazy
    SGD through the default store, against the same run with a dense
    embedding gradient (the control); clip_global_norm on the dense
    parameters only in both."""
    nets, snap = {}, None
    for label in ("dense", "sparse"):
        net = lstm_lm(mx, dev, sparse_grad=label == "sparse")
        net.initialize(mx.init.Uniform(0.05), seed=46)
        nets[label] = net
        if snap is None:
            snap = {n: p.data().detach().clone()
                    for n, p in net.collect_params().items()}
    gen = torch.Generator(device="cpu").manual_seed(47)
    data = torch.randint(0, LM_VOCAB, (8 * LM_BPTT + 1, LM_BATCH),
                         generator=gen).to(dev)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out, losses, emb = {}, {}, {}
    for label, net in nets.items():
        params = net.collect_params()
        with torch.no_grad():
            for name, p in params.items():
                p.data().copy_(snap[name])
        opt = {"learning_rate": LM_LR, "momentum": 0.0, "wd": 0.0}
        if label == "sparse":
            opt["lazy_update"] = True
        trainer = mx.gluon.Trainer(params, "sgd", opt)
        dense = [p for n, p in params.items() if n != "embedding.weight"]
        state = [torch.zeros(LM_LAYERS, LM_BATCH, LM_UNITS, device=dev)
                 for _ in range(2)]
        pos, seen = [0], {}

        def step(mark=None, guard=False, net=net, trainer=trainer,
                 dense=dense, pos=pos, seen=seen, params=params):
            nonlocal state
            i = pos[0] % (data.shape[0] // LM_BPTT - 1)
            pos[0] += 1
            x = data[i * LM_BPTT:(i + 1) * LM_BPTT]
            y = data[i * LM_BPTT + 1:(i + 1) * LM_BPTT + 1]
            with mx.autograd.record():
                o, state = net(x, state)
                loss = loss_fn(o.reshape(-1, LM_VOCAB), y.reshape(-1))
            # no host sync from the backward to the store's update
            run = sync_debug_error if guard else (lambda f: f())
            run(lambda: mx.autograd.backward(loss))
            state = [s.detach() for s in state]
            seen["grad"] = params["embedding.weight"].grad()
            mx.gluon.utils.clip_global_norm([p.grad() for p in dense],
                                            LM_CLIP * LM_BPTT * LM_BATCH)
            if mark is not None:
                mark()
            run(lambda: trainer.step(LM_BPTT * LM_BATCH))
            return loss.detach()
        ls = [float(step(guard=True).mean()) for _ in range(3)]
        losses[label] = ls
        emb[label] = params["embedding.weight"].data().detach().clone()
        grad = seen["grad"]
        if label == "sparse":
            check(type(grad).__name__ == "RowSparseNDArray"
                  and grad.data.shape[0] == LM_BPTT * LM_BATCH,
                  f"sparse LM: the embedding's gradient is "
                  f"{type(grad).__name__} of "
                  f"{getattr(grad, 'data', grad).shape} slots, expected a "
                  f"RowSparseNDArray of {LM_BPTT * LM_BATCH}")
            check(trainer._update_on_kvstore is True,
                  "sparse LM: the Trainer did not update on the store")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gcs = [g["collections"] for g in gc.get_stats()]
        wall, update, walls, _ = event_ms(step, LM_STEPS)
        gcs = [g["collections"] - n for g, n in zip(gc.get_stats(), gcs)]
        dev_ms = device_ms(step, 2, warmup=0)
        launches = host_launch_calls(step)
        out[label] = {
            "losses_first_3": ls, "step_ms_median": wall, "step_ms_all":
            walls, "update_ms_median": update,
            "gc_collections_in_timed_steps": gcs,
            "device_ms": dev_ms, "busy_share": busy_share(dev_ms, wall),
            "host_launch_calls_a_step": sum(launches.values()),
            "host_launch_calls": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens_per_s": LM_BPTT * LM_BATCH / wall * 1e3}
        print(f"  (a) LSTM LM, {label} embedding gradient: "
              f"{json.dumps(out[label])}", flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sparse"],
                                                  losses["dense"]))
    check(rel <= SP_LOSS_TOL, f"sparse LM losses {losses['sparse']} against "
                              f"the dense control {losses['dense']}: "
                              f"{rel:.3g} relative")
    # every row the three windows touched, and the rest
    touched = torch.zeros(LM_VOCAB, dtype=torch.bool, device=dev)
    touched[data[:3 * LM_BPTT].reshape(-1)] = True
    w0 = snap["embedding.weight"]
    untouched_equal = torch.equal(emb["sparse"][~touched], w0[~touched])
    check(untouched_equal, "sparse LM: an untouched embedding row moved")
    diff = float((emb["sparse"][touched] - emb["dense"][touched]).abs().max())
    scale = float(emb["dense"][touched].abs().max())
    check(diff <= SP_ROW_TOL * scale,
          f"sparse LM: touched rows {diff:.3g} from the control (scale "
          f"{scale:.3g})")
    out.update(losses_max_rel=rel, touched_rows=int(touched.sum()),
               touched_rows_max_abs_diff=diff, touched_rows_scale=scale,
               untouched_rows_bit_for_bit=untouched_equal,
               grad_slots=LM_BPTT * LM_BATCH, host_syncs_backward_to_update=0)
    print(f"  (a) losses within {rel:.3g} relative of the control; "
          f"{int(touched.sum())} touched rows within {diff:.3g} (scale "
          f"{scale:.3g}); untouched rows bit for bit; no host sync from the "
          f"backward to the store's update", flush=True)
    del nets
    return out


def zipf_ids(rng, n, size, a=1.0):
    """``size`` ids in [0, n) drawn from a Zipf law of exponent ``a`` over
    the ranks (id = rank - 1)."""
    p = 1.0 / onp.arange(1, n + 1) ** a
    return rng.choice(n, size=size, p=p / p.sum())


def sparse_table(mx, dev):
    """(b) Lazy Adam through the store on a 793,471 x 512 row-sparse
    embedding against dense Adam on a dense gradient: the rows against a
    float64 Adam rule, the untouched rows and their state bit for bit,
    row_sparse_pull, and the step and update times beside their
    bounds."""
    rng = onp.random.RandomState(47)
    batches = [torch.from_numpy(zipf_ids(rng, SP_VOCAB, LM_BATCH * LM_BPTT)
                                .reshape(LM_BPTT, LM_BATCH)).to(dev)
               for _ in range(SP_STEPS + 2)]
    c = torch.randn(LM_BPTT, LM_BATCH, SP_DIM,
                    generator=torch.Generator(device="cpu").manual_seed(47)
                    ).to(dev)
    out = {}
    w0 = None
    for label in ("lazy", "dense"):
        net = mx.gluon.nn.Embedding(SP_VOCAB, SP_DIM, device=dev,
                                    sparse_grad=label == "lazy")
        net.initialize(mx.init.Uniform(0.07), seed=47)
        param = net.collect_params()["weight"]
        if w0 is None:
            w0 = param.data().detach().clone()
        opt = {"learning_rate": SP_LR}
        if label == "lazy":
            opt["lazy_update"] = True
        trainer = mx.gluon.Trainer(net.collect_params(), "adam", opt)
        pos = [0]

        def step(mark=None, net=net, trainer=trainer, pos=pos):
            ids = batches[pos[0] % len(batches)]
            pos[0] += 1
            with mx.autograd.record():
                loss = (net(ids) * c).sum()
            mx.autograd.backward(loss)
            if mark is not None:
                mark()
            trainer.step(1)
        step()
        torch.cuda.synchronize()
        w = param.data().detach()
        if label == "lazy":
            m, v = trainer._updater.states[0]
            ids = batches[0].reshape(-1)
            uniq = torch.unique(ids)
            g = torch.zeros(len(uniq), SP_DIM, dtype=torch.float64,
                            device=dev)
            g.index_add_(0, torch.searchsorted(uniq, ids),
                         c.reshape(-1, SP_DIM).double())
            b1, b2, eps = 0.9, 0.999, 1e-8
            m64, v64 = (1 - b1) * g, (1 - b2) * g * g
            lr_t = SP_LR * math.sqrt(1 - b2) / (1 - b1)
            want = w0[uniq].double() - lr_t * m64 / (v64.sqrt() + eps)
            adam_err = float((w[uniq].double() - want).abs().max())
            check(adam_err <= SP_ADAM_TOL, f"lazy Adam rows {adam_err:.3g} "
                                           "from the float64 rule")
            mask = torch.ones(SP_VOCAB, dtype=torch.bool, device=dev)
            mask[uniq] = False
            same = (torch.equal(w[mask], w0[mask])
                    and not bool(m[mask].any()) and not bool(v[mask].any()))
            check(same, "lazy Adam: an untouched row, or its m / v, moved")
            pull_ids = uniq[torch.randperm(len(uniq), generator=torch.
                                           Generator().manual_seed(47)
                                           )[:64].to(dev)]
            pulled = trainer._kvstore.row_sparse_pull(0, row_ids=pull_ids)
            pull_equal = torch.equal(pulled.data._data,
                                     w[torch.sort(pull_ids).values])
            check(pull_equal, "row_sparse_pull of 64 touched ids differs "
                              "from those rows of the weight")
            out.update(unique_rows_step1=len(uniq), adam_f64_max_abs=adam_err,
                       untouched_rows_and_state_bit_for_bit=same,
                       row_sparse_pull_64_bit_for_bit=pull_equal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, update_ms, walls, tails = event_ms(step, SP_STEPS)
        upd_dev = device_ms(lambda: trainer.step(1), 3, warmup=0)
        upd_launches = host_launch_calls(lambda: trainer.step(1))
        uniq_n = [len(torch.unique(b)) for b in batches]
        table_bytes = SP_VOCAB * SP_DIM * 4
        if label == "lazy":
            # read w, m, v and the gradient's rows, write w, m, v: the
            # unique rows of a step's ids (read on the host, outside)
            rows = sorted(uniq_n)[len(uniq_n) // 2]
            nbytes = 7 * rows * SP_DIM * 4
        else:
            nbytes = 7 * table_bytes
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out[label] = {"step_ms_median": step_ms, "update_ms_median":
                      update_ms, "step_ms_all": walls,
                      "update_ms_all": tails, "update_device_ms": upd_dev,
                      "update_host_launch_calls": sum(upd_launches.values()),
                      "update_bytes_bound_ms": bound_ms,
                      "update_bytes": nbytes,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"  (b) {SP_VOCAB} x {SP_DIM} table, {label} Adam: "
              f"{json.dumps(out[label])}", flush=True)
        del net, trainer, param, w, step
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  (b) lazy rows within {out['adam_f64_max_abs']:.3g} of float64 "
          f"Adam over {out['unique_rows_step1']} unique rows; untouched rows "
          f"and m / v bit for bit; row_sparse_pull bit for bit", flush=True)
    return out


def nd_cases(mx, rs):
    """(name, function of the nd module) of the legacy names that
    tests/test_legacy_ops.py exercises, at its shapes."""
    def a(*shape):
        return rs.randn(*shape).astype("float32")
    x4, w3, b3 = a(4, 10), a(3, 10), a(3)
    img, cw = a(2, 3, 8, 8), a(4, 3, 3, 3) * 0.1
    bn = a(2, 4, 8, 8)
    seq = a(2, 6, 4)
    up = a(1, 2, 3, 3)
    lrn = a(2, 8, 4, 4)
    bb, cc = a(2, 1, 4), a(1, 3, 4)
    sm, lab = a(4, 3), onp.array([0, 1, 2, 1], "float32")
    A = a(3, 3)
    spd = (A @ A.T + 3 * onp.eye(3)).astype("float32")
    B, Br = a(3, 2), a(2, 3)
    grid_x = a(1, 2, 5, 5)
    theta = onp.array([[0.9, 0.1, 0.2, -0.1, 1.1, 0.3]], "float32")
    rois = onp.array([[0, 0, 0, 5, 5], [1, 2, 1, 7, 6]], "float32")
    return [
        ("FullyConnected", lambda nd: nd.FullyConnected(
            nd.array(x4), nd.array(w3), nd.array(b3), num_hidden=3)),
        ("Convolution", lambda nd: nd.Convolution(
            nd.array(img), nd.array(cw), nd.zeros(4), kernel="(3, 3)",
            num_filter="4", stride="(1, 1)", pad="(1, 1)")),
        ("BatchNorm_Activation_Pooling", lambda nd: nd.Pooling(
            nd.Activation(nd.BatchNorm(nd.array(bn), nd.ones(4), nd.zeros(4),
                                       nd.zeros(4), nd.ones(4)),
                          act_type="relu"), kernel=(2, 2), stride=(2, 2),
            pool_type="max")),
        ("SliceChannel_Concat", lambda nd: nd.Concat(
            *nd.SliceChannel(nd.array(seq), num_outputs=3, axis=1), dim=1)),
        ("Reshape", lambda nd: [nd.Reshape(nd.array(seq), shape=s)
                                for s in ((-1,), (0, -1), (-3, 0))]),
        ("SoftmaxOutput", lambda nd: nd.SoftmaxOutput(nd.array(sm),
                                                      nd.array(lab))),
        ("UpSampling_Pad", lambda nd: [
            nd.UpSampling(nd.array(up), scale=2, sample_type="nearest"),
            nd.Pad(nd.array(up), mode="constant",
                   pad_width=(0, 0, 0, 0, 1, 1, 2, 2), constant_value=5)]),
        ("LRN", lambda nd: nd.LRN(nd.array(lrn), alpha=1e-3, beta=0.75,
                                  knorm=2, nsize=3)),
        ("broadcast", lambda nd: [
            nd.broadcast_add(nd.array(bb), nd.array(cc)),
            nd.broadcast_to(nd.array(bb), shape=(2, 3, 0)),
            nd.broadcast_axis(nd.array(bb), axis=1, size=3)]),
        ("npx_fallback", lambda nd: [
            nd.slice_axis(nd.array(x4), axis=1, begin=1, end=3),
            nd.topk(nd.array(x4), k=2)]),
        ("linalg", lambda nd: [
            nd.linalg_potrf(nd.array(spd)),
            nd.linalg_gemm2(nd.array(A), nd.array(B), alpha=2.0),
            nd.linalg_trsm(nd.linalg_potrf(nd.array(spd)), nd.array(B)),
            nd.linalg_trsm(nd.linalg_potrf(nd.array(spd)), nd.array(Br),
                           rightside=True, transpose=True),
            nd.linalg_trmm(nd.array(A), nd.array(B), lower=False),
            nd.linalg_sumlogdiag(nd.array(spd)),
            nd.linalg_maketrian(nd.linalg_extracttrian(
                nd.array(A), offset=1), offset=1),
            nd.linalg_syrk(nd.array(B)), nd.linalg_inverse(nd.array(spd))]),
        ("spatial", lambda nd: [
            nd.GridGenerator(nd.array(theta), transform_type="affine",
                             target_shape=(4, 6)),
            nd.SpatialTransformer(nd.array(grid_x), nd.array(theta),
                                  target_shape=(5, 5))]),
        ("ROIPooling", lambda nd: nd.ROIPooling(
            nd.array(img), nd.array(rois), pooled_size=(2, 3))),
    ]


def nd_legacy_vs_cpu(mx, dev):
    """(c) The legacy names on the card against the port's CPU (phase
    45's tolerance: rtol 1e-5 + atol 1e-5 of max|cpu|)."""
    worst = {}
    for name, fn in nd_cases(mx, onp.random.RandomState(47)):
        outs = []
        for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
            with ctx:
                outs.append([t.detach().cpu() for t in tail_leaves(
                    fn(mx.nd))])
        got, want = outs
        check(len(got) == len(want), f"nd.{name}: output counts differ")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"nd.{name}: card {g.shape} {g.dtype}, CPU {w.shape} "
                  f"{w.dtype}")
            if w.is_floating_point():
                check(torch.allclose(g.double(), w.double(), rtol=1e-5,
                                     atol=1e-5 * max(1.0, float(
                                         w.abs().max()))),
                      f"nd.{name} on the card against the CPU: "
                      f"{share_err(g, w):.3g}")
                err = max(err, share_err(g, w))
            else:
                check(torch.equal(g, w), f"nd.{name}: index outputs differ")
        worst[name] = err
    return worst


def criteo_dot(mx, dev):
    """(c) sparse.dot of a CSR batch at Criteo's LibSVM width (8192 rows x
    1,000,000 columns, 39 values a row) by a (1,000,000, 1) weight on the
    card, against the dense product of the same rows (built 512 rows at a
    time)."""
    from mxnet_tpu_torch.ndarray import sparse
    g = torch.Generator(device="cpu").manual_seed(47)
    cols = torch.stack([torch.randperm(CRITEO_COLS, generator=g)[
        :CRITEO_NNZ].sort().values for _ in range(64)])
    cols = cols.repeat(CRITEO_ROWS // 64, 1)
    cols = (cols + torch.randint(0, CRITEO_COLS, (CRITEO_ROWS, 1),
                                 generator=g)) % CRITEO_COLS
    cols = cols.sort(dim=1).values.to(dev)
    vals = torch.rand(CRITEO_ROWS, CRITEO_NNZ, generator=g).to(dev)
    indptr = torch.arange(0, CRITEO_ROWS + 1, device=dev) * CRITEO_NNZ
    csr = sparse.CSRNDArray(vals.reshape(-1), cols.reshape(-1), indptr,
                            (CRITEO_ROWS, CRITEO_COLS))
    w = torch.randn(CRITEO_COLS, 1, generator=g).to(dev)
    got = sparse.dot(csr, w)._data
    want = torch.empty_like(got)
    chunk = 512
    for r in range(0, CRITEO_ROWS, chunk):
        dense = torch.zeros(chunk, CRITEO_COLS, device=dev)
        dense.scatter_(1, cols[r:r + chunk], vals[r:r + chunk])
        want[r:r + chunk] = dense @ w
        del dense
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= SP_DOT_TOL, f"CSR dot against the dense product: {rel:.3g}")
    ms, _, walls, _ = event_ms(lambda mark: sparse.dot(csr, w), 10)
    nnz = CRITEO_ROWS * CRITEO_NNZ
    nbytes = nnz * (4 + 4 + 4) + (CRITEO_ROWS + 1) * 4 + CRITEO_ROWS * 4
    return {"rows": CRITEO_ROWS, "cols": CRITEO_COLS, "nnz": nnz,
            "max_rel_err": rel, "dot_ms_median": ms, "dot_ms_all": walls,
            "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}


def phase_sparse(dev, card):
    """Phase 47: sparse storage on the card: (a) the LSTM LM with a
    row-sparse embedding against its dense control, (b) lazy against
    dense Adam on a 793,471 x 512 table, (c) mx.nd's legacy names against
    the CPU and a CSR dot at Criteo's width."""
    import mxnet_tpu_torch as mx
    print(f"== phase 47: sparse storage and mx.nd on {card} (torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    before = all_launches()
    lm = sparse_lm(mx, dev)
    gc.collect()
    torch.cuda.empty_cache()
    table = sparse_table(mx, dev)
    gc.collect()
    torch.cuda.empty_cache()
    nd = nd_legacy_vs_cpu(mx, dev)
    print(f"  (c) {len(nd)} legacy cases on the card against the CPU, worst "
          f"share {max(nd.values()):.3g} ({max(nd, key=nd.get)})")
    dot = criteo_dot(mx, dev)
    print(f"  (c) CSR dot {CRITEO_ROWS} x {CRITEO_COLS}, {CRITEO_NNZ} a row: "
          f"{json.dumps(dot)}", flush=True)
    launches = [a - b for a, b in zip(all_launches(), before)]
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "lstm_lm": lm, "table": table,
            "nd_worst_share_err": nd, "criteo_dot": dot,
            "launches": launches}


def timed(name, phase, *args):
    """Run a phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {name} seconds: {time.perf_counter() - t0:.1f}",
          flush=True)
    return out


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
    card = timed("1", phase_build)
    errs = timed("2", phase_kernel_vs_plain, dev)
    bwd_errs = timed("2b", phase_bwd_vs_plain, dev)
    ln_errs = timed("2c", phase_ln_vs_plain, dev)
    fp8_errs = timed("2d", phase_fp8_vs_plain, dev)
    int8_errs = timed("2e", phase_int8_vs_plain, dev)
    conv_errs = timed("2f", phase_conv_vs_plain, dev)
    net, eng, serve_e2e_row, base_reqs, prompts, serve_launches = timed(
        "3", phase_main_path, dev)
    serve_shape = timed("4", phase_times, dev, net, eng, serve_e2e_row, card)
    del net, eng
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_e2e = timed("5", phase_train, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    rows = timed("6", phase_kernel_times, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches, bert_e2e = timed("7", phase_bert, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    ln_rows = timed("8", phase_ln_times, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    fp8_launches, fp8_e2e = timed("9", phase_fp8_train, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    fp8_rows = timed("10", phase_fp8_times, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    int8_launches, int8_e2e = timed("11", phase_bert_int8, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    int8_rows = timed("12", phase_int8_times, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_e2e, resnet_shapes = timed("13", phase_resnet_train, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    conv_rows = timed("14", phase_conv_times, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_int8_e2e = timed("15", phase_resnet_int8, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    gpt16_launches, gpt16_e2e = timed("16", phase_gpt_bf16, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert16_launches, bert16_e2e = timed("17", phase_bert_bf16, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet16_e2e, resnet16_shapes = timed("18", phase_resnet_bf16, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    gpt_hybrid = timed("19", phase_gpt_hybrid, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_hybrid = timed("20", phase_bert_hybrid, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_hybrid = timed("21", phase_resnet_hybrid, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    fused_update = timed("22", phase_fused_update, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 23-25 serve phase 3's model again (the same seed, so the same
    # weights) and compare with phase 3's tokens; phase 44 too
    base_tokens = [r.generated for r in base_reqs]
    net = serve_net(dev)
    serve_quant = timed("23", phase_serve_quantized, dev, card, net, prompts,
                        serve_e2e_row)
    pprompts, serve_prefix = timed("24", phase_serve_prefix, dev, card, net)
    serve_spec = timed("25", phase_serve_spec, dev, card, net, prompts,
                       base_reqs, pprompts, serve_prefix)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    np_surface = timed("26", phase_np_surface, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    gpt_np = timed("27", phase_gpt_np, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    net = serve_net(dev)
    serve_planes = timed("28", phase_serve_planes, dev, card, net, prompts,
                         base_reqs)
    del net, base_reqs
    gc.collect()
    torch.cuda.empty_cache()
    train_planes = timed("29", phase_train_planes, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    planes_cost = timed("30", phase_disabled_cost, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_lamb = timed("31", phase_bert_lamb, dev, card, bert_hybrid)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_nag = timed("32", phase_resnet_nag, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    surface = timed("33", phase_surface, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_pipe = timed("34", phase_resnet_pipeline, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    gpt_stream = timed("35", phase_gpt_stream, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        cfg = mesh_config(dp_config())
        with open(os.path.join(root, "dp_config.json"), "w") as f:
            json.dump(cfg, f)
        gpt_sharded = timed("36", phase_gpt_sharded, dev, card, root, cfg)
        gpt_dp = timed("37", phase_gpt_dp, dev, card, root, cfg)
        resnet_dp = timed("38", phase_resnet_dp, dev, card, root, cfg)
        ring = timed("39", phase_ring, dev, card, root, cfg)
        gpt_mesh = timed("40", phase_gpt_mesh, dev, card, root, cfg)
        gpt_pp = timed("41", phase_gpt_pp, dev, card, root, cfg)
        mesh4 = timed("42", phase_mesh4, dev, card, root, cfg)
        gpt_fleet = timed("43", phase_gpt_fleet, dev, card, root, cfg)
        serve_fleet = timed("44", phase_serve_fleet, dev, card, root,
                            prompts, base_tokens, serve_e2e_row)
    gc.collect()
    torch.cuda.empty_cache()
    npx_tail = timed("45", phase_npx_tail, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    lstm_lm_train = timed("46", phase_lstm_lm, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    sparse_train = timed("47", phase_sparse, dev, card)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(card)
    fa8 = fp8_launches[1:]
    resnet_paths = {"resnet_train": 0, "resnet_int8_infer": 0}
    entries = [
        kernel_entry("fwd", serve_launches + train_launches[0] + fa8[0],
                     errs, rows,
                     {"launches_by_path": {"serve": serve_launches,
                                           "train": train_launches[0],
                                           "bert_train": 0,
                                           "fp8_train": fa8[0],
                                           "bert_int8_infer": 0},
                      "serve_shape": serve_shape}),
        kernel_entry("dkv", train_launches[1] + fa8[1], bwd_errs["dkv"], rows,
                     {"launches_by_path": {"train": train_launches[1],
                                           "bert_train": 0,
                                           "fp8_train": fa8[1],
                                           "bert_int8_infer": 0}}),
        kernel_entry("dq", train_launches[2] + fa8[2], bwd_errs["dq"], rows,
                     {"launches_by_path": {"train": train_launches[2],
                                           "bert_train": 0,
                                           "fp8_train": fa8[2],
                                           "bert_int8_infer": 0}}),
        ln_entry("fwd", bert_launches[0], ln_errs, ln_rows),
        ln_entry("bwd", bert_launches[1], ln_errs, ln_rows),
        fp8_entry(fp8_launches[0], fp8_errs, fp8_rows),
        int8_entry(int8_launches, int8_errs, int8_rows),
    ]
    for entry in entries:
        entry["launches_by_path"].update(resnet_paths)
    # the bf16 paths: flash (rows 1-3) on GPT, ln_residual (rows 4-5) on
    # BERT; all_launches() lists flash fwd/dkv/dq, ln fwd/bwd first
    for i, entry in enumerate(entries):
        by_path = {"gpt_bf16_train": gpt16_launches[i] if i < 5 else 0,
                   "bert_bf16_train": bert16_launches[i] if i < 5 else 0,
                   "resnet_bf16_train": 0}
        entry["launches"] += sum(by_path.values())
        entry["launches_by_path"].update(by_path)
    int8 = entries[-1]
    int8["launches"] += resnet_int8_e2e["launches"]
    int8["launches_by_path"]["resnet_int8_infer"] = \
        resnet_int8_e2e["launches"]
    conv = conv_entry(conv_errs, conv_rows, resnet_e2e["launches"],
                      resnet_shapes, resnet16_e2e["launches"],
                      resnet16_shapes)
    conv["launches_by_path"].update(gpt_bf16_train=0, bert_bf16_train=0)
    entries.append(conv)
    # the hybridized paths (phases 19-21): replays leave the wrappers'
    # counts alone, so a kernel's launches there are its profiler events
    # in the path's launch window of HYBRID_STEPS hybridized steps
    hybrid = {"gpt_bf16_hybrid_train": (gpt_hybrid, ["flash_fwd",
                                                     "flash_bwd_dkv",
                                                     "flash_bwd_dq"]),
              "bert_bf16_hybrid_train": (bert_hybrid, [None] * 3 + [
                  "ln_residual_fwd", "ln_residual_bwd"]),
              "resnet_hybrid_train": (resnet_hybrid, [None] * 7 + [
                  "conv_bwd_dgrad_kernel"]),
              "bert_bf16_lamb_hybrid_train": (bert_lamb, [None] * 3 + [
                  "ln_residual_fwd", "ln_residual_bwd"]),
              "resnet_nag_hybrid_train": (resnet_nag, [None] * 7 + [
                  "conv_bwd_dgrad_kernel"])}
    for path, (e2e, names) in hybrid.items():
        window = e2e["launch_window_kernel_events"]
        for i, entry in enumerate(entries):
            name = names[i] if i < len(names) else None
            n = window[name] if name else 0
            entry["launches_by_path"][path] = n
            entry["launches"] += n
    # the serving phases 23-25: flash forward kernel events of each
    # engine's profiled run (graph replays; no other kernel of the table)
    serving = {f"serve_{mode}": row["flash_fwd_events"]
               for mode, row in serve_quant.items() if mode != "fp32"}
    serving.update({"serve_prefix_cache_off":
                    serve_prefix["cache off"]["flash_fwd_events"],
                    "serve_prefix_cache":
                    serve_prefix["prefix cache"]["flash_fwd_events"],
                    "serve_self_draft":
                    serve_spec["self draft"]["flash_fwd_events"],
                    "serve_foreign_draft":
                    serve_spec["foreign draft"]["flash_fwd_events"]})
    for i, entry in enumerate(entries):
        for path, n in serving.items():
            entry["launches_by_path"][path] = n if i == 0 else 0
            entry["launches"] += n if i == 0 else 0
    # phase 27, GPT-2 bf16 from mx.np arrays: the eager steps by the
    # wrappers' counts, the hybridized run by profiler events
    np_window = gpt_np["launches"]["hybridized_window"]
    for i, entry in enumerate(entries):
        eager = gpt_np["launches"]["eager"][i] if i < 3 else 0
        hybrid = np_window[("flash_fwd", "flash_bwd_dkv",
                            "flash_bwd_dq")[i]] if i < 3 else 0
        entry["launches_by_path"].update(gpt_bf16_np_train=eager,
                                         gpt_bf16_np_hybrid_train=hybrid)
        entry["launches"] += eager + hybrid
    # phases 28-29, the host planes: the serving run's flash forward
    # events, and the eager profiled steps' wrapper counts
    for i, entry in enumerate(entries):
        serve = serve_planes["flash_fwd_events"] if i == 0 else 0
        train = train_planes["wrapper_launches_2_steps"][i] if i < 3 else 0
        entry["launches_by_path"].update(serve_planes=serve,
                                         gpt_bf16_planes_train=train)
        entry["launches"] += serve + train
    # phases 31-32, the LAMB and NAG training paths: one eager step by the
    # wrappers' counts (their hybridized windows are above)
    for i, entry in enumerate(entries):
        lamb = bert_lamb["eager_step_ln_launches"][i - 3] if i in (3, 4) \
            else 0
        nag = resnet_nag["eager_step_kernel8_launches"] if i == 7 else 0
        entry["launches_by_path"].update(bert_bf16_lamb_train=lamb,
                                         resnet_nag_train=nag)
        entry["launches"] += lamb + nag
    # phases 34-35, fed from disk: the profiler events of a window of
    # loader-fed (stream-fed) steps
    for i, entry in enumerate(entries):
        pipe = resnet_pipe["launch_window_kernel_events"][
            "conv_bwd_dgrad_kernel"] if i == 7 else 0
        strm = gpt_stream["launch_window_kernel_events"][
            ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")[i]] if i < 3 \
            else 0
        entry["launches_by_path"].update(resnet_pipeline_train=pipe,
                                         gpt_bf16_stream_train=strm)
        entry["launches"] += pipe + strm
    # phases 36-38, data parallel: phase 36's one-card ShardedTrainStep
    # (every remat setting), and both ranks of phases 37-38 by their
    # wrappers' counts (the two ranks share the card)
    for i, entry in enumerate(entries):
        sharded = gpt_sharded["launches"][i] if i < 3 else 0
        gdp = gpt_dp["launches"][i] if i < 3 else 0
        rdp = resnet_dp["launches"] if i == 7 else 0
        entry["launches_by_path"].update(
            gpt_sharded_train=sharded, gpt_dp2_train=gdp,
            gpt_dp2_train_by_rank=[r["launches"][i] if i < 3 else 0
                                   for r in gpt_dp["ranks"]],
            resnet_dp2_train=rdp,
            resnet_dp2_train_by_rank=[r["launches"] if i == 7 else 0
                                      for r in resnet_dp["ranks"]])
        entry["launches"] += sharded + gdp + rdp
    # phases 39-42, tensor, pipeline and sequence parallelism: every
    # rank's wrapper counts (the ranks share the card)
    mesh_paths = {"ring_sp2_card": ring, "gpt_tp2_sp2_train": gpt_mesh,
                  "gpt_pp2_accum2_train": gpt_pp,
                  "gpt_dp2_tp2_bert_tp2_sp2_train": mesh4}
    for i, entry in enumerate(entries):
        for path, e2e in mesh_paths.items():
            per = e2e["launches"]
            n = per[i] if i < len(per) else 0
            entry["launches_by_path"][path] = n
            entry["launches_by_path"][f"{path}_by_rank"] = [
                r["launches"][i] if i < len(r["launches"]) else 0
                for r in e2e["ranks"]]
            entry["launches"] += n
    # phases 43-44, the elastic fleets: every rank's wrapper counts in the
    # training drill (the uninterrupted run at the target layout apart),
    # and the kernel-1 launches inside the serving fleet's prefill graphs
    # replayed in its profiled run
    for i, entry in enumerate(entries):
        drill = gpt_fleet["launches"][i] if i < 3 else 0
        served = serve_fleet["flash_fwd_launches"] if i == 0 else 0
        entry["launches_by_path"].update(
            gpt_fleet_drill_train=drill,
            gpt_fleet_drill_train_by_rank=[
                r["launches"][i] if i < 3 else 0
                for r in gpt_fleet["ranks"]],
            serve_fleet=served)
        entry["launches"] += drill + served
    # phases 45-46: kernels 1-3 under npx.multi_head_attention (the
    # wrappers' counts); the LSTM LM runs none of the table's kernels
    for i, entry in enumerate(entries):
        mha = npx_tail["launches"][i] if i < 3 else 0
        entry["launches_by_path"].update(npx_multi_head_attention=mha,
                                         lstm_lm_train=0)
        entry["launches"] += mha
    # phase 47, sparse storage: the wrappers' counts over the phase (the
    # sparse LM, the table and mx.nd run none of the table's kernels)
    for i, entry in enumerate(entries):
        entry["launches_by_path"]["sparse_phase"] = \
            sparse_train["launches"][i] if i < 7 else sum(
                sparse_train["launches"][7:])
        entry["launches"] += entry["launches_by_path"]["sparse_phase"]
    for row in serve_prefix.values():
        row.pop("tokens")
    print(json.dumps({"kernels": entries, "train": train_e2e,
                      "bert_train": bert_e2e, "fp8_train": fp8_e2e,
                      "bert_int8_infer": int8_e2e,
                      "resnet_train": resnet_e2e,
                      "resnet_int8_infer": resnet_int8_e2e,
                      "gpt_bf16_train": gpt16_e2e,
                      "bert_bf16_train": bert16_e2e,
                      "resnet_bf16_train": resnet16_e2e,
                      "gpt_bf16_hybrid_train": gpt_hybrid,
                      "bert_bf16_hybrid_train": bert_hybrid,
                      "resnet_hybrid_train": resnet_hybrid,
                      "fused_update": fused_update,
                      "serve": serve_e2e_row,
                      "serve_quantized": serve_quant,
                      "serve_prefix": serve_prefix,
                      "serve_spec": serve_spec,
                      "np_surface": np_surface,
                      "gpt_bf16_np_train": gpt_np,
                      "serve_planes": serve_planes,
                      "train_planes": train_planes,
                      "planes_cost": planes_cost,
                      "bert_bf16_lamb_train": bert_lamb,
                      "resnet_nag_train": resnet_nag,
                      "surface": surface,
                      "resnet_pipeline_train": resnet_pipe,
                      "gpt_bf16_stream_train": gpt_stream,
                      "gpt_sharded_train": gpt_sharded,
                      "gpt_dp2_train": gpt_dp,
                      "resnet_dp2_train": resnet_dp,
                      "ring_sp2_card": ring,
                      "gpt_tp2_sp2_train": gpt_mesh,
                      "gpt_pp2_accum2_train": gpt_pp,
                      "gpt_dp2_tp2_bert_tp2_sp2_train": mesh4,
                      "gpt_fleet_drill_train": gpt_fleet,
                      "serve_fleet": serve_fleet,
                      "npx_tail": npx_tail,
                      "lstm_lm_train": lstm_lm_train,
                      "sparse_train": sparse_train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2], sys.argv[3])
    else:
        main()
