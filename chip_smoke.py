"""On-card smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc; exits
non-zero without them, or when any phase fails. Phases:

  0. the card's name and power limit, torch and CUDA versions;
  1. builds every kernel source under deeplearning4j_tpu_torch/ops/csrc
     (one nvcc per source, all started together); prints ptxas's register
     and spill lines, and the registers, local (spill) bytes and dynamic
     shared memory, as loaded, of the kernels on the tensor cores: the two
     forward attention kernels, the two dK/dV kernels and the two dQ
     kernels at each head dim (flash causal and full), of the paged
     decode kernels (page walk over fp32 and int8 pages, combine) at the
     serving head dim, MHA and GQA, the conv kernel's variants at
     AlexNet's and LeNet's channel counts, and the bnap_sums kernel's two
     lane widths (float4 and scalar); and the same of the three bf16 CNN
     kernels (conv by channel counts, bnap_sums by lane width, bnap_dx),
     and of the two bf16 BN+act+pool ring kernels (bnap_common.cuh: bulk
     copies through an mbarrier ring, 16-byte lanes) with ptxas's spills,
     gated on 0 local bytes;
     and of the bf16 forward core (attn_fwd_bf16.cuh) by head dim: its
     warp specialisation (threads, the registers setmaxnreg gives the
     producer warpgroup and each consumer warpgroup, stages, tile), ptxas's
     registers and spills of each forward kernel, and the count of ptxas
     warnings that it serialised a wgmma; the same of the bf16 dK/dV core
     (attn_dkv_bf16.cuh: its block and ring) and its two kernels; the same of
     the bf16 wgmma conv kernel (conv_bf16.cuh), and the conv route of
     AlexNet's and LeNet's convs and of shapes at the route's limits as the
     built library decides it (gated against cuda_kernels.conv_bf16_route,
     the rule the CPU tests read);
  2. holds the paged-decode kernels (the page walk split over S blocks per
     (row, kv-head), S = cuda_kernels._paged_splits of the shapes, then
     the combine) against their plain PyTorch version on the card at the
     serving shapes (fp32 and int8 pages, MHA and GQA): max |diff| < 1e-4
     and the same bits on a second launch; prints S; times both with CUDA
     events (median of 25; before each call the L2 is flushed and the
     device spins for about 5 ms, so the host has queued the call when
     the first event runs, and the events hold device time, not the
     host's launch path) beside the least time the card could take (live
     K/V bytes at 3.35 TB/s, or f32 flops at 67 TFLOP/s);
     and again at the loop bound's and the splits' edge depths (0, either
     side of a page boundary, either side of split 0's end, full depth,
     the overflow sentinel 1 << 30) and at a one-page table bucket, where
     S = 1 and the walk writes the output itself (same gates);
  3. serves the flagship transformer LM (vocab 128, d_model 512, 8 heads,
     4 blocks, RoPE, f32, random weights from a seed) through the port's
     InferenceServer (supervised, the default) on a paged pool, its decode
     step and its prefill chunks captured into CUDA graphs (one step per
     table bucket and one chunk per (chunk bucket, table bucket), by the
     server's warmup() before it answers; decode_graphs "on", the
     default): after one short warm-up request, 8 concurrent POST
     /generate (prompts of 100-700 tokens, 32 new tokens, half greedy,
     half seeded sampling); tokens must equal the port's solo
     generate_transformer on the card and the same requests on a
     decode_graphs="off" server (the eager step and chunks), the kernel's
     launch count (counted at capture, added on every replay) must equal
     4 layers x the decode steps taken, the captures exactly those
     buckets, all made by warmup() (none under traffic), the chunk rows
     read back to the host exactly one per final chunk (none for the
     others), and no engine restart; prints the mean decode step and
     prefill chunk, captured and eager, the time to first token (p50,
     p99), the warmup seconds and the graph pool's bytes;
  4. the same with int8 KV pages, held against a paged_kernel="off" int8
     engine on the card (the layer's gather body) and the eager step;
     then a breakdown of the fp32 and int8 serving runs under
     torch.profiler, captured and eager (the device's busy share, the top
     kernels), printed side by side (no speed gate);
  5. holds the three training kernels against their plain PyTorch
     versions on the card: the conv kernel at AlexNet-CIFAR10's three
     conv shapes and LeNet-MNIST's conv2 (B=512), the BN+act+pool
     backward's sums and dx kernels at AlexNet's three BN+pool shapes
     (B=512), and an edge set (stride 2 SAME, OC not a multiple of the
     tile, exact 4-way ties, the smallest B, every activation of the conv
     epilogue with its pre-activation output); then the conv training
     seam (kernel forward, saved-tensor backward; softmax as the identity
     epilogue plus a channel softmax) against the autograd of the plain
     default: output and dx, dw, db within 1e-4 of max |plain|, one
     launch in the forward and none in the backward. Gates: conv max
     |diff| <=
     1e-4 x max |plain| (f32 sums of up to 1152 products in another
     order); sums <= 1e-4 x max |plain| (sums over up to 131072 window
     positions in another order), and bitwise equal on a second launch;
     dx <= 1e-5; the conv bitwise equal on a second launch too (it runs
     on the tensor cores in 3xTF32). Times (as in phase 2) beside the
     bound and, for conv, beside its 3xTF32 bound (three tf32 products per
     product at 495 TFLOP/s, or the bytes) with the kernel's share of each
     bound, and F.conv2d on channels-last with bias and the activation
     (TF32 off); the sums and dx kernels' times summed over AlexNet's three
     shapes beside their bounds and shares;
  6. trains AlexNet-CIFAR10 at full width (64/128/256 conv channels,
     Dense 512 with dropout 0.5, Adam, l2 1e-4, f32, random weights from
     the config's seed) on one seeded synthetic CIFAR-shaped batch of
     512 for 20 fit_batch steps: every loss finite, the last below the
     first, launches exactly 3 conv + 3 sums + 3 dx per step; examples/s
     and step ms; 5 more steps under torch.profiler for the busy share.
     Then the gradients of one more step, on the same params and dropout
     masks, through the kernels and through plain versions: with only
     bn_act_pool plain (the forward is then the same bits) the loss
     within 1e-6 and every parameter's gradient within 1e-4 (relative L2
     norm; a conv bias that feeds a BatchNorm, whose exact gradient is
     zero, relative to its layer's whole gradient); with every kernel
     plain the loss within 1e-5, the gradients printed beside the count
     of 2x2 windows whose max or its sign the conv's rounding moved (one
     such window moves a leaf well past rounding); with every kernel plain
     but each conv's forward value pinned to the kernel's bits (its
     gradient through the plain conv), each conv output within 1e-4 of
     the plain one (of max |plain|) on the training path's own inputs,
     the loss within 1e-6 and every gradient within 1e-4. Then the
     same seeds with the three kernels replaced by their plain
     versions (helpers.PLAIN_OVERRIDES through register_helper): no
     kernel launches; the losses of steps 1-2 within 1e-4 (relative) of
     the kernel run's, where only one update separates them, and every
     loss within 2e-2: from step 3 on, Adam and the loss spike of the
     first steps amplify the 1e-7 rounding differences of the two runs
     (to about 6e-3 at worst on an H100);
  7. trains LeNet-MNIST (Nesterovs, l2 5e-4) for 5 steps at B=512: one
     conv launch per step (conv1's kw*c = 5 < 8 declines, as in the JAX
     package), finite losses;
  8. prefix reuse, copy-on-write and preemption on the serving flagship of
     phase 3, through the same InferenceServer, over fp32 and int8 pages:
     after the first wave (phase 3's 8 requests, which publishes their
     prompts' full blocks to the prefix trie), a second wave of 8: seven
     requests on the first 256 tokens of a first-wave prompt with new
     suffixes (prefix hits: the table points at the cached pages, no K/V
     copy), and an exact repeat of the block-aligned 384-token first-wave
     prompt (a full-prompt hit whose refeed copies the last shared page);
     it runs under torch.profiler (CUDA activity only) for the device's
     busy share; then the first wave again, posted in order, on a pool cut
     to 0.41 (then 0.33) of the wave's peak block need until a request is
     preempted and resumed. Every server captures its decode steps and
     prefill chunks in warmup(); one more serves both waves with the
     eager step and chunks (decode_graphs "off"), its second wave profiled
     too. Gates: tokens
     identical to solo generate_transformer (fp32) or to a
     paged_kernel="off" engine on the same waves (int8), and to the eager
     step's, the rerun's to the first wave's; prefix hits and a COW copy
     in the second wave, a preemption in the rerun; no trie pin left;
     paged-kernel launches = 4 layers x decode steps in every wave; the
     captures exactly the buckets and none under traffic; one host read
     per final chunk; no engine restart. Prints
     each wave's wall time, tokens/s, prefill chunks (beside a cold
     wave's), restored positions and busy share (captured and eager);
  9. holds the three flash-attention kernels (forward, dK/dV, dQ, all on
     the tensor cores in 3xTF32) against their plain versions on the card
     at the LM training shapes [32, 256, 8, 64] and [1, 8192, 4, 128]
     (causal) and an edge set (L = 1, 7, 129, 300 at D=32, and L = 7, 129,
     300 at D = 16, 64 and 128, full attention with B*H = 3 and causal):
     max |diff| / max |plain| <= 1e-5 for o and lse, and for dq, dk and dv
     over the largest plain gradient; the gradients bitwise equal on a
     second launch. Times (as in phase 2) beside the f32 bound (operations
     of the kept (query, key) pairs at 67 TFLOP/s, or bytes) and the
     3xTF32 bound (three tf32 products per product at 495 TFLOP/s) with
     the kernel's share of each,
     and, at the two main shapes, F.scaled_dot_product_attention forward
     and forward+backward (f32, TF32 off) and the splash forward on the
     same inputs (within 1e-4 of the flash plain version). Then the
     attention seam under autograd against the dense default's autograd
     (1e-4; one launch of each kernel);
 10. trains transformer_lm at full width (vocab 128, d_model 512, 4
     blocks, Adam 3e-4, f32, random weights from seed 7) on seeded one-hot
     next-token batches: 8 heads at T=256, B=32 for 20 steps, and 4 heads
     (Dh 128) at T=8192, B=1 for 10: every loss finite, the last below the
     first, launches exactly 4 forward + 4 dK/dV + 4 dQ per step;
     tokens/s and step ms; the busy share over 5 profiled steps; the
     gradients of one more step through the kernels and through their
     plain versions (loss 1e-5 relative, worst leaf's relative L2 1e-3);
     the same seeds through the plain versions: no kernel launch, losses
     within 1e-6 (relative) over steps 1-2 and 1e-5 over all (the LM's
     losses fall smoothly, without AlexNet's early spike that amplifies
     rounding);
 11. holds the three splash-attention kernels (forward, dK/dV, dQ; loops
     driven by the block tables of ops/splash_mask.py) against their
     plain versions (chunked over query rows, so they run at L = 32768)
     at [1, 32768, 4, 128] causal (the long-context LM's shape), [1,
     32768, 8, 128] causal (the JAX bench row's), [4, 2048, 4, 64] full
     and an edge set (L = 128 and 256, D = 16 and 32, B*H = 3): o and lse
     within 1e-5 of max |plain|, dq, dk and dv within 1e-5 of the largest
     plain gradient, the gradients bitwise equal on a second launch; and
     against the flash kernels on the same inputs, two independent
     kernels (1e-4: the splash path folds the scale into q, flash scales
     the scores). Times as in phase 2 (5 calls at L = 32768) beside the
     bound (the 3xTF32 bounds and shares of all three as in phase 9: dK/dV
     3 x 8 D per kept pair, dQ 3 x 6 D), the
     flash kernels' time at the same shape and, at the three
     main shapes, F.scaled_dot_product_attention forward and
     forward+backward (f32, TF32 off). Then, for the attention route's
     SPLASH_MIN_LEN, the forward, dK/dV and dQ of both families at [1, L,
     4, 128] causal for L = 8192, 16384 and 32768, timed in turns in one
     run (no gate: the route stays as it is);
 12. trains transformer_lm at T = 32768, B = 1 (vocab 128, d_model 512, 4
     heads, Dh 128, 4 blocks, Adam 3e-4, f32, remat on, random weights
     from seed 7) for 4 steps: every loss finite, the last below the
     first, launches exactly 8 splash forward (4, and 4 recomputed by
     remat) + 4 dK/dV + 4 dQ per step and no flash launch; tokens/s and
     step ms; the busy share over 2 profiled steps; the gradients of one
     step through the kernels and through their plain versions (loss
     1e-5 relative, worst leaf's relative L2 1e-3); the same step with
     remat off (4 + 4 + 4 launches): loss and every gradient within 1e-6
     (relative L2) of the remat run's;
 13. KV-cache generation on the serving flagship of phase 3: a 300-token
     prompt and 32 new tokens, greedy and seeded, through
     generate_transformer(use_cache=True) (the contiguous cache of
     rnn_time_step): tokens identical to the uncached solo generate;
 14. contiguous serving on the flagship (kv_pool_mb 0, the default: per-
     slot stripes of max_cache_len 1024, 8 slots, a 64 MiB side prefix
     pool), decode and chunks captured: phase 3's first wave, then phase
     8's second wave (prefix hits restored into the stripes). Gates: both
     waves' tokens identical to solo generate_transformer, prefix hits >
     0, exactly one decode capture and one chunk capture per chunk bucket
     (the slot a device index), one host read per final chunk, no kernel
     launch (contiguous decode has no kernel, in JAX either); prints the
     registry's step-time and time-to-first-token quantiles;
 15. phase 3's wave again on a server with decode_transfer_guard
     "disallow" (every scheduler iteration under
     torch.cuda.set_sync_debug_mode("error"), the probs and final-row
     reads declared; the server takes /generate traffic only, as the mode
     is process-wide): no undeclared sync (no engine crash, no restart),
     tokens identical to phase 3's;
 16. the same wave as SSE streams, all at once: every streamed token list
     equal to the buffered one; then a client that hangs up mid-stream:
     its decode is cancelled, its slot and blocks freed, no pin left;
 17. the chaos drill on the card (paged fp32, full width, hang timeout
     HANG_TIMEOUT_S): the wave with no fault, then with each of
     CHAOS_FAULTS armed in turn (crash and oom at dispatch.decode,
     dispatch.prefill, scheduler.iteration and pool.alloc, and a hang
     past the timeout), the 8 requests posted at once by a retrying
     client, while another client posts /predict forwards through the
     recoveries (the rebuilt engines capture while it runs) and another
     polls /readyz. Gates: every completion's tokens identical to the
     no-fault run, none lost or finished twice, each fault fired once and
     restarted the engine once, /readyz 503 during each recovery and 200
     after, the paged launches 4 x the decode steps of every engine built,
     each rebuilt engine on the same device, kernel and graph modes, and
     torch.cuda.memory_allocated() after the last restart within one
     engine's footprint of its value before the first; prints both and
     each fault's recovery seconds;
 18. POST /admin/drain on the same server with all 8 requests in flight:
     none dropped, tokens identical, the engine swapped, ready again;
 19. /predict on alexnet_cifar10 at full width from a zip, micro-batched:
     64 concurrent single-row posts; every answer within 1e-4 of the net's
     plain-version output, conv kernel launches = 3 x the batches the
     batcher dispatched; prints the batch occupancy and the p50/p99
     latency;
 20. holds the six bf16 attention kernels (the forwards on the Hopper
     core attn_fwd_bf16.cuh: wgmma fed by TMA through an mbarrier ring,
     warp-specialised warpgroups; both dK/dV kernels on attn_dkv_bf16.cuh:
     wgmma, q and dO by TMA through an mbarrier ring, two warpgroups of 64
     keys; both dQ kernels on attn_dq_bf16.cuh: wgmma, k and v by TMA
     through an mbarrier ring, two warpgroups of 64 query rows; in the
     same four .cu files) against their
     plain versions at bf16, which make the roundings of the library each
     replaces (flash rounds p to bf16 before p v, splash keeps it f32; both
     round p and ds before the backward products): flash causal at [32,
     256, 8, 64], flash causal and full at [1, 8192, 4, 128], splash causal
     at [1, 32768, 4, 128] and [1, 32768, 8, 128]. Gates: max |diff| of o,
     dq, dk and dv within 2^-7 of each one's max |plain| (one bf16 ulp of
     the largest element), mean |diff| within 1e-3 of it, lse within 1e-4
     absolute, outputs bf16 and lse f32; every kernel, the forwards
     included, bitwise repeatable over two launches. Times (as in phase 2)
     beside the bf16 bound (the kept pairs' operations at 989 TFLOP/s, or
     bf16 bytes), each forward's and dK/dV kernel's achieved TFLOP/s
     beside its share, and SDPA at bf16, forward and forward+backward (its
     o within 2^-5 of the plain version's) against the three kernels' sum;
     the edge set runs flash L = 7, 129, 300 and splash L = 128, 256 at
     every head dim; phase 1 prints the kernels' registers, local bytes and
     shared memory;
 21. trains transformer_lm in bf16 at full width, as phases 10 and 12
     train it in f32 (same seeds, the same data, the f32 init rounded):
     bf16 params at T=256 B=32 (20 steps), T=8192 B=1 (10), T=32768 B=1
     with remat (4), and f32 masters with compute_dtype bf16 at T=8192
     (10). Gates: losses finite and falling; launches exactly 4 forward +
     4 dK/dV + 4 dQ bf16 kernels per step (splash: 8 forward under remat)
     and no other kernel; params at their dtype, updater state f32, the
     output bf16; the loss curve within 0.1 max(1, |loss|) of the f32
     row's at every step; one step's loss (2e-3 relative) and every
     leaf's gradient (max |diff| within 5e-2 of its max |plain|) through
     the kernels against the plain versions. Prints step ms, tokens/s and
     the busy share beside the f32 row's;
 22. holds the three bf16 CNN kernels (conv2d_bias_act over
     conv_bf16.cuh, f32 accumulation, one rounding at the store: the wgmma
     kernel, A by TMA im2col, when C % 64 == 0 and OC % 8 == 0, AlexNet's
     conv2 and conv3, the bf16 mma.sync kernel for other shapes, AlexNet's
     conv1 and LeNet's conv2; bnap_sums and bnap_dx with bf16 x, g and dx, the window's
     activations rounded to bf16 before the max and the tie count) against
     their plain versions at bf16: the conv at AlexNet's three conv shapes
     and LeNet's conv2 (B=512, each with its route and TFLOP/s), the
     BN+act+pool backward at AlexNet's three BN+pool shapes (B=512), and an
     edge set on each route (stride 2 SAME, OC not a multiple of the tile,
     C = 3, 4, 8, 16, 20, 24, 32, the smallest B, every activation of the
     epilogue with its pre-activation output; on the wgmma route C = 64,
     128, 192, OC = 72, asymmetric pads, M tails, B = 1, every activation
     with its pre-activation at C = 64, OC = 16; each case gated on its
     route; windows of four
     adjacent bf16 values whose activations tie only after the rounding,
     the smallest B, a C that takes the scalar lanes; on the BN+act+pool
     ring route, cuda_kernels.bnap_bf16_route, B = 1 with H = 2, rows wider
     than a stage, a pooled-row count that is not a multiple of the grid,
     C = 8 and C = 1024, tied windows, and a view 8 bytes off 16 that
     takes the lane kernels; each case's route printed). Gates: conv output,
     pre-activation and dx within 2^-7 of max |plain| (one bf16 ulp of the
     largest element), mean |diff| within 1e-3 of it, outputs bf16; sums
     (f32) within 1e-4 of max |plain| and bitwise on a second launch; the
     conv bitwise on a second launch; the tied windows' dx bitwise the
     plain version's. Times (as in phase 2) beside the bf16 bound
     (operations at 989 TFLOP/s for the conv, bf16 bytes at 3.35 TB/s)
     and its share, and F.conv2d at bf16 on channels-last with the bias and
     the activation (its output within 2^-5 of the plain version's);
 23. trains AlexNet-CIFAR10 in bf16 at full width, B=512, 20 fit_batch
     steps on phase 6's seeds and data: bf16 params (the f32 init
     rounded), and f32 masters with compute_dtype bf16; then LeNet-MNIST
     bf16, 5 steps. Gates: losses finite and falling; launches exactly 3
     bf16 conv + 3 bf16 sums + 3 bf16 dx per AlexNet step, every sums and
     dx launch on the ring route, and no f32 CNN kernel (LeNet: one bf16
     conv); params and BN variables at their
     dtype, the updater state f32 (and the masters and variables f32 under
     mixed precision), output() bf16; each loss within 0.1 max(1, |loss|)
     of phase 6's f32 loss at every step; one step's loss through the
     kernels within 2e-3 (relative) of the plain versions' on the same
     params and dropout masks, every leaf's gradient within 5e-2 of the
     largest plain gradient, and each leaf's distance from the same step
     in f32 through the f32 kernels no more than 2x the plain path's (a
     conv bias that feeds a BatchNorm against its layer's whole
     gradient). Prints step ms, examples/s and the busy share (5 profiled
     steps) beside phase 6's f32 row;
 24. trains the GravesLSTM char-RNN (char_rnn_lstm: V=77, two GravesLSTM
     layers of 256, TBPTT 50, Nesterovs 0.9, lr 0.1) at B=128 T=200 on
     seeded walks of a Markov chain (three successors a character, 0.6 /
     0.3 / 0.1): 10 fits on one batch, 4 windows each. No hand-written
     kernel runs (JAX has none for the LSTM): the time loop is plain
     PyTorch, torch.matmul for the products. Gates: every window's loss
     finite and the last below the first; the first fit on the card and
     on the CPU from the same params, each window's loss within 1e-4
     relative and every leaf after it within 1e-4 of its max |value|;
     64 one-token rnn_time_step calls against output() within 1e-5;
     generate_rnn greedy (a 20-token prompt, 100 new) from the trained
     params, the same tokens on the card and on the CPU (on a parting,
     the step and the CPU's top-2 gap are printed); the bf16 net (the
     f32 init rounded) for 10 fits, every window within 0.1 max(1, |loss|)
     of the f32 one. Prints characters/s (B T over the mean fit wall,
     fits 2-10), the mean window ms and the busy share over 2 profiled
     fits, beside the card's name and power limit;
 25. trains MLP-Iris (mlp_iris() with Adam, lr 0.01, 60 epochs of batch
     50, the packaged Iris copy) and evaluates it: accuracy above 0.9 and
     the confusion matrix equal to the CPU run's from the same init; then
     every layer of ROADMAP A3 (GRU, the bidirectional GravesLSTM, a
     masked LSTM and GravesLSTM, Embedding by index and one-hot, each
     GlobalPooling kind masked, unmasked and NHWC, LRN, Activation,
     Dropout at p=0, Loss) on the card against the CPU, forward and
     gradients, within 1e-5 of max |CPU|; every kernel launch counter
     stands still over phases 24-25;
 26. serving paths of the slice after A3: (a) the char-RNN of phase 24,
     trained 10 fits, served through /generate from the engine's own h/c
     rows: 16 requests at once (prompt 20, 100 new, half seeded top-k)
     over 8 slots, prefill chunk 32, captured and eager (decode_graphs
     "off"); gates: tokens identical to generate_rnn solo on the card,
     one decode and one capture per chunk bucket, all in warmup(), no
     kernel launch; prints characters/s and the busy share (a profiled
     second wave); (b) the flagship LM at bf16 and mixed (phase 3's width,
     the same seed's params rounded) through the engine on phase 3's
     requests, paged and contiguous: every served row within 2^-9 of the
     solo cached row on its context (rnn_time_step, teacher-forced), and
     tokens identical to solo generate_transformer(use_cache=True) at the
     same dtype, or parting only at a near tie (a row within 2^-9 of
     solo's could draw another token: greedy, a top-two gap below 2^-9; a
     chunked prompt rounds otherwise than a whole one; printed), caches
     bf16,
     no kernel launch (the paged seam declines a bf16 query; the kernel's
     wrapper, called with one, raises); prints tokens/s; (c) phase 3's
     paged wave on a server, fp32 pages and int8: unconstrained (cold,
     then again on the published prompts), twice with an admit-all
     grammar on every request (warmup() builds no masked step without a
     resident grammar, so the first of the two captures them on first
     use), and with neutral penalties; gates: tokens identical to phase
     3's (phase 4's), every step of an admit-all wave the masked graph and
     the paged kernel launched 4 x its steps inside it, no capture past
     the first admit-all wave; then (fp32) a trie grammar forces its
     sequence ("grammar"), three JSON-schema completions parse, a stop
     sequence cuts request 0 ("stop"), and /generate n=4 on a 1024-token
     prompt returns 4 candidates, candidate 0 the n=1 output, 3 followers
     restoring 3 x 1023 positions, the 64 prompt blocks held by all 4
     slots' block tables, and every reference returned; prints the
     masked and unmasked steps' mean ms from the same server;
 27. speculative decoding and int8 graph decode on phase 3's flagship
     and requests, through supervised servers: (a) speculate=3 with the
     default shallow draft (2 blocks) on fp32 pages, int8 pages and
     contiguous stripes; gates: tokens identical to phase 3's (phase
     4's), every capture (the verify per table bucket, the draft step, a
     draft chunk per chunk bucket) in warmup(), proposals made, the paged
     kernel launched 4 x the plain decode steps and never by the verify
     or the draft, every page back; prints tokens/s beside phase 3's and
     the acceptance rate; (b) draft_net a second copy of the target: the
     greedy half's acceptance above 0.95, each greedy rejection's
     top-two gap printed; (c) an admit-all grammar on every request
     (fp32 pages, twice): tokens identical, the masked verify and draft
     captured on first use and never again; phase 26's trie and first
     JSON completion the same under speculation; (d) dispatch.verify
     crash@once mid-wave at speculate=2: every request answered with
     phase 3's tokens, the rebuilt engine speculating, its captures those
     of its warmup(); (e) the flagship's quantize_graph clone (calibrated
     on phase 3's first prompt) on fp32 pages without and with
     speculate=2: tokens identical to its solo cached decode, launches 4
     x the plain steps; its rows on the card within 1e-5 of max |CPU|
     of the same clone on the CPU; AlexNet's quantize artifact behind
     /predict within 1e-4 of max |CPU| with the same argmax; prints the
     float and int8 parameter bytes;
 28. the KV tiers and the attribution plane on the flagship at full
     width, through InferenceServer over HTTP, paged kernel on, prefill
     chunk 16, a pool of 1.25 x one wave's peak block need: wave A (8
     prompts of 512 tokens, heads that differ, half greedy, half seeded),
     wave B (8 unrelated ones, which evict A's prefix leaves), wave C (A
     again). (a) fp32 pages over a host tier of 96 MiB, under an armed
     resource ledger; gates: wave C's tokens equal wave A's,
     kv_tier_spilled_blocks_total, kv_tier_promoted_blocks_total and
     kv_tier_restored_tokens_total > 0, no failed restore, every promoted
     block still in the trie bitwise equal to the rows it was promoted
     from, wave C's paged launches = 4 x its decode steps, the ledger zero
     at stop; prints the restored tokens, wave C's TTFT beside wave A's,
     and the worker's ms a block of a spill and of a promotion; (b) the
     same on int8 pages (the scale rows move with them); (c) a host tier
     of 4 MiB over a disk tier of 128 MiB, one of wave A's block files
     truncated after wave B and its prompt served alone (the torn block a
     counted miss, the same tokens), then wave C: disk hits, promotions,
     identical tokens; (d) tier.spill crash@n:5, tier.restore crash@n:3
     and directory.publish crash@n:2: identical tokens, each fault
     counted, the directory's state kept; (e) between (d)'s faults a
     second server fetches the heads of wave A's chains that (d)'s server
     still holds (resident or in its tiers) with POST /prefix/fetch from
     its /prefix/block and serves those prompts: at least one block from
     (d)'s host or disk tier, tokens identical, every fetched block
     restored, only the rest prefilled; (f) GET /debug/engine on (a)'s
     warmed server: a cost entry for every (family, bucket), fused 1.0 on
     every decode bucket (0.0 on a kernel-off server), the kernel
     engaged, the MFU estimate in (0, 1], the tier's queues empty at idle,
     /info's slo and profiler; prints wave A's served tokens/s over each
     wave's wall time on one warmed server with the step-phase profiler
     armed and disarmed in turns (on, off, off, on, ...), and their ratio
     (the tokens must not change);
 29. the captured training step (nn/step_graph.py: the default
     train_graphs="on", each step on the card a replay of the CUDA graph
     captured for its key) against the eager one (train_graphs="off") on
     every training path of phases 6, 7, 10, 12, 21, 23 and 24 (AlexNet
     f32, bf16 and mixed at B=512, LeNet at B=512, the LM at T=256 and at
     T=8192 bf16, the T=32768 remat step, the char-RNN's TBPTT windows)
     and an MLP with dropout, AdamW and an exponential lr: per path one
     captured and two eager runs of the same init, seeds and batches, 5
     steps (the 32k step and the char-RNN's fits 3), cuDNN on its
     deterministic algorithms for the phase; gates: losses,
     params, updater state and BN variables bitwise equal to the eager
     run where the two eager runs are bitwise equal (else no further from
     it than the second eager run), each step's launches kernel by kernel
     equal to the eager step's, graphs captured and replayed; prints the
     steady-state step ms and the busy share (3 profiled steps) of both
     modes; then fit_scan K = 16 bitwise against 16 fit_batch calls
     (LeNet), fit_batch_accumulated K = 4 against the full batch (an Sgd
     MLP, max |diff| of the params within 1e-5 after 5 steps), dbn_mnist
     pretrained (512 binary digits) and finetuned 10 epochs (finite, the
     loss falling), an LBFGS fit (the loss falling), and three captured
     steps under torch.cuda.set_sync_debug_mode("error"). Every earlier
     training phase runs captured too, its launch gates counting
     replays; their plain references run eagerly;
 30. ComputationGraph vertices, BatchNorm variables, early stopping and
     gradient checks (cuDNN on its deterministic algorithms): (a)
     AlexNet-CIFAR10 at full width as a ComputationGraph, one
     LayerVertex a layer of the list (the dense vertex with the list's
     CnnToFeedForward, a FeedForwardToCnn on the first), on the CIFAR-10
     iterator's offline stand-in at B=512: 5 Adam steps captured against
     train_graphs="off", losses, params, updater state and BN variables
     bitwise, launches equal step for step, row 3's 3 a step (the graph
     does not fuse BN + pool); eval outputs against the
     MultiLayerNetwork on the same params and BN variables within 1e-5
     of max |network output|; (b) early stopping on a fresh such graph
     (8 train batches of 512, 2 held out, MaxEpochs(4),
     ScoreImprovement(2), InMemoryModelSaver): epochs, best epoch, score
     per epoch, the best model's accuracy; the best model written with
     write_model and restored on the card, and through
     LocalFileModelSaver: outputs, params and variables bitwise; (c)
     examples/seq2seq_addition.py's graph at its widths (GravesLSTM 64,
     B=128): 5 steps captured against eager bitwise, 200 captured
     steps, the loss at steps 0/100/200 and the digit accuracy on 256
     fresh problems (a report); (d) check_gradients at float64 on the
     card, a conv + BN + dense network and a masked GravesLSTM one,
     every parameter passing (the plain paths: the conv's kw*c < 8);
     (e) the phase's seconds; alone: `python3 tools/phase30_alone.py`;
 31. tensor-parallel decode and the data-parallel masters, ranks
     co-located on card 0 over gloo (`devices=["cuda:0"] * 2`): (a) the
     flagship (phase 3's net and 8 requests) at tp = 2, paged fp32 pages,
     eager steps: tokens equal the tp = 1 eager engine's, each rank runs
     H = 4, Hkv = 4 and launches the paged kernel 4 x the decode steps,
     one decode step's collectives on each rank 8 all-reduces and one
     command, and the wave's all-reduces 8 x (steps + chunks); (b) the
     same with int8 pages, then a GQA net at the same width (Hkv = 2,
     one kv head a rank); (c) phase 2's kernel check at the shard shapes
     (H = 4, Hkv = 4 fp32 and int8, Hkv = 1): max |diff| < 1e-4, the same
     bits again, with ms, plain ms and bound; (d) rank 1 SIGKILLed while
     a supervised tp = 2 server decodes: the request ends with its
     tokens after a rebuild (or in the structured 503), never a hang;
     (e) AlexNet-CIFAR10 at full width with dropout 0, B = 512 over 2
     ranks, 3 steps of the ICI master against one process's 3 steps on
     the whole batch (losses within 1e-4, Adam's moments within 1e-3 of
     their norm, params within 5e-2 of the steps' change), 3 conv, 3
     sums and 3 dx launches a step on each rank; then 5 rounds of
     parameter averaging (frequency 2): finite, falling; (f) each
     rank's step ms, the all-reduce's ms and bytes, examples/s, the
     pool's blocks at tp = 1 and 2 (no speed gate); (g) with two or more
     cards, (a) again over NCCL, one card a rank, else "phase 31g not
     run: 1 card"; alone: `python3 tools/phase31_alone.py`;
 32. speculation, the KV tiers and fault tolerance under the mesh, ranks
     co-located on card 0 over gloo: (a) the flagship at tp = 2,
     speculate = 3 with a 2-block shallow draft, phase 3's 8 requests on
     paged fp32 pages and in contiguous mode: tokens equal the tp = 1
     unspeculated eager engine's, 4 paged launches a plain decode step
     on each rank (none in contiguous mode; the verify and the draft
     launch none), the verify's collectives on each rank 8 all-reduces
     and one command, the draft's 4 and one; verify, draft and step ms,
     proposals and acceptances; (b) phase 28's waves (A, B, C = A; 8 x
     512-token prompts, chunk 16) at tp = 2 on fp32 and int8 pages, a
     rank's pool holding phase 28's block count, a 96 MiB host tier:
     wave C equals wave A and the tp = 1 engine's wave A, promotions > 0,
     failed restores printed, 4 paged launches a step on each rank; wave
     A's first prompt chain fetched from the tp = 2 tier holds every head
     and, fp32, serves a tp = 1 peer engine token-identically; (c)
     AlexNet-CIFAR10 at full width, B = 512 over 2 ranks, ICI master with
     a TrainingStateTracker every step: dropped after 3 steps, `resume()`
     on a fresh net and master returns 3 and the 5-step params match an
     uninterrupted run's (31e's gate; bitwise or not is printed); the
     follower SIGKILLed after step 3 under `fit_with_recovery` fails the
     fit, and a restart on one rank with the dead worker disabled replays
     from the cursor to the uninterrupted params (31e's gate), 3 + 3 + 3
     launches a step on each rank; alone: `python3
     tools/phase32_alone.py`;
 33. tensor-parallel training and the other parallel modules, ranks
     co-located on card 0 over gloo: (a) the flagship (vocab 128,
     d_model 512, 8 heads, 4 blocks, RoPE, f32, Adam, seed 7) trained at
     tp = 2 by `shard_transformer_tp` for 3 steps of B = 32, T = 256,
     eager, against the tp = 1 eager step: losses within 1e-5 relative,
     params within 1e-2 of the steps' change, the replicated params
     bitwise equal on both ranks, on each rank exactly 4 launches a step
     of each flash kernel (rows 6a-6c at [32, 256, 4, 64]), 16
     all-reduces on the model axis and 1 command a step and no gather;
     both step ms; (b) the flash kernels at that shard shape against
     their plain versions (phase 9's gates and print); (c) the same net
     on a 2 x 2 {data, model} mesh (4 ranks) under the ICI master, 3
     steps, against one process's fits (losses within 1e-4, params
     within 1e-2 of the change), the collectives by axis; (d) ZeRO-1:
     the net under the ICI master on 2 ranks, params within 1e-6 of the
     change from the unsharded master's, each rank's updater bytes
     0.45-0.55 of the unsharded master's; (e) ring and Ulysses attention
     at [1, 8192, 8, 64] causal over 2 ranks against the single-card
     flash forward, within 1e-4 of max |ref|, one flash forward launch
     on each Ulysses rank; (f) GPipe (2 stages x 4 microbatches of the
     pre-LN block at d_model 512) forward and gradients against the
     sequential stack, and MoE (2 experts at D = 512) against the
     one-process routing, within 1e-4; alone: `python3
     tools/phase33_alone.py` (``--cpu-rehearsal`` on CPU ranks);
 34. prints the kernels line (the bf16 kernels as rows of their own,
     named "<kernel>_bf16"; the paged rows carry phase 26's masked-wave
     launches as "masked_launches", phase 27a's as
     "speculating_launches" and phase 28's wave C as "tiered_launches",
     the fp32 row phase 27e's int8-clone launches as
     "int8_graph_launches"; the f32 conv row phase 30a's launches of
     each captured graph step as "graph_launches_per_step"; phase
     31's per-rank launches as "tp_launches_per_rank" and
     "dp_launches_per_rank", the paged kernel at the shard shapes as
     "shard_cases"; phase 32's as "tp_speculating_launches_per_rank",
     "tp_tiered_launches_per_rank" and "ft_launches_per_rank"; the flash
     rows phase 33a's as "tp_train_launches_per_rank", 33b's kernel at
     the shard shape as "shard_case", and the forward row 33e's as
     "ulysses_launches_per_rank").

The last line is {"ok": true, "device": {...}}. Every number printed is
measured in this run; a "[details]" JSON line before the kernels line
holds them all, unrounded.
"""
import contextlib
import gc
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM tf32 on the tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
# phase 20: a bf16 kernel against its plain version (the library's roundings
# in PyTorch): max |diff| within one bf16 ulp of the largest element (the
# two sum in f32 in other orders, so a rounding may flip), mean |diff|
# within 1e-3 of it (a wrong rounding rule cannot hide under the max), lse
# (f32 from f32 sums) within 1e-4
BF16_MAX_REL, BF16_MEAN_REL, BF16_LSE_ABS = 2.0 ** -7, 1e-3, 1e-4
# phase 21: one bf16 LM step through the kernels against the plain
# versions (loss relative; every leaf's max |diff| over the largest plain
# gradient of the step), each path's distance from the same step in f32
# (the kernel path no more than BF16_VS_F32 times the plain path's, per
# leaf), and the bf16 loss curve against the f32 one (0.1 max(1, |loss|),
# the JAX package's test_mixed_precision criterion)
BF16_LOSS_REL, BF16_GRAD_REL, BF16_VS_F32, BF16_CURVE = 2e-3, 5e-2, 2.0, 0.1
SPIN_CYCLES = 10_000_000   # about 5 ms at the H100's 1.98 GHz boost clock

VOCAB, D_MODEL, HEADS, BLOCKS = 128, 512, 8, 4
KV_BLOCK, SLOTS, CHUNK, NEW_TOKENS = 16, 8, 64, 32
# f32 K+V of 4 layers x 8 heads x 64 dims = 256 KiB per 16-position
# block; 516 blocks = 515 usable (8 x 1024 positions fit) + scratch
KV_POOL_MB = 129
# phase 8: the tokens of a first-wave prompt that a second-wave request
# shares, and the pools (shares of the first wave's peak block need) its
# rerun of the first wave tries in turn until one preempts
PREFIX_HEAD = 256
PREEMPT_CUTS = (0.41, 0.33)
# the rerun's posts arrive in order this far apart, close enough that the
# requests overlap (a captured prefill takes a request through its chunks
# in a few ms) and so need more blocks at once than the cut pool holds
PREEMPT_STAGGER_S = 0.005
# phase 14: the contiguous mode's side prefix pool
PREFIX_CACHE_MB = 64
# phase 17: one fault at a time, each firing once mid-wave (the n-th hit of
# its seam after arming; the wave's prompts are cached in the prefix trie
# by then, so a wave makes about 38 decode steps, 8 chunks and 20 block
# allocations); the hang outlasts the watchdog's timeout
HANG_TIMEOUT_S = 1.5
CHAOS_FAULTS = (("dispatch.decode", "crash@n:12"),
                ("dispatch.prefill", "crash@n:3"),
                ("scheduler.iteration", "oom@n:20"),
                ("pool.alloc", "oom@n:4"),
                ("pool.alloc", "crash@n:10"),
                ("scheduler.iteration", "hang:3000@n:25"))
# phase 19: concurrent single-row /predict posts on AlexNet-CIFAR10
PREDICT_POSTS = 64


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps=25, warmup=3, flush=None):
    """Median device ms of ``reps`` single calls of ``fn``, each between
    CUDA events. Before each, outside the events, ``flush`` (an L2
    eviction) runs and then the device spins for about 5 ms: the host
    enqueues the call while the device spins, so the events hold the
    call's device work and not the host's launch path (the wrapper's
    checks, its allocations, ctypes)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def paged_inputs(torch, *, B, H, Hkv, nb, pos, quantized, seed):
    """Seeded paged-decode inputs on the card, Dh = 64, block 16, over a
    permuted table: (args, kwargs) of the wrapper. ``pos`` None draws
    random per-row depths below nb * block."""
    from deeplearning4j_tpu_torch.ops.kvquant import quantize_kv_rows
    Dh, block = D_MODEL // HEADS, KV_BLOCK
    g = torch.Generator().manual_seed(seed)
    P = B * nb + 1
    kp = torch.randn((P, block, Hkv, Dh), generator=g)
    vp = torch.randn((P, block, Hkv, Dh), generator=g)
    table = (1 + torch.randperm(B * nb, generator=g)).reshape(B, nb).int()
    if pos is None:
        pos = torch.randint(0, nb * block, (B,), generator=g).int()
    else:
        pos = torch.tensor(pos, dtype=torch.int32)
    q = torch.randn((B, 1, H, Dh), generator=g)
    dev = torch.device("cuda")
    kw = {}
    if quantized:
        kp, ks = quantize_kv_rows(kp)
        vp, vs = quantize_kv_rows(vp)
        kw = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    return [t.to(dev) for t in (q, kp, vp, table, pos)], kw


def paged_check(ck, torch, args, kw):
    """The kernels against the plain version, and a second launch against
    the first: (max |diff|, bitwise repeatable, finite)."""
    got = ck.paged_decode_attention(*args, **kw)
    got2 = ck.paged_decode_attention(*args, **kw)
    want = ck.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    return (float((got - want).abs().max()), bool(torch.equal(got, got2)),
            bool(torch.isfinite(got).all()))


def kernel_case(ck, torch, *, H, Hkv, quantized, seed):
    """Serving shape: B=8 slots, Dh=64, block 16, table bucket nb=64,
    random per-row depths up to 1023 over a permuted table."""
    B, Dh, nb = SLOTS, D_MODEL // HEADS, 64
    args, kw = paged_inputs(torch, B=B, H=H, Hkv=Hkv, nb=nb, pos=None,
                            quantized=quantized, seed=seed)
    q, _, _, table, pos = args
    err, repeat, finite = paged_check(ck, torch, args, kw)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    ms = time_ms(lambda: ck.paged_decode_attention(*args, **kw), flush=flush)
    plain_ms = time_ms(lambda: ck.paged_decode_attention_ref(*args, **kw),
                       flush=flush)
    # least work: each live K/V row (and int8 scale) read once, q and
    # table/pos read once, out written once; 4*G*Dh flops per live row
    live = int((pos.long() + 1).sum())
    elem = 1 if quantized else 4
    kv_bytes = 2 * live * Hkv * (Dh * elem + (4 if quantized else 0))
    io_bytes = 2 * q.numel() * 4 + table.numel() * 4 + pos.numel() * 4
    flops = 4 * live * H * Dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"max_abs_err": err, "repeat_bitwise": repeat, "finite": finite,
            "splits": ck._paged_splits(B, Hkv, nb), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_positions": live}


def edge_cases(ck, torch, *, H, Hkv, quantized):
    """The kernels' loop bounds on the card, three table buckets of 5 rows:
    nb = 4 at depths 0, either side of a page boundary (15, 16), full depth
    and the overflow sentinel 1 << 30, which must walk no further than the
    table's nb pages; nb = 64 at depths 0, either side of split 0's end (P
    pages), full depth and the sentinel (rows whose later splits hold no
    live page); nb = 1, where S = 1 and the page walk writes the output
    itself. Returns {bucket: {depths, splits, max_abs_err, repeat_bitwise,
    finite}}."""
    B, block = 5, KV_BLOCK
    out = {}
    for nb in (4, 64, 1):
        S = ck._paged_splits(B, Hkv, nb)
        end = ck._paged_split_pages(nb, S) * block
        depths = {4: [0, block - 1, block, nb * block - 1, 1 << 30],
                  64: [0, end - 1, end, nb * block - 1, 1 << 30],
                  1: [0, 7, block - 1, block - 1, 1 << 30]}[nb]
        args, kw = paged_inputs(torch, B=B, H=H, Hkv=Hkv, nb=nb, pos=depths,
                                quantized=quantized, seed=11 + nb)
        err, repeat, finite = paged_check(ck, torch, args, kw)
        out[f"nb={nb}"] = {"depths": depths, "splits": S,
                           "max_abs_err": err, "repeat_bitwise": repeat,
                           "finite": finite}
    return out


def divergence(net, reqs, tokens, solo):
    """Each diverging request's first divergent token, and the solo
    model's top-2 log-probability margin at that position."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import onehot
    out = []
    for i, (a, s) in enumerate(zip(tokens, solo)):
        if a == s:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, s)) if x != y),
                 min(len(a), len(s)))
        ids = list(reqs[i]["prompt"]) + list(s[:j])
        p = net.output(onehot(ids, VOCAB))[0][0, -1].double().cpu().numpy()
        top = np.sort(np.log(np.maximum(p, 1e-300)))[::-1]
        out.append(f"request {i} token {j}: served {a[j:j + 1]} solo "
                   f"{s[j:j + 1]}, top-2 margin {top[0] - top[1]:.3e}")
    return "; ".join(out)


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate?timeout_ms=900000",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.loads(r.read())


def requests_for(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(rng.integers(100, 701, SLOTS)):
        body = {"prompt": [int(t) for t in rng.integers(0, VOCAB, n)],
                "max_new_tokens": NEW_TOKENS}
        if i % 2:
            body.update(temperature=0.8, top_k=20, seed=100 + i)
        out.append(body)
    return out


def post_all(port, bodies, stagger=0.0):
    """POST every body at once (body i after i * ``stagger`` s, so that
    they queue in order); the responses in order."""
    def one(ib):
        time.sleep(ib[0] * stagger)
        return post(port, ib[1])
    with ThreadPoolExecutor(len(bodies)) as ex:
        return list(ex.map(one, enumerate(bodies)))


def prefix_wave(reqs, seed):
    """Phase 8's second wave: seven requests that share the first
    PREFIX_HEAD tokens of a first-wave prompt (those at least that long,
    in turn) and go on with new tokens, half greedy, half seeded sampling;
    then an exact repeat of the first block-aligned first-wave prompt,
    whose every block is cached: a full-prompt hit, whose refeed of the
    last token copies the shared last page first."""
    import numpy as np
    rng = np.random.default_rng(seed)
    heads = [b["prompt"][:PREFIX_HEAD] for b in reqs
             if len(b["prompt"]) >= PREFIX_HEAD]
    out = []
    for i in range(SLOTS - 1):
        tail = rng.integers(0, VOCAB, int(rng.integers(32, 301)))
        body = {"prompt": heads[i % len(heads)] + [int(t) for t in tail],
                "max_new_tokens": NEW_TOKENS}
        if i % 2:
            body.update(temperature=0.8, top_k=20, seed=200 + i)
        out.append(body)
    aligned = [b for b in reqs if len(b["prompt"]) % KV_BLOCK == 0]
    if not heads or not aligned:
        raise SystemExit("the first wave has no prompt of PREFIX_HEAD tokens "
                         "or none of whole blocks")
    out.append(dict(aligned[0]))
    return out


def sampling_kw(body):
    """The sampling arguments of a /generate body, for the engine and for
    generate_transformer."""
    return {k: body[k] for k in ("temperature", "top_k", "seed") if k in body}


def post_retry(port, body, max_retries=12):
    """The chaos client: POST /generate, retrying 5xx and connection
    errors with a capped backoff (Retry-After honoured); a request is lost
    only if even this gives up. Returns (response, attempts)."""
    for attempt in range(max_retries + 1):
        try:
            return post(port, body), attempt + 1
        except urllib.error.HTTPError as e:
            if e.code < 500:
                raise
            delay = min(1.0, 0.05 * 2 ** attempt)
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra:
                delay = max(delay, float(ra))
            e.read()
        except urllib.error.URLError:
            delay = min(1.0, 0.05 * 2 ** attempt)
        time.sleep(delay)
    raise SystemExit(f"request lost: {max_retries} retries exhausted")


def sse_post(port, body):
    """POST /generate as SSE; the events, the terminal one last."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request("POST", "/generate?timeout_ms=900000",
                     json.dumps({**body, "stream": True}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SystemExit(f"SSE /generate answered {resp.status}: "
                             f"{resp.read()[:200]}")
        buf, events = b"", []
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                line, buf = buf.split(b"\n\n", 1)
                events.append(json.loads(line[len(b"data: "):]))
        return events
    finally:
        conn.close()


def get_code(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def finish_counts(tracer):
    """request_id -> number of terminal ``finish`` records."""
    counts = {}
    for ev in tracer.events():
        if ev["ph"] == "i" and ev["name"] == "finish":
            rid = ev.get("args", {}).get("request_id")
            counts[rid] = counts.get(rid, 0) + 1
    return counts


def streaming_run(model_path, reqs, want):
    """Phase 16: a paged fp32 server streams the wave as SSE (8 at once);
    then a client hangs up mid-stream. Returns the figures; raises when
    the streamed tokens differ from the buffered ``want`` or the hang-up
    leaves its slot, blocks or pin behind."""
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB, device="cuda").start()
    try:
        dec = srv.decoder
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(reqs)) as ex:
            streams = list(ex.map(lambda b: sse_post(srv.port, b), reqs))
        wall = time.monotonic() - t0
        got = [[e["token"] for e in ev if not e.get("done")]
               for ev in streams]
        done = [ev[-1] for ev in streams]
        bad = [i for i, (g, d, w) in enumerate(zip(got, done, want))
               if not (g == d.get("tokens") == w)]
        if bad:
            raise SystemExit(f"phase 16: streamed tokens differ from the "
                             f"buffered ones for requests {bad}")
        d0 = srv.metrics.counter("stream_disconnects_total").value
        free0 = dec.pool.free_blocks
        reclaim0 = dec.pool.reclaimable_blocks()
        import socket
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        body = json.dumps({"prompt": reqs[0]["prompt"][:200],
                           "max_new_tokens": 400, "stream": True}).encode()
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        head = b""
        while head.count(b"data: ") < 2:  # mid-decode: a few tokens out
            chunk = sock.recv(4096)
            if not chunk:
                raise SystemExit(f"phase 16: the stream ended early: {head}")
            head += chunk
        sock.close()
        t1 = time.monotonic()
        while time.monotonic() - t1 < 60:
            if (srv.metrics.counter("stream_disconnects_total").value > d0
                    and dec.inflight() == 0
                    and dec.pool.free_blocks == free0):
                break
            time.sleep(0.01)
        st = {"wall_s": wall, "tokens": sum(map(len, got)),
              "tokens_per_s": sum(map(len, got)) / wall,
              "disconnects": srv.metrics.counter(
                  "stream_disconnects_total").value - d0,
              "freed_s": time.monotonic() - t1,
              "inflight_after": dec.inflight(),
              "free_blocks": [free0, dec.pool.free_blocks],
              "reclaimable": [reclaim0, dec.pool.reclaimable_blocks()],
              "pins_left": dec.pool.outstanding_refs(),
              "cancelled": srv.metrics.counter(
                  "decode_cancelled_total").value,
              "stream_requests": srv.metrics.counter(
                  "stream_requests_total").value}
    finally:
        srv.stop()
    if not (st["disconnects"] == 1 and st["inflight_after"] == 0
            and st["free_blocks"][0] == st["free_blocks"][1]
            and st["reclaimable"][0] == st["reclaimable"][1]
            and st["pins_left"] == 0 and st["cancelled"] >= 1):
        raise SystemExit(f"phase 16: the hang-up left state behind: {st}")
    return st


def chaos_run(ck, model_path, reqs, want):
    """Phase 17, then phase 18 on the same server. A supervised paged fp32
    server (hang timeout HANG_TIMEOUT_S) serves the wave with no fault,
    then once per CHAOS_FAULTS entry with that fault armed, every request
    posted at once by the retrying client, while one more client posts
    /predict forwards (the flagship on one-hot inputs, [1, 64, 128]) the
    whole time and another polls /readyz. Then the wave again with POST
    /admin/drain sent once every request is in flight. Returns the
    figures; raises on any lost, duplicated or different completion, a
    fault not fired once, a restart count off the faults, a /readyz that
    never flipped or did not come back, a launch count off the decode
    steps, or memory not bounded across the restarts."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.inference import failpoints
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB, hang_timeout_s=HANG_TIMEOUT_S,
                          trace_buffer=1 << 17, device="cuda")
    engines = []
    build = srv._decoder_factory

    def factory():  # every engine the supervisor builds, for its counts
        engines.append(build())
        return engines[-1]
    srv._decoder_factory = factory
    n_attn = sum(type(i).__name__ == "SelfAttentionLayerImpl"
                 for i in srv.net._impls.values())
    # the baseline leaves out what earlier phases left for the collector
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    srv.start()
    torch.cuda.synchronize()
    footprint = torch.cuda.memory_allocated() - mem0
    sup = srv.supervisor
    out = {"engine_footprint_bytes": footprint, "faults": []}
    stop_side = threading.Event()
    side = {"predict": [], "readyz": []}
    x = np.eye(VOCAB, dtype=np.float32)[
        np.random.default_rng(5).integers(0, VOCAB, (1, 64))]
    body = json.dumps({"data": x.tolist()}).encode()

    def predict_loop():
        while not stop_side.is_set():
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                side["predict"].append(
                    np.asarray(json.loads(r.read())["predictions"]))

    def readyz_loop():
        while not stop_side.is_set():
            side["readyz"].append((time.monotonic(),
                                   get_code(srv.port, "/readyz")))
            time.sleep(0.01)

    threads = [threading.Thread(target=predict_loop, daemon=True),
               threading.Thread(target=readyz_loop, daemon=True)]
    try:
        post(srv.port, {"prompt": reqs[0]["prompt"][:CHUNK + 3],
                        "max_new_tokens": 4})
        with ThreadPoolExecutor(len(reqs)) as ex:
            base = [o["tokens"] for o in ex.map(
                lambda b: post(srv.port, b), reqs)]
        if base != want:
            raise SystemExit("phase 17: the no-fault run differs from "
                             "phase 3's tokens")
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        ck.reset_launches()
        first = len(engines) - 1
        engines[-1].reset_counters()
        trig = srv.metrics.counter("failpoint_triggers_total")
        for seam, spec in CHAOS_FAULTS:
            r0, t0_trig = sup.restarts, trig.value
            n_ready = len(side["readyz"])
            t0 = time.monotonic()
            failpoints.arm(seam, spec)
            try:
                with ThreadPoolExecutor(len(reqs)) as ex:
                    res = list(ex.map(lambda b: post_retry(srv.port, b),
                                      reqs))
            finally:
                failpoints.disarm()
            wall = time.monotonic() - t0
            while not srv.ready()[0] and time.monotonic() - t0 < 120:
                time.sleep(0.01)
            time.sleep(0.05)  # one more /readyz sample after recovery
            codes = [c for _, c in side["readyz"][n_ready:]]
            toks = [o["tokens"] for o, _ in res]
            f = {"seam": seam, "spec": spec, "wall_s": wall,
                 "fired": trig.value - t0_trig,
                 "restarts": sup.restarts - r0,
                 "recovery_s": sup.recovery_seconds[r0:],
                 "retries": [o.get("retries", 0) for o, _ in res],
                 "client_attempts": [a for _, a in res],
                 "rebuilt_warmup_s": engines[-1].warmup_seconds,
                 "readyz_503": codes.count(503), "readyz_last": codes[-1:],
                 "identical": toks == want}
            out["faults"].append(f)
            bad = []
            if toks != want:
                bad.append("tokens differ from the no-fault run")
            if f["fired"] != 1 or f["restarts"] != f["fired"]:
                bad.append(f"fired {f['fired']}, restarts {f['restarts']}")
            if not (f["readyz_503"] and f["readyz_last"] == [200]):
                bad.append(f"/readyz never went 503 or did not come back "
                           f"({f['readyz_503']} 503s, last {codes[-1:]})")
            if not any(f["retries"]):
                bad.append("no request reports surviving the restart")
            if bad:
                raise SystemExit(f"phase 17 ({seam} {spec}): "
                                 + "; ".join(bad) + f" {f}")
        for e in engines[:-1]:  # a hung engine's thread exits on waking
            if e._thread is not None:
                e._thread.join(timeout=30)
        stop_side.set()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        steps = sum(e.decode_steps for e in engines[first:])
        launches = ck.LAUNCHES["paged_decode_attention"]
        dups = {k: n for k, n in finish_counts(srv.tracer).items() if n > 1}
        preds = side["predict"]
        out.update(
            memory_allocated_before=mem_before,
            memory_allocated_after=mem_after,
            engines_built=len(engines), decode_steps=steps,
            launches=launches, duplicated_finishes=dups,
            predict_posts=len(preds),
            predict_max_diff=max((float(np.abs(p - preds[0]).max())
                                  for p in preds), default=None),
            restarts_total=srv.metrics.counter(
                "engine_restarts_total").value,
            modes=sorted({(str(e.device), e.paged_kernel, e.decode_graphs)
                          for e in engines}))
        bad = []
        if dups:
            bad.append(f"requests finished twice: {dups}")
        if launches != n_attn * steps or launches <= 0:
            bad.append(f"paged launches {launches} != {n_attn} x {steps} "
                       "decode steps")
        if mem_after - mem_before > footprint:
            bad.append(f"memory grew {mem_after - mem_before} B across the "
                       f"restarts, past one engine's {footprint} B")
        if out["modes"] != [("cuda:0", "on", "on")]:
            bad.append(f"a rebuilt engine changed modes: {out['modes']}")
        if not preds or not all(np.isfinite(p).all() and p.shape
                                == (1, 64, VOCAB) for p in preds) \
                or out["predict_max_diff"] > 1e-5:
            bad.append(f"/predict during the drill: {len(preds)} posts, "
                       f"max diff {out['predict_max_diff']}")
        if bad:
            raise SystemExit("phase 17: " + "; ".join(bad))
        # -- 18. a draining restart with every request in flight ----------
        old = srv.decoder
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(post, srv.port, b) for b in reqs]
            while old.inflight() < len(reqs) and time.monotonic() - t0 < 60:
                time.sleep(0.002)
            inflight = old.inflight()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/admin/drain", data=b"{}",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                code = r.status
            toks = [f.result()["tokens"] for f in futs]
        while (srv.decoder is old or not srv.ready()[0]) \
                and time.monotonic() - t0 < 120:
            time.sleep(0.01)
        out["drain"] = {"inflight_at_drain": inflight, "answer": code,
                        "identical": toks == want,
                        "swapped": srv.decoder is not old,
                        "ready_after": srv.ready()[0],
                        "wall_s": time.monotonic() - t0}
        if not (code == 202 and toks == want and srv.decoder is not old
                and srv.ready()[0] and inflight == len(reqs)):
            raise SystemExit(f"phase 18: {out['drain']}")
    finally:
        stop_side.set()
        failpoints.disarm()
        srv.stop()
    return out


def predict_run(ck, torch):
    """Phase 19: AlexNet-CIFAR10 at full width from a zip behind /predict
    (micro-batched), PREDICT_POSTS concurrent single-row posts. Returns
    the figures; raises when an answer is off the net's plain-version
    output by more than 1e-4 or the conv launches are not 3 per
    dispatched batch."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import helpers
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    x = np.random.default_rng(19).normal(
        size=(PREDICT_POSTS, 32, 32, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alexnet.zip")
        write_model(MultiLayerNetwork(alexnet_cifar10(), device="cuda")
                    .init(), path)
        srv = InferenceServer(model_path=path, device="cuda").start()
    try:
        def one(i):
            body = json.dumps({"data": x[i:i + 1].tolist()}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            with urllib.request.urlopen(req, timeout=300) as r:
                pred = json.loads(r.read())["predictions"][0]
            return pred, time.monotonic() - t0
        one(0)  # the first forward's one-off costs stay out of the run
        batches = srv.metrics.counter("predict_batches_total")
        b0 = batches.value
        ck.reset_launches()
        t0 = time.monotonic()
        with ThreadPoolExecutor(PREDICT_POSTS) as ex:
            res = list(ex.map(one, range(PREDICT_POSTS)))
        wall = time.monotonic() - t0
        launches = dict(ck.LAUNCHES)
        n_batches = batches.value - b0
        snap = srv.metrics.snapshot()["histograms"]
        for name, fn in helpers.PLAIN_OVERRIDES.items():
            helpers.register_helper(name, fn)
        try:
            plain = srv.net.output(x).cpu().numpy()
        finally:
            for name in helpers.PLAIN_OVERRIDES:
                helpers.register_helper(name, None)
    finally:
        srv.stop()
    got = np.asarray([p for p, _ in res])
    lat = [t * 1e3 for _, t in res]
    st = {"posts": PREDICT_POSTS, "wall_s": wall,
          "batches": n_batches, "launches": launches,
          "max_abs_err": float(np.abs(got - plain).max()),
          "occupancy_mean": snap["predict_batch_occupancy"]["mean"],
          "server_latency_p50_ms": 1e3 * snap["predict_latency_sec"]["p50"],
          "server_latency_p99_ms": 1e3 * snap["predict_latency_sec"]["p99"],
          "client_latency_p50_ms": float(np.percentile(lat, 50)),
          "client_latency_p99_ms": float(np.percentile(lat, 99))}
    if not (st["max_abs_err"] <= 1e-4 and np.isfinite(got).all()
            and launches["conv2d_bias_act"] == 3 * n_batches > 0):
        raise SystemExit(f"phase 19: {st}")
    return st


def serve_waves(ck, kw, pool_mb, waves, *, stagger=0.0, profiled=False):
    """A fresh InferenceServer (``kw`` and a ``pool_mb`` MiB pool; its
    start() runs warmup(), which captures the decode steps) serves one
    short warm-up request, then each wave in turn, every request of a
    wave posted at once (body i after i * ``stagger`` s). Returns per wave
    its tokens and counts; the launch and engine counts start at 0 with
    each wave. ``profiled``: the last wave runs under torch.profiler (CUDA
    activity only, so the host pays little for it), and its counts carry
    the device's busy ms and share. Raises when a wave's launches are not
    4 layers x its decode steps, or when a capture happened after
    warmup() or past one per table bucket."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(kv_pool_mb=pool_mb, **kw).start()
    out = []
    try:
        dec = srv.decoder
        warm = warm_counts(dec)
        post(srv.port, {"prompt": waves[0][0]["prompt"][:CHUNK + 3],
                        "max_new_tokens": 4})
        for w, bodies in enumerate(waves):
            ck.reset_launches()
            dec.reset_counters()
            before = dict(dec.pool.stats()["prefix"])
            prof = profile(activities=[ProfilerActivity.CUDA]) \
                if profiled and w == len(waves) - 1 else None
            with prof if prof is not None else contextlib.nullcontext():
                t0 = time.monotonic()
                outs = post_all(srv.port, bodies, stagger)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            after = dec.pool.stats()["prefix"]
            n_tok = sum(len(o["tokens"]) for o in outs)
            st = {"wall_s": wall, "tokens": n_tok,
                  "tokens_per_s": n_tok / wall,
                  "decode_steps": dec.decode_steps,
                  "prefill_chunks": dec.prefill_chunks,
                  "prefill_chunks_cold": sum(-(-len(b["prompt"]) // CHUNK)
                                             for b in bodies),
                  "restored_tokens": dec.restored_tokens,
                  "cow_copies": dec.cow_copies,
                  "preemptions": dec.preemptions,
                  "hits": after["hits"] - before["hits"],
                  "hit_blocks": after["hit_blocks"] - before["hit_blocks"],
                  "launches": ck.LAUNCHES["paged_decode_attention"],
                  "outstanding_refs": dec.pool.outstanding_refs(),
                  "capacity_blocks": dec.pool.capacity_blocks,
                  "bytes_per_block": dec.pool.bytes_per_block,
                  "mean_decode_step_ms": 1e3 * dec.decode_seconds
                  / max(dec.decode_steps, 1),
                  **engine_stats(srv, dec, warm)}
            if prof is not None:
                busy = sum(device_kernels_ms(prof).values())
                st.update(device_busy_ms=busy,
                          device_busy_share=busy / (wall * 1e3))
            out.append(([o["tokens"] for o in outs], st))
        net = srv.net
    finally:
        srv.stop()
    n_attn = sum(type(i).__name__ == "SelfAttentionLayerImpl"
                 for i in net._impls.values())
    for w, (_, st) in enumerate(out):
        if st["launches"] <= 0 or st["launches"] != n_attn * st["decode_steps"]:
            raise SystemExit(f"wave {w}: launch count {st['launches']} != "
                             f"{n_attn} attention layers x "
                             f"{st['decode_steps']} decode steps")
        capture_gate(st)
    return out, net


def warm_counts(dec):
    """The engine's captures right after the server's warmup()."""
    return {"warmup_captures": dec.decode_captures,
            "warmup_prefill_captures": dec.prefill_captures}


def engine_stats(srv, dec, warm):
    """The captures, the chunk host reads and the supervisor's restarts of
    a serving run (the counts since the last reset_counters())."""
    return {**warm, "decode_graphs": dec.decode_graphs,
            "captures": dec.decode_captures,
            "prefill_captures": dec.prefill_captures,
            "table_buckets": len(dec.table_buckets) or 1,
            "chunk_buckets": len(dec.prefill_buckets),
            "prefill_chunks": dec.prefill_chunks,
            "final_chunks": dec.final_chunks,
            "chunk_row_reads": dec.chunk_row_reads,
            "warmup_s": dec.warmup_seconds,
            "restarts": srv.supervisor.restarts}


def graph_pool_bytes(dec):
    """Bytes of the device memory segments of the engine's CUDA graph
    pool (its captured steps' and chunks' private pool)."""
    import torch
    pool = dec._graph_pool
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def capture_gate(st):
    """The capture budget: a captured server makes one decode capture per
    table bucket and one prefill chunk capture per (chunk bucket, table
    bucket), all in warmup(); an eager one none. Every chunk's host read
    is a final chunk's row (non-final chunks read nothing back), and no
    serving phase restarted its engine (a recovery would hide a fault)."""
    on = st["decode_graphs"] == "on"
    want = st["table_buckets"] if on else 0
    want_p = st["chunk_buckets"] * st["table_buckets"] if on else 0
    if not (st["warmup_captures"] == st["captures"] == want
            and st["warmup_prefill_captures"] == st["prefill_captures"]
            == want_p):
        raise SystemExit(f"captures: decode {st['captures']} (after warmup "
                         f"{st['warmup_captures']}), want {want}; prefill "
                         f"{st['prefill_captures']} (after warmup "
                         f"{st['warmup_prefill_captures']}), want {want_p} "
                         f"({st['table_buckets']} table buckets, "
                         f"{st['chunk_buckets']} chunk buckets, graphs "
                         f"{st['decode_graphs']})")
    if not (st["chunk_row_reads"] == st["final_chunks"]
            and 0 < st["final_chunks"] < st["prefill_chunks"]):
        raise SystemExit(f"chunk host reads {st['chunk_row_reads']} for "
                         f"{st['final_chunks']} final of "
                         f"{st['prefill_chunks']} chunks: want one per "
                         "final chunk and none for the others")
    if st["restarts"]:
        raise SystemExit(f"the engine restarted {st['restarts']} times in a "
                         "serving phase")


def prefix_run(ck, model_path, reqs, wave2, kv_dtype):
    """Phase 8 at one page dtype. A server on phase 3's pool serves the
    first wave (its prompts' full blocks are published to the prefix
    trie), then ``wave2``, timed; a second server serves ``wave2`` cold,
    timed; a third serves both waves again, the second under the profiler.
    Then servers whose pools are cut to PREEMPT_CUTS of the first wave's
    peak block need serve the first wave again, posted in order, until one
    preempts. Returns the tokens of every wave served, their counts and
    the first server's net."""
    from deeplearning4j_tpu_torch.inference.kvpool import blocks_for
    kw = dict(model_path=model_path, decode_slots=SLOTS, prefill_chunk=CHUNK,
              kv_block=KV_BLOCK, kv_dtype=kv_dtype, paged_kernel="on",
              device="cuda")
    out, net = serve_waves(ck, kw, KV_POOL_MB, [reqs, wave2])
    (w1, _), (w2, warm) = out
    [(w2_cold, cold)], _ = serve_waves(ck, kw, KV_POOL_MB, [wave2])
    [_, (w2_prof, prof)], _ = serve_waves(ck, kw, KV_POOL_MB, [reqs, wave2],
                                          profiled=True)
    [(w1_eager, _), (w2_eager, eager)], _ = serve_waves(
        ck, dict(kw, decode_graphs="off"), KV_POOL_MB, [reqs, wave2],
        profiled=True)
    peak = sum(blocks_for(len(b["prompt"]) + NEW_TOKENS - 1, KV_BLOCK)
               for b in reqs)
    for cut in PREEMPT_CUTS:
        cap = round(peak * cut)
        [(rerun, pre)], _ = serve_waves(
            ck, kw, (cap + 1) * warm["bytes_per_block"] / (1 << 20), [reqs],
            stagger=PREEMPT_STAGGER_S)
        pre.update(cut=cut, peak_blocks=peak)
        if pre["preemptions"]:
            break
    return ({"wave1": w1, "wave2": w2, "wave2_cold": w2_cold,
             "wave2_profiled": w2_prof, "rerun": rerun, "wave1_eager": w1_eager,
             "wave2_eager": w2_eager},
            {"wave2": warm, "wave2_cold": cold, "wave2_profiled": prof,
             "rerun": pre, "wave2_eager": eager}, net)


def serve_run(ck, model_path, reqs, kv_dtype, graphs="on", guard=None):
    """8 concurrent /generate through a fresh supervised server
    (``graphs``: its decode_graphs, for the step and the chunks;
    ``guard``: its decode_transfer_guard); returns (tokens, stats) with
    the launch count of exactly this run, the chunk and TTFT figures, the
    warmup seconds and the graph pool's bytes."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB, kv_dtype=kv_dtype,
                          paged_kernel="on", decode_graphs=graphs,
                          decode_transfer_guard=guard,
                          device="cuda").start()
    try:
        dec = srv.decoder
        warm = warm_counts(dec)
        pool_bytes = graph_pool_bytes(dec)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
            assert r.status == 200
        # one short request first, so the timed run holds no one-off
        # start-up cost (cuBLAS handles, the allocator's first blocks)
        post(srv.port, {"prompt": reqs[0]["prompt"][:CHUNK + 3],
                        "max_new_tokens": 4})
        ck.reset_launches()
        dec.reset_counters()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(reqs)) as ex:
            outs = list(ex.map(lambda b: post(srv.port, b), reqs))
        wall = time.monotonic() - t0
        launches = ck.LAUNCHES["paged_decode_attention"]
        flash_launches = ck.LAUNCHES["flash_attention_fwd"]
        ttft = [o["timings"]["queue_ms"] + o["timings"]["restore_ms"]
                + o["timings"]["prefill_ms"] for o in outs]
        crashes = sum(e["name"] in ("engine_crash", "engine_hang")
                      for e in srv.tracer.events())
        stats = {"launches": launches, "decode_steps": dec.decode_steps,
                 "flash_fwd_launches": flash_launches,
                 "tokens": sum(len(o["tokens"]) for o in outs),
                 "wall_s": wall,
                 "tokens_per_s": sum(len(o["tokens"]) for o in outs) / wall,
                 "mean_decode_step_ms": 1e3 * dec.decode_seconds
                 / max(dec.decode_steps, 1),
                 "decode_s": dec.decode_seconds,
                 "prefill_s": dec.prefill_seconds,
                 "mean_prefill_chunk_ms": 1e3 * dec.prefill_seconds
                 / max(dec.prefill_chunks, 1),
                 "ttft_ms": ttft,
                 "ttft_p50_ms": float(np.percentile(ttft, 50)),
                 "ttft_p99_ms": float(np.percentile(ttft, 99)),
                 "capacity_blocks": dec.pool.capacity_blocks,
                 "graph_pool_bytes": pool_bytes,
                 "transfer_guard": guard, "engine_crash_records": crashes,
                 **engine_stats(srv, dec, warm)}
        net = srv.net
    finally:
        srv.stop()
    n_attn = sum(type(i).__name__ == "SelfAttentionLayerImpl"
                 for i in net._impls.values())
    if launches <= 0 or launches != n_attn * stats["decode_steps"]:
        raise SystemExit(f"launch count {launches} != {n_attn} attention "
                         f"layers x {stats['decode_steps']} decode steps")
    if flash_launches:
        raise SystemExit(f"the decode engine launched the full-sequence "
                         f"attention kernel {flash_launches} times")
    capture_gate(stats)
    if crashes:
        raise SystemExit(f"{crashes} engine crash records in a serving run")
    return [o["tokens"] for o in outs], stats, net


def contiguous_run(ck, model_path, waves):
    """Phase 14: a supervised server in contiguous mode (no kv_pool_mb:
    per-slot stripes of the model's max_cache_len, a PREFIX_CACHE_MB side
    prefix pool; start() captures the one decode step and one prefill
    chunk per chunk bucket) serves each wave in turn. Returns the tokens
    and counts of each wave (each gated as capture_gate does), the
    launches of the whole run, and the registry's text exposition."""
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          prefix_cache_mb=PREFIX_CACHE_MB,
                          device="cuda").start()
    out = []
    try:
        dec = srv.decoder
        info = srv.info()["decode"]
        warm = warm_counts(dec)
        ck.reset_launches()
        for bodies in waves:
            dec.reset_counters()
            before = dict(dec.pool.stats()["prefix"])
            t0 = time.monotonic()
            outs = post_all(srv.port, bodies)
            wall = time.monotonic() - t0
            after = dec.pool.stats()["prefix"]
            n_tok = sum(len(o["tokens"]) for o in outs)
            out.append(([o["tokens"] for o in outs], {
                "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
                "decode_steps": dec.decode_steps,
                "mean_decode_step_ms": 1e3 * dec.decode_seconds
                / max(dec.decode_steps, 1),
                "restored_tokens": dec.restored_tokens,
                "hits": after["hits"] - before["hits"],
                **engine_stats(srv, dec, warm)}))
            capture_gate(out[-1][1])
        return {"waves": out, "launches": dict(ck.LAUNCHES), "net": srv.net,
                **warm, "captures": dec.decode_captures,
                "prefill_captures": dec.prefill_captures,
                "graph_pool_bytes": graph_pool_bytes(dec),
                "kv_mode": info["kv_mode"],
                "cache_positions": dec._cache_cap,
                "pool_blocks": dec.pool.capacity_blocks,
                "outstanding_refs": dec.pool.outstanding_refs(),
                "metrics_text": srv.metrics.render_text()}
    finally:
        srv.stop()


def profile_run(net, reqs, kv_dtype=None, graphs="on"):
    """The serving run again, straight on a warmed DecodeScheduler (its
    decode_graphs ``graphs``), under torch.profiler: the device's busy
    share of the wall time and the kernels that take it, by device time,
    and the mean decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    eng = DecodeScheduler(net, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                          kv_block=KV_BLOCK, kv_pool_mb=KV_POOL_MB,
                          kv_dtype=kv_dtype, decode_graphs=graphs,
                          device="cuda")
    eng.warmup()
    eng.start()
    try:
        eng.generate(reqs[0]["prompt"][:CHUNK + 3], 4, timeout=900)
        eng.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            hs = [eng.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
                  for b in reqs]
            for h in hs:
                h.result(timeout=900)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        eng.stop()
    kernels = device_kernels_ms(prof)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    paged_ms = sum(ms for k, ms in kernels.items() if "paged_decode" in k)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "paged_kernel_ms": paged_ms, "decode_steps": eng.decode_steps,
            "decode_s": eng.decode_seconds, "prefill_s": eng.prefill_seconds,
            "mean_decode_step_ms": 1e3 * eng.decode_seconds
            / max(eng.decode_steps, 1),
            "prefill_chunks": eng.prefill_chunks,
            "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def device_kernels_ms(prof):
    """{kernel name: device ms} of a torch.profiler run."""
    from torch.autograd import DeviceType
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    return kernels


def bound(n_bytes, n_ops, flops_per_s=F32_FLOPS_PER_S):
    """(bound ms, "bytes" or "operations") at the H100's published rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tc_bound(r, key, n_ops, n_bytes):
    """Kernel ``key`` (the attention forwards, the dK/dV kernels, splash dQ)
    runs its products on the tensor cores in 3xTF32: three tf32 products
    for each f32 one, so its least time there is 3 x ``n_ops`` at 495
    TFLOP/s (or the bytes, if more). Adds it, and the kernel's share of
    each bound (bound / kernel ms), to ``r``."""
    r[key + "_tc_bound_ms"] = bound(n_bytes, 3 * n_ops, TF32_FLOPS_PER_S)[0]
    r[key + "_bound_share"] = r[key + "_bound_ms"] / r[key + "_ms"]
    r[key + "_tc_bound_share"] = r[key + "_tc_bound_ms"] / r[key + "_ms"]


def conv_case(ck, torch, flush, *, B, H, W, C, K, OC, stride, padding,
              act, seed, library):
    """The conv kernel against its plain version at one shape; with
    ``library``, also F.conv2d on channels-last (weights laid out once,
    outside the timing) with bias and the activation."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import activations
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g).to(dev)
    w = (torch.randn((K, K, C, OC), generator=g) / (K * K * C) ** 0.5).to(dev)
    b = (torch.randn((OC,), generator=g) * 0.1).to(dev)
    kw = dict(stride=stride, padding=padding, activation=act)
    got = ck.conv2d_bias_act(x, w, b, **kw)
    got2 = ck.conv2d_bias_act(x, w, b, **kw)
    want = ck.conv2d_bias_act_ref(x, w, b, **kw)
    torch.cuda.synchronize()
    oh, ow, pads = ck.conv_geometry(H, W, K, K, stride, padding)
    r = {"shape": [B, H, W, C, K, OC], "stride": list(stride),
         "pads": [list(p) for p in pads], "activation": act,
         "max_abs_err": float((got - want).abs().max()),
         "max_abs_plain": float(want.abs().max()),
         "repeat_bitwise": bool(torch.equal(got, got2)),
         "ms": time_ms(lambda: ck.conv2d_bias_act(x, w, b, **kw), flush=flush),
         "plain_ms": time_ms(lambda: ck.conv2d_bias_act_ref(x, w, b, **kw),
                             flush=flush),
         "library_ms": None}
    n_bytes = 4 * (x.numel() + w.numel() + b.numel() + B * oh * ow * OC)
    n_ops = 2 * B * oh * ow * OC * K * K * C
    r["bound_ms"], r["bound_by"] = bound(n_bytes, n_ops)
    # the kernel runs on the tensor cores in 3xTF32: three tf32 products
    # for each f32 one at 495 TFLOP/s (or the bytes, if more)
    r["tc_bound_ms"], r["tc_bound_by"] = bound(n_bytes, 3 * n_ops,
                                               TF32_FLOPS_PER_S)
    r["bound_share"] = r["bound_ms"] / r["ms"]
    r["tc_bound_share"] = r["tc_bound_ms"] / r["ms"]
    if library:
        act_fn = activations.get(act)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels-last NCHW
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pad = (pads[0][0], pads[1][0])

        def lib():
            return act_fn(F.conv2d(xc, wc, b, stride=stride, padding=pad))
        r["library_err"] = float((lib().permute(0, 2, 3, 1) - want).abs().max())
        r["library_ms"] = time_ms(lib, flush=flush)
    return r


def conv_seam_case(ck, torch, *, act, stride, seed):
    """The training seam helpers.conv2d_bias_act (the kernel's forward,
    then the saved-tensor backward) against the autograd of the plain
    default on the card at [4, 10, 9, 16] -> 24, 3x3 SAME: max |diff| /
    max |plain| of the output and of dx, dw, db; and the kernel launches
    of the forward and of the backward (1 and 0)."""
    from deeplearning4j_tpu_torch.ops import helpers
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, 10, 9, 16), generator=g).to(dev)
    w = (torch.randn((3, 3, 16, 24), generator=g) / 12.0).to(dev)
    b = (torch.randn((24,), generator=g) * 0.1).to(dev)
    kw = dict(stride=stride, padding="SAME", dilation=(1, 1),
              activation=act)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*ins, **kw)
        gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            seed + 1)).to(dev)
        n0 = ck.LAUNCHES["conv2d_bias_act"]
        (y * gy).sum().backward()
        torch.cuda.synchronize()
        return [y.detach()] + [t.grad for t in ins], \
            ck.LAUNCHES["conv2d_bias_act"] - n0
    n0 = ck.LAUNCHES["conv2d_bias_act"]
    got, bwd_launches = run(helpers.conv2d_bias_act)
    fwd_launches = ck.LAUNCHES["conv2d_bias_act"] - n0 - bwd_launches
    want, _ = run(helpers._conv2d_bias_act_default)
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(got, want)]
    return {"activation": act, "stride": list(stride),
            "rel_err_y_dx_dw_db": rel, "fwd_launches": fwd_launches,
            "bwd_launches": bwd_launches}


def bnap_case(ck, torch, flush, *, B, H, W, C, act, tied, seed):
    """The BN+act+pool backward's two kernels against their plain versions
    at one shape, from the forward's own batch stats; ``tied`` makes every
    2x2 window four equal values. The dx pass takes the plain sums, so it
    is held alone."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    if tied:
        x = torch.randn((B, H // 2, W // 2, C), generator=g)
        x = x.repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
    else:
        x = torch.randn((B, H, W, C), generator=g)
    x = x.to(dev)
    gp = torch.randn((B, H // 2, W // 2, C), generator=g).to(dev)
    gamma = (torch.rand((C,), generator=g) + 0.5).to(dev)
    beta = (torch.randn((C,), generator=g) * 0.1).to(dev)
    _, mean, _, inv = ck.bnap_forward_ref(x, gamma, beta, eps=1e-5,
                                          activation=act)
    p = torch.stack([mean, inv, gamma, beta]).contiguous()
    dg, db = ck.bnap_sums(x, gp, p, activation=act)
    dg2, db2 = ck.bnap_sums(x, gp, p, activation=act)
    rg, rb = ck.bnap_sums_ref(x, gp, p, activation=act)
    s = torch.stack([rb, rg]).contiguous()
    dx = ck.bnap_dx(x, gp, p, s, activation=act)
    rdx = ck.bnap_dx_ref(x, gp, p, s, activation=act)
    torch.cuda.synchronize()
    n_x, n_g = x.numel(), gp.numel()
    sums_bound = bound(4 * (n_x + n_g + 4 * C + 2 * C), 12 * n_x)
    dx_bound = bound(4 * (2 * n_x + n_g + 6 * C), 14 * n_x)
    return {
        "shape": [B, H, W, C], "activation": act, "tied": tied,
        "sums_max_abs_err": max(float((dg - rg).abs().max()),
                                float((db - rb).abs().max())),
        "sums_max_abs_plain": max(float(rg.abs().max()),
                                  float(rb.abs().max())),
        "sums_repeat_bitwise": bool(torch.equal(dg, dg2)
                                    and torch.equal(db, db2)),
        "dx_max_abs_err": float((dx - rdx).abs().max()),
        "sums_ms": time_ms(lambda: ck.bnap_sums(x, gp, p, activation=act),
                           flush=flush),
        "sums_plain_ms": time_ms(
            lambda: ck.bnap_sums_ref(x, gp, p, activation=act), flush=flush),
        "dx_ms": time_ms(lambda: ck.bnap_dx(x, gp, p, s, activation=act),
                         flush=flush),
        "dx_plain_ms": time_ms(
            lambda: ck.bnap_dx_ref(x, gp, p, s, activation=act), flush=flush),
        "sums_bound_ms": sums_bound[0], "sums_bound_by": sums_bound[1],
        "dx_bound_ms": dx_bound[0], "dx_bound_by": dx_bound[1]}


def train_run(ck, torch, conf, x, y, steps, *, plain=False):
    """``steps`` fit_batch steps of a fresh net from ``conf`` on one
    batch, each timed on the host clock up to its loss on the host.
    ``plain`` registers every training kernel's plain version instead
    (the caller's explicit override), and runs the steps eagerly
    (train_graphs="off": the reference is the plain PyTorch step); else
    each step after the first replays the captured step. Returns (net,
    losses, step seconds, launch counts of exactly these steps)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import helpers
    net = MultiLayerNetwork(conf, device="cuda",
                            train_graphs="off" if plain else "on").init()
    overrides = helpers.PLAIN_OVERRIDES if plain else {}
    for name, fn in overrides.items():
        helpers.register_helper(name, fn)
    try:
        torch.cuda.synchronize()
        ck.reset_launches()
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.monotonic()
            net.fit_batch(x, y)
            losses.append(net.score_)
            secs.append(time.monotonic() - t0)
        launches = dict(ck.LAUNCHES)
    finally:
        for name in overrides:
            helpers.register_helper(name, None)
    if not all(l == l and abs(l) != float("inf") for l in losses):
        raise SystemExit(f"non-finite training loss: {losses}")
    return net, losses, secs, launches


def grad_check(torch, net, x, y, overrides):
    """One compute_gradient_and_score through the kernels and one through
    ``overrides`` (plain versions registered by the caller), on the net's
    current params and the same dropout generator state: (relative loss
    difference, {leaf: ||g_kernel - g_plain|| / ||g_plain||}). The bias of
    a layer that feeds a BatchNormalization has an exact gradient of zero
    (the BN subtracts the batch mean), so both runs hold only rounding
    there: such a leaf is measured against its layer's whole gradient."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.ops import helpers
    state = net._gen.get_state()
    lk, gk, _ = net.compute_gradient_and_score(x, y)
    net._gen.set_state(state)
    for name, fn in overrides.items():
        helpers.register_helper(name, fn)
    try:
        lp, gp, _ = net.compute_gradient_and_score(x, y)
    finally:
        for name in overrides:
            helpers.register_helper(name, None)
    layers = net.conf.layers
    rel = {}
    for i, (a, b) in enumerate(zip(gk, gp)):
        whole = torch.cat([t.flatten() for t in b.values()]).norm() \
            if b else None
        for k in a:
            zero = (k == "b" and i + 1 < len(layers)
                    and isinstance(layers[i + 1], BatchNormalization))
            rel[f"{i}.{k}"] = float((a[k] - b[k]).norm() / (
                whole if zero else b[k].norm()).clamp_min(1e-30))
    return float((lk - lp).abs() / lp.abs()), rel


def recording_seam(torch, helpers, name, fn, seen):
    """An override of the seam ``name`` that keeps its inputs (detached)
    in ``seen`` and runs ``fn``, or the seam's own path where ``fn`` is
    None (the override steps aside for the call)."""
    def rec(*args, **kw):
        seen.append(([a.detach() if torch.is_tensor(a) else a
                      for a in args], dict(kw)))
        if fn is not None:
            return fn(*args, **kw)
        helpers.register_helper(name, None)
        try:
            return getattr(helpers, name)(*args, **kw)
        finally:
            helpers.register_helper(name, rec)
    return rec


def pool_flips(torch, seen_a, seen_b):
    """For each bn_act_pool call recorded in two runs: the 2x2 windows
    whose max is another element, or whose max changes sign, between
    the runs' inputs (act(BN(x)) recomputed alike from each)."""
    from deeplearning4j_tpu_torch.ops import activations

    def choice(args, kw):
        x, gamma, beta = args[:3]
        mean = x.mean((0, 1, 2))
        var = x.var((0, 1, 2), unbiased=False)
        z = activations.get(kw.get("activation", "relu"))(
            (x - mean) * torch.rsqrt(var + kw.get("eps", 1e-5)) * gamma
            + beta)
        B, H, W, C = z.shape
        m, a = z.view(B, H // 2, 2, W // 2, 2, C).permute(
            0, 1, 3, 5, 2, 4).reshape(B, H // 2, W // 2, C, 4).max(-1)
        return a, m > 0

    flips = []
    for (xa, ka), (xb, kb) in zip(seen_a, seen_b):
        (aa, sa), (ab, sb) = choice(xa, ka), choice(xb, kb)
        flips.append(int(((aa != ab) | (sa != sb)).sum()))
    return flips


def pinned_conv_plain(torch, helpers, errs):
    """The conv seam's plain version (autograd through F.conv2d) whose
    forward VALUE is the kernel's output on the same inputs, bit for bit:
    the layers after it see the kernel run's bits, so no near-tied max or
    relu sign can flip, and the gradients differ by the backward passes
    alone. Appends max |y_kernel - y_plain| / max |y_plain| of each call
    to ``errs``."""
    class Pin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, plain, kernel):
            return kernel.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None

    def conv(x, w, b, **kw):
        yp = helpers.conv2d_bias_act_plain(x, w, b, **kw)
        helpers.register_helper("conv2d_bias_act", None)
        try:
            with torch.no_grad():
                yk = helpers.conv2d_bias_act(x, w, b, **kw)
        finally:
            helpers.register_helper("conv2d_bias_act", conv)
        d = yp.detach()
        errs.append(float((yk - d).abs().max()
                          / d.abs().max().clamp_min(1e-30)))
        return Pin.apply(yp, yk)
    return conv


def alexnet_grad_checks(torch, net, x, y):
    """Phase 6's gradients of one step on the net's params and dropout
    masks, through the kernels against three plain runs:
    (a) only bn_act_pool plain: the forward is the same bits, so the
        gradients differ by the sums' order alone;
    (b) every kernel plain: the conv outputs round apart, and a 2x2 max
        that is tied within that rounding, or a relu sign at 0, then
        routes a whole gradient element elsewhere and moves leaves well
        past rounding, by another amount each run, so only the loss is
        gated; the windows are counted per BN+pool layer;
    (c) every kernel plain on the kernel's conv outputs (pinned_conv_plain):
        each conv's output against the kernel's on the training path's
        own inputs, and every gradient with no window able to flip.
    Returns the figures and the failed gates."""
    from deeplearning4j_tpu_torch.ops import helpers
    out, failed = {}, []
    loss, rel = grad_check(torch, net, x, y,
                           {"bn_act_pool": helpers.bn_act_pool_plain})
    out["bnap_plain"] = {"loss_rel": loss, "leaf_rel": rel}
    if not (loss <= 1e-6 and max(rel.values()) <= 1e-4):
        failed.append("with bn_act_pool plain")
    seen_k, seen_p = [], []
    kernel_side = recording_seam(torch, helpers, "bn_act_pool", None,
                                 seen_k)
    helpers.register_helper("bn_act_pool", kernel_side)
    try:
        state = net._gen.get_state()
        lk, _, _ = net.compute_gradient_and_score(x, y)
        net._gen.set_state(state)
    finally:
        helpers.register_helper("bn_act_pool", None)
    loss, rel = grad_check(torch, net, x, y, {
        **helpers.PLAIN_OVERRIDES,
        "bn_act_pool": recording_seam(torch, helpers, "bn_act_pool",
                                      helpers.bn_act_pool_plain, seen_p)})
    out["all_plain"] = {"loss_rel": loss, "leaf_rel": rel,
                        "flipped_windows": pool_flips(torch, seen_k,
                                                      seen_p)}
    del seen_k, seen_p
    if not loss <= 1e-5:
        failed.append("with every kernel plain")
    errs = []
    loss, rel = grad_check(torch, net, x, y, {
        **helpers.PLAIN_OVERRIDES,
        "conv2d_bias_act": pinned_conv_plain(torch, helpers, errs)})
    out["pinned_plain"] = {"conv_rel": errs, "loss_rel": loss,
                           "leaf_rel": rel}
    if not (errs and max(errs) <= 1e-4 and loss <= 1e-6
            and max(rel.values()) <= 1e-4):
        failed.append("with every kernel plain on the kernel's conv outputs")
    return out, failed


def grad_checks_line(g):
    """alexnet_grad_checks' figures as one line, each beside its gate."""
    def worst(run):
        k, v = max(g[run]["leaf_rel"].items(), key=lambda kv: kv[1])
        return f"worst leaf {k} {v:.3e}"
    a, p = g["all_plain"], g["pinned_plain"]
    return (f"with bn_act_pool plain, loss rel diff "
            f"{g['bnap_plain']['loss_rel']:.3e} (gate 1e-6), "
            f"{worst('bnap_plain')} ||diff||/||plain|| (gate 1e-4); with "
            f"every kernel plain, loss {a['loss_rel']:.3e} (gate 1e-5), "
            f"{worst('all_plain')} (not gated: 2x2 windows whose max or its "
            f"sign moved, by BN+pool layer, {a['flipped_windows']}); with "
            f"every kernel plain on the kernel's conv outputs, conv "
            f"max|diff|/max|plain| {[f'{e:.3e}' for e in p['conv_rel']]} "
            f"(gate 1e-4), loss {p['loss_rel']:.3e} (gate 1e-6), "
            f"{worst('pinned_plain')} (gate 1e-4)")


def train_profile(torch, net, x, y, steps):
    """``steps`` more steps under torch.profiler: the device's busy share
    of the wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            net.fit_batch(x, y)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = device_kernels_ms(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(ms for n, ms in kernels.items() if k in n)
            for k in ("conv2d_bias_act", "bnap_sums", "bnap_dx")}
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3), "kernels_ms": ours,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def flash_bound(B, L, H, D, causal):
    """(pairs, bytes of one [B, L, H, D] f32 tensor, of one [B, H, L]
    one): the (query, key) pairs this run's mask keeps, and the sizes the
    byte bounds count."""
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    return pairs, 4 * B * L * H * D, 4 * B * H * L


def flash_case(ck, torch, flush, *, B, L, H, D, causal, seed, library):
    """The three flash kernels against their plain versions at one shape.
    The backward kernels take the plain forward's lse and o (di = sum_d o
    * dO), so each kernel is held alone. Errors are max |diff| over max
    |plain|: of o, of lse, and of each gradient over the largest of the
    three plain gradients (at L=1, dq and dk are 0 up to rounding).
    With ``library``, F.scaled_dot_product_attention on [B, H, L, D]
    views of the same tensors, forward and forward+backward."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import splash_mask
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g).to(dev)
                   for _ in range(4))
    kw = dict(causal=causal, scale=D ** -0.5)
    o, lse = ck.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = ck.flash_attention_fwd_ref(q, k, v, **kw)
    di = (ro * do).sum(dim=-1).permute(0, 2, 1).contiguous()
    bwd = (q, k, v, do, rlse, di)
    dk, dv = ck.flash_attention_bwd_dkv(*bwd, **kw)
    dq = ck.flash_attention_bwd_dq(*bwd, **kw)
    dk2, dv2 = ck.flash_attention_bwd_dkv(*bwd, **kw)
    dq2 = ck.flash_attention_bwd_dq(*bwd, **kw)
    rdk, rdv = ck.flash_attention_bwd_dkv_ref(*bwd, **kw)
    rdq = ck.flash_attention_bwd_dq_ref(*bwd, **kw)
    torch.cuda.synchronize()
    gscale = max(float(t.abs().max()) for t in (rdq, rdk, rdv))

    def err(a, b, scale=None):
        return float((a - b).abs().max()) / (
            scale if scale is not None else float(b.abs().max()))
    r = {"shape": [B, L, H, D], "causal": causal,
         "rel_err": {"o": err(o, ro), "lse": err(lse, rlse),
                     "dq": err(dq, rdq, gscale), "dk": err(dk, rdk, gscale),
                     "dv": err(dv, rdv, gscale)},
         "max_abs_err": {"o": float((o - ro).abs().max()),
                         "dkv": max(float((dk - rdk).abs().max()),
                                    float((dv - rdv).abs().max())),
                         "dq": float((dq - rdq).abs().max())},
         "repeat_bitwise": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                                and torch.equal(dq, dq2)),
         "finite": bool(all(torch.isfinite(t).all()
                            for t in (o, lse, dq, dk, dv)))}
    del o, lse, dk, dv, dq, dk2, dv2, dq2, rdk, rdv, rdq
    reps = 10 if L >= 4096 else 25
    for name, fn in (
            ("fwd", lambda: ck.flash_attention_fwd(q, k, v, **kw)),
            ("dkv", lambda: ck.flash_attention_bwd_dkv(*bwd, **kw)),
            ("dq", lambda: ck.flash_attention_bwd_dq(*bwd, **kw))):
        r[name + "_ms"] = time_ms(fn, reps=reps, flush=flush)
    for name, fn in (
            ("fwd", lambda: ck.flash_attention_fwd_ref(q, k, v, **kw)),
            ("dkv", lambda: ck.flash_attention_bwd_dkv_ref(*bwd, **kw)),
            ("dq", lambda: ck.flash_attention_bwd_dq_ref(*bwd, **kw))):
        r[name + "_plain_ms"] = time_ms(fn, reps=reps, flush=flush)
    # least work (f32 operations of this run's mask, 2 per multiply-add):
    # the forward's two products, q k^T and p v; the dK/dV kernel's four
    # (s recomputed, dO v^T, p^T dO, ds^T q); the dQ kernel's three
    pairs, big, small = flash_bound(B, L, H, D, causal)
    for name, n_ops, n_bytes in (
            ("fwd", 4 * D * pairs, 4 * big + small),
            ("dkv", 8 * D * pairs, 6 * big + 2 * small),
            ("dq", 6 * D * pairs, 5 * big + 2 * small)):
        r[name + "_bound_ms"], r[name + "_bound_by"] = bound(n_bytes, n_ops)
    tc_bound(r, "fwd", 4 * D * pairs, 4 * big + small)
    tc_bound(r, "dkv", 8 * D * pairs, 6 * big + 2 * small)
    tc_bound(r, "dq", 6 * D * pairs, 5 * big + 2 * small)
    r["sdpa_fwd_ms"] = r["sdpa_fwd_bwd_ms"] = r["fwd_splash_ms"] = None
    if library and L % splash_mask.BLOCK == 0:
        # the splash forward (the same core) at this shape, on q pre-scaled
        tb = splash_mask.splash_tables(L, H, causal)
        qs = q * kw["scale"]
        so, slse = ck.splash_attention_fwd(qs, k, v, tb)
        r["fwd_splash_vs_plain"] = max(err(so, ro), err(slse, rlse))
        del so, slse
        r["fwd_splash_ms"] = time_ms(
            lambda: ck.splash_attention_fwd(qs, k, v, tb), reps=reps,
            flush=flush)
        del qs
    if library:
        qt, kt, vt = (t.transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  scale=kw["scale"])

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
        with torch.no_grad():
            r["sdpa_rel_err"] = err(sdpa().transpose(1, 2), ro)
            r["sdpa_fwd_ms"] = time_ms(sdpa, reps=reps, flush=flush)
        r["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, reps=reps, flush=flush)
    return r


def attention_seam_case(ck, torch, seed):
    """The training seam helpers.attention (the forward kernel, then the
    two backward kernels under autograd) against the autograd of the
    dense default on the card at [2, 100, 4, 64], causal: max |diff| /
    max |plain| of the output and of dq, dk, dv; and the launches of each
    kernel in the forward and in the backward."""
    from deeplearning4j_tpu_torch.ops import helpers
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    ins = [torch.randn((2, 100, 4, 64), generator=g).to(dev)
           for _ in range(3)]
    gy = torch.randn((2, 100, 4, 64), generator=g).to(dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        n0 = dict(ck.LAUNCHES)
        y = fn(*leaves, causal=True)
        n1 = dict(ck.LAUNCHES)
        (y * gy).sum().backward()
        torch.cuda.synchronize()
        fwd = {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]}
        bwd = {k: ck.LAUNCHES[k] - n1[k] for k in n1
               if ck.LAUNCHES[k] != n1[k]}
        return [y.detach()] + [t.grad for t in leaves], fwd, bwd
    got, fwd, bwd = run(helpers.attention)
    want, _, _ = run(helpers._attention_default)
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in
           zip(got, want)]
    return {"rel_err_y_dq_dk_dv": rel, "fwd_launches": fwd,
            "bwd_launches": bwd}


def lm_batch(torch, T, B, seed=0):
    """Seeded one-hot next-token pairs [B, T, vocab] (bench.py _lm_onehot)."""
    import numpy as np
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, T + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return (torch.from_numpy(eye[ids[:, :-1]]).cuda(),
            torch.from_numpy(eye[ids[:, 1:]]).cuda())


def lm_net(heads, *, remat=False, dtype="float32", compute_dtype=None,
           train_graphs="on"):
    """A fresh transformer_lm graph on the card: vocab 128, d_model 512,
    ``heads`` heads, 4 blocks, Adam 3e-4, seed 7, params at ``dtype``
    (drawn in f32, then cast: a bf16 net starts from the f32 net's weights
    rounded), computing at ``compute_dtype`` when given."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = transformer_lm(vocab_size=VOCAB, d_model=D_MODEL, n_heads=heads,
                          n_blocks=BLOCKS, dtype=dtype)
    conf.conf.remat = remat
    conf.conf.compute_dtype = compute_dtype
    return ComputationGraph(conf, device="cuda",
                            train_graphs=train_graphs).init()


def lm_train_run(ck, torch, heads, x, y, steps, *, plain=False,
                 remat=False, dtype="float32", compute_dtype=None):
    """``steps`` fit_batch steps of a fresh `lm_net`, each timed on the
    host clock up to its loss on the host; ``plain`` registers the
    attention kernels' plain versions instead and runs the steps eagerly.
    Returns (net, losses, step seconds, launch counts of exactly these
    steps)."""
    from deeplearning4j_tpu_torch.ops import helpers
    net = lm_net(heads, remat=remat, dtype=dtype, compute_dtype=compute_dtype,
                 train_graphs="off" if plain else "on")
    if plain:
        helpers.register_helper("attention",
                                helpers.PLAIN_OVERRIDES["attention"])
    try:
        torch.cuda.synchronize()
        ck.reset_launches()
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.monotonic()
            net.fit_batch(x, y)
            losses.append(net.score_)
            secs.append(time.monotonic() - t0)
        launches = dict(ck.LAUNCHES)
    finally:
        helpers.register_helper("attention", None)
    if not all(l == l and abs(l) != float("inf") for l in losses):
        raise SystemExit(f"non-finite LM training loss: {losses}")
    return net, losses, secs, launches


def lm_grad_check(torch, net, x, y):
    """One compute_gradient_and_score through the attention kernels and
    one through their plain versions, on the net's current params: (loss
    relative difference, {leaf: ||g_kernel - g_plain|| / ||g_plain||})."""
    from deeplearning4j_tpu_torch.ops import helpers
    lk, gk = net.compute_gradient_and_score(x, y)
    helpers.register_helper("attention", helpers.PLAIN_OVERRIDES["attention"])
    try:
        lp, gp = net.compute_gradient_and_score(x, y)
    finally:
        helpers.register_helper("attention", None)
    rel = {f"{n}.{k}": float((gk[n][k] - gp[n][k]).norm()
                             / gp[n][k].norm().clamp_min(1e-30))
           for n in gk for k in gk[n]}
    return float((lk - lp).abs() / lp.abs()), rel


def lm_profile(torch, net, x, y, steps,
               keys=("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")):
    """``steps`` more steps under torch.profiler: the device's busy share
    of the wall time, the device ms of the kernels named by ``keys`` and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            net.fit_batch(x, y)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = device_kernels_ms(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(ms for n, ms in kernels.items() if k in n) for k in keys}
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3), "kernels_ms": ours,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def splash_case(ck, torch, flush, *, B, L, H, D, causal, seed, library):
    """The three splash kernels against their plain versions at one shape,
    on q pre-scaled as `_splash_call` scales it; each backward kernel
    takes the plain forward's lse and o (di = sum_d o * dO), so each
    kernel is held alone. Errors are max |diff| over max |plain| (the
    gradients over the largest of the three plain gradients). Then the
    flash kernels on the same inputs (unscaled q, the scale in the
    kernel; their dq is the scale times splash's): errors over the flash
    outputs, and their times. With ``library``, SDPA forward and
    forward+backward on [B, H, L, D] views."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import splash_mask
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g).to(dev)
                   for _ in range(4))
    scale = D ** -0.5
    qs = q * scale
    tb = splash_mask.splash_tables(L, H, causal)
    o, lse = ck.splash_attention_fwd(qs, k, v, tb)
    ro, rlse = ck.splash_attention_fwd_ref(qs, k, v, tb)
    di = (ro * do).sum(dim=-1).permute(0, 2, 1).contiguous()
    bwd = (qs, k, v, do, rlse, di, tb)
    dk, dv = ck.splash_attention_bwd_dkv(*bwd)
    dq = ck.splash_attention_bwd_dq(*bwd)
    dk2, dv2 = ck.splash_attention_bwd_dkv(*bwd)
    dq2 = ck.splash_attention_bwd_dq(*bwd)
    rdk, rdv = ck.splash_attention_bwd_dkv_ref(*bwd)
    rdq = ck.splash_attention_bwd_dq_ref(*bwd)
    torch.cuda.synchronize()
    gscale = max(float(t.abs().max()) for t in (rdq, rdk, rdv))

    def err(a, b, s=None):
        return float((a - b).abs().max()) / (
            s if s is not None else float(b.abs().max()))
    r = {"shape": [B, L, H, D], "causal": causal,
         "rel_err": {"o": err(o, ro), "lse": err(lse, rlse),
                     "dq": err(dq, rdq, gscale), "dk": err(dk, rdk, gscale),
                     "dv": err(dv, rdv, gscale)},
         "max_abs_err": {"o": float((o - ro).abs().max()),
                         "dkv": max(float((dk - rdk).abs().max()),
                                    float((dv - rdv).abs().max())),
                         "dq": float((dq - rdq).abs().max())},
         "repeat_bitwise": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                                and torch.equal(dq, dq2)),
         "finite": bool(all(torch.isfinite(t).all()
                            for t in (o, lse, dq, dk, dv)))}
    del dk2, dv2, dq2, rdk, rdv, rdq
    fkw = dict(causal=causal, scale=scale)
    fbwd = (q, k, v, do, rlse, di)
    fo, flse = ck.flash_attention_fwd(q, k, v, **fkw)
    fdk, fdv = ck.flash_attention_bwd_dkv(*fbwd, **fkw)
    fdq = ck.flash_attention_bwd_dq(*fbwd, **fkw)
    torch.cuda.synchronize()
    fscale = max(float(t.abs().max()) for t in (fdq, fdk, fdv))
    r["vs_flash_rel_err"] = {"o": err(o, fo), "lse": err(lse, flse),
                             "dq": err(dq * scale, fdq, fscale),
                             "dk": err(dk, fdk, fscale),
                             "dv": err(dv, fdv, fscale)}
    del o, lse, dk, dv, dq, fo, flse, fdk, fdv, fdq, ro
    reps = 5 if L >= 32768 else (10 if L >= 4096 else 25)
    runs = (
        ("", (lambda: ck.splash_attention_fwd(qs, k, v, tb),
              lambda: ck.splash_attention_bwd_dkv(*bwd),
              lambda: ck.splash_attention_bwd_dq(*bwd))),
        ("_plain", (lambda: ck.splash_attention_fwd_ref(qs, k, v, tb),
                    lambda: ck.splash_attention_bwd_dkv_ref(*bwd),
                    lambda: ck.splash_attention_bwd_dq_ref(*bwd))),
        ("_flash", (lambda: ck.flash_attention_fwd(q, k, v, **fkw),
                    lambda: ck.flash_attention_bwd_dkv(*fbwd, **fkw),
                    lambda: ck.flash_attention_bwd_dq(*fbwd, **fkw))))
    for suffix, fns in runs:
        for name, fn in zip(("fwd", "dkv", "dq"), fns):
            r[f"{name}{suffix}_ms"] = time_ms(fn, reps=reps, flush=flush)
    # least work: the operations of the pairs this run's mask keeps (the
    # kernels skip empty blocks; partial blocks' masked pairs are not
    # counted), and each input read, each output written once
    pairs, big, small = flash_bound(B, L, H, D, causal)
    for name, n_ops, n_bytes in (
            ("fwd", 4 * D * pairs, 4 * big + small),
            ("dkv", 8 * D * pairs, 6 * big + 2 * small),
            ("dq", 6 * D * pairs, 5 * big + 2 * small)):
        r[name + "_bound_ms"], r[name + "_bound_by"] = bound(n_bytes, n_ops)
    tc_bound(r, "fwd", 4 * D * pairs, 4 * big + small)
    tc_bound(r, "dkv", 8 * D * pairs, 6 * big + 2 * small)
    tc_bound(r, "dq", 6 * D * pairs, 5 * big + 2 * small)
    r["sdpa_fwd_ms"] = r["sdpa_fwd_bwd_ms"] = None
    if library:
        qt, kt, vt = (t.transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  scale=scale)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
        with torch.no_grad():
            ro = ck.splash_attention_fwd_ref(qs, k, v, tb)[0]
            r["sdpa_rel_err"] = err(sdpa().transpose(1, 2), ro)
            del ro
            r["sdpa_fwd_ms"] = time_ms(sdpa, reps=reps, flush=flush)
        r["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, reps=reps, flush=flush)
    return r


def route_case(ck, torch, flush, L, seed, H=4, D=128):
    """The forward, dK/dV and dQ of both attention families at [1, L, H,
    D] causal on the same inputs (flash: q and the scale; splash: q
    pre-scaled), each timed as in phase 2 (5 calls), the two families in
    turns: the figures that set the route's SPLASH_MIN_LEN. Returns
    {"L", "flash_ms": {fwd, dkv, dq, total}, "splash_ms": {...}}."""
    from deeplearning4j_tpu_torch.ops import splash_mask
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((1, L, H, D), generator=g).to(dev)
                   for _ in range(4))
    scale = D ** -0.5
    qs = q * scale
    tb = splash_mask.splash_tables(L, H, True)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    di = (o * do).sum(dim=-1).permute(0, 2, 1).contiguous()
    fkw = dict(causal=True, scale=scale)
    fams = {
        "flash": (lambda: ck.flash_attention_fwd(q, k, v, **fkw),
                  lambda: ck.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                     **fkw),
                  lambda: ck.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                                    **fkw)),
        "splash": (lambda: ck.splash_attention_fwd(qs, k, v, tb),
                   lambda: ck.splash_attention_bwd_dkv(qs, k, v, do, lse, di,
                                                       tb),
                   lambda: ck.splash_attention_bwd_dq(qs, k, v, do, lse, di,
                                                      tb))}
    r = {"L": L, "flash_ms": {}, "splash_ms": {}}
    for i, name in enumerate(("fwd", "dkv", "dq")):
        for fam in ("flash", "splash") if i % 2 == 0 else ("splash",
                                                           "flash"):
            r[fam + "_ms"][name] = time_ms(fams[fam][i], reps=5, flush=flush)
    for fam in ("flash", "splash"):
        r[fam + "_ms"]["total"] = sum(r[fam + "_ms"].values())
    return r


def bf16_grad_check(torch, net, x, y, heads, remat):
    """One step's gradients of a bf16 (or mixed-precision) LM through the
    bf16 kernels, through their plain versions, and of the same params in
    f32 through the f32 kernels. Returns (the loss's relative difference,
    kernel against plain; per leaf: max |g_kernel - g_plain| over the
    largest plain gradient of any leaf ("global") and over the leaf's own
    ("leaf"), and ||g - g_f32|| / ||g_f32|| of each path)."""
    from deeplearning4j_tpu_torch.ops import helpers
    lk, gk = net.compute_gradient_and_score(x, y)
    helpers.register_helper("attention", helpers.PLAIN_OVERRIDES["attention"])
    try:
        lp, gp = net.compute_gradient_and_score(x, y)
    finally:
        helpers.register_helper("attention", None)
    ref = lm_net(heads, remat=remat)
    ref.set_params(net.params)
    _, g32 = ref.compute_gradient_and_score(x, y)
    del ref
    gmax = max(float(g.float().abs().max()) for lg in gp.values()
               for g in lg.values())
    leaves = {}
    for n in gk:
        for k in gk[n]:
            a, b, c = (g[n][k].float() for g in (gk, gp, g32))
            d = float((a - b).abs().max())
            cn = float(c.norm().clamp_min(1e-30))
            leaves[f"{n}.{k}"] = {
                "global": d / gmax,
                "leaf": d / float(b.abs().max().clamp_min(1e-30)),
                "kernel_vs_f32": float((a - c).norm()) / cn,
                "plain_vs_f32": float((b - c).norm()) / cn}
    return float((lk - lp).abs() / lp.abs()), leaves


def attn16_ptxas(logs, kind="fwd"):
    """ptxas's report of the bf16 attention kernels of ``kind`` ("fwd",
    "bwd_dkv" or "bwd_dq") in the build logs: {kernel: {"registers", "spill_stores",
    "spill_loads"}} by family, head dim (and causal for flash), and the
    count of its warnings that a wgmma was serialised."""
    import re
    out, serialised, cur = {}, 0, None
    pat = rf"(flash|splash)_{kind}_bf16_kernelILi(\d+)E(?:Lb(\d))?"
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(pat, ln)
            if "serialized" in ln and m:
                serialised += 1
                continue
            if "Compiling entry function" in ln:
                cur = (f"{m.group(1)} D={m.group(2)}"
                       + ("" if m.group(3) is None else
                          f" causal={bool(int(m.group(3)))}")) if m else None
                if cur:
                    out[cur] = {}
            elif cur and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                out[cur].update(spill_stores=int(st), spill_loads=int(ld))
            elif cur and "Used" in ln and "registers" in ln:
                out[cur]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                cur = None
    return out, serialised


def conv16_ptxas(logs):
    """ptxas's report of the bf16 wgmma conv kernel in the build logs:
    {"registers", "spill_stores", "spill_loads"}, and the count of its
    warnings that a wgmma was serialised."""
    import re
    out, serialised, cur = {}, 0, False
    for log in logs.values():
        for ln in log.splitlines():
            ours = "conv_bf16_wgmma_kernel" in ln
            if "serialized" in ln and ours:
                serialised += 1
                continue
            if "Compiling entry function" in ln:
                cur = ours
            elif cur and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                out.update(spill_stores=int(st), spill_loads=int(ld))
            elif cur and "Used" in ln and "registers" in ln:
                out["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                cur = False
    return out, serialised


def bnap_ring_ptxas(logs):
    """ptxas's report of the two bf16 BN+act+pool ring kernels in the build
    logs: {"sums" | "dx": {activation code: {"registers", "spill_stores",
    "spill_loads"}}}."""
    import re
    out, cur = {"sums": {}, "dx": {}}, None
    for log in logs.values():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                m = re.search(r"bnap_(sums|dx)_ring_kernelILi(\d+)E", ln)
                cur = (m.group(1), int(m.group(2))) if m else None
            elif cur and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                out[cur[0]].setdefault(cur[1], {}).update(
                    spill_stores=int(st), spill_loads=int(ld))
            elif cur and "Used" in ln and "registers" in ln:
                out[cur[0]].setdefault(cur[1], {})["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                cur = None
    return out


def bf16_case(ck, torch, flush, *, family, B, L, H, D, causal, seed,
              timed=True):
    """The three bf16 kernels of ``family`` ("flash", or "splash" on q
    pre-scaled in bf16 as `_splash` scales it) against their plain versions
    at one shape, on bf16 inputs; each backward kernel takes the plain
    forward's lse and o (di = sum_d o * dO in f32), so each kernel is held
    alone. Errors of o, dq, dk and dv over each one's max |plain| (max and
    mean |diff|), of lse absolute. Times (as in phase 2) beside the bf16
    bound (the pairs the mask keeps at 989 TFLOP/s, or bf16 bytes), and
    SDPA at bf16 on [B, H, L, D] views, forward and forward+backward,
    unless ``timed`` is False (the edge set: values only)."""
    import functools
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import splash_mask
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g).to(dev, bf)
                   for _ in range(4))
    scale = D ** -0.5
    if family == "flash":
        kw = dict(causal=causal, scale=scale)
        qin = q
        fns = [functools.partial(f, **kw) for f in (
            ck.flash_attention_fwd, ck.flash_attention_bwd_dkv,
            ck.flash_attention_bwd_dq, ck.flash_attention_fwd_ref,
            ck.flash_attention_bwd_dkv_ref, ck.flash_attention_bwd_dq_ref)]
    else:
        tb = splash_mask.splash_tables(L, H, causal)
        qin = q * torch.full((), scale, dtype=bf, device=dev)
        fns = [functools.partial(f, tables=tb) for f in (
            ck.splash_attention_fwd, ck.splash_attention_bwd_dkv,
            ck.splash_attention_bwd_dq, ck.splash_attention_fwd_ref,
            ck.splash_attention_bwd_dkv_ref, ck.splash_attention_bwd_dq_ref)]
    fwd, dkv, dq, rfwd, rdkv, rdq = fns
    o, lse = fwd(qin, k, v)
    o2, lse2 = fwd(qin, k, v)
    ro, rlse = rfwd(qin, k, v)
    di = (ro.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
    bwd = (qin, k, v, do, rlse, di)
    dk, dv = dkv(*bwd)
    dq_ = dq(*bwd)
    dk2, dv2 = dkv(*bwd)
    dq2 = dq(*bwd)
    rdk, rdv = rdkv(*bwd)
    rdq_ = rdq(*bwd)
    torch.cuda.synchronize()
    outs = {"o": (o, ro), "dq": (dq_, rdq_), "dk": (dk, rdk), "dv": (dv, rdv)}
    rel, mean = {}, {}
    for n, (a, b) in outs.items():
        d = (a.float() - b.float()).abs()
        m = float(b.float().abs().max())
        rel[n], mean[n] = float(d.max()) / m, float(d.mean()) / m
    r = {"family": family, "shape": [B, L, H, D], "causal": causal,
         "rel_err": rel, "mean_rel_err": mean,
         "lse_abs_err": float((lse - rlse).abs().max()),
         "max_abs_err": {
             "o": float((o.float() - ro.float()).abs().max()),
             "dkv": max(float((dk.float() - rdk.float()).abs().max()),
                        float((dv.float() - rdv.float()).abs().max())),
             "dq": float((dq_.float() - rdq_.float()).abs().max())},
         "repeat_bitwise": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                                and torch.equal(dq_, dq2)),
         "fwd_repeat_bitwise": bool(torch.equal(o, o2)
                                    and torch.equal(lse, lse2)),
         "dtypes": [str(t.dtype) for t in (o, lse, dq_, dk, dv)],
         "finite": bool(all(torch.isfinite(t).all()
                            for t in (o, lse, dq_, dk, dv)))}
    r["ok"] = bool(max(rel.values()) <= BF16_MAX_REL
                   and max(mean.values()) <= BF16_MEAN_REL
                   and r["lse_abs_err"] <= BF16_LSE_ABS and r["finite"]
                   and r["dtypes"] == ["torch.bfloat16", "torch.float32"]
                   + ["torch.bfloat16"] * 3)
    del o, lse, o2, lse2, dk, dv, dq_, dk2, dv2, dq2, rdk, rdv, rdq_
    if not timed:
        return r
    reps = 5 if L >= 32768 else (10 if L >= 4096 else 25)
    for suffix, trio in (("", (lambda: fwd(qin, k, v), lambda: dkv(*bwd),
                               lambda: dq(*bwd))),
                         ("_plain", (lambda: rfwd(qin, k, v),
                                     lambda: rdkv(*bwd), lambda: rdq(*bwd)))):
        for name, fn in zip(("fwd", "dkv", "dq"), trio):
            r[f"{name}{suffix}_ms"] = time_ms(fn, reps=reps, flush=flush)
    # least work: the operations of the pairs the mask keeps, in bf16 on
    # the tensor cores; each bf16 input read, each output written once (lse
    # and di f32)
    pairs, _, small = flash_bound(B, L, H, D, causal)
    big = 2 * B * L * H * D
    for name, n_ops, n_bytes in (
            ("fwd", 4 * D * pairs, 4 * big + small),
            ("dkv", 8 * D * pairs, 6 * big + 2 * small),
            ("dq", 6 * D * pairs, 5 * big + 2 * small)):
        r[name + "_bound_ms"], r[name + "_bound_by"] = bound(
            n_bytes, n_ops, BF16_FLOPS_PER_S)
        r[name + "_bound_share"] = r[name + "_bound_ms"] / r[name + "_ms"]
        # the kept pairs' operations over the kernel's time
        r[name + "_tflops"] = n_ops / r[name + "_ms"] / 1e9
    qt, kt, vt = (t.transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
    with torch.no_grad():
        so = sdpa().transpose(1, 2).float()
        r["sdpa_rel_err"] = float((so - ro.float()).abs().max()
                                  / ro.float().abs().max())
        del so
        r["sdpa_fwd_ms"] = time_ms(sdpa, reps=reps, flush=flush)
    r["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, reps=reps, flush=flush)
    r["three_ms"] = r["fwd_ms"] + r["dkv_ms"] + r["dq_ms"]
    r["three_vs_sdpa"] = r["three_ms"] / r["sdpa_fwd_bwd_ms"]
    return r


def conv_bf16_case(ck, torch, flush, *, B, H, W, C, K, OC, stride, padding,
                   act, seed, timed, want_pre=False):
    """The bf16 conv kernel against its plain version at bf16 (the conv of
    the upcast operands in f32, bias and activation in f32, one rounding)
    at one shape, on bf16 inputs: max and mean |diff| over max |plain| of
    the output (and of the pre-activation with ``want_pre``), bitwise on a
    second launch, outputs bf16. With ``timed``: times (as in phase 2)
    beside the bf16 bound (operations at 989 TFLOP/s, or bf16 bytes) and
    F.conv2d at bf16 on channels-last with the bias and the activation."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import activations
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g).to(dev, bf)
    w = (torch.randn((K, K, C, OC), generator=g) / (K * K * C) ** 0.5).to(
        dev, bf)
    b = (torch.randn((OC,), generator=g) * 0.1).to(dev, bf)
    kw = dict(stride=stride, padding=padding, activation=act,
              want_pre=want_pre)
    got = ck.conv2d_bias_act(x, w, b, **kw)
    got2 = ck.conv2d_bias_act(x, w, b, **kw)
    want = ck.conv2d_bias_act_ref(x, w, b, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if want_pre else [(got, want)]
    rel, mean = [], []
    for a, r_ in pairs:
        d = (a.float() - r_.float()).abs()
        m = float(r_.float().abs().max())
        rel.append(float(d.max()) / m)
        mean.append(float(d.mean()) / m)
    oh, ow, pads = ck.conv_geometry(H, W, K, K, stride, padding)
    outs = got if want_pre else (got,)
    where = dict(stride=stride, padding=padding, x_ptr=x.data_ptr(),
                 w_ptr=w.data_ptr())
    route = ck.conv_bf16_route_on_card(B, H, W, C, K, K, OC, **where)
    r = {"shape": [B, H, W, C, K, OC], "stride": list(stride),
         "pads": [list(p) for p in pads], "activation": act,
         "route": route,
         "route_ok": route == ck.conv_bf16_route(B, H, W, C, K, K, OC,
                                                 **where),
         "want_pre": want_pre, "rel_err": rel, "mean_rel_err": mean,
         "max_abs_err": max(float((a.float() - r_.float()).abs().max())
                            for a, r_ in pairs),
         "repeat_bitwise": bool(all(
             torch.equal(a, b_) for a, b_ in zip(
                 outs, got2 if want_pre else (got2,)))),
         "dtypes": sorted({str(t.dtype) for t in outs}),
         "library_ms": None}
    r["ok"] = bool(max(rel) <= BF16_MAX_REL and max(mean) <= BF16_MEAN_REL
                   and r["repeat_bitwise"] and r["route_ok"]
                   and r["dtypes"] == ["torch.bfloat16"])
    if not timed:
        return r
    kw.pop("want_pre")
    r["ms"] = time_ms(lambda: ck.conv2d_bias_act(x, w, b, **kw), flush=flush)
    r["tflops"] = 2 * B * oh * ow * OC * K * K * C / r["ms"] / 1e9
    r["plain_ms"] = time_ms(lambda: ck.conv2d_bias_act_ref(x, w, b, **kw),
                            flush=flush)
    n_bytes = 2 * (x.numel() + w.numel() + b.numel() + B * oh * ow * OC)
    n_ops = 2 * B * oh * ow * OC * K * K * C
    r["bound_ms"], r["bound_by"] = bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
    r["bound_share"] = r["bound_ms"] / r["ms"]
    act_fn = activations.get(act)
    xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels-last NCHW
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = (pads[0][0], pads[1][0])

    def lib():
        return act_fn(F.conv2d(xc, wc, b, stride=stride, padding=pad))
    r["library_rel_err"] = float(
        (lib().permute(0, 2, 3, 1).float() - want.float()).abs().max()
        / want.float().abs().max())
    r["library_ms"] = time_ms(lib, flush=flush)
    r["ok"] = r["ok"] and r["library_rel_err"] <= 2.0 ** -5
    return r


def bnap_bf16_case(ck, torch, flush, *, B, H, W, C, act, tied, seed, timed,
                   misaligned=False):
    """The bf16 BN+act+pool backward kernels against their plain versions
    at one shape, on bf16 x and g, from the forward's own f32 batch stats.
    ``tied``: each 2x2 window holds four adjacent bf16 values (distinct
    inputs and distinct f32 activations) under gamma 0.05 and beta 3,
    where the activations round to one bf16 value: ties that exist only
    after the rounding; the dx there must be the plain version's bits.
    ``misaligned``: x and g are views 8 bytes past 16 (the lane kernels'
    route). The dx pass takes the plain sums, so it is held alone. Sums
    (f32) within 1e-4 of max |plain| and bitwise on a second launch; dx
    (bf16) within one bf16 ulp of max |plain|, mean 1e-3. Records the
    route the launches took (cuda_kernels.bnap_bf16_route)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    if tied:
        base = torch.randn((B, H // 2, W // 2, C), generator=g).to(bf)
        base = base.view(torch.int16) & ~3  # room for + 0..3 in the bits
        base = base.repeat_interleave(2, 1).repeat_interleave(2, 2)
        offs = torch.stack([torch.randperm(4, generator=g)
                            for _ in range(B * (H // 2) * (W // 2) * C)])
        offs = offs.reshape(B, H // 2, W // 2, C, 2, 2).permute(
            0, 1, 4, 2, 5, 3).reshape(B, H, W, C).to(torch.int16)
        x = (base + offs).view(bf).contiguous().to(dev)
        gamma = torch.full((C,), 0.05, device=dev)
        beta = torch.full((C,), 3.0, device=dev)
    else:
        x = torch.randn((B, H, W, C), generator=g).to(dev, bf)
        gamma = (torch.rand((C,), generator=g) + 0.5).to(dev)
        beta = (torch.randn((C,), generator=g) * 0.1).to(dev)
    gp = torch.randn((B, H // 2, W // 2, C), generator=g).to(dev, bf)
    if misaligned:  # a bf16 view 4 elements (8 bytes) into its buffer
        def off(t):
            v = torch.empty(t.numel() + 8, dtype=bf, device=dev)[4:]
            return v[:t.numel()].view(t.shape).copy_(t)
        x, gp = off(x), off(gp)
    _, mean, _, inv = ck.bnap_forward_ref(x, gamma, beta, eps=1e-5,
                                          activation=act)
    p = torch.stack([mean, inv, gamma, beta]).contiguous()
    dg, db = ck.bnap_sums(x, gp, p, activation=act)
    dg2, db2 = ck.bnap_sums(x, gp, p, activation=act)
    rg, rb = ck.bnap_sums_ref(x, gp, p, activation=act)
    s = torch.stack([rb, rg]).contiguous()
    dx = ck.bnap_dx(x, gp, p, s, activation=act)
    rdx = ck.bnap_dx_ref(x, gp, p, s, activation=act)
    torch.cuda.synchronize()
    route = ck.bnap_bf16_route(B, H, W, C, x.data_ptr(), gp.data_ptr(),
                               dx.data_ptr())
    # windows whose rounded activations tie, 4-way and at all
    a = ck.activations.get(act)(
        (x.float() - mean) * inv * gamma + beta).to(bf).float()
    a = a.reshape(B, H // 2, 2, W // 2, 2, C)
    cnt = (a == a.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4))
    d = (dx.float() - rdx.float()).abs()
    m = float(rdx.float().abs().max())
    r = {"shape": [B, H, W, C], "activation": act, "tied": tied,
         "misaligned": misaligned, "route": route,
         "tie_share": float((cnt > 1).float().mean()),
         "tie4_share": float((cnt == 4).float().mean()),
         "sums_max_abs_err": max(float((dg - rg).abs().max()),
                                 float((db - rb).abs().max())),
         "sums_max_abs_plain": max(float(rg.abs().max()),
                                   float(rb.abs().max())),
         "sums_repeat_bitwise": bool(torch.equal(dg, dg2)
                                     and torch.equal(db, db2)),
         "dx_max_abs_err": float(d.max()), "dx_rel_err": float(d.max()) / m,
         "dx_mean_rel_err": float(d.mean()) / m,
         "dx_bitwise": bool(torch.equal(dx, rdx)),
         "dtypes": [str(t.dtype) for t in (dg, db, dx)]}
    r["ok"] = bool(
        r["sums_max_abs_err"] <= 1e-4 * r["sums_max_abs_plain"]
        and r["sums_repeat_bitwise"] and r["dx_rel_err"] <= BF16_MAX_REL
        and r["dx_mean_rel_err"] <= BF16_MEAN_REL
        and r["dtypes"] == ["torch.float32"] * 2 + ["torch.bfloat16"]
        and (r["dx_bitwise"] and r["tie_share"] >= 0.5 if tied else True))
    if not timed:
        return r
    for k, fn in (("sums_ms", lambda: ck.bnap_sums(x, gp, p, activation=act)),
                  ("sums_plain_ms",
                   lambda: ck.bnap_sums_ref(x, gp, p, activation=act)),
                  ("dx_ms", lambda: ck.bnap_dx(x, gp, p, s, activation=act)),
                  ("dx_plain_ms",
                   lambda: ck.bnap_dx_ref(x, gp, p, s, activation=act))):
        r[k] = time_ms(fn, flush=flush)
    # bf16 x and g read once, dx (bf16) written once, p and s f32; the
    # arithmetic is f32 outside the tensor cores
    n_x, n_g = x.numel(), gp.numel()
    for k, n_bytes, n_ops in (("sums", 2 * (n_x + n_g) + 4 * 6 * C, 12 * n_x),
                              ("dx", 2 * (2 * n_x + n_g) + 4 * 6 * C,
                               14 * n_x)):
        r[k + "_bound_ms"], r[k + "_bound_by"] = bound(n_bytes, n_ops)
        r[k + "_bound_share"] = r[k + "_bound_ms"] / r[k + "_ms"]
    return r


def cnn_bf16_grad_check(torch, net, x, y):
    """One step's gradients of a bf16 (or mixed-precision) CNN through the
    bf16 kernels, through their plain versions (PLAIN_OVERRIDES), and of
    the same params and variables in f32 through the f32 kernels, all on
    the same dropout masks. Returns (the loss's relative difference,
    kernel against plain; per leaf: max |g_kernel - g_plain| over the
    largest plain gradient of the step ("global"), and ||g - g_f32|| of
    each path over ||g_f32||, or over its layer's whole f32 gradient for a
    conv bias that feeds a BatchNormalization, whose exact gradient is 0,
    as phase 6 measures it)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import helpers
    state = net._gen.get_state()
    lk, gk, _ = net.compute_gradient_and_score(x, y)
    net._gen.set_state(state)
    for name, fn in helpers.PLAIN_OVERRIDES.items():
        helpers.register_helper(name, fn)
    try:
        lp, gp, _ = net.compute_gradient_and_score(x, y)
    finally:
        for name in helpers.PLAIN_OVERRIDES:
            helpers.register_helper(name, None)
    conf = net.conf.from_json(net.conf.to_json())
    conf.conf.dtype, conf.conf.compute_dtype = "float32", None
    ref = MultiLayerNetwork(conf, device="cuda").init()
    ref.set_params(net.params)
    ref.variables = [{k: v.float() for k, v in lv.items()}
                     for lv in net.variables]
    ref._gen.set_state(state)
    _, g32, _ = ref.compute_gradient_and_score(x, y)
    del ref
    net._gen.set_state(state)
    layers = net.conf.layers
    gmax = max(float(g.float().abs().max()) for lg in gp for g in lg.values())
    leaves = {}
    for i, (a_, b_, c_) in enumerate(zip(gk, gp, g32)):
        whole = (torch.cat([t.flatten() for t in c_.values()]).norm()
                 if c_ else None)
        for k in a_:
            a, b, c = (t[k].float() for t in (a_, b_, c_))
            zero = (k == "b" and i + 1 < len(layers)
                    and isinstance(layers[i + 1], BatchNormalization))
            cn = float((whole if zero else c.norm()).clamp_min(1e-30))
            leaves[f"{i}.{k}"] = {
                "global": float((a - b).abs().max()) / gmax,
                "kernel_vs_f32": float((a - c).norm()) / cn,
                "plain_vs_f32": float((b - c).norm()) / cn}
    return float((lk - lp).abs() / lp.abs()), leaves


# -- phases 24-25: the recurrent training path, MLP-Iris and the A3 layers ---

CHAR_V, CHAR_H, CHAR_B, CHAR_T, CHAR_L = 77, 256, 128, 200, 50
CHAR_FITS = 10          # fits on one batch, 4 TBPTT windows each
CHAR_CPU_REL = 1e-4     # card against CPU: each window's loss, relative
CHAR_CPU_LEAF = 1e-4    # and every leaf after the fit, of its max |value|
CHAR_STEP_TOL = 1e-5    # 64 rnn_time_step calls against output()
CHAR_PROMPT, CHAR_NEW = 20, 100
A3_LAYER_REL = 1e-5     # phase 25: card against CPU, of max |CPU|


def char_batch(seed, B, T, V=CHAR_V):
    """One-hot next-character pairs [B, T, V] of seeded walks on a Markov
    chain: each character has three successors, taken with probabilities
    0.6, 0.3 and 0.1, so the loss has somewhere to fall."""
    import numpy as np
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, V, (V, 3))
    pick = rng.choice(3, size=(B, T), p=[0.6, 0.3, 0.1])
    ids = np.empty((B, T + 1), np.int64)
    ids[:, 0] = rng.integers(0, V, B)
    for t in range(T):
        ids[:, t + 1] = succ[ids[:, t], pick[:, t]]
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]], ids


class WindowLosses:
    """Keeps each window's loss as the device scalar the step leaves
    (reading it would sync the card once a window)."""

    def __init__(self):
        self.raw = []

    def iteration_done(self, model, iteration):
        self.raw.append(model._score_raw)

    def values(self):
        return [float(v) for v in self.raw]


def char_net(torch, device, dtype="float32", params=None):
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(char_rnn_lstm(dtype=dtype), device=device).init()
    if params is not None:
        net.set_params(params)
    return net


def params_cpu(net):
    return [{k: v.detach().cpu().clone() for k, v in lp.items()}
            for lp in net.params]


def char_fit(torch, net, x, y, fits):
    """``fits`` fits on one batch (TBPTT windows of 50): each window's
    loss, and each fit's host seconds up to a synchronize."""
    lis = WindowLosses()
    net.set_listeners(lis)
    secs = []
    for _ in range(fits):
        t0 = time.monotonic()
        net.fit(x, y)
        sync(torch, net.device.type)
        secs.append(time.monotonic() - t0)
    net.set_listeners()
    return lis.values(), secs


def sync(torch, dev):
    if dev != "cpu":
        torch.cuda.synchronize()


def char_profile(torch, net, x, y, fits=2):
    """``fits`` more fits under torch.profiler: the busy share and the
    kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    dev = net.device.type
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(fits):
            net.fit(x, y)
        sync(torch, dev)
        wall = time.monotonic() - t0
    kernels = device_kernels_ms(prof)
    busy = sum(kernels.values())
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"fits": fits, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "kernel_launches": launches,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def generate_check(torch, net_card, net_cpu, prompt, n_new):
    """generate_rnn greedy on the card and on the CPU from the same params:
    (card tokens, CPU tokens, None or the first step where they part with
    the CPU's top-2 probability gap there)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import generate_rnn
    card = generate_rnn(net_card, prompt, n_new, CHAR_V)
    cpu = generate_rnn(net_cpu, prompt, n_new, CHAR_V)
    if card == cpu:
        return card, cpu, None
    k = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
    net_cpu.rnn_clear_previous_state()
    ctx = list(prompt) + cpu[:k]
    x = np.eye(CHAR_V, dtype=np.float32)[ctx][None]
    row = np.sort(net_cpu.rnn_time_step(x)[0, -1].numpy())
    return card, cpu, {"step": k, "cpu_top2_gap": float(row[-1] - row[-2])}


def a3_layer_cases(torch):
    """(name, port layer config, input maker, mask or None) of phase 25:
    each layer of A3 at widths of the char-RNN and AlexNet."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    rng = np.random.default_rng(25)
    B, T, V, H = 32, 32, CHAR_V, CHAR_H
    seq = rng.normal(size=(B, T, V)).astype(np.float32)
    hid = rng.normal(size=(B, T, H)).astype(np.float32)
    img = rng.normal(size=(B, 16, 16, 64)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[::3, T // 2:] = 0.0
    mask[1::4, 5] = 0.0
    idx = rng.integers(0, V, (4 * B,))
    cases = [
        ("GRU", L.GRU(n_in=V, n_out=H, activation="tanh"), seq, None),
        ("GravesBidirectionalLSTM", L.GravesBidirectionalLSTM(
            n_in=V, n_out=H, activation="tanh"), seq, None),
        ("LSTM masked", L.LSTM(n_in=V, n_out=H, activation="tanh"), seq,
         mask),
        ("GravesLSTM masked", L.GravesLSTM(n_in=V, n_out=H,
                                           activation="tanh"), seq, mask),
        ("EmbeddingLayer index", L.EmbeddingLayer(
            n_in=V, n_out=H, activation="identity"), idx[:, None], None),
        ("EmbeddingLayer one-hot", L.EmbeddingLayer(
            n_in=V, n_out=H, activation="identity"),
         np.eye(V, dtype=np.float32)[idx], None),
        ("LocalResponseNormalization", L.LocalResponseNormalization(), img,
         None),
        ("ActivationLayer", L.ActivationLayer(activation="tanh"), hid, None),
        ("DropoutLayer p=0", L.DropoutLayer(dropout=0.0), hid, None),
        ("LossLayer", L.LossLayer(activation="softmax", loss="mcxent"), hid,
         None),
    ]
    for pool in ("max", "avg", "sum", "pnorm"):
        conf = L.GlobalPoolingLayer(pooling_type=pool)
        cases += [(f"GlobalPooling {pool}", conf, hid, None),
                  (f"GlobalPooling {pool} masked", conf, hid, mask),
                  (f"GlobalPooling {pool} NHWC", conf, img, None)]
    return cases


def a3_layer_check(torch, conf, x, mask, seed, dev="cuda"):
    """One layer's forward and the gradients of sum(y R) (params and, for
    float inputs, the input) on the card and on the CPU, same params:
    {forward, worst leaf: max |diff| / max |CPU|}."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.conf.config import \
        resolve_layer_defaults, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.base import (BaseRecurrentImpl,
                                                         impl_for)
    impl = impl_for(resolve_layer_defaults(conf, NeuralNetConfiguration()))
    # the layer's own init (Xavier weights), with N(0, 0.1) added to the
    # biases and peepholes so that their paths carry values
    p0 = impl.init_params(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    p0 = {k: v + torch.tensor((rng.normal(size=tuple(v.shape)) * 0.1)
                              .astype(np.float32)) if v.ndim == 1 else v
          for k, v in p0.items()}
    out = {}
    for d in ("cpu", dev):
        p = {k: v.to(d).requires_grad_(True) for k, v in p0.items()}
        xt = torch.tensor(x, device=d)
        if xt.is_floating_point():
            xt.requires_grad_(True)
        m = None if mask is None else torch.tensor(mask, device=d)
        if isinstance(impl, BaseRecurrentImpl):
            y = impl.forward_with_state(p, xt, None, mask=m)[0]
        else:
            y = impl.forward(p, xt, train=True, mask=m,
                             gen=torch.Generator(device=d).manual_seed(1))
        R = torch.tensor(np.random.default_rng(seed + 1).normal(
            size=tuple(y.shape)).astype(np.float32), device=d)
        leaves = list(p.values()) + ([xt] if xt.requires_grad else [])
        g = torch.autograd.grad((y * R).sum(), leaves) if leaves else []
        out[d] = [y.detach().cpu()] + [t.cpu() for t in g]
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(out[dev], out["cpu"])]
    return {"forward_rel": rel[0], "grad_rel": max(rel[1:], default=0.0)}


def mlp_iris_run(torch, device, params=None):
    """`mlp_iris()` with the recipe of the JAX test_iris_accuracy (Adam,
    lr 0.01, 60 epochs of batch 50) on the packaged Iris copy: (net,
    Evaluation over the 150 rows, host seconds of the fit, the params it
    started from on the CPU)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        IrisDataSetIterator
    from deeplearning4j_tpu_torch.datasets.iterators import \
        MultipleEpochsIterator
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater.updaters import Adam
    conf = mlp_iris(lr=0.01)
    for layer in conf.layers:
        layer.updater = Adam()
    net = MultiLayerNetwork(conf, device=device).init()
    if params is not None:
        net.set_params(params)
    init = params_cpu(net)
    t0 = time.monotonic()
    net.fit(MultipleEpochsIterator(60, IrisDataSetIterator(batch=50)))
    secs = time.monotonic() - t0
    return net, net.evaluate(IrisDataSetIterator(batch=150)), secs, init


def a3_phases(torch, ck, card, dev="cuda"):
    """Phases 24 (the GravesLSTM char-RNN at full width) and 25 (MLP-Iris
    and the layers of A3 on the card against the CPU). No hand-written
    kernel runs here: every launch counter must stand still. (``dev``
    "cpu" rehearses the phases on the CPU, at the sizes the module's
    CHAR_* constants are set to.)"""
    import numpy as np
    launches0 = dict(ck.LAUNCHES)
    failures = []
    x, y, ids = char_batch(24, CHAR_B, CHAR_T)
    # -- phase 24: card against CPU, one fit from the same params
    net = char_net(torch, dev)
    init = params_cpu(net)
    cpu = char_net(torch, "cpu", params=init)
    t0 = time.monotonic()
    cpu_losses, _ = char_fit(torch, cpu, x, y, 1)
    cpu_s = time.monotonic() - t0
    losses, secs = char_fit(torch, net, x, y, 1)
    win_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    leaf_rel = max(float((a.cpu() - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))
                   for la, lb in zip(net.params, cpu.params)
                   for a, b in ((la[k], lb[k]) for k in la))
    n_win = -(-CHAR_T // CHAR_L)
    if len(losses) != n_win or win_rel > CHAR_CPU_REL \
            or leaf_rel > CHAR_CPU_LEAF:
        failures.append(f"char-RNN card vs CPU: windows {losses} vs "
                        f"{cpu_losses} (rel {win_rel}), leaves {leaf_rel}")
    phase(24, f"char_rnn_lstm ({net.num_params()} params: V={CHAR_V}, two "
              f"GravesLSTM H={CHAR_H}, TBPTT {CHAR_L}) B={CHAR_B} "
              f"T={CHAR_T}, first fit ({len(losses)} windows) on the card "
              f"and on the CPU from the same params: window losses "
              f"{losses}; max rel diff {win_rel:.3e} (gate {CHAR_CPU_REL}), "
              f"every leaf after it within {leaf_rel:.3e} of its max "
              f"|value| (gate {CHAR_CPU_LEAF}); the CPU fit took "
              f"{cpu_s:.2f} s")
    more, more_secs = char_fit(torch, net, x, y, CHAR_FITS - 1)
    losses += more
    secs += more_secs
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"char-RNN losses {losses}")
    steady = secs[1:]
    fit_ms = 1e3 * sum(steady) / len(steady)
    r = {"vocab": CHAR_V, "hidden": CHAR_H, "batch": CHAR_B, "T": CHAR_T,
         "tbptt": CHAR_L, "fits": CHAR_FITS, "window_losses": losses,
         "cpu_window_losses": cpu_losses, "card_vs_cpu_window_rel": win_rel,
         "card_vs_cpu_leaf_rel": leaf_rel, "fit_s": secs,
         "first_fit_ms": secs[0] * 1e3, "mean_fit_ms": fit_ms,
         "mean_window_ms": fit_ms / n_win,
         "chars_per_s": CHAR_B * CHAR_T * len(steady) / sum(steady),
         "params": net.num_params()}
    phase(24, f"char_rnn_lstm {CHAR_FITS} fits of B={CHAR_B} T={CHAR_T}: "
              f"window loss {losses[0]:.6f} -> {losses[-1]:.6f}, all "
              f"finite; fits 2-{CHAR_FITS}: mean {fit_ms:.3f} ms a fit, "
              f"{r['mean_window_ms']:.3f} ms a window, "
              f"{r['chars_per_s']:.1f} characters/s (first fit "
              f"{r['first_fit_ms']:.1f} ms) [{card}]")
    r["profile"] = pr = char_profile(torch, net, x, y, 2)
    phase(24, f"char_rnn_lstm under torch.profiler, 2 more fits: wall "
              f"{pr['wall_ms']:.3f} ms, device busy "
              f"{pr['device_busy_ms']:.3f} ms "
              f"({100 * pr['device_busy_share']:.2f}%), "
              f"{pr['kernel_launches']} kernel launches; top "
              f"{pr['top_kernels_ms'][:5]} [{card}]")
    # streaming: 64 one-token rnn_time_step calls against output()
    xs = x[:8, :64]
    want = net.output(xs)
    net.rnn_clear_previous_state()
    got = torch.cat([net.rnn_time_step(xs[:, t]) for t in range(64)], dim=1)
    r["rnn_time_step_max_abs"] = step_err = float((got - want).abs().max())
    if not step_err <= CHAR_STEP_TOL:
        failures.append(f"rnn_time_step vs output: {step_err}")
    # greedy generation from the trained params, card against CPU
    trained = params_cpu(net)
    cpu.set_params(trained)
    prompt = [int(t) for t in ids[0, :CHAR_PROMPT]]
    t0 = time.monotonic()
    gen_card, gen_cpu, part = generate_check(torch, net, cpu, prompt,
                                             CHAR_NEW)
    r["generate"] = {"tokens": gen_card, "identical": part is None,
                     "parted": part, "s": time.monotonic() - t0}
    if part is not None:
        failures.append(f"generate_rnn card vs CPU part at step "
                        f"{part['step']} (CPU top-2 gap "
                        f"{part['cpu_top2_gap']:.3e}): {gen_card} vs "
                        f"{gen_cpu}")
    phase(24, f"64 one-token rnn_time_step calls against output(): max "
              f"|diff| {step_err:.3e} (gate {CHAR_STEP_TOL}); generate_rnn "
              f"greedy, prompt {CHAR_PROMPT}, {CHAR_NEW} new: card and CPU "
              f"tokens {'identical' if part is None else 'DIFFER'} "
              f"({gen_card[:16]}...)")
    # bf16: the same init rounded, the same batch
    net16 = char_net(torch, dev, dtype="bfloat16", params=init)
    losses16, secs16 = char_fit(torch, net16, x, y, CHAR_FITS)
    curve = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses16, losses)]
    if not (all(np.isfinite(losses16)) and len(losses16) == len(losses)
            and max(curve) <= BF16_CURVE):
        failures.append(f"char-RNN bf16 left the f32 curve: {losses16}")
    steady16 = secs16[1:]
    r["bf16"] = {"window_losses": losses16, "curve_rel": curve,
                 "fit_s": secs16,
                 "mean_fit_ms": 1e3 * sum(steady16) / len(steady16),
                 "chars_per_s": CHAR_B * CHAR_T * len(steady16)
                 / sum(steady16)}
    phase(24, f"char_rnn_lstm bf16, {CHAR_FITS} fits: window loss "
              f"{losses16[0]:.6f} -> {losses16[-1]:.6f}; vs f32 max "
              f"{max(curve):.3e} of max(1, |loss|) (gate {BF16_CURVE}); "
              f"{r['bf16']['mean_fit_ms']:.3f} ms a fit, "
              f"{r['bf16']['chars_per_s']:.1f} characters/s [{card}]")
    del net, net16, cpu
    # -- phase 25: MLP-Iris, then every layer of A3 against the CPU
    iris_net, ev, iris_s, iris_init = mlp_iris_run(torch, dev)
    _, ev_cpu, _, _ = mlp_iris_run(torch, "cpu", params=iris_init)
    same = bool(np.array_equal(ev.confusion.matrix, ev_cpu.confusion.matrix))
    iris = {"accuracy": ev.accuracy(), "f1": ev.f1(),
            "confusion": ev.confusion.matrix.tolist(),
            "cpu_confusion": ev_cpu.confusion.matrix.tolist(),
            "fit_s": iris_s, "steps": iris_net.step}
    if not (ev.accuracy() > 0.9 and same):
        failures.append(f"MLP-Iris: accuracy {ev.accuracy()}, confusion "
                        f"{iris['confusion']} vs CPU {iris['cpu_confusion']}")
    phase(25, f"MLP-Iris (mlp_iris(), Adam lr 0.01, 60 epochs of batch 50, "
              f"{iris_net.step} steps in {iris_s:.2f} s): accuracy "
              f"{ev.accuracy():.4f} (gate > 0.9), confusion "
              f"{iris['confusion']} {'equal to' if same else 'UNLIKE'} the "
              f"CPU run's from the same init [{card}]")
    layers = {}
    for i, (name, conf, xin, m) in enumerate(a3_layer_cases(torch)):
        layers[name] = c = a3_layer_check(torch, conf, xin, m, 100 + i,
                                          dev)
        if not (c["forward_rel"] <= A3_LAYER_REL
                and c["grad_rel"] <= A3_LAYER_REL):
            failures.append(f"{name} card vs CPU: {c}")
    worst = max(layers.items(), key=lambda kv: max(kv[1].values()))
    phase(25, f"{len(layers)} layer cases on the card against the CPU, "
              f"forward and gradients (f32): worst {worst[0]} forward "
              f"{worst[1]['forward_rel']:.3e}, gradient "
              f"{worst[1]['grad_rel']:.3e} of max |CPU| (gate "
              f"{A3_LAYER_REL})")
    moved = {k: v - launches0.get(k, 0) for k, v in ck.LAUNCHES.items()
             if v != launches0.get(k, 0)}
    if moved:
        failures.append(f"kernel launches during phases 24-25: {moved}")
    if failures:
        raise SystemExit("phases 24-25 failed: " + " | ".join(failures))
    return {"char_rnn": r, "mlp_iris": iris, "a3_layers": layers}



# -- phase 26: the char-RNN served, bf16 decode, grammars, best-of-n --------

CHAR_SLOTS, CHAR_REQS, CHAR_CHUNK = 8, 16, 32
# phase 26's JSON schema (an object of a 2-digit integer and a string of
# at most 3 of "abc") over an alphabet of 128 one-character tokens
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "a": {"type": "integer", "maxDigits": 2},
    "b": {"type": "string", "maxLength": 3, "charset": "abc"}}}
GRAMMAR_ALPHABET = ([chr(c) for c in range(32, 127)]
                    + [chr(c) for c in range(161, 194)])


# phase 26b: a bf16 row served against the solo cached row on the same
# context, absolute (the rows are probabilities). A few times the largest
# sound difference seen (7e-4 on the CPU, a chunked prompt against a whole
# one) and well below a typical probability at V 128 (1/128).
BF16_ROW_TOL = 2.0 ** -9


def near_tie(row, body, k, tol):
    """Whether some row within ``tol`` of ``row`` (entry by entry) could
    draw another token than ``row`` does at request ``body``'s step ``k``,
    judged from ``row`` alone; with the margin it was judged by. Greedy:
    the top-two gap against ``tol``. Sampled: the step's uniform
    (``default_rng(seed)`` replayed to step k, one uniform a sampled
    step, as ``rng.choice`` draws it) against the edges of the drawn
    token's interval in the cumulative sampling distribution, each edge
    moved as far as entries moved by ``tol`` can carry it (the kept
    tokens' weights are ``p ** (1 / T)``)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import sampling_distribution
    if body.get("temperature", 0.0) <= 0.0:
        top = np.sort(row)
        gap = float(top[-1] - top[-2])
        return gap < tol, gap
    inv_t = 1.0 / body["temperature"]
    rng = np.random.default_rng(body.get("seed", 0))
    rng.random(k)
    u = rng.random()
    p = sampling_distribution(row, body["temperature"], body.get("top_k"),
                              body.get("top_p"))
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    t = int(cdf.searchsorted(u, side="right"))
    keep = p > 0
    row = np.asarray(row, np.float64)
    up = np.where(keep, (row + tol) ** inv_t, 0.0)
    down = np.where(keep, np.maximum(row - tol, 0.0) ** inv_t, 0.0)

    def reach(e):  # how far the mass of tokens below e can move
        lo_up, hi_down = up[:e].sum(), down[e:].sum()
        lo_down, hi_up = down[:e].sum(), up[e:].sum()
        f0 = cdf[e - 1] if e else 0.0
        return max(lo_up / (lo_up + hi_down) - f0,
                   f0 - lo_down / (lo_down + hi_up))
    below = u - (cdf[t - 1] if t else 0.0)
    above = cdf[t] - u
    near = (t > 0 and below < reach(t)) or above < reach(t + 1)
    return bool(near), float(min(below, above))


def cached_rows(net, prompt, toks, vocab):
    """The rows [len(toks), vocab] f32 that solo cached decode computes on
    the context ``prompt + toks``: the prompt in one rnn_time_step, then
    one token a step (teacher forcing)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import onehot
    net.rnn_clear_previous_state()
    out = []
    try:
        for ids in [list(prompt)] + [[t] for t in toks[:-1]]:
            r = net.rnn_time_step(onehot(ids, vocab))
            out.append((r[0] if isinstance(r, list) else r)[0, -1]
                       .float().cpu().numpy())
    finally:
        net.rnn_clear_previous_state()
    return np.stack(out)


def top2_gap(net, prompt, toks, k, vocab):
    """The top-two probability gap of ``net``'s cached row that gave
    ``toks[k]`` after ``prompt`` (the prompt and toks[:k] fed through
    rnn_time_step)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import onehot
    net.rnn_clear_previous_state()
    try:
        row = net.rnn_time_step(onehot(list(prompt) + list(toks[:k]), vocab))
        row = row[0] if isinstance(row, list) else row
        row = np.sort(row[0, -1].float().cpu().numpy())
    finally:
        net.rnn_clear_previous_state()
    return float(row[-1] - row[-2]), float(row[-1])


def char_serving(torch, ck, card, dev="cuda"):
    """Phase 26a: the char-RNN of phase 24 (trained CHAR_FITS fits, so its
    rows are peaked) served through /generate: CHAR_REQS requests of a
    CHAR_PROMPT-character prompt and CHAR_NEW new characters at once over
    CHAR_SLOTS slots, half greedy, half seeded top-k, on a captured server
    and on an eager one (decode_graphs "off"); the tokens of both equal
    generate_rnn's solo on the card. No hand-written kernel runs."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.models.sampling import generate_rnn
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    x, y, ids = char_batch(24, CHAR_B, CHAR_T)
    net = char_net(torch, dev)
    char_fit(torch, net, x, y, CHAR_FITS)
    bodies = []
    for i in range(CHAR_REQS):
        body = {"prompt": [int(t) for t in ids[i, :CHAR_PROMPT]],
                "max_new_tokens": CHAR_NEW}
        if i % 2:
            body.update(temperature=0.8, top_k=20, seed=300 + i)
        bodies.append(body)
    t0 = time.monotonic()
    solo = [generate_rnn(net, b["prompt"], CHAR_NEW, CHAR_V, **sampling_kw(b))
            for b in bodies]
    solo_s = time.monotonic() - t0
    launches0 = dict(ck.LAUNCHES)
    runs, failures = {}, []
    for graphs in ("on", "off"):
        srv = InferenceServer(net=net, decode_vocab=CHAR_V,
                              decode_slots=CHAR_SLOTS,
                              prefill_chunk=CHAR_CHUNK, decode_graphs=graphs,
                              device=dev).start()
        try:
            dec = srv.decoder
            warm = warm_counts(dec)
            post(srv.port, {"prompt": bodies[0]["prompt"],
                            "max_new_tokens": 4})
            dec.reset_counters()
            t0 = time.monotonic()
            outs = post_all(srv.port, bodies)
            sync(torch, dev)
            wall = time.monotonic() - t0
            toks = [o["tokens"] for o in outs]
            n_tok = sum(map(len, toks))
            st = {"wall_s": wall, "tokens": n_tok,
                  "chars_per_s": n_tok / wall,
                  "decode_steps": dec.decode_steps,
                  "mean_decode_step_ms": 1e3 * dec.decode_seconds
                  / max(dec.decode_steps, 1),
                  "mean_prefill_chunk_ms": 1e3 * dec.prefill_seconds
                  / max(dec.prefill_chunks, 1),
                  **engine_stats(srv, dec, warm)}
            if graphs == "on":
                with profile(activities=[ProfilerActivity.CUDA
                                         if dev != "cpu"
                                         else ProfilerActivity.CPU]) as prof:
                    t0 = time.monotonic()
                    again = post_all(srv.port, bodies)
                    sync(torch, dev)
                    pwall = time.monotonic() - t0
                busy = sum(device_kernels_ms(prof).values())
                st.update(profiled_wall_ms=pwall * 1e3, device_busy_ms=busy,
                          device_busy_share=busy / (pwall * 1e3))
                if [o["tokens"] for o in again] != toks:
                    failures.append("the profiled char-RNN wave's tokens "
                                    "differ from the first wave's")
        finally:
            srv.stop()
        runs[graphs] = st
        if toks != solo:
            bad = []
            for i, (a, b) in enumerate(zip(toks, solo)):
                if a != b:
                    k = next(j for j, (u, v) in enumerate(zip(a, b))
                             if u != v)
                    gap, _ = top2_gap(net, bodies[i]["prompt"], b, k, CHAR_V)
                    bad.append(f"request {i} step {k} (top-2 gap {gap:.3e})")
            failures.append(f"char-RNN served ({graphs}) tokens differ from "
                            f"generate_rnn: {bad}")
        on = graphs == "on"
        if not (st["warmup_captures"] == st["captures"] == (1 if on else 0)
                and st["warmup_prefill_captures"] == st["prefill_captures"]
                == (len(dec.prefill_buckets) if on else 0)):
            failures.append(f"char-RNN captures ({graphs}): {st}")
        if st["restarts"] or st["chunk_row_reads"] != st["final_chunks"]:
            failures.append(f"char-RNN serving ({graphs}): restarts "
                            f"{st['restarts']}, chunk reads "
                            f"{st['chunk_row_reads']} for "
                            f"{st['final_chunks']} final chunks")
    moved = {k: v - launches0.get(k, 0) for k, v in ck.LAUNCHES.items()
             if v != launches0.get(k, 0)}
    if moved:
        failures.append(f"kernel launches while serving the char-RNN: "
                        f"{moved}")
    on = runs["on"]
    phase(26, f"char_rnn_lstm (V={CHAR_V}, two GravesLSTM H={CHAR_H}, "
              f"{CHAR_FITS} fits) served: {CHAR_REQS} /generate at once, "
              f"prompt {CHAR_PROMPT}, {CHAR_NEW} new, {CHAR_SLOTS} slots, "
              f"prefill chunk {CHAR_CHUNK}: tokens identical to generate_rnn "
              f"solo ({solo_s:.2f} s) and to the eager engine: "
              f"{not failures}; captured {on['chars_per_s']:.2f} characters/s"
              f" ({on['tokens']} in {on['wall_s']:.3f} s, "
              f"{on['decode_steps']} decode steps of mean "
              f"{on['mean_decode_step_ms']:.3f} ms, prefill chunk mean "
              f"{on['mean_prefill_chunk_ms']:.3f} ms), eager "
              f"{runs['off']['chars_per_s']:.2f} characters/s (step "
              f"{runs['off']['mean_decode_step_ms']:.3f} ms); busy "
              f"{on['device_busy_ms']:.3f} ms of {on['profiled_wall_ms']:.3f}"
              f" ms ({100 * on['device_busy_share']:.2f}%); captures "
              f"{on['captures']} decode + {on['prefill_captures']} prefill, "
              f"all in warmup(); no kernel launch [{card}]")
    return {"runs": runs, "solo_s": solo_s}, failures


def bf16_serving(torch, ck, card, reqs, dev="cuda"):
    """Phase 26b: the flagship LM at phase 3's width in bf16 and mixed
    precision (the same seed's params, rounded), served by the engine on
    phase 3's requests, paged and contiguous: its tokens equal solo
    generate_transformer(use_cache=True) at the same dtype, and the paged
    kernel is never launched (its seam declines a bf16 query); the
    kernel's wrapper refuses a bf16 query."""
    import numpy as np
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.models.sampling import generate_transformer
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    out, failures = {}, []
    if dev != "cpu":  # (the CPU runs the plain version at any dtype)
        q = torch.zeros((SLOTS, 1, HEADS, D_MODEL // HEADS),
                        dtype=torch.bfloat16, device=dev)
        pages = torch.zeros((3, KV_BLOCK, HEADS, D_MODEL // HEADS),
                            dtype=torch.float32, device=dev)
        try:
            ck.paged_decode_attention(
                q, pages, pages, torch.zeros((SLOTS, 1), dtype=torch.int32,
                                             device=dev),
                torch.zeros((SLOTS,), dtype=torch.int32, device=dev))
            failures.append("the paged kernel's wrapper took a bf16 query")
        except TypeError as e:
            out["wrapper_refusal"] = str(e)
    for prec in ("bf16", "mixed"):
        conf = transformer_lm(vocab_size=VOCAB, d_model=D_MODEL,
                              n_heads=HEADS, n_blocks=BLOCKS, rope=True,
                              seed=7, dtype="bfloat16" if prec == "bf16"
                              else "float32")
        if prec == "mixed":
            conf.conf.compute_dtype = "bfloat16"
        net = ComputationGraph(conf, device=dev).init()
        t0 = time.monotonic()
        solo = [generate_transformer(net, b["prompt"], NEW_TOKENS, VOCAB,
                                     use_cache=True, **sampling_kw(b))
                for b in reqs]
        solo_s = time.monotonic() - t0
        for kv in ("paged", "contiguous"):
            eng = DecodeScheduler(net, VOCAB, n_slots=SLOTS,
                                  prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                                  kv_pool_mb=KV_POOL_MB if kv == "paged"
                                  else 0.0, device=dev)
            eng.warmup()
            eng.start()
            rows = {}
            consume = eng._consume

            def keep_row(slot, seq, row):
                # the host row each token is sampled from (a copy)
                rows.setdefault(seq.handle.request_id, []).append(
                    np.array(row, np.float32))
                consume(slot, seq, row)
            try:
                eng.generate(reqs[0]["prompt"][:CHUNK + 3], 4, timeout=900)
                ck.reset_launches()
                eng.reset_counters()
                eng._consume = keep_row
                t0 = time.monotonic()
                hs = [eng.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
                      for b in reqs]
                toks = [h.result(900) for h in hs]
                wall = time.monotonic() - t0
            finally:
                eng.stop()
            n_tok = sum(map(len, toks))
            r = {"tokens_per_s": n_tok / wall, "wall_s": wall,
                 "tokens": n_tok, "decode_steps": eng.decode_steps,
                 "mean_decode_step_ms": 1e3 * eng.decode_seconds
                 / max(eng.decode_steps, 1),
                 "paged_launches": ck.LAUNCHES["paged_decode_attention"],
                 "launches": {k: v for k, v in ck.LAUNCHES.items() if v},
                 "cache_dtype": str(next(iter(next(iter(
                     eng._states.values())).values())).dtype),
                 "solo_s": solo_s, "identical": toks == solo}
            # every served row against the solo cached row on the served
            # context; a request may part from solo only at a near tie:
            # where a row within BF16_ROW_TOL of solo's could draw another
            # token (greedy: solo's top-two gap below it)
            parts, row_err = [], 0.0
            for i, (a, b, h) in enumerate(zip(toks, solo, hs)):
                got = np.stack(rows[h.request_id])
                ref = cached_rows(net, reqs[i]["prompt"], a, VOCAB)
                row_err = max(row_err, float(np.abs(got - ref).max()))
                if a == b:
                    continue
                k = next(j for j, (u, v) in enumerate(zip(a, b)) if u != v)
                near, margin = near_tie(ref[k], reqs[i], k, BF16_ROW_TOL)
                parts.append({
                    "request": i, "step": k, "margin": margin,
                    "row_diff": float(np.abs(got[k] - ref[k]).max()),
                    "near_tie": near})
            r.update(parted=parts, max_row_diff=row_err)
            out[f"{prec}_{kv}"] = r
            if row_err > BF16_ROW_TOL or not all(x["near_tie"]
                                                 for x in parts):
                failures.append(f"{prec} {kv}: served rows against solo "
                                f"cached rows {row_err:.3e} (gate "
                                f"{BF16_ROW_TOL:.3e}); partings {parts}")
            if r["launches"] or r["cache_dtype"] != "torch.bfloat16":
                failures.append(f"{prec} {kv}: launches {r['launches']} "
                                f"(want none), cache {r['cache_dtype']}")
            phase(26, f"flagship LM {prec} ({kv}): phase 3's 8 requests "
                      f"through the engine, tokens identical to solo "
                      f"generate_transformer(use_cache=True) at the same "
                      f"dtype {r['identical']} (partings, each at a near "
                      f"tie within the gate: {parts}); every served "
                      f"row within {row_err:.3e} of the solo cached row on "
                      f"its context (gate {BF16_ROW_TOL:.3e}); "
                      f"{r['tokens_per_s']:.2f} "
                      f"tokens/s ({n_tok} in {wall:.3f} s, "
                      f"{r['decode_steps']} decode steps of mean "
                      f"{r['mean_decode_step_ms']:.3f} ms), cache "
                      f"{r['cache_dtype']}, paged kernel launches "
                      f"{r['paged_launches']} [{card}]")
        del net
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out, failures


def grammar_serving(torch, ck, card, model_path, reqs, want, kv_dtype,
                    dev="cuda"):
    """Phase 26c: phase 3's paged wave (phase 4's with int8 pages) on a
    server: the wave unconstrained, then twice with an admit-all grammar
    on every request (the masked step on every decode step: tokens
    identical to phase 3's, the paged kernel launched 4 x the masked
    steps inside the masked graphs; the first of the two captures the
    masked steps on first use, as warmup() builds them only for a
    resident grammar), then with neutral penalties; a trie grammar
    forces its sequence, a JSON-schema completion parses, a stop sequence
    cuts the output, and best-of-n (n = 4) returns 4 candidates,
    candidate 0 the n = 1 output, the followers sharing the primary's
    prompt blocks."""
    import collections
    import numpy as np
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    failures, r = [], {}
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB, kv_dtype=kv_dtype,
                          paged_kernel="on", device=dev).start()
    tag = kv_dtype or "fp32"
    try:
        dec = srv.decoder
        warm = {"decode": dec.decode_captures, "masked": dec.masked_captures,
                "prefill": dec.prefill_captures}
        nb = len(dec.table_buckets)
        if not (warm["decode"] == nb and warm["masked"] == 0):
            failures.append(f"{tag}: warmup captured {warm}, want {nb} "
                            f"decode and no masked steps")
        post(srv.port, {"prompt": reqs[0]["prompt"][:CHUNK + 3],
                        "max_new_tokens": 4})

        def wave(extra):
            ck.reset_launches()
            dec.reset_counters()
            t0 = time.monotonic()
            outs = post_all(srv.port, [{**b, **extra} for b in reqs])
            sync(torch, dev)
            wall = time.monotonic() - t0
            toks = [o["tokens"] for o in outs]
            return toks, {
                "wall_s": wall, "tokens_per_s": sum(map(len, toks)) / wall,
                "decode_steps": dec.decode_steps,
                "masked_steps": dec.masked_steps,
                "mean_decode_step_ms": 1e3 * dec.decode_seconds
                / max(dec.decode_steps, 1),
                "mean_masked_step_ms": 1e3 * dec.masked_seconds
                / max(dec.masked_steps, 1),
                "launches": ck.LAUNCHES["paged_decode_attention"],
                "masked_captures": dec.masked_captures,
                "finish": sorted({o["finish_reason"] for o in outs})}
        n_attn = BLOCKS
        admit = {"grammar": {"type": "admit_all"}}
        # the first wave publishes the prompts' blocks; the ones after it,
        # compared with each other, all restore them; the first admit-all
        # wave captures the masked steps, the second is timed
        for name, extra in (("cold", {}), ("plain", {}),
                            ("admit_all_first_use", admit),
                            ("admit_all", admit),
                            ("neutral_penalties",
                             {"repetition_penalty": 1.0,
                              "presence_penalty": 0.0,
                              "frequency_penalty": 0.0})):
            toks, st = wave(extra)
            r[name] = st
            st["identical"] = toks == want
            if toks != want:
                failures.append(f"{tag} {name} wave: tokens differ from "
                                f"phase 3's/4's")
            masked = name.startswith("admit_all")
            if st["masked_steps"] != (st["decode_steps"] if masked else 0):
                failures.append(f"{tag} {name}: {st['masked_steps']} masked "
                                f"of {st['decode_steps']} decode steps")
            if st["launches"] != n_attn * st["decode_steps"] \
                    or not st["launches"]:
                failures.append(f"{tag} {name}: {st['launches']} paged "
                                f"launches for {st['decode_steps']} steps")
        m1 = r["admit_all_first_use"]["masked_captures"]
        if not (dec.decode_captures == nb and 0 < m1 <= nb
                and dec.masked_captures == m1):
            failures.append(f"{tag}: captures after the waves "
                            f"{dec.decode_captures} decode (want {nb}), "
                            f"{dec.masked_captures} masked (want the first "
                            f"admit-all wave's {m1}, at most {nb})")
        if kv_dtype is None:
            prompt = reqs[0]["prompt"][:100]
            forced = [5, 9, 12, 3, 77, 64]
            o = post(srv.port, {"prompt": prompt, "max_new_tokens": 16,
                                "grammar": {"type": "trie",
                                            "sequences": [forced]}})
            r["trie"] = o["tokens"]
            if (o["tokens"], o["finish_reason"]) != (forced, "grammar"):
                failures.append(f"trie grammar: {o['tokens']} "
                                f"{o['finish_reason']}")
            r["json"] = []
            for seed in range(3):
                o = post(srv.port, {
                    "prompt": prompt, "max_new_tokens": 40,
                    "temperature": 1.0, "seed": seed,
                    "grammar": {"type": "json_schema",
                                "schema": GRAMMAR_SCHEMA,
                                "alphabet": GRAMMAR_ALPHABET}})
                text = "".join(GRAMMAR_ALPHABET[t] for t in o["tokens"])
                try:
                    obj = json.loads(text)
                    ok = (isinstance(obj.get("a"), int)
                          and set(obj.get("b", "")) <= set("abc")
                          and o["finish_reason"] == "grammar")
                except ValueError:
                    ok = False
                r["json"].append({"text": text, "ok": ok})
                if not ok:
                    failures.append(f"JSON-schema completion {text!r} "
                                    f"({o['finish_reason']})")
            base = want[0]
            stop = base[5:7]
            first = next(i for i in range(len(base) - 1)
                         if base[i:i + 2] == stop)
            o = post(srv.port, {**reqs[0], "stop": stop})
            r["stop"] = {"tokens": len(o["tokens"]), "cut_at": first,
                         "finish": o["finish_reason"]}
            if (o["tokens"], o["finish_reason"]) != (base[:first], "stop"):
                failures.append(f"stop sequence: {r['stop']}")
            # best-of-n: a fresh 1024-token prompt (64 blocks, none in the
            # trie yet), 4 candidates
            bon = {"prompt": [int(t) for t in np.random.default_rng(
                       26).integers(0, VOCAB, 1024)],
                   "max_new_tokens": NEW_TOKENS, "temperature": 0.8,
                   "top_k": 20, "seed": 100}
            # as each follower attaches, read which pool blocks the live
            # slots' block tables hold in common, and by how many slots
            shared = []
            restore = dec._try_restore_paged

            def restore_and_read(slot, seq):
                f = dec.forks
                restore(slot, seq)
                if dec.forks > f:
                    held = collections.Counter(
                        b for q in dec._slots if q is not None
                        for b in set(q.block_ids))
                    shared.append((sum(c > 1 for c in held.values()),
                                   max(held.values())))
            f0, rt0 = dec.forks, dec.restored_tokens
            dec._try_restore_paged = restore_and_read
            try:
                o = post(srv.port, {**bon, "n": 4})
            finally:
                del dec._try_restore_paged
            forks, restored = dec.forks - f0, dec.restored_tokens - rt0
            one = post(srv.port, bon)
            n_blk = len(bon["prompt"]) // KV_BLOCK
            r["best_of_n"] = {
                "candidates": len(o["candidates"]), "forks": forks,
                # the prompt positions the followers restored (each feeds
                # its last token again): 3 x (1024 - 1)
                "restored_positions": restored,
                "shared_blocks": max((b for b, _ in shared), default=0),
                "max_holders": max((h for _, h in shared), default=0),
                "candidate0_is_n1": o["candidates"][0]["tokens"]
                == one["tokens"],
                "outstanding_refs": dec.pool.outstanding_refs()}
            if not (len(o["candidates"]) == 4
                    and r["best_of_n"]["candidate0_is_n1"]
                    and forks == 3
                    and restored == forks * (len(bon["prompt"]) - 1)
                    and r["best_of_n"]["shared_blocks"] == n_blk
                    and r["best_of_n"]["max_holders"] == 4
                    and r["best_of_n"]["outstanding_refs"] == 0):
                failures.append(f"best-of-n: {r['best_of_n']} (want 3 "
                                f"forks restoring 3 x "
                                f"{len(bon['prompt']) - 1} positions, "
                                f"{n_blk} blocks held by 4 slots)")
    finally:
        srv.stop()
    a, p = r["admit_all"], r["plain"]
    phase(26, f"phase 3's paged wave ({tag} pages) under grammars: "
              f"warmup captured {warm['decode']} decode + {warm['masked']} "
              f"masked steps, the first admit-all wave "
              f"{r['admit_all_first_use']['masked_captures']} masked steps "
              f"on first use (its mean masked step "
              f"{r['admit_all_first_use']['mean_masked_step_ms']:.3f} ms, "
              f"captures included); admit-all on every request: tokens "
              f"identical "
              f"to phase {4 if kv_dtype else 3} {a['identical']} (plain "
              f"wave {p['identical']}, neutral penalties "
              f"{r['neutral_penalties']['identical']}), "
              f"{a['masked_steps']} masked steps of {a['decode_steps']}, "
              f"paged kernel launches {a['launches']} = {BLOCKS} x "
              f"{a['decode_steps']} inside the masked graphs; mean step "
              f"masked {a['mean_masked_step_ms']:.3f} ms, unmasked "
              f"{p['mean_decode_step_ms']:.3f} ms (same server, both waves "
              f"on the prompts the cold wave published); "
              f"{a['tokens_per_s']:.2f} vs {p['tokens_per_s']:.2f} "
              f"tokens/s (cold wave {r['cold']['tokens_per_s']:.2f}) "
              f"[{card}]")
    if kv_dtype is None:
        phase(26, f"trie grammar forced {r['trie']}; JSON-schema "
                  f"completions {[j['text'] for j in r['json']]} parse; stop "
                  f"sequence cut request 0 at {r['stop']['cut_at']} "
                  f"({r['stop']['finish']}); best-of-n n=4 on a 1024-token "
                  f"prompt: {r['best_of_n']['candidates']} candidates, "
                  f"candidate 0 = n=1 {r['best_of_n']['candidate0_is_n1']}, "
                  f"{r['best_of_n']['forks']} followers restored "
                  f"{r['best_of_n']['restored_positions']} prompt positions; "
                  f"the block tables shared {r['best_of_n']['shared_blocks']} "
                  f"pool blocks, held by up to "
                  f"{r['best_of_n']['max_holders']} slots; "
                  f"outstanding refs {r['best_of_n']['outstanding_refs']} "
                  f"[{card}]")
    return r, failures


def phase26(torch, ck, card, reqs, want, want8, dev="cuda"):
    """Phase 26: char-RNN serving, bf16 decode, the grammar-masked paged
    step (fp32 and int8 pages) and best-of-n. Failures are gathered and
    raised at the end."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    out, failures = {}, []
    out["char_rnn"], f = char_serving(torch, ck, card, dev)
    failures += f
    out["bf16"], f = bf16_serving(torch, ck, card, reqs, dev)
    failures += f
    net = ComputationGraph(transformer_lm(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_blocks=BLOCKS,
        rope=True, seed=7), device=dev).init()
    with tempfile.TemporaryDirectory() as tmp:
        zpath = os.path.join(tmp, "lm.zip")
        write_model(net, zpath)
        del net
        for kv_dtype, w in ((None, want), ("int8", want8)):
            r, f = grammar_serving(torch, ck, card, zpath, reqs, w, kv_dtype,
                                   dev)
            out[f"grammar_{kv_dtype or 'fp32'}"] = r
            failures += f
    if failures:
        raise SystemExit("phase 26 failed: " + " | ".join(failures))
    return out


# -- phase 27: speculative decoding and int8 graph decode --------------------
SPEC_G = 3              # 27a-c: drafted tokens a slot an iteration
SPEC_CRASH_G = 2        # 27d, and the int8 clone's speculating server
FULL_ACCEPT_MIN = 0.95  # 27b: the greedy half's acceptance, draft = target
INT8_ROW_REL = 1e-5     # 27e: an int8 step's output, card against CPU
INT8_PREDICT_REL = 1e-4  # 27e: AlexNet int8 /predict rows, card against CPU
INT8_PREDICT_ROWS = 32
# the device of phase 27 ("cpu" with small VOCAB / D_MODEL rehearses it)
SPEC_DEV = "cuda"


def spec_captures(dec):
    """The engine's captures by family, speculative ones included."""
    return {"decode": dec.decode_captures, "prefill": dec.prefill_captures,
            "masked_decode": dec.masked_captures, **dec.spec_captures}


def spec_warm_want(dec):
    """The captures warmup() makes on a speculating engine (no grammar
    resident): one decode step and one verify per table bucket, a prefill
    chunk per (chunk bucket, table bucket), the draft step and a draft
    chunk per chunk bucket."""
    nb = len(dec.table_buckets) or 1
    cb = len(dec.prefill_buckets)
    return {"decode": nb, "prefill": nb * cb, "masked_decode": 0,
            "verify": nb, "draft": 1, "draft_prefill": cb}


def spec_wave(torch, ck, srv, bodies):
    """One wave through ``srv``, every body posted at once, with the
    engine's counts since its reset; returns (tokens, responses, stats)."""
    dec = srv.decoder
    ck.reset_launches()
    dec.reset_counters()
    t0 = time.monotonic()
    outs = post_all(srv.port, bodies)
    sync(torch, SPEC_DEV)
    wall = time.monotonic() - t0
    toks = [o["tokens"] for o in outs]
    st = {"wall_s": wall, "tokens": sum(map(len, toks)),
          "tokens_per_s": sum(map(len, toks)) / wall,
          "decode_steps": dec.decode_steps, "spec_rounds": dec.spec_rounds,
          "draft_steps": dec.draft_steps, "draft_chunks": dec.draft_chunks,
          "proposed": dec.spec_proposed, "accepted": dec.spec_accepted,
          "acceptance": dec.spec_accepted / max(dec.spec_proposed, 1),
          "mean_decode_step_ms": 1e3 * dec.decode_seconds
          / max(dec.decode_steps, 1),
          "mean_verify_ms": 1e3 * dec.verify_seconds
          / max(dec.spec_rounds, 1),
          "mean_draft_round_ms": 1e3 * dec.draft_seconds
          / max(dec.draft_steps, 1),
          "launches": ck.LAUNCHES["paged_decode_attention"],
          "spec_launches": dec.spec_launches,
          "outstanding_refs": (dec.pool.outstanding_refs() if dec.paged
                               else None),
          "captures": spec_captures(dec)}
    return toks, outs, st


def spec_gates(tag, st, warm, want_warm, paged, toks, want, failures):
    """27a's gates on one wave: the tokens, every capture in warmup(),
    proposals made, the paged kernel launched only by the plain decode
    steps (4 a step; the verify and the draft none), every page back."""
    if toks != want:
        failures.append(f"{tag}: tokens differ from the reference")
    if warm != want_warm or st["captures"] != warm:
        failures.append(f"{tag}: captures {warm} after warmup, "
                        f"{st['captures']} after the wave, want {want_warm}")
    if not st["proposed"]:
        failures.append(f"{tag}: no proposal")
    want_l = BLOCKS * st["decode_steps"] if paged else 0
    if st["launches"] != want_l or (paged and not want_l) \
            or st["spec_launches"]:
        failures.append(f"{tag}: {st['launches']} paged launches for "
                        f"{st['decode_steps']} plain steps, "
                        f"{st['spec_launches']} in the verify and draft")
    if paged and st["outstanding_refs"]:
        failures.append(f"{tag}: {st['outstanding_refs']} references left")


def spec_server(path=None, net=None, kv_pool_mb=KV_POOL_MB, **kw):
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    return InferenceServer(model_path=path, net=net, decode_vocab=VOCAB,
                           decode_slots=SLOTS, prefill_chunk=CHUNK,
                           kv_block=KV_BLOCK, kv_pool_mb=kv_pool_mb,
                           paged_kernel="on", device=SPEC_DEV, **kw).start()


def spec_serving(torch, ck, card, zpath, reqs, want, want8, p26, e2e):
    """Phases 27a-d on phase 3's flagship and requests."""
    from deeplearning4j_tpu_torch.inference import failpoints
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    out, failures = {}, []
    warm_req = {"prompt": reqs[0]["prompt"][:CHUNK + 3], "max_new_tokens": 4}
    # (a) three layouts, the default shallow draft; (c) on the fp32 pages
    for tag, kw, w in (("paged_fp32", {}, want),
                       ("paged_int8", {"kv_dtype": "int8"}, want8),
                       ("contiguous", {"kv_pool_mb": 0}, want)):
        srv = spec_server(zpath, speculate=SPEC_G, **kw)
        try:
            dec = srv.decoder
            warm = spec_captures(dec)
            if (dec.speculate, dec.draft_blocks) != (SPEC_G, BLOCKS // 2):
                failures.append(f"{tag}: speculate {dec.speculate}, draft "
                                f"blocks {dec.draft_blocks}")
            post(srv.port, warm_req)
            toks, _, st = spec_wave(torch, ck, srv, reqs)
            st["warmup_captures"] = warm
            st["warmup_s"] = dec.warmup_seconds
            spec_gates(f"27a {tag}", st, warm, spec_warm_want(dec),
                       dec.paged, toks, w, failures)
            out[tag] = st
            if tag == "paged_fp32":
                out["grammar"] = spec_grammar(torch, ck, srv, reqs, want,
                                              p26, failures)
        finally:
            srv.stop()
        phase(27, f"(a) speculate={SPEC_G}, shallow draft of "
                  f"{BLOCKS // 2} blocks, {tag}: tokens identical "
                  f"{toks == w}; {st['tokens_per_s']:.2f} tokens/s "
                  f"(phase 3 {e2e['tokens_per_s']:.2f}); acceptance "
                  f"{st['accepted']}/{st['proposed']} = "
                  f"{st['acceptance']:.4f}; {st['spec_rounds']} verifies "
                  f"(mean {st['mean_verify_ms']:.3f} ms), "
                  f"{st['draft_steps']} draft rounds (mean "
                  f"{st['mean_draft_round_ms']:.3f} ms), "
                  f"{st['draft_chunks']} draft chunks, "
                  f"{st['decode_steps']} plain steps (mean "
                  f"{st['mean_decode_step_ms']:.3f} ms); paged launches "
                  f"{st['launches']} = {BLOCKS} x {st['decode_steps']} plain "
                  f"steps, verify and draft {st['spec_launches']}; captures "
                  f"{st['captures']}, all in warmup() "
                  f"({st['warmup_s']:.3f} s); outstanding refs "
                  f"{st['outstanding_refs']} [{card}]")
    g = out["grammar"]
    phase(27, f"(c) admit-all grammar on every request under speculation "
              f"(fp32 pages): tokens identical {g['admit_identical']}; the "
              f"first wave captured {g['first_use']} on first use, the "
              f"second {g['second']}; {g['tokens_per_s']:.2f} tokens/s, "
              f"acceptance {g['acceptance']:.4f}; trie {g['trie']} and "
              f"JSON {g['json']!r} equal phase 26's {g['same_as_26']} "
              f"[{card}]")
    # (b) the draft is a second copy of the target: full acceptance
    srv = spec_server(zpath, speculate=SPEC_G,
                      draft_net=restore_model(zpath, device=SPEC_DEV))
    try:
        warm = spec_captures(srv.decoder)
        # the greedy half first, on prompts the trie does not hold yet:
        # the draft ingests each prompt beside its chunks, so speculation
        # starts at the first token (a restored prompt waits for the
        # draft's catch-up, one chunk an iteration)
        greedy = [b for b in reqs if b.get("temperature", 0) <= 0]
        gw = [w for b, w in zip(reqs, want) if b.get("temperature", 0) <= 0]
        gtoks, gouts, gst = spec_wave(torch, ck, srv, greedy)
        if gtoks != gw:
            failures.append("27b: the greedy half's tokens differ")
        toks, _, st = spec_wave(torch, ck, srv, reqs)
        spec_gates("27b", st, warm, spec_warm_want(srv.decoder), True,
                   toks, want, failures)
        rids = {o["request_id"]: i for i, o in enumerate(gouts)}
        gaps = []
        for ev in srv.tracer.events():
            a = ev.get("args", {})
            if ev["name"] == "rollback" and a.get("mismatch") \
                    and a.get("request") in rids:
                i = rids[a["request"]]
                k = a["tokens"] - 1
                gaps.append({"request": i, "token": k, "gap": top2_gap(
                    srv.net, greedy[i]["prompt"], gtoks[i], k, VOCAB)[0]})
        st.update(greedy=gst, rejection_gaps=gaps[:16],
                  rejections=len(gaps))
        out["full_accept"] = st
        if not gst["acceptance"] > FULL_ACCEPT_MIN:
            failures.append(f"27b: greedy acceptance {gst['acceptance']} "
                            f"<= {FULL_ACCEPT_MIN}")
    finally:
        srv.stop()
    phase(27, f"(b) draft_net = a copy of the target: tokens identical "
              f"{toks == want}; all 8 acceptance {st['acceptance']:.4f}, "
              f"the greedy half {gst['accepted']}/{gst['proposed']} = "
              f"{gst['acceptance']:.4f} (> {FULL_ACCEPT_MIN}); "
              f"{st['tokens_per_s']:.2f} tokens/s (greedy half "
              f"{gst['tokens_per_s']:.2f}); {len(gaps)} greedy rejections, "
              f"top-two gaps {[round(x['gap'], 9) for x in gaps[:16]]} "
              f"[{card}]")
    # (d) a crash in the verify seam mid-wave, supervised
    srv = spec_server(zpath, speculate=SPEC_CRASH_G)
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.1
    try:
        post(srv.port, warm_req)
        failpoints.arm("dispatch.verify", "crash@once")
        try:
            outs = post_all(srv.port, reqs)
        finally:
            failpoints.disarm()
        dec = srv.decoder
        st = {"tokens_identical": [o["tokens"] for o in outs] == want,
              "answered": len(outs),
              "retries": [o.get("retries", 0) for o in outs],
              "restarts": srv.supervisor.restarts,
              "speculate": dec.speculate,
              "captures": spec_captures(dec),
              "warm_want": spec_warm_want(dec)}
        out["crash"] = st
        if not (st["tokens_identical"] and st["answered"] == len(reqs)
                and st["restarts"] >= 1 and dec.speculate == SPEC_CRASH_G
                and st["captures"] == st["warm_want"]):
            failures.append(f"27d: {st}")
    finally:
        failpoints.disarm()
        srv.stop()
    phase(27, f"(d) dispatch.verify crash@once mid-wave, speculate="
              f"{SPEC_CRASH_G}: {st['answered']} answered, tokens "
              f"identical {st['tokens_identical']}, retries "
              f"{st['retries']}, restarts {st['restarts']}; the rebuilt "
              f"engine speculate={st['speculate']}, captures "
              f"{st['captures']} = its warmup()'s [{card}]")
    return out, failures


def spec_grammar(torch, ck, srv, reqs, want, p26, failures):
    """27c on 27a's fp32 server: the admit-all wave twice (the masked
    verify and draft captured on the first, none on the second), then
    phase 26's trie and first JSON-schema request."""
    dec = srv.decoder
    before = spec_captures(dec)
    admit = [{**b, "grammar": {"type": "admit_all"}} for b in reqs]
    t1, _, s1 = spec_wave(torch, ck, srv, admit)
    t2, _, s2 = spec_wave(torch, ck, srv, admit)
    first = {k: v - before.get(k, 0) for k, v in s1["captures"].items()
             if v != before.get(k, 0)}
    second = {k: v - s1["captures"].get(k, 0)
              for k, v in s2["captures"].items()
              if v != s1["captures"].get(k, 0)}
    nb = len(dec.table_buckets)
    if not (t1 == want and t2 == want):
        failures.append("27c: admit-all tokens differ from phase 3's")
    if second or not (1 <= first.get("masked_verify", 0) <= nb
                      and first.get("masked_draft") == 1):
        failures.append(f"27c: captures on first use {first}, after {second}")
    prompt = reqs[0]["prompt"][:100]
    o = post(srv.port, {"prompt": prompt, "max_new_tokens": 16,
                        "grammar": {"type": "trie",
                                    "sequences": [[5, 9, 12, 3, 77, 64]]}})
    j = post(srv.port, {"prompt": prompt, "max_new_tokens": 40,
                        "temperature": 1.0, "seed": 0,
                        "grammar": {"type": "json_schema",
                                    "schema": GRAMMAR_SCHEMA,
                                    "alphabet": GRAMMAR_ALPHABET}})
    text = "".join(GRAMMAR_ALPHABET[t] for t in j["tokens"])
    same = (o["tokens"] == p26["grammar_fp32"]["trie"]
            and text == p26["grammar_fp32"]["json"][0]["text"])
    if not same:
        failures.append(f"27c: trie {o['tokens']} / JSON {text!r} differ "
                        "from phase 26's")
    return {"admit_identical": t1 == want and t2 == want,
            "first_use": first, "second": second,
            "tokens_per_s": s2["tokens_per_s"],
            "acceptance": s2["acceptance"], "wave": s2,
            "trie": o["tokens"], "json": text, "same_as_26": same}


def int8_vertex_check(torch, q, qnet, qcpu, x0):
    """Each quantized vertex of the clone on the card against the same
    vertex on the CPU, on the same input (the CPU forward's input to that
    vertex): the int32 accumulators bit for bit, and the outputs (the f32
    epilogue and the activation) within INT8_ROW_REL of max |CPU|. Then
    the whole clone, card against CPU, with the int8 levels that differ
    at each vertex's input: returns the figures."""
    import numpy as np
    ins = {"cpu": [], "card": []}
    orig = q._int8_forward
    into = ins["cpu"]

    def spy(*a):
        into.append(a[-1])  # each quantized vertex's input, in order
        return orig(*a)
    q._int8_forward = spy
    try:
        rows_cpu = qcpu.output(x0)[0].float().numpy()
        into = ins["card"]
        rows_card = qnet.output(x0)[0].float().cpu().numpy()
    finally:
        q._int8_forward = orig
    names = [n for n in qcpu.topo if n in qcpu._quantized_vertices]
    per = []
    for name, xc, xg in zip(names, ins["cpu"], ins["card"]):
        vc, vg = qcpu._impls[name], qnet._impls[name]
        xq = torch.clamp(torch.round(xc / vc.x_scale), -127, 127).to(
            torch.int8)
        xq2 = xq.reshape(-1, xq.shape[-1])
        acc_c = q.int8_matmul(xq2, vc._w, vc.n_out)
        dev = vg.Wq.device
        acc_g = q.int8_matmul(xq2.to(dev), vg._w, vg.n_out).cpu()
        yc = vc.forward(None, xc)
        yg = vg.forward(None, xc.to(dev)).cpu()
        lv_c = torch.round(xc / vc.x_scale)
        lv_g = torch.round(xg.cpu() / vg.x_scale.cpu())
        per.append({"vertex": name, "acc_bitwise": bool(torch.equal(
            acc_c, acc_g)), "out_max_abs_err": float((yc - yg).abs().max()),
            "out_max_abs": float(yc.abs().max()),
            "end_to_end_level_flips": int((lv_c != lv_g).sum()),
            "elements": int(lv_c.numel())})
    return per, rows_card, rows_cpu


def int8_serving(torch, ck, card, zpath, reqs):
    """Phase 27e: the flagship's quantize_graph clone. Its int8 steps on
    the card against the CPU on the same inputs; the clone served on fp32
    pages without and with speculation, captured against the eager step;
    the clone's rows and tokens against the CPU and its solo decode
    (printed: an int8 level that float noise moves shifts every later
    vertex); AlexNet's int8 program behind /predict against the CPU."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.sampling import (
        generate_transformer, onehot)
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn import quantization as q
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    out, failures = {}, []
    net = restore_model(zpath, device=SPEC_DEV)
    x0 = onehot(reqs[0]["prompt"], VOCAB)
    qnet = q.quantize_graph(net, [x0])
    fbytes = sum(p.numel() * p.element_size()
                 for lp in net.params.values() for p in lp.values())
    qbytes = sum(
        (qnet._impls[n].Wq.numel() + 4 * qnet._impls[n].w_scale.numel()
         + 4 * qnet._impls[n].bias.numel()) if n in qnet._quantized_vertices
        else sum(p.numel() * p.element_size() for p in lp.values())
        for n, lp in net.params.items())
    t0 = time.monotonic()
    solo = [generate_transformer(qnet, b["prompt"], NEW_TOKENS, VOCAB,
                                 use_cache=True, **sampling_kw(b))
            for b in reqs]
    solo_s = time.monotonic() - t0
    for G in (0, SPEC_CRASH_G):
        runs = {}
        for graphs in ("on", "off"):
            srv = spec_server(net=qnet, speculate=G, decode_graphs=graphs)
            try:
                post(srv.port, {"prompt": reqs[0]["prompt"][:CHUNK + 3],
                                "max_new_tokens": 4})
                runs[graphs] = spec_wave(torch, ck, srv, reqs)
            finally:
                srv.stop()
        toks, _, st = runs["on"]
        st["eager"] = runs["off"][2]
        st["captured_equals_eager"] = toks == runs["off"][0]
        st["partings_from_solo"] = divergence(qnet, reqs, toks, solo)
        st["identical_to_solo"] = toks == solo
        out[f"speculate_{G}"] = st
        if toks != runs["off"][0]:
            failures.append(f"27e speculate={G}: captured and eager steps "
                            "served different tokens")
        for tag, r in (("captured", st), ("eager", st["eager"])):
            if not (r["launches"] == BLOCKS * r["decode_steps"] > 0
                    and not r["spec_launches"]):
                failures.append(f"27e speculate={G} {tag}: "
                                f"{r['launches']} launches for "
                                f"{r['decode_steps']} steps")
        if G and not (st["proposed"] and st["eager"]["proposed"]):
            failures.append("27e: the int8 clone proposed nothing")
    with tempfile.TemporaryDirectory() as tmp:
        qpath = os.path.join(tmp, "qlm.zip")
        q.save_quantized_graph(qnet, qpath)
        qcpu = q.load_quantized(qpath, device="cpu")
        per, card_rows, cpu_rows = int8_vertex_check(torch, q, qnet, qcpu,
                                                     x0)
        fcpu = restore_model(zpath, device="cpu").output(x0)[0].numpy()
        err = float(np.abs(card_rows - cpu_rows).max())
        qerr = float(np.abs(cpu_rows - fcpu).max())
        out["rows"] = {"max_abs_err": err, "int8_vs_float": qerr,
                       "max_abs_cpu": float(np.abs(cpu_rows).max()),
                       "rows": int(card_rows.shape[1]), "vertices": per}
        bad = [v for v in per if not (
            v["acc_bitwise"]
            and v["out_max_abs_err"] <= INT8_ROW_REL * v["out_max_abs"])]
        if bad:
            failures.append(f"27e: int8 steps on the card differ from the "
                            f"CPU on the same inputs: {bad}")
        if not err <= qerr:
            failures.append(f"27e: the clone's rows on the card are "
                            f"{err} from the CPU's, beyond int8's own "
                            f"{qerr} from f32")
        # AlexNet-CIFAR10 through quantize, its artifact behind /predict
        anet = MultiLayerNetwork(alexnet_cifar10(), device=SPEC_DEV).init()
        rng = np.random.default_rng(27)
        xc = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
        qa = q.quantize(anet, [xc])
        apath = os.path.join(tmp, "qalex.zip")
        q.save_quantized(qa, apath)
        xs = rng.normal(size=(INT8_PREDICT_ROWS, 32, 32, 3)).astype(
            np.float32)
        srv = InferenceServer(model_path=apath, device=SPEC_DEV).start()
        try:
            ck.reset_launches()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict",
                data=json.dumps({"data": xs.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            with urllib.request.urlopen(req, timeout=300) as r:
                got = np.asarray(json.loads(r.read())["predictions"])
            pred_s = time.monotonic() - t0
            served = type(srv.net).__name__
            alaunches = {k: v for k, v in ck.LAUNCHES.items() if v}
        finally:
            srv.stop()
        want_a = q.load_quantized(apath, device="cpu").output(xs).numpy()
        aerr = float(np.abs(got - want_a).max())
        out["alexnet"] = {
            "served": served, "rows": INT8_PREDICT_ROWS, "max_abs_err": aerr,
            "max_abs_cpu": float(np.abs(want_a).max()),
            "argmax_equal": bool((got.argmax(-1) == want_a.argmax(-1))
                                 .all()),
            "predict_s": pred_s, "launches": alaunches,
            "param_bytes_float": qa.float_param_bytes(),
            "param_bytes_int8": qa.param_bytes()}
        if not (served == "QuantizedNetwork"
                and aerr <= INT8_PREDICT_REL * out["alexnet"]["max_abs_cpu"]
                and out["alexnet"]["argmax_equal"]):
            failures.append(f"27e AlexNet /predict: {out['alexnet']}")
    out.update(param_bytes_float=fbytes, param_bytes_int8=qbytes,
               quantized_vertices=qnet._quantized_vertices,
               solo_s=solo_s)
    s0, s2 = out["speculate_0"], out[f"speculate_{SPEC_CRASH_G}"]
    flips = [v["end_to_end_level_flips"] for v in per]
    phase(27, f"(e) int8 graph clone of the flagship "
              f"({len(qnet._quantized_vertices)} vertices int8, params "
              f"{fbytes} B float -> {qbytes} B): each int8 step on the card "
              f"against the CPU on the same input: accumulators bitwise "
              f"{all(v['acc_bitwise'] for v in per)}, outputs max|diff| "
              f"{max(v['out_max_abs_err'] for v in per):.3e}; served on "
              f"fp32 pages, captured = eager {s0['captured_equals_eager']} "
              f"({s0['tokens_per_s']:.2f} tokens/s, eager "
              f"{s0['eager']['tokens_per_s']:.2f}; launches "
              f"{s0['launches']} = {BLOCKS} x {s0['decode_steps']}), "
              f"speculate={SPEC_CRASH_G} captured = eager "
              f"{s2['captured_equals_eager']} ({s2['tokens_per_s']:.2f} "
              f"tokens/s, acceptance {s2['acceptance']:.4f}, launches "
              f"{s2['launches']} = {BLOCKS} x {s2['decode_steps']} plain "
              f"steps); the clone's rows ({out['rows']['rows']}) card "
              f"against CPU max|diff| {err:.3e}, int8 against f32 on the "
              f"CPU {qerr:.3e}, int8 levels moved by float noise at each "
              f"vertex {flips}; tokens as its solo cached decode: "
              f"speculate=0 {s0['identical_to_solo']} "
              f"({s0['partings_from_solo'] or 'no parting'}), "
              f"speculate={SPEC_CRASH_G} {s2['identical_to_solo']} "
              f"({s2['partings_from_solo'] or 'no parting'}); AlexNet int8 "
              f"/predict of {INT8_PREDICT_ROWS} rows "
              f"({out['alexnet']['served']}): max|diff| against the CPU "
              f"{aerr:.3e}, argmax equal {out['alexnet']['argmax_equal']}, "
              f"params {out['alexnet']['param_bytes_float']} B float -> "
              f"{out['alexnet']['param_bytes_int8']} B, launches "
              f"{out['alexnet']['launches']} [{card}]")
    return out, failures


def phase27(torch, ck, card, reqs, want, want8, p26, e2e):
    """Phase 27: speculative decoding (three layouts, full acceptance, a
    grammar, a crash) and int8 graph decode on phase 3's flagship.
    Failures are gathered and raised at the end."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    t0 = time.monotonic()
    net = ComputationGraph(transformer_lm(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_blocks=BLOCKS,
        rope=True, seed=7), device=SPEC_DEV).init()
    with tempfile.TemporaryDirectory() as tmp:
        zpath = os.path.join(tmp, "lm.zip")
        write_model(net, zpath)
        del net
        out, failures = spec_serving(torch, ck, card, zpath, reqs, want,
                                     want8, p26, e2e)
        out["int8"], f = int8_serving(torch, ck, card, zpath, reqs)
        failures += f
    out["seconds"] = time.monotonic() - t0
    if failures:
        raise SystemExit("phase 27 failed: " + " | ".join(failures))
    return out


# -- phase 28: the KV tiers, the prefix directory, attribution ---------------
TIER_PROMPT = 512       # wave prompts: 32 full blocks each
# the tier servers' prefill chunk: one fp32 block (256 KiB) an iteration
# against the tier's busy grant of 512 KiB leaves the worker room for
# restores (PERF.md §6)
TIER_CHUNK = 16
TIER_POOL_SHARE = 1.25  # the pool over one wave's peak block need
TIER_HOST_MB = 96       # 28a, 28b, 28d, 28e's second server: the host tier
TIER_DISK_HOST_MB = 4   # 28c: a host tier of 16 fp32 blocks ...
TIER_DISK_MB = 128      # ... over a disk tier
TIER_SETTLE_S = 120     # the longest a tier may take to drain at idle
TIER_FETCH_MAX = 4      # 28e: wave-A prompts whose chains are fetched
# 28f: waves of the profiler's armed/disarmed comparison, in turns
# on, off, off, on, ...
TIER_PROFILE_WAVES = 16


# phase 28's figures, kept when a gate fails (tools/phase28_alone.py)
PHASE28_FIGURES = {}


def tier_block_bytes(kv_dtype=None):
    """One pool block's bytes: 4 layers x (K, V) x 16 positions x 8 heads
    x 64 dims at f32, or int8 with an f32 scale per position and head."""
    dh = D_MODEL // HEADS
    row = HEADS * (dh + 4) if kv_dtype == "int8" else HEADS * dh * 4
    return 2 * BLOCKS * KV_BLOCK * row


def tier_pool_mb(kv_dtype=None):
    """A pool of 1.25 x one wave's peak block need (8 x 34 blocks)."""
    need = SLOTS * -(-(TIER_PROMPT + NEW_TOKENS) // KV_BLOCK)
    pb = tier_block_bytes(kv_dtype)
    return ((int(TIER_POOL_SHARE * need) + 1) * pb + pb // 2) / float(1 << 20)


def tier_waves(seed):
    """Waves A and B: 8 prompts of 512 tokens each (heads that differ),
    half greedy, half seeded sampling; wave C is wave A again."""
    import numpy as np
    rng = np.random.default_rng(seed)
    waves = []
    for w in range(2):
        wave = []
        for i in range(SLOTS):
            body = {"prompt": [int(t) for t in
                               rng.integers(0, VOCAB, TIER_PROMPT)],
                    "max_new_tokens": NEW_TOKENS}
            if i % 2:
                body.update(temperature=0.8, top_k=20, seed=300 + 10 * w + i)
            wave.append(body)
        waves.append(wave)
    return waves


def tier_server(net, **kw):
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    args = dict(net=net, decode_vocab=VOCAB, decode_slots=SLOTS,
                prefill_chunk=TIER_CHUNK, kv_block=KV_BLOCK,
                kv_pool_mb=tier_pool_mb(kw.get("kv_dtype")),
                paged_kernel="on", device="cuda")
    args.update(kw)
    return InferenceServer(**args).start()


def tier_settle(dec, timeout=TIER_SETTLE_S):
    """Seconds until the tier's queues are empty (spills landed,
    promotions integrated) on an idle engine."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if not any(dec.tier.stats()["queues"].values()):
            return time.monotonic() - t0
        time.sleep(0.02)
    raise SystemExit(f"phase 28: the tier never drained: {dec.tier.stats()}")


def tier_counters(srv):
    snap = srv.metrics.snapshot()["counters"]
    return {k: v for k, v in snap.items()
            if k.startswith("kv_tier_") or k == "prefill_tokens_total"}


def tier_wave(torch, ck, srv, bodies):
    """One wave, every body posted at once, with the engine's counts over
    it; returns (tokens, stats)."""
    import numpy as np
    dec = srv.decoder
    ck.reset_launches()
    dec.reset_counters()
    c0 = tier_counters(srv)
    t0 = time.monotonic()
    outs = post_all(srv.port, bodies)
    sync(torch, "cuda")
    wall = time.monotonic() - t0
    c1 = tier_counters(srv)
    ttft = [sum(o["timings"][k] for k in ("queue_ms", "restore_ms",
                                          "prefill_ms")) for o in outs]
    toks = [o["tokens"] for o in outs]
    return toks, {
        "wall_s": wall, "tokens": sum(map(len, toks)),
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_steps": dec.decode_steps,
        "launches": ck.LAUNCHES["paged_decode_attention"],
        "prefix_restored_tokens": dec.restored_tokens,
        "tier_restored_tokens": dec.tier_restored_tokens,
        "promoted_blocks": dec.promoted_blocks,
        "promote_host_ms_per_block": 1e3 * dec.promote_seconds
        / max(dec.promoted_blocks, 1),
        "counters": {k: v - c0.get(k, 0) for k, v in c1.items()}}


def track_promotions(dec):
    """Record each promotion the engine integrates: (chain hash, the host
    rows it copied in)."""
    seen = []
    orig = dec._integrate_promotion

    def rec(entry, rows):
        ok = orig(entry, rows)
        if ok:
            seen.append((entry.hash, rows))
        return ok
    dec._integrate_promotion = rec
    return seen


def promoted_rows_equal(torch, dec, seen):
    """(blocks compared, blocks differing): each promoted block still in
    the trie, its pool rows read back against the rows it was promoted
    from, bit for bit."""
    rows = dict(seen)
    checked = bad = 0
    for node in list(dec.pool._walk()):
        want = rows.get(node.hash)
        if want is None:
            continue
        checked += 1
        for lk, pks in want.items():
            for pk, a in pks.items():
                got = dec._states[lk][pk][node.block_id].cpu()
                if not torch.equal(got, a):
                    bad += 1
                    break
    return checked, bad


def tier_stats(dec):
    tier = dec.tier
    return {"spill_ms_per_block": 1e3 * tier.spill_seconds
            / max(tier.spill_blocks, 1),
            "spilled_blocks": tier.spill_blocks,
            "spill_batches": tier.spill_batches,
            "spill_queue_peak": tier.spill_queue_peak,
            "spill_credit_wait_s": tier.spill_credit_wait_seconds,
            "spill_event_wait_s": tier.spill_event_wait_seconds,
            "restore_staging_ms_per_block": 1e3 * tier.restore_seconds
            / max(tier.restore_blocks, 1),
            "staged_blocks": tier.restore_blocks, **tier.stats()}


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def post_json(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def tier_host_run(torch, ck, card, net, wave_a, wave_b, kv_dtype, failures):
    """28a (fp32 pages) / 28b (int8): waves A, B, C on a host tier of
    96 MiB, under an armed resource ledger; 28a's server also answers 28f's
    attribution reads before it stops."""
    from deeplearning4j_tpu_torch.analysis.runtime import resource_ledger
    tag = "28a" if kv_dtype is None else "28b"
    out = {}
    with resource_ledger() as led:
        srv = tier_server(net, kv_dtype=kv_dtype, host_cache_mb=TIER_HOST_MB)
        try:
            dec = srv.decoder
            toks_a, out["wave_a"] = tier_wave(torch, ck, srv, wave_a)
            out["settle_a_s"] = tier_settle(dec)
            _, out["wave_b"] = tier_wave(torch, ck, srv, wave_b)
            out["settle_b_s"] = tier_settle(dec)
            seen = track_promotions(dec)
            toks_c, out["wave_c"] = tier_wave(torch, ck, srv, wave_a)
            out["settle_c_s"] = tier_settle(dec)
            out["rows_checked"], out["rows_differing"] = \
                promoted_rows_equal(torch, dec, seen)
            out["tier"] = tier_stats(dec)
            out["counters"] = tier_counters(srv)
            if kv_dtype is None:
                out["attribution"] = attribution_gates(srv, failures)
        finally:
            srv.stop()
    try:
        led.assert_clean()
        out["ledger_clean"] = True
    except AssertionError as e:
        out["ledger_clean"] = False
        failures.append(f"{tag}: {e}")
    c, wc = out["counters"], out["wave_c"]
    if toks_c != toks_a:
        failures.append(f"{tag}: wave C's tokens differ from wave A's")
    for k in ("kv_tier_spilled_blocks_total", "kv_tier_promoted_blocks_total",
              "kv_tier_restored_tokens_total"):
        if not c.get(k):
            failures.append(f"{tag}: {k} is {c.get(k)}")
    if c.get("kv_tier_restore_failed_total"):
        failures.append(f"{tag}: {c['kv_tier_restore_failed_total']} "
                        "failed restores")
    if not out["rows_checked"] or out["rows_differing"]:
        failures.append(f"{tag}: promoted rows {out['rows_differing']} of "
                        f"{out['rows_checked']} differ from their payload")
    if wc["launches"] != BLOCKS * wc["decode_steps"] or not wc["launches"]:
        failures.append(f"{tag}: wave C {wc['launches']} paged launches for "
                        f"{wc['decode_steps']} decode steps")
    prompt_tokens = SLOTS * TIER_PROMPT
    phase(28, f"({tag[-1]}) {'int8' if kv_dtype else 'fp32'} pages, host tier "
              f"{TIER_HOST_MB} MiB, pool {tier_pool_mb(kv_dtype):.3f} MiB, "
              f"prefill chunk {TIER_CHUNK}: wave C tokens "
              f"{'identical' if toks_c == toks_a else 'DIFFERENT'} to wave "
              f"A's; spilled {c['kv_tier_spilled_blocks_total']} (dropped "
              f"{c['kv_tier_spill_dropped_total']}; "
              f"{out['tier']['spill_batches']} worker batches, spill queue "
              f"peak {out['tier']['spill_queue_peak']}), promoted "
              f"{c['kv_tier_promoted_blocks_total']}, failed restores "
              f"{c['kv_tier_restore_failed_total']}; wave C restored "
              f"{wc['tier_restored_tokens']} tokens from promotions and "
              f"{wc['prefix_restored_tokens'] - wc['tier_restored_tokens']} "
              f"from resident prefixes of its {prompt_tokens} prompt tokens, "
              f"prefilled {wc['counters']['prefill_tokens_total']}; TTFT p50 "
              f"{wc['ttft_ms_p50']:.3f} / p99 {wc['ttft_ms_p99']:.3f} ms "
              f"(wave A {out['wave_a']['ttft_ms_p50']:.3f} / "
              f"{out['wave_a']['ttft_ms_p99']:.3f}); the worker's spill "
              f"{out['tier']['spill_ms_per_block']:.4f} ms a block (event "
              f"wait and device->host copy), a promotion "
              f"{out['tier']['restore_staging_ms_per_block']:.4f} ms staging "
              f"+ {wc['promote_host_ms_per_block']:.4f} ms on the scheduler "
              f"(alloc, copy enqueued, adopt); promoted rows bitwise equal "
              f"their payload in {out['rows_checked'] - out['rows_differing']}"
              f" of {out['rows_checked']}; wave C paged launches "
              f"{wc['launches']} = {BLOCKS} x {wc['decode_steps']}; ledger "
              f"{'zero' if out['ledger_clean'] else 'NOT zero'} at stop "
              f"[{card}]")
    return out


def attribution_gates(srv, failures):
    """28f on 28a's warmed, tiered, idle server: GET /debug/engine and
    /info."""
    dec = srv.decoder
    dbg = get_json(srv.port, "/debug/engine")
    info = get_json(srv.port, "/info")
    per = dbg["costs"]["per_invocation"]
    want = {"decode": {str(nb) for nb in dec.table_buckets},
            "prefill": {str(b) for b in dec.prefill_buckets}}
    if {f: set(v) for f, v in per.items()} != want:
        failures.append(f"28f: cost entries {sorted(per)} "
                        f"{ {f: sorted(v) for f, v in per.items()} }")
    if not set(dbg["costs"]["dispatches"]) <= set(per):
        failures.append(f"28f: dispatched {dbg['costs']['dispatches']} "
                        "without a cost entry")
    fused = {b: c.get("fused") for b, c in per.get("decode", {}).items()}
    if set(fused.values()) != {1.0}:
        failures.append(f"28f: fused {fused} with the kernel on")
    mfu = dbg["costs"]["mfu_estimate"]
    if not dbg["paged_kernel"]["engaged"] or not 0 < mfu <= 1:
        failures.append(f"28f: engaged {dbg['paged_kernel']['engaged']}, "
                        f"MFU {mfu}")
    if any(dbg["tier"]["queues"].values()):
        failures.append(f"28f: tier queues {dbg['tier']['queues']} at idle")
    if "slo" not in info or "profiler" not in info:
        failures.append("28f: /info lacks slo or profiler")
    if not {"costs", "phases", "paged_kernel", "tier"} <= set(dbg):
        failures.append(f"28f: /debug/engine keys {sorted(dbg)}")
    return {"costs": dbg["costs"], "phases": dbg["phases"],
            "paged_kernel": dbg["paged_kernel"], "info_slo": info.get("slo"),
            "info_profiler": info.get("profiler")}


def tier_fetch_run(torch, ck, card, net, srv1, wave_a, toks_a, failures):
    """28e: a second server on the card fetches, for each of wave A's
    prompts, the head of its chain that server 1 (28d's, after wave B)
    still holds, from the root to the first block it lost: resident
    blocks (its /prefix/block copies them down first) and blocks in its
    host or disk tier, with POST /prefix/fetch -> GET /prefix/block. The
    prompts whose held heads reach deepest into server 1's tiers go
    first. Server 2 then serves those prompts: every fetched block is
    restored, only the rest of each prompt is prefilled."""
    from deeplearning4j_tpu_torch.inference.kvtier import prompt_chain
    feed = get_json(srv1.port, "/prefix/directory?since=0")
    tiers = {e["hash"]: e["tier"] for e in feed["events"]}
    heads = []
    for b in wave_a:
        head = []
        for h in prompt_chain(b["prompt"], KV_BLOCK):
            if tiers.get(h) not in ("hbm", "host", "disk"):
                break
            head.append(h)
        heads.append(head)
    held = [i for i, hd in enumerate(heads) if hd]
    pick = sorted(held, key=lambda i: -sum(tiers[h] != "hbm"
                                           for h in heads[i]))
    pick = sorted(pick[:TIER_FETCH_MAX])
    from_tier = {t: sum(tiers[h] == t for i in pick for h in heads[i])
                 for t in ("hbm", "host", "disk")}
    out = {"prompts": pick, "blocks": [len(heads[i]) for i in pick],
           "from_tier": from_tier}
    if not from_tier["host"] + from_tier["disk"]:
        failures.append(f"28e: no held block of wave A in server 1's host "
                        f"or disk tier: {from_tier}")
        return out
    srv2 = tier_server(net, host_cache_mb=TIER_HOST_MB)
    try:
        dec2 = srv2.decoder
        t0 = time.monotonic()
        res = [post_json(srv2.port, "/prefix/fetch",
                         {"peer": f"http://127.0.0.1:{srv1.port}",
                          "hashes": heads[i]}) for i in pick]
        out["fetch_s"] = time.monotonic() - t0
        n_blocks = sum(out["blocks"])
        if any(r["failed"] for r in res) or \
                sum(r["fetched"] for r in res) != n_blocks:
            failures.append(f"28e: fetch results {res}")
        deadline = time.monotonic() + TIER_SETTLE_S
        while time.monotonic() < deadline:
            if (tier_counters(srv2)["kv_tier_promoted_blocks_total"]
                    >= n_blocks and not any(
                        dec2.tier.stats()["queues"].values())):
                break
            time.sleep(0.05)
        out["promote_s"] = time.monotonic() - t0 - out["fetch_s"]
        out["promoted"] = tier_counters(srv2)["kv_tier_promoted_blocks_total"]
        toks, st = tier_wave(torch, ck, srv2, [wave_a[i] for i in pick])
        out["wave"] = st
    finally:
        srv2.stop()
    want_restored = sum(min(len(heads[i]) * KV_BLOCK,
                            len(wave_a[i]["prompt"]) - 1) for i in pick)
    prefilled = st["counters"]["prefill_tokens_total"]
    if toks != [toks_a[i] for i in pick]:
        failures.append("28e: server 2's tokens differ from server 1's")
    if st["prefix_restored_tokens"] != want_restored or \
            prefilled != sum(len(wave_a[i]["prompt"]) for i in pick) \
            - want_restored:
        failures.append(f"28e: restored {st['prefix_restored_tokens']} "
                        f"(want {want_restored}), prefilled {prefilled}")
    phase(28, f"(e) two servers on the card: server 2 fetched the held "
              f"heads of wave A's prompts {pick} ({out['blocks']} blocks: "
              f"{from_tier['host']} from server 1's host tier, "
              f"{from_tier['disk']} from its disk tier, {from_tier['hbm']} "
              f"copied down from its pool) from server 1's /prefix/block in "
              f"{out['fetch_s']:.3f} s, promoted {out['promoted']} in "
              f"{out['promote_s']:.3f} s; served them: tokens "
              f"{'identical' if toks == [toks_a[i] for i in pick] else 'DIFFERENT'}"
              f", restored {st['prefix_restored_tokens']} tokens (every "
              f"fetched block, less a whole prompt's refeed), prefilled "
              f"{prefilled} [{card}]")
    return out


def tier_disk_run(torch, ck, card, net, wave_a, wave_b, failures):
    """28c: a host tier of 4 MiB over a disk tier of 128 MiB. After waves
    A and B, the first tiered block of a wave-A chain that is on disk is
    truncated and that prompt served alone (its restore reads the torn
    file first: a counted miss, the block prefilled cold); then wave C."""
    from deeplearning4j_tpu_torch.inference.kvtier import (BLOCK_SUFFIX,
                                                           prompt_chain)
    out = {}
    torn = None
    with tempfile.TemporaryDirectory() as tdir:
        srv = tier_server(net, host_cache_mb=TIER_DISK_HOST_MB,
                          disk_cache_mb=TIER_DISK_MB, tier_dir=tdir)
        try:
            dec = srv.decoder
            toks_a, out["wave_a"] = tier_wave(torch, ck, srv, wave_a)
            tier_settle(dec)
            _, out["wave_b"] = tier_wave(torch, ck, srv, wave_b)
            tier_settle(dec)
            tiers = {e["hash"]: e["tier"] for e in get_json(
                srv.port, "/prefix/directory?since=0")["events"]}
            chains = [prompt_chain(b["prompt"], KV_BLOCK) for b in wave_a]
            out["disk_blocks_of_a"] = sum(
                tiers.get(h) == "disk" for ch in chains for h in ch)
            for i, ch in enumerate(chains):
                first = next((h for h in ch if tiers.get(h) != "hbm"), None)
                if first is not None and tiers.get(first) == "disk":
                    torn = (i, first)
                    break
            if torn is not None:
                path = os.path.join(tdir, torn[1] + BLOCK_SUFFIX)
                with open(path, "rb") as f:
                    raw = f.read()
                with open(path, "wb") as f:
                    f.write(raw[:-5])
                toks_t, out["torn_request"] = tier_wave(
                    torch, ck, srv, [wave_a[torn[0]]])
                tier_settle(dec)
                out["torn_dropped"] = torn[1] not in dec.tier._disk
            toks_c, out["wave_c"] = tier_wave(torch, ck, srv, wave_a)
            tier_settle(dec)
            out["tier"] = tier_stats(dec)
        finally:
            srv.stop()
    c = out["wave_c"]["counters"]
    if toks_c != toks_a:
        failures.append("28c: wave C's tokens differ from wave A's")
    if not c["kv_tier_hits_disk_total"] or \
            not c["kv_tier_promoted_blocks_total"]:
        failures.append(f"28c: disk hits {c['kv_tier_hits_disk_total']}, "
                        f"promoted {c['kv_tier_promoted_blocks_total']}")
    ct = out.get("torn_request", {}).get("counters", {})
    if torn is None or not out["torn_dropped"] or \
            not ct.get("kv_tier_restore_failed_total") or \
            toks_t != [toks_a[torn[0]]]:
        failures.append(f"28c: the torn block ({torn}) was not a counted "
                        f"miss served with the same tokens: {ct}")
    wc = out["wave_c"]
    phase(28, f"(c) host tier {TIER_DISK_HOST_MB} MiB over disk "
              f"{TIER_DISK_MB} MiB: {out['wave_b']['counters']['kv_tier_demoted_disk_blocks_total']}"
              f" blocks demoted to disk in wave B ({out['disk_blocks_of_a']} "
              f"of wave A's on disk); wave A's prompt "
              f"{torn[0] if torn else None} served alone after its first "
              f"tiered block's file was truncated: a miss "
              f"({ct.get('kv_tier_restore_failed_total')} failed restores, "
              f"the block out of the disk index: "
              f"{out.get('torn_dropped')}), tokens "
              f"{'identical' if torn and toks_t == [toks_a[torn[0]]] else 'DIFFERENT'}"
              f"; wave C tokens "
              f"{'identical' if toks_c == toks_a else 'DIFFERENT'} to wave "
              f"A's, disk hits {c['kv_tier_hits_disk_total']}, host hits "
              f"{c['kv_tier_hits_host_total']}, promoted "
              f"{c['kv_tier_promoted_blocks_total']}, restored "
              f"{wc['tier_restored_tokens']} tokens; TTFT p50 "
              f"{wc['ttft_ms_p50']:.3f} / p99 {wc['ttft_ms_p99']:.3f} ms "
              f"(wave A {out['wave_a']['ttft_ms_p50']:.3f} / "
              f"{out['wave_a']['ttft_ms_p99']:.3f}); a disk block's staging "
              f"(read, decode, pin) {out['tier']['restore_staging_ms_per_block']:.4f}"
              f" ms, spills {out['tier']['spill_ms_per_block']:.4f} ms a "
              f"block [{card}]")
    return out


def tier_fault_run(torch, ck, card, net, wave_a, wave_b, failures):
    """28d: tier.spill crash@n:5 during wave B, then (28e) a second
    server fetches wave-A chains from this one, then tier.restore
    crash@n:3 during wave C, then directory.publish crash@n:2 during a
    repeat of wave B: each fault degrades to a cold prefill with the same
    tokens."""
    from deeplearning4j_tpu_torch.inference import failpoints
    from deeplearning4j_tpu_torch.inference.kvtier import prompt_chain
    srv = tier_server(net, host_cache_mb=TIER_HOST_MB)
    try:
        dec = srv.decoder
        toks_a, _ = tier_wave(torch, ck, srv, wave_a)
        tier_settle(dec)
        steps = []
        for seam, spec, bodies in (("tier.spill", "crash@n:5", wave_b),
                                   ("tier.restore", "crash@n:3", wave_a),
                                   ("directory.publish", "crash@n:2",
                                    wave_b)):
            if seam == "tier.restore":
                fetch = tier_fetch_run(torch, ck, card, net, srv, wave_a,
                                       toks_a, failures)
            failpoints.arm(seam, spec)
            try:
                toks, st = tier_wave(torch, ck, srv, bodies)
                tier_settle(dec)
            finally:
                failpoints.disarm()
            steps.append((seam, toks, st["counters"]))
        held = all(dec.tier.holds(h) for b in wave_b
                   for h in prompt_chain(b["prompt"], KV_BLOCK))
    finally:
        failpoints.disarm()
        srv.stop()
    (_, toks_b, cb), (_, toks_c, cc), (_, toks_b2, cp) = steps
    out = {"spill_dropped": cb["kv_tier_spill_dropped_total"],
           "restore_failed": cc["kv_tier_restore_failed_total"],
           "publish_dropped": cp["kv_tier_publish_dropped_total"],
           "state_held": held, "fetch": fetch}
    if toks_c != toks_a or toks_b2 != toks_b:
        failures.append("28d: tokens differ under a tier fault")
    if not (out["spill_dropped"] and out["restore_failed"]
            and out["publish_dropped"] and held):
        failures.append(f"28d: faults not counted or state lost: {out}")
    phase(28, f"(d) faults: tier.spill crash@n:5 dropped "
              f"{out['spill_dropped']} spill(s), tier.restore crash@n:3 "
              f"failed {out['restore_failed']} restore(s), "
              f"directory.publish crash@n:2 dropped "
              f"{out['publish_dropped']} event(s) and every block of wave "
              f"B stays in the directory ({held}); tokens "
              f"{'identical' if toks_c == toks_a and toks_b2 == toks_b else 'DIFFERENT'}"
              f" [{card}]")
    return out


def profiler_overhead_run(torch, ck, card, net, wave_a, failures,
                          attribution=None):
    """28f's other servers: a kernel-off server's fused flags, and wave
    A's served rate with the profiler armed and disarmed (printed, not
    gated; the tokens must not change).
    ``attribution``: 28a's reads, for the printed kernel-on flags."""
    out = {}
    on = sorted({c.get("fused") for c in (attribution or {}).get(
        "costs", {}).get("per_invocation", {}).get("decode", {}).values()})
    srv = tier_server(net, paged_kernel="off", kv_pool_mb=KV_POOL_MB,
                      prefill_chunk=CHUNK)
    try:
        dbg = get_json(srv.port, "/debug/engine")
    finally:
        srv.stop()
    fused = {b: c.get("fused") for b, c in
             dbg["costs"]["per_invocation"]["decode"].items()}
    out["off_fused"] = fused
    if set(fused.values()) != {0.0} or dbg["paged_kernel"]["engaged"]:
        failures.append(f"28f: kernel-off server fused {fused}")
    # one warmed server, the step-phase profiler armed and disarmed in
    # turns over whole waves (wall time: every lap, count and iter_end)
    srv = tier_server(net, kv_pool_mb=KV_POOL_MB, prefill_chunk=CHUNK)
    rates, toks = {True: [], False: []}, {True: [], False: []}
    prof = srv.decoder.profiler
    try:
        post(srv.port, {"prompt": wave_a[0]["prompt"][:CHUNK + 3],
                        "max_new_tokens": 4})
        tier_wave(torch, ck, srv, wave_a)  # caches wave A's prompts
        for k in range(TIER_PROFILE_WAVES):
            armed = k % 4 in (0, 3)
            prof.enabled = armed
            t, st = tier_wave(torch, ck, srv, wave_a)
            rates[armed].append(st["tokens"] / st["wall_s"])
            toks[armed].append(t)
    finally:
        prof.enabled = True
        srv.stop()
    out["tokens_per_s_armed"] = rates[True]
    out["tokens_per_s_disarmed"] = rates[False]
    out["ratio"] = sum(rates[True]) / sum(rates[False])
    if any(t != toks[True][0] for t in toks[True] + toks[False]):
        failures.append("28f: the profiler changed the served tokens")
    phase(28, f"(f) /debug/engine on 28a's server and a kernel-off one: "
              f"fused {on} on the decode buckets with the kernel on, "
              f"{sorted(set(fused.values()))} off; wave A's served tokens/s "
              f"over each wave's wall time on one warmed server, the "
              f"step-phase profiler armed {rates[True]} / disarmed "
              f"{rates[False]} (in turns on, off, off, on), tokens "
              f"identical: ratio {out['ratio']:.4f} (printed; the JAX bench "
              f"floors it at 0.95) [{card}]")
    return out


def phase28(torch, ck, card):
    """Phase 28: the KV tiers (28a-e) and the attribution plane (28f) on
    the flagship at full width. Failures are gathered and raised at the
    end."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    t0 = time.monotonic()
    failures = []
    net = ComputationGraph(transformer_lm(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_blocks=BLOCKS,
        rope=True, seed=7), device="cuda").init()
    wave_a, wave_b = tier_waves(seed=28)
    out = {"fp32": tier_host_run(torch, ck, card, net, wave_a, wave_b, None,
                                 failures),
           "int8": tier_host_run(torch, ck, card, net, wave_a, wave_b,
                                 "int8", failures)}
    out["disk"] = tier_disk_run(torch, ck, card, net, wave_a, wave_b,
                                failures)
    out["faults"] = tier_fault_run(torch, ck, card, net, wave_a, wave_b,
                                   failures)
    out["profiler"] = profiler_overhead_run(
        torch, ck, card, net, wave_a, failures,
        out["fp32"].get("attribution"))
    out["seconds"] = time.monotonic() - t0
    phase(28, f"phase 28 took {out['seconds']:.3f} s [{card}]")
    PHASE28_FIGURES.update(out)
    if failures:
        raise SystemExit("phase 28 failed: " + " | ".join(failures))
    return out


# -- phase 29: the captured training step against the eager one -------------
TG_STEPS = 5            # steps of each path in each mode (the 32k LM: 3)
TG_PROFILE_STEPS = 2    # steps under torch.profiler in each mode
ACCUM_TOL = 1e-5        # 29c: accumulated K = 4 against the full batch,
                        # max |diff| of the params after 5 Sgd steps


def tg_state(net):
    """Host copies of everything a step writes: the params, the updater
    state and the BatchNorm variables (a network's list, a graph's dict
    by sorted vertex name), flat."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.precision import host_array
    parts = [net.params_flat(), net.updater_state_flat()]
    vs = net.variables
    for lv in ([vs[k] for k in sorted(vs)] if isinstance(vs, dict) else vs):
        parts += [host_array(lv[k]).reshape(-1) for k in sorted(lv)]
    return np.concatenate([p.astype(np.float64) for p in parts])


def tg_run(torch, ck, make, feed, steps, mode, profiled=True):
    """``steps`` steps (``feed(net)`` each) of a fresh ``make(mode)``:
    the losses of every step (a truncated-BPTT fit gives one a window),
    the state after, each step's launches and host seconds up to a
    synchronize, the graphs captured and replayed, and (``profiled``) a
    profile of TG_PROFILE_STEPS more steps (the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile
    net = make(mode)
    lis = WindowLosses()
    net.set_listeners(lis)
    per_step, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.monotonic()
        feed(net)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        per_step.append({k: v for k, v in ck.LAUNCHES.items() if v})
    out = {"losses": lis.values(), "state": tg_state(net),
           "launches": per_step, "secs": secs,
           "captures": net._graphs.captures, "replays": net._graphs.replays}
    net.set_listeners()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(TG_PROFILE_STEPS):
                feed(net)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        busy = sum(device_kernels_ms(prof).values())
        out.update(profile_wall_ms=wall * 1e3, device_busy_ms=busy,
                   device_busy_share=busy / (wall * 1e3))
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tg_gap(a, b):
    """0.0 where two runs are bitwise equal (losses and state), else the
    largest |difference| of either."""
    import numpy as np
    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    if np.array_equal(la, lb) and np.array_equal(a["state"], b["state"]):
        return 0.0
    return float(max(np.abs(la - lb).max(initial=0.0),
                     np.abs(a["state"] - b["state"]).max(initial=0.0)))


def tg_paths(torch):
    """(name, make(mode), feed(net), steps): every training path phases 6,
    7, 10, 12, 21, 23 and 24 run, and an MLP with dropout, AdamW and an
    exponential lr schedule (every step-dependent scalar in the row)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import (alexnet_cifar10,
                                                     char_rnn_lstm,
                                                     lenet_mnist,
                                                     transformer_lm)
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater.updaters import Adam
    rng = np.random.default_rng(0)
    xa = torch.from_numpy(rng.normal(size=(512, 32, 32, 3)).astype(
        np.float32)).cuda()
    ya = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, 512)]).cuda()
    xl = torch.from_numpy(rng.normal(size=(512, 28, 28, 1)).astype(
        np.float32)).cuda()
    xm = torch.from_numpy(rng.normal(size=(256, 784)).astype(
        np.float32)).cuda()
    ym = ya[:256]
    cx, cy, _ = char_batch(1, CHAR_B, CHAR_T)
    cx, cy = torch.from_numpy(cx).cuda(), torch.from_numpy(cy).cuda()
    x256, y256 = lm_batch(torch, 256, 32)
    x8k, y8k = lm_batch(torch, 8192, 1)
    x32k, y32k = lm_batch(torch, 32768, 1)

    def mln(conf_fn):
        return lambda mode: MultiLayerNetwork(
            conf_fn(), device="cuda", train_graphs=mode).init()

    def alex(dtype, cdt=None):
        def conf():
            c = alexnet_cifar10(dtype=dtype)
            c.conf.compute_dtype = cdt
            return c
        return conf

    def mlp():
        return (NeuralNetConfiguration.builder()
                .seed(5).learning_rate(1e-3)
                .updater(Adam(weight_decay=1e-4))
                .lr_policy("exponential").lr_policy_decay_rate(0.9)
                .list()
                .layer(DenseLayer(n_in=784, n_out=1024, activation="relu",
                                  dropout=0.5))
                .layer(DenseLayer(n_in=1024, n_out=1024, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_in=1024, n_out=10, activation="softmax",
                                   loss="negativeloglikelihood"))
                .build())

    def lm(heads, *, remat=False, dtype="float32"):
        def make(mode):
            conf = transformer_lm(vocab_size=VOCAB, d_model=D_MODEL,
                                  n_heads=heads, n_blocks=BLOCKS, dtype=dtype)
            conf.conf.remat = remat
            return ComputationGraph(conf, device="cuda",
                                    train_graphs=mode).init()
        return make

    return [
        ("alexnet_f32", mln(alex("float32")),
         lambda n: n.fit_batch(xa, ya), TG_STEPS),
        ("alexnet_bf16", mln(alex("bfloat16")),
         lambda n: n.fit_batch(xa, ya), TG_STEPS),
        ("alexnet_mixed", mln(alex("float32", "bfloat16")),
         lambda n: n.fit_batch(xa, ya), TG_STEPS),
        ("lenet_f32", mln(lenet_mnist), lambda n: n.fit_batch(xl, ya),
         TG_STEPS),
        ("mlp_dropout_adamw_exp", mln(mlp), lambda n: n.fit_batch(xm, ym),
         TG_STEPS),
        ("lm_t256_f32", lm(HEADS), lambda n: n.fit_batch(x256, y256),
         TG_STEPS),
        ("lm_t8192_bf16", lm(4, dtype="bfloat16"),
         lambda n: n.fit_batch(x8k, y8k), TG_STEPS),
        ("lm_t32768_remat_f32", lm(4, remat=True),
         lambda n: n.fit_batch(x32k, y32k), 3),
        ("char_rnn_tbptt", mln(lambda: char_rnn_lstm()),
         lambda n: n.fit(cx, cy), 3),
    ]


def tg_new_entry_points(torch, ck, failures):
    """29b-29e: fit_scan K = 16 against 16 fit_batch calls (LeNet, both
    captured: bitwise), fit_batch_accumulated K = 4 against the full batch
    (an Sgd MLP, ACCUM_TOL), a short dbn_mnist pretrain and finetune and
    an LBFGS fit (finite, the loss falling), and a captured step under
    torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import dbn_mnist, lenet_mnist
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    rng = np.random.default_rng(3)
    out = {}
    # 29b: fit_scan
    xs = torch.from_numpy(rng.normal(size=(16, 128, 28, 28, 1)).astype(
        np.float32)).cuda()
    ys = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (16, 128))]).cuda()
    a = MultiLayerNetwork(lenet_mnist(), device="cuda").init()
    b = MultiLayerNetwork(lenet_mnist(), device="cuda").init()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    la = a.fit_scan(xs, ys)
    torch.cuda.synchronize()
    scan_s = time.monotonic() - t0
    lb = []
    t0 = time.monotonic()
    for k in range(16):
        b.fit_batch(xs[k], ys[k])
        lb.append(b._score_raw)
    torch.cuda.synchronize()
    batch_s = time.monotonic() - t0
    scan_equal = (np.array_equal(la.cpu().numpy(),
                                 torch.stack(lb).cpu().numpy())
                  and np.array_equal(tg_state(a), tg_state(b)))
    out["fit_scan"] = {"bitwise_equal": scan_equal, "scan_s": scan_s,
                       "fit_batch_s": batch_s, "steps": a.step}
    if not scan_equal:
        failures.append("29b: fit_scan K=16 differs from 16 fit_batch calls")
    del a, b
    # 29c: fit_batch_accumulated against the full batch

    def mlp():
        return MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(9).learning_rate(0.1)
            .updater(Sgd()).list()
            .layer(DenseLayer(n_in=64, n_out=256, activation="tanh"))
            .layer(DenseLayer(n_in=256, n_out=256, activation="relu"))
            .layer(OutputLayer(n_in=256, n_out=10, activation="softmax",
                               loss="negativeloglikelihood")).build(),
            device="cuda").init()
    xb = torch.from_numpy(rng.normal(size=(512, 64)).astype(
        np.float32)).cuda()
    yb = ys[0].repeat(4, 1)
    full, acc = mlp(), mlp()
    for _ in range(5):
        full.fit_batch(xb, yb)
        acc.fit_batch_accumulated(xb, yb, 4)
    gap = float(np.abs(full.params_flat() - acc.params_flat()).max())
    out["accumulated"] = {"max_abs_diff": gap, "tol": ACCUM_TOL,
                          "captures": acc._graphs.captures,
                          "score_full": full.score_,
                          "score_accumulated": acc.score_}
    if not gap <= ACCUM_TOL:
        failures.append(f"29c: accumulated K=4 params differ by {gap}")
    # 29d: dbn_mnist pretrain + finetune; an LBFGS fit
    protos = rng.uniform(0, 1, (10, 784)) > 0.5
    lab = rng.integers(0, 10, 512)
    xd = (protos[lab] ^ (rng.uniform(size=(512, 784)) < 0.08)).astype(
        np.float32)
    it = ListDataSetIterator(DataSet(xd, np.eye(10, dtype=np.float32)[lab]),
                             batch=128)
    dbn = MultiLayerNetwork(dbn_mnist(), device="cuda").init()
    t0 = time.monotonic()
    dbn.pretrain(it)
    pre_score = dbn.score_
    losses = []
    for _ in range(10):
        it.reset()
        dbn.finetune(it)
        losses.append(dbn.score_)
    out["dbn"] = {"pretrain_score": pre_score, "finetune_losses": losses,
                  "seconds": time.monotonic() - t0}
    if not (np.isfinite(pre_score) and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        failures.append(f"29d: dbn_mnist pretrain {pre_score}, finetune "
                        f"{losses}")
    lconf = (NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
             .optimization_algo("lbfgs").iterations(25).list()
             .layer(DenseLayer(n_in=64, n_out=64, activation="tanh"))
             .layer(OutputLayer(n_in=64, n_out=10, activation="softmax",
                                loss="negativeloglikelihood")).build())
    lnet = MultiLayerNetwork(lconf, device="cuda").init()
    before = lnet.score(x=xb, y=yb)
    lnet.fit(xb, yb)
    after = lnet.score(x=xb, y=yb)
    out["lbfgs"] = {"before": before, "after": after}
    if not (np.isfinite(after) and after < before):
        failures.append(f"29d: LBFGS fit {before} -> {after}")
    # 29e: a captured step under the sync guard (inputs on the card)
    g = MultiLayerNetwork(lenet_mnist(), device="cuda").init()
    g.fit_batch(xs[0], ys[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(1, 4):
            g.fit_batch(xs[k], ys[k])
        guard = None
    except RuntimeError as e:
        guard = str(e)[:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["sync_guard"] = {"error": guard, "replays": g._graphs.replays}
    if guard is not None or g._graphs.replays != 3:
        failures.append(f"29e: a captured step under the sync guard: {guard}")
    return out


def phase29(torch, ck, card):
    """Each training path of phases 6, 7, 10, 12, 21, 23 and 24 captured
    (train_graphs="on") against eager ("off"), then the new entry points
    (tg_new_entry_points). Per path: one captured run and two eager runs
    of the same init, seeds and batches; losses, params, updater state
    and variables must be bitwise equal to the eager run where the two
    eager runs are bitwise equal, and no further from it than the second
    eager run where not; each step's launches, kernel by kernel, equal
    the eager step's; step ms and the busy share printed for both. cuDNN
    takes its deterministic algorithms in this phase (its default conv
    backward sums with atomics, so two eager AlexNet runs part by ~4e-3
    after 5 Adam steps and the comparison could show nothing)."""
    failures = []
    rows = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        new = tg_compare(torch, ck, card, rows, failures)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    phase(29, f"fit_scan K=16 {new['fit_scan']}; fit_batch_accumulated K=4 "
              f"{new['accumulated']}; dbn_mnist {new['dbn']}; LBFGS "
              f"{new['lbfgs']}; sync guard {new['sync_guard']}")
    if failures:
        raise SystemExit("phase 29 failed: " + "; ".join(failures))
    return {"paths": rows, **new}


def tg_compare(torch, ck, card, rows, failures):
    """phase29's paths into ``rows``, then the new entry points."""
    for name, make, feed, steps in tg_paths(torch):
        on = tg_run(torch, ck, make, feed, steps, "on")
        off = tg_run(torch, ck, make, feed, steps, "off")
        off2 = tg_run(torch, ck, make, feed, steps, "off", profiled=False)
        ee, ce = tg_gap(off, off2), tg_gap(on, off)
        launches_ok = on["launches"] == off["launches"]
        if not (ce == 0.0 if ee == 0.0 else ce <= ee):
            failures.append(f"{name}: captured against eager {ce}, eager "
                            f"against eager {ee}")
        if not launches_ok:
            failures.append(f"{name}: launches captured {on['launches']}, "
                            f"eager {off['launches']}")
        if on["captures"] == 0 or on["replays"] == 0 or off["captures"]:
            failures.append(f"{name}: captures {on['captures']}, replays "
                            f"{on['replays']}, eager captures "
                            f"{off['captures']}")
        # steady-state step ms: the steps after the first (a capture)
        ms = {m: statistics.median(r["secs"][1:]) * 1e3
              for m, r in (("captured", on), ("eager", off))}
        rows[name] = {
            "steps": steps, "captured_vs_eager": ce, "eager_vs_eager": ee,
            "launches_per_step": on["launches"][-1], "launches_equal":
            launches_ok, "captures": on["captures"],
            "replays": on["replays"], "step_ms": ms,
            "first_step_ms": {"captured": on["secs"][0] * 1e3,
                              "eager": off["secs"][0] * 1e3},
            "busy_share": {"captured": on["device_busy_share"],
                           "eager": off["device_busy_share"]},
            "losses": on["losses"]}
        phase(29, f"{name}: captured {ms['captured']:.3f} ms a step (busy "
                  f"{on['device_busy_share']:.4f}) against eager "
                  f"{ms['eager']:.3f} ms (busy "
                  f"{off['device_busy_share']:.4f}); captured vs eager "
                  f"{ce}, eager vs eager {ee}; launches a step "
                  f"{on['launches'][-1]} (equal {launches_ok}); "
                  f"{on['captures']} captures, {on['replays']} replays "
                  f"[{card}]")
    return tg_new_entry_points(torch, ck, failures)


# -- phase 30: ComputationGraph vertices, BN variables, early stopping --------

CG_STEPS = 5            # 30a, 30c: captured against eager
CG_OUT_REL = 1e-5       # 30a: graph against the network, eval outputs,
                        # max |diff| / max |network output|
ES_B = 512              # 30b: the early-stopping batches
ES_TRAIN, ES_HELD = 8, 2
ES_MAX_EPOCHS, ES_PATIENCE = 4, 2
S2S_B, S2S_HIDDEN, S2S_STEPS, S2S_EVAL = 128, 64, 200, 256
S2S_VOCAB = "0123456789+ "  # examples/seq2seq_addition.py's 12 symbols
S2S_Q, S2S_A = 5, 3
P30_DEV = "cuda"        # "cpu" rehearses phase 30 (with smaller sizes)


def alexnet_graph_conf():
    """alexnet_cifar10() as a ComputationGraph: one LayerVertex per layer
    of the list after shape inference, named l00-l10 in layer order (the
    graph's init, by sorted name, then draws the list's params), each
    with the list's preprocessor (CnnToFeedForward on the dense vertex),
    and a FeedForwardToCnn on the first, so flat CIFAR rows feed it."""
    import copy
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
        FeedForwardToCnnPreProcessor
    conf = alexnet_cifar10()
    gb = GraphBuilder(copy.deepcopy(conf.conf)).add_inputs("in")
    src = "in"
    for i, lc in enumerate(conf.layers):
        pre = conf.preprocessor(i)
        if i == 0:
            pre = FeedForwardToCnnPreProcessor(32, 32, 3)
        gb.add_layer(f"l{i:02d}", lc, src, preprocessor=pre)
        src = f"l{i:02d}"
    return gb.set_outputs(src).build(), conf


def graph_steps(torch, ck, net, feeds):
    """One fit_batch per (inputs, labels) of ``feeds``: the losses, each
    step's launches (up to a synchronize) and host seconds."""
    lis = WindowLosses()
    net.set_listeners(lis)
    launches, secs = [], []
    for ins, labs in feeds:
        sync(torch, P30_DEV)
        ck.reset_launches()
        t0 = time.monotonic()
        net.fit_batch(ins, labs)
        sync(torch, P30_DEV)
        secs.append(time.monotonic() - t0)
        launches.append({k: v for k, v in ck.LAUNCHES.items() if v})
    net.set_listeners()
    return lis.values(), launches, secs


def graph_alexnet(torch, ck, card, data, failures):
    """30a: AlexNet as a graph, 5 Adam steps captured against eager, then
    held against the MultiLayerNetwork on the same params and BN
    variables (eval outputs)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    gconf, lconf = alexnet_graph_conf()
    x = data.features.reshape(-1, 32, 32, 3)
    batches = [(torch.from_numpy(x[k * ES_B:(k + 1) * ES_B]).to(P30_DEV),
                torch.from_numpy(data.labels[k * ES_B:(k + 1) * ES_B]).to(
                    P30_DEV)) for k in range(ES_TRAIN + ES_HELD)]
    runs = {}
    for mode in ("on", "off"):
        g = ComputationGraph(gconf, device=P30_DEV, train_graphs=mode).init()
        losses, launches, secs = graph_steps(
            torch, ck, g, [([xb], [yb]) for xb, yb in batches[:CG_STEPS]])
        runs[mode] = {"net": g, "losses": losses, "launches": launches,
                      "secs": secs, "state": tg_state(g)}
    on, off = runs["on"], runs["off"]
    bitwise = (on["losses"] == off["losses"]
               and np.array_equal(on["state"], off["state"]))
    gap = 0.0 if bitwise else float(np.abs(on["state"] - off["state"]).max())
    per_step = [l.get("conv2d_bias_act", 0) for l in on["launches"]]
    g = on["net"]
    if not bitwise:
        failures.append(f"30a: captured against eager differ by {gap}")
    if on["launches"] != off["launches"] or per_step != [3] * CG_STEPS:
        failures.append(f"30a: launches captured {on['launches']}, eager "
                        f"{off['launches']}")
    if g._graphs.captures != int(P30_DEV != "cpu") or \
            g._graphs.replays != (CG_STEPS - 1) * int(P30_DEV != "cpu"):
        failures.append(f"30a: {g._graphs.captures} captures, "
                        f"{g._graphs.replays} replays")
    # the network on the graph's params and BN variables
    mln = MultiLayerNetwork(lconf, device=P30_DEV).init()
    init_equal = np.array_equal(
        mln.params_flat(), ComputationGraph(gconf, device=P30_DEV).init()
        .params_flat())
    mln.set_params_flat(g.params_flat())
    for i, lv in enumerate(mln.variables):
        for k, t in lv.items():
            t.copy_(g.variables[f"l{i:02d}"][k])
    xh = batches[-1][0]
    ref = mln.output(xh)
    got = g.output(xh)[0]
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not (init_equal and rel <= CG_OUT_REL):
        failures.append(f"30a: graph against the network: init equal "
                        f"{init_equal}, outputs {rel}")
    ms = {m: statistics.median(r["secs"][1:]) * 1e3 for m, r in runs.items()}
    out = {"params": g.num_params(), "losses": on["losses"],
           "captured_vs_eager_bitwise": bitwise, "gap": gap,
           "conv_launches_per_step": per_step,
           "launches_per_step": on["launches"][-1],
           "captures": g._graphs.captures, "replays": g._graphs.replays,
           "step_ms": ms, "vs_network_rel": rel, "init_equal": init_equal}
    phase(30, f"(a) AlexNet-CIFAR10 as a ComputationGraph ({out['params']} "
              f"params, B={ES_B}, data {data.source}): {CG_STEPS} Adam steps "
              f"captured against eager bitwise {bitwise} (gap {gap}), losses "
              f"{on['losses']}; row 3 (conv2d_bias_act) launches a step "
              f"{per_step} (the graph does not fuse BN + pool: launches "
              f"{on['launches'][-1]}); step {ms['on']:.3f} ms captured, "
              f"{ms['off']:.3f} eager; eval outputs against the "
              f"MultiLayerNetwork on the same params and BN variables: "
              f"max |diff| / max |ref| {rel:.3e} (gate {CG_OUT_REL}) [{card}]")
    return out


def graph_early_stopping(torch, card, data, failures):
    """30b: early stopping on a fresh AlexNet graph, the best model
    written and restored, in memory and through LocalFileModelSaver."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import earlystopping as es
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_computation_graph, write_model)
    n_train = ES_TRAIN * ES_B
    train = DataSet(data.features[:n_train], data.labels[:n_train])
    held = DataSet(data.features[n_train:], data.labels[n_train:])
    held_it = ListDataSetIterator(held, ES_B)
    net = ComputationGraph(alexnet_graph_conf()[0], device=P30_DEV).init()
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(held_it),
        model_saver=es.InMemoryModelSaver(),
        epoch_termination_conditions=[
            es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
            es.ScoreImprovementEpochTerminationCondition(ES_PATIENCE)])
    t0 = time.monotonic()
    result = es.EarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(train, ES_B)).fit()
    fit_s = time.monotonic() - t0
    best = result.best_model
    acc = best.evaluate(held_it).accuracy()
    xh = held.features[:ES_B]
    want = best.output(xh)[0]
    trips = {}
    with tempfile.TemporaryDirectory() as d:
        write_model(best, Path(d) / "best.zip")
        back = restore_computation_graph(Path(d) / "best.zip",
                                         device=P30_DEV)
        saver = es.LocalFileModelSaver(str(Path(d) / "saver"))
        saver.save_best_model(best, result.best_model_score)
        from_saver = saver.get_best_model()
        for name, g in (("write_model", back), ("LocalFileModelSaver",
                                                from_saver)):
            vars_equal = all(torch.equal(g.variables[v][k],
                                         best.variables[v][k])
                             for v in best.variables
                             for k in best.variables[v])
            trips[name] = {
                "graph": type(g).__name__, "device": str(g.device),
                "outputs_bitwise": bool(torch.equal(g.output(xh)[0], want)),
                "params_bitwise": bool(np.array_equal(g.params_flat(),
                                                      best.params_flat())),
                "variables_bitwise": vars_equal, "step": g.step}
    for name, t in trips.items():
        if not (t["graph"] == "ComputationGraph" and t["outputs_bitwise"]
                and t["params_bitwise"] and t["variables_bitwise"]
                and t["device"].startswith(P30_DEV)):
            failures.append(f"30b: {name} round trip {t}")
    scores = [result.score_vs_epoch[e] for e in sorted(result.score_vs_epoch)]
    if not (result.total_epochs <= ES_MAX_EPOCHS
            and all(np.isfinite(scores)) and 0.0 <= acc <= 1.0
            and result.best_model_score == min(scores)):
        failures.append(f"30b: early stopping {result}")
    out = {"epochs": result.total_epochs,
           "best_epoch": result.best_model_epoch,
           "score_per_epoch": scores, "reason": result.termination_reason,
           "details": result.termination_details, "best_accuracy": acc,
           "fit_s": fit_s, "round_trips": trips}
    phase(30, f"(b) early stopping on it ({ES_TRAIN} batches of {ES_B}, "
              f"{ES_HELD} held out; MaxEpochs({ES_MAX_EPOCHS}), "
              f"ScoreImprovement({ES_PATIENCE}), InMemoryModelSaver): "
              f"{out['epochs']} epochs ({out['reason']}: {out['details']}), "
              f"best epoch {out['best_epoch']}, held-out score per epoch "
              f"{scores}, the best model's accuracy {acc:.4f}, {fit_s:.3f} s; "
              f"round trips {trips} [{card}]")
    return out


def s2s_conf(hidden=S2S_HIDDEN):
    """examples/seq2seq_addition.py's encoder-decoder graph: GravesLSTM
    encoder, last time step, duplicated over the answer's 3 steps,
    GravesLSTM decoder, softmax RnnOutputLayer; Adam 3e-3, seed 0."""
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        DuplicateToTimeSeriesVertex, LastTimeStepVertex)
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.updater.updaters import Adam
    V = len(S2S_VOCAB)
    gb = (NeuralNetConfiguration.builder().seed(0).learning_rate(3e-3)
          .updater(Adam()).graph_builder()
          .add_inputs("question", "answer_shape")
          .add_layer("enc", GravesLSTM(n_in=V, n_out=hidden,
                                       activation="tanh"), "question")
          .add_vertex("thought", LastTimeStepVertex(), "enc")
          .add_vertex("repeat", DuplicateToTimeSeriesVertex(
              reference_input="answer_shape"), "thought")
          .add_layer("dec", GravesLSTM(n_in=hidden, n_out=hidden,
                                       activation="tanh"), "repeat")
          .add_layer("out", RnnOutputLayer(n_in=hidden, n_out=V,
                                           activation="softmax",
                                           loss="mcxent"), "dec"))
    return gb.set_outputs("out").build()


def s2s_batch(rng, n):
    """One-hot "a+b" questions and zero-padded 3-digit answers."""
    import numpy as np
    eye = np.eye(len(S2S_VOCAB), dtype=np.float32)
    xs, ys = [], []
    for _ in range(n):
        a, b = rng.integers(0, 50), rng.integers(0, 50)
        xs.append(eye[[S2S_VOCAB.index(c) for c in f"{a}+{b}".ljust(S2S_Q)]])
        ys.append(eye[[S2S_VOCAB.index(c) for c in str(a + b).zfill(S2S_A)]])
    return np.stack(xs), np.stack(ys)


def graph_seq2seq(torch, ck, card, failures):
    """30c: the addition encoder-decoder at the example's widths."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    shape = np.zeros((S2S_B, S2S_A, 1), np.float32)
    rng = np.random.default_rng(0)
    feeds = [s2s_batch(rng, S2S_B) for _ in range(CG_STEPS + S2S_STEPS)]
    feeds = [([x, shape], [y]) for x, y in feeds]
    runs = {}
    for mode in ("on", "off"):
        g = ComputationGraph(s2s_conf(), device=P30_DEV,
                             train_graphs=mode).init()
        runs[mode] = (g,) + graph_steps(torch, ck, g, feeds[:CG_STEPS])
    (g, l_on, _, s_on), (e, l_off, _, _) = runs["on"], runs["off"]
    bitwise = (l_on == l_off
               and np.array_equal(tg_state(g), tg_state(e)))
    if not bitwise:
        failures.append(f"30c: captured {l_on} against eager {l_off}")
    losses, _, secs = graph_steps(torch, ck, g, feeds[CG_STEPS:])
    losses = l_on + losses
    x, y = s2s_batch(np.random.default_rng(1), S2S_EVAL)
    pred = g.output(x, np.zeros((S2S_EVAL, S2S_A, 1), np.float32))[0]
    pred = pred.argmax(-1).cpu().numpy()
    digit_acc = float((pred == y.argmax(-1)).mean())
    answer_acc = float((pred == y.argmax(-1)).all(-1).mean())
    if not all(np.isfinite(losses)):
        failures.append(f"30c: losses {losses}")
    out = {"captured_vs_eager_bitwise": bitwise,
           "losses_at": {k: losses[k] for k in (0, 100, 200)},
           "digit_accuracy": digit_acc, "answer_accuracy": answer_acc,
           "step_ms": statistics.median(secs) * 1e3,
           "captures": g._graphs.captures, "replays": g._graphs.replays}
    phase(30, f"(c) seq2seq addition (GravesLSTM {S2S_HIDDEN}, B={S2S_B}, "
              f"question {S2S_Q}, answer {S2S_A}, {len(S2S_VOCAB)} symbols, "
              f"Adam 3e-3): {CG_STEPS} steps captured against eager bitwise "
              f"{bitwise}; then {S2S_STEPS} captured steps, {out['step_ms']:.3f}"
              f" ms a step; loss at steps 0/100/200 "
              f"{[out['losses_at'][k] for k in (0, 100, 200)]}; digit "
              f"accuracy on {S2S_EVAL} fresh problems {digit_acc:.4f} "
              f"(whole answers {answer_acc:.4f}; a report, no gate) [{card}]")
    return out


def graph_gradient_checks(torch, card, failures):
    """30d: check_gradients at float64 on the card: a conv + BN + dense
    network and a masked GravesLSTM network (the JAX sweep's shapes)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        BatchNormalization, ConvolutionLayer, DenseLayer, GravesLSTM,
        OutputLayer, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    from deeplearning4j_tpu_torch.util import check_gradients

    def net(*layers, input_type=None, l2=0.0):
        b = (NeuralNetConfiguration.builder().seed(42).dtype("float64")
             .updater(Sgd()).regularization(l2 > 0).l2(l2).list())
        for layer in layers:
            b.layer(layer)
        if input_type is not None:
            b.set_input_type(input_type)
        return MultiLayerNetwork(b.build(), device=P30_DEV).init()
    rng = np.random.default_rng(0)
    cnn = net(ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                               activation="identity"),
              BatchNormalization(activation="relu"),
              DenseLayer(n_out=5, activation="tanh"),
              OutputLayer(n_out=2, activation="softmax",
                          loss="negativeloglikelihood"),
              input_type=InputType.convolutional(6, 6, 2), l2=0.01)
    x = rng.normal(size=(4, 6, 6, 2))
    y = np.eye(2)[rng.integers(0, 2, 4)]
    lstm = net(GravesLSTM(n_in=3, n_out=4, activation="tanh"),
               RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                              loss="mcxent"))
    xs = rng.normal(size=(3, 5, 3))
    ys = np.zeros((3, 5, 2))
    ys[:, :, 0] = 1.0
    mask = np.ones((3, 5))
    mask[0, 3:] = 0
    mask[1, 1:] = 0
    out = {}
    for name, n, args, kw in (("conv_bn_dense", cnn, (x, y), {}),
                              ("masked_graves_lstm", lstm, (xs, ys),
                               {"fmask": mask, "lmask": mask})):
        t0 = time.monotonic()
        ok = check_gradients(n, *args, **kw)
        out[name] = {"passed": ok, "params": n.num_params(),
                     "device": str(n.device),
                     "seconds": time.monotonic() - t0}
        if not ok:
            failures.append(f"30d: {name} fails the gradient check")
    phase(30, f"(d) check_gradients at float64 on the card (eps 1e-6, max "
              f"relative error 1e-3, min absolute 1e-9; every parameter): "
              f"{out}. float64 runs the plain paths: the conv's kw*c = 4 < 8,"
              f" so the seam declines the kernel as the JAX seam does, and "
              f"no kernel has a float64 variant [{card}]")
    return out


def phase30(torch, ck, card):
    """30a-30e: see the module docstring. cuDNN takes its deterministic
    algorithms for the phase, as in phase 29."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        CifarDataSetIterator
    t0 = time.monotonic()
    failures = []
    # the CIFAR-10 iterator's offline stand-in (or real batches where a
    # user put them under DL4J_TPU_DATA_DIR)
    it = CifarDataSetIterator(ES_B, num_examples=ES_B * (ES_TRAIN + ES_HELD))
    data = DataSet.merge(list(it))
    data.source = it.source
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"data_source": data.source,
               "alexnet_graph": graph_alexnet(torch, ck, card, data,
                                              failures),
               "early_stopping": graph_early_stopping(torch, card, data,
                                                      failures),
               "seq2seq": graph_seq2seq(torch, ck, card, failures),
               "gradient_checks": graph_gradient_checks(torch, card,
                                                        failures)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["seconds"] = time.monotonic() - t0
    phase(30, f"(e) phase 30 took {out['seconds']:.3f} s [{card}]")
    if failures:
        raise SystemExit("phase 30 failed: " + "; ".join(failures))
    return out


# -- phase 31: tensor-parallel decode and the data-parallel masters --------
P31_DEV = "cuda"        # "cpu" rehearses phase 31 (with smaller sizes)
P31_TIMEOUT = 120.0     # the mesh's collective timeout and every wait's
P31_B = 512             # AlexNet's global batch, over the two ranks
P31_ICI_STEPS = 3
P31_PA_ROUNDS = 5
# 31e: the ICI ranks against one process on the whole batch. After the
# first step, Adam's moments (the step's gradient and its square: global
# BN statistics, both BN sums, the all-reduce) within 1e-4 of their
# norm. Over the 3 steps, each step's loss within 1e-4, and the params
# within 5e-2 of the steps' change, as the norm of the difference over
# the norm of the change: Adam's update divides by the gradient's own
# scale, so an element whose gradient is near 0 may move by a full step
# either way under another summation order, and on this random batch the
# loss grows fast, so later gradients amplify that
P31_LOSS_REL = 1e-4
P31_MOMENT_REL = 1e-4
P31_PARAM_REL = 5e-2
# the same, over the params other than the three conv biases that feed a
# BatchNorm (448 elements; their gradient is zero up to rounding, which
# Adam turns into steps of about +-lr): 3.120e-03 measured with those
# biases at 1.218 of their change (PERF.md §6, PR 26)
P31_OTHER_REL = 1e-2


def bn_fed_bias_mask(net):
    """A mask over ``net.params_flat()``: False on the bias of each layer
    whose next layer is a BatchNormalization, True elsewhere."""
    import numpy as np
    keep = []
    layers = net.conf.layers
    for i, lp in enumerate(net.params):
        fed = (i + 1 < len(layers)
               and type(layers[i + 1]).__name__ == "BatchNormalization")
        for name in sorted(lp):
            keep.append(np.full(lp[name].numel(),
                                not (fed and name == "b")))
    return np.concatenate(keep)


def p31_devices(n=2):
    """The ranks' devices: co-located on card 0 (gloo), or CPU ranks when
    the phase is rehearsed on the CPU."""
    return (["cuda:0"] if P31_DEV == "cuda" else ["cpu"]) * n


def tp_wave(torch, ck, net, reqs, mesh, **kw):
    """Phase 3's requests through an eager engine (``mesh`` None: tp = 1,
    else the mesh's ranks): (tokens, stats). Under tp, before the wave one
    all-idle decode step's collectives on every rank
    (`sharding.collective_counts`), and over the wave each rank's paged
    kernel launches and collectives."""
    from deeplearning4j_tpu_torch.inference import sharding as shd
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
    eng = DecodeScheduler(net, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                          kv_block=KV_BLOCK, kv_pool_mb=KV_POOL_MB,
                          decode_graphs="off", mesh=mesh,
                          metrics=MetricsRegistry(), device=P31_DEV, **kw)
    st = {"tp": eng.tp, "pool_blocks": eng.pool.capacity_blocks}
    if mesh is not None:
        impl = eng._fwd_net._impls["attn0"]
        st["shard_heads"] = {"H": impl.conf.n_heads, "Hkv": impl._kv_heads()}
        st["step_collectives"] = shd.collective_counts(eng)
        mesh.reset_launches()
        mesh.reset_counts()
    else:
        ck.reset_launches()
    t0 = time.monotonic()
    eng.start()
    try:
        hs = [eng.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
              for b in reqs]
        toks = [h.result(P31_TIMEOUT) for h in hs]
    finally:
        eng.stop()
    wall = time.monotonic() - t0
    st.update(decode_steps=eng.decode_steps,
              prefill_chunks=eng.prefill_chunks, wall_s=wall,
              tokens_per_s=sum(len(t) for t in toks) / wall,
              mean_decode_step_ms=1e3 * eng.decode_seconds
              / max(1, eng.decode_steps),
              mean_prefill_chunk_ms=1e3 * eng.prefill_seconds
              / max(1, eng.prefill_chunks))
    if mesh is not None:
        st["launches"] = [r["paged_decode_attention"]
                          for r in mesh.query_launches()]
        st["collectives"] = mesh.query_counts()
    else:
        st["launches"] = [ck.LAUNCHES["paged_decode_attention"]]
    return toks, st


def tp_gates(tag, st, toks, want, failures, heads=None):
    steps = st["decode_steps"]
    n_blocks = BLOCKS
    if toks != want:
        failures.append(f"31{tag}: tp tokens differ from the tp = 1 eager "
                        "engine's")
    if heads is not None and st["shard_heads"] != heads:
        failures.append(f"31{tag}: a rank runs {st['shard_heads']} heads, "
                        f"want {heads}")
    if any(n != n_blocks * steps for n in st["launches"]):
        failures.append(f"31{tag}: paged kernel launches per rank "
                        f"{st['launches']}, want {n_blocks} x {steps}")
    for r, c in enumerate(st["step_collectives"]):
        if c != {"all_reduce": 2 * n_blocks, "all_gather": 0,
                 "broadcast_command": 1, "broadcast_data": 0}:
            failures.append(f"31{tag}: rank {r}'s decode step collectives "
                            f"{c}, want {2 * n_blocks} all-reduces and one "
                            "command")
    for r, c in enumerate(st["collectives"]):
        want_ar = 2 * n_blocks * (steps + st["prefill_chunks"])
        if c["all_reduce"] != want_ar or c["all_gather"]:
            failures.append(f"31{tag}: rank {r}'s collectives over the wave "
                            f"{c}, want {want_ar} all-reduces")


def tp_sigkill(torch, card, net, reqs, want, failures):
    """31d: rank 1 SIGKILLed while the first request decodes, in a
    supervised server: the request ends with its tokens after the
    rebuild, or in the structured 503; never a hang."""
    import signal
    from deeplearning4j_tpu_torch.inference.supervisor import \
        RetryBudgetExceededError
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    t0 = time.monotonic()
    srv = InferenceServer(net=net, decode_vocab=VOCAB, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_pool_mb=KV_POOL_MB,
                          kv_block=KV_BLOCK, decode_tp=2,
                          decode_tp_devices=p31_devices(),
                          decode_graphs="off", hang_timeout_s=30.0,
                          device=P31_DEV).start()
    out = {"start_s": time.monotonic() - t0}
    try:
        sup = srv.supervisor
        dead = sup.engine
        b = reqs[0]
        h = sup.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
        t1 = time.monotonic()
        while not h.tokens and time.monotonic() - t1 < P31_TIMEOUT:
            time.sleep(0.002)
        os.kill(dead.mesh._procs[0].pid, signal.SIGKILL)
        t2 = time.monotonic()
        try:
            toks = h.result(P31_TIMEOUT)
            out["outcome"] = "tokens" if toks == want[0] else "wrong tokens"
        except RetryBudgetExceededError:
            out["outcome"] = "503"
        except TimeoutError:
            out["outcome"] = "hang"
        out.update(recovery_s=time.monotonic() - t2, retries=h.retries,
                   restarts=sup.restarts,
                   rebuilt_tp=sup.engine.tp if sup.engine is not None else 0,
                   old_followers_alive=dead.mesh.alive(),
                   new_followers_alive=(sup.engine is not None
                                        and sup.engine.mesh.alive()))
    finally:
        srv.stop()
    if out["outcome"] not in ("tokens", "503") or out["restarts"] < 1 \
            or out["old_followers_alive"] or out["rebuilt_tp"] != 2:
        failures.append(f"31d: the killed follower's request {out}")
    phase(31, f"(d) rank 1 SIGKILLed mid-decode in a supervised tp = 2 "
              f"server: outcome {out['outcome']}, retries {out['retries']}, "
              f"restarts {out['restarts']}, recovered in "
              f"{out['recovery_s']:.3f} s (server start "
              f"{out['start_s']:.3f} s) [{card}]")
    return out


class _Losses:
    """A listener keeping each iteration's score and wall time."""

    def __init__(self):
        self.losses, self.times = [], [time.monotonic()]

    def iteration_done(self, net, step):
        self.losses.append(float(net.score_))
        self.times.append(time.monotonic())


def dp_alexnet(torch, ck, card, mesh, failures):
    """31e-f: AlexNet-CIFAR10 at full width, dropout 0 (each rank would
    draw its own masks), B = P31_B over the two ranks."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.trainer import (
        IciDataParallelTrainingMaster, ParameterAveragingTrainingMaster)
    conf = alexnet_cifar10()
    conf.layers[9].dropout = 0.0
    rng = np.random.default_rng(31)
    x = rng.normal(size=(P31_B, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, P31_B)]
    one = MultiLayerNetwork(conf, device=P31_DEV).init()
    p0 = one.params_flat()
    rec1 = _Losses()
    one.listeners = [rec1]
    one.fit_batch(x, y)
    u1 = one.updater_state_flat()
    for _ in range(P31_ICI_STEPS - 1):
        one.fit_batch(x, y)
    dp = MultiLayerNetwork(conf, device=P31_DEV).init()
    rec = _Losses()
    dp.listeners = [rec]
    master = IciDataParallelTrainingMaster(mesh=mesh)
    mesh.reset_launches()
    master.execute_training(dp, [DataSet(x, y)])
    ud = dp.updater_state_flat()
    moment_rel = float(np.linalg.norm(ud - u1)) / max(
        float(np.linalg.norm(u1)), 1e-30)
    master.execute_training(dp, [DataSet(x, y)] * (P31_ICI_STEPS - 1))
    launches = mesh.query_launches()
    stats = mesh.query_stats(["step_s", "all_reduce_s", "all_reduce_bytes"])
    p1, pd = one.params_flat(), dp.params_flat()
    change = float(np.linalg.norm(p1 - p0))
    rel = float(np.linalg.norm(pd - p1)) / max(change, 1e-30)
    keep = bn_fed_bias_mask(one)
    rel_other = float(np.linalg.norm((pd - p1)[keep])) / max(
        float(np.linalg.norm((p1 - p0)[keep])), 1e-30)
    rel_bias = float(np.linalg.norm((pd - p1)[~keep])) / max(
        float(np.linalg.norm((p1 - p0)[~keep])), 1e-30)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(rec.losses, rec1.losses))
    # the listener's times: the second call's state handover falls
    # between steps 1 and 2, so examples/s reads steps 3 on
    step_s = [rec.times[i + 1] - rec.times[i] for i in range(len(rec.losses))]
    out = {"losses": rec.losses, "one_process_losses": rec1.losses,
           "loss_max_rel": loss_rel, "param_rel": rel,
           "param_rel_without_bn_fed_biases": rel_other,
           "bn_fed_bias_rel": rel_bias,
           "bn_fed_bias_count": int((~keep).sum()),
           "moment_rel": moment_rel,
           "param_max_abs_diff": float(np.abs(pd - p1).max()),
           "launches_per_rank": [{k: r[k] for k in ("conv2d_bias_act",
                                                    "bnap_sums", "bnap_dx")}
                                 for r in launches],
           "rank_step_ms": [1e3 * r["step_s"] for r in stats],
           "all_reduce_ms": [1e3 * r["all_reduce_s"] for r in stats],
           "all_reduce_bytes": [r["all_reduce_bytes"] for r in stats],
           "driver_step_ms": [1e3 * t for t in step_s],
           "examples_per_s": P31_B / (sum(step_s[2:]) / max(1, len(step_s)
                                                             - 2))}
    for r, ln in enumerate(out["launches_per_rank"]):
        if any(v != 3 * P31_ICI_STEPS for v in ln.values()):
            failures.append(f"31e: rank {r} launches {ln}, want 3 conv, 3 "
                            f"sums and 3 dx a step x {P31_ICI_STEPS}")
    if not (rel <= P31_PARAM_REL and loss_rel <= P31_LOSS_REL
            and moment_rel <= P31_MOMENT_REL and rel_other <= P31_OTHER_REL):
        failures.append(f"31e: ICI params {rel:.3e} of the steps' change "
                        f"(limit {P31_PARAM_REL}), losses {loss_rel:.3e} "
                        f"(limit {P31_LOSS_REL}), Adam's moments "
                        f"{moment_rel:.3e} (limit {P31_MOMENT_REL}), params "
                        f"without the BN-fed conv biases {rel_other:.3e} "
                        f"(limit {P31_OTHER_REL}) from one process's")
    phase(31, f"(e) AlexNet-CIFAR10 B={P31_B} over 2 ranks (ICI master, "
              f"global BN statistics), {P31_ICI_STEPS} steps: losses "
              f"{out['losses']} (one process {rec1.losses}); Adam's "
              f"moments after step 1 {moment_rel:.3e} of their norm, params "
              f"{rel:.3e} of the change from one process's (max |diff| "
              f"{out['param_max_abs_diff']:.3e}; without the "
              f"{out['bn_fed_bias_count']} conv biases feeding a BatchNorm "
              f"{rel_other:.3e}, those biases alone {rel_bias:.3e}); "
              f"launches a rank "
              f"{out['launches_per_rank']} [{card}]")
    x2 = np.concatenate([x, x[::-1]])
    y2 = np.concatenate([y, y[::-1]])
    pa_net = MultiLayerNetwork(conf, device=P31_DEV).init()
    rec2 = _Losses()
    pa_net.listeners = [rec2]
    pa = ParameterAveragingTrainingMaster(batch_size_per_worker=P31_B // 2,
                                          averaging_frequency=2, mesh=mesh)
    pa.execute_training(pa_net, [DataSet(x2, y2)] * P31_PA_ROUNDS)
    out["pa_round_losses"] = rec2.losses
    if not (len(rec2.losses) == P31_PA_ROUNDS
            and all(np.isfinite(rec2.losses))
            and rec2.losses[-1] < rec2.losses[0]):
        failures.append(f"31e: parameter averaging round losses "
                        f"{rec2.losses}")
    phase(31, f"(e) parameter averaging, 2 ranks x {P31_B // 2} x "
              f"frequency 2, {P31_PA_ROUNDS} rounds on the same "
              f"{2 * P31_B} examples: round losses {rec2.losses} [{card}]")
    phase(31, f"(f) ICI step ms by rank {out['rank_step_ms']}, driver's "
              f"{out['driver_step_ms']}; the gradient all-reduce "
              f"{out['all_reduce_ms']} ms of {out['all_reduce_bytes']} "
              f"bytes by rank (gloo, host-staged); "
              f"{out['examples_per_s']:.1f} examples/s [{card}]")
    return out


def phase31(torch, ck, card):
    """31a-g: see the module docstring."""
    from deeplearning4j_tpu_torch.inference import sharding as shd
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    t0 = time.monotonic()
    failures = []
    reqs = requests_for(seed=1)
    mesh = shd.decode_mesh(2, p31_devices(), timeout=P31_TIMEOUT).start()
    out = {"mesh_start_s": time.monotonic() - t0}
    try:
        net = ComputationGraph(transformer_lm(
            vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
            n_blocks=BLOCKS, rope=True, seed=7), device=P31_DEV).init()
        for tag, kw in (("a", {}), ("b_int8", {"kv_dtype": "int8"})):
            want, st1 = tp_wave(torch, ck, net, reqs, None, **kw)
            toks, st2 = tp_wave(torch, ck, net, reqs, mesh, **kw)
            tp_gates(tag, st2, toks, want, failures,
                     heads={"H": HEADS // 2, "Hkv": HEADS // 2})
            out[tag] = {"tp1": st1, "tp2": st2}
            if tag == "a":
                want_a = want
            phase(31, f"({tag}) the flagship, {'int8' if kw else 'fp32'} "
                      f"pages, 8 requests at tp = 2 (2 ranks on "
                      f"{p31_devices()[0]}, gloo): tokens "
                      f"{'identical' if toks == want else 'DIFFERENT'} to "
                      f"tp = 1 eager; a rank runs {st2['shard_heads']} "
                      f"heads; paged launches per rank {st2['launches']} for "
                      f"{st2['decode_steps']} decode steps; one step's "
                      f"collectives per rank {st2['step_collectives']}; "
                      f"mean decode step {st2['mean_decode_step_ms']:.3f} ms "
                      f"(tp = 1 {st1['mean_decode_step_ms']:.3f}), "
                      f"{st2['tokens_per_s']:.1f} tokens/s (tp = 1 "
                      f"{st1['tokens_per_s']:.1f}); pool blocks at "
                      f"{KV_POOL_MB} MiB a rank: tp = 1 {st1['pool_blocks']}, "
                      f"tp = 2 {st2['pool_blocks']} [{card}]")
        del net
        gqa = ComputationGraph(transformer_lm(
            vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
            n_blocks=BLOCKS, rope=True, seed=7, n_kv_heads=2),
            device=P31_DEV).init()
        want, st1 = tp_wave(torch, ck, gqa, reqs, None)
        toks, st2 = tp_wave(torch, ck, gqa, reqs, mesh)
        tp_gates("b_gqa", st2, toks, want, failures,
                 heads={"H": HEADS // 2, "Hkv": 1})
        out["b_gqa"] = {"tp1": st1, "tp2": st2}
        phase(31, f"(b) GQA (Hkv = 2) at tp = 2: one kv head a rank "
                  f"{st2['shard_heads']}, tokens "
                  f"{'identical' if toks == want else 'DIFFERENT'} to "
                  f"tp = 1; paged launches per rank {st2['launches']} for "
                  f"{st2['decode_steps']} steps [{card}]")
        del gqa
        kcases = {}
        for H, Hkv, q in (((4, 4, False), (4, 4, True), (4, 1, False))
                          if P31_DEV == "cuda" else ()):
            key = f"H{H}_Hkv{Hkv}_{'int8' if q else 'fp32'}"
            r = kernel_case(ck, torch, H=H, Hkv=Hkv, quantized=q,
                            seed=31 + len(kcases))
            kcases[key] = r
            phase(31, f"(c) paged kernel at the shard shape {key}: "
                      f"max|diff|={r['max_abs_err']:.3e}, bitwise "
                      f"repeatable {r['repeat_bitwise']}; kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                      f"[{card}]")
            if not (r["max_abs_err"] < 1e-4 and r["repeat_bitwise"]
                    and r["finite"]):
                failures.append(f"31c: {key} {r}")
        out["kernel_cases"] = kcases
        net = ComputationGraph(transformer_lm(
            vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
            n_blocks=BLOCKS, rope=True, seed=7), device=P31_DEV).init()
        out["d"] = tp_sigkill(torch, card, net, reqs, want_a, failures)
        out["e"] = dp_alexnet(torch, ck, card, mesh, failures)
        if P31_DEV == "cuda" and torch.cuda.device_count() >= 2:
            nccl = shd.decode_mesh(2, ["cuda:0", "cuda:1"],
                                   timeout=P31_TIMEOUT).start()
            try:
                toks, st = tp_wave(torch, ck, net, reqs, nccl)
            finally:
                nccl.close()
            tp_gates("g", st, toks, want_a, failures,
                     heads={"H": HEADS // 2, "Hkv": HEADS // 2})
            out["g"] = st
            phase(31, f"(g) the flagship over NCCL, one card a rank: tokens "
                      f"{'identical' if toks == want_a else 'DIFFERENT'} "
                      f"[{card}]")
        else:
            out["g"] = None
            phase(31, "phase 31g not run: 1 card")
    finally:
        mesh.close()
    out["seconds"] = time.monotonic() - t0
    phase(31, f"phase 31 took {out['seconds']:.3f} s [{card}]")
    if failures:
        raise SystemExit("phase 31 failed: " + "; ".join(failures))
    return out


# -- phase 32: speculation and the KV tiers under tp, fault tolerance ------
P32_DRAFT_BLOCKS = 2    # 32a: the shallow draft's blocks (of BLOCKS)
P32_STEPS = 5           # 32c: AlexNet steps of the uninterrupted run
P32_CKPT_AT = 3         # 32c: steps before the drop, and the kill
# 32c: the ICI steps against an uninterrupted run: each loss within 1e-4
# (as 31e), params within P31_PARAM_REL of the steps' change (31e's gate)
P32_LOSS_REL = 1e-4


def spec_tp_wave(torch, ck, net, reqs, mesh, paged):
    """32a: phase 3's requests through a speculating eager engine at the
    mesh's tp (G = SPEC_G, a shallow draft of P32_DRAFT_BLOCKS blocks),
    paged fp32 pages or contiguous stripes: (tokens, stats). Before the
    wave the verify's and the draft's collectives on every rank; over it
    each rank's paged kernel launches."""
    from deeplearning4j_tpu_torch.inference import sharding as shd
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
    eng = DecodeScheduler(net, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                          kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB if paged else 0.0,
                          decode_graphs="off", mesh=mesh, speculate=SPEC_G,
                          draft_blocks=P32_DRAFT_BLOCKS,
                          metrics=MetricsRegistry(), device=P31_DEV)
    st = {"tp": eng.tp, "speculate": eng.speculate,
          "draft_blocks": eng.draft_blocks,
          "verify_collectives": shd.verify_collective_counts(eng),
          "draft_collectives": shd.draft_collective_counts(eng)}
    mesh.reset_launches()
    t0 = time.monotonic()
    eng.start()
    try:
        hs = [eng.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
              for b in reqs]
        toks = [h.result(P31_TIMEOUT) for h in hs]
    finally:
        eng.stop()
    wall = time.monotonic() - t0
    st.update(wall_s=wall, tokens_per_s=sum(map(len, toks)) / wall,
              decode_steps=eng.decode_steps, spec_rounds=eng.spec_rounds,
              draft_steps=eng.draft_steps, draft_chunks=eng.draft_chunks,
              proposed=eng.spec_proposed, accepted=eng.spec_accepted,
              mean_decode_step_ms=1e3 * eng.decode_seconds
              / max(1, eng.decode_steps),
              mean_verify_ms=1e3 * eng.verify_seconds
              / max(1, eng.spec_rounds),
              mean_draft_ms=1e3 * eng.draft_seconds
              / max(1, eng.draft_steps + eng.draft_chunks),
              launches=[r["paged_decode_attention"]
                        for r in mesh.query_launches()])
    return toks, st


def spec_tp_gates(tag, st, toks, want, paged, failures):
    if toks != want:
        failures.append(f"32{tag}: speculating tp tokens differ from the "
                        "tp = 1 unspeculated eager engine's")
    if st["tp"] != 2 or st["speculate"] != SPEC_G \
            or st["draft_blocks"] != P32_DRAFT_BLOCKS:
        failures.append(f"32{tag}: engine armed {st}")
    want_l = BLOCKS * st["decode_steps"] if paged else 0
    if any(n != want_l for n in st["launches"]):
        failures.append(f"32{tag}: paged launches per rank "
                        f"{st['launches']}, want {want_l} ({BLOCKS} a plain "
                        "decode step)")
    for what, counts, nb in (("verify", st["verify_collectives"], BLOCKS),
                             ("draft", st["draft_collectives"],
                              P32_DRAFT_BLOCKS)):
        for r, c in enumerate(counts):
            if c != {"all_reduce": 2 * nb, "all_gather": 0,
                     "broadcast_command": 1, "broadcast_data": 0}:
                failures.append(f"32{tag}: rank {r}'s {what} collectives "
                                f"{c}, want {2 * nb} all-reduces and one "
                                "command")
    if not st["proposed"] or not st["spec_rounds"]:
        failures.append(f"32{tag}: no speculation ran ({st['spec_rounds']} "
                        "verifies)")


def tier_tp_engine(net, mesh, kv_dtype, **kw):
    """A tiered eager engine over phase 28's pool block count (its budget
    split over the mesh's ranks: each rank's pages hold its heads)."""
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
    tp = 1 if mesh is None else mesh.size
    return DecodeScheduler(net, VOCAB, n_slots=SLOTS,
                           prefill_chunk=TIER_CHUNK, kv_block=KV_BLOCK,
                           kv_pool_mb=tier_pool_mb(kv_dtype) / tp,
                           kv_dtype=kv_dtype, decode_graphs="off", mesh=mesh,
                           metrics=MetricsRegistry(), device=P31_DEV, **kw)


def engine_wave(eng, bodies):
    hs = [eng.submit(b["prompt"], b["max_new_tokens"], **sampling_kw(b))
          for b in bodies]
    return [h.result(P31_TIMEOUT) for h in hs]


def tier_tp_run(torch, ck, card, net, mesh, wave_a, wave_b, kv_dtype,
                failures):
    """32b: phase 28's waves A, B, C (= A) through a tp = 2 tiered engine
    (host tier TIER_HOST_MB); wave A through a tp = 1 eager engine; then
    wave A's first chain fetched from the tp = 2 tier (fp32: served by a
    tp = 1 peer engine from the fetched blocks)."""
    from deeplearning4j_tpu_torch.inference import kvtier as tkv
    tag = "b_" + ("int8" if kv_dtype else "fp32")
    t0 = time.monotonic()
    one = tier_tp_engine(net, None, kv_dtype).start()
    try:
        want_a = engine_wave(one, wave_a)
    finally:
        one.stop()
    out = {"tp1_wave_a_s": time.monotonic() - t0}
    eng = tier_tp_engine(net, mesh, kv_dtype, host_cache_mb=TIER_HOST_MB)
    mesh.reset_counts()
    out["pool_blocks"] = eng.pool.capacity_blocks
    eng.start()
    chain = tkv.prompt_chain(wave_a[0]["prompt"], KV_BLOCK)
    try:
        t1 = time.monotonic()
        toks_a = engine_wave(eng, wave_a)
        out["wave_a_s"] = time.monotonic() - t1
        out["settle_a_s"] = tier_settle(eng)
        engine_wave(eng, wave_b)
        out["settle_b_s"] = tier_settle(eng)
        mesh.reset_launches()
        eng.reset_counters()
        t1 = time.monotonic()
        toks_c = engine_wave(eng, wave_a)
        out["wave_c_s"] = time.monotonic() - t1
        out["settle_c_s"] = tier_settle(eng)
        out["wave_c_decode_steps"] = eng.decode_steps
        out["wave_c_launches"] = [r["paged_decode_attention"]
                                  for r in mesh.query_launches()]
        out["wave_c_tier_restored_tokens"] = eng.tier_restored_tokens
        out["spill_all_gathers"] = [c["all_gather"]
                                    for c in mesh.query_counts()]
        snap = eng.metrics.snapshot()["counters"]
        out["counters"] = {k: v for k, v in snap.items()
                           if k.startswith("kv_tier_")}
        t1 = time.monotonic()
        payloads = [eng.tier.get_block_payload(h, timeout=P31_TIMEOUT)
                    for h in chain]
        out["fetch_s"] = time.monotonic() - t1
    finally:
        eng.stop()
    dh = D_MODEL // HEADS
    heads = []
    for p in payloads:
        dec = tkv.decode_block(p) if p is not None else None
        heads.append(None if dec is None else sorted(
            {tuple(a.shape) for pks in dec[1].values()
             for a in pks.values()}))
    want_shapes = sorted({(KV_BLOCK, HEADS, dh)}
                         | ({(KV_BLOCK, HEADS)} if kv_dtype else set()))
    out["fetched_shapes"] = heads[0]
    c = out["counters"]
    if toks_c != toks_a or toks_a != want_a:
        failures.append(f"32{tag}: wave C {'=' if toks_c == toks_a else '!='}"
                        f" wave A, wave A {'=' if toks_a == want_a else '!='} "
                        "tp = 1")
    if not c.get("kv_tier_promoted_blocks_total"):
        failures.append(f"32{tag}: no block promoted ({c})")
    if any(n != BLOCKS * out["wave_c_decode_steps"]
           for n in out["wave_c_launches"]):
        failures.append(f"32{tag}: wave C paged launches per rank "
                        f"{out['wave_c_launches']}, want {BLOCKS} x "
                        f"{out['wave_c_decode_steps']}")
    if any(h != want_shapes for h in heads):
        failures.append(f"32{tag}: fetched blocks' row shapes {heads}, want "
                        f"{want_shapes} (every head)")
    if kv_dtype is None and all(p is not None for p in payloads):
        peer = tier_tp_engine(net, None, None, host_cache_mb=TIER_HOST_MB)
        peer.start()
        try:
            got = [peer.tier.insert_fetched(p) for p in payloads]
            peer.tier.request_restore(chain)
            t1 = time.monotonic()
            while (peer.metrics.counter("kv_tier_promoted_blocks_total").value
                   < len(chain) and time.monotonic() - t1 < P31_TIMEOUT):
                time.sleep(0.01)
            out["peer_promoted"] = peer.metrics.counter(
                "kv_tier_promoted_blocks_total").value
            pre = peer.metrics.counter("prefill_tokens_total").value
            ptoks = engine_wave(peer, wave_a[:1])
            out["peer_prefilled"] = peer.metrics.counter(
                "prefill_tokens_total").value - pre
        finally:
            peer.stop()
        out["peer_tokens_identical"] = ptoks == want_a[:1]
        if got != chain or not out["peer_tokens_identical"] \
                or out["peer_promoted"] < len(chain):
            failures.append(f"32{tag}: the tp = 1 peer from the fetched "
                            f"blocks: inserted {got == chain}, promoted "
                            f"{out['peer_promoted']}, tokens "
                            f"{out['peer_tokens_identical']}")
    phase(32, f"({tag[0]}) {'int8' if kv_dtype else 'fp32'} pages at tp = 2, "
              f"{out['pool_blocks']} pool blocks (a rank's "
              f"{tier_pool_mb(kv_dtype) / 2:.3f} MiB), host tier "
              f"{TIER_HOST_MB} MiB, phase 28's waves: wave C "
              f"{'identical' if toks_c == toks_a else 'DIFFERENT'} to wave A,"
              f" wave A {'identical' if toks_a == want_a else 'DIFFERENT'} to "
              f"tp = 1; spilled {c.get('kv_tier_spilled_blocks_total')} "
              f"(dropped {c.get('kv_tier_spill_dropped_total')}), promoted "
              f"{c.get('kv_tier_promoted_blocks_total')}, failed restores "
              f"{c.get('kv_tier_restore_failed_total')}; wave C restored "
              f"{out['wave_c_tier_restored_tokens']} tokens from promotions, "
              f"paged launches per rank {out['wave_c_launches']} for "
              f"{out['wave_c_decode_steps']} steps; waves A/C "
              f"{out['wave_a_s']:.3f}/{out['wave_c_s']:.3f} s; a fetched "
              f"block's rows {heads[0]}"
              + (f"; a tp = 1 peer promoted {out['peer_promoted']} fetched "
                 f"blocks, prefilled {out['peer_prefilled']} tokens, tokens "
                 + ("identical" if out["peer_tokens_identical"]
                    else "DIFFERENT")
                 if kv_dtype is None else "") + f" [{card}]")
    return out


class _KillFollowerAt:
    """A listener that SIGKILLs rank 1 of ``mesh`` after step ``at``."""

    def __init__(self, mesh, at):
        self.mesh, self.at = mesh, at
        self.killed_at = None

    def iteration_done(self, net, step):
        import signal
        if step == self.at and self.killed_at is None:
            os.kill(self.mesh._procs[0].pid, signal.SIGKILL)
            self.mesh._procs[0].join(30)
            self.killed_at = step


def ft_alexnet(torch, ck, card, failures):
    """32c: AlexNet-CIFAR10 at full width (dropout 0), B = P31_B over two
    ranks under the ICI master with a TrainingStateTracker checkpointing
    every step: an uninterrupted run of P32_STEPS steps; a run dropped
    after P32_CKPT_AT steps and resumed on a fresh net and master; a run
    under fit_with_recovery whose follower is SIGKILLed after step
    P32_CKPT_AT, restarted on one rank with the dead worker disabled."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.parallel.statetracker import (
        TrainingStateTracker, fit_with_recovery)
    from deeplearning4j_tpu_torch.parallel.trainer import \
        IciDataParallelTrainingMaster
    conf = alexnet_cifar10()
    conf.layers[9].dropout = 0.0
    rng = np.random.default_rng(32)
    batches = [DataSet(rng.normal(size=(P31_B, 32, 32, 3)).astype(np.float32),
                       np.eye(10, dtype=np.float32)[
                           rng.integers(0, 10, P31_B)])
               for _ in range(P32_STEPS)]

    def fresh(rec=None):
        net = MultiLayerNetwork(conf, device=P31_DEV).init()
        net.listeners = [rec] if rec is not None else []
        return net

    out = {}
    tmp = tempfile.mkdtemp(prefix="p32-ckpt-")
    mesh = tmesh.default_mesh(2, p31_devices(), timeout=P31_TIMEOUT).start()
    try:
        rec = _Losses()
        ref = fresh(rec)
        p0 = ref.params_flat()
        mesh.reset_launches()
        IciDataParallelTrainingMaster(mesh=mesh).execute_training(ref,
                                                                  batches)
        out["launches_per_rank"] = [
            {k: r[k] for k in ("conv2d_bias_act", "bnap_sums", "bnap_dx")}
            for r in mesh.query_launches()]
        pref = ref.params_flat()
        change = float(np.linalg.norm(pref - p0))
        out["ref_losses"] = rec.losses
        # the same run again: how far two uninterrupted runs part
        again = fresh()
        IciDataParallelTrainingMaster(mesh=mesh).execute_training(again,
                                                                  batches)
        pa = again.params_flat()
        out["rerun_bitwise"] = bool(np.array_equal(pa, pref))
        out["rerun_param_rel"] = float(np.linalg.norm(pa - pref)) / max(
            change, 1e-30)
        del again
        # dropped after P32_CKPT_AT steps, resumed on a fresh net and master
        t0 = time.monotonic()
        net = fresh()
        tracker = TrainingStateTracker(os.path.join(tmp, "a"),
                                       every_n_batches=1)
        IciDataParallelTrainingMaster(mesh=mesh, state_tracker=tracker) \
            .execute_training(net, batches[:P32_CKPT_AT])
        out["ckpt_write_s"] = (time.monotonic() - t0) / P32_CKPT_AT
        p3 = net.params_flat()
        del net
        rec2 = _Losses()
        net2 = fresh(rec2)
        m2 = IciDataParallelTrainingMaster(
            mesh=mesh, state_tracker=TrainingStateTracker(
                os.path.join(tmp, "a"), every_n_batches=1))
        t0 = time.monotonic()
        out["resume_skip"] = m2.resume(net2)
        out["resume_s"] = time.monotonic() - t0
        out["restored_bitwise"] = bool(np.array_equal(net2.params_flat(),
                                                      p3))
        m2.execute_training(net2, batches)
        p2 = net2.params_flat()
        out["resumed_losses"] = rec2.losses
        out["resumed_bitwise"] = bool(np.array_equal(p2, pref))
        out["resumed_param_rel"] = float(np.linalg.norm(p2 - pref)) / max(
            change, 1e-30)
        # the follower killed under fit_with_recovery
        ckpt = os.path.join(tmp, "b")
        tr = TrainingStateTracker(ckpt, every_n_batches=1)
        tr.add_worker("rank0")
        tr.add_worker("rank1")
        kill = _KillFollowerAt(mesh, P32_CKPT_AT)
        net3 = fresh(kill)
        try:
            fit_with_recovery(net3, lambda epoch: batches, epochs=1,
                              tracker=tr,
                              master=IciDataParallelTrainingMaster(mesh=mesh))
            out["kill_raised"] = None
        except tmesh.MeshError as e:
            out["kill_raised"] = str(e)
        out["killed_at"] = kill.killed_at
    finally:
        mesh.kill()
    tr = TrainingStateTracker(ckpt, every_n_batches=1)
    tr.disable_worker("rank1")
    live = tr.enabled_workers()
    out["roster_after"] = live
    one = tmesh.default_mesh(len(live), p31_devices(len(live)))
    rec4 = _Losses()
    net4 = fresh(rec4)
    t0 = time.monotonic()
    fit_with_recovery(net4, lambda epoch: batches, epochs=1, tracker=tr,
                      master=IciDataParallelTrainingMaster(mesh=one))
    out["restart_s"] = time.monotonic() - t0
    p4 = net4.params_flat()
    out["restarted_losses"] = rec4.losses
    out["restarted_bitwise"] = bool(np.array_equal(p4, pref))
    out["restarted_param_rel"] = float(np.linalg.norm(p4 - pref)) / max(
        change, 1e-30)
    out["restarted_step"] = net4.step
    loss_rel = max([abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        rec2.losses, rec.losses[P32_CKPT_AT:])]
        + [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            rec4.losses, rec.losses[P32_CKPT_AT:])] or [0.0])
    out["loss_max_rel"] = loss_rel
    for r, ln in enumerate(out["launches_per_rank"]):
        if any(v != 3 * P32_STEPS for v in ln.values()):
            failures.append(f"32c: rank {r} launches {ln}, want 3 a step x "
                            f"{P32_STEPS}")
    if out["resume_skip"] != P32_CKPT_AT or not out["restored_bitwise"]:
        failures.append(f"32c: resume() returned {out['resume_skip']}, want "
                        f"{P32_CKPT_AT}; restored params bitwise the "
                        f"checkpointed net's: {out['restored_bitwise']}")
    if out["kill_raised"] is None or out["killed_at"] != P32_CKPT_AT:
        failures.append(f"32c: the killed follower's fit did not fail "
                        f"({out['kill_raised']}, killed at "
                        f"{out['killed_at']})")
    if live != ["rank0"] or out["restarted_step"] != P32_STEPS:
        failures.append(f"32c: restart roster {live}, step "
                        f"{out['restarted_step']}")
    if not (out["resumed_param_rel"] <= P31_PARAM_REL
            and out["restarted_param_rel"] <= P31_PARAM_REL
            and loss_rel <= P32_LOSS_REL):
        failures.append(f"32c: resumed params {out['resumed_param_rel']:.3e}"
                        f", restarted {out['restarted_param_rel']:.3e} of "
                        f"the change (limit {P31_PARAM_REL}), losses "
                        f"{loss_rel:.3e} (limit {P32_LOSS_REL})")
    phase(32, f"(c) AlexNet-CIFAR10 B={P31_B} over 2 ranks (ICI master, "
              f"TrainingStateTracker every step): resume() after "
              f"{P32_CKPT_AT} steps returned {out['resume_skip']} "
              f"({out['resume_s']:.3f} s, a checkpoint "
              f"{out['ckpt_write_s']:.3f} s a step with its step), the "
              f"restored params "
              + ("bitwise" if out["restored_bitwise"] else "NOT bitwise")
              + f" the checkpointed net's; after {P32_STEPS} steps params "
              + ("bitwise equal to" if out["resumed_bitwise"]
                 else "not bitwise") + f" the uninterrupted run's ({out['resumed_param_rel']:.3e} of "
              f"the change); follower SIGKILLed after step "
              f"{out['killed_at']}: the fit raised, restart on "
              f"{len(live)} rank with roster {live} replayed from the "
              f"cursor in {out['restart_s']:.3f} s, params "
              + ("bitwise equal" if out["restarted_bitwise"]
                 else "not bitwise") + f" ({out['restarted_param_rel']:.3e} of the change); losses "
              f"within {loss_rel:.3e}; two uninterrupted runs part by "
              f"{out['rerun_param_rel']:.3e} of the change ("
              + ("bitwise" if out["rerun_bitwise"] else "not bitwise")
              + f"); launches a rank "
              f"{out['launches_per_rank']} [{card}]")
    return out


def phase32(torch, ck, card):
    """32a-c: see the module docstring."""
    from deeplearning4j_tpu_torch.inference import sharding as shd
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    t0 = time.monotonic()
    failures = []
    reqs = requests_for(seed=1)
    out = {}
    net = ComputationGraph(transformer_lm(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_blocks=BLOCKS,
        rope=True, seed=7), device=P31_DEV).init()
    want, st1 = tp_wave(torch, ck, net, reqs, None)
    out["tp1_plain"] = st1
    mesh = shd.decode_mesh(2, p31_devices(), timeout=P31_TIMEOUT).start()
    try:
        for tag, paged in (("a_paged", True), ("a_contiguous", False)):
            toks, st = spec_tp_wave(torch, ck, net, reqs, mesh, paged)
            spec_tp_gates(tag, st, toks, want, paged, failures)
            out[tag] = st
            phase(32, f"(a) speculate={SPEC_G}, {P32_DRAFT_BLOCKS}-block "
                      f"shallow draft, "
                      + ("paged fp32" if paged else "contiguous")
                      + f" at tp = 2 ({p31_devices()[0]} x 2, gloo), phase 3's "
                      f"8 requests: tokens "
                      f"{'identical' if toks == want else 'DIFFERENT'} to "
                      f"tp = 1 unspeculated eager; {st['spec_rounds']} "
                      f"verifies, proposed {st['proposed']}, accepted "
                      f"{st['accepted']}; verify {st['mean_verify_ms']:.3f} "
                      f"ms, draft {st['mean_draft_ms']:.3f} ms a dispatch, "
                      f"plain tp step {st['mean_decode_step_ms']:.3f} ms "
                      f"(tp = 1 unspeculated {st1['mean_decode_step_ms']:.3f})"
                      f"; paged launches per rank {st['launches']} for "
                      f"{st['decode_steps']} plain steps; collectives per "
                      f"rank: verify {st['verify_collectives'][0]}, draft "
                      f"{st['draft_collectives'][0]}; "
                      f"{st['tokens_per_s']:.1f} tokens/s [{card}]")
        wave_a, wave_b = tier_waves(seed=28)
        for kv in (None, "int8"):
            key = "b_" + ("int8" if kv else "fp32")
            out[key] = tier_tp_run(torch, ck, card, net, mesh, wave_a,
                                   wave_b, kv, failures)
    finally:
        mesh.close()
    del net
    out["c"] = ft_alexnet(torch, ck, card, failures)
    out["seconds"] = time.monotonic() - t0
    phase(32, f"phase 32 took {out['seconds']:.3f} s [{card}]")
    if failures:
        raise SystemExit("phase 32 failed: " + "; ".join(failures))
    return out


# -- phase 33: tp training, N-D meshes, ZeRO-1, ring/Ulysses, GPipe, MoE ---
P33_DEV = "cuda"        # "cpu" rehearses phase 33 (tools/phase33_alone.py)
P33_T, P33_B = 256, 32  # phase 29's LM shape
P33_STEPS = 3
# 33a: each step's loss against the tp = 1 eager step on the card, and the
# params' distance as the norm of the difference over the norm of the 3
# steps' change (31e's gate on the params other than BN-fed biases; this
# net has no BatchNorm)
P33_LOSS_REL = 1e-5
P33_PARAM_REL = 1e-2
# 33c: dp x tp against one process on the whole batch: 31e's loss gate
P33_DP_LOSS_REL = 1e-4
# 33d: ZeRO-1 against the unsharded master (elementwise Adam on the same
# all-reduced gradient), and the rank's updater bytes over the unsharded
# master's: about half
P33_ZERO_REL = 1e-6
P33_ZERO_BYTES = (0.45, 0.55)
# 33e: ring and Ulysses against the single-card flash forward, of max |ref|
P33_ATTN_L = 8192
P33_ATTN_REL = 1e-4
# 33f: GPipe and MoE against the one-process computation, of the largest
# reference element (forward) and of each leaf's largest gradient
P33_PIPE_REL = 1e-4
P33_PIPE_B, P33_PIPE_T, P33_MICRO = 8, 128, 4
P33_MOE_B, P33_MOE_H = 256, 2048


def p33_devices(n):
    return ([f"{P33_DEV}:0"] if P33_DEV == "cuda" else ["cpu"]) * n


def p33_sync(torch):
    if P33_DEV == "cuda":
        torch.cuda.synchronize()


def p33_net(heads=HEADS):
    """The flagship transformer_lm (RoPE, f32, Adam, seed 7) with eager
    steps."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return ComputationGraph(transformer_lm(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=heads, n_blocks=BLOCKS,
        rope=True, seed=7), device=P33_DEV, train_graphs="off").init()


def p33_flat(torch, net):
    return torch.cat([t.detach().reshape(-1).float()
                      for n in sorted(net.params)
                      for t in (net.params[n][k]
                                for k in sorted(net.params[n]))])


def p33_batch(torch):
    import numpy as np
    ids = np.random.default_rng(33).integers(0, VOCAB, (P33_B, P33_T + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def p33_fit(torch, fn, steps=P33_STEPS):
    """``steps`` calls of ``fn`` (one step each), each timed on the host
    clock up to the card's synchronize: (losses, ms)."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        loss = fn()
        p33_sync(torch)
        ms.append(1e3 * (time.monotonic() - t0))
        losses.append(float(loss))
    return losses, ms


def p33_rel(torch, a, b, base):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(base))


def p33_tblock(p, x):
    """JAX tests/test_pipeline.py's pre-LN attention + FFN block at the
    flagship's width (d_model 512, 8 heads)."""
    import torch
    from deeplearning4j_tpu_torch.parallel.ring import full_attention
    d = p["Wq"].shape[0]
    dh = d // HEADS

    def ln(a):
        return (a - a.mean(-1, keepdim=True)) / (
            a.std(-1, keepdim=True, unbiased=False) + 1e-5)
    h = ln(x)
    b, t, _ = h.shape
    q = (h @ p["Wq"]).reshape(b, t, HEADS, dh)
    k = (h @ p["Wk"]).reshape(b, t, HEADS, dh)
    v = (h @ p["Wv"]).reshape(b, t, HEADS, dh)
    a = full_attention(q, k, v, causal=True).reshape(b, t, d)
    x = x + a @ p["Wo"]
    return x + torch.tanh(ln(x) @ p["Wf1"]) @ p["Wf2"]


def p33_expert(p, x):
    """JAX tests/test_moe.py's expert at the flagship's width."""
    import torch
    return torch.tanh(x @ p["W1"]) @ p["W2"]


def p33_moe_ref(torch, experts, gate_w, x, capacity, n_ranks):
    """The one-process routing: each rank's shard of tokens gated top-1,
    a token past its expert's capacity dropped (JAX's position rule)."""
    outs = []
    n_local = x.shape[0] // n_ranks
    for r in range(n_ranks):
        xs = x[r * n_local:(r + 1) * n_local]
        probs = torch.softmax(xs @ gate_w, -1)
        eidx, gate = probs.argmax(-1), probs.max(-1).values
        y = torch.zeros_like(xs)
        for e in range(len(experts)):
            rows = torch.nonzero(eidx == e).reshape(-1)[:capacity]
            if rows.numel():
                y[rows] = gate[rows, None] * p33_expert(experts[e], xs[rows])
        outs.append(y)
    return torch.cat(outs)


def p33_tp(torch, ck, card, mesh, x, y, failures):
    """33a: tp = 2 training against the tp = 1 eager step."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        shard_transformer_tp
    ref = p33_net()
    p0 = p33_flat(torch, ref)
    xs, ys = ref._as_tensor(x), ref._as_tensor(y)

    def one(net):
        net.fit_batch([xs], [ys])
        return net._score_raw
    ck.reset_launches()
    l1, ms1 = p33_fit(torch, lambda: one(ref))
    launches1 = dict(ck.LAUNCHES)
    p1 = p33_flat(torch, ref)
    del ref
    net = p33_net()
    shard_transformer_tp(net, mesh)
    mesh.reset_launches()
    mesh.reset_counts()
    l2, ms2 = p33_fit(torch, lambda: one(net))
    counts = mesh.query_counts(by_axis=True)
    launches = mesh.query_launches()
    reps = net._tp.replicas()
    bitwise = all(bool(torch.equal(reps[0], reps[r]))
                  for r in range(1, reps.shape[0]))
    p2 = p33_flat(torch, net)
    rel = p33_rel(torch, p2, p1, p1 - p0)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    want = {"flash_attention_fwd": BLOCKS * P33_STEPS,
            "flash_attention_bwd_dkv": BLOCKS * P33_STEPS,
            "flash_attention_bwd_dq": BLOCKS * P33_STEPS}
    flash = [{k: r.get(k, 0) for k in want} for r in launches]
    out = {"tp1_losses": l1, "tp2_losses": l2, "tp1_step_ms": ms1,
           "tp2_step_ms": ms2, "loss_rel": loss_rel, "param_rel": rel,
           "replicas_bitwise": bitwise, "collectives_per_rank": counts,
           "launches_per_rank": launches, "tp1_launches": launches1,
           "shard_heads": HEADS // 2}
    phase(33, f"(a) the flagship (RoPE, f32, Adam) trained at tp = 2 "
              f"({p33_devices(1)[0]} x 2, gloo, eager), B={P33_B} T={P33_T}, "
              f"{P33_STEPS} steps: losses {l2} against tp = 1 eager {l1} "
              f"(max rel {loss_rel:.3e}, gate {P33_LOSS_REL:g}); params "
              f"{rel:.3e} of the steps' change (gate {P33_PARAM_REL:g}); "
              f"replicated params bitwise equal across ranks {bitwise}; "
              f"flash launches per rank {flash} (want {want}: rows 6a-6c "
              f"at [{P33_B}, {P33_T}, {HEADS // 2}, {D_MODEL // HEADS}]); "
              f"collectives per rank: all-reduces on the model axis "
              f"{[c['all_reduce@model'] for c in counts]}, commands "
              f"{[c['broadcast_command'] for c in counts]}, gathers "
              f"{[c['all_gather'] for c in counts]}; step ms tp = 2 "
              f"{[round(m, 3) for m in ms2]} against tp = 1 eager "
              f"{[round(m, 3) for m in ms1]} [{card}]")
    if not loss_rel <= P33_LOSS_REL:
        failures.append(f"33a: losses {l2} vs {l1}")
    if not rel <= P33_PARAM_REL:
        failures.append(f"33a: params {rel:.3e} of the change")
    if not bitwise:
        failures.append("33a: replicated params differ across ranks")
    if P33_DEV == "cuda" and any(f != want for f in flash):
        failures.append(f"33a: flash launches {flash}, want {want}")
    for c in counts:
        if not (c["all_reduce@model"] == 4 * BLOCKS * P33_STEPS
                and c["broadcast_command"] == P33_STEPS
                and c["all_gather"] == 0):
            failures.append(f"33a: collectives {c}")
    del net
    return out


def p33_flash(torch, ck, card, failures):
    """33b: the flash kernels at a tp = 2 rank's shard shape."""
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    r = flash_case(ck, torch, flush_buf.zero_, B=P33_B, L=P33_T,
                   H=HEADS // 2, D=D_MODEL // HEADS, causal=True, seed=433,
                   library=True)
    e = r["rel_err"]
    phase(33, f"(b) flash at the shard shape {r['shape']} causal: "
              f"max|diff|/max|plain| o {e['o']:.3e} lse {e['lse']:.3e} dq "
              f"{e['dq']:.3e} dk {e['dk']:.3e} dv {e['dv']:.3e} (gates "
              f"1e-5), bitwise repeatable {r['repeat_bitwise']}; kernel / "
              f"plain / bound ms: fwd {r['fwd_ms']:.4f} / "
              f"{r['fwd_plain_ms']:.4f} / {r['fwd_bound_ms']:.4f} "
              f"({r['fwd_bound_by']}), dkv {r['dkv_ms']:.4f} / "
              f"{r['dkv_plain_ms']:.4f} / {r['dkv_bound_ms']:.4f} "
              f"({r['dkv_bound_by']}), dq {r['dq_ms']:.4f} / "
              f"{r['dq_plain_ms']:.4f} / {r['dq_bound_ms']:.4f} "
              f"({r['dq_bound_by']}); SDPA fwd {r['sdpa_fwd_ms']:.4f} ms, "
              f"fwd+bwd {r['sdpa_fwd_bwd_ms']:.4f} ms [{card}]")
    if not (max(e.values()) <= 1e-5 and r["repeat_bitwise"]
            and r["finite"] and r["sdpa_rel_err"] <= 1e-4):
        failures.append(f"33b: flash at the shard shape {r}")
    return r


def p33_dp_tp(torch, card, x, y, failures):
    """33c: the same net on a 2 x 2 {data, model} mesh under the ICI
    master against one process's fits."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        shard_transformer_tp
    from deeplearning4j_tpu_torch.parallel.trainer import \
        IciDataParallelTrainingMaster
    ref = p33_net()
    p0 = p33_flat(torch, ref)
    xs, ys = ref._as_tensor(x), ref._as_tensor(y)

    def single():
        ref.fit_batch([xs], [ys])
        return ref._score_raw
    l1, ms1 = p33_fit(torch, single)
    p1 = p33_flat(torch, ref)
    del ref
    t0 = time.monotonic()
    mesh = make_mesh({"data": 2, "model": 2}, p33_devices(4),
                     timeout=P31_TIMEOUT).start()
    start_s = time.monotonic() - t0
    try:
        net = p33_net()
        shard_transformer_tp(net, mesh)
        master = IciDataParallelTrainingMaster(mesh=mesh)
        mesh.reset_counts()

        def step():
            master.execute_training(net, [DataSet(x, y)])
            return net._score_raw
        l2, ms2 = p33_fit(torch, step)
        counts = mesh.query_counts(by_axis=True)
        p2 = p33_flat(torch, net)
        master.close()
    finally:
        mesh.close()
    rel = p33_rel(torch, p2, p1, p1 - p0)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    by_axis = [{k: v for k, v in c.items() if "@" in k and v}
               for c in counts]
    phase(33, f"(c) dp x tp: the flagship on a 2 x 2 {{data, model}} mesh "
              f"({p33_devices(1)[0]} x 4, gloo) under the ICI master, "
              f"{P33_STEPS} steps of B={P33_B}: losses {l2} against one "
              f"process {l1} (max rel {loss_rel:.3e}, gate "
              f"{P33_DP_LOSS_REL:g}); params {rel:.3e} of the change (gate "
              f"{P33_PARAM_REL:g}); collectives by axis per rank {by_axis}; "
              f"step ms {[round(m, 3) for m in ms2]} against one process "
              f"{[round(m, 3) for m in ms1]}; mesh start {start_s:.1f} s "
              f"[{card}]")
    if not loss_rel <= P33_DP_LOSS_REL:
        failures.append(f"33c: losses {l2} vs {l1}")
    if not rel <= P33_PARAM_REL:
        failures.append(f"33c: params {rel:.3e} of the change")
    for c in counts:
        if not (c["all_reduce@data"] == P33_STEPS
                and c["all_reduce@model"] == 4 * BLOCKS * P33_STEPS):
            failures.append(f"33c: collectives {c}")
    return {"losses": l2, "single_losses": l1, "step_ms": ms2,
            "single_step_ms": ms1, "loss_rel": loss_rel, "param_rel": rel,
            "collectives_by_axis_per_rank": by_axis, "mesh_start_s": start_s}


def p33_zero(torch, card, mesh, x, y, failures):
    """33d: ZeRO-1 under the ICI master on the 2-rank mesh against the
    unsharded master."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.trainer import \
        IciDataParallelTrainingMaster
    from deeplearning4j_tpu_torch.parallel import zero
    axis = mesh.axis_names[0]
    runs = {}
    for tag in ("unsharded", "zero"):
        net = p33_net()
        p0 = p33_flat(torch, net)
        counts = None
        if tag == "zero":
            counts = zero.shard_updater_state(net, mesh, axis=axis)
        master = IciDataParallelTrainingMaster(mesh=mesh)

        def step():
            master.execute_training(net, [DataSet(x, y)])
            return net._score_raw
        losses, ms = p33_fit(torch, step)
        stats = mesh.query_stats(["updater_state_bytes"]) \
            if tag == "zero" else None
        runs[tag] = {"losses": losses, "step_ms": ms,
                     "bytes": zero.updater_state_bytes_per_device(net),
                     "rank_bytes": ([s["updater_state_bytes"] for s in stats]
                                    if stats else None),
                     "leaves": counts, "p0": p0, "p": p33_flat(torch, net)}
        master.close()
        del net
    u, z = runs["unsharded"], runs["zero"]
    rel = p33_rel(torch, z["p"], u["p"], u["p"] - u["p0"])
    ratio = z["bytes"] / u["bytes"]
    phase(33, f"(d) ZeRO-1: the flagship under the ICI master on 2 ranks, "
              f"{P33_STEPS} steps: params {rel:.3e} of the change from the "
              f"unsharded master's (gate {P33_ZERO_REL:g}); losses "
              f"{z['losses']} (unsharded {u['losses']}); sharded leaves "
              f"{z['leaves']}; updater bytes per rank {z['rank_bytes']} "
              f"against {u['bytes']} unsharded ({ratio:.4f}, gate "
              f"{P33_ZERO_BYTES}); step ms {[round(m, 3) for m in z['step_ms']]} "
              f"(unsharded {[round(m, 3) for m in u['step_ms']]}) [{card}]")
    if not rel <= P33_ZERO_REL:
        failures.append(f"33d: ZeRO params {rel:.3e} of the change")
    if not (P33_ZERO_BYTES[0] <= ratio <= P33_ZERO_BYTES[1]
            and all(b == z["bytes"] for b in z["rank_bytes"])):
        failures.append(f"33d: updater bytes {z['rank_bytes']} vs "
                        f"{u['bytes']}")
    return {k: {f: v for f, v in r.items() if f not in ("p", "p0")}
            for k, r in runs.items()} | {"param_rel": rel,
                                        "bytes_ratio": ratio}


def p33_attention(torch, ck, card, mesh, failures):
    """33e: ring and Ulysses at [1, 8192, 8, 64] over 2 ranks against
    the single-card flash forward."""
    from deeplearning4j_tpu_torch.ops import helpers as ophelpers
    from deeplearning4j_tpu_torch.parallel.ring import (ring_attention,
                                                        ulysses_attention)
    axis = mesh.axis_names[0]
    L = P33_ATTN_L if P33_DEV == "cuda" else 256
    g = torch.Generator().manual_seed(333)
    q, k, v = (torch.randn((1, L, HEADS, D_MODEL // HEADS), generator=g)
               .to(P33_DEV) for _ in range(3))
    out = {}
    with torch.no_grad():
        t0 = time.monotonic()
        ref = ophelpers.attention(q, k, v, causal=True)
        p33_sync(torch)
        out["single_ms"] = 1e3 * (time.monotonic() - t0)
        scale = float(ref.abs().max())
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            mesh.reset_launches()
            mesh.reset_counts()
            t0 = time.monotonic()
            got = fn(q, k, v, mesh, axis=axis, causal=True)
            p33_sync(torch)
            ms = 1e3 * (time.monotonic() - t0)
            launches = mesh.query_launches()
            counts = mesh.query_counts(by_axis=True)
            err = float((got - ref).abs().max()) / scale
            out[name] = {"rel_err": err, "ms": ms,
                         "flash_fwd_launches_per_rank": [
                             r.get("flash_attention_fwd", 0)
                             for r in launches],
                         "exchanges_per_rank": [
                             {k: c[k] for k in ("send", "recv", "all_to_all")}
                             for c in counts]}
            if not err <= P33_ATTN_REL:
                failures.append(f"33e: {name} rel err {err:.3e}")
    u = out["ulysses"]["flash_fwd_launches_per_rank"]
    if P33_DEV == "cuda" and u != [1, 1]:
        failures.append(f"33e: Ulysses flash launches per rank {u}")
    phase(33, f"(e) ring and Ulysses attention at [1, {L}, {HEADS}, "
              f"{D_MODEL // HEADS}] causal over 2 ranks: max|diff|/max|ref| "
              f"ring {out['ring']['rel_err']:.3e}, Ulysses "
              f"{out['ulysses']['rel_err']:.3e} (gate {P33_ATTN_REL:g}) "
              f"against the single-card flash forward; Ulysses flash "
              f"forward launches per rank {u} (at H/2 = {HEADS // 2} heads); "
              f"exchanges per rank ring {out['ring']['exchanges_per_rank']}, "
              f"Ulysses {out['ulysses']['exchanges_per_rank']}; host ms "
              f"ring {out['ring']['ms']:.3f}, Ulysses "
              f"{out['ulysses']['ms']:.3f}, one card "
              f"{out['single_ms']:.3f} [{card}]")
    return out


def p33_pipe_moe(torch, card, mesh, failures):
    """33f: GPipe (2 stages x 4 microbatches of the block at d_model 512)
    and MoE (2 experts at D = 512) against one process."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.parallel.moe import MoEExecutor
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GPipeExecutor, stack_block_params)
    axis = mesh.axis_names[0]
    d = D_MODEL
    g = torch.Generator().manual_seed(334)

    def w(*shape):
        return (torch.randn(shape, generator=g) / shape[0] ** 0.5).to(
            P33_DEV)
    blocks = [{"Wq": w(d, d), "Wk": w(d, d), "Wv": w(d, d), "Wo": w(d, d),
               "Wf1": w(d, 4 * d), "Wf2": w(4 * d, d)} for _ in range(2)]
    x = torch.randn((P33_PIPE_B, P33_PIPE_T, d), generator=g).to(P33_DEV)
    target = torch.randn(x.shape, generator=g).to(P33_DEV)
    ex = GPipeExecutor(cs.p33_tblock, 2, P33_MICRO, mesh, axis=axis)
    stacked = ex.shard_params(stack_block_params(blocks))
    t0 = time.monotonic()
    y = ex.apply(stacked, x)
    loss, grads = ex.grad_fn(lambda a, t: ((a - t) ** 2).mean())(
        stacked, x, target)
    p33_sync(torch)
    pipe_ms = 1e3 * (time.monotonic() - t0)
    ps = [{k: v.clone().requires_grad_(True) for k, v in b.items()}
          for b in blocks]
    ys = x
    for p in ps:
        ys = p33_tblock(p, ys)
    ls = ((ys - target) ** 2).mean()
    ls.backward()
    ys, ls = ys.detach(), ls.detach()
    y_err = float((y - ys).abs().max() / ys.abs().max())
    g_err = max(float((grads[k][i] - ps[i][k].grad).abs().max()
                      / ps[i][k].grad.abs().max())
                for k in grads for i in range(2))
    l_err = abs(float(loss) - float(ls)) / abs(float(ls))
    # MoE: two experts, the batch split over the two ranks
    experts = [{"W1": w(d, P33_MOE_H), "W2": w(P33_MOE_H, d)}
               for _ in range(2)]
    gate_w = w(d, 2)
    xm = torch.randn((P33_MOE_B, d), generator=g).to(P33_DEV)
    moe = MoEExecutor(cs.p33_expert, 2, mesh, capacity_factor=1.0,
                      axis=axis)
    sm = moe.shard_params(stack_block_params(experts))
    mesh.reset_counts()
    t0 = time.monotonic()
    ym = moe.apply(sm, gate_w, xm)
    p33_sync(torch)
    moe_ms = 1e3 * (time.monotonic() - t0)
    a2a = [c["all_to_all"] for c in mesh.query_counts(by_axis=True)]
    cap = moe.capacity(P33_MOE_B // 2)
    ref = p33_moe_ref(torch, experts, gate_w, xm, cap, 2)
    m_err = float((ym - ref).abs().max() / ref.abs().max())
    dropped = int((ref.abs().sum(-1) == 0).sum())
    mloss, (ge, gg) = moe.grad_fn(lambda a, t: (a ** 2).mean())(
        sm, gate_w, xm, xm)
    m_fin = bool(torch.isfinite(mloss) and all(
        torch.isfinite(t).all() for t in ge.values())
        and torch.isfinite(gg).all() and float(gg.abs().sum()) > 0)
    out = {"pipe": {"y_rel": y_err, "grad_rel": g_err, "loss_rel": l_err,
                    "ms": pipe_ms},
           "moe": {"y_rel": m_err, "capacity": cap, "dropped": dropped,
                   "all_to_all_per_rank": a2a, "grads_finite": m_fin,
                   "ms": moe_ms}}
    phase(33, f"(f) GPipe, 2 stages x {P33_MICRO} microbatches of the "
              f"pre-LN block at d_model {d} ([{P33_PIPE_B}, {P33_PIPE_T}, "
              f"{d}]): forward {y_err:.3e}, gradients {g_err:.3e}, loss "
              f"{l_err:.3e} of the sequential stack's (gate "
              f"{P33_PIPE_REL:g}), apply + grad {pipe_ms:.3f} ms; MoE, 2 "
              f"experts at D = {d} (hidden {P33_MOE_H}), B = {P33_MOE_B}, "
              f"capacity {cap}: {m_err:.3e} of the one-process routing "
              f"(gate {P33_PIPE_REL:g}), {dropped} tokens dropped, "
              f"all-to-alls per rank {a2a}, gradients finite and reaching "
              f"the router {m_fin}, apply {moe_ms:.3f} ms [{card}]")
    if not max(y_err, g_err, l_err) <= P33_PIPE_REL:
        failures.append(f"33f: GPipe {out['pipe']}")
    if not (m_err <= P33_PIPE_REL and m_fin and a2a == [2, 2]):
        failures.append(f"33f: MoE {out['moe']}")
    return out


def phase33(torch, ck, card):
    """33a-f: see the module docstring."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    t0 = time.monotonic()
    failures = []
    x, y = p33_batch(torch)
    out = {}
    mesh = make_mesh({"model": 2}, p33_devices(2),
                     timeout=P31_TIMEOUT).start()
    out["mesh_start_s"] = time.monotonic() - t0
    try:
        out["a"] = p33_tp(torch, ck, card, mesh, x, y, failures)
        if P33_DEV == "cuda":
            out["b"] = p33_flash(torch, ck, card, failures)
        out["d"] = p33_zero(torch, card, mesh, x, y, failures)
        out["e"] = p33_attention(torch, ck, card, mesh, failures)
        out["f"] = p33_pipe_moe(torch, card, mesh, failures)
    finally:
        mesh.close()
    out["c"] = p33_dp_tp(torch, card, x, y, failures)
    out["seconds"] = time.monotonic() - t0
    phase(33, f"phase 33 took {out['seconds']:.3f} s [{card}]")
    if failures:
        raise SystemExit("phase 33 failed: " + "; ".join(failures))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.models.sampling import generate_transformer
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.monotonic()
    card = card_line()
    phase(0, f"card: {card}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    logs = _build.build_all(sources)
    for s in sources:
        _build.load(s)
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase(1, f"built {sources} in {build_s:.3f} s; ptxas: {ptxas}")
    # the tensor-core kernels as loaded: registers (ptxas's count), local
    # bytes per thread (spills and stack), dynamic shared memory
    attn_build = {D: ck.attention_tc_attrs(D) for D in ck.FLASH_HEAD_DIMS}
    phase(1, f"tensor-core attention kernels by head dim: {attn_build}")
    attn_bf16_build = {D: ck.attention_bf16_attrs(D)
                       for D in ck.FLASH_HEAD_DIMS}
    phase(1, f"bf16 attention kernels by head dim: {attn_bf16_build}")
    fwd16_roles = ck.attention_bf16_fwd_roles()
    fwd16_spills, fwd16_serialised = attn16_ptxas(logs)
    phase(1, f"bf16 forward core (attn_fwd_bf16.cuh: wgmma fed by TMA "
             f"through an mbarrier ring, warp-specialised): "
             f"{fwd16_roles['threads']} threads a block, "
             f"{fwd16_roles['rows_per_block']} query rows, K/V tiles of "
             f"{fwd16_roles['keys_per_tile']} keys in "
             f"{fwd16_roles['stages']} stages; setmaxnreg gives the producer "
             f"warpgroup (one thread issues every TMA load) "
             f"{fwd16_roles['producer_registers']} registers a thread and "
             f"each of the two consumer warpgroups (64 query rows: wgmma and "
             f"the softmax) {fwd16_roles['consumer_registers']}; by head dim "
             f"as loaded (registers at launch, local bytes, shared memory): "
             + str({D: {k: a[k] for k in ("flash_fwd_causal", "flash_fwd_full",
                                            "splash_fwd")}
                    for D, a in attn_bf16_build.items()})
             + f"; ptxas (registers, spills): {fwd16_spills}; wgmma "
             f"serialised in {fwd16_serialised} ptxas warnings")
    dkv16_roles = ck.attention_bf16_dkv_roles()
    dkv16_spills, dkv16_serialised = attn16_ptxas(logs, "bwd_dkv")
    phase(1, f"bf16 dK/dV core (attn_dkv_bf16.cuh: wgmma, q and dO fed by "
             f"TMA through an mbarrier ring): {dkv16_roles['threads']} "
             f"threads a block, two warpgroups of 64 of its "
             f"{dkv16_roles['keys_per_block']} keys, q and dO tiles of "
             f"{dkv16_roles['rows_per_tile']} rows in "
             f"{dkv16_roles['stages']} stages, refilled by the warpgroup "
             f"done with a stage second; by head dim as loaded (registers, "
             f"local bytes, shared memory): "
             + str({D: {k: a[k] for k in ("flash_bwd_dkv_causal",
                                            "flash_bwd_dkv_full",
                                            "splash_bwd_dkv")}
                    for D, a in attn_bf16_build.items()})
             + f"; ptxas (registers, spills): {dkv16_spills}; wgmma "
             f"serialised in {dkv16_serialised} ptxas warnings")
    dq16_roles = ck.attention_bf16_dq_roles()
    dq16_spills, dq16_serialised = attn16_ptxas(logs, "bwd_dq")
    phase(1, f"bf16 dQ core (attn_dq_bf16.cuh: wgmma, k and v fed by TMA "
             f"through an mbarrier ring): {dq16_roles['threads']} threads "
             f"a block, two warpgroups of 64 of its "
             f"{dq16_roles['rows_per_block']} query rows, k and v tiles of "
             f"{dq16_roles['keys_per_tile']} keys in "
             f"{dq16_roles['stages']} stages, refilled by the warpgroup "
             f"done with a stage second; by head dim as loaded (registers, "
             f"local bytes, shared memory): "
             + str({D: {k: a[k] for k in ("flash_bwd_dq_causal",
                                            "flash_bwd_dq_full",
                                            "splash_bwd_dq")}
                    for D, a in attn_bf16_build.items()})
             + f"; ptxas (registers, spills): {dq16_spills}; wgmma "
             f"serialised in {dq16_serialised} ptxas warnings")
    paged_build = {f"G={g} Dh=64": ck.paged_decode_attrs(g, D_MODEL // HEADS)
                   for g in (1, 4)}
    phase(1, f"paged decode kernels at the serving head dim, MHA and GQA: "
             f"{paged_build}")
    conv_build = {f"C={c} OC={oc}": ck.conv2d_bias_act_attrs(c, oc)
                  for c, oc in ((3, 64), (64, 128), (128, 256), (20, 50))}
    phase(1, f"conv2d_bias_act variants at AlexNet's and LeNet's channels: "
             f"{conv_build}")
    bnap_build = ck.bnap_sums_attrs()
    phase(1, f"bnap_sums (relu) by lane width: {bnap_build}")
    cnn16_build = {
        "conv2d_bias_act": {f"C={c} OC={oc}": ck.conv2d_bias_act_attrs(
            c, oc, torch.bfloat16) for c, oc in ((3, 64), (64, 128),
                                                 (128, 256), (20, 50))},
        "bnap_sums": ck.bnap_sums_attrs(torch.bfloat16),
        "bnap_dx": ck.bnap_dx_bf16_attrs()}
    phase(1, f"bf16 CNN kernels (conv by AlexNet's and LeNet's channels, "
             f"bnap_sums (relu) by lane width, bnap_dx): {cnn16_build}")
    bnap16_ring = ck.bnap_bf16_ring_attrs()
    bnap16_ring_ptxas = bnap_ring_ptxas(logs)
    ring_lim = ck.bnap_bf16_route_limits()
    phase(1, f"bf16 BN+act+pool ring kernels (bnap_common.cuh: "
             f"{ring_lim['kRingConsumers']} consumers and a producer warp a "
             f"block, {ring_lim['kRingBlocksPerSm']} blocks an SM, "
             f"{ring_lim['kRingSumsStages']} stages (sums) and "
             f"{ring_lim['kRingDxStages']} (dx) of 10 KiB, 16-byte lanes), "
             f"as loaded at relu (registers, local bytes, shared memory): "
             f"{bnap16_ring}; ptxas (registers, spills) by activation: "
             f"{bnap16_ring_ptxas}")
    if any(a["local_bytes"] for a in bnap16_ring.values()) or any(
            v.get("spill_stores", 0) for k in bnap16_ring_ptxas.values()
            for v in k.values()):
        raise SystemExit(f"bf16 BN+act+pool ring kernels use local memory: "
                         f"{bnap16_ring} {bnap16_ring_ptxas}")
    conv16_roles = ck.conv_bf16_wgmma_roles()
    conv16_spills, conv16_serialised = conv16_ptxas(logs)
    # (B, H, W, C, K, OC, stride, padding): AlexNet's three convs, LeNet's
    # conv2, then shapes at each limit of the route (conv_bf16.cuh
    # wgmma_route): C = 8, OC = 72; M = 2^31 - 129 and 2^31 - 128 (1 x 1
    # convs of 1 x 1 images); stride 8 and 9; a corner at -128 and -129
    route_shapes = {
        "alexnet conv1": (512, 32, 32, 3, 3, 64, (1, 1), "SAME"),
        "alexnet conv2": (512, 16, 16, 64, 3, 128, (1, 1), "SAME"),
        "alexnet conv3": (512, 8, 8, 128, 3, 256, (1, 1), "SAME"),
        "lenet conv2": (512, 12, 12, 20, 5, 50, (1, 1), "VALID"),
        "C=8 OC=72": (2, 12, 11, 8, 5, 72, (2, 2), "SAME"),
        "M=2^31-129": (2 ** 31 - 129, 1, 1, 64, 1, 64, (1, 1), "VALID"),
        "M=2^31-128": (2 ** 31 - 128, 1, 1, 64, 1, 64, (1, 1), "VALID"),
        "stride 8": (1, 64, 64, 64, 3, 64, (8, 8), "SAME"),
        "stride 9": (1, 64, 64, 64, 3, 64, (9, 9), "SAME"),
        "corner -128": (1, 8, 8, 64, 3, 64, (1, 1), ((128, 0), (1, 1))),
        "corner -129": (1, 8, 8, 64, 3, 64, (1, 1), ((129, 0), (1, 1)))}
    conv16_routes = {
        k: ck.conv_bf16_route_on_card(B, H, W, C, K, K, OC, st, pad)
        for k, (B, H, W, C, K, OC, st, pad) in route_shapes.items()}
    phase(1, f"bf16 conv, wgmma kernel (conv_bf16.cuh: an implicit GEMM on "
             f"wgmma fed through an mbarrier ring by a producer warpgroup; A "
             f"by TMA im2col, B by TMA; a persistent grid): "
             f"{conv16_roles['threads']} threads "
             f"a block, tiles of {conv16_roles['tile_rows']} x "
             f"{conv16_roles['tile_cols']}, K slices of "
             f"{conv16_roles['k_per_slice']} in {conv16_roles['stages']} "
             f"stages; setmaxnreg gives the producer warpgroup "
             f"{conv16_roles['producer_registers']} registers a thread and "
             f"each of the two consumer warpgroups (64 rows each: wgmma and "
             f"the epilogue) {conv16_roles['consumer_registers']}; ptxas "
             f"(registers, spills): {conv16_spills}; wgmma serialised in "
             f"{conv16_serialised} ptxas warnings; the route as the built "
             f"library decides it: {conv16_routes}")
    if any(ck.conv_bf16_route(B, H, W, C, K, K, OC, st, pad)
           != conv16_routes[k]
           for k, (B, H, W, C, K, OC, st, pad) in route_shapes.items()):
        raise SystemExit(f"the bf16 conv route of the built library is not "
                         f"cuda_kernels.conv_bf16_route's: {conv16_routes}")

    cases = {}
    for name, H, Hkv in (("mha", 8, 8), ("gqa", 8, 2)):
        for quantized in (False, True):
            key = f"{name}_{'int8' if quantized else 'fp32'}"
            r = kernel_case(ck, torch, H=H, Hkv=Hkv, quantized=quantized,
                            seed=len(cases))
            cases[key] = r
            phase(2, f"{key}: B={SLOTS} H={H} Hkv={Hkv} Dh=64 block=16 nb=64 "
                     f"S={r['splits']} live={r['live_positions']} "
                     f"max|diff|={r['max_abs_err']:.3e}, bitwise repeatable "
                     f"{r['repeat_bitwise']}; kernel {r['ms']:.4f} ms, plain "
                     f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_by']}); library call: none (no single "
                     f"PyTorch op gathers pages and attends) [{card}]")
            if not (r["max_abs_err"] < 1e-4 and r["repeat_bitwise"]
                    and r["finite"]):
                raise SystemExit(f"kernel disagrees with the plain version "
                                 f"or with itself: {key} {r}")
            edges = edge_cases(ck, torch, H=H, Hkv=Hkv, quantized=quantized)
            r["edges"] = edges
            r["edge_max_abs_err"] = max(e["max_abs_err"]
                                        for e in edges.values())
            for bucket, e in edges.items():
                phase(2, f"{key} edges, {bucket} (S={e['splits']}), depths "
                         f"{e['depths']}: max|diff|={e['max_abs_err']:.3e}, "
                         f"bitwise repeatable {e['repeat_bitwise']}")
                if not (e["max_abs_err"] < 1e-4 and e["repeat_bitwise"]
                        and e["finite"]):
                    raise SystemExit(f"kernel disagrees with the plain "
                                     f"version or with itself at the edge "
                                     f"depths: {key} {bucket} {e}")

    conf = transformer_lm(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                          n_blocks=BLOCKS, rope=True, seed=7)
    net = ComputationGraph(conf, device="cuda").init()
    reqs = requests_for(seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        zpath = os.path.join(tmp, "lm.zip")
        write_model(net, zpath)
        tokens, e2e, snet = serve_run(ck, zpath, reqs, None)
        tokens_eager, e2e_eager, _ = serve_run(ck, zpath, reqs, None, "off")
        e2e["eager"] = e2e_eager
        solo = []
        n0 = ck.LAUNCHES["flash_attention_fwd"]
        for b in reqs:
            solo.append(generate_transformer(snet, b["prompt"], NEW_TOKENS,
                                             VOCAB, **sampling_kw(b)))
        e2e["solo_flash_fwd_launches"] = ck.LAUNCHES["flash_attention_fwd"] - n0
        if tokens != solo:
            raise SystemExit("served tokens differ from solo decode: "
                             + divergence(snet, reqs, tokens, solo))
        if tokens_eager != tokens:
            raise SystemExit("captured and eager decode steps served "
                             "different tokens: "
                             + divergence(snet, reqs, tokens_eager, solo))
        if e2e["solo_flash_fwd_launches"] != BLOCKS * NEW_TOKENS * len(reqs):
            raise SystemExit(f"the solo reference launched the forward "
                             f"kernel {e2e['solo_flash_fwd_launches']} times, "
                             f"want {BLOCKS} x {NEW_TOKENS} x {len(reqs)}")
        phase(3, f"flagship LM ({net.num_params()} params) served 8 "
                 f"concurrent /generate, prompts "
                 f"{[len(b['prompt']) for b in reqs]}: tokens identical to "
                 f"solo and to the eager step; captured: {e2e['tokens']} "
                 f"tokens in {e2e['wall_s']:.3f} s = "
                 f"{e2e['tokens_per_s']:.2f} tokens/s, {e2e['decode_steps']} "
                 f"decode steps, mean {e2e['mean_decode_step_ms']:.3f} ms "
                 f"(eager: {e2e_eager['tokens_per_s']:.2f} tokens/s, "
                 f"{e2e_eager['decode_steps']} steps, mean "
                 f"{e2e_eager['mean_decode_step_ms']:.3f} ms), "
                 f"{e2e['prefill_chunks']} prefill chunks "
                 f"({e2e['final_chunks']} final, {e2e['chunk_row_reads']} "
                 f"rows read back), mean {e2e['mean_prefill_chunk_ms']:.3f} "
                 f"ms captured against {e2e_eager['mean_prefill_chunk_ms']:.3f}"
                 f" ms eager; time to first token p50 "
                 f"{e2e['ttft_p50_ms']:.3f} / p99 {e2e['ttft_p99_ms']:.3f} ms "
                 f"(eager {e2e_eager['ttft_p50_ms']:.3f} / "
                 f"{e2e_eager['ttft_p99_ms']:.3f} ms); kernel launches "
                 f"{e2e['launches']} = {BLOCKS} x {e2e['decode_steps']} "
                 f"(eager {e2e_eager['launches']}); captures: "
                 f"{e2e['captures']} decode for {e2e['table_buckets']} table "
                 f"buckets + {e2e['prefill_captures']} prefill for "
                 f"{e2e['chunk_buckets']} chunk x {e2e['table_buckets']} "
                 f"table buckets, all in warmup() ({e2e['warmup_s']:.3f} s, "
                 f"graph pool {e2e['graph_pool_bytes']} B); the solo "
                 f"reference launched "
                 f"flash_attention_fwd {e2e['solo_flash_fwd_launches']} "
                 f"times = {BLOCKS} x {NEW_TOKENS} x {len(reqs)}, the server "
                 f"none [{card}]")

        tokens8, e2e8, snet8 = serve_run(ck, zpath, reqs, "int8")
        tokens8_eager, e2e8_eager, _ = serve_run(ck, zpath, reqs, "int8",
                                                 "off")
        e2e8["eager"] = e2e8_eager
        ref = DecodeScheduler(snet8, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                              kv_block=KV_BLOCK, kv_pool_mb=KV_POOL_MB,
                              kv_dtype="int8", paged_kernel="off",
                              device="cuda").start()
        try:
            hs = [ref.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
                  for b in reqs]
            ref_tokens = [h.result(timeout=900) for h in hs]
        finally:
            ref.stop()
        for label, got in (("kernel", tokens8), ("eager step", tokens8_eager)):
            if got != ref_tokens:
                bad = [i for i, (a, s) in enumerate(zip(got, ref_tokens))
                       if a != s]
                raise SystemExit(f"int8 {label} tokens differ from the "
                                 f"gather body for requests {bad}")
        phase(4, f"int8 KV: tokens identical to paged_kernel='off' and to "
                 f"the eager step; captured {e2e8['tokens_per_s']:.2f} "
                 f"tokens/s, mean decode step "
                 f"{e2e8['mean_decode_step_ms']:.3f} ms (eager "
                 f"{e2e8_eager['tokens_per_s']:.2f} tokens/s, "
                 f"{e2e8_eager['mean_decode_step_ms']:.3f} ms), kernel "
                 f"launches {e2e8['launches']} = {BLOCKS} x "
                 f"{e2e8['decode_steps']}; mean prefill chunk "
                 f"{e2e8['mean_prefill_chunk_ms']:.3f} ms (eager "
                 f"{e2e8_eager['mean_prefill_chunk_ms']:.3f} ms); captures "
                 f"{e2e8['captures']} decode + {e2e8['prefill_captures']} "
                 f"prefill, all in warmup() [{card}]")

    prof = {}
    for kv_dtype in (None, "int8"):
        for graphs in ("on", "off"):
            prof[f"{kv_dtype or 'fp32'}_{graphs}"] = profile_run(
                snet, reqs, kv_dtype, graphs)
    for kv_label in ("fp32", "int8"):
        on, off = prof[f"{kv_label}_on"], prof[f"{kv_label}_off"]
        if on["device_busy_ms"] > 0 and off["device_busy_ms"] > 0:
            print(f"[profile] {kv_label} serving run under torch.profiler, "
                  f"captured | eager: wall {on['wall_ms']:.3f} | "
                  f"{off['wall_ms']:.3f} ms, device busy "
                  f"{on['device_busy_ms']:.3f} | {off['device_busy_ms']:.3f}"
                  f" ms ({100 * on['device_busy_share']:.2f}% | "
                  f"{100 * off['device_busy_share']:.2f}%), mean decode step "
                  f"{on['mean_decode_step_ms']:.3f} | "
                  f"{off['mean_decode_step_ms']:.3f} ms, paged kernel "
                  f"{on['paged_kernel_ms']:.3f} | {off['paged_kernel_ms']:.3f}"
                  f" ms, decode {on['decode_s']:.3f} | {off['decode_s']:.3f} s"
                  f" / prefill {on['prefill_s']:.3f} | {off['prefill_s']:.3f}"
                  f" s of host time; top kernels captured "
                  f"{on['top_kernels_ms'][:4]} [{card}]", flush=True)
        else:
            print(f"[profile] {kv_label}: the profiler saw no device time: "
                  "not measured", flush=True)

    # -- 5. the training kernels against their plain versions --------------
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    same = ((1, 1), (1, 1))
    conv_main = [  # AlexNet-CIFAR10's three convs, then LeNet-MNIST's conv2
        dict(B=512, H=32, W=32, C=3, K=3, OC=64, stride=(1, 1),
             padding=same, act="identity"),
        dict(B=512, H=16, W=16, C=64, K=3, OC=128, stride=(1, 1),
             padding=same, act="identity"),
        dict(B=512, H=8, W=8, C=128, K=3, OC=256, stride=(1, 1),
             padding=same, act="identity"),
        dict(B=512, H=12, W=12, C=20, K=5, OC=50, stride=(1, 1),
             padding="VALID", act="identity")]
    conv_edge = [
        dict(B=3, H=13, W=11, C=8, K=5, OC=50, stride=(2, 2),
             padding="SAME", act="relu"),
        dict(B=1, H=7, W=7, C=4, K=3, OC=33, stride=(2, 2), padding="SAME",
             act="tanh"),
        dict(B=2, H=9, W=10, C=3, K=3, OC=70, stride=(1, 2),
             padding=((2, 0), (1, 1)), act="sigmoid")]
    conv_cases = []
    for i, c in enumerate(conv_main + conv_edge):
        r = conv_case(ck, torch, flush, seed=100 + i,
                      library=i < len(conv_main), **c)
        conv_cases.append(r)
        gate = 1e-4 * r["max_abs_plain"]
        phase(5, f"conv2d_bias_act {r['shape']} stride {r['stride']} pads "
                 f"{r['pads']} {r['activation']}: max|diff|="
                 f"{r['max_abs_err']:.3e} (gate {gate:.3e}), bitwise "
                 f"repeatable {r['repeat_bitwise']}; kernel {r['ms']:.4f} ms, "
                 f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']}; 3xTF32 {r['tc_bound_ms']:.4f}, "
                 f"{r['tc_bound_by']}; shares {r['bound_share']:.3f} and "
                 f"{r['tc_bound_share']:.3f}), library {r['library_ms']} ms "
                 f"[{card}]")
        if not (r["max_abs_err"] <= gate and r["repeat_bitwise"]):
            raise SystemExit(f"conv kernel disagrees with the plain version "
                             f"or with itself at {r['shape']}: {r}")
        if r["library_ms"] is not None and not r["library_err"] <= gate:
            raise SystemExit(f"F.conv2d yardstick computes another function "
                             f"at {r['shape']}: {r['library_err']}")
    # AlexNet's three convs summed: one train step's conv forward
    conv_sum = {k: sum(c[k] for c in conv_cases[:3])
                for k in ("ms", "bound_ms", "tc_bound_ms", "library_ms")}
    conv_sum["bound_share"] = conv_sum["bound_ms"] / conv_sum["ms"]
    conv_sum["tc_bound_share"] = conv_sum["tc_bound_ms"] / conv_sum["ms"]
    phase(5, f"conv2d_bias_act, AlexNet's three convs summed: kernel "
             f"{conv_sum['ms']:.4f} ms, F.conv2d (TF32 off) "
             f"{conv_sum['library_ms']:.4f} ms (kernel / library "
             f"{conv_sum['ms'] / conv_sum['library_ms']:.3f}); f32 bound "
             f"{conv_sum['bound_ms']:.4f} ms (share "
             f"{conv_sum['bound_share']:.3f}), 3xTF32 bound "
             f"{conv_sum['tc_bound_ms']:.4f} ms (share "
             f"{conv_sum['tc_bound_share']:.3f}) [{card}]")
    # every activation the epilogue has, at one small shape
    g = torch.Generator().manual_seed(99)
    xs = torch.randn((2, 6, 5, 3), generator=g).cuda() * 2
    ws = (torch.randn((3, 3, 3, 9), generator=g) * 0.3).cuda()
    bs = torch.randn((9,), generator=g).cuda()
    act_errs = {}
    for act in sorted(set(ck.ACT_CODES) - {"linear"}):
        got = ck.conv2d_bias_act(xs, ws, bs, activation=act, want_pre=True)
        want = ck.conv2d_bias_act_ref(xs, ws, bs, activation=act,
                                      want_pre=True)
        act_errs[act] = max(float((a - b).abs().max()
                                  / b.abs().max().clamp_min(1e-30))
                            for a, b in zip(got, want))
    phase(5, f"conv2d_bias_act epilogue, every activation at [2, 6, 5, 3] "
             f"-> 9, output and pre-activation: max|diff| / max|plain| = "
             f"{act_errs} (gate 1e-4)")
    if not max(act_errs.values()) <= 1e-4:
        raise SystemExit(f"conv epilogue disagrees: {act_errs}")
    seam_cases = []
    for i, (act, stride) in enumerate((("identity", (1, 1)),
                                       ("relu", (2, 2)),
                                       ("swish", (1, 1)),
                                       ("softmax", (2, 2)))):
        r = conv_seam_case(ck, torch, act=act, stride=stride, seed=300 + i)
        seam_cases.append(r)
        phase(5, f"conv seam {act} stride {stride}: max|diff| / max|plain| "
                 f"of y, dx, dw, db = {r['rel_err_y_dx_dw_db']} (gate 1e-4); "
                 f"launches forward {r['fwd_launches']}, backward "
                 f"{r['bwd_launches']} (want 1, 0)")
        if not (max(r["rel_err_y_dx_dw_db"]) <= 1e-4
                and r["fwd_launches"] == 1 and r["bwd_launches"] == 0):
            raise SystemExit(f"conv seam disagrees with the plain default: "
                             f"{r}")
    bnap_main = [dict(B=512, H=32, W=32, C=64, act="relu", tied=False),
                 dict(B=512, H=16, W=16, C=128, act="relu", tied=False),
                 dict(B=512, H=8, W=8, C=256, act="relu", tied=False)]
    bnap_edge = [dict(B=2, H=4, W=4, C=8, act="relu", tied=True),
                 dict(B=1, H=4, W=4, C=8, act="sigmoid", tied=False),
                 dict(B=3, H=6, W=10, C=40, act="tanh", tied=False),
                 dict(B=4, H=8, W=6, C=16, act="identity", tied=True)]
    bnap_cases = []
    for i, c in enumerate(bnap_main + bnap_edge):
        r = bnap_case(ck, torch, flush, seed=200 + i, **c)
        bnap_cases.append(r)
        gate = 1e-4 * r["sums_max_abs_plain"]
        phase(5, f"bnap {r['shape']} {r['activation']}"
                 f"{' tied' if r['tied'] else ''}: sums max|diff|="
                 f"{r['sums_max_abs_err']:.3e} (gate {gate:.3e}), bitwise "
                 f"repeatable {r['sums_repeat_bitwise']}; dx max|diff|="
                 f"{r['dx_max_abs_err']:.3e} (gate 1e-5); sums "
                 f"{r['sums_ms']:.4f} ms (plain {r['sums_plain_ms']:.4f}, "
                 f"bound {r['sums_bound_ms']:.4f} {r['sums_bound_by']}, "
                 f"share {r['sums_bound_ms'] / r['sums_ms']:.3f}), dx "
                 f"{r['dx_ms']:.4f} ms (plain {r['dx_plain_ms']:.4f}, bound "
                 f"{r['dx_bound_ms']:.4f} {r['dx_bound_by']}); library call: "
                 "none (no single PyTorch op routes a pooled gradient "
                 f"through BN and the activation) [{card}]")
        if not (r["sums_max_abs_err"] <= gate and r["sums_repeat_bitwise"]
                and r["dx_max_abs_err"] <= 1e-5):
            raise SystemExit(f"BN+act+pool backward kernels disagree with "
                             f"the plain versions at {r['shape']}: {r}")
    # AlexNet's three BN+pool layers summed: one train step's backward
    bnap_sum = {k: sum(c[k] for c in bnap_cases[:3])
                for k in ("sums_ms", "sums_bound_ms", "dx_ms", "dx_bound_ms")}
    phase(5, f"bnap, AlexNet's three layers summed: sums "
             f"{bnap_sum['sums_ms']:.4f} ms, bound "
             f"{bnap_sum['sums_bound_ms']:.4f} ms (share "
             f"{bnap_sum['sums_bound_ms'] / bnap_sum['sums_ms']:.3f}); dx "
             f"{bnap_sum['dx_ms']:.4f} ms, bound {bnap_sum['dx_bound_ms']:.4f} "
             f"ms (share {bnap_sum['dx_bound_ms'] / bnap_sum['dx_ms']:.3f}) "
             f"[{card}]")

    # -- 6. AlexNet-CIFAR10 training, kernels then plain versions ------------
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10, lenet_mnist
    from deeplearning4j_tpu_torch.ops import helpers
    rng = np.random.default_rng(0)
    B, STEPS = 512, 20
    xa = torch.from_numpy(rng.normal(size=(B, 32, 32, 3)).astype(
        np.float32)).cuda()
    ya = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, B)]).cuda()
    torch.cuda.reset_peak_memory_stats()
    anet, losses, secs, alex_launches = train_run(
        ck, torch, alexnet_cifar10(), xa, ya, STEPS)
    want = dict.fromkeys(ck.LAUNCHES, 0)
    want.update(conv2d_bias_act=3 * STEPS, bnap_sums=3 * STEPS,
                bnap_dx=3 * STEPS)
    if alex_launches != want:
        raise SystemExit(f"AlexNet launches {alex_launches}, want {want}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"AlexNet loss did not fall: {losses}")
    steady = secs[1:]
    train = {"batch": B, "steps": STEPS, "losses": losses, "step_s": secs,
             "first_step_ms": secs[0] * 1e3,
             "mean_step_ms": 1e3 * sum(steady) / len(steady),
             "examples_per_s": B * len(steady) / sum(steady),
             "launches": alex_launches, "params": anet.num_params(),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    phase(6, f"AlexNet-CIFAR10 ({train['params']} params) B={B}, {STEPS} "
             f"fit_batch steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
             f"all finite; launches {alex_launches}; steps 2-{STEPS}: mean "
             f"{train['mean_step_ms']:.3f} ms = {train['examples_per_s']:.1f}"
             f" examples/s (first step {train['first_step_ms']:.1f} ms) "
             f"[{card}]")
    tprof = train_profile(torch, anet, xa, ya, 5)
    phase(6, f"under torch.profiler, 5 more steps: wall "
             f"{tprof['wall_ms']:.3f} ms, device busy "
             f"{tprof['device_busy_ms']:.3f} ms "
             f"({100 * tprof['device_busy_share']:.2f}%); the three kernels "
             f"{tprof['kernels_ms']}; top {tprof['top_kernels_ms'][:5]} "
             f"[{card}]")
    # the backward kernels on the training path's own inputs
    grads, failed = alexnet_grad_checks(torch, anet, xa, ya)
    train.update(grad_bnap_plain=grads["bnap_plain"],
                 grad_all_plain=grads["all_plain"],
                 grad_pinned_plain=grads["pinned_plain"])
    phase(6, f"gradients at step {STEPS + 5}'s params, B={B}, same dropout "
             f"masks: {grad_checks_line(grads)}")
    if failed:
        raise SystemExit(f"kernel and plain gradients differ: {failed}: "
                         f"{grads}")
    del anet
    _, plain_losses, plain_secs, plain_launches = train_run(
        ck, torch, alexnet_cifar10(), xa, ya, STEPS, plain=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(plain_losses, losses)]
    train.update(plain_losses=plain_losses, plain_step_s=plain_secs,
                 plain_mean_step_ms=1e3 * sum(plain_secs[1:])
                 / (STEPS - 1), loss_rel_diff=rel)
    if any(plain_launches[k] for k in ("conv2d_bias_act", "bnap_sums",
                                       "bnap_dx")):
        raise SystemExit(f"the plain run launched kernels: {plain_launches}")
    if not (max(rel[:2]) <= 1e-4 and max(rel) <= 2e-2):
        raise SystemExit(f"kernel and plain runs' losses differ by {rel} "
                         f"(relative): {losses} vs {plain_losses}")
    phase(6, f"same seeds through the plain versions: losses agree step for "
             f"step, relative diff {max(rel[:2]):.3e} over steps 1-2 (gate "
             f"1e-4), {max(rel):.3e} over all {STEPS} (gate 2e-2); plain "
             f"mean step {train['plain_mean_step_ms']:.3f} ms [{card}]")

    # -- 7. LeNet-MNIST training -------------------------------------------
    xl = torch.from_numpy(rng.normal(size=(B, 28, 28, 1)).astype(
        np.float32)).cuda()
    _, lenet_losses, lenet_secs, lenet_launches = train_run(
        ck, torch, lenet_mnist(), xl, ya, 5)
    if lenet_launches != {**dict.fromkeys(ck.LAUNCHES, 0),
                          "conv2d_bias_act": 5}:
        raise SystemExit(f"LeNet launches {lenet_launches}, want 1 conv per "
                         f"step")
    lenet = {"losses": lenet_losses, "step_s": lenet_secs,
             "launches": lenet_launches,
             "mean_step_ms": 1e3 * sum(lenet_secs[1:]) / 4}
    phase(7, f"LeNet-MNIST B={B}, 5 steps: losses {lenet_losses}, launches "
             f"{lenet_launches} (conv1 declines: kw*c = 5 < 8); steps 2-5 "
             f"mean {lenet['mean_step_ms']:.3f} ms [{card}]")

    # -- 8. prefix reuse, COW and preemption on the serving flagship -------
    wave2 = prefix_wave(reqs, seed=2)
    prefix = {}
    # the serving flagship's zip, kept for phase 14
    serving_dir = tempfile.TemporaryDirectory()
    serving_zip = os.path.join(serving_dir.name, "lm.zip")
    write_model(net, serving_zip)
    for kv_dtype in (None, "int8"):
        label = kv_dtype or "fp32"
        toks, st, pnet = prefix_run(ck, serving_zip, reqs, wave2, kv_dtype)
        if kv_dtype is None:  # solo generate on the card, as phase 3
            want1 = solo
            want2 = [generate_transformer(pnet, b["prompt"], NEW_TOKENS,
                                          VOCAB, **sampling_kw(b))
                     for b in wave2]
            against = "solo generate_transformer"
        else:  # the layer's gather body on the same two waves
            ref = DecodeScheduler(pnet, VOCAB, n_slots=SLOTS,
                                  prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                                  kv_pool_mb=KV_POOL_MB, kv_dtype="int8",
                                  paged_kernel="off", device="cuda").start()
            try:
                want1, want2 = (
                    [h.result(timeout=900) for h in
                     [ref.submit(b["prompt"], NEW_TOKENS, **sampling_kw(b))
                      for b in wave]] for wave in (reqs, wave2))
            finally:
                ref.stop()
            against = "paged_kernel='off'"
        del pnet
        prefix[label] = st
        w, c, p, r, e = (st[k] for k in ("wave2", "wave2_cold",
                                         "wave2_profiled", "rerun",
                                         "wave2_eager"))
        wrong = [k for k, want in (("wave1", want1), ("wave2", want2),
                                   ("wave2_cold", want2),
                                   ("wave2_profiled", want2),
                                   ("rerun", want1),
                                   ("wave1_eager", toks["wave1"]),
                                   ("wave2_eager", toks["wave2"]))
                 if toks[k] != want]
        if kv_dtype is None:
            prefix_want = (want1, want2)
        phase(8, f"{label} pages, second wave (7 requests on "
                 f"{PREFIX_HEAD}-token heads of the first wave's prompts, "
                 f"1 exact repeat of a {len(wave2[-1]['prompt'])}-token "
                 f"block-aligned one) after the first: {w['tokens']} "
                 f"tokens in {w['wall_s']:.3f} s = {w['tokens_per_s']:.2f}"
                 f" tokens/s, prefix hits {w['hits']} ({w['hit_blocks']} "
                 f"blocks, {w['restored_tokens']} positions restored), COW "
                 f"copies {w['cow_copies']}, {w['prefill_chunks']} prefill "
                 f"chunks, {w['decode_steps']} decode steps, launches "
                 f"{w['launches']}; the same wave cold: {c['wall_s']:.3f} "
                 f"s = {c['tokens_per_s']:.2f} tokens/s, "
                 f"{c['prefill_chunks']} prefill chunks, "
                 f"{c['decode_steps']} decode steps; under the profiler "
                 f"(after the first wave): device busy "
                 f"{p['device_busy_ms']:.3f} ms of {p['wall_s']:.3f} s "
                 f"({100 * p['device_busy_share']:.2f}%), mean decode "
                 f"step {p['mean_decode_step_ms']:.3f} ms; eager step: "
                 f"{e['device_busy_ms']:.3f} ms of {e['wall_s']:.3f} s "
                 f"({100 * e['device_busy_share']:.2f}%), mean decode "
                 f"step {e['mean_decode_step_ms']:.3f} ms; tokens of "
                 f"every wave identical to {against} and to the eager "
                 f"step {not wrong}; decode captures {w['captures']} "
                 f"for {w['table_buckets']} table buckets, all in "
                 f"warmup(); pins left {w['outstanding_refs']} [{card}]")
        phase(8, f"{label} pages, the first wave again on a pool cut to "
                 f"{r['cut']} of its peak need ({r['capacity_blocks']} of "
                 f"{r['peak_blocks']} blocks), posted in order: "
                 f"preemptions {r['preemptions']}, {r['prefill_chunks']} "
                 f"prefill chunks, {r['decode_steps']} decode steps, "
                 f"launches {r['launches']}, {r['wall_s']:.3f} s, pins "
                 f"left {r['outstanding_refs']} [{card}]")
        bad = []
        if wrong:
            bad.append(f"tokens differ from {against} in {wrong}")
        if not (w["hits"] > 0 and w["cow_copies"] > 0):
            bad.append(f"no prefix hit or no COW copy: {w}")
        if not r["preemptions"]:
            bad.append(f"no cut of the pool preempted: {r}")
        if any(x["outstanding_refs"] for x in (w, c, p, r)):
            bad.append("trie pins left after the waves")
        if bad:
            raise SystemExit(f"phase 8 ({label}): " + "; ".join(bad))

    # -- 9. the flash-attention kernels against their plain versions -------
    # phases 9-10 gather their failures and stop after phase 10, so one run
    # reports every figure
    failures = []
    flash_main = [dict(B=32, L=256, H=8, D=64, causal=True),
                  dict(B=1, L=8192, H=4, D=128, causal=True)]
    # every head dim of the tensor-core dK/dV walk meets its odd-L masks
    flash_edge = [dict(B=b, L=L, H=h, D=d, causal=c)
                  for d in (32, 16, 64, 128)
                  for L in ((1, 7, 129, 300) if d == 32 else (7, 129, 300))
                  for b, h, c in ((3, 1, False), (1, 3, True))]
    flash_cases = []
    for i, c in enumerate(flash_main + flash_edge):
        r = flash_case(ck, torch, flush, seed=400 + i,
                       library=i < len(flash_main), **c)
        flash_cases.append(r)
        e = r["rel_err"]
        lib = "" if r["sdpa_fwd_ms"] is None else (
            f"; SDPA (f32, TF32 off) fwd {r['sdpa_fwd_ms']:.4f} ms, fwd+bwd "
            f"{r['sdpa_fwd_bwd_ms']:.4f} ms, its o vs plain "
            f"{r['sdpa_rel_err']:.3e}")
        if r["fwd_splash_ms"] is not None:
            lib += (f"; the splash forward here {r['fwd_splash_ms']:.4f} ms, "
                    f"vs plain {r['fwd_splash_vs_plain']:.3e} (gate 1e-4)")
        phase(9, f"flash {r['shape']} {'causal' if r['causal'] else 'full'}: "
                 f"max|diff|/max|plain| o {e['o']:.3e} lse {e['lse']:.3e} "
                 f"dq {e['dq']:.3e} dk {e['dk']:.3e} dv {e['dv']:.3e} (gates "
                 f"1e-5; gradients over the largest plain gradient), "
                 f"bitwise repeatable {r['repeat_bitwise']}; kernel / plain / "
                 f"bound ms: fwd {r['fwd_ms']:.4f} / {r['fwd_plain_ms']:.4f} / "
                 f"{r['fwd_bound_ms']:.4f} ({r['fwd_bound_by']}; 3xTF32 "
                 f"{r['fwd_tc_bound_ms']:.4f}; shares "
                 f"{r['fwd_bound_share']:.3f} and "
                 f"{r['fwd_tc_bound_share']:.3f}), dkv "
                 f"{r['dkv_ms']:.4f} / {r['dkv_plain_ms']:.4f} / "
                 f"{r['dkv_bound_ms']:.4f} ({r['dkv_bound_by']}; 3xTF32 "
                 f"{r['dkv_tc_bound_ms']:.4f}; shares "
                 f"{r['dkv_bound_share']:.3f} and "
                 f"{r['dkv_tc_bound_share']:.3f}), dq "
                 f"{r['dq_ms']:.4f} / {r['dq_plain_ms']:.4f} / "
                 f"{r['dq_bound_ms']:.4f} ({r['dq_bound_by']}; 3xTF32 "
                 f"{r['dq_tc_bound_ms']:.4f}; shares "
                 f"{r['dq_bound_share']:.3f} and "
                 f"{r['dq_tc_bound_share']:.3f}){lib} [{card}]")
        if not (max(e.values()) <= 1e-5 and r["repeat_bitwise"]
                and r["finite"]):
            failures.append(f"flash kernels disagree with the plain versions "
                            f"at {r['shape']} causal={r['causal']}: {r}")
        if r["sdpa_fwd_ms"] is not None and not r["sdpa_rel_err"] <= 1e-4:
            failures.append(f"the SDPA yardstick computes another function "
                            f"at {r['shape']}: {r['sdpa_rel_err']}")
        if (r["fwd_splash_ms"] is not None
                and not r["fwd_splash_vs_plain"] <= 1e-4):
            failures.append(f"the splash forward disagrees with the flash "
                            f"plain version at {r['shape']}: "
                            f"{r['fwd_splash_vs_plain']}")
    seam = attention_seam_case(ck, torch, seed=500)
    phase(9, f"attention seam [2, 100, 4, 64] causal vs the dense default's "
             f"autograd: max|diff|/max|plain| of y, dq, dk, dv = "
             f"{seam['rel_err_y_dq_dk_dv']} (gate 1e-4); launches forward "
             f"{seam['fwd_launches']}, backward {seam['bwd_launches']}")
    if not (max(seam["rel_err_y_dq_dk_dv"]) <= 1e-4
            and seam["fwd_launches"] == {"flash_attention_fwd": 1}
            and seam["bwd_launches"] == {"flash_attention_bwd_dkv": 1,
                                         "flash_attention_bwd_dq": 1}):
        failures.append(f"attention seam disagrees: {seam}")

    # -- 10. transformer_lm training at full width, kernels then plain ------
    flash_keys = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq")
    lm = {}
    for key, heads, T, Bn, steps in (("transformer_lm", HEADS, 256, 32, 20),
                                     ("transformer_lm_long", 4, 8192, 1, 10)):
        xt, yt = lm_batch(torch, T, Bn)
        torch.cuda.reset_peak_memory_stats()
        net, losses, secs, launches = lm_train_run(ck, torch, heads, xt, yt,
                                                   steps)
        want = dict.fromkeys(ck.LAUNCHES, 0)
        want.update(dict.fromkeys(flash_keys, BLOCKS * steps))
        if launches != want:
            failures.append(f"{key} launches {launches}, want {want}")
        if not losses[-1] < losses[0]:
            failures.append(f"{key} loss did not fall: {losses}")
        steady = secs[1:]
        r = {"heads": heads, "T": T, "batch": Bn, "steps": steps,
             "losses": losses, "step_s": secs, "first_step_ms": secs[0] * 1e3,
             "mean_step_ms": 1e3 * sum(steady) / len(steady),
             "tokens_per_s": Bn * T * len(steady) / sum(steady),
             "launches": launches, "params": net.num_params(),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        phase(10, f"{key} ({r['params']} params) {heads} heads T={T} B={Bn},"
                  f" {steps} fit_batch steps: loss {losses[0]:.6f} -> "
                  f"{losses[-1]:.6f}, all finite; launches "
                  f"{ {k: launches[k] for k in flash_keys} }; steps 2-{steps}:"
                  f" mean {r['mean_step_ms']:.3f} ms = "
                  f"{r['tokens_per_s']:.1f} tokens/s (first step "
                  f"{r['first_step_ms']:.1f} ms) [{card}]")
        r["profile"] = lm_profile(torch, net, xt, yt, 5)
        pr = r["profile"]
        phase(10, f"{key} under torch.profiler, 5 more steps: wall "
                  f"{pr['wall_ms']:.3f} ms, device busy "
                  f"{pr['device_busy_ms']:.3f} ms "
                  f"({100 * pr['device_busy_share']:.2f}%); the three kernels "
                  f"{pr['kernels_ms']}; top {pr['top_kernels_ms'][:5]} "
                  f"[{card}]")
        r["grad_loss_rel"], r["grad_leaf_rel"] = lm_grad_check(torch, net,
                                                               xt, yt)
        worst = max(r["grad_leaf_rel"].items(), key=lambda kv: kv[1])
        phase(10, f"{key} gradients at step {steps + 5}'s params through "
                  f"the kernels and through their plain versions: loss rel "
                  f"diff {r['grad_loss_rel']:.3e} (gate 1e-5), worst leaf "
                  f"{worst[0]} ||diff||/||plain|| {worst[1]:.3e} (gate 1e-3)")
        if not (r["grad_loss_rel"] <= 1e-5 and worst[1] <= 1e-3):
            failures.append(f"{key} kernel and plain gradients differ: "
                            f"{r['grad_loss_rel']} {worst}")
        del net
        torch.cuda.empty_cache()
        _, plain_losses, plain_secs, plain_launches = lm_train_run(
            ck, torch, heads, xt, yt, steps, plain=True)
        rel = [abs(a - b) / abs(b) for a, b in zip(plain_losses, losses)]
        r.update(plain_losses=plain_losses, plain_step_s=plain_secs,
                 plain_mean_step_ms=1e3 * sum(plain_secs[1:]) / (steps - 1),
                 loss_rel_diff=rel)
        if any(plain_launches[k] for k in flash_keys):
            failures.append(f"{key}: the plain run launched kernels: "
                            f"{plain_launches}")
        if not (max(rel[:2]) <= 1e-6 and max(rel) <= 1e-5):
            failures.append(f"{key} kernel and plain runs' losses differ by "
                            f"{rel} (relative): {losses} vs {plain_losses}")
        phase(10, f"{key} same seeds through the plain versions: losses "
                  f"agree step for step, relative diff {max(rel[:2]):.3e} "
                  f"over steps 1-2 (gate 1e-6), {max(rel):.3e} over all "
                  f"{steps} (gate 1e-5); plain mean step "
                  f"{r['plain_mean_step_ms']:.3f} ms [{card}]")
        lm[key] = r
        del xt, yt
        torch.cuda.empty_cache()

    # -- 11. the splash-attention kernels against their plain versions ------
    from deeplearning4j_tpu_torch.ops import helpers
    splash_main = [dict(B=1, L=32768, H=4, D=128, causal=True),
                   dict(B=1, L=32768, H=8, D=128, causal=True),
                   dict(B=4, L=2048, H=4, D=64, causal=False)]
    splash_edge = [dict(B=b, L=L, H=h, D=d, causal=c)
                   for L in (128, 256) for d in (16, 32)
                   for b, h, c in ((3, 1, False), (1, 3, True))]
    splash_cases = []
    for i, c in enumerate(splash_main + splash_edge):
        r = splash_case(ck, torch, flush, seed=600 + i,
                        library=i < len(splash_main), **c)
        splash_cases.append(r)
        torch.cuda.empty_cache()
        e, f = r["rel_err"], r["vs_flash_rel_err"]
        lib = "" if r["sdpa_fwd_ms"] is None else (
            f"; SDPA (f32, TF32 off) fwd {r['sdpa_fwd_ms']:.4f} ms, fwd+bwd "
            f"{r['sdpa_fwd_bwd_ms']:.4f} ms, its o vs plain "
            f"{r['sdpa_rel_err']:.3e}")
        phase(11, f"splash {r['shape']} {'causal' if r['causal'] else 'full'}:"
                  f" max|diff|/max|plain| o {e['o']:.3e} lse {e['lse']:.3e} "
                  f"dq {e['dq']:.3e} dk {e['dk']:.3e} dv {e['dv']:.3e} (gates "
                  f"1e-5), bitwise repeatable {r['repeat_bitwise']}; vs the "
                  f"flash kernels {max(f.values()):.3e} (gate 1e-4); kernel / "
                  f"plain / flash / bound ms: fwd {r['fwd_ms']:.4f} / "
                  f"{r['fwd_plain_ms']:.4f} / {r['fwd_flash_ms']:.4f} / "
                  f"{r['fwd_bound_ms']:.4f} ({r['fwd_bound_by']}; 3xTF32 "
                  f"{r['fwd_tc_bound_ms']:.4f}; shares "
                  f"{r['fwd_bound_share']:.3f} and "
                  f"{r['fwd_tc_bound_share']:.3f}), dkv "
                  f"{r['dkv_ms']:.4f} / {r['dkv_plain_ms']:.4f} / "
                  f"{r['dkv_flash_ms']:.4f} / {r['dkv_bound_ms']:.4f} "
                  f"({r['dkv_bound_by']}; 3xTF32 {r['dkv_tc_bound_ms']:.4f}; "
                  f"shares {r['dkv_bound_share']:.3f} and "
                  f"{r['dkv_tc_bound_share']:.3f}), dq {r['dq_ms']:.4f} / "
                  f"{r['dq_plain_ms']:.4f} / {r['dq_flash_ms']:.4f} / "
                  f"{r['dq_bound_ms']:.4f} ({r['dq_bound_by']}; 3xTF32 "
                  f"{r['dq_tc_bound_ms']:.4f}; shares "
                  f"{r['dq_bound_share']:.3f} and "
                  f"{r['dq_tc_bound_share']:.3f}){lib} [{card}]")
        if not (max(e.values()) <= 1e-5 and r["repeat_bitwise"]
                and r["finite"] and max(f.values()) <= 1e-4):
            failures.append(f"splash kernels disagree at {r['shape']} "
                            f"causal={r['causal']}: {r}")
        if r["sdpa_fwd_ms"] is not None and not r["sdpa_rel_err"] <= 1e-4:
            failures.append(f"the SDPA yardstick computes another function "
                            f"at {r['shape']}: {r['sdpa_rel_err']}")

    # the attention route's crossover: both families at three lengths
    route = [route_case(ck, torch, flush, L, seed=700 + i)
             for i, L in enumerate((8192, 16384, 32768))]
    torch.cuda.empty_cache()
    for r in route:
        phase(11, f"SPLASH_MIN_LEN timings at [1, {r['L']}, 4, 128] causal, "
                  f"fwd / dkv / dq / sum ms: flash "
                  f"{' / '.join(f'{x:.4f}' for x in r['flash_ms'].values())}"
                  f"; splash "
                  f"{' / '.join(f'{x:.4f}' for x in r['splash_ms'].values())}"
                  f" (route today: {helpers.attention_route(r['L'])}) "
                  f"[{card}]")

    # -- 12. transformer_lm at T = 32768 through the splash kernels ---------
    splash_keys = ("splash_attention_fwd", "splash_attention_bwd_dkv",
                   "splash_attention_bwd_dq")
    T32, STEPS32 = 32768, 4
    if helpers.attention_route(T32) != "splash":
        failures.append(f"attention_route({T32}) is not splash")
    xt, yt = lm_batch(torch, T32, 1)
    torch.cuda.reset_peak_memory_stats()
    net, losses, secs, launches = lm_train_run(ck, torch, 4, xt, yt, STEPS32,
                                               remat=True)
    want = dict.fromkeys(ck.LAUNCHES, 0)
    want.update({"splash_attention_fwd": 2 * BLOCKS * STEPS32,
                 "splash_attention_bwd_dkv": BLOCKS * STEPS32,
                 "splash_attention_bwd_dq": BLOCKS * STEPS32})
    if launches != want:
        failures.append(f"transformer_lm_32k launches {launches}, want {want}")
    if not losses[-1] < losses[0]:
        failures.append(f"transformer_lm_32k loss did not fall: {losses}")
    steady = secs[1:]
    lc = {"heads": 4, "T": T32, "batch": 1, "steps": STEPS32, "remat": True,
          "losses": losses, "step_s": secs, "first_step_ms": secs[0] * 1e3,
          "mean_step_ms": 1e3 * sum(steady) / len(steady),
          "tokens_per_s": T32 * len(steady) / sum(steady),
          "launches": launches, "params": net.num_params(),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    phase(12, f"transformer_lm_32k ({lc['params']} params) 4 heads T={T32} "
              f"B=1, remat, {STEPS32} fit_batch steps: loss {losses[0]:.6f} "
              f"-> {losses[-1]:.6f}, all finite; launches "
              f"{ {k: launches[k] for k in splash_keys + flash_keys} }; steps "
              f"2-{STEPS32}: mean {lc['mean_step_ms']:.3f} ms = "
              f"{lc['tokens_per_s']:.1f} tokens/s (first step "
              f"{lc['first_step_ms']:.1f} ms), peak memory "
              f"{lc['peak_mem_bytes']} B [{card}]")
    lc["profile"] = lm_profile(torch, net, xt, yt, 2, keys=(
        "splash_fwd", "splash_bwd_dkv", "splash_bwd_dq"))
    pr = lc["profile"]
    phase(12, f"transformer_lm_32k under torch.profiler, 2 more steps: wall "
              f"{pr['wall_ms']:.3f} ms, device busy {pr['device_busy_ms']:.3f}"
              f" ms ({100 * pr['device_busy_share']:.2f}%); the three kernels "
              f"{pr['kernels_ms']}; top {pr['top_kernels_ms'][:5]} [{card}]")
    lc["grad_loss_rel"], lc["grad_leaf_rel"] = lm_grad_check(torch, net, xt,
                                                             yt)
    worst = max(lc["grad_leaf_rel"].items(), key=lambda kv: kv[1])
    phase(12, f"transformer_lm_32k gradients at step {STEPS32 + 2}'s params "
              f"through the kernels and through their plain versions: loss "
              f"rel diff {lc['grad_loss_rel']:.3e} (gate 1e-5), worst leaf "
              f"{worst[0]} ||diff||/||plain|| {worst[1]:.3e} (gate 1e-3)")
    if not (lc["grad_loss_rel"] <= 1e-5 and worst[1] <= 1e-3):
        failures.append(f"transformer_lm_32k kernel and plain gradients "
                        f"differ: {lc['grad_loss_rel']} {worst}")
    lr_, gr_ = net.compute_gradient_and_score(xt, yt)
    flat = lm_net(4, remat=False)
    flat.set_params(net.params)
    del net
    torch.cuda.empty_cache()
    ck.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lf, gf = flat.compute_gradient_and_score(xt, yt)
    flat_launches = {k: ck.LAUNCHES[k] for k in splash_keys + flash_keys}
    lc["no_remat"] = {
        "loss_rel": float((lf - lr_).abs() / lr_.abs()),
        "leaf_rel": {f"{n}.{k}": float((gf[n][k] - gr_[n][k]).norm()
                                       / gr_[n][k].norm().clamp_min(1e-30))
                     for n in gf for k in gf[n]},
        "launches": flat_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    nr = lc["no_remat"]
    worst = max(nr["leaf_rel"].items(), key=lambda kv: kv[1])
    phase(12, f"transformer_lm_32k the same step with remat off: loss rel "
              f"diff {nr['loss_rel']:.3e}, worst leaf {worst[0]} "
              f"{worst[1]:.3e} (gates 1e-6); launches {flat_launches}; peak "
              f"memory {nr['peak_mem_bytes']} B, with remat "
              f"{lc['peak_mem_bytes']} B [{card}]")
    want_flat = dict.fromkeys(splash_keys + flash_keys, 0)
    want_flat.update(dict.fromkeys(splash_keys, BLOCKS))
    if not (nr["loss_rel"] <= 1e-6 and worst[1] <= 1e-6
            and flat_launches == want_flat):
        failures.append(f"transformer_lm_32k remat off differs: {nr}")
    del flat, gf, gr_, xt, yt
    torch.cuda.empty_cache()

    # -- 13. KV-cache generation on the serving flagship ----------------------
    gnet = ComputationGraph(conf, device="cuda").init()  # phase 3's model
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, VOCAB,
                                                                300)]
    gen = {}
    for label, kw in (("greedy", {}),
                      ("seeded", dict(temperature=0.8, top_k=20, seed=9))):
        t0 = time.monotonic()
        cached = generate_transformer(gnet, prompt, NEW_TOKENS, VOCAB,
                                      use_cache=True, **kw)
        t1 = time.monotonic()
        solo = generate_transformer(gnet, prompt, NEW_TOKENS, VOCAB, **kw)
        t2 = time.monotonic()
        gen[label] = {"cached_s": t1 - t0, "uncached_s": t2 - t1,
                      "identical": cached == solo, "tokens": cached}
        phase(13, f"KV-cache generation {label}, prompt 300, {NEW_TOKENS} new "
                  f"tokens: tokens identical to the uncached solo generate "
                  f"{cached == solo}; cached {t1 - t0:.3f} s, uncached "
                  f"{t2 - t1:.3f} s [{card}]")
        if cached != solo:
            failures.append(f"cached generation ({label}) differs from the "
                            f"uncached: {cached} vs {solo}")
    del gnet
    if failures:
        raise SystemExit("phases 9-13 failed: " + " | ".join(failures))

    # -- 14. contiguous serving, with its side prefix pool, on phase 3's
    # model and phase 8's waves -------------------------------------------
    cont = contiguous_run(ck, serving_zip, [reqs, wave2])
    cnet = cont.pop("net")
    (c1, c1_st), (c2, c2_st) = cont["waves"]
    quantiles = [ln for ln in cont.pop("metrics_text").splitlines()
                 if ln.startswith(("decode_step_time_sec",
                                   "decode_time_to_first_token_sec"))]
    cont["metrics_quantiles"] = quantiles
    bad = []
    if c1 != prefix_want[0]:
        bad.append("first wave's tokens differ from solo generate: "
                   + divergence(cnet, reqs, c1, prefix_want[0]))
    if c2 != prefix_want[1]:
        bad.append("prefix wave's tokens differ from solo generate: "
                   + divergence(cnet, wave2, c2, prefix_want[1]))
    if not c2_st["hits"]:
        bad.append(f"no prefix hit in the second wave: {c2_st}")
    if not (cont["warmup_captures"] == cont["captures"] == 1
            and cont["warmup_prefill_captures"] == cont["prefill_captures"]
            == 3):
        bad.append(f"captures: decode {cont['captures']} (warmup "
                   f"{cont['warmup_captures']}), want exactly 1; prefill "
                   f"{cont['prefill_captures']} (warmup "
                   f"{cont['warmup_prefill_captures']}), want 3 (one per "
                   "chunk bucket)")
    if any(cont["launches"].values()) or cont["kv_mode"] != "contiguous" \
            or cont["outstanding_refs"]:
        bad.append(f"kernel launches {cont['launches']}, mode "
                   f"{cont['kv_mode']}, pins left {cont['outstanding_refs']}")
    phase(14, f"contiguous serving ({cont['cache_positions']} positions a "
              f"slot, {SLOTS} slots, a {PREFIX_CACHE_MB} MiB prefix pool of "
              f"{cont['pool_blocks']} blocks), decode captured "
              f"({cont['captures']} capture) and prefill chunks captured "
              f"({cont['prefill_captures']}, graph pool "
              f"{cont['graph_pool_bytes']} B): first wave "
              f"{c1_st['tokens_per_s']:.2f} tokens/s, mean decode step "
              f"{c1_st['mean_decode_step_ms']:.3f} ms, {c1_st['prefill_chunks']}"
              f" prefill chunks ({c1_st['final_chunks']} final, "
              f"{c1_st['chunk_row_reads']} rows read); prefix wave {c2_st['tokens_per_s']:.2f} "
              f"tokens/s, {c2_st['hits']} hits, {c2_st['restored_tokens']} "
              f"positions restored, {c2_st['prefill_chunks']} prefill chunks; "
              f"tokens of both identical to solo {not bad}; registry: "
              f"{quantiles} [{card}]")
    if bad:
        raise SystemExit("phase 14: " + "; ".join(bad))
    del cnet

    # -- 15. phase 3's wave with the transfer guard on ----------------------
    tokens_g, guarded, _ = serve_run(ck, serving_zip, reqs, None,
                                     guard="disallow")
    if tokens_g != tokens:
        raise SystemExit("phase 15: the guarded wave's tokens differ from "
                         "phase 3's: " + divergence(snet, reqs, tokens_g,
                                                    tokens))
    phase(15, f"phase 3's wave with decode_transfer_guard='disallow' "
              f"(torch.cuda.set_sync_debug_mode('error') around every "
              f"scheduler iteration; the probs and final-row reads "
              f"declared): no undeclared sync raised (0 engine crashes, 0 "
              f"restarts), tokens identical to phase 3; "
              f"{guarded['tokens_per_s']:.2f} tokens/s, mean decode step "
              f"{guarded['mean_decode_step_ms']:.3f} ms, mean prefill chunk "
              f"{guarded['mean_prefill_chunk_ms']:.3f} ms [{card}]")

    # -- 16. the wave as SSE streams, and a client that hangs up -----------
    stream = streaming_run(serving_zip, reqs, tokens)
    phase(16, f"SSE: the 8 requests streamed at once, every streamed token "
              f"list identical to the buffered one, {stream['tokens']} "
              f"tokens in {stream['wall_s']:.3f} s = "
              f"{stream['tokens_per_s']:.2f} tokens/s; a client that hung "
              f"up mid-stream: decode cancelled, slot and blocks freed in "
              f"{stream['freed_s']:.3f} s (free blocks "
              f"{stream['free_blocks']}, pins left {stream['pins_left']}) "
              f"[{card}]")

    # -- 17-18. the chaos drill and a draining restart, full width ----------
    chaos = chaos_run(ck, serving_zip, reqs, tokens)
    for f in chaos["faults"]:
        phase(17, f"{f['seam']} {f['spec']}: fired {f['fired']}, restarts "
                  f"{f['restarts']}, recovery {f['recovery_s']} s (the "
                  f"rebuilt engine's warmup {f['rebuilt_warmup_s']:.3f} s), wave "
                  f"{f['wall_s']:.3f} s, retries reported {f['retries']}, "
                  f"/readyz 503 x{f['readyz_503']} then "
                  f"{f['readyz_last']}; tokens identical to the no-fault "
                  f"run {f['identical']} [{card}]")
    phase(17, f"drill: {chaos['engines_built']} engines built (same device, "
              f"kernel and graph modes {chaos['modes']}), "
              f"engine_restarts_total {chaos['restarts_total']}, no "
              f"request lost or finished twice; paged launches "
              f"{chaos['launches']} = {BLOCKS} x {chaos['decode_steps']} "
              f"decode steps over every engine; memory_allocated "
              f"{chaos['memory_allocated_before']} B before the first fault,"
              f" {chaos['memory_allocated_after']} B after the last (one "
              f"engine's footprint {chaos['engine_footprint_bytes']} B); "
              f"{chaos['predict_posts']} /predict forwards ran through the "
              f"recoveries (max diff {chaos['predict_max_diff']}) [{card}]")
    d = chaos["drain"]
    phase(18, f"POST /admin/drain with {d['inflight_at_drain']} requests in "
              f"flight: {d['answer']}, none dropped, tokens identical "
              f"{d['identical']}, engine swapped {d['swapped']}, ready "
              f"again {d['ready_after']} after {d['wall_s']:.3f} s [{card}]")
    serving_dir.cleanup()

    # -- 19. /predict on AlexNet-CIFAR10 through the micro-batcher ----------
    pred = predict_run(ck, torch)
    phase(19, f"/predict on alexnet_cifar10 from a zip, {pred['posts']} "
              f"concurrent single-row posts: {pred['batches']} batches "
              f"(occupancy mean {pred['occupancy_mean']:.2f}), conv launches "
              f"{pred['launches']['conv2d_bias_act']} = 3 x "
              f"{pred['batches']}, max |diff| against the plain versions "
              f"{pred['max_abs_err']:.3e} (gate 1e-4); latency p50 / p99: "
              f"server {pred['server_latency_p50_ms']:.3f} / "
              f"{pred['server_latency_p99_ms']:.3f} ms, client "
              f"{pred['client_latency_p50_ms']:.3f} / "
              f"{pred['client_latency_p99_ms']:.3f} ms; {pred['wall_s']:.3f}"
              f" s [{card}]")

    # -- 20. the bf16 attention kernels against their plain versions --------
    # phases 20-21 gather their failures and stop after phase 21
    failures = []
    phase(20, "bf16 attention kernels: the forwards on the Hopper core "
              "attn_fwd_bf16.cuh (wgmma fed by TMA through an mbarrier ring, "
              "a producer and two consumer warpgroups in ping-pong), dK/dV "
              "on the Hopper core attn_dkv_bf16.cuh (wgmma, q and dO fed by "
              "TMA through an mbarrier ring, two warpgroups of 64 keys), dQ "
              "on the Hopper core attn_dq_bf16.cuh (wgmma, k and v fed by "
              "TMA through an mbarrier ring, two warpgroups of 64 query "
              "rows)")
    bf16_main = [dict(family="flash", B=32, L=256, H=8, D=64, causal=True),
                 dict(family="flash", B=1, L=8192, H=4, D=128, causal=True),
                 dict(family="flash", B=1, L=8192, H=4, D=128, causal=False),
                 dict(family="splash", B=1, L=32768, H=4, D=128, causal=True),
                 dict(family="splash", B=1, L=32768, H=8, D=128, causal=True)]
    # the masks' edges: odd L at every head dim (flash), the smallest
    # tables at every head dim (splash); values only
    bf16_edge = ([dict(family="flash", B=b, L=L, H=h, D=d, causal=c)
                  for d in (16, 32, 64, 128) for L in (7, 129, 300)
                  for b, h, c in ((3, 1, False), (1, 3, True))]
                 + [dict(family="splash", B=b, L=L, H=h, D=d, causal=c)
                    for L in (128, 256) for d in (16, 32, 64, 128)
                    for b, h, c in ((3, 1, False), (1, 3, True))])
    bf16_edges = []
    for i, c in enumerate(bf16_edge):
        r = bf16_case(ck, torch, flush, seed=850 + i, timed=False, **c)
        bf16_edges.append(r)
        if not (r["ok"] and r["repeat_bitwise"]
                and r["fwd_repeat_bitwise"]):
            failures.append(f"bf16 {r['family']} kernels disagree with the "
                            f"plain versions at the edge {r['shape']} "
                            f"causal={r['causal']}: {r}")
    phase(20, f"bf16 edge set, {len(bf16_edges)} cases (flash L = 7, 129, "
              f"300 and splash L = 128, 256 at D = 16-128; full "
              f"B*H = 3 and causal): worst max|diff|/max|plain| "
              f"{max(max(r['rel_err'].values()) for r in bf16_edges):.3e}, "
              f"mean {max(max(r['mean_rel_err'].values()) for r in bf16_edges):.3e}"
              f", lse abs {max(r['lse_abs_err'] for r in bf16_edges):.3e}; "
              f"all bitwise repeatable "
              f"{all(r['repeat_bitwise'] and r['fwd_repeat_bitwise'] for r in bf16_edges)}")
    bf16_cases = []
    for i, c in enumerate(bf16_main):
        r = bf16_case(ck, torch, flush, seed=800 + i, **c)
        bf16_cases.append(r)
        torch.cuda.empty_cache()
        e, m = r["rel_err"], r["mean_rel_err"]
        times = ", ".join(
            f"{n} {r[n + '_ms']:.4f} / {r[n + '_plain_ms']:.4f} / "
            f"{r[n + '_bound_ms']:.4f} ({r[n + '_bound_by']}; share "
            f"{r[n + '_bound_share']:.3f})" for n in ("fwd", "dkv", "dq"))
        phase(20, f"bf16 {r['family']} {r['shape']} "
                  f"{'causal' if r['causal'] else 'full'}: max|diff|/max|plain|"
                  f" o {e['o']:.3e} dq {e['dq']:.3e} dk {e['dk']:.3e} dv "
                  f"{e['dv']:.3e} (gate {BF16_MAX_REL:.3e}), mean "
                  f"{max(m.values()):.3e} (gate {BF16_MEAN_REL}), lse abs "
                  f"{r['lse_abs_err']:.3e} (gate {BF16_LSE_ABS}); bitwise "
                  f"repeatable: forward {r['fwd_repeat_bitwise']}, backward "
                  f"{r['repeat_bitwise']}; kernel / plain / bf16 "
                  f"bound ms: {times}; forward {r['fwd_tflops']:.1f} TFLOP/s "
                  f"(share {r['fwd_bound_share']:.3f}); dK/dV "
                  f"{r['dkv_tflops']:.1f} TFLOP/s; SDPA (bf16) fwd "
                  f"{r['sdpa_fwd_ms']:.4f} ms, fwd+bwd "
                  f"{r['sdpa_fwd_bwd_ms']:.4f} ms against the three kernels' "
                  f"{r['three_ms']:.4f} ms ({r['three_vs_sdpa']:.3f}x), its o "
                  f"vs plain {r['sdpa_rel_err']:.3e} [{card}]")
        if not (r["ok"] and r["fwd_repeat_bitwise"]):
            failures.append(f"bf16 {r['family']} kernels disagree with the "
                            f"plain versions at {r['shape']} "
                            f"causal={r['causal']}: {r}")
        if not r["sdpa_rel_err"] <= 2.0 ** -5:
            failures.append(f"the bf16 SDPA yardstick computes another "
                            f"function at {r['shape']}: {r['sdpa_rel_err']}")

    # -- 21. transformer_lm training in bf16 (params, and mixed precision) ---
    bf16_flash = tuple(f"{k}_bf16" for k in flash_keys)
    bf16_splash = tuple(f"{k}_bf16" for k in splash_keys)
    f32_rows = dict(lm, transformer_lm_32k=lc)
    lm16 = {}
    for key, ref, heads, T, Bn, steps, dtype, cdt, remat in (
            ("transformer_lm_bf16", "transformer_lm", HEADS, 256, 32, 20,
             "bfloat16", None, False),
            ("transformer_lm_long_bf16", "transformer_lm_long", 4, 8192, 1,
             10, "bfloat16", None, False),
            ("transformer_lm_long_mixed", "transformer_lm_long", 4, 8192, 1,
             10, "float32", "bfloat16", False),
            ("transformer_lm_32k_bf16", "transformer_lm_32k", 4, T32, 1,
             STEPS32, "bfloat16", None, True)):
        xt, yt = lm_batch(torch, T, Bn)
        torch.cuda.reset_peak_memory_stats()
        net, losses, secs, launches = lm_train_run(
            ck, torch, heads, xt, yt, steps, remat=remat, dtype=dtype,
            compute_dtype=cdt)
        want = dict.fromkeys(ck.LAUNCHES, 0)
        if remat:
            want.update({bf16_splash[0]: 2 * BLOCKS * steps,
                         bf16_splash[1]: BLOCKS * steps,
                         bf16_splash[2]: BLOCKS * steps})
        else:
            want.update(dict.fromkeys(bf16_flash, BLOCKS * steps))
        if launches != want:
            failures.append(f"{key} launches {launches}, want {want}")
        if not losses[-1] < losses[0]:
            failures.append(f"{key} loss did not fall: {losses}")
        f32_losses = f32_rows[ref]["losses"][:steps]
        curve = [abs(a - b) / max(1.0, abs(b))
                 for a, b in zip(losses, f32_losses)]
        if not max(curve) <= BF16_CURVE:
            failures.append(f"{key} left the f32 curve: {losses} vs "
                            f"{f32_losses}")
        pdt = {str(p.dtype) for lp in net.params.values()
               for p in lp.values()}
        sdt = {str(t.dtype) for lu in net.updater_state.values()
               for st in lu.values() for t in st.values()}
        odt = str(net.output(xt[:1])[0].dtype)
        want_dt = ({f"torch.{dtype}"}, {"torch.float32"}, "torch.bfloat16")
        if (pdt, sdt, odt) != want_dt:
            failures.append(f"{key} dtypes: params {pdt}, updater state "
                            f"{sdt}, output {odt}; want {want_dt}")
        steady = secs[1:]
        r = {"heads": heads, "T": T, "batch": Bn, "steps": steps,
             "dtype": dtype, "compute_dtype": cdt, "remat": remat,
             "losses": losses, "f32_losses": f32_losses,
             "curve_rel": curve, "step_s": secs,
             "first_step_ms": secs[0] * 1e3,
             "mean_step_ms": 1e3 * sum(steady) / len(steady),
             "tokens_per_s": Bn * T * len(steady) / sum(steady),
             "f32_mean_step_ms": f32_rows[ref]["mean_step_ms"],
             "f32_tokens_per_s": f32_rows[ref]["tokens_per_s"],
             "launches": launches, "params": net.num_params(),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        ours = bf16_splash if remat else bf16_flash
        phase(21, f"{key} ({r['params']} params, {dtype} params"
                  f"{', compute ' + cdt if cdt else ''}) {heads} heads T={T} "
                  f"B={Bn}{', remat' if remat else ''}, {steps} fit_batch "
                  f"steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}, all "
                  f"finite; vs the f32 row's curve max "
                  f"{max(curve):.3e} of max(1, |loss|) (gate {BF16_CURVE}); "
                  f"launches { {k: launches[k] for k in ours} }; steps "
                  f"2-{steps}: mean {r['mean_step_ms']:.3f} ms = "
                  f"{r['tokens_per_s']:.1f} tokens/s against f32 "
                  f"{r['f32_mean_step_ms']:.3f} ms = "
                  f"{r['f32_tokens_per_s']:.1f} (first step "
                  f"{r['first_step_ms']:.1f} ms), peak memory "
                  f"{r['peak_mem_bytes']} B [{card}]")
        r["profile"] = lm_profile(
            torch, net, xt, yt, 2 if remat else 5,
            keys=(("splash_fwd", "splash_bwd_dkv", "splash_bwd_dq") if remat
                  else ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")))
        pr = r["profile"]
        f32_busy = f32_rows[ref]["profile"]["device_busy_share"]
        phase(21, f"{key} under torch.profiler, {pr['steps']} more steps: "
                  f"wall {pr['wall_ms']:.3f} ms, device busy "
                  f"{pr['device_busy_ms']:.3f} ms "
                  f"({100 * pr['device_busy_share']:.2f}%; the f32 row "
                  f"{100 * f32_busy:.2f}%); the three kernels "
                  f"{pr['kernels_ms']}; top {pr['top_kernels_ms'][:5]} "
                  f"[{card}]")
        r["grad_loss_rel"], r["grad_leaves"] = bf16_grad_check(
            torch, net, xt, yt, heads, remat)
        gl = r["grad_leaves"]

        def worst(fn):
            return max(((n, fn(v)) for n, v in gl.items()),
                       key=lambda kv: kv[1])
        wg, wl = worst(lambda v: v["global"]), worst(lambda v: v["leaf"])
        wr = worst(lambda v: v["kernel_vs_f32"]
                   / max(v["plain_vs_f32"], 1e-30))
        phase(21, f"{key} gradients at step {steps + pr['steps']}'s params "
                  f"through the kernels and through their plain versions: "
                  f"loss rel diff {r['grad_loss_rel']:.3e} (gate "
                  f"{BF16_LOSS_REL}); worst leaf {wg[0]} max|diff| "
                  f"{wg[1]:.3e} of the largest plain gradient (gate "
                  f"{BF16_GRAD_REL}); over its own max, worst {wl[0]} "
                  f"{wl[1]:.3e} (kernel / plain distance from f32 there "
                  f"{gl[wl[0]]['kernel_vs_f32']:.3e} / "
                  f"{gl[wl[0]]['plain_vs_f32']:.3e}); the kernel path's "
                  f"distance from the f32 step over the plain path's, worst "
                  f"leaf {wr[0]} {wr[1]:.3f} (gate {BF16_VS_F32})")
        if not (r["grad_loss_rel"] <= BF16_LOSS_REL
                and wg[1] <= BF16_GRAD_REL and wr[1] <= BF16_VS_F32):
            failures.append(f"{key} kernel and plain gradients differ: "
                            f"{r['grad_loss_rel']} {wg} {wr}")
        lm16[key] = r
        del net, xt, yt
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit("phases 20-21 failed: " + " | ".join(failures))

    # -- 22. the bf16 CNN kernels against their plain versions ---------------
    # phases 22-23 gather their failures and stop after phase 23
    failures = []
    conv16_edge = [
        dict(B=3, H=13, W=11, C=8, K=5, OC=50, stride=(2, 2),
             padding="SAME", act="relu"),   # stride 2 SAME, OC off the tile
        dict(B=1, H=7, W=7, C=4, K=3, OC=33, stride=(2, 2), padding="SAME",
             act="tanh"),                   # smallest B, odd OC
        dict(B=2, H=9, W=10, C=3, K=3, OC=70, stride=(1, 2),
             padding=((2, 0), (1, 1)), act="sigmoid"),  # C = 3
        dict(B=2, H=9, W=9, C=20, K=5, OC=50, stride=(1, 1),
             padding="VALID", act="relu")]  # C = 20: 4-byte A copies
    # every activation of the epilogue, with its pre-activation output, at
    # C = 3 (scalar A copies) and C = 16 (16-byte copies)
    conv16_acts = [dict(B=2, H=6, W=5, C=c, K=3, OC=9, stride=(1, 1),
                        padding="SAME", act=a, want_pre=True)
                   for a in sorted(set(ck.ACT_CODES) - {"linear"})
                   for c in (3, 16)]
    # C a multiple of 8 but not of 64, OC of 8 (16-byte A chunks of one tap,
    # 64-deep K slices would cross taps): the mma.sync route
    conv16_c8 = [
        dict(B=3, H=13, W=11, C=8, K=5, OC=72, stride=(2, 2),
             padding="SAME", act="relu"),
        dict(B=2, H=9, W=7, C=24, K=3, OC=40, stride=(1, 1),
             padding="SAME", act="tanh"),
        dict(B=1, H=5, W=5, C=8, K=3, OC=16, stride=(1, 1),
             padding="SAME", act="identity"),
        dict(B=3, H=11, W=10, C=16, K=3, OC=136, stride=(1, 2),
             padding=((2, 0), (1, 1)), act="sigmoid"),
        dict(B=5, H=7, W=9, C=32, K=3, OC=256, stride=(1, 1),
             padding="VALID", act="relu")]
    # the wgmma route (C % 64 == 0, OC % 8 == 0): stride 2 SAME (asymmetric
    # pads at H = 12) with OC = 72, explicit asymmetric pads, M not a
    # multiple of 128, B = 1, OC past one 128-column tile, a 1 x 1 conv;
    # every activation with its pre-activation at C = 64, OC = 16
    conv16_wg_edge = [
        dict(B=3, H=13, W=11, C=64, K=5, OC=72, stride=(2, 2),
             padding="SAME", act="relu"),
        dict(B=3, H=12, W=11, C=64, K=3, OC=72, stride=(2, 2),
             padding="SAME", act="relu"),
        dict(B=2, H=9, W=7, C=64, K=3, OC=40, stride=(1, 1),
             padding="SAME", act="tanh"),
        dict(B=1, H=5, W=5, C=64, K=3, OC=16, stride=(1, 1),
             padding="SAME", act="identity"),
        dict(B=3, H=11, W=10, C=64, K=3, OC=136, stride=(1, 2),
             padding=((2, 0), (1, 1)), act="sigmoid"),
        dict(B=1, H=9, W=9, C=64, K=5, OC=64, stride=(2, 1),
             padding=((2, 1), (0, 3)), act="relu"),
        dict(B=5, H=7, W=9, C=128, K=3, OC=256, stride=(1, 1),
             padding="VALID", act="relu"),
        dict(B=3, H=7, W=7, C=64, K=3, OC=128, stride=(2, 2),
             padding="VALID", act="identity"),
        dict(B=2, H=12, W=10, C=128, K=3, OC=136, stride=(2, 2),
             padding="SAME", act="tanh"),
        dict(B=1, H=16, W=16, C=64, K=3, OC=128, stride=(1, 1),
             padding=same, act="relu"),
        dict(B=2, H=5, W=6, C=192, K=1, OC=40, stride=(1, 1),
             padding="VALID", act="relu"),
        dict(B=2, H=6, W=5, C=64, K=3, OC=16, stride=(1, 1),
             padding="SAME", act="gelu", want_pre=True)]
    conv16_wg_acts = [dict(B=2, H=6, W=5, C=64, K=3, OC=16, stride=(1, 1),
                           padding="SAME", act=a, want_pre=True)
                      for a in sorted(set(ck.ACT_CODES) - {"linear"})]
    conv16_cases, conv16_edges = [], []
    n_old = len(conv16_edge + conv16_acts + conv16_c8)
    for i, c in enumerate(conv16_edge + conv16_acts + conv16_c8
                          + conv16_wg_edge + conv16_wg_acts):
        r = conv_bf16_case(ck, torch, flush, seed=900 + i, timed=False, **c)
        conv16_edges.append(r)
        if r["route"] != ("wgmma" if i >= n_old else "mma_sync"):
            r["ok"] = False
        if not r["ok"]:
            failures.append(f"bf16 conv kernel disagrees with the plain "
                            f"version (or takes another route) at the edge "
                            f"{r['shape']} {r['activation']}: {r}")
    for name, part, what in (
            ("mma.sync route", conv16_edges[:n_old],
             "stride 2 SAME, OC 50/33/70/9/72/40/16/136/256, C = "
             "3/4/8/16/20/24/32, B = 1, every activation with its "
             "pre-activation"),
            ("wgmma route", conv16_edges[n_old:],
             "C = 64/128/192, stride 2 SAME, OC 72/40/16/136/64/256/128, "
             "asymmetric pads, M tails, B = 1, every activation with its "
             "pre-activation")):
        phase(22, f"bf16 conv2d_bias_act edge set, {name}, {len(part)} "
                  f"cases (routes {sorted({r['route'] for r in part})}; "
                  f"{what}): worst max|diff|/max|plain| "
                  f"{max(max(r['rel_err']) for r in part):.3e} (gate "
                  f"{BF16_MAX_REL:.3e}), mean "
                  f"{max(max(r['mean_rel_err']) for r in part):.3e} (gate "
                  f"{BF16_MEAN_REL}); all bitwise repeatable "
                  f"{all(r['repeat_bitwise'] for r in part)}")
    for i, c in enumerate(conv_main):
        r = conv_bf16_case(ck, torch, flush, seed=100 + i, timed=True, **c)
        conv16_cases.append(r)
        phase(22, f"bf16 conv2d_bias_act {r['shape']} stride {r['stride']} "
                  f"pads {r['pads']}, route {r['route']}, "
                  f"{r['tflops']:.1f} TFLOP/s: max|diff|/max|plain| "
                  f"{r['rel_err'][0]:.3e} (gate {BF16_MAX_REL:.3e}), mean "
                  f"{r['mean_rel_err'][0]:.3e} (gate {BF16_MEAN_REL}), "
                  f"bitwise repeatable {r['repeat_bitwise']}; kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bf16 "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; share "
                  f"{r['bound_share']:.3f}), F.conv2d (bf16) "
                  f"{r['library_ms']:.4f} ms (its output vs plain "
                  f"{r['library_rel_err']:.3e}) [{card}]")
        if not r["ok"]:
            failures.append(f"bf16 conv kernel disagrees with the plain "
                            f"version (or F.conv2d computes another "
                            f"function) at {r['shape']}: {r}")
    conv16_sum = {k: sum(c[k] for c in conv16_cases[:3])
                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    conv16_sum["bound_share"] = conv16_sum["bound_ms"] / conv16_sum["ms"]
    phase(22, f"bf16 conv2d_bias_act, AlexNet's three convs summed: kernel "
              f"{conv16_sum['ms']:.4f} ms (f32 kernel {conv_sum['ms']:.4f}), "
              f"F.conv2d (bf16) {conv16_sum['library_ms']:.4f} ms (kernel / "
              f"library {conv16_sum['ms'] / conv16_sum['library_ms']:.3f}); "
              f"bf16 bound {conv16_sum['bound_ms']:.4f} ms (share "
              f"{conv16_sum['bound_share']:.3f}) [{card}]")
    # the edges of the lane kernels' set, then those of the ring route
    # (bnap_common.cuh): B = 1 with H = 2; rows wider than a stage (16 and
    # 5 items a row, the latter tied); 455 pooled rows on 396 blocks; C = 8
    # and C = 1024 (a pooled column an item); a view 8 bytes off 16, which
    # takes the lane kernels
    bnap16_edge = [dict(B=2, H=4, W=4, C=8, act="relu", tied=True),
                   dict(B=1, H=4, W=4, C=8, act="sigmoid", tied=False),
                   dict(B=3, H=6, W=10, C=40, act="tanh", tied=False),
                   dict(B=4, H=8, W=6, C=16, act="identity", tied=True),
                   dict(B=3, H=6, W=10, C=6, act="relu", tied=False),
                   dict(B=1, H=2, W=16, C=64, act="relu", tied=False),
                   dict(B=2, H=4, W=64, C=512, act="tanh", tied=False),
                   dict(B=3, H=4, W=40, C=256, act="relu", tied=True),
                   dict(B=7, H=130, W=8, C=16, act="relu", tied=False),
                   dict(B=3, H=6, W=10, C=8, act="sigmoid", tied=False),
                   dict(B=2, H=4, W=6, C=1024, act="identity", tied=False),
                   dict(B=2, H=6, W=8, C=16, act="tanh", tied=False,
                        misaligned=True)]
    bnap16_cases, bnap16_edges = [], []
    for i, c in enumerate(bnap16_edge):
        r = bnap_bf16_case(ck, torch, flush, seed=950 + i, timed=False, **c)
        bnap16_edges.append(r)
        phase(22, f"bf16 bnap edge {r['shape']} {r['activation']}"
                  f"{' tied' if r['tied'] else ''}"
                  f"{' misaligned' if r['misaligned'] else ''} (route "
                  f"{r['route']}): windows tied after the "
                  f"rounding {r['tie_share']:.3f} (4-way "
                  f"{r['tie4_share']:.3f}); sums max|diff| "
                  f"{r['sums_max_abs_err']:.3e} of max|plain| "
                  f"{r['sums_max_abs_plain']:.3e} (gate 1e-4 of it), bitwise "
                  f"repeatable {r['sums_repeat_bitwise']}; dx max|diff|/max|"
                  f"plain| {r['dx_rel_err']:.3e}, mean "
                  f"{r['dx_mean_rel_err']:.3e}, bitwise {r['dx_bitwise']}"
                  f"{' (gate: bitwise)' if r['tied'] else ''}")
        if not r["ok"]:
            failures.append(f"bf16 BN+act+pool backward kernels disagree "
                            f"with the plain versions at the edge "
                            f"{r['shape']}: {r}")
    for i, c in enumerate(bnap_main):
        r = bnap_bf16_case(ck, torch, flush, seed=200 + i, timed=True, **c)
        bnap16_cases.append(r)
        phase(22, f"bf16 bnap {r['shape']} {r['activation']} (route "
                  f"{r['route']}): sums "
                  f"max|diff| {r['sums_max_abs_err']:.3e} (gate "
                  f"{1e-4 * r['sums_max_abs_plain']:.3e}), bitwise repeatable "
                  f"{r['sums_repeat_bitwise']}; dx max|diff|/max|plain| "
                  f"{r['dx_rel_err']:.3e} (gate {BF16_MAX_REL:.3e}), mean "
                  f"{r['dx_mean_rel_err']:.3e}; sums {r['sums_ms']:.4f} ms "
                  f"(plain {r['sums_plain_ms']:.4f}, bf16 bound "
                  f"{r['sums_bound_ms']:.4f} {r['sums_bound_by']}, share "
                  f"{r['sums_bound_share']:.3f}), dx {r['dx_ms']:.4f} ms "
                  f"(plain {r['dx_plain_ms']:.4f}, bound "
                  f"{r['dx_bound_ms']:.4f} {r['dx_bound_by']}, share "
                  f"{r['dx_bound_share']:.3f}); library call: none [{card}]")
        if not r["ok"] or r["route"] != "ring":
            failures.append(f"bf16 BN+act+pool backward kernels disagree "
                            f"with the plain versions, or leave the ring "
                            f"route, at {r['shape']}: {r}")
    bnap16_sum = {k: sum(c[k] for c in bnap16_cases)
                  for k in ("sums_ms", "sums_bound_ms", "dx_ms",
                            "dx_bound_ms")}
    # the card's streaming rate as a yardstick: x.clone() of the first
    # layer's bf16 x (x read once and written once), timed as the kernels
    xc = torch.randn((512, 32, 32, 64), device="cuda").to(torch.bfloat16)
    bnap16_sum["clone_ms"] = time_ms(lambda: xc.clone(), flush=flush)
    bnap16_sum["clone_bound_ms"] = bound(2 * 2 * xc.numel(), 0)[0]
    del xc
    phase(22, f"bf16 bnap, AlexNet's three layers summed: sums "
              f"{bnap16_sum['sums_ms']:.4f} ms (f32 {bnap_sum['sums_ms']:.4f})"
              f", bound {bnap16_sum['sums_bound_ms']:.4f} ms (share "
              f"{bnap16_sum['sums_bound_ms'] / bnap16_sum['sums_ms']:.3f}); "
              f"dx {bnap16_sum['dx_ms']:.4f} ms (f32 {bnap_sum['dx_ms']:.4f}),"
              f" bound {bnap16_sum['dx_bound_ms']:.4f} ms (share "
              f"{bnap16_sum['dx_bound_ms'] / bnap16_sum['dx_ms']:.3f}); "
              f"yardstick x.clone() of [512, 32, 32, 64] bf16 "
              f"{bnap16_sum['clone_ms']:.4f} ms, bound "
              f"{bnap16_sum['clone_bound_ms']:.4f} ms (share "
              f"{bnap16_sum['clone_bound_ms'] / bnap16_sum['clone_ms']:.3f}) "
              f"[{card}]")

    # -- 23. AlexNet-CIFAR10 and LeNet-MNIST training in bf16 ---------------
    cnn16_keys = ("conv2d_bias_act_bf16", "bnap_sums_bf16", "bnap_dx_bf16")
    alex16 = {}
    for key, dtype, cdt in (("alexnet_bf16", "bfloat16", None),
                            ("alexnet_mixed", "float32", "bfloat16")):
        aconf = alexnet_cifar10(dtype=dtype)
        aconf.conf.compute_dtype = cdt
        torch.cuda.reset_peak_memory_stats()
        net, losses16, secs16, launches16 = train_run(ck, torch, aconf, xa,
                                                      ya, STEPS)
        routes16 = dict(ck.BNAP_BF16_ROUTES)  # of these steps' launches
        want = dict.fromkeys(ck.LAUNCHES, 0)
        want.update(dict.fromkeys(cnn16_keys, 3 * STEPS))
        if launches16 != want:
            failures.append(f"{key} launches {launches16}, want {want}")
        if routes16 != {"ring": 2 * 3 * STEPS, "lanes": 0}:
            failures.append(f"{key} bf16 BN+act+pool launches by route "
                            f"{routes16}, want all on the ring route")
        if not losses16[-1] < losses16[0]:
            failures.append(f"{key} loss did not fall: {losses16}")
        f32_losses = train["losses"]  # phase 6's run, same seeds and data
        curve = [abs(a - b) / max(1.0, abs(b))
                 for a, b in zip(losses16, f32_losses)]
        if not max(curve) <= BF16_CURVE:
            failures.append(f"{key} left the f32 curve: {losses16} vs "
                            f"{f32_losses}")
        pdt = {str(p.dtype) for lp in net.params for p in lp.values()}
        vdt = {str(v.dtype) for lv in net.variables for v in lv.values()}
        sdt = {str(t.dtype) for lu in net.updater_state
               for st in lu.values() for t in st.values()}
        odt = str(net.output(xa[:2]).dtype)
        want_dt = ({f"torch.{dtype}"}, {f"torch.{dtype}"},
                   {"torch.float32"}, "torch.bfloat16")
        if (pdt, vdt, sdt, odt) != want_dt:
            failures.append(f"{key} dtypes: params {pdt}, variables {vdt}, "
                            f"updater state {sdt}, output {odt}; want "
                            f"{want_dt}")
        steady = secs16[1:]
        r = {"dtype": dtype, "compute_dtype": cdt, "batch": B,
             "steps": STEPS, "losses": losses16, "f32_losses": f32_losses,
             "curve_rel": curve, "step_s": secs16,
             "first_step_ms": secs16[0] * 1e3,
             "mean_step_ms": 1e3 * sum(steady) / len(steady),
             "examples_per_s": B * len(steady) / sum(steady),
             "f32_mean_step_ms": train["mean_step_ms"],
             "f32_examples_per_s": train["examples_per_s"],
             "launches": launches16, "bnap_routes": routes16,
             "params": net.num_params(),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        phase(23, f"{key} ({r['params']} params, {dtype} params"
                  f"{', compute ' + cdt if cdt else ''}) B={B}, {STEPS} "
                  f"fit_batch steps: loss {losses16[0]:.6f} -> "
                  f"{losses16[-1]:.6f}, all finite; vs phase 6's f32 curve "
                  f"max {max(curve):.3e} of max(1, |loss|) (gate "
                  f"{BF16_CURVE}); launches "
                  f"{ {k: launches16[k] for k in cnn16_keys} } (BN+act+pool "
                  f"by route {routes16}); steps "
                  f"2-{STEPS}: mean {r['mean_step_ms']:.3f} ms = "
                  f"{r['examples_per_s']:.1f} examples/s against f32 "
                  f"{r['f32_mean_step_ms']:.3f} ms = "
                  f"{r['f32_examples_per_s']:.1f} (first step "
                  f"{r['first_step_ms']:.1f} ms), peak memory "
                  f"{r['peak_mem_bytes']} B [{card}]")
        r["profile"] = pr = train_profile(torch, net, xa, ya, 5)
        phase(23, f"{key} under torch.profiler, 5 more steps: wall "
                  f"{pr['wall_ms']:.3f} ms, device busy "
                  f"{pr['device_busy_ms']:.3f} ms "
                  f"({100 * pr['device_busy_share']:.2f}%; phase 6's f32 "
                  f"{100 * tprof['device_busy_share']:.2f}%); the three "
                  f"kernels {pr['kernels_ms']}; top "
                  f"{pr['top_kernels_ms'][:5]} [{card}]")
        r["grad_loss_rel"], r["grad_leaves"] = cnn_bf16_grad_check(
            torch, net, xa, ya)
        gl = r["grad_leaves"]
        wg = max(((n, v["global"]) for n, v in gl.items()),
                 key=lambda kv: kv[1])
        wr = max(((n, v["kernel_vs_f32"] / max(v["plain_vs_f32"], 1e-30))
                  for n, v in gl.items()), key=lambda kv: kv[1])
        phase(23, f"{key} gradients at step {STEPS + 5}'s params, same "
                  f"dropout masks, through the kernels and through their "
                  f"plain versions: loss rel diff {r['grad_loss_rel']:.3e} "
                  f"(gate {BF16_LOSS_REL}); worst leaf {wg[0]} max|diff| "
                  f"{wg[1]:.3e} of the largest plain gradient (gate "
                  f"{BF16_GRAD_REL}); the kernel path's distance from the "
                  f"f32 step over the plain path's, worst leaf {wr[0]} "
                  f"{wr[1]:.3f} (gate {BF16_VS_F32}; there "
                  f"{gl[wr[0]]['kernel_vs_f32']:.3e} / "
                  f"{gl[wr[0]]['plain_vs_f32']:.3e})")
        if not (r["grad_loss_rel"] <= BF16_LOSS_REL
                and wg[1] <= BF16_GRAD_REL and wr[1] <= BF16_VS_F32):
            failures.append(f"{key} kernel and plain gradients differ: "
                            f"{r['grad_loss_rel']} {wg} {wr}")
        alex16[key] = r
        del net
        torch.cuda.empty_cache()
    _, lenet16_losses, lenet16_secs, lenet16_launches = train_run(
        ck, torch, lenet_mnist(dtype="bfloat16"), xl, ya, 5)
    if lenet16_launches != {**dict.fromkeys(ck.LAUNCHES, 0),
                            "conv2d_bias_act_bf16": 5}:
        failures.append(f"LeNet bf16 launches {lenet16_launches}, want 1 "
                        f"bf16 conv per step")
    lenet16 = {"losses": lenet16_losses, "step_s": lenet16_secs,
               "launches": lenet16_launches,
               "mean_step_ms": 1e3 * sum(lenet16_secs[1:]) / 4}
    phase(23, f"LeNet-MNIST bf16 B={B}, 5 steps: losses {lenet16_losses}, "
              f"launches { {k: v for k, v in lenet16_launches.items() if v} }"
              f"; steps 2-5 mean {lenet16['mean_step_ms']:.3f} ms (f32 "
              f"{lenet['mean_step_ms']:.3f}) [{card}]")
    if failures:
        raise SystemExit("phases 22-23 failed: " + " | ".join(failures))
    a3 = a3_phases(torch, ck, card)
    p26 = phase26(torch, ck, card, reqs, tokens, tokens8)
    p27 = phase27(torch, ck, card, reqs, tokens, tokens8, p26, e2e)
    p28 = phase28(torch, ck, card)
    p29 = phase29(torch, ck, card)
    p30 = phase30(torch, ck, card)
    p31 = phase31(torch, ck, card)
    p32 = phase32(torch, ck, card)
    p33 = phase33(torch, ck, card)


    src = "deeplearning4j_tpu_torch/ops/csrc/paged_decode_attention.cu"
    kernels = []
    for name, key, run, replaces in (
            ("paged_decode_attention", "mha_fp32", e2e,
             "deeplearning4j_tpu/ops/pallas_kernels.py:850"),
            ("paged_decode_attention_int8", "mha_int8", e2e8,
             "deeplearning4j_tpu/ops/pallas_kernels.py:857")):
        c = cases[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": run["launches"],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": None,
                        # phase 26: the admit-all wave, every decode step
                        # the grammar-masked graph
                        "masked_launches": p26[
                            "grammar_" + key.split("_")[1]]["admit_all"][
                                "launches"],
                        # phase 27a: the plain steps of a speculating
                        # engine (the verify and the draft launch none)
                        "speculating_launches": p27[
                            "paged_" + key.split("_")[1]]["launches"],
                        # phase 28a/b: wave C's decode steps, over pages
                        # promoted from the host tier
                        "tiered_launches": p28[
                            key.split("_")[1]]["wave_c"]["launches"]})
    # phase 31: the tp = 2 waves' launches on each rank, and the kernel at
    # a rank's shard shapes (H/2, Hkv/2; GQA's one kv head)
    for row, tag, shards in ((kernels[0], "a", ("H4_Hkv4_fp32",
                                                "H4_Hkv1_fp32")),
                             (kernels[1], "b_int8", ("H4_Hkv4_int8",))):
        row["tp_launches_per_rank"] = p31[tag]["tp2"]["launches"]
        row["shard_cases"] = {k: {f: p31["kernel_cases"][k][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
            for k in shards}
    kernels[0]["gqa_tp_launches_per_rank"] = p31["b_gqa"]["tp2"]["launches"]
    # phase 32a: the plain steps of a speculating tp = 2 engine; 32b: wave
    # C's steps at tp = 2 over pages promoted from the host tier
    kernels[0]["tp_speculating_launches_per_rank"] = p32["a_paged"][
        "launches"]
    for row, key in ((kernels[0], "b_fp32"), (kernels[1], "b_int8")):
        row["tp_tiered_launches_per_rank"] = p32[key]["wave_c_launches"]
    # phase 27e: the int8 graph clone's decode steps, fp32 pages
    kernels[0]["int8_graph_launches"] = sum(
        p27["int8"][f"speculate_{g}"]["launches"] for g in (0, SPEC_CRASH_G))
    # the training kernels: per AlexNet train step, summed over its three
    # launches (conv1-3, or BN1-3); max |diff| over the main-path shapes
    csrc = "deeplearning4j_tpu_torch/ops/csrc"
    alex_conv, alex_bnap = conv_cases[:3], bnap_cases[:3]

    def by(cases, key):
        ops = sum(c[key + "bound_ms"] for c in cases
                  if c[key + "bound_by"] == "operations")
        return "operations" if ops > sum(c[key + "bound_ms"]
                                         for c in cases) / 2 else "bytes"
    kernels.append({
        "name": "conv2d_bias_act", "route": "cuda",
        "source": f"{csrc}/conv2d_bias_act.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:92",
        "launches": alex_launches["conv2d_bias_act"],
        # phase 30a: launches of each captured step of the AlexNet graph
        "graph_launches_per_step": p30["alexnet_graph"][
            "conv_launches_per_step"],
        "max_abs_err": max(c["max_abs_err"] for c in conv_cases[:4]),
        "ms": sum(c["ms"] for c in alex_conv),
        "plain_ms": sum(c["plain_ms"] for c in alex_conv),
        "bound_ms": sum(c["bound_ms"] for c in alex_conv),
        "bound_by": by(alex_conv, ""),
        "library_ms": sum(c["library_ms"] for c in alex_conv),
        "tc_bound_ms": conv_sum["tc_bound_ms"],
        "tc_bound_share": conv_sum["tc_bound_share"],
        # phase 31e: each ICI rank's launches over its steps
        "dp_launches_per_rank": [r["conv2d_bias_act"] for r in p31["e"][
            "launches_per_rank"]],
        # phase 32c: the same under the state tracker's run
        "ft_launches_per_rank": [r["conv2d_bias_act"] for r in p32["c"][
            "launches_per_rank"]]})
    for name, line in (("bnap_sums", 286), ("bnap_dx", 301)):
        k = "sums_" if name == "bnap_sums" else "dx_"
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
            "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:{line}",
            "launches": alex_launches[name],
            "max_abs_err": max(c[k + "max_abs_err"] for c in alex_bnap),
            "ms": sum(c[k + "ms"] for c in alex_bnap),
            "plain_ms": sum(c[k + "plain_ms"] for c in alex_bnap),
            "bound_ms": sum(c[k + "bound_ms"] for c in alex_bnap),
            "bound_by": by(alex_bnap, k), "library_ms": None,
            "dp_launches_per_rank": [r[name] for r in p31["e"][
                "launches_per_rank"]],
            "ft_launches_per_rank": [r[name] for r in p32["c"][
                "launches_per_rank"]]})
    # the flash kernels: per transformer_lm_long (T=8192) train step, four
    # launches at [1, 8192, 4, 128]; launches from both LM runs; max |diff|
    # over the two main-path shapes
    long_case = flash_cases[1]
    for name, key, err_key, src_name, lib_line in (
            ("flash_attention_fwd", "fwd", "o", "flash_attention_fwd.cu",
             "758 _flash_attention_impl"),
            ("flash_attention_bwd_dkv", "dkv", "dkv", "flash_attention_bwd.cu",
             "1121 _flash_attention_bwd_dkv"),
            ("flash_attention_bwd_dq", "dq", "dq", "flash_attention_bwd.cu",
             "1456 _flash_attention_bwd_dq")):
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src_name}",
            "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:589 "
                        "(_flash_call -> jax/experimental/pallas/ops/tpu/"
                        f"flash_attention.py:{lib_line}, JAX 0.9.0)",
            "launches": sum(r["launches"][name] for r in lm.values()),
            "max_abs_err": max(c["max_abs_err"][err_key]
                               for c in flash_cases[:2]),
            "ms": BLOCKS * long_case[key + "_ms"],
            "plain_ms": BLOCKS * long_case[key + "_plain_ms"],
            "bound_ms": BLOCKS * long_case[key + "_bound_ms"],
            "bound_by": long_case[key + "_bound_by"],
            "library_ms": (BLOCKS * long_case["sdpa_fwd_ms"] if key == "fwd"
                           else None)})
        kernels[-1]["tc_bound_ms"] = BLOCKS * long_case[key + "_tc_bound_ms"]
        kernels[-1]["tc_bound_share"] = long_case[key + "_tc_bound_share"]
        # phase 33a: each tp = 2 rank's launches over its training steps;
        # 33b: the kernel at the shard shape; 33e: each Ulysses rank's
        kernels[-1]["tp_train_launches_per_rank"] = [
            r[name] for r in p33["a"]["launches_per_rank"]]
        kernels[-1]["shard_case"] = {
            "shape": p33["b"]["shape"],
            "max_abs_err": p33["b"]["max_abs_err"][err_key],
            "ms": p33["b"][key + "_ms"],
            "plain_ms": p33["b"][key + "_plain_ms"],
            "bound_ms": p33["b"][key + "_bound_ms"],
            "bound_by": p33["b"][key + "_bound_by"],
            "library_ms": (p33["b"]["sdpa_fwd_ms"] if key == "fwd"
                           else None)}
        if key == "fwd":
            kernels[-1]["ulysses_launches_per_rank"] = p33["e"]["ulysses"][
                "flash_fwd_launches_per_rank"]
    # the splash kernels: per transformer_lm_32k train step at [1, 32768,
    # 4, 128] (8 forward launches under remat, 4 dK/dV, 4 dQ); launches of
    # the whole 32k run; max |diff| over the two L = 32768 shapes
    path_case = splash_cases[0]
    per_step = {"fwd": 2 * BLOCKS, "dkv": BLOCKS, "dq": BLOCKS}
    for name, key, err_key, src_name, lib_line in (
            ("splash_attention_fwd", "fwd", "o", "splash_attention_fwd.cu",
             "1137"),
            ("splash_attention_bwd_dkv", "dkv", "dkv",
             "splash_attention_bwd.cu", "2196"),
            ("splash_attention_bwd_dq", "dq", "dq", "splash_attention_bwd.cu",
             "1635")):
        n = per_step[key]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src_name}",
            "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:609 "
                        "(_splash_call -> jax/experimental/pallas/ops/tpu/"
                        "splash_attention/splash_attention_kernel.py:"
                        f"{lib_line}, JAX 0.9.0)",
            "launches": lc["launches"][name],
            "max_abs_err": max(c["max_abs_err"][err_key]
                               for c in splash_cases[:2]),
            "ms": n * path_case[key + "_ms"],
            "plain_ms": n * path_case[key + "_plain_ms"],
            "bound_ms": n * path_case[key + "_bound_ms"],
            "bound_by": path_case[key + "_bound_by"],
            "library_ms": (n * path_case["sdpa_fwd_ms"] if key == "fwd"
                           else None)})
        kernels[-1]["tc_bound_ms"] = n * path_case[key + "_tc_bound_ms"]
        kernels[-1]["tc_bound_share"] = path_case[key + "_tc_bound_share"]
    # the bf16 kernels: per bf16 LM step as the f32 rows (flash at [1, 8192,
    # 4, 128] causal, four launches; splash at [1, 32768, 4, 128], 8 + 4 +
    # 4 under remat); launches of the phase-21 runs; max |diff| over the
    # family's phase-20 shapes
    flash16 = [c for c in bf16_cases if c["family"] == "flash"]
    splash16 = [c for c in bf16_cases if c["family"] == "splash"]
    for fam, cases16, case, per, lines in (
            ("flash", flash16, flash16[1],
             {"fwd": BLOCKS, "dkv": BLOCKS, "dq": BLOCKS},
             ("589 (_flash_call -> jax/experimental/pallas/ops/tpu/"
              "flash_attention.py:", ("758", "1121", "1456"))),
            ("splash", splash16, splash16[0], per_step,
             ("609 (_splash_call -> jax/experimental/pallas/ops/tpu/"
              "splash_attention/splash_attention_kernel.py:",
              ("1137", "2196", "1635")))):
        for key, err_key, src_name, lib_line in zip(
                ("fwd", "dkv", "dq"), ("o", "dkv", "dq"),
                (f"{fam}_attention_fwd.cu", f"{fam}_attention_bwd.cu",
                 f"{fam}_attention_bwd.cu"), lines[1]):
            name = f"{fam}_attention_{'fwd' if key == 'fwd' else 'bwd_' + key}"
            n = per[key]
            kernels.append({
                "name": name + "_bf16", "route": "cuda",
                "source": f"{csrc}/{src_name}",
                "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:"
                            f"{lines[0]}{lib_line}, JAX 0.9.0, at bf16)",
                "launches": sum(r["launches"][name + "_bf16"]
                                for r in lm16.values()),
                "max_abs_err": max(c["max_abs_err"][err_key]
                                   for c in cases16),
                "ms": n * case[key + "_ms"],
                "plain_ms": n * case[key + "_plain_ms"],
                "bound_ms": n * case[key + "_bound_ms"],
                "bound_by": case[key + "_bound_by"],
                "library_ms": (n * case["sdpa_fwd_ms"] if key == "fwd"
                               else None),
                "bound_share": case[key + "_bound_share"]})
            if key in ("fwd", "dkv"):
                kernels[-1].update(
                    core=f"{csrc}/attn_{key}_bf16.cuh (wgmma fed by TMA "
                         "through an mbarrier ring, "
                         + ("warp-specialised warpgroups)" if key == "fwd"
                            else "two warpgroups of 64 keys)"),
                    tflops=case[key + "_tflops"])
    # the bf16 CNN kernels: per bf16 AlexNet step as the f32 rows (summed
    # over its three launches); launches of phase 23's runs (both AlexNet
    # runs, and LeNet's conv); max |diff| over the main-path shapes
    for name, line, k, cases16 in (
            ("conv2d_bias_act", 92, "", conv16_cases[:3]),
            ("bnap_sums", 286, "sums_", bnap16_cases),
            ("bnap_dx", 301, "dx_", bnap16_cases)):
        key = name + "_bf16"
        src_name = "conv2d_bias_act.cu (conv_bf16.cuh)" if k == "" \
            else f"{name}.cu"
        err = (max(c["max_abs_err"] for c in conv16_cases) if k == ""
               else max(c[("sums_max_abs_err" if k == "sums_"
                           else "dx_max_abs_err")] for c in cases16))
        kernels.append({
            "name": key, "route": "cuda", "source": f"{csrc}/{src_name}",
            **({"conv_routes": [c["route"] for c in cases16]} if k == ""
               else {"bnap_routes": [c["route"] for c in cases16]}),
            "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:{line} "
                        "(at bf16)",
            "launches": (sum(r["launches"][key] for r in alex16.values())
                         + lenet16_launches[key]),
            "max_abs_err": err,
            "ms": sum(c[k + "ms"] for c in cases16),
            "plain_ms": sum(c[k + "plain_ms"] for c in cases16),
            "bound_ms": sum(c[k + "bound_ms"] for c in cases16),
            "bound_by": by(cases16, k),
            "library_ms": (sum(c["library_ms"] for c in cases16) if k == ""
                           else None)})
        kernels[-1]["bound_share"] = kernels[-1]["bound_ms"] / kernels[-1][
            "ms"]
    print("[details] " + json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": ptxas, "attn_build": attn_build,
         "paged_build": paged_build, "bnap_sums_build": bnap_build,
         "conv_build": conv_build, "conv_alexnet_sum": conv_sum,
         "bnap_alexnet_sum": bnap_sum,
         "cases": cases, "e2e_fp32": e2e,
         "e2e_int8": e2e8, "profile": prof, "conv_cases": conv_cases,
         "conv_activation_rel_errs": act_errs, "conv_seam": seam_cases,
         "bnap_cases": bnap_cases, "alexnet_train": train,
         "alexnet_profile": tprof, "lenet_train": lenet,
         "flash_cases": flash_cases, "attention_seam": seam,
         "lm_train": lm, "splash_cases": splash_cases,
         "splash_min_len_timings": route,
         "lm_train_32k": lc, "kv_cache_generation": gen,
         "prefix_serving": prefix, "contiguous_serving": cont,
         "guarded_serving": guarded, "streaming": stream, "chaos": chaos,
         "predict_alexnet": pred, "attn_bf16_build": attn_bf16_build,
         "fwd16_roles": fwd16_roles, "fwd16_ptxas": fwd16_spills,
         "fwd16_serialised_warnings": fwd16_serialised,
         "dkv16_roles": dkv16_roles, "dkv16_ptxas": dkv16_spills,
         "dkv16_serialised_warnings": dkv16_serialised,
         "dq16_roles": dq16_roles, "dq16_ptxas": dq16_spills,
         "dq16_serialised_warnings": dq16_serialised,
         "bf16_cases": bf16_cases, "bf16_edges": bf16_edges,
         "lm_train_bf16": lm16, "cnn_bf16_build": cnn16_build,
         "bnap_bf16_ring_build": bnap16_ring,
         "bnap_bf16_ring_ptxas": bnap16_ring_ptxas,
         "conv_bf16_cases": conv16_cases, "conv_bf16_edges": conv16_edges,
         "conv_bf16_wgmma_roles": conv16_roles,
         "conv_bf16_wgmma_ptxas": conv16_spills,
         "conv_bf16_wgmma_serialised_warnings": conv16_serialised,
         "conv_bf16_routes": conv16_routes,
         "conv_bf16_alexnet_sum": conv16_sum, "bnap_bf16_cases": bnap16_cases,
         "bnap_bf16_edges": bnap16_edges, "bnap_bf16_alexnet_sum": bnap16_sum,
         "alexnet_train_bf16": alex16, "lenet_train_bf16": lenet16,
         **a3, "serving_26": p26, "serving_27": p27, "tiering_28": p28,
         "training_29": p29, "graphs_30": p30, "parallel_31": p31,
         "tp_spec_tiers_ft_32": p32, "tp_training_33": p33,
         "elapsed_s": time.monotonic() - t_start}))
    phase(34, "kernels:")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
