"""On-card smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc; exits
non-zero without them, or when any phase fails. Phases:

  0. the card's name and power limit, torch and CUDA versions;
  1. builds every kernel source under deeplearning4j_tpu_torch/ops/csrc
     (one nvcc per source, all started together);
  2. holds the paged-decode kernel against its plain PyTorch version on
     the card at the serving shapes (fp32 and int8 pages, MHA and GQA):
     max |diff| < 1e-4; times both with CUDA events (median of 25; before
     each call the L2 is flushed and the device spins for about 5 ms, so
     the host has queued the call when the first event runs, and the
     events hold device time, not the host's launch path) beside the
     least time the card could take (live K/V bytes at 3.35 TB/s, or f32
     flops at 67 TFLOP/s);
     and again at the loop bound's edge depths (0, either side of a page
     boundary, full depth, the overflow sentinel 1 << 30);
  3. serves the flagship transformer LM (vocab 128, d_model 512, 8 heads,
     4 blocks, RoPE, f32, random weights from a seed) through the port's
     InferenceServer: after one short warm-up request, 8 concurrent POST
     /generate (prompts of 100-700
     tokens, 32 new tokens, half greedy, half seeded sampling); tokens
     must equal the port's solo generate_transformer on the card, and the
     kernel's launch count must equal 4 layers x the decode steps taken;
  4. the same with int8 KV pages, held against a paged_kernel="off" int8
     engine on the card (the layer's gather body); then a breakdown of
     the fp32 serving run under torch.profiler (the device's busy share,
     the top kernels);
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
     dx <= 1e-5. Times (as in phase 2) beside the bound and,
     for conv, beside F.conv2d on channels-last with bias and the
     activation (TF32 off);
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
     plain within 1e-5 and 1e-2 (the conv's rounding can flip a few
     near-tied maxima and relu signs). Then the
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
  8. prints the kernels line.

The last line is {"ok": true, "device": {...}}. Every number printed is
measured in this run; a "[details]" JSON line before the kernels line
holds them all, unrounded.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
SPIN_CYCLES = 10_000_000   # about 5 ms at the H100's 1.98 GHz boost clock

VOCAB, D_MODEL, HEADS, BLOCKS = 128, 512, 8, 4
KV_BLOCK, SLOTS, CHUNK, NEW_TOKENS = 16, 8, 64, 32
# f32 K+V of 4 layers x 8 heads x 64 dims = 256 KiB per 16-position
# block; 516 blocks = 515 usable (8 x 1024 positions fit) + scratch
KV_POOL_MB = 129


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


def kernel_case(ck, torch, *, H, Hkv, quantized, seed):
    """Serving shape: B=8 slots, Dh=64, block 16, table bucket nb=64,
    random per-row depths up to 1023 over a permuted table."""
    from deeplearning4j_tpu_torch.ops.kvquant import quantize_kv_rows
    B, Dh, block, nb = SLOTS, D_MODEL // HEADS, KV_BLOCK, 64
    g = torch.Generator().manual_seed(seed)
    P = B * nb + 1
    kp = torch.randn((P, block, Hkv, Dh), generator=g)
    vp = torch.randn((P, block, Hkv, Dh), generator=g)
    table = (1 + torch.randperm(B * nb, generator=g)).reshape(B, nb).int()
    pos = torch.randint(0, nb * block, (B,), generator=g).int()
    q = torch.randn((B, 1, H, Dh), generator=g)
    dev = torch.device("cuda")
    kw = {}
    if quantized:
        kp, ks = quantize_kv_rows(kp)
        vp, vs = quantize_kv_rows(vp)
        kw = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    args = [t.to(dev) for t in (q, kp, vp, table, pos)]
    got = ck.paged_decode_attention(*args, **kw)
    want = ck.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_positions": live}


def edge_case(ck, torch, *, H, Hkv, quantized):
    """The kernel's loop bound on the card: rows at depth 0, either side
    of a page boundary (15, 16), full depth, and one at the overflow
    sentinel 1 << 30, which must walk no further than the table's nb
    pages. Returns max |kernel - plain| over all rows."""
    from deeplearning4j_tpu_torch.ops.kvquant import quantize_kv_rows
    B, Dh, block, nb = 5, D_MODEL // HEADS, KV_BLOCK, 4
    g = torch.Generator().manual_seed(11)
    P = B * nb + 1
    kp = torch.randn((P, block, Hkv, Dh), generator=g)
    vp = torch.randn((P, block, Hkv, Dh), generator=g)
    table = (1 + torch.randperm(B * nb, generator=g)).reshape(B, nb).int()
    pos = torch.tensor([0, block - 1, block, nb * block - 1, 1 << 30],
                       dtype=torch.int32)
    q = torch.randn((B, 1, H, Dh), generator=g)
    dev = torch.device("cuda")
    kw = {}
    if quantized:
        kp, ks = quantize_kv_rows(kp)
        vp, vs = quantize_kv_rows(vp)
        kw = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    args = [t.to(dev) for t in (q, kp, vp, table, pos)]
    got = ck.paged_decode_attention(*args, **kw)
    want = ck.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise SystemExit("kernel output is not finite at the edge depths")
    return float((got - want).abs().max())


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


def serve_run(ck, model_path, reqs, kv_dtype):
    """8 concurrent /generate through a fresh server; returns (tokens,
    stats) with the launch count of exactly this run."""
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model_path=model_path, decode_slots=SLOTS,
                          prefill_chunk=CHUNK, kv_block=KV_BLOCK,
                          kv_pool_mb=KV_POOL_MB, kv_dtype=kv_dtype,
                          paged_kernel="on", device="cuda").start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
            assert r.status == 200
        dec = srv.decoder
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
        stats = {"launches": launches, "decode_steps": dec.decode_steps,
                 "prefill_chunks": dec.prefill_chunks,
                 "tokens": sum(len(o["tokens"]) for o in outs),
                 "wall_s": wall,
                 "tokens_per_s": sum(len(o["tokens"]) for o in outs) / wall,
                 "mean_decode_step_ms": 1e3 * dec.decode_seconds
                 / max(dec.decode_steps, 1),
                 "decode_s": dec.decode_seconds,
                 "prefill_s": dec.prefill_seconds,
                 "mean_prefill_chunk_ms": 1e3 * dec.prefill_seconds
                 / max(dec.prefill_chunks, 1),
                 "capacity_blocks": dec.pool.capacity_blocks}
        net = srv.net
    finally:
        srv.stop()
    n_attn = sum(type(i).__name__ == "SelfAttentionLayerImpl"
                 for i in net._impls.values())
    if launches <= 0 or launches != n_attn * stats["decode_steps"]:
        raise SystemExit(f"launch count {launches} != {n_attn} attention "
                         f"layers x {stats['decode_steps']} decode steps")
    return [o["tokens"] for o in outs], stats, net


def profile_run(net, reqs):
    """The fp32 serving run again, straight on a DecodeScheduler, under
    torch.profiler: the device's busy share of the wall time and the
    kernels that take it, by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    eng = DecodeScheduler(net, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                          kv_block=KV_BLOCK, kv_pool_mb=KV_POOL_MB,
                          device="cuda").start()
    try:
        eng.generate(reqs[0]["prompt"][:CHUNK + 3], 4, timeout=900)
        eng.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            hs = [eng.submit(b["prompt"], NEW_TOKENS,
                             **{k: b[k] for k in ("temperature", "top_k",
                                                  "seed") if k in b})
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
            "prefill_chunks": eng.prefill_chunks,
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


def bound(n_bytes, n_ops):
    """(bound ms, "bytes" or "operations") at the H100's published rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    want = ck.conv2d_bias_act_ref(x, w, b, **kw)
    torch.cuda.synchronize()
    oh, ow, pads = ck.conv_geometry(H, W, K, K, stride, padding)
    r = {"shape": [B, H, W, C, K, OC], "stride": list(stride),
         "pads": [list(p) for p in pads], "activation": act,
         "max_abs_err": float((got - want).abs().max()),
         "max_abs_plain": float(want.abs().max()),
         "ms": time_ms(lambda: ck.conv2d_bias_act(x, w, b, **kw), flush=flush),
         "plain_ms": time_ms(lambda: ck.conv2d_bias_act_ref(x, w, b, **kw),
                             flush=flush),
         "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(
        4 * (x.numel() + w.numel() + b.numel() + B * oh * ow * OC),
        2 * B * oh * ow * OC * K * K * C)
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
    (the caller's explicit override). Returns (net, losses, step
    seconds, launch counts of exactly these steps)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import helpers
    net = MultiLayerNetwork(conf, device="cuda").init()
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

    cases = {}
    for name, H, Hkv in (("mha", 8, 8), ("gqa", 8, 2)):
        for quantized in (False, True):
            key = f"{name}_{'int8' if quantized else 'fp32'}"
            r = kernel_case(ck, torch, H=H, Hkv=Hkv, quantized=quantized,
                            seed=len(cases))
            cases[key] = r
            ok = r["max_abs_err"] < 1e-4
            phase(2, f"{key}: B={SLOTS} H={H} Hkv={Hkv} Dh=64 block=16 nb=64 "
                     f"live={r['live_positions']} max|diff|={r['max_abs_err']:.3e} "
                     f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); library "
                     "call: none (no single PyTorch op gathers pages and "
                     f"attends) [{card}]")
            if not ok:
                raise SystemExit(f"kernel disagrees with the plain version: "
                                 f"{key} max|diff|={r['max_abs_err']}")
            err = edge_case(ck, torch, H=H, Hkv=Hkv, quantized=quantized)
            cases[key]["edge_max_abs_err"] = err
            phase(2, f"{key} edges: depths 0, 15, 16, 63 and 1 << 30 over "
                     f"nb=4 pages: max|diff|={err:.3e}")
            if not err < 1e-4:
                raise SystemExit(f"kernel disagrees with the plain version "
                                 f"at the edge depths: {key} max|diff|={err}")

    conf = transformer_lm(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                          n_blocks=BLOCKS, rope=True, seed=7)
    net = ComputationGraph(conf, device="cuda").init()
    reqs = requests_for(seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        zpath = os.path.join(tmp, "lm.zip")
        write_model(net, zpath)
        tokens, e2e, snet = serve_run(ck, zpath, reqs, None)
        solo = []
        for b in reqs:
            kw = {k: b[k] for k in ("temperature", "top_k", "seed") if k in b}
            solo.append(generate_transformer(snet, b["prompt"], NEW_TOKENS,
                                             VOCAB, **kw))
        if tokens != solo:
            bad = [i for i, (a, s) in enumerate(zip(tokens, solo)) if a != s]
            raise SystemExit(f"served tokens differ from solo decode for "
                             f"requests {bad}")
        phase(3, f"flagship LM ({net.num_params()} params) served 8 "
                 f"concurrent /generate, prompts "
                 f"{[len(b['prompt']) for b in reqs]}: tokens identical to "
                 f"solo; {e2e['tokens']} tokens in {e2e['wall_s']:.3f} s = "
                 f"{e2e['tokens_per_s']:.2f} tokens/s, {e2e['decode_steps']} "
                 f"decode steps, mean {e2e['mean_decode_step_ms']:.3f} ms, "
                 f"{e2e['prefill_chunks']} prefill chunks, mean "
                 f"{e2e['mean_prefill_chunk_ms']:.3f} ms, kernel launches "
                 f"{e2e['launches']} = {BLOCKS} x {e2e['decode_steps']} "
                 f"[{card}]")

        tokens8, e2e8, snet8 = serve_run(ck, zpath, reqs, "int8")
        ref = DecodeScheduler(snet8, VOCAB, n_slots=SLOTS, prefill_chunk=CHUNK,
                              kv_block=KV_BLOCK, kv_pool_mb=KV_POOL_MB,
                              kv_dtype="int8", paged_kernel="off",
                              device="cuda").start()
        try:
            hs = [ref.submit(b["prompt"], NEW_TOKENS,
                             **{k: b[k] for k in ("temperature", "top_k",
                                                  "seed") if k in b})
                  for b in reqs]
            ref_tokens = [h.result(timeout=900) for h in hs]
        finally:
            ref.stop()
        if tokens8 != ref_tokens:
            bad = [i for i, (a, s) in enumerate(zip(tokens8, ref_tokens))
                   if a != s]
            raise SystemExit(f"int8 kernel tokens differ from the gather "
                             f"body for requests {bad}")
        phase(4, f"int8 KV: tokens identical to paged_kernel='off'; "
                 f"{e2e8['tokens_per_s']:.2f} tokens/s, mean decode step "
                 f"{e2e8['mean_decode_step_ms']:.3f} ms, kernel launches "
                 f"{e2e8['launches']} = {BLOCKS} x {e2e8['decode_steps']} "
                 f"[{card}]")

    prof = profile_run(snet, reqs)
    if prof["device_busy_ms"] > 0:
        print(f"[profile] fp32 serving run under torch.profiler: wall "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f}"
              f" ms ({100 * prof['device_busy_share']:.2f}%), paged kernel "
              f"{prof['paged_kernel_ms']:.3f} ms, decode {prof['decode_s']:.3f} s"
              f" / prefill {prof['prefill_s']:.3f} s of host time; top "
              f"kernels {prof['top_kernels_ms'][:4]} [{card}]", flush=True)
    else:
        print("[profile] the profiler saw no device time: not measured",
              flush=True)

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
                 f"{r['max_abs_err']:.3e} (gate {gate:.3e}); kernel "
                 f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                 f"{r['library_ms']} ms [{card}]")
        if not r["max_abs_err"] <= gate:
            raise SystemExit(f"conv kernel disagrees with the plain version "
                             f"at {r['shape']}: {r['max_abs_err']}")
        if r["library_ms"] is not None and not r["library_err"] <= gate:
            raise SystemExit(f"F.conv2d yardstick computes another function "
                             f"at {r['shape']}: {r['library_err']}")
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
                 f"bound {r['sums_bound_ms']:.4f} {r['sums_bound_by']}), dx "
                 f"{r['dx_ms']:.4f} ms (plain {r['dx_plain_ms']:.4f}, bound "
                 f"{r['dx_bound_ms']:.4f} {r['dx_bound_by']}); library call: "
                 "none (no single PyTorch op routes a pooled gradient "
                 f"through BN and the activation) [{card}]")
        if not (r["sums_max_abs_err"] <= gate and r["sums_repeat_bitwise"]
                and r["dx_max_abs_err"] <= 1e-5):
            raise SystemExit(f"BN+act+pool backward kernels disagree with "
                             f"the plain versions at {r['shape']}: {r}")

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
    want = {"paged_decode_attention": 0, "conv2d_bias_act": 3 * STEPS,
            "bnap_sums": 3 * STEPS, "bnap_dx": 3 * STEPS}
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
    # the backward kernels on the training path's own inputs: the same
    # params and dropout masks through the kernels and through plain
    # versions. With only bn_act_pool plain, the forward is the same bits,
    # so the gradients differ by the sums' order alone; with every kernel
    # plain, the conv outputs differ by rounding, which can flip a few
    # near-tied 2x2 maxima and relu signs and so move whole gradient
    # elements: a looser gate, still far below a wrong per-tensor scale
    bnap_loss, bnap_rel = grad_check(
        torch, anet, xa, ya, {"bn_act_pool": helpers.bn_act_pool_plain})
    all_loss, all_rel = grad_check(torch, anet, xa, ya,
                                   helpers.PLAIN_OVERRIDES)
    train.update(grad_bnap_plain={"loss_rel": bnap_loss, "leaf_rel": bnap_rel},
                 grad_all_plain={"loss_rel": all_loss, "leaf_rel": all_rel})
    worst_b = max(bnap_rel.items(), key=lambda kv: kv[1])
    worst_a = max(all_rel.items(), key=lambda kv: kv[1])
    phase(6, f"gradients at step {STEPS + 5}'s params, B={B}, same dropout "
             f"masks: with bn_act_pool plain, loss rel diff {bnap_loss:.3e} "
             f"(gate 1e-6), worst leaf {worst_b[0]} ||diff||/||plain|| "
             f"{worst_b[1]:.3e} (gate 1e-4); with every kernel plain, loss "
             f"{all_loss:.3e} (gate 1e-5), worst leaf {worst_a[0]} "
             f"{worst_a[1]:.3e} (gate 1e-2)")
    if not (bnap_loss <= 1e-6 and worst_b[1] <= 1e-4 and all_loss <= 1e-5
            and worst_a[1] <= 1e-2):
        raise SystemExit(f"kernel and plain gradients differ: bn_act_pool "
                         f"{bnap_loss} {bnap_rel}; all {all_loss} {all_rel}")
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
    if lenet_launches != {"paged_decode_attention": 0, "conv2d_bias_act": 5,
                          "bnap_sums": 0, "bnap_dx": 0}:
        raise SystemExit(f"LeNet launches {lenet_launches}, want 1 conv per "
                         f"step")
    lenet = {"losses": lenet_losses, "step_s": lenet_secs,
             "launches": lenet_launches,
             "mean_step_ms": 1e3 * sum(lenet_secs[1:]) / 4}
    phase(7, f"LeNet-MNIST B={B}, 5 steps: losses {lenet_losses}, launches "
             f"{lenet_launches} (conv1 declines: kw*c = 5 < 8); steps 2-5 "
             f"mean {lenet['mean_step_ms']:.3f} ms [{card}]")

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
                        "bound_by": c["bound_by"], "library_ms": None})
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
        "max_abs_err": max(c["max_abs_err"] for c in conv_cases[:4]),
        "ms": sum(c["ms"] for c in alex_conv),
        "plain_ms": sum(c["plain_ms"] for c in alex_conv),
        "bound_ms": sum(c["bound_ms"] for c in alex_conv),
        "bound_by": by(alex_conv, ""),
        "library_ms": sum(c["library_ms"] for c in alex_conv)})
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
            "bound_by": by(alex_bnap, k), "library_ms": None})
    print("[details] " + json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": ptxas, "cases": cases, "e2e_fp32": e2e,
         "e2e_int8": e2e8, "profile": prof, "conv_cases": conv_cases,
         "conv_activation_rel_errs": act_errs, "conv_seam": seam_cases,
         "bnap_cases": bnap_cases, "alexnet_train": train,
         "alexnet_profile": tprof, "lenet_train": lenet}))
    phase(8, "kernels:")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
