"""On-card smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc; exits
non-zero without them, or when any phase fails. Phases:

  0. the card's name and power limit, torch and CUDA versions;
  1. builds every kernel source under deeplearning4j_tpu_torch/ops/csrc
     (one nvcc per source, all started together);
  2. holds the paged-decode kernel against its plain PyTorch version on
     the card at the serving shapes (fp32 and int8 pages, MHA and GQA):
     max |diff| < 1e-4; times both with CUDA events (median of 25, L2
     flushed before each launch) beside the least time the card could
     take (live K/V bytes at 3.35 TB/s, or f32 flops at 67 TFLOP/s);
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
     engine on the card (the layer's gather body);
  5. prints the kernels line, after a breakdown of the fp32 serving run
     under torch.profiler (the device's busy share, the top kernels).

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
    """Median ms of ``reps`` single launches, each between CUDA events,
    with ``flush`` (an L2 eviction) run before each outside the events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
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
    from torch.autograd import DeviceType
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
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    paged_ms = sum(ms for k, ms in kernels.items() if "paged_decode" in k)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "paged_kernel_ms": paged_ms, "decode_steps": eng.decode_steps,
            "decode_s": eng.decode_seconds, "prefill_s": eng.prefill_seconds,
            "prefill_chunks": eng.prefill_chunks,
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
    print("[details] " + json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": ptxas, "cases": cases, "e2e_fp32": e2e,
         "e2e_int8": e2e8, "profile": prof}))
    phase(5, "kernels:")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
