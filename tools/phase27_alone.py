"""Run phase 27 of chip_smoke.py alone on the card (about two minutes).

Builds the kernels, computes phase 27's references the way the full
script does (phase 3's tokens: solo cached decode of the flagship;
phase 4's: an int8-page engine with ``paged_kernel="off"``; phase 26's
trie and first JSON-schema completion on an unspeculated server, whose
wave also gives the tokens/s printed beside phase 27's), then runs
`chip_smoke.phase27`, and with ``--out PATH`` writes its figures there
as JSON. First it probes ``torch._int_mm``'s
shape rule on this torch (a row count of 16 or less is refused, which
`nn/quantization.int8_matmul` pads past).

    python3 tools/phase27_alone.py [--out phase27.json]

It exits 1 without a CUDA device, and 2 when phase 27 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 27 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase27_alone: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
    from deeplearning4j_tpu_torch.models.sampling import generate_transformer
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t00 = time.time()
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    for M, K, N in ((24, 512, 512), (17, 16, 8), (8, 512, 2048)):
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda")
        try:
            r = torch._int_mm(a, b).cpu().long()
            exact = bool((r == a.cpu().long() @ b.cpu().long()).all())
            print(f"torch._int_mm [{M}, {K}] x [{K}, {N}]: exact {exact}")
        except RuntimeError as e:
            print(f"torch._int_mm [{M}, {K}] x [{K}, {N}]: refused "
                  f"({str(e)[:120]})")
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    _build.build_all(sources)
    for s in sources:
        _build.load(s)
    reqs = cs.requests_for(seed=1)
    net = ComputationGraph(transformer_lm(
        vocab_size=cs.VOCAB, d_model=cs.D_MODEL, n_heads=cs.HEADS,
        n_blocks=cs.BLOCKS, rope=True, seed=7), device="cuda").init()
    want = [generate_transformer(net, b["prompt"], cs.NEW_TOKENS, cs.VOCAB,
                                 use_cache=True, **cs.sampling_kw(b))
            for b in reqs]
    ref = DecodeScheduler(net, cs.VOCAB, n_slots=cs.SLOTS,
                          prefill_chunk=cs.CHUNK, kv_block=cs.KV_BLOCK,
                          kv_pool_mb=cs.KV_POOL_MB, kv_dtype="int8",
                          paged_kernel="off", device="cuda").start()
    try:
        hs = [ref.submit(b["prompt"], cs.NEW_TOKENS, **cs.sampling_kw(b))
              for b in reqs]
        want8 = [h.result(900) for h in hs]
    finally:
        ref.stop()
    srv = cs.spec_server(net=net)
    try:
        prompt = reqs[0]["prompt"][:100]
        o = cs.post(srv.port, {"prompt": prompt, "max_new_tokens": 16,
                               "grammar": {"type": "trie", "sequences": [
                                   [5, 9, 12, 3, 77, 64]]}})
        j = cs.post(srv.port, {"prompt": prompt, "max_new_tokens": 40,
                               "temperature": 1.0, "seed": 0,
                               "grammar": {"type": "json_schema",
                                           "schema": cs.GRAMMAR_SCHEMA,
                                           "alphabet": cs.GRAMMAR_ALPHABET}})
        cs.post(srv.port, {"prompt": reqs[0]["prompt"][:cs.CHUNK + 3],
                           "max_new_tokens": 4})
        _, _, base = cs.spec_wave(torch, ck, srv, reqs)
    finally:
        srv.stop()
    del net
    p26 = {"grammar_fp32": {"trie": o["tokens"], "json": [{
        "text": "".join(cs.GRAMMAR_ALPHABET[t] for t in j["tokens"])}]}}
    print(f"references in {time.time() - t00:.1f} s; the unspeculated "
          f"wave {base['tokens_per_s']:.2f} tokens/s", flush=True)
    rc = 0
    try:
        out = cs.phase27(torch, ck, card, reqs, want, want8, p26, base)
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "phase27": out}, f, default=str)
    print(f"total {time.time() - t00:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
