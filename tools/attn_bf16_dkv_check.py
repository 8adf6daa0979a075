"""A quick check of the bf16 dK/dV or dQ kernels (ops/csrc/attn_dkv_bf16.cuh
or attn_dq_bf16.cuh under flash_attention_bwd.cu and
splash_attention_bwd.cu) on the card, short of a whole chip_smoke.py run.

    python tools/attn_bf16_dkv_check.py [--root TREE] [--kernel dkv|dq]

Builds the two backward sources of TREE (default: this checkout) and prints
ptxas's registers, spills and serialised-wgmma warnings of the chosen bf16
kernels (default dkv), their core's shape where TREE reports it, and their
registers, local bytes and shared memory as loaded; then holds their
outputs (dk and dv, or dq) against the plain versions, with lse and di
from the plain forward, at phase 20's edge set of chip_smoke.py (flash L =
7, 129, 300 and splash L = 128, 256 at every head dim) and main shapes
(max |diff| within 2^-7 of max |plain|, mean within 1e-3, bitwise
repeatable), and times the main shapes (CUDA events, median, L2 flushed,
the device spun before each call). Prints one JSON line per case and ends
with "ALL OK" or "FAILURES" (exit 1). Needs a CUDA card and nvcc.
"""
import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernel", choices=("dkv", "dq"), default="dkv")
    a = ap.parse_args()
    kind = f"{a.kernel}_bf16"
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("attn_bf16_dkv_check: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import _build, splash_mask
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.monotonic()
    logs = _build.build_all(["flash_attention_bwd", "splash_attention_bwd"])
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    for log in logs.values():
        ours = False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                ours = kind in ln
                if ours:
                    print(ln.strip().split("'")[1])
            elif ours and ("Used" in ln or "spill" in ln):
                print("   ", ln.strip())
            if kind in ln and "serialized" in ln:
                why, _, fn = ln.partition(" in the function")
                print("SERIALISED", fn.strip()[-60:], why.split(":")[-1])
    roles = getattr(ck, f"attention_bf16_{a.kernel}_roles", None)
    if roles is not None:
        print(roles())
    for D in ck.FLASH_HEAD_DIMS:
        print(D, {k: v for k, v in ck.attention_bf16_attrs(D).items()
                  if f"_{a.kernel}" in k}, flush=True)

    dev, bf = torch.device("cuda"), torch.bfloat16
    scratch = torch.empty(64 << 20, dtype=torch.int8, device=dev)

    def time_ms(fn, reps):
        ts = []
        for _ in range(reps):
            scratch.zero_()
            torch.cuda._sleep(10_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return sorted(ts)[len(ts) // 2]

    def case(family, B, L, H, D, causal, seed, timed=False):
        g = torch.Generator().manual_seed(seed)
        q, k, v, do = (torch.randn((B, L, H, D), generator=g).to(dev, bf)
                       for _ in range(4))
        scale = D ** -0.5
        fn = f"{family}_attention_bwd_{a.kernel}"
        if family == "flash":
            kw = dict(causal=causal, scale=scale)
            qin = q
            fwd = functools.partial(ck.flash_attention_fwd_ref, **kw)
        else:
            kw = dict(tables=splash_mask.splash_tables(L, H, causal))
            qin = q * torch.full((), scale, dtype=bf, device=dev)
            fwd = functools.partial(ck.splash_attention_fwd_ref, **kw)
        run = functools.partial(getattr(ck, fn), **kw)
        ref = functools.partial(getattr(ck, f"{fn}_ref"), **kw)
        names = ("dk", "dv") if a.kernel == "dkv" else ("dq",)

        def outs(*args):
            got = run(*args)
            return got if a.kernel == "dkv" else (got,)

        o, lse = fwd(qin, k, v)
        di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (qin, k, v, do, lse, di)
        got, again = outs(*args), outs(*args)
        want = ref(*args)
        want = want if a.kernel == "dkv" else (want,)
        torch.cuda.synchronize()
        r = {"case": f"{family} {[B, L, H, D]} "
                     f"{'causal' if causal else 'full'}"}
        for n, x, w in zip(names, got, want):
            d = (x.float() - w.float()).abs()
            m = float(w.float().abs().max())
            r[n] = (float(d.max()) / m, float(d.mean()) / m)
        r["bitwise"] = all(torch.equal(x, y) for x, y in zip(got, again))
        r["ok"] = (max(r[n][0] for n in names) <= 2 ** -7
                   and max(r[n][1] for n in names) <= 1e-3 and r["bitwise"]
                   and all(bool(torch.isfinite(x.float()).all())
                           for x in got))
        if timed:
            r["ms"] = time_ms(lambda: run(*args),
                              5 if L >= 32768 else (10 if L >= 4096 else 25))
        print(json.dumps(r), flush=True)
        return r["ok"]

    ok = True
    edges = ([("flash", b, L, h, D, c) for D in ck.FLASH_HEAD_DIMS
              for L in (7, 129, 300) for b, h, c in ((3, 1, False),
                                                     (1, 3, True))]
             + [("splash", b, L, h, D, c) for L in (128, 256)
                for D in ck.FLASH_HEAD_DIMS
                for b, h, c in ((3, 1, False), (1, 3, True))])
    for fam, B, L, H, D, c in edges:
        ok &= case(fam, B, L, H, D, c, seed=L + D)
    for fam, B, L, H, D, c in (("flash", 32, 256, 8, 64, True),
                               ("flash", 1, 8192, 4, 128, True),
                               ("flash", 1, 8192, 4, 128, False),
                               ("splash", 1, 32768, 4, 128, True),
                               ("splash", 1, 32768, 8, 128, True)):
        ok &= case(fam, B, L, H, D, c, seed=7, timed=True)
        torch.cuda.empty_cache()
    print("ALL OK" if ok else "FAILURES")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
