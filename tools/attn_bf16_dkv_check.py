"""A quick check of the bf16 dK/dV kernels (ops/csrc/attn_dkv_bf16.cuh under
flash_attention_bwd.cu and splash_attention_bwd.cu) on the card, short of a
whole chip_smoke.py run.

    python tools/attn_bf16_dkv_check.py [--root TREE]

Builds the two backward sources of TREE (default: this checkout) and prints
ptxas's registers, spills and serialised-wgmma warnings of the bf16 dK/dV
kernels, and their registers, local bytes and shared memory as loaded; then
holds dk and dv against the plain versions, with lse and di from the plain
forward, at phase 20's edge set of chip_smoke.py (flash L = 7, 129, 300 and
splash L = 128, 256 at every head dim) and main shapes (max |diff| within
2^-7 of max |plain|, mean within 1e-3, bitwise repeatable), and times the
main shapes (CUDA events, median, L2 flushed, the device spun before each
call). Prints one JSON line per case and ends with "ALL OK" or
"FAILURES" (exit 1). Needs a CUDA card and nvcc.
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
    a = ap.parse_args()
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
                ours = "dkv_bf16" in ln
                if ours:
                    print(ln.strip().split("'")[1])
            elif ours and ("Used" in ln or "spill" in ln):
                print("   ", ln.strip())
            if "dkv_bf16" in ln and "serialized" in ln:
                print("SERIALISED", ln.strip()[-120:])
    print(ck.attention_bf16_dkv_roles())
    for D in ck.FLASH_HEAD_DIMS:
        print(D, {k: v for k, v in ck.attention_bf16_attrs(D).items()
                  if "dkv" in k}, flush=True)

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
        if family == "flash":
            kw = dict(causal=causal, scale=scale)
            qin = q
            fwd = functools.partial(ck.flash_attention_fwd_ref, **kw)
            dkv = functools.partial(ck.flash_attention_bwd_dkv, **kw)
            rdkv = functools.partial(ck.flash_attention_bwd_dkv_ref, **kw)
        else:
            tb = splash_mask.splash_tables(L, H, causal)
            qin = q * torch.full((), scale, dtype=bf, device=dev)
            fwd = functools.partial(ck.splash_attention_fwd_ref, tables=tb)
            dkv = functools.partial(ck.splash_attention_bwd_dkv, tables=tb)
            rdkv = functools.partial(ck.splash_attention_bwd_dkv_ref,
                                     tables=tb)
        o, lse = fwd(qin, k, v)
        di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (qin, k, v, do, lse, di)
        dk, dv = dkv(*args)
        dk2, dv2 = dkv(*args)
        rdk, rdv = rdkv(*args)
        torch.cuda.synchronize()
        r = {"case": f"{family} {[B, L, H, D]} "
                     f"{'causal' if causal else 'full'}"}
        for n, got, want in (("dk", dk, rdk), ("dv", dv, rdv)):
            d = (got.float() - want.float()).abs()
            m = float(want.float().abs().max())
            r[n] = (float(d.max()) / m, float(d.mean()) / m)
        r["bitwise"] = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        r["ok"] = (max(r["dk"][0], r["dv"][0]) <= 2 ** -7
                   and max(r["dk"][1], r["dv"][1]) <= 1e-3 and r["bitwise"]
                   and bool(torch.isfinite(dk.float()).all()
                            and torch.isfinite(dv.float()).all()))
        if timed:
            r["ms"] = time_ms(lambda: dkv(*args),
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
