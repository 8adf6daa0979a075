"""Times the bf16 BN+act+pool backward kernels (bnap_sums and bnap_dx) at
AlexNet-CIFAR10's three BN+pool layers (B = 512, relu), to compare two
trees' kernels on one card.

    python tools/bnap_bf16_time.py [--root TREE] [--reps N] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, holds both kernels against their plain versions at
the edge set of bnap_digest.py (phase 22's gates; tied windows: dx
bitwise), and for each layer: checks both kernels against their
plain versions (the sums within 1e-4 of max |plain| and the same bits on a
second launch; dx, fed the plain sums, within one bf16 ulp of max |plain|,
2^-7, with mean 1e-3, as chip_smoke.py phase 22 does), then takes the
median device time of ``reps`` single launches between CUDA events, each
after a 64 MiB L2 eviction and a device spin (chip_smoke.py's `time_ms`),
beside each kernel's bytes bound (x and g read once, dx written once, p and
s f32, at 3.35 TB/s). As a yardstick of the card's streaming rate it also
times ``x.clone()`` of the first layer's x (x read once and written once).
Prints one JSON object: the card's name and power limit, and per layer the
route (where the tree has one), ms, bound, share and errors, their sums
over the three layers, and the copy's ms and share. Run the trees in the
order A, B, B, A in one call and compare. Needs a CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from bnap_digest import BF16_EDGE, EDGE, make_inputs, route_of

LAYERS = {"conv1": (512, 32, 32, 64), "conv2": (512, 16, 16, 128),
          "conv3": (512, 8, 8, 256)}
SPIN_CYCLES = 10_000_000  # about 5 ms at the H100's boost clock
HBM_BYTES_PER_S = 3.35e12


def time_ms(torch, fn, reps, flush):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
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


def check(torch, ck, x, gp, p, act):
    """The phase-22 gates of one case: (sums rel err, sums bitwise
    repeatable, dx rel err, dx mean rel err, dx bitwise, the plain sums
    as dx's s)."""
    dg, db = ck.bnap_sums(x, gp, p, activation=act)
    dg2, db2 = ck.bnap_sums(x, gp, p, activation=act)
    rg, rb = ck.bnap_sums_ref(x, gp, p, activation=act)
    s = torch.stack([rb, rg]).contiguous()
    dx = ck.bnap_dx(x, gp, p, s, activation=act)
    rdx = ck.bnap_dx_ref(x, gp, p, s, activation=act)
    torch.cuda.synchronize()
    sums_rel = max(float((dg - rg).abs().max()),
                   float((db - rb).abs().max())) / max(
        float(rg.abs().max()), float(rb.abs().max()))
    d = (dx.float() - rdx.float()).abs()
    m = float(rdx.float().abs().max())
    return (sums_rel, bool(torch.equal(dg, dg2) and torch.equal(db, db2)),
            float(d.max()) / m, float(d.mean()) / m,
            bool(torch.equal(dx, rdx)), s)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("bnap_bf16_time: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    edges = {}
    for i, (B, H, W, C, act, tied, mis) in enumerate(
            [c + (False,) for c in EDGE] + BF16_EDGE):
        x, gp, p = make_inputs(torch, ck, B, H, W, C, act, tied, 950 + i,
                               torch.bfloat16, misaligned=mis)
        sr, sbit, dr, dm, dbit, _ = check(torch, ck, x, gp, p, act)
        edges[f"{[B, H, W, C]} {act}{' tied' if tied else ''}"
              f"{' misaligned' if mis else ''}"] = {
            "route": route_of(ck, x, gp), "sums_rel_err": sr,
            "sums_repeat_bitwise": sbit, "dx_rel_err": dr,
            "dx_mean_rel_err": dm, "dx_bitwise": dbit,
            "ok": bool(sr <= 1e-4 and sbit and dr <= 2.0 ** -7
                       and dm <= 1e-3 and (dbit or not tied))}
    out, copy = {}, None
    for i, (name, (B, H, W, C)) in enumerate(LAYERS.items()):
        x, gp, p = make_inputs(torch, ck, B, H, W, C, "relu", False, 900 + i,
                               torch.bfloat16)
        kw = dict(activation="relu")
        sr, sbit, dr, dm, _, s = check(torch, ck, x, gp, p, "relu")
        n_x, n_g = x.numel(), gp.numel()
        r = {"shape": [B, H, W, C], "route": route_of(ck, x, gp),
             "sums_rel_err": sr, "sums_repeat_bitwise": sbit,
             "dx_rel_err": dr, "dx_mean_rel_err": dm,
             "sums_ms": time_ms(torch, lambda: ck.bnap_sums(x, gp, p, **kw),
                                a.reps, flush),
             "dx_ms": time_ms(torch, lambda: ck.bnap_dx(x, gp, p, s, **kw),
                              a.reps, flush),
             "sums_bound_ms": (2 * (n_x + n_g) + 4 * 6 * C)
             / HBM_BYTES_PER_S * 1e3,
             "dx_bound_ms": (2 * (2 * n_x + n_g) + 4 * 6 * C)
             / HBM_BYTES_PER_S * 1e3}
        for k in ("sums", "dx"):
            r[k + "_share"] = r[k + "_bound_ms"] / r[k + "_ms"]
        r["ok"] = bool(r["sums_rel_err"] <= 1e-4 and r["sums_repeat_bitwise"]
                       and r["dx_rel_err"] <= 2.0 ** -7
                       and r["dx_mean_rel_err"] <= 1e-3)
        out[name] = r
        if copy is None:
            ms = time_ms(torch, lambda: x.clone(), a.reps, flush)
            bound = 2 * 2 * n_x / HBM_BYTES_PER_S * 1e3
            copy = {"shape": [B, H, W, C], "ms": ms, "bound_ms": bound,
                    "share": bound / ms}
    total = {k: sum(r[k] for r in out.values())
             for k in ("sums_ms", "sums_bound_ms", "dx_ms", "dx_bound_ms")}
    for k in ("sums", "dx"):
        total[k + "_share"] = total[k + "_bound_ms"] / total[k + "_ms"]
    attrs = getattr(ck, "bnap_bf16_ring_attrs", None)
    line = json.dumps({"root": a.root, "card": card, "layers": out,
                       "summed": total, "clone": copy, "edges": edges,
                       "ring_attrs": attrs() if attrs else None})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0 if all(r["ok"] for r in (*out.values(), *edges.values())) else 1


if __name__ == "__main__":
    sys.exit(main())
