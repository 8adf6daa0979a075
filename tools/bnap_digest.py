"""Digests of the BN+act+pool backward kernels' outputs (bnap_sums and
bnap_dx, f32 and bf16), to show two trees build kernels that give the same
bits.

    python tools/bnap_digest.py [--root TREE] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, and runs bnap_sums and bnap_dx on inputs drawn from
fixed seeds (the batch stats from the plain forward, and a fixed random s
for dx, so that dx does not depend on the sums kernel):
  - f32, at chip_smoke.py phase 5's shapes (AlexNet-CIFAR10's three
    BN+pool layers at B = 512, relu, and its edge set);
  - bf16, at phase 22's shapes (AlexNet's three layers, its edge set, and
    the edges of the bf16 ring route: B = 1 with H = 2, rows wider than a
    stage, a pooled-row count that is not a multiple of the grid, C = 8
    and C = 1024, tied windows, and a view that starts 8 bytes off 16).
Each case's d gamma and d beta digest apart from its dx. Prints one JSON
object {case: sha256 of the raw bytes}, with each bf16 case's route where
the tree has one. Run it on two checkouts on one card and compare: equal
digests mean equal bits. Needs a CUDA card.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

MAIN = [(512, 32, 32, 64, "relu", False), (512, 16, 16, 128, "relu", False),
        (512, 8, 8, 256, "relu", False)]
EDGE = [(2, 4, 4, 8, "relu", True), (1, 4, 4, 8, "sigmoid", False),
        (3, 6, 10, 40, "tanh", False), (4, 8, 6, 16, "identity", True)]
# (B, H, W, C, activation, tied, misaligned)
BF16_EDGE = [(3, 6, 10, 6, "relu", False, False),
             (1, 2, 16, 64, "relu", False, False),
             (2, 4, 64, 512, "tanh", False, False),
             (7, 130, 8, 16, "relu", False, False),
             (3, 6, 10, 8, "sigmoid", False, False),
             (2, 4, 6, 1024, "identity", False, False),
             (3, 4, 40, 256, "relu", True, False),
             (2, 6, 8, 16, "tanh", False, True)]


def make_inputs(torch, ck, B, H, W, C, act, tied, seed, dtype,
                misaligned=False):
    """(x, g, p) on the card from a fixed seed, as chip_smoke.py draws
    them. ``tied``: at f32 every 2x2 window holds four equal values; at
    bf16 four adjacent bf16 values whose activations, under gamma 0.05 and
    beta 3, round to one bf16 value. ``misaligned``: x and g are views that
    start 8 bytes past a 16-byte boundary."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    gamma = beta = None
    if tied and dtype == bf:
        base = torch.randn((B, H // 2, W // 2, C), generator=g).to(bf)
        base = base.view(torch.int16) & ~3
        base = base.repeat_interleave(2, 1).repeat_interleave(2, 2)
        offs = torch.stack([torch.randperm(4, generator=g)
                            for _ in range(B * (H // 2) * (W // 2) * C)])
        offs = offs.reshape(B, H // 2, W // 2, C, 2, 2).permute(
            0, 1, 4, 2, 5, 3).reshape(B, H, W, C).to(torch.int16)
        x = (base + offs).view(bf).contiguous().to(dev)
        gamma = torch.full((C,), 0.05, device=dev)
        beta = torch.full((C,), 3.0, device=dev)
    elif tied:
        x = torch.randn((B, H // 2, W // 2, C), generator=g)
        x = x.repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
        x = x.to(dev, dtype)
    else:
        x = torch.randn((B, H, W, C), generator=g).to(dev, dtype)
    gp = torch.randn((B, H // 2, W // 2, C), generator=g).to(dev, dtype)
    if gamma is None:
        gamma = (torch.rand((C,), generator=g) + 0.5).to(dev)
        beta = (torch.randn((C,), generator=g) * 0.1).to(dev)
    if misaligned:  # 8 bytes past 16 (a bf16 view 4 elements into a buffer)
        def off(t):
            buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
            v = buf[4:4 + t.numel()].view(t.shape)
            v.copy_(t)
            return v
        x, gp = off(x), off(gp)
    _, mean, _, inv = ck.bnap_forward_ref(x, gamma, beta, eps=1e-5,
                                          activation=act)
    p = torch.stack([mean, inv, gamma, beta]).contiguous()
    return x, gp, p


def route_of(ck, x, g):
    fn = getattr(ck, "bnap_bf16_route", None)
    if fn is None or x.dtype.itemsize != 2:
        return None
    B, H, W, C = x.shape
    # dx is a fresh allocation: 16-byte aligned
    return fn(B, H, W, C, x.data_ptr(), g.data_ptr(), 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("bnap_digest: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    cases = ([(torch.float32, *c, False) for c in MAIN + EDGE]
             + [(torch.bfloat16, *c, False) for c in MAIN + EDGE]
             + [(torch.bfloat16, *c) for c in BF16_EDGE])
    digests, routes = {}, {}
    for i, (dt, B, H, W, C, act, tied, mis) in enumerate(cases):
        x, gp, p = make_inputs(torch, ck, B, H, W, C, act, tied, 1300 + i,
                               dt, misaligned=mis)
        g = torch.Generator().manual_seed(1700 + i)
        s = (torch.randn((2, C), generator=g) * (B * H * W) * 1e-2).to("cuda")
        dg, db = ck.bnap_sums(x, gp, p, activation=act)
        dx = ck.bnap_dx(x, gp, p, s, activation=act)
        torch.cuda.synchronize()
        name = (f"{'f32' if dt == torch.float32 else 'bf16'} {[B, H, W, C]} "
                f"{act}{' tied' if tied else ''}{' misaligned' if mis else ''}")
        for key, ts in (("sums", (dg, db)), ("dx", (dx,))):
            h = hashlib.sha256()
            for t in ts:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            digests[f"{name} {key}"] = h.hexdigest()
        route = route_of(ck, x, gp)
        if route is not None:
            routes[name] = route
    line = json.dumps({"root": a.root, "card": torch.cuda.get_device_name(0),
                       "routes": routes, "digests": digests})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
