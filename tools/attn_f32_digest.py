"""Digests of the f32 attention kernels' outputs, to show two trees build
the same f32 kernels bit for bit.

    python tools/attn_f32_digest.py [--root TREE] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, runs the six f32 attention kernels (flash and splash
forward, dK/dV, dQ) at the main shapes of chip_smoke.py's phases 9 and 11
on inputs drawn from fixed seeds, and prints one JSON object {case:
sha256 of the raw bytes of every output}. Run it on two checkouts on one
card and compare: equal digests mean equal bits. Needs a CUDA card.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

SHAPES = (("flash", 32, 256, 8, 64, True), ("flash", 1, 8192, 4, 128, True),
          ("splash", 1, 32768, 4, 128, True),
          ("splash", 1, 32768, 8, 128, True),
          ("splash", 4, 2048, 4, 64, False))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("attn_f32_digest: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import splash_mask
    digests = {}
    for i, (fam, B, L, H, D, causal) in enumerate(SHAPES):
        g = torch.Generator().manual_seed(900 + i)
        q, k, v, do = (torch.randn((B, L, H, D), generator=g).cuda()
                       for _ in range(4))
        scale = D ** -0.5
        if fam == "flash":
            kw = dict(causal=causal, scale=scale)
            o, lse = ck.flash_attention_fwd(q, k, v, **kw)
            di = (o * do).sum(dim=-1).permute(0, 2, 1).contiguous()
            dk, dv = ck.flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
            dq = ck.flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
        else:
            tb = splash_mask.splash_tables(L, H, causal)
            qs = q * scale
            o, lse = ck.splash_attention_fwd(qs, k, v, tb)
            di = (o * do).sum(dim=-1).permute(0, 2, 1).contiguous()
            dk, dv = ck.splash_attention_bwd_dkv(qs, k, v, do, lse, di, tb)
            dq = ck.splash_attention_bwd_dq(qs, k, v, do, lse, di, tb)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (o, lse, dk, dv, dq):
            h.update(t.cpu().numpy().tobytes())
        digests[f"{fam} {[B, L, H, D]} {'causal' if causal else 'full'}"] = \
            h.hexdigest()
        del q, k, v, do, o, lse, di, dk, dv, dq
        torch.cuda.empty_cache()
    line = json.dumps({"root": a.root, "card": torch.cuda.get_device_name(0),
                       "digests": digests})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
