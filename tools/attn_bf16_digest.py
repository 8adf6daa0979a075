"""Digests of the bf16 attention kernels' outputs, each output apart, to
show two trees build the same bf16 attention kernels bit for bit, or which
outputs differ.

    python tools/attn_bf16_digest.py [--root TREE] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, and runs the six bf16 attention kernels (flash and
splash forward, dK/dV, dQ) at the main shapes of chip_smoke.py's phase 20
on bf16 inputs drawn from fixed seeds. The backward kernels take lse and di
from the plain forward, as phase 20 feeds them, so a change to a forward
kernel cannot move a backward digest. Prints one JSON object {case:
{output: sha256 of its raw bytes}} for o, lse, dq, dk and dv. Run it on two
checkouts on one card and compare: equal digests mean equal bits. Needs a
CUDA card.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

SHAPES = (("flash", 32, 256, 8, 64, True), ("flash", 1, 8192, 4, 128, True),
          ("flash", 1, 8192, 4, 128, False),
          ("splash", 1, 32768, 4, 128, True),
          ("splash", 1, 32768, 8, 128, True))


def _sha(t) -> str:
    import torch
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.contiguous().cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("attn_bf16_digest: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import splash_mask
    bf = torch.bfloat16
    digests = {}
    for i, (fam, B, L, H, D, causal) in enumerate(SHAPES):
        g = torch.Generator().manual_seed(950 + i)
        q, k, v, do = (torch.randn((B, L, H, D), generator=g).to("cuda", bf)
                       for _ in range(4))
        scale = D ** -0.5
        if fam == "flash":
            kw = dict(causal=causal, scale=scale)
            qin = q
            o, lse = ck.flash_attention_fwd(qin, k, v, **kw)
            ro, rlse = ck.flash_attention_fwd_ref(qin, k, v, **kw)
            di = (ro.float() * do.float()).sum(dim=-1).permute(
                0, 2, 1).contiguous()
            dk, dv = ck.flash_attention_bwd_dkv(qin, k, v, do, rlse, di, **kw)
            dq = ck.flash_attention_bwd_dq(qin, k, v, do, rlse, di, **kw)
        else:
            tb = splash_mask.splash_tables(L, H, causal)
            qin = q * torch.full((), scale, dtype=bf, device="cuda")
            o, lse = ck.splash_attention_fwd(qin, k, v, tb)
            ro, rlse = ck.splash_attention_fwd_ref(qin, k, v, tb)
            di = (ro.float() * do.float()).sum(dim=-1).permute(
                0, 2, 1).contiguous()
            dk, dv = ck.splash_attention_bwd_dkv(qin, k, v, do, rlse, di, tb)
            dq = ck.splash_attention_bwd_dq(qin, k, v, do, rlse, di, tb)
        torch.cuda.synchronize()
        digests[f"{fam} {[B, L, H, D]} {'causal' if causal else 'full'}"] = {
            n: _sha(t) for n, t in (("o", o), ("lse", lse), ("dq", dq),
                                    ("dk", dk), ("dv", dv))}
        del q, k, v, do, qin, o, lse, ro, rlse, di, dk, dv, dq
        torch.cuda.empty_cache()
    line = json.dumps({"root": a.root, "card": torch.cuda.get_device_name(0),
                       "digests": digests})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
