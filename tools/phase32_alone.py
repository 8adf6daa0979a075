"""Run phase 32 of chip_smoke.py alone on the card: builds the kernels,
then speculation, the KV tiers and fault tolerance under the mesh
(`chip_smoke.phase32`: the flagship speculating at tp = 2 by two ranks on
card 0, paged and contiguous; phase 28's waves through a tiered tp = 2
engine, fp32 and int8 pages, a fetched block served by a tp = 1 peer;
AlexNet under the ICI master with a state tracker, resumed, and
restarted on one rank after its follower is SIGKILLed).

    python3 tools/phase32_alone.py [--out phase32.json]

It exits 1 without a CUDA device, and 2 when phase 32 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 32 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase32_alone: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t00 = time.time()
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    _build.build_all(sources)
    for s in sources:
        _build.load(s)
    print(f"built in {time.time() - t00:.1f} s", flush=True)
    try:
        out = cs.phase32(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 32 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
