"""Run phase 31 of chip_smoke.py alone on the card (about two minutes after
the build): builds the kernels, then the tensor-parallel and
data-parallel phase (`chip_smoke.phase31`: the flagship served at tp = 2
by two ranks on card 0, fp32 and int8 pages and GQA, the paged kernel at
the shard shapes, a follower SIGKILLed under a supervised server,
AlexNet under the ICI and parameter-averaging masters).

    python3 tools/phase31_alone.py [--out phase31.json]

It exits 1 without a CUDA device, and 2 when phase 31 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 31 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase31_alone: no CUDA device", file=sys.stderr)
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
        out = cs.phase31(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 31 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
