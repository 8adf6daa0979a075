"""Run phase 30 of chip_smoke.py alone on the card (under a minute after
the build): builds the kernels, then the ComputationGraph phase
(`chip_smoke.phase30`: AlexNet as a graph captured against eager and
against the MultiLayerNetwork, early stopping and the zip round trips,
the seq2seq addition graph, float64 gradient checks).

    python3 tools/phase30_alone.py [--out phase30.json]

It exits 1 without a CUDA device, and 2 when phase 30 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 30 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase30_alone: no CUDA device", file=sys.stderr)
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
        out = cs.phase30(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 30 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
