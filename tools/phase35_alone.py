"""Run phase 35 of chip_smoke.py alone on the card: the embeddings stack
(`chip_smoke.phase35`: Word2Vec at bench.py's config on the chunk path,
words/s and the busy share, the first chunk against the CPU step on the
same draws; one batch of every other step against the CPU and the fits of
tests/test_nlp.py's topic corpus; Word2Vec and GloVe over a 2-rank gloo
mesh on card 0 against one process). It builds no kernel: the steps are
plain PyTorch in captured CUDA graphs.

    python3 tools/phase35_alone.py [--out phase35.json]
    python3 tools/phase35_alone.py --cpu-rehearsal

``--cpu-rehearsal`` runs the phase on the CPU at a small size (60,000
tokens, batch 512, two fits; the capture gates are off and no time is
worth keeping): a check of its paths before a chip run. Without it the
script exits 1 without a CUDA device, and 2 when phase 35 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 35 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="the CPU at a small size (no card)")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    t00 = time.time()
    if args.cpu_rehearsal:
        torch.set_num_threads(1)
        cs.P35_DEV = "cpu"
        cs.W2V_TOKENS, cs.W2V_B, cs.W2V_FITS = 60_000, 512, 2
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("phase35_alone: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.card_line()
        print(card, torch.__version__, torch.version.cuda, flush=True)
    try:
        out = cs.phase35(torch, None, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 35 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
