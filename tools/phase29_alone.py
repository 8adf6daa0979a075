"""Run phase 29 of chip_smoke.py alone on the card (about two minutes):
builds the kernels, then holds every training path captured against
eager and checks the new entry points (`chip_smoke.phase29`).

    python3 tools/phase29_alone.py [--out phase29.json] [--only a,b]

``--only`` keeps the named paths of `chip_smoke.tg_paths` (and skips the
new entry points). It exits 1 without a CUDA device, and 2 when phase 29
fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 29 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    ap.add_argument("--only", default=None,
                    help="comma-separated path names of tg_paths")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase29_alone: no CUDA device", file=sys.stderr)
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
    if args.only:
        keep = set(args.only.split(","))
        paths = cs.tg_paths
        cs.tg_paths = lambda torch: [p for p in paths(torch)
                                     if p[0] in keep]
        cs.tg_new_entry_points = lambda torch, ck, failures: {
            k: None for k in ("fit_scan", "accumulated", "dbn", "lbfgs",
                              "sync_guard")}
    try:
        out = cs.phase29(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 29 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
