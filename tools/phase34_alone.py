"""Run phase 34 of chip_smoke.py alone on the card: builds the kernels,
then the fleet (`chip_smoke.phase34`: two replica processes on card 0
serving the flagship through the paged kernel behind the journaled router;
routing and identity against the in-process engine, fp32 and int8 pages;
a replica SIGKILLed mid-decode; the router SIGKILLed between its journal
append and its dispatch; a rolling drain, the federation and the merged
trace).

    python3 tools/phase34_alone.py [--out phase34.json]
    python3 tools/phase34_alone.py --cpu-rehearsal

``--cpu-rehearsal`` runs the phase with CPU replicas at a small width
(d_model 32, 2 heads, 2 blocks, an 8 MiB pool; the kernels' plain
versions, so the launch gates are off and no time is worth keeping): a
check of its paths before a chip run. Without it the script exits 1
without a CUDA device, and 2 when phase 34 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 34 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="CPU replicas at a small width (no card)")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    t00 = time.time()
    if args.cpu_rehearsal:
        torch.set_num_threads(1)
        cs.P34_DEV = "cpu"
        cs.D_MODEL, cs.HEADS, cs.BLOCKS = 32, 2, 2
        cs.P34_KV_POOL_MB = 8
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("phase34_alone: no CUDA device", file=sys.stderr)
            return 1
        from deeplearning4j_tpu_torch.ops import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.card_line()
        print(card, torch.__version__, torch.version.cuda, flush=True)
        sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
        _build.build_all(sources)
        for s in sources:
            _build.load(s)
        print(f"built in {time.time() - t00:.1f} s", flush=True)
    try:
        out = cs.phase34(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 34 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
