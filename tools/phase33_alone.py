"""Run phase 33 of chip_smoke.py alone on the card: builds the kernels,
then tensor-parallel training and the other parallel modules
(`chip_smoke.phase33`: the flagship trained at tp = 2 by two ranks on
card 0 against the tp = 1 eager step, the flash kernels at the shard
shape, dp x tp on a 2 x 2 mesh under the ICI master, ZeRO-1, ring and
Ulysses attention at L = 8192, GPipe and MoE at d_model 512).

    python3 tools/phase33_alone.py [--out phase33.json]
    python3 tools/phase33_alone.py --cpu-rehearsal

``--cpu-rehearsal`` runs the phase on CPU ranks at a small width with the
kernels' plain versions (no card, no kernel gate, no timing worth
keeping): a check of its paths before a chip run. Without it the script
exits 1 without a CUDA device, and 2 when phase 33 fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 33 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="CPU ranks at a small width (no card)")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    t00 = time.time()
    if args.cpu_rehearsal:
        torch.set_num_threads(1)
        cs.P33_DEV = "cpu"
        cs.VOCAB, cs.D_MODEL, cs.BLOCKS = 16, 32, 2
        cs.P33_T, cs.P33_B = 8, 4
        cs.P33_PIPE_B, cs.P33_PIPE_T = 8, 6
        cs.P33_MOE_B, cs.P33_MOE_H = 16, 32
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("phase33_alone: no CUDA device", file=sys.stderr)
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
        out = cs.phase33(torch, ck, card)
        rc = 0
    except SystemExit as e:
        print(e, flush=True)
        out, rc = {"failed": str(e)}, 2
    print(f"phase 33 in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
