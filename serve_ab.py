"""Serving throughput of two checkouts of the port, in turns, on one card.

    python3 serve_ab.py PARENT_DIR CHANGE_DIR [--reps N]

Runs chip_smoke.py's phase-3 serving wave (`serve_run`: 8 concurrent
/generate on the flagship LM, fp32 pages, after one warm-up request) from
each checkout in turn: parent, change, change, parent, each in a process of
its own started in that checkout, so that each imports and builds its own
package; N waves (default 3) a process. Prints one JSON line per process,
then the medians of tokens/s and of the mean decode-step ms per checkout,
with the card's name and power limit. Every wave's tokens must be the same
in both checkouts, or it exits 1. Host times move between calls on a shared
host: compare two versions only within one run of this script.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.models.zoo import transformer_lm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.util.model_serializer import write_model
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
net = ComputationGraph(transformer_lm(
    vocab_size=cs.VOCAB, d_model=cs.D_MODEL, n_heads=cs.HEADS,
    n_blocks=cs.BLOCKS, rope=True, seed=7), device="cuda").init()
reqs = cs.requests_for(seed=1)
keys = ("tokens_per_s", "mean_decode_step_ms", "mean_prefill_chunk_ms",
        "wall_s", "decode_steps", "prefill_chunks")
out = []
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "lm.zip")
    write_model(net, path)
    for _ in range(int(sys.argv[1])):
        tokens, st, _ = cs.serve_run(ck, path, reqs, None)
        out.append({"tokens": tokens, **{k: st[k] for k in keys}})
print("RESULT " + json.dumps(out))
"""


def run(checkout: Path, reps: int) -> list:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(reps)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    waves = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        got = run(getattr(args, side), args.reps)
        waves[side] += got
        print(json.dumps({"side": side, "card": card, "waves": [
            {k: v for k, v in w.items() if k != "tokens"} for w in got]}),
            flush=True)
    first = waves["parent"][0]["tokens"]
    if any(w["tokens"] != first for ws in waves.values() for w in ws):
        print("the two checkouts served different tokens", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "reps": args.reps, **{
        side: {k: statistics.median(w[k] for w in ws)
               for k in ("tokens_per_s", "mean_decode_step_ms")}
        for side, ws in waves.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
