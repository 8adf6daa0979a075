"""Run phase 6's gradient checks of chip_smoke.py alone on the card, on
several data seeds: AlexNet-CIFAR10 at full width, B = 512, 20 captured
fit_batch steps and 5 more (as phase 6 trains it), then
`chip_smoke.alexnet_grad_checks` on one more step's params and dropout
masks. Seed 0 is phase 6's own batch. Each seed prints one line, and the
count of 2x2 windows that the conv's rounding moved shows how often the
every-kernel-plain gradients part from the kernels' by a whole element.

    python3 tools/phase6_grad_alone.py [--seeds 0 1 2] [--out grads.json]

It exits 1 without a CUDA device, and 2 when a gate fails on any seed.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 6's gradient checks")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=None, help="write the figures here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("phase6_grad_alone: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t00 = time.time()
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    out, rc = {}, 0
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(size=(512, 32, 32, 3)).astype(
            np.float32)).cuda()
        y = torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, 512)]).cuda()
        net, _, _, _ = cs.train_run(ck, torch, alexnet_cifar10(), x, y, 20)
        for _ in range(5):
            net.fit_batch(x, y)
        grads, failed = cs.alexnet_grad_checks(torch, net, x, y)
        out[seed] = {"figures": grads, "failed": failed}
        print(f"seed {seed}: {cs.grad_checks_line(grads)}; failed "
              f"{failed}", flush=True)
        rc = rc or (2 if failed else 0)
        del net
        torch.cuda.empty_cache()
    print(f"done in {time.time() - t00:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
