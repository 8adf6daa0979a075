"""Digests of the conv kernels' outputs, to show two trees build the same f32
conv kernel, and the same bf16 mma.sync and wgmma conv kernels, bit for
bit.

    python tools/conv_digest.py [--root TREE] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, and runs conv2d_bias_act on inputs drawn from fixed
seeds:
  - f32, at the main shapes of chip_smoke.py's phase 5 (AlexNet-CIFAR10's
    three convs and LeNet-MNIST's conv2, B = 512) and its edge set;
  - bf16, at the shapes that take the mma.sync kernel (the route of
    csrc/conv_bf16.cuh: C not a multiple of 64, or OC not of 8): AlexNet's
    conv1 and LeNet's conv2 (B = 512), and phase 22's edge set of that
    route (C = 3, 4, 8, 20 with OC = 50, 33, 70; C = 8, 16, 24, 32 with OC
    = 72, 136, 40, 256; every activation with its pre-activation at C = 3
    and 16, OC = 9);
  - bf16, at shapes that take the wgmma kernel (C % 64 == 0, OC % 8 ==
    0): AlexNet's conv2 and conv3 (B = 512) and a strided edge (C = 64, OC
    = 72, stride 2).
Prints one JSON object {case: sha256 of the raw bytes of out (and pre)}.
Run it on two checkouts on one card and compare: equal digests mean equal
bits. Needs a CUDA card.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

SAME = ((1, 1), (1, 1))
# (dtype, B, H, W, C, K, OC, stride, padding, activation, want_pre)
F32 = [("f32", 512, 32, 32, 3, 3, 64, (1, 1), SAME, "identity", False),
       ("f32", 512, 16, 16, 64, 3, 128, (1, 1), SAME, "identity", False),
       ("f32", 512, 8, 8, 128, 3, 256, (1, 1), SAME, "identity", False),
       ("f32", 512, 12, 12, 20, 5, 50, (1, 1), "VALID", "identity", False),
       ("f32", 3, 13, 11, 8, 5, 50, (2, 2), "SAME", "relu", False),
       ("f32", 1, 7, 7, 4, 3, 33, (2, 2), "SAME", "tanh", False),
       ("f32", 2, 9, 10, 3, 3, 70, (1, 2), ((2, 0), (1, 1)), "sigmoid",
        True)]
BF16_MMA_SYNC = [
    ("bf16", 512, 32, 32, 3, 3, 64, (1, 1), SAME, "relu", False),
    ("bf16", 512, 12, 12, 20, 5, 50, (1, 1), "VALID", "identity", False),
    ("bf16", 3, 13, 11, 8, 5, 50, (2, 2), "SAME", "relu", False),
    ("bf16", 1, 7, 7, 4, 3, 33, (2, 2), "SAME", "tanh", False),
    ("bf16", 2, 9, 10, 3, 3, 70, (1, 2), ((2, 0), (1, 1)), "sigmoid",
     False),
    ("bf16", 2, 9, 9, 20, 5, 50, (1, 1), "VALID", "relu", False),
    ("bf16", 3, 13, 11, 8, 5, 72, (2, 2), "SAME", "relu", False),
    ("bf16", 2, 9, 7, 24, 3, 40, (1, 1), "SAME", "tanh", False),
    ("bf16", 3, 11, 10, 16, 3, 136, (1, 2), ((2, 0), (1, 1)), "sigmoid",
     False),
    ("bf16", 5, 7, 9, 32, 3, 256, (1, 1), "VALID", "relu", False)]
BF16_WGMMA = [
    ("bf16", 512, 16, 16, 64, 3, 128, (1, 1), SAME, "relu", False),
    ("bf16", 512, 8, 8, 128, 3, 256, (1, 1), SAME, "relu", False),
    ("bf16", 3, 13, 11, 64, 3, 72, (2, 2), "SAME", "tanh", True)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    if not torch.cuda.is_available():
        print("conv_digest: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    acts = sorted(set(ck.ACT_CODES) - {"linear"})
    cases = F32 + BF16_MMA_SYNC + [
        ("bf16", 2, 6, 5, c, 3, 9, (1, 1), "SAME", act, True)
        for act in acts for c in (3, 16)] + BF16_WGMMA
    digests = {}
    for i, (dt, B, H, W, C, K, OC, stride, padding, act, pre) in enumerate(
            cases):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        g = torch.Generator().manual_seed(700 + i)
        x = torch.randn((B, H, W, C), generator=g).to("cuda", dtype)
        w = (torch.randn((K, K, C, OC), generator=g)
             / (K * K * C) ** 0.5).to("cuda", dtype)
        b = (torch.randn((OC,), generator=g) * 0.1).to("cuda", dtype)
        got = ck.conv2d_bias_act(x, w, b, stride=stride, padding=padding,
                                 activation=act, want_pre=pre)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (got if pre else (got,)):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[f"{dt} {[B, H, W, C, K, OC]} {list(stride)} {padding} "
                f"{act}{' pre' if pre else ''}"] = h.hexdigest()
    line = json.dumps({"root": a.root, "card": torch.cuda.get_device_name(0),
                       "digests": digests})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
