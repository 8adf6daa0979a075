"""Times the bf16 conv + bias + act kernel at AlexNet-CIFAR10's three convs
(B = 512, SAME, relu), to compare two trees' kernels on one card.

    python tools/conv_bf16_time.py [--root TREE] [--reps N] [--out FILE]

Imports ``deeplearning4j_tpu_torch`` from TREE (default: this checkout),
builds its kernels, and for each conv: checks the kernel's output against
the plain version (max |diff| within one bf16 ulp of max |plain|, 2^-7, as
chip_smoke.py phase 22 does), then takes the median device time of
``reps`` single launches between CUDA events, each after a 64 MiB L2
eviction and a device spin (chip_smoke.py's `time_ms`), and the same for
F.conv2d at bf16. Prints one JSON object: the card's name and power limit,
and per conv its route, ms, F.conv2d ms, TFLOP/s and error. Run the trees
in the order A, B, B, A in one call and compare. Needs a CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SAME = ((1, 1), (1, 1))
CONVS = {"conv1": (512, 32, 32, 3, 3, 64), "conv2": (512, 16, 16, 64, 3, 128),
         "conv3": (512, 8, 8, 128, 3, 256)}
SPIN_CYCLES = 10_000_000  # about 5 ms at the H100's boost clock


def time_ms(torch, fn, reps, flush):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("conv_bf16_time: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    bf = torch.bfloat16
    out = {}
    for i, (name, (B, H, W, C, K, OC)) in enumerate(CONVS.items()):
        g = torch.Generator().manual_seed(900 + i)
        x = torch.randn((B, H, W, C), generator=g).to("cuda", bf)
        w = (torch.randn((K, K, C, OC), generator=g)
             / (K * K * C) ** 0.5).to("cuda", bf)
        b = (torch.randn((OC,), generator=g) * 0.1).to("cuda", bf)
        kw = dict(stride=(1, 1), padding=SAME, activation="relu")
        got = ck.conv2d_bias_act(x, w, b, **kw)
        want = ck.conv2d_bias_act_ref(x, w, b, **kw)
        m = float(want.float().abs().max())
        rel = float((got.float() - want.float()).abs().max()) / m
        xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wc = w.permute(3, 2, 0, 1).contiguous()
        ms = time_ms(torch, lambda: ck.conv2d_bias_act(x, w, b, **kw),
                     a.reps, flush)
        lib = time_ms(torch, lambda: F.conv2d(xc, wc, b, padding=1),
                      a.reps, flush)
        oh, ow, _ = ck.conv_geometry(H, W, K, K, (1, 1), SAME)
        flop = 2.0 * B * oh * ow * OC * K * K * C
        try:
            route = ck.conv_bf16_route_on_card(
                B, H, W, C, K, K, OC, (1, 1), SAME, x.data_ptr(),
                w.data_ptr())
        except TypeError:  # a tree whose route query takes (C, OC, M, x, w)
            route = ck.conv_bf16_route_on_card(C, OC, B * oh * ow,
                                               x.data_ptr(), w.data_ptr())
        out[name] = {"shape": [B, H, W, C, K, OC], "route": route,
                     "ms": ms, "F.conv2d_ms": lib,
                     "tflops": flop / ms / 1e9, "rel_err": rel,
                     "ok": rel <= 2.0 ** -7}
    line = json.dumps({"root": a.root, "card": card, "convs": out})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0 if all(v["ok"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
