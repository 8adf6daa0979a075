"""Run phase 28 of chip_smoke.py alone on the card (about two minutes).

Builds the paged decode kernel (the only kernel phase 28 runs), then
runs `chip_smoke.phase28`: the KV tiers and the attribution plane on the
flagship at full width. Options:

    python3 tools/phase28_alone.py [--out phase28.json] [--only a,c,d,f]
        [--guard-probe]

``--only`` runs the named sub-phases (a and b: the
host tier on fp32 and int8 pages; c: the disk tier; d: the faults,
with e, the peer fetch, between them; f: the kernel-off server and the
profiler's armed and disarmed rates) and reports their gates without raising.
``--guard-probe`` first serves waves A, B and C on a tiered server under
``decode_transfer_guard="disallow"`` (torch's process-wide sync debug
mode), a host tier over a disk tier, and reports whether the tier worker
tripped it. With ``--out PATH`` the figures go there as JSON.

It exits 1 without a CUDA device, and 2 when a gate fails.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def guard_probe(torch, ck, cs, card, net, wave_a, wave_b):
    """Waves A, B, C on a guarded, tiered server: the worker's copies must
    not trip the sync guard (a tripped call fails in the worker and shows
    as its last_error and as dropped spills or failed restores)."""
    with tempfile.TemporaryDirectory() as tdir:
        srv = cs.tier_server(net, host_cache_mb=cs.TIER_DISK_HOST_MB,
                             disk_cache_mb=cs.TIER_DISK_MB, tier_dir=tdir,
                             decode_transfer_guard="disallow")
        try:
            dec = srv.decoder
            toks_a, _ = cs.tier_wave(torch, ck, srv, wave_a)
            cs.tier_settle(dec)
            cs.tier_wave(torch, ck, srv, wave_b)
            cs.tier_settle(dec)
            toks_c, st = cs.tier_wave(torch, ck, srv, wave_a)
            cs.tier_settle(dec)
            out = {"tokens_identical": toks_c == toks_a,
                   "last_error": dec.tier.last_error,
                   "counters": cs.tier_counters(srv),
                   "restarts": srv.supervisor.restarts}
        finally:
            srv.stop()
    print(f"guard probe [{card}]: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="phase 28 of chip_smoke.py")
    ap.add_argument("--out", default=None, help="write the figures here")
    ap.add_argument("--only", default=None,
                    help="comma-separated sub-phases among a,b,c,d,f")
    ap.add_argument("--guard-probe", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase28_alone: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t00 = time.time()
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    _build.build_all(["paged_decode_attention"])
    _build.load("paged_decode_attention")
    out = {"card": card}
    rc = 0
    net = None
    if args.guard_probe or args.only:
        net = ComputationGraph(transformer_lm(
            vocab_size=cs.VOCAB, d_model=cs.D_MODEL, n_heads=cs.HEADS,
            n_blocks=cs.BLOCKS, rope=True, seed=7), device="cuda").init()
    wave_a, wave_b = cs.tier_waves(seed=28)
    if args.guard_probe:
        out["guard_probe"] = guard_probe(torch, ck, cs, card, net, wave_a,
                                         wave_b)
    if args.only:
        failures = []
        parts = set(args.only.split(","))
        if "a" in parts:
            out["fp32"] = cs.tier_host_run(torch, ck, card, net, wave_a,
                                           wave_b, None, failures)
        if "b" in parts:
            out["int8"] = cs.tier_host_run(torch, ck, card, net, wave_a,
                                           wave_b, "int8", failures)
        if "c" in parts:
            out["disk"] = cs.tier_disk_run(torch, ck, card, net, wave_a,
                                           wave_b, failures)
        if "d" in parts:
            out["faults"] = cs.tier_fault_run(torch, ck, card, net, wave_a,
                                              wave_b, failures)
        if "f" in parts:
            out["profiler"] = cs.profiler_overhead_run(
                torch, ck, card, net, wave_a, failures)
        out["failures"] = failures
        print(f"gates failed: {failures}", flush=True)
        rc = 2 if failures else 0
    else:
        del net
        try:
            out["phase28"] = cs.phase28(torch, ck, card)
        except SystemExit as e:
            print(e, flush=True)
            out["failed"], rc = str(e), 2
            out["phase28"] = cs.PHASE28_FIGURES
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)
    print(f"total {time.time() - t00:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
