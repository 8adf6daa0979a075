"""Command line — port of the ``serve --generate`` path of
deeplearning4j_tpu/cli/main.py.

    python -m deeplearning4j_tpu_torch.cli.main serve --model lm.zip \
        --generate --kv-pool-mb M --kv-block 16 --decode-slots N \
        --prefill-chunk C [--kv-dtype int8] [--paged-kernel on|off] \
        [--device cuda|cpu] [--port P]

The model zip is the shared format (a JAX-written zip serves as is).
``--device`` defaults to cuda and fails without a CUDA device. The
train/test/predict, telemetry and router commands come with later slices.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def cmd_serve(args) -> int:
    if not args.generate:
        print("error: the port serves /generate only (pass --generate); "
              "/predict comes with a later slice", file=sys.stderr)
        return 2
    from ..serving.server import InferenceServer
    server = InferenceServer(
        model_path=args.model, port=args.port, host=args.host,
        default_timeout_ms=args.timeout_ms, decode_vocab=args.vocab_size,
        decode_slots=args.decode_slots, prefill_chunk=args.prefill_chunk,
        decode_queue=args.queue_size, kv_block=args.kv_block,
        kv_pool_mb=args.kv_pool_mb, kv_dtype=args.kv_dtype,
        paged_kernel=args.paged_kernel, device=args.device).start()
    dec = server.decoder
    print(f"Serving {args.model} on http://{args.host}:{server.port} "
          f"(device {server.device}; /generate: {dec.n_slots} slots, "
          f"prefill chunk {dec.prefill_chunk}, paged KV pool "
          f"{args.kv_pool_mb}MB ({dec.pool.capacity_blocks} blocks of "
          f"{dec.kv_block}{', int8 KV' if dec.kv_dtype else ''}), decode "
          f"kernel {dec.paged_kernel}; GET /healthz, /info)", flush=True)
    if args.once:  # start, report, stop
        server.stop()
        return 0
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dl4j-torch",
                                 description="deeplearning4j_tpu_torch CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve a saved LM over HTTP")
    s.add_argument("--model", required=True, help="model zip")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a CUDA device) or cpu")
    s.add_argument("--generate", action="store_true",
                   help="serve POST /generate through the paged decode "
                        "engine")
    s.add_argument("--vocab-size", type=int, default=None,
                   help="token space (default: the output layer's width)")
    s.add_argument("--decode-slots", type=int, default=4)
    s.add_argument("--prefill-chunk", type=int, default=64)
    s.add_argument("--queue-size", type=int, default=64)
    s.add_argument("--timeout-ms", type=float, default=None)
    s.add_argument("--kv-pool-mb", type=float, required=True,
                   help="byte budget (MiB) of the paged KV pool")
    s.add_argument("--kv-block", type=int, default=16)
    s.add_argument("--kv-dtype", choices=["int8"], default=None)
    s.add_argument("--paged-kernel", choices=["on", "off"], default="on",
                   help="on: decode attention through the CUDA kernel; "
                        "off: the layer's gather body")
    s.add_argument("--once", action="store_true",
                   help="start, print the banner, stop")
    s.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
