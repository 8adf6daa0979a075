"""Command line — port of the ``train`` (local runtime) and ``serve
--generate`` paths of deeplearning4j_tpu/cli/main.py.

    python -m deeplearning4j_tpu_torch.cli.main train --conf net.json \
        --input data.csv --output model.zip [--epochs N] [--batch B] \
        [--label-index I] [--num-classes C] [--regression] \
        [--skip-lines K] [--print-every P] [--device cuda|cpu]
    python -m deeplearning4j_tpu_torch.cli.main serve --model lm.zip \
        --generate --kv-pool-mb M --kv-block 16 --decode-slots N \
        --prefill-chunk C [--kv-dtype int8] [--paged-kernel on|off] \
        [--device cuda|cpu] [--port P]

The config JSON and the model zip are the shared formats (a JAX-written
config trains here, a zip written here restores in the JAX package, and
back). ``--device`` defaults to cuda and fails without a CUDA device. The
test/predict, telemetry and router commands and the data-parallel
runtime come with later slices.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional


def _build_iterator(args):
    from ..datasets.records import CSVRecordReader, RecordReaderDataSetIterator
    reader = CSVRecordReader(skip_lines=args.skip_lines).initialize(args.input)
    return RecordReaderDataSetIterator(
        reader, batch_size=args.batch, label_index=args.label_index,
        num_classes=args.num_classes, regression=args.regression)


def cmd_train(args) -> int:
    from ..datasets.iterators import MultipleEpochsIterator
    from ..nn.conf.config import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    from ..optimize.listeners import ScoreIterationListener
    from ..util.model_serializer import write_model

    conf = MultiLayerConfiguration.from_json(Path(args.conf).read_text())
    net = MultiLayerNetwork(conf, device=args.device).init()
    net.set_listeners(ScoreIterationListener(args.print_every, log_fn=print))
    iterator = _build_iterator(args)
    if args.epochs > 1:
        iterator = MultipleEpochsIterator(args.epochs, iterator)
    net.fit(iterator)
    write_model(net, args.output)
    print(f"Model saved to {args.output} (final score {net.score_:.6f})")
    return 0


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
    t = sub.add_parser("train", help="train a MultiLayerNetwork from a JSON "
                                     "configuration on CSV records")
    t.add_argument("--conf", required=True,
                   help="MultiLayerConfiguration JSON")
    t.add_argument("--input", required=True, help="input CSV path")
    t.add_argument("--output", required=True, help="output model zip")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch", type=int, default=32)
    t.add_argument("--label-index", type=int, default=-1,
                   help="label column (-1 = last)")
    t.add_argument("--num-classes", type=int, default=None)
    t.add_argument("--regression", action="store_true")
    t.add_argument("--skip-lines", type=int, default=0)
    t.add_argument("--print-every", type=int, default=10)
    t.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a CUDA device) or cpu")
    t.set_defaults(fn=cmd_train)
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
