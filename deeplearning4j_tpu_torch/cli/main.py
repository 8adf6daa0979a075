"""Command line — port of the ``train`` (local and data-parallel
runtimes), ``test``, ``predict``, ``serve``, ``telemetry`` and ``router``
commands of deeplearning4j_tpu/cli/main.py.

    python -m deeplearning4j_tpu_torch.cli.main train --conf net.json \
        --input data.csv --output model.zip [--epochs N] [--batch B] \
        [--label-index I] [--num-classes C] [--regression] \
        [--skip-lines K] [--print-every P] [--device cuda|cpu] \
        [--runtime local|data-parallel [--workers N]]
    python -m deeplearning4j_tpu_torch.cli.main test --model model.zip \
        --input data.csv [--batch B] [--label-index I] [--num-classes C] \
        [--skip-lines K] [--device cuda|cpu]
    python -m deeplearning4j_tpu_torch.cli.main predict --model model.zip \
        --input data.csv [--output preds.csv] [--batch B] \
        [--label-index I] [--skip-lines K] [--device cuda|cpu]
    python -m deeplearning4j_tpu_torch.cli.main serve --model model.zip \
        [--max-batch N] [--no-batching] [--batch-window-ms MS] \
        [--queue-size N] [--timeout-ms MS] [--trace-buffer N] \
        [--generate [--kv-pool-mb M] [--prefix-cache-mb M] [--kv-block 16] \
         [--decode-slots N] [--prefill-chunk C] [--kv-dtype int8] \
         [--paged-kernel on|off] [--decode-graphs on|off] \
         [--tp N [--tp-devices D,D]]] \
        [--no-supervise] [--hang-timeout S] [--retry-budget N] \
        [--failpoint NAME=SPEC ...] [--failpoint-endpoint] \
        [--device cuda|cpu] [--port P]
    python -m deeplearning4j_tpu_torch.cli.main telemetry \
        --targets URL,URL [--out trace.json] [--serve-port P] \
        [--interval S] [--duration S] [--clock-probes N]
    python -m deeplearning4j_tpu_torch.cli.main router \
        (--replicas URL,URL | --spawn N --model model.zip \
         [--replica-arg=ARG ...] [--device cuda|cpu] [--paged-kernel on|off]) \
        [--journal j.log] [--port P] [--quorum Q] [--kv-block 16] \
        [--affinity-blocks K] [--no-admission] [--no-prefix-directory] \
        [--prefix-fetch]

The config JSON and the model zip are the shared formats (a JAX-written
config trains here, a zip written here restores in the JAX package, and
back). ``--device`` defaults to cuda and fails without a CUDA device.
``serve`` answers /predict for any zip and, with ``--generate``,
/generate through the supervised decode engine, for a transformer LM
graph or a recurrent MultiLayerNetwork such as the char-RNN (the
vocabulary is the output layer's width unless ``--vocab-size`` is given);
``test`` prints the
``Evaluation.stats()`` of a saved MultiLayerNetwork on labelled CSV
records. ``train --runtime data-parallel`` trains through
`parallel.trainer.IciDataParallelTrainingMaster`; ``serve --tp N
--decode-graphs off`` decodes tensor-parallel over N ranks
(`inference/sharding.py`). ``telemetry`` tails N servers' traces into one
Perfetto waterfall and federates their metrics (`serving/telemetry.py`;
``--ui`` raises NotImplementedError until the training UI is ported);
``router`` fronts N replica processes with the journaled, prefix-affine
router (`serving/router.py`), spawning them on ``--device`` (cuda by
default: no card fails before any replica starts) with ``--spawn``.
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
    if args.runtime == "data-parallel":
        # JAX cli/main.py :74: the ICI master over every card (or
        # --workers ranks; --device cpu: CPU ranks)
        from ..parallel.mesh import default_mesh
        from ..parallel.trainer import IciDataParallelTrainingMaster
        n = args.workers or None
        devices = (["cpu"] * (n or 1) if net.device.type == "cpu"
                   else None)
        master = IciDataParallelTrainingMaster(
            mesh=default_mesh(n, devices))
        try:
            master.execute_training(net, iterator)
        finally:
            master.close()
    else:
        net.fit(iterator)
    write_model(net, args.output)
    print(f"Model saved to {args.output} (final score {net.score_:.6f})")
    return 0


def cmd_test(args) -> int:
    """Evaluate a saved MultiLayerNetwork on CSV records and print
    ``stats()`` (JAX cli/main.py :84)."""
    from ..util.model_serializer import restore_multi_layer_network
    net = restore_multi_layer_network(args.model, device=args.device)
    print(net.evaluate(_build_iterator(args)).stats())
    return 0


def cmd_predict(args) -> int:
    """Predicted classes of CSV records (JAX cli/main.py:93)."""
    from ..util.model_serializer import restore_multi_layer_network
    net = restore_multi_layer_network(args.model, device=args.device)
    preds = []
    for ds in _build_iterator(args):
        preds.extend(net.predict(ds.features).tolist())
    if args.output:
        Path(args.output).write_text("\n".join(str(p) for p in preds) + "\n")
        print(f"{len(preds)} predictions written to {args.output}")
    else:
        for p in preds:
            print(p)
    return 0


def cmd_serve(args) -> int:
    from ..inference import failpoints
    from ..serving.server import InferenceServer
    # chaos seams: --failpoint flags, then the environment
    # (DL4J_FAILPOINTS="name=spec;..."), both through the same parser, so
    # a typo'd seam or spec fails startup loudly
    armed = []
    for entry in args.failpoint or []:
        name, sep, spec = entry.partition("=")
        if not sep:
            print(f"error: bad --failpoint {entry!r} (want name=spec)",
                  file=sys.stderr)
            return 2
        failpoints.arm(name.strip(), spec.strip())
        armed.append(name.strip())
    armed += failpoints.arm_from_env()
    if args.tp > 1 and args.decode_graphs != "off":
        print(f"error: serve --tp {args.tp} needs --decode-graphs off: the "
              "tensor-parallel step runs eagerly (a gloo collective cannot "
              "sit in a captured CUDA graph; a captured tp step under NCCL "
              "is ROADMAP A7.2.6)", file=sys.stderr)
        return 2
    net = None
    vocab = args.vocab_size if args.generate else 0
    if args.int8:
        # the int8 program of a quantized artifact (nn/quantization
        # save_quantized or save_quantized_graph), JAX cli/main.py :161
        from ..nn.quantization import is_quantized_artifact, load_quantized
        from ..util.device import resolve_device
        dev = resolve_device(args.device)
        if not is_quantized_artifact(args.model):
            print("error: --int8 needs a quantized artifact "
                  "(nn.quantization.save_quantized or "
                  "save_quantized_graph)", file=sys.stderr)
            return 2
        net = load_quantized(args.model, device=dev)
        if args.generate and not hasattr(net.conf, "vertices"):
            # the decode engine drives graph decode (KV caches); a
            # multilayer QuantizedNetwork has none
            print("error: --int8 --generate needs a quantized "
                  "ComputationGraph artifact (nn.quantization."
                  "save_quantized_graph); this zip holds a multilayer one",
                  file=sys.stderr)
            return 2
    if args.generate and vocab is None:
        # the next-token head's width is the vocabulary (JAX cli/main.py
        # :187): a graph's output vertex, a MultiLayerNetwork's last layer
        from ..util.device import resolve_device
        from ..util.model_serializer import restore_model
        # the device first, as the server does: no card raises before
        # the zip is read
        if net is None:
            net = restore_model(args.model,
                                device=resolve_device(args.device))
        if hasattr(net.conf, "vertices"):
            out = net.conf.network_outputs[0]
            vocab = int(net.conf.vertices[out].layer.n_out)
        else:
            vocab = int(net.conf.layers[-1].n_out)
    server = InferenceServer(
        net=net, model_path=None if net is not None else args.model,
        port=args.port, host=args.host,
        max_batch=args.max_batch, batching=not args.no_batching,
        batch_window_ms=args.batch_window_ms, max_queue=args.queue_size,
        default_timeout_ms=args.timeout_ms,
        decode_vocab=vocab,
        decode_slots=args.decode_slots, prefill_chunk=args.prefill_chunk,
        prefix_cache_mb=args.prefix_cache_mb,
        kv_block=args.kv_block, kv_pool_mb=args.kv_pool_mb,
        kv_dtype=args.kv_dtype, paged_kernel=args.paged_kernel,
        decode_graphs=args.decode_graphs, trace_buffer=args.trace_buffer,
        supervise=not args.no_supervise, hang_timeout_s=args.hang_timeout,
        retry_budget=args.retry_budget, mask_rows=args.mask_rows,
        speculate=args.speculate, draft_blocks=args.draft_blocks or None,
        host_cache_mb=args.host_cache_mb, disk_cache_mb=args.disk_cache_mb,
        tier_dir=args.tier_dir, slo_p99_ms=args.slo_p99_ms,
        failpoint_endpoint=args.failpoint_endpoint,
        decode_tp=args.tp if args.generate else 0,
        decode_tp_devices=(args.tp_devices.split(",")
                           if args.tp_devices else None),
        device=args.device).start()
    batch_mode = ("lock-serialized" if args.no_batching else
                  f"micro-batched, window {args.batch_window_ms}ms, "
                  f"queue {args.queue_size}")
    dec = server.decoder
    gen_mode = ""
    if dec is not None:
        if dec.paged:
            kv = (f"paged KV pool {args.kv_pool_mb}MB ({dec.pool.capacity_blocks}"
                  f" blocks of {dec.kv_block}"
                  f"{', int8 KV' if dec.kv_dtype else ''}), decode kernel "
                  f"{dec.paged_kernel}")
        elif dec.recurrent:
            kv = "recurrent h/c rows"
        else:
            kv = (f"contiguous KV ({dec._cache_cap} positions a slot"
                  + (f", prefix pool {args.prefix_cache_mb}MB "
                     f"({dec.pool.capacity_blocks} blocks of {dec.kv_block})"
                     if dec.pool else "") + ")")
        if dec.tier is not None:
            kv += (f", host tier {args.host_cache_mb}MB"
                   + (f" + disk {args.disk_cache_mb}MB"
                      if args.disk_cache_mb else ""))
        if dec.speculate:
            # the engine's armed state, not the flag: an engine that
            # cannot speculate warns and runs unarmed
            kv += (f", speculative x{dec.speculate} ("
                   + (f"shallow-exit draft, {dec.draft_blocks} blocks"
                      if dec.draft_blocks else "draft net") + ")")
        if dec.tp > 1:
            # the ENGINE's tp in force (it disables tp with a warning
            # where the heads do not divide), not the flag
            topo = dec.mesh_topology()
            kv += (f", tensor-parallel over {dec.tp} ranks "
                   f"({','.join(topo['device_list'])}; {topo['backend']}; "
                   "heads/FFN split, KV pool head-split, per-rank budgets, "
                   "eager steps)")
        if getattr(server.net, "_quantized_vertices", None):
            kv += (f", int8 graph ({len(server.net._quantized_vertices)} "
                   "quantized vertices)")
        gen_mode = (f"; /generate: {dec.n_slots} slots, prefill chunk "
                    f"{dec.prefill_chunk}, {kv}, decode graphs "
                    f"{dec.decode_graphs} ({dec.decode_captures} captured),"
                    f" prefill graphs {dec.prefill_captures}, SSE streaming"
                    + (f", supervised (hang timeout {args.hang_timeout}s, "
                       f"retry budget {args.retry_budget})"
                       if not args.no_supervise else ", UNSUPERVISED"))
    chaos = f"; failpoints ARMED: {', '.join(armed)}" if armed else ""
    print(f"Serving {args.model} on http://{args.host}:{server.port} "
          f"(device {server.device}; /predict {batch_mode}{gen_mode}{chaos};"
          f" POST /predict, /predict/csv"
          + (", /generate" if dec is not None else "")
          + (", /admin/drain" if server.supervisor is not None else "")
          + "; GET /health, /healthz, /readyz, /info, /metrics, /trace"
          + (", /debug/engine" if dec is not None else "")
          + (", /prefix/directory, /prefix/block; POST /prefix/fetch"
             if dec is not None and dec.tier is not None else "") + ")",
          flush=True)
    if args.once:  # start, report, stop
        server.stop()
        return 0
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_telemetry(args) -> int:
    """The fleet telemetry plane (`serving/telemetry.py`)."""
    from ..serving import telemetry

    argv = ["--targets", args.targets,
            "--interval", str(args.interval),
            "--clock-probes", str(args.clock_probes)]
    if args.out:
        argv += ["--out", args.out]
    if args.serve_port is not None:
        argv += ["--serve-port", str(args.serve_port)]
    if args.duration is not None:
        argv += ["--duration", str(args.duration)]
    if args.ui:
        argv += ["--ui", args.ui]
    return telemetry.main(argv)


def cmd_router(args) -> int:
    """The fleet front end (`serving/router.py`): journaled,
    prefix-affine routing over N replica processes."""
    from ..serving import router

    argv = []
    if args.replicas:
        argv += ["--replicas", args.replicas]
    if args.spawn:
        argv += ["--spawn", str(args.spawn), "--device", args.device]
        rargs = (["--model", args.model] if args.model else [])
        rargs += list(args.replica_arg or [])
        # the = form: a forwarded fragment may itself start with --,
        # which argparse would otherwise read as the next option
        argv += [f"--replica-arg={ra}" for ra in rargs]
    if args.journal:
        argv += ["--journal", args.journal]
    argv += ["--port", str(args.port),
             "--kv-block", str(args.kv_block),
             "--affinity-blocks", str(args.affinity_blocks),
             "--quorum", str(args.quorum)]
    if args.paged_kernel is not None:
        argv += ["--paged-kernel", args.paged_kernel]
    if args.no_admission:
        argv += ["--no-admission"]
    if args.no_prefix_directory:
        argv += ["--no-prefix-directory"]
    if args.prefix_fetch:
        argv += ["--prefix-fetch"]
    return router.main(argv)


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", required=True, help="input CSV path")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--label-index", type=int, default=-1,
                   help="label column (-1 = last)")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--regression", action="store_true")
    p.add_argument("--skip-lines", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a CUDA device) or cpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dl4j-torch",
                                 description="deeplearning4j_tpu_torch CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train a MultiLayerNetwork from a JSON "
                                     "configuration on CSV records")
    t.add_argument("--conf", required=True,
                   help="MultiLayerConfiguration JSON")
    t.add_argument("--output", required=True, help="output model zip")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--print-every", type=int, default=10)
    t.add_argument("--runtime", choices=["local", "data-parallel"],
                   default="local",
                   help="data-parallel: IciDataParallelTrainingMaster, one "
                        "gradient all-reduce a step over the ranks")
    t.add_argument("--workers", type=int, default=0,
                   help="data-parallel ranks (default: every card; 1 with "
                        "--device cpu)")
    _add_data_args(t)
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("test", help="evaluate a saved MultiLayerNetwork")
    e.add_argument("--model", required=True, help="model zip")
    _add_data_args(e)
    e.set_defaults(fn=cmd_test)
    p = sub.add_parser("predict", help="predict classes with a saved "
                                       "MultiLayerNetwork")
    p.add_argument("--model", required=True, help="model zip")
    p.add_argument("--output", default=None,
                   help="write the predictions here (default: stdout)")
    _add_data_args(p)
    p.set_defaults(fn=cmd_predict)
    s = sub.add_parser("serve", help="serve a saved model over HTTP")
    s.add_argument("--model", required=True, help="model zip")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a CUDA device) or cpu")
    s.add_argument("--max-batch", type=int, default=1024,
                   help="rows per /predict batch")
    s.add_argument("--no-batching", action="store_true",
                   help="disable /predict micro-batching (the "
                        "lock-serialized direct path)")
    s.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="how long the collator waits for more requests "
                        "after the first arrival (latency/occupancy knob)")
    s.add_argument("--queue-size", type=int, default=256,
                   help="bounded /predict request queue; beyond it "
                        "requests get HTTP 503 (backpressure)")
    s.add_argument("--timeout-ms", type=float, default=None,
                   help="default per-request deadline (504 past it; "
                        "?timeout_ms= overrides per request)")
    s.add_argument("--generate", action="store_true",
                   help="serve POST /generate through the decode engine")
    s.add_argument("--vocab-size", type=int, default=None,
                   help="token space (default: the output layer's width)")
    s.add_argument("--decode-slots", type=int, default=4)
    s.add_argument("--prefill-chunk", type=int, default=64)
    s.add_argument("--kv-pool-mb", type=float, default=0.0,
                   help="byte budget (MiB) of the paged KV pool (0 = "
                        "contiguous per-slot caches)")
    s.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="byte budget (MiB) of the contiguous mode's prefix "
                        "KV pool: finished prompts' blocks are kept and "
                        "repeated prefixes restored instead of re-prefilled "
                        "(0 = disabled; the paged pool is its own)")
    s.add_argument("--kv-block", type=int, default=16)
    s.add_argument("--host-cache-mb", type=float, default=0.0,
                   help="KV tiering (paged only): evicted unreferenced "
                        "prefix blocks spill to a pinned host-RAM ring of "
                        "this budget (MiB) and promote back on the next hit "
                        "(0 = tiering off)")
    s.add_argument("--disk-cache-mb", type=float, default=0.0,
                   help="disk tier below the host ring: blocks the host "
                        "budget evicts land in CRC-framed files under "
                        "--tier-dir (needs --host-cache-mb)")
    s.add_argument("--tier-dir", default=None,
                   help="directory of the disk tier's block files "
                        "(default: a fresh temporary directory)")
    s.add_argument("--kv-dtype", choices=["int8"], default=None)
    s.add_argument("--paged-kernel", choices=["on", "off"], default="on",
                   help="on: decode attention through the CUDA kernel; "
                        "off: the layer's gather body")
    s.add_argument("--decode-graphs", choices=["on", "off"], default="on",
                   help="on: the decode step and the prefill chunks "
                        "captured into CUDA graphs (one per bucket), "
                        "replayed; off: eager")
    s.add_argument("--int8", action="store_true",
                   help="serve the int8 program of a quantized artifact "
                        "(nn.quantization.save_quantized for /predict, "
                        "save_quantized_graph for /generate too)")
    s.add_argument("--mask-rows", type=int, default=64,
                   help="device rows of the grammar mask table (row 0 the "
                        "admit-all row; <= 1 masks grammars on the host "
                        "only)")
    s.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                   help="speculative decoding: draft GAMMA tokens a slot "
                        "an iteration with a shallow-exit draft and verify "
                        "them in one forward; the tokens are those of "
                        "GAMMA=0 (0 = off)")
    s.add_argument("--draft-blocks", type=int, default=0, metavar="K",
                   help="transformer blocks the shallow-exit draft runs "
                        "before its exit through the output head (default: "
                        "half the model's blocks)")
    s.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel decode over N ranks (attention "
                        "heads and FFN split over a 'tp' mesh, KV pool "
                        "split by head, pool budgets per rank; rank 0 is "
                        "this process, the others spawned followers; needs "
                        "--decode-graphs off; composes with --speculate and "
                        "--host-cache-mb; 0/1 = one device)")
    s.add_argument("--tp-devices", default=None,
                   help="comma-separated device of each tp rank (default "
                        "cuda:0..N-1, or cpu ranks with --device cpu; "
                        "cuda:0,cuda:0 co-locates two ranks on one card "
                        "over gloo)")
    s.add_argument("--trace-buffer", type=int, default=8192,
                   help="span flight-recorder ring capacity (events) behind "
                        "the per-request timings and GET /trace; 0 "
                        "disables tracing")
    s.add_argument("--no-supervise", action="store_true",
                   help="run the decode engine without the crash-recovery "
                        "supervisor (no watchdog, no engine restarts, no "
                        "/readyz gating, no /admin/drain)")
    s.add_argument("--hang-timeout", type=float, default=5.0,
                   help="watchdog heartbeat staleness (seconds) that "
                        "declares the scheduler loop hung and restarts the "
                        "engine")
    s.add_argument("--slo-p99-ms", type=float, default=None,
                   help="p99 latency objective (ms): per-route percentiles "
                        "and fast/slow-window burn rates, and a sustained "
                        "burn escalates the degradation ladder beside "
                        "queue pressure (default: percentiles only)")
    s.add_argument("--retry-budget", type=int, default=3,
                   help="submissions allowed per request across engine "
                        "crashes before it fails with a structured 503")
    s.add_argument("--failpoint", action="append", metavar="NAME=SPEC",
                   help="arm a chaos seam, e.g. dispatch.decode=crash@n:3 "
                        "(repeatable; see inference/failpoints.py)")
    s.add_argument("--failpoint-endpoint", action="store_true",
                   help="TEST ONLY: expose POST /admin/failpoints so "
                        "clients can arm and disarm chaos seams over HTTP")
    s.add_argument("--once", action="store_true",
                   help="start, print the banner, stop")
    s.set_defaults(fn=cmd_serve)
    f = sub.add_parser("telemetry",
                       help="fleet telemetry: merge N servers' traces into "
                            "one Perfetto waterfall and federate their "
                            "metrics and SLO")
    f.add_argument("--targets", required=True,
                   help="comma-separated server base URLs")
    f.add_argument("--out", default=None,
                   help="write the merged Perfetto trace here at exit")
    f.add_argument("--serve-port", type=int, default=None,
                   help="expose GET /fleet, /fleet/summary, /fleet/trace")
    f.add_argument("--interval", type=float, default=1.0,
                   help="poll/scrape cadence, seconds")
    f.add_argument("--duration", type=float, default=None,
                   help="run this long then exit")
    f.add_argument("--clock-probes", type=int, default=5,
                   help="RTT-bounded /trace/clock probes per server")
    f.add_argument("--ui", default=None,
                   help="training-UI base URL for the /serving fleet line "
                        "(not ported yet: raises NotImplementedError)")
    f.set_defaults(fn=cmd_telemetry)
    r = sub.add_parser("router",
                       help="fleet front end: journaled, prefix-affine "
                            "routing over N engine replica processes")
    r.add_argument("--replicas", default=None,
                   help="attach to running replicas (comma-separated base "
                        "URLs)")
    r.add_argument("--spawn", type=int, default=0,
                   help="spawn N replica subprocesses serving --model")
    r.add_argument("--model", default=None,
                   help="model zip every spawned replica serves")
    r.add_argument("--device", default="cuda",
                   help="the spawned replicas' device: cuda (default; fails "
                        "without a CUDA device) or cpu")
    r.add_argument("--replica-arg", action="append", default=[],
                   help="extra argv forwarded to every spawned replica "
                        "(repeatable; see python -m "
                        "deeplearning4j_tpu_torch.serving.replica --help)")
    r.add_argument("--journal", default=None,
                   help="durable request-journal path (a SIGKILLed router "
                        "replays in-flight requests from it)")
    r.add_argument("--port", type=int, default=0)
    r.add_argument("--quorum", type=int, default=1,
                   help="/readyz answers 200 only with >= this many ready "
                        "replicas")
    r.add_argument("--kv-block", type=int, default=16,
                   help="the replicas' KV block size (the affinity hash "
                        "aligns to it)")
    r.add_argument("--paged-kernel", choices=["on", "off"], default=None,
                   help="the paged decode kernel's mode forwarded to every "
                        "spawned replica (replicas default to 'on')")
    r.add_argument("--affinity-blocks", type=int, default=1,
                   help="how many leading prompt blocks the affinity hash "
                        "covers")
    r.add_argument("--no-admission", action="store_true",
                   help="disable SLO-aware admission (route even while the "
                        "fleet burns)")
    r.add_argument("--no-prefix-directory", action="store_true",
                   help="stop tailing replica /prefix/directory feeds "
                        "(affinity-only routing)")
    r.add_argument("--prefix-fetch", action="store_true",
                   help="keep rendezvous placement and have the target pull "
                        "tiered prefix chains from the holding peer instead "
                        "of re-routing to it")
    r.set_defaults(fn=cmd_router)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
