"""HTTP serving endpoint — a reduced port of deeplearning4j_tpu/serving/server.py.

`InferenceServer` loads a model (a port `ComputationGraph`, or a model
zip restored onto ``device``), runs a `DecodeScheduler` behind ``POST
/generate`` — contiguous per-slot stripes by default (``kv_pool_mb=0``,
with a side prefix pool of ``prefix_cache_mb``), or a paged pool of
``kv_pool_mb`` MiB — and answers on a stdlib ThreadingHTTPServer. The
server owns a `MetricsRegistry` and a span `FlightRecorder`
(``trace_buffer`` events; 0 disables recording) that the engine writes,
and calls the engine's `warmup()` before it answers, so the decode steps
are captured before any traffic.

Endpoints:
  GET  /healthz    liveness: {"status": "up"} (always 200)
  GET  /info       model summary, config JSON, device, engine (KV mode,
                   decode captures) and pool state
  POST /generate   {"prompt": [ids], "max_new_tokens": N, "temperature"?,
                   "top_k"?, "top_p"?, "seed"?, "eos_id"?} -> {"tokens":
                   [ids], "request_id", "finish_reason", "timings"};
                   ?timeout_ms=N (expiry cancels the decode -> 504); a
                   full queue -> 503; a prompt the pool cannot hold -> 413;
                   malformed input -> 400.

The supervisor, streaming (SSE), /predict, /metrics, /trace and the
admin endpoints of the JAX server come with later slices.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import torch

from ..inference.engine import (DecodeScheduler, PromptTooLongError,
                                QueueFullError)
from ..inference.metrics import MetricsRegistry
from ..inference.trace import FlightRecorder
from ..util.device import DeviceLike, resolve_device


class InferenceServer:
    def __init__(self, net=None, model_path: Union[str, Path, None] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 default_timeout_ms: Optional[float] = None,
                 decode_vocab: Optional[int] = None, decode_slots: int = 4,
                 prefill_chunk: int = 64, decode_queue: int = 64,
                 prefix_cache_mb: float = 0.0, kv_block: int = 16,
                 kv_pool_mb: float = 0.0, kv_dtype: Optional[str] = None,
                 paged_kernel: str = "on", decode_graphs: str = "on",
                 metrics: Optional[MetricsRegistry] = None,
                 trace_buffer: int = 8192,
                 tracer: Optional[FlightRecorder] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if net is None:
            if model_path is None:
                raise ValueError("pass a net or a model_path")
            from ..util.model_serializer import restore_model
            net = restore_model(model_path, device=self.device)
        self.net = net
        if decode_vocab is None:
            out = net.conf.network_outputs[0]
            decode_vocab = int(net.conf.vertices[out].layer.n_out)
        self.decode_vocab = int(decode_vocab)
        self.default_timeout_ms = default_timeout_ms
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else FlightRecorder(
            trace_buffer, enabled=trace_buffer > 0)
        self.decoder = DecodeScheduler(
            net, self.decode_vocab, n_slots=decode_slots,
            max_queue=decode_queue, prefill_chunk=prefill_chunk,
            prefix_cache_mb=prefix_cache_mb, kv_block=kv_block,
            kv_pool_mb=kv_pool_mb, kv_dtype=kv_dtype,
            paged_kernel=paged_kernel, decode_graphs=decode_graphs,
            metrics=self.metrics, tracer=self.tracer, device=self.device)
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def info(self) -> dict:
        dec = self.decoder
        dev = self.device
        return {"model": type(self.net).__name__,
                "config": json.loads(self.net.conf.to_json()),
                "params": self.net.num_params(),
                "device": {"type": dev.type,
                           "name": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu")},
                "decode": {"slots": dec.n_slots,
                           "prefill_chunk": dec.prefill_chunk,
                           "kv_mode": "paged" if dec.paged else "contiguous",
                           "kv_dtype": dec.kv_dtype,
                           "paged_kernel": dec.paged_kernel,
                           "decode_graphs": dec.decode_graphs,
                           "decode_captures": dec.decode_captures,
                           "pool": dec.pool.stats() if dec.pool else None}}

    def _generate(self, payload: dict, timeout_ms: Optional[float]) -> dict:
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ValueError("body must be a JSON object with a 'prompt'")
        kw = {k: payload[k] for k in ("temperature", "top_k", "top_p", "seed",
                                      "eos_id") if k in payload}
        prompt = [int(t) for t in payload["prompt"]]
        max_new = int(payload.get("max_new_tokens", 16))
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        timeout = timeout_ms / 1e3 if timeout_ms is not None else 120.0
        handle = self.decoder.generate_handle(prompt, max_new,
                                              timeout=timeout, **kw)
        return {"tokens": handle.tokens, "request_id": handle.request_id,
                "finish_reason": handle.finish_reason,
                "timings": handle.timings()}

    def start(self) -> "InferenceServer":
        server = self
        self.decoder.warmup()
        self.decoder.start()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send({"status": "up"})
                elif path == "/info":
                    self._send(server.info())
                else:
                    self._send({"error": f"unknown path {path}"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != "/generate":
                    return self._send({"error": f"unknown path {url.path}"},
                                      404)
                try:
                    q = parse_qs(url.query)
                    timeout_ms = (float(q["timeout_ms"][0])
                                  if "timeout_ms" in q else None)
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    self._send(server._generate(payload, timeout_ms))
                except PromptTooLongError as e:
                    self._send({"error": str(e),
                                "blocks_needed": e.blocks_needed,
                                "blocks_available": e.blocks_available}, 413)
                except QueueFullError as e:
                    self._send({"error": str(e)}, 503)
                except TimeoutError:
                    self._send({"error": "deadline exceeded"}, 504)
                except (ValueError, TypeError, KeyError) as e:
                    self._send({"error": str(e)}, 400)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.decoder.stop()
