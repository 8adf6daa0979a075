"""Stalls of the whole process against the serving supervisor's watchdog,
on the CPU.

    python tools/stall_probe.py server [--stalls N] [--root TREE]
    python tools/stall_probe.py gc -- PYTEST_ARGS...

``server``: a supervised /generate server on a tiny port LM (the chaos
tests' settings: hang_timeout_s 1.0, watchdog poll 0.02 s) serves short
requests while the main thread holds the GIL in one C call (a sort of 12M
floats, about a second, as a full garbage collection holds it) N times;
prints each stall's seconds, the restarts the watchdog made and their
recorded causes (where TREE's supervisor records them; TREE defaults to
this checkout). A restart here is a false hang: the engine was never
stuck.

``gc``: runs pytest in this process with PYTEST_ARGS and prints the
longest garbage-collection pauses (seconds, generation, objects
collected) and the heap's object count when each test of
test_torch_chaos.py starts.
"""
import argparse
import gc
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def server(stalls: int, root: str) -> int:
    sys.path.insert(0, root)
    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    net = ComputationGraph(transformer_lm(vocab_size=13, d_model=16,
                                          n_heads=2, n_blocks=2, rope=True),
                           device="cpu").init()
    srv = InferenceServer(net=net, decode_slots=2, prefill_chunk=16,
                          hang_timeout_s=1.0, retry_budget=6,
                          decode_transfer_guard="disallow",
                          device="cpu").start()
    srv.supervisor.poll_interval_s = 0.02
    big = [float(i % 9973) for i in range(12_000_000)]

    def post(prompt):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": prompt, "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        post([1, 2, 3])
        secs = []
        for k in range(stalls):
            th = threading.Thread(
                target=lambda: [post([1, 2, 3, k]) for _ in range(3)])
            th.start()
            time.sleep(0.05)
            t = time.perf_counter()
            sorted(big)  # one C call: the GIL is held throughout
            secs.append(round(time.perf_counter() - t, 3))
            th.join()
            time.sleep(0.3)
        print(json.dumps({"stall_s": secs,
                          "restarts": srv.supervisor.restarts,
                          "causes": getattr(srv.supervisor, "restart_log",
                                            "not recorded")}))
    finally:
        srv.stop()
    return 0


def gc_pauses(pytest_args) -> int:
    import pytest
    sys.path.insert(0, str(ROOT))
    starts, pauses = {}, []

    def cb(phase, info):
        tid = threading.get_ident()
        if phase == "start":
            starts[tid] = time.perf_counter()
        else:
            dt = time.perf_counter() - starts.pop(tid, time.perf_counter())
            pauses.append((round(dt, 4), info["generation"],
                           info.get("collected")))

    class Heap:
        @staticmethod
        def pytest_runtest_setup(item):
            if "test_torch_chaos" in item.nodeid:
                print(f"\nheap objects at {item.name}: "
                      f"{len(gc.get_objects())}")

    gc.callbacks.append(cb)
    rc = pytest.main(list(pytest_args), plugins=[Heap()])
    gc.callbacks.remove(cb)
    print(json.dumps({"collections": len(pauses),
                      "longest": sorted(pauses)[-8:]}))
    return int(rc)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("server", "gc"))
    ap.add_argument("--stalls", type=int, default=6)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("pytest_args", nargs="*")
    a = ap.parse_args()
    if a.mode == "server":
        return server(a.stalls, a.root)
    return gc_pauses(a.pytest_args)


if __name__ == "__main__":
    sys.exit(main())
