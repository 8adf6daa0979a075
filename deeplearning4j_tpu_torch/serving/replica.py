"""Engine replica as a supervised OS **process** (the fleet's unit of
failure) — a port of deeplearning4j_tpu/serving/replica.py.

`inference/supervisor.py` recovers a crashed engine *within* one process:
watchdog, fence, rebuild, token-identical replay. This module carries the
same discipline across a process boundary, so the fleet router
(`serving/router.py`) can front N replicas and survive a replica *host*
dying, not just an engine thread:

  - the **subprocess entry point** (``python -m
    deeplearning4j_tpu_torch.serving.replica``) builds a model (a model
    zip through `restore_model`, an int8 artifact through
    `load_quantized` under ``--int8``, or the seeded zoo transformer LM —
    the seed makes every replica's params bit-identical, which is what
    makes fleet replay token-identical), arms any ``DL4J_FAILPOINTS``
    seams, starts a supervised :class:`serving.server.InferenceServer` on
    ``--device`` (cuda by default: no card raises; on the card every
    decode step launches the paged decode kernel unless ``--paged-kernel
    off``, and the server's ``warmup()`` captures the decode graphs
    before the port is announced), and announces its ephemeral port by
    atomically writing a JSON file the parent polls (the child binds
    port 0);
  - :class:`ReplicaProcess` is the parent-side handle: spawn, await
    readiness, probe ``/healthz``/``/readyz``, SIGKILL (chaos), SIGTERM
    (orderly), respawn;
  - :class:`ReplicaSupervisor` is the fleet-level watchdog: a probe
    thread restarts dead replicas with bounded exponential backoff,
    caches each replica's readiness for the router's quorum ``/readyz``,
    and fans draining restarts out through each replica's own ``POST
    /admin/drain``, one replica at a time, so the fleet never dips below
    quorum for a rolling restart.

The child's environment: ``PYTHONPATH`` leads with the repository root
(the child imports this package from any working directory),
``DL4J_FAILPOINTS`` is set for a child spawned with ``failpoints`` and
removed for every other one, and a ``--device cpu`` child runs torch on
one thread (``OMP_NUM_THREADS=1`` unless the caller set it, and
``torch.set_num_threads(1)`` in the entry point): several CPU replicas
share a few cores. No replica arms the decode transfer guard: the port's
guard is process-wide and the server reserves it for ``/generate``-only
traffic.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["ReplicaProcess", "ReplicaSupervisor", "lm_spec_argv",
           "write_announce", "main"]

# the directory holding the deeplearning4j_tpu_torch package: a spawned
# child finds the package through it wherever its working directory is
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _argv_device(argv: List[str]) -> str:
    """The ``--device`` a replica argv asks for (cuda when absent)."""
    dev = "cuda"
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            dev = argv[i + 1]
        elif a.startswith("--device="):
            dev = a.split("=", 1)[1]
    return dev.split(":")[0]


def write_announce(path: str, port: int, armed: List[str]) -> None:
    """Atomically publish a serving process's {port, pid, armed seams}
    (tmp + fsync + rename — the parent polling the file must never read
    a torn half-written port). Shared by the replica and router entry
    points so the announce format cannot diverge."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"port": port, "pid": os.getpid(),
                   "failpoints_armed": armed}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _get_json(url: str, timeout: float = 5.0) -> Tuple[int, dict]:
    """(status_code, parsed body) — 503 bodies parsed too (readyz
    carries its verdict in the body either way)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        finally:
            e.close()


def lm_spec_argv(vocab: int, d_model: int = 16, n_heads: int = 2,
                 n_blocks: int = 2, cache: int = 96, seed: int = 7,
                 n_kv_heads: Optional[int] = None) -> List[str]:
    """The ``--lm-*`` argv fragment that makes a replica build this
    seeded zoo LM (every replica spawned with the same fragment holds
    bit-identical params)."""
    argv = ["--lm-vocab", str(vocab), "--lm-d-model", str(d_model),
            "--lm-heads", str(n_heads), "--lm-blocks", str(n_blocks),
            "--lm-cache", str(cache), "--lm-seed", str(seed)]
    if n_kv_heads:
        argv += ["--lm-kv-heads", str(n_kv_heads)]
    return argv


class ReplicaProcess:
    """Parent-side handle on one replica subprocess.

    ``argv`` is everything after the module name (model spec + serving
    knobs — see :func:`main`); the handle adds ``--announce`` itself
    and learns the child's ephemeral port from the announce file. Not
    thread-safe on its own: the :class:`ReplicaSupervisor` serializes
    spawn/kill through its probe loop, and chaos tests kill from one
    thread."""

    restartable = True  # the supervisor may kill + respawn this process

    def __init__(self, argv: List[str], name: str = "r0",
                 workdir: Optional[str] = None,
                 failpoints: Optional[Dict[str, str]] = None,
                 env: Optional[Dict[str, str]] = None):
        self.argv = list(argv)
        self.name = name
        self.workdir = workdir or tempfile.mkdtemp(prefix="dl4j-replica-")
        self.failpoints = dict(failpoints or {})
        self.env_extra = dict(env or {})
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.generation = 0  # bumped per spawn: names the announce file
        self.log_path = os.path.join(self.workdir, f"{name}.log")

    @property
    def base_url(self) -> Optional[str]:
        return f"http://127.0.0.1:{self.port}" if self.port else None

    def child_env(self) -> Dict[str, str]:
        """The child's environment: this process's, the repository root
        first on ``PYTHONPATH``, ``DL4J_FAILPOINTS`` for this child's
        seams only, one torch thread for a CPU replica, then ``env``."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p and p != _REPO_ROOT])
        env.pop("DL4J_FAILPOINTS", None)
        if self.failpoints:
            env["DL4J_FAILPOINTS"] = ";".join(
                f"{k}={v}" for k, v in self.failpoints.items())
        if _argv_device(self.argv) == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
        env.update(self.env_extra)
        return env

    def _announce_path(self) -> str:
        return os.path.join(self.workdir,
                            f"{self.name}.g{self.generation}.json")

    def spawn(self) -> "ReplicaProcess":
        """Start (or restart) the subprocess. The previous incarnation's
        port is forgotten — the child binds a fresh ephemeral one."""
        self.generation += 1
        self.port = None
        cmd = [sys.executable, "-m",
               "deeplearning4j_tpu_torch.serving.replica",
               "--announce", self._announce_path(), *self.argv]
        log = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                         env=self.child_env())
        finally:
            log.close()  # the child holds its own descriptor
        return self

    def try_announce(self) -> bool:
        """Non-blocking announce read: learn the child's port if the
        announce file has landed (the supervisor's probe loop calls
        this each pass while a respawned replica boots — it must never
        block the loop the way :meth:`await_ready` would)."""
        if self.port is not None:
            return True
        try:
            with open(self._announce_path()) as fh:
                self.port = int(json.load(fh)["port"])
            return True
        except (OSError, ValueError, KeyError):
            return False

    def await_ready(self, timeout: float = 120.0) -> str:
        """Block until the child announced its port AND answers
        ``/readyz`` 200 (the supervised engine is warmed). Returns the
        base URL; raises with the log tail if the child died."""
        deadline = time.monotonic() + timeout
        path = self._announce_path()
        while self.port is None:
            if time.monotonic() > deadline:
                raise TimeoutError(self._fail_msg("never announced"))
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(self._fail_msg(
                    f"exited rc={self.proc.returncode} before announcing"))
            try:
                with open(path) as fh:
                    self.port = int(json.load(fh)["port"])
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)
        while True:
            try:
                code, _ = _get_json(self.base_url + "/readyz", timeout=5)
                if code == 200:
                    return self.base_url
            except (OSError, ValueError):
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(self._fail_msg("never became ready"))
            time.sleep(0.05)

    def _fail_msg(self, what: str) -> str:
        tail = ""
        try:
            with open(self.log_path, "rb") as fh:
                tail = fh.read()[-2000:].decode(errors="replace")
        except OSError:
            pass
        return f"replica {self.name} {what}\n--- log tail ---\n{tail}"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the chaos action: no cleanup, no drain, the
        replica-host-crash failure mode."""
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=30)
            except OSError:
                pass

    def terminate(self, timeout: float = 30.0, wait: bool = True) -> None:
        """Orderly SIGTERM (the entry point stops its server and exits
        0); escalates to SIGKILL when it does not die in time.
        ``wait=False`` only sends the signal (a fleet stops all its
        replicas at once, then waits for each)."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                return
        if not wait:
            return
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()


class ReplicaSupervisor:
    """Fleet-level watchdog over N :class:`ReplicaProcess` — the
    cross-process analog of `inference/supervisor.py`'s engine
    supervisor.

    A probe thread polls each replica: a dead process (or one whose
    ``/healthz`` stops answering for ``unhealthy_kills`` consecutive
    probes) is SIGKILLed and respawned with bounded exponential backoff
    (``backoff_base_s * 2**streak``, capped; the streak resets after
    ``healthy_reset_s`` of continuous readiness). Each probe caches the
    replica's ``/readyz`` verdict, which is what the router's quorum
    aggregation and affinity candidate set read — routing decisions
    never wait on a probe RPC."""

    def __init__(self, replicas: List[ReplicaProcess],
                 poll_interval_s: float = 0.25,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 10.0,
                 healthy_reset_s: float = 10.0, unhealthy_kills: int = 3,
                 probe_timeout_s: float = 2.0,
                 boot_timeout_s: float = 240.0, metrics=None):
        self.replicas = list(replicas)
        self.poll_interval_s = float(poll_interval_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.healthy_reset_s = float(healthy_reset_s)
        self.unhealthy_kills = int(unhealthy_kills)
        self.probe_timeout_s = float(probe_timeout_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self.restarts = 0
        self._lock = threading.Lock()
        # name -> cached probe verdict {"ready", "alive", "url", ...};
        # REBOUND whole each probe pass (readers snapshot the ref)
        self._states: Dict[str, dict] = {}
        self._streak: Dict[str, int] = {r.name: 0 for r in replicas}
        self._ready_since: Dict[str, float] = {}
        self._unhealthy: Dict[str, int] = {r.name: 0 for r in replicas}
        self._next_spawn: Dict[str, float] = {r.name: 0.0 for r in replicas}
        # boot grace: a just-(re)spawned replica pays a torch import,
        # the model build and the graph captures of warmup before it can
        # even announce a port — that window is
        # "starting", not "unhealthy", or the watchdog would kill every
        # boot at unhealthy_kills consecutive probes and respawn-loop
        self._boot_deadline: Dict[str, float] = {}
        self.probe_error: Optional[str] = None  # last probe-pass failure
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics = metrics
        if metrics is not None:
            self._g_up = metrics.gauge(
                "fleet_replicas_up",
                help="replicas currently answering /readyz 200")
            self._c_restarts = metrics.counter(
                "fleet_replica_restarts_total",
                help="replica subprocesses respawned by the fleet "
                     "supervisor")
        else:
            self._g_up = self._c_restarts = None

    def start(self, wait: bool = True) -> "ReplicaSupervisor":
        """``wait=False`` skips the blocking readiness barrier: quorum
        fleets must come up even when a MINORITY of replicas is down
        (the router's /readyz reports the shortfall; the probe loop
        restarts what it can)."""
        now = time.monotonic()
        for r in self.replicas:
            if r.proc is None:
                r.spawn()
                self._boot_deadline[r.name] = now + self.boot_timeout_s
        if wait:
            for r in self.replicas:
                r.await_ready()
        self._probe_pass()  # routing state is live before start returns
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="replica-supervisor")
        self._thread.start()
        return self

    # -- probe loop --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._probe_pass()
            except Exception as e:  # a wedged pass must not silently
                # kill the fleet watchdog; the error is kept for the
                # router's /readyz body
                with self._lock:
                    self.probe_error = repr(e)

    def _probe_one(self, r: ReplicaProcess) -> dict:
        """One replica's probe verdict (network, NO locks held)."""
        state = {"name": r.name, "url": r.base_url, "alive": r.alive(),
                 "ready": False, "generation": r.generation}
        if not state["alive"]:
            state["reason"] = "process_dead"
            return state
        if r.port is None:
            if not r.try_announce():
                # booting (imports / warmup): not probeable yet, and
                # not evidence of ill health until the boot deadline
                state["starting"] = True
                state["reason"] = "booting (no port announced yet)"
                return state
            state["url"] = r.base_url
        try:
            code, body = _get_json(r.base_url + "/readyz",
                                   timeout=self.probe_timeout_s)
            state["ready"] = code == 200
            state["status"] = body
            state["healthy"] = True
        except Exception as e:  # probe failed: unreachable counts as
            # unhealthy (repeated -> restart), and the error is the
            # operator-visible reason in /readyz's per-replica block
            state["healthy"] = False
            state["reason"] = repr(e)
        return state

    def _probe_pass(self) -> None:
        now = time.monotonic()
        probed = {r.name: self._probe_one(r) for r in list(self.replicas)}
        respawn: List[ReplicaProcess] = []
        with self._lock:
            for r in self.replicas:
                st = probed[r.name]
                if st.get("starting"):
                    # boot window: benign until the deadline, then the
                    # boot itself is declared hung (kill + respawn)
                    deadline = self._boot_deadline.setdefault(
                        r.name, now + self.boot_timeout_s)
                    self._unhealthy[r.name] = (
                        self.unhealthy_kills if now >= deadline else 0)
                elif st["alive"] and st.get("healthy", False):
                    self._unhealthy[r.name] = 0
                else:
                    self._unhealthy[r.name] += 1
                if st["ready"]:
                    since = self._ready_since.setdefault(r.name, now)
                    if now - since >= self.healthy_reset_s:
                        self._streak[r.name] = 0
                else:
                    self._ready_since.pop(r.name, None)
                dead = (not st["alive"]
                        or self._unhealthy[r.name] >= self.unhealthy_kills)
                if dead and getattr(r, "restartable", False) \
                        and now >= self._next_spawn[r.name]:
                    streak = self._streak[r.name]
                    self._next_spawn[r.name] = now + min(
                        self.backoff_max_s,
                        self.backoff_base_s * (2 ** streak))
                    self._streak[r.name] = streak + 1
                    st["restarting"] = True
                    respawn.append(r)
            self._states = probed
        for r in respawn:  # spawn OUTSIDE the lock (slow: fork+exec)
            r.kill()  # reap a zombie / put down an unresponsive child
            r.spawn()
            with self._lock:
                self.restarts += 1
                self._unhealthy[r.name] = 0
                self._boot_deadline[r.name] = (time.monotonic()
                                               + self.boot_timeout_s)
            if self._c_restarts is not None:
                self._c_restarts.inc()
        if self._g_up is not None:
            self._g_up.set(sum(1 for s in probed.values() if s["ready"]))

    # -- the router's read surface -----------------------------------------
    def states(self) -> Dict[str, dict]:
        with self._lock:
            return self._states  # rebound-whole dict: safe to iterate

    def ready_replicas(self) -> List[Tuple[str, str]]:
        """(name, base_url) of every replica whose last probe was ready
        — the affinity candidate set."""
        with self._lock:
            states = self._states
        return [(n, s["url"]) for n, s in sorted(states.items())
                if s.get("ready") and s.get("url")]

    def ready_count(self) -> int:
        return len(self.ready_replicas())

    # -- draining restarts --------------------------------------------------
    def drain(self, name: str, timeout: float = 120.0) -> bool:
        """One replica's draining restart via its own supervisor's
        ``POST /admin/drain``: finish in-flight, swap a warmed engine,
        come back ready. Returns True when the replica is ready again."""
        r = next((x for x in self.replicas if x.name == name), None)
        if r is None or not r.base_url:
            return False
        try:
            req = urllib.request.Request(r.base_url + "/admin/drain",
                                         data=b"{}", method="POST")
            with urllib.request.urlopen(
                    req, timeout=self.probe_timeout_s) as resp:
                resp.read()
        except (OSError, urllib.error.URLError):
            return False
        t0 = time.monotonic()
        deadline = t0 + timeout
        observed = False
        while time.monotonic() < deadline:
            try:
                code, body = _get_json(r.base_url + "/readyz", timeout=5)
            except Exception:
                code, body = 0, {}
            if code != 200 or body.get("draining"):
                observed = True  # inside the drain window
            elif observed or time.monotonic() - t0 > 1.0:
                # ready again after the observed window — or the drain
                # was faster than our probe cadence (idle engine): a 1 s
                # grace bounds how long we can falsely report "done"
                return True
            time.sleep(0.05)
        return False

    def rolling_drain(self, timeout_each: float = 120.0) -> List[str]:
        """Drain every replica, one at a time (the fleet never loses
        more than one replica's capacity). Returns the names that
        completed."""
        done = []
        for r in list(self.replicas):
            if self.drain(r.name, timeout=timeout_each):
                # settle: wait for the CACHED probe state (what quorum
                # reads) to agree the replica is back before taking the
                # next one down — direct-probe readiness can lead the
                # cache by a poll interval, and overlapping that window
                # with the next drain would transiently break quorum
                deadline = time.monotonic() + timeout_each
                while time.monotonic() < deadline:
                    with self._lock:
                        st = self._states.get(r.name)
                    if st is not None and st.get("ready"):
                        break
                    time.sleep(max(0.02, self.poll_interval_s / 2))
                done.append(r.name)
        return done

    def stop(self, terminate: bool = True) -> None:
        """``terminate=False`` stops only the probe loop and leaves the
        replica processes running (hand-off shape: a caller swaps
        supervisors over one live fleet)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if terminate:
            # signal every replica first: their shutdowns overlap
            for r in self.replicas:
                r.terminate(wait=False)
            for r in self.replicas:
                r.terminate()


# -- subprocess entry point --------------------------------------------------

def _build_net(args, device):
    """The replica's model on ``device``: a model zip, an int8 artifact
    (``--int8``), or the seeded zoo LM (identical across replicas by
    construction)."""
    if args.model:
        if args.int8:
            from ..nn.quantization import load_quantized
            return load_quantized(args.model, device=device)
        from ..util.model_serializer import restore_model
        return restore_model(args.model, device=device)
    from ..models.zoo import transformer_lm
    from ..nn.graph import ComputationGraph
    conf = transformer_lm(vocab_size=args.lm_vocab, d_model=args.lm_d_model,
                          n_heads=args.lm_heads, n_blocks=args.lm_blocks,
                          rope=True, seed=args.lm_seed,
                          n_kv_heads=args.lm_kv_heads)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = args.lm_cache
    return ComputationGraph(conf, device=device).init()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.replica",
        description="one supervised engine replica process (fleet tier)")
    ap.add_argument("--announce", required=True,
                    help="JSON file to write {port, pid} into once "
                         "serving (written atomically)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or "
                         "cpu")
    ap.add_argument("--model", default=None, help="model zip to serve")
    ap.add_argument("--int8", action="store_true",
                    help="--model is a quantized artifact: serve its int8 "
                         "program")
    ap.add_argument("--lm-vocab", type=int, default=32,
                    help="no --model: build the seeded zoo transformer LM")
    ap.add_argument("--lm-d-model", type=int, default=16)
    ap.add_argument("--lm-heads", type=int, default=2)
    ap.add_argument("--lm-kv-heads", type=int, default=None)
    ap.add_argument("--lm-blocks", type=int, default=2)
    ap.add_argument("--lm-cache", type=int, default=96)
    ap.add_argument("--lm-seed", type=int, default=7)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--kv-pool-mb", type=float, default=0.0)
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0)
    ap.add_argument("--kv-dtype", choices=["int8"], default=None)
    ap.add_argument("--paged-kernel", choices=["on", "off"], default="on",
                    help="on: paged decode attention through the CUDA "
                         "kernel (the gather body on a CPU replica); off: "
                         "the layer's gather body")
    ap.add_argument("--decode-graphs", choices=["on", "off"], default="on",
                    help="on: decode steps and prefill chunks captured "
                         "into CUDA graphs in warmup(); off: eager")
    ap.add_argument("--host-cache-mb", type=float, default=0.0,
                    help="pinned host-RAM KV spill ring (0 disables)")
    ap.add_argument("--disk-cache-mb", type=float, default=0.0,
                    help="durable disk tier below the host ring")
    ap.add_argument("--tier-dir", default=None,
                    help="directory for disk-tier block files "
                         "(default: fresh tempdir)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel decode over N ranks (needs "
                         "--decode-graphs off)")
    ap.add_argument("--tp-devices", default=None,
                    help="comma-separated device of each tp rank")
    ap.add_argument("--slo-p99-ms", type=float, default=None)
    ap.add_argument("--hang-timeout", type=float, default=5.0)
    ap.add_argument("--retry-budget", type=int, default=6)
    ap.add_argument("--trace-buffer", type=int, default=8192)
    ap.add_argument("--failpoint-endpoint", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ..inference import failpoints
    from ..util.device import resolve_device
    from .server import InferenceServer

    device = resolve_device(args.device)  # no card: raises here
    if device.type == "cpu":
        torch.set_num_threads(1)
    armed = failpoints.arm_from_env()  # fleet chaos arms seams HERE
    net = _build_net(args, device)
    if hasattr(net.conf, "vertices"):
        out = net.conf.network_outputs[0]
        vocab = int(net.conf.vertices[out].layer.n_out)
    else:
        vocab = int(net.conf.layers[-1].n_out)
    srv = InferenceServer(
        net=net, port=args.port, decode_vocab=vocab,
        decode_slots=args.slots, prefill_chunk=args.prefill_chunk,
        kv_block=args.kv_block, kv_pool_mb=args.kv_pool_mb,
        prefix_cache_mb=args.prefix_cache_mb, kv_dtype=args.kv_dtype,
        paged_kernel=args.paged_kernel, decode_graphs=args.decode_graphs,
        host_cache_mb=args.host_cache_mb,
        disk_cache_mb=args.disk_cache_mb, tier_dir=args.tier_dir,
        decode_tp=args.tp,
        decode_tp_devices=(args.tp_devices.split(",")
                           if args.tp_devices else None),
        slo_p99_ms=args.slo_p99_ms,
        hang_timeout_s=args.hang_timeout, retry_budget=args.retry_budget,
        trace_buffer=args.trace_buffer,
        failpoint_endpoint=args.failpoint_endpoint,
        device=device).start()

    stop = threading.Event()

    def _term(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    write_announce(args.announce, srv.port, armed)
    print(f"replica pid={os.getpid()} serving on http://127.0.0.1:"
          f"{srv.port} (device {device})"
          + (f" (failpoints armed: {', '.join(armed)})" if armed else ""),
          flush=True)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
