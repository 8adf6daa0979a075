"""The runtime resource ledger — a port of the ledger half of
deeplearning4j_tpu/analysis/runtime.py (`ResourceLedger` :486,
`ledger_note` :596, `ledger_check_request` :609, `ledger_check_zero`
:619, `ledger_forget` :629, `resource_ledger` :640).

Subsystems note every acquire and release of an owned resource at its
seam, keyed by an id (`ledger_note(kind, key, +1 / -1)`); a test arms a
ledger for its duration (``with resource_ledger() as led:``) and judges
it at the end (``led.assert_clean()``): every balance zero, no release
without an acquire. A request's end asserts its own kinds zero for its key
(`ledger_check_request`: the fleet router's journal record at the end of
each ``/generate``), stop paths assert their own kinds zero everywhere
(`ledger_check_zero`), and a fenced engine or a router that inherits a
crashed predecessor's journal disowns what it held (`ledger_forget`).

Disarmed, a seam costs one module-level dict emptiness test, as in the
JAX package, so the notes stay in the serving loop. The JAX ledger's
cross-check against graftlint's static lifecycle registry is not ported
with it: the linter and its registry stay in ROADMAP A9.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Set, Tuple

__all__ = ["ResourceLedger", "ledger_note", "ledger_check_request",
           "ledger_check_zero", "ledger_forget", "resource_ledger"]

_LEDGERS: Dict[int, "ResourceLedger"] = {}
_ledgers_lock = threading.Lock()


class ResourceLedger:
    """Balance sheet of (resource kind, key) acquisitions. ``note`` never
    raises on the noting thread: violations accumulate and the owning
    test calls :meth:`assert_clean` at the end."""

    def __init__(self):
        self._lock = threading.Lock()
        self._balances: Dict[Tuple[str, str], int] = {}
        self._kinds: Dict[str, List[int]] = {}  # kind -> [acquires, releases]
        self.violations: List[str] = []
        self._reported: Set[Tuple[str, str]] = set()

    def note(self, kind: str, key: str, delta: int) -> None:
        with self._lock:
            k = (kind, str(key))
            c = self._kinds.setdefault(kind, [0, 0])
            if delta > 0:
                c[0] += delta
            else:
                c[1] += -delta
            bal = self._balances.get(k, 0) + int(delta)
            if bal == 0:
                self._balances.pop(k, None)
                return
            self._balances[k] = bal
            if bal < 0 and k not in self._reported:
                self._reported.add(k)
                self.violations.append(
                    f"over-release: {kind} for {key!r} went to {bal} "
                    "(released more than acquired)")

    def check_request(self, key: str, kinds=None) -> None:
        """Request-end invariant: every balance of ``kinds`` (every kind
        when None) for ``key`` is zero. A nonzero balance is recorded as a
        violation and cleared, so a later stop does not report the same
        debt again. ``kinds`` keeps one owner from judging another's
        still-open balance for the same request id."""
        key = str(key)
        with self._lock:
            bad = [(k, b) for k, b in self._balances.items()
                   if k[1] == key and (kinds is None or k[0] in kinds)]
            for k, b in bad:
                self._balances.pop(k, None)
                if k not in self._reported:
                    self._reported.add(k)
                    self.violations.append(
                        f"leak at request end: {k[0]} balance {b:+d} "
                        f"for request {key!r}")

    def check_zero(self, scope: str, kinds=None) -> None:
        """Stop-time invariant: nothing of ``kinds`` (every kind when
        None) is left acquired anywhere."""
        with self._lock:
            for k, b in sorted(self._balances.items()):
                if kinds is not None and k[0] not in kinds:
                    continue
                self._balances.pop(k, None)
                if k not in self._reported:
                    self._reported.add(k)
                    self.violations.append(
                        f"leak at {scope}: {k[0]} balance {b:+d} for "
                        f"{k[1]!r}")

    def forget(self, key: str, kinds=None) -> None:
        """Disown ``key``'s balances without judging them (a fenced
        engine's state is dropped wholesale)."""
        key = str(key)
        with self._lock:
            for k in [k for k in self._balances
                      if k[1] == key and (kinds is None or k[0] in kinds)]:
                self._balances.pop(k, None)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """The open balances and, per kind, the acquires and releases
        noted so far."""
        with self._lock:
            return {
                "balances": {f"{k}:{key}": b for (k, key), b
                             in sorted(self._balances.items())},
                "kinds": {k: {"acquires": c[0], "releases": c[1]}
                          for k, c in sorted(self._kinds.items())},
            }

    def observed_kinds(self) -> Set[str]:
        with self._lock:
            return set(self._kinds)

    def assert_clean(self) -> None:
        """Zero balances and no recorded violation, or an AssertionError
        carrying the whole charge sheet."""
        with self._lock:
            self.violations.extend(
                f"unchecked residue: {k[0]} balance {b:+d} for {k[1]!r}"
                for k, b in sorted(self._balances.items()))
            self._balances.clear()
            charges = list(self.violations)
        if charges:
            raise AssertionError("resource ledger is not balanced:\n  "
                                 + "\n  ".join(charges))


def _armed() -> List[ResourceLedger]:
    with _ledgers_lock:
        return list(_LEDGERS.values())


def ledger_note(kind: str, key: str, delta: int) -> None:
    """The seam call; disarmed, one dict emptiness test."""
    if not _LEDGERS:
        return
    for led in _armed():
        led.note(kind, key, delta)


def ledger_check_request(key: str, kinds=None) -> None:
    """The request-end seam."""
    if not _LEDGERS:
        return
    for led in _armed():
        led.check_request(key, kinds)


def ledger_check_zero(scope: str, kinds=None) -> None:
    if not _LEDGERS:
        return
    for led in _armed():
        led.check_zero(scope, kinds)


def ledger_forget(key: str, kinds=None) -> None:
    if not _LEDGERS:
        return
    for led in _armed():
        led.forget(key, kinds)


@contextlib.contextmanager
def resource_ledger():
    """Arm a ResourceLedger for the duration of the context and yield
    it; ``led.assert_clean()`` judges it afterwards."""
    led = ResourceLedger()
    with _ledgers_lock:
        _LEDGERS[id(led)] = led
    try:
        yield led
    finally:
        with _ledgers_lock:
            _LEDGERS.pop(id(led), None)
