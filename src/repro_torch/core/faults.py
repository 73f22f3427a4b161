"""Deterministic, seeded fault injection for the serving stack.

The twin of ``repro/core/faults.py``: the same classes, scripting methods,
sites and coins, so that a seed poisons the same requests in both
packages.

Chaos testing the scheduler/executor split needs *reproducible* failures:
the same seed must poison the same graphs, kill the same executor after
the same number of dispatches, and stall the same transfers, run after
run. A ``FaultInjector`` therefore never draws from a shared RNG stream
(thread interleaving would reorder the draws); every decision is an
independent coin keyed by ``(seed, fault kind, stable identity)``:

  * per-graph faults (poison dispatch, NaN output, submit-time OOM) key on
    the engine request id: a graph is poisoned or it is not, regardless
    of which batch, executor, or retry attempt it rides in;
  * per-executor faults (worker crash) key on ``(executor index, nth
    dispatch on that executor)``;
  * per-batch faults (transfer stall) key on the first request id in the
    batch.

The injector plugs into ``GraphStreamEngine(fault_injector=...)``, which
wires it into its submit path and into each ``DeviceExecutor``'s
dispatch/complete sites (the executor takes an opaque ``fault_hook``
callable). Scripted faults (``poison_request``, ``kill_executor``, ...)
target exact victims for acceptance tests; ``*_rate`` coins drive
randomized chaos sweeps. The chaos HOWTO is in the README's port section.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Set

import numpy as np

#: fault kinds understood by the rate-based coins
FAULT_KINDS = ("crash", "dispatch_error", "stall", "nan", "oom",
               "bad_input")


class InjectedFault(RuntimeError):
    """An injected recoverable failure (dispatch error / submit OOM)."""


class InjectedOOM(InjectedFault):
    """Injected submit-time allocation failure."""


class InjectedCrash(BaseException):
    """Injected worker-loop death.

    A ``BaseException`` on purpose: the executor worker loops catch
    ``Exception`` around one batch (bad batch ≠ dead executor), so a
    crash must escape that net the way a real ``KeyboardInterrupt`` /
    interpreter teardown would and trigger the loop-fatal path.
    """


class FaultInjector:
    """Seeded chaos: deterministic fault decisions at serving-stack sites.

    Parameters
    ----------
    seed : chaos seed; every decision is a pure function of
        ``(seed, kind, identity)``.
    crash_rate : P(worker-loop death) per executor dispatch.
    dispatch_error_rate : P(a graph is poison) — any batch containing a
        poison graph fails at dispatch (the real poison-graph shape: the
        whole co-packed batch dies until bisection isolates it).
    stall_rate : P(transfer stall) per completed batch; the completer
        sleeps ``stall_s`` (long enough to trip an in-flight watchdog).
    nan_rate : P(a graph's output rows are overwritten with NaN) — must
        be caught by the engine's output-validation gate, never returned.
    oom_rate : P(submit-time OOM-like failure) per submission.
    bad_input_rate : P(a submission's raw arrays are corrupted pre-admission
        — an out-of-range edge index or a NaN feature) — must be rejected
        by the engine's admission validation (``InvalidGraph``), never
        packed.
    stall_s : injected stall duration in seconds.
    """

    def __init__(self, seed: int = 0, *, crash_rate: float = 0.0,
                 dispatch_error_rate: float = 0.0, stall_rate: float = 0.0,
                 nan_rate: float = 0.0, oom_rate: float = 0.0,
                 bad_input_rate: float = 0.0, stall_s: float = 0.2):
        self.seed = int(seed)
        self.rates: Dict[str, float] = {
            "crash": crash_rate, "dispatch_error": dispatch_error_rate,
            "stall": stall_rate, "nan": nan_rate, "oom": oom_rate,
            "bad_input": bad_input_rate,
        }
        self.stall_s = stall_s
        # scripted victims (exact targeting for acceptance tests)
        self._poisoned: Set[int] = set()
        self._nan: Set[int] = set()
        self._stalled: Set[int] = set()
        self._oom: Set[int] = set()
        self._bad_input: Set[int] = set()
        self._kills: Dict[int, int] = {}       # executor index -> nth dispatch
        self._broken_impls: Dict[str, float] = {}   # impl -> finite epsilon
        self._lock = threading.Lock()
        self._dispatch_counts: Dict[int, int] = {}
        #: injected-fault counts by kind (observability for chaos benches)
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.injected["bad_impl"] = 0

    # -- scripting ---------------------------------------------------------

    def poison_request(self, req_id: int) -> "FaultInjector":
        """Any batch containing this request fails at dispatch."""
        self._poisoned.add(int(req_id))
        return self

    def nan_request(self, req_id: int) -> "FaultInjector":
        """This request's output rows come back NaN."""
        self._nan.add(int(req_id))
        return self

    def stall_request(self, req_id: int) -> "FaultInjector":
        """The completion of any batch containing this request stalls."""
        self._stalled.add(int(req_id))
        return self

    def oom_request(self, req_id: int) -> "FaultInjector":
        """This submission fails with an injected OOM."""
        self._oom.add(int(req_id))
        return self

    def bad_input_request(self, req_id: int) -> "FaultInjector":
        """This submission's raw arrays are corrupted pre-admission."""
        self._bad_input.add(int(req_id))
        return self

    def kill_executor(self, index: int,
                      after_batches: int = 0) -> "FaultInjector":
        """Kill executor ``index``'s dispatch loop on its
        ``after_batches``-th subsequent dispatch (0 = the very next).
        One-shot: a respawned executor at the same index is not
        re-killed unless scripted again."""
        self._kills[int(index)] = int(after_batches)
        return self

    def break_impl(self, impl: str, eps: float = 0.05) -> "FaultInjector":
        """Emulate a numerically-broken kernel variant: every batch
        *served by* dataflow ``impl`` has a finite ``eps`` added to all
        its output values. Finite on purpose — it sails through the
        engine's NaN gate the way a real miscompiled kernel would, and
        only the shadow auditor's reference comparison can catch it.
        Once the circuit breaker demotes the bucket off ``impl`` the
        corruption stops (the "broken kernel" is no longer executing),
        so demotion is observably curative. Re-breaking on a re-probe is
        automatic: the promoted rung serves ``impl`` again."""
        self._broken_impls[str(impl)] = float(eps)
        return self

    def fix_impl(self, impl: str) -> "FaultInjector":
        """Heal a previously broken impl (the re-probe-succeeds case)."""
        self._broken_impls.pop(str(impl), None)
        return self

    # -- deterministic coins ----------------------------------------------

    def _coin(self, kind: str, *identity: int) -> bool:
        rate = self.rates.get(kind, 0.0)
        if rate <= 0.0:
            return False
        key = [self.seed, zlib.crc32(kind.encode())]
        key += [int(x) & 0xFFFFFFFF for x in identity]
        return float(np.random.default_rng(key).random()) < rate

    def is_poison(self, req_id: int) -> bool:
        return req_id in self._poisoned or self._coin("dispatch_error",
                                                      req_id)

    def is_nan(self, req_id: int) -> bool:
        return req_id in self._nan or self._coin("nan", req_id)

    def is_bad_input(self, req_id: int) -> bool:
        return req_id in self._bad_input or self._coin("bad_input", req_id)

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] += 1

    @staticmethod
    def _req_ids(pb) -> List[int]:
        """Engine request ids riding in a PackedBatch (payloads without a
        ``req_id`` — e.g. bare executor tests — are skipped)."""
        out = []
        for it in pb.items:
            rid = getattr(it.payload, "req_id", None)
            if rid is not None:
                out.append(int(rid))
        return out

    # -- injection sites ---------------------------------------------------

    def on_submit(self, req_id: int) -> None:
        """Engine submit path; raises ``InjectedOOM`` for scripted/coined
        victims (the caller sees the failure; no future is created)."""
        if req_id in self._oom or self._coin("oom", req_id):
            self._count("oom")
            raise InjectedOOM(f"injected submit-time OOM (request {req_id})")

    def corrupt_input(self, req_id: int, node_feat, senders, receivers,
                      edge_feat):
        """Engine admission path, BEFORE validation: corrupt a victim's
        raw arrays the way a buggy client would — an out-of-range edge
        index (even ids) or a NaN node feature (odd ids). Admission
        validation must reject the result with ``InvalidGraph``; the
        originals are never mutated (copies only)."""
        if not self.is_bad_input(req_id):
            return node_feat, senders, receivers, edge_feat
        self._count("bad_input")
        if senders.shape[0] and req_id % 2 == 0:
            senders = np.array(senders, copy=True)
            senders[0] = node_feat.shape[0] + 7       # out of [0, n_nodes)
        else:
            node_feat = np.array(node_feat, dtype=np.float32, copy=True)
            node_feat[0, 0] = np.nan
        return node_feat, senders, receivers, edge_feat

    def executor_hook(self, site: str, ex, pb) -> None:
        """Called by ``DeviceExecutor`` at its fault sites.

        ``site='dispatch'`` runs on the dispatch thread before the batch
        builds: may raise ``InjectedCrash`` (worker death) or
        ``InjectedFault`` (poisoned batch). ``site='complete'`` runs on
        the completer thread before results are read back: may sleep
        (transfer stall) or raise.
        """
        if site == "dispatch":
            with self._lock:
                n = self._dispatch_counts.get(ex.index, 0)
                self._dispatch_counts[ex.index] = n + 1
                kill_at = self._kills.get(ex.index)
                scripted_kill = kill_at is not None and n >= kill_at
                if scripted_kill:
                    del self._kills[ex.index]      # one-shot
            if scripted_kill or self._coin("crash", ex.index, n):
                self._count("crash")
                raise InjectedCrash(
                    f"injected worker crash (executor {ex.index}, "
                    f"dispatch #{n})")
            poison = [r for r in self._req_ids(pb) if self.is_poison(r)]
            if poison:
                self._count("dispatch_error")
                raise InjectedFault(
                    f"injected dispatch failure (poison requests {poison})")
        elif site == "complete":
            rids = self._req_ids(pb)
            stall = (any(r in self._stalled for r in rids)
                     or (rids and self._coin("stall", rids[0])))
            if stall:
                self._count("stall")
                time.sleep(self.stall_s)

    def corrupt_outputs(self, pb, results: List[np.ndarray],
                        impl: Optional[str] = None) -> List[np.ndarray]:
        """Engine unpack path: overwrite victims' output rows with NaN
        (the output-validation gate must quarantine them), and — when the
        batch was served by a ``break_impl``-scripted dataflow — add the
        broken impl's finite epsilon to every output (only the shadow
        auditor can catch that one)."""
        out = list(results)
        eps = self._broken_impls.get(impl) if impl is not None else None
        if eps is not None:
            self._count("bad_impl")
            out = [np.asarray(r) + np.float32(eps) for r in out]
        for i, it in enumerate(pb.items):
            rid = getattr(it.payload, "req_id", None)
            if rid is not None and self.is_nan(int(rid)):
                self._count("nan")
                out[i] = np.full_like(np.asarray(out[i]), np.nan)
        return out

    def summary(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)
