"""Engine supervisor: in-replica crash recovery for the serving engine.

Port of ``k8s_gpu_device_plugin_tpu/serving/supervisor.py``
(``RollingBudget``, ``StreamError``, ``EngineSupervisor``, the
``engine_crash`` / ``engine_restart`` spans and ``on_engine_restart``),
on the port's ``queue.Queue`` streams.

An exception on the engine thread used to end the engine for good. The
supervisor recovers it in place, within a restart budget:

- **Capture.** The crashed batcher's host ledgers are intact (the engine
  thread owns them and runs this code): queued submissions still sit in
  the engine's submit queue, and every live request is a ``_Request`` in
  ``pending`` / ``prefilling`` / ``running``. Committed tokens are pushed
  to their streams first; device work lost in flight never reached
  ``req.out``, so nothing is emitted twice.
- **Rebuild.** The old batcher's device state (KV cache, captured decode
  graph and its pool) is released, then a fresh batcher is built from
  the engine's recipe: new device state, new page pool, the same
  weights (shared, not reloaded), scheduler and fault plane. The prefix
  cache re-attaches as it is on the dense layout (its entries are rows
  of their own); on the paged layout it is reset (its entries hold page
  ids of the dead pool).
- **Resume.** Each surviving request takes the preemption fold: its
  emitted tokens join its prompt as ``prefilled_out``, the re-prefill
  recomputes their K/V and the finish chunk samples emission (and seeded
  draw) ``prefilled_out``, so greedy and seeded streams continue token
  for token and no token is emitted twice. Requests keep their ids (the
  new batcher's counter continues from the old one's).

Past the budget (``max_restarts`` per rolling ``window_s``) the engine
degrades to the dead state, and every open stream ends with a
:class:`StreamError` frame, never a silent short completion.

Thread model: every ledger here is engine-thread state (``on_crash`` and
``recover`` run on the crashed loop's thread); ``/v1/health`` reads the
:meth:`EngineSupervisor.stats` snapshot.
"""

from __future__ import annotations

import gc
import time

from k8s_gpu_device_plugin_torch.obs.trace import get_tracer
from k8s_gpu_device_plugin_torch.utils.log import get_logger

log = get_logger()


class RollingBudget:
    """N events per rolling window: the engine supervisor's restart
    budget. ``max_events=0`` means the budget is always exhausted (the
    recovery-off switch). Single-writer (the engine thread)."""

    __slots__ = ("max_events", "window_s", "_times")

    def __init__(self, max_events: int, window_s: float):
        if max_events < 0:
            raise ValueError(f"max_events must be >= 0, got {max_events}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.max_events = int(max_events)
        self.window_s = float(window_s)
        self._times: list[float] = []

    def allow(self) -> bool:
        """True while the rolling budget has room (prunes the window)."""
        now = time.monotonic()
        self._times = [t for t in self._times if now - t < self.window_s]
        return len(self._times) < self.max_events

    def record(self) -> None:
        """Charge one event against the window."""
        self._times.append(time.monotonic())

    def used(self) -> int:
        """Events charged inside the current window (prunes it)."""
        now = time.monotonic()
        self._times = [t for t in self._times if now - t < self.window_s]
        return len(self._times)


class StreamError:
    """Terminal structured-error frame on a per-request stream queue: the
    stream's ``(token, logprob)`` items end with one of these, then
    ``None``, when the engine could not finish it. The HTTP plane answers
    it as an SSE error event (or a 503), never as a clean end."""

    __slots__ = ("code", "message")

    def __init__(self, code: str, message: str):
        self.code = code
        self.message = message

    def __repr__(self) -> str:
        return f"StreamError(code={self.code!r}, message={self.message!r})"


def _live_requests(cb) -> list:
    return (list(cb.pending) + list(cb.prefilling.values())
            + list(cb.running.values()))


class EngineSupervisor:
    """Restart policy and recovery for one InferenceEngine:
    ``max_restarts`` restarts per rolling ``window_s`` seconds; 0 turns
    recovery off (every crash degrades to the dead state, with the
    structured error frames)."""

    def __init__(self, max_restarts: int = 3, window_s: float = 300.0):
        self._budget = RollingBudget(max_restarts, window_s)  # owner: engine
        self.max_restarts = self._budget.max_events
        self.window_s = self._budget.window_s
        self._state = "ok"                     # owner: engine
        self._last_crash: "dict | None" = None  # owner: engine
        self._crashes_total = 0                # owner: engine
        self._restarts_total = 0               # owner: engine
        self._replayed_total = 0               # owner: engine
        self._resumed_total = 0                # owner: engine

    # --- policy (engine thread) ---

    def on_crash(self, exc: BaseException) -> None:
        """Record one engine-loop crash (restart or not)."""
        self._crashes_total += 1
        self._last_crash = {"t_wall": time.time(),
                            "error": f"{type(exc).__name__}: {exc}"}
        tracer = get_tracer()
        if tracer.enabled:
            tracer.span("engine_crash", component="serving_engine",
                        error=f"{type(exc).__name__}: {exc}",
                        crashes=self._crashes_total).end()

    def allow_restart(self) -> bool:
        """True while the rolling restart budget has room."""
        return self._budget.allow()

    def mark_dead(self) -> None:
        self._state = "dead"

    # --- recovery (engine thread, after the crashed loop unwound) ---

    @staticmethod
    def _fallback_publish(engine, old) -> None:
        """Twin of ``engine._publish`` for when that raised against the
        torn batcher: push every live request's committed tokens, and
        close the streams of requests that retired between the last
        publish and the crash (their ids never reach the new batcher, so
        no later publish would end their streams). One bad entry must not
        strand the rest."""
        for req in _live_requests(old):
            try:
                engine._push(req.rid, req.out, req.out_logp)
            except Exception:  # noqa: BLE001
                log.exception("fallback push failed for rid=%s", req.rid)
        for rid, eid in list(engine._rid_to_eid.items()):
            req = old.done_requests.pop(rid, None)
            if req is None:
                continue
            try:
                engine._push(rid, req.out, req.out_logp)
            except Exception:  # noqa: BLE001
                log.exception("fallback push failed for rid=%s", rid)
            old.done.pop(rid, None)
            engine._close_stream(rid, eid, req)

    def recover(self, engine) -> None:
        """Rebuild ``engine.cb`` in place and resume its work. Raises if
        the rebuild itself fails (the caller then degrades to dead)."""
        # imported here: the replica router takes RollingBudget from this
        # module and imports no torch
        import torch

        old = engine.cb
        if old.device.type == "cuda":
            # the crashed step's replay (and any copy behind it) finishes
            # before its buffers are let go
            torch.cuda.synchronize(old.device)
        # 1. deliver every committed token: a crash between the paired
        # out/out_logp appends may leave one list a token longer
        for req in _live_requests(old):
            n = min(len(req.out), len(req.out_logp))
            del req.out[n:]
            del req.out_logp[n:]
        try:
            # the normal publish also closes the streams of requests that
            # retired between the last publish and the crash
            engine._publish()
        except Exception:  # noqa: BLE001 - torn batcher state
            log.exception("post-crash publish failed; pushing live "
                          "streams directly")
            self._fallback_publish(engine, old)
        survivors = sorted(_live_requests(old), key=lambda r: r.rid)
        # 2. the prefix cache: paged entries hold page ids of the dead
        # pool; dense entries are rows of their own and re-attach
        pc = old.prefix_cache
        if pc is not None and old.pool is not None:
            pc.reset()
        # 3. free the old device state before the new one is allocated:
        # a second KV cache and graph pool beside the first may not fit
        next_rid = old._next_rid
        old.release_device_state()
        del old
        gc.collect()
        if engine.cb.device.type == "cuda":
            torch.cuda.empty_cache()
        new = engine._make_batcher()
        # ids stay unique and stable: survivors keep theirs (the engine's
        # rid -> stream map needs no change), new ones continue the count
        new._next_rid = next_rid
        replayed = resumed = 0
        now = time.perf_counter()
        for req in survivors:
            was_admitted = req.slot >= 0
            if was_admitted and req.timeline is not None:
                # the decode or prefill segment closes at the crash and a
                # queue_wait opens (the resumed admission closes it): the
                # phase sums stay exact
                req.timeline.advance("queue_wait", now)
            if req.decode_span is not None:
                req.decode_span.set(tokens=len(req.out)).end()
                req.decode_span = None
            # the preemption fold; any pins belonged to the dead pool
            req.fold()
            if req.out:
                resumed += 1
            else:
                replayed += 1
            if was_admitted or req.out:
                # a mid-stream survivor: the scheduler does not charge
                # its (output-inflated) prompt again
                req.restarts += 1
            new.pending.append(req)
        engine.cb = new
        self._budget.record()
        self._restarts_total += 1
        self._replayed_total += replayed
        self._resumed_total += resumed
        # the rebuilt batcher carries the server's metrics, attributor and
        # MFU accumulator (the recipe's own objects): their ledgers live on
        if new.metrics is not None:
            new.metrics.on_engine_restart(replayed, resumed)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.span("engine_restart", component="serving_engine",
                        restart=self._restarts_total, replayed=replayed,
                        resumed=resumed).end()
        log.warning(
            "inference engine restarted after crash",
            extra={"fields": {
                "restarts_total": self._restarts_total,
                "replayed": replayed,
                "resumed": resumed,
                "last_crash": (self._last_crash or {}).get("error"),
            }},
        )

    # --- cross-thread snapshot ---

    def stats(self) -> dict:
        """The ``supervisor`` section of ``/v1/health`` (the reference's
        keys)."""
        return {
            "state": self._state,
            "max_restarts": self.max_restarts,
            "window_s": self.window_s,
            "crashes_total": self._crashes_total,
            "restarts_total": self._restarts_total,
            "replayed_total": self._replayed_total,
            "resumed_total": self._resumed_total,
            "last_crash": (dict(self._last_crash)
                           if self._last_crash else None),
        }
