"""Seeded fault-injection plane: failures as a rehearsed event.

Port of ``k8s_gpu_device_plugin_tpu/serving/faults.py``: the same named
points, the same spec grammar (``--faults`` on the server's CLI, or the
``TPU_SERVING_FAULTS`` environment variable) and the same firing
sequence for a given spec. Every point is DISARMED by default.

Fault points (the seams they live at):

==================  ====================================================
``pool.alloc``      paged-KV page reservation (``_reserve_pages``) and
                    windowed growth (``_grow_slot_pages``): a fired
                    fault reads as transient pool pressure; the
                    admission (or the chunk) defers as under a real
                    exhausted free list and retries next step
``prefill.dispatch``  the chunked-prefill dispatch
                    (``_prefill_one_chunk``): raises on the engine
                    thread, an engine crash mid-prefill
``decode.apply``    the decode readback seam (``_apply_decode_result``):
                    raises on the engine thread, the mid-decode crash
``prefix.promote``  prefix-cache promotion (``_maybe_promote_prefix``):
                    raises on the engine thread after a finished prefill
``adapter.upload``  the adapter-residency gate (``_admit_adapter``): reads
                    as an upload in flight, the admission defers and
                    retries next pass
``health.handler``  ``GET /v1/health``: answers 500, a live socket over a
                    lying health surface
``router.connect``  the replica router's dispatch (``serving/router.py``
                    ``_open_attempt``): a fired fault reads as a
                    connection failure, the request fails over to the
                    next ring candidate
``router.midstream``  the replica router's SSE relay (``_pump_sse``,
                    once per relayed frame): a journaled stream resumes
                    on another replica, any other ends visibly cut
==================  ====================================================

Schedules (per point, all deterministic):

- ``nth=N``: fire on the Nth hit (once; ``times`` repeats it on later
  hits up to that many fires).
- ``p=0.3:seed=7``: fire each hit with probability p, drawn from a
  ``random.Random`` seeded by ``(seed, point name)``: the sequence is the
  same run to run. Unlimited fires unless ``times`` caps it.
- ``delay_ms=D``: when the schedule fires, sleep instead of raising.

Spec grammar: comma-separated entries, colon-separated fields::

    decode.apply:nth=40,pool.alloc:p=0.25:seed=3:times=6

A disarmed point is ``None``: consumers hold the resolved point and guard
with ``is not None``, so the disarmed cost is one compare per seam. The
batcher never imports this module: the plane is duck-typed
(``point()``/``error``).
"""

from __future__ import annotations

import random
import time
import zlib


class FaultError(RuntimeError):
    """An injected failure. Raised ONLY by armed fault points, so a
    test or chaos harness can always tell induced breakage from real
    bugs (a real crash never carries this type)."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


#: every seam a spec may name — a typo'd point would otherwise arm
#: nothing and silently pass the chaos it was meant to cause
KNOWN_POINTS = (
    "pool.alloc",
    "prefill.dispatch",
    "decode.apply",
    "prefix.promote",
    "adapter.upload",
    "health.handler",
    "router.connect",
    "router.midstream",
)


class FaultPoint:
    """One armed fault point: a name plus a deterministic schedule.

    ``fire()`` is the whole consumer API: it advances the schedule and
    either returns (not due), sleeps (``delay_ms`` latency injection),
    or raises :class:`FaultError`. Counters (``hits``/``fired``) are
    owned by whichever thread runs the seam — single-threaded per
    point, like the state around every seam it installs into.
    """

    __slots__ = ("name", "nth", "p", "times", "delay_ms", "hits", "fired",
                 "_rng")

    def __init__(self, name: str, *, nth: int = 0, p: float = 0.0,
                 seed: int = 0, times: int = 0, delay_ms: float = 0.0):
        if name not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {name!r}; known: {list(KNOWN_POINTS)}"
            )
        if (nth > 0) == (p > 0.0):
            raise ValueError(
                f"fault point {name!r} needs exactly one schedule: "
                "nth=N or p=P"
            )
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"fault point {name!r}: p must be in [0, 1]")
        if delay_ms < 0:
            raise ValueError(f"fault point {name!r}: delay_ms must be >= 0")
        if times < 0:
            raise ValueError(f"fault point {name!r}: times must be >= 0")
        self.name = name
        self.nth = int(nth)
        self.p = float(p)
        # nth defaults to a single fire (the induced-crash idiom); p
        # defaults to unlimited (the background-flakiness idiom)
        self.times = int(times) if times else (1 if nth else 0)
        self.delay_ms = float(delay_ms)
        self.hits = 0
        self.fired = 0
        # seeded per (seed, name): two points under one seed draw
        # independent, reproducible sequences
        self._rng = random.Random(
            (int(seed) << 32) ^ zlib.crc32(name.encode())
        )

    def fire(self) -> None:
        """Advance the schedule; raise/sleep when due, else return."""
        self.hits += 1
        if self.times and self.fired >= self.times:
            return
        if self.nth:
            due = self.hits >= self.nth
        else:
            due = self._rng.random() < self.p
        if not due:
            return
        self.fired += 1
        if self.delay_ms:
            time.sleep(self.delay_ms / 1000.0)
            return
        raise FaultError(self.name)

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "fired": self.fired,
            "schedule": (
                {"nth": self.nth} if self.nth else {"p": self.p}
            ),
            "times": self.times,
            "delay_ms": self.delay_ms,
        }


class FaultPlane:
    """The armed-point registry one process carries (server or router).

    ``point(name)`` returns the armed :class:`FaultPoint` or ``None`` —
    consumers cache the result and guard with ``is not None``.
    ``error`` hands consumers the exception TYPE without an import
    (the batcher catches injected pool-alloc failures through it while
    keeping models/ serving-free).
    """

    #: duck-typed exception handle for no-import consumers
    error = FaultError

    def __init__(self):
        self._points: dict[str, FaultPoint] = {}

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlane | None":
        """Parse a ``--faults`` spec; empty/whitespace -> ``None`` (the
        fully disarmed plane — consumers then hold no plane at all)."""
        spec = (spec or "").strip()
        if not spec:
            return None
        plane = cls()
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, rest = entry.partition(":")
            name = name.strip()
            kw: dict = {}
            for fld in rest.split(":") if rest else ():
                if "=" not in fld:
                    raise ValueError(
                        f"fault spec field {fld!r} in {entry!r}: "
                        "expected key=value"
                    )
                k, v = fld.split("=", 1)
                k = k.strip()
                try:
                    if k in ("nth", "seed", "times"):
                        kw[k] = int(v)
                    elif k == "p":
                        kw[k] = float(v)
                    elif k == "delay_ms":
                        kw[k] = float(v)
                    else:
                        raise ValueError
                except ValueError:
                    raise ValueError(
                        f"fault spec field {fld!r} in {entry!r}: known "
                        "keys are nth/p/seed/times/delay_ms"
                    ) from None
            if "nth" not in kw and "p" not in kw:
                kw["nth"] = 1  # no schedule named: fire on first hit
            if name in plane._points:
                raise ValueError(f"fault point {name!r} armed twice")
            plane._points[name] = FaultPoint(name, **kw)
        return plane

    @classmethod
    def from_cli(cls, spec_arg: str) -> "FaultPlane | None":
        """The one CLI/env arming path (server AND router ``_main``):
        the ``--faults`` value, falling back to ``TPU_SERVING_FAULTS``;
        spec errors become the clean usage exit, not a traceback."""
        import os

        try:
            return cls.from_spec(
                spec_arg or os.environ.get("TPU_SERVING_FAULTS", "")
            )
        except ValueError as e:
            raise SystemExit(str(e)) from None

    def arm(self, name: str, **kw) -> FaultPoint:
        """Programmatic arming (tests/benches); same rules as the spec."""
        if name in self._points:
            raise ValueError(f"fault point {name!r} armed twice")
        pt = FaultPoint(name, **kw)
        self._points[name] = pt
        return pt

    def point(self, name: str) -> "FaultPoint | None":
        if name not in KNOWN_POINTS:
            # resolving a typo'd name would silently disarm the seam
            raise ValueError(
                f"unknown fault point {name!r}; known: {list(KNOWN_POINTS)}"
            )
        return self._points.get(name)

    def stats(self) -> dict:
        return {name: pt.stats() for name, pt in self._points.items()}
