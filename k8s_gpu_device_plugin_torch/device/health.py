"""Tri-state GPU health: the wedged-but-present detector.

Port of the reference's ``device/health.py``. ``backend.check_health()``
sees the device node and whether NVML answers, which a wedged GPU can
still satisfy. :class:`HealthAssessor` (the reference's, verbatim in its
verdicts and ``last_reasons``) adds two liveness sources:

1. **Stale readings.** The usage reader (``metrics/runtime_metrics.py``
   ``NvmlUsageReader``) reports the GPUs a workload holds. A GPU that was
   held and then drops out of the readings while the reader still says a
   workload may be there (``silent``) goes ``Unknown`` after
   ``stale_after``.
2. **Bounded idle probe (opt-in).** When no workload holds a GPU — NVML
   lists no compute process on any, and the reader can tell (status
   ``absent``) — a child process runs one bf16 product on the card and
   exits. A child that fails or hangs past the timeout marks every
   node-present GPU ``Unknown``. The reader says it cannot tell
   (``silent``) when NVML lists no process while card memory is held (a
   container's PID namespace can hide processes) or while this process
   holds the card: that counts as busy, and the probe never runs.

``Unknown`` rather than ``Unhealthy``: kubelet withdraws the GPU either
way (any health string but "Healthy" makes it unschedulable), and the
daemon stays honest that this is lost liveness evidence, not a confirmed
fault.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable

from k8s_gpu_device_plugin_torch.device.chip import HEALTHY, UNHEALTHY, UNKNOWN
from k8s_gpu_device_plugin_torch.utils.log import get_logger

#: Readings older than this mark their GPU Unknown (a held GPU is read
#: every health interval).
DEFAULT_STALE_AFTER_SECONDS = 30.0
#: Idle-probe cadence: how often an idle host may spend a probe child.
DEFAULT_PROBE_INTERVAL_SECONDS = 600.0
#: Hard kill for the probe child — a wedged GPU can hang it forever.
DEFAULT_PROBE_TIMEOUT_SECONDS = 45.0

PROBE_CODE = (
    "import torch; "
    "x = torch.ones((8, 8), dtype=torch.bfloat16, device='cuda'); "
    "torch.cuda.synchronize(); (x @ x).float().sum().item()"
)


def run_idle_probe(timeout_seconds: float = DEFAULT_PROBE_TIMEOUT_SECONDS) -> bool:
    """Start CUDA in a child, run one bf16 product on the card, exit.

    Returns True iff the child completed in time. On timeout
    ``subprocess.run`` kills it. Callers must only invoke this when no
    workload holds the GPUs. A child's CUDA start alone costs seconds.
    """
    try:
        proc = subprocess.run(
            [sys.executable, "-c", PROBE_CODE],
            capture_output=True,
            timeout=timeout_seconds,
        )
        return proc.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


class HealthAssessor:
    """Combine node-presence booleans with liveness evidence.

    ``assess`` maps each GPU index to "Healthy" / "Unhealthy" /
    "Unknown". The reader's keys are GPU indices (the NVML reader maps
    NVML's devices to the enumerator's indices by minor number).
    All liveness state is per-assessor: the manager owns one instance
    for the daemon's lifetime.
    """

    def __init__(
        self,
        reader=None,
        stale_after: float = DEFAULT_STALE_AFTER_SECONDS,
        probe: Callable[[], bool] | None = None,
        probe_interval: float = DEFAULT_PROBE_INTERVAL_SECONDS,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
    ) -> None:
        self._reader = reader
        self._stale_after = stale_after
        self._probe = probe
        self._probe_interval = probe_interval
        self._clock = clock
        self._log = logger or get_logger()
        self._last_seen: dict[int, float] = {}
        self._last_probe_t: float | None = None
        self._last_probe_ok = True
        # per-chip reason behind the latest verdict ("ok" /
        # "node_unhealthy" / "stale_gauges" / "probe_failed") — what the
        # allocation journal's health_transition events carry, so an
        # Unknown chip says WHICH liveness source demoted it
        self.last_reasons: dict[int, str] = {}

    def _scrape(self, now: float) -> tuple[set[int], bool]:
        """Refresh gauge liveness; returns (devices seen, endpoint absent).

        The reader's status disambiguates "readings stopped": ``absent``
        (no workload holds a GPU) means the workload exited — liveness
        history is CLEARED so a clean exit never reads as a wedge.
        ``silent`` (the reader cannot tell: NVML lists no process while
        memory is held, or stopped answering) keeps history, and
        previously-seen GPUs go stale against it. The absent flag is the
        ONLY state that may unlock the idle probe: "cannot tell" counts
        as busy.
        """
        if self._reader is None:
            return set(), False
        try:
            read_status = getattr(self._reader, "read_status", None)
            if read_status is not None:
                usages, status = read_status()
            else:
                usages = self._reader.read()
                status = "data" if usages else "absent"
        except Exception as e:  # noqa: BLE001 - liveness is best-effort
            self._log.warning(
                "usage read failed during health assessment",
                extra={"fields": {"error": str(e)}},
            )
            return set(), False
        if status == "absent":
            self._last_seen.clear()
            return set(), True
        live = set(usages)
        for dev in live:
            self._last_seen[dev] = now
        return live, False

    def assess(
        self,
        node_health: dict[int, bool],
        allow_probe: bool = True,
        scrape: bool = True,
    ) -> dict[int, str]:
        """``allow_probe=False`` skips the idle-probe branch (startup /
        restart paths, which must not block on a child process).
        ``scrape=False`` additionally skips the usage read and judges
        from cached liveness state only — zero blocking calls, for
        callers on the event loop (the health loop reads from a worker
        thread soon after anyway)."""
        now = self._clock()
        live, endpoint_absent = (
            self._scrape(now) if scrape else (set(), False)
        )

        verdicts: dict[int, str] = {}
        reasons: dict[int, str] = {}
        for idx, ok in node_health.items():
            if not ok:
                verdicts[idx] = UNHEALTHY
                reasons[idx] = "node_unhealthy"
                continue
            seen = self._last_seen.get(idx)
            if seen is not None and idx not in live and now - seen > self._stale_after:
                # a workload held this GPU and its readings stopped while
                # the node still looks fine: the wedged-but-present
                # signature
                verdicts[idx] = UNKNOWN
                reasons[idx] = "stale_gauges"
                continue
            verdicts[idx] = HEALTHY
            reasons[idx] = "ok"

        if live:
            # a workload on the GPUs = demonstrably alive; retire any stale
            # idle-probe failure so it can't outlive the evidence against it
            self._last_probe_ok = True
        elif (
            allow_probe
            and endpoint_absent
            and self._probe is not None
            and all(v == HEALTHY for v in verdicts.values())
        ):
            # Truly idle host: no workload on any GPU (a reader that
            # cannot tell is treated as busy, and a busy GPU is never
            # raced by a probe child). Spend a bounded probe child at most
            # every probe_interval.
            if (
                self._last_probe_t is None
                or now - self._last_probe_t >= self._probe_interval
            ):
                self._last_probe_t = now
                self._last_probe_ok = bool(self._probe())
                if not self._last_probe_ok:
                    self._log.warning(
                        "idle CUDA probe failed; marking GPUs Unknown"
                    )
            if not self._last_probe_ok:
                for idx, v in verdicts.items():
                    if v == HEALTHY:
                        verdicts[idx] = UNKNOWN
                        reasons[idx] = "probe_failed"
        self.last_reasons = reasons
        return verdicts


def assessor_from_config(cfg, logger=None, reader=None) -> HealthAssessor | None:
    """Build the assessor the config asks for, or None (plain node and
    NVML health) when both liveness sources are disabled. ``cfg`` is any
    object with the reference's attribute names (``runtime_metrics_ports``
    "off" disables the usage reader, ``health_idle_probe``,
    ``health_idle_probe_timeout``, ``health_stale_after``,
    ``health_idle_probe_interval``).

    ``reader`` shares an existing usage reader; None builds from config.
    """
    from k8s_gpu_device_plugin_torch.metrics.device_metrics import NullUsageReader
    from k8s_gpu_device_plugin_torch.metrics.runtime_metrics import (
        usage_reader_from_config,
    )

    if reader is None:
        reader = usage_reader_from_config(cfg)
    if isinstance(reader, NullUsageReader):
        reader = None
    probe = None
    if getattr(cfg, "health_idle_probe", "off") == "on":
        if reader is None:
            # Without readings there is NO idleness signal, and probing
            # blind would contend with a workload for the card.
            (logger or get_logger()).warning(
                "healthIdleProbe=on requires the usage reader; probe disabled"
            )
        else:
            timeout = float(
                getattr(
                    cfg, "health_idle_probe_timeout", DEFAULT_PROBE_TIMEOUT_SECONDS
                )
            )
            probe = lambda: run_idle_probe(timeout)  # noqa: E731
    if reader is None and probe is None:
        return None
    return HealthAssessor(
        reader=reader,
        stale_after=float(
            getattr(cfg, "health_stale_after", DEFAULT_STALE_AFTER_SECONDS)
        ),
        probe=probe,
        probe_interval=float(
            getattr(
                cfg, "health_idle_probe_interval", DEFAULT_PROBE_INTERVAL_SECONDS
            )
        ),
        logger=logger,
    )
