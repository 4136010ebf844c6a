"""Serving MFU / roofline cost model + live accumulator.

The port's copy of ``k8s_gpu_device_plugin_tpu/metrics/roofline.py``,
priced at the card's own peaks. Serving work is priced from the config
math alone (``LlamaConfig.flops_per_token``, ``paging.kv_token_bytes``)
and divided by the spec-sheet peaks of the card that serves it:

- **Prefill** is compute-bound: ``2 * matmul_params`` FLOPs per prompt
  token (the forward third of the 6N training figure; O(S) attention
  score FLOPs are left out, so the reported MFU is slightly
  conservative).
- **Decode** is memory-bound: each step streams the weights once plus
  every live context row of the active slots, so the roofline number is
  the bytes moved against the card's memory bandwidth.

``weight_bytes`` is the matmul parameter count at the activation width,
as in the reference: under ``--weightQuant int8|int4`` the step streams
fewer bytes than that, so the bandwidth share over-reads.

The peaks come from :data:`CARDS`, keyed by ``torch.cuda.get_device_name``.
A CUDA card missing from the table raises, naming itself: no made-up
peaks. A server on the CPU (``--device cpu``) prices at the H100 entry
and says so in ``generation`` (the reference's off-device rule: the
ratios stay defined and testable off the card).

:class:`MfuAccumulator` is the live half: engine-owned (the batcher
drives it from the step loop; other threads read :meth:`mfu_stats`),
windowed like ``tokens_per_second`` (fresh gauges every ~1 s of busy
time), with per-tenant FLOP attribution at retirement, so goodput per
TFLOP is a live metric.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from k8s_gpu_device_plugin_torch.device.topology import GENERATIONS
from k8s_gpu_device_plugin_torch.models.paging import kv_token_bytes


@dataclass(frozen=True)
class Card:
    """One card's spec-sheet peaks (dense, no sparsity)."""

    peak_bf16_tflops: float
    hbm_gbps: float


#: ``torch.cuda.get_device_name()`` -> peaks, read from the device
#: model's generation table (``device/topology.py`` ``GENERATIONS``: the
#: H100 SXM part's data sheet, 989.4 TFLOP/s dense bf16 and 3352 GB/s of
#: HBM3 at 700 W), so the two never disagree.
CARDS = {
    g.device_name: Card(peak_bf16_tflops=g.peak_bf16_tflops,
                        hbm_gbps=g.hbm_bandwidth_gbps)
    for g in GENERATIONS.values()
}
#: the entry a server on the CPU is priced at
OFF_DEVICE_CARD = "NVIDIA H100 80GB HBM3"


def card_for(device) -> tuple[str, Card]:
    """(generation label, peaks) for ``device``: the table's entry for a
    CUDA device's name, which must be there; the H100's for the CPU,
    labelled as priced off the card."""
    device = torch.device(device)
    if device.type == "cpu":
        return (f"{OFF_DEVICE_CARD} (priced off-device: cpu)",
                CARDS[OFF_DEVICE_CARD])
    name = torch.cuda.get_device_name(device)
    card = CARDS.get(name)
    if card is None:
        raise ValueError(
            f"no roofline peaks for the card {name!r}: add its spec-sheet "
            f"dense bf16 TFLOP/s and memory GB/s to device/topology.py "
            f"GENERATIONS (known: {sorted(CARDS)})")
    return name, card


@dataclass(frozen=True)
class ServingCostModel:
    """Pure pricing math for one serving config on one card.

    ``flops_per_token`` here is the INFERENCE forward (2 * matmul
    params); ``weight_bytes`` prices the decode step's weight stream from
    the same matmul-parameter count at the activation width."""

    generation: str
    peak_tflops: float        # per card, dense bf16
    hbm_gbps: float           # per card, GB/s
    flops_per_token: float    # inference forward, per token
    weight_bytes: int         # matmul weights streamed per decode step
    kv_token_bytes: int       # device bytes one cached token row costs
    tp: int = 1

    @staticmethod
    def for_config(cfg, device="cuda",
                   tp: "int | None" = None) -> "ServingCostModel":
        generation, card = card_for(device)
        fwd = cfg.flops_per_token() / 3.0  # 6N is fwd+bwd; serving runs fwd
        # matmul params = fwd flops / 2 (one multiply-add per weight), at
        # the config's activation width (2 for bf16)
        width = cfg.dtype.itemsize
        return ServingCostModel(
            generation=generation,
            peak_tflops=card.peak_bf16_tflops,
            hbm_gbps=card.hbm_gbps,
            flops_per_token=fwd,
            weight_bytes=int(fwd / 2.0) * int(width),
            kv_token_bytes=kv_token_bytes(cfg),
            tp=tp if tp is not None else max(1, getattr(cfg, "tp", 1)),
        )

    # --- pricing ---------------------------------------------------------

    def prefill_flops(self, n_tokens: int) -> float:
        """Model FLOPs of prefilling ``n_tokens`` prompt tokens."""
        return self.flops_per_token * n_tokens

    def decode_flops(self, n_tokens: int) -> float:
        """Model FLOPs of emitting ``n_tokens`` decode tokens."""
        return self.flops_per_token * n_tokens

    def decode_step_bytes(self, active: int, live_tokens: int) -> float:
        """Bytes one decode step streams: the weights once (batched
        decode amortizes them across the batch) plus every live context
        row read by attention, plus the ``active`` rows written."""
        return float(
            self.weight_bytes
            + live_tokens * self.kv_token_bytes
            + active * self.kv_token_bytes
        )

    def mfu_pct(self, flops: float, seconds: float) -> float:
        """Achieved model FLOP/s as % of the peak of ``tp`` cards."""
        if seconds <= 0:
            return 0.0
        return 100.0 * (flops / seconds) / (self.peak_tflops * 1e12 * self.tp)

    def hbm_bw_util_pct(self, nbytes: float, seconds: float) -> float:
        """Achieved memory stream as % of the bandwidth of ``tp`` cards."""
        if seconds <= 0:
            return 0.0
        return 100.0 * (nbytes / seconds) / (self.hbm_gbps * 1e9 * self.tp)


class MfuAccumulator:
    """Live serving MFU/roofline accounting, driven by the batcher.

    All mutable state is owned by the engine thread (the step loop is the
    only writer); ``/v1/health`` and the gauges cross threads only
    through the :meth:`mfu_stats` snapshot and the metrics hooks (whose
    families lock themselves)."""

    def __init__(self, model: ServingCostModel, metrics=None,
                 window_s: float = 1.0):
        self.model = model
        self.metrics = metrics
        self.window_s = float(window_s)
        self._flops_total = 0.0     # owner: engine
        self._bytes_total = 0.0     # owner: engine
        self._win_flops = 0.0       # owner: engine
        self._win_bytes = 0.0       # owner: engine
        self._win_tokens = 0        # owner: engine
        self._win_t0 = time.monotonic()  # owner: engine
        self._mfu_pct = 0.0         # owner: engine (last closed window)
        self._bw_pct = 0.0          # owner: engine
        self._win_tps = 0.0         # owner: engine
        # tenant -> [model_flops, goodput_tokens]; bounded by the tenant
        # set the scheduler's labels carry
        self._tenants: dict[str, list] = {}  # owner: engine

    # --- batcher hooks (engine thread) -----------------------------------

    def on_prefill_tokens(self, n: int) -> None:
        """``n`` COMPUTED prompt tokens ran through the model (prefix-
        reused tokens moved no FLOPs and are not priced)."""
        f = self.model.prefill_flops(n)
        self._flops_total += f
        self._win_flops += f

    def on_step(self, emitted: int, active: int, live_tokens: int) -> None:
        """One decode step: ``emitted`` tokens sampled, ``active`` slots
        computing over ``live_tokens`` total context rows."""
        f = self.model.decode_flops(emitted)
        b = self.model.decode_step_bytes(active, live_tokens) if active \
            else 0.0
        self._flops_total += f
        self._bytes_total += b
        self._win_flops += f
        self._win_bytes += b
        self._win_tokens += emitted
        dt = time.monotonic() - self._win_t0
        if dt >= self.window_s:
            self._close_window(dt)

    def _close_window(self, dt: float) -> None:
        self._mfu_pct = self.model.mfu_pct(self._win_flops, dt)
        self._bw_pct = self.model.hbm_bw_util_pct(self._win_bytes, dt)
        self._win_tps = self._win_tokens / dt
        if self.metrics is not None:
            self.metrics.set_mfu(self._mfu_pct, self._bw_pct)
            self.metrics.on_model_work(self._win_flops, self._win_bytes)
        self._win_flops = 0.0
        self._win_bytes = 0.0
        self._win_tokens = 0
        self._win_t0 = time.monotonic()

    def on_idle(self) -> None:
        """Busy -> idle: zero the window gauges instead of freezing them."""
        self._mfu_pct = 0.0
        self._bw_pct = 0.0
        self._win_tps = 0.0
        self._win_flops = 0.0
        self._win_bytes = 0.0
        self._win_tokens = 0
        self._win_t0 = time.monotonic()
        if self.metrics is not None:
            self.metrics.set_mfu(0.0, 0.0)

    def on_retired(self, req, goodput_tokens: int) -> None:
        """Per-tenant FLOP attribution at retirement: the prefill tokens
        this request actually ran through the model (the batcher's
        ``prefill_computed``) plus its decode tokens. ``goodput_tokens``
        follows the scheduler's rule (0 when the deadline was missed), so
        tokens per TFLOP is a goodput ratio."""
        flops = (
            self.model.prefill_flops(req.prefill_computed)
            + self.model.decode_flops(len(req.out))
        )
        t = self._tenants.get(req.tenant)
        if t is None:
            t = self._tenants[req.tenant] = [0.0, 0]
        t[0] += flops
        t[1] += int(goodput_tokens)
        if self.metrics is not None:
            self.metrics.on_tenant_flops(req.tenant, flops)

    def totals(self) -> tuple[float, float]:
        """(model FLOPs, bytes) accumulated so far (engine thread, or a
        finished run)."""
        return self._flops_total, self._bytes_total

    # --- cross-thread snapshot -------------------------------------------

    def mfu_stats(self) -> dict:
        """Snapshot for ``/v1/health`` (plain numbers copied under the
        GIL, ``list()`` before iterating)."""
        tenants = {}
        for name, (flops, good) in list(self._tenants.items()):
            tflops = flops / 1e12
            tenants[name] = {
                "model_tflops": round(tflops, 6),
                "goodput_tokens": good,
                "goodput_tokens_per_tflop": (
                    round(good / tflops, 3) if tflops > 0 else 0.0
                ),
            }
        return {
            "generation": self.model.generation,
            "tp": self.model.tp,
            "peak_tflops": self.model.peak_tflops * self.model.tp,
            "hbm_gbps": self.model.hbm_gbps * self.model.tp,
            "serving_mfu_pct": round(self._mfu_pct, 4),
            "hbm_bw_util_pct": round(self._bw_pct, 4),
            "window_tokens_per_second": round(self._win_tps, 3),
            "model_tflops_total": round(self._flops_total / 1e12, 6),
            "hbm_gb_total": round(self._bytes_total / 1e9, 6),
            "tenants": tenants,
        }
