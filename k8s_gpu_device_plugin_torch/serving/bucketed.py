"""Shared bucketed single-row dispatch for the auxiliary serving forwards.

Port of ``k8s_gpu_device_plugin_tpu/serving/bucketed.py``. Embeddings
(``serving/embeddings.py``) and prompt scoring (``serving/scoring.py``)
are one machine with two functions: pad a token list to the smallest
fitting prompt bucket (the batcher's own ``_bucket``), run the
non-cached forward on it, one dispatch at a time behind a lock, and run
every bucket once at construction, on the constructing thread, before
the engine thread starts. On the card that warm-up also builds and first
launches the kernels, so no handler thread ever does.

Where it runs: on the HTTP handler's thread, behind the lock, and on a
card on a CUDA stream of its own (a pool stream, which does not
synchronize with the legacy default stream the engine works on). The
engine's decode graph and its recapture after a supervised restart
(``capture_error_mode="thread_local"``) live on other streams and
threads; the forwards here read the weights and write only tensors of
their own.

The K2 bucket rule: the flash forward takes S only as a positive
multiple of ``flash_attention.TILE`` (64), so on a card a bucket is
padded up to that multiple (the public 32 runs as 64). The forward is
causal: rows past the real tokens change no real row, and the callers
mask them out of the pool and the scores. A shape the kernel refuses is
padded, never sent to the plain path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from k8s_gpu_device_plugin_torch.models.batching import _bucket
from k8s_gpu_device_plugin_torch.ops.flash_attention import TILE


def _to_host(out):
    if isinstance(out, torch.Tensor):
        return out.cpu()
    return tuple(_to_host(x) for x in out)


class BucketedForward:
    """Pad-to-bucket dispatcher over ``fn(params, padded, length, cfg)``
    (``padded`` a (P,) int64 tensor on the weights' device, ``length``
    the real token count). ``kind`` names the consumer in the over-cap
    error ("embedding", "scoring"); ``buckets`` are the public pad
    lengths. Results come back on the host."""

    def __init__(self, fn, params, cfg, buckets: tuple[int, ...], kind: str,
                 warmup: bool = True):
        self._fn = fn
        self.params = params
        # a serving forward keeps nothing for a backward: no remat
        self.cfg = dataclasses.replace(cfg, remat=False)
        self.buckets = tuple(sorted(buckets))
        self.kind = kind
        self.device = params["embed"].device
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        if warmup:
            self.warmup()

    def rows(self, bucket: int) -> int:
        """The padded length a bucket runs at: the bucket itself on the
        CPU, the next multiple of K2's tile on a card."""
        if self.device.type != "cuda":
            return bucket
        return -(-bucket // TILE) * TILE

    @contextlib.contextmanager
    def running(self):
        """One dispatch: the lock, no autograd, and on a card the
        dispatcher's own stream."""
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with self._lock, torch.inference_mode(), stream:
            yield

    def warmup(self) -> None:
        """Run every padded length once, now, on this thread, every row
        real (so what runs on the real rows alone, the scorer's lm_head
        and top-k, is launched too)."""
        for p in sorted({self.rows(b) for b in self.buckets}):
            with self.running():
                _to_host(self._fn(self.params, self._pad([], p), p,
                                  self.cfg))

    def _pad(self, ids: list[int], p: int) -> torch.Tensor:
        return torch.tensor(list(ids) + [0] * (p - len(ids)),
                            dtype=torch.int64, device=self.device)

    def dispatch(self, ids: list[int]):
        """Pad ``ids`` to its bucket and run the forward (serialized);
        returns the result on the host."""
        if not ids:
            raise ValueError("empty input")
        try:
            b = _bucket(len(ids), self.buckets)
        except ValueError:
            raise ValueError(
                f"input of {len(ids)} tokens exceeds the {self.kind} "
                f"bucket cap {self.buckets[-1]}"
            ) from None
        with self.running():
            return _to_host(self._fn(self.params,
                                     self._pad(ids, self.rows(b)), len(ids),
                                     self.cfg))
