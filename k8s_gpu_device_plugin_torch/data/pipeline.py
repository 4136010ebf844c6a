"""Token data pipeline with host-to-device prefetch.

Port of ``k8s_gpu_device_plugin_tpu/data/pipeline.py`` for one process:

- ``SyntheticSource`` and ``MemmapSource`` are copies: their numpy
  recipes keyed by ``(seed, step)`` give batches bit-identical to the
  reference's.
- ``DataLoader`` assembles each batch in a pinned host buffer (on a
  CUDA device) and copies it to the device without blocking, from the
  same prefetch thread, with the same ``seek``/``state``. Batches are
  ``{"inputs", "targets"}`` (B, S) int64 tensors on the device.
- ``make_token_source`` serves a corpus file through ``MemmapSource``;
  the reference's native C++ gather (``data/native_loader.py``) is not
  ported yet (ROADMAP A8) and its sampling recipe is the same, so the
  batches do not change.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Protocol

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.device import resolve_device


class TokenSource(Protocol):
    """Pure window server: (step, rows, seq_len) -> (rows, seq_len+1) int32,
    deterministic in ``step`` (resume depends on it)."""

    def windows(self, step: int, rows: slice, batch_rows: int,
                seq_len: int) -> np.ndarray: ...


class SyntheticSource:
    """Deterministic random tokens (benchmark default; zero IO)."""

    def __init__(self, vocab_size: int, seed: int = 0) -> None:
        self.vocab_size = vocab_size
        self.seed = seed

    def windows(self, step, rows, batch_rows, seq_len):
        rng = np.random.default_rng((self.seed, step))
        full = rng.integers(
            0, self.vocab_size, (batch_rows, seq_len + 1), dtype=np.int32
        )
        return full[rows]


class MemmapSource:
    """Flat binary token file (np.memmap) served as windows at
    pseudo-random offsets keyed by (seed, step)."""

    def __init__(self, path: str, dtype: str = "uint16", seed: int = 0) -> None:
        self.tokens = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        self.seed = seed
        if len(self.tokens) < 2:
            raise ValueError(f"token file {path} too small ({len(self.tokens)})")

    def windows(self, step, rows, batch_rows, seq_len):
        n = len(self.tokens) - (seq_len + 1)
        if n < 1:
            raise ValueError(
                f"corpus of {len(self.tokens)} tokens shorter than seq {seq_len}+1"
            )
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n + 1, size=batch_rows)[rows]
        return np.stack(
            [self.tokens[s : s + seq_len + 1] for s in starts]
        ).astype(np.int32)


class DataLoader:
    """Prefetching batch iterator for one device: yields
    ``{"inputs": (B, S), "targets": (B, S)}`` int64 tensors on
    ``device``; batch content is a pure function of the step."""

    def __init__(self, source: TokenSource, batch_size: int, seq_len: int,
                 device: "str | torch.device | None" = "cuda",
                 start_step: int = 0, prefetch: int = 2) -> None:
        self.source = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self._step = start_step
        self._prefetch = max(prefetch, 0)

    # --- resumability ---

    def state(self) -> dict:
        return {"step": self._step}

    def seek(self, step: int) -> None:
        self._step = step

    # --- batch production ---

    def _make_batch(self, step: int) -> dict:
        local = self.source.windows(
            step, slice(0, self.batch_size), self.batch_size, self.seq_len
        )
        host = torch.from_numpy(local)
        if self.device.type == "cuda":
            host = host.pin_memory()
        tokens = host.to(self.device, non_blocking=True).long()
        return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        if self._prefetch == 0:
            while True:
                batch = self._make_batch(self._step)
                self._step += 1
                yield batch
        else:
            yield from self._prefetch_iter()

    def _prefetch_iter(self) -> Iterator[dict]:
        """Background producer thread, bounded queue (double buffering)."""
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def produce(start: int) -> None:
            step = start
            try:
                while not stop.is_set():
                    q.put(("ok", step, self._make_batch(step)))
                    step += 1
            except Exception as e:  # noqa: BLE001 - surface on the consumer side
                q.put(("err", step, e))

        t = threading.Thread(
            target=produce, args=(self._step,), daemon=True, name="data-prefetch"
        )
        t.start()
        try:
            while True:
                kind, step, payload = q.get()
                if kind == "err":
                    raise payload
                self._step = step + 1
                yield payload
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def make_token_source(path: str, vocab_size: int, dtype: str = "uint16",
                      seed: int = 0) -> tuple[TokenSource, str]:
    """``(source, label)``: synthetic tokens without ``path``, else the
    memmap source over the file. A probe window is vocab-checked up
    front: out-of-vocab ids (a wrong ``dtype``, a corpus for a larger
    vocabulary) would otherwise index past the embedding table."""
    if not path:
        return SyntheticSource(vocab_size, seed=seed), "synthetic"
    source = MemmapSource(path, dtype=dtype, seed=seed)
    probe = source.windows(0, slice(0, 2), 2, 127)
    if int(probe.max()) >= vocab_size:
        raise ValueError(
            f"corpus {path} contains token id {int(probe.max())} >= "
            f"vocab_size {vocab_size} (wrong --dataDtype, or a corpus "
            "tokenized for a larger vocabulary)"
        )
    return source, "python-memmap"
