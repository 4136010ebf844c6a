"""Checkpoint/resume for training runs, on ``torch.save``.

Port of ``k8s_gpu_device_plugin_tpu/models/checkpoint.py``. The reference
rides on orbax, which imports JAX; the port keeps the reference's public
surface (``TrainCheckpointer``: cadence, retention, async commit,
``restore`` / ``restore_unstructured`` / ``restore_or_pass``) over a
format of its own:

- **Layout.** One directory a step, ``<dir>/<step>/``, holding one
  ``torch.save`` file a top-level key of the state (``params.pt``,
  ``opt_state.pt``, ``lora.pt``, ...) and ``meta.json`` (format, step,
  keys, bytes). A reader takes only the keys it wants: serving reads
  ``params`` and never the optimizer's moments.
- **Atomic commit.** A step is written into a hidden temporary directory
  and renamed to ``<dir>/<step>`` (``os.replace``) once every file is on
  disk; a step is listed only when its ``meta.json`` is there, so a
  partial write is never seen. Retention renames a step away before it
  deletes it.
- **Async save, in-place state.** The port's train step updates the
  parameters and moments IN PLACE (``models/train.py``), so ``save``
  copies every tensor to host memory (contiguous, so a view does not
  drag its whole storage into the file) before it returns; only the file
  write runs on the background thread. A checkpoint of step n therefore
  holds step n's numbers even when step n + 1 runs during its write.
- **Moments by name.** ``opt_state``'s per-leaf lists (``mu``, ``nu``,
  in ``param_leaves`` order) are written keyed by the leaf's dotted name
  in the state's ``params`` (or ``lora``) tree, and read back by name
  into the target's order: a target with other leaves is refused, never
  given another leaf's moments.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
from typing import Any, NamedTuple

import torch

from k8s_gpu_device_plugin_torch.utils.log import get_logger

FORMAT = 1
META = "meta.json"
#: the state's keys whose leaves the optimizer's moment lists follow
_PARAM_KEYS = ("params", "lora")
_MOMENT_KEYS = ("mu", "nu")


class TensorSpec(NamedTuple):
    """Shape, dtype and device of a live tensor: a restore target leaf."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def abstract_like(state: Any) -> Any:
    """The state's skeleton (each tensor a :class:`TensorSpec`, other
    leaves kept): a restore target that holds no tensor memory."""
    if isinstance(state, TensorSpec):
        return state
    if isinstance(state, dict):
        return {k: abstract_like(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(abstract_like(v) for v in state)
    if isinstance(state, torch.Tensor):
        return TensorSpec(tuple(state.shape), state.dtype, state.device)
    return state


def leaf_names(tree: dict, prefix: str = "") -> list:
    """The dotted name of every tensor leaf, in ``param_leaves`` order."""
    out = []
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.extend(leaf_names(value, name + "."))
        else:
            out.append(name)
    return out


def _param_tree(state: dict) -> "dict | None":
    return next((state[k] for k in _PARAM_KEYS
                 if isinstance(state.get(k), dict)), None)


def _host_copy(x: Any) -> Any:
    """A tree's tensors copied to host memory, contiguous and detached
    (a synchronous copy: it is done when this returns)."""
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type == "cpu":
            return x.clone(memory_format=torch.contiguous_format)
        return x.to("cpu").contiguous()
    return x


def _named_moments(opt_state: dict, names: list) -> dict:
    """``opt_state`` with each moment list keyed by leaf name."""
    out = dict(opt_state)
    for key in _MOMENT_KEYS:
        moments = opt_state.get(key)
        if isinstance(moments, (list, tuple)):
            if len(moments) != len(names):
                raise ValueError(
                    f"opt_state.{key} has {len(moments)} moments for "
                    f"{len(names)} parameter leaves")
            out[key] = dict(zip(names, moments))
    return out


def _listed_moments(opt_state: dict, names: list) -> dict:
    """The inverse of :func:`_named_moments`, in ``names``' order;
    refuses a checkpoint whose leaves are not exactly ``names``."""
    out = dict(opt_state)
    for key in _MOMENT_KEYS:
        moments = opt_state.get(key)
        if isinstance(moments, dict):
            missing = [n for n in names if n not in moments]
            extra = [n for n in moments if n not in names]
            if missing or extra:
                raise ValueError(
                    f"opt_state.{key}: the checkpoint's leaves do not match "
                    f"the target's (missing {missing}, unexpected {extra})")
            out[key] = [moments[n] for n in names]
    return out


def _tree_bytes(x: Any) -> int:
    if isinstance(x, dict):
        return sum(_tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tree_bytes(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _place(loaded: Any, target: Any, path: str) -> Any:
    """``loaded`` (host tensors) on each target leaf's device and dtype;
    a shape or structure mismatch raises, naming the leaf."""
    if isinstance(target, (torch.Tensor, TensorSpec)):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"{path}: the checkpoint holds no tensor")
        if tuple(loaded.shape) != tuple(target.shape):
            raise ValueError(f"{path}: checkpoint shape "
                             f"{tuple(loaded.shape)}, target "
                             f"{tuple(target.shape)}")
        return loaded.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded)
            raise ValueError(f"{path or 'state'}: checkpoint keys {got}, "
                             f"target keys {sorted(target)}")
        return {k: _place(loaded[k], v, f"{path}.{k}" if path else k)
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or \
                len(loaded) != len(target):
            raise ValueError(f"{path}: checkpoint and target lengths differ")
        return type(target)(_place(a, b, f"{path}[{i}]")
                            for i, (a, b) in enumerate(zip(loaded, target)))
    return loaded


def _copy_into(dst: Any, src: Any) -> None:
    """Copy ``src``'s tensors into ``dst``'s (same structure) in place."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            if isinstance(v, torch.Tensor):
                v.copy_(src[k])
            elif isinstance(v, (dict, list)):
                _copy_into(v, src[k])
            else:
                dst[k] = src[k]
    elif isinstance(dst, list):
        for i, v in enumerate(dst):
            if isinstance(v, torch.Tensor):
                v.copy_(src[i])
            elif isinstance(v, (dict, list)):
                _copy_into(v, src[i])
            else:
                dst[i] = src[i]


class TrainCheckpointer:
    """Save/restore a training-state tree ({"params" or "lora",
    "opt_state", "step"}): cadence (``save_interval``), retention
    (``max_to_keep``, None keeps all) and an async file write."""

    def __init__(self, directory: str, max_to_keep: "int | None" = 3,
                 save_interval: int = 1000, async_save: bool = True,
                 logger: "logging.Logger | None" = None) -> None:
        self.log = logger or get_logger()
        # created by the first save: a reader never makes a directory
        self._dir = os.path.abspath(directory)
        self._interval = max(int(save_interval), 1)
        self._keep = max_to_keep
        self._async = async_save
        self._writer: "threading.Thread | None" = None
        self._error: "BaseException | None" = None
        #: the last save's step, bytes, seconds until save() returned
        #: (``save_s``: the host copy) and until the commit (``write_s``)
        self.last_save: "dict | None" = None
        #: the last restore's step, seconds and bytes
        self.last_restore: "dict | None" = None

    # --- inspection ---

    @property
    def directory(self) -> str:
        return self._dir

    def all_steps(self) -> list:
        """Committed steps, ascending (a temporary or half-deleted
        directory is not one)."""
        if not os.path.isdir(self._dir):
            return []
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self._dir, name, META)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> "int | None":
        steps = self.all_steps()
        return steps[-1] if steps else None

    # --- save ---

    def save(self, state: dict, step: "int | None" = None,
             force: bool = False) -> bool:
        """Save if the cadence (``step % save_interval == 0``) or
        ``force`` says so; returns True if saved, False for a step
        already on disk. Every tensor is on the host when this returns;
        with ``async_save`` the write commits in the background
        (``wait()`` joins it)."""
        if step is None:
            step = int(state["step"])
        if not force and step % self._interval:
            return False
        t0 = time.perf_counter()
        self.wait()  # one write in flight; its step is listed after it
        if step in self.all_steps():
            return False
        host = _host_copy(state)
        tree = _param_tree(host)
        if isinstance(host.get("opt_state"), dict) and tree is not None:
            host["opt_state"] = _named_moments(host["opt_state"],
                                               leaf_names(tree))
        stats = {"step": step, "bytes": _tree_bytes(host)}
        self.last_save = stats
        if self._async:
            self._writer = threading.Thread(
                target=self._write, args=(host, step, stats, t0),
                name="checkpoint-writer")
            self._writer.start()
        else:
            self._write(host, step, stats, t0)
            self._raise_error()
        stats["save_s"] = time.perf_counter() - t0
        self.log.info("checkpoint saved",
                      extra={"fields": {"step": step, "dir": self._dir}})
        return True

    def _write(self, host: dict, step: int, stats: dict, t0: float) -> None:
        tmp = os.path.join(self._dir, f".tmp-{step}-{uuid.uuid4().hex}")
        try:
            os.makedirs(tmp)
            for key, value in host.items():
                torch.save(value, os.path.join(tmp, f"{key}.pt"))
            meta = {"format": FORMAT, "step": step, "keys": list(host),
                    "bytes": stats["bytes"]}
            with open(os.path.join(tmp, META), "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(self._dir, str(step)))
            stats["write_s"] = time.perf_counter() - t0
            self._prune()
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def _prune(self) -> None:
        if self._keep is None:
            return
        for step in self.all_steps()[:-self._keep or None]:
            # renamed first: a reader never lists a half-deleted step
            gone = os.path.join(self._dir, f".del-{step}-{uuid.uuid4().hex}")
            os.replace(os.path.join(self._dir, str(step)), gone)
            shutil.rmtree(gone, ignore_errors=True)

    # --- restore ---

    def _step_or_latest(self, step: "int | None") -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        return step

    def _load(self, step: int, keys=None) -> dict:
        path = os.path.join(self._dir, str(step))
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: checkpoint format "
                             f"{meta.get('format')!r}, this reader "
                             f"takes {FORMAT}")
        want = meta["keys"] if keys is None else list(keys)
        missing = [k for k in want if k not in meta["keys"]]
        if missing:
            raise KeyError(f"{path} holds {meta['keys']}, not {missing}")
        # mmap: a leaf's pages are read when it is placed, so a tree is
        # never whole in host memory on its way to the device
        return {k: torch.load(os.path.join(path, f"{k}.pt"),
                              map_location="cpu", weights_only=True,
                              mmap=True)
                for k in want}

    def _restored(self, target: dict, step: int) -> dict:
        loaded = self._load(step, keys=list(target))
        tree = _param_tree(target)
        if isinstance(loaded.get("opt_state"), dict) and tree is not None:
            loaded["opt_state"] = _listed_moments(loaded["opt_state"],
                                                  leaf_names(tree))
        return _place(loaded, target, "")

    def _restore_done(self, step: int, tree: dict, t0: float) -> None:
        self.last_restore = {"step": step, "bytes": _tree_bytes(tree),
                             "seconds": time.perf_counter() - t0}
        self.log.info("checkpoint restored", extra={"fields": {"step": step}})

    def restore(self, target: dict, step: "int | None" = None) -> dict:
        """A new state of ``target``'s structure, shapes, dtypes and
        devices (``target``: a live state or :func:`abstract_like`'s
        skeleton) from ``step`` (default the latest)."""
        t0 = time.perf_counter()
        step = self._step_or_latest(step)
        out = self._restored(abstract_like(target), step)
        self._restore_done(step, out, t0)
        return out

    def restore_unstructured(self, step: "int | None" = None,
                             keys=None) -> dict:
        """The saved tree as written (host tensors, moments keyed by leaf
        name), without a target; ``keys`` reads only those top-level
        keys (``("params",)`` for serving)."""
        step = self._step_or_latest(step)
        tree = self._load(step, keys)
        self.log.info("checkpoint restored (unstructured)",
                      extra={"fields": {"step": step}})
        return tree

    def restore_or_pass(self, state: dict) -> tuple:
        """Resume from the latest checkpoint if one exists, else keep the
        freshly initialized ``state``; returns (state, resumed). The
        checkpoint is copied INTO ``state``'s tensors (their devices and
        dtypes) a leaf at a time from the memory-mapped files, so
        resuming never holds two states on the device."""
        t0 = time.perf_counter()
        step = self.latest_step()
        if step is None:
            return state, False
        host = self._restored(_on_host(abstract_like(state)), step)
        _copy_into(state, host)
        self._restore_done(step, state, t0)
        return state, True

    # --- lifecycle ---

    def _raise_error(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Join the in-flight write; re-raises its error, if any."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        self._raise_error()

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _on_host(skeleton: Any) -> Any:
    """A skeleton's specs moved to the host (dtypes kept)."""
    if isinstance(skeleton, TensorSpec):
        return skeleton._replace(device=torch.device("cpu"))
    if isinstance(skeleton, dict):
        return {k: _on_host(v) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_on_host(v) for v in skeleton)
    return skeleton
