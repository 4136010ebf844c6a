"""End-to-end training driver: data pipeline + train step + eval.

Port of ``k8s_gpu_device_plugin_tpu/models/trainer.py`` for one card.
``Trainer.run`` keeps the reference's loop: the tokens/s clock starts
after step 0 (warm-up) and pauses for evaluation; eval runs every
``eval_every`` steps and after the last one over the same validation
batches. With ``checkpoint_dir`` a run resumes from the directory's
latest step (state and data stream), saves on the checkpointer's cadence
after every step and always saves its final state
(``models/checkpoint.py``).

Tracing, as the reference's loop: every step is a ``train_step`` span
(component ``trainer``, attribute ``step``) holding ``data_load``,
``step_dispatch`` and, when they run, ``checkpoint`` and ``eval``
(``obs/trace.py``; recorded when the process tracer is enabled). With
``trace_dir`` the steps ``[trace_start, trace_stop)`` run under
``torch.profiler`` (CPU activity, and the card's on CUDA), each step
marked ``train_step#<step>``, and the profile is written into
``trace_dir`` as a Chrome/Perfetto JSON trace; a run that ends early
still closes and writes it. The CLI's ``--traceDir`` also turns the
tracer on and writes the run's spans there (``trainer_spans.json``).
Meshes and multi-host runs are not ported yet; the CLI refuses their
flags, naming the ROADMAP item.

    python -m k8s_gpu_device_plugin_torch.models.trainer --preset tiny \\
        --steps 20 --device cpu --checkpointDir /tmp/run --traceDir /tmp/tr
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import sys
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch

from k8s_gpu_device_plugin_torch.data.pipeline import (
    DataLoader,
    make_token_source,
)
from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.checkpoint import TrainCheckpointer
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.train import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    refuse_tp_training,
)
from k8s_gpu_device_plugin_torch.obs.export import to_chrome_trace
from k8s_gpu_device_plugin_torch.obs.trace import configure, get_tracer
from k8s_gpu_device_plugin_torch.ops import flash_attention, kernel_support
from k8s_gpu_device_plugin_torch.utils.log import get_logger


@dataclass
class TrainerConfig:
    """Everything a run needs; defaults give a laptop-size smoke run."""

    model: LlamaConfig = field(default_factory=lambda: LlamaConfig.tiny(n_layers=2))
    batch_size: int = 8
    seq_len: int = 128
    # microbatches per optimizer update (1 = no accumulation)
    grad_accum: int = 1
    total_steps: int = 20
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    # held-out evaluation (0 disables): every eval_every steps and after
    # the last step, over eval_batches deterministic validation batches;
    # eval_micro chunks each eval batch (0 = follow grad_accum)
    eval_every: int = 0
    eval_batches: int = 4
    eval_micro: int = 0
    log_every: int = 10
    # checkpoint/resume ("" disables): saves every checkpoint_interval
    # steps and at the end, keeping the newest max_checkpoints
    checkpoint_dir: str = ""
    checkpoint_interval: int = 1000
    max_checkpoints: int = 3
    opt_impl: str = "optax"
    # profiling ("" disables): a torch.profiler trace of steps
    # [trace_start, trace_stop) written into trace_dir
    trace_dir: str = ""
    trace_start: int = 3
    trace_stop: int = 6
    # token corpus ("" = synthetic)
    data_file: str = ""
    data_dtype: str = "uint16"
    device: str = "cuda"


@dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    tokens_per_second: float
    metrics_history: list
    final_eval: "dict | None" = None  # {"loss", "perplexity", "accuracy"}
    data_source: str = "synthetic"
    resumed_from: "int | None" = None


class Trainer:
    """Owns one training run. ``params`` replaces the random initial
    parameters (tests start both frameworks from the same numbers). On
    the card, a config whose attention the flash kernels do not take
    (head dim, sequence length, dtype) is refused here, at startup.
    After ``run`` the final state is ``self.state``."""

    def __init__(self, cfg: TrainerConfig,
                 loader: "DataLoader | None" = None,
                 eval_loader: "DataLoader | None" = None,
                 logger: "logging.Logger | None" = None,
                 params: "dict | None" = None) -> None:
        self.cfg = cfg
        self.log = logger or get_logger()
        refuse_tp_training(cfg.model)
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            m = cfg.model
            why = flash_attention.shape_refusal(
                seq_len=cfg.seq_len, n_heads=m.n_heads,
                n_kv_heads=m.n_kv_heads, head_dim=m.head_dim, dtype=m.dtype)
            if why is not None:
                raise ValueError(
                    f"the flash-attention kernels do not take this config on "
                    f"the card: {why}"
                )
        self.optimizer = make_optimizer(
            learning_rate=cfg.learning_rate,
            warmup_steps=cfg.warmup_steps,
            total_steps=cfg.total_steps,
            impl=cfg.opt_impl,
        )
        # a fused cross-entropy has no logits to take an accuracy from
        self.step_fn = make_train_step(cfg.model, self.optimizer,
                                       with_accuracy=not cfg.model.fused_ce,
                                       grad_accum=cfg.grad_accum)
        self._params = params
        if loader is not None:
            self.loader = loader
            self.data_source_label = "caller-provided"
        else:
            source, self.data_source_label = make_token_source(
                cfg.data_file, cfg.model.vocab_size, dtype=cfg.data_dtype
            )
            self.loader = DataLoader(source, cfg.batch_size, cfg.seq_len,
                                     self.device)
        self.eval_loader: "DataLoader | None" = None
        self.eval_step_fn = None
        if eval_loader is not None and cfg.eval_every <= 0:
            raise ValueError(
                "eval_loader passed but eval_every is 0 — the loader would "
                "be silently ignored; set eval_every > 0"
            )
        if cfg.eval_every > 0:
            if cfg.eval_batches < 1:
                raise ValueError(
                    f"eval_batches must be >= 1 when eval_every > 0, got "
                    f"{cfg.eval_batches}"
                )
            # held-out stream: seed 1 of the same source kind, no prefetch
            # (every pass restarts at step 0 and scores the same batches)
            if eval_loader is not None:
                self.eval_loader = eval_loader
            else:
                eval_source, _ = make_token_source(
                    cfg.data_file, cfg.model.vocab_size,
                    dtype=cfg.data_dtype, seed=1,
                )
                self.eval_loader = DataLoader(eval_source, cfg.batch_size,
                                              cfg.seq_len, self.device,
                                              prefetch=0)
            self.eval_step_fn = make_eval_step(
                cfg.model, micro=cfg.eval_micro or cfg.grad_accum
            )
        self.ckpt: "TrainCheckpointer | None" = None
        if cfg.checkpoint_dir:
            self.ckpt = TrainCheckpointer(
                cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
                save_interval=cfg.checkpoint_interval, logger=self.log)
        self.state: "dict | None" = None

    def _init_or_resume(self) -> "tuple[dict, int | None]":
        state = init_train_state(self.cfg.model, self.optimizer,
                                 device=self.device, params=self._params)
        resumed_from = None
        if self.ckpt is not None:
            state, resumed = self.ckpt.restore_or_pass(state)
            if resumed:
                resumed_from = int(state["step"])
                self.loader.seek(resumed_from)
        return state, resumed_from

    def _evaluate(self, params) -> dict:
        """Mean held-out metrics over ``eval_batches`` batches from step 0."""
        assert self.eval_loader is not None and self.eval_step_fn is not None
        self.eval_loader.seek(0)
        it = iter(self.eval_loader)
        loss_sum, acc_sum = 0.0, 0.0
        for _ in range(self.cfg.eval_batches):
            m = self.eval_step_fn(params, next(it))
            loss_sum += float(m["loss"])
            acc_sum += float(m["accuracy"])
        loss = loss_sum / self.cfg.eval_batches
        return {
            "loss": loss,
            "perplexity": math.exp(min(loss, 700.0)),
            "accuracy": acc_sum / self.cfg.eval_batches,
        }

    def run(self, on_step: "Callable[[int, dict], None] | None" = None
            ) -> TrainResult:
        cfg = self.cfg
        state, resumed_from = self._init_or_resume()
        self.state = state
        start_step = int(state["step"])
        history: list = []
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        it = iter(self.loader)
        metrics: "dict[str, Any]" = {}
        t_start = None
        steps_timed = 0
        eval_seconds = 0.0
        profile = None  # the torch.profiler run of [trace_start, trace_stop)
        # step-phase spans (obs/): what the host spends a step (data wait,
        # dispatch, checkpoint, eval); the device's split is the profile's
        tr = get_tracer()
        try:
            for step in range(start_step, cfg.total_steps):
                if cfg.trace_dir and step == cfg.trace_start:
                    profile = self._start_profile()
                with tr.span("train_step", component="trainer", step=step):
                    marker = (torch.profiler.record_function(
                        f"train_step#{step}") if profile is not None
                        else contextlib.nullcontext())
                    with marker:
                        with tr.span("data_load", component="trainer"):
                            batch = next(it)
                        with tr.span("step_dispatch", component="trainer"):
                            state, metrics = self.step_fn(state, batch)
                    if step + 1 == cfg.trace_stop and profile is not None:
                        self._stop_profile(profile, step)
                        profile = None
                    if t_start is None:
                        # the clock starts once the run's first step has
                        # finished (warm-up)
                        float(metrics["loss"])
                        t_start = time.perf_counter()
                    else:
                        steps_timed += 1
                    if self.ckpt is not None:
                        with tr.span("checkpoint", component="trainer"):
                            self.ckpt.save(state, step=step + 1)
                    if (step + 1) % cfg.log_every == 0 \
                            or step + 1 == cfg.total_steps:
                        snap = {"step": step + 1,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])}
                        history.append(snap)
                        self.log.info("train step", extra={"fields": snap})
                    if (self.eval_loader is not None
                            and (step + 1) % cfg.eval_every == 0
                            and step + 1 != cfg.total_steps):
                        # (the final eval is below) finish in-flight
                        # work, then pause the clock
                        float(metrics["loss"])
                        t_eval = time.perf_counter()
                        with tr.span("eval", component="trainer"):
                            ev = self._evaluate(state["params"])
                        eval_seconds += time.perf_counter() - t_eval
                        self.log.info("eval", extra={
                            "fields": {"step": step + 1, **ev}})
                        history.append({"step": step + 1, "eval": ev})
                    if on_step is not None:
                        on_step(step + 1, metrics)
        finally:
            if profile is not None:  # a run that ended inside the window
                self._stop_profile(profile, int(state["step"]) - 1)
            if self.ckpt is not None:
                # the final state is always recoverable, cadence
                # notwithstanding (a run stopped between steps too); a
                # state that an exception left half updated is not
                if int(state["step"]) > start_step and _whole(state):
                    self.ckpt.save(state, force=True)
                self.ckpt.wait()
        final_loss = float(metrics["loss"]) if metrics else float("nan")
        elapsed = time.perf_counter() - t_start - eval_seconds if t_start else 0.0
        tps = tokens_per_batch * steps_timed / elapsed if elapsed > 0 else 0.0
        final_eval = None
        if self.eval_loader is not None and cfg.total_steps > start_step:
            final_eval = self._evaluate(state["params"])
            self.log.info("final eval",
                          extra={"fields": {"step": cfg.total_steps, **final_eval}})
        return TrainResult(
            steps_run=cfg.total_steps - start_step,
            final_loss=final_loss,
            tokens_per_second=tps,
            metrics_history=history,
            final_eval=final_eval,
            data_source=self.data_source_label,
            resumed_from=resumed_from,
        )

    def _start_profile(self) -> "torch.profiler.profile":
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=activities)
        profile.start()
        return profile

    def _stop_profile(self, profile: "torch.profiler.profile",
                      last_step: int) -> None:
        """Stop ``profile`` once the card has finished the traced steps
        and write it as ``trace_dir/train_steps_<first>_<last>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profile.stop()
        os.makedirs(self.cfg.trace_dir, exist_ok=True)
        path = os.path.join(
            self.cfg.trace_dir,
            f"train_steps_{self.cfg.trace_start}_{last_step}.json")
        profile.export_chrome_trace(path)
        self.log.info("trace written", extra={
            "fields": {"dir": self.cfg.trace_dir, "file": path}})


def _whole(state: dict) -> bool:
    """Whether no step is half applied to ``state``: the optimizer counts
    its update before it writes the leaves one at a time, and the step
    counter moves last (``models/train.py``), so an exception inside a
    step leaves the two apart."""
    return int(state["opt_state"]["count"]) == int(state["step"])


PRESETS = {
    "tiny": LlamaConfig.tiny,
    "llama3_8b": LlamaConfig.llama3_8b,
    "llama3_70b": LlamaConfig.llama3_70b,
    "mistral_7b": LlamaConfig.mistral_7b,
}


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    parser = argparse.ArgumentParser(prog="torch-trainer")
    parser.add_argument("--preset", default="tiny",
                        choices=[*PRESETS, "mixtral_8x7b"])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batchSize", type=int, default=8)
    parser.add_argument("--seqLen", type=int, default=128)
    parser.add_argument("--gradAccum", type=int, default=1,
                        help="microbatches per optimizer update (splits the "
                        "batch; grads accumulate in f32)")
    parser.add_argument("--evalEvery", type=int, default=0,
                        help="held-out eval cadence in steps (0 = off)")
    parser.add_argument("--evalBatches", type=int, default=4)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--pp", type=int, default=1)
    parser.add_argument("--ep", type=int, default=1)
    parser.add_argument("--fsdp", type=int, default=None)
    parser.add_argument("--numSlices", type=int, default=1)
    parser.add_argument("--checkpointDir", default="",
                        help="resume from this directory's latest step "
                        "and save into it (empty = no checkpoints)")
    parser.add_argument("--checkpointInterval", type=int, default=1000,
                        help="save every this many steps (and always "
                        "after the last)")
    parser.add_argument("--traceDir", default="")
    parser.add_argument("--quant", default="none", choices=["none", "int8"])
    parser.add_argument("--masterWeights", action="store_true",
                        help="store params/grads/optimizer moments in f32 "
                        "(bf16 compute); keeps updates smaller than a bf16 "
                        "ulp at 2x parameter memory")
    parser.add_argument("--optImpl", default="optax",
                        choices=["optax", "fused"])
    parser.add_argument("--dataFile", default="",
                        help="flat binary token corpus (empty = synthetic)")
    parser.add_argument("--dataDtype", default="uint16",
                        choices=["uint16", "uint32"])
    parser.add_argument("--fusedCE", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def _refusal(args: argparse.Namespace) -> "str | None":
    """The first flag the port does not serve yet, as an error naming its
    ROADMAP item; None when every flag is served."""
    for flag in ("tp", "sp", "pp", "ep", "fsdp", "numSlices"):
        value = getattr(args, flag)
        if value is not None and value > 1:
            return (f"--{flag} {value}: parallel training is not ported yet "
                    "(ROADMAP A.13); the port trains on one card")
    checks = (
        (args.preset == "mixtral_8x7b", "--preset mixtral_8x7b: its "
         "params, grads and Adam state take about 747 GB, which is "
         "parallel training, not ported yet (ROADMAP A.13); the tiny "
         "MoE trains in process (models/train.py)"),
    )
    return next((why for bad, why in checks if bad), None)


def _main(argv: "list[str] | None" = None) -> int:
    """CLI: run a (default tiny, synthetic) training job on one card."""
    parser = build_parser()
    args = parser.parse_args(argv)
    why = _refusal(args)
    if why:
        parser.error(why)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    model = replace(PRESETS[args.preset](), quant=args.quant,
                    fused_ce=args.fusedCE,
                    param_dtype=torch.float32 if args.masterWeights else None)
    cfg = TrainerConfig(
        model=model,
        batch_size=args.batchSize,
        seq_len=args.seqLen,
        grad_accum=args.gradAccum,
        eval_every=args.evalEvery,
        eval_batches=args.evalBatches,
        total_steps=args.steps,
        opt_impl=args.optImpl,
        checkpoint_dir=args.checkpointDir,
        checkpoint_interval=args.checkpointInterval,
        trace_dir=args.traceDir,
        data_file=args.dataFile,
        data_dtype=args.dataDtype,
        device=str(device),
    )
    try:
        trainer = Trainer(cfg)
    except ValueError as e:  # a config the card's kernels do not take
        print(f"error: {e}", file=sys.stderr)
        return 2
    spans: list = []
    tracer = get_tracer()
    was_enabled = tracer.enabled
    if args.traceDir:  # the run's step spans beside its profile
        configure(enabled=True)
        tracer.add_listener(spans.append)
    try:
        result = trainer.run()
    finally:
        if args.traceDir:
            tracer.remove_listener(spans.append)
            configure(enabled=was_enabled)
    if args.traceDir:
        path = os.path.join(args.traceDir, "trainer_spans.json")
        os.makedirs(args.traceDir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(to_chrome_trace(spans), f)
        trainer.log.info("spans written", extra={
            "fields": {"file": path, "spans": len(spans)}})
    # the hand-written kernels this process launched (empty on the CPU)
    trainer.log.info("kernel launches", extra={
        "fields": {"launches": kernel_support.launch_counts()}})
    eval_str = (
        f" eval_loss={result.final_eval['loss']:.4f}"
        f" ppl={result.final_eval['perplexity']:.2f}"
        if result.final_eval else ""
    )
    print(
        f"trainer: steps={result.steps_run} loss={result.final_loss:.4f} "
        f"tokens/s={result.tokens_per_second:.0f} "
        f"resumed_from={result.resumed_from} data={result.data_source}"
        f"{eval_str}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
