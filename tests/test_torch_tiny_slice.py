"""The default ``--preset tiny`` (head dim 16) as one slice: training fed
by the native gather, the trainer's step spans and profiler trace, and
serving, each against the JAX package.

- The port's ``Trainer`` and the reference's, from the same initial
  parameters (``params_from_jax``) over the same corpus, f32: every logged
  loss and ``grad_norm`` and the evals at atol 1e-5 (loss) and rtol 1e-5
  (``grad_norm``), the tolerances of ``test_torch_trainer.py``; both runs'
  spans (names, components, nesting, the ``step`` attribute) equal.
- The trace window ``[trace_start, trace_stop)``: steps 3-5 only, and a
  run that ends inside the window still closes and writes its trace. The
  reference test mirrored: ``tests/test_data_trainer.py``'s profiler case.
- The continuous batcher at the tiny preset in both packages: greedy
  streams equal (f32).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.models import trainer as jtrainer
from k8s_gpu_device_plugin_tpu.obs import trace as jtrace
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import trainer as ttrainer
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.obs import trace as ttrace

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

COMMON = dict(batch_size=8, seq_len=64, total_steps=6, log_every=1,
              learning_rate=1e-3, warmup_steps=1, eval_every=3,
              eval_batches=1, checkpoint_interval=3)


def _traced(tracer, run):
    """``run()`` with ``tracer`` on: (its result, every span record)."""
    spans: list = []
    was = tracer.enabled
    tracer.enabled = True
    tracer.add_listener(spans.append)
    try:
        return run(), spans
    finally:
        tracer.remove_listener(spans.append)
        tracer.enabled = was


def _shape(spans: list) -> list:
    """Each span as (name, component, parent's name, step), in the order
    the spans ended (the listener's): what the two trainers' loops must
    agree on."""
    names = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], s["component"], names.get(s["parent_id"]),
             (s["attrs"] or {}).get("step")) for s in spans]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    corpus = str(root / "corpus.bin")
    np.random.default_rng(5).integers(0, 512, 60_000).astype(
        np.uint16).tofile(corpus)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jtr = jtrainer.Trainer(jtrainer.TrainerConfig(
        model=jcfg, mesh=MeshSpec.for_devices(len(jax.devices())),
        data_file=corpus, checkpoint_dir=str(root / "jck"), **COMMON))
    jstate = jtrain.init_train_state(jax.random.key(0), jcfg, jtr.mesh,
                                     jtr.optimizer)
    np_params = jax.tree.map(np.asarray, jstate["params"])
    want, want_spans = _traced(jtrace.get_tracer(), jtr.run)

    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    assert tcfg.head_dim == 16
    trace_dir = str(root / "trace")
    ttr = ttrainer.Trainer(
        ttrainer.TrainerConfig(model=tcfg, device="cpu", data_file=corpus,
                               checkpoint_dir=str(root / "tck"),
                               trace_dir=trace_dir, **COMMON),
        params=params_from_jax(np_params, tcfg, device="cpu"))
    got, got_spans = _traced(ttrace.get_tracer(), ttr.run)
    return dict(want=want, want_spans=want_spans, got=got,
                got_spans=got_spans, trace_dir=trace_dir)


def test_tiny_training_matches_the_jax_trainer(runs):
    got, want = runs["got"], runs["want"]
    assert got.data_source == "native-memmap"
    assert got.steps_run == want.steps_run == 6
    assert len(got.metrics_history) == len(want.metrics_history)
    for g, w in zip(got.metrics_history, want.metrics_history):
        assert g["step"] == w["step"]
        if "eval" in w:
            np.testing.assert_allclose(g["eval"]["loss"], w["eval"]["loss"],
                                       atol=1e-5, rtol=0)
            continue
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got.final_eval[key], want.final_eval[key],
                                   atol=1e-5, rtol=0)


def test_step_spans_match_the_reference_trainer(runs):
    got, want = _shape(runs["got_spans"]), _shape(runs["want_spans"])
    assert got == want
    names = {name for name, *_ in got}
    assert names == {"train_step", "data_load", "step_dispatch",
                     "checkpoint", "eval"}
    assert {c for _, c, *_ in got} == {"trainer"}
    assert [s for n, _, p, s in got if n == "train_step"] == list(range(6))
    assert all(p == "train_step" for n, _, p, _ in got if n != "train_step")


def test_trace_covers_steps_3_to_5_only(runs):
    files = os.listdir(runs["trace_dir"])
    assert files == ["train_steps_3_5.json"]
    with open(os.path.join(runs["trace_dir"], files[0])) as f:
        events = json.load(f)["traceEvents"]
    marked = {int(m.group(1)) for e in events
              if (m := re.fullmatch(r"train_step#(\d+)", e.get("name", "")))}
    assert marked == {3, 4, 5}
    assert any(e.get("name", "").startswith("aten::") for e in events)


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


@pytest.mark.parametrize("stop_early", [False, True],
                         ids=["short_run", "exception"])
def test_a_run_that_ends_inside_the_window_closes_its_trace(tmp_path,
                                                            stop_early):
    """A run of 5 steps (0-4) against the window [3, 6), and a run that an
    exception stops after step 3: the profile stops on the way out and
    is written for the steps it saw."""
    trace_dir = str(tmp_path / "trace")
    tr = ttrainer.Trainer(ttrainer.TrainerConfig(
        seq_len=16, batch_size=2, total_steps=5, device="cpu",
        trace_dir=trace_dir))

    def on_step(step, metrics):
        assert _profiling() == (step in (4, 5))
        if stop_early and step == 4:
            raise KeyboardInterrupt

    if stop_early:
        with pytest.raises(KeyboardInterrupt):
            tr.run(on_step=on_step)
    else:
        tr.run(on_step=on_step)
    assert not _profiling()
    last = 3 if stop_early else 4
    assert os.listdir(trace_dir) == [f"train_steps_3_{last}.json"]


def test_cli_writes_step_spans_and_a_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert ttrainer._main(["--preset", "tiny", "--steps", "7", "--seqLen",
                           "16", "--batchSize", "2", "--traceDir",
                           str(trace_dir), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("trainer: steps=7 ")
    assert sorted(os.listdir(trace_dir)) == ["train_steps_3_5.json",
                                             "trainer_spans.json"]
    with open(trace_dir / "trainer_spans.json") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["args"]["step"] for e in spans
                  if e["name"] == "train_step") == list(range(7))
    assert sum(e["name"] == "step_dispatch" for e in spans) == 7
    assert not ttrace.get_tracer().enabled  # the CLI restores the tracer


def test_tiny_batcher_streams_match_the_reference():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(9)
    specs = [(5, 9), (30, 12), (70, 7)]
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n, _ in specs]
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, n_slots=2, max_len=128,
                                   chunked_prefill=16, pipeline_depth=0)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=128,
                                   chunked_prefill=16)
    jr = [jcb.submit(p, max_new=m) for p, (_, m) in zip(prompts, specs)]
    tr = [tcb.submit(p, max_new=m) for p, (_, m) in zip(prompts, specs)]
    jcb.run()
    tcb.run()
    for a, b, (_, m) in zip(jr, tr, specs):
        got, want = tcb.done_requests[b].out, jcb.done_requests[a].out
        assert len(got) == m and got == want
