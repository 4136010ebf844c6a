"""The port's data pipeline and trainer against the JAX reference's.

Token sources are held bit-identical (the same numpy recipes keyed by
``(seed, step)``). ``Trainer.run`` on a tiny f32 config starts from the
JAX trainer's own initial parameters and is held against the JAX
``Trainer`` on the same synthetic stream: every logged loss and
``grad_norm`` and the final eval metrics, at f32 atol 1e-5 (loss) and
rtol 1e-5 (``grad_norm``), the tolerances of ``test_torch_train.py``.
The CLI's refusals, its exit without CUDA and the startup refusal of a
config the card's kernels do not take are checked here too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.data import pipeline as jpipe
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.models import trainer as jtrainer
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec
from k8s_gpu_device_plugin_torch.data import native_loader
from k8s_gpu_device_plugin_torch.data import pipeline as tpipe
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import trainer as ttrainer
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.train import param_leaves

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

DIMS = dict(d_model=256, n_heads=4, n_kv_heads=2)


def test_synthetic_source_is_bit_identical():
    for seed, step in ((0, 0), (7, 3), (1, 12)):
        want = jpipe.SyntheticSource(300, seed=seed).windows(
            step, slice(0, 4), 4, 16)
        got = tpipe.SyntheticSource(300, seed=seed).windows(
            step, slice(0, 4), 4, 16)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_memmap_source_is_bit_identical(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000, dtype=np.uint16).tofile(path)
    for step in range(3):
        want = jpipe.MemmapSource(str(path), seed=2).windows(
            step, slice(0, 3), 3, 40)
        got = tpipe.MemmapSource(str(path), seed=2).windows(
            step, slice(0, 3), 3, 40)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="shorter than"):
        tpipe.MemmapSource(str(path)).windows(0, slice(0, 1), 1, 6000)


def test_token_source_refuses_out_of_vocab_corpus(tmp_path):
    path = tmp_path / "corpus.bin"
    np.full(1000, 700, dtype=np.uint16).tofile(path)
    with pytest.raises(ValueError, match="vocab_size"):
        tpipe.make_token_source(str(path), 512)
    source, label = tpipe.make_token_source(str(path), 1024)
    # the factory takes the C++ gather wherever a C++ compiler is present
    # (data/native_loader.py), the Python memmap only without one
    if native_loader.native_available():
        assert label == "native-memmap"
        assert isinstance(source, native_loader.NativeMemmapSource)
        source.close()
    else:
        assert label == "python-memmap"
        assert isinstance(source, tpipe.MemmapSource)


def test_loader_batches_seek_and_prefetch():
    def loader(prefetch):
        return tpipe.DataLoader(tpipe.SyntheticSource(100, seed=3), 4, 16,
                                device="cpu", prefetch=prefetch)

    plain = loader(0)
    it = iter(plain)
    batches = [next(it) for _ in range(4)]
    assert plain.state() == {"step": 4}
    b0 = batches[0]
    assert b0["inputs"].shape == (4, 16) and b0["inputs"].dtype == torch.int64
    assert torch.equal(b0["inputs"][:, 1:], b0["targets"][:, :-1])
    want = jpipe.SyntheticSource(100, seed=3).windows(2, slice(0, 4), 4, 16)
    assert np.array_equal(batches[2]["inputs"].numpy(), want[:, :-1])
    resumed = loader(0)
    resumed.seek(2)
    assert torch.equal(next(iter(resumed))["targets"], batches[2]["targets"])
    for a, b in zip(batches, iter(loader(2))):
        assert torch.equal(a["inputs"], b["inputs"])


COMMON = dict(batch_size=8, seq_len=32, total_steps=4, log_every=1,
              learning_rate=1e-3, warmup_steps=1, eval_every=2,
              eval_batches=1)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's uninterrupted run and its initial parameters as
    numpy (its run() builds that state from key 0)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **DIMS)
    jtr = jtrainer.Trainer(jtrainer.TrainerConfig(
        model=jcfg, mesh=MeshSpec.for_devices(len(jax.devices())), **COMMON))
    jstate = jtrain.init_train_state(jax.random.key(0), jcfg, jtr.mesh,
                                     jtr.optimizer)
    np_params = jax.tree.map(np.asarray, jstate["params"])
    return np_params, jtr.run()


def _port_trainer(np_params, **kw):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **DIMS)
    return ttrainer.Trainer(
        ttrainer.TrainerConfig(model=tcfg, device="cpu", **COMMON, **kw),
        params=params_from_jax(np_params, tcfg, device="cpu"))


def _assert_history_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        if "eval" in w:
            np.testing.assert_allclose(g["eval"]["loss"], w["eval"]["loss"],
                                       atol=1e-5, rtol=0)
            continue
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)


def test_trainer_run_matches_the_jax_trainer(jax_run):
    np_params, want = jax_run
    got = _port_trainer(np_params).run()

    assert got.steps_run == want.steps_run == 4
    assert got.resumed_from is want.resumed_from is None
    _assert_history_close(got.metrics_history, want.metrics_history)
    np.testing.assert_allclose(got.final_loss, want.final_loss, atol=1e-5,
                               rtol=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got.final_eval[key], want.final_eval[key],
                                   atol=1e-5, rtol=0)
    assert got.data_source == want.data_source == "synthetic"
    assert got.tokens_per_second > 0


class _Preempted(Exception):
    pass


def test_resumed_run_matches_the_uninterrupted_jax_run(tmp_path, jax_run):
    """The port's run stopped after step 2 (its final state force-saved
    on the way out), then a fresh ``Trainer`` on the same directory
    resumed at step 2 (state and data stream): every step's loss and
    ``grad_norm`` and the evals against the JAX trainer's uninterrupted
    run, at the parity test's tolerances; and the resumed run's final
    state equals the port's own uninterrupted run's bit for bit."""
    np_params, want = jax_run
    d = str(tmp_path / "ckpt")
    steps = []

    def preempt(step, metrics):
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"])})
        if step == 2:
            raise _Preempted

    first = _port_trainer(np_params, checkpoint_dir=d, checkpoint_interval=3)
    with pytest.raises(_Preempted):
        first.run(on_step=preempt)
    assert first.ckpt.all_steps() == [2]  # off-cadence: the forced save
    second = _port_trainer(np_params, checkpoint_dir=d, checkpoint_interval=3)
    got = second.run()
    assert got.resumed_from == 2 and got.steps_run == 2
    assert second.ckpt.all_steps() == [2, 3, 4]
    # the first run's eval at step 2 is lost with its history
    want_steps = [w for w in want.metrics_history
                  if "eval" not in w or w["step"] > 2]
    _assert_history_close(steps + got.metrics_history, want_steps)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got.final_eval[key], want.final_eval[key],
                                   atol=1e-5, rtol=0)
    straight = _port_trainer(np_params)
    straight.run()
    a, b = straight.state, second.state
    assert a["step"] == b["step"] == 4
    leaves = [param_leaves(s["params"]) + s["opt_state"]["mu"]
              + s["opt_state"]["nu"] for s in (a, b)]
    assert all(torch.equal(x, y) for x, y in zip(*leaves))


def test_an_exception_inside_a_step_saves_no_torn_state(tmp_path):
    """An exception raised inside the optimizer's update, after it wrote
    its first leaf, leaves the state half updated (the update counted,
    the step not): the run's way out must not save that state as a step.
    A fresh ``Trainer`` resumes from the last whole step on disk and ends
    where an uninterrupted run does, bit for bit."""
    armed = []

    class Tripwire(list):
        """A moment list whose first iteration stops after one leaf."""

        def __iter__(self):
            if armed:
                yield from super().__iter__()
                return
            armed.append(True)
            yield self[0]
            raise _Preempted

    def trainer(**kw):
        return ttrainer.Trainer(ttrainer.TrainerConfig(
            seq_len=16, batch_size=2, total_steps=4, device="cpu", **kw))

    d = str(tmp_path)
    first = trainer(checkpoint_dir=d, checkpoint_interval=2)

    def arm(step, metrics):
        if step == 3:  # step 4 tears; step 3 is not on disk
            opt = first.state["opt_state"]
            opt["mu"] = Tripwire(opt["mu"])

    with pytest.raises(_Preempted):
        first.run(on_step=arm)
    torn = first.state
    assert (torn["step"], torn["opt_state"]["count"]) == (3, 4)
    assert first.ckpt.all_steps() == [2]
    second = trainer(checkpoint_dir=d, checkpoint_interval=2)
    assert second.run().resumed_from == 2
    straight = trainer()
    straight.run()
    leaves = [param_leaves(s["params"]) + s["opt_state"]["mu"]
              + s["opt_state"]["nu"] for s in (straight.state, second.state)]
    assert all(torch.equal(x, y) for x, y in zip(*leaves))


@pytest.mark.parametrize("argv,item", [
    # the ids are the cases' first ones, from the old labels ("A12" is
    # A.13, "A8" A.11c); --checkpointDir trains now
    # (test_cli_trains_and_resumes_with_a_checkpoint_dir), and so do
    # --quant int8, --optImpl fused and --fusedCE
    # (test_cli_trains_with_the_fused_and_int8_options)
    pytest.param(["--tp", "2"], "A.13", id="argv0-A12"),
    pytest.param(["--sp", "2"], "A.13", id="argv1-A12"),
    pytest.param(["--pp", "2"], "A.13", id="argv2-A12"),
    pytest.param(["--ep", "2"], "A.13", id="argv3-A12"),
    pytest.param(["--fsdp", "2"], "A.13", id="argv4-A12"),
    pytest.param(["--numSlices", "2"], "A.13", id="argv5-A12"),
    # --traceDir traces now (test_cli_writes_step_spans_and_a_trace); the
    # case keeps its id and pins that a traced run is still refused for
    # what it cannot run, naming that item and no longer A.11c
    pytest.param(["--traceDir", "/x", "--tp", "2"], "A.13", id="argv7-A8"),
    # full-size Mixtral training is parallel training (ROADMAP A.13);
    # the case keeps its id
    pytest.param(["--preset", "mixtral_8x7b"], "A.13", id="argv11-A10"),
])
def test_cli_refuses_what_is_not_ported(capsys, argv, item):
    with pytest.raises(SystemExit) as exc:
        ttrainer._main([*argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--quant", "int8"], ["--optImpl", "fused"],
                                  ["--fusedCE"]],
                         ids=["quant-int8", "optImpl-fused", "fusedCE"])
def test_cli_trains_with_the_fused_and_int8_options(capsys, argv):
    """Each option of the fused training ops trains the tiny preset for
    two steps on the CPU and reaches the trainer's summary line."""
    assert ttrainer._main([*argv, "--preset", "tiny", "--steps", "2",
                           "--seqLen", "32", "--batchSize", "2",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 ")
    assert "nan" not in out


def test_cli_without_cuda_exits_naming_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttrainer._main(["--preset", "tiny", "--steps", "1"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_trainer_refuses_on_the_card_what_the_kernels_do_not_take(
        monkeypatch, capsys):
    """The check runs at startup, before anything touches the card, so a
    device resolved to CUDA shows it here."""
    monkeypatch.setattr(ttrainer, "resolve_device",
                        lambda device: torch.device("cuda"))
    # the tiny preset's head dim (16) runs in the kernels' 64-column
    # tiles now; 48 is one they still refuse
    for model, seq_len, why in (
            (tllama.LlamaConfig.tiny(head_dim_override=48), 128,
             "head_dim=48"),
            (tllama.LlamaConfig.tiny(**DIMS), 100, "seq_len=100")):
        with pytest.raises(ValueError, match=why):
            ttrainer.Trainer(ttrainer.TrainerConfig(
                model=model, seq_len=seq_len, device="cuda"))
    assert ttrainer._main(["--preset", "tiny", "--steps", "1",
                           "--seqLen", "100"]) == 2
    assert "seq_len=100" in capsys.readouterr().err


def test_cli_trains_on_the_cpu(capsys):
    assert ttrainer._main(["--preset", "tiny", "--steps", "2", "--seqLen",
                           "16", "--batchSize", "2", "--masterWeights",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 loss=")


def test_cli_trains_and_resumes_with_a_checkpoint_dir(tmp_path, capsys):
    """``--checkpointDir``: two steps, then the same command to four
    resumes at step 2 (``resumed_from=2``, two steps run); at four again
    it has nothing left to run."""
    argv = ["--preset", "tiny", "--seqLen", "16", "--batchSize", "2",
            "--checkpointDir", str(tmp_path), "--checkpointInterval", "1",
            "--device", "cpu"]
    assert ttrainer._main([*argv, "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 ") and "resumed_from=None" in out
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    assert ttrainer._main([*argv, "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 ") and "resumed_from=2" in out
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]  # keeps three
    assert ttrainer._main([*argv, "--steps", "4"]) == 0
    assert "steps=0 " in capsys.readouterr().out


def test_loader_seek_while_iterating_drops_staged_batches():
    """A seek during iteration restarts the prefetch thread at the new
    step: the batches it had staged are not served."""
    loader = tpipe.DataLoader(tpipe.SyntheticSource(100, seed=3), 4, 16,
                              device="cpu", prefetch=2)
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    loader.seek(1)
    for want in batches[1:]:
        assert torch.equal(next(it)["inputs"], want["inputs"])
    assert loader.state() == {"step": 3}
