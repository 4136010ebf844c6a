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
from k8s_gpu_device_plugin_torch.data import pipeline as tpipe
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import trainer as ttrainer
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax

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
    assert label == "python-memmap" and isinstance(source, tpipe.MemmapSource)


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


def test_trainer_run_matches_the_jax_trainer():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **DIMS)
    common = dict(batch_size=8, seq_len=32, total_steps=3, log_every=1,
                  learning_rate=1e-3, warmup_steps=1, eval_every=2,
                  eval_batches=1)
    jtr = jtrainer.Trainer(jtrainer.TrainerConfig(
        model=jcfg, mesh=MeshSpec.for_devices(len(jax.devices())), **common))
    # the JAX trainer's initial state, built as its run() builds it
    jstate = jtrain.init_train_state(jax.random.key(0), jcfg, jtr.mesh,
                                     jtr.optimizer)
    np_params = jax.tree.map(np.asarray, jstate["params"])
    want = jtr.run()

    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **DIMS)
    ttr = ttrainer.Trainer(
        ttrainer.TrainerConfig(model=tcfg, device="cpu", **common),
        params=params_from_jax(np_params, tcfg, device="cpu"))
    got = ttr.run()

    assert got.steps_run == want.steps_run == 3
    assert len(got.metrics_history) == len(want.metrics_history)
    for g, w in zip(got.metrics_history, want.metrics_history):
        assert g["step"] == w["step"]
        if "eval" in w:
            np.testing.assert_allclose(g["eval"]["loss"], w["eval"]["loss"],
                                       atol=1e-5, rtol=0)
            continue
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(got.final_loss, want.final_loss, atol=1e-5,
                               rtol=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got.final_eval[key], want.final_eval[key],
                                   atol=1e-5, rtol=0)
    assert got.data_source == want.data_source == "synthetic"
    assert got.tokens_per_second > 0


@pytest.mark.parametrize("argv,item", [
    (["--tp", "2"], "A12"), (["--sp", "2"], "A12"), (["--pp", "2"], "A12"),
    (["--ep", "2"], "A12"), (["--fsdp", "2"], "A12"),
    (["--numSlices", "2"], "A12"), (["--checkpointDir", "/x"], "A8"),
    (["--traceDir", "/x"], "A8"), (["--quant", "int8"], "A8"),
    (["--optImpl", "fused"], "A8"), (["--fusedCE"], "A8"),
    (["--preset", "mixtral_8x7b"], "A10"),
])
def test_cli_refuses_what_is_not_ported(capsys, argv, item):
    with pytest.raises(SystemExit) as exc:
        ttrainer._main([*argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


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
    for model, seq_len, why in (
            (tllama.LlamaConfig.tiny(), 128, "head_dim=16"),
            (tllama.LlamaConfig.tiny(**DIMS), 100, "seq_len=100")):
        with pytest.raises(ValueError, match=why):
            ttrainer.Trainer(ttrainer.TrainerConfig(
                model=model, seq_len=seq_len, device="cuda"))
    assert ttrainer._main(["--preset", "tiny", "--steps", "1"]) == 2
    assert "head_dim=16" in capsys.readouterr().err


def test_cli_trains_on_the_cpu(capsys):
    assert ttrainer._main(["--preset", "tiny", "--steps", "2", "--seqLen",
                           "16", "--batchSize", "2", "--masterWeights",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 loss=")
