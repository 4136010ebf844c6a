"""The port's native C++ token gather (``data/native_loader.py``,
``native/dataload.cc``) against the Python sources.

The gather is built at first use with the machine's C++ compiler.
Its batches must equal the port's ``MemmapSource`` and the reference's
``MemmapSource`` (and the reference's own native gather where its library
is built) bit for bit: one sampling recipe keyed by (seed, step), the C++
side only moves and widens bytes. The reference tests mirrored:
``tests/test_data_trainer.py``'s native-loader and factory cases.
"""

import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.data import native_loader as jnative
from k8s_gpu_device_plugin_tpu.data import pipeline as jpipe
from k8s_gpu_device_plugin_torch.data import native_loader
from k8s_gpu_device_plugin_torch.data import pipeline as tpipe
from k8s_gpu_device_plugin_torch.models import trainer as ttrainer

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)


def _corpus(tmp_path, dtype="uint16", n=8192, high=50_000, seed=0):
    path = tmp_path / f"corpus_{dtype}.bin"
    np.random.default_rng(seed).integers(0, high, n).astype(dtype).tofile(path)
    return str(path)


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_native_batches_equal_the_python_sources_bit_for_bit(tmp_path, dtype):
    path = _corpus(tmp_path, dtype)
    nat = native_loader.NativeMemmapSource(path, dtype=dtype, seed=7,
                                           threads=3)
    sources = [tpipe.MemmapSource(path, dtype=dtype, seed=7),
               jpipe.MemmapSource(path, dtype=dtype, seed=7)]
    if jnative.native_available():  # the reference's own C++ gather
        sources.append(jnative.NativeMemmapSource(path, dtype=dtype, seed=7))
    try:
        assert nat.n_tokens == 8192 and nat.threads == 3 and nat.seed == 7
        for step in range(24):
            rows = slice(0, 8) if step % 2 else np.arange(1, 7)
            got = nat.windows(step, rows, 8, 96 + step)
            assert got.dtype == np.int32
            for src in sources:
                np.testing.assert_array_equal(
                    got, src.windows(step, rows, 8, 96 + step),
                    err_msg=f"{type(src).__module__} step {step}")
    finally:
        nat.close()
        for src in sources:
            getattr(src, "close", lambda: None)()


def test_native_source_feeds_the_loader_and_survives_seek(tmp_path):
    path = _corpus(tmp_path, high=400, n=4096, seed=1)

    def loader(prefetch, start=0):
        src = native_loader.NativeMemmapSource(path, seed=0)
        return tpipe.DataLoader(src, batch_size=4, seq_len=32, device="cpu",
                                start_step=start, prefetch=prefetch)

    straight = loader(2)
    it = iter(straight)
    batches = [next(it) for _ in range(5)]
    b0 = batches[0]
    assert b0["inputs"].shape == (4, 32) and b0["inputs"].dtype == torch.int64
    assert torch.equal(b0["inputs"][:, 1:], b0["targets"][:, :-1])
    want = tpipe.MemmapSource(path, seed=0).windows(3, slice(0, 4), 4, 32)
    assert np.array_equal(batches[3]["inputs"].numpy(), want[:, :-1])
    # a resumed loader (seek, or a start step) continues the same stream
    resumed = loader(0)
    resumed.seek(3)
    assert torch.equal(next(iter(resumed))["targets"], batches[3]["targets"])
    assert torch.equal(next(iter(loader(2, start=4)))["inputs"],
                       batches[4]["inputs"])
    straight.seek(1)  # a seek while iterating restarts there
    assert torch.equal(next(it)["inputs"], batches[1]["inputs"])


def test_native_source_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        native_loader.NativeMemmapSource("/nonexistent", dtype="float32")
    with pytest.raises(FileNotFoundError):
        native_loader.NativeMemmapSource(str(tmp_path / "missing.bin"))
    one = tmp_path / "one.bin"
    np.zeros(1, np.uint16).tofile(one)
    with pytest.raises(ValueError, match="too small"):
        native_loader.NativeMemmapSource(str(one))
    src = native_loader.NativeMemmapSource(_corpus(tmp_path, n=64))
    with pytest.raises(ValueError, match="shorter than"):
        src.windows(0, slice(0, 1), 1, 64)
    src.close()
    src.close()  # closing twice is harmless


def test_factory_labels_the_source_that_fed_the_run(tmp_path, monkeypatch):
    src, label = tpipe.make_token_source("", vocab_size=100)
    assert isinstance(src, tpipe.SyntheticSource) and label == "synthetic"
    path = _corpus(tmp_path, high=100, n=4096)
    src, label = tpipe.make_token_source(path, vocab_size=100)
    assert label == "native-memmap"
    assert isinstance(src, native_loader.NativeMemmapSource)
    src.close()
    # out-of-vocab ids are refused, and the refused source is closed
    closed = []
    monkeypatch.setattr(native_loader.NativeMemmapSource, "close",
                        lambda self: closed.append(True))
    with pytest.raises(ValueError, match="vocab_size"):
        tpipe.make_token_source(path, vocab_size=50)
    assert closed
    # a machine without a C++ compiler serves the Python memmap, labelled
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-on-this-path")
    assert not native_loader.native_available()
    src, label = tpipe.make_token_source(path, vocab_size=100)
    assert isinstance(src, tpipe.MemmapSource) and label == "python-memmap"
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.NativeMemmapSource(path)


def test_a_compiler_that_fails_raises_with_its_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'dataload.cc: fatal: no room' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    assert native_loader.native_available()
    path = _corpus(tmp_path, high=100, n=4096)
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no room"):
        tpipe.make_token_source(path, vocab_size=100)
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half built


def test_trainer_reports_the_native_gather(tmp_path, capsys):
    path = _corpus(tmp_path, high=512, n=20_000)
    assert ttrainer._main(["--preset", "tiny", "--steps", "2", "--seqLen",
                           "32", "--batchSize", "2", "--dataFile", path,
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("trainer: steps=2 ") and "data=native-memmap" in out
