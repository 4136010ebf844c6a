"""The port's ragged-paged attention against the JAX reference.

The reference's Pallas kernel runs in interpret mode (as its own tests
run it on the CPU) and its XLA gather (``generate._cached_attention``)
runs as is; both are held against the port's plain version, which is
what the port's wrapper runs for CPU tensors. Tolerance: atol 1e-5 in
f32 at hd 64 — the online-softmax kernel and the plain softmax differ
only in summation order.

The CUDA kernel itself needs the card: ``chip_smoke.py`` holds it
against the same plain version there. The build is covered here with
``subprocess`` mocked (no nvcc runs).
"""

import subprocess
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.attention import (
    attention_backend_plan,
    serving_cache_attention,
)

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

HD = 64
S = 128
ATOL = 1e-5


def _inputs(seed, b, t, hq, hkv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, HD)).astype(np.float32)
    k = rng.standard_normal((b, S, hkv, HD)).astype(np.float32)
    v = rng.standard_normal((b, S, hkv, HD)).astype(np.float32)
    return q, k, v


def _plain(q, k, v, base, window=0):
    out = rpa.ragged_paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(base), scale=HD ** -0.5, window=window,
    )
    return out.numpy()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("window", [0, 16])
def test_jax_kernel_matches_plain_version(t, hq, hkv, window):
    q, k, v = _inputs(t + hq, 3, t, hq, hkv)
    # an empty slot (-1), a fresh one (0) and one deep in its cache
    base = np.asarray([-1, 0, S - t - 3], np.int32)
    want = jax_rpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(base), scale=HD ** -0.5, window=window,
                   block_k=32, interpret=True)
    np.testing.assert_allclose(_plain(q, k, v, base, window),
                               np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("window", [0, 16])
def test_jax_gather_matches_plain_version(t, window):
    """The reference's own gather branch (no clamp) on live slots."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, n_heads=8,
                                  n_kv_heads=2, head_dim_override=HD,
                                  sliding_window=window)
    q, k, v = _inputs(7 + t, 2, t, 8, 2)
    base = np.asarray([0, 57], np.int32)
    want = jgen._cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        jnp.asarray(base), cfg,
    )
    np.testing.assert_allclose(_plain(q, k, v, base, window),
                               np.asarray(want), atol=ATOL, rtol=0)


def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing():
    kernel_support.reset_launch_counts()
    q, k, v = _inputs(0, 2, 4, 8, 2)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = serving_cache_attention(qt, kt, vt, 5)
    want = _plain(q, k, v, np.asarray([5, 5], np.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernel_support.launch_counts() == {}


def test_wrapper_refuses_a_page_table_and_bad_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 2, 1, 8, 2))
    base = torch.zeros(2, dtype=torch.int32)
    # a page table now selects the paged route (its own refusals are in
    # test_torch_paged_attention.py); a table of the wrong type raises
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, k, v, base,
                                   torch.zeros((2, 4), dtype=torch.int64),
                                   scale=1.0)
    with pytest.raises(ValueError, match="multiple"):
        rpa.ragged_paged_attention(q[:, :, :7], k, v, base, scale=1.0)
    with pytest.raises(ValueError, match="base"):
        rpa.ragged_paged_attention(q, k, v, base[:1], scale=1.0)


def test_attended_rows_counts_the_causal_and_windowed_span():
    base = torch.tensor([-1, 0, 10], dtype=torch.int32)
    # an empty slot's queries clamp to position 0: one row each
    assert rpa.attended_rows(base, 2).tolist() == [[1, 1], [1, 2], [11, 12]]
    assert rpa.attended_rows(base, 2, window=4).tolist() == [
        [1, 1], [1, 2], [4, 4]]


def test_backend_plan_names_the_route_per_device():
    cuda = attention_backend_plan(device="cuda", n_heads=32, n_kv_heads=8,
                                  head_dim=128, chunk=256)
    assert cuda["decode"]["backend"] == "cuda"
    assert cuda["prefill"]["backend"] == "cuda"
    cpu = attention_backend_plan(device="cpu", n_heads=32, n_kv_heads=8,
                                 head_dim=128)
    assert cpu["decode"]["backend"] == "plain"
    odd = attention_backend_plan(device="cuda", n_heads=8, n_kv_heads=1,
                                 head_dim=256)
    assert odd["decode"]["backend"] == "unsupported"


# --- the build (nvcc mocked) ------------------------------------------------


def test_build_command_targets_sm90a():
    cmd = kernel_support.build_command("nvcc", ["a.cu"], "out.so")
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd
    assert cmd[-1] == "a.cu" and cmd[cmd.index("-o") + 1] == "out.so"


def test_build_key_follows_the_sources_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    before = kernel_support.build_key([src])
    assert kernel_support.build_key([src]) == before
    src.write_text("__global__ void k() { }\n")
    edited = kernel_support.build_key([src])
    assert edited != before
    monkeypatch.setattr(kernel_support, "NVCC_FLAGS", ("-O0",))
    assert kernel_support.build_key([src]) != edited


def test_load_library_builds_once_per_key(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"not a real library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    with mock.patch.object(kernel_support.subprocess, "run", fake_run), \
            mock.patch.object(kernel_support, "find_nvcc", lambda: "nvcc"), \
            mock.patch.object(kernel_support.ctypes, "CDLL",
                              lambda path: ("lib", path)):
        lib = kernel_support.load_library("demo", [src], build_dir=tmp_path)
        again = kernel_support.load_library("demo", [src], build_dir=tmp_path)
    assert len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert lib == again
    key = kernel_support.build_key([src])
    assert lib[1].endswith(f"libdemo_{key}.so")
