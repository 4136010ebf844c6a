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


@pytest.mark.parametrize("dtype,t,group,want", [
    (torch.bfloat16, 1, 4, "tensor_cores"),   # decode: split over its span
    (torch.bfloat16, 2, 4, "tensor_cores"),   # 8 query vectors: narrow, split
    (torch.bfloat16, 3, 4, "tensor_cores"),   # 12: the chunk route
    (torch.bfloat16, 8, 1, "tensor_cores"),
    (torch.bfloat16, 9, 1, "tensor_cores"),
    (torch.bfloat16, 256, 4, "tensor_cores"),
    (torch.float32, 256, 4, "cuda_cores"),    # f32 pins need f32 products
    (torch.float32, 1, 4, "cuda_cores"),
])
def test_engine_choice(dtype, t, group, want):
    assert rpa.engine(dtype, t, group) == want
    assert kernel_support.engine_key(rpa.NAME, want) == f"{rpa.NAME}<{want}>"


def test_engine_key_refuses_an_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        kernel_support.engine_key(rpa.NAME, "tpu")


def test_p_bf16_plain_version_rounds_the_running_tile_weights():
    """One query at position 127 (two 64-row kv tiles, the second's max
    the row's): the first tile's weights are rounded to bf16 against its
    own running max, then rescaled; o is divided by the sum of the
    unrounded weights. f32 q, so o itself is not rounded."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 1, 2, 2))
    k[0, 100] = q[0, 0]                  # the row's max in the second tile
    base = torch.tensor([127], dtype=torch.int32)
    got = rpa.ragged_paged_attention_reference(q, k, v, base, scale=0.3,
                                               p_bf16=True)
    s = torch.einsum("bthd,bshd->bhs", q, k)[:, :, None] * 0.3  # (1, 2, 1, 128)
    m1 = s[..., :64].amax(-1, keepdim=True)
    m = s.amax(-1, keepdim=True)
    assert bool((m > m1).all())
    p1 = torch.exp(s[..., :64] - m1).bfloat16().float() * torch.exp(m1 - m)
    p2 = torch.exp(s[..., 64:] - m).bfloat16().float()
    l = torch.exp(s - m).sum(-1, keepdim=True)
    want = (torch.einsum("bhts,bshd->bthd", p1, v[:, :64])
            + torch.einsum("bhts,bshd->bthd", p2, v[:, 64:])) \
        / l.permute(0, 2, 1, 3)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def _bf16_chunk_operands(cache_quant, seed=11, t=20, bases=(0, 90)):
    """A bf16 chunk over a cache of bf16 rows, int8 codes or packed int4
    codes (the port's own recipes): q, (k, v, k_scale, v_scale), base."""
    from k8s_gpu_device_plugin_torch.ops import quant

    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(seed, len(bases), t, 8, 2))
    ks = vs = None
    if cache_quant == "int8":
        (k, ks), (v, vs) = (quant.quantize_int8(x, axis=-1) for x in (k, v))
    elif cache_quant == "int4":
        (k, ks), (v, vs) = (quant.quantize_int4_sym(x, axis=-1)
                            for x in (k, v))
        k, v = quant.pack_int4(k), quant.pack_int4(v)
    return q, (k, v, ks, vs), torch.tensor(bases, dtype=torch.int32)


@pytest.mark.parametrize("cache_quant", ["int8", "int4"])
def test_p_bf16_plain_version_rounds_dequantized_rows_once(cache_quant):
    """On codes, the tensor-core engine's producer multiplies each code by
    its row's scale in f32 and rounds once to bf16: the p_bf16 plain
    version on codes equals it on those bf16 rows, bit for bit."""
    from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4

    q, (k, v, ks, vs), base = _bf16_chunk_operands(cache_quant)
    kw = dict(scale=HD ** -0.5, window=0, p_bf16=True)
    got = rpa.ragged_paged_attention_reference(q, k, v, base, k_scale=ks,
                                               v_scale=vs, **kw)
    if cache_quant == "int4":
        k, v = unpack_int4(k), unpack_int4(v)
    rows = [(x.float() * sc).bfloat16() for x, sc in ((k, ks), (v, vs))]
    assert torch.equal(got, rpa.ragged_paged_attention_reference(
        q, *rows, base, **kw))


@pytest.mark.parametrize("cache_quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("window", [0, 16])
def test_p_bf16_plain_version_within_the_engines_bound(cache_quant, window):
    """The two plain versions of a bf16 chunk differ only by where they
    round (weights against the running tile max, dequantized rows): within
    the bf16 bound (atol = rtol = 2e-2) the tensor-core engine is held to
    against the f32 plain version, and not equal. A paged pool gives the
    dense cache's bits."""
    q, (k, v, ks, vs), base = _bf16_chunk_operands(cache_quant)
    kw = dict(scale=HD ** -0.5, window=window, k_scale=ks, v_scale=vs)
    plain = rpa.ragged_paged_attention_reference(q, k, v, base, **kw)
    p16 = rpa.ragged_paged_attention_reference(q, k, v, base, p_bf16=True,
                                               **kw)
    torch.testing.assert_close(p16.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    assert not torch.equal(p16, plain)
    ps, nsp = 16, S // 16
    perm = torch.from_numpy(np.random.default_rng(5).permutation(2 * nsp)) + 1
    table = perm.reshape(2, nsp).int()

    def pool(x):
        if x is None:
            return None
        out = torch.zeros((1 + 2 * nsp, ps, *x.shape[2:]), dtype=x.dtype)
        out[table.reshape(-1).long()] = x.reshape(2 * nsp, ps, *x.shape[2:])
        return out

    paged = rpa.ragged_paged_attention_reference(
        q, pool(k), pool(v), base, table, scale=kw["scale"], window=window,
        k_scale=pool(ks), v_scale=pool(vs), p_bf16=True)
    assert torch.equal(paged, p16)


def test_p_bf16_weights_pad_a_partial_tile():
    """A last partial kv tile is padded with masked columns; a fully
    masked leading tile adds nothing once a later tile raises the max."""
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.standard_normal((3, 100)).astype(np.float32))
    s[0, :64] = -1e30
    m = s.amax(-1, keepdim=True)
    got = kernel_support.p_bf16_weights(s, m)
    padded = torch.cat([s, torch.full((3, 28), -1e30)], dim=-1)
    assert torch.equal(got, kernel_support.p_bf16_weights(padded, m)[:, :100])
    assert torch.equal(got[0, :64], torch.zeros(64))
    torch.testing.assert_close(got, torch.exp(s - m), atol=0, rtol=2 ** -8)


def test_backend_plan_names_the_route_per_device():
    cuda = attention_backend_plan(device="cuda", n_heads=32, n_kv_heads=8,
                                  head_dim=128, chunk=256)
    assert cuda["decode"]["backend"] == "cuda"
    assert cuda["prefill"]["backend"] == "cuda"
    cpu = attention_backend_plan(device="cpu", n_heads=32, n_kv_heads=8,
                                 head_dim=128)
    assert cpu["decode"]["backend"] == "plain"
    # hd 256 (Gemma-2B's) runs in an instantiation of its own; 512 does not
    odd = attention_backend_plan(device="cuda", n_heads=8, n_kv_heads=1,
                                 head_dim=512)
    assert odd["decode"]["backend"] == "unsupported"
    gemma = attention_backend_plan(device="cuda", n_heads=8, n_kv_heads=1,
                                   head_dim=256)
    assert gemma["decode"]["backend"] == "cuda"


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


def test_build_key_follows_the_headers(tmp_path):
    """Both kernel libraries include the shared headers of ops/csrc: an
    edit to a header alone must change every library's key, or a stale
    library would load."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_support.CSRC_DIR, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["attention_tile.cuh"]
    sources = [sorted(csrc.glob("*.cu"))[:1], sorted(csrc.glob("*.cu"))[1:]]
    before = [kernel_support.build_key(s, csrc) for s in sources]
    assert before == [kernel_support.build_key(s, csrc) for s in sources]
    headers[0].write_text(headers[0].read_text() + "// edited\n")
    after = [kernel_support.build_key(s, csrc) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    cmd = kernel_support.build_command("nvcc", sources[0], "out.so", csrc)
    assert f"-I{csrc}" in cmd


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
