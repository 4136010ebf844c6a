"""The split-KV plan of K1's narrow windows and the plain version that
follows it.

On the tensor cores a narrow window (decode, verify: at most
``NARROW_TILE`` query vectors) splits each slot's live span into splits of
``SPLIT_TILES`` absolute 64-row kv tiles, one block each, and combines the
splits' partials in f32. ``split_plan`` is the plan the kernel mirrors;
``ragged_paged_attention_reference(p_bf16=True, split_tiles=K)`` rounds
the weights where that launch does (the running max restarts at each
split). Here the plan is pinned, the split-aware plain version is held to
today's where a span holds one split, and to the JAX kernel (interpret
mode, as its own tests run it) within the bf16 bound 2e-2 (the two round
at different places). The kernel itself is held to it on the card
(``test_torch_kernel_card.py``, ``chip_smoke.py`` phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

# one intra-op thread per worker process (the suite runs several)
torch.set_num_threads(1)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bases,t,window,s_len,k,want", [
    # an empty slot: its clamped query reads tile 0 alone
    ([-1], 1, 0, 2048, 4, [[(0, 0, 0)]]),
    # spans that end on a tile boundary, and one row past it
    ([63], 1, 0, 2048, 4, [[(0, 0, 0)]]),
    ([64], 1, 0, 2048, 4, [[(0, 0, 1)]]),
    # spans that end on a split boundary, and one tile past it
    ([255], 1, 0, 2048, 4, [[(0, 0, 3)]]),
    ([256], 1, 0, 2048, 4, [[(0, 0, 3), (1, 4, 4)]]),
    # a window: the splits before its floor are not live
    ([1000], 1, 64, 2048, 4, [[(3, 14, 15)]]),
    ([1030], 1, 100, 2048, 4, [[(3, 14, 15), (4, 16, 16)]]),
    # a verify window of two rows: the span ends at its last row
    ([62, 63], 2, 0, 2048, 4, [[(0, 0, 0)], [(0, 0, 1)]]),
    # a paged table's virtual extent (5 pages of 16): a slot parked at the
    # last virtual row, and one past the extent, clip to it
    ([79, 200], 1, 0, 80, 1, [[(0, 0, 0), (1, 1, 1)]] * 2),
])
def test_split_plan(bases, t, window, s_len, k, want):
    base = torch.tensor(bases, dtype=torch.int32)
    assert rpa.split_plan(base, t, window, s_len, k) == want


def test_split_plan_of_the_headline_decode_batch():
    """Phase 2's decode bases: at K = 4 the slots take 1, 1, 1, 1, 2, 4,
    8, 8 splits (26 live blocks a kv head of the grid's 8); every split
    but a span's last holds K tiles, and the splits tile the span."""
    bases = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    plan = rpa.split_plan(bases, 1, 0, 2048, 4)
    assert [len(p) for p in plan] == [1, 1, 1, 1, 2, 4, 8, 8]
    assert rpa.n_splits(2048, 4) == 8 and rpa.n_splits(2049, 4) == 9
    for b0, splits in zip(bases, plan):
        tiles = [j for _, lo, hi in splits for j in range(lo, hi + 1)]
        assert tiles == list(range(0, max(b0, 0) // 64 + 1))
        assert all(hi - lo + 1 == 4 for _, lo, hi in splits[:-1])


@pytest.mark.parametrize("t,group,want", [
    (1, 4, rpa.SPLIT_TILES), (2, 4, rpa.SPLIT_TILES), (8, 1, rpa.SPLIT_TILES),
    (3, 4, None), (9, 1, None), (256, 4, None),
])
def test_window_split(t, group, want):
    """Narrow windows split their spans; chunks walk theirs in one block.
    SPLIT_TILES is one of the values its measurement chose from."""
    assert rpa.SPLIT_TILES in (2, 4, 8)
    assert rpa.window_split(t, group) == want


def _operands(seed, b, s, hq, hkv, hd, t=1):
    """f32 numpy q, k, v from a seed (rounded to bf16 by each side)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    return q, k, v


def _bf16(*xs):
    return [torch.from_numpy(x).bfloat16() for x in xs]


@pytest.mark.parametrize("cache_quant", ["none", "int8"])
def test_split_plain_version_equals_the_unsplit_one_within_one_split(
        cache_quant):
    """Every span here lies in one split of 4 tiles (bases up to 255): the
    split-aware p_bf16 plain version is today's bit for bit. A span of
    several splits moves (the running max restarts), within the bf16
    bound of the f32 plain version."""
    from k8s_gpu_device_plugin_torch.ops import quant

    q, k, v = _bf16(*_operands(3, 4, 512, 8, 2, 64))
    kw = dict(scale=64 ** -0.5)
    if cache_quant == "int8":
        (k, ks), (v, vs) = (quant.quantize_int8(x, axis=-1) for x in (k, v))
        kw.update(k_scale=ks, v_scale=vs)
    one = torch.tensor([-1, 0, 100, 255], dtype=torch.int32)
    assert all(len(p) == 1 for p in rpa.split_plan(one, 1, 0, 512, 4))
    split = rpa.ragged_paged_attention_reference(q, k, v, one, p_bf16=True,
                                                 split_tiles=4, **kw)
    assert torch.equal(split, rpa.ragged_paged_attention_reference(
        q, k, v, one, p_bf16=True, **kw))
    many = torch.tensor([300, 511, 256, 400], dtype=torch.int32)
    split = rpa.ragged_paged_attention_reference(q, k, v, many, p_bf16=True,
                                                 split_tiles=1, **kw)
    assert not torch.equal(split, rpa.ragged_paged_attention_reference(
        q, k, v, many, p_bf16=True, **kw))
    torch.testing.assert_close(
        split.float(),
        rpa.ragged_paged_attention_reference(q, k, v, many, **kw).float(),
        **BF16_TOL)


def test_split_weights_restart_the_running_max_at_each_split():
    """Two kv tiles, one split each: the first tile's weights are rounded
    against its own max, though the second tile holds the row's max."""
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    s[:, 64:] += 3.0
    m = s.amax(-1, keepdim=True)
    m1 = s[:, :64].amax(-1, keepdim=True)
    want = torch.cat([
        torch.exp(s[:, :64] - m1).bfloat16().float() * torch.exp(m1 - m),
        torch.exp(s[:, 64:] - m).bfloat16().float()], dim=-1)
    got = kernel_support.p_bf16_weights(s, m, split_tiles=1)
    torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    # a split of both tiles is the unsplit walk
    assert torch.equal(kernel_support.p_bf16_weights(s, m, split_tiles=2),
                       kernel_support.p_bf16_weights(s, m))


def test_split_plain_version_pages_like_dense():
    """Splits are positions, not pages: through a shuffled pool of 16-row
    pages the split-aware plain version gives the dense cache's bits."""
    q, k, v = _bf16(*_operands(5, 2, 256, 8, 2, 64))
    base = torch.tensor([200, 255], dtype=torch.int32)
    ps, nsp = 16, 256 // 16
    perm = torch.from_numpy(np.random.default_rng(2).permutation(2 * nsp)) + 1
    table = perm.reshape(2, nsp).int()

    def pool(x):
        out = torch.zeros((1 + 2 * nsp, ps, *x.shape[2:]), dtype=x.dtype)
        out[table.reshape(-1).long()] = x.reshape(2 * nsp, ps, *x.shape[2:])
        return out

    kw = dict(scale=0.125, p_bf16=True, split_tiles=1)
    dense = rpa.ragged_paged_attention_reference(q, k, v, base, **kw)
    paged = rpa.ragged_paged_attention_reference(q, pool(k), pool(v), base,
                                                 table, **kw)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("hq,hkv,t,window", [
    (4, 4, 1, 0), (8, 2, 1, 0), (8, 2, 1, 40), (8, 2, 2, 0), (4, 1, 2, 100),
])
def test_split_plain_version_matches_the_jax_kernel(hq, hkv, t, window):
    """B 3, S 256, hd 64, bf16, one tile a split (up to four splits a
    span): the split-aware plain version within the bf16 bound of the JAX
    kernel in interpret mode on the same inputs."""
    q, k, v = _operands(11 + hq + t + window, 3, 256, hq, hkv, 64, t)
    bases = np.asarray([-1, 130, 256 - t], np.int32)
    want = jax_rpa(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                   jnp.asarray(bases), scale=64 ** -0.5, window=window,
                   block_k=32, interpret=True)
    tq, tk, tv = _bf16(q, k, v)
    got = rpa.ragged_paged_attention_reference(
        tq, tk, tv, torch.from_numpy(bases), scale=64 ** -0.5, window=window,
        p_bf16=True, split_tiles=1)
    assert max(len(p) for p in rpa.split_plan(bases, t, window, 256, 1)) > 1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_split_tools_edit_the_sources_once():
    """The split A/B tool's variants and the fault tool's split faults find
    their text exactly once in the kernel source, as their builds
    require."""
    import importlib.util
    from pathlib import Path

    tools = Path(__file__).resolve().parents[1] / "tools"
    edits = {}
    for name in ("torch_rpa_split_ab", "torch_flash_fault"):
        spec = importlib.util.spec_from_file_location(name, tools / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if name == "torch_rpa_split_ab":
            edits.update(module.VARIANTS)
        else:
            edits.update({n: e for n, (kernel, e) in module.FAULTS.items()
                          if kernel == "rpa_split"})
    assert {"combine_skips_last_split", "split_max_not_rescaled",
            "ring3_one_block", "copies_only", "products_only"} == set(edits)
    for name, changes in edits.items():
        for path, old, _ in changes:
            text = (kernel_support.CSRC_DIR / path).read_text()
            assert text.count(old) == 1, (name, path, old[:60])
