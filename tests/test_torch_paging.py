"""The port's page pool against the reference's.

``models/paging.py`` is host-side bookkeeping with no arithmetic, so
every comparison is exact: one scripted sequence of alloc / incref /
decref / recycle drives both pools and must give the same page ids in
the same LIFO order and the same counters after every step; the byte
accounting must agree for bf16, f32 and int8 configs.

The tests drive the allocator itself, with no holder that records
ownership, so the repository's refcount-pairing lint is switched off on
the lines that allocate or reference pages bare.
"""

import jax.numpy as jnp
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import paging as jpaging
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import paging as tpaging

torch.set_num_threads(1)

# (operation, argument): alloc takes a count, the others indices into the
# list of pages handed out so far
SCRIPT = [
    ("alloc", 3), ("alloc", 2), ("incref", [0, 1]), ("decref", [0, 1, 2]),
    ("alloc", 1), ("decref", [0, 1]), ("recycle", [3]), ("alloc", 4),
    ("incref", [4]), ("recycle", [4]), ("decref", [4, 5]), ("alloc", 2),
]


def _view(pool):
    return (pool.free_pages, pool.in_use, pool.peak_in_use,
            pool.recycled_total, pool.capacity)


def _drive(pool, handed):
    """Run SCRIPT against ``pool``; returns what each step returned and
    the counters after it."""
    log = []
    for op, arg in SCRIPT:
        if op == "alloc":
            out = pool.alloc(arg)
            handed.extend(out)  # graftlint: disable=refcount-pairing
        else:
            out = getattr(pool, op)([handed[i] for i in arg])
        pool.check()
        log.append((op, out, _view(pool)))
    return log


def test_scripted_sequence_matches_reference():
    want_pages, got_pages = [], []
    want = _drive(jpaging.PagePool(9, 16), want_pages)
    got = _drive(tpaging.PagePool(9, 16), got_pages)
    assert got == want
    assert got_pages == want_pages
    assert 0 not in got_pages  # the trap page is never handed out


@pytest.mark.parametrize("module", [jpaging, tpaging])
def test_exhaustion_and_bad_references(module):
    pool = module.PagePool(4, 8)
    assert pool.capacity == 3 and pool.pages_for_tokens(17) == 3
    first = pool.alloc(3)
    # graftlint: disable=refcount-pairing
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)  # graftlint: disable=refcount-pairing
    with pytest.raises(ValueError, match="unallocated"):
        pool.incref([0])  # graftlint: disable=refcount-pairing
    assert pool.decref(first) == first
    with pytest.raises(ValueError, match="unallocated"):
        pool.decref(first[:1])
    pool.check()
    assert pool.in_use == 0 and pool.peak_in_use == 3
    with pytest.raises(ValueError, match=">= 2 pages"):
        module.PagePool(1, 8)
    with pytest.raises(ValueError, match="page_size"):
        module.PagePool(4, 0)


def test_check_catches_a_corrupted_pool():
    pool = tpaging.PagePool(5, 8)
    pages = pool.alloc(2)
    # a page both free and allocated
    pool._free.append(pages[0])  # graftlint: disable=refcount-pairing
    with pytest.raises(AssertionError, match="free and allocated"):
        pool.check()


@pytest.mark.parametrize("dtype,quant", [
    ("bfloat16", "none"), ("float32", "none"), ("bfloat16", "int8"),
])
def test_kv_token_bytes_match_reference(dtype, quant):
    jcfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype),
                                   cache_quant=quant, head_dim_override=64)
    tcfg = tllama.LlamaConfig.tiny(dtype=getattr(torch, dtype),
                                   cache_quant=quant, head_dim_override=64)
    assert tpaging.kv_token_bytes(tcfg) == jpaging.kv_token_bytes(jcfg)
    assert tpaging.kv_shard_token_bytes(tcfg) == \
        jpaging.kv_shard_token_bytes(jcfg)


def test_kv_token_bytes_of_llama3_8b():
    cfg = tllama.LlamaConfig.llama3_8b()
    assert tpaging.kv_token_bytes(cfg) == 131072          # 2*32*8*128*2
    cfg8 = tllama.LlamaConfig(**{**cfg.__dict__, "cache_quant": "int8"})
    assert tpaging.kv_token_bytes(cfg8) == 67584          # codes + scales
