"""The paged KV layout end to end: the cached forward and the batcher
against the reference's, and against the port's own dense layout.

A tiny f32 model (hd 64, page size 16, max_len 128, chunked prefill 16)
with the JAX weights converted. Pins:

- ``_forward_cached`` through a page table: f32 logits within atol 1e-4
  of the reference's paged forward (summation order only), the pools'
  live pages within 1e-5.
- One mixed workload on the batcher (five requests on two slots: admit,
  retire on budget, a stop sequence, a cancel mid-prefill and a cancel
  mid-decode): inside the port the paged layout gives the dense layout's
  tokens and logprobs bit for bit; against the reference's paged batcher
  (synchronous loop) the greedy streams are equal and the logprobs agree
  within atol 1e-4.
- A pool smaller than the workload needs defers an admission, counts one
  ``pool_pressure`` for the spell, then serves everything with the same
  streams; after every run the pool is back at its baseline and
  ``check()`` passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(1)

PS = 16
MAX_LEN = 128
CHUNK = 16
# (prompt length, max_new); index 1 is cancelled mid-prefill, index 3
# mid-decode, index 2 carries a stop sequence
SPECS = [(5, 9), (40, 12), (70, 7), (50, 10), (23, 6)]


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64,
                                   kv_layout="paged", kv_page_size=PS)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   kv_layout="paged", kv_page_size=PS)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_forward_cached_through_a_page_table_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(5)
    n_pages, per_slot = 9, 4
    table = np.asarray([[3, 7, 0, 0], [5, 1, 8, 0]], np.int32)
    jcache = jgen.KVCache.init_paged(jcfg, n_pages, PS)
    tcache = tgen.KVCache.init_paged(tcfg, n_pages, PS, "cpu")
    assert tcache.k.shape == jcache.k.shape and tcache.k_scale is None
    calls = [  # (tokens (B, T), length)
        (rng.integers(1, jcfg.vocab_size, (2, CHUNK)), 0),
        (rng.integers(1, jcfg.vocab_size, (2, CHUNK)), CHUNK),
        (rng.integers(1, jcfg.vocab_size, (2, 1)), np.asarray([32, 32])),
        (rng.integers(1, jcfg.vocab_size, (2, 1)), np.asarray([31, 33])),
    ]
    for tokens, length in calls:
        jlen = (jnp.asarray(length, jnp.int32) if np.ndim(length)
                else jnp.int32(length))
        tlen = (torch.tensor(length, dtype=torch.int32) if np.ndim(length)
                else int(length))
        want, jcache = jgen._forward_cached(
            jparams, jnp.asarray(tokens, jnp.int32), jcache, jlen, jcfg,
            pages=jnp.asarray(table))
        got = tgen._forward_cached(
            tparams, torch.from_numpy(tokens), tcache, tlen, tcfg,
            pages=torch.from_numpy(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    for leaf in ("k", "v"):  # page 0 is the trap page
        np.testing.assert_allclose(getattr(tcache, leaf).numpy()[:, 1:],
                                   np.asarray(getattr(jcache, leaf))[:, 1:],
                                   atol=1e-5, rtol=0)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def _drive(cb, prompts, stop):
    """The scripted workload, the same calls for either package's
    batcher. Returns the finished requests in submission order."""
    rids = [cb.submit(p, max_new=n, stop=[stop] if i == 2 else None)
            for i, (p, (_, n)) in enumerate(zip(prompts, SPECS))]
    cb.step()
    cb.step()
    assert any(r.rid == rids[1] for r in cb.prefilling.values())
    assert cb.cancel(rids[1])          # mid-prefill
    steps = 0
    while not any(r.rid == rids[3] and len(r.out) >= 3
                  for r in cb.running.values()):
        cb.step()
        steps += 1
        assert steps < 200
    assert cb.cancel(rids[3])          # mid-decode
    cb.run()
    return [cb.done_requests[r] for r in rids]


def _torch_batcher(tparams, tcfg, **kw):
    return tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2,
                                    max_len=MAX_LEN, chunked_prefill=CHUNK,
                                    **kw)


@pytest.fixture(scope="module")
def workload(models):
    """Streams of the port's dense batcher, and the stop sequence taken
    from request 2's unstopped stream."""
    _, _, tcfg, tparams = models
    prompts = _prompts(tcfg.vocab_size)
    free = _torch_batcher(tparams, tcfg, kv_layout="dense")
    rid = free.submit(prompts[2], max_new=SPECS[2][1])
    full = free.run()[rid]
    stop = full[3:5]
    dense = _drive(_torch_batcher(tparams, tcfg, kv_layout="dense"), prompts,
                   stop)
    ends = next(j for j in range(2, len(full) + 1) if full[j - 2:j] == stop)
    assert ends < len(full) and dense[2].out == full[:ends]  # stop kept
    assert dense[1].out == [] and len(dense[3].out) == 3
    assert [len(r.out) for r in (dense[0], dense[4])] == [9, 6]
    return prompts, stop, dense


def _pool_at_baseline(cb):
    cb.pool.check()
    return (cb.pool.in_use == 0 and cb.pool.free_pages == cb.pool.capacity
            and not cb._slot_pages)


def test_paged_batcher_equals_dense_batcher_bitwise(models, workload):
    _, _, tcfg, tparams = models
    prompts, stop, dense = workload
    cb = _torch_batcher(tparams, tcfg)   # the config says paged
    assert cb.pool.n_pages == 2 * (MAX_LEN // PS) + 1
    paged = _drive(cb, prompts, stop)
    for got, want in zip(paged, dense):
        assert got.out == want.out
        assert got.out_logp == want.out_logp
    assert _pool_at_baseline(cb)
    assert cb.pool.peak_in_use > 0
    assert cb.kv_rejections() == {"pool_pressure": 0, "request_too_large": 0}


def test_paged_batcher_matches_reference_paged_batcher(models, workload):
    jcfg, jparams, _, _ = models
    prompts, stop, dense = workload
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, n_slots=2, max_len=MAX_LEN,
                                   chunked_prefill=CHUNK, pipeline_depth=0)
    want = _drive(jcb, prompts, stop)
    for got, ref in zip(dense, want):  # dense == paged bitwise (above)
        assert got.out == ref.out
        np.testing.assert_allclose(got.out_logp, ref.out_logp, atol=1e-4,
                                   rtol=0)
    assert jcb.pool.in_use == 0


def test_small_pool_defers_then_serves_everything(models, workload):
    _, _, tcfg, tparams = models
    prompts, _, _ = workload
    specs = [SPECS[2], SPECS[0], SPECS[1]]        # need 5, 1 and 4 pages
    ps = [prompts[2], prompts[0], prompts[1]]

    def run(kv_pages):
        cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=3,
                                      max_len=MAX_LEN, chunked_prefill=CHUNK,
                                      kv_pages=kv_pages)
        rids = [cb.submit(p, max_new=n) for p, (_, n) in zip(ps, specs)]
        cb.step()
        waiting = [r.rid for r in cb.pending]
        out = cb.run()
        assert _pool_at_baseline(cb)
        return cb, [out[r] for r in rids], [cb.done_requests[r].out_logp
                                            for r in rids], waiting

    ample, toks, logps, waiting = run(0)
    assert waiting == [] and ample.kv_rejections()["pool_pressure"] == 0
    # 7 allocatable pages: 5 + 1 are taken, the third request needs 4 and
    # waits with a slot free until the first retires
    tight, toks2, logps2, waiting2 = run(8)
    assert len(waiting2) == 1
    assert tight.kv_rejections() == {"pool_pressure": 1,
                                     "request_too_large": 0}
    assert toks2 == toks and logps2 == logps
    assert tight.pool.peak_in_use <= 7 < ample.pool.peak_in_use
    stats = tight.kv_stats()
    assert stats["layout"] == "paged" and stats["pages_total"] == 7
    assert stats["pages_in_use"] == 0 and stats["fragmentation_pct"] == 0.0
    assert stats["reserved_bytes"] == 8 * PS * 2 * 2 * 4 * 64 * 4


def test_request_too_large_for_the_pool(models):
    _, _, tcfg, tparams = models
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=MAX_LEN,
                                  chunked_prefill=CHUNK, kv_pages=4)
    with pytest.raises(tbatch.RequestTooLargeError) as exc:
        cb.submit(list(range(1, 50)), max_new=8)    # 4 pages > 3
    assert exc.value.limit == 3 * PS and "KV pages" in str(exc.value)
    assert cb.kv_rejections()["request_too_large"] == 1
    with pytest.raises(tbatch.RequestTooLargeError) as exc:
        cb.submit(list(range(1, 120)), max_new=20)  # the slot's own wall
    assert exc.value.limit == MAX_LEN
    rid = cb.submit(list(range(1, 40)), max_new=8)  # 3 pages: fits
    assert len(cb.run()[rid]) == 8


def test_paged_refusals(models):
    _, _, tcfg, tparams = models
    make = lambda cfg=tcfg, **kw: tbatch.ContinuousBatcher(  # noqa: E731
        tparams, cfg, n_slots=2, max_len=MAX_LEN, chunked_prefill=CHUNK, **kw)
    with pytest.raises(ValueError, match="kv_pages must be >= 0"):
        make(kv_pages=-1)
    with pytest.raises(ValueError, match="must divide"):
        make(kv_page_size=48)
    with pytest.raises(ValueError, match="power of two"):
        tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=96,
                                 chunked_prefill=CHUNK, kv_page_size=12)
    with pytest.raises(ValueError, match="no effect"):
        make(kv_layout="dense", kv_pages=5)
    # a sliding window on the pool is served now: incremental
    # reservation and out-of-window recycling (tests/test_torch_longctx_
    # serving.py), the dense layout keeps its full rows
    windowed = tllama.LlamaConfig.tiny(
        dtype=torch.float32, head_dim_override=64, sliding_window=32)
    cb = make(windowed, kv_layout="paged", kv_page_size=PS)
    assert cb._incremental_reserve and cb.kv_stats()["attn_window"] == 32
    assert make(windowed, kv_layout="dense").pool is None
    # int4 codes ride the pool as int8 codes do
    int4 = tllama.LlamaConfig.tiny(cache_quant="int4", kv_layout="paged")
    assert (int4.cache_quant, int4.kv_layout) == ("int4", "paged")
    # the automatic prefix cache attaches (tests/test_torch_prefix_cache.py),
    # bound to the batcher's chunk; a KV page install is served
    # (tests/test_torch_kv_transfer.py) and takes a wire blob only
    pc = PrefixCache(tcfg, buckets=(32, 64), budget_bytes=1 << 20)
    cb = make(prefix_cache=pc)
    assert cb.prefix_cache is pc and pc.chunk == CHUNK
    assert pc.release_entry is not None
    with pytest.raises(ValueError, match="kv_pages without resume_out"):
        cb.submit([1, 2, 3], 4, kv_pages=b"blob")
    with pytest.raises(ValueError, match="not a KV wire blob"):
        cb.submit([1, 2, 3], 4, resume_out=[5], kv_pages=b"blob")
