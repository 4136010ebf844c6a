"""The port's pipelined decode loop (pipeline_depth=1) against its
synchronous one (pipeline_depth=0).

Dispatching step t+1 before reading step t back must not show in the
outputs: token streams and per-token logprobs are equal bit for bit
across every event that can land while a step is in flight (bucketed
and chunked admission, retirement on a stop sequence, budget or EOS,
cancellation, slot reuse), for greedy, seeded and unseeded streams, on
the dense and the paged layout. The unseeded scenario admits no request
behind a retirement: the pipeline sees a retirement one step later, so
such an admission (and the shared generator's draws behind it) would
come one step later. Then the loop's mechanics, as the reference pins
them (``tests/test_pipelined_decode.py``): the steady loop keeps its
device buffers (the same tensors, never rewritten), slot reuse flushes
the in-flight step while saturation does not, the budget is gated on the
device and the drain skips the wasted dispatch, the lag token after EOS
is dropped, and a threaded engine under load serves the oracle's tokens.
A tiny f32 model on the CPU (two layers, hd 64).
"""

import threading

import pytest
import torch

from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving.server import InferenceEngine

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    cfg = LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompt(key, n, cfg):
    gen = torch.Generator().manual_seed(key)
    return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()


def _oracle(params, prompt, cfg, max_new):
    return generate(params, torch.tensor([prompt]), cfg, max_new)[0].tolist()


def _batcher(params, cfg, depth, layout, **kw):
    paged = dict(kv_layout="paged", kv_page_size=16) if layout == "paged" \
        else {}
    return tbatch.ContinuousBatcher(params, cfg, max_len=MAX_LEN,
                                    pipeline_depth=depth, **paged, **kw)


def _streams(cb):
    return {rid: (list(r.out), list(r.out_logp))
            for rid, r in cb.done_requests.items()}


def _bucketed_churn(params, cfg, depth, layout):
    """More requests than slots through bucketed prefill: each budget
    retirement frees a slot for the next admission while a step is in
    flight."""
    cb = _batcher(params, cfg, depth, layout, n_slots=2)
    for key, plen, new in [(1, 5, 6), (2, 12, 4), (3, 33, 8), (4, 9, 5)]:
        cb.submit(_prompt(key, plen, cfg), max_new=new)
    cb.run()
    return _streams(cb)


def _chunked_midstream(params, cfg, depth, layout):
    """Chunked prefill interleaved with decode, and submissions landing
    while a step is in flight."""
    cb = _batcher(params, cfg, depth, layout, n_slots=2, chunked_prefill=4)
    cb.submit(_prompt(10, 4, cfg), max_new=10)
    for _ in range(3):
        cb.step()
    cb.submit(_prompt(11, 13, cfg), max_new=5)
    cb.submit(_prompt(12, 7, cfg), max_new=6)
    cb.run()
    return _streams(cb)


def _stop_sequences(params, cfg, depth, layout):
    """A stop-sequence retirement must not grow an extra token out of the
    in-flight step; its neighbour is untouched."""
    cb = _batcher(params, cfg, depth, layout, n_slots=2, chunked_prefill=4)
    p = _prompt(20, 5, cfg)
    oracle = _oracle(params, p, cfg, 8)
    cb.submit(p, max_new=8, stop=[[oracle[1], oracle[2]]])
    cb.submit(_prompt(21, 6, cfg), max_new=7)
    cb.run()
    return _streams(cb)


def _cancel_and_reuse(params, cfg, depth, layout):
    """A cancel mid-decode, then the freed slot reused: the stale
    in-flight token must vanish. The cancelled stream's length is timing
    (one token fewer while a step is in flight), so it is checked as a
    prefix of the oracle and left out of the comparison."""
    cb = _batcher(params, cfg, depth, layout, n_slots=1)
    p1 = _prompt(30, 5, cfg)
    r1 = cb.submit(p1, max_new=12)
    for _ in range(4):
        cb.step()
    cb.cancel(r1)
    cb.submit(_prompt(31, 6, cfg), max_new=5)
    cb.run()
    streams = _streams(cb)
    got, _ = streams.pop(r1)
    assert 1 <= len(got) < 12
    assert got == _oracle(params, p1, cfg, 12)[:len(got)]
    return streams


def _eos(params, cfg, depth, layout):
    """An EOS retirement with a queued successor in the same slot."""
    p = _prompt(40, 5, cfg)
    oracle = _oracle(params, p, cfg, 6)
    cb = _batcher(params, cfg, depth, layout, n_slots=1, eos_id=oracle[1])
    cb.submit(p, max_new=6)
    cb.submit(_prompt(41, 7, cfg), max_new=6)
    cb.run()
    return _streams(cb)


def _seeded_sampled(params, cfg, depth, layout):
    """Seeded requests draw at the device's draw index, the true i even
    when the step is dispatched ahead of the host's count; slots churn."""
    cb = _batcher(params, cfg, depth, layout, n_slots=2, chunked_prefill=4)
    cb.submit(_prompt(50, 5, cfg), max_new=6,
              sampler=Sampler(temperature=0.9, top_k=20), seed=7)
    cb.submit(_prompt(51, 9, cfg), max_new=8,
              sampler=Sampler(temperature=1.1, top_p=0.9), seed=123)
    cb.submit(_prompt(52, 6, cfg), max_new=5)  # greedy neighbour
    cb.submit(_prompt(53, 4, cfg), max_new=7,
              sampler=Sampler(temperature=1.0, repetition_penalty=1.3),
              seed=9)
    cb.run()
    return _streams(cb)


def _unseeded_sampled(params, cfg, depth, layout):
    """Unseeded requests draw from the shared generator, once per
    prefill and once per decode dispatch; no admission waits on a
    retirement, so both loops make the same draws in the same order."""
    cb = _batcher(params, cfg, depth, layout, n_slots=3, chunked_prefill=8,
                  sampler=Sampler(temperature=0.8, top_k=30), seed=11)
    cb.submit(_prompt(60, 5, cfg), max_new=9)
    cb.submit(_prompt(61, 20, cfg), max_new=4)
    cb.submit(_prompt(62, 11, cfg), max_new=7,
              sampler=Sampler(temperature=1.2, top_p=0.8))
    cb.run()
    return _streams(cb)


SCENARIOS = {
    "bucketed_churn": _bucketed_churn,
    "chunked_midstream": _chunked_midstream,
    "stop_sequences": _stop_sequences,
    "cancel_and_reuse": _cancel_and_reuse,
    "eos": _eos,
    "seeded_sampled": _seeded_sampled,
    "unseeded_sampled": _unseeded_sampled,
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_bit_identical_to_sync(setup, name, layout):
    cfg, params = setup
    sync = SCENARIOS[name](params, cfg, 0, layout)
    pipe = SCENARIOS[name](params, cfg, 1, layout)
    assert set(sync) == set(pipe) and sync
    for rid in sync:
        assert pipe[rid][0] == sync[rid][0], (name, rid, "tokens")
        assert pipe[rid][1] == sync[rid][1], (name, rid, "logprobs")


def test_pipeline_depth_validation(setup):
    cfg, params = setup
    for bad in (-1, 2):
        with pytest.raises(ValueError, match="pipeline_depth"):
            tbatch.ContinuousBatcher(params, cfg, 1, MAX_LEN,
                                     pipeline_depth=bad)
    assert tbatch.ContinuousBatcher(params, cfg, 1, MAX_LEN).pipeline_depth == 1


def _buffers(cb):
    state = cb.state
    return [cb._allowed, cb._knobs, cb._bias, cb._eos, state.lengths,
            state.last_token, state.active, state.presence, state.budget,
            state.seeds, state.draws, state.cache.k, state.cache.v]


def test_steady_state_reuses_cached_device_buffers(setup):
    """Once every slot decodes, each step reads and writes the same
    tensors (no rebinding: what a captured graph needs) and rewrites no
    per-slot input; a step is always in flight. A membership change
    (cancel) marks the inputs for one rewrite, in place."""
    cfg, params = setup
    cb = tbatch.ContinuousBatcher(params, cfg, 2, MAX_LEN)
    cb.submit(_prompt(70, 5, cfg), max_new=32, seed=5,
              sampler=Sampler(temperature=0.8))
    cb.submit(_prompt(71, 6, cfg), max_new=32, logit_bias={3: -2.0})
    cb.step()  # both admitted (bucketed), the first step dispatched
    cb.step()
    before = _buffers(cb)
    ptrs = [t.data_ptr() for t in before]
    for _ in range(5):
        cb.step()
        assert cb._inflight is not None
        assert not cb._slots_dirty
        after = _buffers(cb)
        assert all(a is b for a, b in zip(after, before))
        assert [t.data_ptr() for t in after] == ptrs
    cb.cancel(next(iter(cb.running.values())).rid)
    assert cb._slots_dirty
    cb.step()
    assert not cb._slots_dirty and all(
        a is b for a, b in zip(_buffers(cb), before))


def test_slot_reuse_flushes_inflight_but_saturation_does_not(setup):
    """Re-admitting a slot the in-flight step counted live flushes first;
    admissions into fresh slots, and a saturated queue, do not."""
    cfg, params = setup
    cb = tbatch.ContinuousBatcher(params, cfg, 2, MAX_LEN)
    cb.submit(_prompt(80, 5, cfg), max_new=16)
    cb.step()
    assert cb._inflight is not None
    cb.submit(_prompt(81, 5, cfg), max_new=4)   # a fresh slot
    cb.step()
    assert cb.pipeline_flushes == 0
    cb.submit(_prompt(82, 5, cfg), max_new=4)   # every slot busy: queued
    cb.step()
    assert cb.pipeline_flushes == 0
    # the hazard: a request the in-flight step counted live is cancelled,
    # and the next admission reuses its slot
    cb.cancel(next(iter(cb.running.values())).rid)
    cb.step()
    assert cb.pipeline_flushes >= 1
    cb.run()
    for req in cb.done_requests.values():
        want = _oracle(params, req.prompt, cfg, req.max_new)
        assert req.out == want[:len(req.out)]
    assert cb.decode_stats()["pipeline_flushes"] == cb.pipeline_flushes


def test_budget_exhaustion_is_gated_on_device(setup):
    """The device's budget, not the host, stops emission: two raw decode
    steps with the slot still allowed emit a token, then the -1
    sentinel."""
    cfg, params = setup
    cb = tbatch.ContinuousBatcher(params, cfg, 1, MAX_LEN)
    cb.submit(_prompt(83, 5, cfg), max_new=2)
    cb._admit()  # the prefill emits token 1 of 2: the device budget is 1
    allowed = torch.ones((1,), dtype=torch.bool)
    e1, _ = tbatch.decode_step(cb.params, cb.state, allowed, -1, cfg,
                               cb._knobs, cb.generator)
    e2, _ = tbatch.decode_step(cb.params, cb.state, allowed, -1, cfg,
                               cb._knobs, cb.generator)
    assert int(e1[0]) >= 0 and int(e2[0]) == -1
    assert int(cb.state.budget[0]) == 0 and int(cb.state.draws[0]) == 2


def test_budget_drain_skips_the_wasted_dispatch(setup):
    """When the budgets show that the in-flight step retires every running
    request, it is read back without a dispatch ahead: the pipelined loop
    dispatches as many steps as the synchronous one and ends empty."""
    cfg, params = setup
    counts = []
    for depth in (0, 1):
        cb = tbatch.ContinuousBatcher(params, cfg, 2, MAX_LEN,
                                      pipeline_depth=depth)
        r1 = cb.submit(_prompt(84, 5, cfg), max_new=3)
        r2 = cb.submit(_prompt(85, 6, cfg), max_new=3)
        done = cb.run()
        assert len(done[r1]) == 3 and len(done[r2]) == 3
        assert cb._inflight is None
        counts.append(cb.decode_steps)
    assert counts[0] == counts[1] == 2


def test_eos_lag_token_is_dropped_from_inflight(setup):
    """EOS cannot be predicted on the host, so the pipeline dispatches one
    step past it: that step emits the -1 sentinel for the retired slot
    (the device deactivated it), and nothing reaches the stream."""
    cfg, params = setup
    p = _prompt(86, 5, cfg)
    oracle = _oracle(params, p, cfg, 8)
    cb = tbatch.ContinuousBatcher(params, cfg, 1, MAX_LEN, eos_id=oracle[1])
    rid = cb.submit(p, max_new=8)
    cb.run()
    assert cb.done[rid] == oracle[:2]
    assert cb._inflight is not None
    assert int(cb._inflight.arrs[0][0]) == -1  # (emitted, logps)


def test_engine_threaded_stress_with_pipeline(setup):
    """The serving engine with the pipeline on under concurrent load: 12
    requests over 3 slots from staggered threads, two cancelled in flight;
    every other stream equals its oracle and the engine stays alive."""
    cfg, params = setup
    engine = InferenceEngine(tbatch.ContinuousBatcher(
        params, cfg, n_slots=3, max_len=MAX_LEN, chunked_prefill=8))
    assert engine.cb.pipeline_depth == 1
    prompts = {i: _prompt(700 + i, 4 + (i % 5), cfg) for i in range(12)}
    results: dict = {}

    def one(i):
        threading.Event().wait(0.002 * (i % 4))  # staggered admissions
        eid, q = engine.submit(prompts[i], max_new=4 + (i % 3))
        if i in (5, 9):
            threading.Event().wait(0.01)
            engine.cancel(eid)
        toks = []
        while (item := q.get(timeout=120)) is not None:
            toks.append(item[0])
        results[i] = toks

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(180)
    finally:
        engine.shutdown()
    assert not engine._dead.is_set() and len(results) == 12
    for i, toks in results.items():
        want = _oracle(params, prompts[i], cfg, 4 + (i % 3))
        if i in (5, 9):  # cancelled: any prefix of the oracle
            assert toks == want[:len(toks)]
        else:
            assert toks == want, i
