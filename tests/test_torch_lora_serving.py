"""Multi-LoRA serving in the port, held against the JAX package.

The port's ``models/lora.py`` and ``models/lora_serving.py`` and the
adapter paths of its batcher, server and OpenAI façade, on the tiny
config in f32. Both packages get the same numbers: the reference's
weights through ``params_from_jax`` and its adapters' factors (drawn with
JAX, B made nonzero as the reference's tests make it) through
``lora_params_from_jax``. Tolerances, stated where they are used: f32
elementwise functions within 1e-5 of the JAX functions; served greedy
tokens equal to the JAX batcher's and logprobs within 1e-4 (the two
frameworks order f32 reductions differently); inside the port, a served
adapter's greedy tokens equal ``generate`` on ``merge_lora`` weights
(the reference's oracle, ``tests/test_multilora.py``).
"""

import asyncio
import json
import urllib.error
import urllib.request
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import lora as tlora
from k8s_gpu_device_plugin_torch.models import lora_serving as tls
from k8s_gpu_device_plugin_torch.models.convert import (
    lora_params_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_torch.models.checkpoint import TrainCheckpointer
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.models.spec_batching import (
    SpeculativeBatcher,
)
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import lora as jlora
from k8s_gpu_device_plugin_tpu.models import lora_serving as jls
from k8s_gpu_device_plugin_tpu.models import quantized_serving as jqs

torch.set_num_threads(1)

F32_TOL = 1e-5    # elementwise f32 functions, port against JAX
LOGP_TOL = 1e-4   # served logprobs, port against the JAX batcher


def _rand_b(lp, seed):
    """Training starts B at zero (the base model); a served test needs a
    nonzero delta, so B is redrawn, as the reference's tests do."""
    out = {}
    for i, (t, ab) in enumerate(sorted(lp.items())):
        k = jax.random.fold_in(jax.random.key(seed), i)
        out[t] = {"a": ab["a"],
                  "b": 0.3 * jax.random.normal(k, ab["b"].shape,
                                               ab["b"].dtype)}
    return out


def _port_cfg(lc):
    return tlora.LoraConfig(rank=lc.rank, alpha=lc.alpha,
                            targets=tuple(lc.targets))


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    lcs = [jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wo", "w2")),
           jlora.LoraConfig(rank=8, alpha=16.0)]  # attention, other rank
    jlps = [_rand_b(jlora.init_lora_params(jax.random.key(i + 1), jcfg, lc),
                    10 + i) for i, lc in enumerate(lcs)]
    names = ("alpha", "beta")
    jaset = jls.stack_adapters(jcfg, list(zip(names, jlps, lcs)))
    entries = [(n, lora_params_from_jax(jax.tree.map(np.asarray, lp), tcfg,
                                        device="cpu"), _port_cfg(lc))
               for n, lp, lc in zip(names, jlps, lcs)]
    taset = tls.stack_adapters(tcfg, entries)
    merged = {-1: tparams}
    for i, (_, lp, lc) in enumerate(entries):
        merged[i] = tlora.merge_lora(tparams, lp, lc)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jaset=jaset, taset=taset, entries=entries, merged=merged,
                jlps=jlps, lcs=lcs)


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _oracle(merged, prompt, cfg, max_new):
    return generate(merged, torch.tensor([prompt]), cfg, max_new)[0].tolist()


# --- models/lora.py ----------------------------------------------------------


def test_lora_config_init_and_merge_match_the_reference(setup):
    """The config's validation and scale, the factors' shapes (B zeros:
    the merge of a fresh adapter is the base, exactly) and
    ``merge_lora`` against the reference's within F32_TOL."""
    with pytest.raises(ValueError, match="rank"):
        tlora.LoraConfig(rank=0)
    with pytest.raises(ValueError, match="untargetable"):
        tlora.LoraConfig(targets=("embed",))
    assert tlora.LoraConfig(rank=4, alpha=8.0).scale == 2.0
    tcfg, tparams = setup["tcfg"], setup["tparams"]
    lc = tlora.LoraConfig(rank=2, targets=("wq", "w2"))
    gen = torch.Generator().manual_seed(0)
    lp = tlora.init_lora_params(tcfg, lc, generator=gen, device="cpu")
    assert lp["wq"]["a"].shape == (tcfg.n_layers, 128, 2)
    assert lp["w2"]["b"].shape == (tcfg.n_layers, 2, 128)
    assert not lp["wq"]["b"].any()
    fresh = tlora.merge_lora(tparams, lp, lc)
    assert all(torch.equal(fresh["layers"][k], tparams["layers"][k])
               for k in tparams["layers"])
    for (_, lp_t, lc_t), lp_j, lc_j in zip(setup["entries"], setup["jlps"],
                                           setup["lcs"]):
        want = jlora.merge_lora(setup["jparams"], lp_j, lc_j)["layers"]
        got = tlora.merge_lora(tparams, lp_t, lc_t)["layers"]
        for t in lc_t.targets:
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                       atol=F32_TOL, rtol=0)


def test_stack_adapters_and_lora_delta_match_the_reference(setup):
    """The stacks (mixed ranks zero-padded, scale baked into B) and the
    per-row delta with one-hot and zero selection rows, against the JAX
    functions within F32_TOL; a zero row's delta is exactly zero."""
    for k, v in setup["jaset"].leaves.items():
        np.testing.assert_allclose(setup["taset"].leaves[k].numpy(),
                                   np.asarray(v), atol=F32_TOL, rtol=0)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 5, 128)).astype(np.float32)
    sel = np.array([[0, 1], [0, 0], [1, 0]], np.float32)
    for t in ("wq", "wo"):
        ja = setup["jaset"].leaves[f"lora_{t}_a"][1]
        jb = setup["jaset"].leaves[f"lora_{t}_b"][1]
        want = np.asarray(jls.lora_delta(jnp.asarray(h), ja, jb,
                                         jnp.asarray(sel)))
        got = tls.lora_delta(torch.from_numpy(h),
                             setup["taset"].leaves[f"lora_{t}_a"][1],
                             setup["taset"].leaves[f"lora_{t}_b"][1],
                             torch.from_numpy(sel))
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
        assert not got[1].any()  # the base row
    assert torch.equal(tls.one_hot_sel(1, 3), torch.tensor([0.0, 1.0, 0.0]))
    assert not tls.one_hot_sel(-1, 2).any()


def test_stack_adapters_validation(setup):
    tcfg = setup["tcfg"]
    lc = tlora.LoraConfig(rank=2)
    lp = tlora.init_lora_params(tcfg, lc, generator=torch.Generator(),
                                device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        tls.stack_adapters(tcfg, [("x", lp, lc), ("x", lp, lc)])
    with pytest.raises(ValueError, match="at least one"):
        tls.stack_adapters(tcfg, [])
    assert setup["taset"].index_of("beta") == 1
    with pytest.raises(KeyError, match="unknown adapter"):
        setup["taset"].index_of("nope")
    with pytest.raises(ValueError, match=">= n_adapters"):
        tls.one_hot_sel(5, 2)


# --- the batcher ---------------------------------------------------------------


@pytest.mark.parametrize("lora_slots", [None, 0], ids=["gathered", "dense"])
def test_mixed_adapters_one_batch_match_the_jax_batcher(setup, lora_slots):
    """Base and two adapters of different ranks and targets decode in
    one batch: greedy tokens equal the JAX batcher's (logprobs within
    LOGP_TOL), and each stream equals ``generate`` on its adapter's
    merged weights."""
    kw = dict(n_slots=3, max_len=64, chunked_prefill=8)
    jcb = jbatch.ContinuousBatcher(setup["jparams"], setup["jcfg"],
                                   adapters=setup["jaset"],
                                   lora_slots=lora_slots, **kw)
    tcb = tbatch.ContinuousBatcher(setup["tparams"], setup["tcfg"],
                                   adapters=setup["taset"],
                                   lora_slots=lora_slots, **kw)
    prompts = {a: _prompt(50 + a, 6) for a in (-1, 0, 1)}
    jr = {a: jcb.submit(p, max_new=8, adapter=a) for a, p in prompts.items()}
    tr = {a: tcb.submit(p, max_new=8, adapter=a) for a, p in prompts.items()}
    jcb.run()
    tcb.run()
    for a in prompts:
        want, got = jcb.done_requests[jr[a]], tcb.done_requests[tr[a]]
        assert got.out == want.out, f"adapter {a}"
        np.testing.assert_allclose(got.out_logp, want.out_logp,
                                   atol=LOGP_TOL, rtol=0)
        assert got.out == _oracle(setup["merged"][a], prompts[a],
                                  setup["tcfg"], 8)


def test_bucketed_prefill_path_and_slot_reuse(setup):
    """The bucketed path (``prefill_insert``) serves adapters too, and a
    slot reused across adapters stays exact."""
    tcb = tbatch.ContinuousBatcher(setup["tparams"], setup["tcfg"],
                                   n_slots=1, max_len=64,
                                   prompt_buckets=(8, 16),
                                   adapters=setup["taset"])
    for a, seed in ((0, 60), (-1, 61), (1, 62)):
        p = _prompt(seed, 5)
        rid = tcb.submit(p, max_new=6, adapter=a)
        assert tcb.run()[rid] == _oracle(setup["merged"][a], p,
                                         setup["tcfg"], 6), a


def test_adapter_prefix_compatibility(setup):
    """A prefix prefilled under an adapter serves that adapter exactly
    (through the batcher method: under gathered serving the adapter's
    compact slot is not its registry index); another adapter, or the
    base, is refused, and a base prefix refuses an adapter request."""
    tcfg = setup["tcfg"]
    cb = tbatch.ContinuousBatcher(setup["tparams"], tcfg, n_slots=2,
                                  max_len=64, chunked_prefill=8,
                                  adapters=setup["taset"])
    sys_prompt, suffix = _prompt(70, 9), _prompt(71, 4)
    prefix = cb.precompute_shared_prefix(sys_prompt, adapter=1)
    assert prefix.adapter == 1
    rid = cb.submit(suffix, max_new=6, prefix=prefix, adapter=1)
    assert cb.run()[rid] == _oracle(setup["merged"][1], sys_prompt + suffix,
                                    tcfg, 6)
    for other in (0, -1):
        with pytest.raises(ValueError, match="prefix was prefilled"):
            cb.submit(suffix, max_new=6, prefix=prefix, adapter=other)
    base = tbatch.precompute_prefix(setup["tparams"], sys_prompt, tcfg)
    for a in (0, 1):
        with pytest.raises(ValueError, match="prefix was prefilled"):
            cb.submit(suffix, max_new=5, prefix=base, adapter=a)
    assert cb.submit(suffix, max_new=5, prefix=base) >= 0
    cb.pending.clear()


def test_adapter_validation_and_guards(setup):
    """Out-of-range indices, the modes' argument rules, and the
    precompute guards that keep base rows from being labelled with an
    adapter."""
    tcfg, tparams, taset = setup["tcfg"], setup["tparams"], setup["taset"]
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=32,
                                  chunked_prefill=8, adapters=taset)
    with pytest.raises(ValueError, match="out of range"):
        cb.submit([1, 2], max_new=2, adapter=2)
    plain = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=32,
                                     chunked_prefill=8)
    with pytest.raises(ValueError, match="out of range"):
        plain.submit([1, 2], max_new=2, adapter=0)
    assert plain.adapter_stats() is None and plain.adapter_names == ()
    store = tls.AdapterStore.from_set(tcfg, taset)
    with pytest.raises(ValueError, match="dense-N"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 32, adapters=store,
                                 lora_slots=0)
    with pytest.raises(ValueError, match="own cache_bytes"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 32, adapters=store,
                                 adapter_cache_mb=4)
    with pytest.raises(ValueError, match="no effect on the dense-N"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 32, adapters=taset,
                                 lora_slots=0, adapter_cache_mb=4)
    with pytest.raises(ValueError, match="no registered adapters"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 32,
                                 adapters=tls.AdapterStore(tcfg))
    with pytest.raises(ValueError, match="needs n_adapters"):
        tbatch.precompute_prefix(tparams, [1, 2, 3], tcfg, adapter=0)
    with pytest.raises(ValueError, match="no stacked LoRA leaves"):
        tbatch.precompute_prefix(tparams, [1, 2, 3], tcfg, adapter=0,
                                 n_adapters=taset.n)
    with pytest.raises(ValueError, match="static AdapterSet"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 32, adapters=taset,
                                 lora_slots=0).register_adapter(
            "x", setup["entries"][0][1], setup["entries"][0][2])


def test_speculative_batcher_and_server_refuse_adapters(setup):
    """The speculative batcher refuses stacks (its draft has none to
    mirror), as the reference's does; the server refuses adapters, in
    process or by ``--loraAdapters``, only together with a draft."""
    tcfg, tparams = setup["tcfg"], setup["tparams"]
    with pytest.raises(ValueError, match="does not support LoRA"):
        SpeculativeBatcher(tparams, tcfg, tparams, tcfg, n_slots=1,
                           max_len=32, chunked_prefill=8,
                           adapters=setup["taset"])
    parser = srv.build_parser()
    base = ["--device", "cpu", "--preset", "tiny", "--port", "0"]
    with pytest.raises(ValueError, match="--draftPreset"):
        srv.build_server(parser.parse_args(
            base + ["--loraAdapters", "fr=/ckpt", "--draftPreset", "tiny"]))
    with pytest.raises(ValueError, match="--draftPreset"):
        srv.build_server(parser.parse_args(base + ["--draftPreset", "tiny"]),
                         adapters=setup["taset"])
    with pytest.raises(ValueError, match="needs adapters"):
        srv.build_server(parser.parse_args(base + ["--adapterCacheMB", "4"]))


def test_all_per_request_features_compose_in_one_batch(setup):
    """A base row with a +100 bias, a greedy adapter row held to its
    merged oracle and a sampled adapter row, in one decode step."""
    tcfg = setup["tcfg"]
    cb = tbatch.ContinuousBatcher(setup["tparams"], tcfg, n_slots=3,
                                  max_len=64, chunked_prefill=8,
                                  adapters=setup["taset"])
    p1, p2, p3 = (_prompt(s, 6) for s in (200, 201, 202))
    r_forced = cb.submit(p1, max_new=4, logit_bias={42: 100.0})
    r_adapter = cb.submit(p2, max_new=6, adapter=1)
    r_both = cb.submit(p3, max_new=5, adapter=0, seed=3,
                       sampler=Sampler(temperature=0.8, top_k=20))
    done = cb.run()
    assert done[r_forced] == [42] * 4
    assert done[r_adapter] == _oracle(setup["merged"][1], p2, tcfg, 6)
    assert len(done[r_both]) == 5
    assert all(0 <= t < tcfg.vocab_size for t in done[r_both])


@pytest.mark.parametrize("what", ["int8_kv", "int8_weights"])
def test_adapters_compose_with_int8(setup, what):
    """The deltas touch the products, int8 KV the storage and int8
    weights the base product (the delta is added to ``qmatmul``'s
    output): a batcher with either equals the JAX batcher with the same
    quantization (tokens; logprobs within LOGP_TOL)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jparams, tparams = setup["jparams"], setup["tparams"]
    if what == "int8_kv":
        jcfg = replace(jcfg, cache_quant="int8")
        tcfg = replace(tcfg, cache_quant="int8")
    else:
        jparams = jqs.quantize_weights_int8(jparams)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
    kw = dict(n_slots=2, max_len=64, chunked_prefill=8)
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, adapters=setup["jaset"],
                                   **kw)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, adapters=setup["taset"],
                                   **kw)
    prompts = {1: _prompt(210, 6), -1: _prompt(211, 5)}
    jr = {a: jcb.submit(p, max_new=6, adapter=a) for a, p in prompts.items()}
    tr = {a: tcb.submit(p, max_new=6, adapter=a) for a, p in prompts.items()}
    jcb.run()
    tcb.run()
    for a in prompts:
        want, got = jcb.done_requests[jr[a]], tcb.done_requests[tr[a]]
        assert got.out == want.out, (what, a)
        np.testing.assert_allclose(got.out_logp, want.out_logp,
                                   atol=LOGP_TOL, rtol=0)


# --- both HTTP APIs --------------------------------------------------------------


def _http(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_both_apis_route_adapters():
    """Through ``build_server(args, params=, adapters=)`` on the tiny
    preset (bf16), with ``init_random_adapters``: the native ``adapter``
    field and the OpenAI ``model`` field reach the same stacks, and each
    answer equals the same request served alone by a batcher over the
    same weights and adapters, bit for bit; ``/v1/models`` lists the
    adapters; unknown names answer 400 (native) and 404
    ``model_not_found`` (OpenAI); ``/v1/health`` has the ``adapters``
    section."""
    cfg = tllama.LlamaConfig.tiny()
    params = srv.load_params(cfg, seed=3, device="cpu")
    entries = tls.init_random_adapters(cfg, 2, 4, seed=5, device="cpu")
    aset = tls.stack_adapters(cfg, entries)
    prompt = _prompt(80, 5)

    def alone(adapter, max_new):
        cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                      chunked_prefill=8, adapters=aset)
        rid = cb.submit(prompt, max_new=max_new, adapter=adapter)
        return cb.run()[rid]

    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--port", "0", "--host",
        "127.0.0.1", "--slots", "2", "--maxLen", "64",
        "--chunkedPrefill", "8", "--attributionOff"])
    server = srv.build_server(args, params=params, adapters=aset)
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        status, got = _http(url, "/v1/generate", {
            "prompt": prompt, "max_new": 6, "adapter": "adapter1"})
        assert status == 200, got
        assert got["tokens"] == alone(1, 6)
        assert got["tokens"] != alone(-1, 6)
        status, got = _http(url, "/v1/completions", {
            "model": "adapter0", "prompt": prompt, "max_tokens": 6})
        assert status == 200, got
        assert got["model"] == "adapter0"
        assert got["usage"]["completion_tokens"] == 6
        status, got = _http(url, "/v1/completions", {
            "prompt": prompt, "max_tokens": 4})
        assert status == 200
        status, got = _http(url, "/v1/models")
        assert [m["id"] for m in got["data"]] == ["tpu-serving", "adapter0",
                                                  "adapter1"]
        status, got = _http(url, "/v1/generate", {
            "prompt": prompt, "max_new": 4, "adapter": "nope"})
        assert status == 400 and "unknown adapter" in got["error"]
        status, got = _http(url, "/v1/completions", {
            "model": "nope", "prompt": prompt, "max_tokens": 4})
        assert status == 404
        assert got["error"]["code"] == "model_not_found"
        status, health = _http(url, "/v1/health")
        assert health["adapters"]["mode"] == "gathered"
        assert health["adapters"]["registered"] == 2
        assert health["adapters"]["gathers"] >= 1
    finally:
        server.stop()


def test_engine_refuses_adapters_it_does_not_serve(setup):
    """An engine whose batcher serves no adapters refuses an adapter
    submit on the request thread, not mid-loop."""
    async def body():
        engine = srv.InferenceEngine(tbatch.ContinuousBatcher(
            setup["tparams"], setup["tcfg"], n_slots=1, max_len=32,
            chunked_prefill=8))
        try:
            with pytest.raises(ValueError, match="out of range"):
                engine.submit(_prompt(90, 4), 4, adapter=0)
        finally:
            engine.shutdown()

    asyncio.run(asyncio.wait_for(body(), timeout=60))


# --- adapters from training checkpoints ---------------------------------------


def _save(directory, tree, step=0):
    with TrainCheckpointer(str(directory), async_save=False) as ckpt:
        assert ckpt.save(tree, step=step, force=True)
    return str(directory)


def test_load_adapters_rejects_moe_mlp_targets(tmp_path):
    """The twin of the reference's: an adapter carrying w1/w2/w3 factors
    is refused on an MoE config at load time (the MoE decode path never
    reads them), and the same checkpoint loads on the dense config it was
    made for. The parse errors are the reference's."""
    dense = tllama.LlamaConfig.tiny(dtype=torch.float32)
    lc = tlora.LoraConfig(rank=2, targets=("wq", "w1"))
    gen = torch.Generator()
    gen.manual_seed(3)
    d = _save(tmp_path / "adapter",
              {"lora": tlora.init_lora_params(dense, lc, generator=gen,
                                              device="cpu")})
    moe = tllama.LlamaConfig.tiny(dtype=torch.float32, n_experts=4,
                                  n_experts_per_token=2, capacity_factor=4.0)
    with pytest.raises(ValueError, match="MoE expert MLPs"):
        srv.load_adapters(moe, f"bad={d}")
    aset = srv.load_adapters(dense, f"good={d}")
    assert aset.index_of("good") == 0
    for spec, why in ((f"={d}", "empty adapter name"),
                      (f"tpu-serving={d}", "collides"),
                      ("nodir", "expected name=ckptdir"),
                      (f"x={_save(tmp_path / 'empty', {'params': {}})}",
                       "no LoRA factors")):
        with pytest.raises(ValueError, match=why):
            srv.load_adapters(dense, spec)
    with pytest.raises(ValueError, match="do not fit"):
        srv.load_adapters(tllama.LlamaConfig.tiny(n_layers=1), f"x={d}")


def test_lora_adapters_flag_serves_a_trained_adapter(tmp_path):
    """An adapter trained by ``make_lora_train_step`` and saved with its
    state, served by ``--loraAdapters fr=dir`` (rank and targets read off
    the factors, alpha 2·rank): over HTTP the stream equals a batcher's
    with the same adapter (bf16, bit for bit) and differs from the base's;
    the same checkpoint loaded on the f32 config serves the greedy stream
    of ``generate`` on ``merge_lora`` weights (the merged oracle)."""
    cfg = tllama.LlamaConfig.tiny()
    params = srv.load_params(cfg, seed=3, device="cpu")
    lc = tlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w2"))
    opt = ttrain.make_optimizer(learning_rate=5e-2, warmup_steps=1,
                                total_steps=8)
    state = tlora.init_lora_state(cfg, lc, opt, seed=4, device="cpu")
    step = tlora.make_lora_train_step(params, cfg, lc, opt)
    batch = ttrain.synthetic_batch(cfg, 2, 32, seed=5, device="cpu")
    for _ in range(4):
        state, _ = step(state, batch)
    d = _save(tmp_path / "fr", state, step=state["step"])
    prompt = _prompt(81, 6)

    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--port", "0", "--host",
        "127.0.0.1", "--slots", "2", "--maxLen", "64", "--chunkedPrefill",
        "8", "--seed", "3", "--attributionOff", "--loraAdapters",
        f"fr={d}"])
    server = srv.build_server(args)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.bound_port}"
        status, got = _http(url, "/v1/generate",
                            {"prompt": prompt, "max_new": 6,
                             "adapter": "fr"})
        assert status == 200, got
        status, base_got = _http(url, "/v1/generate",
                                 {"prompt": prompt, "max_new": 6})
        assert status == 200
        status, models = _http(url, "/v1/models")
        assert [m["id"] for m in models["data"]] == ["tpu-serving", "fr"]
    finally:
        server.stop()
    aset = srv.load_adapters(cfg, f"fr={d}")
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                  chunked_prefill=8, adapters=aset)
    rid = cb.submit(prompt, max_new=6, adapter=0)
    assert got["tokens"] == cb.run()[rid]
    assert got["tokens"] != base_got["tokens"]

    cfg32 = replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if not isinstance(v, dict)
                    else {kk: vv.float() for kk, vv in v.items()})
                for k, v in params.items()}
    cb32 = tbatch.ContinuousBatcher(
        params32, cfg32, n_slots=2, max_len=64, chunked_prefill=8,
        adapters=srv.load_adapters(cfg32, f"fr={d}"))
    rid = cb32.submit(prompt, max_new=6, adapter=0)
    lp32 = {t: {k: v.float() for k, v in ab.items()}
            for t, ab in state["lora"].items()}
    assert cb32.run()[rid] == _oracle(
        tlora.merge_lora(params32, lp32, lc), prompt, cfg32, 6)
