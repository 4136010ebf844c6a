"""MoE serving in the port against the reference's: the dense-mix decode
MLP, generation, the continuous batcher, quantized expert stacks,
speculative decoding with a MoE target, adapters on a MoE config, the
server's quantize-as-drawn weights and its Mixtral preset.

A tiny f32 config (2 layers, 4 experts, top 2, ``capacity_factor`` 8.0
so the training forward drops no token, as the reference's
``tests/test_generate.py`` sets it); the JAX weights are carried across
with ``params_from_jax``. Streams must be equal; logprobs and logits
agree within 1e-4; one MLP call within 1e-5. Routing near ties are
handled as in ``tests/test_torch_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import lora as jlora
from k8s_gpu_device_plugin_tpu.models import lora_serving as jls
from k8s_gpu_device_plugin_tpu.models import moe as jmoe
from k8s_gpu_device_plugin_tpu.models import quantized_serving as jqs
from k8s_gpu_device_plugin_tpu.models import speculative as jspec
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import lora as tlora
from k8s_gpu_device_plugin_torch.models import lora_serving as tls
from k8s_gpu_device_plugin_torch.models import moe as tmoe
from k8s_gpu_device_plugin_torch.models import quantized_serving as tqs
from k8s_gpu_device_plugin_torch.models import speculative as tspec
from k8s_gpu_device_plugin_torch.models.convert import (
    lora_params_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4
from k8s_gpu_device_plugin_torch.serving import server as srv
from tests.test_torch_moe import selections_agree

torch.set_num_threads(1)

ATOL = 1e-5        # one MLP call, f32
LOGITS_ATOL = 1e-4  # a whole forward, and served logprobs, f32
E, K = 4, 2
QUANTS = [("int8", None), ("int4", 32), ("int4", 128)]


def _configs(**kw):
    kw = {"n_layers": 2, "n_experts": E, "n_experts_per_token": K,
          "capacity_factor": 8.0, **kw}
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tllama.LlamaConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def quantized(models):
    """(quant, group) -> (the reference's quantized tree, the port's),
    quantized once each."""
    _, jparams, _, tparams = models
    trees = {}

    def get(quant, group):
        if (quant, group) not in trees:
            kw = {} if group is None else {"group": group}
            if quant == "int8":
                trees[quant, group] = (jqs.quantize_weights_int8(jparams),
                                       tqs.quantize_weights_int8(tparams))
            else:
                trees[quant, group] = (
                    jqs.quantize_weights_int4(jparams, **kw),
                    tqs.quantize_weights_int4(tparams, **kw))
        return trees[quant, group]

    return get


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _h(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _agree(jparams, tparams, h, layer):
    """Where the reference's and the port's top-k agree on h (a
    disagreement must be a near tie)."""
    jl = jnp.asarray(h) @ jparams["layers"]["router"][layer]
    _, ji, jp = jmoe.router_topk(jl, K)
    tl = tmoe.router_logits(torch.from_numpy(h),
                            tparams["layers"]["router"][layer])
    _, ti, _ = tmoe.router_topk(tl, K)
    return selections_agree(ji, ti.numpy(), jp)


# --- the decode MLP and generation ------------------------------------------


@pytest.mark.parametrize("t", [1, 16, 200])
def test_decode_moe_mlp_matches_the_reference(models, t):
    """Every expert computed and mixed by the gates; T 200 runs in chunks
    of 128 in both."""
    jcfg, jparams, tcfg, tparams = models
    h = _h((2, t, jcfg.d_model), seed=t)
    want = jgen._decode_moe_mlp(
        jnp.asarray(h), {k: v[1] for k, v in jparams["layers"].items()}, jcfg)
    got = tgen._decode_moe_mlp(
        torch.from_numpy(h), {k: v[1] for k, v in tparams["layers"].items()},
        tcfg)
    agree = _agree(jparams, tparams, h, layer=1)
    assert agree.mean() > 0.9
    np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree],
                               atol=ATOL, rtol=0)


def test_generate_and_prefill_match_the_reference(models):
    """Greedy ``generate`` gives the reference's tokens; the prefill's
    last-position log-probabilities agree within LOGITS_ATOL, and equal
    the port's own full forward (the dense mix against the capacity
    dispatch at ample capacity)."""
    jcfg, jparams, tcfg, tparams = models
    prompt = np.array([_prompt(3, 6), _prompt(4, 6)])
    want = jgen.generate(jparams, jnp.asarray(prompt), jcfg, max_new=8)
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlast, _ = jgen.prefill(jparams, jnp.asarray(prompt),
                            jgen.KVCache.init(jcfg, 2, 16), jcfg)
    tlast = tgen.prefill(tparams, torch.from_numpy(prompt),
                         tgen.KVCache.init(tcfg, 2, 16, "cpu"), tcfg)
    np.testing.assert_allclose(
        torch.log_softmax(tlast, -1).numpy(),
        np.asarray(jax.nn.log_softmax(jlast, -1)), atol=LOGITS_ATOL, rtol=0)
    full = tllama.forward(tparams, torch.from_numpy(prompt), tcfg)[:, -1]
    np.testing.assert_allclose(tlast.numpy(), full.numpy(),
                               atol=LOGITS_ATOL, rtol=0)


def test_chunked_prefill_logits_match_forward(models):
    """A 150-token prompt runs its MoE MLP in chunks of 128 and 22: the
    cached path's logits equal the full forward's at every position."""
    jcfg, jparams, tcfg, tparams = models
    prompt = torch.tensor([_prompt(5, 150)])
    cache = tgen.KVCache.init(tcfg, 1, 160, "cpu")
    got = tgen._forward_cached(tparams, prompt, cache, 0, tcfg)
    want = tllama.forward(tparams, prompt, tcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGITS_ATOL,
                               rtol=0)
    ref = jllama.forward(jparams, jnp.asarray(prompt.numpy()), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batcher_matches_the_jax_batcher(models, layout):
    """Four requests through two slots, chunked prefill 16, on a dense
    cache and a paged pool: the reference's greedy streams, logprobs
    within LOGITS_ATOL."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(n_slots=2, max_len=128, chunked_prefill=16)
    if layout == "paged":
        jcfg = dataclasses.replace(jcfg, kv_layout="paged", kv_page_size=16)
        tcfg = dataclasses.replace(tcfg, kv_layout="paged", kv_page_size=16)
        kw.update(kv_layout="paged", kv_page_size=16)
    specs = [(5, 9), (16, 6), (40, 12), (70, 7)]
    prompts = [_prompt(20 + i, n) for i, (n, _) in enumerate(specs)]
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, pipeline_depth=0, **kw)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
    jr = [jcb.submit(p, max_new=n) for p, (_, n) in zip(prompts, specs)]
    tr = [tcb.submit(p, max_new=n) for p, (_, n) in zip(prompts, specs)]
    jcb.run()
    tcb.run()
    for a, b, (_, n) in zip(jr, tr, specs):
        want, got = jcb.done_requests[a], tcb.done_requests[b]
        assert len(got.out) == n
        assert got.out == want.out
        np.testing.assert_allclose(got.out_logp, want.out_logp,
                                   atol=LOGITS_ATOL, rtol=0)


# --- quantized expert stacks ----------------------------------------------


def _codes(leaf):
    if isinstance(leaf, torch.Tensor):
        return (unpack_int4(leaf) if leaf.dtype == torch.uint8
                else leaf).numpy().astype(np.int32)
    return np.asarray(leaf).astype(np.int32)


@pytest.mark.parametrize("quant,group", QUANTS)
def test_expert_stacks_quantize_as_the_reference(models, quantized, quant,
                                                 group):
    """Per-(layer, expert, output channel) int8 scales (L, E, 1, N), int4
    group scales (L, E, in / group, N) with the codes packed two a byte:
    the reference's codes (a code at a rounding boundary may differ by
    one, ROADMAP C) and scales within 1e-6 relative; the router stays
    f32; ``qexpert_einsum`` on both patterns within ATOL."""
    jcfg, jparams, tcfg, tparams = models
    jq, tq = quantized(quant, group)
    key = "q" if quant == "int8" else "q4"
    assert tq["layers"]["router"].dtype == torch.float32
    L, d, f = tcfg.n_layers, tcfg.d_model, tcfg.d_ff
    for name, (k, n) in (("moe_w1", (d, f)), ("moe_w3", (d, f)),
                         ("moe_w2", (f, d))):
        want, got = jq["layers"][name], tq["layers"][name]
        assert set(got) == {key, "s"}
        if quant == "int8":
            assert got["s"].shape == (L, E, 1, n)
        else:
            assert got[key].dtype == torch.uint8
            assert got[key].shape == (L, E, k, n // 2)
            assert got["s"].shape == (L, E, k // (group or 128), n)
        diff = np.abs(_codes(got[key]) - _codes(want[key]))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                                   rtol=1e-6, atol=0)
    assert tqs.weight_quant_of(tq) == quant
    rng = np.random.default_rng(7)
    for pattern, name, shape in (
            ("btd,edf->btef", "moe_w1", (2, 3, d)),
            ("btef,efd->bted", "moe_w2", (2, 3, E, f))):
        x = rng.standard_normal(shape).astype(np.float32)
        jw = jax.tree.map(lambda a: a[1], jq["layers"][name])
        tw = tqs.layer_slice(tq["layers"][name], 1)
        want = jqs.qexpert_einsum(pattern, jnp.asarray(x), jw)
        got = tqs.qexpert_einsum(pattern, torch.from_numpy(x), tw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        flt = tqs.qexpert_einsum(pattern, torch.from_numpy(x),
                                 tparams["layers"][name][1])
        np.testing.assert_allclose(
            flt.numpy(), np.asarray(jnp.einsum(
                pattern, jnp.asarray(x), jparams["layers"][name][1])),
            atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant,group,band", [("int8", None, 0.05),
                                              ("int4", 32, 0.2)])
def test_quantized_decode_close_to_float(models, quantized, quant, group,
                                         band):
    """The reference's recipe (its ``tests/test_quantized_serving.py``):
    the quantized prefill within the width's band of the float one, and
    within LOGITS_ATOL of the reference's on the same quantized weights;
    greedy tokens mostly agree with float (int8)."""
    jcfg, jparams, tcfg, tparams = models
    jq, tq = quantized(quant, group)
    # the reference test's own prompt on its own weights
    prompt = np.asarray(jax.random.randint(
        jax.random.key(3 if quant == "int8" else 6), (1, 10), 0,
        jcfg.vocab_size, jnp.int32)).astype(np.int64)
    ref = tgen.prefill(tparams, torch.from_numpy(prompt),
                       tgen.KVCache.init(tcfg, 1, 16, "cpu"), tcfg)
    got = tgen.prefill(tq, torch.from_numpy(prompt),
                       tgen.KVCache.init(tcfg, 1, 16, "cpu"), tcfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=band)
    want, _ = jgen.prefill(jq, jnp.asarray(prompt),
                           jgen.KVCache.init(jcfg, 1, 16), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    toks = tgen.generate(tq, torch.from_numpy(prompt), tcfg, 8)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jgen.generate(
        jq, jnp.asarray(prompt), jcfg, max_new=8)))
    if quant == "int8":
        base = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, 8)
        assert (toks == base).float().mean().item() >= 0.5


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_as_drawn_equals_drawn_then_quantized(quant):
    """The server's weights: a MoE config's expert stacks quantized layer
    by layer as they are drawn equal the whole float tree drawn and then
    quantized, bit for bit; a dense config's draws are unchanged."""
    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    for cfg in (_configs()[1], tllama.LlamaConfig.tiny()):
        got = srv.load_params(cfg, seed=3, device="cpu", weight_quant=quant)
        want = tqs.quantize_weights(
            tllama.init_params(cfg, seed=3, device="cpu"), quant)
        same(got, want)
    # a stack quantized another way is refused by name
    int8_experts = tllama.init_params(
        _configs()[1], seed=3, device="cpu",
        expert_leaf=tqs.expert_quantizer("int8"))
    with pytest.raises(ValueError, match="moe_w1"):
        tqs.quantize_weights_int4(int8_experts)


# --- speculative decoding and adapters ----------------------------------------


def test_speculative_is_lossless_with_a_moe_target(models):
    """Greedy speculative decoding with a MoE target and a dense draft
    gives the target's own greedy tokens, the reference's too."""
    jcfg, jparams, tcfg, tparams = models
    jcfg_d = jllama.LlamaConfig.tiny(n_layers=1, dtype=jnp.float32)
    tcfg_d = tllama.LlamaConfig.tiny(n_layers=1, dtype=torch.float32)
    jparams_d = jllama.init_params(jax.random.key(9), jcfg_d)
    tparams_d = params_from_jax(jax.tree.map(np.asarray, jparams_d), tcfg_d,
                                device="cpu")
    prompt = np.arange(1, 7)[None, :]
    toks, _ = tspec.speculative_generate(tparams, tcfg, tparams_d, tcfg_d,
                                         torch.from_numpy(prompt), 8, gamma=3)
    plain = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, 8)
    want, _ = jspec.speculative_generate(jparams, jcfg, jparams_d, jcfg_d,
                                         jnp.asarray(prompt), max_new=8,
                                         gamma=3)
    np.testing.assert_array_equal(toks.numpy(), plain.numpy())
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def test_mixed_adapter_batch_on_a_moe_config(models):
    """Adapters on a MoE config target attention only: base and two
    adapters decode in one batch with the JAX batcher's greedy tokens
    (logprobs within LOGITS_ATOL); an MLP target is refused."""
    jcfg, jparams, tcfg, tparams = models
    lcs = [jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wo")),
           jlora.LoraConfig(rank=8, alpha=16.0)]
    jlps = []
    for i, lc in enumerate(lcs):
        lp = jlora.init_lora_params(jax.random.key(i + 1), jcfg, lc)
        jlps.append({t: {"a": ab["a"], "b": 0.3 * jax.random.normal(
            jax.random.fold_in(jax.random.key(10 + i), j), ab["b"].shape)}
            for j, (t, ab) in enumerate(sorted(lp.items()))})
    names = ("alpha", "beta")
    jaset = jls.stack_adapters(jcfg, list(zip(names, jlps, lcs)))
    taset = tls.stack_adapters(tcfg, [
        (n, lora_params_from_jax(jax.tree.map(np.asarray, lp), tcfg,
                                 device="cpu"),
         tlora.LoraConfig(rank=lc.rank, alpha=lc.alpha,
                          targets=tuple(lc.targets)))
        for n, lp, lc in zip(names, jlps, lcs)])
    kw = dict(n_slots=3, max_len=64, chunked_prefill=8)
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, adapters=jaset, **kw)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, adapters=taset, **kw)
    prompts = {a: _prompt(50 + a, 6) for a in (-1, 0, 1)}
    jr = {a: jcb.submit(p, max_new=8, adapter=a) for a, p in prompts.items()}
    tr = {a: tcb.submit(p, max_new=8, adapter=a) for a, p in prompts.items()}
    jcb.run()
    tcb.run()
    outs = set()
    for a in prompts:
        want, got = jcb.done_requests[jr[a]], tcb.done_requests[tr[a]]
        assert got.out == want.out, f"adapter {a}"
        np.testing.assert_allclose(got.out_logp, want.out_logp,
                                   atol=LOGITS_ATOL, rtol=0)
        outs.add(tuple(got.out))
    assert len(outs) == 3
    with pytest.raises(NotImplementedError, match="MoE"):
        tlora.init_lora_params(
            tcfg, tlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "w1")),
            generator=torch.Generator(), device="cpu")


# --- the server ------------------------------------------------------------


def test_server_takes_the_mixtral_preset():
    args = srv.build_parser().parse_args(
        ["--preset", "mixtral_8x7b", "--weightQuant", "int8"])
    cfg = srv.PRESETS[args.preset]()
    assert cfg.is_moe and cfg.n_experts == 8 and cfg.n_layers == 32
    assert (args.preset, args.weightQuant) == ("mixtral_8x7b", "int8")
    assert tqs.expert_quantizer("none") is None
    with pytest.raises(ValueError, match="weight_quant"):
        tqs.expert_quantizer("int2")
