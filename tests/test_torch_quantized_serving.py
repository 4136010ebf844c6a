"""Weight-only int8/int4 serving against the reference's
``models/quantized_serving.py``.

A tiny f32 model (hd 64). The reference quantizes its weights; the port
quantizes the same weights after ``params_from_jax``, or converts the
reference's quantized tree. The pins:

- ``quantize_weights_int8``/``int4`` give the reference's codes (int4:
  unpacked from the port's two-per-byte storage) and scale bits, and
  ``params_from_jax`` on the reference's quantized tree gives the very
  tree the port quantizes itself;
- ``qmatmul``, ``_q4_matmul`` and ``qhead_matmul`` within 1e-5 of the
  reference's (f32; the same codes, summation order only);
- ``_forward_cached`` logits within 1e-4, and greedy ``generate`` streams
  equal, on the same quantized weights;
- the master-weight cast leaves quantized leaves untouched;
- the CPU server serves ``--weightQuant int4 --cacheQuant int4
  --kvLayout paged`` and reports the weights and the route in
  ``/v1/health``;
- MoE expert stacks are refused by name.

int4 runs at the reference tests' group of 32 (four groups on the tiny
model's 128-wide contractions) and, but for the whole forward, at the
default 128. The reference's recipes run eagerly, as its server runs
them: jitted whole, XLA fuses the recipe and some scales move by their
last bits (the codes stay).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import quantized_serving as jqs
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import quantized_serving as tqs
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4
from k8s_gpu_device_plugin_torch.serving import server as srv

torch.set_num_threads(1)

ATOL = 1e-5         # one product, f32
LOGITS_ATOL = 1e-4  # the whole forward, f32
RECIPES = {"int8": (jqs.quantize_weights_int8, tqs.quantize_weights_int8),
           "int4": (jqs.quantize_weights_int4, tqs.quantize_weights_int4)}
CASES = [("int8", None), ("int4", 32), ("int4", 128)]


def _configs():
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64),
            tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _configs()
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jparams, tparams


@pytest.fixture(scope="module")
def quantized(weights):
    """(quant, group) -> (the reference's quantized tree, the port's),
    each quantized once for the module."""
    jparams, tparams = weights
    trees = {}

    def get(quant, group):
        if (quant, group) not in trees:
            jq, tq = RECIPES[quant]
            kw = {} if group is None else {"group": group}
            trees[quant, group] = jq(jparams, **kw), tq(tparams, **kw)
        return trees[quant, group]

    return get


def _codes(leaf):
    """A leaf's codes as numpy int8 (int4: unpacked / widened)."""
    if isinstance(leaf, torch.Tensor):
        return (unpack_int4(leaf) if leaf.dtype == torch.uint8 else leaf).numpy()
    return np.asarray(leaf).astype(np.int8)


@pytest.mark.parametrize("quant,group", CASES)
def test_quantize_weights_give_the_reference_codes_and_scale_bits(
        weights, quantized, quant, group):
    jq, tq = quantized(quant, group)
    key = "q" if quant == "int8" else "q4"
    pairs = [(jq["lm_head"], tq["lm_head"])] + [
        (jq["layers"][n], tq["layers"][n]) for n in tqs._QUANT_LEAVES]
    for want, got in pairs:
        assert set(got) == {key, "s"}
        if quant == "int4":  # packed: half the output axis
            assert got[key].dtype == torch.uint8
            assert got[key].shape[-1] * 2 == want[key].shape[-1]
        np.testing.assert_array_equal(_codes(got[key]), _codes(want[key]))
        assert got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got["s"].numpy().view(np.uint32),
                                      np.asarray(want["s"]).view(np.uint32))
    # norms and the embedding table stay float, untouched
    assert tq["embed"] is weights[1]["embed"]
    assert tq["layers"]["attn_norm"] is weights[1]["layers"]["attn_norm"]
    assert tqs.weight_quant_of(tq) == quant


@pytest.mark.parametrize("quant,group", CASES)
def test_params_from_jax_takes_the_reference_quantized_tree(quantized, quant,
                                                            group):
    jq, tq = quantized(quant, group)
    got = params_from_jax(jax.tree.map(np.asarray, jq), _configs()[1],
                          device="cpu")

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same(got, tq)


@pytest.mark.parametrize("quant,group", CASES)
def test_qmatmul_and_head_match_the_reference(quantized, quant, group):
    jq, tq = quantized(quant, group)
    rng = np.random.default_rng(5)
    for name in ("wq", "wk", "w2"):
        jw = jax.tree.map(lambda x: x[1], jq["layers"][name])
        tw = tqs.layer_slice(tq["layers"][name], 1)
        k = _codes(tw["q" if quant == "int8" else "q4"]).shape[0]
        x = rng.standard_normal((2, 3, k)).astype(np.float32)
        want = jqs.qmatmul(jnp.asarray(x), jw)
        got = tqs.qmatmul(torch.from_numpy(x), tw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        if quant == "int4":
            want = jqs._q4_matmul(jnp.asarray(x), jw, out_f32=True)
            got = tqs._q4_matmul(torch.from_numpy(x), tw, out_f32=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)
    x = rng.standard_normal((2, 1, 128)).astype(np.float32)
    want = jqs.qhead_matmul(jnp.asarray(x), jq["lm_head"], jnp.float32)
    got = tqs.qhead_matmul(torch.from_numpy(x), tq["lm_head"], torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("quant,group", CASES[:2])
def test_forward_cached_and_generate_match_the_reference(quantized, quant,
                                                         group):
    jq, tq = quantized(quant, group)
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(6)
    jcache = jgen.KVCache.init(jcfg, 2, 48)
    tcache = tgen.KVCache.init(tcfg, 2, 48, "cpu")
    for t, length in ((16, 0), (1, 16), (1, 17)):
        tokens = rng.integers(1, jcfg.vocab_size, (2, t))
        want, jcache = jgen._forward_cached(
            jq, jnp.asarray(tokens, jnp.int32), jcache, jnp.int32(length),
            jcfg)
        got = tgen._forward_cached(tq, torch.from_numpy(tokens), tcache,
                                   length, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
    prompt = rng.integers(1, jcfg.vocab_size, (2, 9))
    want = jgen.generate(jq, jnp.asarray(prompt, jnp.int32), jcfg, 8)
    got = tgen.generate(tq, torch.from_numpy(prompt), tcfg, 8)
    assert got.tolist() == np.asarray(want).tolist()


def test_master_weight_cast_leaves_quantized_leaves_untouched(weights):
    _, tparams = weights
    cfg = tllama.LlamaConfig.tiny(head_dim_override=64,
                                  param_dtype=torch.float32)
    qparams = tqs.quantize_weights_int4(tparams)
    cast = tllama.cast_params_for_compute(qparams, cfg)
    for name, leaf in qparams["layers"].items():
        if isinstance(leaf, dict):
            assert cast["layers"][name] is leaf
        else:
            assert cast["layers"][name].dtype == torch.bfloat16
    assert tllama.head_weights(cast, cfg) is qparams["lm_head"]
    logits = tgen._forward_cached(qparams, torch.tensor([[3, 4, 5]]),
                                  tgen.KVCache.init(cfg, 1, 8, "cpu"), 0, cfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_server_serves_int4_weights_from_an_int4_pool():
    flags = ["--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
             "--port", "0", "--slots", "2", "--maxLen", "64",
             "--chunkedPrefill", "16", "--seed", "3", "--weightQuant", "int4",
             "--cacheQuant", "int4", "--kvLayout", "paged", "--kvPageSize",
             "16", "--kvPages", "5"]
    server = srv.build_server(srv.build_parser().parse_args(flags))
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        cb = server.engine.cb
        # the tiny preset's weights quantized as the server did, served by
        # a batcher of the same shape: the same greedy tokens
        params = tqs.quantize_weights_int4(
            srv.load_params(cb.cfg, seed=3, device="cpu"))
        twin = tbatch.ContinuousBatcher(params, cb.cfg, n_slots=2,
                                        max_len=64, chunked_prefill=16,
                                        kv_pages=5)
        rid = twin.submit(list(range(1, 21)), max_new=5)
        twin.run()
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": list(range(1, 21)),
                             "max_new": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["tokens"] == twin.done[rid]
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert {m["route"] for m in health["decode_attn"].values()} == {
            "int4_paged"}
        assert health["weights"] == {"quant": "int4",
                                     "resident_bytes":
                                         tqs.resident_bytes(params)}
        assert health["kv"]["pages_in_use"] == 0
    finally:
        server.stop()
    # params passed in must already carry the quantization the flag names
    args = srv.build_parser().parse_args(flags)
    with pytest.raises(ValueError, match="--weightQuant"):
        srv.build_server(args, params=srv.load_params(
            cb.cfg, seed=3, device="cpu"))


def test_moe_stacks_are_refused_by_name(weights):
    _, tparams = weights
    moe = {**tparams, "layers": {**tparams["layers"],
                                 "moe_w1": tparams["layers"]["w1"]}}
    for recipe in (tqs.quantize_weights_int8, tqs.quantize_weights_int4):
        with pytest.raises(NotImplementedError, match="MoE"):
            recipe(moe)
    with pytest.raises(ValueError, match="weight_quant"):
        tqs.quantize_weights(tparams, "int2")
    assert tqs.quantize_weights(tparams, "none") is tparams
