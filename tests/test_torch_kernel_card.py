"""The CUDA kernels on the card: shapes beyond chip_smoke.py's, refusals,
and the launch counts of a served request and of a train step.

Marked ``cuda``; every test skips without a CUDA device (decided inside
the fixture, so every worker collects the same tests). On a machine
without JAX, run it without the repository's conftest:

    python -m pytest tests/test_torch_kernel_card.py --noconftest -q

Tolerances of the ragged-paged kernel: f32 atol 1e-4 (summation order
only); bf16 atol = rtol = 2e-2 against the plain version (it rounds
normalised probabilities and the output to bf16; the engines round the
output, the tensor cores also the unnormalised weights and the
dequantized rows). The same on its paged, int8 and int4 routes (the
scale moves from after the product to before it: last bits). A launch on
the tensor cores is also held to one bf16 ulp of the plain version that
rounds where the engine does (``p_bf16=True``), as
``kernel_support.bf16_o_mismatch`` states. The paged route equals the
dense one on the same rows bit for bit, on both engines. The flash
kernels' are stated above their tests.
"""

import dataclasses

import pytest
import torch

from k8s_gpu_device_plugin_torch.models import train, trainer
from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.attention import (
    MHA_ROUTE,
    attention,
    mha_reference,
)
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.quant import pack_int4

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _routes_only(counts):
    """Launch counts without the per-engine keys."""
    engines = {kernel_support.engine_key(rpa.NAME, e)
               for e in kernel_support.ENGINES}
    return {k: n for k, n in counts.items() if k not in engines}


def _engine_counts(counts, name=rpa.NAME):
    return {e: counts.get(kernel_support.engine_key(name, e), 0)
            for e in kernel_support.ENGINES}


def _check_rpa(out, q, k, v, base, pages=None, **kw):
    """A ragged-paged launch's output against its plain versions, as the
    tolerances above state (a narrow window's split launch against the
    plain version that splits where it does)."""
    t, group = q.shape[1], q.shape[2] // k.shape[2]
    want = rpa.ragged_paged_attention_reference(q, k, v, base, pages, **kw)
    if rpa.engine(q.dtype, t, group) == "cuda_cores":
        torch.testing.assert_close(out.float(), want.float(), **TOL[q.dtype])
        return
    want_p = rpa.ragged_paged_attention_reference(
        q, k, v, base, pages, p_bf16=True,
        split_tiles=rpa.window_split(t, group), **kw)
    why = kernel_support.bf16_o_mismatch(out, want_p, want,
                                         TOL[torch.bfloat16])
    assert why is None, why


def _inputs(b, t, hq, hkv, hd, s, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((b, t, hq, hd), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (24, 3), (64, 1)])
@pytest.mark.parametrize("t,window", [(1, 0), (3, 0), (17, 5), (65, 0),
                                      (300, 100)])
def test_kernel_matches_plain_version(cuda, dtype, hd, hq, hkv, t, window):
    s = 520  # not a multiple of the 64-row kv tile
    q, k, v = _inputs(3, t, hq, hkv, hd, s, dtype)
    base = torch.tensor([-1, 0, s - t], dtype=torch.int32, device=cuda)
    got = rpa.ragged_paged_attention(q, k, v, base, scale=hd ** -0.5,
                                     window=window)
    _check_rpa(got, q, k, v, base, scale=hd ** -0.5, window=window)


def test_kernel_output_does_not_depend_on_the_other_slots(cuda):
    q, k, v = _inputs(4, 1, 32, 8, 128, 1024, torch.bfloat16)
    base = torch.tensor([700, 3, 1000, 64], dtype=torch.int32, device=cuda)
    both = rpa.ragged_paged_attention(q, k, v, base, scale=0.1)
    alone = rpa.ragged_paged_attention(q[2:3], k[2:3].contiguous(),
                                       v[2:3].contiguous(), base[2:3],
                                       scale=0.1)
    assert torch.equal(both[2:3], alone)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _inputs(2, 1, 8, 2, 128, 64, torch.bfloat16)
    base = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, k, v, base.long(), scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(q.half(), k.half(), v.half(), base,
                                   scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        rpa.ragged_paged_attention(q, k.transpose(0, 1).contiguous()
                                   .transpose(0, 1), v, base, scale=1.0)
    q96, k96, v96 = _inputs(2, 1, 8, 2, 96, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q96, k96, v96, base, scale=1.0)


def test_served_requests_launch_the_kernel_per_layer(cuda):
    cfg = LlamaConfig.tiny(head_dim_override=64)
    cb = ContinuousBatcher(init_params(cfg, seed=1, device=cuda), cfg,
                           n_slots=2, max_len=128, chunked_prefill=16)
    for plen in (5, 40, 70):
        cb.submit(list(range(1, plen + 1)), max_new=6)
    kernel_support.reset_launch_counts()
    out = cb.run()
    assert all(len(toks) == 6 for toks in out.values())
    need = cfg.n_layers * (cb.decode_steps + cb.prefill_chunks)
    counts = kernel_support.launch_counts()
    assert _routes_only(counts) == {rpa.NAME: need, rpa.route_key("dense"): need}
    assert sum(_engine_counts(counts).values()) == need


@pytest.mark.parametrize("layout,quant", [("dense", "none"),
                                          ("paged", "int8"),
                                          ("paged", "int4")])
def test_decode_graph_streams_equal_the_eager_loop(cuda, layout, quant):
    """The decode step captured as a CUDA graph, in the pipelined loop,
    serves the eager synchronous loop's streams bit for bit (greedy, a
    bias row, seeded), every replay counted as the launches it makes."""
    from k8s_gpu_device_plugin_torch.models.sampling import Sampler

    cfg = LlamaConfig.tiny(head_dim_override=64, cache_quant=quant)
    params = init_params(cfg, seed=1, device=cuda)
    streams = []
    for graph, depth in ((False, 0), (True, 1)):
        cb = ContinuousBatcher(params, cfg, n_slots=3, max_len=128,
                               chunked_prefill=16, kv_layout=layout,
                               kv_page_size=16, decode_graph=graph,
                               pipeline_depth=depth)
        assert (cb.graph is not None) == graph
        rids = [cb.submit(list(range(1, plen + 1)), max_new=8,
                          sampler=Sampler(temperature=0.9) if i else None,
                          seed=i or None,
                          logit_bias={7: 3.0} if i == 1 else None)
                for i, plen in enumerate((5, 40, 70, 23))]
        kernel_support.reset_launch_counts()
        cb.run()
        need = cfg.n_layers * (cb.decode_steps + cb.prefill_chunks)
        assert kernel_support.launch_counts()[rpa.NAME] == need
        if graph:
            assert cb.graph.replays == cb.decode_steps
            assert cb.graph.launches[rpa.NAME] == cfg.n_layers
        streams.append([(cb.done_requests[r].out, cb.done_requests[r].out_logp)
                        for r in rids])
    assert streams[0] == streams[1]


# --- the paged, int8 and int4 routes of K1 ----------------------------------


def _paged_inputs(b, t, hq, hkv, hd, ps, n_slot_pages, bases, dtype,
                  quant, seed=0):
    """A shuffled pool (every page finite, the trap page included): each
    slot reserves the pages its live rows need, the rest of its row is
    0. ``quant`` is ``'none'`` (q's dtype), ``'int8'`` or ``'int4'``
    (codes packed two per byte). Returns q, (k, v, k_scale, v_scale) and
    the table."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_pages = 1 + b * n_slot_pages
    ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).int()
    table = torch.zeros((b, n_slot_pages), dtype=torch.int32, device="cuda")
    taken = 0
    for i, base in enumerate(bases):
        n = max(1, -(-(base + t) // ps))
        table[i, :n] = ids[taken:taken + n]
        taken += n
    q = torch.randn((b, t, hq, hd), generator=gen, device="cuda", dtype=dtype)
    shape = (n_pages, ps, hkv, hd)
    if quant == "none":
        k = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        v = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        return q, (k, v, None, None), table
    qmax = 127 if quant == "int8" else 7
    k, v = (torch.randint(-qmax - 1, qmax + 1, shape, generator=gen,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    if quant == "int4":
        k, v = pack_int4(k), pack_int4(v)
    ks, vs = (torch.rand((*shape[:-1], 1), generator=gen, device="cuda")
              * 0.02 + 0.002 for _ in range(2))
    return q, (k, v, ks, vs), table


def _gathered(pool, table):
    if pool is None:
        return None
    return pool[table.long()].reshape(table.shape[0], -1,
                                      *pool.shape[-2:]).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd,hq,hkv", [(128, 8, 2), (64, 4, 4), (128, 24, 3)])
@pytest.mark.parametrize("ps", [8, 16, 64, 256])
@pytest.mark.parametrize("t,window", [(1, 0), (3, 0), (17, 5), (65, 0),
                                      (300, 100)])
def test_paged_and_int8_routes_match_plain_and_dense(cuda, dtype, quant,
                                                     hd, hq, hkv, ps, t,
                                                     window):
    s = 512
    bases = [-1, 0, s - t]
    q, (k, v, ks, vs), table = _paged_inputs(
        3, t, hq, hkv, hd, ps, s // ps, bases, dtype, quant)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, window=window)
    kernel_support.reset_launch_counts()
    paged = rpa.ragged_paged_attention(q, k, v, base, table, k_scale=ks,
                                       v_scale=vs, **kw)
    _check_rpa(paged, q, k, v, base, table, k_scale=ks, v_scale=vs, **kw)
    dense = rpa.ragged_paged_attention(
        q, _gathered(k, table), _gathered(v, table), base,
        k_scale=_gathered(ks, table), v_scale=_gathered(vs, table), **kw)
    assert torch.equal(paged, dense)
    routes = [rpa.route_name(p, quant) for p in (True, False)]
    counts = kernel_support.launch_counts()
    assert _routes_only(counts) == {
        rpa.NAME: 2, rpa.route_key(routes[0]): 1, rpa.route_key(routes[1]): 1}
    assert _engine_counts(counts)[rpa.engine(dtype, t, hq // hkv)] == 2


def test_inactive_slot_reads_the_trap_page_without_faulting(cuda):
    """An inactive decode slot: an all-zero table row at the virtual last
    row. Defined and finite; the live slot beside it is not disturbed."""
    ps, nsp = 64, 32
    q, (k, v, ks, vs), table = _paged_inputs(
        2, 1, 32, 8, 128, ps, nsp, [700, 0], torch.bfloat16, "int8")
    table[1] = 0
    base = torch.tensor([700, nsp * ps - 1], dtype=torch.int32, device=cuda)
    both = rpa.ragged_paged_attention(q, k, v, base, table, scale=0.1,
                                      k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(both).all()
    alone = rpa.ragged_paged_attention(q[:1], k, v, base[:1], table[:1],
                                       scale=0.1, k_scale=ks, v_scale=vs)
    assert torch.equal(both[:1], alone)


def test_new_routes_refuse_what_the_kernel_does_not_take(cuda):
    q, (k, v, ks, vs), table = _paged_inputs(
        2, 1, 8, 2, 128, 16, 4, [5, 9], torch.bfloat16, "int8")
    base = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    call = rpa.ragged_paged_attention
    with pytest.raises(ValueError, match="contiguous"):
        call(q, k, v, base, table.t().contiguous().t(), scale=1.0,
             k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="int32"):
        call(q, k, v, base, table.long(), scale=1.0, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="together"):
        call(q, k, v, base, table, scale=1.0, k_scale=ks)
    with pytest.raises(ValueError, match="power of two"):
        pool = torch.zeros((5, 48, 2, 128), device=cuda, dtype=torch.bfloat16)
        call(q, pool, pool, base, table, scale=1.0)
    with pytest.raises(ValueError, match="different devices"):
        call(q, k, v, base, table.cpu(), scale=1.0, k_scale=ks, v_scale=vs)
    # a uint8 cache is packed int4 codes: without its scales it raises,
    # and a full-width uint8 row is not a packed one
    _, (k4, v4, ks4, vs4), _ = _paged_inputs(
        2, 1, 8, 2, 128, 16, 4, [5, 9], torch.bfloat16, "int4")
    kernel_support.reset_launch_counts()
    with pytest.raises(ValueError, match="int4 cache needs k_scale"):
        call(q, k4, v4, base, table, scale=1.0)
    with pytest.raises(ValueError, match="does not match"):
        call(q, k.view(torch.uint8), v.view(torch.uint8), base, table,
             scale=1.0, k_scale=ks, v_scale=vs)
    assert kernel_support.launch_counts() == {}
    out = call(q, k4, v4, base, table, scale=1.0, k_scale=ks4, v_scale=vs4)
    assert torch.isfinite(out).all()
    assert kernel_support.launch_counts() == {
        rpa.NAME: 1, rpa.route_key("int4_paged"): 1,
        kernel_support.engine_key(rpa.NAME, "tensor_cores"): 1}


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_batcher_launches_its_route_and_matches_dense(cuda, quant):
    cfg = LlamaConfig.tiny(head_dim_override=64, dtype=torch.float32,
                           cache_quant=quant)
    params = init_params(cfg, seed=1, device=cuda)
    streams = {}
    for layout in ("dense", "paged"):
        cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=128,
                               chunked_prefill=16, kv_layout=layout,
                               kv_page_size=16,
                               kv_pages=8 if layout == "paged" else 0)
        rids = [cb.submit(list(range(1, plen + 1)), max_new=6)
                for plen in (5, 40, 70)]
        kernel_support.reset_launch_counts()
        cb.run()
        streams[layout] = [(cb.done_requests[r].out,
                            cb.done_requests[r].out_logp) for r in rids]
        counts = kernel_support.launch_counts()
        route = rpa.route_name(layout == "paged", quant)
        need = cfg.n_layers * (cb.decode_steps + cb.prefill_chunks)
        assert _routes_only(counts) == {rpa.NAME: need,
                                        rpa.route_key(route): need}
        assert _engine_counts(counts)["cuda_cores"] == need  # f32 model
        if layout == "paged":
            cb.pool.check()
            assert cb.pool.in_use == 0
            assert cb.kv_rejections()["pool_pressure"] >= 1
    assert streams["paged"] == streams["dense"]


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_weight_quantized_forward_on_the_card(cuda, weight_quant):
    """Weight-only quantized params on the card: an int4-cache forward
    through the kernel against the plain attention on the same weights
    (f32 logits, atol 1e-4: summation order only), and a served batch
    whose every launch is on the int4 route."""
    from k8s_gpu_device_plugin_torch.models import generate
    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        quantize_weights,
    )

    cfg = LlamaConfig.tiny(head_dim_override=64, dtype=torch.float32,
                           cache_quant="int4")
    params = quantize_weights(init_params(cfg, seed=1, device=cuda),
                              weight_quant)
    tokens = torch.randint(1, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    logits = []
    for plain in (False, True):
        cache = generate.KVCache.init(cfg, 2, 64, cuda)
        logits.append(generate._forward_cached(
            params, tokens, cache, 0, cfg, plain_attention=plain))
    torch.testing.assert_close(logits[0], logits[1], atol=1e-4, rtol=0)
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=128,
                           chunked_prefill=16, kv_layout="paged",
                           kv_page_size=16)
    for plen in (5, 40, 70):
        cb.submit(list(range(1, plen + 1)), max_new=6)
    kernel_support.reset_launch_counts()
    out = cb.run()
    assert all(len(toks) == 6 for toks in out.values())
    need = cfg.n_layers * (cb.decode_steps + cb.prefill_chunks)
    counts = kernel_support.launch_counts()
    assert _routes_only(counts) == {rpa.NAME: need,
                                    rpa.route_key("int4_paged"): need}
    assert _engine_counts(counts)["cuda_cores"] == need  # f32 model


# --- flash attention (K2, K3, K4) --------------------------------------------
# Tolerances: o in f32 atol 1e-4. In bf16 (the tensor-core engine) rtol
# 8e-3 with atol 1e-3, one bf16 ulp (at most 2^-7 of the value), against
# the plain version that rounds the weights p to bf16 where the kernel does
# (p_bf16=True): both compute the rest in f32 and round o once; a weight
# on a rounding boundary may flip, so kernel_support.FLIP_ROWS rows (or
# FLIP_ROW_SHARE of them) may miss. Against the f32 plain version o may move 2^-9 max|v|
# more (each weight by 2^-9 of itself, the weights summing to l): atol
# 1e-3 + 2^-9 max|v| (fa.o_wide_tol, kernel_support.bf16_o_mismatch).
# lse is f32 from the same inputs on both routes: atol 1e-4 (summation
# order only); so are dq, dk, dv in f32. In bf16 the tensor-core backward
# rounds p and dS to bf16 before its gradient products: its f32
# gradients are held to the plain versions that round them there
# (p_bf16=True) within kernel_support.GRAD_TIGHT of each element's
# magnitude (summation order, one flip of its largest term) in all but
# FLIP_ROWS rows, and to the f32 plain versions within GRAD_WIDE (2^-8 of
# the sum of |terms|, plus 1e-4): kernel_support.bf16_grad_mismatch.

GRAD_TOL = dict(atol=1e-4, rtol=0.0)


def _check_o(o, q, k, v, kw):
    """o against its plain versions, as the tolerances above state."""
    o_r, _ = fa.flash_fwd_reference(q, k, v, **kw)
    if o.dtype == torch.float32:
        torch.testing.assert_close(o, o_r, **TOL[torch.float32])
        return
    o_p, _ = fa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)
    why = kernel_support.bf16_o_mismatch(o, o_p, o_r, fa.o_wide_tol(v))
    assert why is None, why


def _check_grads(got, args, kw):
    """dk, dv, dq (f32) against their plain versions, as stated above."""
    dk_r, dv_r = fa.flash_bwd_dkv_reference(*args, **kw)
    want = {"dk": dk_r, "dv": dv_r,
            "dq": fa.flash_bwd_dq_reference(*args, **kw)}
    if args[0].dtype == torch.float32:
        for name, g in got.items():
            torch.testing.assert_close(g, want[name], **GRAD_TOL)
        return
    dk_p, dv_p = fa.flash_bwd_dkv_reference(*args, p_bf16=True, **kw)
    rounded = {"dk": dk_p, "dv": dv_p,
               "dq": fa.flash_bwd_dq_reference(*args, p_bf16=True, **kw)}
    magnitude = fa.flash_bwd_magnitudes(*args, **kw)
    for name, g in got.items():
        why = kernel_support.bf16_grad_mismatch(g, rounded[name], want[name],
                                                magnitude[name])
        assert why is None, f"{name}: {why}"


def _flash_inputs(bh, bhkv, s, hd, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn((rows, s, hd), generator=gen, device="cuda",
                        dtype=dtype) for rows in (bh, bhkv, bhkv, bh)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("s", [384, 640])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (True, 64),
                                           (True, 100), (True, 128),
                                           (False, 0)])
def test_flash_kernels_match_plain_versions(cuda, dtype, hd, hq, hkv, s,
                                            causal, window):
    q, k, v, do = _flash_inputs(2 * hq, 2 * hkv, s, hd, dtype)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    _check_o(o, q, k, v, kw)
    torch.testing.assert_close(lse, lse_r, **GRAD_TOL)
    delta = (do.float() * o_r.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse_r, delta)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    _check_grads({"dk": dk, "dv": dv, "dq": fa.flash_bwd_dq(*args, **kw)},
                 args, kw)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_matches_plain_backward(cuda, dtype, batch):
    """The autograd entry (K2, delta, K3, K4) against mha_reference under
    autograd. bf16: the entry's grads are the backward wrappers' f32
    gradients (from the kernel forward's o and lse, delta = rowsum(dO o))
    rounded to bf16 bit for bit, and those hold their tolerances."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn((batch, 256, h, 128), generator=gen,
                           device="cuda", dtype=dtype).requires_grad_()
               for h in (8, 2, 2))
    do = torch.randn((batch, 256, 8, 128), generator=gen, device="cuda",
                     dtype=dtype)
    for window in (0, 100):
        kernel_support.reset_launch_counts()
        o = fa.flash_attention(q, k, v, window=window)
        grads = torch.autograd.grad(o, (q, k, v), do)
        counts = kernel_support.launch_counts()
        assert [counts[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq")] == [1, 1, 1]
        want = mha_reference(q, k, v, window=window)
        want_grads = torch.autograd.grad(want, (q, k, v), do)
        o_tol = TOL[dtype] if dtype == torch.float32 else \
            fa.o_wide_tol(v.detach())
        torch.testing.assert_close(o.float(), want.float(), **o_tol)
        if dtype == torch.float32:
            for g, w in zip(grads, want_grads):
                torch.testing.assert_close(g, w, **GRAD_TOL)
            continue
        kw = dict(scale=128 ** -0.5, causal=True, window=window)
        qb, kb, vb, dob = (fa._to_bhsd(x.detach()) for x in (q, k, v, do))
        ob, lse = fa.flash_fwd(qb, kb, vb, **kw)
        delta = (dob.float() * ob.float()).sum(-1, keepdim=True)
        args = (qb, kb, vb, dob, lse, delta)
        dk, dv = fa.flash_bwd_dkv(*args, **kw)
        dq = fa.flash_bwd_dq(*args, **kw)
        for g, w, h in zip(grads, (dq, dk, dv), (8, 2, 2)):
            assert torch.equal(g, fa._from_bhsd(w, batch, h).bfloat16())
        _check_grads({"dk": dk, "dv": dv, "dq": dq}, args, kw)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, do = _flash_inputs(4, 2, 256, 128, torch.bfloat16)
    kw = dict(scale=0.1)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q, k.float(), v, **kw)
    q96, k96, v96, _ = _flash_inputs(4, 2, 256, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q96, k96, v96, **kw)
    q100, k100, v100, _ = _flash_inputs(4, 2, 100, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of"):
        fa.flash_fwd(q100, k100, v100, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     **kw)
    lse = torch.zeros((4, 256, 1), device="cuda")
    with pytest.raises(ValueError, match="f32"):
        fa.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse, **kw)
    with pytest.raises(ValueError, match="fold"):
        fa.flash_fwd(q[:3].contiguous(), k, v, **kw)


def test_attention_dispatch_counts_the_plain_route(cuda):
    """A CUDA tensor launches the kernels or raises; only ``plain=True``
    reaches mha_reference, and that route is counted."""
    q, k, v, _ = _flash_inputs(1, 1, 200, 64, torch.float32)
    q, k, v = (x.view(1, 200, 1, 64) for x in (q, k, v))
    kernel_support.reset_launch_counts()
    with pytest.raises(ValueError, match="seq_len=200"):
        attention(q, k, v)
    q96, k96, v96, _ = _flash_inputs(1, 1, 256, 96, torch.float32)
    with pytest.raises(ValueError, match="head_dim=96"):
        attention(*(x.view(1, 256, 1, 96) for x in (q96, k96, v96)))
    assert kernel_support.launch_counts() == {}
    out = attention(q, k, v, plain=True)
    assert kernel_support.launch_counts() == {MHA_ROUTE: 1}
    torch.testing.assert_close(out, mha_reference(q, k, v))
    # S 192: a multiple of the 64-row tile, not of the reference's 128
    q, k, v, _ = _flash_inputs(1, 1, 192, 64, torch.float32)
    q, k, v = (x.view(1, 192, 1, 64) for x in (q, k, v))
    kernel_support.reset_launch_counts()
    out = attention(q, k, v)
    assert kernel_support.launch_counts() == {
        "flash_fwd": 1, kernel_support.engine_key("flash_fwd", "cuda_cores"): 1}
    torch.testing.assert_close(out, mha_reference(q, k, v), **TOL[torch.float32])


def test_trainer_refuses_what_the_kernels_do_not_take(cuda):
    tcfg = trainer.TrainerConfig(model=LlamaConfig.tiny(), seq_len=128,
                                 device="cuda")
    with pytest.raises(ValueError, match="head_dim=16"):
        trainer.Trainer(tcfg)
    tcfg = trainer.TrainerConfig(model=LlamaConfig.tiny(head_dim_override=64),
                                 seq_len=100, device="cuda")
    with pytest.raises(ValueError, match="seq_len=100"):
        trainer.Trainer(tcfg)


def test_train_step_launches_the_flash_kernels_per_layer(cuda):
    cfg = dataclasses.replace(LlamaConfig.tiny(head_dim_override=64),
                              dtype=torch.float32)
    opt = train.make_optimizer()
    state = train.init_train_state(cfg, opt, seed=2, device=cuda)
    batch = train.synthetic_batch(cfg, 2, 128, seed=3, device=cuda)
    kernel_support.reset_launch_counts()
    _, m_kernel = train.make_train_step(cfg, opt)(state, batch)
    counts = kernel_support.launch_counts()
    assert counts["flash_bwd_dkv"] == counts["flash_bwd_dq"] == cfg.n_layers
    assert counts["flash_fwd"] == cfg.n_layers  # save_dots_attn keeps o
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _engine_counts(counts, name) == {"cuda_cores": cfg.n_layers,
                                                "tensor_cores": 0}
    assert MHA_ROUTE not in counts
    # the first update has learning rate 0: the plain step sees the same
    # parameters
    _, m_plain = train.make_train_step(cfg, opt, plain_attention=True)(
        state, batch)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_kernel[key], m_plain[key], atol=0,
                                   rtol=1e-4)


# --- the tensor-core engine: K2 bf16 and K1's chunk route --------------------


@pytest.mark.parametrize("hq,hkv,hd,window", [(32, 8, 128, 512), (8, 8, 64, 0),
                                              (32, 8, 128, 0)])
def test_flash_fwd_tensor_cores_at_training_shapes(cuda, hq, hkv, hd, window):
    """K2 bf16 at the trainer's S 2048: a window of 512 and hd 64 at group
    1 beside the headline shape; o within its tolerances, lse at 1e-4, two
    launches equal bit for bit, every launch on the tensor cores."""
    q, k, v, _ = _flash_inputs(2 * hq, 2 * hkv, 2048, hd, torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=True, window=window)
    kernel_support.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    assert _engine_counts(kernel_support.launch_counts(), "flash_fwd") == {
        "cuda_cores": 0, "tensor_cores": 2}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _check_o(o, q, k, v, kw)
    torch.testing.assert_close(lse, fa.flash_fwd_reference(q, k, v, **kw)[1],
                               **GRAD_TOL)


@pytest.mark.parametrize("hq,hkv,hd", [(32, 8, 128), (8, 8, 128), (32, 8, 64),
                                       (8, 8, 64)])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_backward_tensor_cores_at_training_shapes(cuda, hq, hkv, hd,
                                                        window):
    """K3 and K4 bf16 at the trainer's B 2, S 2048: every launch on the
    tensor cores, two launches equal bit for bit, the gradients within
    their tolerances."""
    q, k, v, do = _flash_inputs(2 * hq, 2 * hkv, 2048, hd, torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=True, window=window)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta)
    kernel_support.reset_launch_counts()
    runs = [(*fa.flash_bwd_dkv(*args, **kw), fa.flash_bwd_dq(*args, **kw))
            for _ in range(2)]
    counts = kernel_support.launch_counts()
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        assert _engine_counts(counts, name) == {"cuda_cores": 0,
                                                "tensor_cores": 2}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dk, dv, dq = runs[0]
    del runs
    _check_grads({"dk": dk, "dv": dv, "dq": dq}, args, kw)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("hd,hq,hkv", [(128, 32, 8), (64, 8, 8)])
@pytest.mark.parametrize("t,bases,window", [
    (3, [100, 0], 0),          # 12 query vectors: just past the decode tile
    (37, [100, 475], 0),
    (256, [0, 256], 0),
    (256, [1536, 0], 64),
])
def test_chunk_route_on_the_tensor_cores(cuda, quant, hd, hq, hkv, t, bases,
                                         window):
    """K1's chunk route (bf16 q) on every cache type: against the plain
    versions (one ulp of the p_bf16 one on the tensor cores), two launches
    bit for bit, the paged pool (pages of 16 and 64) equal to the dense
    cache bit for bit, every launch on the tensor cores (T 3 at group 1
    is 3 query vectors: a narrow window, split over its span)."""
    s = 512 if max(bases) + t <= 512 else 2048
    b = len(bases)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    for ps in (16, 64):
        q, (k, v, ks, vs), table = _paged_inputs(
            b, t, hq, hkv, hd, ps, s // ps, bases, torch.bfloat16, quant)
        kw = dict(scale=hd ** -0.5, window=window)
        dense_ops = [_gathered(x, table) for x in (k, v, ks, vs)]
        kernel_support.reset_launch_counts()
        paged = rpa.ragged_paged_attention(q, k, v, base, table, k_scale=ks,
                                           v_scale=vs, **kw)
        dense = rpa.ragged_paged_attention(q, dense_ops[0], dense_ops[1], base,
                                           k_scale=dense_ops[2],
                                           v_scale=dense_ops[3], **kw)
        again = rpa.ragged_paged_attention(q, dense_ops[0], dense_ops[1], base,
                                           k_scale=dense_ops[2],
                                           v_scale=dense_ops[3], **kw)
        engine = rpa.engine(torch.bfloat16, t, hq // hkv)
        assert _engine_counts(kernel_support.launch_counts())[engine] == 3
        assert torch.equal(dense, again)
        assert torch.equal(paged, dense)
        _check_rpa(paged, q, k, v, base, table, k_scale=ks, v_scale=vs, **kw)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_chunk_engines_agree_on_the_same_inputs(cuda, quant):
    """engine_override: a bf16 chunk on the CUDA cores (the yardstick
    chip_smoke.py times) against the plain version within TOL, the paged
    pool equal to the dense cache there too; f32 q refuses the tensor
    cores before launching."""
    bases, t, hd = [300, 0], 64, 128
    q, (k, v, ks, vs), table = _paged_inputs(
        2, t, 32, 8, hd, 16, 512 // 16, bases, torch.bfloat16, quant)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, k_scale=ks, v_scale=vs)
    kernel_support.reset_launch_counts()
    cores = rpa.ragged_paged_attention(q, k, v, base, table,
                                       engine_override="cuda_cores", **kw)
    assert _engine_counts(kernel_support.launch_counts()) == {
        "cuda_cores": 1, "tensor_cores": 0}
    want = rpa.ragged_paged_attention_reference(q, k, v, base, table, **kw)
    torch.testing.assert_close(cores.float(), want.float(),
                               **TOL[torch.bfloat16])
    dense = rpa.ragged_paged_attention(
        q, *(_gathered(x, table) for x in (k, v)), base,
        engine_override="cuda_cores", scale=kw["scale"],
        k_scale=_gathered(ks, table), v_scale=_gathered(vs, table))
    assert torch.equal(cores, dense)
    with pytest.raises(ValueError, match="take bf16 q"):
        rpa.ragged_paged_attention(q.float(), k if quant != "none" else
                                   k.float(), v if quant != "none" else
                                   v.float(), base, table,
                                   engine_override="tensor_cores", **kw)


# --- K1's narrow windows on the tensor cores: split-KV -----------------------

DECODE_BASES = [-1, 0, 1, 255, 256, 1000, 2046, 2047]


def _decode_operands(quant, hq=32, hkv=8, hd=128, ps=64, t=1,
                     bases=DECODE_BASES):
    """Decode over eight slots of a 2048-row table: the shuffled pool of
    ``_paged_inputs`` and the same rows gathered into a dense cache."""
    q, (k, v, ks, vs), table = _paged_inputs(
        len(bases), t, hq, hkv, hd, ps, 2048 // ps, bases, torch.bfloat16,
        quant)
    dense = tuple(_gathered(x, table) for x in (k, v, ks, vs))
    base = torch.tensor(bases, dtype=torch.int32, device="cuda")
    return q, (k, v, ks, vs), table, dense, base


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("hq,hkv,hd,window", [(32, 8, 128, 0),
                                              (32, 8, 128, 64),
                                              (8, 8, 64, 0)])
def test_decode_on_the_tensor_cores_on_every_route(cuda, quant, hq, hkv, hd,
                                                   window):
    """bf16 decode on the dense and paged routes of every cache type: each
    launch on the tensor cores, against the split-aware p_bf16 plain
    version (one ulp) and the f32 one (TOL), two launches bit for bit, the
    paged pool equal to the dense cache bit for bit."""
    q, (k, v, ks, vs), table, dense, base = _decode_operands(quant, hq, hkv,
                                                             hd)
    kw = dict(scale=hd ** -0.5, window=window)
    kernel_support.reset_launch_counts()
    paged = rpa.ragged_paged_attention(q, k, v, base, table, k_scale=ks,
                                       v_scale=vs, **kw)
    runs = [rpa.ragged_paged_attention(q, dense[0], dense[1], base,
                                       k_scale=dense[2], v_scale=dense[3],
                                       **kw) for _ in range(2)]
    assert _engine_counts(kernel_support.launch_counts()) == {
        "cuda_cores": 0, "tensor_cores": 3}
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(paged, runs[0])
    _check_rpa(paged, q, k, v, base, table, k_scale=ks, v_scale=vs, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_slot_alone_equals_the_slot_among_neighbours(cuda, layout,
                                                            quant):
    """A slot's splits come from its own span, K is a constant and the grid
    from the table's extent: each slot launched alone gives the bits it
    gets among its seven neighbours."""
    q, (k, v, ks, vs), table, dense, base = _decode_operands(quant)
    if layout == "dense":
        k, v, ks, vs = dense
        table = None
    kw = dict(scale=128 ** -0.5, k_scale=ks, v_scale=vs)
    both = rpa.ragged_paged_attention(q, k, v, base, table, **kw)
    for i in range(len(DECODE_BASES)):
        def one(x):
            return None if x is None else x[i:i + 1].contiguous()
        if table is None:
            alone = rpa.ragged_paged_attention(
                one(q), one(k), one(v), one(base), scale=kw["scale"],
                k_scale=one(ks), v_scale=one(vs))
        else:
            alone = rpa.ragged_paged_attention(one(q), k, v, one(base),
                                               one(table), **kw)
        assert torch.equal(alone, both[i:i + 1]), i


@pytest.mark.parametrize("t,hq,hkv,bases,s", [
    (2, 32, 8, [62, 1000, 2046], 2048),   # a verify window of 8 vectors
    (8, 8, 8, [0, 700, 1400], 1500),      # 8 rows at group 1; S off the split
    (1, 64, 8, [5, 1300], 1344),          # group 8
])
def test_narrow_windows_split_on_the_tensor_cores(cuda, t, hq, hkv, bases, s):
    """Narrow windows other than decode: every launch split on the tensor
    cores, within its tolerances, against the engine override's CUDA-core
    launch within TOL, with the grid from an extent that is not a multiple
    of a split."""
    q, k, v = _inputs(len(bases), t, hq, hkv, 128, s, torch.bfloat16)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    kw = dict(scale=128 ** -0.5)
    kernel_support.reset_launch_counts()
    got = rpa.ragged_paged_attention(q, k, v, base, **kw)
    cores = rpa.ragged_paged_attention(q, k, v, base,
                                       engine_override="cuda_cores", **kw)
    assert _engine_counts(kernel_support.launch_counts()) == {
        "cuda_cores": 1, "tensor_cores": 1}
    assert rpa.window_split(t, hq // hkv) == rpa.SPLIT_TILES
    _check_rpa(got, q, k, v, base, **kw)
    torch.testing.assert_close(got.float(), cores.float(),
                               **TOL[torch.bfloat16])

