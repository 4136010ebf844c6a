"""The port router's disaggregated prefill/decode relay over the port's
KV pages, mirroring ``tests/test_kv_transfer.py:349-468``.

Tiny f32 port replicas on the CPU (2 layers, hd 64, pages of 16, chunks
of 8) with a paged pool, in an in-process fleet. Pinned: a long-prompt
stream through a roled fleet (prefill on r0, its KV pages exported at
the first token and installed on a decode worker, the stream spliced
across the hop) equals a colocated run bit for bit, tokens and
logprobs, greedy and seeded, on f32 and int8 caches; the decode worker
makes no prefill chunk for it; a short prompt skips the hop; the
prefill replica holds no pages after it; ``/fleet/health`` shows the
roles, and draining the last prefill-capable replica is refused
(``role_empty``). With every decode worker dead the transfer falls back
to a re-prefill resume, bit for bit, counted as a ``fallback`` and not
charged as a death.
"""

import asyncio
import dataclasses

import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.serving.testing import (
    get_json,
    inprocess_fleet,
    post_json,
    stream_generate,
)
from tests.test_torch_router import BUCKETS, prompt, run

torch.set_num_threads(1)

ENGINE_KW = dict(n_slots=2, max_len=64, prompt_buckets=BUCKETS,
                 chunked_prefill=8, kv_layout="paged", kv_page_size=16)
DISAGG_KW = dict(roles="prefill=r0 decode=r1,r2", disagg_min_prompt=8,
                 prompt_buckets=BUCKETS, health_interval_s=0.1)


@pytest.fixture(scope="module")
def model():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                  n_layers=2)
    return cfg, tllama.init_params(cfg, seed=3, device="cpu")


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_disagg_streams_bit_identical(model, quant):
    cfg0, params = model
    cfg = dataclasses.replace(cfg0, cache_quant=quant)
    p = prompt(5, 20, cfg)

    async def body():
        refs = {}
        async with inprocess_fleet(params, cfg, n_replicas=1, device="cpu",
                                   engine_kw=ENGINE_KW,
                                   router_kw={"prompt_buckets": BUCKETS}) \
                as colo:
            for seed in (None, 123):
                refs[seed] = await stream_generate(colo.base, prompt=p,
                                                   max_new=8, seed=seed)
        async with inprocess_fleet(params, cfg, n_replicas=3, device="cpu",
                                   engine_kw=ENGINE_KW,
                                   router_kw=dict(DISAGG_KW)) as fleet:
            for i, seed in enumerate((None, 123)):
                cbs = [s.engine.cb for s in fleet.servers]
                chunks0 = [cb.prefill_chunks for cb in cbs]
                got = await stream_generate(fleet.base, prompt=p,
                                            max_new=8, seed=seed)
                assert not got["error"], got
                assert got["tokens"] == refs[seed]["tokens"], (quant, seed)
                assert got["logprobs"] == refs[seed]["logprobs"]
                st = fleet.router.router_stats()
                assert st["kv_transfers"].get("ok", 0) == i + 1
                # the decode workers installed the pages: no prefill chunk
                assert [cb.prefill_chunks for cb in cbs][1:] == chunks0[1:]
                assert cbs[0].prefill_chunks > chunks0[0]
            st = fleet.router.router_stats()
            assert st["kv_transferred_pages"] > 0
            assert len(st["kv_transfer_ms"]) == 2
            assert st["roles"] == {"r0": "prefill", "r1": "decode",
                                   "r2": "decode"}
            transfers = [e for e in fleet.router.journal.events_payload()[
                "events"] if e["kind"] == "kv_transfer"]
            assert [e["outcome"] for e in transfers] == ["ok", "ok"]
            assert all(e["source"] == "r0" and e["pages"] > 0
                       for e in transfers)
            short = await stream_generate(fleet.base, prompt=p[:5],
                                          max_new=6)
            assert len(short["tokens"]) == 6 and not short["error"]
            assert fleet.router.router_stats()["kv_transfers"]["ok"] == 2
            assert fleet.servers[0].engine.cb.pool.in_use == 0
            for server in fleet.servers:
                server.engine.cb.pool.check()
            if quant == "none":
                s, snap = await get_json(f"{fleet.base}/fleet/health")
                assert {rid: rep["role"] for rid, rep in
                        snap["replicas"].items()} == {
                    "r0": "prefill", "r1": "decode", "r2": "decode"}
                assert snap["roles"]["prefill"]["replicas"] == 1
                s, _, d = await post_json(f"{fleet.base}/fleet/drain/r0")
                assert s == 409 and d["code"] == "role_empty"
                s, _, _ = await post_json(f"{fleet.base}/fleet/drain/r1")
                assert s == 200
                s, _, _ = await post_json(f"{fleet.base}/fleet/undrain/r1")
                assert s == 200

    run(body())


def test_disagg_transfer_failure_falls_back_bit_identical(model):
    """Every decode worker dead: the transfer leg finds no target and
    the router degrades to a re-prefill resume on the prefill replica —
    the same stream, counted as a fallback, not a replica death."""
    cfg, params = model
    p = prompt(5, 20, cfg)

    async def body():
        async with inprocess_fleet(params, cfg, n_replicas=1, device="cpu",
                                   engine_kw=ENGINE_KW,
                                   router_kw={"prompt_buckets": BUCKETS}) \
                as colo:
            ref = await stream_generate(colo.base, prompt=p, max_new=8)
        async with inprocess_fleet(params, cfg, n_replicas=3, device="cpu",
                                   engine_kw=ENGINE_KW,
                                   router_kw=dict(DISAGG_KW)) as fleet:
            await fleet.kill_replica(1)
            await fleet.kill_replica(2)
            for _ in range(100):
                if sum(1 for r in fleet.fleet.all() if r.alive) == 1:
                    break
                await asyncio.sleep(0.1)
            got = await stream_generate(fleet.base, prompt=p, max_new=8)
            assert not got["error"], got
            assert got["tokens"] == ref["tokens"]
            assert max(abs(a - b) for a, b in zip(
                got["logprobs"], ref["logprobs"])) <= 1e-5
            st = fleet.router.router_stats()
            assert st["kv_transfers"].get("fallback", 0) >= 1
            assert st["fleet_budget"]["charged_total"] == 0
            assert st["resume_failures"] == 0
            assert fleet.servers[0].engine.cb.pool.in_use == 0
            fleet.servers[0].engine.cb.pool.check()

    run(body())
