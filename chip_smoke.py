#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check its kernel.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits non-zero without the final line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; the hand-written kernels are built from the sources in the
   checkout, timed.
2. ``ragged_paged_attention``'s kernel against its plain version at the
   Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128, S 2048): decode
   over eight slots, prefill chunks as the batcher runs them (one slot),
   a windowed case and an hd-64 group-1 case, each in bf16 and f32. Per
   case: max error, kernel / plain / ``scaled_dot_product_attention``
   times (CUDA-graph replays timed with CUDA events; SDPA is a yardstick
   the port never calls) and the bound (bytes over 3.35 TB/s or
   operations over the peak of the input type, whichever is larger).
3. Llama-3-8B with random weights: a 512-token prefill (two chunks of
   256) and 8 greedy decode steps through the kernel path and through the
   plain path; last-position f32 logits compared.
4. The server (``serving/server.py``) with ``--preset llama3_8b --slots 8
   --maxLen 2048 --chunkedPrefill 256`` on 127.0.0.1: six concurrent
   ``/v1/generate`` requests (one streamed, one with logprobs), launch
   counts over exactly that run, and one request replayed alone.
5. One ``{"kernels": [...]}`` line.
6. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # f32 outside the tensor cores
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),   # bf16 output rounding
       "float32": dict(atol=1e-4, rtol=0.0)}     # summation order only
LOGITS_BOUND = 1e-3   # phase 3: f32 model, kernel vs plain path, max abs
BF16_FACTOR = 1.5     # phase 3: bf16 kernel path's distance to the f32
                      # model, at most this times the plain path's

# (prompt length, max_new); index 3 streams, index 1 asks for logprobs
REQUESTS = [(17, 64), (200, 48), (256, 32), (700, 40), (1500, 56), (1900, 64)]
STREAMED, WITH_LOGPROBS = 3, 1


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --- phase 1 -----------------------------------------------------------------


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


# --- phase 2 -----------------------------------------------------------------


def graph_ms(torch, fn, reps: int, iters: int = 5) -> float:
    """Mean device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``iters`` times between CUDA events (no
    host launch overhead in the number)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def kernel_cases():
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    full = dict(hq=32, hkv=8, hd=128, s=2048)
    return [
        dict(name="decode", b=8, t=1, bases=bases8, window=0, **full),
        dict(name="prefill_t256_base0", b=1, t=256, bases=[0], window=0,
             **full),
        dict(name="prefill_t256_base256", b=1, t=256, bases=[256], window=0,
             **full),
        dict(name="prefill_t256_base1536", b=1, t=256, bases=[1536],
             window=0, **full),
        dict(name="prefill_t37_base100", b=1, t=37, bases=[100], window=0,
             **full),
        dict(name="decode_window64", b=8, t=1, bases=bases8, window=64,
             **full),
        dict(name="decode_hd64_group1", b=8, t=1, bases=bases8, window=0,
             hq=8, hkv=8, hd=64, s=2048),
    ]


def bound(case, rpa, torch, dtype_name: str) -> tuple[float, str, dict]:
    """Least time for the work this case's data needs: every input byte
    read once (q, the K/V rows some query attends, base), the output
    written once; 4 * hd operations per (query, q head, attended row)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    base = torch.tensor(case["bases"], dtype=torch.int32)
    rows = rpa.attended_rows(base, case["t"], case["window"])   # (B, T)
    q_pos = torch.clamp(base[:, None].long() + torch.arange(case["t"]), min=0)
    kv_rows = 0
    for b in range(case["b"]):
        lo = int((q_pos[b] - rows[b] + 1).min())
        kv_rows += int(q_pos[b].max()) - lo + 1
    q_bytes = case["b"] * case["t"] * case["hq"] * case["hd"] * elem
    kv_bytes = 2 * kv_rows * case["hkv"] * case["hd"] * elem
    nbytes = 2 * q_bytes + kv_bytes + 4 * case["b"]
    flops = 4 * case["hd"] * case["hq"] * int(rows.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "flops": flops}


def phase_kernels(torch, rpa) -> list[dict]:
    import torch.nn.functional as F

    results = []
    for case in kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            b, t, hq, hkv, hd, s = (case[k] for k in
                                    ("b", "t", "hq", "hkv", "hd", "s"))
            q = torch.randn((b, t, hq, hd), generator=gen, device="cuda",
                            dtype=dtype)
            k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                            dtype=dtype)
            v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                            dtype=dtype)
            base = torch.tensor(case["bases"], dtype=torch.int32,
                                device="cuda")
            kw = dict(scale=hd ** -0.5, window=case["window"])

            def kernel():
                return rpa.ragged_paged_attention(q, k, v, base, **kw)

            def plain():
                return rpa.ragged_paged_attention_reference(q, k, v, base,
                                                            **kw)

            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{case['name']} {dname}: non-finite kernel output")
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), **TOL[dname]):
                fail(f"{case['name']} {dname}: kernel disagrees with its "
                     f"plain version (max abs err {err:.3e}, {TOL[dname]})")

            # the library yardstick: SDPA over the whole cache with the
            # same boolean mask (reads every row, not just the live span)
            q_pos = torch.clamp(base[:, None].long()
                                + torch.arange(t, device="cuda"), min=0)
            k_pos = torch.arange(s, device="cuda")
            mask = k_pos[None, None, :] <= q_pos[:, :, None]
            if case["window"]:
                mask &= q_pos[:, :, None] - k_pos[None, None, :] < case["window"]
            mask = mask[:, None]                       # (B, 1, T, S)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, scale=kw["scale"],
                    enable_gqa=hq != hkv,
                )

            reps = 20 if t == 1 else 5
            row = {
                "case": case["name"], "dtype": dname, "b": b, "t": t,
                "hq": hq, "hkv": hkv, "hd": hd, "s": s,
                "bases": case["bases"], "window": case["window"],
                "max_abs_err": err,
                "ms": graph_ms(torch, kernel, reps),
                "plain_ms": graph_ms(torch, plain, max(1, reps // 4)),
                "library_ms": graph_ms(torch, library, reps),
            }
            row["bound_ms"], row["bound_by"], work = bound(case, rpa, torch,
                                                           dname)
            row.update(work)
            emit({"phase": 2, **row})
            results.append(row)
    return results


# --- phase 3 -----------------------------------------------------------------


def _model_logits(torch, generate, params, cfg, prompt, tokens, plain):
    """Last-position f32 logits of a 512-token prefill (two 256-token
    chunks) and of 8 decode steps fed ``tokens`` (filled in greedily by
    the first run, followed by the others) — (9, V)."""
    cache = generate.KVCache.init(cfg, 1, 512 + 8, "cuda")
    for start in (0, 256):
        last = generate._forward_cached(
            params, prompt[:, start:start + 256], cache, start, cfg,
            last_only=True, plain_attention=plain,
        )[:, -1]
    logits = [last]
    for i in range(8):
        if len(tokens) == i:
            tokens.append(int(logits[-1].argmax()))
        pos = torch.tensor([512 + i], dtype=torch.int32, device="cuda")
        tok = torch.tensor([[tokens[i]]], device="cuda")
        logits.append(generate._forward_cached(
            params, tok, cache, pos, cfg, plain_attention=plain,
        )[:, -1])
    out = torch.cat(logits).float()
    if not torch.isfinite(out).all():
        fail("model-level logits are not finite")
    return out


def phase_model(torch, server_mod, generate, cfg) -> dict:
    """The bf16 model through the kernel path and the plain path, and the
    same weights widened to f32 through both paths. In f32 the two paths
    differ only in summation order, so they must agree within
    LOGITS_BOUND; in bf16 each path also rounds differently (the plain
    version rounds probabilities to bf16 before the V product, the kernel
    keeps them in f32), so the bf16 check is that the kernel path lies no
    further from the f32 model than the plain path does."""
    import dataclasses

    import numpy as np

    params = server_mod.load_params(cfg, seed=SEED, device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({n: x.float() for n, x in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    rng = np.random.default_rng(SEED)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                          device="cuda")
    tokens: list[int] = []  # the bf16 kernel path picks; the others follow
    runs = {}
    for name, c, p, plain in (("bf16_kernel", cfg, params, False),
                              ("bf16_plain", cfg, params, True),
                              ("f32_kernel", cfg32, params32, False),
                              ("f32_plain", cfg32, params32, True)):
        runs[name] = _model_logits(torch, generate, p, c, prompt, tokens,
                                   plain)
    torch.cuda.synchronize()
    del params, params32
    torch.cuda.empty_cache()

    def err(a, b):
        return float((runs[a] - runs[b]).abs().max())

    ref = runs["f32_plain"]
    out = {
        "phase": 3,
        "f32_kernel_vs_plain": err("f32_kernel", "f32_plain"),
        "bound": LOGITS_BOUND,
        "bf16_kernel_vs_plain": err("bf16_kernel", "bf16_plain"),
        "bf16_kernel_vs_f32": err("bf16_kernel", "f32_plain"),
        "bf16_plain_vs_f32": err("bf16_plain", "f32_plain"),
        "per_position_bf16_kernel_vs_plain": [
            float(x) for x in
            (runs["bf16_kernel"] - runs["bf16_plain"]).abs().amax(-1)],
        "logits_std": float(ref.std()), "logits_abs_max": float(ref.abs().max()),
        "greedy_agreement_bf16_kernel_vs_plain": "%d/9" % int(
            (runs["bf16_kernel"].argmax(-1)
             == runs["bf16_plain"].argmax(-1)).sum()),
        "greedy_agreement_bf16_kernel_vs_f32": "%d/9" % int(
            (runs["bf16_kernel"].argmax(-1) == ref.argmax(-1)).sum()),
    }
    emit(out)
    if out["f32_kernel_vs_plain"] > LOGITS_BOUND:
        fail(f"f32 kernel-path logits differ from the plain path by "
             f"{out['f32_kernel_vs_plain']:.3e} > {LOGITS_BOUND}")
    if out["bf16_kernel_vs_f32"] > BF16_FACTOR * out["bf16_plain_vs_f32"]:
        fail(f"bf16 kernel path is {out['bf16_kernel_vs_f32']:.3e} from the "
             f"f32 model, more than {BF16_FACTOR}x the plain path's "
             f"{out['bf16_plain_vs_f32']:.3e}")
    return out


# --- phase 4 -----------------------------------------------------------------


def _post(url: str, body: dict) -> tuple[list[int], "list[float] | None", float]:
    """One /v1/generate; returns (tokens, logprobs, seconds to the first
    token frame for a stream else to the response)."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    first = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            payload = json.loads(resp.read())
            return payload["tokens"], payload.get("logprobs"), \
                time.perf_counter() - t0
        toks = []
        done = False
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if evt.get("done"):
                done = True
                break
            if "error" in evt:
                fail(f"stream error frame: {evt['error']}")
            if first is None:
                first = time.perf_counter() - t0
            toks.append(evt["token"])
        if not done:
            fail("stream ended without its done frame")
        return toks, None, first


def phase_serving(torch, server_mod, kernel_support, cfg) -> dict:
    import numpy as np

    args = server_mod.build_parser().parse_args([
        "--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
        "--chunkedPrefill", "256", "--host", "127.0.0.1", "--port", "0",
        "--seed", str(SEED),
    ])
    server = server_mod.build_server(args)
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        rng = np.random.default_rng(SEED + 1)
        bodies = []
        for i, (plen, max_new) in enumerate(REQUESTS):
            body = {"prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
                    "max_new": max_new}
            if i == STREAMED:
                body["stream"] = True
            if i == WITH_LOGPROBS:
                body["logprobs"] = True
            bodies.append(body)
        results: list = [None] * len(bodies)
        errors: list = []

        def worker(i):
            try:
                results[i] = _post(url, bodies[i])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        cb = server.engine.cb
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        launches = kernel_support.launch_counts().get(
            "ragged_paged_attention", 0)
        if errors or any(r is None for r in results):
            fail(f"serving requests failed: {errors}")
        health = server.engine.stats()
        decode_steps = health["decode_steps"] - steps0
        chunks = health["prefill_chunks"] - chunks0
        for i, ((toks, lps, _), (plen, max_new)) in enumerate(
                zip(results, REQUESTS)):
            if len(toks) != max_new:
                fail(f"request {i} (prompt {plen}) returned {len(toks)} "
                     f"tokens, wanted {max_new}")
            if i == WITH_LOGPROBS and (lps is None or len(lps) != max_new
                                       or not all(x <= 0 for x in lps)):
                fail(f"request {i}: bad logprobs {lps}")
        need = cfg.n_layers * (decode_steps + chunks)
        if launches < need:
            fail(f"the kernel launched {launches} times; the serving run "
                 f"needs {need} = {cfg.n_layers} layers x ({decode_steps} "
                 f"decode steps + {chunks} prefill chunks)")
        # the streamed request again, alone: its greedy stream must not
        # depend on the batch it was served in
        alone, _, _ = _post(url, {"prompt": bodies[STREAMED]["prompt"],
                                  "max_new": REQUESTS[STREAMED][1]})
        batched = results[STREAMED][0]
        if alone != batched:
            first = next(i for i, (x, y) in enumerate(zip(alone, batched))
                         if x != y)
            fail(f"greedy stream served alone differs from the batched one "
                 f"at token {first}")
        out = {
            "phase": 4, "requests": len(bodies), "wall_s": wall,
            "launches": launches, "decode_steps": decode_steps,
            "prefill_chunks": chunks, "launches_needed": need,
            "ttft_s_p50": health["ttft_s_p50"],
            "stream_ttft_s": results[STREAMED][2],
            "decode_tokens_per_s": health["decode_tokens_per_s"],
            "decode_step_ms_mean": health["decode_step_ms_mean"],
            "prefill_chunk_ms_mean": health["prefill_chunk_ms_mean"],
            "alone_equals_batched": True,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
        }
        emit(out)
        return out
    finally:
        server.stop()


# --- main --------------------------------------------------------------------


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a card")
    sys.path.insert(0, ROOT)
    try:
        from k8s_gpu_device_plugin_torch.models import generate
        from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
        from k8s_gpu_device_plugin_torch.ops import kernel_support
        from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
        from k8s_gpu_device_plugin_torch.serving import server as server_mod
    except ImportError as e:
        fail(f"the port package is not next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit({"phase": 1, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    rpa.load_kernel()
    emit({"phase": 1, "build_s": time.perf_counter() - t0})

    cases = phase_kernels(torch, rpa)
    cfg = LlamaConfig.llama3_8b()
    phase_model(torch, server_mod, generate, cfg)
    serving = phase_serving(torch, server_mod, kernel_support, cfg)

    head = next(c for c in cases
                if c["case"] == "decode" and c["dtype"] == "bfloat16")
    err_bf16 = max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16")
    err_f32 = max(c["max_abs_err"] for c in cases if c["dtype"] == "float32")
    emit({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "k8s_gpu_device_plugin_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py:142",
        "launches": serving["launches"],
        "max_abs_err": max(err_bf16, err_f32),
        "max_err_bf16": err_bf16,
        "max_err_f32": err_f32,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "headline_case": "decode bfloat16, B=8 S=2048 Hq=32 Hkv=8 hd=128",
        "cases": [{k: c[k] for k in ("case", "dtype", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")} for c in cases],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
