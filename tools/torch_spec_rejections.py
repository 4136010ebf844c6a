#!/usr/bin/env python3
"""Why a self-draft's greedy proposals are rejected, on one CUDA card.

A self-draft (the draft is the target, the same tensors) proposes with
T = 1 forwards and the target verifies with one T = gamma forward; in
exact arithmetic every proposal is accepted. This tool serves the six
requests of ``chip_smoke.py``'s phase 4 through an eager
``SpeculativeBatcher`` (Llama-3-8B widths, random weights from seed 0,
8 slots, gamma 4, synchronous) and records both forwards' logits at
every position of every round: for each (slot, position) up to the
first rejection, the largest |draft logit - verify logit| over the
vocabulary, the verify logits' gap between their two best tokens, and at
each rejection the verify's gap between its argmax and the draft's
token. One JSON line on stdout, after the card's name and power limit.

    python3 tools/torch_spec_rejections.py [--dtype bfloat16|float32]
        [--layers N] [--plainAttention]

``--plainAttention`` runs the round's forwards through the plain
attention instead of the kernel (the prefill still runs the kernel), to
tell the attention's rounding from the rest of the model's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (prompt length, max_new): chip_smoke.py's phase 4 requests
REQUESTS = [(17, 64), (200, 48), (256, 32), (700, 40), (1500, 56), (1900, 64)]
GAMMA = 4


def main() -> None:
    parser = argparse.ArgumentParser(prog="torch_spec_rejections")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--plainAttention", action="store_true")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_spec_rejections: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from k8s_gpu_device_plugin_torch.models import llama
    from k8s_gpu_device_plugin_torch.models import spec_batching as spec_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=args.layers,
                              dtype=getattr(torch, args.dtype))
    params = llama.init_params(cfg, seed=0, device="cuda")

    calls = []
    forward = spec_mod._forward_cached

    def recording(p, tokens, cache, length, c, **kw):
        logits = forward(p, tokens, cache, length, c,
                         plain_attention=args.plainAttention, **kw)
        calls.append((bool(kw.get("verify")), logits.float()))
        return logits

    spec_mod._forward_cached = recording
    cb = spec_mod.SpeculativeBatcher(
        params, cfg, params, cfg, n_slots=8, max_len=2048,
        chunked_prefill=256, gamma=GAMMA, decode_graph=False,
        pipeline_depth=0)
    rng = np.random.default_rng(1)  # chip_smoke.py's SEED + 1
    for plen, max_new in REQUESTS:
        cb.submit(rng.integers(0, cfg.vocab_size, plen).tolist(), max_new)
    maxdiff, top2, rejected_gaps = [], [], []
    while cb.pending or cb.prefilling or cb.running:
        calls.clear()
        live = cb._allowed.clone()
        cb.step()
        verify = [lg for v, lg in calls if v]
        if not verify:
            continue
        vl = verify[0]                                     # (B, gamma, V)
        dl = torch.stack([lg[:, -1] for v, lg in calls[-GAMMA - 1:-1]], 1)
        d_tok, v_tok = dl.argmax(-1), vl.argmax(-1)
        for s in live.nonzero()[:, 0].tolist():
            for j in range(GAMMA):
                maxdiff.append(float((dl[s, j] - vl[s, j]).abs().max()))
                best = vl[s, j].topk(2).values
                top2.append(float(best[0] - best[1]))
                if d_tok[s, j] != v_tok[s, j]:
                    rejected_gaps.append(float(
                        vl[s, j, v_tok[s, j]] - vl[s, j, d_tok[s, j]]))
                    break

    def quantiles(xs):
        xs = sorted(xs)
        return {"p10": xs[len(xs) // 10], "p50": xs[len(xs) // 2],
                "p90": xs[int(len(xs) * 0.9)], "max": xs[-1]}

    print(json.dumps({
        "dtype": args.dtype, "layers": args.layers,
        "plain_attention": args.plainAttention, "spec": cb.spec_stats(),
        "positions": len(maxdiff), "rejections": len(rejected_gaps),
        "logit_maxdiff_draft_vs_verify": quantiles(maxdiff),
        "verify_top2_gap": quantiles(top2),
        "rejection_gap_verify": quantiles(rejected_gaps)
        if rejected_gaps else None}), flush=True)


if __name__ == "__main__":
    main()
