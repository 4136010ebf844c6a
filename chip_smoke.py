#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check its kernels.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits non-zero without the final line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; the hand-written kernels are built from the sources in the
   checkout (one ``nvcc`` per source, four sources, started together),
   timed; then
   ``cuobjdump -sass`` counts the HGMMA (``wgmma``) instructions of every
   kernel symbol, and every instantiation of the four tensor-core kernels
   (``flash_fwd_tc_kernel``, ``flash_bwd_dkv_tc_kernel``,
   ``flash_bwd_dq_tc_kernel``, ``rpa_tc_kernel``) must have some. The
   device model's C++ enumerator (``native/gpuenum.cc``, g++) builds in
   the same pool.
   The device phase, on the quiet card: ``make_backend("native")``
   against torch's view of each card, matched by UUID (name, NVML's
   total memory against ``totalGlobalMem`` within 1 GiB, NUMA node, PCI
   id, generation ``h100`` and its source, ``Healthy``);
   ``new_chip_map(..., "none")`` advertising exactly the card as
   ``nvidia.com/gpu`` under its MIG mode as found (read before and after,
   never switched); the NVML usage reader under an 8 GiB tensor (used
   memory up by at least that) and K1 decode launches (the duty cycle
   above zero); ``DeviceMetrics`` rendering the card; an assessor that
   must not probe a busy card; ``run_idle_probe`` returning True, timed.
2. ``ragged_paged_attention``'s kernel against its plain version at the
   Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128, S 2048), each case
   in bf16 and f32, on every route (a dense cache; a paged pool read
   through a shuffled table, pages of 64 and of 16 rows; int8 codes and
   int4 codes packed two per byte, with f32 scales, on both layouts):
   decode over eight slots (also windowed and at hd 64, group 1, dense
   and int4), and prefill chunks as the batcher runs them (one slot):
   T 3, T 37, T 256 at bases 0, 256 and 1536, windowed and at hd 64,
   group 1, and whole bucketed prompts (``--chunkedPrefill 0``) of T 512
   and T 1024 at base 0; long-prompt scoring's chunk, T 512 at base
   3584 over a 4096-row batch-1 dense cache; speculative verify windows
   of T 2, 4, 8 and 16
   over eight slots (the last windows ending at rows 2046 and 2047) on
   every route in bf16 and dense in f32, each reporting its engine's
   plan (T 2 at group 4 is split, the wider ones take the chunk engine);
   and bf16 decode at Mistral-7B's window (W 4096,
   eight slots at bases 6000 ... 8191, S 8192), dense and paged (pages of
   64 and of 16), where the pages-of-16 case also runs the stale-entry
   check: entries below each slot's window floor pointed at the trap page
   filled with large finite garbage, and the entries of tiles below the
   floor's tile at a page of NaN, must leave o bit for bit as it was (NaN
   inside the floor's tile is reported: the batcher resets recycled
   entries to the trap page for that reason); and the batch-1 decode
   modes' shapes, bf16: beam search's decode at B 4 over its 544-row
   cache (every row at base 542) and rolling decode's one windowed
   prefill, T 4160 from base 0 at W 4096; and one tensor-parallel
   shard's heads of Llama-3-8B (``*_tpN_shard_*``: tp 2's Hq 16 / Hkv 4,
   tp 4's Hq 8 / Hkv 2), decode over eight slots, a T-256 chunk at base
   1536 and a T-4 verify, dense and paged 64, bf16 and int8 codes (f32 on
   tp 2's dense decode). Every bf16 case runs on the
   tensor cores (decode split over
   each slot's span, ``SPLIT_TILES`` kv tiles a block), f32 on the CUDA
   cores: each launch must be counted on its engine, and two launches on
   the same inputs must agree bit for bit. A tensor-core case is held to
   one ulp of the plain version that rounds where the engine does
   (``p_bf16=True``, split where a decode launch splits) and to the f32
   plain version within TOL; the others to the f32 plain version within
   TOL. On the dense and paged bf16 decode cases each slot launched alone
   must equal the slot among its neighbours bit for bit. Per case: max
   error, kernel / plain / library times (and, for bf16 decode and at
   T 256, the CUDA-core engine's time on the same inputs; for decode the
   splits per slot and the blocks an SM holds)
   (CUDA-graph replays timed with CUDA events; the library yardstick, which
   the port never calls, is ``scaled_dot_product_attention`` after a
   gather of the pool and a dequantization of the codes into a dense
   view) and the bound (bytes over 3.35 TB/s or operations over the peak
   of the query type, whichever is larger). A paged case must equal the
   dense route on the same rows bit for bit.
3. Llama-3-8B with random weights: a 512-token prefill (two chunks of
   256) and 8 greedy decode steps through the kernel path and through the
   plain path; last-position f32 logits compared. The same through a
   paged pool and through int8 and int4 pools: kernel path against plain
   path in f32 (the quantized kernels on the model's own codes), and the
   paged kernel path bit for bit against the dense one. Then the same
   weights quantized (``--weightQuant`` int8, int4): kernel path against
   plain path in f32, and their distance from the bf16 weights' logits.
4. First the decode step captured as a CUDA graph against the eager
   step (dense bf16, paged int8, and ``w4_int4_paged`` after phase 3's
   int4 weights): a batcher serves a greedy request with a bias row, a
   seeded and an unseeded sampled one; three times a copy of its state
   (the cache bytes included, a pool's trap page aside) and of its
   generator takes an eager ``decode_step`` while the batcher replays the
   graph, and tokens, logprobs and every state tensor must agree bit for
   bit, the replay moving the generator on; the seeded stream alone must
   equal itself among its neighbours. Then the server
   (``serving/server.py``) with ``--preset llama3_8b --slots 8 --maxLen
   2048 --chunkedPrefill 256`` (the pipelined loop, ``--pipelineDepth
   1``, the prefix cache on: the server's defaults) on 127.0.0.1: six
   concurrent ``/v1/generate`` requests (one streamed, one with
   logprobs), launch counts over exactly that run (every decode step a
   graph replay, counted as the launches its capture recorded), and one
   request replayed alone twice (the second a prefix-cache hit, with
   ``cached_tokens`` > 0), the same tokens each time. The same on
   ``--pipelineDepth 0`` (served first: its tokens are the ones the
   pipelined dense run and the unquantized pool must give) and on
   ``--chunkedPrefill 0`` (bucketed prefill: the 1500- and 1900-token
   prompts answer 422, the other four are served; TTFT beside the
   chunked run's). Then the same six requests on ``--kvLayout paged
   --kvPageSize 64 --kvPages 65``
   (64 allocatable pages against the 79 the six reserve together, so an
   admission must wait): the dense run's tokens, every launch on the paged
   route, the pool empty at the end once the prefix cache has released
   its entries; on ``--cacheQuant int8`` and ``int4``,
   paged and dense; on ``--weightQuant int8`` (bf16 dense cache); and on
   ``--weightQuant int4 --cacheQuant int4`` in the 65-page pool (these
   two at REQUESTS_HALF: half the tokens). Every
   launch (the model is bf16: chunks and decode steps) must be on the
   tensor cores. Then the prefix cache: eight requests sharing a
   1024-token system prompt (suffixes of 64-300 tokens, 64 out, streamed
   with logprobs), one alone and then seven at once, on
   ``--prefixCacheOff`` (paged, default pool; served first), on the paged
   pool and on the dense cache: the seven hits answer ``cached_tokens``
   1024 and the cache-off run's tokens and logprobs; a paged hit aliases
   16 pages and copies no row, a dense one copies 1024 rows (the
   promotion 2016); TTFT of the first request and p50 of the seven. The
   copy-on-write at batcher level: chunks of 32, pages of 64, a 40-token
   shared prefix, so the hit's 32-token boundary lies inside a page: one
   page copied, the cache-off streams, on a bf16 and an int8 pool. Then
   tensor-parallel serving (``tp_*``, ``phase_tp``, after ``cow_check``,
   the same weights, all 32 layers): the mesh names ``cuda:0`` once a
   shard. Under torch's default cuBLAS workspace ``tp_gemm_probe`` asks
   whether each column shard's product (wq, wk, w1, w3, the lm_head at
   M 1, 8, 32, 256, 512, tp 2 and 4, strided view and copy, with and
   without reduced-precision reductions) is the whole product's columns
   bit for bit, and tp 2 against tp 1 dense reports where the streams
   part (``tp_default_workspace``: a parting with every shard equal
   fails), with each side's f32 logit gap between the two tokens where
   a greedy stream parts and a 2048-row prefill's device ms. Then a
   child, ``python3 chip_smoke.py --tp-exact`` under
   ``CUBLAS_WORKSPACE_CONFIG=:0:0`` (its lines relayed, ``tp_exact``):
   every probed shard equal, and the reference's ``_scenario`` (8 slots
   x 2048, chunks of 256, the prefix cache evicting, greedy and seeded
   requests, a cancel) at tp 1, 2 and 4, dense and paged 64, with int8
   KV, int8 weights, a self-draft speculative batcher (gamma 4) and
   ``tp_allow_psum`` at tp 2: every stream tp 1's bit for bit in tokens
   and logprobs (psum's reported), the prefill's device ms, each shard's
   KV bytes the aggregate over tp and what it allocates, K1 tp x 32
   launches a decode step (x 5 a speculative round), all on the tensor
   cores, the decode step's device ms at tp 1, 2 and 4 (eight slots at
   about 512 rows). Then,
   the Llama-3-8B weights freed, Mistral-7B (W 4096) on ``--slots 2
   --maxLen 12288 --kvLayout paged --kvPageSize 64 --kvPages 180``: two
   greedy requests of 12,000 and 9,000 prompt tokens (256 out) that the
   pool could not reserve whole (192 pages of the 179), served with at
   most 164 pages in use and pages recycled, the host clock of a step
   while both decode, every launch on the paged route and the tensor
   cores, and the tokens of the dense twin (3 GiB of cache); the
   full-causal twin of the pool refuses the 12,000-token request at
   ``validate``. Then the rolling ring-cache decode on the same weights
   (``rolling_*``, ``phase_rolling``): ``rolling_generate`` on a
   4160-token prompt (past the window), 64 tokens, against the unbounded
   windowed ``generate``, each step's logits recorded on both paths: the
   first token equal (the same prefill), the ring holding W rows against
   the unbounded cache's P + 64 (both caches' bytes), K1 launched once a
   layer by the ring (the windowed chunk route at T 4160) against the
   unbounded run's prefill and decode steps; in bf16 the step where the
   streams part and the largest logit gap while they agree are reported
   (the ring's softmax is a plain one, K1's an online one); a 2-layer
   f32 copy at the same width must give the same 64 tokens.
   Then speculative decoding (the same 8B weights). ``spec_self``: the
   server with ``--draftPreset llama3_8b --gamma 4`` (a self-draft
   sharing the target's tensors) on phase 4's six requests, all asking
   for logprobs, dense and paged (default pools), ``--pipelineDepth`` 0
   and 1: the four runs equal bit for bit in tokens and logprobs, every
   round a replay of the captured round, K1's verify windows (one a layer
   a round, all on the chunk engine) and draft decodes (gamma a layer a
   round, all split) counted where the kernel launches, acceptance
   reported (held to a floor of 0.8: in bf16 the draft's T = 1 forwards
   and the T = 4 verify differ by rounding that flips near ties), the
   target's and the draft's bytes in ``reserved_bytes``; the greedy
   tokens the plain dense run's up to each stream's first divergence,
   judged by the plain f32 forward (f32 weights) of the common prefix:
   its gap between the two tokens is reported beside 0.1. Eager batcher
   reruns record the decode and verify forwards that picked the two
   tokens; they must give the streams, the gap must be at most their
   error at the two tokens, and the verify forward's RMS error over the
   vocabulary at most twice the decode forward's. ``spec_prefix``: the
   prefix runs' requests on the paged pools, cache off and on: the hits answer ``cached_tokens`` 1024,
   alias 16 pages, copy no row and backfill the draft (4 chunks each),
   with the cache-off streams. ``spec_sampled``: temperature 0.8, top-p
   0.95, acceptance at least 0.95. At batcher level: the round's and a
   plain step's device ms (eight slots at 1000 rows, replays back to
   back); ``spec_f32``: the target's first 8 layers in f32 as a
   self-draft (the CUDA cores), acceptance at least 0.95 and the f32
   plain batcher's tokens; ``spec_trunc``,
   the draft the target's first 8 layers with its embedding, norm and
   head, dense and paged: the first 16 replayed rounds held to the eager
   round bit for bit (both states, every tensor), paged equal to dense,
   the histogram of accepted counts; and batch-1
   ``speculative_generate`` (self-draft, 32 tokens) against
   ``generate``, up to a near tie, with its round count.
   Then scheduling and failure (the same 8B weights). ``preempt``, at
   batcher level (8 slots x 2048, chunks of 256, the prefix cache and
   the graph on): eight priority-2 requests of about 200 tokens (96
   out; request 1 seeded at temperature 0.8), and after 32 and 40 steps
   a priority-0 request with a 1 ms deadline: the ``slo`` scheduler
   evicts request 0, then request 1, dense and paged at depth 1 and 0
   (the four runs equal bit for bit); every budget delivered, every step
   a replay, the re-prefill counted as K1 chunk launches beyond the fifo
   run's; against the fifo run (no preemption) the streams never
   preempted are equal bit for bit, the seeded victim's tokens equal,
   the greedy victim's equal or first diverging at a near tie
   (``near_ties`` over eager reruns of the resume); the f32 twin (8
   layers widened, one preemption) gives equal tokens and logprobs
   within 1e-3. ``sup_*``, through the server with eight streamed
   requests: one injected mid-decode crash (dense) and three (paged) are
   recovered in place with no error frame (restarts and resumes
   counted in ``/v1/health``'s ``supervisor``; the new batcher's steps
   graph replays; ``memory_allocated`` after the prefix cache is drained
   within the graph pool's bytes of its value before the first crash;
   the no-fault tokens up to near ties; the seconds from each crash to
   the next token); injected pool pressure makes admissions wait and
   leaves the streams bit for bit; a second crash past ``--restartBudget
   1`` ends every stream with an ``engine_dead`` frame and health reads
   dead; a burst past ``--maxQueue 2`` answers 429 with Retry-After;
   ``resume_out`` continues two streams from token 10. ``arrivals``: 16
   requests (20% priority 0 with a 1500 ms deadline) at once on the fifo
   server, then as Poisson arrivals at 1.2x that rate under fifo and
   slo: TTFT p50/p99 per class, deadlines met, preemptions, re-prefill
   chunks per preemption (reported, not held to limits), and the same
   per class from the server's own timelines (``/debug/requests``: TTFT,
   queue wait, prefill, decode, p50 and p99). ``obs``: the six requests
   (REQUESTS_HALF: half the tokens) served dense and paged, at depth 1 and 0, each with attribution off,
   on (the default) and on with ``--tracing --traceSteps
   --slowRequestMs 1``: streams bit for bit across the three (tokens
   across all twelve), K1's launches exactly the run's steps and chunks,
   every timeline summing to its wall time within 5e-5 s, both
   ``/metrics`` formats well formed line by line (an exemplar in the
   OpenMetrics one), the live MFU and bandwidth shares of every busy
   window polled from ``/v1/health`` within (0, 100%], the host-clock
   decode step of each run, one request trace's span names and one
   ``/debug/slow`` entry. After the
   windowed Mistral-7B runs, ``window_relief``: a head waiting on pages
   (its first reservation reads injected pool pressure) evicts the
   decode whose eviction returns the most live pages, not the longest.
   Then the serving surface (``surface``, after ``arrivals``, the same
   8B weights): the server with ``--tokenizer byte --embeddings
   --scoring --scoringMaxLen 4096 --slots 8 --maxLen 2048``; a seeded
   n = 4 text completion whose choices equal the single requests at
   seed + i bit for bit (tokens/s beside the four singles in turn); a
   streamed chat (letters by a logit bias) stopping on a stop string cut
   from its greedy answer, trimmed; echo scoring of a 200-token prompt
   (K2 at B 1, S 256: 32 launches a call) and a 3000-token one (six
   chunks of 512 through the cached forward: 32 K1 launches a chunk)
   and an embedding, three calls each (the same answer each time),
   timed, and the scorer in process beside them; ``concurrent``: the
   echo and embedding requests again while eight streams decode, every
   answer equal to its solo run (streams bit for bit, scores and the
   embedding exactly). Then the served scores and embedding against the
   f32 model's plain forward (widened weights): the kernel path's RMS
   distance at most BF16_FACTOR times the bf16 plain path's; and an
   8-layer f32 twin's kernels (CUDA cores) against its plain attention
   within 1e-3. Then multi-LoRA on the same weights (``lora_*``, after
   ``surface``): 32 random adapters (``init_random_adapters``, rank 16
   on all seven targets, 83,886,080 bytes each) registered once on the
   host, each run's store a fork of that registry. ``lora_step``: the
   decode step with eight distinct adapters live against the same step
   with none (host clock, graph replay by CUDA events, kernels a step).
   ``lora_mix``: 24 requests of 64 tokens each (6 on the base model, the
   others' adapters drawn Zipf-like, s = 1) through the server with
   ``--adapterCacheMB 960`` (12 resident), at once and then as Poisson
   arrivals at 1.2x that rate: every budget delivered, both passes' streams
   equal, K1's launches exactly the passes' steps and chunks (all on the
   tensor cores), every decode step a replay, misses, uploads past the warm
   set, evictions and ``adapter_miss`` deferrals above zero, the engine's
   steps timed with an upload in flight or not; the first LORA_SOLO (5)
   distinct first requests (adapter or base) alone on the same server equal
   to their streams, bit for bit; a server without adapters on the same
   requests: its base streams equal, its decode step beside the adapters'.
   ``lora_dense``: four adapters in dense-N
   mode and gathered (K 8 and K 2, which defers on ``adapter_slots``) at
   depth 0 and 1, bit for bit. ``lora_oracle``: each of the four against
   a server of ``merge_lora`` weights (bf16: reported up to the first
   divergence, with both paths' logit gaps there) and a 4-layer f32
   twin at batcher level (tokens equal, logprobs within 1e-3).
   ``lora_compose``: adapters on the paged int8 pool (equal to the dense
   int8 cache bit for bit) and on ``--weightQuant int8``, reported
   against dense bf16. ``lora_surface``: an ``adapter.upload`` fault
   leaves the streams as they were; the OpenAI ``model`` field serves
   an adapter's stream; ``/v1/models``, unknown names (404, 400),
   ``/v1/health``'s ``adapters`` and the seven ``gpu_serving_adapter*``
   families; an over-quota request answers 429 ``adapter_quota`` and a
   queued one's cancel refunds the bucket; an adapter registered at run
   time serves its factors' stream, its unregistration refused while it
   is live and evicting its prefix root after. Then KV page export and
   install on the same weights (``kv_*``, after ``lora``): two pairs of
   servers A and B (``--slots 8 --maxLen 2048 --kvLayout paged
   --kvPageSize 64``, the default pool, ``--prefixCacheOff``; one pair at
   ``--pipelineDepth`` 1, one at 0) sharing the weights. ``kv_http``:
   prompts of 512, 1024 and 1536 tokens (greedy, seeded at temperature
   0.8, a repetition penalty of 1.3) on the depth-1 pair, whose B
   decodes three other streams throughout, and of 1900 (greedy) on the
   idle depth-0 pair, 32 tokens each: the uninterrupted run on B, the
   stream on A exported after 3 tokens through ``POST
   /v1/kv/export/{id}`` (a second export answers 404), resubmitted to B
   with ``resume_out``, ``resume_logprobs`` and ``kv_pages`` (the blob's
   bytes spliced in as they came): the spliced stream equals the
   uninterrupted one bit for bit, tokens and logprobs; on the idle pair
   the install makes no prefill chunk (K1's launches are 32 a decode
   step, all split, on the paged route and the tensor cores). The same
   without ``kv_pages`` (the re-prefill resume: ceil(folded / 256)
   chunks of 32 launches) is reported against the uninterrupted stream.
   Per hop: the blob's raw and wire bytes, the export's wall time, the
   request thread's decode, the first token of the install and of the
   re-prefill. ``kv_load``: the depth-1 B's engine steps timed with an
   install in them or not (p50). ``kv_graph``: each B's decode graph is
   the same object throughout and every step a replay; every pool is
   empty at the end. ``kv_quant_int8`` / ``kv_quant_int4``: two batchers on that
   pool, a seeded 1536-token stream exported after 3 tokens and
   installed on the other, the other's uninterrupted stream bit for
   bit (no prefill chunk), and a re-export of the installed stream
   equal to the blob's full pages byte for byte on every plane (the
   int4 wire one code a byte, twice the pool's code bytes). Then the
   fleet tier on the same weights (``fleet_*``, ``phase_fleet``): two
   servers r0 and r1 (``--slots 8 --maxLen 2048 --kvLayout paged
   --kvPageSize 64 --embeddings --replicaId rN``, the prefix cache on)
   behind the port's replica router (``serving/router.py``) on an event
   loop of its own. ``fleet_route`` (affinity): four streams sharing a
   512-token prefix (64-token tails, 32 tokens, greedy and seeded) land
   on one replica, the second to fourth with ``cached_tokens`` >= 512;
   they, a plain generate, a streamed completion and an embedding equal
   the same requests sent straight to the chosen replica bit for bit
   (tokens, logprobs, embedding values; OpenAI ids and timestamps
   aside); affinity hits and K1's launches per replica. ``fleet_drain``:
   the home drained under a stream, which finishes whole; new requests
   go to the other; undrain. ``fleet_disagg``: a second router with
   ``--roles "prefill=r0 decode=r1" --disaggMinPrompt 64``; a prompt of
   512 tokens, greedy, and one of 1024, seeded at 0.8: each stream equals the
   uninterrupted one on r1 bit for bit and r1 makes no prefill chunk
   (K1 on r1 only split decode steps); transfers by outcome, pages,
   transfer ms, TTFT beside the same prompts colocated (caches
   emptied). ``fleet_resume``: a greedy and a seeded stream of a
   1024-token prompt on r1, r1 killed after 8 relayed tokens (its
   sockets cut): both finish on r0 with 48 tokens, none twice, their
   continuation a direct ``resume_out`` of the same fold on r0 bit for
   bit (the first divergence from the uninterrupted run printed, not
   held: a re-prefill resume is not bit for bit in bf16); one budget
   charge, one ``stream_resume`` event a stream; then a disaggregated
   request whose decode replica is the dead r1 falls back to a
   re-prefill on r0, equal to a direct resume there, counted as a
   ``fallback`` and not charged. The fleet servers run ``--tracing``:
   before the kill ``fleet_trace`` streams one request through the
   router and fetches its stitched ``/fleet/debug/traces/{id}`` (a router
   track and the serving replica's, no orphan, no unreachable replica)
   and ``fleet_metrics`` scrapes ``/fleet/metrics`` classic and
   OpenMetrics (well formed, every ``gpu_serving_*`` series under its
   replica's label, ``gpu_fleet_replicas`` 2, the summed TTFT histogram
   the replicas' sum); after it a second traced stream's document names
   r1 unreachable and federation counts it in
   ``gpu_fleet_scrape_errors``. Then beam search
   on the same weights (``beam_*``, ``phase_beam``): beam 1 equal to
   ``generate``'s greedy tokens bit for bit, then beam 4 on a 512-token
   prompt, 32 tokens (K1's split decode at B 4, one prefill), every
   score within BEAM_BF16_TOL a token of its sequence's log-probability
   under the full-context forward (K2), the rows distinct and sorted;
   the same on a 2-layer f32 copy within BEAM_F32_TOL; wall time, K1
   and K2 launches, peak memory. Then, after
   the 8B weights are freed and before the windowed Mistral-7B runs,
   Mixture-of-Experts (``moe_*``, ``phase_moe``): ``moe_model``,
   Mixtral-8x7B at its full width and 2 of its 32 layers
   (``capacity_factor`` 8.0), through phase 3's prompt and steps: the
   f32 kernel path against the f32 plain path, the prefill's last
   logits against ``forward_with_aux`` (the capacity dispatch of
   ``moe_mlp``, K2 on the CUDA cores, one launch a layer), both within
   LOGITS_BOUND; int8 and int4 expert stacks held the same way
   (``phase_weights``); the router's top-k on the card against the
   CPU's on the same rows (differing selections and their margin,
   printed). ``moe_w8``: Mixtral-8x7B at all 32 layers with int8
   weights, drawn and quantized one layer at a time (the bf16 tree,
   93.4 GB, is never built): ``phase_graph``'s replay-against-eager
   check, then the server (``--preset mixtral_8x7b --weightQuant int8``)
   on REQUESTS_QUARTER at ``--pipelineDepth`` 0 and 1, K1's launches counted on
   the dense route, the streams equal; decode step, TTFT, resident
   weight bytes, graph pool bytes and the peak memory printed.
5. The flash-attention kernels (``flash_fwd``, ``flash_bwd_dkv``,
   ``flash_bwd_dq``) against their plain versions at the shapes phase 6
   gives them (B 2, S 2048, Hq 32, Hkv 8, hd 128, causal), a window-512
   case, an hd-64 group-1 case, and the serving surface's B 1 forwards
   at S 64, 256 and 1024 (the padded scoring and embedding buckets), and
   beam search's check, B 4 at S 576, each in bf16 (the tensor cores) and
   f32 (the CUDA cores; each launch counted on its engine, two launches
   of each kernel equal bit for bit): max errors of o, dq, dk, dv (bf16:
   against the plain versions that round p, and dS, where the kernels
   do, and against the f32 ones: kernel_support.bf16_o_mismatch and
   bf16_grad_mismatch; f32 within TOL and GRAD_TOL) and lse; kernel /
   plain times;
   ``scaled_dot_product_attention``'s forward, backward and forward +
   backward as a yardstick the port never calls; the bound (operations
   over the input type's peak or bytes over 3.35 TB/s). Then the fused
   training ops at phase 6's shapes (``phase_fused_kernels``): K5
   ``fused_adamw`` over the leaves of a 2-layer Llama-3-8B-width state in
   bf16 and in f32, three updates with clipping engaged, against its plain
   version fed the kernel's own clip scale (every element equal bit for
   bit, or within one bf16 ulp / FUSED_F32_RTOL in at most
   FUSED_UNEQUAL_SHARE of them), the norm within NORM_RTOL, two launches
   equal bit for bit; K6 ``ce_chunk_fwd`` and K7 ``ce_chunk_bwd`` over
   the 32 chunks of 4096 columns of Llama-3-8B's head at N 4096, D 4096
   (the last chunk 1280 wide), bf16: lse within LSE_TOL, target logits
   equal, dlogits within one bf16 ulp; the int8 product at M 4096, K
   4096, N 14336: the int32 result equal bit for bit to the float64
   product of the same codes. Times, bounds (bytes for K5-K7, operations
   at 1979 TOP/s for the int8 product) and yardsticks the port never
   calls: ``torch._fused_adamw_`` and the eager ``AdamW.update`` (K5),
   the unfused head and cross-entropy forward and backward with the
   memory each takes (K6, K7), the bf16 ``torch.mm`` (int8).
6. The trainer (``models/trainer.py``) on Llama-3-8B widths cut to 8
   layers, B 2, S 2048, 5 steps: step-1 loss near the random init's
   expected ln(vocab) + d * 0.02^2 / 2, finite loss
   and grad_norm, flash launches per layer and step counted over exactly
   that run (every launch on the tensor cores), no ``mha_reference``
   route, the losses equal bit for bit to a second run's; step ms,
   tokens/s, MFU, peak memory. Then one step of a 2-layer f32 copy at the
   same B and S
   through the kernels (on the CUDA cores) and through the plain
   attention: loss and grad_norm compared; and the gradients of a bf16
   copy of its weights through the kernels and through the plain
   attention: per leaf, the kernel path's distance to the f32 plain
   path's gradients at most BF16_FACTOR times the plain path's. Then the
   same run with ``--optImpl fused --fusedCE`` (``train_fused``: finite
   losses, step 1 within FUSED_STEP1_TOL of the unfused run's, the
   losses equal bit for bit to a second run's, K5, K6 and K7 launched
   steps x their launches a step, K2-K4 as in the unfused run, a peak
   below the unfused run's) and with ``--quant int8`` (``train_int8``:
   the final loss within INT8_LOSS_RTOL of bf16's, seven int8 products a
   layer and step, none re-run in the backward); every run prints its
   step ms, tokens/s, MFU, peak memory and the optimizer update's own
   device ms (CUDA events around ``optimizer.update``).
7. Checkpoints and LoRA training, Llama-3-8B widths cut to 2 layers
   (``models/checkpoint.py``, the trainer's and the server's
   ``--checkpointDir``, ``--loraAdapters``), in a directory beside this
   script that is deleted after the phase (its free space checked
   first): ``ckpt_resume`` (4 steps straight against 2 steps with a
   checkpoint every 2 and a stop, then a fresh trainer resumed to 4:
   ``resumed_from`` 2, steps 3-4's losses and the final params and
   moments equal bit for bit; save, write and restore ms and bytes on
   disk); ``ckpt_serve`` (``load_params`` equal to the trained params bit
   for bit; a ``--checkpointDir`` server's greedy stream equal to
   ``generate`` on them; K1 launches); ``lora_train`` (a rank-16 adapter
   on all seven targets, 6 steps on one batch at B 2, S 2048: the loss
   falls, the base stays bit for bit, K2-K4 launched per layer and step
   on the tensor cores and no ``mha_reference``; then one f32 step's
   factor gradients through the kernels on the CUDA cores against the
   plain attention); ``lora_ckpt_serve`` (the adapter saved and served
   by ``--loraAdapters``: the bf16 stream against the merged weights'
   reported, the f32 twin's equal to the merged oracle's).
8. The default ``--preset tiny`` (head dim 16) from the command line
   (``phase_tiny``): the trainer's CLI over a corpus with traces and a
   checkpoint, the server's CLI on that checkpoint (streams equal to
   ``generate``), and the f32 twin, card against CPU.
9. Gemma-2B (head dim 256, tied head) and Qwen2-7B (a GQA group of 7,
   q/k/v biases), ``phase_wide``: K1 at Gemma's heads on every route of
   NARROW_LAYOUTS and at Qwen2's dense and paged (decode, a T-256 chunk
   at base 1536, a T-4 verify; 8 slots, S 2048; Gemma's decode and chunk
   at W 64) and K2-K4 at both heads (B 2, S 2048; Gemma's also at W
   512), bf16 and f32, with phases 2 and 5's checks, times, bounds and
   SDPA times; then each preset at its published widths, bf16, random
   weights from SEED: Gemma's ``params_to_hf`` -> ``params_from_hf``
   round trip (every leaf back bit for bit, the tied head consumed);
   WIDE_REQUESTS through one-slot batchers, dense and paged (equal
   streams, K1 launched a layer per chunk and step), each prompt one
   chunk of its own length (each stream equal to ``generate``'s) and at
   chunks of WIDE_CHUNK (a stream parting from ``generate``'s judged by
   ``near_ties`` against the plain f32 forward); a 2-layer f32 copy's
   prefill and decode
   logits and full-forward logits, kernels against the plain path
   within LOGITS_BOUND; the gradient of the tied embedding (rows no
   input looks up get one) or of the biases (nonzero); training with
   FusedAdamW and the fused cross-entropy at B 1, S 2048 (Gemma all 18
   layers, 5 steps; Qwen2 a 2-layer cut, 3 steps), the losses bit for
   bit a second run's; Gemma's 2-layer f32 twin, card against CPU (the
   CPU's share beside the models' checks, after every timed case), the
   losses within WIDE_TWIN_RTOL.
10. One ``{"kernels": [...]}`` line (all four kernels; the ragged-paged
   kernel's entry carries its six routes, the decode graph's checks and
   pool bytes, the prefix and windowed runs' launches, the W 4096 cases
   with the stale-entry check, the copy-on-write check, the speculative
   runs' verify and split launches with phase 2's verify cases, the
   round's time and acceptance, the preemption runs' launches with
   the page-relief and arrival summaries, the surface run's launches
   with phase 2's T 512 scoring case, the lora runs', the KV transfer
   runs', the fleet runs' (by run, the paged route), the beam and
   rolling runs' with phase 2's cases at their shapes, and the moe runs';
   K2's entry counts the trainer's launches, the surface run's, the
   fleet's embeddings, the MoE forward check's and the beam check's, and
   lists its B 1 serving cases; K1 and K2-K4 add phase 7's, K2-K4 the
   fused runs'), then K5, K6, K7 and the int8 product (``replaces``
   null, each naming the reference module it is the counterpart of,
   with phase 6's launches; K1-K4 add phase 9's launches and cases).
11. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
SEED = 0

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # f32 outside the tensor cores
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),   # bf16 output rounding
       "float32": dict(atol=1e-4, rtol=0.0)}     # summation order only
LOGITS_BOUND = 1e-3   # phase 3: f32 model, kernel vs plain path, max abs
BF16_FACTOR = 1.5     # phase 3: bf16 kernel path's distance to the f32
                      # model, at most this times the plain path's

# The tensor-core engine (K1's bf16 chunks, K2 bf16) rounds its weights p
# to bf16 before P V, and K1's producer rounds dequantized K/V rows to
# bf16: each kernel is held to one ulp of the plain version that rounds
# them where the kernel does (``p_bf16=True``; a weight on a rounding
# boundary may flip, in a few rows: kernel_support.FLIP_ROWS),
# and to its f32 plain version within a wide bound: K1's TOL above, K2's
# one ulp plus 2^-8 max|v| (each weight moves by at most 2^-8 of itself,
# the weights sum to l; flash_attention.o_wide_tol). One check holds both:
# kernel_support.bf16_o_mismatch. Phase 5's f32 o is held to TOL. The
# tensor-core backward (K3, K4 bf16) rounds p and dS to bf16 before its
# gradient products: its f32 gradients are held to the plain versions
# that round them there (p_bf16=True) within the summation order of the
# same products and one flip of an element's largest term (in all but a
# few rows), and to the f32 plain versions within 2^-8 of each element's
# sum of |terms| plus GRAD_TOL's atol: kernel_support.bf16_grad_mismatch.
GRAD_TOL = dict(atol=1e-4, rtol=0.0)  # f32 grads/lse from the same inputs:
                                      # summation order only
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 5
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 1e-3   # phase 6: kernels vs plain, f32

# bytes of one cached token of Llama-3-8B (32 layers, 8 kv heads, hd 128,
# K and V) per cache type: bf16 rows, or codes plus one f32 scale a row
TOKEN_BYTES = {"none": 131072, "int8": 67584, "int4": 34816}

# (prompt length, max_new); index 3 streams, index 1 asks for logprobs
REQUESTS = [(17, 64), (200, 48), (256, 32), (700, 40), (1500, 56), (1900, 64)]
# phase_obs's and the weight-quantized runs' requests: every prompt, half
# the tokens; the moe_w8 runs': a quarter (cut when the tp phase took its
# time)
REQUESTS_HALF = [(plen, max_new // 2) for plen, max_new in REQUESTS]
REQUESTS_QUARTER = [(plen, max_new // 4) for plen, max_new in REQUESTS]
STREAMED, WITH_LOGPROBS = 3, 1


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (the command's time budget, part by part)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 1)}
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


def hgmma_counts(kernel_support, lib) -> dict[str, int]:
    """HGMMA instructions (wgmma in SASS) per kernel symbol of a built
    library, from ``cuobjdump -sass`` beside nvcc."""
    tool = os.path.join(os.path.dirname(kernel_support.find_nvcc()),
                        "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib._name} failed: {proc.stderr[-2000:]}")
    counts, symbol = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            symbol = line.split("Function :", 1)[1].strip()
            counts[symbol] = 0
        elif symbol is not None and "HGMMA" in line:
            counts[symbol] += 1
    return counts


# --- the device phase ----------------------------------------------------------

# the device phase: the usage reader's load (K1 decode at the main path's
# decode shape, launched for at least DEVICE_LOAD_S and at most
# DEVICE_LOAD_MAX_S, NVML read every DEVICE_READ_S), the tensor whose
# bytes NVML must see, and the margin NVML's total may exceed CUDA's
# totalGlobalMem by (the driver's own reservation: 480 MiB on an H100
# 80GB HBM3 under driver 580)
DEVICE_ALLOC_BYTES = 8 << 30
DEVICE_MEM_MARGIN = 1 << 30
DEVICE_LOAD_S, DEVICE_LOAD_MAX_S, DEVICE_READ_S = 1.5, 6.0, 0.1
DEVICE_LOAD_BURST = 64   # K1 launches between two synchronizations


def phase_device(torch, rpa, kernel_support) -> dict:
    """The device model on the quiet card: ``make_backend("native")``
    (the C++ enumerator built in phase 1, NVML, the CUDA driver's UUIDs
    where the host hides them) against torch's view of each card, matched
    by UUID; ``new_chip_map(..., "none")`` advertising exactly these cards
    as ``nvidia.com/gpu`` under the MIG mode as found (read before and
    after: nothing here switches it); the NVML usage reader under an
    8 GiB tensor and K1 decode launches; ``DeviceMetrics`` rendering the
    card; a health assessor that must not probe a busy card; and
    ``run_idle_probe`` (a child's CUDA start and one bf16 product),
    timed. One line a check; any failed check fails the run."""
    from k8s_gpu_device_plugin_torch.device import new_chip_map
    from k8s_gpu_device_plugin_torch.device.chip import HEALTHY
    from k8s_gpu_device_plugin_torch.device.factory import make_backend
    from k8s_gpu_device_plugin_torch.device.health import (
        HealthAssessor,
        run_idle_probe,
    )
    from k8s_gpu_device_plugin_torch.device.topology import GENERATIONS
    from k8s_gpu_device_plugin_torch.metrics.device_metrics import DeviceMetrics
    from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
    from k8s_gpu_device_plugin_torch.metrics.runtime_metrics import (
        NvmlUsageReader,
    )
    from k8s_gpu_device_plugin_torch.resource import discover_resources

    t_phase = time.perf_counter()
    out = {}
    backend = make_backend("native")
    nv = backend.nvml
    topo = backend.host_topology()
    gpus, specs = backend.gpus(), backend.enumerate_chips()
    health = backend.check_health()
    mig_before = [nv.mig_mode(nv.handle_by_index(g.nvml_index))
                  for g in gpus if g.nvml_index is not None]
    cards = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        uuid = f"GPU-{props.uuid}"
        mine = [s for s in specs if s.uuid == uuid]
        if len(mine) != 1:
            fail(f"device: CUDA device {i} ({uuid}) is not among the "
                 f"enumerated GPUs {[s.uuid for s in specs]}")
        spec, gpu = mine[0], gpus[mine[0].index]
        row = {"phase": "device", "check": "card", "cuda_index": i,
               "uuid": spec.uuid, "uuid_source": gpu.uuid_source,
               "path": spec.paths[0], "name": spec.name,
               "torch_name": props.name,
               "nvml_total_bytes": spec.hbm_bytes,
               "cuda_total_global_mem": props.total_memory,
               "total_memory_carries": "nvml_total",
               "numa_node": spec.numa_node,
               "pci_bus_id": spec.pci_bus_id or None,
               "pci_device_id": hex(spec.pci_device_id)
               if spec.pci_device_id else None,
               "generation": topo.generation.name,
               "generation_source": backend.generation_source,
               "health": HEALTHY if health.get(spec.index) else "Unhealthy",
               "mig_mode": nv.mig_mode(nv.handle_by_index(gpu.nvml_index))}
        emit(row)
        if spec.name != props.name:
            fail(f"device: NVML names the card {spec.name!r}, torch "
                 f"{props.name!r}")
        if not 0 <= spec.hbm_bytes - props.total_memory <= DEVICE_MEM_MARGIN:
            fail(f"device: NVML's total {spec.hbm_bytes} and totalGlobalMem "
                 f"{props.total_memory} differ by more than "
                 f"{DEVICE_MEM_MARGIN} B")
        if topo.generation.name != "h100":
            fail(f"device: generation {topo.generation.name}, want h100")
        # the PCI device id decides where the host shows one; where it
        # hides it (no PCI sysfs, NVML's PCI information Not Supported),
        # the driver's model name, and the source must say so
        want_source = "pci" if spec.pci_device_id else "name"
        if backend.generation_source != want_source or (
                spec.pci_device_id
                and spec.pci_device_id != GENERATIONS["h100"].pci_device_id):
            fail(f"device: generation source {backend.generation_source} "
                 f"with PCI id {row['pci_device_id']}, want {want_source}")
        if row["health"] != HEALTHY:
            fail(f"device: the card reads {row['health']}")
        cards.append(row)
    out["cards"] = cards

    # the MIG mode as found: whole cards under strategy none
    resources = discover_resources("none", topo)
    chip_map = new_chip_map(backend, resources, "none")
    want_ids = sorted(c["uuid"] for c in cards)
    advertised = {name: chips.ids() for name, chips in chip_map.items()}
    row = {"phase": "device", "check": "chip_map", "strategy": "none",
           "advertised": advertised, "mig_mode_as_found": mig_before}
    emit(row)
    if advertised != {"nvidia.com/gpu": want_ids}:
        fail(f"device: chip map {advertised}, want nvidia.com/gpu: {want_ids}")
    out["chip_map"] = row

    # the usage reader: 8 GiB seen, then K1 decode launches under reads
    index = next(s.index for s in specs if s.uuid == cards[0]["uuid"])
    reader = NvmlUsageReader(nvml=nv, indices=backend.nvml_indices())
    torch.cuda.synchronize()
    before = reader.read().get(index)
    used0 = before.hbm_used_bytes if before is not None else 0
    x = torch.empty(DEVICE_ALLOC_BYTES, dtype=torch.uint8, device="cuda")
    x.fill_(1)
    torch.cuda.synchronize()

    def usage():
        got = reader.read().get(index)
        if got is None:
            fail(f"device: the usage reader does not list GPU {index} while "
                 "this process holds it")
        return got

    used1 = usage().hbm_used_bytes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, s, hq, hkv, hd = 8, 2048, 32, 8, 128
    q = torch.randn((b, 1, hq, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    base = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    kernel_support.reset_launch_counts()
    duty, t0 = [], time.perf_counter()
    next_read = t0
    while True:
        for _ in range(DEVICE_LOAD_BURST):
            rpa.ragged_paged_attention(q, k, v, base, None, scale=hd ** -0.5)
        torch.cuda.synchronize()
        now = time.perf_counter()
        if now >= next_read:
            duty.append(usage().duty_cycle_percent)
            next_read = now + DEVICE_READ_S
        if now - t0 >= DEVICE_LOAD_MAX_S or (
                now - t0 >= DEVICE_LOAD_S and max(duty) > 0):
            break
    load_s = time.perf_counter() - t0
    k1 = kernel_support.launch_counts().get(rpa.NAME, 0)
    usages, status = reader.read_status()
    if index not in usages:
        fail(f"device: read_status() does not list GPU {index}")
    row = {"phase": "device", "check": "usage",
           "hbm_used_before": used0, "hbm_used_after_alloc": used1,
           "alloc_bytes": DEVICE_ALLOC_BYTES,
           "duty_cycle_reads": duty, "load_s": load_s, "k1_launches": k1,
           "status": status, "nvml_pids": list(usages[index].processes),
           "this_pid": os.getpid()}
    emit(row)
    if used1 - used0 < DEVICE_ALLOC_BYTES:
        fail(f"device: NVML's used memory rose by {used1 - used0} B under a "
             f"{DEVICE_ALLOC_BYTES}-byte tensor")
    if not max(duty) > 0:
        fail(f"device: duty cycle read {duty} under {k1} K1 launches")
    if status not in ("data", "silent"):
        fail(f"device: the reader reads {status!r} while this process "
             "holds the card")
    out["usage"] = row

    # the metrics, and an assessor that must not probe a busy card
    registry = Registry()
    metrics = DeviceMetrics(reader, registry=registry)
    metrics.update_inventory(chip_map)
    metrics.set_generation_source(topo.generation.name,
                                  backend.generation_source)
    metrics.update_usage()
    text = metrics.render()
    chip = str(index)
    samples = {
        "chips_healthy": registry.get_sample_value(
            "gpu_plugin_chips", {"resource": "nvidia.com/gpu",
                                 "state": "healthy"}),
        "hbm_total": registry.get_sample_value(
            "gpu_plugin_chip_hbm_total_bytes",
            {"chip": chip, "generation": topo.generation.name}),
        "hbm_used": registry.get_sample_value(
            "gpu_plugin_chip_hbm_used_bytes", {"chip": chip}),
        "duty_cycle": registry.get_sample_value(
            "gpu_plugin_chip_duty_cycle_percent", {"chip": chip}),
        "generation_guessed": registry.get_sample_value(
            "gpu_plugin_generation_guessed",
            {"generation": topo.generation.name,
             "source": backend.generation_source})}
    probed = []
    verdicts = HealthAssessor(reader=reader, probe=lambda: probed.append(1)
                              or False).assess(health)
    row = {"phase": "device", "check": "metrics", "samples": samples,
           "exposition_bytes": len(text), "assessor": verdicts,
           "assessor_probed": bool(probed)}
    emit(row)
    if samples["chips_healthy"] != len(cards) or samples["hbm_total"] != \
            cards[0]["nvml_total_bytes"] or not samples["hbm_used"] or \
            samples["hbm_used"] < DEVICE_ALLOC_BYTES or \
            samples["duty_cycle"] is None or samples["generation_guessed"] != 0:
        fail(f"device: the rendered samples {samples}")
    if probed or set(verdicts.values()) != {HEALTHY}:
        fail(f"device: the assessor on a busy card gave {verdicts} "
             f"(probed: {bool(probed)})")
    del x, q, k, v
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    probe_ok = run_idle_probe()
    probe_s = time.perf_counter() - t0
    mig_after = [nv.mig_mode(nv.handle_by_index(g.nvml_index))
                 for g in gpus if g.nvml_index is not None]
    row = {"phase": "device", "check": "probe", "ok": probe_ok,
           "probe_s": probe_s, "mig_mode_after": mig_after,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if not probe_ok:
        fail("device: run_idle_probe returned False")
    if mig_after != mig_before:
        fail(f"device: MIG mode {mig_before} became {mig_after}")
    out["probe"] = row
    backend.close()
    return out


# the tensor-core kernels: every instantiation must hold wgmma
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "rpa_tc_kernel")


def phase_sass(kernel_support, libs) -> None:
    """Phase 1's proof that the redesigned kernels run on the tensor
    cores: the HGMMA count of every kernel symbol; fails if an
    instantiation of a tensor-core kernel has none (or none exists)."""
    counts = {}
    for name, lib in libs.items():
        counts[name] = hgmma_counts(kernel_support, lib)
        emit({"phase": 1, "library": name, "hgmma_per_kernel": counts[name]})
    for kernel in TC_KERNELS:
        mine = {sym: n for per_lib in counts.values()
                for sym, n in per_lib.items() if kernel in sym}
        if not mine or not all(mine.values()):
            fail(f"{kernel}: no HGMMA in some instantiation: {mine}")


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


# every route of the kernel: (route, page size), pages of 64 and of 16
ROUTE_LAYOUTS = (("dense", 0), ("paged", 64), ("paged", 16),
                 ("int8_dense", 0), ("int8_paged", 64), ("int8_paged", 16),
                 ("int4_dense", 0), ("int4_paged", 64), ("int4_paged", 16))


def kernel_cases():
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    full = dict(hq=32, hkv=8, hd=128, s=2048)
    narrow = dict(hq=8, hkv=8, hd=64, s=2048)
    cases = [
        dict(name="decode", b=8, t=1, bases=bases8, window=0, **full),
        dict(name="decode_window64", b=8, t=1, bases=bases8, window=64,
             **full),
        dict(name="decode_hd64_group1", b=8, t=1, bases=bases8, window=0,
             **narrow),
    ]
    for case in cases:
        case.update(route="dense", ps=0)
    # the other routes at the serving shapes: decode
    for route, ps in ROUTE_LAYOUTS[1:]:
        tag = route + (f"_ps{ps}" if ps else "")
        cases.append(dict(name=f"decode_{tag}", b=8, t=1, bases=bases8,
                          window=0, route=route, ps=ps, **full))
    # int4's unpacking at the narrower shapes of the dense route's cases
    cases += [
        dict(name="decode_window64_int4_dense", b=8, t=1, bases=bases8,
             window=64, route="int4_dense", ps=0, **full),
        dict(name="decode_hd64_group1_int4_dense", b=8, t=1, bases=bases8,
             window=0, route="int4_dense", ps=0, **narrow),
    ]
    # prefill chunks as the batcher runs them (one slot), on every route:
    # T 3 (12 query vectors, just past the 8-vector decode tile) up to
    # T 256 at three depths, a window and hd 64 at group 1, and whole
    # bucketed prompts of 512 and 1024 rows
    chunks = [("prefill_t3_base100", 3, 100, 0, full),
              ("prefill_t37_base100", 37, 100, 0, full),
              ("prefill_t256_base0", 256, 0, 0, full),
              # a bucketed prefill (--chunkedPrefill 0): the whole padded
              # prompt from base 0, T up to the largest bucket
              ("prefill_t512_base0", 512, 0, 0, full),
              ("prefill_t1024_base0", 1024, 0, 0, full),
              ("prefill_t256_base256", 256, 256, 0, full),
              ("prefill_t256_base1536", 256, 1536, 0, full),
              ("prefill_t256_base1536_window64", 256, 1536, 64, full),
              ("prefill_t256_base1536_hd64_group1", 256, 1536, 0, narrow)]
    for route, ps in ROUTE_LAYOUTS:
        tag = "" if route == "dense" else "_" + route + (f"_ps{ps}" if ps else "")
        for name, t, base, window, shape in chunks:
            cases.append(dict(name=name + tag, b=1, t=t, bases=[base],
                              window=window, route=route, ps=ps, **shape))
    # long-prompt scoring (serving/scoring.py): a chunk of 512 at the last
    # base over the scorer's batch-1 dense cache of 4096 rows
    cases.append(dict(name="score_t512_base3584", b=1, t=512, bases=[3584],
                      window=0, route="dense", ps=0, hq=32, hkv=8, hd=128,
                      s=4096))
    # speculative verify windows (the target's forward over a round's
    # proposals) at Llama-3-8B's heads, eight slots, T 2 ... 16: every
    # route in bf16, dense in f32. The last two windows end at rows 2046
    # and 2047 (a round never writes past its slot: the gamma reservation)
    for t in VERIFY_TS:
        vbases = [-1, 0, 1, 255, 256, 1000, full["s"] - t - 1, full["s"] - t]
        for route, ps in ROUTE_LAYOUTS:
            tag = route + (f"_ps{ps}" if ps else "")
            cases.append(dict(
                name=f"verify_t{t}_{tag}", b=8, t=t, bases=vbases, window=0,
                route=route, ps=ps, verify=True,
                dtypes=("bfloat16", "float32") if route == "dense"
                else ("bfloat16",), **full))
    # windowed decode at Mistral-7B's attention shapes and its published
    # window (the window_paged run of phase 4), bf16: dense, and a pool
    # through a shuffled table with pages of 64 and of 16; the pages-of-16
    # case also runs the stale-entry check
    for route, ps in WINDOW_LAYOUTS:
        tag = route + (f"_ps{ps}" if ps else "")
        cases.append(dict(name=f"decode_w{MISTRAL_WINDOW}_{tag}", b=8, t=1,
                          bases=WINDOW_BASES, window=MISTRAL_WINDOW,
                          route=route, ps=ps, dtypes=("bfloat16",),
                          stale_check=ps == 16, hq=32, hkv=8, hd=128,
                          s=8192))
    # the batch-1 decode modes at Llama-3-8B's / Mistral-7B's heads, bf16:
    # beam search's last decode step (B = beam, every row at one base,
    # over the (prompt + max_new)-row cache), and rolling decode's one
    # prefill of the whole prompt, past the window
    cases += [
        dict(name=f"decode_beam{BEAM_WIDTH}", b=BEAM_WIDTH, t=1,
             bases=[BEAM_PROMPT + BEAM_NEW - 2] * BEAM_WIDTH, window=0,
             route="dense", ps=0, dtypes=("bfloat16",), hq=32, hkv=8,
             hd=128, s=BEAM_PROMPT + BEAM_NEW),
        dict(name=f"prefill_t{ROLLING_PROMPT}_w{MISTRAL_WINDOW}", b=1,
             t=ROLLING_PROMPT, bases=[0], window=MISTRAL_WINDOW,
             route="dense", ps=0, dtypes=("bfloat16",), hq=32, hkv=8,
             hd=128, s=ROLLING_PROMPT),
        # phase 7's one-slot servers of a restored checkpoint (2048-row
        # slot): the prompt's one chunk, and the last decode step
        dict(name=f"prefill_t{CKPT_PROMPT}_base0", b=1, t=CKPT_PROMPT,
             bases=[0], window=0, route="dense", ps=0, dtypes=("bfloat16",),
             **full),
        dict(name="decode_b1_ckpt", b=1, t=1,
             bases=[CKPT_PROMPT + CKPT_NEW - 2], window=0, route="dense",
             ps=0, dtypes=("bfloat16",), **full)]
    return cases + narrow_kernel_cases() + shard_kernel_cases()


# the tensor-parallel phase's shards of Llama-3-8B's heads: tp -> (Hq, Hkv)
TP_SHARD_HEADS = {2: dict(hq=16, hkv=4, hd=128), 4: dict(hq=8, hkv=2, hd=128)}
TP_SHARD_LAYOUTS = (("dense", 0), ("paged", 64), ("int8_dense", 0),
                    ("int8_paged", 64))
TP_CHUNK_BASE = 1536
TP_VERIFY_T = 4


def shard_kernel_cases():
    """K1 at one tensor-parallel shard's heads of Llama-3-8B (tp 2: Hq 16,
    Hkv 4; tp 4: Hq 8, Hkv 2; the group stays 4), 8 slots, S 2048: decode,
    a T-256 chunk at base 1536 and a T-4 verify window, dense and paged
    64, bf16 and int8 codes; f32 (the CUDA cores) on tp 2's dense
    decode."""
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    vbases = [-1, 0, 1, 255, 256, 1000, 2048 - TP_VERIFY_T - 1,
              2048 - TP_VERIFY_T]
    cases = []
    for tp, heads in TP_SHARD_HEADS.items():
        for route, ps in TP_SHARD_LAYOUTS:
            tag = route + (f"_ps{ps}" if ps else "")
            for kind, b, t, bases in (
                    ("decode", 8, 1, bases8),
                    (f"prefill_t256_base{TP_CHUNK_BASE}", 1, 256,
                     [TP_CHUNK_BASE]),
                    (f"verify_t{TP_VERIFY_T}", 8, TP_VERIFY_T, vbases)):
                f32 = tp == 2 and route == "dense" and kind == "decode"
                cases.append(dict(
                    name=f"{kind}_tp{tp}_shard_{tag}", b=b, t=t, bases=bases,
                    window=0, route=route, ps=ps,
                    verify=kind.startswith("verify"),
                    dtypes=("bfloat16", "float32") if f32 else ("bfloat16",),
                    s=2048, tp_shard=tp, **heads))
    return cases


# the head dims below the kernels' 64-column tiles (the tiny preset's 16),
# run zero-padded in the 64-column instantiation
NARROW_HDS = (16, 32)
NARROW_LAYOUTS = (("dense", 0), ("paged", 64), ("int8_dense", 0),
                  ("int8_paged", 64), ("int4_dense", 0), ("int4_paged", 64))
# eight slots of one T-256 chunk each, the last ending at row 2047
NARROW_CHUNK_BASES = [0, 100, 256, 700, 1000, 1500, 1536, 1792]
NARROW_VERIFY_T = 4


def narrow_kernel_cases():
    """K1 at hd 16 and 32 (8 slots, S 2048, Llama-3-8B's heads): decode, a
    T-256 chunk and a T-4 verify window on every route of NARROW_LAYOUTS,
    bf16 (f32 on the dense route too); and the tiny preset's own heads
    (Hq 8, Hkv 4, hd 16) at its server's decode and chunk."""
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    cases = []
    for hd in NARROW_HDS:
        shape = dict(hq=32, hkv=8, hd=hd, s=2048)
        vbases = [-1, 0, 1, 255, 256, 1000, 2048 - NARROW_VERIFY_T - 1,
                  2048 - NARROW_VERIFY_T]
        for route, ps in NARROW_LAYOUTS:
            tag = route + (f"_ps{ps}" if ps else "")
            dtypes = ("bfloat16", "float32") if route == "dense" \
                else ("bfloat16",)
            for kind, t, bases in (("decode", 1, bases8),
                                   ("prefill_t256", 256, NARROW_CHUNK_BASES),
                                   (f"verify_t{NARROW_VERIFY_T}",
                                    NARROW_VERIFY_T, vbases)):
                cases.append(dict(name=f"{kind}_hd{hd}_{tag}", b=8, t=t,
                                  bases=bases, window=0, route=route, ps=ps,
                                  verify=kind.startswith("verify"),
                                  dtypes=dtypes, **shape))
    tiny = dict(hq=8, hkv=4, hd=16, s=TINY_MAX_LEN, route="dense", ps=0,
                window=0)
    cases += [dict(name="decode_tiny", b=TINY_SLOTS, t=1, bases=bases8,
                   **tiny),
              dict(name="prefill_tiny", b=1, t=TINY_CHUNK, bases=[0], **tiny)]
    return cases


# the verify windows of phase 2: T = gamma of a speculative round
VERIFY_TS = (2, 4, 8, 16)

MISTRAL_WINDOW = 4096
WINDOW_LAYOUTS = (("dense", 0), ("paged", 64), ("paged", 16))
# eight slots between 6000 and 8191: every span is the whole window
WINDOW_BASES = [6000, 6301, 6655, 6999, 7300, 7727, 8000, 8191]
# the large finite garbage the stale-entry check writes into the trap page
GARBAGE = 3.0e4


def stale_entry_check(torch, rpa, q, k, v, base, pages, kw, clean,
                      ps: int, window: int) -> dict:
    """The batcher resets a recycled table entry to the trap page 0
    (``_recycle_slot_pages``). Decode at ``base`` attends rows from
    ``base - window + 1``; a page wholly below that floor is one the
    batcher would have recycled. Three variants of the clean launch:

    - ``trap_garbage``: every such entry points at page 0, and page 0
      holds large finite garbage: o must equal the clean o bit for bit
      (the kernel's floor tile reads up to three such entries, under its
      mask);
    - ``unfetched_nan``: the entries of pages in tiles below the floor's
      64-row tile point at a page of NaN: o must equal the clean o bit for
      bit (the kernel never fetches a tile below the floor's);
    - ``floor_tile_nan``: the same NaN page under the dead entries inside
      the floor's tile, where the mask multiplies it by 0: reported (NaN
      poisons o, which is why the batcher resets the entries)."""
    floor = base.long() - window + 1                 # first attended row
    dead = torch.clamp(floor // ps, min=0)           # pages wholly below
    unfetched = torch.clamp((floor // 64) * 64 // ps, min=0)
    nan_id = k.shape[0]
    cols = torch.arange(pages.shape[1], device=pages.device)[None, :]

    def run(table, kk, vv):
        return rpa.ragged_paged_attention(q, kk, vv, base, table, **kw)

    def with_page(fill):
        page = torch.full_like(k[:1], fill)
        return torch.cat([k, page]), torch.cat([v, torch.full_like(v[:1],
                                                                   fill)])

    kg, vg = k.clone(), v.clone()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    kg[0] = (torch.randn(kg[0].shape, generator=gen, device="cuda")
             * GARBAGE).to(kg.dtype)
    vg[0] = (torch.randn(vg[0].shape, generator=gen, device="cuda")
             * GARBAGE).to(vg.dtype)
    trap = torch.where(cols < dead[:, None], torch.zeros_like(pages), pages)
    o_trap = run(trap, kg, vg)
    kn, vn = with_page(float("nan"))
    below = torch.where(cols < unfetched[:, None],
                        torch.full_like(pages, nan_id), pages)
    o_unfetched = run(below, kn, vn)
    inside = torch.where((cols >= unfetched[:, None]) & (cols < dead[:, None]),
                         torch.full_like(pages, nan_id), pages)
    o_inside = run(inside, kn, vn)
    torch.cuda.synchronize()
    out = {"dead_entries": int(dead.sum()),
           "unfetched_entries": int(unfetched.sum()),
           "floor_tile_dead_entries": int((dead - unfetched).sum()),
           "trap_garbage_bitwise": bool(torch.equal(o_trap, clean)),
           "unfetched_nan_bitwise": bool(torch.equal(o_unfetched, clean)),
           "floor_tile_nan_poisons_o": bool(not torch.isfinite(o_inside).all())}
    if not (out["trap_garbage_bitwise"] and out["unfetched_nan_bitwise"]):
        fail(f"stale-entry check: {out}")
    return out


def chunk_headline(case) -> bool:
    """The prefill chunk each route's entry reports: T 256 at base 1536,
    no window, hd 128 (a phase-2 case or its result row)."""
    return (case["t"] == 256 and case["bases"] == [1536]
            and case["window"] == 0 and case["hd"] == 128)


def cache_quant_of(route: str) -> str:
    """The cache type a route name carries: 'none', 'int8' or 'int4'."""
    head = route.split("_")[0]
    return head if head in ("int8", "int4") else "none"


def bound(case, rpa, torch, dtype_name: str) -> tuple[float, str, dict]:
    """Least time for the work this case's data needs: every input byte
    read once (q, the K/V rows some query attends with their scale rows on
    an int8 or int4 cache, base, the table entries of those rows), the
    output written once; 4 * hd operations per (query, q head, attended
    row), at the query type's peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    code_bytes = {"int8": 1, "int4": 0.5}.get(cache_quant_of(case["route"]))
    quantized = code_bytes is not None
    base = torch.tensor(case["bases"], dtype=torch.int32)
    rows = rpa.attended_rows(base, case["t"], case["window"])   # (B, T)
    q_pos = torch.clamp(base[:, None].long() + torch.arange(case["t"]), min=0)
    kv_rows = table_entries = 0
    for b in range(case["b"]):
        lo = int((q_pos[b] - rows[b] + 1).min())
        hi = int(q_pos[b].max())
        kv_rows += hi - lo + 1
        if case["ps"]:
            table_entries += hi // case["ps"] - lo // case["ps"] + 1
    q_bytes = case["b"] * case["t"] * case["hq"] * case["hd"] * elem
    kv_bytes = 2 * kv_rows * case["hkv"] * case["hd"] * (code_bytes or elem)
    if quantized:
        kv_bytes += 2 * kv_rows * case["hkv"] * 4
    nbytes = int(2 * q_bytes + kv_bytes + 4 * case["b"] + 4 * table_entries)
    flops = 4 * case["hd"] * case["hq"] * int(rows.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "flops": flops}


def route_operands(torch, quant, case, k, v, gen):
    """The dense rows ``k``/``v`` (B, S, Hkv, hd) as the case's route
    takes them: (k, v, k_scale, v_scale, pages). int8 and int4 routes
    quantize the rows with the cache's own recipe (int4 codes packed two
    per byte); paged routes scatter them into a
    pool through a shuffled table that reserves, per slot, the pages its
    live rows need (the rest of its row is 0, the trap page, which holds
    finite garbage)."""
    ks = vs = pages = None
    codes = cache_quant_of(case["route"])
    if codes == "int8":
        k, ks = quant.quantize_int8(k, axis=-1)
        v, vs = quant.quantize_int8(v, axis=-1)
    elif codes == "int4":
        (k, ks), (v, vs) = (quant.quantize_int4_sym(x, axis=-1)
                            for x in (k, v))
        k, v = quant.pack_int4(k), quant.pack_int4(v)
    if case["ps"]:
        ps, b = case["ps"], case["b"]
        nsp = case["s"] // ps
        n_pages = 1 + b * nsp
        ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
               + 1).int()
        pages = torch.zeros((b, nsp), dtype=torch.int32, device="cuda")
        for i, base in enumerate(case["bases"]):
            n = max(1, -(-(base + case["t"]) // ps))
            pages[i, :n] = ids[i * nsp:i * nsp + n]

        def pool_of(rows, trap):
            pool = torch.empty((n_pages, ps, *rows.shape[2:]),
                               dtype=rows.dtype, device="cuda")
            pool[ids.long()] = rows.reshape(b * nsp, ps, *rows.shape[2:])
            pool[0] = trap
            return pool

        k, v = pool_of(k, k[0, :ps]), pool_of(v, v[0, :ps])
        if ks is not None:
            ks, vs = pool_of(ks, ks[0, :ps]), pool_of(vs, vs[0, :ps])
    return k, v, ks, vs, pages


def phase_kernels(torch, rpa, quant, kernel_support, cases=None,
                  phase: int = 2) -> list[dict]:
    """K1 against its plain version on ``cases`` (phase 2's
    ``kernel_cases()`` by default), one line a case under ``phase``."""
    import torch.nn.functional as F

    results = []
    for case in kernel_cases() if cases is None else cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            if dname not in case.get("dtypes", (dname,)):
                continue
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            b, t, hq, hkv, hd, s = (case[k] for k in
                                    ("b", "t", "hq", "hkv", "hd", "s"))
            q = torch.randn((b, t, hq, hd), generator=gen, device="cuda",
                            dtype=dtype)
            k0 = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            v0 = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            base = torch.tensor(case["bases"], dtype=torch.int32,
                                device="cuda")
            k, v, ks, vs, pages = route_operands(torch, quant, case, k0, v0,
                                                 gen)
            kw = dict(scale=hd ** -0.5, window=case["window"], k_scale=ks,
                      v_scale=vs)

            def kernel():
                return rpa.ragged_paged_attention(q, k, v, base, pages, **kw)

            def plain():
                return rpa.ragged_paged_attention_reference(q, k, v, base,
                                                            pages, **kw)

            engine = rpa.engine(dtype, t, hq // hkv)
            tc = engine == "tensor_cores"
            split = rpa.window_split(t, hq // hkv) if tc else None
            kernel_support.reset_launch_counts()
            got = kernel()
            counts = kernel_support.launch_counts()
            blocks_per_sm = rpa.load_kernel().rpa_blocks_per_sm() if tc \
                else None
            again = kernel()
            want = plain()
            torch.cuda.synchronize()
            label = f"{case['name']} {dname}"
            if counts.get(kernel_support.engine_key(rpa.NAME, engine)) != 1 \
                    or counts.get(rpa.SPLIT_KEY, 0) != int(split is not None):
                fail(f"{label}: the launch was not counted on the {engine} "
                     f"engine{' split' if split else ''}: {counts}")
            if not torch.isfinite(got).all():
                fail(f"{label}: non-finite kernel output")
            if not torch.equal(got, again):
                fail(f"{label}: two launches on the same inputs differ")
            err = float((got.float() - want.float()).abs().max())
            err_p = off_one_ulp = None
            if tc:  # the tolerances above: one ulp of what the engine does
                want_p = rpa.ragged_paged_attention_reference(
                    q, k, v, base, pages, p_bf16=True, split_tiles=split,
                    **kw)
                why = kernel_support.bf16_o_mismatch(got, want_p, want,
                                                     TOL[dname])
                if why is not None:
                    fail(f"{label}: {why}")
                err_p = float((got.float() - want_p.float()).abs().max())
                off_one_ulp = kernel_support.off_one_ulp(got, want_p)
                del want_p
            elif not torch.allclose(got.float(), want.float(), **TOL[dname]):
                fail(f"{label}: kernel disagrees with its plain version "
                     f"(max abs err {err:.3e}, {TOL[dname]})")
            if pages is not None:
                # the same rows through the dense route of the same cache
                # type: the layouts must agree bit for bit
                dense_case = dict(case, ps=0)
                dk, dv, dks, dvs, _ = route_operands(torch, quant, dense_case,
                                                     k0, v0, gen)
                dense = rpa.ragged_paged_attention(
                    q, dk, dv, base, scale=kw["scale"],
                    window=case["window"], k_scale=dks, v_scale=dvs)
                if not torch.equal(got, dense):
                    fail(f"{label}: the paged route differs from the dense "
                         "route on the same rows (max abs "
                         f"{float((got.float() - dense.float()).abs().max()):.3e})")
                del dk, dv, dks, dvs, dense
            neighbours = None
            if split and case["route"] in ("dense", "paged"):
                neighbours = alone_equals_batched(torch, rpa, q, k, v, base,
                                                  pages, kw)
                if not all(neighbours):
                    fail(f"{label}: slots {neighbours} launched alone differ "
                         "from the same slots among their neighbours")

            # the library yardstick: a gather of the pool and a
            # dequantization into a dense view of q's type where the route
            # needs them, then SDPA over the whole cache with the same
            # boolean mask (it reads every row, not just the live span)
            q_pos = torch.clamp(base[:, None].long()
                                + torch.arange(t, device="cuda"), min=0)
            k_pos = torch.arange(s, device="cuda")
            mask = k_pos[None, None, :] <= q_pos[:, :, None]
            if case["window"]:
                mask &= q_pos[:, :, None] - k_pos[None, None, :] < case["window"]
            mask = mask[:, None]                       # (B, 1, T, S)
            qs = q.transpose(1, 2).contiguous()
            table = None if pages is None else pages.long()

            def dense_view(x, scale):
                if table is not None:
                    x = x[table].reshape(b, s, hkv, x.shape[-1])
                    scale = None if scale is None else \
                        scale[table].reshape(b, s, hkv, 1)
                if x.dtype == torch.uint8:
                    x = quant.unpack_int4(x)
                if scale is not None:
                    x = (x.float() * scale).to(dtype)
                return x.transpose(1, 2)

            if case["route"] == "dense":  # nothing to gather or widen
                ks_, vs_ = (x.transpose(1, 2).contiguous() for x in (k, v))

            def library():
                kk, vv = ((ks_, vs_) if case["route"] == "dense" else
                          (dense_view(k, ks), dense_view(v, vs)))
                return F.scaled_dot_product_attention(
                    qs, kk, vv, attn_mask=mask, scale=kw["scale"],
                    enable_gqa=hq != hkv,
                )

            reps = 20 if t == 1 else 5
            row = {
                "case": case["name"], "route": case["route"],
                "page_size": case["ps"], "dtype": dname, "engine": engine,
                "verify": case.get("verify", False),
                # the tensor cores' plan: split spans or one block a span
                "plan": None if not tc else ("split" if split else "chunk"),
                "b": b, "t": t,
                "hq": hq, "hkv": hkv, "hd": hd, "s": s,
                "bases": case["bases"], "window": case["window"],
                "max_abs_err": err, "max_abs_err_vs_p_bf16": err_p,
                "off_one_ulp_elements_rows": off_one_ulp,
                "paged_equals_dense_bitwise": pages is not None or None,
                "alone_equals_batched": neighbours,
                "split_tiles": split,
                "splits_per_slot": None if split is None else [
                    len(x) for x in rpa.split_plan(case["bases"], t,
                                                   case["window"], s, split)],
                "blocks_per_sm": blocks_per_sm,
                "ms": graph_ms(torch, kernel, reps),
                "plain_ms": graph_ms(torch, plain, max(1, reps // 4)),
                "library_ms": graph_ms(torch, library, reps),
            }
            if tc and (split or chunk_headline(case)):
                # the other engine on the same inputs: a yardstick
                row["cuda_cores_ms"] = graph_ms(
                    torch, lambda: rpa.ragged_paged_attention(
                        q, k, v, base, pages, engine_override="cuda_cores",
                        **kw), reps)
            if case.get("stale_check"):
                row["stale_entries"] = stale_entry_check(
                    torch, rpa, q, k, v, base, pages, kw, got, case["ps"],
                    case["window"])
            row["bound_ms"], row["bound_by"], work = bound(case, rpa, torch,
                                                           dname)
            row.update(work)
            emit({"phase": phase, **row})
            results.append(row)
    return results


def alone_equals_batched(torch, rpa, q, k, v, base, pages, kw) -> list[bool]:
    """For each slot, whether its output launched alone (its own q, base
    and cache rows or table row) equals its output among the batch's
    slots, bit for bit."""
    both = rpa.ragged_paged_attention(q, k, v, base, pages, **kw)
    out = []
    for i in range(q.shape[0]):
        def one(x):
            return x[i:i + 1].contiguous()
        if pages is None:
            alone = rpa.ragged_paged_attention(
                one(q), one(k), one(v), one(base), **kw)
        else:
            alone = rpa.ragged_paged_attention(one(q), k, v, one(base),
                                               one(pages), **kw)
        out.append(bool(torch.equal(alone, both[i:i + 1])))
    return out


# --- phase 3 -----------------------------------------------------------------


MODEL_ROWS = 576     # phase 3 cache: 512 + 8 rows, whole pages of 64
MODEL_TABLE = [7, 3, 9, 1, 5, 2, 8, 4, 6]   # nine shuffled pages of a pool


def _model_logits(torch, generate, params, cfg, prompt, tokens, plain):
    """Last-position f32 logits of a 512-token prefill (two 256-token
    chunks) and of 8 decode steps fed ``tokens`` (filled in greedily by
    the first run, followed by the others): (9, V), and the cache they
    left. ``cfg`` names the layout and the cache type."""
    pages = None
    if cfg.kv_layout == "paged":
        cache = generate.KVCache.init_paged(cfg, len(MODEL_TABLE) + 1,
                                            cfg.kv_page_size, "cuda")
        pages = torch.tensor([MODEL_TABLE], dtype=torch.int32, device="cuda")
    else:
        cache = generate.KVCache.init(cfg, 1, MODEL_ROWS, "cuda")
    kw = dict(pages=pages, plain_attention=plain)
    for start in (0, 256):
        last = generate._forward_cached(
            params, prompt[:, start:start + 256], cache, start, cfg,
            last_only=True, **kw,
        )[:, -1]
    logits = [last]
    for i in range(8):
        if len(tokens) == i:
            tokens.append(int(logits[-1].argmax()))
        pos = torch.tensor([512 + i], dtype=torch.int32, device="cuda")
        tok = torch.tensor([[tokens[i]]], device="cuda")
        logits.append(generate._forward_cached(params, tok, cache, pos, cfg,
                                               **kw)[:, -1])
    out = torch.cat(logits).float()
    if not torch.isfinite(out).all():
        fail("model-level logits are not finite")
    return out, cache


def widened(torch, params):
    """The params with every float leaf in f32; quantized leaves (codes
    and f32 scales) as they are."""
    def leaf(x):
        if isinstance(x, dict):
            if set(x) in ({"q", "s"}, {"q4", "s"}):
                return x
            return {k: leaf(v) for k, v in x.items()}
        return x.float()

    return leaf(params)


def checked_attention_patch(torch, generate, record: dict):
    """A stand-in for ``generate._cached_attention`` that runs the kernel
    path and, on the very same operands (the pool as this layer finds
    it), the plain version; the outputs must agree within the f32 kernel
    tolerance. ``record`` collects the worst difference and the calls."""
    orig = generate._cached_attention

    def checked(q, k_cache, v_cache, k_scale, v_scale, base, c, pages=None,
                verify=False, plain=False):
        out = orig(q, k_cache, v_cache, k_scale, v_scale, base, c,
                   pages=pages, verify=verify, plain=False)
        want = orig(q, k_cache, v_cache, k_scale, v_scale, base, c,
                    pages=pages, verify=verify, plain=True)
        diff = float((out - want).abs().max())
        if not torch.allclose(out, want, **TOL["float32"]):
            fail(f"{c.cache_quant} attention on the model's own codes: "
                 f"kernel and plain version differ by {diff:.3e}")
        record["max"] = max(record["max"], diff)
        record["calls"] += 1
        return out

    return orig, checked


def phase_model(torch, generate, cfg, params) -> dict:
    """The bf16 model through the kernel path and the plain path, and the
    same weights widened to f32 through both paths. In f32 the two paths
    differ only in summation order, so they must agree within
    LOGITS_BOUND; in bf16 each path also rounds differently (the plain
    version rounds probabilities to bf16 before the V product, the kernel
    keeps them in f32), so the bf16 check is that the kernel path lies no
    further from the f32 model than the plain path does.

    Then the same model on a paged pool (pages of 64 rows, a shuffled
    table) and on int8 and int4 pools. Unquantized, in f32, the paged
    kernel path against the paged plain path within LOGITS_BOUND. The
    paged kernel path bit for bit against the dense one, for bf16, f32,
    int8 and int4 caches.

    A quantized cache cannot be held to a logits bound across two paths:
    each path quantizes the rows it computed itself, a last-bit
    difference moves a value on a rounding boundary to another code, that
    code moves the next layer's rows by a whole quantization step, and 32
    layers of quantizers carry the difference on (for int8 the codes that
    differ and the logits' distance are printed, not bounded). So each
    quantized kernel is held on identical codes instead: during the f32
    int8 and int4 kernel-path runs every cached-attention call also runs
    the plain version on the very same operands, and the two attention
    outputs must agree within the f32 kernel tolerance. A quantized
    cache's distance to the unquantized cache's logits is printed, not
    bounded. Returns the summary line with the bf16 kernel path's logits
    and greedy tokens, which the weight-quant checks compare against."""
    import numpy as np

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, params)
    rng = np.random.default_rng(SEED)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                          device="cuda")
    tokens: list[int] = []  # the bf16 kernel path picks; the others follow

    def variant(c, layout, quant):
        return dataclasses.replace(c, kv_layout=layout, cache_quant=quant,
                                   kv_page_size=64)

    checks = {q: {"max": 0.0, "calls": 0} for q in ("int8", "int4")}
    runs, caches = {}, {}
    for name, c, p, layout, quant, plain in (
            ("bf16_kernel", cfg, params, "dense", "none", False),
            ("bf16_plain", cfg, params, "dense", "none", True),
            ("f32_kernel", cfg32, params32, "dense", "none", False),
            ("f32_plain", cfg32, params32, "dense", "none", True),
            ("bf16_paged_kernel", cfg, params, "paged", "none", False),
            ("f32_paged_kernel", cfg32, params32, "paged", "none", False),
            ("f32_paged_plain", cfg32, params32, "paged", "none", True),
            ("bf16_int8_dense_kernel", cfg, params, "dense", "int8", False),
            ("bf16_int8_paged_kernel", cfg, params, "paged", "int8", False),
            ("f32_int8_paged_kernel", cfg32, params32, "paged", "int8", False),
            ("f32_int8_paged_plain", cfg32, params32, "paged", "int8", True),
            ("bf16_int4_dense_kernel", cfg, params, "dense", "int4", False),
            ("bf16_int4_paged_kernel", cfg, params, "paged", "int4", False),
            ("f32_int4_paged_kernel", cfg32, params32, "paged", "int4",
             False)):
        orig = generate._cached_attention
        if name in ("f32_int8_paged_kernel", "f32_int4_paged_kernel"):
            _, generate._cached_attention = checked_attention_patch(
                torch, generate, checks[quant])
        try:
            runs[name], cache = _model_logits(
                torch, generate, p, variant(c, layout, quant), prompt, tokens,
                plain)
        finally:
            generate._cached_attention = orig
        if name.startswith("f32_int8"):
            caches[name] = cache
    torch.cuda.synchronize()
    codes = caches["f32_int8_paged_kernel"].k.numel() * 2
    codes_differ = sum(
        int((getattr(caches["f32_int8_paged_kernel"], leaf)
             != getattr(caches["f32_int8_paged_plain"], leaf)).sum())
        for leaf in ("k", "v"))
    del params32, caches
    torch.cuda.empty_cache()

    def err(a, b):
        return float((runs[a] - runs[b]).abs().max())

    def agree(a, b):
        return "%d/9" % int((runs[a].argmax(-1) == runs[b].argmax(-1)).sum())

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
        "greedy_agreement_bf16_kernel_vs_plain": agree("bf16_kernel",
                                                       "bf16_plain"),
        "greedy_agreement_bf16_kernel_vs_f32": agree("bf16_kernel",
                                                     "f32_plain"),
        "f32_paged_kernel_vs_plain": err("f32_paged_kernel",
                                         "f32_paged_plain"),
        "f32_int8_paged_kernel_vs_plain_own_codes": err(
            "f32_int8_paged_kernel", "f32_int8_paged_plain"),
        "f32_int8_codes_differing_kernel_vs_plain": f"{codes_differ}/{codes}",
    }
    for quant, check in checks.items():
        out[f"f32_{quant}_attention_kernel_vs_plain_same_codes"] = check["max"]
        out[f"f32_{quant}_attention_calls_checked"] = check["calls"]
        out[f"bf16_{quant}_vs_bf16_cache"] = err(f"bf16_{quant}_paged_kernel",
                                                 "bf16_kernel")
        out[f"f32_{quant}_vs_f32_cache"] = err(f"f32_{quant}_paged_kernel",
                                               "f32_kernel")
        out[f"greedy_agreement_bf16_{quant}_vs_bf16_cache"] = agree(
            f"bf16_{quant}_paged_kernel", "bf16_kernel")
    bitwise = {"bf16_paged_equals_dense": ("bf16_paged_kernel", "bf16_kernel"),
               "f32_paged_equals_dense": ("f32_paged_kernel", "f32_kernel"),
               "int8_paged_equals_int8_dense": ("bf16_int8_paged_kernel",
                                                "bf16_int8_dense_kernel"),
               "int4_paged_equals_int4_dense": ("bf16_int4_paged_kernel",
                                                "bf16_int4_dense_kernel")}
    for key, (a, b) in bitwise.items():
        out[key] = bool(torch.equal(runs[a], runs[b]))
    emit(out)
    for quant, check in checks.items():
        if check["calls"] != cfg.n_layers * 10:
            fail(f"the {quant} attention check saw {check['calls']} calls, "
                 f"not {cfg.n_layers} layers x (2 chunks + 8 steps)")
    for key in ("f32_kernel_vs_plain", "f32_paged_kernel_vs_plain"):
        if out[key] > LOGITS_BOUND:
            fail(f"{key}: f32 kernel-path logits differ from the plain "
                 f"path by {out[key]:.3e} > {LOGITS_BOUND}")
    for key, (a, b) in bitwise.items():
        if not out[key]:
            fail(f"{key}: the paged kernel path's logits differ from the "
                 f"dense kernel path's by {err(a, b):.3e}, not bit-identical")
    if out["bf16_kernel_vs_f32"] > BF16_FACTOR * out["bf16_plain_vs_f32"]:
        fail(f"bf16 kernel path is {out['bf16_kernel_vs_f32']:.3e} from the "
             f"f32 model, more than {BF16_FACTOR}x the plain path's "
             f"{out['bf16_plain_vs_f32']:.3e}")
    return {**out, "bf16_logits": runs["bf16_kernel"], "prompt": prompt,
            "tokens": tokens}


def phase_weights(torch, generate, cfg, qparams, weight_quant: str,
                  model: dict, label: str = "llama3_8b") -> dict:
    """The 8B model on weight-only quantized params (``--weightQuant``):
    the f32 kernel path against the f32 plain path on the same quantized
    weights (codes and scales as they are, the float leaves widened),
    within LOGITS_BOUND; and the bf16 kernel path's distance from the bf16
    weights' logits, with its greedy agreement, printed (the same prompt
    and the tokens the bf16 weights picked)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, qparams)
    prompt, tokens = model["prompt"], list(model["tokens"])
    runs = {}
    for name, c, p, plain in (("bf16_kernel", cfg, qparams, False),
                              ("f32_kernel", cfg32, params32, False),
                              ("f32_plain", cfg32, params32, True)):
        runs[name], _ = _model_logits(torch, generate, p, c, prompt, tokens,
                                      plain)
    del params32
    torch.cuda.empty_cache()
    ref = model["bf16_logits"]
    out = {
        "phase": 3, "model": label, "weight_quant": weight_quant,
        "f32_kernel_vs_plain": float(
            (runs["f32_kernel"] - runs["f32_plain"]).abs().max()),
        "bound": LOGITS_BOUND,
        "bf16_vs_bf16_weights": float((runs["bf16_kernel"] - ref).abs().max()),
        "greedy_agreement_vs_bf16_weights": "%d/9" % int(
            (runs["bf16_kernel"].argmax(-1) == ref.argmax(-1)).sum()),
    }
    emit(out)
    if out["f32_kernel_vs_plain"] > LOGITS_BOUND:
        fail(f"{label} --weightQuant {weight_quant}: f32 kernel-path logits "
             "differ "
             f"from the plain path by {out['f32_kernel_vs_plain']:.3e} > "
             f"{LOGITS_BOUND}")
    return out


# --- phase 4 -----------------------------------------------------------------


def _post(url: str, body: dict, data: "bytes | None" = None) -> dict:
    """One /v1/generate: {"tokens", "logprobs" (None unless asked),
    "ttft" (seconds to the first token frame for a stream, else to the
    response), "cached_tokens" (the body's, or the stream's done event's:
    absent there means 0), "token_times" (a stream's frame arrivals on
    the ``time.perf_counter`` clock, else None)}. ``data`` is the body
    already encoded (``body`` then only says whether it streams)."""
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps(body).encode() if data is None else data,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        if not body.get("stream"):
            payload = json.loads(resp.read())
            return {"tokens": payload["tokens"],
                    "logprobs": payload.get("logprobs"),
                    "ttft": time.perf_counter() - t0,
                    "cached_tokens": payload["cached_tokens"],
                    "token_times": None}
        toks, lps, times = [], [], []
        done = None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if evt.get("done"):
                done = evt
                break
            if "error" in evt:
                fail(f"stream error frame: {evt['error']}")
            times.append(time.perf_counter())
            toks.append(evt["token"])
            if "logprob" in evt:
                lps.append(evt["logprob"])
        if done is None:
            fail("stream ended without its done frame")
        return {"tokens": toks, "logprobs": lps if lps else None,
                "ttft": times[0] - t0 if times else None,
                "cached_tokens": done.get("cached_tokens", 0),
                "token_times": times}


def start_server(server_mod, argv: list, params, adapters=None):
    """A server on 127.0.0.1 (an ephemeral port) for ``argv``'s flags,
    serving ``params`` (and ``adapters``: an AdapterSet or AdapterStore);
    returns (parsed args, server, url)."""
    args = server_mod.build_parser().parse_args([
        *argv, "--host", "127.0.0.1", "--port", "0", "--seed", str(SEED)])
    server = server_mod.build_server(args, params=params, adapters=adapters)
    server.start()
    return args, server, f"http://127.0.0.1:{server.bound_port}"


def post_all(url: str, bodies: list, run: str, refused=()) -> list[dict]:
    """The bodies at once, one thread each; every one must be served, but
    for the indices in ``refused``, which must answer 422 (their result
    has no tokens)."""
    import urllib.error

    results: list = [None] * len(bodies)
    errors: list = []

    def worker(i):
        try:
            results[i] = _post(url, bodies[i])
            if i in refused:
                errors.append(f"request {i} was served, not refused")
        except urllib.error.HTTPError as e:
            if i in refused and e.code == 422:
                results[i] = {"tokens": [], "logprobs": None, "ttft": None,
                              "cached_tokens": 0, "token_times": None}
            else:
                errors.append(f"request {i}: HTTP {e.code}: "
                              f"{e.read()[:200]!r}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if errors or any(r is None for r in results):
        fail(f"{run}: requests failed: {errors}")
    return results


def route_launches(run: str, kernel_support, rpa, route: str, n_layers: int,
                   decode_steps: int, chunks: int) -> dict:
    """K1's launches since the last reset: one a layer for every decode
    step and prefill chunk, all on ``route`` and on the tensor cores (the
    bf16 models)."""
    counts = kernel_support.launch_counts()
    launches = counts.get(rpa.route_key(route), 0)
    need = n_layers * (decode_steps + chunks)
    engines = {e: counts.get(kernel_support.engine_key(rpa.NAME, e), 0)
               for e in kernel_support.ENGINES}
    if (launches != need or counts.get(rpa.NAME, 0) != launches
            or engines != {"cuda_cores": 0, "tensor_cores": need}):
        fail(f"{run}: the kernel launched {launches} times on the {route} "
             f"route, per engine {engines} ({counts}); the run needs {need} "
             f"= {n_layers} layers x ({decode_steps} decode steps + "
             f"{chunks} prefill chunks), all on that route and on the "
             "tensor cores")
    return {"launches": launches, "launches_per_engine": engines,
            "launches_needed": need}


def equal_streams(run: str, got: list, want: list, logprobs: bool) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g["tokens"] != w["tokens"]:
            first = next((j for j, (x, y) in enumerate(
                zip(g["tokens"], w["tokens"])) if x != y), None)
            fail(f"{run}: request {i}'s stream differs at token {first}")
        if logprobs and g["logprobs"] != w["logprobs"]:
            fail(f"{run}: request {i}'s logprobs differ")


# the serving runs: name -> the flags it adds to the base command line.
# Each of the kernel's routes has the run of its name; the two last runs
# serve weight-only quantized params.
POOL_65 = ["--kvLayout", "paged", "--kvPageSize", "64", "--kvPages", "65"]
SERVING_RUNS = {
    "dense": [],
    # the dense run at the synchronous loop, and with bucketed prefill
    "dense_depth0": ["--pipelineDepth", "0"],
    "dense_bucketed": ["--chunkedPrefill", "0"],
    "paged": POOL_65,
    "int8_paged": [*POOL_65, "--cacheQuant", "int8"],
    "int8_dense": ["--cacheQuant", "int8"],
    "int4_dense": ["--cacheQuant", "int4"],
    "int4_paged": [*POOL_65, "--cacheQuant", "int4"],
    "w8": ["--weightQuant", "int8"],
    "w4_int4_paged": ["--weightQuant", "int4", "--cacheQuant", "int4",
                      *POOL_65],
    # Mixtral-8x7B at full depth, int8 weights (phase_moe)
    "moe_w8": ["--weightQuant", "int8"],
    "moe_w8_depth0": ["--weightQuant", "int8", "--pipelineDepth", "0"],
}


# with --chunkedPrefill 0 a prompt past the largest bucket (1024) is
# refused with a 422, as the reference refuses it
BUCKET_REFUSED = {i for i, (plen, _) in enumerate(REQUESTS) if plen > 1024}


def phase_serving(torch, server_mod, kernel_support, rpa, cfg, params,
                  run: str, dense_tokens=None,
                  preset: str = "llama3_8b", requests=REQUESTS) -> dict:
    """The server for one serving run: the six ``requests`` (REQUESTS) at
    once, every launch of exactly that run counted by route, all on the
    route its flags name, every decode step a replay of the captured
    graph. ``dense_tokens`` (the dense run's streams) must come back token
    for token from an unquantized pool and from the synchronous loop. A
    paged run must make at least one admission wait (the pool holds 64
    pages, the six reserve 79) and leave the pool empty and consistent.
    The bucketed run must refuse the prompts past the largest bucket with
    a 422 and serve the others. ``params`` are already quantized as the
    run's ``--weightQuant`` says; ``preset`` is the model they are for."""
    import numpy as np

    args, server, url = start_server(
        server_mod, ["--preset", preset, "--slots", "8", "--maxLen",
                     "2048", "--chunkedPrefill", "256", *SERVING_RUNS[run]],
        params)
    route = rpa.route_name(args.kvLayout == "paged", args.cacheQuant)
    try:
        rng = np.random.default_rng(SEED + 1)
        bodies = []
        for i, (plen, max_new) in enumerate(requests):
            body = {"prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
                    "max_new": max_new}
            if i == STREAMED:
                body["stream"] = True
            if i == WITH_LOGPROBS:
                body["logprobs"] = True
            bodies.append(body)
        refused = BUCKET_REFUSED if args.chunkedPrefill == 0 else set()
        cb = server.engine.cb
        if cb.graph is None or cb.pipeline_depth != args.pipelineDepth:
            fail(f"{run}: the batcher on the card must capture its decode "
                 f"step (graph {cb.graph}, depth {cb.pipeline_depth})")
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        replays0 = cb.graph.replays
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        results = post_all(url, bodies, run, refused=refused)
        wall = time.perf_counter() - t0
        health = server.engine.stats()
        decode_steps = health["decode_steps"] - steps0
        chunks = health["prefill_chunks"] - chunks0
        if cb.graph.replays - replays0 != decode_steps:
            fail(f"{run}: {decode_steps} decode steps but "
                 f"{cb.graph.replays - replays0} graph replays")
        for i, (res, (plen, max_new)) in enumerate(zip(results, requests)):
            toks, lps = res["tokens"], res["logprobs"]
            if i in refused:
                continue
            if len(toks) != max_new:
                fail(f"{run}: request {i} (prompt {plen}) returned "
                     f"{len(toks)} tokens, wanted {max_new}")
            if i == WITH_LOGPROBS and (lps is None or len(lps) != max_new
                                       or not all(x <= 0 for x in lps)):
                fail(f"{run}: request {i}: bad logprobs {lps}")
        launched = route_launches(run, kernel_support, rpa, route,
                                  cfg.n_layers, decode_steps, chunks)
        tokens = [r["tokens"] for r in results]
        if dense_tokens is not None and tokens != dense_tokens:
            bad = next(i for i, (x, y) in enumerate(zip(tokens, dense_tokens))
                       if x != y)
            fail(f"{run}: request {bad}'s greedy stream differs from the "
                 "dense run's")
        served = [i for i in range(len(requests)) if i not in refused]
        kv = health["kv"]
        want_bytes = (65 * 64 if "paged" in route else 8 * 2048) * \
            TOKEN_BYTES[args.cacheQuant]
        if kv["reserved_bytes"] != want_bytes:
            fail(f"{run}: reserved_bytes {kv['reserved_bytes']}, wanted "
                 f"{want_bytes}")
        if health["weights"]["quant"] != args.weightQuant:
            fail(f"{run}: serving {health['weights']} weights, wanted "
                 f"{args.weightQuant}")
        if cb.prefix_cache is None and args.chunkedPrefill:
            fail(f"{run}: the server's prefix cache is off by default")
        if "paged" in route:
            if kv["admission_rejected"]["pool_pressure"] < 1:
                fail(f"{run}: no admission waited for pages: {kv}")
            cb.pool.check()
            # what stays allocated is what the prefix cache's entries pin
            drain_prefix_cache(server)
            if cb.pool.in_use != 0:
                fail(f"{run}: pages still in use after the run and the "
                     f"prefix cache's release: {cb.kv_stats()}")
            cb.pool.check()
        alone_cached = None
        if run == "dense":
            # the streamed request again, alone, twice: its greedy stream
            # must not depend on the batch it was served in, and the
            # second time it hits the prefix cache (the first may have
            # been evicted by the longer prompts' promotions)
            alone_cached = []
            for _ in range(2):
                alone = _post(url, {"prompt": bodies[STREAMED]["prompt"],
                                    "max_new": requests[STREAMED][1]})
                alone_cached.append(alone["cached_tokens"])
                batched = results[STREAMED]["tokens"]
                if alone["tokens"] != batched:
                    first = next(i for i, (x, y) in enumerate(
                        zip(alone["tokens"], batched)) if x != y)
                    fail(f"greedy stream served alone differs from the "
                         f"batched one at token {first} (cached_tokens "
                         f"{alone['cached_tokens']})")
            if alone_cached[-1] <= 0:
                fail(f"the request replayed alone missed the prefix cache: "
                     f"{alone_cached}")
        out = {
            "phase": 4, "run": run, "preset": preset, "route": route,
            "flags": SERVING_RUNS[run],
            "requests": len(bodies), "served": len(served),
            "refused_422": sorted(refused), "wall_s": wall,
            "pipeline_depth": args.pipelineDepth,
            "chunked_prefill": args.chunkedPrefill,
            "decode_graph": health["decode"]["graph"],
            "pipeline_flushes": health["decode"]["pipeline_flushes"],
            **launched, "decode_steps": decode_steps,
            "prefill_chunks": chunks,
            "ttft_s_p50": health["ttft_s_p50"],
            "stream_ttft_s": results[STREAMED]["ttft"],
            "decode_tokens_per_s": health["decode_tokens_per_s"],
            "decode_step_ms_mean": health["decode_step_ms_mean"],
            "prefill_chunk_ms_mean": health["prefill_chunk_ms_mean"],
            "kv": kv, "weights": health["weights"],
            "equals_dense_tokens": dense_tokens is not None or None,
            "alone_equals_batched": run == "dense" or None,
            "alone_cached_tokens": alone_cached,
            "prefix_cache": health.get("prefix_cache"),
            "prefill_tokens": health["prefill_tokens"],
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "tokens": tokens,
        }
        emit({k: v for k, v in out.items() if k != "tokens"})
        return out
    finally:
        server.stop()


def drain_prefix_cache(server) -> int:
    """Evict every entry of a server's prefix cache through its release
    hook (the pool-pressure valve's own call), so that a paged pool can
    be checked empty; returns the entries evicted."""
    pc = server.engine.cb.prefix_cache
    n = 0
    while pc is not None and pc.evict_one():
        n += 1
    return n


# the graph check's requests: (prompt length, max_new, sampler knobs, seed,
# logit bias); the greedy row carries the one bias row (a ban of the
# unbiased first token and a push on another)
GRAPH_REQUESTS = [
    (300, 64, {}, None, "ban"),
    (450, 64, {"temperature": 1.0, "top_k": 50}, 7, None),
    (200, 64, {"temperature": 0.8, "top_p": 0.9}, None, None),
]
GRAPH_STEPS = 3  # replays checked against the eager step, one after another


def _state_tensors(state) -> dict:
    """Every tensor of a BatchState (the cache's planes included)."""
    out = {name: getattr(state, name) for name in
           ("lengths", "last_token", "active", "presence", "budget", "seeds",
            "draws", "pages") if getattr(state, name) is not None}
    for name in ("k", "v", "k_scale", "v_scale"):
        x = getattr(state.cache, name)
        if x is not None:
            out["cache." + name] = x
    return out


def phase_graph(torch, batching, sampling, cfg, params, run: str,
                flags: list) -> dict:
    """The captured decode step against the eager one, on the card. One
    batcher (8 slots, 2048 rows, the run's layout and cache type) serves
    a greedy request with a bias row, a seeded and an unseeded sampled
    request until all three decode; then, GRAPH_STEPS times, a copy of
    the state (every tensor, the cache bytes included) and of the shared
    generator's state takes one eager ``decode_step`` while the batcher
    replays its graph: tokens, logprobs and every state tensor must agree
    bit for bit, and the replay must move the shared generator on (fresh
    unseeded noise each step). Then the seeded request alone in a fresh
    batcher must give the stream it gave among its neighbours."""
    import numpy as np

    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
              kv_layout="paged" if "paged" in run else "dense",
              kv_page_size=64, kv_pages=65 if "paged" in run else 0)
    if kw["kv_layout"] == "dense":
        kw.pop("kv_page_size"), kw.pop("kv_pages")
    rcfg = dataclasses.replace(
        cfg, cache_quant=flags[flags.index("--cacheQuant") + 1]
        if "--cacheQuant" in flags else "none")
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n, *_ in GRAPH_REQUESTS]

    def serve(cb, which):
        rids = {}
        for i in which:
            _, max_new, knobs, seed, bias = GRAPH_REQUESTS[i]
            rids[i] = cb.submit(
                prompts[i], max_new,
                sampler=sampling.Sampler(**knobs) if knobs else None,
                seed=seed, logit_bias={int(ban): -100.0, 5: 4.0}
                if bias else None)
        return rids

    t0 = time.perf_counter()
    probe = batching.ContinuousBatcher(params, rcfg, decode_graph=False,
                                       **kw)
    rid = probe.submit(prompts[0], 1)
    ban = probe.run()[rid][0]
    del probe
    cb = batching.ContinuousBatcher(params, rcfg, **kw)
    if cb.graph is None:
        fail(f"graph {run}: the batcher captured no decode graph")
    rids = serve(cb, range(len(GRAPH_REQUESTS)))
    while cb.pending or cb.prefilling or len(cb.running) < 3:
        cb.step()
    for _ in range(4):
        cb.step()
    # the check drives the graph itself: nothing may be in flight
    inflight, cb._inflight = cb._inflight, None
    n_read = cb._read_step(inflight)
    checked = []
    for _ in range(GRAPH_STEPS):
        cb._refresh_slot_inputs()
        twin = dataclasses.replace(
            cb.state, cache=dataclasses.replace(cb.state.cache))
        for name, x in _state_tensors(cb.state).items():
            obj, attr = (twin.cache, name[6:]) if name.startswith("cache.") \
                else (twin, name)
            setattr(obj, attr, x.clone())
        gen = torch.Generator(device="cuda")
        gen.set_state(cb.generator.get_state())
        before = cb.generator.get_state()
        e_tok, e_logp = batching.decode_step(
            cb.params, twin, cb._allowed, cb._eos, cb.cfg, cb._knobs, gen,
            bias=cb._bias, seeds=twin.seeds)
        g_tok, g_logp = (x.clone() for x in cb.graph.replay())
        torch.cuda.synchronize()
        moved = not torch.equal(before, cb.generator.get_state())
        same = {"tokens": bool(torch.equal(e_tok, g_tok)),
                "logprobs": bool(torch.equal(e_logp, g_logp))}
        for name, x in _state_tensors(cb.state).items():
            y = getattr(twin.cache, name[6:]) if name.startswith("cache.") \
                else getattr(twin, name)
            if name.startswith("cache.") and kw["kv_layout"] == "paged":
                # the inactive slots' writes all land in the trap page
                # 0, which row of them stays is not defined, and nothing
                # reads it unmasked: the pool's other pages must agree
                x, y = x[:, 1:], y[:, 1:]
            same[name] = bool(torch.equal(x, y))
        bad = [k for k, v in same.items() if not v]
        if bad or not moved:
            fail(f"graph {run}: a replay differs from the eager step in "
                 f"{bad} (generator moved: {moved})")
        checked.append(g_tok.tolist())
        n_read += cb._apply_emitted(g_tok.tolist(), g_logp.tolist())
        del twin
    done = cb.run()
    seeded = done[rids[1]]
    alone_cb = batching.ContinuousBatcher(params, rcfg, **kw)
    alone_rids = serve(alone_cb, [1])
    alone = alone_cb.run()[alone_rids[1]]
    if alone != seeded:
        fail(f"graph {run}: the seeded stream alone differs from the same "
             "stream among its neighbours")
    if done[rids[0]][0] == ban:
        fail(f"graph {run}: the banned token {ban} came out first")
    out = {"phase": 4, "graph_check": run, "flags": flags,
           "steps_checked": GRAPH_STEPS, "tokens_checked": checked,
           "equal_bitwise": True, "state_tensors": len(same),
           "seeded_alone_equals_batched": True,
           "pool_bytes": cb.graph.pool_bytes,
           "launches_per_replay": cb.graph.launches,
           "s": time.perf_counter() - t0}
    emit(out)
    del cb, alone_cb
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the prefix runs: Llama-3-8B, 8 slots, chunks of 256; one system prompt
# of 1024 tokens shared by eight requests, each with its own suffix
PREFIX_SYSTEM, PREFIX_SUFFIX, PREFIX_MAX_NEW, PREFIX_N = 1024, (64, 300), 64, 8
PREFIX_POOL = ["--kvLayout", "paged", "--kvPageSize", "64"]  # default pool
PREFIX_RUNS = {"prefix_off": [*PREFIX_POOL, "--prefixCacheOff"],
               "prefix_paged": PREFIX_POOL, "prefix_dense": []}


def phase_prefix(torch, server_mod, kernel_support, rpa, batching, cfg,
                 params) -> dict:
    """The automatic prefix cache through the server. One request alone
    (cold: it promotes the system prompt's boundaries 32 ... 1024), then
    the seven others at once, every one streamed with logprobs. The
    cache-off run (on the paged pool) is served first; the paged and the
    dense runs with the cache on must give its tokens and logprobs, the
    seven hits ``cached_tokens`` 1024, a paged hit no copied row (its 16
    pages aliased), a dense hit 1024 copied rows; the pool empty once
    the cache lets go."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    system = rng.integers(0, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    bodies = [{"prompt": system + rng.integers(0, cfg.vocab_size,
                                               int(n)).tolist(),
               "max_new": PREFIX_MAX_NEW, "stream": True, "logprobs": True}
              for n in rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1,
                                    PREFIX_N)]
    boundaries = sum(b for b in (32, 64, 128, 256, 512, 1024)
                     if b <= PREFIX_SYSTEM)
    out = {}
    for run, flags in PREFIX_RUNS.items():
        args, server, url = start_server(
            server_mod, ["--preset", "llama3_8b", "--slots", "8", "--maxLen",
                         "2048", "--chunkedPrefill", "256", *flags], params)
        try:
            cb = server.engine.cb
            on = cb.prefix_cache is not None
            if on == (run == "prefix_off"):
                fail(f"{run}: prefix cache {'on' if on else 'off'}")
            route = rpa.route_name(cb.pool is not None, "none")
            batching.reset_kv_copy_counts()
            kernel_support.reset_launch_counts()
            steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
            replays0 = cb.graph.replays
            t0 = time.perf_counter()
            results = post_all(url, bodies[:1], run)
            chunks_first = cb.prefill_chunks - chunks0
            results += post_all(url, bodies[1:], run)
            wall = time.perf_counter() - t0
            health = server.engine.stats()
            copies = batching.kv_copy_counts()
            decode_steps = cb.decode_steps - steps0
            chunks = cb.prefill_chunks - chunks0
            if cb.graph.replays - replays0 != decode_steps:
                fail(f"{run}: {decode_steps} decode steps but "
                     f"{cb.graph.replays - replays0} graph replays")
            launched = route_launches(run, kernel_support, rpa, route,
                                      cfg.n_layers, decode_steps, chunks)
            cached = [r["cached_tokens"] for r in results]
            want_cached = [0] + [PREFIX_SYSTEM * on] * (PREFIX_N - 1)
            if cached != want_cached:
                fail(f"{run}: cached_tokens {cached}, wanted {want_cached}")
            if any(len(r["tokens"]) != PREFIX_MAX_NEW
                   or len(r["logprobs"] or ()) != PREFIX_MAX_NEW
                   for r in results):
                fail(f"{run}: a request came back short")
            if run != "prefix_off":
                equal_streams(run, results, out["prefix_off"]["results"],
                              logprobs=True)
            kv = health["kv"]
            if run == "prefix_paged":
                want = {"rows": 0, "cow_pages": 0}
                if copies != want or kv["pages_aliased"] != \
                        (PREFIX_N - 1) * PREFIX_SYSTEM // 64:
                    fail(f"{run}: copies {copies}, pages aliased "
                         f"{kv['pages_aliased']}: a paged hit aliases the "
                         "prefix's 16 pages and copies nothing")
            elif run == "prefix_dense":
                want = boundaries + (PREFIX_N - 1) * PREFIX_SYSTEM
                if copies != {"rows": want, "cow_pages": 0}:
                    fail(f"{run}: copies {copies}, wanted {want} rows (the "
                         "promotion's and one 1024-row insert a hit)")
            if cb.pool is not None:
                drain_prefix_cache(server)
                if cb.pool.in_use != 0:
                    fail(f"{run}: pages still in use once the prefix cache "
                         f"let go: {cb.kv_stats()}")
                cb.pool.check()
            hits_ttft = sorted(r["ttft"] for r in results[1:])
            row = {"phase": 4, "run": run, "route": route, "flags": flags,
                   "requests": PREFIX_N, "system_tokens": PREFIX_SYSTEM,
                   "prompt_tokens": [len(b["prompt"]) for b in bodies],
                   "cached_tokens": cached, "kv_copy_counts": copies,
                   "pages_aliased": kv.get("pages_aliased"),
                   "prefill_chunks_first": chunks_first,
                   "prefill_chunks_rest": chunks - chunks_first,
                   "prefill_tokens": health["prefill_tokens"],
                   "prefix_cache": health.get("prefix_cache"),
                   "ttft_first_s": results[0]["ttft"],
                   "ttft_rest_s_p50": hits_ttft[len(hits_ttft) // 2],
                   "decode_steps": decode_steps, "prefill_chunks": chunks,
                   **launched, "wall_s": wall,
                   "decode_step_ms_mean": health["decode_step_ms_mean"],
                   "equals_cache_off": run != "prefix_off" or None}
            emit(row)
            out[run] = {**row, "results": results}
        finally:
            server.stop()
        gc.collect()
        torch.cuda.empty_cache()
    return out


COW_PREFIX, COW_SUFFIX, COW_MAX_NEW = 40, 30, 16


def phase_cow(torch, batching, prefix_cache_mod, cfg, params) -> dict:
    """Copy-on-write at batcher level: chunks of 32, pages of 64, two
    requests sharing a 40-token prefix, one after the other. The second
    matches the 32-token boundary, inside the first page: its table
    aliases nothing and copies that one page. Streams (tokens and
    logprobs) must equal a cache-off batcher's, on a bf16 and an int8
    pool."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    shared = rng.integers(0, cfg.vocab_size, COW_PREFIX).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, COW_SUFFIX).tolist()
               for _ in range(2)]
    out = {}
    for quant in ("none", "int8"):
        rcfg = dataclasses.replace(cfg, cache_quant=quant)
        streams = {}
        for on in (False, True):
            pc = prefix_cache_mod.PrefixCache(
                rcfg, buckets=(32, 64, 128, 256), budget_bytes=64 << 20) \
                if on else None
            batching.reset_kv_copy_counts()
            cb = batching.ContinuousBatcher(
                params, rcfg, n_slots=2, max_len=256, chunked_prefill=32,
                kv_layout="paged", kv_page_size=64, prefix_cache=pc)
            got = []
            for p in prompts:
                rid = cb.submit(p, COW_MAX_NEW)
                cb.run()
                r = cb.done_requests[rid]
                got.append({"tokens": r.out, "logprobs": r.out_logp,
                            "cached_tokens": r.cached_tokens})
            copies = batching.kv_copy_counts()
            while pc is not None and pc.evict_one():
                pass
            cb.pool.check()
            if cb.pool.in_use:
                fail(f"cow {quant}: {cb.pool.in_use} pages left in use")
            streams[on] = (got, copies, cb.pages_aliased)
            del cb
            gc.collect()
            torch.cuda.empty_cache()
        (off, _, _), (hit, copies, aliased) = streams[False], streams[True]
        equal_streams(f"cow {quant}", hit, off, logprobs=True)
        if copies != {"rows": 0, "cow_pages": 1} or aliased != 0 or \
                [g["cached_tokens"] for g in hit] != [0, 32]:
            fail(f"cow {quant}: copies {copies}, pages aliased {aliased}, "
                 f"cached_tokens {[g['cached_tokens'] for g in hit]}: "
                 "wanted one copied page and a 32-token hit")
        out[quant] = {"kv_copy_counts": copies, "pages_aliased": aliased,
                      "cached_tokens": [g["cached_tokens"] for g in hit],
                      "equals_cache_off": True}
    emit({"phase": 4, "cow_check": out, "prefix_tokens": COW_PREFIX,
          "chunked_prefill": 32, "page_size": 64})
    return out


# --- phase 4, tensor-parallel serving ----------------------------------------

# tp 1, 2 and 4 over one card: the mesh names cuda:0 once a shard
# (``tp_devices``), each shard its own contiguous KV planes and its K1
TP_DEGREES = (1, 2, 4)
TP_DEVICE = "cuda:0"
TP_KW = dict(n_slots=8, max_len=2048, chunked_prefill=256)
TP_SYS, TP_NEW = 300, 24      # the shared system prompt; tokens a request
TP_TIMED_PROMPT, TP_TIMED_NEW, TP_TIMED_REPS = 512, 64, 20
TP_GEMM_M = (1, 8, 32, 256, 512)   # decode, verify (8 x 4), chunks
TP_PREFILL_ROWS, TP_PREFILL_CHUNK, TP_PREFILL_REPS = 2048, 512, 3
TP_CHILD_TIMEOUT_S = 600
TP_SAMPLED = dict(temperature=0.8, top_p=0.95)


def tp_gemm_probe(torch, quantized_serving, cfg, params) -> dict:
    """Whether a column shard's product is the whole product's columns
    bit for bit on this card: ``x @ w[:, cols]`` against ``(x @ w)[:,
    cols]`` through the port's own products (``qmatmul``, the lm_head's
    ``qhead_matmul`` to f32), at M 1, 8, 32, 256, 512, for wq, wk, w1, w3
    (layer 0) and the lm_head at Llama-3-8B's widths, tp 2 and 4, the
    shard a strided view of the whole leaf (what the batcher serves) and
    a contiguous copy, with cuBLAS's reduced-precision bf16 reductions
    allowed (torch's default, what serving runs) and not. One line a
    weight and setting."""
    mm = {"lm_head": lambda x, w: quantized_serving.qhead_matmul(
        x, w, torch.bfloat16)}
    weights = {name: params["layers"][name][0]
               for name in ("wq", "wk", "w1", "w3")}
    weights["lm_head"] = params["lm_head"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    xs = {m: torch.randn((m, cfg.d_model), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for m in TP_GEMM_M}
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for reduced in (True, False):
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = reduced
            for name, w in weights.items():
                f = mm.get(name, quantized_serving.qmatmul)
                rows = []
                for m, x in xs.items():
                    full = f(x, w)
                    for tp in (2, 4):
                        n = w.shape[-1] // tp
                        for layout in ("view", "copy"):
                            diffs = []
                            for s in range(tp):
                                part = w.narrow(-1, s * n, n)
                                if layout == "copy":
                                    part = part.contiguous()
                                got = f(x, part)
                                diffs.append(float(
                                    (got.float() - full[:, s * n:(s + 1) * n]
                                     .float()).abs().max()))
                                del got, part
                            rows.append({"m": m, "tp": tp, "layout": layout,
                                         "equal": max(diffs) == 0.0,
                                         "max_abs_diff": max(diffs)})
                    del full
                key = f"{name}_{'reduced' if reduced else 'full'}"
                out[key] = rows
                emit({"phase": 4, "tp_gemm_probe": name,
                      "shape": list(w.shape),
                      "reduced_precision_reduction": reduced,
                      "all_equal": all(r["equal"] for r in rows),
                      "unequal": [r for r in rows if not r["equal"]]})
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    return out


def tp_prompts(cfg) -> dict:
    import numpy as np

    rng = np.random.default_rng(SEED + 25)

    def ids(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    return {"sys": ids(TP_SYS), **{k: ids(n) for k, n in (
        (30, 5), (31, 4), (32, 6), (33, 40), (35, 3))},
        "timed": [ids(TP_TIMED_PROMPT) for _ in range(TP_KW["n_slots"])]}


def tp_batcher(batching, spec_mod, prefix_cache_mod, cfg, params, tp: int,
               layout: str, spec: bool = False):
    """A batcher of the phase: 8 slots x 2048 rows, chunks of 256, the
    prefix cache on with a budget that evicts mid-run (the boundaries of
    256 and 64 rows), the decode graph captured; at tp > 1 the mesh is
    ``["cuda:0"] * tp``."""
    kw = dict(TP_KW, kv_layout=layout)
    if layout == "paged":
        kw["kv_page_size"] = 64
    if tp > 1:
        kw.update(tp=tp, tp_devices=[TP_DEVICE] * tp)
    budget = sum(prefix_cache_mod.prefix_kv_bytes(cfg, p) for p in (64, 256))
    buckets = tuple(b for b in batching.DEFAULT_PROMPT_BUCKETS
                    if b <= TP_KW["max_len"])
    kw["prefix_cache"] = prefix_cache_mod.PrefixCache(
        cfg, buckets=buckets, budget_bytes=budget)
    if spec:
        return spec_mod.SpeculativeBatcher(params, cfg, params, cfg,
                                           gamma=SPEC_GAMMA, **kw)
    return batching.ContinuousBatcher(params, cfg, **kw)


def tp_scenario(cb, sampling, cfg, prompts: dict, sampled: bool) -> tuple:
    """The reference's ``_scenario`` (``tests/test_tp_serving.py``) at the
    8B widths: staggered waves over a shared system prompt, greedy and
    (``sampled``) seeded requests at temperature 0.8, a stop sequence that
    cannot fire, a cancel mid-flight, the prefix cache evicting. Returns
    (request ids, the cancelled one, {rid: (tokens, logprobs)},
    {rid: (its prompt, whether it is greedy)})."""
    rids, asked = [], {}
    sys_a = prompts["sys"]

    def sub(base, key, new, seed=None, stop=None):
        kw = {}
        if seed is not None and sampled:
            kw = dict(sampler=sampling.Sampler(**TP_SAMPLED), seed=seed)
        rids.append(cb.submit(base + prompts[key], max_new=new, stop=stop,
                              **kw))
        asked[rids[-1]] = (base + prompts[key], not kw)

    sub(sys_a, 30, TP_NEW)
    sub(sys_a, 31, TP_NEW, seed=4)
    for _ in range(7):
        cb.step()
    sub(sys_a, 32, TP_NEW, seed=5)
    sub([], 33, TP_NEW - 8)
    for _ in range(4):
        cb.step()
    cancelled = rids[2]
    cb.cancel(cancelled)
    sub(sys_a, 35, TP_NEW, stop=[[cfg.vocab_size - 1] * 2])
    cb.run()
    if cb.pool is not None:
        cb.pool.check()
    return rids, cancelled, {rid: (list(r.out), list(r.out_logp))
                             for rid, r in cb.done_requests.items()}, asked


def tp_compare(got: tuple, want: tuple) -> dict:
    """Streams against tp 1's: completed requests in tokens and logprobs,
    the cancelled one over the common prefix. Per stream: equal, or the
    first token where tokens or logprobs part and the largest logprob
    gap over the prefix the tokens share."""
    rids, cancelled, streams, _ = got
    w_rids, w_cancelled, ref, _ = want
    if (rids, cancelled) != (w_rids, w_cancelled):
        fail(f"tp: request ids {rids}/{cancelled} against {w_rids}/"
             f"{w_cancelled}")
    out = {}
    for rid in rids:
        toks, lps = streams[rid]
        rt, rl = ref[rid]
        if rid == cancelled:
            n = min(len(toks), len(rt))
            toks, lps, rt, rl = toks[:n], lps[:n], rt[:n], rl[:n]
        if (toks, lps) == (rt, rl):
            out[rid] = {"equal": True}
            continue
        j = first_divergence(toks, rt)
        k = next((i for i, (a, b) in enumerate(zip(lps, rl)) if a != b),
                 None)
        n = len(toks) if j is None else j
        out[rid] = {"equal": False, "first_token_parting": j,
                    "first_logprob_parting": k,
                    "max_logprob_gap": max((abs(a - b) for a, b in
                                            zip(lps[:n], rl[:n])),
                                           default=0.0)}
    return out


def tp_shard_bytes(cb) -> list:
    """Device bytes each shard's KV planes hold (scale planes included):
    the allocation itself, beside ``kv_stats``' per-shard count."""
    from k8s_gpu_device_plugin_torch.models.generate import kv_shards

    def planes(c):
        return [x for x in (c.k, c.v, c.k_scale, c.v_scale) if x is not None]

    return [sum(x.numel() * x.element_size() for x in planes(c))
            for c in kv_shards(cb.state.cache)]


def tp_timed_step(torch, cb, prompts: dict) -> float:
    """The decode step's device ms with all eight slots decoding at about
    512 rows: graph replays back to back between CUDA events."""
    for p in prompts["timed"]:
        cb.submit(p, TP_TIMED_NEW)
    while cb.pending or cb.prefilling or len(cb.running) < TP_KW["n_slots"]:
        cb.step()
    inflight, cb._inflight = cb._inflight, None
    if inflight is not None:
        cb._read_step(inflight)
    return _replay_ms(torch, cb.graph, TP_TIMED_REPS)


def tp_cells(exact: bool) -> list:
    """(run, tp, layout, cache quant, speculative, psum, weight quant) of
    the phase: under the exact setting every cell, else tp 1 and 2
    dense."""
    cells = [(f"tp_{layout}_tp{tp}", tp, layout, "none", False, False,
              "none") for layout in ("dense", "paged") for tp in TP_DEGREES]
    if not exact:
        return cells[:2]
    cells += [(f"tp_int8_dense_tp{tp}", tp, "dense", "int8", False, False,
               "none") for tp in (1, 2)]
    cells += [(f"tp_spec_paged_tp{tp}", tp, "paged", "none", True, False,
               "none") for tp in (1, 2)]
    cells.append(("tp_psum_dense_tp2", 2, "dense", "none", False, True,
                  "none"))
    # int8 weights (replicated leaves, each shard's columns cut from the
    # whole product) under the setting's cuBLASLt int8 products
    cells += [(f"tp_w8_dense_tp{tp}", tp, "dense", "none", False, False,
               "int8") for tp in (1, 2)]
    return cells


def tp_run_cells(torch, batching, sampling, spec_mod, prefix_cache_mod,
                 quantized_serving, kernel_support, rpa, cfg, params,
                 cells: list) -> tuple:
    """Each cell's scenario on a fresh batcher: its line (K1 launches a
    decode step and in all, KV bytes a shard as reported and as
    allocated, the streams against the tp-1 twin, the timed decode
    step). Returns ({run: row, with its streams under "got"}, the runs
    whose streams part)."""
    prompts = tp_prompts(cfg)
    runs, parted = {}, []
    weights = {"none": params}
    for run, tp, layout, quant, spec, psum, wq in cells:
        t_run = time.perf_counter()
        rcfg = dataclasses.replace(cfg, cache_quant=quant,
                                   tp_allow_psum=psum)
        if wq not in weights:
            weights[wq] = quantized_serving.quantize_weights(params, wq)
        cb = tp_batcher(batching, spec_mod, prefix_cache_mod, rcfg,
                        weights[wq], tp, layout, spec)
        if cb.graph is None:
            fail(f"{run}: the batcher captured no decode graph")
        per_step = cb.graph.launches.get(rpa.NAME, 0)
        layers = cfg.n_layers * (SPEC_GAMMA + 1 if spec else 1)
        if per_step != tp * layers:
            fail(f"{run}: {per_step} K1 launches a decode step, wanted "
                 f"tp x {layers} = {tp * layers}")
        kernel_support.reset_launch_counts()
        got = tp_scenario(cb, sampling, cfg, prompts, sampled=not spec)
        counts = kernel_support.launch_counts()
        k1 = counts.get(rpa.NAME, 0)
        if not k1 or counts.get(kernel_support.engine_key(
                rpa.NAME, "tensor_cores"), 0) != k1:
            fail(f"{run}: K1 launches {counts}: none, or some off the "
                 "tensor cores")
        kv = cb.kv_stats()
        allocated = tp_shard_bytes(cb)
        row = {"phase": 4, "run": run, "tp": tp, "layout": layout,
               "cache_quant": quant, "weight_quant": wq, "k1_launches": k1,
               "k1_launches_per_decode_step": per_step,
               "reserved_bytes": kv["reserved_bytes"],
               "shard_reserved_bytes": [s["reserved_bytes"]
                                        for s in kv.get("shards", [])],
               "shard_allocated_bytes": allocated,
               "weights": cb.weight_stats,
               "prefix_cache": cb.prefix_cache.stats.as_dict(),
               "decode_graph_pool_bytes": cb.graph.pool_bytes}
        if tp > 1:
            shards = kv["shards"]
            draft = kv.get("draft_reserved_bytes", 0)
            if sum(s["reserved_bytes"] for s in shards) != \
                    kv["reserved_bytes"] or any(
                        s["reserved_bytes"] * tp != kv["reserved_bytes"]
                        for s in shards):
                fail(f"{run}: shard bytes {shards} against the aggregate "
                     f"{kv['reserved_bytes']}")
            target = [s["reserved_bytes"] - s.get("draft_reserved_bytes", 0)
                      for s in shards]
            if target != allocated:
                fail(f"{run}: shards allocate {allocated} bytes of KV, "
                     f"kv_stats says {target}")
            if draft and any(s["draft_reserved_bytes"] * tp != draft
                             for s in shards):
                fail(f"{run}: draft shard bytes {shards} against {draft}")
        elif kv.get("shards") or "tp" in kv:
            fail(f"{run}: tp 1's kv_stats carries a shard view: {kv}")
        twin = f"tp_{layout}_tp1" if quant == wq == "none" and not spec \
            else run.replace(f"tp{tp}", "tp1")
        if tp > 1 or psum:
            row["streams"] = tp_compare(got, runs[twin]["got"])
            if not psum and not all(v["equal"]
                                    for v in row["streams"].values()):
                parted.append(run)
        if layout == "dense" and quant == wq == "none" and not spec and \
                not psum:
            row["decode_step_device_ms"] = tp_timed_step(torch, cb, prompts)
        row["wall_s"] = time.perf_counter() - t_run
        emit(row)
        runs[run] = {**row, "got": got}
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return runs, parted


def tp_timed_prefill(torch, generate, cfg, params) -> float:
    """Device ms of one TP_PREFILL_ROWS-token prefill at tp 1 in chunks
    of TP_PREFILL_CHUNK rows through the kernel path, under this
    process's cuBLAS setting: one warm-up, then TP_PREFILL_REPS between
    CUDA events (the chunks' M is the size where the workspace setting
    can choose other GEMM algorithms)."""
    gen = torch.Generator(device=TP_DEVICE)
    gen.manual_seed(SEED + 26)
    n, c = TP_PREFILL_ROWS, TP_PREFILL_CHUNK
    toks = torch.randint(1, cfg.vocab_size, (1, n), generator=gen,
                         device=TP_DEVICE)
    cache = generate.KVCache.init(cfg, 1, n, TP_DEVICE)

    def prefill():
        for i in range(0, n, c):
            generate._forward_cached(params, toks[:, i:i + c], cache, i,
                                     cfg, last_only=True)

    prefill()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TP_PREFILL_REPS):
        prefill()
    end.record()
    end.synchronize()
    del cache
    return start.elapsed_time(end) / TP_PREFILL_REPS


def tp_parting_gaps(torch, generate, tp_serving, cfg, params, got: tuple,
                    want: tuple, tp: int) -> list:
    """Where a greedy stream at tp ``tp`` (``got``) first parts in tokens
    from tp 1's (``want``): the two tokens' f32 logit gap on each side,
    from one forward of the common prefix through the plain attention,
    at tp 1 and at tp ``tp`` (the mesh ``[TP_DEVICE] * tp``) under this
    process's cuBLAS setting, with the token each side picks there and
    how far the two sides' logits lie apart."""
    rids, _, streams, asked = got
    ref = want[2]
    tcfg = dataclasses.replace(cfg, tp=tp)
    mesh = tp_serving.serving_mesh(tp, cfg.n_kv_heads, [TP_DEVICE] * tp)
    sharded = tp_serving.shard_serving_params(params, tcfg, mesh)
    out = []
    for rid in rids:
        prompt, greedy = asked[rid]
        toks, rt = streams[rid][0], ref[rid][0]
        j = first_divergence(toks, rt)
        if j is None or not greedy:
            continue
        g, w = toks[j], rt[j]
        ctx = prompt + rt[:j]
        whole = plain_logits(torch, generate, cfg, params, ctx)
        cache = generate.scratch_cache(tcfg, 1, len(ctx), mesh)
        shard = generate._forward_cached(
            sharded, torch.tensor([ctx], device=TP_DEVICE), cache, 0, tcfg,
            last_only=True, plain_attention=True)[0, -1].float()
        gaps = {f"tp{k}": float((x[g] - x[w]).abs())
                for k, x in ((1, whole), (tp, shard))}
        out.append({"request": rid, "token": j, "got": g, "want": w,
                    "logit_gap": gaps,
                    "picks": {"tp1": int(whole.argmax()),
                              f"tp{tp}": int(shard.argmax())},
                    "logits_max_apart": float((whole - shard).abs().max()),
                    "logits_rms_apart": float((whole - shard).pow(2).mean()
                                              .sqrt()),
                    "within_near_tie": {k: v <= NEAR_TIE
                                        for k, v in gaps.items()}})
        del cache, whole, shard
    del sharded
    return out


def phase_tp_exact(torch, batching, sampling, spec_mod, prefix_cache_mod,
                   quantized_serving, kernel_support, rpa, cfg,
                   params) -> dict:
    """The phase's bit-for-bit half, in a process whose cuBLAS has no
    workspace (``parallel/tp_serving.EXACT_CUBLAS_ENV``): every column
    shard's product equal to the whole product's columns, and at tp 2
    and 4 every stream equal to tp 1's in tokens and logprobs, dense and
    paged, int8 KV, int8 weights and speculative at tp 2; psum at tp 2
    reported; the prefill's device ms under the setting."""
    from k8s_gpu_device_plugin_torch.models import generate

    t0 = time.perf_counter()
    probe = tp_gemm_probe(torch, quantized_serving, cfg, params)
    unequal = [k for k, rows in probe.items()
               if not all(r["equal"] for r in rows)]
    if unequal:
        fail(f"tp exact: column shards of {unequal} differ from the whole "
             "product with no cuBLAS workspace")
    runs, parted = tp_run_cells(torch, batching, sampling, spec_mod,
                                prefix_cache_mod, quantized_serving,
                                kernel_support, rpa, cfg, params,
                                tp_cells(exact=True))
    if parted:
        fail(f"tp exact: streams of {parted} part from tp 1's")
    summary = {
        "prefill_device_ms": tp_timed_prefill(torch, generate, cfg, params),
        "decode_step_device_ms": {tp: runs[f"tp_dense_tp{tp}"][
            "decode_step_device_ms"] for tp in TP_DEGREES},
        "k1_launches": sum(r["k1_launches"] for r in runs.values()),
        "k1_launches_tp": sum(r["k1_launches"] for r in runs.values()
                              if r["tp"] > 1),
        "k1_launches_per_decode_step": {
            run: r["k1_launches_per_decode_step"] for run, r in runs.items()},
        "streams_equal_to_tp1": True,
        "psum_streams": runs["tp_psum_dense_tp2"]["streams"],
        "wall_s": time.perf_counter() - t0}
    emit({"phase": 4, "run": "tp_exact", **summary})
    return summary


def tp_exact_child() -> None:
    """``chip_smoke.py --tp-exact``: :func:`phase_tp_exact` on its own
    copy of the Llama-3-8B weights (the same seed), drawn while the
    parent builds the kernels, with K1 loaded from the parent's build
    once it lands (the child never runs nvcc beside it)."""
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a card")
    sys.path.insert(0, ROOT)
    from k8s_gpu_device_plugin_torch.models import batching, llama
    from k8s_gpu_device_plugin_torch.models import quantized_serving
    from k8s_gpu_device_plugin_torch.models import sampling
    from k8s_gpu_device_plugin_torch.models import spec_batching as spec_mod
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
    from k8s_gpu_device_plugin_torch.parallel import tp_serving
    from k8s_gpu_device_plugin_torch.serving import prefix_cache as pc_mod
    from k8s_gpu_device_plugin_torch.serving import server as server_mod

    if not tp_serving.exact_cublas():
        fail(f"--tp-exact runs under {tp_serving.EXACT_CUBLAS_ENV}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig.llama3_8b()
    params = server_mod.load_params(cfg, seed=SEED, device="cuda")
    built = os.path.join(kernel_support.BUILD_DIR, f"lib{rpa.NAME}_"
                         f"{kernel_support.build_key([rpa.SOURCE])}.so")
    t0 = time.perf_counter()
    while not os.path.exists(built):
        if time.perf_counter() - t0 > TP_CHILD_TIMEOUT_S:
            fail(f"--tp-exact: the parent's K1 build {built} never landed")
        time.sleep(0.5)
    rpa.load_kernel()
    phase_tp_exact(torch, batching, sampling, spec_mod, pc_mod,
                   quantized_serving, kernel_support, rpa, cfg, params)


def start_tp_exact():
    """Start the bit-for-bit half of the tp phase, ``chip_smoke.py
    --tp-exact`` under no cuBLAS workspace (:func:`tp_exact_child`), at
    the script's start: it draws its weights while this process builds
    the kernels, and runs once K1 is built, beside phase 1's SASS count
    only (no timed case shares the card with it)."""
    from k8s_gpu_device_plugin_torch.parallel.tp_serving import (
        EXACT_CUBLAS_ENV,
    )

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-exact"],
        env={**os.environ, **EXACT_CUBLAS_ENV}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # a failure before the join must not leave the child behind
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def join_tp_exact(proc) -> dict:
    """Wait for the ``--tp-exact`` child, relay its lines
    (``child_elapsed_s``: the child's clock) and return its summary."""
    try:
        out, err = proc.communicate(timeout=TP_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    exact = None
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if "elapsed_s" in obj:
            obj["child_elapsed_s"] = obj.pop("elapsed_s")
        if obj.get("run") == "tp_exact":
            exact = obj
        emit(obj)
    if proc.returncode or exact is None:
        fail(f"tp: the --tp-exact child exited {proc.returncode}: "
             f"{out[-1500:]} {err[-1500:]}")
    return exact


def phase_tp(torch, batching, sampling, spec_mod, prefix_cache_mod,
             quantized_serving, kernel_support, rpa, cfg, params,
             exact: dict) -> dict:
    """Tensor-parallel serving on one card (``parallel/tp_serving.py``),
    the mesh ``["cuda:0"] * tp``. Under torch's default cuBLAS workspace
    (this process): the column-product probe and tp 1 against tp 2
    dense, reported (cuBLAS may split K otherwise for a narrower N: the
    limit ROADMAP C records; streams that part while the probe finds
    every shard equal fail), with the f32 logit gaps where greedy
    streams part and the prefill's device ms (against the child's, the
    cost of no workspace). ``exact`` is the bit-for-bit half's summary
    (:func:`join_tp_exact`), run with no cuBLAS workspace in a child."""
    from k8s_gpu_device_plugin_torch.models import generate
    from k8s_gpu_device_plugin_torch.parallel import tp_serving

    t0 = time.perf_counter()
    probe = tp_gemm_probe(torch, quantized_serving, cfg, params)
    runs, parted = tp_run_cells(torch, batching, sampling, spec_mod,
                                prefix_cache_mod, quantized_serving,
                                kernel_support, rpa, cfg, params,
                                tp_cells(exact=False))
    probe_equal = all(r["equal"] for rows in probe.values() for r in rows)
    if parted and probe_equal:
        fail(f"tp: streams of {parted} part from tp 1's while every column "
             "shard's product equals the whole product's")
    default = {"probe_all_equal": probe_equal,
               "probe_unequal": {k: [r for r in rows if not r["equal"]]
                                 for k, rows in probe.items()},
               "streams": runs["tp_dense_tp2"]["streams"],
               "parting_logit_gaps": tp_parting_gaps(
                   torch, generate, tp_serving, cfg, params,
                   runs["tp_dense_tp2"]["got"], runs["tp_dense_tp1"]["got"],
                   2),
               "decode_step_device_ms": {tp: runs[f"tp_dense_tp{tp}"][
                   "decode_step_device_ms"] for tp in (1, 2)},
               "prefill_device_ms": tp_timed_prefill(torch, generate, cfg,
                                                     params),
               "k1_launches": sum(r["k1_launches"] for r in runs.values())}
    emit({"phase": 4, "run": "tp_default_workspace", **default})
    summary = {**exact, "default_workspace": default,
               "k1_launches": exact["k1_launches"] + default["k1_launches"],
               "wall_s": time.perf_counter() - t0}
    emit({"phase": 4, "run": "tp", "wall_s": summary["wall_s"],
          "k1_launches": summary["k1_launches"]})
    return {"summary": summary}


# --- phase 4, speculative decoding --------------------------------------------

# the speculative runs: Llama-3-8B drafting for itself (the draft shares
# the target's random weights and tensors) or with its first 8 layers
SPEC_GAMMA = 4
SPEC_ARGS = ["--preset", "llama3_8b", "--draftPreset", "llama3_8b",
             "--gamma", str(SPEC_GAMMA), "--slots", "8", "--maxLen", "2048",
             "--chunkedPrefill", "256"]
SPEC_PAGED = ["--kvLayout", "paged", "--kvPageSize", "64"]  # default pools
# spec_self: the phase 4 requests, dense and paged, synchronous and
# pipelined; the first run is the one the others must equal bit for bit
SPEC_RUNS = {"spec_self_dense_depth0": ["--pipelineDepth", "0"],
             "spec_self_dense": [],
             "spec_self_paged": SPEC_PAGED,
             "spec_self_paged_depth0": [*SPEC_PAGED, "--pipelineDepth", "0"]}
SPEC_PREFIX_RUNS = {"spec_prefix_off": [*SPEC_PAGED, "--prefixCacheOff"],
                    "spec_prefix": SPEC_PAGED}
SPEC_SAMPLED = ["--temperature", "0.8", "--topP", "0.95"]
# a self-draft's q differs from p only by rounding: in f32 (the 8-layer
# self-draft at batcher level) that leaves a rejection only at an exact
# tie, so it must accept at least SPEC_ACCEPT_MIN; in bf16 the T = 1 draft
# decodes and the T = 4 verify forward differ by rounding that moves a
# logit by up to about 0.3 on these random weights and flips near ties
# (PERF.md), so a bf16 self-draft is held to SPEC_ACCEPT_FLOOR_BF16. The
# rate counts each round's correction as accepted: rounds that keep k
# proposals and reject the next read (k + 1) / gamma, 0.25 when the first
# is rejected and 0.75 when the third is; the floor lies above that and
# below the bf16 self-draft runs' readings on an H100 (0.888 spec_self,
# 0.845 spec_prefix)
SPEC_ACCEPT_MIN = 0.95
SPEC_ACCEPT_FLOOR_BF16 = 0.8
NEAR_TIE = 0.1          # f32 logits: a near tie, reported beside each
                        # greedy divergence (the check is near_ties')
F32_LAYERS = 8          # the f32 self-draft: the target's first 8 layers
TRUNC_LAYERS = 8        # spec_trunc's draft: the target's first 8 layers
SPEC_EAGER_ROUNDS = 16  # replayed rounds held to the eager round
SPEC_TIMED_ROUNDS = 10  # rounds (and plain steps) timed back to back
# speculative_generate's tokens (64 until the tp phase took its time)
SPEC_GENERATE_NEW = 32


def spec_refused(max_len: int = 2048) -> set:
    """Phase 4 requests the gamma reservation refuses: prompt + max_new +
    gamma past the slot."""
    return {i for i, (plen, max_new) in enumerate(REQUESTS)
            if plen + max_new + SPEC_GAMMA > max_len}


def spec_bodies(cfg) -> list[dict]:
    """Phase 4's six requests (the same prompts: the same generator),
    every one asking for logprobs; the streamed one streams."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    bodies = []
    for i, (plen, max_new) in enumerate(REQUESTS):
        body = {"prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
                "max_new": max_new, "logprobs": True}
        if i == STREAMED:
            body["stream"] = True
        bodies.append(body)
    return bodies


def spec_launches(run: str, kernel_support, rpa, cfg,
                  draft_layers: int, rounds: int, chunks: int,
                  backfill: int) -> dict:
    """K1's launches since the last reset for a speculative run: per round
    gamma draft decodes (a layer each, all split) and one verify window (a
    layer each, none split: group 4 x T 4 takes the chunk engine); per
    prefill chunk the target's and the draft's mirror; per backfill chunk
    the draft's. All on the run's route and the tensor cores."""
    counts = kernel_support.launch_counts()
    verify = counts.get(rpa.VERIFY_KEY, 0)
    split = counts.get(rpa.SPLIT_KEY, 0)
    verify_split = counts.get(rpa.VERIFY_SPLIT_KEY, 0)
    total = counts.get(rpa.NAME, 0)
    engines = {e: counts.get(kernel_support.engine_key(rpa.NAME, e), 0)
               for e in kernel_support.ENGINES}
    need = {"verify": cfg.n_layers * rounds,
            "draft_decode_split": draft_layers * SPEC_GAMMA * rounds,
            "total": (cfg.n_layers + draft_layers * SPEC_GAMMA) * rounds
            + (cfg.n_layers + draft_layers) * chunks
            + draft_layers * backfill}
    got = {"verify": verify, "draft_decode_split": split, "total": total}
    if got != need or verify_split or engines != {
            "cuda_cores": 0, "tensor_cores": total}:
        fail(f"{run}: K1 launches {got} (verify windows split: "
             f"{verify_split}, per engine {engines}), the run needs {need}: "
             "every verify on the chunk engine, every draft decode split, "
             "all on the tensor cores")
    return {"launches": total, "launches_per_engine": engines,
            "verify_launches": verify, "verify_launches_split": verify_split,
            "split_launches": split}


def first_divergence(a: list, b: list) -> "int | None":
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def plain_logits(torch, generate, cfg, params, context: list):
    """f32 logits at the position after ``context``: one forward of the
    whole context through the plain attention."""
    device = params["embed"].device
    toks = torch.tensor([context], device=device)
    cache = generate.KVCache.init(cfg, 1, len(context), device)
    logits = generate._forward_cached(params, toks, cache, 0, cfg,
                                      last_only=True,
                                      plain_attention=True)[0, -1].float()
    del cache
    return logits


@contextlib.contextmanager
def recording(torch, module, verify: bool):
    """Record the forwards through ``module``'s ``_forward_cached`` that
    pick tokens: its verify windows (``verify``) or its T = 1 decodes.
    Yields the list of (each row's first position (B,), f32 logits
    (B, T, V)) the calls append to."""
    orig = module._forward_cached
    calls = []

    def wrapped(params, tokens, cache, length, cfg, **kw):
        out = orig(params, tokens, cache, length, cfg, **kw)
        if bool(kw.get("verify")) == verify and (verify
                                                 or tokens.shape[1] == 1):
            base = torch.as_tensor(length).reshape(-1).expand(
                tokens.shape[0])
            calls.append((base.tolist(), out.float().clone()))
        return out

    module._forward_cached = wrapped
    try:
        yield calls
    finally:
        module._forward_cached = orig


def deciding_logits(run: str, calls: list, pos: int):
    """Slot 0's logits from the last recorded forward whose row ran the
    token at position ``pos``: the one that picked the token after it (an
    earlier round may have run ``pos`` after a rejected proposal)."""
    for base, logits in reversed(calls):
        r = pos - base[0]
        if 0 <= r < logits.shape[1]:
            return logits[0, r]
    fail(f"{run}: no recorded forward ran position {pos}")


def batcher_decider(torch, batching, spec_mod, cfg, params, max_news: list):
    """``decide`` for near_ties over batcher runs (eight slots, 2048 rows,
    chunks of 256, the self-draft at SPEC_GAMMA): stream ``k`` alone, in
    slot 0 of a plain batcher and of a speculative one, both eager; each
    row of a step is computed alone at the batch's shapes, so these are
    the logits the served runs picked from (the replayed step equals the
    eager one bit for bit, and near_ties holds the picks to the streams)."""
    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
              decode_graph=False, pipeline_depth=0)

    def decide(run: str, k: int, prompt: list, j: int) -> tuple:
        out = []
        for module, cb in (
                (batching, batching.ContinuousBatcher(params, cfg, **kw)),
                (spec_mod, spec_mod.SpeculativeBatcher(
                    params, cfg, params, cfg, gamma=SPEC_GAMMA, **kw))):
            with recording(torch, module, module is spec_mod) as calls:
                rid = cb.submit(prompt, max_news[k])
                cb.run()
            out.append((cb.done_requests[rid].out,
                        deciding_logits(run, calls, len(prompt) + j - 1)))
            del cb, calls
            gc.collect()
            torch.cuda.empty_cache()
        return out

    return decide


def near_ties(run: str, torch, generate, truth: tuple, prompts: list,
              got: list, want: list, decide, score=None) -> list:
    """Each stream's first divergence from ``want`` (None: none), judged
    by the plain f32 forward of the common prefix (``truth``: an f32
    config and f32 weights); its gap between the two tokens is reported
    beside NEAR_TIE. ``want`` came from decode forwards and ``got`` from
    verify windows (or from a resumed admission): ``decide(run, k, prompt,
    j)`` reruns stream ``k`` and gives, for each, the stream (whole, or
    through token ``j``) and the logits its token ``j`` was picked from.
    The reruns must give the streams, and the logits their tokens.
    One of the two forwards then moved the pair's order against the truth
    by the gap, so the gap is at most its error at the two tokens,
    |e[g] - t[g]| + |e[w] - t[w]| (reported for both). What can fail is
    the rounding bound: the verify forward's RMS error over the vocabulary
    at most twice the decode forward's. ``score(logits, j)`` (a seeded
    sampled stream: the logits over the temperature plus token ``j``'s
    counter noise) is what the pick maximizes; every comparison is made
    on it (default: the logits, greedy)."""
    out = []
    for k, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        j = first_divergence(g, w)
        if j is None:
            out.append(None)
            continue
        (w_again, e_dec), (g_again, e_ver) = decide(run, k, prompt, j)
        # a rerun gives the stream, or its first tokens through token j
        picks = [int((x if score is None else score(x, j)).argmax())
                 for x in (e_dec, e_ver)]
        if len(w_again) <= j or w_again != w[:len(w_again)] or \
                len(g_again) <= j or g_again != g[:len(g_again)] or \
                picks != [w[j], g[j]]:
            fail(f"{run}: stream {k}'s rerun does not give the served "
                 f"tokens, or its logits at token {j} do not pick them")
        t = plain_logits(torch, generate, *truth, prompt + w[:j])
        if score is not None:
            e_dec, e_ver, t = (score(x, j) for x in (e_dec, e_ver, t))
        gap = float((t[g[j]] - t[w[j]]).abs())
        pair = [float((e[g[j]] - t[g[j]]).abs() + (e[w[j]] - t[w[j]]).abs())
                for e in (e_dec, e_ver)]
        rms = [float((e - t).pow(2).mean().sqrt()) for e in (e_dec, e_ver)]
        out.append({"request": k, "token": j, "got": g[j], "want": w[j],
                    "logit_gap": gap, "pair_error_decode": pair[0],
                    "pair_error_verify": pair[1], "rms_error_decode": rms[0],
                    "rms_error_verify": rms[1],
                    "within_near_tie": gap <= NEAR_TIE})
        del t, e_dec, e_ver
        if gap > max(pair):
            fail(f"{run}: stream {k} diverges at token {j} ({g[j]} against "
                 f"{w[j]}) at an f32 logit gap of {gap:.4f}, over both "
                 f"forwards' errors at the two tokens ({pair[0]:.4f}, "
                 f"{pair[1]:.4f})")
        if rms[1] > 2 * rms[0]:
            fail(f"{run}: at stream {k}'s divergence (token {j}) the verify "
                 f"forward's RMS error over the vocabulary, {rms[1]:.4f}, is "
                 f"over twice the decode forward's, {rms[0]:.4f}")
    return out


def spec_serve(torch, server_mod, kernel_support, rpa, spec_mod,
               cfg, params, run: str, flags: list, bodies: list,
               refused=frozenset(), alone_first: bool = False) -> dict:
    """One speculative server (the self-draft) over ``bodies`` at once (the
    first alone before the rest with ``alone_first``): every stream
    complete, every round a replay of the captured round, K1's launches
    counted (spec_launches), acceptance at least SPEC_ACCEPT_FLOOR_BF16, a
    paged run's pools consistent and empty once the prefix cache lets
    go."""
    args, server, url = start_server(server_mod, [*SPEC_ARGS, *flags],
                                     params)
    try:
        cb = server.engine.cb
        if not isinstance(cb, spec_mod.SpeculativeBatcher) or \
                cb.graph is None or cb.draft_params is not cb.params:
            fail(f"{run}: the server must serve a self-draft "
                 "SpeculativeBatcher sharing the target's tensors, its "
                 "round captured as a CUDA graph")
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        replays0, backfill0 = cb.graph.replays, cb.draft_backfill_chunks
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        if alone_first:
            results = post_all(url, bodies[:1], run)
            results += post_all(url, bodies[1:], run)
        else:
            results = post_all(url, bodies, run, refused=refused)
        wall = time.perf_counter() - t0
        health = server.engine.stats()
        rounds = cb.decode_steps - steps0
        chunks = cb.prefill_chunks - chunks0
        backfill = cb.draft_backfill_chunks - backfill0
        if cb.graph.replays - replays0 != rounds:
            fail(f"{run}: {rounds} rounds but "
                 f"{cb.graph.replays - replays0} graph replays")
        for i, (res, body) in enumerate(zip(results, bodies)):
            if i in refused:
                continue
            toks, lps = res["tokens"], res["logprobs"]
            if len(toks) != body["max_new"] or len(lps or ()) != len(toks) \
                    or not all(0 <= t < cfg.vocab_size for t in toks):
                fail(f"{run}: request {i} came back short or out of the "
                     f"vocabulary ({len(toks)} tokens)")
        launched = spec_launches(run, kernel_support, rpa, cfg,
                                 cb.draft_cfg.n_layers, rounds, chunks,
                                 backfill)
        spec = health["spec"]
        if spec["acceptance_rate"] < SPEC_ACCEPT_FLOOR_BF16:
            fail(f"{run}: acceptance {spec['acceptance_rate']:.4f} < "
                 f"{SPEC_ACCEPT_FLOOR_BF16} for a bf16 self-draft: {spec}")
        kv = health["kv"]
        if kv["reserved_bytes"] != 2 * kv["target_reserved_bytes"]:
            fail(f"{run}: reserved_bytes {kv['reserved_bytes']} is not the "
                 "target's and its self-draft's")
        if cb.pool is not None:
            cb.pool.check()
            cb.draft_pool.check()
            drain_prefix_cache(server)
            if cb.pool.in_use or cb.draft_pool.in_use:
                fail(f"{run}: pages still in use: {cb.kv_stats()}")
            cb.pool.check()
        row = {"phase": 4, "run": run, "flags": flags,
               "requests": len(bodies), "refused_422": sorted(refused),
               "rounds": rounds, "prefill_chunks": chunks,
               "draft_backfill_chunks": backfill, **launched,
               "spec": spec, "wall_s": wall,
               "pipeline_depth": args.pipelineDepth,
               "round_ms_host_mean": health["decode_step_ms_mean"],
               "decode_tokens_per_s": health["decode_tokens_per_s"],
               "ttft_s_p50": health["ttft_s_p50"],
               "decode_graph": health["decode"]["graph"],
               "pipeline_flushes": health["decode"]["pipeline_flushes"],
               "kv": kv, "prefix_cache": health.get("prefix_cache"),
               "prefill_tokens": health["prefill_tokens"],
               "cached_tokens": [r["cached_tokens"] for r in results]}
        emit(row)
        return {**row, "results": results}
    finally:
        server.stop()
        gc.collect()
        torch.cuda.empty_cache()


def phase_spec_serving(torch, server_mod, kernel_support, rpa,
                       spec_mod, batching, generate, cfg, params,
                       plain: dict) -> dict:
    """The speculative server on the card. spec_self: phase 4's requests
    with a self-draft at gamma 4, dense and paged, synchronous and
    pipelined: the four runs equal bit for bit in tokens and logprobs;
    the greedy tokens the plain dense run's (``plain``) up to each
    stream's first divergence, which must be a near tie. spec_prefix: the
    prefix runs' shared 1024-token system prompt on the paged pools, one
    request alone and then seven at once, cache off and on: the hits
    answer cached_tokens 1024, alias 16 pages each, copy no row, backfill
    the draft (4 chunks each) and give the cache-off streams.
    spec_sampled: the self-draft at temperature 0.8, top-p 0.95, dense."""
    import numpy as np

    refused = spec_refused()
    bodies = spec_bodies(cfg)
    out = {}
    for run, flags in SPEC_RUNS.items():
        out[run] = spec_serve(torch, server_mod, kernel_support, rpa,
                              spec_mod, cfg, params, run, flags, bodies,
                              refused)
    first = next(iter(SPEC_RUNS))
    for run in SPEC_RUNS:
        equal_streams(run, out[run]["results"], out[first]["results"],
                      logprobs=True)
    served = [i for i in range(len(bodies)) if i not in refused]
    # the near-tie judge: the plain f32 forward, f32 weights (32 GB, freed
    # right after)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, params)
    divergences = near_ties(
        "spec_self", torch, generate, (cfg32, params32),
        [bodies[i]["prompt"] for i in served],
        [out[first]["results"][i]["tokens"] for i in served],
        [plain["tokens"][i] for i in served],
        batcher_decider(torch, batching, spec_mod, cfg, params,
                        [bodies[i]["max_new"] for i in served]))
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": 4, "run": "spec_self", "equal_bitwise": list(SPEC_RUNS),
          "refused_422": sorted(refused),
          "divergences_from_plain_dense": divergences,
          "tokens_per_s": {"spec_self_dense":
                           out["spec_self_dense"]["decode_tokens_per_s"],
                           "plain_dense": plain["decode_tokens_per_s"]}})
    out["spec_self"] = {"divergences": divergences}

    rng = np.random.default_rng(SEED + 3)  # phase_prefix's requests
    system = rng.integers(0, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    pbodies = [{"prompt": system + rng.integers(0, cfg.vocab_size,
                                                int(n)).tolist(),
                "max_new": PREFIX_MAX_NEW, "stream": True, "logprobs": True}
               for n in rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1,
                                     PREFIX_N)]
    for run, flags in SPEC_PREFIX_RUNS.items():
        batching.reset_kv_copy_counts()
        out[run] = spec_serve(torch, server_mod, kernel_support, rpa,
                              spec_mod, cfg, params, run, flags, pbodies,
                              alone_first=True)
        out[run]["kv_copy_counts"] = batching.kv_copy_counts()
    hit, off = out["spec_prefix"], out["spec_prefix_off"]
    equal_streams("spec_prefix", hit["results"], off["results"],
                  logprobs=True)
    hits = PREFIX_N - 1
    want_cached = [0] + [PREFIX_SYSTEM] * hits
    chunk = int(SPEC_ARGS[SPEC_ARGS.index("--chunkedPrefill") + 1])
    per_hit = -(-PREFIX_SYSTEM // chunk)  # the cold grid's chunks below it
    if (hit["cached_tokens"] != want_cached
            or off["cached_tokens"] != [0] * PREFIX_N
            or hit["kv_copy_counts"] != {"rows": 0, "cow_pages": 0}
            or hit["kv"]["pages_aliased"] != hits * PREFIX_SYSTEM // 64
            or hit["draft_backfill_chunks"] != hits * per_hit
            or off["draft_backfill_chunks"] != 0):
        fail(f"spec_prefix: cached_tokens {hit['cached_tokens']}, copies "
             f"{hit['kv_copy_counts']}, pages aliased "
             f"{hit['kv']['pages_aliased']}, backfill chunks "
             f"{hit['draft_backfill_chunks']} (off: "
             f"{off['draft_backfill_chunks']}): each hit aliases 16 pages, "
             f"copies nothing and backfills the draft in {per_hit} chunks")
    emit({"phase": 4, "run": "spec_prefix", "equals_cache_off": True,
          "cached_tokens": hit["cached_tokens"],
          "kv_copy_counts": hit["kv_copy_counts"],
          "pages_aliased": hit["kv"]["pages_aliased"],
          "draft_backfill_chunks": hit["draft_backfill_chunks"],
          "prefill_chunks": {"off": off["prefill_chunks"],
                             "on": hit["prefill_chunks"]}})

    out["spec_sampled"] = spec_serve(
        torch, server_mod, kernel_support, rpa, spec_mod, cfg, params,
        "spec_sampled", SPEC_SAMPLED, bodies, refused)
    # rejection sampling accepts 1 - TV(p, q): rounding moves little mass
    sampled = out["spec_sampled"]["spec"]["acceptance_rate"]
    if sampled < SPEC_ACCEPT_MIN:
        fail(f"spec_sampled: acceptance {sampled:.4f} < {SPEC_ACCEPT_MIN}")
    for run in (*SPEC_RUNS, *SPEC_PREFIX_RUNS, "spec_sampled"):
        out[run].pop("results", None)
    return out


def _clone_state(state):
    """A copy of a BatchState, every tensor (the cache's planes too)."""
    twin = dataclasses.replace(state, cache=dataclasses.replace(state.cache))
    for name, x in _state_tensors(state).items():
        obj, attr = (twin.cache, name[6:]) if name.startswith("cache.") \
            else (twin, name)
        setattr(obj, attr, x.clone())
    return twin


def _replay_ms(torch, graph, reps: int) -> float:
    """Device ms of one replay: ``reps`` replays back to back between CUDA
    events (the batch keeps decoding: nothing is read back)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def truncated_draft(cfg, params, layers: int):
    """The target's first ``layers`` layers with its embedding, final norm
    and head: slices of the same tensors, no copy."""
    return (dataclasses.replace(cfg, n_layers=layers),
            {**params, "layers": {k: v[:layers]
                                  for k, v in params["layers"].items()}})


def phase_spec_batcher(torch, batching, spec_mod, speculative, generate,
                       cfg, params) -> dict:
    """The speculative round at batcher level on the card.

    - Round time: a self-draft batcher and a plain one, eight slots
      decoding at about 1000 rows each: the round's and the plain step's
      device ms, SPEC_TIMED_ROUNDS replays back to back between CUDA
      events.
    - spec_f32: the target's first F32_LAYERS layers widened to f32 as a
      self-draft (the CUDA cores) on phase 4's six requests: acceptance at
      least SPEC_ACCEPT_MIN, and the f32 plain batcher's tokens up to a
      near tie.
    - spec_trunc: the draft is the target's first TRUNC_LAYERS layers
      (with its embedding, norm and head), dense and paged: three
      requests decode, and for the first SPEC_EAGER_ROUNDS rounds a copy
      of both states takes an eager ``spec_decode_step`` while the batcher
      replays its graph: emitted tokens, counts, logprobs and every tensor
      of both states must agree bit for bit (a pool's trap page aside);
      then phase 4's six requests join and all run out. Paged must equal
      dense bit for bit; the histogram of per-slot counts is reported.
    - speculative_generate: batch 1, the self-draft, phase 4's 200-token
      prompt, SPEC_GENERATE_NEW tokens: generate's up to a near tie."""
    import collections

    import numpy as np

    out = {}
    # round time against the plain step, eight slots decoding
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, 1000).tolist()
               for _ in range(8)]
    timed = {}
    for name in ("spec_self_round", "plain_step"):
        kw = dict(n_slots=8, max_len=2048, chunked_prefill=256)
        cb = (spec_mod.SpeculativeBatcher(params, cfg, params, cfg,
                                          gamma=SPEC_GAMMA, **kw)
              if name == "spec_self_round"
              else batching.ContinuousBatcher(params, cfg, **kw))
        for p in prompts:
            cb.submit(p, 400)
        while cb.pending or cb.prefilling:
            cb.step()
        cb.step()
        cb._flush_inflight()
        timed[name] = _replay_ms(torch, cb.graph, SPEC_TIMED_ROUNDS)
        timed[name + "_pool_bytes"] = cb.graph.pool_bytes
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    timed["round_over_step"] = timed["spec_self_round"] / timed["plain_step"]
    emit({"phase": 4, "spec_round_time": timed, "slots": 8,
          "context_rows": 1000, "gamma": SPEC_GAMMA})
    out["round_time"] = timed

    # spec_trunc
    dcfg, dparams = truncated_draft(cfg, params, TRUNC_LAYERS)
    rng = np.random.default_rng(SEED + 2)  # phase_graph's prompts
    first = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n, *_ in GRAPH_REQUESTS]
    rest = [b["prompt"] for b in spec_bodies(cfg)]
    streams, trunc = {}, {}
    for layout in ("dense", "paged"):
        kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
                  gamma=SPEC_GAMMA, kv_layout=layout, kv_page_size=64)
        if layout == "dense":
            kw.pop("kv_page_size")
        cb = spec_mod.SpeculativeBatcher(params, cfg, dparams, dcfg, **kw)
        if cb.graph is None:
            fail(f"spec_trunc {layout}: no round graph")
        hist = collections.Counter()
        apply = cb._apply_decode_result

        def counted(arrs, apply=apply, hist=hist):
            hist.update(c for c in arrs[1].tolist() if c > 0)
            return apply(arrs)

        cb._apply_decode_result = counted
        rids = [cb.submit(p, 128) for p in first]
        while cb.pending or cb.prefilling or len(cb.running) < len(first):
            cb.step()
        cb._flush_inflight()
        checked = []
        for _ in range(SPEC_EAGER_ROUNDS):
            cb._refresh_slot_inputs()
            t_twin, d_twin = _clone_state(cb.state), _clone_state(cb.draft_state)
            e = spec_mod.spec_decode_step(
                cb.params, cb.draft_params, t_twin, d_twin, cb._allowed,
                cb.cfg, cb.draft_cfg, cb.gamma, cb.sampler, cb.generator)
            g = tuple(x.clone() for x in cb.graph.replay())
            torch.cuda.synchronize()
            same = {n: bool(torch.equal(a, b)) for n, a, b in
                    zip(("emitted", "counts", "logps"), e, g)}
            for tag, live, twin in (("target", cb.state, t_twin),
                                    ("draft", cb.draft_state, d_twin)):
                for name, x in _state_tensors(live).items():
                    y = getattr(twin.cache, name[6:]) if \
                        name.startswith("cache.") else getattr(twin, name)
                    if name.startswith("cache.") and layout == "paged":
                        x, y = x[:, 1:], y[:, 1:]  # the trap page aside
                    same[f"{tag}.{name}"] = bool(torch.equal(x, y))
            bad = [k for k, v in same.items() if not v]
            if bad:
                fail(f"spec_trunc {layout}: a replayed round differs from "
                     f"the eager round in {bad}")
            checked.append(g[1].tolist())
            cb._apply_decode_result(g)
            del t_twin, d_twin, e
        rids += [cb.submit(p, b["max_new"]) for p, b in
                 zip(rest, spec_bodies(cfg))]
        cb.run()
        if cb.pool is not None:
            cb.pool.check()
            cb.draft_pool.check()
            if cb.pool.in_use or cb.draft_pool.in_use:
                fail(f"spec_trunc {layout}: pages left in use")
        streams[layout] = [(cb.done_requests[r].out,
                            cb.done_requests[r].out_logp) for r in rids]
        trunc[layout] = {"spec": cb.spec_stats(),
                         "counts_histogram": dict(sorted(hist.items())),
                         "rounds_checked": SPEC_EAGER_ROUNDS,
                         "counts_checked": checked,
                         "pool_bytes": cb.graph.pool_bytes,
                         "kv_reserved_bytes": cb.kv_stats()["reserved_bytes"]}
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    if streams["paged"] != streams["dense"]:
        bad = next(i for i, (a, b) in enumerate(zip(streams["paged"],
                                                    streams["dense"]))
                   if a != b)
        fail(f"spec_trunc: request {bad}'s paged stream differs from the "
             "dense one")
    emit({"phase": 4, "run": "spec_trunc", "draft_layers": TRUNC_LAYERS,
          "requests": len(streams["dense"]), "paged_equals_dense": True,
          "replay_equals_eager": True, **trunc})
    out["spec_trunc"] = trunc

    # the f32 self-draft: the target's first F32_LAYERS layers widened to
    # f32 (the CUDA cores): q and p differ by f32 rounding only
    cfg32, params32 = truncated_draft(cfg, params, F32_LAYERS)
    cfg32 = dataclasses.replace(cfg32, dtype=torch.float32)
    params32 = widened(torch, params32)  # copies of the 8 layers' views
    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256)
    f32 = {}
    for name in ("spec", "plain"):
        cb = (spec_mod.SpeculativeBatcher(params32, cfg32, params32, cfg32,
                                          gamma=SPEC_GAMMA, **kw)
              if name == "spec"
              else batching.ContinuousBatcher(params32, cfg32, **kw))
        rids = [cb.submit(p, b["max_new"]) for p, b in
                zip(rest, spec_bodies(cfg))]
        cb.run()
        f32[name] = [cb.done_requests[r].out for r in rids]
        if name == "spec":
            f32["stats"] = cb.spec_stats()
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    f32_ties = near_ties(
        "spec_f32", torch, generate, (cfg32, params32), rest, f32["spec"],
        f32["plain"], batcher_decider(
            torch, batching, spec_mod, cfg32, params32,
            [b["max_new"] for b in spec_bodies(cfg)]))
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    if f32["stats"]["acceptance_rate"] < SPEC_ACCEPT_MIN:
        fail(f"spec_f32: acceptance {f32['stats']['acceptance_rate']:.4f} < "
             f"{SPEC_ACCEPT_MIN} for an f32 self-draft: {f32['stats']}")
    row = {"phase": 4, "run": "spec_f32", "layers": F32_LAYERS,
           "spec": f32["stats"], "divergences_from_plain": f32_ties}
    emit(row)
    out["spec_f32"] = row

    # speculative_generate: batch 1, the self-draft
    prompt = spec_bodies(cfg)[1]["prompt"]
    ptensor = torch.tensor([prompt], device=params["embed"].device)
    t0 = time.perf_counter()
    toks, rounds = speculative.speculative_generate(
        params, cfg, params, cfg, ptensor, SPEC_GENERATE_NEW,
        gamma=SPEC_GAMMA)
    spec_s = time.perf_counter() - t0
    want = generate.generate(params, ptensor, cfg, SPEC_GENERATE_NEW)
    params32 = widened(torch, params)

    def decide(run, k, start, j):
        """generate's and speculative_generate's streams again, with the
        logits that picked their token ``j`` (``start``: the prompt)."""
        picked = []
        for module, again in (
                (generate, lambda: generate.generate(
                    params, ptensor, cfg, SPEC_GENERATE_NEW)),
                (speculative, lambda: speculative.speculative_generate(
                    params, cfg, params, cfg, ptensor, SPEC_GENERATE_NEW,
                    gamma=SPEC_GAMMA)[0])):
            with recording(torch, module, module is speculative) as calls:
                stream = again()[0].tolist()
            picked.append((stream, deciding_logits(run, calls,
                                                   len(start) + j - 1)))
        return picked

    ties = near_ties("speculative_generate", torch, generate,
                     (dataclasses.replace(cfg, dtype=torch.float32), params32),
                     [prompt], [toks[0].tolist()], [want[0].tolist()],
                     decide)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 4, "run": "speculative_generate", "prompt_tokens":
           len(prompt), "max_new": SPEC_GENERATE_NEW, "gamma": SPEC_GAMMA,
           "rounds": rounds, "rounds_if_all_accepted":
           -(-(SPEC_GENERATE_NEW - 1) // SPEC_GAMMA),
           "divergence_from_generate": ties[0], "wall_s": spec_s}
    emit(row)
    out["speculative_generate"] = row
    return out


# --- phase 4, scheduling and failure ------------------------------------------

# phase_preempt, at batcher level (Llama-3-8B, 8 slots x 2048, chunks of
# 256, the prefix cache on, the graph on): eight priority-2 requests fill
# the slots; after PREEMPT_AFTER steps, and PREEMPT_GAP steps later, a
# priority-0 request with a 1 ms deadline arrives, and the slo scheduler
# evicts the longest-running decode each time: request 0 (greedy), then
# request PREEMPT_SEEDED (seeded, temperature 0.8)
# (256 tokens out until the checkpoint phases took their time)
# 128 tokens a request until the tp phase took its time
PREEMPT_PROMPT, PREEMPT_MAX_NEW, PREEMPT_SLOTS = (190, 210), 96, 8
PREEMPT_AFTER, PREEMPT_GAP, PREEMPT_HI_NEW = 32, 8, 32
PREEMPT_SEEDED, PREEMPT_SEED, PREEMPT_TEMP = 1, 11, 0.8
PREEMPT_RUNS = {"preempt_dense": ("dense", 1), "preempt_paged": ("paged", 1),
                "preempt_dense_depth0": ("dense", 0),
                "preempt_paged_depth0": ("paged", 0)}
# the f32 twin (the target's first F32_LAYERS layers widened): the same
# two preemptions, the first after PREEMPT_F32_AFTER steps, 64 tokens a
# request; a resumed token's logprob comes from the finish chunk's
# forward, not a T = 1 decode: f32 rounding elsewhere, held to
# LOGP_F32_TOL
PREEMPT_F32_MAX_NEW, PREEMPT_F32_AFTER, LOGP_F32_TOL = 64, 16, 1e-3

# phase_supervisor, through the server: eight streamed requests
SUP_ARGS = ["--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
            "--chunkedPrefill", "256"]
SUP_PAGED = ["--kvLayout", "paged", "--kvPageSize", "64"]  # default pool
SUP_PROMPTS, SUP_MAX_NEW, SUP_N = (100, 600), (64, 96), 8
SUP_RUNS = {
    # the same requests with no fault: the streams every run is held to
    "sup_nofault": [],
    # one mid-decode crash, recovered in place
    "sup_crash_dense": ["--faults", "decode.apply:nth=40"],
    # three crashes at seeded decode steps: three restarts, no leak
    "sup_crash_paged": [*SUP_PAGED, "--faults",
                        "decode.apply:p=0.02:seed=5:times=3"],
    # injected pool pressure: admissions wait, nothing crashes (the
    # seeded schedule first fires on the 15th reservation: the requests
    # are served POOL_PRESSURE_BATCHES times, the prefix cache hitting
    # from the second)
    "sup_pool_pressure": [*SUP_PAGED, "--faults",
                          "pool.alloc:p=0.3:seed=3:times=6"],
    # a second crash past a budget of one: the engine dies
    "sup_budget": ["--restartBudget", "1", "--faults",
                   "decode.apply:nth=20:times=2"],
}
SUP_RESUME_AT = 10        # HTTP resume: the first 10 tokens come back in
POOL_PRESSURE_BATCHES = 3
OVERLOAD_QUEUE, OVERLOAD_BURST = 2, 24

# phase_arrivals: an open-loop schedule through the server, fifo and slo
# (48 requests until the checkpoint phases took their time)
# 32 requests of up to 128 tokens until the tp phase took its time; up
# to 96 until the device phase took its time
ARRIVAL_N, ARRIVAL_PROMPTS, ARRIVAL_MAX_NEW = 16, (64, 512), (32, 64)
ARRIVAL_HI_SHARE, ARRIVAL_DEADLINE_MS, ARRIVAL_LOAD = 0.2, 1500, 1.2


@contextlib.contextmanager
def recording_picks(torch, module):
    """Record every forward through ``module._forward_cached`` that yields
    one logits row per sequence: decode steps (T = 1), prefill finish
    chunks (the row at ``select_pos``) and whole prefills (``last_only``:
    the last row). Yields the list of (each row's position, f32 logits
    (B, V)) the calls append to."""
    orig = module._forward_cached
    calls = []

    def wrapped(params, tokens, cache, length, cfg, **kw):
        out = orig(params, tokens, cache, length, cfg, **kw)
        if out.shape[1] == 1:
            t = tokens.shape[1]
            off = 0 if t == 1 else t - 1 if kw.get("last_only") else \
                kw.get("select_pos", 0)
            pos = torch.as_tensor(length).reshape(-1).expand(
                tokens.shape[0]) + off
            calls.append((pos.tolist(), out[:, 0].float().clone()))
        return out

    module._forward_cached = wrapped
    try:
        yield calls
    finally:
        module._forward_cached = orig


def resume_decider(torch, batching, cfg, params, streams: list,
                   folds: list, kws: "list | None" = None):
    """``decide`` for near_ties over streams that resumed: stream ``k``
    alone in slot 0 of an eager batcher (eight slots, 2048 rows, chunks of
    256), uninterrupted, and resumed at its last fold at or before token
    ``j`` (``folds[k]``: the emission counts its preemptions or restarts
    folded into the prompt, 0 first) through ``resume_out``, which is the
    same fold; each rerun stops after token ``j`` (its budget is j + 1:
    greedy tokens do not depend on it). Returns both reruns' tokens and
    the logits their token ``j`` was picked from (a decode, or the
    resumed admission's finish chunk). ``kws[k]`` are stream ``k``'s
    submit arguments (its sampler and seed)."""
    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
              decode_graph=False, pipeline_depth=0)

    def decide(run: str, k: int, prompt: list, j: int) -> tuple:
        n = max(f for f in folds[k] if f <= j)
        out = []
        for resume in ([], streams[k][:n]):
            cb = batching.ContinuousBatcher(params, cfg, **kw)
            with recording_picks(torch, batching) as calls:
                rid = cb.submit(prompt, j + 1, resume_out=resume,
                                **(kws[k] if kws else {}))
                cb.run()
            pos = len(prompt) + j - 1
            logits = next((lg[0] for p, lg in reversed(calls) if p[0] == pos),
                          None)
            if logits is None:
                fail(f"{run}: no recorded forward picked stream {k}'s token "
                     f"{j}")
            out.append((cb.done_requests[rid].out, logits))
            del cb, calls
            gc.collect()
            torch.cuda.empty_cache()
        return out

    return decide


class LazyTruth:
    """The near-tie judge's f32 weights (32 GB for Llama-3-8B), widened
    only when a stream diverges and freed by :meth:`free`."""

    def __init__(self, torch, cfg, params):
        self.torch, self.cfg, self.params = torch, cfg, params
        self.pair = None

    def __call__(self) -> tuple:
        if self.pair is None:
            self.pair = (dataclasses.replace(self.cfg,
                                             dtype=self.torch.float32),
                         widened(self.torch, self.params))
        return self.pair

    def free(self) -> None:
        self.pair = None
        gc.collect()
        self.torch.cuda.empty_cache()


def judge_resumed(run: str, torch, generate, truth: LazyTruth,
                  prompts: list, got: list, want: list, decide,
                  score=None) -> list:
    """near_ties over streams that resumed (``got``) against their
    uninterrupted runs (``want``); the f32 judge is built only if one
    diverges."""
    if all(first_divergence(g, w) is None for g, w in zip(got, want)):
        return [None] * len(got)
    return near_ties(run, torch, generate, truth(), prompts, got, want,
                     decide, score=score)


def preempt_bodies(cfg, n_hi: int = 2) -> tuple:
    """The eight priority-2 prompts (request PREEMPT_SEEDED seeded and
    sampled) and the priority-0 ones."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    lows = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(*PREEMPT_PROMPT, PREEMPT_SLOTS)]
    his = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
           for n in rng.integers(*PREEMPT_PROMPT, n_hi)]
    return lows, his


def seeded_kw(sampling) -> dict:
    """The seeded victim's submit arguments."""
    return {"sampler": sampling.Sampler(temperature=PREEMPT_TEMP),
            "seed": PREEMPT_SEED}


def seeded_score(torch, sampling):
    """What the seeded victim's pick maximizes at its token ``j``: the
    logits over the temperature plus the seed's counter noise at draw
    ``j`` (no top-k, top-p or penalty)."""
    def score(logits, j):
        dev = logits.device
        noise = sampling.counter_gumbel(
            torch.tensor([PREEMPT_SEED], device=dev),
            torch.tensor([j], device=dev), logits.shape[-1])[0]
        return logits.float() / PREEMPT_TEMP + noise

    return score


def preempt_run(torch, batching, sampling, sched_mod, prefix_cache_mod,
                kernel_support, rpa, cfg, params, run: str, layout: str,
                depth: int, policy: str, max_new: int, arrivals: tuple,
                n_hi: int) -> dict:
    """One batcher run of phase_preempt: the low requests at once, the
    high ones after ``arrivals`` steps each; every decode step a graph
    replay and every K1 launch counted (decode launches split, the rest
    prefill chunks: the first prefills and the re-prefills)."""
    kw = dict(n_slots=PREEMPT_SLOTS, max_len=2048, chunked_prefill=256,
              pipeline_depth=depth)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_page_size=64)
    buckets = tuple(b for b in batching.DEFAULT_PROMPT_BUCKETS if b <= 2048)
    sched = sched_mod.make_scheduler(policy)
    cb = batching.ContinuousBatcher(
        params, cfg, scheduler=sched, prefix_cache=prefix_cache_mod.PrefixCache(
            cfg, buckets=buckets, budget_bytes=256 << 20), **kw)
    if cb.graph is None:
        fail(f"{run}: the batcher on the card must capture its decode step")
    lows, his = preempt_bodies(cfg, n_hi)
    kernel_support.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [cb.submit(p, max_new, tenant="bronze", priority=2,
                      **(seeded_kw(sampling) if i == PREEMPT_SEEDED else {}))
            for i, p in enumerate(lows)]
    for wait, hi in zip(arrivals, his):
        for _ in range(wait):
            cb.step()
        rids.append(cb.submit(hi, PREEMPT_HI_NEW, tenant="gold", priority=0,
                              deadline_ms=1))
    cb.run()
    wall = time.perf_counter() - t0
    reqs = [cb.done_requests[r] for r in rids]
    for i, req in enumerate(reqs):
        want = max_new if i < len(lows) else PREEMPT_HI_NEW
        if len(req.out) != want:
            fail(f"{run}: request {i} delivered {len(req.out)} of {want}")
    counts = kernel_support.launch_counts()
    total, split = counts.get(rpa.NAME, 0), counts.get(rpa.SPLIT_KEY, 0)
    engines = {e: counts.get(kernel_support.engine_key(rpa.NAME, e), 0)
               for e in kernel_support.ENGINES}
    dtype = str(cfg.dtype).replace("torch.", "")
    # bf16 decode launches split their spans (f32 ones never split)
    engine = "tensor_cores" if dtype == "bfloat16" else "cuda_cores"
    decode = cfg.n_layers * cb.decode_steps
    if (split != (decode if engine == "tensor_cores" else 0)
            or total - decode != cfg.n_layers * cb.prefill_chunks
            or engines[engine] != total
            or cb.graph.replays != cb.decode_steps):
        fail(f"{run}: K1 launches {total} ({split} split, per engine "
             f"{engines}), graph replays {cb.graph.replays}: the run needs "
             f"{cfg.n_layers} x {cb.decode_steps} decode launches (split "
             f"in bf16) and {cfg.n_layers} x {cb.prefill_chunks} chunk "
             f"launches, all on the {engine}, every step a replay")
    if cb.pool is not None:
        while cb.prefix_cache.evict_one():
            pass
        if cb.pool.in_use:
            fail(f"{run}: pages still in use: {cb.kv_stats()}")
        cb.pool.check()
    out = {"run": run, "layout": layout, "pipeline_depth": depth,
           "policy": policy, "dtype": dtype, "wall_s": wall,
           "decode_steps": cb.decode_steps,
           "prefill_chunks": cb.prefill_chunks,
           "chunk_launches": total - decode, "decode_launches": decode,
           "pipeline_flushes": cb.pipeline_flushes,
           "preemptions": sched.preemptions,
           "victims": [i for i, r in enumerate(reqs) if r.preemptions],
           "folds": [[0] + ([r.prefilled_out] if r.preemptions else [])
                     for r in reqs],
           "tokens": [r.out for r in reqs],
           "logprobs": [r.out_logp for r in reqs],
           "prompts": lows + his[:len(arrivals)],
           "cached_tokens": [r.cached_tokens for r in reqs]}
    del cb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_preempt(torch, batching, sampling, sched_mod, prefix_cache_mod,
                  kernel_support, rpa, generate, cfg, params) -> dict:
    """Preemption at batcher level. The slo runs (dense and paged, depth 1
    and 0) must preempt exactly twice, request 0 then PREEMPT_SEEDED,
    deliver every budget, count the re-prefill as K1 chunk launches (one
    a layer a chunk beyond the fifo run's) and equal each other bit for
    bit. Against the fifo run (no preemption: the uninterrupted streams)
    every stream that was not preempted is equal bit for bit, and each
    victim's tokens are equal or first diverge at a near tie (near_ties
    over reruns of the resume; the seeded victim's judged on what its
    pick maximizes, the logits over the temperature plus its counter
    noise). The f32 twin (8 layers widened, the same two preemptions):
    every stream's tokens equal, the seeded victim's included, and
    logprobs within LOGP_F32_TOL."""
    args = (torch, batching, sampling, sched_mod, prefix_cache_mod,
            kernel_support, rpa)
    arrivals = (PREEMPT_AFTER, PREEMPT_GAP)
    runs = {run: preempt_run(*args, cfg, params, run, layout, depth, "slo",
                             PREEMPT_MAX_NEW, arrivals, 2)
            for run, (layout, depth) in PREEMPT_RUNS.items()}
    fifo = preempt_run(*args, cfg, params, "preempt_fifo", "dense", 1, "fifo",
                       PREEMPT_MAX_NEW, arrivals, 2)
    first = runs["preempt_dense"]
    for run, r in runs.items():
        if r["preemptions"] != 2 or r["victims"] != [0, PREEMPT_SEEDED]:
            fail(f"{run}: {r['preemptions']} preemptions of requests "
                 f"{r['victims']}, wanted 2 of [0, {PREEMPT_SEEDED}]")
        if r["prefill_chunks"] - fifo["prefill_chunks"] < r["preemptions"]:
            fail(f"{run}: {r['prefill_chunks']} prefill chunks against the "
                 f"fifo run's {fifo['prefill_chunks']}: no re-prefill")
        if r["tokens"] != first["tokens"] or \
                r["logprobs"] != first["logprobs"]:
            fail(f"{run}: the streams differ from preempt_dense's")
    if fifo["preemptions"]:
        fail(f"preempt_fifo: the fifo policy preempted {fifo['preemptions']}")
    victims = set(first["victims"])
    for i, (g, w) in enumerate(zip(first["tokens"], fifo["tokens"])):
        if i not in victims and (g != w or first["logprobs"][i]
                                 != fifo["logprobs"][i]):
            fail(f"preempt: request {i}, never preempted, differs from its "
                 "fifo stream")
    truth = LazyTruth(torch, cfg, params)
    ties = {}
    for i, kw, score in ((0, {}, None),
                         (PREEMPT_SEEDED, seeded_kw(sampling),
                          seeded_score(torch, sampling))):
        ties[i] = judge_resumed(
            f"preempt request {i}", torch, generate, truth,
            [first["prompts"][i]], [first["tokens"][i]], [fifo["tokens"][i]],
            resume_decider(torch, batching, cfg, params,
                           [first["tokens"][i]], [first["folds"][i]], [kw]),
            score=score)[0]
    truth.free()

    # the f32 twin: one preemption, tokens equal, logprobs within tolerance
    cfg32, params32 = truncated_draft(cfg, params, F32_LAYERS)
    cfg32 = dataclasses.replace(cfg32, dtype=torch.float32)
    params32 = widened(torch, params32)
    arrivals32 = (PREEMPT_F32_AFTER, PREEMPT_GAP)
    f32 = preempt_run(*args, cfg32, params32, "preempt_f32", "dense", 1,
                      "slo", PREEMPT_F32_MAX_NEW, arrivals32, 2)
    f32_fifo = preempt_run(*args, cfg32, params32, "preempt_f32_fifo",
                           "dense", 1, "fifo", PREEMPT_F32_MAX_NEW,
                           arrivals32, 2)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    if f32["victims"] != [0, PREEMPT_SEEDED] or \
            f32["tokens"] != f32_fifo["tokens"]:
        fail(f"preempt_f32: victims {f32['victims']}; the streams must equal "
             "the uninterrupted f32 ones")
    logp_err = max(abs(a - b) for g, w in zip(f32["logprobs"],
                                              f32_fifo["logprobs"])
                   for a, b in zip(g, w))
    if logp_err > LOGP_F32_TOL:
        fail(f"preempt_f32: logprobs differ by {logp_err} (> {LOGP_F32_TOL})")
    keys = ("wall_s", "decode_steps", "prefill_chunks", "chunk_launches",
            "decode_launches", "pipeline_flushes", "preemptions", "victims",
            "folds")
    row = {"phase": 4, "run": "preempt",
           "runs": {r["run"]: {k: r[k] for k in keys}
                    for r in (*runs.values(), fifo, f32, f32_fifo)},
           "equal_bitwise": list(PREEMPT_RUNS),
           "reprefill_chunks": first["prefill_chunks"] - fifo["prefill_chunks"],
           "victim_cached_tokens": [first["cached_tokens"][i]
                                    for i in sorted(victims)],
           "victim_divergences": {"greedy": ties[0],
                                  "seeded": ties[PREEMPT_SEEDED]},
           "f32_tokens_equal": True, "f32_logprob_max_err": logp_err}
    emit(row)
    return {**row, "launches": sum(r["chunk_launches"] + r["decode_launches"]
                                   for r in (*runs.values(), fifo))}


def sup_bodies(cfg) -> list[dict]:
    """phase_supervisor's eight streamed requests, with logprobs."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    return [{"prompt": rng.integers(0, cfg.vocab_size, int(n)).tolist(),
             "max_new": int(m), "stream": True, "logprobs": True}
            for n, m in zip(rng.integers(*SUP_PROMPTS, SUP_N),
                            rng.integers(*SUP_MAX_NEW, SUP_N))]


def read_frames(url: str, body: dict) -> dict:
    """One streamed /v1/generate read to its end, an error frame
    included: {"tokens", "error" (the frame's error object or None),
    "done" (the done event or None)}."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    toks, error, done = [], None, None
    with urllib.request.urlopen(req, timeout=900) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if "error" in evt:
                error = evt["error"]
                break
            if evt.get("done"):
                done = evt
                break
            toks.append(evt["token"])
    return {"tokens": toks, "error": error, "done": done}


def get_health(url: str) -> tuple[int, dict]:
    import urllib.error

    try:
        with urllib.request.urlopen(url + "/v1/health", timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def watch_recoveries(server) -> list:
    """Wrap the engine supervisor's ``recover`` to log, for each crash, its
    time (``time.perf_counter``) and each live request's fold point (the
    tokens it had emitted), keyed by its prompt as submitted."""
    sup = server.engine.supervisor
    orig = sup.recover
    log = []

    def recover(engine):
        cb = engine.cb
        live = (*cb.pending, *cb.prefilling.values(), *cb.running.values())
        log.append({"t": time.perf_counter(), "folds": {
            tuple(r.prompt[:len(r.prompt) - r.prefilled_out]):
                min(len(r.out), len(r.out_logp)) for r in live}})
        orig(engine)

    sup.recover = recover
    return log


def phase_supervisor(torch, server_mod, batching, generate, cfg,
                     params) -> dict:
    """Crash recovery, fault injection, overload and the resume seam
    through the server (Llama-3-8B, 8 slots x 2048, the prefix cache on,
    the graph on). sup_crash_dense (one mid-decode crash) and
    sup_crash_paged (three): every stream completes with no error frame,
    the supervisor counts the restarts and resumes, the new batcher's
    decode steps are graph replays, and once the prefix cache is drained
    ``memory_allocated`` is within the graph pool's bytes of its value
    before the first crash; tokens equal sup_nofault's or first diverge at
    a near tie. sup_pool_pressure: admissions wait, nothing is refused,
    the streams are sup_nofault's bit for bit. sup_budget: the second
    crash past a budget of one ends every stream with an ``engine_dead``
    frame and health reads dead. Then a burst past ``--maxQueue 2``
    answers 429 with Retry-After, and ``resume_out`` continues two
    streams from token SUP_RESUME_AT."""
    bodies = sup_bodies(cfg)
    prompts = [b["prompt"] for b in bodies]
    out, ties = {}, {}
    truth = LazyTruth(torch, cfg, params)
    for run, flags in SUP_RUNS.items():
        args, server, url = start_server(server_mod, [*SUP_ARGS, *flags],
                                         params)
        try:
            cb0 = server.engine.cb
            pool_bytes = cb0.graph.pool_bytes
            del cb0
            mem0 = torch.cuda.memory_allocated()
            recoveries = watch_recoveries(server)
            row = {"phase": 4, "run": run, "flags": flags}
            t0 = time.perf_counter()
            if run == "sup_budget":
                results = [None] * len(bodies)

                def worker(i):
                    results[i] = read_frames(url, bodies[i])

                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(len(bodies))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(900)
                status, health = get_health(url)
                codes = [r and r["error"] and r["error"]["code"]
                         for r in results]
                if codes != ["engine_dead"] * len(bodies) or status != 503 \
                        or health["alive"] or \
                        health["supervisor"]["state"] != "dead":
                    fail(f"{run}: error codes {codes}, health {status} "
                         f"{health.get('supervisor')}: past the budget every "
                         "stream ends with engine_dead and health reads dead")
                row.update(error_codes=codes, health_status=status,
                           supervisor=health["supervisor"],
                           tokens_before_death=[len(r["tokens"])
                                                for r in results])
                emit(row)
                out[run] = row
                continue
            batches = [post_all(url, bodies, run) for _ in range(
                POOL_PRESSURE_BATCHES if run == "sup_pool_pressure" else 1)]
            results = batches[0]
            row["wall_s"] = time.perf_counter() - t0
            status, health = get_health(url)
            sup = health["supervisor"]
            for res, b in zip(results, bodies):
                if len(res["tokens"]) != b["max_new"]:
                    fail(f"{run}: a stream came back with "
                         f"{len(res['tokens'])} of {b['max_new']} tokens")
            want_restarts = {"sup_crash_dense": 1,
                             "sup_crash_paged": 3}.get(run, 0)
            if (sup["restarts_total"] != want_restarts
                    or sup["crashes_total"] != want_restarts
                    or sup["state"] != "ok" or status != 200
                    or (want_restarts and sup["resumed_total"] < 1)):
                fail(f"{run}: supervisor {sup} (health {status}): wanted "
                     f"{want_restarts} restarts, requests resumed, state ok")
            cb = server.engine.cb
            if cb.graph is None or cb.graph.replays != cb.decode_steps:
                fail(f"{run}: after recovery {cb.decode_steps} decode steps, "
                     f"graph {cb.graph and cb.graph.stats()}: every step a "
                     "replay")
            drain_prefix_cache(server)
            mem1 = torch.cuda.memory_allocated()
            if abs(mem1 - mem0) > pool_bytes:
                fail(f"{run}: memory_allocated {mem0} before, {mem1} after "
                     f"the drain: more than the graph pool ({pool_bytes}) "
                     "apart")
            row.update(supervisor=sup, sched=health["sched"],
                       memory_allocated_before=mem0,
                       memory_allocated_after=mem1,
                       graph_pool_bytes=pool_bytes,
                       kv_admission_rejected=health["kv"]
                       ["admission_rejected"],
                       decode_steps_new_batcher=cb.decode_steps,
                       graph_replays_new_batcher=cb.graph.replays)
            tokens = [r["tokens"] for r in results]
            if run == "sup_nofault":
                out[run] = {"tokens": tokens,
                            "logprobs": [r["logprobs"] for r in results]}
                resumed = []
                for k in range(2):
                    body = {"prompt": prompts[k], "max_new":
                            bodies[k]["max_new"], "logprobs": True,
                            "resume_out": tokens[k][:SUP_RESUME_AT],
                            "resume_logprobs":
                                results[k]["logprobs"][:SUP_RESUME_AT]}
                    got = _post(url, body)["tokens"]
                    resumed.append(tokens[k][:SUP_RESUME_AT] + got)
                ties["sup_http_resume"] = judge_resumed(
                    "sup_http_resume", torch, generate, truth, prompts[:2],
                    resumed, tokens[:2], resume_decider(
                        torch, batching, cfg, params, resumed,
                        [[0, SUP_RESUME_AT]] * 2))
                row["http_resume_divergences"] = ties["sup_http_resume"]
            elif run == "sup_pool_pressure":
                want = out["sup_nofault"]
                for batch in batches:
                    if [r["tokens"] for r in batch] != want["tokens"] or \
                            [r["logprobs"] for r in batch] != \
                            want["logprobs"]:
                        fail(f"{run}: the streams differ from sup_nofault's")
                if health["kv"]["admission_rejected"]["pool_pressure"] < 1:
                    fail(f"{run}: no admission waited: {health['kv']}")
                row["batches"] = len(batches)
                row["cached_tokens"] = [r["cached_tokens"]
                                        for r in batches[-1]]
            else:
                folds = [[0] + [e["folds"][tuple(p)] for e in recoveries
                                if tuple(p) in e["folds"]] for p in prompts]
                ties[run] = judge_resumed(
                    run, torch, generate, truth, prompts, tokens,
                    out["sup_nofault"]["tokens"], resume_decider(
                        torch, batching, cfg, params, tokens, folds))
                # the recovery's wall: crash -> the next token any stream
                # received
                arrivals = sorted(t for r in results for t in r["token_times"])
                row["recovery_s"] = [
                    next((t for t in arrivals if t > e["t"]), math.inf) - e["t"]
                    for e in recoveries]
                row["folds"] = folds
                row["divergences_from_nofault"] = ties[run]
            emit(row)
            out[run] = {**row, **out.get(run, {})}
        finally:
            server.stop()
            # the next run's "before" must not count this run's batcher
            cb = None
        gc.collect()
        torch.cuda.empty_cache()
    truth.free()

    # overload: a burst past --maxQueue answers 429 with Retry-After
    import urllib.error

    args, server, url = start_server(
        server_mod, [*SUP_ARGS, "--maxQueue", str(OVERLOAD_QUEUE)], params)
    try:
        codes, retry = [], []

        def burst(i):
            req = urllib.request.Request(
                url + "/v1/generate", data=json.dumps(
                    {"prompt": prompts[i % SUP_N][:64], "max_new": 16}
                ).encode(), headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    resp.read()
                    codes.append(resp.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                body = json.loads(e.read())
                retry.append((e.headers.get("Retry-After"), body))

        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(OVERLOAD_BURST)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        status, health = get_health(url)
        if 429 not in codes or not all(
                h is not None and int(h) == b["retry_after"] >= 1
                and b["reason"] == "queue_full" for h, b in retry) \
                or set(codes) - {200, 429}:
            fail(f"overload: codes {sorted(codes)}, 429 bodies {retry}")
        out["overload"] = {"phase": 4, "run": "overload",
                           "max_queue": OVERLOAD_QUEUE,
                           "burst": OVERLOAD_BURST,
                           "answered_200": codes.count(200),
                           "answered_429": codes.count(429),
                           "retry_after": sorted({int(h) for h, _ in retry}),
                           "rejections": health["sched"]["rejections"]}
        emit(out["overload"])
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def arrival_bodies(cfg) -> list[dict]:
    """phase_arrivals' requests: ARRIVAL_HI_SHARE priority 0 with a
    deadline, the rest priority 2; streamed (TTFT)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    bodies = []
    for _ in range(ARRIVAL_N):
        hi = rng.random() < ARRIVAL_HI_SHARE
        body = {"prompt": rng.integers(0, cfg.vocab_size, int(
                    rng.integers(*ARRIVAL_PROMPTS))).tolist(),
                "max_new": int(rng.integers(*ARRIVAL_MAX_NEW)),
                "stream": True, "priority": 0 if hi else 2}
        if hi:
            body["deadline_ms"] = ARRIVAL_DEADLINE_MS
        bodies.append(body)
    return bodies


def percentile(xs: list, q: float) -> "float | None":
    import numpy as np

    return float(np.percentile(xs, q)) if xs else None


def phase_arrivals(torch, server_mod, cfg, params, recovery: dict) -> dict:
    """Latency under an arrival schedule (reported, not held to a limit):
    the requests at once on the fifo server give the closed-loop request
    rate at 8 slots; then Poisson arrivals at ARRIVAL_LOAD times that rate
    (seeded), under --schedPolicy fifo and slo: TTFT p50/p99 per class,
    the share of deadlines met, preemptions, re-prefill chunks per
    preemption; beside them phase_supervisor's recovery seconds."""
    import numpy as np

    bodies = arrival_bodies(cfg)
    out = {}
    for run in ("closed_fifo", "open_fifo", "open_slo"):
        policy = run.split("_")[1]
        args, server, url = start_server(
            server_mod, [*SUP_ARGS, "--schedPolicy", policy], params)
        try:
            if run == "closed_fifo":
                offsets = [0.0] * len(bodies)
            else:
                rate = ARRIVAL_LOAD * out["closed_fifo"]["requests_per_s"]
                offsets = np.cumsum(np.random.default_rng(SEED + 10)
                                    .exponential(1 / rate, len(bodies)))
            results = [None] * len(bodies)
            t0 = time.perf_counter()

            def worker(i):
                time.sleep(max(0.0, t0 + offsets[i] - time.perf_counter()))
                start = time.perf_counter()
                res = _post(url, bodies[i])
                results[i] = {**res, "latency": time.perf_counter() - start}

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(bodies))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t0
            if any(r is None or len(r["tokens"]) != b["max_new"]
                   for r, b in zip(results, bodies)):
                fail(f"arrivals {run}: a request failed or came back short")
            _, health = get_health(url)
            by_class = {}
            for cls in (0, 2):
                mine = [r for r, b in zip(results, bodies)
                        if b["priority"] == cls]
                ttft = [r["ttft"] for r in mine]
                by_class[cls] = {"n": len(mine),
                                 "ttft_s_p50": percentile(ttft, 50),
                                 "ttft_s_p99": percentile(ttft, 99),
                                 "latency_s_p50": percentile(
                                     [r["latency"] for r in mine], 50)}
            # the server's own view: every retired request's timeline
            # (TTFT at its cursor; queue wait, prefill, decode)
            recs = get_json(url, "/debug/requests")["requests"]
            timelines = {}
            for cls in (0, 2):
                mine = [r for r in recs if r["priority"] == cls]
                ttft = [r["ttft_s"] for r in mine if r["ttft_s"] is not None]
                timelines[cls] = {
                    "n": len(mine), "ttft_s_p50": percentile(ttft, 50),
                    "ttft_s_p99": percentile(ttft, 99),
                    **{f"{p}_s_{q}": percentile(
                        [r["phases"].get(p, 0.0) for r in mine], q)
                       for p in ("queue_wait", "prefill", "decode")
                       for q in (50, 99)}}
            if sum(t["n"] for t in timelines.values()) != len(bodies):
                fail(f"arrivals {run}: {len(recs)} timelines for "
                     f"{len(bodies)} requests")
            hi = [r for r, b in zip(results, bodies) if b["priority"] == 0]
            met = sum(r["latency"] <= ARRIVAL_DEADLINE_MS / 1e3 for r in hi)
            pre = health["sched"]["preemptions"]
            out[run] = {"phase": 4, "run": f"arrivals_{run}", "policy": policy,
                        "requests": len(bodies), "wall_s": wall,
                        "requests_per_s": len(bodies) / wall,
                        "offered_requests_per_s": (
                            None if run == "closed_fifo"
                            else len(bodies) / float(offsets[-1])),
                        "ttft_by_priority": by_class,
                        "timeline_by_priority": timelines,
                        "deadlines_met_share": met / len(hi) if hi else None,
                        "preemptions": pre,
                        "prefill_chunks": health["prefill_chunks"],
                        "decode_step_ms_mean": health["decode_step_ms_mean"],
                        "tokens": [r["tokens"] for r in results]}
        finally:
            server.stop()
        gc.collect()
        torch.cuda.empty_cache()
    slo, fifo = out["open_slo"], out["open_fifo"]
    reprefill = slo["prefill_chunks"] - fifo["prefill_chunks"]
    summary = {"phase": 4, "run": "arrivals",
               "load": ARRIVAL_LOAD, "deadline_ms": ARRIVAL_DEADLINE_MS,
               "reprefill_chunks_per_preemption": (
                   reprefill / slo["preemptions"] if slo["preemptions"]
                   else None),
               "streams_equal_fifo_slo": sum(
                   a == b for a, b in zip(slo["tokens"], fifo["tokens"])),
               "recovery_s": recovery}
    for run in out.values():
        run.pop("tokens")
        emit(run)
    emit(summary)
    return {**out, "summary": summary}


# --- phase 4, observability --------------------------------------------------

# phase_obs: the six requests of REQUESTS through the server, dense and
# paged, at depth 1 and 0, each with attribution off, on (the default),
# and on with --tracing --traceSteps (and a flight-recorder threshold of
# 1 ms, so that every request is captured)
OBS_BASE = ["--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
            "--chunkedPrefill", "256"]
OBS_LAYOUTS = {"dense": [], "paged": POOL_65}
OBS_MODES = {"off": ["--attributionOff"], "on": [],
             "traced": ["--tracing", "--traceSteps", "--slowRequestMs", "1"]}
OBS_TIMELINE_TOL = 5e-5   # a timeline's segments against its total_s
OBS_POLL_S = 0.05         # /v1/health polled for the live roofline
# the live roofline's window in these runs (the server's is 1 s): the six
# requests take about a second and a half, so a 1 s window would close
# once or not at all
OBS_MFU_WINDOW_S = 0.25
# the hooks' host cost, timed in a loop of this many 8-slot steps
OBS_HOOK_STEPS = 20000

_EXPO_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_EXPO_LABELS = r'\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*",?)*\}'
_EXPO_NUM = r"(?:[-+]?(?:[0-9.]+(?:e[-+]?[0-9]+)?|Inf)|NaN)"


def exposition_errors(text: str, openmetrics: bool) -> list[str]:
    """Lines of a /metrics body that are not well-formed Prometheus text
    (classic 0.0.4, or OpenMetrics with exemplars and ``# EOF`` last):
    HELP and TYPE before a family's samples, every sample line a name,
    optional labels and a number."""
    import re

    sample = re.compile(
        rf"^{_EXPO_NAME}(?:{_EXPO_LABELS})? {_EXPO_NUM}"
        + (rf"(?: # {_EXPO_LABELS} {_EXPO_NUM}(?: {_EXPO_NUM})?)?$"
           if openmetrics else "$"))
    meta = re.compile(rf"^# (?:HELP {_EXPO_NAME} .*|TYPE {_EXPO_NAME} "
                      r"(?:counter|gauge|histogram))$")
    lines = text.rstrip("\n").split("\n")
    errors = []
    if openmetrics:
        if lines[-1] != "# EOF":
            errors.append("no '# EOF' last")
        lines = lines[:-1]
    for line in lines:
        if not (meta.match(line) or sample.match(line)):
            errors.append(line[:160])
    return errors


def get_json(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


def scrape(url: str, openmetrics: bool, path: str = "/metrics") -> str:
    req = urllib.request.Request(url + path, headers={
        "Accept": "application/openmetrics-text; version=1.0.0"}
        if openmetrics else {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


class HealthPoller:
    """Polls /v1/health's ``mfu`` every OBS_POLL_S on a thread of its own
    while the requests run: the live shares close a window each busy
    second and read 0 once the engine idles."""

    def __init__(self, url: str):
        self.url = url
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(OBS_POLL_S):
            mfu = get_health(self.url)[1].get("mfu")
            if mfu is not None:
                self.samples.append(mfu)

    def __enter__(self) -> "HealthPoller":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(30)


def obs_run(torch, server_mod, kernel_support, rpa, cfg, params, layout: str,
            depth: int, mode: str, bodies: list) -> dict:
    """One server of phase_obs: the six requests at once, K1's launches
    counted for exactly this run, the timelines, the scrape, the live
    roofline and (traced) a trace and a flight-recorder entry."""
    run = f"obs_{layout}_depth{depth}_{mode}"
    flags = [*OBS_BASE, *OBS_LAYOUTS[layout], "--pipelineDepth", str(depth),
             *OBS_MODES[mode]]
    args, server, url = start_server(server_mod, flags, params)
    route = rpa.route_name(args.kvLayout == "paged", args.cacheQuant)
    try:
        cb = server.engine.cb
        if cb.graph is None:
            fail(f"{run}: the decode step must be a CUDA graph replay")
        if (cb.attribution is None) != (mode == "off"):
            fail(f"{run}: attribution {cb.attribution} with mode {mode}")
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        # the process's trace ring holds this run's traces only (the step
        # spans of --traceSteps are two root traces a step)
        server_mod.get_tracer().clear()
        if cb.mfu is not None:
            # the first window opens with the requests, not at the
            # server's construction (the engine is idle here)
            cb.mfu.window_s = OBS_MFU_WINDOW_S
            cb.mfu.on_idle()
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        with HealthPoller(url) as poller:
            results = post_all(url, bodies, run)
        wall = time.perf_counter() - t0
        health = server.engine.stats()
        decode_steps = health["decode_steps"] - steps0
        launched = route_launches(run, kernel_support, rpa, route,
                                  cfg.n_layers, decode_steps,
                                  health["prefill_chunks"] - chunks0)
        row = {"phase": 4, "run": run, "flags": flags, "wall_s": wall,
               **launched, "decode_steps": decode_steps,
               "decode_step_ms_mean": health["decode_step_ms_mean"],
               "ttft_s_p50": health["ttft_s_p50"]}
        classic, om = scrape(url, False), scrape(url, True)
        for name, text, is_om in (("classic", classic, False),
                                  ("openmetrics", om, True)):
            bad = exposition_errors(text, is_om)
            if bad:
                fail(f"{run}: malformed {name} /metrics lines: {bad[:5]}")
        row["scrape_bytes"] = {"classic": len(classic), "openmetrics": len(om)}
        if mode != "off":
            if "# {trace_id=" not in om:
                fail(f"{run}: no exemplar in the OpenMetrics scrape")
            recs = get_json(url, "/debug/requests")["requests"]
            if len(recs) != len(bodies):
                fail(f"{run}: {len(recs)} timelines for {len(bodies)} "
                     "requests")
            worst = 0.0
            for rec in recs:
                seg = sum(d for _, _, d in rec["segments"])
                ph = sum(rec["phases"].values())
                worst = max(worst, abs(seg - rec["total_s"]),
                            abs(ph - rec["total_s"]))
            if worst > OBS_TIMELINE_TOL:
                fail(f"{run}: a timeline misses its wall time by {worst} s")
            # each closed window once (the poll reads one several times)
            busy = list({(m["serving_mfu_pct"], m["hbm_bw_util_pct"],
                          m["window_tokens_per_second"]): m
                         for m in poller.samples
                         if m["window_tokens_per_second"] > 0}.values())
            if not busy:
                fail(f"{run}: no busy MFU window in {len(poller.samples)} "
                     "health samples")
            for m in busy:
                for key in ("serving_mfu_pct", "hbm_bw_util_pct"):
                    if not 0 < m[key] <= 100:
                        fail(f"{run}: {key} read {m[key]} (outside (0, 100])")
            final = health["mfu"]
            # the decode steps' own average: the bytes the cost model
            # priced for them over the host wall of the decode part
            decode_s = health["decode_step_ms_mean"] * decode_steps / 1e3
            row["decode_bw_pct"] = (100.0 * final["hbm_gb_total"] * 1e9
                                    / decode_s / (final["hbm_gbps"] * 1e9))
            row.update({
                "timeline_sum_max_err_s": worst,
                "timeline_phases_s_p50": {
                    p: percentile([r["phases"].get(p, 0.0) for r in recs], 50)
                    for p in ("queue_wait", "prefill", "decode")},
                "mfu": {"generation": final["generation"],
                        "windows": len(busy),
                        "serving_mfu_pct": [m["serving_mfu_pct"]
                                            for m in busy],
                        "hbm_bw_util_pct": [m["hbm_bw_util_pct"]
                                            for m in busy],
                        "window_tokens_per_second": [
                            m["window_tokens_per_second"] for m in busy],
                        "model_tflops_total": final["model_tflops_total"],
                        "hbm_gb_total": final["hbm_gb_total"]},
                "attribution": health["attribution"]})
        if mode == "traced":
            traces = get_json(url, "/debug/traces")
            # the step traces evict the earlier requests' from the ring
            # (64 traces): the last to retire is there
            request_traces = [t for t in traces["traces"]
                              if t["root"] == "POST /v1/generate"]
            if not request_traces:
                fail(f"{run}: no request trace in the ring: "
                     f"{[t['root'] for t in traces['traces']][:8]}")
            doc = get_json(url, "/debug/traces/"
                           + request_traces[0]["trace_id"])
            names: dict = {}
            for e in doc["traceEvents"]:
                if e["ph"] == "X":
                    names[e["name"]] = names.get(e["name"], 0) + 1
            for need in ("POST /v1/generate", "request", "admit",
                         "prefill_chunk", "decode", "retire"):
                if need not in names:
                    fail(f"{run}: span {need!r} missing from a request "
                         f"trace: {names}")
            slow = get_json(url, "/debug/slow")
            if slow["captured"] < len(bodies):
                fail(f"{run}: the flight recorder captured "
                     f"{slow['captured']} of {len(bodies)} at 1 ms")
            entry = slow["requests"][0]
            row.update({
                "traces_in_ring": traces["total"],
                "spans_in_ring": sum(t["n_spans"] for t in traces["traces"]),
                "request_trace_span_names": names,
                "slow_entry": {**{k: v for k, v in entry.items()
                                  if k not in ("segments", "steps")},
                               "steps_kept": len(entry["steps"])}})
        emit(row)
        row["tokens"] = [r["tokens"] for r in results]
        row["logprobs"] = results[WITH_LOGPROBS]["logprobs"]
        return row
    finally:
        server.stop()
        gc.collect()
        torch.cuda.empty_cache()


def obs_hook_cost(batching, cfg, device) -> dict:
    """The host cost a step of the hooks, on this machine's host CPU:
    attribution on (eight slots' inter-token bookkeeping with exemplars
    and timelines, the dispatch and readback histograms, ``on_step``, the
    MFU step) and ``--traceSteps``'s two step spans (with the span
    histogram's listener), each timed over OBS_HOOK_STEPS calls. The
    served runs' step times move with the requests' arrival order more
    than by this."""
    import types

    from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
    from k8s_gpu_device_plugin_torch.metrics.roofline import (
        MfuAccumulator,
        ServingCostModel,
    )
    from k8s_gpu_device_plugin_torch.metrics.serving_metrics import (
        ServingMetrics,
    )
    from k8s_gpu_device_plugin_torch.obs.attribution import RequestAttributor
    from k8s_gpu_device_plugin_torch.obs.prom import SpanMetrics
    from k8s_gpu_device_plugin_torch.obs.trace import Tracer

    registry = Registry()
    metrics = ServingMetrics(registry)
    att = RequestAttributor(metrics=metrics)
    mfu = MfuAccumulator(ServingCostModel.for_config(cfg, device=device),
                         metrics=metrics)
    host = types.SimpleNamespace(metrics=metrics, attribution=att)
    cb = batching.ContinuousBatcher
    reqs = []
    for rid in range(8):
        req = batching._Request(rid, [1] * 1000, 1 << 30,
                                t_submit=time.perf_counter())
        req.timeline = att.start(req)
        req.t_last_tok = req.t_submit
        reqs.append(req)

    def attribution_on():
        _, now = cb._token_tracking(host)
        for req in reqs:
            cb._mark_emitted_token(host, req, now)
        metrics.observe_dispatch(0.0005)
        metrics.observe_readback(0.008)
        metrics.on_step(8, 0, 8, 0)
        mfu.on_step(8, 8, sum(len(r.prompt) + len(r.out) - r.prefilled_out
                              for r in reqs))

    tracer = Tracer()
    tracer.enabled = True
    spans = SpanMetrics(registry).install(tracer)

    def trace_steps():
        tracer.span("decode_dispatch", component="serving_engine",
                    step=0).end()
        tracer.span("decode_readback", component="serving_engine",
                    step=0).set(emitted=8).end()

    out = {}
    for name, fn in (("attribution_on", attribution_on),
                     ("trace_steps", trace_steps)):
        fn()
        t0 = time.perf_counter()
        for _ in range(OBS_HOOK_STEPS):
            fn()
        out[f"{name}_us_per_step"] = (
            1e6 * (time.perf_counter() - t0) / OBS_HOOK_STEPS)
    spans.close()
    metrics.close()
    return out


def phase_obs(torch, server_mod, batching, kernel_support, rpa, cfg,
              params) -> dict:
    """Observability on the main path: attribution off / on / traced,
    dense and paged, depth 1 and 0. Streams (tokens, and the logprobs
    of request WITH_LOGPROBS) must be bit for bit the same across the
    three modes, and the tokens across every run; the host-clock decode
    step of each run is reported beside the others."""
    import numpy as np

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)  # phase_serving's six requests
    bodies = []
    for i, (plen, max_new) in enumerate(REQUESTS_HALF):
        body = {"prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
                "max_new": max_new}
        if i == STREAMED:
            body["stream"] = True
        if i == WITH_LOGPROBS:
            body["logprobs"] = True
        bodies.append(body)
    runs = {}
    for layout in OBS_LAYOUTS:
        for depth in (1, 0):
            triple = {mode: obs_run(torch, server_mod, kernel_support, rpa,
                                    cfg, params, layout, depth, mode, bodies)
                      for mode in OBS_MODES}
            for mode, r in triple.items():
                if (r["tokens"], r["logprobs"]) != (triple["off"]["tokens"],
                                                    triple["off"]["logprobs"]):
                    fail(f"obs {layout} depth {depth}: the {mode} streams "
                         "differ from attribution off")
            runs.update({r["run"]: r for r in triple.values()})
    first = next(iter(runs.values()))
    for r in runs.values():
        if r["tokens"] != first["tokens"]:
            fail(f"{r['run']}: greedy tokens differ from {first['run']}")
    steady = runs["obs_dense_depth1_on"]["mfu"]
    summary = {
        "phase": 4, "run": "obs",
        "streams_equal": True,
        "logprobs_equal_all_runs": all(r["logprobs"] == first["logprobs"]
                                       for r in runs.values()),
        "decode_step_ms_mean": {name: r["decode_step_ms_mean"]
                                for name, r in runs.items()},
        "dense_depth1_bw_pct_max": max(steady["hbm_bw_util_pct"]),
        "dense_depth1_bw_pct_median": float(np.median(
            steady["hbm_bw_util_pct"])),
        "dense_depth1_mfu_pct_median": float(np.median(
            steady["serving_mfu_pct"])),
        "dense_depth1_decode_bw_pct": runs["obs_dense_depth1_on"][
            "decode_bw_pct"],
        "launches": sum(r["launches"] for r in runs.values()),
        "hook_cost": obs_hook_cost(batching, cfg, params["embed"].device),
        "wall_s": time.perf_counter() - t_phase}
    emit(summary)
    return {**runs, "summary": summary}


# window_relief (phase_window's weights, Mistral-7B at W 4096, the pool of
# WINDOW_POOL pages, 3 slots): Y a short prompt decoding long, X a long
# prompt whose window recycling keeps about 66 pages live; H, priority 0,
# arrives after RELIEF_AT steps and its reservation reads pool pressure
RELIEF_Y, RELIEF_X, RELIEF_H = (300, 200), (6000, 64), (1000, 16)
RELIEF_AT = 40


def window_relief(torch, batching, cfg, params) -> dict:
    """The slo scheduler's page-relief ranking on the card: a head that
    waits on pages, not a slot, evicts the decode whose eviction returns
    the most live pages (X), where the longest decode would be Y. The
    head's wait is injected: the ``pool.alloc`` point fires on its first
    reservation (one fire), as a real exhausted free list would read.
    Every request then delivers its budget, and the pool drains."""
    import numpy as np

    t0 = time.perf_counter()
    from k8s_gpu_device_plugin_torch.serving import faults, scheduler

    plane = faults.FaultPlane.from_spec("pool.alloc:nth=1000000000")
    point = plane.point("pool.alloc")
    sched = scheduler.SloScheduler()
    cb = batching.ContinuousBatcher(
        params, cfg, n_slots=3, max_len=12288, chunked_prefill=256,
        kv_layout="paged", kv_page_size=64, kv_pages=WINDOW_POOL,
        scheduler=sched, faults=plane)
    rng = np.random.default_rng(SEED + 11)
    prompt = [rng.integers(0, cfg.vocab_size, n).tolist()
              for n, _ in (RELIEF_Y, RELIEF_X, RELIEF_H)]
    ry = cb.submit(prompt[0], RELIEF_Y[1], priority=2)
    rx = cb.submit(prompt[1], RELIEF_X[1], priority=2)
    for _ in range(RELIEF_AT):
        cb.step()
    running = {r.rid: s for s, r in cb.running.items()}
    if set(running) != {rx, ry}:
        fail(f"window_relief: {running} should be X and Y, both decoding")
    point.nth = point.hits + 1  # the head's first reservation
    rh = cb.submit(prompt[2], RELIEF_H[1], priority=0, deadline_ms=1)
    cb.step()
    head = cb.pending[0] if cb.pending else None
    if head is None or head.rid != rh or not head.defer_counted:
        fail("window_relief: the head's reservation did not wait on pages")
    live = {rid: sum(1 for p in cb._slot_pages[s] if p)
            for rid, s in running.items()}
    outs = {rid: len(cb.running[s].out) for rid, s in running.items()}
    cb.run()
    done = cb.done_requests
    if (done[rx].preemptions, done[ry].preemptions) != (1, 0) or \
            sched.preemptions != 1:
        fail(f"window_relief: preemptions X {done[rx].preemptions}, Y "
             f"{done[ry].preemptions}: live pages {live}, tokens out {outs}")
    if outs[ry] <= outs[rx] or live[rx] <= live[ry]:
        fail(f"window_relief: the case must set the rules apart: pages "
             f"{live}, tokens out {outs}")
    for rid, (_, max_new) in zip((ry, rx, rh), (RELIEF_Y, RELIEF_X, RELIEF_H)):
        if len(done[rid].out) != max_new:
            fail(f"window_relief: request {rid} delivered "
                 f"{len(done[rid].out)} of {max_new}")
    while cb.prefix_cache is not None and cb.prefix_cache.evict_one():
        pass
    if cb.pool.in_use:
        fail(f"window_relief: pages still in use: {cb.kv_stats()}")
    cb.pool.check()
    row = {"phase": 4, "run": "window_relief", "window": cfg.sliding_window,
           "live_pages_at_preemption": {"X": live[rx], "Y": live[ry]},
           "tokens_out_at_preemption": {"X": outs[rx], "Y": outs[ry]},
           "victim": "X", "longest_decode": "Y",
           "pool_pressure_deferrals": cb.kv_rejections()["pool_pressure"],
           "pages_recycled_total": cb.kv_stats()["pages_recycled_total"],
           "wall_s": time.perf_counter() - t0}
    emit(row)
    del cb
    gc.collect()
    torch.cuda.empty_cache()
    return row


# the windowed runs: Mistral-7B at its published widths and window, two
# long prompts on two slots; the pool holds 179 allocatable pages of 64
WINDOW_PROMPTS, WINDOW_MAX_NEW, WINDOW_POOL = (12000, 9000), 256, 180
WINDOW_ARGS = ["--preset", "mistral_7b", "--slots", "2", "--maxLen", "12288",
               "--chunkedPrefill", "256"]
WINDOW_RUNS = {"window_paged": ["--kvLayout", "paged", "--kvPageSize", "64",
                                "--kvPages", str(WINDOW_POOL)],
               "window_dense": []}
WINDOW_PEAK_PAGES = 164  # two rows at the windowed peak (82 pages each)


MOE_MODEL_LAYERS = 2   # moe_model: Mixtral-8x7B's full width, depth cut
MOE_CAPACITY = 8.0     # moe_model's training forward drops no token
MOE_TOPK_ROWS = 4096   # moe_model: rows of h for the card-vs-CPU top-k
MOE_CHECK_SEQ = 512    # moe_model: the forward check's prompt


def moe_model(torch, generate, llama, quantized_serving, moe_mod,
              kernel_support) -> dict:
    """Mixtral-8x7B at its full width (d 4096, 8 experts, top 2, d_ff
    14336, vocab 32000) and depth MOE_MODEL_LAYERS, random bf16 weights
    (f32 widened: about 12.5 GB; the whole depth would need 187 GB), the
    prompt and steps of phase 3 (``_model_logits``):

    (a) the f32 cached path (K1, the dense-mix decode MLP) against the
        f32 plain path, within LOGITS_BOUND;
    (b) the prefill's last-position f32 logits against
        ``forward_with_aux`` (the capacity dispatch of ``moe_mlp``, K2 on
        the CUDA cores, one launch a layer) on the same 512 tokens, within
        LOGITS_BOUND: no token is dropped at ``capacity_factor``
        MOE_CAPACITY, so the two MLPs compute the same function;
    (c) int8 and int4 expert stacks (``--weightQuant``): the f32 kernel
        path against the f32 plain path on the same codes, within
        LOGITS_BOUND (phase 3's ``phase_weights``);
    (d) the router's top-k on the card against the CPU's for the same h
        (MOE_TOPK_ROWS rows of N(0, 1), each layer's router): the count
        of differing selections and their largest margin, printed."""
    import numpy as np

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(),
                              n_layers=MOE_MODEL_LAYERS,
                              capacity_factor=MOE_CAPACITY)
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (1, MOE_CHECK_SEQ)), device="cuda")
    tokens: list[int] = []
    bf16, _ = _model_logits(torch, generate, params, cfg, prompt, tokens,
                            False)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, params)
    runs = {}
    for name, plain in (("f32_kernel", False), ("f32_plain", True)):
        runs[name], _ = _model_logits(torch, generate, params32, cfg32,
                                      prompt, tokens, plain)
    kernel_support.reset_launch_counts()
    with torch.no_grad():
        logits, aux = llama.forward_with_aux(params32, prompt, cfg32)
    torch.cuda.synchronize()
    counts = kernel_support.launch_counts()
    k2 = counts.get("flash_fwd", 0)
    k2_engines = {e: counts.get(kernel_support.engine_key("flash_fwd", e), 0)
                  for e in kernel_support.ENGINES}
    if k2 != cfg.n_layers or k2_engines["cuda_cores"] != k2:
        fail(f"moe_model: forward_with_aux launched K2 {k2} times "
             f"({k2_engines}), wanted {cfg.n_layers} on the CUDA cores")
    forward_err = float((logits[0, -1] - runs["f32_kernel"][0]).abs().max())
    # (d): the same h and router on the card and on the CPU
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn((1, MOE_TOPK_ROWS, cfg.d_model), generator=gen,
                    device="cuda")
    differ, worst, closest = 0, 0.0, float("inf")
    for i in range(cfg.n_layers):
        router = params["layers"]["router"][i]
        _, card_idx, probs = moe_mod.router_topk(
            moe_mod.router_logits(h, router), cfg.n_experts_per_token)
        _, cpu_idx, _ = moe_mod.router_topk(
            moe_mod.router_logits(h.cpu(), router.cpu()),
            cfg.n_experts_per_token)
        ranked = probs.sort(dim=-1, descending=True).values.cpu()
        k = cfg.n_experts_per_token
        margin = ranked[..., k - 1] - ranked[..., k]
        bad = (card_idx.cpu().sort(-1).values
               != cpu_idx.sort(-1).values).any(-1)
        differ += int(bad.sum())
        if bad.any():
            worst = max(worst, float(margin[bad].max()))
        closest = min(closest, float(margin.min()))
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out = {
        "phase": 3, "run": "moe_model", "layers": cfg.n_layers,
        "n_experts": cfg.n_experts, "top_k": cfg.n_experts_per_token,
        "capacity_factor": cfg.capacity_factor,
        "f32_kernel_vs_plain": float(
            (runs["f32_kernel"] - runs["f32_plain"]).abs().max()),
        "f32_prefill_vs_forward_with_aux": forward_err,
        "bound": LOGITS_BOUND,
        "bf16_kernel_vs_f32_plain": float((bf16 - runs["f32_plain"])
                                          .abs().max()),
        "greedy_agreement_bf16_vs_f32": "%d/9" % int(
            (bf16.argmax(-1) == runs["f32_plain"].argmax(-1)).sum()),
        "logits_std": float(runs["f32_plain"].std()),
        "aux": {k: float(v) for k, v in aux.items()},
        "k2_launches": k2, "k2_launches_per_engine": k2_engines,
        "topk_rows": MOE_TOPK_ROWS * cfg.n_layers,
        "topk_card_vs_cpu_differing": differ,
        "topk_differing_largest_margin": worst,
        "topk_smallest_margin": closest,
    }
    emit(out)
    for key in ("f32_kernel_vs_plain", "f32_prefill_vs_forward_with_aux"):
        if not out[key] <= LOGITS_BOUND:
            fail(f"moe_model {key}: {out[key]:.3e} > {LOGITS_BOUND}")
    model = {"bf16_logits": bf16, "prompt": prompt, "tokens": tokens}
    out["weights"] = {}
    for weight_quant in ("int8", "int4"):
        qparams = quantized_serving.quantize_weights(params, weight_quant)
        out["weights"][weight_quant] = phase_weights(
            torch, generate, cfg, qparams, weight_quant, model,
            label="mixtral_8x7b_2_layers")
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def phase_moe(torch, server_mod, batching, sampling, generate, llama,
              quantized_serving, moe_mod, kernel_support, rpa) -> dict:
    """Mixture-of-Experts serving, after the Llama-3-8B weights are
    freed: ``moe_model`` (Mixtral's width at depth 2, the checks (a) to
    (d)), then ``moe_w8``: Mixtral-8x7B at its full 32 layers with int8
    weights, its expert stacks quantized one layer at a time as they are
    drawn (``server.load_params``: the 93.4 GB bf16 tree is never built).
    Its captured decode step against the eager one (``phase_graph``),
    then the server (``--preset mixtral_8x7b --weightQuant int8 --slots 8
    --maxLen 2048``) serving REQUESTS at ``--pipelineDepth`` 0 and 1:
    every decode step a graph replay, every K1 launch counted on the
    dense route, the two runs' streams equal token for token. Prints the
    decode step, TTFT, resident weight bytes, the graph pool and the peak
    memory."""
    model = moe_model(torch, generate, llama, quantized_serving, moe_mod,
                      kernel_support)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.LlamaConfig.mixtral_8x7b()
    params = server_mod.load_params(cfg, seed=SEED, device="cuda",
                                    weight_quant="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    resident = quantized_serving.resident_bytes(params)
    graph = phase_graph(torch, batching, sampling, cfg, params, "moe_w8",
                        SERVING_RUNS["moe_w8"])
    serving = {"moe_w8_depth0": phase_serving(
        torch, server_mod, kernel_support, rpa, cfg, params, "moe_w8_depth0",
        preset="mixtral_8x7b", requests=REQUESTS_QUARTER)}
    gc.collect()
    torch.cuda.empty_cache()
    serving["moe_w8"] = phase_serving(
        torch, server_mod, kernel_support, rpa, cfg, params, "moe_w8",
        dense_tokens=serving["moe_w8_depth0"]["tokens"],
        preset="mixtral_8x7b", requests=REQUESTS_QUARTER)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    run = serving["moe_w8"]
    out = {
        "phase": 4, "run": "moe_w8_summary", "layers": cfg.n_layers,
        "load_s": load_s, "load_peak_gib": load_peak / 2**30,
        "resident_weight_bytes": resident,
        "weights": run["weights"],
        "decode_step_ms_mean": {r: serving[r]["decode_step_ms_mean"]
                                for r in serving},
        "prefill_chunk_ms_mean": {r: serving[r]["prefill_chunk_ms_mean"]
                                  for r in serving},
        "ttft_s_p50": {r: serving[r]["ttft_s_p50"] for r in serving},
        "decode_graph_pool_bytes": {"graph_check": graph["pool_bytes"],
                                    **{r: serving[r]["decode_graph"][
                                        "pool_bytes"] for r in serving}},
        "graph_equal_bitwise": graph["equal_bitwise"],
        "streams_depth1_equal_depth0": True,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "k1_launches": {r: serving[r]["launches"] for r in serving},
        "s": time.perf_counter() - t0,
    }
    emit(out)
    return {"model": model, "graph": graph, "serving": serving,
            "summary": out,
            "k1_launches": sum(serving[r]["launches"] for r in serving),
            "k2_launches": model["k2_launches"]}


def phase_window(torch, server_mod, kernel_support, rpa, batching,
                 llama, generate) -> dict:
    """Mistral-7B served windowed (W 4096) from a page pool too small for
    the full reservation of its 12,256-token request (192 pages of the
    179): both requests served with at most 164 pages in use at once and
    pages recycled out of the window, every K1 launch on the paged route
    and the tensor cores, and the tokens of a dense twin (3 GiB of
    cache). The full-causal twin of the same pool refuses the request at
    ``validate``, running no weights. Then the rolling decode on the same
    weights (``phase_rolling``)."""
    import numpy as np

    cfg = llama.LlamaConfig.mistral_7b()
    params = server_mod.load_params(cfg, seed=SEED, device="cuda")
    twin = batching.ContinuousBatcher(
        params, dataclasses.replace(cfg, sliding_window=0), n_slots=2,
        max_len=12288, chunked_prefill=256, kv_layout="paged",
        kv_page_size=64, kv_pages=WINDOW_POOL, decode_graph=False)
    try:
        twin.validate(WINDOW_PROMPTS[0], WINDOW_MAX_NEW)
        fail("window: the full-causal twin admitted a request past its pool")
    except batching.RequestTooLargeError as e:
        refused = e.body()
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 4)
    bodies = [{"prompt": rng.integers(0, cfg.vocab_size, n).tolist(),
               "max_new": WINDOW_MAX_NEW, "stream": True}
              for n in WINDOW_PROMPTS]
    out = {}
    for run, flags in WINDOW_RUNS.items():
        args, server, url = start_server(server_mod, [*WINDOW_ARGS, *flags],
                                         params)
        try:
            cb = server.engine.cb
            route = rpa.route_name(cb.pool is not None, "none")
            kernel_support.reset_launch_counts()
            steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
            replays0 = cb.graph.replays
            t0 = time.perf_counter()
            results = post_all(url, bodies, run)
            wall = time.perf_counter() - t0
            health = server.engine.stats()
            decode_steps = cb.decode_steps - steps0
            chunks = cb.prefill_chunks - chunks0
            if cb.graph.replays - replays0 != decode_steps:
                fail(f"{run}: {decode_steps} decode steps but "
                     f"{cb.graph.replays - replays0} graph replays")
            launched = route_launches(run, kernel_support, rpa, route,
                                      cfg.n_layers, decode_steps, chunks)
            if any(len(r["tokens"]) != WINDOW_MAX_NEW for r in results):
                fail(f"{run}: a request came back short")
            kv = health["kv"]
            if kv.get("attn_window") != cfg.sliding_window:
                fail(f"{run}: kv {kv} does not name the window")
            if run == "window_paged":
                if kv["pages_in_use_peak"] > WINDOW_PEAK_PAGES or \
                        kv["pages_recycled_total"] <= 0:
                    fail(f"{run}: peak {kv['pages_in_use_peak']} pages "
                         f"(at most {WINDOW_PEAK_PAGES}), recycled "
                         f"{kv['pages_recycled_total']}")
                drain_prefix_cache(server)
                if cb.pool.in_use:
                    fail(f"{run}: pages still in use: {cb.kv_stats()}")
                cb.pool.check()
            else:
                equal_streams(run, results, out["window_paged"]["results"],
                              logprobs=False)
                want = 2 * 12288 * TOKEN_BYTES["none"]
                if kv["reserved_bytes"] != want:
                    fail(f"{run}: reserved_bytes {kv['reserved_bytes']}, "
                         f"wanted {want}")
            # the host clock of the steps while both rows decode: the
            # long request's token gaps after the other's first token
            # (each replay reads 4096 rows a row, at contexts 12.0k-12.3k
            # and 9.0k-9.3k)
            times = results[0]["token_times"]
            start = results[1]["token_times"][0]
            gaps = sorted(b - a for a, b in zip(times, times[1:]) if a > start)
            row = {"phase": 4, "run": run, "route": route, "flags": flags,
                   "prompt_tokens": list(WINDOW_PROMPTS),
                   "max_new": WINDOW_MAX_NEW, "window": cfg.sliding_window,
                   "decode_steps": decode_steps, "prefill_chunks": chunks,
                   **launched, "wall_s": wall,
                   "decode_step_ms_both_decoding_p50":
                       1e3 * gaps[len(gaps) // 2] if gaps else None,
                   "decode_steps_both_decoding": len(gaps),
                   "decode_step_ms_mean": health["decode_step_ms_mean"],
                   "ttft_s": [r["ttft"] for r in results],
                   "kv": kv, "decode_graph": health["decode"]["graph"],
                   "full_causal_twin_refused": refused,
                   "equals_window_paged": run == "window_dense" or None,
                   "max_memory_allocated_gib":
                       torch.cuda.max_memory_allocated() / 2**30}
            emit(row)
            out[run] = {**row, "results": results}
        finally:
            server.stop()
        gc.collect()
        torch.cuda.empty_cache()
    out["window_relief"] = window_relief(torch, batching, cfg, params)
    out["rolling"] = phase_rolling(torch, generate, kernel_support, rpa, cfg,
                                   params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the batch-1 decode modes ------------------------------------------------

# beam search on the 8B bf16 weights (K1's split decode at B = beam; K2
# in the check's full-context forward), then on a 2-layer f32 copy
BEAM_WIDTH, BEAM_PROMPT, BEAM_NEW = 4, 512, 32
BEAM_BF16_TOL = 0.05     # bf16: nats a generated token, score vs forward
BEAM_F32_TOL = 1e-3      # f32: a whole score against the full forward's
BEAM_F32_LAYERS = 2
BEAM_CHECK_SEQ = -(-(BEAM_PROMPT + BEAM_NEW) // 64) * 64  # K2's tile
# rolling decode on Mistral-7B: one prefill past the window, then ring steps
ROLLING_PROMPT, ROLLING_NEW = 4160, 64
ROLLING_F32_LAYERS = 2


def full_forward_scores(torch, llama, params, cfg, prompt, seqs):
    """Each row of ``seqs`` (beam, n): its cumulative f32 log-probability
    after ``prompt`` (1, P) under the full-context forward, one batch of
    all rows padded at the end to K2's sequence tile (causal: the padding
    changes no earlier position)."""
    beam, n = seqs.shape
    p = prompt.shape[1]
    pad = -(p + n) % 64
    tokens = torch.cat([prompt.expand(beam, p), seqs,
                        torch.zeros((beam, pad), dtype=seqs.dtype,
                                    device=seqs.device)], dim=1)
    with torch.no_grad():
        logits = llama.forward(params, tokens, cfg)[:, p - 1:p - 1 + n]
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(2, seqs[:, :, None])[..., 0].sum(1)


def beam_run(run: str, torch, beam_mod, generate, llama, kernel_support,
             rpa, cfg, params, prompt, tol: float) -> dict:
    """Beam 1 against ``generate``'s greedy tokens bit for bit, then beam
    ``BEAM_WIDTH``: its K1 launches (one a layer for the prefill, one a
    layer for each later step, every step split on the dense route),
    distinct rows sorted by score, each score within ``tol`` of its
    sequence's log-probability under the full-context forward (K2, one
    launch a layer)."""
    greedy = generate.generate(params, prompt, cfg, BEAM_NEW)
    one, _ = beam_mod.beam_search(params, prompt, cfg, BEAM_NEW, beam=1)
    if not torch.equal(one, greedy):
        fail(f"{run}: beam 1 differs from greedy at token "
             f"{first_divergence(one[0].tolist(), greedy[0].tolist())}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernel_support.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = beam_mod.beam_search(params, prompt, cfg, BEAM_NEW,
                                        beam=BEAM_WIDTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_support.launch_counts()
    n = cfg.n_layers
    eng = rpa.engine(cfg.dtype, 1, cfg.n_heads // cfg.n_kv_heads)
    want = {rpa.NAME: n * BEAM_NEW, rpa.route_key("dense"): n * BEAM_NEW,
            kernel_support.engine_key(rpa.NAME, eng): n * BEAM_NEW,
            rpa.SPLIT_KEY: n * (BEAM_NEW - 1)
            if rpa.window_split(1, cfg.n_heads // cfg.n_kv_heads)
            and eng == "tensor_cores" else 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        fail(f"{run}: K1 launches {got}, wanted {want}")
    rows = [tuple(r) for r in seqs.tolist()]
    if seqs.shape != (BEAM_WIDTH, BEAM_NEW) or len(set(rows)) != BEAM_WIDTH \
            or not torch.isfinite(scores).all() \
            or not bool((scores[:-1] >= scores[1:]).all()) \
            or not bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()):
        fail(f"{run}: sequences {seqs.shape} or scores {scores.tolist()}")
    kernel_support.reset_launch_counts()
    full = full_forward_scores(torch, llama, params, cfg, prompt, seqs)
    torch.cuda.synchronize()
    k2 = kernel_support.launch_counts().get("flash_fwd", 0)
    if k2 != n:
        fail(f"{run}: the full forward launched K2 {k2} times, wanted {n}")
    gaps = (scores - full).abs()
    if float(gaps.max()) > tol:
        fail(f"{run}: a beam score is {float(gaps.max()):.4e} from its "
             f"sequence's full-forward log-probability (tolerance {tol})")
    out = {"phase": 4, "run": run, "card": card_line(), "beam": BEAM_WIDTH,
           "prompt_tokens": BEAM_PROMPT, "max_new": BEAM_NEW,
           "dtype": str(cfg.dtype).split(".")[-1], "layers": n,
           "beam1_equals_greedy": True, "wall_s": wall,
           "ms_per_step": 1e3 * wall / BEAM_NEW,
           "k1_launches": got[rpa.NAME], "k1_split_launches":
               got[rpa.SPLIT_KEY], "k1_engine": eng, "k2_launches": k2,
           "cache_rows": BEAM_PROMPT + BEAM_NEW,
           "peak_gib": peak / 2**30, "peak_over_held_gib":
               (peak - held) / 2**30,
           "scores": scores.tolist(), "full_forward": full.tolist(),
           "max_score_gap": float(gaps.max()), "tolerance": tol,
           "best_equals_greedy": seqs[0].tolist() == greedy[0].tolist()}
    emit(out)
    return out


def phase_beam(torch, generate, llama, kernel_support, rpa, cfg,
               params) -> dict:
    """``beam_bf16``: beam search on the 8B bf16 weights, a 512-token
    prompt, 32 tokens (``beam_run``; a score within BEAM_BF16_TOL a token
    of the full forward's); ``beam_f32``: the same on a 2-layer f32 copy
    at the same width (K1 and K2 on the CUDA cores; within
    BEAM_F32_TOL)."""
    import numpy as np

    from k8s_gpu_device_plugin_torch.models import beam as beam_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 500)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, BEAM_PROMPT)),
                          device="cuda")
    out = {"bf16": beam_run("beam_bf16", torch, beam_mod, generate, llama,
                            kernel_support, rpa, cfg, params, prompt,
                            BEAM_BF16_TOL * BEAM_NEW)}
    cfg32, params32 = truncated_draft(cfg, params, BEAM_F32_LAYERS)
    cfg32 = dataclasses.replace(cfg32, dtype=torch.float32)
    params32 = widened(torch, params32)
    out["f32"] = beam_run("beam_f32", torch, beam_mod, generate, llama,
                          kernel_support, rpa, cfg32, params32, prompt,
                          BEAM_F32_TOL)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def rolling_run(run: str, torch, rolling, generate, kernel_support, rpa,
                cfg, params, prompt) -> dict:
    """``rolling_generate`` against the unbounded windowed ``generate`` on
    one prompt past the window, each step's logits recorded on both
    paths: the tokens, the first step where they part, the largest logit
    gap over the steps where the two contexts agree, K1's launches of
    each (the ring's one prefill, on the chunk route, against the
    unbounded run's prefill and decode steps) and both caches' rows and
    bytes."""
    rec = {"ring": [], "ring_logits": [], "full": [], "full_logits": []}
    fwd_gen, fwd_roll = generate._forward_cached, rolling._forward_cached
    ring_forward = rolling._ring_forward

    def cache_bytes(cache):
        return sum(x.numel() * x.element_size() for x in
                   (cache.k, cache.v, cache.k_scale, cache.v_scale)
                   if x is not None)

    def gen_recorded(params_, tokens, cache, *a, **kw):
        if not rec["full"]:
            rec["full"].append((cache.k.shape[2], cache_bytes(cache)))
        logits = fwd_gen(params_, tokens, cache, *a, **kw)
        rec["full_logits"].append(logits[:, -1].float())
        return logits

    def prefill_recorded(*a, **kw):
        logits = fwd_roll(*a, **kw)
        rec["ring_logits"].append(logits[:, -1].float())
        return logits

    def ring_recorded(params_, tok, ring, pos, cfg_):
        if not rec["ring"]:
            rec["ring"].append((ring.k.shape[2], cache_bytes(ring)))
        logits = ring_forward(params_, tok, ring, pos, cfg_)
        rec["ring_logits"].append(logits.float())
        return logits

    generate._forward_cached = gen_recorded
    rolling._forward_cached = prefill_recorded
    rolling._ring_forward = ring_recorded
    try:
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        ring_toks = rolling.rolling_generate(params, prompt, cfg, ROLLING_NEW)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        ring_counts = kernel_support.launch_counts()
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        full_toks = generate.generate(params, prompt, cfg, ROLLING_NEW)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        full_counts = kernel_support.launch_counts()
    finally:
        generate._forward_cached = fwd_gen
        rolling._forward_cached = fwd_roll
        rolling._ring_forward = ring_forward
    n = cfg.n_layers
    w = cfg.sliding_window
    (ring_rows, ring_bytes), = rec["ring"]
    (full_rows, full_bytes), = rec["full"]
    a, b = ring_toks[0].tolist(), full_toks[0].tolist()
    part = first_divergence(a, b)
    agree = len(a) if part is None else part + 1  # step `part` saw one context
    gap = max(float((x - y).abs().max()) for x, y in
              zip(rec["ring_logits"][:agree], rec["full_logits"][:agree]))
    if a[0] != b[0]:
        fail(f"{run}: the first tokens differ ({a[0]} against {b[0]}): the "
             "two prefills are the same")
    if ring_rows != w or full_rows != ROLLING_PROMPT + ROLLING_NEW:
        fail(f"{run}: the ring holds {ring_rows} rows (window {w}), the "
             f"unbounded cache {full_rows}")
    if ring_counts.get(rpa.NAME, 0) != n or ring_counts.get(
            rpa.SPLIT_KEY, 0) or \
            full_counts.get(rpa.NAME, 0) != n * ROLLING_NEW:
        fail(f"{run}: K1 launches {ring_counts} (ring) and {full_counts} "
             f"(unbounded), wanted {n} chunk launches and {n * ROLLING_NEW}")
    if len(rec["ring_logits"]) != ROLLING_NEW or \
            not all(bool(torch.isfinite(x).all()) for x in rec["ring_logits"]):
        fail(f"{run}: {len(rec['ring_logits'])} ring steps, or non-finite "
             "logits")
    out = {"phase": 4, "run": run, "card": card_line(),
           "dtype": str(cfg.dtype).split(".")[-1], "layers": n, "window": w,
           "prompt_tokens": ROLLING_PROMPT, "max_new": ROLLING_NEW,
           "first_token_equal": True, "first_divergence": part,
           "max_logit_gap_while_equal": gap, "steps_compared": agree,
           "ring_rows": ring_rows, "ring_bytes": ring_bytes,
           "unbounded_rows": full_rows, "unbounded_bytes": full_bytes,
           "k1_launches_rolling": ring_counts.get(rpa.NAME, 0),
           "k1_launches_unbounded": full_counts.get(rpa.NAME, 0),
           "rolling_s": ring_s, "unbounded_s": full_s}
    emit(out)
    return out


def phase_rolling(torch, generate, kernel_support, rpa, cfg, params) -> dict:
    """``rolling_bf16``: Mistral-7B's rolling decode against its unbounded
    windowed decode (the first token equal, the parting step and the
    logit gap reported: the ring's softmax is a plain one, K1's an online
    one); ``rolling_f32``: the same on a 2-layer f32 copy at the same
    width, token for token."""
    import numpy as np

    from k8s_gpu_device_plugin_torch.models import rolling

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 600)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (1, ROLLING_PROMPT)), device="cuda")
    out = {"bf16": rolling_run("rolling_bf16", torch, rolling, generate,
                               kernel_support, rpa, cfg, params, prompt)}
    cfg32, params32 = truncated_draft(cfg, params, ROLLING_F32_LAYERS)
    cfg32 = dataclasses.replace(cfg32, dtype=torch.float32)
    params32 = widened(torch, params32)
    out["f32"] = rolling_run("rolling_f32", torch, rolling, generate,
                             kernel_support, rpa, cfg32, params32, prompt)
    if out["f32"]["first_divergence"] is not None:
        fail(f"rolling_f32: the streams part at token "
             f"{out['f32']['first_divergence']}")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# surface (the serving surface at Llama-3-8B width): the server with the
# byte tokenizer, embeddings and prompt scoring; K2 at B 1 and the padded
# bucket for every short scored prompt and embedding, K1's chunk route at
# T 512 over a 4096-row batch-1 cache for the long ones
SURFACE_ARGS = ["--preset", "llama3_8b", "--tokenizer", "byte",
                "--embeddings", "--scoring", "--scoringMaxLen", "4096",
                "--slots", "8", "--maxLen", "2048"]
SURFACE_SHORT, SURFACE_LONG = 200, 3000   # echo-scored prompt lengths
SURFACE_N, SURFACE_NEW = 4, 48            # the n-choice completion
SURFACE_REPS = 3             # timed calls of each echo and embedding
SURFACE_F32_TOL = 1e-3      # the f32 twin: kernels vs plain, max abs
SURFACE_F32_LAYERS = 8      # the f32 twin's depth
# the chat's letters: a logit bias on a-z makes the greedy answer ASCII,
# so a stop string cut from it round-trips through the byte tokenizer
SURFACE_BIAS = {str(c): 10.0 for c in range(97, 123)}


def _oai(url: str, path: str, body: "dict | None" = None):
    """One OpenAI-surface call: (payload, seconds); a stream's payload is
    its list of ``data:`` events ("[DONE]" last). A status other than 200
    fails the run."""
    import urllib.error

    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            raw = resp.read().decode()
    except urllib.error.HTTPError as e:
        fail(f"surface: {path} answered {e.code}: {e.read()[:300]!r}")
    secs = time.perf_counter() - t0
    if body is None or not body.get("stream"):
        return json.loads(raw), secs
    evts = [line[len("data: "):] for line in raw.split("\n\n")
            if line.startswith("data: ")]
    return [e if e == "[DONE]" else json.loads(e) for e in evts], secs


def _k_launches(kernel_support, rpa) -> tuple[int, int]:
    counts = kernel_support.launch_counts()
    return counts.get("flash_fwd", 0), counts.get(rpa.NAME, 0)


def surface_scores(scoring, embeddings, cfg, params, prompts: dict,
                   plain: bool) -> dict:
    """In process: the echo logprobs of each prompt (token 1 on) and the
    embedding of the short one, through the kernels or the plain
    attention."""
    import numpy as np

    scorer = scoring.Scorer(params, cfg, max_len=4096, warmup=False,
                            plain_attention=plain)
    out = {f"echo_{n}": np.asarray(scorer.score(ids)[1:], np.float64)
           for n, ids in prompts.items()}
    out["embedding"] = embeddings.Embedder(
        params, cfg, warmup=False, plain_attention=plain).embed(
        prompts[SURFACE_SHORT]).astype(np.float64)
    return out


def surface_distances(got: dict, want: dict) -> dict:
    """Max and RMS distance of each entry of ``got`` from ``want``."""
    import numpy as np

    out = {}
    for key, ref in want.items():
        d = np.asarray(got[key], np.float64) - ref
        out[key] = {"max": float(np.abs(d).max()),
                    "rms": float(np.sqrt((d * d).mean()))}
    return out


def phase_surface(torch, server_mod, kernel_support, rpa, scoring,
                  embeddings, cfg, params) -> dict:
    """The serving surface through the port's server (SURFACE_ARGS):
    a seeded n=4 text completion (each choice the single request at seed
    + i, bit for bit; tokens/s beside the four singles one after
    another); a streamed chat that stops on a stop string, trimmed; echo
    scoring of a 200- and a 3000-token prompt (the long one in chunks of
    512) and an embedding, each timed; ``concurrent``: echo and embedding
    requests while eight streams decode, every answer equal to its solo
    run (streams bit for bit, scores and embeddings exactly). Then, in
    process, the served scores and embedding against the f32 model's
    plain forward (RMS distance within BF16_FACTOR of the bf16 plain
    path's), and an 8-layer f32 twin's kernels against its plain
    attention within SURFACE_F32_TOL. K2 launches must be 32 for every
    short-path forward of the run, K1's 32 for every chunk of the long
    prompt scored alone."""
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    args, server, url = start_server(server_mod, SURFACE_ARGS, params)
    startup_s = time.perf_counter() - t_phase
    rng = np.random.default_rng(SEED + 13)
    prompts = {n: rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (SURFACE_SHORT, SURFACE_LONG)}
    chunks = -(-SURFACE_LONG // server.scorer.chunk)
    layers = cfg.n_layers
    out = {"phase": 4, "run": "surface", "startup_s": startup_s}
    served, short_forwards = {}, 0
    try:
        kernel_support.reset_launch_counts()
        # n choices against the single requests at seed + i
        body = {"prompt": "The quick brown fox", "max_tokens": SURFACE_NEW,
                "n": SURFACE_N, "seed": 1234, "temperature": 0.8,
                "logprobs": 0}
        multi, n_s = _oai(url, "/v1/completions", body)
        singles, single_s = [], 0.0
        for i in range(SURFACE_N):
            one, secs = _oai(url, "/v1/completions",
                             {**body, "n": 1, "seed": 1234 + i})
            singles.append(one["choices"][0])
            single_s += secs
        for i, choice in enumerate(multi["choices"]):
            if (choice["text"], choice["logprobs"]) != (
                    singles[i]["text"], singles[i]["logprobs"]):
                fail(f"surface: choice {i} of the n={SURFACE_N} request "
                     f"differs from the single request at seed {1234 + i}")
        tokens = multi["usage"]["completion_tokens"]
        out["n_choices"] = {
            "n": SURFACE_N, "tokens": tokens, "seconds": n_s,
            "tokens_per_s": tokens / n_s,
            "singles_seconds": single_s,
            "singles_tokens_per_s": tokens / single_s,
            "choices_equal_singles": True}
        # a streamed chat that stops on a stop string cut from its greedy
        # answer (letters, by the bias)
        msgs = [{"role": "user", "content": "Name a fruit."}]
        chat = {"messages": msgs, "max_tokens": 24,
                "logit_bias": SURFACE_BIAS}
        full = _oai(url, "/v1/chat/completions", chat)[0]["choices"][0][
            "message"]["content"]
        # the first two-letter window from the seventh letter on whose
        # first occurrence leaves a letter or more before it
        cut, stop = next(((full.find(full[j:j + 2]), full[j:j + 2])
                          for j in range(6, len(full) - 1)
                          if full[j:j + 2].isascii()
                          and full.find(full[j:j + 2]) >= 1), (-1, ""))
        if cut < 1:
            fail(f"surface: the biased chat answer {full!r} has no stop "
                 "string to cut")
        evts, chat_s = _oai(url, "/v1/chat/completions",
                            {**chat, "stop": stop, "stream": True})
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in evts[:-1])
        finish = evts[-2]["choices"][0]["finish_reason"]
        if evts[-1] != "[DONE]" or text != full[:cut] or finish != "stop" \
                or evts[0]["choices"][0]["delta"] != {"role": "assistant"}:
            fail(f"surface: the streamed chat gave {text!r} ({finish}), "
                 f"not {full[:cut]!r} trimmed at {stop!r}")
        out["chat_stop"] = {"answer": full, "stop": stop, "kept": text,
                            "finish_reason": finish, "seconds": chat_s}
        # echo scoring and an embedding, each SURFACE_REPS times with the
        # engine idle: K2 launches per short forward, K1's per long chunk,
        # and the same answer every time
        latency = {}
        calls = {f"echo_{n}": ("/v1/completions",
                               {"prompt": ids, "echo": True, "max_tokens": 0,
                                "logprobs": 5}, n)
                 for n, ids in prompts.items()}
        calls["embedding"] = ("/v1/embeddings",
                              {"input": prompts[SURFACE_SHORT]},
                              SURFACE_SHORT)
        for key, (path, body, n) in calls.items():
            secs = []
            for _ in range(SURFACE_REPS):
                before = _k_launches(kernel_support, rpa)
                payload, t = _oai(url, path, body)
                k2, k1 = (b - a for a, b in zip(
                    before, _k_launches(kernel_support, rpa)))
                got = (payload["data"][0]["embedding"] if key == "embedding"
                       else payload["choices"][0]["logprobs"][
                           "token_logprobs"])
                if served.setdefault(key, got) != got:
                    fail(f"surface: {key} differs from call to call")
                want = (layers, 0) if n <= 1024 else (0, layers * chunks)
                if (k2, k1) != want:
                    fail(f"surface: {key} launched K2 {k2} and K1 {k1} "
                         f"times, not {want}")
                short_forwards += n <= 1024
                secs.append(t)
            latency[key] = {"first": secs[0],
                            "p50": float(np.median(secs))}
            out[f"{key}_launches"] = {"flash_fwd": k2, rpa.NAME: k1}
        for n in prompts:
            lps = served[f"echo_{n}"]
            if len(lps) != n or lps[0] is not None or not all(
                    math.isfinite(x) and x <= 0 for x in lps[1:]):
                fail(f"surface: echo of {n} tokens gave malformed logprobs")
        out["latency_s"] = latency
        norm = float(np.linalg.norm(served["embedding"]))
        if abs(norm - 1.0) > 1e-3:
            fail(f"surface: the embedding's norm is {norm}")
        out["embedding_norm"] = norm
        # concurrent: eight streams decode while echo and embedding
        # requests run on the handlers' stream
        streams = [{"prompt": rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    "max_new": 64, "stream": True, "logprobs": True}
                   for n in rng.integers(100, 600, 8)]
        solo = post_all(url, streams, "surface_solo")
        aux = [("/v1/completions", {"prompt": prompts[SURFACE_SHORT],
                                    "echo": True, "max_tokens": 0,
                                    "logprobs": 5}, f"echo_{SURFACE_SHORT}"),
               ("/v1/embeddings", {"input": prompts[SURFACE_SHORT]},
                "embedding"),
               ("/v1/completions", {"prompt": prompts[SURFACE_LONG],
                                    "echo": True, "max_tokens": 0,
                                    "logprobs": 5}, f"echo_{SURFACE_LONG}")]
        aux_out: list = []

        def run_aux():
            for _ in range(2):
                for path, body, key in aux:
                    aux_out.append((key, _oai(url, path, body)[0]))

        side = threading.Thread(target=run_aux)
        side.start()
        during = post_all(url, streams, "surface_concurrent")
        side.join(900)
        short_forwards += 2 * 2
        for i, (a, b) in enumerate(zip(solo, during)):
            if (a["tokens"], a["logprobs"]) != (b["tokens"], b["logprobs"]):
                fail(f"surface concurrent: stream {i} differs from its solo "
                     "run")
        if len(aux_out) != 2 * len(aux):
            fail("surface concurrent: an auxiliary request did not finish")
        for key, payload in aux_out:
            got = (payload["data"][0]["embedding"] if key == "embedding"
                   else payload["choices"][0]["logprobs"]["token_logprobs"])
            if got != served[key]:
                fail(f"surface concurrent: {key} differs from its solo run")
        k2, k1 = _k_launches(kernel_support, rpa)
        if k2 != layers * short_forwards:
            fail(f"surface: K2 launched {k2} times for {short_forwards} "
                 f"short forwards of {layers} layers")
        # where an echo's time goes: the scorer in process (the forward,
        # the log-softmax and top-5, no HTTP and no detokenizing), after
        # the run's counts were read
        for n, ids in prompts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.scorer.score_full(ids)
            latency[f"echo_{n}"]["scorer_in_process"] = \
                time.perf_counter() - t0
        _, health = get_health(url)
        out["concurrent"] = {"streams_equal_solo": len(solo),
                             "aux_equal_solo": len(aux_out)}
        out["launches"] = {"flash_fwd": k2, rpa.NAME: k1,
                           "short_forwards": short_forwards,
                           "long_chunks_alone": chunks}
        out["decode_step_ms_mean"] = health["decode_step_ms_mean"]
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["reserved_memory_bytes"] = torch.cuda.memory_reserved()
    finally:
        server.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    # bf16: the served answers (the kernels) and the plain attention's,
    # each against the f32 model's plain forward (the weights widened):
    # the kernel path within BF16_FACTOR of the plain path's RMS distance
    # (bf16 rounds in other places in each: on random 8B weights two bf16
    # forwards of one prompt sit about 0.25 apart in logits)
    kernel = {k: np.asarray(v[1:] if k.startswith("echo") else v,
                            np.float64) for k, v in served.items()}
    plain = surface_scores(scoring, embeddings, cfg, params, prompts, True)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, params)
    truth = surface_scores(scoring, embeddings, cfg32, params32, prompts,
                           True)
    dist = {"kernel": surface_distances(kernel, truth),
            "plain": surface_distances(plain, truth),
            "kernel_vs_plain": surface_distances(kernel, plain)}
    for key in truth:
        k_rms, p_rms = dist["kernel"][key]["rms"], dist["plain"][key]["rms"]
        if not k_rms <= BF16_FACTOR * p_rms:
            fail(f"surface bf16: {key}: the kernel path's RMS distance to "
                 f"the f32 model {k_rms:.3e} > {BF16_FACTOR} x the plain "
                 f"path's {p_rms:.3e}")
    out["bf16_distances"] = dist
    # the f32 twin: the widened weights' first 8 layers, the kernels (f32
    # K2 and K1 on the CUDA cores) against the plain attention
    cfg8 = dataclasses.replace(cfg32, n_layers=SURFACE_F32_LAYERS)
    params8 = {**params32, "layers": {
        k: v[:SURFACE_F32_LAYERS] for k, v in params32["layers"].items()}}
    twin = surface_distances(
        surface_scores(scoring, embeddings, cfg8, params8, prompts, False),
        surface_scores(scoring, embeddings, cfg8, params8, prompts, True))
    for key, d in twin.items():
        if not d["max"] <= SURFACE_F32_TOL:
            fail(f"surface f32 twin: {key}: the kernels and the plain "
                 f"attention differ by {d['max']:.3e} (> {SURFACE_F32_TOL})")
    out["f32_twin_kernel_vs_plain"] = twin
    del params32, params8, truth, plain
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# --- phase 4, multi-LoRA --------------------------------------------------------

# the lora runs: Llama-3-8B, 8 slots x 2048 rows, chunks of 256, the
# pipelined loop and the graph (the server's defaults); LORA_N random
# adapters (init_random_adapters: rank LORA_RANK on all seven targets,
# 83,886,080 bytes each in bf16), all registered on the host; the
# lora_mix server holds LORA_CACHE_MB of them resident (12)
LORA_ARGS = ["--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
             "--chunkedPrefill", "256"]
LORA_N, LORA_RANK, LORA_CACHE_MB = 32, 16, 960
# lora_mix: LORA_MIX_N requests, LORA_BASE_N on the base model, the rest
# on adapters drawn Zipf-like (s = LORA_ZIPF_S) over the LORA_N; prompts
# of LORA_PROMPTS tokens, LORA_MAX_NEW generated (128 until the decode
# modes' part took their time, 64 until the device phase took its time);
# at once, then Poisson arrivals at
# LORA_LOAD times the closed-loop rate (48 requests, 12 on the base,
# until the checkpoint phases took their time: the 24 still miss, upload
# and evict past the warm 12)
LORA_MIX_N, LORA_BASE_N, LORA_ZIPF_S = 24, 6, 1.0
# lora_mix's requests replayed alone: the first LORA_SOLO distinct
# (adapter or base) first requests, in request order
LORA_SOLO = 5
LORA_PROMPTS, LORA_MAX_NEW, LORA_LOAD = (64, 1025), 24, 1.2
# lora_dense, lora_oracle, lora_compose and lora_surface: LORA_SMALL
# requests (prompt length, adapter index or -1), LORA_SMALL_NEW tokens
# each, on the first LORA_FEW adapters
LORA_FEW, LORA_SMALL_NEW = 4, 32
LORA_SMALL = [(100, 0), (240, 1), (380, 2), (520, 3), (660, -1), (130, 0),
              (450, 1), (590, -1)]
# lora_oracle's f32 twin (the 8B's first 4 layers; 8 until the decode
# modes' part took their time): logprobs within LORA_F32_TOL of the
# merged weights'
LORA_F32_LAYERS, LORA_F32_TOL = 4, 1e-3
# lora_step: decode steps timed on the host clock, replays timed by
# CUDA events, with eight distinct adapters live and with none
LORA_STEP_PROMPT, LORA_STEP_STEPS, LORA_STEP_REPLAYS = 512, 32, 16
# lora_surface: the quota'd adapter (not among the LORA_SMALL ones), its
# request cost (prompt + max_new) and bucket
LORA_QUOTA_ADAPTER, LORA_QUOTA_PROMPT, LORA_QUOTA_NEW = 9, 64, 16
LORA_FILL_NEW = 128  # the eight base streams that hold every slot


def lora_mix_bodies(cfg) -> list[dict]:
    """lora_mix's requests: streamed, greedy, LORA_BASE_N of them on the
    base model at seeded positions, the others' adapters drawn
    Zipf-like."""
    import numpy as np

    rng = np.random.default_rng(SEED + 21)
    zipf = 1.0 / np.arange(1, LORA_N + 1) ** LORA_ZIPF_S
    base = set(rng.permutation(LORA_MIX_N)[:LORA_BASE_N].tolist())
    bodies = []
    for i in range(LORA_MIX_N):
        body = {"prompt": rng.integers(0, cfg.vocab_size, int(
                    rng.integers(*LORA_PROMPTS))).tolist(),
                "max_new": LORA_MAX_NEW, "stream": True}
        if i not in base:
            body["adapter"] = "adapter%d" % int(
                rng.choice(LORA_N, p=zipf / zipf.sum()))
        bodies.append(body)
    return bodies


def lora_small(cfg) -> list[tuple]:
    """LORA_SMALL's (prompt ids, adapter index) pairs, seeded."""
    import numpy as np

    rng = np.random.default_rng(SEED + 22)
    return [(rng.integers(0, cfg.vocab_size, n).tolist(), a)
            for n, a in LORA_SMALL]


def lora_body(prompt: list, adapter: int) -> dict:
    body = {"prompt": prompt, "max_new": LORA_SMALL_NEW, "stream": True,
            "logprobs": True}
    if adapter >= 0:
        body["adapter"] = f"adapter{adapter}"
    return body


def k1_counts(kernel_support, rpa) -> dict:
    """K1's launches since the last reset: total and per engine."""
    counts = kernel_support.launch_counts()
    return {"total": counts.get(rpa.NAME, 0),
            **{e: counts.get(kernel_support.engine_key(rpa.NAME, e), 0)
               for e in kernel_support.ENGINES}}


class LoraLaunches:
    """K1's launches over the lora runs: each run resets the counts when
    its server or batcher is up (the graph capture's warm-up steps are
    not the run's) and adds what it launched."""

    def __init__(self, kernel_support, rpa):
        self.ks, self.rpa = kernel_support, rpa
        self.runs: dict = {}

    def start(self) -> None:
        self.ks.reset_launch_counts()

    def stop(self, run: str) -> dict:
        got = k1_counts(self.ks, self.rpa)
        self.runs[run] = got
        return got

    def total(self) -> dict:
        keys = ("total", *self.ks.ENGINES)
        return {k: sum(r[k] for r in self.runs.values()) for k in keys}


def serve_batch(batching, params, cfg, small, **kw):
    """LORA_SMALL-style requests at once on a fresh 8-slot batcher (the
    server's shapes and loop); returns (streams [(tokens, logprobs)],
    the batcher)."""
    cb = batching.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                                    chunked_prefill=256, **kw)
    rids = [cb.submit(p, LORA_SMALL_NEW, adapter=a) for p, a in small]
    cb.run()
    return [(cb.done_requests[r].out, cb.done_requests[r].out_logp)
            for r in rids], cb


def lora_step(torch, batching, cfg, params, store, launches) -> dict:
    """The decode step with eight distinct adapters live against the
    same step with none, at batcher level: eight requests of
    LORA_STEP_PROMPT tokens; once all eight decode, LORA_STEP_STEPS steps
    on the host clock (median) and LORA_STEP_REPLAYS replays of the
    graph by CUDA events."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, cfg.vocab_size, LORA_STEP_PROMPT).tolist()
               for _ in range(8)]
    out = {}
    for arm in ("base", "adapters"):
        cb = batching.ContinuousBatcher(
            params, cfg, n_slots=8, max_len=2048, chunked_prefill=256,
            adapters=store.fork(cache_bytes=0) if arm == "adapters" else None)
        launches.start()
        for i, p in enumerate(prompts):
            cb.submit(p, 256, adapter=i if arm == "adapters" else -1)
        while cb.pending or cb.prefilling or len(cb.running) < 8:
            cb.step()
        host = []
        for _ in range(LORA_STEP_STEPS):
            t0 = time.perf_counter()
            cb.step()
            host.append(time.perf_counter() - t0)
        cb._flush_inflight()
        replay = _replay_ms(torch, cb.graph, LORA_STEP_REPLAYS)
        # the kernels one step launches: an eager step under the
        # profiler's host activity (its launch calls; no device tracing)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cb._eager_step()
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages() if e.key in (
            "cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
            "cudaLaunchKernelExC"))
        launches.stop(f"lora_step_{arm}")
        out[arm] = {"decode_step_host_ms_p50": 1e3 * float(np.median(host)),
                    "replay_device_ms": replay,
                    "kernels_a_step": kernels,
                    "graph_pool_bytes": cb.graph.pool_bytes}
        if arm == "adapters":
            st = cb.adapter_stats()
            if st["active"] != 8 or st["slot_copies"] != 8:
                fail(f"lora_step: {st['active']} adapters active, "
                     f"{st['slot_copies']} slots filled, not 8 and 8")
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    out["ratio_host"] = (out["adapters"]["decode_step_host_ms_p50"]
                         / out["base"]["decode_step_host_ms_p50"])
    out["ratio_device"] = (out["adapters"]["replay_device_ms"]
                           / out["base"]["replay_device_ms"])
    out["delta_kernels_a_step"] = (out["adapters"]["kernels_a_step"]
                                   - out["base"]["kernels_a_step"])
    row = {"phase": 4, "run": "lora_step", **out}
    emit(row)
    return row


def lora_mix(torch, server_mod, kernel_support, rpa, cfg, params, store,
             launches) -> dict:
    """lora_mix through the server (LORA_ARGS, ``--adapterCacheMB``
    LORA_CACHE_MB: 12 of the 32 adapters resident): the requests at
    once, then as Poisson arrivals at LORA_LOAD times that rate; every
    budget delivered, both passes' streams equal, K1's launches exactly
    the passes' steps and chunks (all on the tensor cores), every decode
    step a replay. The engine's steps are timed with the store's
    uploads in flight or not. Then the first LORA_SOLO distinct first
    requests (adapter or base) alone on the same server, bit for bit
    their streams (the base rows are held to the server without
    adapters); then
    a server without adapters on
    the same requests, each as a base request: its streams of the base
    requests equal, its decode step beside the adapters'."""
    import numpy as np

    bodies = lora_mix_bodies(cfg)
    mix = store.fork(cache_bytes=LORA_CACHE_MB << 20)
    args, server, url = start_server(
        server_mod, [*LORA_ARGS, "--adapterCacheMB", str(LORA_CACHE_MB)],
        params, adapters=mix)
    out = {"phase": 4, "run": "lora_mix", "requests": len(bodies),
           "base_requests": sum("adapter" not in b for b in bodies),
           "distinct_adapters": len({b["adapter"] for b in bodies
                                     if "adapter" in b}),
           "resident_at_start": mix.resident_count()}
    cb = server.engine.cb
    steps: list = []
    step = cb.step

    def timed_step():
        busy = mix.uploads_in_flight()
        t0 = time.perf_counter()
        n = step()
        steps.append((time.perf_counter() - t0,
                      bool(busy or mix.uploads_in_flight())))
        return n

    cb.step = timed_step
    try:
        launches.start()
        passes = {}
        for run in ("closed", "open"):
            if run == "closed":
                offsets = [0.0] * len(bodies)
            else:
                rate = LORA_LOAD * passes["closed"]["requests_per_s"]
                offsets = np.cumsum(np.random.default_rng(SEED + 24)
                                    .exponential(1 / rate, len(bodies)))
            results = [None] * len(bodies)
            t0 = time.perf_counter()

            def worker(i):
                time.sleep(max(0.0, t0 + offsets[i] - time.perf_counter()))
                results[i] = _post(url, bodies[i])

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(bodies))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t0
            if any(r is None or len(r["tokens"]) != LORA_MAX_NEW
                   for r in results):
                fail(f"lora_mix {run}: a request failed or came back short")
            ttft = {k: [r["ttft"] for r, b in zip(results, bodies)
                        if ("adapter" in b) == (k == "adapter")]
                    for k in ("base", "adapter")}
            passes[run] = {"wall_s": wall,
                           "requests_per_s": len(bodies) / wall,
                           "ttft_s": {k: {"p50": percentile(v, 50),
                                          "p99": percentile(v, 99)}
                                      for k, v in ttft.items()},
                           "tokens": [r["tokens"] for r in results]}
        if passes["open"]["tokens"] != passes["closed"]["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(
                passes["open"]["tokens"], passes["closed"]["tokens"]))
                if a != b]
            fail(f"lora_mix: the open-loop streams {bad} differ from the "
                 "closed-loop ones")
        _, health = get_health(url)
        dec = health["decode"]["graph"]
        if dec is None or dec["replays"] != health["decode_steps"]:
            fail(f"lora_mix: {health['decode_steps']} decode steps, "
                 f"graph {dec}: every step must be a replay")
        out["k1"] = route_launches(
            "lora_mix", kernel_support, rpa, "dense", cfg.n_layers,
            health["decode_steps"], health["prefill_chunks"])
        launches.stop("lora_mix")
        ad = health["adapters"]
        defer = ad["deferrals"]
        if not (ad["misses"] > 0 and ad["uploads"] > out["resident_at_start"]
                and ad["evictions"] > 0 and defer.get("adapter_miss", 0) > 0):
            fail(f"lora_mix: misses, uploads past the warm set, evictions "
                 f"and adapter_miss deferrals must all be > 0: {ad}")
        out["adapters"] = ad
        out["decode_step_ms_mean"] = health["decode_step_ms_mean"]
        out["decode_steps"] = health["decode_steps"]
        out["prefill_chunks"] = health["prefill_chunks"]
        out["prefix_cache"] = health.get("prefix_cache")
        for run, p in passes.items():
            out[run] = {k: v for k, v in p.items() if k != "tokens"}
        busy = [dt for dt, up in steps if up]
        idle = [dt for dt, up in steps if not up]
        out["engine_step_ms"] = {
            "steps": len(steps),
            "steps_with_upload_in_flight": len(busy),
            **{f"{k}_{name}": (1e3 * f(xs) if xs else None)
               for name, xs in (("all", [dt for dt, _ in steps]),
                                ("with_upload", busy),
                                ("without_upload", idle))
               for k, f in (("p50", lambda x: percentile(x, 50)),
                            ("p99", lambda x: percentile(x, 99)),
                            ("max", max))}}
        # alone in the same server: the first LORA_SOLO distinct first
        # requests (the base rows are all held to the server without
        # adapters below)
        t_solo = time.perf_counter()
        firsts = {}
        for i, body in enumerate(bodies):
            firsts.setdefault(body.get("adapter"), i)
        solo = sorted(firsts.values())[:LORA_SOLO]
        for i in solo:
            body = bodies[i]
            alone = _post(url, body)["tokens"]
            if alone != passes["closed"]["tokens"][i]:
                j = first_divergence(alone, passes["closed"]["tokens"][i])
                fail(f"lora_mix: request {i} ({body.get('adapter', 'base')})"
                     f" alone differs from its batched stream at token {j}")
        out["solo_s"] = time.perf_counter() - t_solo
        out["streams_equal_solo"] = len(solo)
    finally:
        cb.step = step
        server.stop()
    del server, cb, mix
    gc.collect()
    torch.cuda.empty_cache()
    # the same requests on a server without adapters, all as base ones
    args, server, url = start_server(server_mod, LORA_ARGS, params)
    try:
        plain = [{k: v for k, v in b.items() if k != "adapter"}
                 for b in bodies]
        got = post_all(url, plain, "lora_mix_base_server")
        for i, (b, r) in enumerate(zip(bodies, got)):
            if "adapter" not in b and r["tokens"] != \
                    passes["closed"]["tokens"][i]:
                fail(f"lora_mix: base request {i} differs from the "
                     "no-adapter server's stream")
        _, health = get_health(url)
        out["base_server"] = {
            "decode_step_ms_mean": health["decode_step_ms_mean"],
            "decode_steps": health["decode_steps"],
            "base_streams_equal": out["base_requests"]}
    finally:
        server.stop()
    out["decode_step_ratio"] = (out["decode_step_ms_mean"]
                                / out["base_server"]["decode_step_ms_mean"])
    del server
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def lora_dense(torch, batching, cfg, params, aset, small, launches) -> dict:
    """The same LORA_FEW adapters in dense-N mode and gathered (K = 8,
    and K = 2, which defers on ``adapter_slots``), at pipeline depth 0
    and 1: tokens and logprobs equal bit for bit across all five."""
    arms = {"dense_depth0": dict(lora_slots=0, pipeline_depth=0),
            "dense_depth1": dict(lora_slots=0, pipeline_depth=1),
            "gathered_depth0": dict(pipeline_depth=0),
            "gathered_depth1": dict(pipeline_depth=1),
            "gathered_k2_depth1": dict(lora_slots=2, pipeline_depth=1)}
    streams, stats = {}, {}
    for arm, kw in arms.items():
        launches.start()
        streams[arm], cb = serve_batch(batching, params, cfg, small,
                                       adapters=aset, **kw)
        launches.stop(f"lora_dense_{arm}")
        stats[arm] = cb.adapter_stats()
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    first = next(iter(streams.values()))
    for arm, got in streams.items():
        if got != first:
            fail(f"lora_dense: {arm}'s streams differ from dense_depth0's")
    k2 = stats["gathered_k2_depth1"]["deferrals"].get("adapter_slots", 0)
    if not k2:
        fail("lora_dense: K = 2 under four adapters never deferred on "
             "adapter_slots")
    row = {"phase": 4, "run": "lora_dense", "arms": list(arms),
           "equal_bitwise": True, "requests": len(small),
           "adapter_slots_deferrals_k2": k2,
           "gathers": {a: s.get("gathers") for a, s in stats.items()},
           "slot_copies": {a: s.get("slot_copies") for a, s in stats.items()}}
    emit(row)
    return {**row, "streams": first}


def lora_oracle(torch, server_mod, batching, generate, lora, ls, cfg,
                params, entries, small, launches) -> dict:
    """Each of LORA_FEW adapters against a plain server of
    ``merge_lora(base, adapter)`` weights: on the bf16 8B model, the
    served streams (the adapter server, the requests at once) against
    the merged server's, reported up to the first divergence with each
    path's f32 logit gap between the two tokens there (bf16 rounds the
    merged weights otherwise than x @ W + x @ A @ B: a near tie flips);
    on a LORA_F32_LAYERS-layer f32 twin, tokens equal and logprobs
    within LORA_F32_TOL, at batcher level."""
    reqs = [(p, a) for p, a in small if a >= 0][:LORA_FEW]
    aset = ls.stack_adapters(cfg, entries[:LORA_FEW])
    launches.start()
    args, server, url = start_server(server_mod, LORA_ARGS, params,
                                     adapters=aset)
    try:
        served = post_all(url, [lora_body(p, a) for p, a in reqs],
                          "lora_oracle_adapters")
    finally:
        server.stop()
    launches.stop("lora_oracle_adapters")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = []
    for (p, a), got in zip(reqs, served):
        name, lp, lc = entries[a]
        merged = lora.merge_lora(params, lp, lc)
        launches.start()
        args, server, url = start_server(server_mod, LORA_ARGS, merged)
        try:
            want = _post(url, lora_body(p, -1))
        finally:
            server.stop()
        launches.stop(f"lora_oracle_merged_{a}")
        j = first_divergence(got["tokens"], want["tokens"])
        row = {"adapter": name, "first_divergence": j}
        if j is not None:
            ctx = p + want["tokens"][:j]
            g, w = got["tokens"][j], want["tokens"][j]
            l_m = plain_logits(torch, generate, cfg, merged, ctx)
            one = ls.attach_adapters(params, ls.stack_adapters(
                cfg, [entries[a]]))
            dev = params["embed"].device
            toks = torch.tensor([ctx], device=dev)
            cache = generate.KVCache.init(cfg, 1, len(ctx), dev)
            l_a = generate._forward_cached(
                one, toks, cache, 0, cfg, last_only=True,
                plain_attention=True,
                lora_sel=torch.ones((1, 1), device=dev))[0, -1].float()
            gaps = {k: float((x[g] - x[w]).abs()) for k, x in
                    (("adapter", l_a), ("merged", l_m))}
            rms = float((l_a - l_m).pow(2).mean().sqrt())
            row.update(got=g, want=w, logit_gap=gaps,
                       within_near_tie={k: v <= NEAR_TIE
                                        for k, v in gaps.items()},
                       logits_rms_apart=rms,
                       gap_over_rms_apart={k: v / rms
                                           for k, v in gaps.items()})
            del one, cache, l_a, l_m
        bf16.append(row)
        del merged, server
        gc.collect()
        torch.cuda.empty_cache()
    # the f32 twin: the first LORA_F32_LAYERS layers, weights and
    # factors widened
    n = min(LORA_F32_LAYERS, cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=n)
    params32 = {k: v.float() for k, v in params.items() if k != "layers"}
    params32["layers"] = {k: v[:n].float()
                          for k, v in params["layers"].items()}
    ents32 = [(name, {t: {"a": ab["a"][:n].float(), "b": ab["b"][:n].float()}
                      for t, ab in lp.items()}, lc)
              for name, lp, lc in entries[:LORA_FEW]]
    launches.start()
    twin, _ = serve_batch(batching, params32, cfg32, reqs,
                          adapters=ls.stack_adapters(cfg32, ents32))
    launches.stop("lora_oracle_f32_adapters")
    f32_err = 0.0
    for (p, a), (toks, lps) in zip(reqs, twin):
        merged = lora.merge_lora(params32, ents32[a][1], ents32[a][2])
        launches.start()
        [(want_t, want_l)], cb = serve_batch(batching, merged, cfg32,
                                             [(p, -1)])
        launches.stop(f"lora_oracle_f32_merged_{a}")
        if toks != want_t:
            fail(f"lora_oracle f32: adapter{a}'s stream differs from its "
                 f"merged weights' at token {first_divergence(toks, want_t)}")
        err = max(abs(x - y) for x, y in zip(lps, want_l))
        if err > LORA_F32_TOL:
            fail(f"lora_oracle f32: adapter{a}'s logprobs differ from the "
                 f"merged weights' by {err:.3e} (> {LORA_F32_TOL})")
        f32_err = max(f32_err, err)
        del merged, cb
        gc.collect()
        torch.cuda.empty_cache()
    del params32, ents32
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 4, "run": "lora_oracle", "bf16": bf16,
           "bf16_streams_equal": sum(r["first_divergence"] is None
                                     for r in bf16),
           "f32_twin": {"layers": n, "streams_equal": len(reqs),
                        "logprob_max_err": f32_err, "tol": LORA_F32_TOL}}
    emit(row)
    return row


def lora_compose(torch, server_mod, quantized_serving, cfg, params, store,
                 small, launches) -> dict:
    """Adapters on the paged int8 pool and on int8 weights, the
    LORA_SMALL requests at once: paged int8 equals dense int8 bit for bit
    (phase 4 holds paged equal to dense); each against the dense bf16
    run (which lora_surface's streams must equal) is reported, tokens
    equal a request."""
    runs = {"dense_bf16": [], "dense_int8": ["--cacheQuant", "int8"],
            "paged_int8": ["--kvLayout", "paged", "--kvPageSize", "64",
                           "--cacheQuant", "int8"],
            "w8": ["--weightQuant", "int8"]}
    bodies = [lora_body(p, a) for p, a in small]
    got = {}
    for run, flags in runs.items():
        w = (quantized_serving.quantize_weights(params, "int8")
             if run == "w8" else params)
        args, server, url = start_server(server_mod, [*LORA_ARGS, *flags], w,
                                         adapters=store.fork(cache_bytes=0))
        launches.start()
        try:
            got[run] = post_all(url, bodies, f"lora_compose_{run}")
        finally:
            server.stop()
        launches.stop(f"lora_compose_{run}")
        del server, w
        gc.collect()
        torch.cuda.empty_cache()
    equal_streams("lora_compose paged_int8", got["paged_int8"],
                  got["dense_int8"], logprobs=True)

    def agree(a, b):
        return [sum(x == y for x, y in zip(r["tokens"], s["tokens"]))
                for r, s in zip(a, b)]

    row = {"phase": 4, "run": "lora_compose",
           "paged_int8_equals_dense_int8": True,
           "tokens_equal_to_dense_bf16": {
               run: agree(got[run], got["dense_bf16"])
               for run in ("dense_int8", "paged_int8", "w8")},
           "tokens_a_request": LORA_SMALL_NEW}
    emit(row)
    return {**row, "dense_bf16": got["dense_bf16"]}


def lora_surface(torch, server_mod, batching, prefix_cache_mod, cfg, params,
                 store, entries, small, dense_bf16, launches) -> dict:
    """The adapter surface of both APIs, on a server with an
    ``adapter.upload`` fault (the first adapter admission defers) and a
    quota on adapter LORA_QUOTA_ADAPTER: the LORA_SMALL requests equal
    lora_compose's dense bf16 streams bit for bit; the OpenAI ``model``
    naming an adapter gives its native stream's logprobs; ``/v1/models``
    lists every adapter; unknown names answer 404 (OpenAI) and 400
    (native); ``/v1/health``'s ``adapters`` and the seven
    ``gpu_serving_adapter*`` families are set; a queued quota'd request
    leaves the bucket short, the next answers 429 ``adapter_quota``, the
    queued one's cancel refunds it and the next is served. Then, at
    batcher level, an adapter registered at run time serves (its stream
    the same factors' under their first index), its unregistration is
    refused while it is live and evicts its prefix root after."""
    import urllib.error

    qname = f"adapter{LORA_QUOTA_ADAPTER}"
    cost = LORA_QUOTA_PROMPT + LORA_QUOTA_NEW
    launches.start()
    args, server, url = start_server(server_mod, [
        *LORA_ARGS, "--faults", "adapter.upload:nth=1", "--adapterQuota",
        f"{qname}=0.001:burst={cost + cost // 2}"], params,
        adapters=store.fork(cache_bytes=0))
    out = {"phase": 4, "run": "lora_surface"}
    try:
        got = post_all(url, [lora_body(p, a) for p, a in small],
                       "lora_surface_fault")
        equal_streams("lora_surface (adapter.upload fault)", got, dense_bf16,
                      logprobs=True)
        p1, a1 = next((p, a) for p, a in small if a == 1)
        native = next(g for g, (p, a) in zip(got, small) if a == 1)
        oai, _ = _oai(url, "/v1/completions", {
            "model": "adapter1", "prompt": p1, "max_tokens": LORA_SMALL_NEW,
            "logprobs": 0})
        lps = oai["choices"][0]["logprobs"]["token_logprobs"]
        if oai["model"] != "adapter1" or lps != native["logprobs"]:
            fail("lora_surface: the OpenAI model field did not serve "
                 "adapter1's stream")
        ids = [m["id"] for m in get_json(url, "/v1/models")["data"]]
        if ids != ["tpu-serving", *[f"adapter{i}" for i in range(LORA_N)]]:
            fail(f"lora_surface: /v1/models lists {ids[:4]}...")
        for path, body, code in (
                ("/v1/completions", {"model": "nope", "prompt": p1,
                                     "max_tokens": 2}, 404),
                ("/v1/generate", {"prompt": p1, "max_new": 2,
                                  "adapter": "nope"}, 400)):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=60)
                fail(f"lora_surface: an unknown name on {path} was served")
            except urllib.error.HTTPError as e:
                if e.code != code:
                    fail(f"lora_surface: an unknown name on {path} answered "
                         f"{e.code}, not {code}")
        _, health = get_health(url)
        ad = health["adapters"]
        if ad["deferrals"].get("adapter_miss", 0) < 1 or ad["gathers"] < 1:
            fail(f"lora_surface: the injected upload fault did not defer: "
                 f"{ad}")
        out["health_adapters"] = ad
        text = scrape(url, False)
        families = {}
        for line in text.splitlines():
            if line.startswith("gpu_serving_adapter"):
                key, val = line.rsplit(" ", 1)
                fam = key.split("{")[0]
                for suffix in ("_count", "_sum", "_bucket"):
                    fam = fam[:-len(suffix)] if fam.endswith(suffix) else fam
                families[fam] = max(families.get(fam, 0.0), float(val))
        want = {"gpu_serving_adapters_registered",
                "gpu_serving_adapters_resident",
                "gpu_serving_adapter_resident_bytes",
                "gpu_serving_adapter_uploads_total",
                "gpu_serving_adapter_upload_seconds",
                "gpu_serving_adapter_deferred_total",
                "gpu_serving_adapter_gathers_total"}
        unset = sorted(f for f in want if not families.get(f))
        if unset:
            fail(f"lora_surface: /metrics families not set: {unset}")
        out["metrics"] = {f: families[f] for f in sorted(want)}
        # the quota: eight long base streams hold every slot
        import numpy as np

        rng = np.random.default_rng(SEED + 25)
        fillers = [{"prompt": rng.integers(0, cfg.vocab_size, 64).tolist(),
                    "max_new": LORA_FILL_NEW, "stream": True}
                   for _ in range(8)]
        side = threading.Thread(target=post_all,
                                args=(url, fillers, "lora_surface_fill"))
        side.start()
        deadline = time.perf_counter() + 120
        while get_health(url)[1]["active"] < 8:
            if time.perf_counter() > deadline:
                fail("lora_surface: the fillers never held all eight slots")
            time.sleep(0.02)
        engine = server.engine
        qidx = engine.cb.adapter_names.index(qname)
        qprompt = rng.integers(0, cfg.vocab_size,
                               LORA_QUOTA_PROMPT).tolist()
        eid, _ = engine.submit(qprompt, LORA_QUOTA_NEW, adapter=qidx)

        def quota():
            return get_health(url)[1]["sched"]["adapters"].get(qname, {})

        while quota().get("submitted", 0) < 1:
            if time.perf_counter() > deadline:
                fail("lora_surface: the queued quota'd request was never "
                     "charged")
            time.sleep(0.01)
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": qprompt, "max_new": LORA_QUOTA_NEW,
                 "adapter": qname}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            fail("lora_surface: the over-quota request was served")
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            if e.code != 429 or body.get("reason") != "adapter_quota" or \
                    "Retry-After" not in e.headers:
                fail(f"lora_surface: over quota answered {e.code} {body}")
        engine.cancel(eid)
        while quota()["quota_level"] < cost:
            if time.perf_counter() > deadline:
                fail("lora_surface: the cancelled request's charge was "
                     "not refunded")
            time.sleep(0.01)
        refunded = quota()
        served = _post(url, {"prompt": qprompt, "max_new": LORA_QUOTA_NEW,
                             "adapter": qname})
        side.join(900)
        if len(served["tokens"]) != LORA_QUOTA_NEW:
            fail("lora_surface: the refunded quota did not serve")
        out["quota"] = {"adapter": qname, "cost": cost,
                        "after_refund": refunded,
                        "final": quota(),
                        "rejections": get_health(url)[1]["sched"][
                            "rejections"]["adapter_quota"]}
    finally:
        server.stop()
    launches.stop("lora_surface")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    # run-time registration at batcher level, with the prefix cache
    pc = prefix_cache_mod.PrefixCache(
        cfg, buckets=batching.DEFAULT_PROMPT_BUCKETS, budget_bytes=256 << 20)
    launches.start()
    cb = batching.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                                    chunked_prefill=256,
                                    adapters=store.fork(cache_bytes=0),
                                    prefix_cache=pc)
    name0, lp0, lc0 = entries[0]
    late = cb.register_adapter("late", lp0, lc0)
    prompt = small[2][0]
    rid = cb.submit(prompt, LORA_SMALL_NEW, adapter=late)
    cb.step()
    try:
        cb.unregister_adapter("late")
        fail("lora_surface: a live adapter was unregistered")
    except ValueError:
        pass
    cb.run()
    twin = cb.submit(prompt, LORA_SMALL_NEW, adapter=0)
    cb.run()
    if cb.done_requests[rid].out != cb.done_requests[twin].out:
        fail("lora_surface: the adapter registered at run time does not "
             "serve its factors' stream")
    before = pc.stats.as_dict()["entries"]
    cb.unregister_adapter("late")
    after = pc.stats.as_dict()["entries"]
    if not before > after or "late" in cb.adapter_names:
        fail(f"lora_surface: unregistering left the prefix root "
             f"({before} -> {after} entries)")
    launches.stop("lora_surface_register")
    out["register"] = {"index": late, "prefix_entries_before": before,
                       "prefix_entries_after": after}
    del cb, pc
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_lora(torch, server_mod, batching, generate, lora, ls,
               quantized_serving, prefix_cache_mod, kernel_support, rpa,
               cfg, params) -> dict:
    """Multi-LoRA on the 8B weights: LORA_N random adapters registered
    once on the host (pinned), each run's store a fork of that registry;
    then lora_step, lora_mix, lora_dense, lora_oracle, lora_compose and
    lora_surface. Returns K1's launches over all of them and the
    headline numbers."""
    t0 = time.perf_counter()
    entries = ls.init_random_adapters(cfg, LORA_N, LORA_RANK, seed=SEED + 20,
                                      device=params["embed"].device)
    store = ls.AdapterStore(cfg)
    for name, lp, lc in entries:
        store.register(name, lp, lc)
    if params["embed"].device.type == "cuda":
        store.pin_host()
    # rank x (d_in + d_out) a target a layer, bf16: 83,886,080 bytes at
    # Llama-3-8B's widths
    want = cfg.n_layers * LORA_RANK * sum(
        d_in + d_out for d_in, d_out in lora.target_dims(cfg).values()) * 2
    if store.adapter_bytes != want:
        fail(f"lora: an adapter holds {store.adapter_bytes} bytes, not "
             f"{want}")
    entries = entries[:LORA_FEW]
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    small = lora_small(cfg)
    launches = LoraLaunches(kernel_support, rpa)
    step = lora_step(torch, batching, cfg, params, store, launches)
    mix = lora_mix(torch, server_mod, kernel_support, rpa, cfg, params, store,
                   launches)
    dense = lora_dense(torch, batching, cfg, params,
                       ls.stack_adapters(cfg, entries), small, launches)
    oracle = lora_oracle(torch, server_mod, batching, generate, lora, ls, cfg,
                         params, entries, small, launches)
    compose = lora_compose(torch, server_mod, quantized_serving, cfg, params,
                           store, small, launches)
    if compose["dense_bf16"] and dense["streams"]:
        # the server's dense bf16 streams are the batcher's (one engine)
        want = [s[0] for s in dense["streams"]]
        if [r["tokens"] for r in compose["dense_bf16"]] != want:
            fail("lora: the dense bf16 server's streams differ from the "
                 "batcher's")
    surface = lora_surface(torch, server_mod, batching, prefix_cache_mod, cfg,
                           params, store, entries, small,
                           compose["dense_bf16"], launches)
    k1 = launches.total()
    if k1["cuda_cores"] != sum(r["cuda_cores"] for run, r in
                               launches.runs.items() if "f32" in run) \
            or k1["total"] != k1["tensor_cores"] + k1["cuda_cores"]:
        fail(f"lora: a bf16 K1 launch ran on the CUDA cores: {launches.runs}")
    row = {"phase": 4, "run": "lora", "setup_s": setup_s,
           "wall_s": time.perf_counter() - t0,
           "adapter_bytes": store.adapter_bytes, "k1_launches": k1,
           "k1_launches_by_run": launches.runs,
           "decode_step_8_adapters": step,
           "upload_ms_p99": mix["adapters"]["upload_ms_p99"]}
    emit(row)
    del store, entries
    gc.collect()
    torch.cuda.empty_cache()
    return {**row, "mix": mix, "dense": dense, "oracle": oracle,
            "compose": compose, "surface": surface}


# --- phase 5 -----------------------------------------------------------------


#: phase 5's serving shapes of K2: B 1 at the padded scoring and
#: embedding buckets (64 also serves bucket 32)
# KV page export and install (``kv_*``, ``phase_kv``): pairs of servers
# sharing the 8B weights, a stream exported from A and continued on B;
# then batcher pairs on int8 and int4 pools
KV_ARGS = ["--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
           "--kvLayout", "paged", "--kvPageSize", "64", "--prefixCacheOff"]
KV_MAX_NEW = 32
KV_EXPORT_AT = 3       # tokens streamed before the export
# the hops: (prompt length, body knobs, pipeline depth of the pair)
KV_HOPS = [(512, {}, 1),
           (1024, {"seed": 11, "temperature": 0.8}, 1),
           (1536, {"repetition_penalty": 1.3}, 1),
           (1900, {}, 0)]
KV_FILLERS = 3         # streams decoding on the depth-1 B during its hops
KV_FILLER_PROMPT, KV_FILLER_NEW = 256, 400
KV_QUANT_PROMPT = 1536


def kv_body(cfg, plen: int, knobs: dict) -> dict:
    import numpy as np

    prompt = np.random.default_rng(SEED + 30 + plen).integers(
        1, cfg.vocab_size, plen).tolist()
    return {"prompt": prompt, "max_new": KV_MAX_NEW, "logprobs": True,
            **knobs}


def _post_raw(url: str, path: str, data: bytes) -> tuple:
    """(status, body bytes) of one POST, an HTTP error's too."""
    import urllib.error

    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def split_export(data: bytes) -> tuple:
    """An export's answer (``{"kv_pages": blob, "resume_out",
    "resume_logprobs", "id"}``, the blob's keys in ``pack_kv_wire``'s
    order) -> (the blob's JSON bytes, its metadata, the resume fields),
    without parsing the planes' payloads: the resubmission splices the
    blob's bytes as they came."""
    head = b'{"kv_pages": '
    cut = data.rindex(b', "resume_out": ')
    blob = data[len(head):cut]
    meta = json.loads(blob[:blob.index(b', "planes": ')] + b"}")
    tail = json.loads(b"{" + data[cut + 2:])
    return blob, meta, {k: tail[k] for k in ("resume_out",
                                             "resume_logprobs")}


def kv_resubmit(body: dict, resume: dict, blob: "bytes | None") -> bytes:
    """The resubmission's body: ``body`` streamed, the resume fields and,
    given, the blob's bytes spliced in as ``kv_pages``."""
    head = json.dumps({**body, **resume, "stream": True}).encode()
    if blob is None:
        return head
    return head[:-1] + b', "kv_pages": ' + blob + b"}"


def stream_and_export(url: str, body: dict) -> tuple:
    """Stream ``body`` from ``url`` and export it after KV_EXPORT_AT
    tokens. Returns (the blob's bytes, its metadata, the resume fields,
    a row: the export's wall time (the POST and its body read), its bytes
    on the wire, the tokens streamed, a second export's status)."""
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    got, data, row = [], None, {}
    with urllib.request.urlopen(req, timeout=900) as resp:
        eid = int(resp.headers["X-Request-Id"])
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if "error" in evt:
                fail(f"kv: stream error frame {evt['error']}")
            if evt.get("done"):
                break
            got.append(evt["token"])
            if len(got) == KV_EXPORT_AT and data is None:
                t0 = time.perf_counter()
                status, data = _post_raw(url, f"/v1/kv/export/{eid}", b"")
                row["export_ms"] = 1e3 * (time.perf_counter() - t0)
                if status != 200:
                    fail(f"kv: the export answered {status}: {data[:300]!r}")
                row["wire_bytes"] = len(data)
    if data is None:
        fail(f"kv: the stream ended after {len(got)} tokens, before its "
             "export")
    blob, meta, resume = split_export(data)
    if resume["resume_out"][:len(got)] != got:
        fail(f"kv: the stream delivered {got}, not a prefix of the "
             f"export's resume_out {resume['resume_out']}")
    row["streamed"] = len(got)
    row["second_export_status"] = _post_raw(
        url, f"/v1/kv/export/{eid}", b"")[0]
    if row["second_export_status"] != 404:
        fail(f"kv: a second export answered {row['second_export_status']}")
    return blob, meta, resume, row


def k1_window(kernel_support, rpa, run: str, h0: dict, h1: dict,
              chunks: int, route: str = "paged") -> dict:
    """K1's launches between two idle points of a batcher (its decode
    steps and prefill chunks at ``h0`` and ``h1``, counts reset at
    ``h0``): one a layer for every decode step and prefill chunk, on
    ``route`` and the tensor cores; exactly ``chunks`` prefill chunks;
    every decode launch split."""
    steps = h1["decode_steps"] - h0["decode_steps"]
    got = h1["prefill_chunks"] - h0["prefill_chunks"]
    if got != chunks:
        fail(f"{run}: {got} prefill chunks, expected {chunks}")
    out = route_launches(run, kernel_support, rpa, route, 32, steps, chunks)
    split = kernel_support.launch_counts().get(rpa.SPLIT_KEY, 0)
    if split != 32 * steps:
        fail(f"{run}: {split} split launches for {steps} decode steps")
    return {**out, "decode_steps": steps, "prefill_chunks": chunks,
            "split_launches": split}


def spliced(want: dict, resume: dict, got: dict) -> dict:
    """A resumed stream against the uninterrupted one: the resumed tokens
    and logprobs, then the resubmission's."""
    tokens = resume["resume_out"] + got["tokens"]
    lps = resume["resume_logprobs"] + got["logprobs"]
    return {"tokens_equal": tokens == want["tokens"],
            "logprobs_equal": lps == want["logprobs"],
            "first_divergence": first_divergence(tokens, want["tokens"]),
            "logprob_max_abs_diff": max(
                abs(x - y) for x, y in zip(lps, want["logprobs"]))}


class KvLoad:
    """KV_FILLERS streams kept decoding on a server (each thread starts
    the next when one ends) while its installs land, and its engine's
    steps timed with an install in them or not."""

    def __init__(self, cfg, server, url: str):
        self.server, self.url = server, url
        self.cb = server.engine.cb
        self.steps, self.installs = [], []
        self.stop = threading.Event()
        self.bodies = [{**kv_body(cfg, KV_FILLER_PROMPT + i, {}),
                        "max_new": KV_FILLER_NEW} for i in range(KV_FILLERS)]

    def _fill(self, body: dict) -> None:
        while not self.stop.is_set():
            read_frames(self.url, body)

    def __enter__(self) -> "KvLoad":
        cb = self.cb
        self.step, self.install = cb.step, cb.install_kv_pages

        def marked(req, slot):
            self.installs.append(time.perf_counter())
            return self.install(req, slot)

        def timed_step():
            n = len(self.installs)
            t0 = time.perf_counter()
            out = self.step()
            self.steps.append((time.perf_counter() - t0,
                               len(self.installs) > n))
            return out

        cb.step, cb.install_kv_pages = timed_step, marked
        self.threads = [threading.Thread(target=self._fill, args=(b,))
                        for b in self.bodies]
        for th in self.threads:
            th.start()
        t0 = time.perf_counter()
        while len(cb.running) < KV_FILLERS:
            if time.perf_counter() - t0 > 120:
                fail("kv_load: the filler streams never all decoded")
            time.sleep(0.01)
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        engine = self.server.engine
        for th in self.threads:
            while th.is_alive():
                try:  # the engine thread admits and retires meanwhile
                    eids = list(engine._rid_to_eid.values())
                except RuntimeError:
                    continue
                for eid in eids:
                    engine.cancel(eid)
                th.join(0.5)
        self.cb.step, self.cb.install_kv_pages = self.step, self.install

    def row(self) -> dict:
        with_i = [dt for dt, inst in self.steps if inst]
        without = [dt for dt, inst in self.steps if not inst]
        return {"fillers": KV_FILLERS, "installs": len(self.installs),
                "steps": len(self.steps),
                "step_ms_p50_with_install": 1e3 * percentile(with_i, 50),
                "step_ms_p50_without": 1e3 * percentile(without, 50),
                "step_ms_max_with_install": 1e3 * max(with_i)}


def kv_hop(kernel_support, rpa, cfg, pair: list, plen: int, knobs: dict,
           depth: int, decode_s: list, idle: bool) -> dict:
    """One hop: the uninterrupted run on B, the stream on A exported after
    KV_EXPORT_AT tokens, its resubmission to B with the pages (spliced =
    uninterrupted, bit for bit) and without them (the re-prefill resume,
    reported against the uninterrupted stream). On an ``idle`` B, K1's
    launches of each: no prefill chunk for the install, ceil(folded /
    256) for the re-prefill."""
    (_, a_url), (_, b_url) = pair
    run = f"kv_http_{plen}"
    body = kv_body(cfg, plen, knobs)
    want = _post(b_url, body)
    blob, meta, resume, row = stream_and_export(a_url, body)
    folded = plen + len(resume["resume_out"])
    for kind, kv, chunks in (("install", blob, 0),
                             ("reprefill", None, -(-folded // 256))):
        if idle:
            _, h0 = get_health(b_url)
            kernel_support.reset_launch_counts()
        n = len(decode_s)
        t0 = time.perf_counter()
        r = _post(b_url, {"stream": True}, kv_resubmit(body, resume, kv))
        row[kind] = {"first_token_ms": 1e3 * (r["token_times"][0] - t0),
                     **spliced(want, resume, r)}
        if idle:
            _, h1 = get_health(b_url)
            row[kind]["k1"] = k1_window(kernel_support, rpa,
                                        f"{run}_{kind}", h0, h1, chunks)
        if kind == "install":
            row[kind]["request_thread_decode_ms"] = 1e3 * decode_s[n]
    if not (row["install"]["tokens_equal"]
            and row["install"]["logprobs_equal"]):
        fail(f"{run}: the spliced stream differs from the uninterrupted "
             f"one: {row['install']}")
    out = {"phase": 4, "run": run, "pipeline_depth": depth, "knobs": knobs,
           "beside_live_streams": 0 if idle else KV_FILLERS,
           "resumed": len(resume["resume_out"]),
           "blob_tokens": meta["tokens"], "blob_pages": meta["n_pages"],
           # the wire's bytes a token: bf16 K and V, every layer
           "raw_bytes": meta["n_pages"] * meta["page_size"]
           * TOKEN_BYTES["none"], **row}
    emit(out)
    return out


def kv_quant(torch, batching, kernel_support, rpa, cfg, params,
             quant: str) -> dict:
    """``kv_quant``: two batchers on a ``quant`` pool (pages of 64, 8
    slots x 2048, chunks of 256): a seeded 1536-token stream exported
    after KV_EXPORT_AT tokens on one and installed on the other is the
    other's uninterrupted run bit for bit (no prefill chunk, every K1
    launch a split decode on the tensor cores); a re-export of the
    installed stream gives the original blob's full pages byte for
    byte, every plane."""
    from k8s_gpu_device_plugin_torch.models import paging
    from k8s_gpu_device_plugin_torch.models.sampling import Sampler

    qcfg = dataclasses.replace(cfg, cache_quant=quant)
    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
              kv_layout="paged", kv_page_size=64)
    req = dict(sampler=Sampler(temperature=0.8), seed=5)
    prompt = kv_body(cfg, KV_QUANT_PROMPT, {})["prompt"]
    src = batching.ContinuousBatcher(params, qcfg, **kw)
    dst = batching.ContinuousBatcher(params, qcfg, **kw)
    graph = dst.graph
    rid = dst.submit(prompt, KV_MAX_NEW, **req)
    dst.run()
    want = dst.done_requests[rid]
    rid = src.submit(prompt, KV_MAX_NEW, **req)
    while not any(r.rid == rid and len(r.out) >= KV_EXPORT_AT
                  for r in src.running.values()):
        src.step()
    t0 = time.perf_counter()
    blob, out, lps = src.export_kv_pages(rid)
    export_ms = 1e3 * (time.perf_counter() - t0)
    src.cancel(rid)
    src.run()
    steps0, chunks0 = dst.decode_steps, dst.prefill_chunks
    kernel_support.reset_launch_counts()
    rid = dst.submit(prompt, KV_MAX_NEW, resume_out=out, resume_logp=lps,
                     kv_pages=blob, **req)
    dst.run()
    got = dst.done_requests[rid]
    run = f"kv_quant_{quant}"
    if got.out != want.out or got.out_logp != want.out_logp:
        fail(f"{run}: the installed stream differs from the uninterrupted "
             f"one at token {first_divergence(got.out, want.out)}")
    k1 = k1_window(kernel_support, rpa, run,
                   {"decode_steps": steps0, "prefill_chunks": chunks0},
                   {"decode_steps": dst.decode_steps,
                    "prefill_chunks": dst.prefill_chunks}, 0,
                   route=f"{quant}_paged")
    # the re-export: install again, one token on, export
    rid = dst.submit(prompt, KV_MAX_NEW, resume_out=out, resume_logp=lps,
                     kv_pages=blob, **req)
    while not any(r.rid == rid and len(r.out) > len(out)
                  for r in dst.running.values()):
        dst.step()
    blob2, _, _ = dst.export_kv_pages(rid)
    dst.cancel(rid)
    dst.run()
    _, p1 = paging.unpack_kv_wire(blob)
    _, p2 = paging.unpack_kv_wire(blob2)
    full = blob["tokens"] // 64
    equal = {name: bool(torch.equal(p1[name][:, :full].view(torch.uint8),
                                    p2[name][:, :full].view(torch.uint8)))
             for name in p1}
    if set(p1) != set(p2) or not all(equal.values()):
        fail(f"{run}: the re-export differs from the blob: {equal}")
    for cb in (src, dst):
        cb.pool.check()
        if cb.pool.in_use:
            fail(f"{run}: {cb.pool.in_use} pages still in use")
    if dst.graph is not graph:
        fail(f"{run}: the decode graph was captured again")
    size = {"float32": 4, "int8": 1, "int4": 1}
    row = {"phase": 4, "run": run, "resumed": len(out),
           "blob_tokens": blob["tokens"], "blob_pages": blob["n_pages"],
           "raw_bytes": sum(math.prod(p["shape"]) * size[p["dtype"]]
                            for p in blob["planes"].values()),
           "plane_dtypes": {n: p["dtype"] for n, p in blob["planes"].items()},
           "pool_bytes": sum(x.numel() * x.element_size() for x in
                             paging.kv_pool_planes(p1, quant).values()),
           "export_ms": export_ms, "k1": k1,
           "reexport_full_pages_equal": full, "planes_equal": equal,
           "graph_replays": dst.graph.replays}
    emit(row)
    del src, dst
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_kv(torch, server_mod, batching, kernel_support, rpa, cfg,
             params) -> dict:
    """KV page export and install at Llama-3-8B's full width and depth:
    ``kv_http`` (the hops through two server pairs, bf16, depth 1 and 0;
    the depth-1 B decodes KV_FILLERS other streams throughout,
    ``kv_load``: its steps with an install in them or not; the depth-0
    pair idle, so K1's launches of its hop are counted exactly),
    ``kv_graph`` (B's captured decode graph: the same object replaying
    across every install, every step a replay), the pools empty after;
    then ``kv_quant`` on int8 and int4 pools at batcher level."""
    t0 = time.perf_counter()
    pairs = {}
    for depth in sorted({d for _, _, d in KV_HOPS}, reverse=True):
        flags = [*KV_ARGS, "--pipelineDepth", str(depth)]
        pairs[depth] = [start_server(server_mod, flags, params)[1:]
                        for _ in "AB"]
    try:
        decode_s: list = []
        graphs = {}
        for _, (b, _) in pairs.values():
            cb = b.engine.cb
            graphs[id(b)] = (cb, cb.graph, cb.graph.replays)
            validate = cb.validate_kv_pages

            def timed(kv_pages, *args, validate=validate):
                t1 = time.perf_counter()
                out = validate(kv_pages, *args)
                if isinstance(kv_pages, dict):  # the request thread's
                    decode_s.append(time.perf_counter() - t1)
                return out

            cb.validate_kv_pages = timed
        rows = []
        b, b_url = pairs[1][1]
        with KvLoad(cfg, b, b_url) as load:
            for plen, knobs, depth in KV_HOPS:
                if depth == 1:
                    rows.append(kv_hop(kernel_support, rpa, cfg, pairs[1],
                                       plen, knobs, 1, decode_s, False))
        for plen, knobs, depth in KV_HOPS:
            if depth != 1:
                rows.append(kv_hop(kernel_support, rpa, cfg, pairs[depth],
                                   plen, knobs, depth, decode_s, True))
        graph_rows = {}
        for depth, (_, (b, url)) in pairs.items():
            cb, graph, replays0 = graphs[id(b)]
            graph_rows[depth] = {"replays_before": replays0,
                                 "replays_after": graph.replays,
                                 "decode_steps": cb.decode_steps}
            if b.engine.cb is not cb or cb.graph is not graph:
                fail(f"kv: B's batcher or decode graph was replaced")
            if graph.replays <= replays0 or graph.replays != cb.decode_steps:
                fail(f"kv: B's graph {graph_rows[depth]}: every step must "
                     "be a replay")
        for pair in pairs.values():
            for server, url in pair:
                _, health = get_health(url)
                if health["kv"]["pages_in_use"]:
                    fail(f"kv: {health['kv']['pages_in_use']} pages still "
                         f"in use on {url}")
                server.engine.cb.pool.check()
    finally:
        for pair in pairs.values():
            for server, _ in pair:
                server.stop()
    del pairs, b, cb, graphs
    gc.collect()
    torch.cuda.empty_cache()
    http_s = time.perf_counter() - t0
    emit({"phase": 4, "run": "kv_load", **load.row()})
    emit({"phase": 4, "run": "kv_graph", "same_graph_object": True,
          "by_pipeline_depth": graph_rows})
    quant = {q: kv_quant(torch, batching, kernel_support, rpa, cfg, params,
                         q) for q in ("int8", "int4")}
    idle = [r for r in rows if "k1" in r["install"]]
    summary = {
        "phase": 4, "run": "kv", "card": card_line(),
        "http_s": http_s, "wall_s": time.perf_counter() - t0,
        "hops": {r["run"]: {
            "raw_bytes": r["raw_bytes"], "wire_bytes": r["wire_bytes"],
            "export_ms": r["export_ms"],
            "request_thread_decode_ms":
                r["install"]["request_thread_decode_ms"],
            "install_first_token_ms": r["install"]["first_token_ms"],
            "reprefill_first_token_ms": r["reprefill"]["first_token_ms"],
            "reprefill_equal": r["reprefill"]["tokens_equal"]
            and r["reprefill"]["logprobs_equal"]} for r in rows},
        "k1_launches": sum(r[k]["k1"]["launches"] for r in idle
                           for k in ("install", "reprefill"))
        + sum(q["k1"]["launches"] for q in quant.values()),
        "install_chunks": [r["install"]["k1"]["prefill_chunks"]
                           for r in idle]
        + [q["k1"]["prefill_chunks"] for q in quant.values()],
        "reprefill_chunks": [r["reprefill"]["k1"]["prefill_chunks"]
                             for r in idle]}
    emit(summary)
    return {"summary": summary, "rows": rows, "load": load.row(),
            "graph": graph_rows, "quant": quant}


# The fleet tier (``fleet_*``, ``phase_fleet``): two servers sharing the 8B
# weights behind the port's replica router (serving/router.py on its own
# event loop in a thread), driven over HTTP through the router
FLEET_ARGS = ["--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
              "--kvLayout", "paged", "--kvPageSize", "64", "--embeddings",
              "--tracing"]
FLEET_PREFIX, FLEET_TAIL, FLEET_NEW = 512, 64, 32
FLEET_DRAIN_NEW = 64
# the disaggregated hops: (prompt length, body knobs), 32 tokens each
# (each length greedy and seeded until the checkpoint phases took their
# time)
FLEET_DISAGG = [(512, {}), (1024, {"seed": 22, "temperature": 0.8})]
FLEET_ROLES = "prefill=r0 decode=r1"
FLEET_RESUME_PROMPT, FLEET_RESUME_NEW, FLEET_KILL_AT = 1024, 48, 8
FLEET_HEALTH_S = 0.25   # the routers' health-poll interval
FLEET_TRACE_NEW = 8     # fleet_trace's traced stream


class LoopThread:
    """An asyncio event loop on a thread of its own: the routers run on
    it, the script's clients talk to them over HTTP from this thread."""

    def __init__(self):
        import asyncio

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="router-loop", daemon=True)
        self.thread.start()

    def call(self, coro, timeout: float = 120.0):
        return self.asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def fleet_ids(n: int, seed: int, vocab: int) -> list:
    import numpy as np

    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def fleet_stream(url: str, body: dict, on_token=None) -> dict:
    """One streamed /v1/generate read to its done frame: {"tokens",
    "logprobs", "ttft" (seconds to the first token frame), "token_times",
    "cached_tokens"}; ``on_token(count)`` after each token frame. Fails
    on an error frame or a stream cut before its done frame."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps({**body, "stream": True})
        .encode(), headers={"Content-Type": "application/json"})
    toks, lps, times, done = [], [], [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if "error" in evt:
                fail(f"fleet: stream error frame {evt['error']}")
            if evt.get("done"):
                done = evt
                break
            times.append(time.perf_counter())
            toks.append(evt["token"])
            lps.append(evt.get("logprob"))
            if on_token is not None:
                on_token(len(toks))
    if done is None:
        fail(f"fleet: a stream ended after {len(toks)} tokens without its "
             "done frame")
    return {"tokens": toks, "logprobs": lps, "token_times": times,
            "ttft": times[0] - t0 if times else None,
            "cached_tokens": done.get("cached_tokens", 0)}


def sse_payloads(url: str, path: str, body: dict) -> list:
    """An OpenAI stream's ``data:`` payloads, ids and timestamps aside."""
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=900) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                payload = line[len("data: "):]
                evt = payload if payload == "[DONE]" else json.loads(payload)
                if isinstance(evt, dict):
                    evt = {k: v for k, v in evt.items()
                           if k not in ("id", "created")}
                out.append(evt)
    return out


def relayed(base: str) -> dict:
    return {rid: r["relayed"] for rid, r in
            get_json(base, "/fleet/health")["replicas"].items()}


def picked(base: str, before: dict) -> str:
    """The replica that served the one request since ``before``."""
    after = relayed(base)
    hit = [rid for rid in after if after[rid] > before[rid]]
    if len(hit) != 1:
        fail(f"fleet: expected one replica to serve the request: {before} "
             f"-> {after}")
    return hit[0]


def fleet_counters(fleet) -> list:
    return [(s.engine.cb.decode_steps, s.engine.cb.prefill_chunks)
            for s in fleet.servers]


def fleet_k1(run: str, kernel_support, rpa, fleet, c0: list,
             n_layers: int) -> dict:
    """K1's launches since the reset at ``c0``: one a layer for each
    decode step and prefill chunk of either replica, all on the paged
    route and the tensor cores, every decode launch split; and each
    replica's share."""
    per = {}
    for i, ((s0, k0), (s1, k1)) in enumerate(zip(c0, fleet_counters(fleet))):
        per[f"r{i}"] = {"decode_steps": s1 - s0, "prefill_chunks": k1 - k0,
                        "k1_launches": n_layers * (s1 - s0 + k1 - k0)}
    steps = sum(p["decode_steps"] for p in per.values())
    chunks = sum(p["prefill_chunks"] for p in per.values())
    out = route_launches(run, kernel_support, rpa, "paged", n_layers, steps,
                         chunks)
    split = kernel_support.launch_counts().get(rpa.SPLIT_KEY, 0)
    if split != n_layers * steps:
        fail(f"{run}: {split} split launches for {steps} decode steps")
    return {**out, "split_launches": split, "per_replica": per}


def same_stream(run: str, got: dict, want: dict) -> None:
    if got["tokens"] != want["tokens"]:
        fail(f"{run}: the stream differs at token "
             f"{first_divergence(got['tokens'], want['tokens'])}")
    if got["logprobs"] != want["logprobs"]:
        fail(f"{run}: the logprobs differ")


def fleet_route(kernel_support, rpa, cfg, fleet, base: str) -> dict:
    """``fleet_route`` (affinity): four streams sharing a 512-token prefix
    land on one replica and reuse its cache; they, a plain generate, a
    streamed completion and an embedding equal the same requests sent
    straight to the replica the router chose, bit for bit."""
    run = "fleet_route"
    vocab = cfg.vocab_size
    prefix = fleet_ids(FLEET_PREFIX, SEED + 90, vocab)
    tails = [fleet_ids(FLEET_TAIL, SEED + 91 + i, vocab) for i in range(5)]
    bodies = [{"prompt": prefix + tails[i], "max_new": FLEET_NEW,
               "logprobs": True, "stream": True,
               **({"seed": 40 + i, "temperature": 0.8} if i % 2 else {})}
              for i in range(4)]
    c0 = fleet_counters(fleet)
    kernel_support.reset_launch_counts()
    hits0 = get_json(base, "/fleet/health")["router"]["affinity_hits"]
    streams = []
    for body in bodies:
        before = relayed(base)
        streams.append((body, fleet_stream(base, body), picked(base, before)))
    homes = {at for _, _, at in streams}
    if len(homes) != 1:
        fail(f"{run}: the shared-prefix requests went to {homes}")
    home = streams[0][2]
    cached = [s["cached_tokens"] for _, s, _ in streams]
    if any(c < FLEET_PREFIX for c in cached[1:]):
        fail(f"{run}: cached_tokens {cached}: the second to fourth must "
             f"reuse the {FLEET_PREFIX}-token prefix")
    plain = {"prompt": prefix + tails[4], "max_new": FLEET_NEW,
             "logprobs": True}
    before = relayed(base)
    plain_got = _post(base, plain)
    plain_at = picked(base, before)
    oai = {"prompt": fleet_ids(200, SEED + 96, vocab), "max_tokens": 16,
           "stream": True, "logprobs": 1, "model": "tpu-serving"}
    before = relayed(base)
    oai_got = sse_payloads(base, "/v1/completions", oai)
    oai_at = picked(base, before)
    emb = json.dumps({"input": fleet_ids(64, SEED + 97, vocab),
                      "model": "tpu-serving"}).encode()
    before = relayed(base)
    status, emb_got = _post_raw(base, "/v1/embeddings", emb)
    emb_at = picked(base, before)
    if status != 200:
        fail(f"{run}: embeddings answered {status}: {emb_got[:200]!r}")
    hits = get_json(base, "/fleet/health")["router"]["affinity_hits"] - hits0
    # the same requests straight to the replica the router chose
    gaps = {"routed": [], "direct": []}
    for i, (body, got, at) in enumerate(streams):
        want = fleet_stream(fleet.replica_base(int(at[1:])), body)
        same_stream(f"{run} stream {i}", got, want)
        for key, s in (("routed", got), ("direct", want)):
            t = s["token_times"]
            gaps[key].append((t[-1] - t[0]) / (len(t) - 1))
    want = _post(fleet.replica_base(int(plain_at[1:])), plain)
    same_stream(f"{run} plain", plain_got, want)
    if sse_payloads(fleet.replica_base(int(oai_at[1:])), "/v1/completions",
                    oai) != oai_got:
        fail(f"{run}: the routed completion stream differs from direct")
    status, emb_want = _post_raw(fleet.replica_base(int(emb_at[1:])),
                                 "/v1/embeddings", emb)
    a, b = json.loads(emb_got), json.loads(emb_want)
    if (status != 200 or [d["embedding"] for d in a["data"]]
            != [d["embedding"] for d in b["data"]] or a["usage"] != b["usage"]):
        fail(f"{run}: the routed embedding differs from direct")
    k2 = kernel_support.launch_counts().get("flash_fwd", 0)
    if k2 != 2 * cfg.n_layers:  # one forward each way, one launch a layer
        fail(f"{run}: {k2} flash_fwd launches for two embedding forwards")
    k1 = fleet_k1(run, kernel_support, rpa, fleet, c0, cfg.n_layers)
    row = {"phase": 4, "run": run, "home": home, "affinity_hits": hits,
           "cached_tokens": cached, "plain_at": plain_at,
           "completions_at": oai_at, "embeddings_at": emb_at,
           "ttft_ms": [1e3 * s["ttft"] for _, s, _ in streams],
           # the mean gap between token frames of each stream, through
           # the router and straight to the replica (the hop's cost)
           "inter_token_ms": {k: [1e3 * g for g in v]
                              for k, v in gaps.items()},
           "router_added_ms_per_token": 1e3 * (
               sum(gaps["routed"]) - sum(gaps["direct"])) / len(streams),
           "equal_to_direct": ["streams", "plain", "completions",
                               "embeddings"],
           "k1": k1, "k2_launches": k2}
    emit(row)
    return row


def fleet_drain(kernel_support, rpa, cfg, fleet, base: str,
                home: str) -> dict:
    """``fleet_drain``: POST /fleet/drain/{home} while a stream runs there;
    the stream finishes whole, new requests go to the other replica,
    then undrain."""
    run = "fleet_drain"
    prefix = fleet_ids(FLEET_PREFIX, SEED + 90, cfg.vocab_size)
    body = {"prompt": prefix + fleet_ids(FLEET_TAIL, SEED + 98,
                                         cfg.vocab_size),
            "max_new": FLEET_DRAIN_NEW}
    c0 = fleet_counters(fleet)
    kernel_support.reset_launch_counts()
    drained = {}

    def drain():
        t0 = time.perf_counter()
        drained["status"], raw = _post_raw(base, f"/fleet/drain/{home}", b"")
        drained["answer"] = json.loads(raw)
        drained["wall_s"] = time.perf_counter() - t0

    th = threading.Thread(target=drain)
    before = relayed(base)
    got = fleet_stream(base, body,
                       lambda n: th.start() if n == 1 else None)
    th.join(300)
    if picked(base, before) != home:
        fail(f"{run}: the stream did not run on {home}")
    if len(got["tokens"]) != FLEET_DRAIN_NEW:
        fail(f"{run}: the drained replica's stream came back with "
             f"{len(got['tokens'])} of {FLEET_DRAIN_NEW} tokens")
    ans = drained.get("answer") or {}
    if drained.get("status") != 200 or ans.get("drained") is not True:
        fail(f"{run}: the drain answered {drained}")
    spilled = []
    for i in range(2):
        before = relayed(base)
        _post(base, {**body, "max_new": 8, "stream": False})
        spilled.append(picked(base, before))
    if home in spilled:
        fail(f"{run}: a request reached the drained {home}: {spilled}")
    status, _ = _post_raw(base, f"/fleet/undrain/{home}", b"")
    if status != 200:
        fail(f"{run}: undrain answered {status}")
    row = {"phase": 4, "run": run, "replica": home,
           "drain_seconds": ans["drain_seconds"],
           "drain_wall_s": drained["wall_s"],
           "stream_tokens": len(got["tokens"]), "spilled_to": spilled,
           "k1": fleet_k1(run, kernel_support, rpa, fleet, c0,
                          cfg.n_layers)}
    emit(row)
    return row


def router_stats(base: str) -> dict:
    return get_json(base, "/fleet/health")["router"]


def last_timeline(base: str) -> dict:
    return get_json(base, "/fleet/debug/requests")["requests"][0]


def fleet_disagg(kernel_support, rpa, cfg, fleet, base: str,
                 base2: str) -> dict:
    """``fleet_disagg``: through the roled router (prefill on r0, decode
    on r1), each stream equals the uninterrupted one on r1 bit for bit
    and r1 makes no prefill chunk for it; then the same prompts,
    colocated through the affinity router with cold caches, for TTFT."""
    run = "fleet_disagg"
    r1 = fleet.replica_base(1)
    rows = []
    for j, (plen, knobs) in enumerate(FLEET_DISAGG):
        body = {"prompt": fleet_ids(plen, SEED + 100 + j, cfg.vocab_size),
                "max_new": FLEET_NEW, "logprobs": True, **knobs}
        want = fleet_stream(r1, body)
        c0 = fleet_counters(fleet)
        kernel_support.reset_launch_counts()
        st0 = router_stats(base2)
        got = fleet_stream(base2, body)
        st1 = router_stats(base2)
        name = f"{run}_{plen}_{'seeded' if knobs else 'greedy'}"
        same_stream(name, got, want)
        k1 = fleet_k1(name, kernel_support, rpa, fleet, c0, cfg.n_layers)
        if k1["per_replica"]["r1"]["prefill_chunks"]:
            fail(f"{name}: the decode replica made "
                 f"{k1['per_replica']['r1']['prefill_chunks']} prefill "
                 "chunks")
        if st1["kv_transfers"].get("ok", 0) != \
                st0["kv_transfers"].get("ok", 0) + 1:
            fail(f"{name}: no KV transfer: {st1['kv_transfers']}")
        tl = last_timeline(base2)
        gaps = [b - a for a, b in zip(got["token_times"],
                                      got["token_times"][1:])]
        rows.append({"run": name, "prompt": plen, "knobs": knobs,
                     "ttft_ms": 1e3 * got["ttft"],
                     "pages": st1["kv_transferred_pages"]
                     - st0["kv_transferred_pages"],
                     "transfer_ms": st1["kv_transfer_ms"][-1],
                     "transfer_gap_ms": tl["phases"].get("transfer_gap", 0)
                     / 1e6,
                     "max_token_gap_ms": 1e3 * max(gaps),
                     "relays": tl["replicas"], "k1": k1})
    outcomes = router_stats(base2)["kv_transfers"]
    if outcomes != {"ok": len(FLEET_DISAGG)}:
        fail(f"{run}: kv_transfers {outcomes}")
    # the same prompts colocated: caches emptied first, so both are cold
    for server in fleet.servers:
        drain_prefix_cache(server)
    for j, ((plen, knobs), row) in enumerate(zip(FLEET_DISAGG, rows)):
        body = {"prompt": fleet_ids(plen, SEED + 100 + j, cfg.vocab_size),
                "max_new": FLEET_NEW, "logprobs": True, **knobs}
        colo = fleet_stream(base, body)
        if colo["cached_tokens"]:
            fail(f"{run}: the colocated run hit a cache")
        row["colocated_ttft_ms"] = 1e3 * colo["ttft"]
    out = {"phase": 4, "run": run, "roles": FLEET_ROLES,
           "kv_transfers": outcomes, "hops": rows,
           "k1_launches": sum(r["k1"]["launches"] for r in rows)}
    emit(out)
    return out


def fleet_resume(kernel_support, rpa, batching, fleet_mod, cfg, fleet,
                 base: str, base2: str) -> dict:
    """``fleet_resume``: a greedy and a seeded stream of one 1024-token
    prompt on r1 (its affinity home), r1 killed after 8 relayed tokens:
    both finish on r0, all 48 tokens, none twice, their continuation a
    direct resume of the same fold on r0 bit for bit (the first
    divergence from the uninterrupted streams printed, not held: a
    re-prefill resume is not bit for bit in bf16); then a disaggregated
    request whose decode replica is the dead r1 falls back to a
    re-prefill on r0, equal to a direct resume there."""
    run = "fleet_resume"
    ring = fleet_mod.HashRing(["r0", "r1"])
    for k in range(1000):
        prompt = fleet_ids(FLEET_RESUME_PROMPT, SEED + 200 + k,
                           cfg.vocab_size)
        key = fleet_mod.affinity_key(prompt, batching.DEFAULT_PROMPT_BUCKETS)
        if ring.candidates(key)[0] == "r1":
            break
    bodies = {"greedy": {"prompt": prompt, "max_new": FLEET_RESUME_NEW,
                         "logprobs": True},
              "seeded": {"prompt": prompt, "max_new": FLEET_RESUME_NEW,
                         "logprobs": True, "seed": 31, "temperature": 0.8}}

    def both(on_token=None):
        got, errors = {}, []

        def one(name):
            try:
                got[name] = fleet_stream(
                    base, bodies[name],
                    (lambda n: on_token(name, n)) if on_token else None)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(f"{name}: {e}")

        threads = [threading.Thread(target=one, args=(n,)) for n in bodies]
        for th in threads:
            th.start()
        return got, errors, threads

    before = relayed(base)
    want, errors, threads = both()
    for th in threads:
        th.join(900)
    after = relayed(base)
    if errors or after["r1"] - before["r1"] != 2:
        fail(f"{run}: the uninterrupted streams {errors}, {before} -> "
             f"{after}")
    # r0's submissions: the fold each resume brought (its resume_out)
    engine = fleet.servers[0].engine
    submitted = []
    submit = engine.submit

    def recording(prompt, max_new, **kw):
        submitted.append((kw.get("seed"), list(kw.get("resume_out") or ())))
        return submit(prompt, max_new, **kw)

    engine.submit = recording
    try:
        c0 = fleet_counters(fleet)
        kernel_support.reset_launch_counts()
        at_kill = threading.Event()
        got, errors, threads = both(
            lambda name, n: at_kill.set()
            if name == "greedy" and n == FLEET_KILL_AT else None)
        if not at_kill.wait(300):
            fail(f"{run}: the greedy stream never reached {FLEET_KILL_AT} "
                 "tokens")
        t_kill = time.perf_counter()
        fleet.kill(1)
        kill_s = time.perf_counter() - t_kill
        for th in threads:
            th.join(900)
        if errors:
            fail(f"{run}: {errors}")
        k1 = fleet_k1(run, kernel_support, rpa, fleet, c0, cfg.n_layers)
        folds = {("seeded" if seed is not None else "greedy"): out
                 for seed, out in submitted if out}
        if set(folds) != set(bodies):
            fail(f"{run}: r0 took the resumes {submitted}")
        rows = {}
        for name, body in bodies.items():
            s, k = got[name], len(folds[name])
            if len(s["tokens"]) != FLEET_RESUME_NEW:
                fail(f"{run} {name}: {len(s['tokens'])} tokens, expected "
                     f"{FLEET_RESUME_NEW}")
            if folds[name] != s["tokens"][:k]:
                fail(f"{run} {name}: the resume folded {folds[name]}, not "
                     "the tokens the client had")
            if s["tokens"][:k] != want[name]["tokens"][:k]:
                fail(f"{run} {name}: the tokens before the kill differ "
                     "from the uninterrupted run's")
            direct = fleet_stream(fleet.replica_base(0), {
                **body, "resume_out": s["tokens"][:k],
                "resume_logprobs": s["logprobs"][:k]})
            same_stream(f"{run} {name} continuation",
                        {"tokens": s["tokens"][k:],
                         "logprobs": s["logprobs"][k:]}, direct)
            t = s["token_times"]
            rows[name] = {
                "tokens": len(s["tokens"]), "tokens_at_death": k,
                # the client's stall across the death: the re-prefill
                # of the fold on r0 and its first token
                "max_token_gap_ms": 1e3 * max(
                    b - a for a, b in zip(t, t[1:])),
                "first_divergence_from_uninterrupted": first_divergence(
                    s["tokens"], want[name]["tokens"]),
                "continuation_equals_direct_resume": True}
        if k1["per_replica"]["r0"]["prefill_chunks"] < 2:
            fail(f"{run}: r0 re-prefilled {k1['per_replica']} chunks")
        events = get_json(base, "/fleet/events")["events"]
        resumes = [e for e in events if e["kind"] == "stream_resume"]
        if [(e["source"], e["target"]) for e in resumes] != \
                [("r1", "r0")] * len(bodies):
            fail(f"{run}: stream_resume events {resumes}")
        stats = router_stats(base)
        if stats["fleet_budget"]["charged_total"] != 1 or \
                stats["resumes"] != len(bodies):
            fail(f"{run}: one death, {len(bodies)} resumes expected: "
                 f"{stats['fleet_budget']}, resumes {stats['resumes']}")
        gaps = [r["resume_gap_ns"] / 1e6 for r in get_json(
            base, "/fleet/debug/requests")["retained_requests"]
            if r["resumes"]]
        for url in (base, base2):  # both routers see r1 dead
            t0 = time.perf_counter()
            while get_json(url, "/fleet/health")["replicas"]["r1"]["alive"]:
                if time.perf_counter() - t0 > 30:
                    fail(f"{run}: {url} still shows r1 alive")
                time.sleep(0.05)
        out = {"phase": 4, "run": run, "killed": "r1", "survivor": "r0",
               "kill_s": kill_s, "streams": rows,
               "stream_resume_events": len(resumes),
               "fleet_budget": stats["fleet_budget"],
               "resume_gap_ms": gaps, "k1": k1}
        # the fallback: a disaggregated request whose decode replica is
        # the dead r1 re-prefills on r0
        submitted.clear()
        c0 = fleet_counters(fleet)
        kernel_support.reset_launch_counts()
        st0 = router_stats(base2)
        body = {"prompt": fleet_ids(FLEET_PREFIX, SEED + 300,
                                    cfg.vocab_size),
                "max_new": FLEET_NEW, "logprobs": True}
        got = fleet_stream(base2, body)
        st1 = router_stats(base2)
        fb = {k: st1["kv_transfers"].get(k, 0) - st0["kv_transfers"].get(k, 0)
              for k in ("ok", "fallback")}
        if fb != {"ok": 0, "fallback": 1} or \
                st1["fleet_budget"]["charged_total"] != 0:
            fail(f"{run} fallback: transfers {fb}, budget "
                 f"{st1['fleet_budget']}")
        resumed = [o for _, o in submitted if o]
        if len(got["tokens"]) != FLEET_NEW or len(resumed) != 1:
            fail(f"{run} fallback: {len(got['tokens'])} tokens, r0's "
                 f"resubmissions {submitted}")
        k = len(resumed[0])
        direct = fleet_stream(fleet.replica_base(0), {
            **body, "resume_out": got["tokens"][:k],
            "resume_logprobs": got["logprobs"][:k]})
        same_stream(f"{run} fallback continuation",
                    {"tokens": got["tokens"][k:],
                     "logprobs": got["logprobs"][k:]}, direct)
        out["fallback"] = {
            "kv_transfers": fb, "tokens_at_transfer": k,
            "charged_total": st1["fleet_budget"]["charged_total"],
            "continuation_equals_direct_resume": True,
            "k1": fleet_k1(f"{run}_fallback", kernel_support, rpa, fleet,
                           c0, cfg.n_layers)}
    finally:
        engine.submit = submit
    emit(out)
    return out


def expo_samples(text: str) -> list:
    """A well-formed exposition's samples: ``(name, labels, value)``
    (label values unescaped; exemplars and timestamps dropped)."""
    import re

    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    head = re.compile(rf"^({_EXPO_NAME})({_EXPO_LABELS})? ({_EXPO_NUM})")
    out = []
    for line in text.split("\n"):
        m = head.match(line)
        if m is None or line.startswith("#"):
            continue
        labels = {k: re.sub(r"\\(.)", lambda e: {"n": "\n"}.get(
            e.group(1), e.group(1)), v)
            for k, v in label.findall(m.group(2) or "")}
        out.append((m.group(1), labels, float(m.group(3))))
    return out


def fleet_metrics(run: str, base: str, live: list, dead: list) -> dict:
    """``GET /fleet/metrics`` through the router, classic and OpenMetrics:
    well-formed; every ``gpu_serving_*`` series under one of the live
    replicas' ``replica`` labels, each live replica present;
    ``gpu_fleet_replicas`` the live replicas, ``gpu_fleet_scrape_errors``
    the dead ones; the fleet TTFT histogram's count (and each bucket) the
    replicas' sum."""
    out = {}
    for om in (False, True):
        text = scrape(base, om, "/fleet/metrics")
        label = f"{run} {'openmetrics' if om else 'classic'}"
        errors = exposition_errors(text, om)
        if errors:
            fail(f"{label}: malformed lines {errors[:5]}")
        samples = expo_samples(text)
        serving = [(n, lb) for n, lb, _ in samples
                   if n.startswith("gpu_serving_")]
        owners = {lb.get("replica") for _, lb in serving}
        if owners != set(live):
            fail(f"{label}: gpu_serving_* series labelled {owners}, live "
                 f"replicas {live}")
        fleet = {n: v for n, lb, v in samples
                 if n.startswith("gpu_fleet_") and not lb}
        if fleet.get("gpu_fleet_replicas") != len(live) or \
                fleet.get("gpu_fleet_scrape_errors") != len(dead):
            fail(f"{label}: {fleet}, live {live}, dead {dead}")
        counts = [v for n, _, v in samples
                  if n == "gpu_serving_ttft_seconds_count"]
        buckets: dict = {}
        for n, lb, v in samples:
            if n == "gpu_serving_ttft_seconds_bucket":
                buckets[lb["le"]] = buckets.get(lb["le"], 0.0) + v
        summed = {lb["le"]: v for n, lb, v in samples
                  if n == "gpu_fleet_ttft_seconds_bucket"}
        if fleet.get("gpu_fleet_ttft_seconds_count") != sum(counts) or \
                summed != buckets or not counts:
            fail(f"{label}: fleet TTFT count "
                 f"{fleet.get('gpu_fleet_ttft_seconds_count')} against the "
                 f"replicas' {counts}")
        out["openmetrics" if om else "classic"] = {
            "bytes": len(text), "samples": len(samples),
            "serving_samples": len(serving),
            "exemplars": text.count(" # {") if om else 0,
            "ttft_count": fleet["gpu_fleet_ttft_seconds_count"],
            **{k: fleet[k] for k in ("gpu_fleet_replicas",
                                     "gpu_fleet_scrape_errors",
                                     "gpu_fleet_mfu_pct",
                                     "gpu_fleet_hbm_bw_util_pct")}}
    return out


def fleet_trace(run: str, cfg, base: str, seed: int,
                dead: tuple = ()) -> dict:
    """One stream through the router (tracing on): the router's newest
    ``POST /v1/generate`` trace; its stitched trace holds a router track
    and the serving replica's, with no orphan, and names exactly the
    ``dead`` replicas unreachable."""
    before = relayed(base)
    fleet_stream(base, {"prompt": fleet_ids(FLEET_PREFIX, seed,
                                            cfg.vocab_size),
                        "max_new": FLEET_TRACE_NEW})
    served = picked(base, before)
    time.sleep(0.2)  # the router's span closes after its last frame
    newest = [t for t in get_json(base, "/debug/traces?limit=16")["traces"]
              if t["component"] == "router_http"
              and t["root"].startswith("POST /v1/generate")]
    if not newest:
        fail(f"{run}: no router trace of the stream")
    trace_id = newest[0]["trace_id"]
    doc = get_json(base, f"/fleet/debug/traces/{trace_id}")
    summary = doc["fleet"]
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e.get("name") == "process_name"}
    if summary["trace_id"] != trace_id or summary["orphans"] or \
            rows != set(summary["tracks"]) or "router" not in rows or \
            served not in rows or summary["unreachable"] != list(dead):
        fail(f"{run}: {served} served the stream; the stitched trace "
             f"{summary}, process rows {rows}")
    return {"trace_id": trace_id, "served_by": served, **summary}


def phase_fleet(torch, server_mod, batching, kernel_support, rpa, cfg,
                params) -> dict:
    """The replica router on the card: two servers sharing the 8B
    weights (``--replicaId r0`` / ``r1``, paged pools, the prefix cache
    on, embeddings) behind the port's router, then ``fleet_route``,
    ``fleet_drain``, ``fleet_disagg`` (a second, roled router),
    ``fleet_metrics`` and ``fleet_trace`` (the read-only surfaces, tracing
    on) and ``fleet_resume`` (last: a killed server is not restarted),
    after which both surfaces report the dead replica."""
    from k8s_gpu_device_plugin_torch.serving import fleet as fleet_mod
    from k8s_gpu_device_plugin_torch.serving import testing

    t0 = time.perf_counter()
    servers = []
    for i in range(2):
        args = server_mod.build_parser().parse_args([
            *FLEET_ARGS, "--replicaId", f"r{i}", "--host", "127.0.0.1",
            "--port", "0", "--seed", str(SEED)])
        servers.append(server_mod.build_server(args, params=params))
    fleet = testing.InprocessFleet(servers)
    fleet.start()
    loop = LoopThread()
    try:
        loop.call(fleet.add_router(policy="affinity",
                                   health_interval_s=FLEET_HEALTH_S))
        base = fleet.base
        router2 = loop.call(fleet.add_router(
            policy="affinity", roles=FLEET_ROLES, disagg_min_prompt=64,
            health_interval_s=FLEET_HEALTH_S))
        base2 = f"http://127.0.0.1:{router2.bound_port}"
        for url in (base, base2):  # both pollers have seen both replicas
            t1 = time.perf_counter()
            while {r["reported_id"] for r in get_json(
                    url, "/fleet/health")["replicas"].values()} != \
                    {"r0", "r1"}:
                if time.perf_counter() - t1 > 60:
                    fail(f"fleet: {url} never saw both replicas' ids")
                time.sleep(0.05)
        t_start = time.perf_counter()
        route = fleet_route(kernel_support, rpa, cfg, fleet, base)
        drain = fleet_drain(kernel_support, rpa, cfg, fleet, base,
                            route["home"])
        disagg = fleet_disagg(kernel_support, rpa, cfg, fleet, base, base2)
        t_obs = time.perf_counter()
        obs = {"fleet_trace": fleet_trace("fleet_trace", cfg, base,
                                          SEED + 400),
               "fleet_metrics": fleet_metrics("fleet_metrics", base,
                                              ["r0", "r1"], [])}
        obs_s = time.perf_counter() - t_obs
        resume = fleet_resume(kernel_support, rpa, batching, fleet_mod, cfg,
                              fleet, base, base2)
        t_obs = time.perf_counter()
        # a fresh trace: the resume's streams have cycled the trace ring
        obs["fleet_trace_after_kill"] = fleet_trace(
            "fleet_trace_after_kill", cfg, base, SEED + 401, dead=("r1",))
        obs["fleet_metrics_after_kill"] = fleet_metrics(
            "fleet_metrics_after_kill", base, ["r0"], ["r1"])
        obs_s += time.perf_counter() - t_obs
        for name, row in obs.items():
            emit({"phase": 4, "run": name, **row})
        runs_s = time.perf_counter() - t_start
        for i, server in enumerate(servers):
            if i not in fleet.killed:
                drain_prefix_cache(server)
                server.engine.cb.pool.check()
    finally:
        loop.call(fleet.close_routers())
        loop.close()
        fleet.stop()
    del servers, fleet
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"fleet_route": route["k1"]["launches"],
                "fleet_drain": drain["k1"]["launches"],
                "fleet_disagg": disagg["k1_launches"],
                "fleet_resume": resume["k1"]["launches"],
                "fleet_fallback": resume["fallback"]["k1"]["launches"]}
    summary = {
        "phase": 4, "run": "fleet", "card": card_line(),
        "wall_s": time.perf_counter() - t0, "runs_s": runs_s,
        "affinity_hits": route["affinity_hits"],
        "router_added_ms_per_token": route["router_added_ms_per_token"],
        "drain_seconds": drain["drain_seconds"],
        "kv_transfers": disagg["kv_transfers"],
        "ttft_ms": {h["run"]: {"disaggregated": h["ttft_ms"],
                               "colocated": h["colocated_ttft_ms"]}
                    for h in disagg["hops"]},
        "transfer_ms": {h["run"]: h["transfer_ms"] for h in disagg["hops"]},
        "pages": {h["run"]: h["pages"] for h in disagg["hops"]},
        "resume_gap_ms": resume["resume_gap_ms"],
        "read_only_surfaces_s": obs_s,
        "federation_bytes": {k: v["classic"]["bytes"] for k, v in obs.items()
                             if k.startswith("fleet_metrics")},
        "k1_launches": launches, "k1_route": "paged",
        "k2_launches": route["k2_launches"]}
    emit(summary)
    return summary


SERVE_SEQS = (64, 256, 1024)


def flash_cases():
    """The training path's shapes (phase 6: B, S and the 8B heads), a
    window and an hd-64 group-1 case at the same B and S, and the
    serving surface's B 1 forwards at SERVE_SEQS."""
    full = dict(b=TRAIN_BATCH, s=TRAIN_SEQ, hq=32, hkv=8, hd=128)
    return [dict(name="causal", window=0, **full),
            dict(name="causal_window512", window=512, **full),
            dict(name="causal_hd64_group1", window=0, b=TRAIN_BATCH,
                 s=TRAIN_SEQ, hq=8, hkv=8, hd=64),
            *(dict(name=f"serve_b1_s{s}", window=0, b=1, s=s, hq=32, hkv=8,
                   hd=128) for s in SERVE_SEQS),
            # beam search's check: its rows' full-context forward, padded
            # to the tile
            dict(name=f"beam_check_b{BEAM_WIDTH}_s{BEAM_CHECK_SEQ}", window=0,
                 b=BEAM_WIDTH, s=BEAM_CHECK_SEQ, hq=32, hkv=8, hd=128),
            # the MoE forward check's attention (Mixtral-8x7B's heads, f32
            # on the CUDA cores, B 1, S MOE_CHECK_SEQ)
            dict(name=f"moe_check_b1_s{MOE_CHECK_SEQ}", window=0, b=1,
                 s=MOE_CHECK_SEQ, hq=32, hkv=8, hd=128, dtypes=("float32",)),
            *narrow_flash_cases()]


def narrow_flash_cases():
    """K2-K4 at hd 16 and 32: the training shape's B, S and Llama-3-8B's
    heads, and the tiny preset's training shape (B 8, S 128, Hq 8, Hkv 4)."""
    return [case for hd in NARROW_HDS for case in (
        dict(name=f"causal_hd{hd}", window=0, b=TRAIN_BATCH, s=TRAIN_SEQ,
             hq=32, hkv=8, hd=hd),
        dict(name=f"tiny_hd{hd}", window=0, b=TINY_BATCH, s=TINY_SEQ, hq=8,
             hkv=4, hd=hd))]


def attended_pairs(s: int, window: int) -> int:
    """(query, key) pairs one causal head attends: sum of min(i+1, window)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bounds(case, dtype_name: str) -> dict:
    """Least time of each kernel for this case's work: every input byte
    read once and every output byte written once, against 4 (forward),
    8 (dK dV) and 6 (dQ) * hd operations per attended (query, key) pair
    of every q head, at the input type's peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    b, s, hq, hkv, hd = (case[k] for k in ("b", "s", "hq", "hkv", "hd"))
    q_bytes = b * hq * s * hd * elem
    kv_bytes = 2 * b * hkv * s * hd * elem
    row_bytes = b * hq * s * 4                      # one lse or delta
    pairs = b * hq * attended_pairs(s, case["window"])
    work = {
        "flash_fwd": (2 * q_bytes + kv_bytes + row_bytes, 4 * hd * pairs),
        "flash_bwd_dkv": (2 * q_bytes + kv_bytes + 2 * row_bytes
                          + 2 * b * hkv * s * hd * 4, 8 * hd * pairs),
        "flash_bwd_dq": (2 * q_bytes + kv_bytes + 2 * row_bytes
                         + b * hq * s * hd * 4, 6 * hd * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def event_ms(torch, fn, reps: int = 5, trials: int = 1) -> float:
    """Device time of ``fn()`` between CUDA events, without a graph (for
    autograd calls): the mean of ``reps`` calls, the least over ``trials``
    such runs. The host launches each call, so a pause between calls
    counts: the garbage collector is off while they run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        best = math.inf
        for _ in range(trials):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
    finally:
        if collecting:
            gc.enable()
    return best


def phase_flash(torch, fa, kernel_support, cases=None,
                phase: int = 5) -> list[dict]:
    """K2-K4 against their plain versions on ``cases`` (phase 5's
    ``flash_cases()`` by default), one line a case under ``phase``."""
    import torch.nn.functional as F

    results = []
    for case in flash_cases() if cases is None else cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            if dname not in case.get("dtypes", (dname,)):
                continue
            b, s, hq, hkv, hd, window = (case[k] for k in
                                         ("b", "s", "hq", "hkv", "hd",
                                          "window"))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)

            def randn(rows):
                return torch.randn((rows, s, hd), generator=gen,
                                   device="cuda", dtype=dtype)

            q, k, v, do = randn(b * hq), randn(b * hkv), randn(b * hkv), \
                randn(b * hq)
            kw = dict(scale=hd ** -0.5, causal=True, window=window)
            engine = fa.engine(dtype)
            label = f"{case['name']} {dname}"
            o_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
            # both backward routes get the plain forward's lse and delta
            delta = (do.float() * o_r.float()).sum(-1, keepdim=True)
            bwd = (q, k, v, do, lse_r, delta)
            runs = []
            for _ in range(2):  # two launches of each on the same inputs
                kernel_support.reset_launch_counts()
                out = {}
                out["o"], out["lse"] = fa.flash_fwd(q, k, v, **kw)
                out["dk"], out["dv"] = fa.flash_bwd_dkv(*bwd, **kw)
                out["dq"] = fa.flash_bwd_dq(*bwd, **kw)
                runs.append((out, kernel_support.launch_counts()))
            (got, counts), (again, _) = runs
            torch.cuda.synchronize()
            for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
                if counts.get(kernel_support.engine_key(name, engine)) != 1:
                    fail(f"{label}: {name} was not counted on the {engine} "
                         f"engine: {counts}")
            for name in got:
                if not torch.equal(got[name], again[name]):
                    fail(f"{label}: two launches on the same inputs give "
                         f"different {name}")
            del runs, again
            want = {"o": o_r, "lse": lse_r,
                    "dq": fa.flash_bwd_dq_reference(*bwd, **kw)}
            want["dk"], want["dv"] = fa.flash_bwd_dkv_reference(*bwd, **kw)
            bf16 = dtype == torch.bfloat16
            errs, off_one_ulp, grad_checks = {}, None, {}
            if bf16:  # the tensor-core checks (the tolerances above)
                o_p = fa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)[0]
                why = kernel_support.bf16_o_mismatch(got["o"], o_p, o_r,
                                                     fa.o_wide_tol(v))
                if why is not None:
                    fail(f"{label}: {why}")
                errs["o_vs_f32"] = float((got["o"].float()
                                          - o_r.float()).abs().max())
                off_one_ulp = kernel_support.off_one_ulp(got["o"], o_p)
                want["o"] = o_p
                rounded = {"dq": fa.flash_bwd_dq_reference(*bwd, p_bf16=True,
                                                           **kw)}
                rounded["dk"], rounded["dv"] = fa.flash_bwd_dkv_reference(
                    *bwd, p_bf16=True, **kw)
                magnitude = fa.flash_bwd_magnitudes(*bwd, **kw)
                for name, g_p in rounded.items():
                    g, g_r, mag = got[name], want[name], magnitude[name]
                    why = kernel_support.bf16_grad_mismatch(g, g_p, g_r, mag)
                    if why is not None:
                        fail(f"{label}: {name}: {why}")
                    errs[f"{name}_vs_f32"] = float((g - g_r).abs().max())
                    grad_checks[name] = {
                        "tight_ratio": float(((g - g_p).abs() / kernel_support
                                              .grad_tight_tol(mag)).max()),
                        "wide_ratio": float(((g - g_r).abs() / kernel_support
                                             .grad_wide_tol(mag)).max()),
                        "off_tight_elements_rows":
                            kernel_support.off_grad_tight(g, g_p, mag)}
                    want[name] = g_p
                del o_p, rounded, magnitude
            for name in ("o", "lse", "dq", "dk", "dv"):
                if not torch.isfinite(got[name]).all():
                    fail(f"{label}: non-finite kernel {name}")
                errs[name] = float((got[name].float()
                                    - want[name].float()).abs().max())
                if bf16 and name != "lse":
                    continue  # held by the tensor-core checks above
                tol = TOL["float32"] if name == "o" else GRAD_TOL
                if not torch.allclose(got[name].float(), want[name].float(),
                                      **tol):
                    fail(f"{label}: kernel {name} disagrees with its plain "
                         f"version (max abs err {errs[name]:.3e}, {tol})")
            del got, want

            # the library yardstick (never called by the port): SDPA over
            # (B, H, S, hd) views of the same inputs
            qs, ks, vs, dos = (x.view(b, -1, s, hd) for x in (q, k, v, do))
            if window:
                pos = torch.arange(s, device="cuda")
                mask = (pos[:, None] >= pos[None, :]) & \
                    (pos[:, None] - pos[None, :] < window)
                sdpa_kw = dict(attn_mask=mask)
            else:
                sdpa_kw = dict(is_causal=True)
            sdpa_kw.update(scale=kw["scale"], enable_gqa=hq != hkv)

            def library():
                return F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)

            qg, kg, vg = (x.detach().requires_grad_() for x in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)

            def library_bwd():
                return torch.autograd.grad(out, (qg, kg, vg), dos,
                                           retain_graph=True)

            def library_fwd_bwd():
                o_ = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
                return torch.autograd.grad(o_, (qg, kg, vg), dos)

            row = {"case": case["name"], "dtype": dname, **case,
                   "engine": engine, "max_abs_err": errs,
                   "o_off_one_ulp_elements_rows": off_one_ulp,
                   "grad_checks": grad_checks,
                   "ms": {
                       "flash_fwd": graph_ms(torch, lambda: fa.flash_fwd(
                           q, k, v, **kw), 5),
                       "flash_bwd_dkv": graph_ms(torch, lambda: fa.flash_bwd_dkv(
                           *bwd, **kw), 5),
                       "flash_bwd_dq": graph_ms(torch, lambda: fa.flash_bwd_dq(
                           *bwd, **kw), 5)},
                   "plain_ms": {
                       "flash_fwd": graph_ms(torch, lambda: fa.flash_fwd_reference(
                           q, k, v, **kw), 1),
                       "flash_bwd_dkv": graph_ms(
                           torch, lambda: fa.flash_bwd_dkv_reference(*bwd, **kw), 1),
                       "flash_bwd_dq": graph_ms(
                           torch, lambda: fa.flash_bwd_dq_reference(*bwd, **kw), 1)},
                   "library_fwd_ms": graph_ms(torch, library, 5),
                   # eager calls: the least of three runs, a stall of the
                   # host read out of the yardstick
                   "library_bwd_ms": event_ms(torch, library_bwd, trials=3),
                   "library_fwd_bwd_ms": event_ms(torch, library_fwd_bwd,
                                                  trials=3),
                   "bounds": flash_bounds(case, dname)}
            del out, qg, kg, vg
            emit({"phase": phase, **row})
            results.append(row)
    torch.cuda.empty_cache()
    return results


# --- phase 5, the fused training ops ------------------------------------------

FUSED_LAYERS = 2        # K5's state: the Llama-3-8B widths at 2 layers
FUSED_STEPS = 3         # K5 updates held to the plain version
FUSED_LR = 3e-4
FUSED_GRAD_STD = 1e-3   # the grads' scale: a norm of about 39, clipped
# K5 against its plain version fed the kernel's own clip scale: both round
# every operation once in the same order, so they agree bit for bit; a bf16
# element may miss by one ulp in at most this share (an operation compiled
# otherwise than eager PyTorch's would show on far more)
FUSED_UNEQUAL_SHARE = 1e-4
FUSED_F32_RTOL = 1e-6   # the f32 copy: relative, element by element
NORM_RTOL = 1e-5        # the kernel's norm (double partials) against the
                        # plain f32 sums over 1.5 B squares
CE_CHUNK = 4096         # the fused loss's chunk of vocabulary columns
LSE_TOL = dict(atol=1e-5, rtol=1e-6)  # K6: 128,256 exponentials summed in
                                      # another order
INT8_SHAPE = (TRAIN_BATCH * TRAIN_SEQ, 4096, 14336)  # M, K, N: w1's product


def bf16_ulp(torch, x):
    """The spacing of bf16 values at |x| (8 significant bits), in f32."""
    mag = x.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def off_by(torch, got, want, dtype, total: "dict | None" = None) -> dict:
    """Elements of ``got`` not equal to ``want`` bit for bit, those past
    one bf16 ulp (bf16) or FUSED_F32_RTOL (f32), and the largest
    difference; added into ``total`` when given."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = (bf16_ulp(torch, w) if dtype == torch.bfloat16
           else FUSED_F32_RTOL * w.abs())
    total = total if total is not None else {
        "unequal": 0, "past_tolerance": 0, "max_abs_err": 0.0}
    total["unequal"] += int((got != want).sum())
    total["past_tolerance"] += int((diff > tol).sum())
    total["max_abs_err"] = max(total["max_abs_err"], float(diff.max()))
    return total


def phase_fused_kernels(torch, llama, train, quant, fo, fce,
                        kernel_support) -> dict:
    """K5 (fused AdamW), K6/K7 (the fused loss's chunk passes) and the
    int8 product, each against its plain version on the card at the
    shapes phase 6 gives it, with times, bounds and yardsticks."""
    out = {"card": card_line()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0)
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=FUSED_LAYERS)
    k5 = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        params = train.param_leaves(llama.init_params(
            dataclasses.replace(cfg, param_dtype=dtype), seed=SEED,
            device="cuda"))
        n = sum(p.numel() for p in params)
        grads = [torch.empty_like(p) for p in params]

        def draw():
            for g in grads:
                g.normal_(0.0, FUSED_GRAD_STD, generator=gen)

        def zeros():
            return [torch.zeros_like(p) for p in params]

        kern = ([p.clone() for p in params], zeros(), zeros())
        plain = ([p.clone() for p in params], zeros(), zeros())
        del params
        row = {"leaves": len(grads), "elements": n, "norm_rel_err": []}
        for step in range(FUSED_STEPS):
            draw()
            if step == 0 and dtype == torch.bfloat16:
                # two launches on the same inputs agree bit for bit
                twin = tuple([x.clone() for x in xs] for xs in kern)
                gn_twin = fo.fused_adamw_kernels(*twin[:1], grads, *twin[1:],
                                                 step, lr=FUSED_LR, **hyper)
            gn = fo.fused_adamw_kernels(kern[0], grads, kern[1], kern[2], step,
                                        lr=FUSED_LR, **hyper)
            if step == 0 and dtype == torch.bfloat16:
                row["repeat_bitwise"] = torch.equal(gn, gn_twin) and all(
                    torch.equal(a, b) for xs, ys in zip(kern, twin)
                    for a, b in zip(xs, ys))
                del twin
            norm_p = fo.fused_adamw_update(plain[0], grads, plain[1],
                                           plain[2], step, lr=FUSED_LR,
                                           scale=gn[1], **hyper)
            row["norm_rel_err"].append(
                float((gn[0] - norm_p).abs() / norm_p))
            row["scale"] = float(gn[1])
        row["off"] = {}
        for name, xs, ys in zip(("p", "m", "v"), kern, plain):
            total = None
            for a, b in zip(xs, ys):
                total = off_by(torch, a, b, dtype, total)
            row["off"][name] = total
        if dtype == torch.bfloat16:
            lr_kw = dict(lr=FUSED_LR, **hyper)
            row["ms"] = event_ms(torch, lambda: fo.fused_adamw_kernels(
                kern[0], grads, kern[1], kern[2], FUSED_STEPS, **lr_kw))
            row["plain_ms"] = event_ms(torch, lambda: fo.fused_adamw_update(
                plain[0], grads, plain[1], plain[2], FUSED_STEPS, **lr_kw), 2)
            eager = train.AdamW(lambda count: FUSED_LR, b1=0.9, b2=0.95,
                                weight_decay=0.1, clip=1.0)
            state = {"count": FUSED_STEPS, "mu": plain[1], "nu": plain[2]}
            row["eager_adamw_ms"] = event_ms(
                torch, lambda: eager.update(grads, state, plain[0]), 2)
            steps = [torch.zeros((), device="cuda") for _ in grads]
            # the yardstick the port never calls: PyTorch's fused AdamW
            # over the same leaves (no clip, so no norm pass)
            row["library_ms"] = event_ms(torch, lambda: torch._fused_adamw_(
                plain[0], grads, plain[1], plain[2], [], steps, lr=FUSED_LR,
                beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                amsgrad=False, maximize=False))
            nbytes = 8 * 2 * n  # g, m, v, p read, m, v, p written, g again
            row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", bytes=nbytes)
        k5[dname] = row
        del kern, plain, grads
        gc.collect()
        torch.cuda.empty_cache()
    out["fused_adamw"] = k5
    emit({"phase": 5, "kernel": "fused_adamw", **k5})
    for dname, row in k5.items():
        for name, off in row["off"].items():
            if off["past_tolerance"] or (
                    off["unequal"] > FUSED_UNEQUAL_SHARE * row["elements"]):
                fail(f"fused_adamw {dname}: {name} misses the plain version "
                     f"fed the kernel's scale: {off} of {row['elements']}")
        if max(row["norm_rel_err"]) > NORM_RTOL:
            fail(f"fused_adamw {dname}: the norm misses the plain version's "
                 f"by {row['norm_rel_err']} (at most {NORM_RTOL})")
    if not k5["bfloat16"]["repeat_bitwise"]:
        fail("fused_adamw: two launches on the same inputs differ")

    # K6 and K7 at the trainer's rows, Llama-3-8B's width and vocabulary
    n_rows, d, v = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.vocab_size
    x = torch.randn((n_rows, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = (torch.randn((d, v), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, v, (n_rows,), generator=gen, device="cuda")
    bounds = fce.chunk_bounds(v, CE_CHUNK)

    def running():
        return (torch.full((n_rows,), float("-inf"), device="cuda"),
                torch.zeros(n_rows, device="cuda"),
                torch.zeros(n_rows, device="cuda"))

    run_k, run_p = running(), running()
    for c0, c1 in bounds:
        logits = quant.dot_f32(x, w[:, c0:c1])
        fce.ce_chunk_fwd(logits, t, c0, *run_k)
        fce.ce_chunk_fwd_reference(logits, t, c0, *run_p)
    lse_k = run_k[0] + torch.log(run_k[1])
    lse = run_p[0] + torch.log(run_p[1])
    g = torch.ones((), device="cuda")
    z = fce.Z_LOSS_WEIGHT
    dl_off = None
    for c0, c1 in bounds:
        logits = quant.dot_f32(x, w[:, c0:c1])
        got = fce.ce_chunk_bwd(logits, t, c0, lse, g, z, torch.bfloat16)
        want = fce.ce_chunk_bwd_reference(logits, t, c0, lse, g, z,
                                          torch.bfloat16)
        dl_off = off_by(torch, got, want, torch.bfloat16, dl_off)
    ce = {"rows": n_rows, "d": d, "vocab": v, "chunk": CE_CHUNK,
          "chunks": len(bounds), "last_chunk_width": bounds[-1][1] - bounds[-1][0],
          "lse_max_abs_err": float((lse_k - lse).abs().max()),
          "target_logit_equal": torch.equal(run_k[2], run_p[2]),
          "dlogits_off": dl_off}
    for width, (c0, c1) in (("full", bounds[0]), ("ragged", bounds[-1])):
        logits = quant.dot_f32(x, w[:, c0:c1])
        state = running()
        nbytes_fwd = logits.numel() * 4
        nbytes_bwd = logits.numel() * (4 + 2)
        ce[width] = {
            "width": c1 - c0,
            "fwd_ms": event_ms(torch, lambda: fce.ce_chunk_fwd(
                logits, t, c0, *state), 20),
            "fwd_plain_ms": event_ms(torch, lambda: fce.ce_chunk_fwd_reference(
                logits, t, c0, *state), 5),
            "bwd_ms": event_ms(torch, lambda: fce.ce_chunk_bwd(
                logits, t, c0, lse, g, z, torch.bfloat16), 20),
            "bwd_plain_ms": event_ms(torch, lambda: fce.ce_chunk_bwd_reference(
                logits, t, c0, lse, g, z, torch.bfloat16), 5),
            "fwd_bound_ms": nbytes_fwd / HBM_BYTES_PER_S * 1e3,
            "bwd_bound_ms": nbytes_bwd / HBM_BYTES_PER_S * 1e3,
            "product_ms": event_ms(torch, lambda: quant.dot_f32(
                x, w[:, c0:c1]), 5)}
        del logits, state
    # the whole loss, forward and backward, fused and unfused (the
    # unfused head and cross-entropy: the yardstick the fused path
    # replaces), with the memory each takes beyond its inputs
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()

    def fused_loss():
        loss = fce.fused_linear_cross_entropy(xg[None], wg, t[None])
        return torch.autograd.grad(loss, (xg, wg))

    def unfused_loss():
        logits = llama._LMHead.apply(xg[None], wg)
        loss = train.cross_entropy(logits, t[None], with_accuracy=False)[0]
        return torch.autograd.grad(loss, (xg, wg))

    for name, fn in (("fused", fused_loss), ("unfused", unfused_loss)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads_once = fn()
        torch.cuda.synchronize()
        ce[f"{name}_loss_extra_gib"] = (torch.cuda.max_memory_allocated()
                                        - base) / 2**30
        del grads_once
        ce[f"{name}_loss_fwd_bwd_ms"] = event_ms(torch, fn, 2)
    del xg, wg
    out["fused_ce"] = ce
    emit({"phase": 5, "kernel": "ce_chunk_fwd/ce_chunk_bwd", **ce})
    if not ce["target_logit_equal"]:
        fail("ce_chunk_fwd: the target logits differ from the plain version's")
    if not torch.allclose(lse_k, lse, **LSE_TOL):
        fail(f"ce_chunk_fwd: lse misses the plain version by "
             f"{ce['lse_max_abs_err']:.3e} ({LSE_TOL})")
    if dl_off["past_tolerance"]:
        fail(f"ce_chunk_bwd: dlogits miss the plain version by more than one "
             f"bf16 ulp: {dl_off}")
    if ce["fused_loss_extra_gib"] >= ce["unfused_loss_extra_gib"]:
        fail(f"the fused loss takes {ce['fused_loss_extra_gib']:.2f} GiB, "
             f"not less than the unfused {ce['unfused_loss_extra_gib']:.2f}")
    del x, w, t, run_k, run_p, lse_k, lse
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 product at w1's shape: the int32 result bit for bit a
    # float64 product of the same codes (exact: |sums| < 2^53)
    m_, k_, n_ = INT8_SHAPE
    a = torch.randn((m_, k_), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    b = (torch.randn((k_, n_), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    qx, _ = quant.quantize_int8(a, axis=-1)
    qw, _ = quant.quantize_int8(b, axis=0)
    y = quant._int_product(qx, qw)
    y64 = qx.double() @ qw.double()
    exact = torch.equal(y.double(), y64)
    int32_err = float((y.double() - y64).abs().max())
    del y64
    ref = quant.dot_f32(a, b)
    y8 = quant.int8_matmul(a, b)
    flops = 2 * m_ * k_ * n_
    i8 = {"shape": {"m": m_, "k": k_, "n": n_}, "int32_exact": exact,
          "max_abs_err": int32_err,
          "rel_err_vs_bf16_operands": float((y8.float() - ref).norm()
                                            / ref.norm()),
          "ms": event_ms(torch, lambda: quant.int8_matmul(a, b), 5),
          "int_mm_ms": event_ms(torch, lambda: quant._int_product(qx, qw), 5),
          "plain_ms": event_ms(torch, lambda: qx.double() @ qw.double(), 1),
          # the yardstick the port does not call for this product: the
          # bf16 product of the unquantized operands
          "library_ms": event_ms(torch, lambda: torch.mm(a, b), 5),
          "bound_ms": max(flops / 1979e12,
                          (m_ * k_ * 2 + k_ * n_ * 2 + m_ * n_ * 2)
                          / HBM_BYTES_PER_S) * 1e3,
          "bound_by": "operations", "flops": flops}
    out["int8_matmul"] = i8
    emit({"phase": 5, "kernel": "int8_matmul", **i8})
    if not exact:
        fail("int8 product: the int32 result differs from the float64 product "
             "of the same codes")
    del a, b, qx, qw, y, ref, y8
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- phase 6 -----------------------------------------------------------------


def phase_training(torch, kernel_support, attention_mod, llama, train,
                   trainer_mod) -> dict:
    """The trainer at Llama-3-8B widths, depth cut to TRAIN_LAYERS, with
    the launch counts of exactly that run; then kernels vs plain
    attention on a 2-layer f32 copy, and the gradients of its bf16 copy
    against the f32 plain path's."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    tcfg = trainer_mod.TrainerConfig(
        model=cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        total_steps=TRAIN_STEPS, warmup_steps=2, log_every=1,
        device="cuda",
    )
    # the same run again from the same seed: its losses must repeat bit
    # for bit (no atomics, fixed summation orders in every kernel)
    repeat = trainer_mod.Trainer(tcfg).run()
    repeat_losses = [h["loss"] for h in repeat.metrics_history if "loss" in h]
    del repeat
    gc.collect()
    torch.cuda.empty_cache()
    run = measured_run(torch, kernel_support, trainer_mod, tcfg)
    losses, norms, launches = run["losses"], run["grad_norms"], run["launches"]
    hist = list(zip(losses, norms))
    need = cfg.n_layers * TRAIN_STEPS
    # the random init's logits: unit-RMS hidden states times std-0.02
    # head weights have variance d * 0.02^2, and the expected cross-entropy
    # of iid normal logits is ln V + variance / 2 (plus the z-loss)
    logit_var = cfg.d_model * 0.02 ** 2
    expected_loss = math.log(cfg.vocab_size) + logit_var / 2
    out = {
        "phase": 6, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "remat_policy": cfg.remat_policy, **run,
        "ln_vocab": math.log(cfg.vocab_size),
        "expected_step1_loss": expected_loss, "launches_needed": need,
        "losses_repeat_bitwise": losses == repeat_losses,
    }

    # kernels vs plain attention, 2 layers in f32 at the run's B and S: the
    # first update has learning rate 0, so both steps see the same
    # parameters
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    opt = train.make_optimizer()
    state = train.init_train_state(cfg32, opt, seed=SEED, device="cuda")
    batch = train.synthetic_batch(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                                  device="cuda")
    routes = []
    for plain in (False, True):
        kernel_support.reset_launch_counts()
        _, m = train.make_train_step(cfg32, opt, plain_attention=plain)(
            state, batch)
        routes.append((m, kernel_support.launch_counts()))
    (m_kernel, kernel_counts), (m_plain, plain_counts) = routes
    cmp = {k: (float(m_kernel[k]), float(m_plain[k]))
           for k in ("loss", "grad_norm")}
    out["f32_two_layer_kernel_vs_plain"] = cmp
    out["f32_two_layer_launches"] = {"kernel_path": kernel_counts,
                                     "plain_path": plain_counts}
    bf16_grads = bf16_gradient_distances(torch, kernel_support, train, cfg32,
                                         state["params"], batch)
    out["bf16_two_layer_gradients"] = bf16_grads
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)

    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"non-finite loss or grad_norm: {losses} {norms}")
    if len(losses) != TRAIN_STEPS or not all(x > 0 for x in norms):
        fail(f"want {TRAIN_STEPS} logged steps with grad_norm > 0: {hist}")
    if abs(losses[0] - expected_loss) > 0.5:
        fail(f"step-1 loss {losses[0]:.4f} is not within 0.5 of "
             f"ln(vocab) + d * 0.02^2 / 2 = {expected_loss:.4f}")
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        if launches.get(name, 0) != need:
            fail(f"{name} launched {launches.get(name, 0)} times; the run "
                 f"needs exactly {need} = {cfg.n_layers} layers x "
                 f"{TRAIN_STEPS} steps")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        tc = launches.get(kernel_support.engine_key(name, "tensor_cores"), 0)
        if tc != need or launches.get(name, 0) != need:
            fail(f"{name} launched {launches.get(name, 0)} times, {tc} on "
                 f"the tensor cores; the run needs exactly {need} bf16 "
                 "launches")
    if losses != repeat_losses:
        fail(f"the losses of two runs differ: {losses} vs {repeat_losses}")
    if launches.get(attention_mod.MHA_ROUTE, 0):
        fail(f"{launches[attention_mod.MHA_ROUTE]} attention calls took "
             "mha_reference on the card")
    if any(kernel_counts.get(kernel_support.engine_key(name, "cuda_cores"))
           != cfg32.n_layers
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            not plain_counts.get(attention_mod.MHA_ROUTE, 0) or \
            any(name.startswith("flash_") for name in plain_counts):
        fail(f"f32 comparison took the wrong routes: {kernel_counts} "
             f"(kernels) and {plain_counts} (plain)")
    worse = {leaf: d for leaf, d in bf16_grads["per_leaf"].items()
             if d["kernel"] > BF16_FACTOR * d["plain"]}
    if worse or bf16_grads["launches"].get(kernel_support.engine_key(
            "flash_bwd_dq", "tensor_cores")) != cfg32.n_layers:
        fail(f"bf16 kernel path's gradients more than {BF16_FACTOR}x the "
             f"plain path's distance from the f32 plain path's: {worse}; "
             f"launches {bf16_grads['launches']}")
    (lk, lp), (gk, gp) = cmp["loss"], cmp["grad_norm"]
    if abs(lk - lp) > LOSS_RTOL * abs(lp) or \
            abs(gk - gp) > GRAD_NORM_RTOL * abs(gp):
        fail(f"f32 kernel path vs plain path: loss {lk} vs {lp}, "
             f"grad_norm {gk} vs {gp}")
    return out


def bf16_gradient_distances(torch, kernel_support, train, cfg32, params,
                            batch) -> dict:
    """The gradients of the f32 model's bf16 copy through the kernels (the
    tensor cores) and through the plain attention, each leaf's relative
    L2 distance from the f32 plain path's gradients: the bf16 check of
    the training path, in the manner of phase 3's (both bf16 paths round
    the weights and activations alike; the kernel path's attention rounds
    only p and dS, so it must lie no further than BF16_FACTOR times the
    plain path)."""
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)

    def as_bf16(tree):
        return {k: as_bf16(v) if isinstance(v, dict) else v.bfloat16()
                for k, v in tree.items()}

    def grads(cfg, tree, plain):
        leaves = train.param_leaves(tree)
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, _ = train.loss_fn(tree, batch, cfg, with_accuracy=False,
                                    plain_attention=plain)
            out = torch.autograd.grad(loss, leaves)
            for leaf in leaves:
                leaf.requires_grad_(False)
        return [g.float() for g in out]

    want = grads(cfg32, params, True)
    params16 = as_bf16(params)
    names = [".".join(path) for path in _leaf_paths(params)]
    per_leaf = {name: {} for name in names}
    for route, plain in (("kernel", False), ("plain", True)):
        kernel_support.reset_launch_counts()
        got = grads(cfg16, params16, plain)
        if not plain:
            launches = kernel_support.launch_counts()
        for name, w, g in zip(names, want, got):
            per_leaf[name][route] = float((g - w).norm() / w.norm())
        del got
    return {"per_leaf": per_leaf, "launches": launches}


def _leaf_paths(tree, prefix=()):
    """The key path of each leaf, in ``train.param_leaves``' order."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaf_paths(value, (*prefix, str(key))))
        else:
            out.append((*prefix, str(key)))
    return out


def timed_updates(torch, optimizer) -> list:
    """Wrap ``optimizer.update`` in CUDA events (one pair a call, read
    after the run): the update's own device time, step by step."""
    events = []
    update = optimizer.update

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        norm = update(*args, **kwargs)
        end.record()
        events.append((start, end))
        return norm

    optimizer.update = timed
    return events


def measured_run(torch, kernel_support, trainer_mod, tcfg) -> dict:
    """One trainer run with the launch counts of exactly that run, the
    step times (synchronised at each step's end), the optimizer update's
    device ms, tokens/s, MFU and the peak memory."""
    trainer = trainer_mod.Trainer(tcfg)
    updates = timed_updates(torch, trainer.optimizer)
    stamps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    kernel_support.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.run(on_step=on_step)
    launches = kernel_support.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = [h for h in result.metrics_history if "loss" in h]
    step_s = [b_ - a_ for a_, b_ in zip([t0] + stamps[:-1], stamps)]
    steady_ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    tokens_per_s = tcfg.batch_size * tcfg.seq_len / (steady_ms / 1e3)
    update_ms = [s.elapsed_time(e) for s, e in updates]
    out = {
        "losses": [h["loss"] for h in hist],
        "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": [1e3 * x for x in step_s], "steady_step_ms": steady_ms,
        "tokens_per_s": tokens_per_s,
        "trainer_tokens_per_s": result.tokens_per_second,
        "flops_per_token": tcfg.model.flops_per_token(),
        "mfu": tcfg.model.flops_per_token() * tokens_per_s
        / PEAK_FLOPS["bfloat16"],
        "peak_memory_gib": peak_gib, "resident_before_gib": resident_gib,
        "launches": launches, "update_ms": update_ms,
        "steady_update_ms": sum(update_ms[1:]) / max(len(update_ms) - 1, 1),
        "leaves": len(trainer.state["opt_state"]["mu"]),
    }
    del trainer, result
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the phase-6 runs of the fused training ops, each against the unfused run
FUSED_RUNS = {"train_fused": dict(fused_ce=True, opt_impl="fused"),
              "train_int8": dict(quant="int8")}
FUSED_STEP1_TOL = 1e-2  # train_fused's step-1 loss against the unfused run's
INT8_LOSS_RTOL = 0.05   # train_int8's final loss against bf16's (the
                        # reference's bound, tests/test_quant.py)


def phase_fused_training(torch, kernel_support, llama, trainer_mod, fo, fce,
                         quant, base: dict) -> dict:
    """The trainer at phase 6's shapes with ``--optImpl fused --fusedCE``
    (``train_fused``: K5, K6 and K7 on the path, the losses repeating bit
    for bit, less memory than the unfused run) and with ``--quant int8``
    (``train_int8``: the int8 products, none re-run in the backward), each
    against the unfused run ``base``."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    out = {}
    for run, opts in FUSED_RUNS.items():
        opt_impl = opts.get("opt_impl", "optax")
        model = dataclasses.replace(cfg, **{k: v for k, v in opts.items()
                                            if k != "opt_impl"})
        tcfg = trainer_mod.TrainerConfig(
            model=model, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            total_steps=TRAIN_STEPS, warmup_steps=2, log_every=1,
            opt_impl=opt_impl, device="cuda")
        repeat = None
        if run == "train_fused":
            first = trainer_mod.Trainer(tcfg).run()
            repeat = [h["loss"] for h in first.metrics_history if "loss" in h]
            del first
        row = measured_run(torch, kernel_support, trainer_mod, tcfg)
        row.update(run=run, opt_impl=opt_impl, fused_ce=model.fused_ce,
                   quant=model.quant, card=card_line(),
                   unfused_losses=base["losses"],
                   unfused_steady_step_ms=base["steady_step_ms"],
                   unfused_mfu=base["mfu"],
                   unfused_peak_memory_gib=base["peak_memory_gib"],
                   unfused_steady_update_ms=base["steady_update_ms"])
        if repeat is not None:
            row["losses_repeat_bitwise"] = row["losses"] == repeat
        out[run] = row
        emit({"phase": 6, **row})

    steps = TRAIN_STEPS
    flash = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    fused, int8 = out["train_fused"], out["train_int8"]
    n_chunks = len(fce.chunk_bounds(cfg.vocab_size, CE_CHUNK))
    for run, row in out.items():
        if not all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]) \
                or len(row["losses"]) != steps:
            fail(f"{run}: want {steps} finite losses and grad norms: "
                 f"{row['losses']} {row['grad_norms']}")
        for name in flash:
            for key in (name, kernel_support.engine_key(name, "tensor_cores")):
                if row["launches"].get(key, 0) != base["launches"].get(key, 0):
                    fail(f"{run}: {key} launched {row['launches'].get(key, 0)} "
                         f"times, the unfused run {base['launches'].get(key, 0)}")
    if abs(fused["losses"][0] - base["losses"][0]) > FUSED_STEP1_TOL:
        fail(f"train_fused: step-1 loss {fused['losses'][0]} is not within "
             f"{FUSED_STEP1_TOL} of the unfused run's {base['losses'][0]}")
    if not fused["losses_repeat_bitwise"]:
        fail("train_fused: the losses of two runs differ")
    want = {**{k: steps * n for k, n in
               fo.launches_per_update(fused["leaves"]).items()},
            fce.FWD_NAME: steps * n_chunks, fce.BWD_NAME: steps * n_chunks}
    got = {k: fused["launches"].get(k, 0) for k in want}
    if got != want:
        fail(f"train_fused: launches {got}, the run needs {want}")
    if fused["peak_memory_gib"] >= base["peak_memory_gib"]:
        fail(f"train_fused: peak {fused['peak_memory_gib']:.2f} GiB is not "
             f"below the unfused run's {base['peak_memory_gib']:.2f}")
    if abs(int8["losses"][-1] - base["losses"][-1]) > \
            INT8_LOSS_RTOL * base["losses"][-1]:
        fail(f"train_int8: final loss {int8['losses'][-1]} is not within "
             f"{INT8_LOSS_RTOL:.0%} of bf16's {base['losses'][-1]}")
    # the forward's seven projections a layer and step; none in the
    # backward (the remat policy saves the int8 products' outputs)
    need = 7 * cfg.n_layers * steps
    if int8["launches"].get(quant.INT8_NAME, 0) != need:
        fail(f"train_int8: {int8['launches'].get(quant.INT8_NAME, 0)} int8 "
             f"products; the forward needs exactly {need}")
    return out


# --- phase 7 -----------------------------------------------------------------

CKPT_LAYERS, CKPT_STEPS, CKPT_AT, CKPT_KEEP = 2, 4, 2, 2
CKPT_ROOT = os.path.join(ROOT, ".ckpt_smoke")  # gitignored; deleted after
CKPT_FREE_MIN = 24e9  # two 8.9 GB steps on disk while the second commits
CKPT_PROMPT, CKPT_NEW = 200, 32
LORA_TRAIN_RANK, LORA_TRAIN_STEPS, LORA_TRAIN_LR = 16, 6, 1e-2


class Preempted(Exception):
    """Raised from a trainer's ``on_step`` to stop a run mid-way."""


def _state_leaves(train, state) -> list:
    return (train.param_leaves(state["params"]) + state["opt_state"]["mu"]
            + state["opt_state"]["nu"])


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def ckpt_resume(torch, kernel_support, llama, train, trainer_mod,
                mha_route: str, directory: str) -> tuple:
    """CKPT_STEPS steps straight through; then CKPT_AT steps with a
    checkpoint every CKPT_AT steps and a stop after step CKPT_AT (the
    preempted run), and a fresh trainer on the same directory run to
    CKPT_STEPS: it resumes at CKPT_AT, and its losses and final params
    and moments equal the straight run's bit for bit. Returns (the row,
    the cfg, the resumed trainer's final state, the flash launches)."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=CKPT_LAYERS)
    base = dict(model=cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                total_steps=CKPT_STEPS, warmup_steps=2, log_every=1,
                device="cuda")
    kernel_support.reset_launch_counts()
    straight = trainer_mod.Trainer(trainer_mod.TrainerConfig(**base))
    want = straight.run()
    want_state = straight.state
    del straight
    tcfg = trainer_mod.TrainerConfig(
        **base, checkpoint_dir=directory, checkpoint_interval=CKPT_AT,
        max_checkpoints=CKPT_KEEP)
    first = trainer_mod.Trainer(tcfg)
    early = []

    def stop(step, metrics):
        early.append(float(metrics["loss"]))
        if step == CKPT_AT:
            raise Preempted

    try:
        first.run(on_step=stop)
        fail("ckpt_resume: the preempted run was not stopped")
    except Preempted:
        pass
    saved_first, steps_first = first.ckpt.last_save, first.ckpt.all_steps()
    del first
    gc.collect()
    torch.cuda.empty_cache()
    second = trainer_mod.Trainer(tcfg)
    got = second.run()
    launches = kernel_support.launch_counts()
    flash = {name: launches.get(name, 0)
             for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    want_losses = [h["loss"] for h in want.metrics_history]
    got_losses = [h["loss"] for h in got.metrics_history]
    leaves_equal = [bool(torch.equal(a, b)) for a, b in zip(
        _state_leaves(train, want_state), _state_leaves(train, second.state))]
    row = {
        "phase": 7, "run": "ckpt_resume", "layers": cfg.n_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": CKPT_STEPS,
        "resumed_from": got.resumed_from, "steps_run": got.steps_run,
        "losses_straight": want_losses, "losses_preempted": early,
        "losses_resumed": got_losses,
        "leaves_equal": sum(leaves_equal), "leaves": len(leaves_equal),
        "count": [want_state["opt_state"]["count"],
                  second.state["opt_state"]["count"]],
        "steps_on_disk": {"preempted": steps_first,
                          "resumed": second.ckpt.all_steps()},
        "save_ms": {f"step{s['step']}": 1e3 * s["save_s"]
                    for s in (saved_first, second.ckpt.last_save)},
        "write_ms": {f"step{s['step']}": 1e3 * s["write_s"]
                     for s in (saved_first, second.ckpt.last_save)},
        "restore_ms": 1e3 * second.ckpt.last_restore["seconds"],
        "state_bytes": saved_first["bytes"],
        "restore_bytes": second.ckpt.last_restore["bytes"],
        "bytes_on_disk": _dir_bytes(directory),
        "flash_launches": flash,
    }
    emit(row)
    if got.resumed_from != CKPT_AT or got.steps_run != CKPT_STEPS - CKPT_AT:
        fail(f"ckpt_resume: resumed_from {got.resumed_from}, steps_run "
             f"{got.steps_run}; want {CKPT_AT} and {CKPT_STEPS - CKPT_AT}")
    if early != want_losses[:CKPT_AT] or \
            got_losses != want_losses[CKPT_AT:]:
        fail(f"ckpt_resume: losses {early} + {got_losses} are not the "
             f"straight run's {want_losses} bit for bit")
    if not all(leaves_equal) or row["count"][0] != row["count"][1]:
        fail(f"ckpt_resume: {len(leaves_equal) - sum(leaves_equal)} "
             "params/moments differ from the straight run's")
    if steps_first != [CKPT_AT] or \
            row["steps_on_disk"]["resumed"] != [CKPT_AT, CKPT_STEPS]:
        fail(f"ckpt_resume: steps on disk {row['steps_on_disk']}")
    # one launch of each a layer and step: the straight run's CKPT_STEPS,
    # the preempted run's CKPT_AT and the resumed run's rest
    need = cfg.n_layers * 2 * CKPT_STEPS
    if any(n != need for n in flash.values()) or launches.get(mha_route, 0):
        fail(f"ckpt_resume: flash launches {flash}, want {need} each")
    state = second.state
    del want_state, second
    gc.collect()
    torch.cuda.empty_cache()
    return row, cfg, state, flash


def ckpt_serve(torch, server_mod, generate, kernel_support, rpa, train, cfg,
               trained: dict, directory: str) -> tuple:
    """``load_params`` on the directory equals the trained params bit for
    bit; a ``--checkpointDir`` server's greedy stream (one slot: the
    decode step's GEMMs at generate's M) equals ``generate`` on them."""
    params = server_mod.load_params(cfg, directory, device="cuda")
    pairs = list(zip(train.param_leaves(params), train.param_leaves(trained)))
    equal = sum(bool(a.dtype == b.dtype and torch.equal(a, b))
                for a, b in pairs)
    prompt = fleet_ids(CKPT_PROMPT, SEED + 7, cfg.vocab_size)
    oracle = generate.generate(params, torch.tensor([prompt], device="cuda"),
                               cfg, CKPT_NEW)[0].tolist()
    argv = ["--preset", "llama3_8b", "--checkpointDir", directory,
            "--slots", "1", "--maxLen", "2048"]
    args, server, url = start_server(server_mod, argv, None)
    try:
        cb = server.engine.cb
        if cb.cfg.n_layers != cfg.n_layers:
            fail(f"ckpt_serve: the server read {cb.cfg.n_layers} layers "
                 f"off a {cfg.n_layers}-layer checkpoint")
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        kernel_support.reset_launch_counts()
        got = _post(url, {"prompt": prompt, "max_new": CKPT_NEW,
                          "stream": True})
        k1 = k1_counts(kernel_support, rpa)
        need = cfg.n_layers * (cb.decode_steps - steps0
                               + cb.prefill_chunks - chunks0)
    finally:
        server.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 7, "run": "ckpt_serve", "layers": cfg.n_layers,
           "leaves_equal": equal, "leaves": len(pairs),
           "prompt": CKPT_PROMPT, "max_new": CKPT_NEW,
           "stream_equal": got["tokens"] == oracle,
           "first_divergence": first_divergence(got["tokens"], oracle),
           "ttft_s": got["ttft"], "k1_launches": k1}
    emit(row)
    if equal != len(pairs):
        fail(f"ckpt_serve: {len(pairs) - equal} restored leaves differ from "
             "the trained params")
    if got["tokens"] != oracle:
        fail(f"ckpt_serve: the served stream parts from generate's at token "
             f"{row['first_divergence']}")
    if not k1["total"] or k1["total"] != need or \
            k1["tensor_cores"] != need:
        fail(f"ckpt_serve: K1 launches {k1}, want {need} (a layer per "
             "decode step and chunk) on the tensor cores")
    return row, params, k1["total"]


def lora_train(torch, kernel_support, lora, train, mha_route: str, cfg,
               base: dict) -> tuple:
    """A rank-16 adapter on all seven targets, LORA_TRAIN_STEPS steps on
    one batch (bf16, the tensor cores); then one f32 step's factor
    gradients through the kernels (CUDA cores) and the plain attention."""
    lc = lora.LoraConfig(rank=LORA_TRAIN_RANK, alpha=2.0 * LORA_TRAIN_RANK,
                         targets=lora.TARGETABLE)
    opt = train.make_optimizer(learning_rate=LORA_TRAIN_LR, warmup_steps=1,
                               total_steps=LORA_TRAIN_STEPS)
    state = lora.init_lora_state(cfg, lc, opt, seed=SEED, device="cuda")
    batch = train.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 1,
                                  device="cuda")
    before = [p.clone() for p in train.param_leaves(base)]
    step = lora.make_lora_train_step(base, cfg, lc, opt)
    kernel_support.reset_launch_counts()
    losses, norms, stamps = [], [], [time.perf_counter()]
    for _ in range(LORA_TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        stamps.append(time.perf_counter())
    launches = kernel_support.launch_counts()
    base_equal = all(torch.equal(a, b) and not b.requires_grad for a, b in
                     zip(before, train.param_leaves(base)))
    del before
    need = cfg.n_layers * LORA_TRAIN_STEPS
    flash = {name: {"total": launches.get(name, 0), **{
        e: launches.get(kernel_support.engine_key(name, e), 0)
        for e in kernel_support.ENGINES}}
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    # f32: the base and the trained factors widened, one step's factor
    # gradients by both attention routes
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    base32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.float())
              for k, v in base.items()}
    lp32 = {t: {k: v.float() for k, v in ab.items()}
            for t, ab in state["lora"].items()}
    routes = []
    for plain in (False, True):
        kernel_support.reset_launch_counts()
        g, m = lora.lora_grads(base32, lp32, batch, cfg32, lc,
                               plain_attention=plain)
        routes.append((g, float(m["loss"]), kernel_support.launch_counts()))
        del g
    (gk, lk, ck), (gp, lp_, cp) = routes
    names = [".".join(p) for p in _leaf_paths(lp32)]
    rel = {n: float((a - b).norm() / b.norm()) for n, a, b in
           zip(names, gk, gp)}
    del base32, lp32, routes, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 7, "run": "lora_train", "layers": cfg.n_layers,
           "rank": LORA_TRAIN_RANK, "targets": list(lc.targets),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": LORA_TRAIN_STEPS,
           "lr": LORA_TRAIN_LR, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "base_bit_equal": base_equal,
           "flash_launches": flash,
           "mha_reference_calls": launches.get(mha_route, 0),
           "f32_loss_kernel_vs_plain": [lk, lp_],
           "f32_factor_grad_rel_dist_max": max(rel.values()),
           "f32_factor_grad_rel_dist": rel,
           "f32_launches": {"kernel_path": ck, "plain_path": cp}}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms) or \
            not losses[-1] < losses[0]:
        fail(f"lora_train: the loss did not fall: {losses}")
    if not base_equal:
        fail("lora_train: the base weights changed or require grad")
    for name, c in flash.items():
        if c["total"] != need or c["tensor_cores"] != need:
            fail(f"lora_train: {name} launched {c}; want {need} on the "
                 "tensor cores")
    if row["mha_reference_calls"]:
        fail("lora_train: attention took mha_reference on the card")
    if any(ck.get(kernel_support.engine_key(n, "cuda_cores")) != cfg.n_layers
           for n in flash) or not cp.get(mha_route, 0) or \
            any(n.startswith("flash_") for n in cp):
        fail(f"lora_train f32: wrong routes {ck} / {cp}")
    if abs(lk - lp_) > LOSS_RTOL * abs(lp_) or \
            row["f32_factor_grad_rel_dist_max"] > GRAD_NORM_RTOL:
        fail(f"lora_train f32: kernel vs plain loss {lk} / {lp_}, factor "
             f"gradients apart by {row['f32_factor_grad_rel_dist_max']:.3e} "
             f"(> {GRAD_NORM_RTOL})")
    return row, state, lc, {n: c["total"] for n, c in flash.items()}


def lora_ckpt_serve(torch, server_mod, batching, lora, kernel_support, rpa,
                    ckpt_mod, cfg, params, state, lc, directory: str,
                    adapter_dir: str) -> tuple:
    """The trained adapter's state saved, then served by
    ``--loraAdapters ft=dir`` beside ``--checkpointDir``: its bf16 stream
    against the merged weights' (reported), and on the f32 twin (the
    same checkpoint loaded for the f32 config) tokens equal to the merged
    oracle's and logprobs within LORA_F32_TOL."""
    with ckpt_mod.TrainCheckpointer(adapter_dir, async_save=False) as c:
        c.save(state, step=state["step"], force=True)
    prompt = fleet_ids(CKPT_PROMPT, SEED + 8, cfg.vocab_size)
    argv = ["--preset", "llama3_8b", "--checkpointDir", directory,
            "--loraAdapters", f"ft={adapter_dir}", "--slots", "1",
            "--maxLen", "2048"]
    args, server, url = start_server(server_mod, argv, None)
    try:
        cb = server.engine.cb
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        kernel_support.reset_launch_counts()
        got = _post(url, {"prompt": prompt, "max_new": CKPT_NEW,
                          "adapter": "ft"})
        served_k1 = k1_counts(kernel_support, rpa)
        need = cfg.n_layers * (cb.decode_steps - steps0
                               + cb.prefill_chunks - chunks0)
    finally:
        server.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    merged = lora.merge_lora(params, state["lora"], lc)
    kernel_support.reset_launch_counts()
    [(want, _)], cb = serve_batch(batching, merged, cfg, [(prompt, -1)])
    k1 = served_k1["total"] + k1_counts(kernel_support, rpa)["total"]
    del merged, cb
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    kernel_support.reset_launch_counts()
    [(t32, l32)], cb = serve_batch(
        batching, p32, cfg32, [(prompt, 0)],
        adapters=server_mod.load_adapters(cfg32, f"ft={adapter_dir}",
                                          device="cuda"))
    del cb
    lp32 = {t: {k: v.float() for k, v in ab.items()}
            for t, ab in state["lora"].items()}
    [(w32, wl32)], cb = serve_batch(batching, lora.merge_lora(p32, lp32, lc),
                                    cfg32, [(prompt, -1)])
    k1 += k1_counts(kernel_support, rpa)["total"]
    del cb, p32, lp32
    gc.collect()
    torch.cuda.empty_cache()
    err = max(abs(x - y) for x, y in zip(l32, wl32)) if t32 == w32 else None
    row = {"phase": 7, "run": "lora_ckpt_serve", "layers": cfg.n_layers,
           "adapter_bytes": _dir_bytes(adapter_dir),
           "bf16_first_divergence": first_divergence(got["tokens"][:len(want)],
                                                     want),
           "bf16_served_new": len(got["tokens"]),
           "f32_stream_equal": t32 == w32,
           "f32_first_divergence": first_divergence(t32, w32),
           "f32_logprob_max_err": err, "f32_tol": LORA_F32_TOL,
           "k1_launches_served": served_k1, "k1_launches": k1}
    emit(row)
    if t32 != w32 or err > LORA_F32_TOL:
        fail(f"lora_ckpt_serve f32: the adapter's stream parts from the "
             f"merged oracle's at {row['f32_first_divergence']} (logprob "
             f"error {err})")
    if not served_k1["total"] or served_k1["total"] != need:
        fail(f"lora_ckpt_serve: K1 launches {served_k1}, want {need} (a "
             "layer per decode step and chunk)")
    return row, k1


def phase_checkpoints(torch, kernel_support, attention_mod, llama, train,
                      trainer_mod, lora, ckpt_mod, server_mod, generate,
                      batching, rpa) -> dict:
    """Phase 7 in a directory beside the script, removed on every path."""
    free = shutil.disk_usage(ROOT).free
    emit({"phase": 7, "run": "ckpt_disk", "dir": CKPT_ROOT,
          "free_bytes": free, "need_bytes": CKPT_FREE_MIN})
    if free < CKPT_FREE_MIN:
        fail(f"phase 7 needs {CKPT_FREE_MIN:.0f} free bytes beside the "
             f"script for two checkpoint steps, {free} are free")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    trained = os.path.join(CKPT_ROOT, "trained")
    try:
        resume, cfg, state, flash = ckpt_resume(
            torch, kernel_support, llama, train, trainer_mod,
            attention_mod.MHA_ROUTE, trained)
        serve, params, k1 = ckpt_serve(torch, server_mod, generate,
                                       kernel_support, rpa, train, cfg,
                                       state["params"], trained)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        lt, lstate, lc, lflash = lora_train(
            torch, kernel_support, lora, train, attention_mod.MHA_ROUTE, cfg,
            params)
        ls_row, ls_k1 = lora_ckpt_serve(
            torch, server_mod, batching, lora, kernel_support, rpa,
            ckpt_mod, cfg, params, lstate, lc, trained,
            os.path.join(CKPT_ROOT, "adapter"))
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    del params, lstate
    gc.collect()
    torch.cuda.empty_cache()
    return {"ckpt_resume": resume, "ckpt_serve": serve, "lora_train": lt,
            "lora_ckpt_serve": ls_row, "k1_launches": k1 + ls_k1,
            "flash_launches": {n: flash[n] + lflash[n] for n in flash},
            "lora_flash_launches": lflash}


# --- main --------------------------------------------------------------------


# --- phase 8, the tiny preset from the command line ---------------------------

# the trainer's and the server's defaults at --preset tiny (d_model 128,
# 8 q heads, 4 kv heads: head dim 16)
TINY_BATCH, TINY_SEQ = 8, 128               # trainer --batchSize, --seqLen
TINY_SLOTS, TINY_MAX_LEN, TINY_CHUNK = 8, 2048, 256   # server defaults
TINY_ROOT = os.path.join(ROOT, ".tiny_smoke")  # gitignored; deleted after
TINY_STEPS = 20
TINY_CORPUS_TOKENS = 1 << 24                # uint16 ids below the vocab
TINY_TRACE_STEPS = (3, 6)                   # the trainer's trace window
TINY_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                "flash_bwd_dq_tc_kernel")
# (prompt, max_new) served one at a time: each prompt one chunk, so the
# served stream and generate's prefill the same rows
TINY_REQUESTS = [(17, 48), (100, 48), (200, 32), (256, 32)]
TINY_TWIN_STEPS = 5


def run_module(module: str, argv: list, timeout: float):
    """``python -m module argv`` from the checkout, its output captured;
    fails the script when it does not exit 0."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{module} {' '.join(argv)} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc


def log_lines(text: str, msg: str) -> list:
    """The JSON log lines of ``text`` whose ``msg`` is ``msg``."""
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if entry.get("msg") == msg:
                out.append(entry)
    return out


def tiny_train(torch, llama, corpus: str, trace_dir: str,
               ckpt_dir: str) -> dict:
    """The trainer's CLI at --preset tiny and its defaults on the card,
    fed by the native gather, writing its spans, its profile of steps
    [3, 6) and its checkpoint."""
    cfg = llama.LlamaConfig.tiny()
    t0 = time.perf_counter()
    proc = run_module("k8s_gpu_device_plugin_torch.models.trainer", [
        "--preset", "tiny", "--steps", str(TINY_STEPS), "--dataFile", corpus,
        "--traceDir", trace_dir, "--checkpointDir", ckpt_dir], timeout=300)
    wall_s = time.perf_counter() - t0
    summary = proc.stdout.strip().splitlines()[-1]
    steps = log_lines(proc.stderr, "train step")
    launches = log_lines(proc.stderr, "kernel launches")
    launches = launches[-1]["launches"] if launches else {}
    traces = sorted(f for f in os.listdir(trace_dir)
                    if f.startswith("train_steps_"))
    trace_text = "".join(open(os.path.join(trace_dir, f)).read()
                         for f in traces)
    with open(os.path.join(trace_dir, "trainer_spans.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    first, stop = TINY_TRACE_STEPS
    marked = sorted(int(m) for m in set(
        re.findall(r'"train_step#(\d+)"', trace_text)))
    need = cfg.n_layers * TINY_STEPS
    row = {"phase": 8, "run": "tiny_train", "wall_s": wall_s,
           "summary": summary, "losses": [e["loss"] for e in steps],
           "grad_norms": [e["grad_norm"] for e in steps],
           "launches": launches, "launches_needed": need,
           "trace_files": traces, "trace_bytes": len(trace_text),
           "trace_kernels": {k: trace_text.count(k) for k in TINY_KERNELS},
           "trace_steps_marked": marked,
           "spans": {n: sum(e["name"] == n for e in spans)
                     for n in ("train_step", "data_load", "step_dispatch",
                               "checkpoint")}}
    emit(row)
    if "data=native-memmap" not in summary or \
            not summary.startswith(f"trainer: steps={TINY_STEPS} "):
        fail(f"tiny_train: {summary!r} (want {TINY_STEPS} steps fed by the "
             "native gather)")
    if len(steps) != TINY_STEPS // 10 or not all(
            math.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in steps):
        fail(f"tiny_train: logged steps {steps}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        tc = launches.get(f"{name}<tensor_cores>", 0)
        if launches.get(name) != need or tc != need:
            fail(f"tiny_train: {name} launched {launches.get(name)} times, "
                 f"{tc} on the tensor cores; the run needs {need}")
    if traces != [f"train_steps_{first}_{stop - 1}.json"] or \
            not all(row["trace_kernels"].values()) or \
            marked != list(range(first, stop)):
        fail(f"tiny_train: trace files {traces}, kernels "
             f"{row['trace_kernels']}, steps marked {marked}")
    if row["spans"] != {"train_step": TINY_STEPS, "data_load": TINY_STEPS,
                        "step_dispatch": TINY_STEPS,
                        "checkpoint": TINY_STEPS}:
        fail(f"tiny_train: spans {row['spans']}")
    return row


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def tiny_serve(torch, llama, generate, server_mod, ckpt_dir: str) -> dict:
    """The server's CLI at --preset tiny serving the trained checkpoint on
    the card (one slot: its decode step's products at generate's M); each
    stream equal to ``generate`` on the restored params, bit for bit, and
    K1's hd-16 launches counted by the server itself."""
    cfg = llama.LlamaConfig.tiny()
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_gpu_device_plugin_torch.serving.server",
         "--preset", "tiny", "--checkpointDir", ckpt_dir, "--slots", "1",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                fail(f"tiny_serve: the server exited {proc.returncode}:\n"
                     f"{proc.stderr.read()[-4000:]}")
            try:
                status, before = get_health(url)
                if status == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 180:
                fail("tiny_serve: the server did not answer in 180 s")
            time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        got = [_post(url, {"prompt": fleet_ids(n, SEED + 8 + i,
                                               cfg.vocab_size),
                           "max_new": m, "stream": True})
               for i, (n, m) in enumerate(TINY_REQUESTS)]
        _, after = get_health(url)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    params = server_mod.load_params(cfg, ckpt_dir, device="cuda")
    want = [generate.generate(params, torch.tensor(
        [fleet_ids(n, SEED + 8 + i, cfg.vocab_size)], device="cuda"), cfg,
        m)[0].tolist() for i, (n, m) in enumerate(TINY_REQUESTS)]
    del params
    k1 = {k: after["kernel_launches"].get(k, 0)
          - before["kernel_launches"].get(k, 0)
          for k in after["kernel_launches"]
          if k.startswith("ragged_paged_attention")}
    need = cfg.n_layers * (after["decode_steps"] - before["decode_steps"]
                           + after["prefill_chunks"] - before["prefill_chunks"])
    row = {"phase": 8, "run": "tiny_serve", "startup_s": startup_s,
           "requests": TINY_REQUESTS, "head_dim": cfg.head_dim,
           "streams_equal": [g["tokens"] == w for g, w in zip(got, want)],
           "first_divergence": [first_divergence(g["tokens"], w)
                                for g, w in zip(got, want)],
           "ttft_s": [g["ttft"] for g in got], "k1_launches": k1,
           "k1_launches_needed": need,
           "decode_attn": after.get("decode_attn")}
    emit(row)
    if not all(row["streams_equal"]):
        fail(f"tiny_serve: streams part from generate's at "
             f"{row['first_divergence']}")
    if k1.get("ragged_paged_attention") != need or need == 0 or \
            k1.get("ragged_paged_attention<tensor_cores>") != need:
        fail(f"tiny_serve: K1 launches {k1}, want {need} on the tensor "
             "cores (a layer per decode step and chunk)")
    return row


def tree_to(tree, device):
    """A copy of a (nested dict of) tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def tiny_f32_twin(torch, kernel_support, llama, trainer_mod) -> dict:
    """TINY_TWIN_STEPS steps of the tiny config in f32 from the same
    parameters and batches: on the card through the flash kernels (the
    CUDA cores), on the CPU through the plain versions."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init_params(cfg, seed=SEED, device="cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        tcfg = trainer_mod.TrainerConfig(
            model=cfg, batch_size=TINY_BATCH, seq_len=TINY_SEQ,
            total_steps=TINY_TWIN_STEPS, log_every=1, device=device)
        kernel_support.reset_launch_counts()
        result = trainer_mod.Trainer(
            tcfg, params=tree_to(params, device)).run()
        runs[device] = {"losses": [h["loss"] for h in result.metrics_history],
                        "grad_norms": [h["grad_norm"]
                                       for h in result.metrics_history],
                        "launches": kernel_support.launch_counts()}
    need = cfg.n_layers * TINY_TWIN_STEPS
    row = {"phase": 8, "run": "tiny_f32_twin", "steps": TINY_TWIN_STEPS,
           **{f"{d}_{k}": v for d, r in runs.items() for k, v in r.items()},
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
               runs["cuda"]["losses"], runs["cpu"]["losses"]))}
    emit(row)
    if len(runs["cuda"]["losses"]) != TINY_TWIN_STEPS or \
            row["loss_rel_err"] > LOSS_RTOL or any(
            abs(a - b) > GRAD_NORM_RTOL * abs(b) for a, b in zip(
                runs["cuda"]["grad_norms"], runs["cpu"]["grad_norms"])):
        fail(f"tiny_f32_twin: card {runs['cuda']} against CPU {runs['cpu']}")
    launches = runs["cuda"]["launches"]
    if any(launches.get(f"{n}<cuda_cores>") != need
           for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            runs["cpu"]["launches"]:
        fail(f"tiny_f32_twin: launches {launches} (card, want {need} each "
             f"on the CUDA cores), {runs['cpu']['launches']} (CPU)")
    return row


def phase_tiny(torch, llama, generate, server_mod, kernel_support,
               trainer_mod) -> dict:
    """Phase 8: the default --preset tiny (head dim 16) end to end from
    the command line on the card: train with a corpus, traces and a
    checkpoint, serve the checkpoint; then the f32 twin."""
    import numpy as np

    shutil.rmtree(TINY_ROOT, ignore_errors=True)
    os.makedirs(TINY_ROOT)
    try:
        corpus = os.path.join(TINY_ROOT, "corpus.bin")
        np.random.default_rng(SEED).integers(
            0, llama.LlamaConfig.tiny().vocab_size, TINY_CORPUS_TOKENS,
            dtype=np.uint16).tofile(corpus)
        ckpt_dir = os.path.join(TINY_ROOT, "ckpt")
        train = tiny_train(torch, llama, corpus,
                           os.path.join(TINY_ROOT, "trace"), ckpt_dir)
        serve = tiny_serve(torch, llama, generate, server_mod, ckpt_dir)
    finally:
        shutil.rmtree(TINY_ROOT, ignore_errors=True)
    twin = tiny_f32_twin(torch, kernel_support, llama, trainer_mod)
    return {"train": train, "serve": serve, "twin": twin}


# --- phase 9, Gemma-2B (head dim 256) and Qwen2-7B (a group of 7) ------------

# the presets' attention heads (q heads, kv heads, head dim)
WIDE_HEADS = {"gemma_2b": dict(hq=8, hkv=1, hd=256),
              "qwen2_7b": dict(hq=28, hkv=4, hd=128)}
WIDE_CHUNK_BASE = 1536
WIDE_VERIFY_T = 4
# (prompt length, max_new), each through a one-slot batcher twice: with the
# prompt as its one chunk (prefill and decode products at generate's M: the
# streams equal generate's bit for bit), and at the serving chunk
# WIDE_CHUNK (17 and 100 pad their finish chunk; a product of more rows may
# round otherwise, so a divergence is judged by near_ties)
WIDE_REQUESTS = [(17, 32), (100, 32), (300, 32), (512, 32)]
WIDE_MAX_LEN = 576
WIDE_CHUNK = 256
WIDE_F32_LAYERS = 2
WIDE_TRAIN_SEQ = 2048
GEMMA_TRAIN_STEPS = 5            # all 18 layers, B 1
QWEN_TRAIN_LAYERS, QWEN_TRAIN_STEPS = 2, 3
# the f32 twin, card against CPU: 2 layers, B 1 at this S
WIDE_TWIN_SEQ, WIDE_TWIN_STEPS, WIDE_TWIN_RTOL = 64, 3, 1e-6


def wide_kernel_cases():
    """K1 at Gemma-2B's heads (hd 256) on every route of NARROW_LAYOUTS and
    at Qwen2-7B's (a group of 7), dense and paged: decode over 8 slots, a
    T-256 chunk at base 1536 and a T-4 verify window over 8 slots, S 2048;
    bf16, and f32 on the dense route."""
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    vbases = [-1, 0, 1, 255, 256, 1000, 2048 - WIDE_VERIFY_T - 1,
              2048 - WIDE_VERIFY_T]
    cases = []
    for model, heads in WIDE_HEADS.items():
        layouts = NARROW_LAYOUTS if model == "gemma_2b" else \
            (("dense", 0), ("paged", 64))
        for route, ps in layouts:
            tag = route + (f"_ps{ps}" if ps else "")
            dtypes = ("bfloat16", "float32") if route == "dense" \
                else ("bfloat16",)
            for kind, b, t, bases in (
                    ("decode", 8, 1, bases8),
                    (f"prefill_t256_base{WIDE_CHUNK_BASE}", 1, 256,
                     [WIDE_CHUNK_BASE]),
                    (f"verify_t{WIDE_VERIFY_T}", 8, WIDE_VERIFY_T, vbases)):
                cases.append(dict(name=f"{kind}_{model}_{tag}", b=b, t=t,
                                  bases=bases, window=0, route=route, ps=ps,
                                  verify=kind.startswith("verify"),
                                  dtypes=dtypes, s=2048, **heads))
    # the window at hd 256 (Gemma-2B's heads, W 64): decode, dense (bf16 and
    # f32) and paged, and a T-256 chunk at base 1536, dense
    for kind, b, t, bases, route, ps, dtypes in (
            ("decode", 8, 1, bases8, "dense", 0, ("bfloat16", "float32")),
            ("decode", 8, 1, bases8, "paged", 64, ("bfloat16",)),
            (f"prefill_t256_base{WIDE_CHUNK_BASE}", 1, 256, [WIDE_CHUNK_BASE],
             "dense", 0, ("bfloat16", "float32"))):
        tag = route + (f"_ps{ps}" if ps else "")
        cases.append(dict(name=f"{kind}_window64_gemma_2b_{tag}", b=b, t=t,
                          bases=bases, window=64, route=route, ps=ps,
                          verify=False, dtypes=dtypes, s=2048,
                          **WIDE_HEADS["gemma_2b"]))
    return cases


def wide_flash_cases():
    """K2-K4 at the training shape's B and S: Gemma-2B's heads (hd 256) and
    Qwen2-7B's (a group of 7), and Gemma-2B's heads under a window of 512
    (K3's halves kernel masks on its own)."""
    return [*(dict(name=f"causal_{model}", window=0, b=TRAIN_BATCH,
                   s=TRAIN_SEQ, **heads) for model, heads in WIDE_HEADS.items()),
            dict(name="causal_window512_gemma_2b", window=512, b=TRAIN_BATCH,
                 s=TRAIN_SEQ, **WIDE_HEADS["gemma_2b"])]


def wide_decider(torch, batching, generate, cfg, params, chunk: int):
    """``decide`` for near_ties over one-slot batchers at ``chunk`` against
    ``generate``: stream ``k`` rerun through token ``j`` by both (the
    batcher eager), each with the logits it picked token ``j`` from."""
    def decide(run: str, k: int, prompt: list, j: int) -> tuple:
        pos = len(prompt) + j - 1
        out = []
        for module in (generate, batching):
            with recording_picks(torch, module) as calls:
                if module is generate:
                    toks = generate.generate(
                        params, torch.tensor([prompt], device="cuda"), cfg,
                        j + 1)[0].tolist()
                else:
                    cb = batching.ContinuousBatcher(
                        params, cfg, n_slots=1, max_len=WIDE_MAX_LEN,
                        chunked_prefill=chunk, decode_graph=False,
                        pipeline_depth=0)
                    rid = cb.submit(prompt, j + 1)
                    cb.run()
                    toks = cb.done_requests[rid].out
                    del cb
            logits = next((lg[0] for p, lg in reversed(calls)
                           if p[0] == pos), None)
            if logits is None:
                fail(f"{run}: no recorded forward of {module.__name__} "
                     f"picked stream {k}'s token {j}")
            out.append((toks, logits))
            del calls
            gc.collect()
            torch.cuda.empty_cache()
        return out

    return decide


def wide_serve(torch, batching, generate, kernel_support, rpa, cfg, params,
               label: str, chunk: "int | None" = None) -> dict:
    """WIDE_REQUESTS through one-slot batchers, dense and paged (pages of
    64): the paged streams equal the dense ones; K1 launched once a layer
    per chunk and decode step, on the tensor cores. With ``chunk`` None
    each prompt is one chunk of its own length and each stream equals
    ``generate``'s bit for bit; at ``chunk`` a stream may part from
    ``generate``'s only where near_ties, against the plain f32 forward,
    finds both forwards' rounding at the two tokens over their gap and the
    batcher's RMS error over the vocabulary at most twice ``generate``'s."""
    prompts = [fleet_ids(n, SEED + 20 + i, cfg.vocab_size)
               for i, (n, _) in enumerate(WIDE_REQUESTS)]
    streams = {"dense": [], "paged": []}
    launches = {"dense": {}, "paged": {}}
    steps = {"dense": 0, "paged": 0}
    for layout in ("dense", "paged"):
        for prompt, (n, max_new) in zip(prompts, WIDE_REQUESTS):
            cb = batching.ContinuousBatcher(
                params, cfg, n_slots=1, max_len=WIDE_MAX_LEN,
                chunked_prefill=chunk or n, kv_layout=layout,
                kv_page_size=64)
            kernel_support.reset_launch_counts()
            rid = cb.submit(prompt, max_new)
            cb.run()
            torch.cuda.synchronize()
            for k, v in kernel_support.launch_counts().items():
                if k.startswith(rpa.NAME):
                    launches[layout][k] = launches[layout].get(k, 0) + v
            steps[layout] += cfg.n_layers * (cb.decode_steps
                                             + cb.prefill_chunks)
            streams[layout].append(cb.done_requests[rid].out)
            del cb
            gc.collect()
    want = [generate.generate(params, torch.tensor([p], device="cuda"), cfg,
                              m)[0].tolist()
            for p, (_, m) in zip(prompts, WIDE_REQUESTS)]
    run = f"{label}_serve" + (f"_chunk{chunk}" if chunk else "")
    row = {"phase": 9, "run": run, "requests": WIDE_REQUESTS,
           "chunk": chunk or "prompt", "head_dim": cfg.head_dim,
           "group": cfg.n_heads // cfg.n_kv_heads,
           "paged_equals_dense": streams["paged"] == streams["dense"],
           "streams_equal_generate": [g == w for g, w in
                                      zip(streams["dense"], want)],
           "first_divergence": [first_divergence(g, w) for g, w in
                                zip(streams["dense"], want)],
           "k1_launches": launches, "k1_launches_needed": steps}
    if chunk and not all(row["streams_equal_generate"]):
        truth = LazyTruth(torch, cfg, params)
        row["near_ties"] = near_ties(
            run, torch, generate, truth(), prompts, streams["dense"], want,
            wide_decider(torch, batching, generate, cfg, params, chunk))
        truth.free()
    emit(row)
    if not row["paged_equals_dense"] or (
            not chunk and not all(row["streams_equal_generate"])):
        fail(f"{run}: paged {streams['paged']} / dense "
             f"{streams['dense']} / generate {want}")
    for layout, need in steps.items():
        got = launches[layout]
        if need == 0 or got.get(rpa.NAME) != need or got.get(
                kernel_support.engine_key(rpa.NAME, "tensor_cores")) != need:
            fail(f"{run} {layout}: K1 launches {got}, want {need} "
                 "on the tensor cores")
    row["k1_launches_total"] = sum(x.get(rpa.NAME, 0)
                                   for x in launches.values())
    return row


def wide_f32_paths(torch, llama, generate, kernel_support, cfg, label: str,
                   params32) -> dict:
    """A WIDE_F32_LAYERS-layer f32 copy through the kernels (the CUDA
    cores) and through the plain path: phase 3's prefill and decode
    logits (K1) and the full forward's (K2), each within LOGITS_BOUND."""
    import numpy as np

    rng = np.random.default_rng(SEED + 21)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                          device="cuda")
    tokens: list[int] = []
    runs, counts = {}, {}
    for plain in (False, True):
        kernel_support.reset_launch_counts()
        serve, _ = _model_logits(torch, generate, params32, cfg, prompt,
                                 tokens, plain)
        full = llama.forward(params32, prompt, cfg, plain_attention=plain)
        runs[plain] = (serve, full.float())
        counts[plain] = kernel_support.launch_counts()
        del full
    (s_k, f_k), (s_p, f_p) = runs[False], runs[True]
    row = {"phase": 9, "run": f"{label}_f32_paths",
           "layers": cfg.n_layers, "bound": LOGITS_BOUND,
           "serve_kernel_vs_plain": float((s_k - s_p).abs().max()),
           "forward_kernel_vs_plain": float((f_k - f_p).abs().max()),
           "launches_kernel_path": counts[False],
           "launches_plain_path": counts[True]}
    emit(row)
    for key in ("serve_kernel_vs_plain", "forward_kernel_vs_plain"):
        if not row[key] <= LOGITS_BOUND:
            fail(f"{label} f32: {key} {row[key]:.3e} > {LOGITS_BOUND}")
    need = {"ragged_paged_attention<cuda_cores>": cfg.n_layers * 10,
            "flash_fwd<cuda_cores>": cfg.n_layers}
    if any(counts[False].get(k) != n for k, n in need.items()) or any(
            k.startswith(("ragged", "flash")) for k in counts[True]):
        fail(f"{label} f32: kernel path {counts[False]} (want {need}), "
             f"plain path {counts[True]}")
    return row


def wide_train(torch, kernel_support, train, cfg, label: str, steps: int,
               params) -> dict:
    """``steps`` steps of ``make_train_step`` with FusedAdamW and the fused
    cross-entropy at B 1, S WIDE_TRAIN_SEQ, twice from the same params:
    the losses must repeat bit for bit, every flash launch on the tensor
    cores. ``params`` is consumed (the first run trains a copy)."""
    cfg = dataclasses.replace(cfg, fused_ce=True)
    batches = [train.synthetic_batch(cfg, 1, WIDE_TRAIN_SEQ,
                                     seed=SEED + 22 + i, device="cuda")
               for i in range(steps)]
    runs = []
    for i in range(2):
        p = params if i == 1 else tree_to(params, "cuda")
        opt = train.make_optimizer(warmup_steps=1, total_steps=steps,
                                   impl="fused")
        state = train.init_train_state(cfg, opt, params=p)
        step = train.make_train_step(cfg, opt, with_accuracy=False)
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append({"losses": losses, "wall_s": time.perf_counter() - t0,
                     "launches": kernel_support.launch_counts()})
        del state, p, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    need = cfg.n_layers * steps
    launches = runs[0]["launches"]
    row = {"phase": 9, "run": f"{label}_train", "layers": cfg.n_layers,
           "batch": 1, "seq": WIDE_TRAIN_SEQ, "steps": steps,
           "losses": runs[0]["losses"], "wall_s": runs[0]["wall_s"],
           "losses_repeat_bitwise": runs[0]["losses"] == runs[1]["losses"],
           "launches": launches, "launches_needed": need}
    emit(row)
    if not row["losses_repeat_bitwise"] or not all(
            math.isfinite(x) for x in row["losses"]):
        fail(f"{label}_train: losses {runs[0]['losses']} then "
             f"{runs[1]['losses']}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if launches.get(kernel_support.engine_key(name, "tensor_cores")) \
                != need:
            fail(f"{label}_train: {name} launches {launches}, want {need} "
                 "on the tensor cores")
    if not launches.get("fused_adamw") or not launches.get("ce_chunk_fwd"):
        fail(f"{label}_train: the fused optimizer or cross-entropy did not "
             f"run: {launches}")
    return row


def wide_gradients(torch, train, cfg, params, leaves: dict) -> dict:
    """One batch's gradients of the named leaves (B 1, S WIDE_TRAIN_SEQ,
    the kernels): each leaf's grad norm, and for a tied embedding the
    largest grad of a row no input token looks up (only the head's role
    reaches it)."""
    batch = train.synthetic_batch(cfg, 1, WIDE_TRAIN_SEQ, seed=SEED + 23,
                                  device="cuda")
    grads, _ = train.grads_by(list(leaves.values()), lambda: params, batch,
                              cfg, with_accuracy=False)
    out = {name: float(g.float().norm()) for name, g in zip(leaves, grads)}
    if "embed" in leaves:
        used = torch.zeros(cfg.vocab_size, dtype=torch.bool, device="cuda")
        used[batch["inputs"].flatten()] = True
        g = grads[list(leaves).index("embed")]
        out["embed_unused_rows_grad_abs_max"] = float(g[~used].abs().max())
    return out


def twin_steps(train, cfg, params, device) -> list:
    """WIDE_TWIN_STEPS steps of ``make_train_step`` with FusedAdamW (its
    plain version on the CPU, K5 on the card) on ``device``, a fresh
    batch a step, from a copy of ``params``: the losses."""
    opt = train.make_optimizer(warmup_steps=0, total_steps=WIDE_TWIN_STEPS,
                               impl="fused")
    state = train.init_train_state(cfg, opt, params=tree_to(params, device))
    step = train.make_train_step(cfg, opt, with_accuracy=False)
    losses = []
    for i in range(WIDE_TWIN_STEPS):
        batch = train.synthetic_batch(cfg, 1, WIDE_TWIN_SEQ,
                                      seed=SEED + 24 + i, device=device)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def wide_twin_start(torch, llama, train, preset, pool):
    """The f32 twin of ``preset`` at WIDE_F32_LAYERS layers: its params
    (drawn on the card), and its CPU share (the plain versions, about a
    minute at Gemma's widths) submitted to ``pool``."""
    cfg = dataclasses.replace(preset, n_layers=WIDE_F32_LAYERS,
                              dtype=torch.float32)
    params = tree_to(wide_init(torch, llama, cfg, "cuda"), "cpu")
    t0 = time.perf_counter()

    def cpu_share():
        return twin_steps(train, cfg, params, "cpu"), time.perf_counter() - t0

    return cfg, params, pool.submit(cpu_share)


def wide_twin(torch, kernel_support, train, label: str, started) -> dict:
    """The card's share of the f32 twin (the kernels on the CUDA cores,
    K5), then the CPU's: every loss within WIDE_TWIN_RTOL."""
    cfg, params, cpu_share = started
    kernel_support.reset_launch_counts()
    card = twin_steps(train, cfg, params, "cuda")
    launches = kernel_support.launch_counts()
    t0 = time.perf_counter()
    cpu, cpu_s = cpu_share.result()
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    row = {"phase": 9, "run": f"{label}_f32_twin", "steps": WIDE_TWIN_STEPS,
           "seq": WIDE_TWIN_SEQ, "layers": cfg.n_layers,
           "cuda_losses": card, "cpu_losses": cpu,
           "cuda_launches": launches, "cpu_share_s": cpu_s,
           "waited_s": time.perf_counter() - t0,
           "loss_rel_err": rel, "rtol": WIDE_TWIN_RTOL}
    emit(row)
    need = cfg.n_layers * WIDE_TWIN_STEPS
    if not rel <= WIDE_TWIN_RTOL or any(
            launches.get(f"{n}<cuda_cores>") != need
            for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            not launches.get("fused_adamw"):
        fail(f"{label}_f32_twin: card {card} {launches} against CPU {cpu}")
    return row


def wide_init(torch, llama, cfg, device):
    """Random params of ``cfg`` from SEED on ``device``, the q/k/v biases
    drawn too (std 0.02: zeros would leave the bias path untested)."""
    params = llama.init_params(cfg, seed=SEED, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    for leaf in ("bq", "bk", "bv"):
        if leaf in params["layers"]:
            x = params["layers"][leaf]
            x.copy_(0.02 * torch.randn(x.shape, generator=gen, device=device))
    return params


def wide_round_trip(torch, convert, cfg, params) -> dict:
    """params_to_hf then params_from_hf (the card) at the full widths:
    every leaf back bit for bit; a materialized tied head (as HF's state
    dict holds one) is consumed, and no lm_head leaf comes back."""
    t0 = time.perf_counter()
    sd = convert.params_to_hf(params, cfg)
    to_s = time.perf_counter() - t0
    if cfg.tied_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    t0 = time.perf_counter()
    back = convert.params_from_hf(sd, cfg, device="cuda")
    torch.cuda.synchronize()
    from_s = time.perf_counter() - t0
    hf_tensors, hf_bytes = len(sd), sum(x.numel() * 4 for x in sd.values())
    del sd
    unequal = [k for k in params if k != "layers"
               and not torch.equal(back.get(k), params[k])]
    unequal += [f"layers.{k}" for k in params["layers"]
                if not torch.equal(back["layers"][k], params["layers"][k])]
    row = {"hf_tensors": hf_tensors, "hf_bytes": hf_bytes,
           "to_hf_s": to_s, "from_hf_s": from_s, "unequal_leaves": unequal,
           "lm_head_leaf": "lm_head" in back}
    del back
    gc.collect()
    torch.cuda.empty_cache()
    if unequal or row["lm_head_leaf"] != (not cfg.tied_embeddings):
        fail(f"HF round trip: {row}")
    return row


def phase_wide(torch, rpa, quant, fa, kernel_support, llama, generate,
               batching, train, convert) -> dict:
    """Phase 9: the hd-256 and group-7 kernel cases (phases 2 and 5's
    checks), then Gemma-2B (18 layers) and Qwen2-7B (28 layers) at their
    published widths, bf16, random weights from SEED: the HF round trip
    (Gemma), serving through the batcher against ``generate``, the f32
    paths at 2 layers, training bit for bit, the tied head's and the
    biases' gradients, Gemma's f32 twin against the CPU. Frees what it
    made."""
    t_phase = time.perf_counter()
    gc.collect()
    memory_before = torch.cuda.memory_allocated()
    gemma = llama.LlamaConfig.gemma_2b()
    # Gemma's weights, and their HF round trip
    gemma_params = wide_init(torch, llama, gemma, "cuda")
    round_trip = wide_round_trip(torch, convert, gemma, gemma_params)
    cases = phase_kernels(torch, rpa, quant, kernel_support,
                          cases=wide_kernel_cases(), phase=9)
    flash = phase_flash(torch, fa, kernel_support, cases=wide_flash_cases(),
                        phase=9)
    # every timed case is done: the twin's CPU share runs beside the
    # models' checks, which time nothing
    pool = ThreadPoolExecutor(1)
    twin = wide_twin_start(torch, llama, train, gemma, pool)
    out = {"cases": cases, "flash": flash, "models": {}}
    for label, preset, train_layers, steps in (
            ("gemma_2b", gemma, None, GEMMA_TRAIN_STEPS),
            ("qwen2_7b", llama.LlamaConfig.qwen2_7b(), QWEN_TRAIN_LAYERS,
             QWEN_TRAIN_STEPS)):
        t0 = time.perf_counter()
        if preset is gemma:
            params, gemma_params = gemma_params, None
        else:
            params = wide_init(torch, llama, preset, "cuda")
        n_params = sum(x.numel() for x in train.param_leaves(params))
        row = {"phase": 9, "run": label, "layers": preset.n_layers,
               "params": n_params,
               "param_bytes": sum(x.numel() * x.element_size()
                                  for x in train.param_leaves(params)),
               "head_dim": preset.head_dim,
               "group": preset.n_heads // preset.n_kv_heads}
        if preset is gemma:
            row["hf_round_trip"] = round_trip
        serve = wide_serve(torch, batching, generate, kernel_support, rpa,
                           preset, params, label)
        padded = wide_serve(torch, batching, generate, kernel_support, rpa,
                            preset, params, label, chunk=WIDE_CHUNK)
        small = dataclasses.replace(preset, n_layers=WIDE_F32_LAYERS)
        cfg32 = dataclasses.replace(small, dtype=torch.float32)
        params32 = widened(torch, {**params, "layers": {
            k: v[:WIDE_F32_LAYERS] for k, v in params["layers"].items()}})
        paths = wide_f32_paths(torch, llama, generate, kernel_support, cfg32,
                               label, params32)
        del params32
        if train_layers is not None:  # train a cut of the full width
            params = {**params, "layers": {
                k: v[:train_layers].clone()
                for k, v in params["layers"].items()}}
            gc.collect()
            torch.cuda.empty_cache()
        tcfg = preset if train_layers is None else \
            dataclasses.replace(preset, n_layers=train_layers)
        grads = wide_gradients(
            torch, train, tcfg, params,
            {"embed": params["embed"]} if preset.tied_embeddings else
            {f"layers.{b}": params["layers"][b] for b in ("bq", "bk", "bv")})
        trained = wide_train(torch, kernel_support, train, tcfg, label, steps,
                             params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        row.update(gradients=grads, wall_s=time.perf_counter() - t0)
        if preset.tied_embeddings:
            if not (row["gradients"]["embed"] > 0 and
                    row["gradients"]["embed_unused_rows_grad_abs_max"] > 0):
                fail(f"{label}: the tied head's gradient does not reach the "
                     f"embedding leaf: {row['gradients']}")
        elif not all(v > 0 for v in grads.values()):
            fail(f"{label}: a bias gradient is zero: {grads}")
        emit(row)
        out["models"][label] = {**row, "serve": serve,
                                "serve_chunk": padded, "f32_paths": paths,
                                "train": trained}
    out["models"]["gemma_2b"]["f32_twin"] = wide_twin(
        torch, kernel_support, train, "gemma_2b", twin)
    pool.shutdown()
    del twin
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    memory = {"memory_allocated_before": memory_before,
              "memory_allocated_after": torch.cuda.memory_allocated()}
    emit({"phase": 9, "run": "wide", "wall_s": out["wall_s"], **memory})
    return {**out, **memory}


def kernel_entry(name, source, replaces, launches, errs, head, extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs.values()), **errs, **head, **extra}


def fused_entries(kernel_support, fo, fce, quant, checks: dict,
                  runs: dict) -> list:
    """The kernels line's entries of the fused training ops: K5, K6, K7
    (hand-written, ``csrc/``) and the int8 product (``torch._int_mm``
    behind ``ops/quant.py``). None replaces a TPU kernel; each names the
    reference module it is the counterpart of. Launches: phase 6's
    train_fused (K5-K7) and train_int8 (the int8 product)."""
    k5, ce, i8 = checks["fused_adamw"], checks["fused_ce"], \
        checks["int8_matmul"]
    fused, int8 = runs["train_fused"]["launches"], runs["train_int8"]["launches"]
    csrc = "k8s_gpu_device_plugin_torch/ops/csrc/"
    bf = k5["bfloat16"]
    entries = [kernel_entry(
        fo.NAME, csrc + "fused_adamw.cu", None,
        fused.get(fo.NAME, 0) + fused.get(fo.NORM_NAME, 0),
        {"max_abs_err": max(off["max_abs_err"] for r in k5.values()
                            for off in r["off"].values())},
        {k: bf[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")},
        {"counterpart_of": "k8s_gpu_device_plugin_tpu/ops/fused_optim.py",
         "launches_update": fused.get(fo.NAME, 0),
         "launches_norm": fused.get(fo.NORM_NAME, 0),
         "headline_case": f"{bf['leaves']} leaves of Llama-3-8B at "
                          f"{FUSED_LAYERS} layers, {bf['elements']} bf16 "
                          "parameters, one update (norm pass included)",
         "library_call": "torch._fused_adamw_ over the same leaves (no clip)",
         "eager_adamw_ms": bf["eager_adamw_ms"],
         "off_plain_fed_the_kernel_scale": {d: r["off"] for d, r in k5.items()},
         "norm_rel_err": {d: max(r["norm_rel_err"]) for d, r in k5.items()},
         "update_ms_train_fused": runs["train_fused"]["steady_update_ms"],
         "update_ms_eager_unfused_run":
             runs["train_fused"]["unfused_steady_update_ms"]})]
    for name, key, plain in ((fce.FWD_NAME, "fwd", "fwd_plain"),
                             (fce.BWD_NAME, "bwd", "bwd_plain")):
        errs = {"max_abs_err": ce["lse_max_abs_err"] if key == "fwd"
                else ce["dlogits_off"]["max_abs_err"]}
        entries.append(kernel_entry(
            name, csrc + "fused_ce.cu", None, fused.get(name, 0), errs,
            {"ms": ce["full"][f"{key}_ms"],
             "plain_ms": ce["full"][f"{plain}_ms"],
             "bound_ms": ce["full"][f"{key}_bound_ms"], "bound_by": "bytes",
             "library_ms": None},
            {"counterpart_of": "k8s_gpu_device_plugin_tpu/ops/fused_ce.py",
             "headline_case": f"one chunk, N {ce['rows']} x {CE_CHUNK} f32 "
                              "logits",
             "ragged_case": {k: ce["ragged"][k] for k in (
                 "width", f"{key}_ms", f"{plain}_ms", f"{key}_bound_ms")},
             "dlogits_off_plain": ce["dlogits_off"],
             "yardstick_loss_fwd_bwd_ms": {
                 "fused": ce["fused_loss_fwd_bwd_ms"],
                 "unfused_head_and_cross_entropy":
                     ce["unfused_loss_fwd_bwd_ms"]},
             "loss_extra_gib": {"fused": ce["fused_loss_extra_gib"],
                                "unfused": ce["unfused_loss_extra_gib"]}}))
    entries.append(kernel_entry(
        quant.INT8_NAME, "k8s_gpu_device_plugin_torch/ops/quant.py", None,
        int8.get(quant.INT8_NAME, 0), {"max_abs_err": i8["max_abs_err"]},
        {k: i8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")},
        {"counterpart_of": "k8s_gpu_device_plugin_tpu/ops/quant.py:61",
         "product": "torch._int_mm (cuBLASLt int8 GEMM), no hand-written "
                    "kernel yet",
         "headline_case": f"M {i8['shape']['m']} K {i8['shape']['k']} "
                          f"N {i8['shape']['n']}, quantize + int32 product "
                          "+ rescale",
         "int_mm_ms": i8["int_mm_ms"], "int32_exact": i8["int32_exact"],
         "library_call": "torch.mm of the bf16 operands",
         "rel_err_vs_bf16_operands": i8["rel_err_vs_bf16_operands"]}))
    for e in entries:
        e["route"] = "cuda"
    return entries


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a card")
    sys.path.insert(0, ROOT)
    try:
        from k8s_gpu_device_plugin_torch.device import native as native_device
        from k8s_gpu_device_plugin_torch.models import batching
        from k8s_gpu_device_plugin_torch.models import checkpoint as ckpt_mod
        from k8s_gpu_device_plugin_torch.models import convert
        from k8s_gpu_device_plugin_torch.models import generate
        from k8s_gpu_device_plugin_torch.models import llama
        from k8s_gpu_device_plugin_torch.models import lora
        from k8s_gpu_device_plugin_torch.models import lora_serving as ls
        from k8s_gpu_device_plugin_torch.models import moe as moe_mod
        from k8s_gpu_device_plugin_torch.models import quantized_serving
        from k8s_gpu_device_plugin_torch.models import sampling
        from k8s_gpu_device_plugin_torch.models import spec_batching as spec_mod
        from k8s_gpu_device_plugin_torch.models import speculative
        from k8s_gpu_device_plugin_torch.models import train
        from k8s_gpu_device_plugin_torch.models import trainer as trainer_mod
        from k8s_gpu_device_plugin_torch.ops import attention as attention_mod
        from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
        from k8s_gpu_device_plugin_torch.ops import fused_ce as fce
        from k8s_gpu_device_plugin_torch.ops import fused_optim as fo
        from k8s_gpu_device_plugin_torch.ops import kernel_support
        from k8s_gpu_device_plugin_torch.ops import quant
        from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
        from k8s_gpu_device_plugin_torch.serving import prefix_cache as \
            prefix_cache_mod
        from k8s_gpu_device_plugin_torch.serving import embeddings
        from k8s_gpu_device_plugin_torch.serving import scheduler as sched_mod
        from k8s_gpu_device_plugin_torch.serving import scoring
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
    # the tp phase's bit-for-bit half: a child drawing its weights while
    # the kernels build, joined before the first timed case
    tp_child = start_tp_exact()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, together
        builds = {"ragged_paged_attention": pool.submit(rpa.load_kernel),
                  "flash_attention": pool.submit(fa.load_kernel),
                  "fused_adamw": pool.submit(fo.load_kernel),
                  "fused_ce": pool.submit(fce.load_kernel),
                  # the device model's C++ enumerator (g++)
                  "gpuenum": pool.submit(native_device.load_library)}
        libs = {name: b.result() for name, b in builds.items()}
    del libs["gpuenum"]
    emit({"phase": 1, "build_s": time.perf_counter() - t0})
    phase_sass(kernel_support, libs)
    tp_exact = join_tp_exact(tp_child)
    # the device model on the quiet card, before phase 2
    phase_device(torch, rpa, kernel_support)

    cases = phase_kernels(torch, rpa, quant, kernel_support)
    flash = phase_flash(torch, fa, kernel_support)
    fused_kernels = phase_fused_kernels(torch, llama, train, quant, fo, fce,
                                        kernel_support)
    cfg = llama.LlamaConfig.llama3_8b()
    # one set of random 8B weights for the model check and the servers
    params = server_mod.load_params(cfg, seed=SEED, device="cuda")
    model = phase_model(torch, generate, cfg, params)
    graphs = {run: phase_graph(torch, batching, sampling, cfg, params, run,
                               SERVING_RUNS[run])
              for run in ("dense", "int8_paged")}
    # the synchronous loop first: its tokens are the ones every
    # unquantized run must give, and the first server of the process pays
    # the engine thread's one-time costs, so that the pipelined chunked
    # and bucketed runs compare their TTFT warm
    serving = {"dense_depth0": phase_serving(
        torch, server_mod, kernel_support, rpa, cfg, params, "dense_depth0")}
    for run in ("dense", "dense_bucketed", "paged", "int8_paged",
                "int8_dense", "int4_dense", "int4_paged"):
        serving[run] = phase_serving(
            torch, server_mod, kernel_support, rpa, cfg, params, run,
            dense_tokens=serving["dense_depth0"]["tokens"]
            if run in ("paged", "dense") else None)
        gc.collect()  # the stopped server's cache and graph pool
        torch.cuda.empty_cache()
    # bucketed prefill rounds its bf16 prompt rows in other places than
    # 256-row chunks do: its greedy streams are compared, not required
    emit({"phase": 4, "run": "dense_bucketed",
          "streams_equal_to_chunked": [
              i for i in range(len(REQUESTS)) if i not in BUCKET_REFUSED
              and serving["dense_bucketed"]["tokens"][i]
              == serving["dense"]["tokens"][i]],
          "ttft_s_p50": {"chunked_256": serving["dense"]["ttft_s_p50"],
                         "bucketed": serving["dense_bucketed"]["ttft_s_p50"]}})
    # the prefix cache: one shared system prompt through the server, then
    # the copy-on-write of a tail page at batcher level
    prefix = phase_prefix(torch, server_mod, kernel_support, rpa, batching,
                          cfg, params)
    cow = phase_cow(torch, batching, prefix_cache_mod, cfg, params)
    # tensor-parallel serving on the same weights: tp 1, 2 and 4 over one
    # card (the mesh names it once a shard), the column products probed
    tp_runs = phase_tp(torch, batching, sampling, spec_mod, prefix_cache_mod,
                       quantized_serving, kernel_support, rpa, cfg, params,
                       tp_exact)
    # speculative decoding: the server with a self-draft (spec_self,
    # spec_prefix, spec_sampled), then the round at batcher level
    # (its time, spec_trunc, speculative_generate); all of it freed
    # before the weight-quantized phases
    spec = phase_spec_serving(torch, server_mod, kernel_support, rpa,
                              spec_mod, batching, generate, cfg, params,
                              serving["dense"])
    spec.update(phase_spec_batcher(torch, batching, spec_mod, speculative,
                                   generate, cfg, params))
    gc.collect()
    torch.cuda.empty_cache()
    # scheduling and failure: preemption at batcher level, the supervisor
    # and the fault plane through the server, latency under arrivals
    t_sched = [time.perf_counter()]
    preempt = phase_preempt(torch, batching, sampling, sched_mod,
                            prefix_cache_mod, kernel_support, rpa, generate,
                            cfg, params)
    t_sched.append(time.perf_counter())
    supervised = phase_supervisor(torch, server_mod, batching, generate, cfg,
                                  params)
    t_sched.append(time.perf_counter())
    arrivals = phase_arrivals(torch, server_mod, cfg, params, {
        run: supervised[run]["recovery_s"]
        for run in ("sup_crash_dense", "sup_crash_paged")})
    t_sched.append(time.perf_counter())
    emit({"phase": 4, "run": "sched_phases_wall_s", **{
        name: b - a for name, a, b in zip(
            ("preempt", "supervisor", "arrivals"), t_sched, t_sched[1:])}})
    # observability: attribution off / on / traced on the main path
    obs = phase_obs(torch, server_mod, batching, kernel_support, rpa, cfg,
                    params)
    # the serving surface: text, n choices, the OpenAI façade, echo
    # scoring and embeddings (K2 at B 1, K1's chunk at T 512)
    surface = phase_surface(torch, server_mod, kernel_support, rpa, scoring,
                            embeddings, cfg, params)
    # multi-LoRA on the same weights: stacked and gathered adapters on
    # the batcher, residency and uploads, both APIs' adapter surface
    lora_runs = phase_lora(torch, server_mod, batching, generate, lora, ls,
                           quantized_serving, prefix_cache_mod,
                           kernel_support, rpa, cfg, params)
    # KV page export and install: a stream continued on another server
    # from its shipped pages, then int8 and int4 pools at batcher level
    kv = phase_kv(torch, server_mod, batching, kernel_support, rpa, cfg,
                  params)
    # the fleet tier: two servers behind the port's replica router
    # (affinity, drain, the disaggregated relay over KV pages, a killed
    # replica's streams resumed)
    fleet_runs = phase_fleet(torch, server_mod, batching, kernel_support,
                             rpa, cfg, params)
    # the batch-1 decode modes on the same weights: beam search
    beam = phase_beam(torch, generate, llama, kernel_support, rpa, cfg,
                      params)
    # each weight width quantized once on the card, checked (phase 3) and
    # served (phase 4), and freed before the next
    for weight_quant, run in (("int8", "w8"), ("int4", "w4_int4_paged")):
        qparams = quantized_serving.quantize_weights(params, weight_quant)
        phase_weights(torch, generate, cfg, qparams, weight_quant, model)
        if run == "w4_int4_paged":
            graphs[run] = phase_graph(torch, batching, sampling, cfg, qparams,
                                      run, SERVING_RUNS[run])
        serving[run] = phase_serving(torch, server_mod, kernel_support, rpa,
                                     cfg, qparams, run,
                                     requests=REQUESTS_HALF)
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    # the Llama-3-8B weights are gone: Mixtral-8x7B's (two layers at its
    # width, then all 32 at int8), then Mistral-7B's, windowed
    moe = phase_moe(torch, server_mod, batching, sampling, generate, llama,
                    quantized_serving, moe_mod, kernel_support, rpa)
    window = phase_window(torch, server_mod, kernel_support, rpa, batching,
                          llama, generate)
    training = phase_training(torch, kernel_support, attention_mod, llama,
                              train, trainer_mod)
    # the fused training ops on the same path: --optImpl fused --fusedCE,
    # then --quant int8
    fused_runs = phase_fused_training(torch, kernel_support, llama,
                                      trainer_mod, fo, fce, quant, training)
    # checkpoints: exact resume, serving what was trained, LoRA training
    # and serving the trained adapter (2 layers at the 8B widths)
    ckpt = phase_checkpoints(torch, kernel_support, attention_mod, llama,
                             train, trainer_mod, lora, ckpt_mod, server_mod,
                             generate, batching, rpa)
    # the default --preset tiny (head dim 16) from the command line: the
    # trainer with a corpus, traces and a checkpoint, then the server on
    # it; and the f32 twin, card against CPU
    tiny = phase_tiny(torch, llama, generate, server_mod, kernel_support,
                      trainer_mod)
    tiny_k1 = tiny["serve"]["k1_launches"].get(rpa.NAME, 0)
    # Gemma-2B (head dim 256) and Qwen2-7B (a group of 7) at their
    # published widths: the kernel cases, the HF round trip, serving,
    # training
    wide = phase_wide(torch, rpa, quant, fa, kernel_support, llama, generate,
                      batching, train, convert)
    wide_k1 = sum(m[run]["k1_launches_total"]
                  for m in wide["models"].values()
                  for run in ("serve", "serve_chunk"))

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    head = next(c for c in cases
                if c["case"] == "decode" and c["dtype"] == "bfloat16")
    err_bf16 = max(c["max_abs_err"] for c in cases + wide["cases"]
                   if c["dtype"] == "bfloat16")
    err_f32 = max(c["max_abs_err"] for c in cases + wide["cases"]
                  if c["dtype"] == "float32")
    routes = {}
    for route in rpa.ROUTES:  # each route's bf16 decode case heads its entry
        mine = [c for c in cases if c["route"] == route]
        first = next(c for c in mine if c["t"] == 1 and c["window"] == 0
                     and c["dtype"] == "bfloat16" and c["hd"] == 128)
        chunk = next(c for c in mine
                     if chunk_headline(c) and c["dtype"] == "bfloat16")
        routes[route] = {
            "launches": serving[route]["launches"],
            "launches_per_engine": serving[route]["launches_per_engine"],
            # bf16 queries on the tensor cores (decode split over each
            # span), f32 queries on the CUDA cores at every T
            "engine": {"decode": first["engine"], "chunk": chunk["engine"],
                       "float32": "cuda_cores"},
            "decode_cuda_cores_ms": first["cuda_cores_ms"],
            "split_tiles": first["split_tiles"],
            "splits_per_slot": first["splits_per_slot"],
            "blocks_per_sm": first["blocks_per_sm"],
            "chunk_case": chunk["case"],
            **{f"chunk_{k}": chunk[k] for k in keys},
            "chunk_cuda_cores_ms": chunk["cuda_cores_ms"],
            "max_err_bf16": max(c["max_abs_err"] for c in mine
                                if c["dtype"] == "bfloat16"),
            "max_err_bf16_vs_p_bf16": max(
                c["max_abs_err_vs_p_bf16"] for c in mine
                if c["engine"] == "tensor_cores"),
            "max_err_f32": max(c["max_abs_err"] for c in mine
                               if c["dtype"] == "float32"),
            "headline_case": first["case"], **{k: first[k] for k in keys},
            "decode_step_ms_mean": serving[route]["decode_step_ms_mean"],
            "reserved_bytes": serving[route]["kv"]["reserved_bytes"],
            # whole bucketed prompts (--chunkedPrefill 0) at base 0
            "bucket_cases": {
                c["t"]: {k: c[k] for k in keys} for c in mine
                if c["dtype"] == "bfloat16" and c["bases"] == [0]
                and c["t"] in (512, 1024)},
        }
    spec_runs = (*SPEC_RUNS, *SPEC_PREFIX_RUNS, "spec_sampled")
    kernels = [kernel_entry(
        "ragged_paged_attention",
        "k8s_gpu_device_plugin_torch/ops/csrc/ragged_paged_attention.cu",
        "k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py:142",
        sum(r["launches"] for r in routes.values())
        + sum(prefix[run]["launches"] for run in PREFIX_RUNS)
        + sum(window[run]["launches"] for run in WINDOW_RUNS)
        + sum(spec[run]["launches"] for run in spec_runs)
        + preempt["launches"] + surface["launches"][rpa.NAME]
        + obs["summary"]["launches"] + lora_runs["k1_launches"]["total"]
        + moe["k1_launches"] + kv["summary"]["k1_launches"]
        + sum(fleet_runs["k1_launches"].values())
        + sum(beam[d]["k1_launches"] for d in ("bf16", "f32"))
        + sum(window["rolling"][d][f"k1_launches_{run}"]
              for d in ("bf16", "f32") for run in ("rolling", "unbounded"))
        + ckpt["k1_launches"] + tiny_k1 + wide_k1
        + tp_runs["summary"]["k1_launches"],
        {"max_err_bf16": err_bf16, "max_err_f32": err_f32},
        {k: head[k] for k in keys},
        {"headline_case": "decode bfloat16, B=8 S=2048 Hq=32 Hkv=8 hd=128, "
                          "dense route",
         "routes": routes,
         # the prefix runs' and the windowed runs' launches (Mistral-7B,
         # W 4096), and phase 2's W 4096 decode cases with the
         # stale-entry check
         "prefix_launches": {run: prefix[run]["launches"]
                             for run in PREFIX_RUNS},
         "window": {
             **{run: {k: window[run][k] for k in
                      ("launches", "launches_per_engine",
                       "decode_step_ms_both_decoding_p50")}
                for run in WINDOW_RUNS},
             "cases": {c["case"]: {**{k: c[k] for k in keys},
                                   "stale_entries": c.get("stale_entries")}
                       for c in cases if c["window"] == MISTRAL_WINDOW}},
         "cow_check": cow,
         # tensor-parallel serving: each shard's K1 on its own heads (tp x
         # 32 launches a decode step), and phase 2's per-shard cases
         "tp": {
             "launches": tp_runs["summary"]["k1_launches"],
             "launches_at_tp_gt_1": tp_runs["summary"]["k1_launches_tp"],
             "launches_per_decode_step": tp_runs["summary"][
                 "k1_launches_per_decode_step"],
             "decode_step_device_ms": tp_runs["summary"][
                 "decode_step_device_ms"],
             "streams_equal_to_tp1": tp_runs["summary"][
                 "streams_equal_to_tp1"],
             "cases": {f"{c['case']} {c['dtype']}": {
                 **{k: c[k] for k in keys}, "plan": c["plan"],
                 "max_abs_err": c["max_abs_err"]}
                 for c in cases if "_shard_" in c["case"]}},
         # preemption: the re-prefill counted as chunk launches, and the
         # windowed page-relief victim
         "preempt": {k: preempt[k] for k in
                     ("runs", "reprefill_chunks", "victim_divergences",
                      "f32_logprob_max_err")},
         "window_relief": window["window_relief"],
         "arrivals": arrivals["summary"],
         # the served runs of phase_obs (attribution off / on / traced,
         # dense and paged, depth 1 and 0)
         # the multi-LoRA runs: every prefill chunk and decode step of
         # batches that mix adapters (bf16 on the tensor cores; the f32
         # twin's on the CUDA cores)
         "lora": {"launches": lora_runs["k1_launches"],
                  "lora_mix_launches": lora_runs["mix"]["k1"]},
         # Mixtral-8x7B, 32 layers, int8 experts: its served runs at
         # pipeline depth 1 and 0 (dense route, tensor cores)
         # KV page transfer: the hops' installs (split decode, no prefill
         # chunk) and re-prefill resumes, and the int8 / int4 installs
         "kv_transfer": {
             "launches": kv["summary"]["k1_launches"],
             "install_chunks": kv["summary"]["install_chunks"],
             "reprefill_chunks": kv["summary"]["reprefill_chunks"]},
         # the fleet runs behind the replica router, all on the paged
         # route: every chunk and split decode step of either replica
         "fleet": {"route": fleet_runs["k1_route"],
                   "launches": sum(fleet_runs["k1_launches"].values()),
                   "by_run": fleet_runs["k1_launches"]},
         # the batch-1 decode modes: beam search's prefill and split
         # decode steps at B = beam (8B bf16 and its 2-layer f32 copy),
         # rolling decode's one windowed prefill chunk past the window and
         # its unbounded twin's prefill and decode steps (Mistral-7B bf16
         # and its 2-layer f32 copy), with phase 2's cases at those shapes
         "beam": {"launches": {d: beam[d]["k1_launches"]
                               for d in ("bf16", "f32")},
                  "split_launches": {d: beam[d]["k1_split_launches"]
                                     for d in ("bf16", "f32")},
                  "max_score_gap": {d: beam[d]["max_score_gap"]
                                    for d in ("bf16", "f32")},
                  "cases": {c["case"]: {**{k: c[k] for k in keys},
                                        "max_abs_err": c["max_abs_err"]}
                            for c in cases
                            if c["case"] == f"decode_beam{BEAM_WIDTH}"}},
         "rolling": {
             "launches": {d: {run: window["rolling"][d][f"k1_launches_{run}"]
                              for run in ("rolling", "unbounded")}
                          for d in ("bf16", "f32")},
             "cases": {c["case"]: {**{k: c[k] for k in keys},
                                   "max_abs_err": c["max_abs_err"]}
                       for c in cases if c["case"] ==
                       f"prefill_t{ROLLING_PROMPT}_w{MISTRAL_WINDOW}"}},
         # phase 7: a --checkpointDir server's chunk and decode steps,
         # the --loraAdapters server's and its batcher-level oracles'
         "checkpoints": {"launches": ckpt["k1_launches"],
                         "ckpt_serve": ckpt["ckpt_serve"]["k1_launches"],
                         "lora_ckpt_serve": ckpt["lora_ckpt_serve"][
                             "k1_launches_served"],
                         "cases": {c["case"]: {**{k: c[k] for k in keys},
                                               "max_abs_err": c["max_abs_err"]}
                                   for c in cases if c["case"] in (
                                       f"prefill_t{CKPT_PROMPT}_base0",
                                       "decode_b1_ckpt")}},
         # phase 8: the tiny server's chunks and decode steps at hd 16
         # (the 64-column instantiation, zero-padded), and phase 2's hd 16
         # and 32 cases
         "narrow_head_dims": {
             "tiny_serve_launches": tiny["serve"]["k1_launches"],
             "cases": {f"{c['case']} {c['dtype']}": {
                 **{k: c[k] for k in keys}, "max_abs_err": c["max_abs_err"]}
                 for c in cases if c["hd"] in NARROW_HDS}},
         # phase 9: Gemma-2B's (hd 256) and Qwen2-7B's (a group of 7)
         # one-slot batchers, dense and paged, a chunk a prompt and at
         # WIDE_CHUNK, and the phase's cases
         "wide_head_dims": {
             "serve_launches": {label: {run: m[run]["k1_launches"] for run in
                                        ("serve", "serve_chunk")}
                                for label, m in wide["models"].items()},
             "cases": {f"{c['case']} {c['dtype']}": {
                 **{k: c[k] for k in keys}, "max_abs_err": c["max_abs_err"],
                 "plan": c["plan"]} for c in wide["cases"]}},
         "moe": {"launches": moe["summary"]["k1_launches"],
                 "decode_step_ms_mean": moe["summary"]["decode_step_ms_mean"],
                 "decode_graph_pool_bytes":
                     moe["summary"]["decode_graph_pool_bytes"]},
         "obs": {"launches": obs["summary"]["launches"],
                 "decode_step_ms_mean": obs["summary"][
                     "decode_step_ms_mean"]},
         # long-prompt scoring: chunks of 512 over a 4096-row batch-1
         # cache (phase 2's case and the surface run's launches)
         "surface": {
             "launches": surface["launches"][rpa.NAME],
             "long_echo_launches": surface[f"echo_{SURFACE_LONG}_launches"][
                 rpa.NAME],
             "cases": {f"{c['case']} {c['dtype']}": {
                 **{k: c[k] for k in keys}, "engine": c["engine"],
                 "max_abs_err": c["max_abs_err"]}
                 for c in cases if c["case"] == "score_t512_base3584"}},
         # the speculative runs' verify windows (T 4, the chunk engine)
         # and draft decodes (split), and phase 2's verify cases
         "verify": {
             "launches": {run: {k: spec[run][k] for k in
                                ("launches", "verify_launches",
                                 "verify_launches_split", "split_launches")}
                          for run in spec_runs},
             "cases": {f"{c['case']} {c['dtype']}": {
                 **{k: c[k] for k in keys}, "plan": c["plan"],
                 "max_abs_err": c["max_abs_err"]}
                 for c in cases if c["verify"]}},
         "spec": {"round_time": spec["round_time"],
                  "acceptance_rate": {run: spec[run]["spec"]["acceptance_rate"]
                                      for run in spec_runs},
                  "spec_trunc_counts_histogram": {
                      layout: r["counts_histogram"]
                      for layout, r in spec["spec_trunc"].items()},
                  "speculative_generate_rounds":
                      spec["speculative_generate"]["rounds"]},
         # the decode step replayed as a CUDA graph, held to the eager step
         "decode_graph": {run: {k: g[k] for k in
                                ("equal_bitwise", "steps_checked",
                                 "pool_bytes")}
                          for run, g in graphs.items()},
         "decode_graph_pool_bytes_serving": {
             run: r["decode_graph"]["pool_bytes"]
             for run, r in serving.items()},
         "cases": [{k: c[k] for k in ("case", "route", "page_size", "dtype",
                                      "engine", "max_abs_err", *keys)}
                   for c in cases]})]
    fhead = next(c for c in flash
                 if c["case"] == "causal" and c["dtype"] == "bfloat16")
    outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dkv": ("dk", "dv"),
               "flash_bwd_dq": ("dq",)}
    replaces = {"flash_fwd": 164, "flash_bwd_dkv": 412, "flash_bwd_dq": 465}
    for name, outs in outputs.items():
        errs = {f"max_err_{dn}": max(c["max_abs_err"][o]
                                     for c in flash + wide["flash"]
                                     for o in outs if c["dtype"] == dn)
                for dn in ("bfloat16", "float32")}
        beam_k2 = sum(beam[d]["k2_launches"] for d in ("bf16", "f32"))
        served = (surface["launches"]["flash_fwd"] + moe["k2_launches"]
                  + fleet_runs["k2_launches"] + beam_k2) \
            if name == "flash_fwd" else 0
        fused_flash = sum(r["launches"].get(name, 0)
                          for r in fused_runs.values())
        tiny_flash = {"tiny_train": tiny["train"]["launches"].get(name, 0),
                      "tiny_f32_twin": tiny["twin"]["cuda_launches"].get(
                          name, 0)}
        wide_flash = {label: m["train"]["launches"].get(name, 0)
                      for label, m in wide["models"].items()}
        kernels.append(kernel_entry(
            name, "k8s_gpu_device_plugin_torch/ops/csrc/flash_attention.cu",
            f"k8s_gpu_device_plugin_tpu/ops/flash_attention.py:{replaces[name]}",
            training["launches"].get(name, 0) + served + fused_flash
            + ckpt["flash_launches"][name] + sum(tiny_flash.values())
            + sum(wide_flash.values()), errs,
            {"ms": fhead["ms"][name], "plain_ms": fhead["plain_ms"][name],
             "bound_ms": fhead["bounds"][name]["bound_ms"],
             "bound_by": fhead["bounds"][name]["bound_by"],
             # SDPA's forward for K2; its backward (dq, dk, dv in one
             # call) for K3 and K4
             "library_ms": fhead["library_fwd_ms"] if name == "flash_fwd"
             else fhead["library_bwd_ms"]},
            {"headline_case": f"causal bfloat16, B={TRAIN_BATCH} "
                              f"S={TRAIN_SEQ} Hq=32 Hkv=8 hd=128",
             "engine": {"bfloat16": "tensor_cores", "float32": "cuda_cores"},
             # the trainer's launches, the serving surface's (K2 at B 1:
             # every short scored prompt and embedding) and the MoE
             # forward check's (Mixtral's width, f32, CUDA cores)
             "launches_training": training["launches"].get(name, 0),
             # phase 6's train_fused and train_int8 runs
             "launches_fused_training": fused_flash,
             # phase 7: the resumed and straight trainer runs' and LoRA
             # training's (2 layers, bf16, the tensor cores)
             "launches_checkpoint_runs": ckpt["flash_launches"][name]
             - ckpt["lora_flash_launches"][name],
             "launches_lora_train": ckpt["lora_flash_launches"][name],
             # phase 8: the tiny trainer's CLI run (hd 16, the tensor
             # cores) and its f32 twin on the card (the CUDA cores)
             "launches_tiny": tiny_flash,
             # phase 9: Gemma-2B's 18 layers (hd 256) and Qwen2-7B's
             # 2-layer cut (a group of 7) trained with FusedAdamW and the
             # fused cross-entropy, and the phase's cases
             "launches_wide": wide_flash,
             "wide_cases": [{"case": c["case"], "dtype": c["dtype"],
                             "ms": c["ms"][name],
                             "plain_ms": c["plain_ms"][name],
                             "library_ms": c["library_fwd_ms"]
                             if name == "flash_fwd" else c["library_bwd_ms"],
                             "max_abs_err": {o: c["max_abs_err"][o]
                                             for o in outs},
                             **c["bounds"][name]} for c in wide["flash"]],
             "launches_surface": surface["launches"]["flash_fwd"]
             if name == "flash_fwd" else 0,
             # the embedding through the replica router and direct
             "launches_fleet": fleet_runs["k2_launches"]
             if name == "flash_fwd" else 0,
             "launches_moe_forward": moe["k2_launches"]
             if name == "flash_fwd" else 0,
             # beam search's check: the full-context forward of its rows
             # (8B bf16 on the tensor cores, the f32 copy's on the CUDA
             # cores)
             "launches_beam": beam_k2 if name == "flash_fwd" else 0,
             "launches_per_engine": {
                 e: training["launches"].get(kernel_support.engine_key(name, e), 0)
                 for e in kernel_support.ENGINES},
             "max_err_bf16_vs_f32_plain": max(
                 c["max_abs_err"][f"{o}_vs_f32"] for c in flash for o in outs
                 if c["dtype"] == "bfloat16" and o != "lse"),
             "cases": [{"case": c["case"], "dtype": c["dtype"],
                        "ms": c["ms"][name], "plain_ms": c["plain_ms"][name],
                        "library_ms": c["library_fwd_ms"]
                        if name == "flash_fwd" else c["library_bwd_ms"],
                        **c["bounds"][name]} for c in flash]}))
    kernels.extend(fused_entries(kernel_support, fo, fce, quant,
                                 fused_kernels, fused_runs))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:] == ["--tp-exact"]:
        tp_exact_child()
    else:
        main()
