#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Drives the port's serving path on the card and checks it, in phases:

  1. the card's name and power limit (exits non-zero without CUDA);
  2. builds the hand-written CUDA kernels from `src/repro_torch/csrc`,
     printing ptxas's registers and spills; flash_attention_bwd's kernels
     by name, with each bf16 pass's dynamic shared memory and its wgmma
     instructions (HGMMA in `cuobjdump -sass`), failing on a spill or a
     bf16 pass without wgmma, and on an old CUDA-core pass built for
     another type than float32;
  3. holds each kernel against its plain PyTorch version on the card at
     the serving path's shapes (float32 and bfloat16, ragged lengths, a
     GQA case beside gemma's MQA, flash attention at head dims 16, 32 and
     112 that its wrapper pads) and times kernel, plain version, one
     PyTorch library call and the roofline bound; flash attention checked
     and timed at every prefill bucket phase 4 hits, in the prefill's own
     strided layout too; decode attention also at lengths 0 and past T,
     behind NaN/inf unfilled rows, at head dims 16, 32, 100 and 112, two
     calls bit-identical, right after a call with other lengths, and its
     per-phase timeline; rmsnorm and add_rmsnorm (the residual add fused
     into the norm) in f32 and bf16 at D = 64 to 8192 and one D that is
     not a multiple of 8, rows 1, 4 and 1023, [1, 1023, D] and views at
     an odd element offset, the fused entry bit for bit against
     rmsnorm(x + r) and x + r, the card's launch plan against the Python
     twin, both entries timed at a decode step's and a prefill's rows,
     the wrapper's host time split into its parts, and the kernel's time
     against the rows a block takes;
  4. full-width gemma-2b (random bf16 weights from a seed, full depth)
     serves 6 requests through `DecodeEngine`, then parks two sessions
     through a `TieredStore` whose DRAM holds 1.5 KV blobs, so the colder
     one is demoted to flash and comes back through a prefetch on the
     virtual clock; every serving kernel's launch counter must move, and
     a prefill and a decode step each make 37 rmsnorm launches; then
     one prefill and one decode step under torch.profiler: device
     operations by time, their count and the device-idle share, and one
     decode-attention kernel with one launch a layer in the step;
  5. reduced gemma-2b in float32: the engine's greedy tokens (kernels)
     equal a greedy loop over the plain PyTorch path;
  6. the SSD-resident cuckoo KV store (paper §VII-A): examples/
     kvstore_demo.py's store (8192 buckets x 8 slots, load 0.7) answers
     4096 batched GETs through the probe kernel and a timed store's
     get_many; then a table of 2^23 buckets x 8 slots (512 MiB on the
     card, each bucket's keys and values in one 64-byte row) answers 2^20
     probes, half stored and half absent; the kernel is held bit for bit
     against its plain version there and on every path (slots 4, 5, 8
     and 16; two arrays, one table, one at a 4-byte offset; N = 0 to
     4096 around a group's edges; one bucket; negative keys; the tests'
     hand-made table and the int32 wrap), its launch plan against the
     Python twin, and it is timed on both layouts, at a table inside L2
     too, beside torch.index_select of the same rows, each batch (the
     demo's too) beside the bytes it needs (a bound at HBM rate for the
     2^23-bucket table; for the tables that stay in L2, a bound at the L2
     read rate measured first: one torch.sum of a 32 MiB buffer held in
     L2);
  7. two-stage ANN search (paper §VII-B) over 262,144 vectors (full
     1024-d, reduced 128-d) for 1024 queries: recall@10 against exact
     search on the card, ann_topk against its plain version (k = 64, 128
     and 256; exact ties of copied rows across tile and split borders,
     resolved to the lowest ids; N = 300 at k = 256 and k = N; Q = 1 and
     65; D = 30 and 1024; a bitwise repeat), the resident blocks an SM
     the card reports against the shared-memory rule, recall@10 > 0.98 at
     the reference tests' size (8000 vectors), recall@10 at promote 128
     and 256 (and at 256 with stage 1 by exact search), kernel time at
     k = 1, 64, 128 and 256 against torch.addmm + torch.topk, and the
     kernel's per-phase timeline;
  8. the autopilot: the reuse-sketch kernel bit for bit against its plain
     version (on the card and on the host) at the bench's shape, the
     scale replay's (50,000 and 2^20 intervals), an empty batch, every
     bucket edge +-64 ulps and special values; M batches in one call
     (M = 2, 10 and 349 one-key segments, random cuts with empty
     segments, the small path's limit and one slot past it), the large
     path right after itself, bitwise repeats, and one segment whose end
     stops short of N on both paths; times at each flush size; the admission
     benchmark (4 scenarios x 240 steps) on the card, byte-identical to
     the same suite on the CPU, with one kernel launch per flush of a
     tracker's pending observes; and a control plane of 20 steps x
     50,000 Zipf keys over 1,000,000 ids whose sketch is bit-identical on
     the card and the host every step;
  9. the declared platform: examples/serve_tiered_kv.py's one-host spec
     (static thresholds, 5 ms step) with phase 4's tiers, compiled by
     `Platform.compile(device="cuda")`, serves phase 4's prompts on phase
     4's weights through `Platform.engine`, then runs the example's
     pause / reuse / prefetch / resume flow; the same flow on an engine
     built directly on a TieredStore must give the same tokens, tiers
     and kv_stall_time; the serving kernels must launch within the
     phase, and the cold session's blob must be on flash before its
     prefetch; then six decode windows of 199 steps with every slot in
     use, platform and direct engine in turns, give tokens/s (three
     windows each, median and range); tokens/s, kv_stall_time and both
     reports are printed beside the card's name and power limit; then a
     traced kv_session save, think gap and resume (quickstart section 6)
     whose stall ledger conserves and whose Perfetto export is not empty;
 10. continuous batching over a declared workload: three tenants (8
     premium chat sessions of 384-token prompts, 4 RAG sessions of 640,
     8 scan sessions of 128) on one host whose DRAM holds 4 KV blobs,
     the economic policy priced per tenant, through `Platform.compile`
     -> `Platform.scheduler` -> `run(Platform.jobs())` on phase 4's
     weights (4 slots, 1024 positions); two runs on fresh platforms
     give equal tokens and reports; continuous batching gives the
     lock-step gang's tokens; the stall ledger conserves; pauses reach
     both DRAM and flash; premium's tau_be is above scan's; rmsnorm,
     decode and flash attention and reuse_sketch launch in the phase;
     prints the modeled report, the tenants' cells and ledger, each
     run's host-clock wall split into decode steps and the rest, and the
     device-idle share of one decode step with every slot decoding; the
     reduced model, on one weight set made on the CPU and copied to the
     card, gives a byte-identical report and every session's tokens equal
     on the card and the CPU.
 11. the autopilot's closed loops: the autoscale bench (diurnal trace, 240
     steps, `Platform.autoscale` growing and shrinking the fleet against a
     peak-provisioned static fleet) and the failover bench (four hosts, 12
     checkpointed sessions, the busiest host killed at step 120 under
     replication 1, 2 and 3, then the repair loop), at the reference's
     defaults with every fleet tracker's sketch on the card: each
     byte-identical to the same bench on the CPU, one reuse_sketch launch
     per flush, the reference's acceptance verdicts; then the autoscale
     bench with one full-width gemma-2b KV blob (37,748,736 B) a block,
     byte-identical on both devices, its verdicts printed as measured;
     each arm's host-clock wall on both devices, its launches and its
     modeled cost_per_token, per_token_stall and recovery_seconds.
 12. the paper's artifacts on the card: `repro_torch.benchmarks.run
     --full --device cuda` in the process (ten anchors met; Fig. 10's
     fails at --full as the reference's own does, its recall@10 within
     0.005 of the CPU's); the eleven artifacts in quick mode on the card
     and the CPU, rows and notes equal (numbers at rtol 1e-12, Fig. 10's
     recall@10 within 0.005); `analytic_iops_grid` over Fig. 3's grid
     (SLC/pSLC/TLC, storage-next and normal, l_blk 512-4096, gamma 1, 3,
     9 and inf) and the channel-bandwidth sweep, card == CPU at rtol
     1e-12; the kvstore_demo, ann_search and provision_advisor twins (the
     advisor in its three modes) on both devices, every line equal but
     the host-clock and route parts that TWIN_MASKS names; ann_search
     over phase 7's corpus (262,144 vectors, 1024 queries) at promote 64
     and 256 on the card, recall@10 > 0.98 at 256; cuckoo_probe, ann_topk
     and reuse_sketch each launched in the phase; then, outside the
     counted run, ann_topk against its plain version at Fig. 10's stage-1
     shapes ([200,128] x [20,000 | 100,000,128], k = 64) by phase 7's
     rule (ANN_ATOL, ANN_TIE).
 13. full-width deepseek-7b (30 layers, d_model 4096, MHA of 32 heads of
     128, SwiGLU d_ff 11008, an untied unembed; random bf16 weights from
     a seed): (a) rmsnorm and add_rmsnorm at [4,4096] and [1023,4096],
     decode attention at q [4,32,128] and k,v [4,32,1024,128] (one query
     head a kv head; the step's lengths, ragged ones, 0 and past T;
     timed over one cache a layer) and flash attention at q,k,v
     [1,32,S,128] at every prefill bucket (the prefill's strided layout
     too), each against its plain version in f32 and bf16 and timed
     against its library call and bound; (b) serve_tiered_kv's spec
     through `Platform.compile` -> `Platform.engine`: the first step's
     logits against the plain path by phase 4's rule, phase 4's prompts
     and the example's flow, greedy tokens across a pause to flash and a
     prefetched resume equal to a run without a break (the pause's and
     the restore's host time), DRAM and flash both written, three decode
     windows, one prefill and one decode step profiled; (c) one run of
     phase 10's workload through `Platform.scheduler` at 8 of its 30
     layers (views of the first 8 groups' weights, as phases 16 and 17
     cut theirs, so the script keeps its time with phase 20): its report,
     tenants, ledger, tau_be, where each pause went, the wall split and
     peak host RSS; the serving kernels and reuse_sketch launched.
 14. the fleet at scale: (a) the fleet bench through the serving_fleet
     twin on the card and on the CPU, JSON byte-identical: --smoke,
     --smoke --churn, the default sweep (hosts 2, 4 and 8 by skew 0.0 and
     1.2) at one full-width gemma-2b KV blob a session (37,748,736 B),
     the heterogeneous 2:1 DRAM spec (kv_tier DRAM) under capacity and
     uniform ring weighting, and a four-host economic spec whose gates
     keep their reuse sketch on the card; each cell's sync and async
     stall per token, stall_speedup, remote fetches, the churn's moved
     fraction, walls and peak host RSS; (b) serving/scale.py's replay at
     the reference's defaults (1,000,000 keys, 100,000 sessions, 120
     steps of ~51,700 accesses, 8 hosts, metrics on) on the card, its
     record byte-identical to the CPU's and equal to the reference's
     modeled values, one reuse_sketch launch a step, its timing sections
     and keys/s, tracking split into the host ghost and the kernel's
     device time; (c) the serving_scale twin's run_compare on reduced
     gemma-2b in float32 (card == CPU), then on full-width gemma-2b in
     bf16 (native seed-0 weights, built again: phase 10 freed its own) at
     the bench's jobs (10 jobs, horizon 96, zipf and diurnal), verdicts
     as measured; rmsnorm, decode and flash attention and reuse_sketch
     launched in the phase.
 15. declared tenants and the fourth tier: serving/tenants.py's
     tenant-isolation bench (premium + batch + scan-flood, three arms)
     and serving/tiers.py's fourth-tier bench (the smoke packs moe_scan
     and diurnal, four arms: baseline, the GPU-direct flash lane, the
     far-memory pool, both) through Platform.compile ->
     Platform.scheduler; (a) at the reference's geometry (reduced
     gemma-2b, max_len 64, 4 slots) on the card and on the CPU over one
     weight set made on the CPU: the JSON byte-identical and every
     session's tokens equal, and the reference tests' verdicts
     (isolation_effective, gpu_flash and pool each winning somewhere,
     each scenario's advice_agreement) held on the card; (b) full-width
     gemma-2b in bf16 at max_len 64, each pack's blob-unit sizes (host
     DRAM, l_blk, the pool's capacity) rescaled to the engine's blob of
     2,359,296 B, verdicts printed as measured, the run held to the
     plain path by the first-step logits and by each serving kernel at
     the prefill buckets and length vectors it launched; each arm's wall,
     decode steps and ms a step beside its modeled per_token_stall,
     $/token, tau_be and tau_pool; rmsnorm, decode and flash attention
     and reuse_sketch launched in the phase.
 16. full-width mistral-nemo-12b (40 layers, d_model 5120, GQA of 32
     query heads on 8 kv heads of 128, so a query width of 4096 against
     d_model 5120, SwiGLU d_ff 14336, vocab 131072, rope theta 1e6, an
     untied unembed; random bf16 weights from a seed) through phase 13's
     path: (a) its serving kernels at its shapes (rmsnorm at
     [4,5120] and [1023,5120], decode attention at q [4,32,128] and k,v
     [4,8,1024,128], flash attention at q [1,32,S,128] and k,v
     [1,8,S,128]), then decode attention at the config's own context,
     k,v [4,8,131072,128] at lengths 131072, 100003, 32769 and 1,
     against its plain version in f32 and bf16, timed beside masked
     SDPA and its bound, with its timeline there; (b) as phase 13, and
     (c) at 10 of its 40 layers (views of the first 10 groups' weights:
     the run's wall is host launches a layer, and the whole script keeps
     inside its time with phase 19); peak device memory of native init,
     of the first-step check, of (b) and of (c).
 17. full-width granite-20b (52 layers, d_model 6144, MQA of 48 query
     heads on one kv head of 128, a plain GELU FFN of d_ff 24576, vocab
     49152, tied embeddings without a scale, rope theta 1e4; 40.03 GB of
     random bf16 weights from a seed, drawn in place) through phase 16's
     path: (a) rmsnorm at [4,6144] and [1023,6144], decode attention at
     q [4,48,128] and k,v [4,1,1024,128] (six head groups a block),
     flash attention at q [1,48,S,128] and k,v [1,1,S,128], then decode
     attention at the config's own 32,768 positions at lengths 32768,
     25001, 8193 and 1, in f32 and bf16 (48 heads' merge weights over
     1,024 chunks: the shared-memory layout's largest case); (b) and
     (c) as phase 16 ((c) at 13 of its 52 layers), with the device
     memory held when the phase starts and the bytes it will need
     reckoned before they are made.
 18. full-width qwen3-moe-235b-a22b at 12 of its 94 layers (31.1 billion
     parameters, 62.2 GB of random bf16 weights drawn in place; the 94
     layers are 470 GB): d_model 4096, GQA of 64 query heads on 4 kv
     heads of 128 with qk-norm (q and k normed a head at a time by the
     rmsnorm kernel at D = 128), an MoE sublayer of 128 experts top-8 of
     d_ff 1536 (SwiGLU) at static capacity, vocab 151936, untied, rope
     theta 1e6, through phase 16's path: (a) adds the qk-norm rows
     ([4 x 64, 128], [4 x 4, 128] and the largest bucket's) against the
     plain version and timed; decode attention at 16 query heads a kv
     head, at 1,024 and at 32,768 positions; (b) the first-step check
     replays the kernel path's expert ids on the plain paths, then runs
     the plain path on its own routing and counts the choices that
     differ; the first decode window notes every step's expert ids, and
     one decode step's expert products are timed in place against the
     bound of reading every expert (57.98 GB); (c) at 3 of the 12 layers
     (views of the first 3 groups' weights); (d) the first 64 steps'
     ids x 12 layers replay through `Platform.expert_store` (economic
     policy priced at one expert's 37,748,736 B, every expert on flash),
     pipelined and through the reference test's fetch loop, on the card
     (the gate's reuse sketch runs reuse_sketch) and on the CPU, records
     equal and the pipelined stall below the sync one; the residency
     plan, the gate's stats and each layer's selection shares printed.
 19. full-width llama4-maverick-400b-a17b at one of its 24 groups, a
     dense layer and an MoE layer (18.6 billion parameters, 37.11 GB of
     random bf16 weights; the 48 layers are 795 GB, and two groups
     would fit native init but not the first-step check's float32 cast
     of one whole expert stack): d_model 5120, GQA of 40 query heads on
     8 kv heads of 128 (five query heads a kv head: one head group of
     8 with three idle lanes in decode attention), SwiGLU d_ff 8192 in
     the dense layer, 128 experts top-1 of d_ff 8192 and an always-on
     shared expert of 8192 in the MoE layer, vocab 202048, untied, rope
     theta 5e5, through phase 18's path with every count of attention
     and MoE layers taken from the pattern (2 flash or decode attention
     launches and 5 norms a prefill or step); native init draws each
     [128, 5120, 8192] expert stack one expert at a time; (d) at one
     MoE layer a step has nothing upstream to prefetch behind, so every
     step must prefetch no expert.
 20. full-width zamba2-7b (81 layers: 13 groups of five Mamba-2 layers and
     a layer of shared attention, shared FFN and Mamba-2, then a tail of
     three Mamba-2 layers; d_model 3584, Mamba-2 of 112 heads of 64 with
     state 64 and d_inner 7168, MHA of 32 heads of 112 and a SwiGLU FFN of
     14336 whose one weight set every group applies, vocab 32000, tied;
     13.27 GB of random bf16 weights) through phase 13's path: prompts
     prefill at their exact lengths (pads would advance the recurrent
     state), so (a) holds flash attention at q,k,v [1,32,S,112] (padded
     to head_dim 128 by its wrapper) at every prompt length, decode
     attention at q [4,32,112] and k,v [4,32,1024,112], rmsnorm at
     [4,3584] and the prefill's rows, and the Mamba-2 gated norm's
     float32 rmsnorm at [4,7168] and [S,7168]; (b) native init and the
     first-step check at all 81 layers (13 shared-attention applications,
     189 norms a prefill or step: 108 pre-norms and the final one, 81
     gated); then (b)'s serving and (c) at ZAMBA_GROUPS of its 13 groups
     and the tail (views of the full weights: a full-depth decode step is
     ~3,900 launches, host-bound), with a park check in (b): a session
     parked three steps, then unparked, decodes the tokens of the run
     without the park. A paused blob holds each slot's K/V of the
     attention applications, the float32 Mamba-2 state and the conv
     windows (537,409,024 B at full depth and 1024 positions, 87,558,656
     B at 2 groups).
 21. full-width xlstm-350m (24 layers: 12 groups of an mLSTM layer, 4
     heads of 512 with d_in 2048 and a [4,512,513] float32 matrix memory,
     and an sLSTM layer, 4 heads of 256 with a GeGLU projection of 1365;
     d_model 1024, no attention and no FFN, vocab 50304, tied; 0.78 GB of
     random bf16 weights) through phase 20's path: (a) rmsnorm and
     add_rmsnorm at [4,1024] and the prompts' exact lengths, and the
     mLSTM's and sLSTM's inner norms on float32 rows ([4,2048] and
     [S,2048], [4,1024] and [S,1024]); (b) at all 24 layers: 49 norms and
     no attention kernel a prefill or step, the first-step check, the
     example's flow, a pause of the 51,068,928 B blob (one size at any
     context) to flash and its prefetched resume, the park check, three
     decode windows, the profile, and the sLSTM scan's launches a cell
     step and its host time a step; (c) at 3 of its 12 groups (a
     prefill's scan is ~100,000 launches, host-bound).
 22. full-width qwen2-vl-2b (28 layers, d_model 1536, GQA of 12 query
     heads on 2 kv heads of 128 with M-RoPE, sections (16, 24, 24) of
     the 64 frequencies, SwiGLU d_ff 8960, vocab 151936, tied, rope
     theta 1e6; 3.09 GB of random bf16 weights) through phase 16's path:
     (a) rmsnorm at [4,1536] and [1023,1536], decode attention at q
     [4,12,128] and k,v [4,2,1024,128] (six query heads in a head group
     of 8), flash attention at q [1,12,S,128] and k,v [1,2,S,128], and
     decode attention at the config's 32,768 positions; (b) as phase 16,
     served on tokens alone as the reference engine serves the config
     (its three position streams the index), plus a vision-prefix check:
     256 patch embeddings (a 16 x 16 grid) and 767 tokens, S = 1,023,
     with t the index and h, w the grid over the image, prefilled and
     decoded one step through the kernels and through the plain path,
     both logits held by the first-step rule, 28 flash launches a
     prefill, 28 decode-attention launches a step and 57 norms each, the
     prefill's wall and kernel time printed; (c) as phase 16, at 7 of its
     28 layers.
 23. full-width whisper-medium (24 encoder layers over 1,500 frame
     embeddings with sinusoidal positions and non-causal self-attention;
     24 decoder layers of causal self-attention with no positions at all
     (rope "none"), cross-attention onto the encoder's 1,500 rows and a
     GELU FFN of 4096; d_model 1024, MHA of 16 heads of 64, LayerNorm,
     vocab 51865, tied; 1.52 GB of random bf16 weights) through phase
     16's path, its prompts prefilled at their exact lengths on zero
     frames as its engine does: (a) flash attention causal at the
     prompts' lengths and non-causal at the encoder's [1,16,1500,64], at
     cross-attention from S = 1, 23 and the prompts' lengths onto 1,500
     rows, at T <= 64, S > T and GQA 4:1, decode attention on the self
     cache [4,16,1024,64] and on the cross cache [4,16,1500,64] (every
     slot's length 1,500), and at the config's 32,768 positions, each
     against its plain version, timed beside SDPA and the bound, and no
     rmsnorm (its path has none); (b) at all 48 layers: 72 flash
     launches a prefill, 48 decode-attention launches a step and no
     rmsnorm, the first-step check, then an audio check (random frames
     [1,1500,1024] from the seed with a prompt, prefilled and decoded a
     step through the kernels and the plain path by the first-step rule,
     the encoder's wall and kernel time printed), the example's flow and
     a pause of the 496,238,592 B blob (its bf16 cross and self K/V
     widened to float32) to flash and its prefetched resume, decode
     windows and the profile; (c) at 6 of its 24 decoder layers, the
     encoder at full depth.
 24. full-width gemma-2b with Gemma 2's attention features (its 18
     layers as 9 groups of a local layer, a sliding window of 4,096, and
     a global one; every score capped at 50, the logits at 30; the
     config built here, as no reference config turns them on): (a)
     decode attention at q [4,8,256] on k,v [4,1,T,256], T = 1,024 and
     8,192, over an int8 cache with its bf16 scales (ragged lengths, 0
     and past T), with the window (rows whose window starts mid-chunk,
     at a chunk's edge, and short rows), with the cap, and all three;
     flash attention at q [1,8,S,256] on k,v [1,1,S,256], S = 700,
     4,097 and 8,191, as a local layer, a global one and the window
     alone (windows of 100 and 1 at 700), in the prefill's strided
     layout too; each in float32 and bf16 against its plain version,
     finite, then timed beside the library call (dequantize then SDPA;
     SDPA with a boolean window mask; none for a cap) and the bound;
     (b) serve_tiered_kv's spec at max_len 8,192 through
     `Platform.engine`: the first-step check at bucket 8,191, 18 flash
     and 18 decode-attention launches a prefill or step and 37 norms,
     five prompts of 4,200-6,000 tokens and one of 700, the example's
     flow, a pause of the 301,989,888 B blob to flash and its prefetched
     resume with the unbroken run's tokens, the profile, no decode
     windows; (c) the int8 KV cache on the same weights: 4 prompts
     prefilled into `init_cache(dtype=torch.int8)`, 32 greedy steps
     through the kernels and the plain path (the first-step rule; the
     greedy token wherever the plain path's top-2 margin exceeds 0.02),
     the cache's bytes, a step's attention kernels and the whole step
     against the bf16 cache's, and the logits' distance from it.
 25. training on the card: (a) the backward kernels, flash_attention_bwd
     (gemma-2b's training shape q [2,8,1024,256] on k,v [2,1,1024,256]
     causal; MHA and GQA 4:1 at head_dim 128, S = 512; whisper's
     cross-attention q [1,16,605,64] onto 1,500 rows; a window of 256
     with a cap of 50 at S = 700; S = 1, T = 1 and both; head_dim 112 and
     16 through the wrapper's padding) and rmsnorm_bwd with its add form
     ([2048,2048] bf16 and f32, [605,7168] f32, D = 2050), in float32 and
     bf16 against their plain versions (float32 outputs within 1e-4 of the
     plain outputs' largest |value|; bf16 within twice the plain bf16's
     own distance from the plain float32), a bitwise repeat, and timed
     beside the bound and the library call (autograd through SDPA with
     enable_gqa, through compiled flex_attention for the window and the
     cap in both types, its gradients held first to the plain float32
     ones within TOL's atol + rtol x their largest |value|, and through
     F.rms_norm), flash_attention_bwd's bf16 passes (rows, dk/dv, the
     group sum, dq) at gemma's shape by their kernels' names under
     torch.profiler; (b) one float32 train step of every reduced config (and
     reduced Gemma 2) through the kernels on the card against the same
     step on the CPU from one weight set: the loss within 1e-5
     (relative), every gradient leaf within 1e-4 of its largest |g|, both
     backward counters moving wherever the config's path has the kernel;
     (c) full-width gemma-2b (2,506,172,416 parameters, float32 master
     weights, bf16 compute, remat): one gradient of its first 4 groups
     through the kernels held leaf by leaf against the plain path
     (relative L2 within twice the plain bf16's distance from float32),
     then 5 train steps over SyntheticLM batches (2 x 1,024 tokens) under
     the Watchdog, each with 36 flash_attention, 73 rmsnorm, 18
     flash_attention_bwd and 37 rmsnorm_bwd launches; prints the loss
     curve, each step's wall beside what could stall its host (the
     caching allocator's retries and cudaMalloc calls, the seconds of
     Python's garbage collections), the step wall, tokens/s, peak device
     memory against the
     state's reckoned 40.10 GB, the device-idle share of one profiled
     step and AdamW's update alone.

The first-step check (phases 4 and 13-23) holds the kernels to the plain
path in bf16 within twice the plain path's distance from the float32
path, which runs on the bf16 weights themselves (each cast to float32
only while it is used), so no phase holds a float32 copy of a model's
weights.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
exits non-zero.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_REQUESTS = 6
MAX_NEW = 16
MAX_SLOTS = 4
MAX_LEN = 1024
STEP_TIME = 5e-3
STEADY_NEW = 200               # tokens a request in phase 9's windows
# tokens a request in the windows of phases 13 and 16-23: with 200 the
# whole script took 950.7 s of its 1,200 on an NVIDIA H100 80GB HBM3 at
# 700 W once phase 23 joined it, 254 s of it in those phases' windows; at
# 120, with phase 25, 957.7 s on one host and 1,119.9-1,152.2 s on slower
# ones (206 s of windows there), so at 80 the windows give back ~70 s
DENSE_STEADY_NEW = 80
SPIN_CYCLES = 100_000_000      # ~50 ms at the H100's ~2 GHz SM clock
# kernel vs plain version: both accumulate in float32; float32 outputs
# differ only by summation order, bfloat16 outputs additionally by one
# rounding step of the output (2^-8 relative)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=1.6e-2)}
KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:29"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:91"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:100"),
    "cuckoo_probe": ("src/repro_torch/csrc/cuckoo_probe.cu",
                     "src/repro/kernels/cuckoo_probe/kernel.py:70"),
    "ann_topk": ("src/repro_torch/csrc/ann_topk.cu",
                 "src/repro/kernels/ann_topk/kernel.py:80"),
    "reuse_sketch": ("src/repro_torch/csrc/reuse_sketch.cu",
                     "src/repro/kernels/reuse_sketch/kernel.py:54"),
    # the backward kernels replace the reference's gradients: its
    # flash_attention custom_vjp's backward, and XLA's derivative of its
    # jnp norm (the rmsnorm TPU kernel has no vjp)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/ops.py:47"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm_bwd.cu",
                    "src/repro/models/layers.py:60"),
}
SERVING_KERNELS = ("rmsnorm", "decode_attention", "flash_attention")
ATTENTION_KERNELS = ("decode_attention", "flash_attention")
# the full-width configs the script serves, by their published parameter
# count at the depth served: gemma-2b in phases 4 and 9-10, deepseek-7b in
# phase 13, mistral-nemo-12b in phase 16, granite-20b in phase 17, all at
# full depth; qwen3-moe-235b-a22b in phase 18 at MOE_GROUPS of its 94
# layers (235,093,634,560 parameters at all 94, 470 GB in bf16);
# llama4-maverick-400b-a17b in phase 19 at TOP1_GROUPS of its 24 groups
# of two layers (397,691,950,080 parameters at all 24, 795 GB in bf16)
MOE_GROUPS = 12
# one group (a dense and an MoE layer) and the two tables are 37.11 GB in
# bf16; two groups (70.08 GB) would fit native init, but not the
# first-step check's float32 truth, which casts one whole [128, 5120,
# 8192] expert stack at a time (+21.5 GB: 91.6 GB of the card's 85.0)
TOP1_GROUPS = 1
PARAMS = {"gemma-2b": 2_506_172_416, "deepseek-7b": 6_910_365_696,
          "mistral-nemo-12b": 12_247_782_400,
          "granite-20b": 20_013_766_656,
          "qwen3-moe-235b-a22b": 31_097_723_904,
          "llama4-maverick-400b-a17b": 18_553_267_200,
          "zamba2-7b": 6_636_442_832, "xlstm-350m": 391_730_272,
          "qwen2-vl-2b": 1_543_656_960, "whisper-medium": 758_002_688,
          "gemma-2b-gemma2": 2_506_172_416}
# the config's analytic `param_count()` less the tensors native init
# makes: zamba2-7b's leaves out each Mamba-2 layer's conv bias (7,296)
# and skip (112) and counts each shared sublayer's norm twice (3,584 x 2);
# xlstm-350m's counts each mLSTM's gate projection and bias as 4 x 4
# heads, where w_gates [2048, 8] and b_gates [8] hold 16,392;
# whisper-medium's counts a norm as its scale and leaves out the 122
# layernorm biases (24 x 3 + 1 in the decoder, 24 x 2 + 1 in the encoder)
ANALYTIC_GAP = {"zamba2-7b": -81 * (7_296 + 112) + 2 * 3_584,
                "xlstm-350m": -12 * (2048 * 8 + 8 - 16),
                "whisper-medium": -122 * 1024}
# phase 3, rmsnorm: d_model of the repo's configs (64: the reduced ones;
# 1024: xlstm-350m's; 1536: qwen2-vl-2b's), 128 (qwen3-moe's qk-norm rows, one a head), the
# TPU kernel's largest and one that is not a multiple of 8; rows of a
# step, of a decode step's slots and of the largest prefill bucket
RMS_DS = (64, 128, 1024, 1536, 2048, 4096, 5120, 6144, 8192, 2050)
RMS_ROWS = (1, MAX_SLOTS, MAX_LEN - 1)
# phase 6: examples/kvstore_demo.py's store, and one at deployment size
KV_DEMO_BUCKETS = 8192
KV_BUCKETS = 1 << 23           # x 8 slots x (key + value) int32 = 512 MiB
KV_SLOTS = 8
KV_LOAD = 0.7
KV_PROBES = 1 << 20
KV_L2_BUCKETS = 1 << 19        # x 8 x 2 x 4 B = 32 MiB: inside the 50 MB L2
# phase 7: the corpus and queries; the reference tests' size
ANN_N, ANN_D_FULL, ANN_D_RED, ANN_Q = 262_144, 1024, 128, 1024
ANN_PROMOTE, ANN_K = 64, 10
ANN_DEEP = (128, 256)          # deeper promotes, up to ann_topk's cap
ANN_SMALL = (8000, 100)
# rows copied from a pool, for exact ties: (corpus rows, pool rows, queries)
ANN_TIED = (65_536, 512, 256)
# ann_topk vs its plain version: float32 products in another summation
# order differ by ~1e-6 at these magnitudes (|d| <= 3); ids are compared
# wherever the plain version's neighbouring distances differ by > 1e-5
ANN_ATOL, ANN_TIE = 1e-4, 1e-5
# phase 8: the scale replay's step (src/repro/serving/scale.py) and the
# control plane fed with it: Zipf ids, the first PLANE_KV of class "kv"
SKETCH_N_STEP = 50_000
PLANE_STEPS, PLANE_KEYS, PLANE_KV = 20, 1_000_000, 100_000
# phase 12: the paper's artifacts. Rows and notes of the host float64
# analytics and the event simulator on the card equal the CPU's to
# ARTIFACT_RTOL (the same float64 code on both). Fig. 10's stage 1 ranks
# by ann_topk on the card and by its plain version on the CPU: float32
# products summed in another order may swap near-tie ids at the promote
# boundary, so recall@10 is held within RECALL_TOL (10 of the 2,000 true
# neighbours of 200 queries) and not to equality
ARTIFACT_RTOL = 1e-12
RECALL_TOL = 0.005
# the reference's own Fig. 10 fails its recall anchor at --full (recall@10
# 0.916 over 100,000 vectors at promote 64; its `fig10_ann(quick=False)`
# raises the same): the port reproduces that artifact's outcome, not a pass
FULL_ANCHOR_FAILS = ("Fig. 10  two-stage progressive ANN",)
# the example twins' host-clock and device-naming parts (pattern,
# replacement), blanked on both devices before their lines are compared
TWIN_MASKS = {
    "kvstore_demo": (
        (r"^(\[store\] \d+ items inserted at load [0-9.]+) in [0-9.]+s;",
         r"\1 in <host clock>;"),
        (r"^(\[store\] batched GET x\d+: \d+ found, \d+ values correct), "
         r"\d+ms \((.*); (~1\.5 block reads/GET)\)$",
         r"\1, <host clock> (<route>; \3)")),
    "ann_search": (
        (r"^\[search\] wall: exact [0-9.]+s vs two-stage [0-9.]+s \(.*\)$",
         "[search] wall: <host clock> (<route>)"),),
    "provision_advisor": (),
}
# ann_search's recall line: compared within RECALL_TOL, as Fig. 10's
ANN_RECALL_LINE = r"^\[search\] recall@10 = ([0-9.]+) "
TWIN_RUNS = (("kvstore_demo", ()), ("ann_search", ()),
             ("provision_advisor", ()),
             ("provision_advisor", ("--trace", "scan_flood")),
             ("provision_advisor", ("--advise-tiers", "--trace", "diurnal",
                                    "--rent-factor", "0.25")))
# phase 7's corpus through the ann_search twin: the default promote, and
# the deepest that ann_topk takes
ANN_TWIN_FULL = ("--n", str(ANN_N), "--queries", str(ANN_Q))
PHASE12_KERNELS = ("cuckoo_probe", "ann_topk", "reuse_sketch")
# Fig. 10's stage 1 (quick, also ann_search's default, and --full):
# FIG10_Q queries against each corpus size, at promote ANN_PROMOTE
FIG10_N, FIG10_Q = (20_000, 100_000), 200


def _prompts(vocab: int, n: int, rng):
    import numpy as np
    return [rng.integers(1, vocab, int(rng.integers(64, 701))).astype(
        np.int32) for _ in range(n)]


def _bucket(n: int, max_len: int = MAX_LEN) -> int:
    """The engine's prefill length of an n-token prompt: the next power of
    two, at most max_len - 1."""
    return min(1 << (n - 1).bit_length(), max_len - 1)


def _path_shapes(prompts, exact=False):
    """The kernels' shapes on the serving path of `prompts`: the decode
    step's lengths of the first slot grid, a few steps in (int32 on the
    card), and the engine's prefill lengths, prompts padded to powers of
    two (at their exact lengths when `exact`: a recurrent config's)."""
    import torch
    lengths = torch.tensor([len(p) + 8 for p in prompts[:MAX_SLOTS]],
                           dtype=torch.int32, device="cuda")
    if exact:
        return lengths, sorted({len(p) for p in prompts})
    buckets = sorted({_bucket(len(p)) for p in prompts})
    return lengths, buckets


def _time_ms(calls, iters: int = 40, queued: bool = True) -> float:
    """Mean time of one call over `iters` calls cycling through `calls`
    (distinct inputs, so a call does not find the previous call's inputs
    in L2 where the real path would find them cold), by CUDA events.

    queued=True gives device time: the calls are enqueued behind a spin
    kernel of ~50 ms, so the host's launch overhead overlaps it and the
    events see only the device work. queued=False lets the host launch
    as the path does, so host overhead shows where it exceeds the work."""
    import torch
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    import torch
    from repro_torch.core import units
    peak = (units.H100_PEAK_FLOPS_BF16 if dtype == torch.bfloat16
            else units.H100_PEAK_FLOPS_F32)
    t_bytes = nbytes / units.H100_HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, dtype_name, label):
    import torch
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[dtype_name],
                               msg=lambda m: f"{name} {label}: {m}")
    print(f"  check {name:17s} {label:44s} max_abs_err={err:.3e} ok")
    return err


def _print_record(name, r):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    print(f"  time  {name:17s} {r['shape']}: kernel_ms={r['ms']:.4f} "
          f"(with host launch {r['launch_ms']:.4f}) plain_ms="
          f"{r['plain_ms']:.4f} library_ms={lib} "
          f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")


def _print_timeline(tl, where=""):
    recorded = ("" if tl["blocks_recorded"] == tl["blocks"] else
                f"; the first {tl['blocks_recorded']} of {tl['blocks']} "
                f"blocks recorded, rows (b, kv head) in order")
    print(f"  time  decode_attention  timeline{where} (us at "
          f"{tl['sm_clock_mhz']} MHz{recorded}): first start to last exit "
          f"{tl['first_start_to_last_exit_us']}; merging block "
          f"{tl['critical_block_us']}; partial blocks (median) "
          f"{tl['partial_blocks_median_us']}")


def _capped_flex(softcap, keep, B, S, T, scale, device):
    """The one PyTorch call that computes attention with capped scores:
    flex_attention under torch.compile, tanh(s / softcap) * softcap on
    s = q.k * scale as its score_mod, and `keep(b, q_idx, kv_idx)` as a
    block mask over [B, S, T] built here, before any timing (as SDPA's
    boolean mask is). Timed beside the kernels, used nowhere in the port.
    Returns (q [B,H,S,hd], k, v [B,KV,T,hd]) -> [B,H,S,hd]."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        # a compile a form, then one with dynamic sizes (ten shapes and
        # forms in phase 24)
        torch._dynamo.config.cache_size_limit = max(
            torch._dynamo.config.cache_size_limit, 64)
        _FLEX.append(torch.compile(flex_attention))

    def cap(s, b, h, q_idx, kv_idx):
        return torch.tanh(s / softcap) * softcap

    block = create_block_mask(lambda b, h, i, j: keep(b, i, j), B, None,
                              S, T, device=device)
    return lambda q, k, v: _FLEX[0](q, k, v, score_mod=cap,
                                    block_mask=block, scale=scale,
                                    enable_gqa=True)


_FLEX = []                     # flex_attention compiled, at first use


def _decode_record(q, caches, lengths, scale, err, window=0,
                   softcap=0.0) -> dict:
    """decode_attention's times over `caches`, one (k, v) a layer (or an
    int8 one's (k, v, k_scale, v_scale)) read in turn as the decode step
    reads them: kernel (device and with launch), plain version, the
    library call (SDPA with the length and window mask; with a score cap,
    compiled flex_attention, the cap its score_mod and the same mask its
    block mask; an int8 cache dequantized first), and the bound of the
    bytes and products of the rows each slot sees (the window's, its
    scales with an int8 cache). With a cap the library call's output is
    held to the plain version's first (bf16 TOL)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        dequantize, reference_decode_attention)

    B, H, hd = q.shape
    KV, T = caches[0][0].shape[1:3]
    pos = torch.arange(T, device=q.device)[None, :]
    length = lengths.clamp(0, T)[:, None]
    seen = pos < length
    start = (length - window).clamp_min(0) if window else 0
    if window:
        seen &= pos >= start
    valid = seen[:, None, None, :]
    rows = int((length - start).clamp_min(0).sum())
    size, kv_size = q.element_size(), caches[0][0].element_size()
    int8 = len(caches[0]) == 4
    nbytes = (2 * rows * KV * (hd * kv_size + 2 * int8)
              + 2 * q.numel() * size + B * 4)
    b_ms, b_by = _bound_ms(nbytes, 4 * rows * H * hd, q.dtype)
    dt = str(q.dtype).split(".")[1].replace("bfloat16", "bf16")
    form = ("" if not int8 else " int8 k,v + bf16 scales") + (
        f" window {window}" if window else "") + (
        f" softcap {softcap:g}" if softcap else "")

    def calls(fn):
        return [lambda c=c: fn(q, *c) for c in caches]

    def scales(c):
        return dict(k_scale=c[2], v_scale=c[3]) if int8 else {}

    if softcap:
        lo = start[:, 0] if window else torch.zeros_like(length[:, 0])
        capped = _capped_flex(softcap, lambda b, i, j, hi=length[:, 0],
                              lo=lo: (j < hi[b]) & (j >= lo[b]),
                              B, 1, T, scale, q.device)

    def library(q, k, v, *sc):
        if int8:
            k, v = dequantize(k, sc[0], q.dtype), dequantize(v, sc[1],
                                                             q.dtype)
        if softcap:
            return capped(q[:, :, None], k, v)[:, :, 0]
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid, scale=scale,
            enable_gqa=True)
    kern = calls(lambda q, k, v, *sc: decode_attention(
        q, k, v, lengths, scale=scale, window=window, softcap=softcap,
        **scales((k, v, *sc))))
    plain = calls(lambda q, k, v, *sc: reference_decode_attention(
        q, k, v, lengths, scale=scale, window=window, softcap=softcap,
        **scales((k, v, *sc))))
    if softcap:
        _check("flex_attention", calls(library)[0](), plain[0](),
               "bfloat16", f"library, T={T}{form}")
    return dict(
        shape=(f"q [{B},{H},{hd}] k,v [{B},{KV},{T},{hd}] {dt}{form}, "
               f"lengths {lengths.tolist()}"),
        max_abs_err=err, ms=_time_ms(kern),
        launch_ms=_time_ms(kern, queued=False),
        plain_ms=_time_ms(plain), library_ms=_time_ms(calls(library)),
        bound_ms=b_ms, bound_by=b_by)


def _flash_record(ins, scale, err, causal=True, window=0,
                  softcap=0.0) -> dict:
    """flash_attention's times over `ins`, distinct (q, k, v) of one
    prefill bucket (or, not `causal`, of one encoder or cross-attention
    shape): kernel (device and with launch), plain version, SDPA of the
    same mask (a window's as a boolean mask; with a score cap, compiled
    flex_attention, the cap its score_mod and the mask its block mask,
    its output held to the plain version's first), and the bound of q,
    k, v and out's bytes and the products of the pairs each query sees
    (the causal half, a window's band, or all S x T)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention

    _, H, S, hd = ins[0][0].shape
    KV, T = ins[0][1].shape[1:3]
    size = ins[0][0].element_size()
    if not causal:
        pairs = S * T
    elif window:
        pairs = sum(min(i + 1, window) for i in range(S))
    else:
        pairs = S * (S + 1) // 2
    nbytes = (2 * S * H * hd + 2 * T * KV * hd) * size
    b_ms, b_by = _bound_ms(nbytes, 4 * pairs * H * hd, ins[0][0].dtype)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    kern = [lambda t=t: flash_attention(*t, **kw) for t in ins]
    mode = ("" if causal else " non-causal") + (
        f" window {window}" if window and causal else "") + (
        f" softcap {softcap:g}" if softcap else "")
    if softcap:
        assert causal, "a capped library call is timed causal only"
        band = ((lambda b, i, j: (i >= j) & (i - j < window)) if window
                else (lambda b, i, j: i >= j))
        capped = _capped_flex(softcap, band, 1, S, T, scale,
                              ins[0][0].device)
        _check("flex_attention", capped(*ins[0]),
               reference_attention(*ins[0], **kw), "bfloat16",
               f"library, S={S}{mode}")
        lib_calls = [lambda t=t: capped(*t) for t in ins]
    else:
        if causal and window:
            i = torch.arange(S, device=ins[0][0].device)
            band = (i[:, None] >= i[None, :T]) & (i[:, None] - i[None, :T]
                                                   < window)
            sdpa = dict(attn_mask=band)
        else:
            sdpa = dict(is_causal=causal)
        lib_calls = [lambda t=t: F.scaled_dot_product_attention(
            *t, scale=scale, enable_gqa=True, **sdpa) for t in ins]
    library = _time_ms(lib_calls, iters=20)
    return dict(
        shape=f"q [1,{H},{S},{hd}] k,v [1,{KV},{T},{hd}] bf16{mode}",
        max_abs_err=err, ms=_time_ms(kern, iters=20),
        launch_ms=_time_ms(kern, iters=20, queued=False),
        plain_ms=_time_ms([lambda t=t: reference_attention(*t, **kw)
                           for t in ins], iters=10),
        library_ms=library, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------- phase 3
def _rmsnorm_cases(eps):
    """rmsnorm and add_rmsnorm against their plain versions (TOL) at every
    D of the repo's configs (64 reduced; 1536 to 6144), the TPU kernel's
    largest (8192) and one that is not a multiple of 8, at rows 1, 4 and
    1023, leading dims [1, 1023, D], and views at an odd element offset
    (the scalar path); bit for bit, the fused normed against rmsnorm(x + r)
    and the sum against x + r, a misaligned row against the same row
    aligned, and a batch's first rows against those rows alone; the plan
    the card takes against ops.launch_plan. Returns the largest errors."""
    import torch
    from repro_torch.kernels import _build, add_rmsnorm, rmsnorm
    from repro_torch.kernels._wrap import DTYPE_CODES
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_of = _build.library("rmsnorm_plan_of")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for D in RMS_DS:
            s = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)

            def fresh(*shape, offset=0):
                n = math.prod(shape)
                flat = torch.randn(n + offset, generator=gen, device=dev)
                return flat.to(dt)[offset:].view(shape)

            cases = [((rows, D), 0) for rows in RMS_ROWS]
            cases += [((1, RMS_ROWS[-1], D), 0), ((4, D), 1),
                      ((RMS_ROWS[-1], D), 1)]
            worst = [0.0, 0.0]
            for shape, offset in cases:
                x, r = fresh(*shape, offset=offset), \
                    fresh(*shape, offset=offset)
                label = f"{list(shape)} {name}" + (
                    " odd offset" if offset else "")
                got = rmsnorm(x, s, eps)
                normed, summed = add_rmsnorm(x, r, s, eps)
                want_n, want_s = reference_add_rmsnorm(x, r, s, eps)
                for i, (g, w, lab) in enumerate(
                        ((got, reference_rmsnorm(x, s, eps), "rmsnorm"),
                         (normed, want_n, "add_rmsnorm"))):
                    e = float((g.float() - w.float()).abs().max())
                    torch.testing.assert_close(
                        g.float(), w.float(), **TOL[name],
                        msg=lambda m: f"{lab} {label}: {m}")
                    worst[i] = max(worst[i], e)
                assert torch.equal(summed, x + r), f"sum {label}"
                assert torch.equal(summed, want_s), f"sum {label}"
                assert torch.equal(normed, rmsnorm(x + r, s, eps)), \
                    f"fused != unfused {label}"
                if offset:
                    assert torch.equal(got, rmsnorm(x.clone(), s, eps)), \
                        f"path changed the bits {label}"
                rows = x.numel() // D
                if rows > 4:
                    assert torch.equal(got.view(rows, D)[:4], rmsnorm(
                        x.view(rows, D)[:4].clone(), s, eps)), \
                        f"batch changed the bits {label}"
                aligned = offset == 0
                plan = (ctypes.c_longlong * 5)()
                plan_of(rows, D, DTYPE_CODES[dt], int(aligned), plan)
                want = rms_ops.launch_plan(rows, D, x.element_size(),
                                           aligned, n_sm)
                assert list(plan) == [
                    want["row_threads"], want["chunks"], want["rows"],
                    want["blocks"], int(want["path"] == "vector")], \
                    (label, list(plan), want)
            big = rms_ops.launch_plan(RMS_ROWS[-1], D, x.element_size(),
                                      True, n_sm)
            errs[(dt, D)] = worst
            print(f"  check rmsnorm D={D:<5d} {name:8s} {len(cases)} shapes: "
                  f"max_abs_err {worst[0]:.3e}, fused {worst[1]:.3e}; "
                  f"fused == rmsnorm(x + r) and sum == x + r bitwise; "
                  f"plan at 1023 rows {big['row_threads']} threads a row x "
                  f"{big['chunks']} chunks, {big['rows']} rows a block, "
                  f"{big['path']}")
    return errs


def _host_us(fn, n: int = 2000) -> float:
    """Host time of one call over n calls, synchronised at the end."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def _rmsnorm_host_split(D, eps):
    """Where a decode-step call's host time goes ([4, D] bf16): the whole
    wrapper, its checks, the output's allocation, the stream lookup, the
    ctypes call with everything prepared, and F.rms_norm with its launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, _wrap, add_rmsnorm, rmsnorm
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    x = torch.randn(MAX_SLOTS, D, device="cuda").to(torch.bfloat16)
    r = torch.randn(MAX_SLOTS, D, device="cuda").to(torch.bfloat16)
    s = torch.ones(D, device="cuda")
    s16 = s.to(torch.bfloat16)
    out = torch.empty_like(x)
    fn = _build.library("rmsnorm")
    args = (x.data_ptr(), None, s.data_ptr(), out.data_ptr(), None,
            MAX_SLOTS, D, float(eps), 1, _wrap.stream_of(x.device))
    split = {
        "wrapper": _host_us(lambda: rmsnorm(x, s, eps)),
        "fused wrapper": _host_us(lambda: add_rmsnorm(x, r, s, eps)),
        "checks": _host_us(lambda: (_wrap.on_cuda("rmsnorm", x, s),
                                    rms_ops.check_args("rmsnorm", x, None,
                                                       s))),
        "empty_like": _host_us(lambda: torch.empty_like(x)),
        "stream_of": _host_us(lambda: _wrap.stream_of(x.device)),
        # the lookup stream_of made before (a torch.cuda.Stream a call)
        "stream_of before": _host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "ctypes call": _host_us(lambda: fn(*args)),
        "F.rms_norm": _host_us(lambda: F.rms_norm(x, (D,), s16, eps)),
        "x + r": _host_us(lambda: x + r),
    }
    print(f"  host  rmsnorm x [{MAX_SLOTS},{D}] bf16, us a call (host "
          f"clock over 2000 calls): " + ", ".join(
              f"{k} {v:.2f}" for k, v in split.items()))
    return split


def _rmsnorm_times(D, eps, rows, entries=("rmsnorm", "add_rmsnorm"),
                   dtype=None):
    """Device, with-launch, plain and library times and the byte bound of
    `entries` (both by default) at [rows, D] in `dtype` (bf16 by
    default); the fused entry also against the two launches it replaces
    (x + r, then the kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import add_rmsnorm, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dtype = dtype or torch.bfloat16
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n_in = 8 if rows <= MAX_SLOTS else 4
    xs = [(torch.randn(rows, D, generator=gen, device=dev).to(dtype),
           torch.randn(rows, D, generator=gen, device=dev).to(dtype))
          for _ in range(n_in)]
    s = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
    s16 = s.to(dtype)
    row_bytes = rows * D * dtype.itemsize
    out = {}
    for entry, calls in (
            ("rmsnorm", dict(
                kernel=[lambda x=x: rmsnorm(x, s, eps) for x, _ in xs],
                plain=[lambda x=x: reference_rmsnorm(x, s, eps)
                       for x, _ in xs],
                library=[lambda x=x: F.rms_norm(x, (D,), s16, eps)
                         for x, _ in xs])),
            ("add_rmsnorm", dict(
                kernel=[lambda x=x, r=r: add_rmsnorm(x, r, s, eps)
                        for x, r in xs],
                plain=[lambda x=x, r=r: reference_add_rmsnorm(x, r, s, eps)
                       for x, r in xs],
                library=[lambda x=x, r=r: F.rms_norm(x + r, (D,), s16, eps)
                         for x, r in xs],
                unfused=[lambda x=x, r=r: rmsnorm(x + r, s, eps)
                         for x, r in xs]))):
        if entry not in entries:
            continue
        n_io = 2 if entry == "rmsnorm" else 4
        b_ms, b_by = _bound_ms(n_io * row_bytes + D * 4,
                               (4 if entry == "rmsnorm" else 5) * rows * D,
                               dtype)
        t = dict(ms=_time_ms(calls["kernel"]),
                 launch_ms=_time_ms(calls["kernel"], queued=False),
                 plain_ms=_time_ms(calls["plain"]),
                 library_ms=_time_ms(calls["library"]),
                 bound_ms=b_ms, bound_by=b_by)
        if "unfused" in calls:
            t["unfused_ms"] = _time_ms(calls["unfused"])
            t["unfused_launch_ms"] = _time_ms(calls["unfused"],
                                              queued=False)
        lib = ("F.rms_norm" if entry == "rmsnorm"
               else "x + r, then F.rms_norm: two calls")
        extra = ("" if "unfused_ms" not in t else
                 f" unfused (x + r, then the kernel) {t['unfused_ms']:.6f} "
                 f"(with host launch {t['unfused_launch_ms']:.6f})")
        print(f"  time  {entry:17s} x [{rows},{D}] {name}: kernel_ms="
              f"{t['ms']:.6f} (with host launch {t['launch_ms']:.6f}) "
              f"plain_ms={t['plain_ms']:.6f} library_ms="
              f"{t['library_ms']:.6f} ({lib}) bound_ms={b_ms:.7f} "
              f"({b_by}){extra}")
        out[entry] = t
    return out


def phase_kernels(cfg, lengths_main, buckets):
    """Kernel vs plain version on the card; returns {name: record}.
    `buckets` are phase 4's prefill lengths, the largest the main shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rmsnorm)
    from repro_torch.kernels.decode_attention import \
        timeline as decode_timeline
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    attn = _attn_specs(cfg)[0]
    D, H, KV, hd = cfg.d_model, attn.n_heads, attn.n_kv, attn.head_dim
    eps = cfg.norm_eps
    scale = 1.0 / math.sqrt(hd)
    S_main = max(buckets)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rec = {}
    # ---- rmsnorm: decode rows (B) and prefill rows (bucket) -------------
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for rows in (MAX_SLOTS, S_main):
            x = randn(rows, D, dtype=dt)
            s = 1.0 + 0.1 * randn(D, dtype=torch.float32)
            errs[(dt, rows)] = _check(
                "rmsnorm", rmsnorm(x, s, eps), reference_rmsnorm(x, s, eps),
                str(dt).split(".")[1], f"[{rows},{D}] {dt}")
    xs = [randn(MAX_SLOTS, D, dtype=torch.bfloat16) for _ in range(8)]
    s = torch.ones(D, device=dev)
    s16 = s.to(torch.bfloat16)
    nbytes = 2 * MAX_SLOTS * D * 2 + D * 4
    b_ms, b_by = _bound_ms(nbytes, 4 * MAX_SLOTS * D, torch.bfloat16)
    rec["rmsnorm"] = dict(
        shape=f"x [{MAX_SLOTS},{D}] bf16 (decode step)",
        max_abs_err=errs[(torch.bfloat16, MAX_SLOTS)],
        ms=_time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xs]),
        launch_ms=_time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xs],
                           queued=False),
        plain_ms=_time_ms([lambda x=x: reference_rmsnorm(x, s, eps)
                           for x in xs]),
        library_ms=_time_ms([lambda x=x: F.rms_norm(x, (D,), s16, eps)
                             for x in xs]),
        bound_ms=b_ms, bound_by=b_by)
    xp = [randn(S_main, D, dtype=torch.bfloat16) for _ in range(4)]
    k_ms = _time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xp])
    p_ms = _time_ms([lambda x=x: reference_rmsnorm(x, s, eps) for x in xp])
    l_ms = _time_ms([lambda x=x: F.rms_norm(x, (D,), s16, eps) for x in xp])
    b_ms = _bound_ms(2 * S_main * D * 2 + D * 4, 4 * S_main * D,
                     torch.bfloat16)[0]
    print(f"  time  rmsnorm           x [{S_main},{D}] bf16 (prefill): "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
          f"bound_ms={b_ms:.5f} (bytes)")
    _rmsnorm_cases(eps)
    _rmsnorm_times(D, eps, MAX_SLOTS)
    _rmsnorm_times(D, eps, S_main)
    _rmsnorm_host_split(D, eps)

    # ---- decode attention: gemma MQA and a GQA case, ragged lengths ------
    ragged = torch.tensor([1, 77, 700, MAX_LEN], dtype=torch.int32,
                          device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for h_, kv_ in ((H, KV), (8, 2)):
            q = randn(MAX_SLOTS, h_, hd, dtype=dt)
            k = randn(MAX_SLOTS, kv_, MAX_LEN, hd, dtype=dt)
            v = randn(MAX_SLOTS, kv_, MAX_LEN, hd, dtype=dt)
            for lens, lab in ((ragged, "ragged"), (lengths_main, "main")):
                errs[(dt, h_, kv_, lab)] = _check(
                    "decode_attention",
                    decode_attention(q, k, v, lens, scale=scale),
                    reference_decode_attention(q, k, v, lens, scale=scale),
                    str(dt).split(".")[1],
                    f"H={h_} KV={kv_} T={MAX_LEN} {lab} {dt}")
    # lengths 0 and past T; unfilled rows NaN in k and inf in v; phase 5's
    # head_dim 32 in f32, 16 and 112 in bf16, and 100, whose rows are not
    # 16-byte multiples (the kernel copies their unaligned ends itself)
    edge = torch.tensor([0, 5, MAX_LEN + 100, 300], dtype=torch.int32,
                        device=dev)
    red = torch.tensor([5, 64, 17, 30], dtype=torch.int32, device=dev)
    for dt, h_, kv_, T_, d_, lens, tail, lab in (
            (torch.float32, H, KV, MAX_LEN, hd, edge, False, "0 and > T"),
            (torch.bfloat16, H, KV, MAX_LEN, hd, edge, False, "0 and > T"),
            (torch.float32, H, KV, MAX_LEN, hd, lengths_main, True,
             "NaN/inf tail"),
            (torch.bfloat16, 8, 2, MAX_LEN, hd, ragged, True, "NaN/inf tail"),
            (torch.float32, 4, 1, 64, 32, red, False, "phase 5 shape"),
            (torch.bfloat16, 8, 2, MAX_LEN, 16, ragged, False, "hd 16"),
            (torch.bfloat16, 8, 2, MAX_LEN, 112, edge, False, "hd 112"),
            (torch.bfloat16, H, KV, MAX_LEN - 1, 100, ragged, False,
             "hd 100")):
        q = randn(MAX_SLOTS, h_, d_, dtype=dt)
        k = randn(MAX_SLOTS, kv_, T_, d_, dtype=dt)
        v = randn(MAX_SLOTS, kv_, T_, d_, dtype=dt)
        if tail:
            unfilled = (torch.arange(T_, device=dev)[None, :]
                        >= lens[:, None])[:, None, :, None]
            k = k.masked_fill(unfilled, float("nan"))
            v = v.masked_fill(unfilled, float("inf"))
        sc = 1.0 / math.sqrt(d_)
        got = decode_attention(q, k, v, lens, scale=sc)
        assert bool(torch.isfinite(got).all()), lab
        _check("decode_attention", got,
               reference_decode_attention(q, k, v, lens, scale=sc),
               str(dt).split(".")[1],
               f"H={h_} KV={kv_} T={T_} hd={d_} {lab} {dt}")
    # the real path reads one layer's cache after another: 18 distinct
    # caches exceed the 50 MB L2
    caches = [(randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16),
               randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16))
              for _ in range(_timed_caches(cfg))]
    q = randn(MAX_SLOTS, H, hd, dtype=torch.bfloat16)
    k, v = caches[0]
    # the same inputs give the same bits; the tickets reset after a call
    # with other lengths, so the next call is right again
    first = decode_attention(q, k, v, lengths_main, scale=scale)
    _check("decode_attention", first,
           reference_decode_attention(q, k, v, lengths_main, scale=scale),
           "bfloat16", "the timed inputs, main lengths bf16")
    assert torch.equal(first, decode_attention(q, k, v, lengths_main,
                                               scale=scale)), "not bitwise"
    decode_attention(q, k, v, edge, scale=scale)
    assert torch.equal(first, decode_attention(q, k, v, lengths_main,
                                               scale=scale)), "tickets"
    print("  check decode_attention  two calls bit-identical; right after a "
          "call with other lengths ok")
    # where a call spends its time, phase by phase (a -DDEC_TIMELINE build)
    _print_timeline(decode_timeline.run(lengths_main.tolist()))
    rec["decode_attention"] = _decode_record(
        q, caches, lengths_main, scale,
        errs[(torch.bfloat16, H, KV, "main")])

    # ---- flash attention: causal prefill, MQA and GQA, ragged S, S < T,
    # and head dims the wrapper pads (16, 32 -> 64 and 112 -> 128 in bf16;
    # 16 -> 32 in f32), the scale from the true head dim ---------------------
    for dt in (torch.float32, torch.bfloat16):
        for h_, kv_, S, T, d_ in ((H, KV, S_main, S_main, hd),
                                  (8, 2, 700, 700, hd), (H, KV, 300, 1023, hd),
                                  (H, KV, 200, 200, 16), (H, KV, 200, 200, 32),
                                  (8, 2, 300, 300, 112)):
            q = randn(1, h_, S, d_, dtype=dt)
            k = randn(1, kv_, T, d_, dtype=dt)
            v = randn(1, kv_, T, d_, dtype=dt)
            sc = 1.0 / math.sqrt(d_)
            errs[(dt, h_, kv_, S, T, d_)] = _check(
                "flash_attention", flash_attention(q, k, v, scale=sc),
                reference_attention(q, k, v, scale=sc),
                str(dt).split(".")[1],
                f"H={h_} KV={kv_} S={S} T={T} hd={d_} {dt}")
        # the prefill's own layout at each of its buckets: q a transposed
        # [B,S,H,hd] projection, k and v the first S rows of a max_len cache
        kc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        vc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        for S in buckets:
            q = randn(1, S, H, hd, dtype=dt).transpose(1, 2)
            _check("flash_attention",
                   flash_attention(q, kc[:, :, :S], vc[:, :, :S],
                                   scale=scale),
                   reference_attention(q, kc[:, :, :S], vc[:, :, :S],
                                       scale=scale),
                   str(dt).split(".")[1], f"strided views S={S} {dt}")
    # checks and times at every prefill bucket of phase 4's prompts
    for S in buckets:
        ins = [(randn(1, H, S, hd, dtype=torch.bfloat16),
                randn(1, KV, S, hd, dtype=torch.bfloat16),
                randn(1, KV, S, hd, dtype=torch.bfloat16))
               for _ in range(4)]
        err = _check("flash_attention", flash_attention(*ins[0], scale=scale),
                     reference_attention(*ins[0], scale=scale), "bfloat16",
                     f"bucket S={S} H={H} KV={KV} hd={hd} bf16")
        r = _flash_record(ins, scale, err)
        if S == S_main:
            rec["flash_attention"] = r
        else:
            _print_record("flash_attention", r)
    for name, r in rec.items():
        _print_record(name, r)
    return rec


# ---------------------------------------------------------------- phase 4
def phase_serving(cfg, prompts):
    """Full-width gemma-2b serving through the kernels and the tiers."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.policy import Tier
    from repro_torch.serving import Request

    params = _native_params(cfg)
    eng, clock = _direct_engine(cfg, params)
    store = eng.store
    _first_step(cfg, params, prompts[0])

    reqs = [Request(rid=f"s{i}", prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts[:N_REQUESTS])]
    extra = [Request(rid=f"s{i}", prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(prompts[N_REQUESTS:N_REQUESTS + 2],
                                   start=N_REQUESTS)]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    assert len(done) == N_REQUESTS and all(
        len(r.generated) == MAX_NEW for r in done), "requests unfinished"
    print(f"  served {len(done)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {toks} tokens in "
          f"{wall:.3f} s = {toks / wall:.1f} tokens/s, {eng.steps} "
          f"decode steps")

    # park two sessions; DRAM holds 1.5 blobs, so the colder goes to flash
    a, b = extra
    eng.admit(a)
    eng.admit(b)
    for _ in range(3):
        eng.step()
    tier_a = eng.pause(a.rid)
    tier_b = eng.pause(b.rid)
    tier_a_now = store.tier_of(("kv", a.rid))
    print(f"  paused {a.rid} -> {tier_a.name}, {b.rid} -> {tier_b.name}; "
          f"{a.rid} now on {tier_a_now.name}")
    assert tier_a_now == Tier.FLASH, "the colder session was not demoted"
    clock.advance(1.2)
    lead = eng.prefetch_lead(a.rid)
    eng.prefetch(a.rid)
    clock.advance(3 * STEP_TIME)
    eng.resume(a.rid)
    eng.resume(b.rid)
    while eng.live.any():
        eng.step()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    flash_st = store.stats[Tier.FLASH]
    # the prefetch-led restore read the blob back from flash
    assert flash_st.demotions >= 1 and flash_st.hits >= 1 \
        and flash_st.prefetch_hits + flash_st.prefetch_late >= 1, flash_st
    assert all(len(r.generated) == MAX_NEW for r in extra)
    peak = torch.cuda.max_memory_allocated()
    print(f"  resumed {a.rid} from FLASH through a prefetch issued 3 steps "
          f"ahead (the p99-sized lead is {lead} steps): "
          f"kv_stall_time={eng.kv_stall_time!r} s; FLASH {flash_st}")
    print(f"  decode steps {eng.steps}; launches {counts}; peak device "
          f"memory {peak / 1e9:.3f} GB")
    counts = {name: counts[name] for name in SERVING_KERNELS}
    for name, n in counts.items():
        assert n > 0, f"{name} kernel never launched on the main path"
    _profile_split(eng, prompts)
    return counts, params


def _native_params(cfg):
    """`cfg` at full width and depth: bf16 weights from SEED, made on the
    card by native init; their count must be the config's published one."""
    import torch
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    assert n_params == PARAMS[cfg.name], n_params
    assert cfg.param_count() == n_params + ANALYTIC_GAP.get(cfg.name, 0), \
        (cfg.param_count(), n_params)
    print(f"  {cfg.name}: {n_params} parameters, bf16, native init in "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def _moe_spec(cfg):
    """`cfg`'s MoE sublayer spec, or None for a dense config."""
    return next((s for _, _, _, s in cfg.sublayers() if s.kind == "moe"),
                None)


@contextlib.contextmanager
def _routes(replay=None, margins=False):
    """Stands in for `repro_torch.models.moe.route`, from outside the
    package, while the block runs: notes each call's expert ids [B,S,K]
    in the list it yields, in call order, with (given `margins`, or
    `replay`) each token's router-logit margin between its k-th and
    (k+1)-th expert. With `replay`, ids noted in an earlier run, each call
    takes the next of them instead of its own top-k, its gates this
    call's own probabilities at those ids, renormalised as `route` does,
    so two paths can be compared on one routing."""
    import torch
    from repro_torch.models import moe
    route = moe.route
    noted = []

    def stand_in(params, x, spec, ctx):
        if replay is None and not margins:
            gates, idx = route(params, x, spec, ctx)
            noted.append((idx, None))
            return gates, idx
        logits = torch.einsum("bsd,de->bse", x, params["router"].to(
            ctx.compute_dtype)).float()
        if replay is None:
            gates, idx = route(params, x, spec, ctx)
        else:
            idx = replay[len(noted)]
            p = torch.softmax(logits, dim=-1).gather(-1, idx)
            if spec.top_k > 1:
                p = p / p.sum(-1, keepdim=True).clamp_min(1e-9)
            gates = p.to(ctx.compute_dtype)
        top = logits.topk(spec.top_k + 1, dim=-1).values
        noted.append((idx, top[..., -2] - top[..., -1]))
        return gates, idx

    moe.route = stand_in
    try:
        yield noted
    finally:
        moe.route = route


def _first_step(cfg, params, prompt, max_len=MAX_LEN, bucket=None):
    """The launches of one prefill and one decode step, and the first
    step's logits through the kernels against the plain path on the same
    bf16 weights, in caches of `max_len` rows, the prompt right-padded to
    `bucket` tokens as the engine pads it (None: not padded). Two bf16
    computations of a deep stack differ by the rounding noise of each, so
    the tolerance is bf16's own error here: twice the plain bf16 path's
    distance from the same path in float32 on the same bf16 weights
    (every weight reaches the compute through `.to(compute_dtype)`, so
    each matrix is float32 only while it is used; bf16 -> float32 is
    exact, so this is the float32 path on a float32 copy, without the
    copy). A config with an encoder prefills on zero frames, as its
    engine does, so both stacks run through the kernels and the plain
    path. Prints the peak device memory of the check. Returns the
    launches per prefill and per decode step.

    Routing is a discrete choice: an MoE config's plain paths replay the
    kernel path's expert ids (`_routes`), so the check holds the kernels'
    arithmetic on one routing. The plain bf16 path then runs again on its
    own routing: the choices that differ from the kernel path's and the
    last token's least routing margin are printed, and the same bound is
    held there only if no choice differs."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.models import model as M

    S = len(prompt)
    # a recurrent config, or one with an encoder, prefills at the exact
    # length, as its engine does
    assert bucket is None or not _exact(cfg), bucket
    tokens = np.zeros(bucket or S, np.int64)
    tokens[:S] = prompt
    p0 = torch.as_tensor(tokens[None], device="cuda")

    def first_logits(weights, dtype, plain):
        cache = M.init_cache(cfg, 1, max_len, dtype, "cuda")
        return M.prefill(weights, cfg, p0, cache, compute_dtype=dtype,
                         last_index=S - 1, plain=plain,
                         frames=_zero_frames(cfg, dtype))[1].float()

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _routes() as noted:
        kern = first_logits(params, torch.bfloat16, False)
    per_prefill = kernels.launch_counts()
    kernels.reset_launch_counts()
    M.decode_step(params, cfg, p0[:, :1], M.init_cache(
        cfg, 1, max_len, torch.bfloat16, "cuda"), 0,
        compute_dtype=torch.bfloat16)
    per_step = kernels.launch_counts()
    print(f"  launches per prefill {per_prefill}, per decode step "
          f"{per_step}")
    assert per_prefill["rmsnorm"] == per_step["rmsnorm"] == _norms(cfg), \
        (per_prefill, per_step)
    ids = [i for i, _ in noted] if _moe_spec(cfg) else None
    with _routes(replay=ids):
        plain = first_logits(params, torch.bfloat16, True)
    with _routes(replay=ids):
        truth = first_logits(params, torch.float32, True)
    peak = torch.cuda.max_memory_allocated()
    err = float((kern - plain).abs().max())
    noise = float((plain - truth).abs().max())
    routing = ("" if ids is None else
               "; the kernel path's routing replayed on the plain paths")
    print(f"  first-step logits [1,{cfg.vocab}] (prompt {S}, tokens "
          f"{len(tokens)}, max_len {max_len}{routing}): kernels vs plain bf16 "
          f"max_abs_err={err:.4e}; plain bf16 vs float32 {noise:.4e}; "
          f"kernels vs float32 {float((kern - truth).abs().max()):.4e}; "
          f"argmax {int(kern.argmax())} / {int(plain.argmax())} / "
          f"{int(truth.argmax())}")
    print(f"  peak device memory in the check {peak / 1e9:.3f} GB "
          f"({held / 1e9:.3f} GB held before it)")
    assert err <= 2 * noise, (err, noise)
    if ids is not None:
        with _routes(margins=True) as own:
            free = first_logits(params, torch.bfloat16, True)
        free_err = float((kern - free).abs().max())
        differ = sum(int((a.sort(-1).values != b.sort(-1).values).sum())
                     for a, (b, _) in zip(ids, own))
        total = sum(a.numel() for a in ids)
        margin = min(float(m[0, S - 1]) for _, m in own)
        print(f"  the plain bf16 path on its own routing: {differ} of "
              f"{total} expert choices differ from the kernel path's; the "
              f"last token's least routing margin over {len(own)} layers "
              f"{margin:.4f}; kernels vs plain bf16 max_abs_err "
              f"{free_err:.4e} (held to {2 * noise:.4e} only when no "
              f"choice differs: {'held' if differ == 0 else 'not held'})")
        if differ == 0:
            assert free_err <= 2 * noise, (free_err, noise)
        del free
    del kern, plain, truth
    torch.cuda.empty_cache()
    return per_prefill, per_step


def _applied(cfg):
    """Every sublayer application of the stack: each spec of the group
    once a group (a shared one too: its one weight set is applied every
    group), then the tail's."""
    for where, _, _, s in cfg.sublayers():
        yield from [s] * (cfg.n_groups if where == "pattern" else 1)


RECURRENT = ("mamba2", "mlstm", "slstm")    # sublayer kinds with state


def _recurrent(cfg) -> bool:
    """A config with recurrent state (Mamba-2, mLSTM, sLSTM): its engine
    prefills at the exact prompt length."""
    return any(s.kind in RECURRENT for _, _, _, s in cfg.sublayers())


def _exact(cfg) -> bool:
    """The engine prefills at the exact prompt length (no power-of-two
    bucket): a recurrent config, or one with an encoder (the reference
    buckets only without one)."""
    return _recurrent(cfg) or cfg.encoder is not None


def _zero_frames(cfg, dtype):
    """The frames the engine prefills a config with an encoder on, zeros
    [1, n_frames, d_model] (the reference engine's), or None."""
    import torch
    if cfg.encoder is None:
        return None
    return torch.zeros((1, cfg.encoder.n_frames, cfg.d_model), dtype=dtype,
                       device="cuda")


def _norms(cfg) -> int:
    """rmsnorm launches a forward: one before each sublayer and the final
    norm (the residual adds run inside them), two (q and k) in each
    attention sublayer with qk-norm, and one in each recurrent sublayer
    (Mamba-2's gated norm and the mLSTM's inner norm on float32 rows of
    d_inner, the sLSTM's on float32 rows of d_model). None under
    LayerNorm (whisper's), whose plain float32 ops no TPU kernel
    computes."""
    if cfg.norm != "rmsnorm":
        return 0
    return sum(1 + 2 * bool(getattr(s, "qk_norm", False))
               + (s.kind in RECURRENT) for s in _applied(cfg)) + 1


def _inner_norms(cfg):
    """(label, width) of each recurrent sublayer kind's inner norm in
    `cfg`, in pattern order, each kind once: float32 rows of that width,
    one a token."""
    seen = {}
    for s in _applied(cfg):
        if s.kind == "mamba2" and s.kind not in seen:
            seen[s.kind] = ("Mamba-2 gated norm", s.expand * cfg.d_model)
        elif s.kind == "mlstm" and s.kind not in seen:
            seen[s.kind] = ("mLSTM inner norm",
                            int(s.proj_factor * cfg.d_model))
        elif s.kind == "slstm" and s.kind not in seen:
            seen[s.kind] = ("sLSTM inner norm", cfg.d_model)
    return list(seen.values())


def _attn_specs(cfg):
    """The attention sublayers' specs of one group, in pattern order."""
    return [s for layer in cfg.pattern for s in layer if s.kind == "attn"]


def _ffn_spec(cfg):
    """The pattern's first FFN or MoE sublayer's spec (None: it has
    neither)."""
    return next((s for layer in cfg.pattern for s in layer
                 if s.kind in ("ffn", "moe")), None)


def _attn_layers(cfg) -> int:
    """Attention applications of the stack, each one flash_attention
    launch a prefill and one decode_attention launch a decode step: a
    group's (two at llama4's, one at every other config's) times its
    groups, with the tail's."""
    return sum(s.kind == "attn" for s in _applied(cfg))


def _enc_attn_layers(cfg) -> int:
    """The encoder's attention applications (none without an encoder):
    one flash_attention launch each a prefill, non-causal."""
    if cfg.encoder is None:
        return 0
    return cfg.encoder.n_groups * sum(
        s.kind == "attn" for layer in cfg.encoder.pattern for s in layer)


def _flash_launches(cfg) -> int:
    """flash_attention launches a prefill: the decoder's attention
    applications (a cross-attention's too) and the encoder's."""
    return _attn_layers(cfg) + _enc_attn_layers(cfg)


def _moe_layers(cfg) -> int:
    """MoE sublayers of the stack: a group's times its groups."""
    return sum(s.kind == "moe" for s in _applied(cfg))


L2_BYTES = 50 * 2 ** 20        # the H100's L2


def _timed_caches(cfg) -> int:
    """Distinct (k, v) caches that decode attention's timing reads in
    turn: one an attention sublayer, and at least enough to pass the L2
    (llama4 at one group has two attention sublayers of 16.8 MB), so
    each call finds its own cold as a layer does behind the layers
    between."""
    attn = _attn_specs(cfg)[0]
    one = 2 * MAX_SLOTS * attn.n_kv * MAX_LEN * attn.head_dim * 2
    return max(_attn_layers(cfg), L2_BYTES // one + 1)


def _timed(fn, *args):
    """fn(*args) and its seconds on the host clock, synchronised."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


PROFILE_PAD = 512              # spin kernels on each side of a profiled call
PAD_CYCLES = 50_000            # each spins ~25 us at 1.98 GHz
PAD_KERNEL = "spin_kernel"     # torch.cuda._sleep's kernel


def _profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activities): (fn's device
    operations from `key_averages()`, fn's wall on the host clock,
    synchronised). Late in a long process a trace loses its first device
    operations, a count of them and not a span of time: 21-25 late in
    the run whether they were a deepseek-7b prefill's own or spin
    kernels of 0.5 us or 0.25 ms, and once a norm of a phase-4 step. So
    PROFILE_PAD spin kernels of PAD_CYCLES each run on each side of fn
    inside the trace, each side synchronised; they are left out of what
    is returned, and the call fails unless the trace kept at least one
    of them on each side, which shows that neither edge of the trace
    reached fn's own operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        wall = _timed(fn)[1]
        pad()
    starts = [(e.time_range.start, PAD_KERNEL in e.name)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    work = [t for t, is_pad in starts if not is_pad]
    pads = [t for t, is_pad in starts if is_pad]
    before = sum(t < min(work) for t in pads) if work else len(pads)
    after = sum(t > max(work) for t in pads) if work else 0
    print(f"  profiler: {before} + {after} of the {PROFILE_PAD} + "
          f"{PROFILE_PAD} pad kernels before + after the call in the trace")
    assert not work or (before and after), \
        f"the trace's window cut into the call ({before}, {after} pads)"
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return [e for e in dev if PAD_KERNEL not in e.key], wall


def _profile_split(eng, prompts):
    """Where a prefill and a decode step spend the card's time: each under
    torch.profiler after a warm-up, with the device operations by time and
    the device-idle share, 1 - kernel time / wall. The profiler slows the
    host, so the share is given against the profiled wall and against the
    same work's wall without the profiler (host clock, synchronised).
    Returns the profiled decode step's device-kernel milliseconds (None
    where the profiler saw no device time). A config without attention
    must show no attention kernel in either."""
    from repro_torch.serving import Request

    def wall(fn):
        return _timed(fn)[1]

    # prompts 0 and 5 fall in bucket 1023, prompt 1 in 256; a recurrent
    # config prefills each at its exact length. The prefill is timed and
    # profiled on one prompt, twice: prompt 5, or prompt 6 (66 tokens) for
    # a config with sLSTM layers, whose prefill is 14 launches a token a
    # layer (~100,000 at 602 tokens, a trace ~25 s to read)
    k = 6 if any(s.kind == "slstm" for s in _applied(eng.cfg)) else 5
    reqs = [Request(rid=f"prof{i}", prompt=prompts[j], max_new=MAX_NEW)
            for i, j in enumerate((0, 1, k, k))]
    pre = (f"prefill, bucket {_bucket(len(prompts[k]), eng.max_len)}"
           if not _exact(eng.cfg) else f"prefill, {len(prompts[k])} tokens")
    eng.admit(reqs[0])                     # warm-up
    eng.admit(reqs[1])
    eng.step()
    plain_pre = wall(lambda: eng.admit(reqs[2]))
    prof_pre, wall_pre = _profiled(lambda: eng.admit(reqs[3]))
    plain_step = sorted(wall(eng.step) for _ in range(5))[2]
    prof_step, wall_step = _profiled(eng.step)
    step_ms = None
    for label, kern, w, w0 in (
            (pre, prof_pre, wall_pre, plain_pre),
            (f"decode step, {MAX_SLOTS} live slots", prof_step, wall_step,
             plain_step)):
        busy = sum(e.self_device_time_total for e in kern) / 1e3   # ms
        if busy == 0:
            print(f"  profile {label}: the profiler saw no device time; "
                  f"device split not measured")
            continue
        print(f"  profile {label}: device kernels {busy:.3f} ms; wall "
              f"{w * 1e3:.3f} ms profiled, {w0 * 1e3:.3f} ms without the "
              f"profiler; device-idle share {1 - busy / (w * 1e3):.3f} "
              f"profiled, {1 - busy / (w0 * 1e3):.3f} without")
        n_rms = sum(e.count for e in kern if "rmsnorm" in e.key)
        print(f"  profile {label}: {sum(e.count for e in kern)} device "
              f"operations, {n_rms} of them rmsnorm kernels")
        assert n_rms == _norms(eng.cfg), n_rms
        if not _attn_layers(eng.cfg):
            assert not any("attention" in e.key for e in kern), \
                [(e.key, e.count) for e in kern if "attention" in e.key]
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            t = e.self_device_time_total / 1e3
            print(f"    {t:9.4f} ms {100 * t / busy:5.1f}% x{e.count:<4d} "
                  f"{e.key[:90]}")
        if label.startswith("decode"):
            step_ms = busy
            if not _attn_layers(eng.cfg):
                continue
            dec = [e for e in kern if "decode_attention" in e.key]
            assert len(dec) == 1 and dec[0].count == _attn_layers(eng.cfg), \
                [(e.key, e.count) for e in dec]
            assert not any("merge" in e.key for e in kern), "merge kernel"
            t = dec[0].self_device_time_total / 1e3
            print(f"  decode step: one decode_attention kernel, "
                  f"{dec[0].count} launches, {t:.4f} ms = "
                  f"{100 * t / busy:.1f}% of device time")
    while eng.live.any():
        eng.step()
    return step_ms


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------- phase 9
def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _slot_bytes(cfg, itemsize, max_len=MAX_LEN) -> int:
    """One slot's cache: every attention application's K and V (a
    cross-attention's of the encoder's n_frames rows) and every
    recurrent sublayer's conv window at `itemsize` bytes an element, and
    each recurrent state in float32 (the cache holds it so in any dtype):
    Mamba-2's [H,N,P], the mLSTM's matrix memory [H,P,P+1], the sLSTM's
    h, c, n and m [H,P]."""
    def sub(s):
        if s.kind == "attn":
            rows = cfg.encoder.n_frames if s.cross else max_len
            return 2 * s.n_kv * rows * s.head_dim * itemsize
        if s.kind == "mamba2":
            d_in = s.expand * cfg.d_model
            return (4 * d_in * s.d_state
                    + itemsize * (s.d_conv - 1)
                    * (d_in + 2 * s.n_groups * s.d_state))
        if s.kind == "mlstm":
            d_in = int(s.proj_factor * cfg.d_model)
            P = d_in // s.n_heads
            return (4 * s.n_heads * P * (P + 1)
                    + itemsize * (s.d_conv - 1) * d_in)
        if s.kind == "slstm":
            return (4 * 4 * cfg.d_model
                    + itemsize * (s.d_conv - 1) * cfg.d_model)
        return 0
    return sum(sub(s) for s in _applied(cfg))


def _blob_bytes(cfg, max_len=MAX_LEN) -> int:
    """A paused session's blob: every cache leaf of one slot (K/V of every
    attention application, every recurrent state and conv window, the
    tail's too), as float32."""
    return _slot_bytes(cfg, 4, max_len)


def _tier_table(cfg, max_len=MAX_LEN) -> dict:
    """The modeled hierarchy of phases 4 and 9, (capacity, bandwidth,
    latency) by tier: the card's HBM (data-sheet size and rate), host
    DRAM that holds 1.5 blobs (of `max_len` positions), so the colder of
    two paused sessions goes to flash, and a Storage-Next SSD."""
    from repro_torch.core import units
    return {"hbm": (80e9, units.H100_HBM_BW, 1e-7),
            "dram": (1.5 * _blob_bytes(cfg, max_len), 45e9, 5e-7),
            "flash": (4e12, 7e9, 2e-5)}


def _direct_engine(cfg, params):
    """A DecodeEngine built by hand on a TieredStore with `_tier_table`'s
    tiers and serve_tiered_kv's static policy (tau_hot 0.05, tau_be 1.0,
    ema_alpha 1.0, 5 ms step); (engine, its clock)."""
    import torch
    from repro_torch.core.policy import Tier, TieringPolicy
    from repro_torch.runtime import TieredStore, TierSpec, VirtualClock
    from repro_torch.serving import DecodeEngine

    specs = {Tier[name.upper()]: TierSpec(*t)
             for name, t in _tier_table(cfg).items()}
    clock = VirtualClock()
    policy = TieringPolicy(tau_hot=0.05, tau_be=1.0, ema_alpha=1.0)
    store = TieredStore(policy, specs=specs, clock=clock)
    return DecodeEngine(cfg, params, max_slots=MAX_SLOTS, max_len=MAX_LEN,
                        policy=policy, store=store, step_time=STEP_TIME,
                        compute_dtype=torch.bfloat16,
                        device="cuda"), clock


def _example_spec(cfg, max_len=MAX_LEN):
    """examples/serve_tiered_kv.py's one-host spec (static tau_hot 0.05 /
    tau_be 1.0 / ema_alpha 1.0, 5 ms step) with `_tier_table`'s tiers."""
    from repro_torch.platform import (HierarchySpec, HostDecl, PolicyDecl,
                                      TierDecl)
    return HierarchySpec(
        hosts=(HostDecl(tiers={name: TierDecl(*t) for name, t in
                               _tier_table(cfg, max_len).items()}),),
        policy=PolicyDecl.static(tau_hot=0.05, tau_be=1.0, ema_alpha=1.0),
        step_time=STEP_TIME)


def _example_flow(eng, clock, prompts):
    """examples/serve_tiered_kv.py's flow at full width: serve phase 4's
    requests, run the example's `tier_sessions` on the first two, then
    the hot one resumes too and both decode to their end. Returns the
    tokens, the tiers (three pauses, then the cold session's before its
    prefetch) and the serving's wall seconds (host clock, synchronised)."""
    import torch
    from repro_torch.examples.serve_tiered_kv import tier_sessions
    from repro_torch.serving import Request

    reqs = [Request(rid=f"s{i}", prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts[:N_REQUESTS])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(done) == N_REQUESTS and all(
        len(r.generated) == MAX_NEW for r in done), "requests unfinished"
    tiers = tier_sessions(eng, clock, done[0], done[1], STEP_TIME)
    eng.resume(done[0].rid)
    while eng.live.any():
        eng.step()
    torch.cuda.synchronize()
    return [r.generated for r in done], [t.name for t in tiers], wall


def _decode_window(eng, prompts, tag: str, new: int = STEADY_NEW) -> float:
    """Decode tokens/s with every slot in use, on the host clock,
    synchronised: MAX_SLOTS requests of `new` tokens are admitted
    (their prefills outside the window), then the timed steps run until
    all finish together."""
    import torch
    from repro_torch.serving import Request

    reqs = [Request(rid=f"{tag}{i}", prompt=p, max_new=new)
            for i, p in enumerate(prompts[:MAX_SLOTS])]
    for r in reqs:
        eng.admit(r)
    assert eng.live.all(), "a slot was left empty"
    before = sum(len(r.generated) for r in reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.live.any():
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(len(r.generated) == new for r in reqs)
    return (sum(len(r.generated) for r in reqs) - before) / wall


def phase_platform(cfg, params, prompts):
    """The declared platform on the card: serve_tiered_kv's one-host spec
    (static tau_hot 0.05 / tau_be 1.0 / ema_alpha 1.0, 5 ms step) with
    phase 4's tiers (DRAM of 1.5 KV blobs) through Platform.compile and
    Platform.engine on phase 4's weights and prompts; the same flow on a
    DecodeEngine built directly on a TieredStore must decode the same
    tokens. Then decode windows with every slot in use on both engines,
    in turns, and a traced kv_session save / think gap / resume. Returns
    the serving kernels' launches in the platform's run."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.policy import Tier
    from repro_torch.platform import ObservabilityDecl, Platform

    t0 = time.perf_counter()
    card = _smi()
    spec = _example_spec(cfg)
    platform = Platform.compile(spec, device="cuda")
    eng = platform.engine(cfg, params, max_slots=MAX_SLOTS,
                          max_len=MAX_LEN, compute_dtype=torch.bfloat16)
    assert eng.device.type == "cuda" and eng.store.fabric is platform.fabric
    print(f"  spec {spec.to_json()}")

    kernels.reset_launch_counts()
    tokens, tier_names, wall = _example_flow(eng, platform.clock, prompts)
    counts = kernels.launch_counts()
    counts = {name: counts[name] for name in SERVING_KERNELS}
    cold = tier_names[-1]
    print(f"  platform engine: served {N_REQUESTS} requests, "
          f"{N_REQUESTS * MAX_NEW} tokens, in {wall:.3f} s (host clock, "
          f"synchronised; too short a window for a rate) [{card}]")
    print(f"  paused tiers {tier_names[:3]}; cold session on {cold} "
          f"before its prefetch; kv_stall_time={eng.kv_stall_time!r} s "
          f"[{card}]; launches {counts}")
    for name, n in counts.items():
        assert n > 0, f"{name} kernel never launched through Platform.engine"
    assert cold == Tier.FLASH.name, "the cold session's blob did not " \
        "reach FLASH"

    direct, clock = _direct_engine(cfg, params)
    d_tokens, d_tiers, _ = _example_flow(direct, clock, prompts)
    print(f"  direct engine: paused tiers {d_tiers[:3]}; "
          f"kv_stall_time={direct.kv_stall_time!r} s")
    assert tokens == d_tokens, "the platform's engine decoded other tokens"
    assert tier_names == d_tiers
    assert eng.kv_stall_time == direct.kv_stall_time
    print(f"  tokens of the platform's engine == the direct engine's "
          f"({sum(map(len, tokens))} tokens, {len(tokens)} sessions)")

    # decode windows with every slot in use, in turns: a host-bound step
    # moves between runs of the same code, so each engine gets three
    turns = [("platform", eng), ("direct", direct), ("direct", direct),
             ("platform", eng), ("platform", eng), ("direct", direct)]
    tps = [(name, _decode_window(e, prompts, f"w{i}-"))
           for i, (name, e) in enumerate(turns)]
    print(f"  decode windows, {MAX_SLOTS} slots live for "
          f"{STEADY_NEW - 1} steps each, tokens/s (host clock, "
          f"synchronised) [{card}]: "
          + ", ".join(f"{n} {t!r}" for n, t in tps))
    for name in ("platform", "direct"):
        got = sorted(t for n, t in tps if n == name)
        print(f"  {name}: median {got[1]!r} tokens/s, range {got[0]!r} - "
              f"{got[-1]!r} over {len(got)} windows [{card}]")
    print(f"  platform.report() [{card}]:")
    print("\n".join("    " + ln for ln in platform.report().splitlines()))
    print(f"  eng.store.runtime.report() [{card}]:")
    print("\n".join("    " + ln
                    for ln in eng.store.runtime.report().splitlines()))
    del eng, direct
    torch.cuda.empty_cache()

    # quickstart section 6 on the card: a traced save, think gap, resume
    traced = Platform.compile(dataclasses.replace(
        spec, observability=ObservabilityDecl(trace=True)), device="cuda")
    sess = traced.kv_session("user-42")
    sess.save(np.zeros(_blob_bytes(cfg) // 4, np.float32))
    traced.clock.advance(5.0)
    sess.resume()
    led = traced.ledger.as_dict()
    parts = sum(v for k, v in led.items() if k not in ("total", "tenants"))
    chrome = traced.tracer.to_chrome_json()
    assert led["total"] > 0 and abs(parts - led["total"]) <= \
        1e-12 * led["total"], led
    assert len(traced.tracer) > 0 and '"traceEvents"' in chrome
    print(f"  traced session: ledger total {led['total']!r} s == sum of "
          f"its components; {len(traced.tracer)} trace events, "
          f"{len(chrome)} bytes of Perfetto JSON")
    print(f"  phase 9 wall {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------- phase 10
DRAM_BLOBS = 4                 # phase 10's host DRAM, in paused-KV blobs
PAUSE_IDLE_STEPS = 8
WORKLOAD_RUNS = 2             # phase 10's full-width runs, compared


def _workload_spec(cfg, tenants=("premium", "rag", "scan"), n_sessions=None,
                   horizon=256):
    """Phase 10's declared platform: `_tier_table`'s host with DRAM of
    DRAM_BLOBS blobs, the economic policy priced at one blob, a 5 ms
    modeled step, the scheduler's knobs and three tenants in the
    reference pack's shapes (tests/test_workload.py) at the lengths users
    send. `tenants`, `n_sessions` and `horizon` cut it for the reduced
    model's check."""
    from repro_torch.platform import (ArrivalDecl, HierarchySpec, HostDecl,
                                      PolicyDecl, SchedulerDecl,
                                      SessionShapeDecl, SloDecl, TenantDecl,
                                      TierDecl, WorkloadDecl)
    blob = _blob_bytes(cfg)
    tiers = dict(_tier_table(cfg), dram=(DRAM_BLOBS * blob, 45e9, 5e-7))
    pack = {
        "premium": TenantDecl(
            name="premium", n_sessions=8,
            session=SessionShapeDecl.chat(prompt_len=384,
                                          tokens_per_turn=48,
                                          gap_steps=24),
            arrival=ArrivalDecl(kind="flash_crowd", peak_step=32,
                                burst_len=16),
            slo=SloDecl(deadline_steps=4, alpha_stall=4.0)),
        "rag": TenantDecl(
            name="rag", n_sessions=4,
            session=SessionShapeDecl.rag(prompt_len=640,
                                         tokens_per_turn=64, gap_steps=48),
            arrival=ArrivalDecl(kind="diurnal", period=96)),
        "scan": TenantDecl(
            name="scan", n_sessions=8,
            session=SessionShapeDecl.scan(prompt_len=128,
                                          tokens_per_turn=8),
            arrival=ArrivalDecl(kind="scan_flood", period=48,
                                burst_len=8)),
    }
    chosen = tuple(pack[t] if n_sessions is None else
                   dataclasses.replace(pack[t], n_sessions=n_sessions)
                   for t in tenants)
    return HierarchySpec(
        hosts=(HostDecl(tiers={name: TierDecl(*t)
                               for name, t in tiers.items()}),),
        policy=PolicyDecl.economic(l_blk=blob), step_time=STEP_TIME,
        scheduler=SchedulerDecl(pause_idle_steps=PAUSE_IDLE_STEPS,
                                prefetch_lead="p99"),
        workload=WorkloadDecl(tenants=chosen, horizon_steps=horizon,
                              seed=SEED, isolation="per-tenant"))


ENGINE_CALLS = ("step", "admit", "pause", "resume", "prefetch")


def _serve_workload(cfg, params, spec, *, device="cuda", dtype=None):
    """One run of the declared workload: a fresh Platform.compile (outside
    the timing), Platform.scheduler, run(Platform.jobs()). Returns the
    platform, the scheduler, the jobs, the report, the run's wall seconds
    (host clock, synchronised), the seconds inside each engine call the
    scheduler makes (ENGINE_CALLS; decode steps, admissions with their
    prefills, pauses, resumes, prefetches; each synchronised) and the
    tier the gate gave every pause."""
    import torch
    from repro_torch.platform import Platform

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    platform = Platform.compile(spec, device=device)
    sched = platform.scheduler(
        cfg, params, max_slots=MAX_SLOTS, max_len=MAX_LEN,
        compute_dtype=dtype if dtype is not None else torch.float32)
    jobs = platform.jobs(vocab=cfg.vocab)
    for j in jobs:
        assert len(j.prompt) + j.total() < MAX_LEN, (j.sid, len(j.prompt),
                                                     j.total())
    eng = sched.engine
    split = dict.fromkeys(ENGINE_CALLS, 0.0)
    tiers = []

    def timed(name, fn):
        def call(*args):
            sync()
            t = time.perf_counter()
            out = fn(*args)
            sync()
            split[name] += time.perf_counter() - t
            if name == "pause":
                tiers.append(out.name)
            return out
        return call

    for name in ENGINE_CALLS:
        setattr(eng, name, timed(name, getattr(eng, name)))
    sync()
    t0 = time.perf_counter()
    report = sched.run(jobs)
    sync()
    wall = time.perf_counter() - t0
    for name in ENGINE_CALLS:
        delattr(eng, name)
    return platform, sched, jobs, report, wall, split, tiers


def _profile_step(step, card):
    """The device-idle share of one decode step (`step`, called once)
    with every slot decoding, under torch.profiler, as `_profile_split`
    measures phase 4's."""
    kern, wall = _profiled(step)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy == 0:
        print(f"  profile of a decode step inside the run: the profiler saw "
              f"no device time; device-idle share not measured [{card}]")
        return None
    print(f"  profile of a decode step inside the run, {MAX_SLOTS} slots "
          f"decoding: device kernels {busy:.3f} ms in {wall * 1e3:.3f} ms "
          f"(profiled wall); device-idle share {1 - busy / (wall * 1e3):.3f}"
          f" profiled; {sum(e.count for e in kern)} device operations "
          f"[{card}]")
    return busy


def _workload_report(platform, sched, report, tiers, card):
    """Hold a workload run's stall ledger to its report (the reference's
    tests/test_workload.py conservation) and print where its pauses went,
    the report, the tenants' cells, the ledger and the compiled tau_be by
    tenant. Returns (tau_be by tenant, the host's DRAM and FLASH stats)."""
    from repro_torch.core.policy import Tier

    led = sched.stall_ledger()
    rhs = report["kv_stall"] + STEP_TIME * report["slot_idle_steps"]
    assert abs(led["total"] - rhs) <= 1e-9 * max(rhs, 1e-30), (led, rhs)
    tenant_slice = sum(c["ledger_stall"]
                       for c in report["tenants"].values())
    assert tenant_slice <= led["total"] - led["scheduler_idle"] + 1e-12, \
        (tenant_slice, led)
    taus = platform.policy(0).class_tau_be
    host = platform.fabric.hosts[0]
    dram, flash = host.stats[Tier.DRAM], host.stats[Tier.FLASH]
    print(f"  pauses by the tier the gate gave them: "
          f"{ {t: tiers.count(t) for t in sorted(set(tiers))} }; store "
          f"DRAM {dram}; FLASH {flash}")
    keys = ("tokens", "ticks", "decode_steps", "slot_idle_steps",
            "admissions", "parks", "unparks", "pauses", "preempt_pauses",
            "resumes", "prefetches", "deadline_misses", "kv_stall",
            "per_token_stall", "makespan", "tokens_per_sec")
    print(f"  report() [{card}]: " + ", ".join(
        f"{k} {report[k]!r}" for k in keys) + " (kv_stall, per_token_stall"
        ", makespan and tokens_per_sec are modeled: virtual clock, "
        f"{STEP_TIME} s a step)")
    print(f"  tenant_report() [{card}]: "
          f"{json.dumps(sched.tenant_report(), sort_keys=True)}")
    print(f"  stall_ledger() [{card}]: {json.dumps(led, sort_keys=True)}")
    print(f"  compiled tau_be by tenant [{card}]: "
          f"{json.dumps(taus, sort_keys=True)}")
    return taus, dram, flash


def _print_split(label, report, wall, split):
    """A workload run's wall split into the engine calls the scheduler
    made (`_serve_workload`'s split) and the scheduler's own Python."""
    calls = {"step": report["decode_steps"], "admit": report["admissions"],
             "pause": report["pauses"], "resume": report["resumes"],
             "prefetch": report["prefetches"]}
    print(f"    {label}: " + ", ".join(
        f"{name} {split[name]!r} s ({calls[name]} calls)"
        for name in ENGINE_CALLS)
        + f"; the scheduler's own Python {wall - sum(split.values())!r} s")


def _tokens(jobs):
    return {j.sid: list(j.request.generated) for j in jobs}


def phase_workload(cfg, params):
    """Continuous batching over a declared workload on the card: three
    tenants (premium chat, RAG, scan) of 20 sessions through
    Platform.compile -> Platform.scheduler -> run(Platform.jobs()) on
    phase 4's full-width bf16 weights, twice on fresh platforms
    (equal tokens and reports), against the lock-step gang (equal
    tokens), with the stall ledger conserved, pauses on both DRAM and
    flash and premium's tau_be above scan's; then the reduced model's
    report on the card and on the CPU, byte for byte. Returns the
    launches of the phase's runs."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.platform import Platform
    from repro_torch.serving import compare_scheduling

    t_phase = time.perf_counter()
    card = _smi()
    spec = _workload_spec(cfg)
    print(f"  spec {spec.to_json()}")
    blob = _blob_bytes(cfg)
    print(f"  blob {blob} B; DRAM {DRAM_BLOBS} blobs; MAX_SLOTS "
          f"{MAX_SLOTS}, MAX_LEN {MAX_LEN}")

    kernels.reset_launch_counts()
    runs = [_serve_workload(cfg, params, spec, dtype=torch.bfloat16)
            for _ in range(WORKLOAD_RUNS)]
    counts = kernels.launch_counts()
    platform, sched, jobs, report, _, _, tiers = runs[0]
    for other in runs[1:]:
        assert _tokens(other[2]) == _tokens(jobs), "a run decoded other tokens"
        assert json.dumps(other[3], sort_keys=True) == json.dumps(
            report, sort_keys=True), "a run's report differs"
        assert other[6] == tiers, "a run paused to other tiers"
    print(f"  {WORKLOAD_RUNS} runs on fresh platforms: equal tokens for "
          f"all {len(jobs)} sessions, equal report() and pause tiers")

    taus, dram, flash = _workload_report(platform, sched, report, tiers,
                                         card)
    assert taus["premium"] > taus["scan"], taus
    # both tiers hold paused blobs: the gate admits a pause to DRAM or
    # sends it to flash, and DRAM's capacity demotes the coldest to flash
    assert dram.bytes_written >= blob and flash.bytes_written >= blob, \
        (dram, flash)
    for k in ("pauses", "resumes", "prefetches"):
        assert report[k] > 0, (k, report[k])
    for name in ("rmsnorm", "decode_attention", "flash_attention",
                 "reuse_sketch"):
        assert counts[name] > 0, f"{name} never launched in phase 10"
    walls = [r[4] for r in runs]
    print(f"  wall of each run (host clock, synchronised, Platform.compile "
          f"outside) [{card}]: {walls!r} s; range {min(walls)!r} - "
          f"{max(walls)!r} s")
    for i, r in enumerate(runs):
        _print_split(f"run {i + 1}", report, r[4], r[5])

    # continuous batching against the lock-step gang: equal tokens; the
    # continuous arm's first decode step with every slot decoding (past
    # the first few) runs under the profiler, and the arm's other
    # full-grid steps are timed without it
    profiled, full_grid, made, made_jobs = [], [], [], []

    def engine():
        p = Platform.compile(spec, device="cuda")
        eng = p.engine(cfg, params, max_slots=MAX_SLOTS, max_len=MAX_LEN,
                       compute_dtype=torch.bfloat16)
        if not made:
            step = eng.step

            def watched():
                if eng.steps < 4 or not (eng.live & eng.active).all():
                    step()
                elif not profiled:
                    profiled.append(_profile_step(step, card))
                else:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    full_grid.append(time.perf_counter() - t)
            eng.step = watched
        made.append(p)
        return eng

    def job_list():
        made_jobs.append(platform.jobs(vocab=cfg.vocab))
        return made_jobs[-1]

    cell = compare_scheduling(engine, job_list,
                              pause_idle_steps=PAUSE_IDLE_STEPS)
    cont, lock = cell["continuous"], cell["lockstep"]
    assert cell["tokens_identical"], ("continuous and lock-step tokens "
                                      "differ", cell["token_mismatches"])
    assert _tokens(made_jobs[0]) == _tokens(jobs)
    assert profiled and full_grid, "no decode step ran with every slot " \
        "decoding"
    if profiled[0] is not None:
        med = sorted(full_grid)[len(full_grid) // 2] * 1e3
        print(f"  device-idle share of that step against the median wall of "
              f"the arm's {len(full_grid)} other full-grid steps without "
              f"the profiler ({med:.3f} ms, host clock, synchronised): "
              f"{1 - profiled[0] / med:.3f} [{card}]")
    print(f"  continuous vs lock-step [{card}]: tokens identical; "
          f"per_token_stall {cont['per_token_stall']!r} vs "
          f"{lock['per_token_stall']!r} s (modeled); slot_idle_steps "
          f"{cont['slot_idle_steps']} vs {lock['slot_idle_steps']}; "
          f"ticks {cont['ticks']} vs {lock['ticks']}; tokens_per_sec "
          f"{cont['tokens_per_sec']!r} vs {lock['tokens_per_sec']!r} "
          f"(modeled)")

    # the reduced model on one set of weights, made on the CPU and copied
    # to the card (native init draws from each device's own generator):
    # the report is modeled, so the card cannot change it, and the greedy
    # tokens of the kernels (card) and the plain versions (CPU) agree
    small = get_config(cfg.name, reduced=True)
    rspec = _workload_spec(small, tenants=("premium", "scan"),
                           n_sessions=3, horizon=64)
    rp = M.init_params(small, SEED, device="cpu")
    weights = {"cpu": rp, "cuda": _map(rp, lambda t: t.to("cuda"))}
    got, toks = {}, {}
    for dev in ("cuda", "cpu"):
        run = _serve_workload(small, weights[dev], rspec, device=dev)
        got[dev] = json.dumps(run[3], sort_keys=True)
        toks[dev] = _tokens(run[2])
    assert got["cuda"] == got["cpu"], (got["cuda"], got["cpu"])
    assert toks["cuda"] == toks["cpu"], "reduced workload: tokens differ"
    n_tok = sum(len(t) for t in toks["cpu"].values())
    assert all(toks["cpu"].values()), "a reduced session decoded nothing"
    print(f"  reduced {cfg.name} f32 (seed-{SEED} weights made on the CPU, "
          f"copied to the card), premium + scan x 3 sessions: the report's "
          f"JSON ({len(got['cpu'])} bytes) and every session's tokens "
          f"({len(toks['cpu'])} sessions, {n_tok} tokens) are identical on "
          f"the card (kernels) and the CPU (plain versions)")
    del rp, weights
    print(f"  phase 10 wall {time.perf_counter() - t_phase:.1f} s")
    return {name: counts[name] for name in
            SERVING_KERNELS + ("reuse_sketch",)}


# ---------------------------------------------------------------- phase 5
def phase_reduced(rng):
    """Reduced gemma-2b in float32: engine (kernels) vs plain greedy."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import DecodeEngine, Request

    cfg = get_config("gemma-2b", reduced=True)
    params = M.init_params(cfg, SEED, device="cuda")
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in (5, 9, 17, 30)]
    eng = DecodeEngine(cfg, params, max_slots=2, max_len=64,
                       device="cuda")
    reqs = [Request(rid=f"r{i}", prompt=p, max_new=8)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for req in reqs:
        cache = M.init_cache(cfg, 1, 64, torch.float32, "cuda")
        tok = torch.as_tensor(req.prompt[None].astype(np.int64),
                              device="cuda")
        cache, logits = M.prefill(params, cfg, tok, cache,
                                  compute_dtype=torch.float32, plain=True)
        out = [int(logits[0].argmax())]
        pos = len(req.prompt)
        while len(out) < req.max_new:
            cache, logits = M.decode_step(
                params, cfg, torch.tensor([[out[-1]]], device="cuda"),
                cache, pos, compute_dtype=torch.float32, plain=True)
            out.append(int(logits[0].argmax()))
            pos += 1
        assert req.generated == out, (req.rid, req.generated, out)
    print(f"  reduced gemma-2b f32: {len(reqs)} requests, kernel-path "
          f"greedy tokens == plain-path greedy tokens")


# ---------------------------------------------------------------- phase 6
def _fill_table(n_buckets, slots, keys, vals):
    """Fixture: place keys [n] (distinct, on the card) each into the first
    free slot of its bucket h1, else of h2, in key order, vectorised by
    bucket; keys that find neither full bucket free stay out. Returns
    (bucket_keys, bucket_vals [n_buckets, slots] int32, placed [n] bool)."""
    import torch
    from repro_torch.kernels.cuckoo_probe import hash_pair

    dev = keys.device
    tk = torch.zeros(n_buckets * slots, dtype=torch.int32, device=dev)
    tv = torch.zeros_like(tk)
    fill = torch.zeros(n_buckets, dtype=torch.int64, device=dev)
    placed = torch.zeros(len(keys), dtype=torch.bool, device=dev)
    for b in hash_pair(keys, n_buckets):
        idx = (~placed).nonzero().squeeze(1)
        bb, order = torch.sort(b[idx].long(), stable=True)
        idx = idx[order]
        rank = torch.arange(len(bb), device=dev) - torch.searchsorted(bb, bb)
        slot = fill[bb] + rank
        ok = slot < slots
        at = bb[ok] * slots + slot[ok]
        tk[at] = keys[idx[ok]]
        tv[at] = vals[idx[ok]]
        placed[idx[ok]] = True
        fill += torch.bincount(bb[ok], minlength=n_buckets)
    return tk.view(n_buckets, slots), tv.view(n_buckets, slots), placed


def _kv_demo():
    """examples/kvstore_demo.py's scenario on the card: returns (the timed
    store, its inner store, 4096 probe keys, all stored)."""
    import numpy as np
    from repro_torch.kvstore import TimedCuckooStore

    timed = TimedCuckooStore(KV_DEMO_BUCKETS, slots=KV_SLOTS,
                             dram_cache_items=1024, wal_limit=128,
                             device="cuda")
    store = timed.inner
    rng = np.random.default_rng(SEED)
    n = int(KV_DEMO_BUCKETS * KV_SLOTS * KV_LOAD)
    keys = rng.choice(np.arange(1, 10**8), size=n, replace=False)
    for k in keys:
        store.put(int(k), int(k) % 99991)
    store.flush()
    return timed, store, keys[rng.integers(0, n, 4096)].astype(np.int32)


def _kv_table(n_buckets, gen):
    """A table of n_buckets x KV_SLOTS on the card filled to ~KV_LOAD, and
    four sets of KV_PROBES probes, half stored and half absent. Returns
    (bucket_keys, bucket_vals [n_buckets, KV_SLOTS] contiguous, the stored
    keys, the probe sets)."""
    import torch
    dev = torch.device("cuda")
    n_fill = int(n_buckets * KV_SLOTS * KV_LOAD)
    half = KV_PROBES // 2
    pool = torch.unique(torch.randint(
        1, 2**31 - 1, (n_fill + max(n_fill // 8, 2 * half),), generator=gen,
        device=dev))
    pool = pool[torch.randperm(len(pool), generator=gen, device=dev)]
    assert len(pool) >= n_fill + half
    cand, absent = pool[:n_fill], pool[n_fill:n_fill + half]
    cand_vals = (cand * 2654435761 % 2**31).to(torch.int32)
    bk, bv, placed = _fill_table(n_buckets, KV_SLOTS, cand.to(torch.int32),
                                 cand_vals)
    stored = cand[placed]
    assert len(stored) >= half
    probes = []
    for _ in range(4):       # distinct probe sets for timing; set 0 checked
        sel = stored[torch.randperm(len(stored), generator=gen,
                                    device=dev)[:half]]
        p = torch.cat([sel, absent]).to(torch.int32)
        probes.append(p[torch.randperm(len(p), generator=gen, device=dev)])
    return bk, bv, stored, probes


def _probe_rows(bk, probes):
    """The rows the probes' lookups touch: both buckets' key rows, the
    value row of the bucket that hit, of each found key, the number of
    bucket rows the kernel reads (bucket 2 only after a miss in bucket
    1), and the number of distinct key rows the function needs (bucket
    1's of every lookup, bucket 2's of those that bucket 1 missed)."""
    import torch
    from repro_torch.kernels.cuckoo_probe import hash_pair
    out = []
    for p in probes:
        b1, b2 = hash_pair(p, bk.shape[0])
        in1 = (bk[b1.long()] == p[:, None]).any(1)
        in2 = (bk[b2.long()] == p[:, None]).any(1)
        out.append((torch.cat([b1, b2]).long(),
                    torch.where(in1, b1, b2)[in1 | in2].long(),
                    len(p) + int((~in1).sum()),
                    int(torch.unique(torch.cat([b1, b2[~in1]])).numel())))
    return out


def _probe_bound(bk, probe):
    """The least time the card could take for one batch of lookups: the
    bytes the function must move over the memory rate — each probed key,
    each key row it needs once (bucket 2's only where bucket 1 missed: a
    hit there decides both outputs), each hit's value, and found + value
    out. Returns (bound_ms, bound_by, key rows needed, bytes)."""
    import torch
    _, hits, _, rows = _probe_rows(bk, [probe])[0]
    n = len(probe)
    nbytes = n * 4 + rows * bk.shape[1] * 4 + len(hits) * 4 + n * 8
    return _bound_ms(nbytes, 0, torch.int32) + (rows, nbytes)


def _bytes_at(b_ms, in_l2: bool, nbytes: int = 0) -> str:
    """`_probe_bound`'s time, named for what it is: a bound where the
    table is read from HBM; for a table the timing loop keeps in L2 the
    needed bytes at HBM rate, which bound nothing, beside the bound those
    bytes give at the L2 read rate `_l2_read_rate` measured (the H100's
    published peak rates give no L2 rate)."""
    if in_l2:
        l2_ms = nbytes / _L2_RATE[0] * 1e3
        return (f"needed bytes at HBM rate {b_ms:.6f} ms (not a bound: "
                f"the table stays in L2); bound {l2_ms:.6f} ms at the L2 "
                f"read rate {_L2_RATE[0] / 1e12:.3f} TB/s")
    return f"bound {b_ms:.6f} ms"


L2_READ_BYTES = 32 << 20       # the buffer `_l2_read_rate` reads from L2
_L2_RATE = []                  # bytes/s, measured at phase 6's start


def _l2_read_rate() -> float:
    """The card's rate for one read of a buffer held in L2: a 32 MiB
    float32 buffer summed by one torch.sum, 200 times in a row (the
    buffer stays in the 50 MB L2 after the first), timed by CUDA events
    behind a spin kernel (`_time_ms`)."""
    import torch
    buf = torch.ones(L2_READ_BYTES // 4, device="cuda")
    ms = _time_ms([lambda: torch.sum(buf)], iters=200)
    rate = L2_READ_BYTES / (ms / 1e3)
    print(f"  time  L2 read: torch.sum of a {L2_READ_BYTES >> 20} MiB "
          f"float32 buffer held in L2 {ms:.6f} ms, {rate / 1e12:.3f} TB/s "
          f"[{_smi()}]")
    return rate


def _probe_times(bk, bv, probes, label, in_l2=False):
    """The kernel on the two layouts (one [n_buckets, 2 * slots] table, as
    the store keeps it, and two arrays) and, for the same random rows,
    torch.index_select of both buckets' key rows and of the hits' value
    rows: a gather, not the same function, and no library_ms."""
    import torch
    from repro_torch.kernels.cuckoo_probe import cuckoo_probe
    t = torch.cat([bk, bv], 1)
    joint = (t[:, :KV_SLOTS], t[:, KV_SLOTS:])
    rows = _probe_rows(bk, probes)
    ms = {
        "one row a bucket": _time_ms(
            [lambda p=p: cuckoo_probe(p, *joint) for p in probes]),
        "two arrays": _time_ms(
            [lambda p=p: cuckoo_probe(p, bk, bv) for p in probes]),
        "index_select key rows": _time_ms(
            [lambda r=r: torch.index_select(bk, 0, r[0]) for r in rows]),
        "index_select value rows": _time_ms(
            [lambda r=r: torch.index_select(bv, 0, r[1]) for r in rows])}
    n_rows, n_hits = len(rows[0][0]), len(rows[0][1])
    reads = sum(r[2] for r in rows) / len(rows)
    b_ms, _, b_rows, b_bytes = _probe_bound(bk, probes[0])
    print(f"  time  cuckoo_probe {label}: kernel, one row a bucket "
          f"{ms['one row a bucket']:.6f} ms, two arrays "
          f"{ms['two arrays']:.6f} ms; it reads "
          f"{reads / len(probes[0]):.4f} bucket rows a lookup, "
          f"{reads / ms['one row a bucket'] / 1e6:.2f} G rows/s; "
          f"index_select of {n_rows} key rows "
          f"({n_rows * KV_SLOTS * 4 / 2**20:.0f} MiB written) "
          f"{ms['index_select key rows']:.6f} ms, of {n_hits} value rows "
          f"({n_hits * KV_SLOTS * 4 / 2**20:.0f} MiB written) "
          f"{ms['index_select value rows']:.6f} ms; "
          f"{_bytes_at(b_ms, in_l2, b_bytes)} ({b_rows} distinct key rows "
          f"needed, {b_bytes} bytes)")
    return ms


def _probe_edges():
    """The kernel bit for bit (torch.equal) against its plain version on
    every path: slots 4, 8 and 16 (vector) and 5 (scalar); two arrays,
    one table of both (the store's) and that table at a 4-byte offset
    (scalar); N = 0, 1, 255-257, one group and +-1, 4096; n_buckets = 1
    (h1 == h2); negative keys and values; the tests' hand-made table (a
    key in both buckets, a duplicate hit, key 0, the int32 wrap); the
    launch plan the card takes against ops.launch_plan. Returns the
    number of cases."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cuckoo_probe import (cuckoo_probe, hash_pair,
                                                  ops as probe_ops,
                                                  reference_cuckoo_probe)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def layouts(tk, tv):
        nb, s = tk.shape
        t = torch.cat([tk, tv], 1)
        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        off = flat[1:].view(nb, 2 * s)
        off.copy_(t)
        return {"two arrays": (tk, tv), "one table": (t[:, :s], t[:, s:]),
                "4-byte offset": (off[:, :s], off[:, s:])}

    def aligned(*ts):
        return all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                   for t in ts)

    n_cases = 0

    def case(label, keys, bk, bv):
        nonlocal n_cases
        f, v = cuckoo_probe(keys, bk, bv)
        rf, rv = reference_cuckoo_probe(keys, *hash_pair(keys, bk.shape[0]),
                                        bk, bv)
        assert torch.equal(f, rf) and torch.equal(v, rv), \
            f"cuckoo_probe {label}: kernel != plain"
        n_cases += 1
        return f, v

    def rand_i32(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    paths = set()
    for slots in (4, 5, 8, 16):
        nb = 4096
        pool = torch.unique(rand_i32(2 * nb * slots))
        pool = pool[pool != 0]
        pool = pool[torch.randperm(len(pool), generator=gen, device=dev)]
        n_fill = int(nb * slots * KV_LOAD)
        tk, tv, placed = _fill_table(nb, slots, pool[:n_fill],
                                     rand_i32(n_fill))
        stored = pool[:n_fill][placed]
        probe = torch.cat([stored[:2048], pool[n_fill:n_fill + 2047],
                           torch.zeros(1, dtype=torch.int32, device=dev)])
        probe = probe[torch.randperm(len(probe), generator=gen, device=dev)]
        assert (probe < 0).any() and len(probe) == 4096
        for name, (bk, bv) in layouts(tk, tv).items():
            plan = probe_ops.launch_plan(len(probe), slots, n_sm,
                                         aligned(bk, bv))
            assert (plan["path"] == "scalar") == (
                slots == 5 or name == "4-byte offset"), (slots, name, plan)
            paths.add(plan["path"])
            g = plan["lookups"] * plan["threads"]
            for n in sorted({0, 1, 255, 256, 257, g - 1, g, g + 1, 4096}):
                case(f"slots {slots}, {name}, N {n}", probe[:n], bk, bv)
        # one bucket: h1 == h2 == 0
        row = torch.zeros(1, slots, dtype=torch.int32, device=dev)
        row[0, :3] = torch.tensor([7, -9, -9], device=dev)
        rowv = torch.zeros_like(row)
        rowv[0, :3] = torch.tensor([70, 2**31 - 1, 5], device=dev)
        one = torch.tensor([7, -9, 0, 8, -2**31], dtype=torch.int32,
                           device=dev)
        for name, (bk, bv) in layouts(row, rowv).items():
            f, v = case(f"slots {slots}, {name}, one bucket", one, bk, bv)
            assert f.tolist() == [1, 1, 1, 0, 0]
            assert v.tolist()[:3] == [70, -2**31 + 4, 0]
    assert paths == {"vector", "scalar"}

    # the tests' hand-made table (tests/test_torch_case_studies.py)
    nb, slots = 16, 4
    b1, b2 = (h.tolist() for h in hash_pair(
        torch.arange(1, 200, dtype=torch.int32, device=dev), nb))
    both = next(k for k in range(1, 200) if b1[k - 1] != b2[k - 1])
    dup = next(k for k in range(1, 200) if k != both
               and b1[k - 1] not in (b1[both - 1], b2[both - 1]))
    hk = torch.zeros(nb, slots, dtype=torch.int32, device=dev)
    hv = torch.zeros_like(hk)
    hk[b1[both - 1], 0], hv[b1[both - 1], 0] = both, 11
    hk[b2[both - 1], 1], hv[b2[both - 1], 1] = both, 22
    hk[b1[dup - 1], 2:4] = dup
    hv[b1[dup - 1], 2:4] = torch.tensor([5, 7], device=dev)
    hand = torch.tensor([both, dup, 0, 12345], dtype=torch.int32,
                        device=dev)
    for name, (bk, bv) in layouts(hk, hv).items():
        f, v = case(f"hand-made table, {name}", hand, bk, bv)
        assert f.tolist() == [1, 1, 1, 0] and v.tolist() == [11, 12, 0, 0]
    hv[b1[dup - 1], 2:4] = torch.tensor([2**31 - 1, 2**31 - 2], device=dev)
    for name, (bk, bv) in layouts(hk, hv).items():
        f, v = case(f"int32 wrap, {name}", hand[1:2], bk, bv)
        assert v.tolist() == [-3]

    # the plan the card takes == the Python twin; the grid's blocks fit
    plan_of = _build.library("cuckoo_probe_plan_of")
    got = (ctypes.c_longlong * 5)()
    for slots in (4, 5, 8, 16):
        for al in (True, False):
            g = probe_ops.launch_plan(1, slots, n_sm, al)
            g = g["lookups"] * g["threads"]
            for n in (0, 1, g - 1, g, g + 1, 4096, KV_PROBES, 2**31):
                want = probe_ops.launch_plan(n, slots, n_sm, al)
                _build.check("cuckoo_probe_plan_of",
                             plan_of(n, slots, int(al), got))
                card = {"threads": got[0], "lookups": got[1],
                        "blocks": got[2],
                        "path": "vector" if got[3] else "scalar"}
                assert card == want, (n, slots, al, card, want)
                assert got[4] >= probe_ops.BLOCKS_PER_SM, \
                    f"{got[4]} resident blocks an SM, the grid assumes " \
                    f"{probe_ops.BLOCKS_PER_SM}"
                n_cases += 1
    return n_cases


def phase_kvstore():
    """The cuckoo store through its entry points, then the probe kernel at
    deployment size against its plain version, on every path, and timed.
    Returns (launches, record)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.cuckoo_probe import (cuckoo_probe, hash_pair,
                                                  reference_cuckoo_probe)
    from repro_torch.kvstore import BlockedCuckooStore

    t0 = time.perf_counter()
    _L2_RATE[:] = [_l2_read_rate()]
    # (a) examples/kvstore_demo.py's scenario
    timed, store, probe = _kv_demo()
    kernels.reset_launch_counts()
    found, vals = store.get_batch(probe)
    launches = kernels.launch_counts()["cuckoo_probe"]
    assert found.all() and (vals == probe % 99991).all(), "demo GETs wrong"
    pf, pv = store.get_batch(probe, use_kernel=False)
    assert (pf == found).all() and (pv == vals).all()
    print(f"  demo store: {len(store.keys.nonzero()[0])} items at load "
          f"{store.load_factor():.4f}, {store.stats.relocations} "
          f"relocations; batched GET x{len(probe)} through the kernel: all "
          f"found, all values right, == plain version; {store.stats}")
    got = timed.get_many(probe[:100].tolist())
    assert got == [int(k) % 99991 for k in probe[:100]]
    print(f"  timed store get_many x100: modeled {timed.clock.now()!r} s\n"
          + "\n".join("    " + line
                      for line in timed.modeled_report().splitlines()))

    # (b) 2^23 buckets x 8 slots on the card, filled to ~0.7
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bk, bv, stored, probes = _kv_table(KV_BUCKETS, gen)
    half = KV_PROBES // 2
    big = BlockedCuckooStore.from_table(bk.cpu().numpy(), bv.cpu().numpy(),
                                        device="cuda")
    bk_d, bv_d = big.device_table()
    assert bk_d.data_ptr() + KV_SLOTS * 4 == bv_d.data_ptr() \
        and bk_d.stride() == bv_d.stride() == (2 * KV_SLOTS, 1), \
        "the store's table is not one row a bucket"
    print(f"  deployment table: {KV_BUCKETS} buckets x {KV_SLOTS} slots "
          f"({bk_d.numel() * 8 / 2**20:.0f} MiB on the card, keys and "
          f"values of a bucket in one row), {len(stored)} keys placed of "
          f"{int(KV_BUCKETS * KV_SLOTS * KV_LOAD)} (load "
          f"{big.load_factor():.4f})")
    kernels.reset_launch_counts()
    f, v = big.get_batch(probes[0])
    torch.cuda.synchronize()
    launches += kernels.launch_counts()["cuckoo_probe"]
    # the check: kernel == plain version exactly; stored found, absent not
    rf, rv = reference_cuckoo_probe(
        probes[0], *hash_pair(probes[0], KV_BUCKETS), bk_d, bv_d)
    assert torch.equal(f, rf) and torch.equal(v, rv), "kernel != plain"
    f2, v2 = cuckoo_probe(probes[0], bk, bv)
    assert torch.equal(f2, f) and torch.equal(v2, v), "two arrays != table"
    want_v = torch.zeros_like(v)
    is_stored = torch.isin(probes[0], stored.to(torch.int32))
    assert int(is_stored.sum()) == half
    assert torch.equal(f.bool(), is_stored), "a stored key was missed or " \
        "an absent one found"
    want_v[is_stored] = (probes[0][is_stored].long() * 2654435761
                         % 2**31).to(torch.int32)
    assert torch.equal(v, want_v), "wrong values"
    print(f"  check cuckoo_probe      {KV_PROBES} probes (half stored) "
          f"max_abs_err=0 (exact, store's table and two arrays) ok: "
          f"{int(f.sum())} found")
    n_edges = _probe_edges()
    print(f"  check cuckoo_probe      {n_edges} edge cases and launch plans "
          f"(slots 4/5/8/16, two arrays, one table, a 4-byte offset, N "
          f"0..4096, one bucket, the hand-made table, int32 wrap) exact ok")
    b_ms, b_by, rows, nbytes = _probe_bound(bk, probes[0])
    print(f"  bound cuckoo_probe      {rows} distinct key rows needed, "
          f"{nbytes} bytes")
    pk = torch.as_tensor(probe, device="cuda")
    dk, dv = store.device_table()
    demo = [lambda: cuckoo_probe(pk, dk, dv)]
    demo_ms = _time_ms(demo)
    demo_launch_ms = _time_ms(demo, queued=False)
    demo_b_ms, _, demo_rows, demo_bytes = _probe_bound(dk, pk)
    _probe_times(bk, bv, probes,
                 f"{KV_PROBES} GETs into [{KV_BUCKETS},{KV_SLOTS}]")
    sk, sv, _, sp = _kv_table(KV_L2_BUCKETS, gen)
    _probe_times(sk, sv, sp,
                 f"{KV_PROBES} GETs into [{KV_L2_BUCKETS},{KV_SLOTS}] "
                 f"({2 * sk.numel() * 4 / 2**20:.0f} MiB, inside L2)",
                 in_l2=True)
    print(f"  time  cuckoo_probe demo batch x{len(probe)}: device "
          f"{demo_ms:.6f} ms, with the host's launch {demo_launch_ms:.6f} "
          f"ms; {_bytes_at(demo_b_ms, True, demo_bytes)} ({demo_rows} "
          f"distinct key rows needed, {demo_bytes} bytes)")
    calls = [lambda p=p: cuckoo_probe(p, bk_d, bv_d) for p in probes]
    rec = dict(
        shape=(f"keys [{KV_PROBES}] (half stored), table [{KV_BUCKETS},"
               f"{2 * KV_SLOTS}] int32 (keys | values a row)"),
        max_abs_err=0.0, ms=_time_ms(calls),
        launch_ms=_time_ms(calls, queued=False),
        plain_ms=_time_ms([lambda p=p: reference_cuckoo_probe(
            p, *hash_pair(p, KV_BUCKETS), bk_d, bv_d) for p in probes],
            iters=8),
        library_ms=None, library="none: no PyTorch call probes a cuckoo "
        "table", bound_ms=b_ms, bound_by=b_by)
    print(f"  phase 6 wall {time.perf_counter() - t0:.1f} s")
    return launches, rec


# ---------------------------------------------------------------- phase 7
def _separated_id_mismatches(d_ref_k1, ids, ids_ref, copies=None):
    """ids equal wherever the plain version's neighbouring distances (its
    k+1 nearest, so the k-th has a next) differ by more than ANN_TIE.
    `copies` [Q, k+1] marks the places that hold a copy of the row
    before them: a run of copies has one distance on both sides and is
    ordered by id, so it counts as one place, set apart by the gaps
    before and after the run."""
    import torch
    inf = torch.full_like(d_ref_k1[:, :1], math.inf)
    before = torch.cat([inf, d_ref_k1[:, 1:] - d_ref_k1[:, :-1]], dim=1)
    first = torch.ones_like(before, dtype=torch.bool) if copies is None \
        else ~copies
    first[:, 0] = True
    run = torch.cumsum(first.long(), dim=1) - 1
    # the gap before each run; after run r comes run r + 1's
    gap = torch.cat([inf.expand_as(before), inf], dim=1).scatter_reduce(
        1, run, torch.where(first, before, inf.expand_as(before)), "amin")
    sep = (gap.gather(1, run) > ANN_TIE) & (gap.gather(1, run + 1) > ANN_TIE)
    sep = sep[:, :ids.shape[1]]
    return int(((ids != ids_ref) & sep).sum()), int(sep.sum())


def _ann_case(q_, c_, k_, lab, group=None, rank=None):
    """ann_topk against its plain version on the card: distances within
    ANN_ATOL, distinct ids, equal to the plain version's at every
    separated place; for a corpus of copied rows (`group`: each row's
    pool row, `rank`: its place among the copies by id) every tied group
    resolved to its lowest ids. Returns max_abs_err."""
    import torch
    from repro_torch.kernels.ann_topk import ann_topk, reference_ann_topk
    n = c_.shape[0]
    d, ids = ann_topk(q_, c_, k=k_)
    rd, rids = reference_ann_topk(q_, c_, min(k_ + 1, n))
    if k_ == n:                    # no next: the k-th is set apart from it
        rd = torch.cat([rd, torch.full_like(rd[:, :1], math.inf)], dim=1)
    copies = None
    if group is not None:
        g = group[rids.long()]
        copies = torch.zeros_like(g, dtype=torch.bool)
        copies[:, 1:] = g[:, 1:] == g[:, :-1]
        if k_ == n:
            copies = torch.cat([copies, torch.zeros_like(copies[:, :1])], 1)
    rids = rids[:, :k_]
    err = float((d - rd[:, :k_]).abs().max())
    bad, n_sep = _separated_id_mismatches(rd, ids, rids, copies)
    assert d.shape == ids.shape == (q_.shape[0], k_), (lab, d.shape)
    assert bool(torch.isfinite(d).all()), lab
    assert bool((ids.sort(dim=1).values.diff(dim=1) > 0).all()), lab
    assert err <= ANN_ATOL and bad == 0, (lab, k_, err, bad)
    tied = ""
    if group is not None:
        g = group[ids.long()]
        held = (g[:, :, None] == g[:, None, :]).sum(dim=-1)
        not_lowest = int((rank[ids.long()] >= held).sum())
        assert not_lowest == 0, (lab, k_, not_lowest)
        tied = (f"; {int((held > 1).sum())} places in tied groups, each "
                f"group's lowest ids")
    print(f"  check ann_topk          {lab} k={k_} max_abs_err={err:.3e}; "
          f"ids equal at all {n_sep} separated places "
          f"({int((ids != rids).sum())} near-tie swaps){tied}; ok")
    return err


def _tied_corpus(gen_np, n, d, pool, n_q):
    """n rows copied from `pool` random rows (norm ~1) at scattered ids,
    so exact ties cross tile and split borders, and n_q queries near pool
    rows. Returns (queries, corpus, group, rank) on the card: each row's
    pool row and its place among that row's copies by id."""
    import numpy as np
    import torch
    rows = (gen_np.standard_normal((pool, d)) / math.sqrt(d)).astype(
        np.float32)
    group = gen_np.integers(0, pool, n)
    order = np.argsort(group, kind="stable")
    first = np.searchsorted(group[order], group[order], side="left")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    qs = rows[gen_np.integers(0, pool, n_q)] + (0.3 / math.sqrt(d)) * \
        gen_np.standard_normal((n_q, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in
                 (qs, rows[group], group, rank))


def _ann_pass_split(fn):
    """Device ms a call of each kernel that `fn` launches, by
    torch.profiler over three calls (each kernel's time over the calls the
    profiler recorded of it); {} when it sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].replace("void ", ""):
            e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def phase_ann():
    """Two-stage search over the full corpus on the card, ann_topk held
    against its plain version and timed. Returns (launches, record)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.ann.corpus import make_corpus, make_queries
    from repro_torch.ann.progressive import exact_topk, recall_at_k, search
    from repro_torch.kernels.ann_topk import ann_topk, reference_ann_topk
    from repro_torch.kernels.ann_topk import timeline as ann_timeline
    from repro_torch.kernels.ann_topk.ops import (blocks_per_sm,
                                                  resident_blocks, smem_bytes)

    t0 = time.perf_counter()
    full_np, red_np, _ = make_corpus(ANN_N, ANN_D_FULL, ANN_D_RED,
                                     seed=SEED)
    qs_np = make_queries(full_np, ANN_Q)
    full = torch.from_numpy(full_np).cuda()
    red = torch.from_numpy(red_np).cuda()
    qs = torch.from_numpy(qs_np).cuda()
    del full_np
    small_full, small_red, _ = make_corpus(ANN_SMALL[0], ANN_D_FULL,
                                           ANN_D_RED)
    small_q = make_queries(small_full, ANN_SMALL[1])
    print(f"  corpus {ANN_N} x {ANN_D_FULL} f32 ({full.numel() * 4 / 2**30:.2f}"
          f" GiB) + reduced {ANN_D_RED}-d, {ANN_Q} queries, made in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred, stats = search(qs, red, full, k=ANN_K, promote=ANN_PROMOTE,
                         device="cuda")
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t1
    small_pred, _ = search(small_q, small_red, small_full, k=ANN_K,
                           promote=ANN_PROMOTE, device="cuda")
    launches = kernels.launch_counts()["ann_topk"]

    truth = exact_topk(qs, full, ANN_K, device="cuda")
    rec = recall_at_k(pred, truth)
    small_rec = recall_at_k(small_pred, exact_topk(
        small_q, small_full, ANN_K, device="cuda"))
    print(f"  search {ANN_Q} queries over {ANN_N}: recall@{ANN_K} = {rec!r} "
          f"against exact search on the card; {t_search * 1e3:.1f} ms wall; "
          f"{stats}")
    print(f"  search at the reference tests' size ({ANN_SMALL[0]} vectors, "
          f"{ANN_SMALL[1]} queries): recall@{ANN_K} = {small_rec!r}")
    assert pred.shape == (ANN_Q, ANN_K) and small_rec > 0.98, small_rec
    assert int(pred.min()) >= 0 and int(pred.max()) < ANN_N
    assert bool((pred.sort(dim=1).values.diff(dim=1) > 0).all())

    # the resident first-pass blocks the card reports at each k: the
    # shared-memory rule that the CPU test of split_plan takes
    rule = resident_blocks()
    per_sm = {k_: blocks_per_sm(k_, red.device)
              for k_ in (1, 64, 88, 89, 128, 256)}
    print(f"  ann_topk resident blocks an SM by k: {per_sm}; the rule "
          f"({smem_bytes()} B of shared memory a block): {rule}")
    assert all(n == rule for n in per_sm.values()), (per_sm, rule)

    # ann_topk against its plain version at the path's shapes and at the
    # deeper promotes of (c); then at edges of the design
    q_red = qs[:, :ANN_D_RED].contiguous()
    small = (torch.from_numpy(small_q[:, :ANN_D_RED]).cuda(),
             torch.from_numpy(small_red).cuda())
    path = f"[{ANN_Q},{ANN_D_RED}] x [{ANN_N},{ANN_D_RED}]"
    errs = {}
    for q_, c_, k_, lab in (
            (q_red, red, ANN_PROMOTE, path),
            (*small, ANN_PROMOTE, f"[{ANN_SMALL[1]},{ANN_D_RED}] x "
             f"[{ANN_SMALL[0]},{ANN_D_RED}]"),
            *((q_red, red, k_, path) for k_ in ANN_DEEP)):
        errs.setdefault(k_, _ann_case(q_, c_, k_, lab))
    gen = np.random.default_rng(SEED)
    tq, tc, group, rank = _tied_corpus(gen, ANN_TIED[0], ANN_D_RED,
                                       ANN_TIED[1], ANN_TIED[2])
    for k_ in (ANN_PROMOTE, 256):
        _ann_case(tq, tc, k_, f"[{ANN_TIED[2]},{ANN_D_RED}] x "
                  f"[{ANN_TIED[0]},{ANN_D_RED}] copies of {ANN_TIED[1]} rows",
                  group, rank)

    def randn(*shape):             # rows of norm ~1, as the path's
        return torch.from_numpy((gen.standard_normal(shape) / math.sqrt(
            shape[1])).astype(np.float32)).cuda()
    for n_ in (300, 256):
        _ann_case(randn(100, ANN_D_RED), randn(n_, ANN_D_RED), 256,
                  f"[100,{ANN_D_RED}] x [{n_},{ANN_D_RED}]")
    for n_q in (1, 65):
        for k_ in (ANN_PROMOTE, 256):
            _ann_case(q_red[:n_q].contiguous(), red, k_,
                      f"[{n_q},{ANN_D_RED}] x [{ANN_N},{ANN_D_RED}]")
    _ann_case(randn(100, 30), randn(5000, 30), ANN_PROMOTE,
              "[100,30] x [5000,30] (rows not 16-byte aligned)")
    for k_ in (ANN_PROMOTE, 256):
        _ann_case(qs[:100].contiguous(), full[:20000], k_,
                  f"[100,{ANN_D_FULL}] x [20000,{ANN_D_FULL}]")
    for k_ in (ANN_PROMOTE, 256):
        d1, i1 = ann_topk(q_red, red, k=k_)
        d2, i2 = ann_topk(q_red, red, k=k_)
        assert torch.equal(d1.view(torch.int32), d2.view(torch.int32)) \
            and torch.equal(i1, i2), k_
        print(f"  check ann_topk          {path} k={k_}: two calls "
              f"bit-identical")

    cn = torch.sum(red * red, dim=1)
    flops = 2 * ANN_Q * ANN_N * ANN_D_RED
    # where stage 1's time goes: the kernel at k = 1 (products, almost no
    # selection), at the promotes, a bare float32 GEMM of the same shape
    # and the PyTorch calls that give the same result
    gemm_ms = _time_ms([lambda: torch.addmm(cn[None, :], q_red, red.T,
                                            alpha=-2.0)], iters=10)
    times = {}
    for k_ in (1, ANN_PROMOTE, *ANN_DEEP):
        b_ms, b_by = _bound_ms((q_red.numel() + red.numel()) * 4
                               + ANN_Q * k_ * 8, flops, torch.float32)
        times[k_] = dict(
            ms=_time_ms([lambda: ann_topk(q_red, red, k=k_)], iters=10),
            launch_ms=_time_ms([lambda: ann_topk(q_red, red, k=k_)],
                               iters=10, queued=False),
            plain_ms=_time_ms([lambda: reference_ann_topk(q_red, red, k_)],
                              iters=5),
            library_ms=_time_ms([lambda: torch.topk(torch.addmm(
                cn[None, :], q_red, red.T, alpha=-2.0), k_, largest=False)],
                iters=10),
            bound_ms=b_ms, bound_by=b_by)
        t = times[k_]
        print(f"  time  ann_topk          queries [{ANN_Q},{ANN_D_RED}] "
              f"corpus [{ANN_N},{ANN_D_RED}] f32, k={k_}: kernel_ms="
              f"{t['ms']!r} (with host launch {t['launch_ms']!r}) plain_ms="
              f"{t['plain_ms']!r} library_ms={t['library_ms']!r} "
              f"bound_ms={b_ms!r} ({b_by})")
    print("  time  ann_topk by k: " + "; ".join(
        f"k={k_} kernel {t['ms']:.4f} ms, addmm + topk "
        f"{t['library_ms']:.4f}" for k_, t in times.items())
        + f"; torch.addmm alone {gemm_ms:.4f} ms (float32, same shape)")
    for k_ in (ANN_PROMOTE, 256):
        split = _ann_pass_split(lambda: ann_topk(q_red, red, k=k_))
        total = sum(split.values())
        print(f"  profile ann_topk k={k_}: " + (", ".join(
            f"{name} {ms:.4f} ms ({ms / total:.1%})"
            for name, ms in split.items()) if split else
            "the profiler saw no device time; split not measured"))
    for k_ in (ANN_PROMOTE, *ANN_DEEP):
        assert times[k_]["ms"] < times[k_]["library_ms"], (k_, times[k_])
    # where a call's time goes, phase by phase (a -DANN_TIMELINE build)
    tl = ann_timeline.run(q_red, red, tuple(times))
    for k_, ph in tl["k"].items():
        print(f"  time  ann_topk          timeline k={k_} (us, median "
              f"block, SM clock {ph['sm_clock_mhz']} MHz): " + ", ".join(
                  f"{p}={ph[p]}" for p in ann_timeline.PHASES)
              + f"; a block's merge rounds {ph['n_rounds']}, merges "
              f"{ph['n_merges']}, candidates {ph['n_survivors']}; first "
              f"start to last exit {ph['first_start_to_last_exit_us']}")

    # (c) deeper promotes, and the recall they buy at 262,144 vectors;
    # at the deepest, the same search with stage 1 by exact_topk
    for k_ in ANN_DEEP:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred_k, _ = search(qs, red, full, k=ANN_K, promote=k_, device="cuda")
        torch.cuda.synchronize()
        rec_k = recall_at_k(pred_k, truth)
        print(f"  search promote {k_}: recall@{ANN_K} = {rec_k!r} over "
              f"{ANN_N} vectors; {(time.perf_counter() - t1) * 1e3:.1f} ms "
              f"wall")
        assert rec_k >= rec, (k_, rec_k, rec)
    pred_p, _ = search(qs, red, full, k=ANN_K, promote=ANN_DEEP[-1],
                       use_kernel=False, device="cuda")
    rec_p = recall_at_k(pred_p, truth)
    print(f"  search promote {ANN_DEEP[-1]}: recall@{ANN_K} = {rec_k!r} "
          f"(ann_topk), {rec_p!r} (use_kernel=False)")
    assert abs(rec_k - rec_p) <= 0.002, (rec_k, rec_p)

    t = times[ANN_PROMOTE]
    out = dict(
        shape=(f"queries [{ANN_Q},{ANN_D_RED}] corpus [{ANN_N},{ANN_D_RED}]"
               f" f32, k={ANN_PROMOTE}"),
        max_abs_err=errs[ANN_PROMOTE], ms=t["ms"], launch_ms=t["launch_ms"],
        plain_ms=t["plain_ms"], library_ms=t["library_ms"],
        library="torch.addmm(|c|^2, q, c.T, alpha=-2) + torch.topk "
        "(|c|^2 precomputed)",
        bound_ms=t["bound_ms"], bound_by=t["bound_by"])
    print(f"  phase 7 wall {time.perf_counter() - t0:.1f} s")
    return launches, out


# ---------------------------------------------------------------- phase 8
def _sketch_edges(tau0: float, n_buckets: int, ulps: int = 64):
    """float32 intervals at tau0 * 2^b for b in -2 .. B+1, and 1 .. `ulps`
    ulps either side of each: where a floor of log2 can go either way."""
    import numpy as np
    base = np.float32(tau0) * np.exp2(np.arange(-2, n_buckets + 2)).astype(
        np.float32)
    steps = np.arange(-ulps, ulps + 1, dtype=np.int64)
    bits = base.view(np.int32).astype(np.int64)[:, None] + steps[None, :]
    return bits.astype(np.int32).view(np.float32).ravel()


def _sketch_specials(n_classes: int):
    """Special intervals crossed with in- and out-of-range class ids."""
    import numpy as np
    f32 = np.finfo(np.float32)
    iv = np.array([0.0, -0.0, -1.0, -1e-9, np.nan, np.inf, -np.inf,
                   1e-45, 1e-40, float(f32.tiny), 1e-30, 1e-9, 1e38,
                   float(f32.max)], np.float32)
    cls = np.array([-1, 0, 1, n_classes - 1, n_classes], np.int32)
    return np.repeat(iv, len(cls)), np.tile(cls, len(iv))


def phase_autopilot():
    """The reuse-sketch kernel bit for bit against its plain version (one
    batch and M batches in one call, both paths), the admission benchmark
    on the card (byte-identical to the CPU run), and a control plane at the
    scale replay's size. Returns (launches, record)."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.autopilot import ReuseTracker
    from repro_torch.autopilot.bench import run_suite
    from repro_torch.kernels.reuse_sketch import (reference_reuse_sketch,
                                                  reuse_sketch_update)
    from repro_torch.kernels.reuse_sketch import ops as sketch_ops
    from repro_torch.obs import bench_json

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    limit = sketch_ops.SMALL_MAX_SLOTS

    def case(C, B, iv, cls, tau0, decay, ends=None):
        hist = (rng.random((C, B)) * 7).astype(np.float32)
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (hist, iv.astype(np.float32), cls.astype(np.int32))] + [
            dict(tau0=tau0, decay=decay),
            None if ends is None else torch.from_numpy(
                np.asarray(ends, np.int32))]

    def log_uniform(n, C):
        iv = np.power(10.0, rng.uniform(-9.0, 5.0, n)).astype(np.float32)
        return iv, rng.integers(-1, C + 1, n)

    def cuts(n, m, n_empty):
        """ends of m segments over n slots at random cuts, n_empty of the
        segments empty"""
        e = np.sort(rng.choice(np.arange(1, n), m - 1 - n_empty,
                               replace=False))
        e = np.sort(np.concatenate([e, rng.choice(e, n_empty)]))
        return np.append(e, n)

    C_BENCH, C_PLANE, B = 8, 4, 32
    cases = {
        "hist [8,32] N=1 (bench)": case(
            C_BENCH, B, np.array([0.75]), np.array([0]), 1e-3, 0.995),
        f"hist [4,32] N={SKETCH_N_STEP} log-uniform": case(
            C_PLANE, B, *log_uniform(SKETCH_N_STEP, C_PLANE), 1e-3, 0.995),
        "hist [4,32] N=2^20 log-uniform": case(
            C_PLANE, B, *log_uniform(1 << 20, C_PLANE), 1e-3, 0.995),
        "hist [4,32] N=0": case(
            C_PLANE, B, np.zeros(0), np.zeros(0), 1e-3, 0.995),
    }
    # 7e-3: a multiply by tau0's float32 reciprocal would move some edges
    for tau0 in (1e-3, 7e-3):
        edges = _sketch_edges(tau0, B)
        cases[f"hist [4,32] {edges.size} edges {tau0}*2^b +-64 ulps"] = \
            case(C_PLANE, B, edges, rng.integers(0, C_PLANE, edges.size),
                 tau0, 0.995)
    # past the kernel's exponent shortcut (the top 256 mantissas of a
    # binade take the log2) on both sides
    edges = _sketch_edges(1e-3, B, 1024)
    cases[f"hist [4,32] {edges.size} edges 0.001*2^b +-1024 ulps"] = case(
        C_PLANE, B, edges, rng.integers(0, C_PLANE, edges.size), 1e-3, 0.995)
    sp_iv, sp_cls = _sketch_specials(C_PLANE)
    cases[f"hist [4,32] {sp_iv.size} special values"] = case(
        C_PLANE, B, sp_iv, sp_cls, 1e-3, 0.995)
    # M batches in one call: one-key segments (the tracker's flushes: 10
    # the suite's mean, 349 its largest), random cuts with empty segments,
    # the small path's limit and one slot past it (the large path)
    for m in (2, 10, 349):
        cases[f"hist [8,32] M={m} one-key segments"] = case(
            C_BENCH, B, *log_uniform(m, C_BENCH), 1e-3, 0.995,
            np.arange(1, m + 1))
    cases["hist [8,32] N=2000 M=64, 16 empty"] = case(
        C_BENCH, B, *log_uniform(2000, C_BENCH), 1e-3, 0.995,
        cuts(2000, 64, 16))
    cases["hist [8,32] N=7 M=40, leading/trailing empty"] = case(
        C_BENCH, B, *log_uniform(7, C_BENCH), 1e-3, 0.995,
        [0] * 5 + [1, 1, 3, 3, 3] + [7] * 30)
    cases[f"hist [8,32] N={limit} M=300 (small path's limit)"] = case(
        C_BENCH, B, *log_uniform(limit, C_BENCH), 1e-3, 0.995,
        cuts(limit, 300, 20))
    cases[f"hist [8,32] N={limit} (limit, small path)"] = case(
        C_BENCH, B, *log_uniform(limit, C_BENCH), 1e-3, 0.995)
    cases[f"hist [8,32] N={limit + 1} (large path)"] = case(
        C_BENCH, B, *log_uniform(limit + 1, C_BENCH), 1e-3, 0.995, [limit + 1])
    # the most cells the kernel takes: 12 a thread, chunks of 4 segments
    c_max = sketch_ops.MAX_CELLS // B
    cases[f"hist [{c_max},32] N=1000 M=22 (most cells)"] = case(
        c_max, B, *log_uniform(1000, c_max), 1e-3, 0.995, cuts(1000, 22, 3))
    cases[f"hist [{c_max},32] N={SKETCH_N_STEP} (most cells, large path)"] \
        = case(c_max, B, *log_uniform(SKETCH_N_STEP, c_max), 1e-3, 0.995)
    results = {}

    def check(label, again=""):
        h, iv, cls, kw, ends = cases[label]
        e = None if ends is None else ends.to(dev)
        got = reuse_sketch_update(h.to(dev), iv.to(dev), cls.to(dev),
                                  ends=e, **kw)
        if label not in results:
            want = reference_reuse_sketch(h.to(dev), iv.to(dev),
                                          cls.to(dev), ends=e, **kw)
            host = reference_reuse_sketch(h, iv, cls, ends=ends, **kw)
            results[label] = (want, host)
        want, host = results[label]
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        same_host = torch.equal(got.cpu().view(torch.int32),
                                host.view(torch.int32))
        assert same and same_host, f"reuse_sketch {label}{again}: not " \
            f"bit-exact (card plain {same}, host plain {same_host})"
        n, m = iv.numel(), 1 if ends is None else ends.numel()
        path = "small" if sketch_ops.small_path(n) else "large"
        print(f"  check reuse_sketch      {label + again:50s} bit-exact vs "
              f"plain (card and host) ok; {path} path, M={m}")

    for label in cases:
        check(label)
    # the large path right after large-path calls (its ticket and counts
    # must be back at zero) and the small path between them, each call a
    # bitwise repeat of its first
    for label in (f"hist [8,32] N={limit + 1} (large path)",
                  "hist [4,32] N=2^20 log-uniform",
                  f"hist [4,32] N={SKETCH_N_STEP} log-uniform",
                  "hist [8,32] M=349 one-key segments",
                  "hist [4,32] N=2^20 log-uniform"):
        check(label, again=" (again)")
    # one segment whose end stops short of N: both paths count the slots
    # before it, as the plain version does on those slots alone
    for n in (limit, limit + 1):
        h, iv, cls, kw, _ = case(C_BENCH, B, *log_uniform(n, C_BENCH), 1e-3,
                                 0.995)
        k = n // 2
        got = reuse_sketch_update(
            h.to(dev), iv.to(dev), cls.to(dev),
            ends=torch.tensor([k], dtype=torch.int32, device=dev), **kw)
        want = reference_reuse_sketch(h, iv[:k], cls[:k], **kw)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), \
            f"reuse_sketch N={n} ends=[{k}]: not the first {k} slots' sketch"
        path = "small" if sketch_ops.small_path(n) else "large"
        print(f"  check reuse_sketch      N={n} ends=[{k}] (short end)"
              f"{'':20s} bit-exact vs plain on the first {k} slots ok; "
              f"{path} path")

    # times: one batch at the bench's shape, the suite's mean and largest
    # flush, the small path's limit and one past, the control plane's
    def inputs(C, n, m=1):
        """4 sets of (hist, intervals, class_ids, kw, ends) on the card;
        m > 1: one-key segments (m == n)"""
        sets = []
        for _ in range(4):
            h, iv, cls, kw, _ = case(C, B, *log_uniform(n, C), 1e-3, 0.995)
            ends = None if m == 1 else torch.arange(
                1, n + 1, dtype=torch.int32, device=dev)
            sets.append((h.to(dev), iv.to(dev), cls.to(dev), kw, ends))
        return sets

    def timed(C, n, m=1):
        sets = inputs(C, n, m)
        b_ms, b_by = _bound_ms(8 * n + 8 * C * B + (4 * m if m > 1 else 0),
                               0, torch.float32)

        def calls(fn):
            return [lambda s=s: fn(s[0], s[1], s[2], ends=s[4], **s[3])
                    for s in sets]
        return dict(
            shape=f"hist [{C},{B}] f32, intervals [{n}] f32, class_ids "
                  f"[{n}] i32" + (f", ends [{m}] i32" if m > 1 else ""),
            max_abs_err=0.0,
            ms=_time_ms(calls(reuse_sketch_update)),
            launch_ms=_time_ms(calls(reuse_sketch_update), queued=False),
            plain_ms=_time_ms(calls(reference_reuse_sketch),
                              iters=4 if m > 1 else 20),
            library_ms=None, library="none: no PyTorch call computes a "
            "decayed per-class log-bucket histogram",
            bound_ms=b_ms, bound_by=b_by)
    rec = timed(C_BENCH, 1)
    for r in (rec, timed(C_BENCH, 10, 10), timed(C_BENCH, 349, 349),
              timed(C_BENCH, limit), timed(C_BENCH, limit + 1),
              timed(C_PLANE, SKETCH_N_STEP), timed(C_PLANE, 1 << 20)):
        print(f"  time  reuse_sketch      {r['shape']}: kernel_ms="
              f"{r['ms']:.6f} (with host launch {r['launch_ms']:.6f}) "
              f"plain_ms={r['plain_ms']:.6f} library_ms=none "
              f"bound_ms={r['bound_ms']:.8f} ({r['bound_by']})")

    # (b) the admission benchmark on the card, then on the host
    trackers = []
    init = ReuseTracker.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        trackers.append(self)

    suite_kw = dict(n_steps=240, step_time=0.25, l_blk=128 << 10,
                    dram_frac=0.35, alpha_accel=4.0, seed=SEED)
    params = {"scenarios": ["zipf", "scan_flood", "diurnal",
                            "multi_tenant"], "n_steps": 240,
              "step_time_ms": 250.0, "l_blk_kib": 128.0, "dram_frac": 0.35,
              "alpha_accel": 4.0, "seed": SEED}
    ReuseTracker.__init__ = spy
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        on_card = run_suite(device="cuda", **suite_kw)
        torch.cuda.synchronize()
        wall_card = time.perf_counter() - t1
        launches = kernels.launch_counts()["reuse_sketch"]
        flushes = sum(t.flushes for t in trackers)
    finally:
        ReuseTracker.__init__ = init
    observed = sum(t.observed for t in trackers)
    assert all(t.hist.is_cuda for t in trackers) and len(trackers) == 4
    t1 = time.perf_counter()
    on_host = run_suite(device="cpu", **suite_kw)
    wall_host = time.perf_counter() - t1
    js_card = bench_json(dict(on_card, params=params))
    js_host = bench_json(dict(on_host, params=params))
    assert js_card == js_host, "admission benchmark differs between devices"
    # one launch per flush of a tracker's pending observes, far fewer than
    # one per observe
    assert 0 < launches == flushes < observed, (launches, flushes, observed)
    print(f"  admission benchmark, 4 scenarios x 240 steps: gate wins "
          f"{on_card['wins']}/{on_card['cells']}; bench_json identical on "
          f"cuda and cpu (sha256 "
          f"{hashlib.sha256(js_card.encode()).hexdigest()[:16]}); "
          f"observes {observed}, flushes {flushes}, reuse_sketch launches "
          f"{launches} == flushes; wall {wall_card:.3f} s on cuda, "
          f"{wall_host:.3f} s on cpu ({wall_card / observed * 1e6:.1f} us "
          f"per observe on cuda)")
    for cell in on_card["scenarios"]:
        g = cell["runs"]["economic"]
        print(f"    {cell['scenario']:12s} gate_wins={cell['gate_wins']} "
              f"cost_per_token={g['cost_per_token']!r} per_token_stall="
              f"{g['per_token_stall']!r} best static {cell['best_static']}"
              f" (cost x{cell['cost_ratio_vs_best_static']:.4f})")
    assert on_card["wins"] >= 3, on_card["wins"]

    # (c) a control plane at the scale replay's size, on both devices
    trs = {d: ReuseTracker(ghost_capacity=1_000_000, n_buckets=B,
                           max_classes=C_PLANE, device=d)
           for d in ("cuda", "cpu")}
    ghost_s = []
    ghost = trs["cuda"]._last_seen
    touch = ghost.touch_batch

    def timed_touch(keys, now):
        t = time.perf_counter()
        out = touch(keys, now)
        ghost_s.append(time.perf_counter() - t)
        return out

    ghost.touch_batch = timed_touch
    kv, obj = (trs["cuda"].class_id(c) for c in ("kv", "obj"))
    for tr in trs.values():
        assert (tr.class_id("kv"), tr.class_id("obj")) == (kv, obj)
    walls, dev_ms = [], []
    for step in range(PLANE_STEPS):
        ids = (rng.zipf(1.1, SKETCH_N_STEP) - 1) % PLANE_KEYS
        keys = ids.tolist()
        cids = np.where(ids < PLANE_KV, kv, obj).astype(np.int32)
        now = 0.25 * step
        hist_before = trs["cuda"].hist
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        iv_card = trs["cuda"].observe_batch(keys, cids, now)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        iv_host = trs["cpu"].observe_batch(keys, cids, now)
        assert np.array_equal(iv_card.view(np.int32), iv_host.view(np.int32))
        assert torch.equal(trs["cuda"].hist.cpu().view(torch.int32),
                           trs["cpu"].hist.view(torch.int32)), step
        for c in ("kv", "obj"):
            assert trs["cuda"].class_quantile(c) == \
                trs["cpu"].class_quantile(c), (step, c)
        iv_d = torch.from_numpy(iv_card).to(dev)
        c_d = torch.from_numpy(cids).to(dev)
        dev_ms.append(_time_ms([lambda: reuse_sketch_update(
            hist_before, iv_d, c_d, tau0=1e-3, decay=0.995)], iters=10))
    tr = trs["cuda"]
    print(f"  control plane: {PLANE_STEPS} steps x {SKETCH_N_STEP} keys "
          f"(Zipf 1.1 over {PLANE_KEYS} ids), ghost {len(tr._last_seen)} "
          f"keys, {tr.measured} of {tr.observed} measured; intervals, "
          f"hist (bit for bit) and class_quantile equal on cuda and cpu at "
          f"every step; median kv {tr.class_quantile('kv')!r} s, obj "
          f"{tr.class_quantile('obj')!r} s")
    print(f"  per step: ghost (host) {np.median(ghost_s) * 1e3:.3f} ms "
          f"median [{min(ghost_s) * 1e3:.3f}, {max(ghost_s) * 1e3:.3f}]; "
          f"observe_batch on cuda {np.median(walls) * 1e3:.3f} ms median; "
          f"sketch kernel (device) {np.median(dev_ms):.6f} ms median "
          f"[{min(dev_ms):.6f}, {max(dev_ms):.6f}]")
    print(f"  phase 8 wall {time.perf_counter() - t0:.1f} s")
    return launches, rec


# --------------------------------------------------------------- phase 11
def _peak_rss_mib() -> float:
    """The process's peak resident set so far (getrusage; Linux gives
    KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _bench_on(run, module, arm_fn: str, device: str, **kw):
    """`run(device=device, **kw)` with the launch counters set to 0 just
    before it, and each arm (`module.<arm_fn>`) timed: its host-clock
    wall, its reuse_sketch launches and the flushes of the fleet trackers
    it built. Returns (report, wall, arms, launches, trackers)."""
    import torch
    from repro_torch import kernels
    from repro_torch.autopilot import ReuseTracker

    trackers, arms = [], []
    init, inner = ReuseTracker.__init__, getattr(module, arm_fn)
    cuda = device == "cuda"

    def spy(self, *a, **k):
        init(self, *a, **k)
        trackers.append(self)

    def timed(*a, **k):
        first = len(trackers)
        before = kernels.launch_counts()["reuse_sketch"]
        t = time.perf_counter()
        out = inner(*a, **k)
        if cuda:
            torch.cuda.synchronize()
        arms.append(dict(
            wall=time.perf_counter() - t,
            launches=kernels.launch_counts()["reuse_sketch"] - before,
            flushes=sum(tr.flushes for tr in trackers[first:])))
        return out

    ReuseTracker.__init__ = spy
    setattr(module, arm_fn, timed)
    try:
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        report = run(device=device, **kw)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()["reuse_sketch"]
    finally:
        ReuseTracker.__init__ = init
        setattr(module, arm_fn, inner)
    assert trackers and all(tr.device.type == device for tr in trackers)
    return report, wall, arms, launches, trackers


def _both_devices(label, run, module, arm_fn, arm_names, card, **kw):
    """One bench on the card, then on the CPU: byte-identical
    `bench_json`, one sketch launch per flush of the fleet trackers on
    the card and none on the CPU; prints each arm. Returns (report,
    launches on the card)."""
    from repro_torch.obs import bench_json

    runs = {d: _bench_on(run, module, arm_fn, d, **kw)
            for d in ("cuda", "cpu")}
    report, wall, arms, launches, trackers = runs["cuda"]
    js = bench_json(report)
    assert js == bench_json(runs["cpu"][0]), \
        f"{label}: bench_json differs between cuda and cpu"
    flushes = sum(tr.flushes for tr in trackers)
    assert 0 < launches == flushes, (label, launches, flushes)
    assert runs["cpu"][3] == 0, (label, runs["cpu"][3])
    assert [a["launches"] for a in arms] == [a["flushes"] for a in arms]
    print(f"  {label} [{card}]: bench_json identical on cuda and cpu "
          f"({len(js)} bytes); reuse_sketch launches {launches} == "
          f"flushes of its {len(trackers)} fleet trackers; wall "
          f"{wall!r} s on cuda, {runs['cpu'][1]!r} s on cpu (host clock)")
    for name, a, h in zip(arm_names, arms, runs["cpu"][2]):
        r = report["arms"][name] if "arms" in report else report[name]
        rec = r.get("recovery_seconds")
        print(f"    arm {name}: wall {a['wall']!r} s on cuda, "
              f"{h['wall']!r} s on cpu; reuse_sketch launches "
              f"{a['launches']}; cost_per_token {r['cost_per_token']!r}, "
              f"per_token_stall {r['per_token_stall']!r}, "
              f"recovery_seconds "
              f"{'n/a (no failure)' if rec is None else repr(rec)} "
              f"(modeled)")
    return report, launches


def phase_closed_loops(cfg):
    """The autopilot's closed loops: the autoscale bench (Platform.autoscale
    driving add_host / remove_host) and the failover bench (fail_host at
    the diurnal peak, then the repair loop) at the reference's defaults,
    their fleet trackers' sketch on the card, each byte-identical to the
    same bench on the CPU with one reuse_sketch launch per flush; then
    the autoscale bench at one full-width gemma-2b KV blob a block.
    Returns the launches of the phase's runs on the card."""
    from repro_torch.platform import autoscale, failover

    t0 = time.perf_counter()
    card = _smi()
    launches = 0

    # (a) both benches at the reference's defaults
    auto, n = _both_devices(
        "autoscale bench (diurnal, 240 steps, 128 KiB blocks, seed 0)",
        autoscale.run_autoscale_bench, autoscale, "_run_arm",
        ("autoscaled", "static"), card)
    launches += n
    assert auto["autoscale_wins"] and auto["final_within_one_of_advice"], \
        auto
    a = auto["autoscaled"]
    print(f"    decisions {json.dumps(a['decisions'])}; hosts "
          f"{a['hosts_start']:.0f}->{a['hosts_peak']:.0f}->"
          f"{a['hosts_final']:.0f}; cost_ratio_vs_static "
          f"{auto['cost_ratio_vs_static']!r}")
    fail, n = _both_devices(
        "failover bench (4 hosts, 12 sessions, kill at step 120)",
        failover.run_failover_bench, failover, "_run_failover_arm",
        ("1", "2", "3"), card)
    launches += n
    for k in ("zero_committed_loss_replicated",
              "all_sessions_resume_replicated", "recommended_wins"):
        assert fail[k], (k, fail)
    print(f"    advisor recommends r={fail['recommended_replicas']:.0f}; "
          + "; ".join(f"r={r}: committed keys lost "
                      f"{arm['committed_keys_lost']:.0f}, sessions lost "
                      f"{arm['sessions_lost']:.0f}, resumed "
                      f"{arm['sessions_resumed']:.0f}"
                      for r, arm in fail["arms"].items()))

    # (b) the autoscale bench at one full-width KV blob a block
    blob = _blob_bytes(cfg)
    rss_before = _peak_rss_mib()
    t1 = time.perf_counter()
    full, n = _both_devices(
        f"autoscale bench at l_blk {blob} B (one gemma-2b KV blob of "
        f"{MAX_LEN} positions)", autoscale.run_autoscale_bench, autoscale,
        "_run_arm", ("autoscaled", "static"), card, l_blk=blob)
    wall = time.perf_counter() - t1
    launches += n
    a = full["autoscaled"]
    print(f"    decisions {json.dumps(a.get('decisions', []))}; hosts "
          f"start {a['hosts_start']:.0f}, peak {a['hosts_peak']:.0f}, "
          f"final {a['hosts_final']:.0f} (advisor's final "
          f"{a['recommended_final']!r}); autoscale_wins "
          f"{full['autoscale_wins']}, final_within_one_of_advice "
          f"{full['final_within_one_of_advice']}, cost_ratio_vs_static "
          f"{full['cost_ratio_vs_static']!r} (as measured, not asserted); "
          f"wall of both devices {wall!r} s; the process's peak host RSS "
          f"{rss_before:.1f} MiB before the run, {_peak_rss_mib():.1f} MiB "
          f"after it (the stores hold one shared blob by reference)")
    print(f"  phase 11 wall {time.perf_counter() - t0:.1f} s")
    return {"reuse_sketch": launches}


# --------------------------------------------------------------- phase 12
def _captured(main, argv):
    """(return value, stdout lines) of an entry point's `main(argv)`."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(list(argv))
    return code, buf.getvalue().splitlines()


def _harness_outcome(lines):
    """{artifact name: its `-->` line} from the harness's output."""
    out, name = {}, None
    for ln in lines:
        if ln.startswith("=== "):
            name = ln[4:].rstrip("= ").strip()
        elif ln.startswith("--> ") and name is not None:
            out[name] = ln[4:]
            name = None
    return out


def _same_artifact(name, got, want):
    """Rows and note of one artifact on the card against the CPU's."""
    import re
    (rows, note), (want_rows, want_note) = got, want
    assert len(rows) == len(want_rows), name
    rows = [dict(r) for r in rows]
    want_rows = [dict(r) for r in want_rows]
    gap = None
    if "Fig. 10" in name:
        a, b = rows[0].pop("recall@10"), want_rows[0].pop("recall@10")
        gap = abs(a - b)
        assert gap <= RECALL_TOL and a > 0.98, (name, a, b)
        mask = re.compile(r"recall@10=[0-9.]+")
        note, want_note = mask.sub("", note), mask.sub("", want_note)
    worst = 0.0
    for i, (g, w) in enumerate(zip(rows, want_rows)):
        assert list(g) == list(w), (name, i)
        for k, v in w.items():
            if isinstance(v, float):
                assert isinstance(g[k], float), (name, i, k)
                assert math.isclose(g[k], v, rel_tol=ARTIFACT_RTOL), \
                    (name, i, k, g[k], v)
                if v and math.isfinite(v):
                    worst = max(worst, abs(g[k] - v) / abs(v))
            else:
                assert type(g[k]) is type(v) and g[k] == v, \
                    (name, i, k, g[k], v)
    assert note == want_note, (name, note, want_note)
    return worst, gap


def _twin_lines(name, lines):
    """A twin's lines with TWIN_MASKS applied; also the lines it masked
    and ann_search's recall (None elsewhere)."""
    import re
    out, masked, recall = [], [], None
    for ln in lines:
        m = ln
        for pat, rep in TWIN_MASKS[name]:
            m = re.sub(pat, rep, m)
        if name == "ann_search":
            hit = re.match(ANN_RECALL_LINE, m)
            if hit:
                recall = float(hit.group(1))
                m = m.replace(hit.group(1), "<recall>", 1)
        if m != ln:
            masked.append(ln)
        out.append(m)
    return out, masked, recall


def phase_artifacts():
    """The paper's artifacts on the card: the harness at --full, every
    artifact in quick mode on the card against the CPU, the analytic IOPS
    grid on both devices, and the example twins on both devices, then
    ann_search at phase 7's corpus on the card. Returns the launches of
    cuckoo_probe, ann_topk and reuse_sketch in the phase."""
    import re
    import torch
    from repro_torch import kernels
    from repro_torch.ann.corpus import make_corpus, make_queries
    from repro_torch.benchmarks import paper_figs
    from repro_torch.benchmarks import run as harness
    from repro_torch.core import (PSLC, SLC, TLC, normal_ssd,
                                  storage_next_ssd)
    from repro_torch.examples import ann_search, kvstore_demo, \
        provision_advisor
    from repro_torch.ssdsim import analytic_iops_grid
    from repro_torch.ssdsim.sweep import analytic_channel_bw_sweep

    t_phase = time.perf_counter()
    card = _smi()
    name = torch.cuda.get_device_name(0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # (a) the harness at --full on the card
    t = time.perf_counter()
    code, lines = _captured(harness.main, ["--full", "--device", "cuda"])
    torch.cuda.synchronize()
    wall_full = time.perf_counter() - t
    outcome = _harness_outcome(lines)
    assert len(outcome) == 11, outcome
    failed = tuple(n for n, note in outcome.items()
                   if note.startswith(("ANCHOR FAILED", "ERROR")))
    for n, note in outcome.items():
        print(f"  --full [{card}] {n}: {note}")
    summary = next(ln for ln in lines if "paper artifacts reproduced" in ln)
    print(f"  --full: {summary} (exit {code}; harness wall {wall_full!r} s, "
          f"host clock)")
    assert failed == FULL_ANCHOR_FAILS and code == 1, (failed, code)
    fail_note = outcome[FULL_ANCHOR_FAILS[0]]
    assert fail_note.startswith("ANCHOR FAILED: "), fail_note
    rec_card = float(fail_note.split(": ", 1)[1])
    try:
        paper_figs.fig10_ann(quick=False, device="cpu")
    except AssertionError as e:
        rec_cpu = float(str(e))
    else:
        raise AssertionError("fig10_ann(quick=False) met its anchor on "
                             "the CPU but not on the card")
    assert abs(rec_card - rec_cpu) <= RECALL_TOL, (rec_card, rec_cpu)
    print(f"  --full Fig. 10: recall@10 {rec_card} over 100,000 vectors at "
          f"promote 64 on the card, {rec_cpu} on the CPU: the reference's "
          f"own --full outcome (its anchor fails there too); the other "
          f"10 anchors met on the card")

    # (b) every artifact in quick mode, card against CPU
    walls, res = {}, {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        res[dev] = [(n, fn(**kw))
                    for n, fn, kw in harness.artifacts(True, dev)]
        if dev == "cuda":
            torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t
    worst, gap = 0.0, None
    for (n, got), (_, want) in zip(res["cuda"], res["cpu"]):
        w, g = _same_artifact(n, got, want)
        worst = max(worst, w)
        gap = g if g is not None else gap
    print(f"  quick: all 11 artifacts' rows and notes equal on cuda and "
          f"cpu (largest relative difference {worst!r}; Fig. 10 recall@10 "
          f"{res['cuda'][8][1][0][0]['recall@10']!r} on the card, "
          f"{res['cpu'][8][1][0][0]['recall@10']!r} on the cpu, gap {gap!r}"
          f" <= {RECALL_TOL}); walls {walls['cuda']!r} s on cuda "
          f"[{card}], {walls['cpu']!r} s on cpu (host clock)")

    # (c) Fig. 3's grid through analytic_iops_grid on both devices
    l_blks, gammas = (512, 1024, 2048, 4096), (1.0, 3.0, 9.0, math.inf)
    grid_worst, cells = 0.0, 0
    for nand in (SLC, PSLC, TLC):
        for make in (storage_next_ssd, normal_ssd):
            ssd = make(nand)
            on = {d: analytic_iops_grid(ssd, l_blks, gammas, device=d)
                  for d in ("cuda", "cpu")}
            bw = {d: analytic_channel_bw_sweep(ssd, 512, (3.6e9, 4.8e9,
                                                          5.6e9), device=d)
                  for d in ("cuda", "cpu")}
            for a, b in ((on["cuda"], on["cpu"]), (bw["cuda"], bw["cpu"])):
                assert a.is_cuda and a.dtype == torch.float64, a
                a = a.cpu()
                assert a.shape == b.shape and bool(torch.isfinite(a).all())
                torch.testing.assert_close(a, b, rtol=ARTIFACT_RTOL, atol=0)
                grid_worst = max(grid_worst,
                                 float(((a - b).abs() / b.abs()).max()))
                cells += a.numel()
    print(f"  analytic_iops_grid (SLC/pSLC/TLC x storage-next/normal x "
          f"l_blk 512-4096 x gamma 1/3/9/inf) and the channel-bw sweep: "
          f"{cells} cells, cuda == cpu within rtol {ARTIFACT_RTOL}; largest "
          f"relative difference {grid_worst!r}")

    # (d) the example twins on both devices
    mods = {"kvstore_demo": kvstore_demo, "ann_search": ann_search,
            "provision_advisor": provision_advisor}
    for twin, argv in TWIN_RUNS:
        runs, twalls = {}, {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            runs[dev] = _twin_lines(
                twin, _captured(mods[twin].main, argv + ("--device", dev))[1])
            twalls[dev] = time.perf_counter() - t
        (card_lines, card_masked, r_card), (cpu_lines, _, r_cpu) = \
            runs["cuda"], runs["cpu"]
        assert card_lines == cpu_lines, (twin, argv, card_lines, cpu_lines)
        assert len(card_masked) == len(TWIN_MASKS[twin]) + \
            (twin == "ann_search"), (twin, card_masked)
        if twin == "ann_search":
            assert abs(r_card - r_cpu) <= RECALL_TOL, (r_card, r_cpu)
        if twin in ("kvstore_demo", "ann_search"):
            kern = "cuckoo_probe" if twin == "kvstore_demo" else "ann_topk"
            assert sum(f"{kern} kernel on {name}" in ln
                       for ln in card_masked) == 1, card_masked
        print(f"  {twin} {' '.join(argv)}: {len(card_lines)} lines equal "
              f"on cuda and cpu (masked: host clock and route); walls "
              f"{twalls['cuda']:.2f} s on cuda [{card}] / "
              f"{twalls['cpu']:.2f} s on cpu")
        for ln in card_masked:
            print(f"    [{card}] {ln}")

    # ann_search at phase 7's corpus, on the card alone
    recalls = {}
    for argv in (ANN_TWIN_FULL, ANN_TWIN_FULL + ("--promote", "256")):
        t = time.perf_counter()
        _, out = _captured(ann_search.main, argv + ("--device", "cuda"))
        wall = time.perf_counter() - t
        rec_ln = next(ln for ln in out if ln.startswith("[search] recall"))
        wall_ln = next(ln for ln in out if ln.startswith("[search] wall"))
        promote = argv[-1] if "--promote" in argv else "64"
        recalls[promote] = float(re.match(ANN_RECALL_LINE, rec_ln).group(1))
        print(f"  ann_search {' '.join(argv)} [{card}]: {rec_ln}; {wall_ln}; "
              f"run wall {wall:.1f} s (corpus made on the host)")
    print(f"  recall@10 over {ANN_N} vectors: {recalls['64']} at the "
          f"default promote 64 (> 0.98: {recalls['64'] > 0.98}), "
          f"{recalls['256']} at promote 256 (> 0.98: asserted)")
    assert recalls["256"] > 0.98, recalls

    # (e) the three kernels launched through the entry points
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {n: counts[n] for n in PHASE12_KERNELS}
    print(f"  launches in phase 12: {json.dumps(launches)}")
    for n in PHASE12_KERNELS:
        assert launches[n] > 0, f"{n} never launched in phase 12"

    # (f) ann_topk's ids and distances against its plain version at the
    # stage-1 shapes that Fig. 10 and ann_search gave it above and phase 7
    # does not check; the recall lines above only bound what near-tie
    # swaps cost. ann_search over phase 7's corpus gave it phase 7's own
    # inputs ([1024,128] x [262144,128], same seeds) at k = 64 and 256,
    # which phase 7 holds to this rule. After (e): not counted.
    for n_ in FIG10_N:
        full_np, red_np, _ = make_corpus(n_, ANN_D_FULL, ANN_D_RED)
        q_red = make_queries(full_np, FIG10_Q)[:, :ANN_D_RED].copy()
        del full_np
        _ann_case(torch.from_numpy(q_red).cuda(),
                  torch.from_numpy(red_np).cuda(), ANN_PROMOTE,
                  f"[{FIG10_Q},{ANN_D_RED}] x [{n_},{ANN_D_RED}] "
                  f"(Fig. 10 stage 1)")
    print(f"  phase 12 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches

# ------------------------------------------------------ phases 13, 16, 17
DENSE_ARCH = "deepseek-7b"
LONG_ARCH = "mistral-nemo-12b"
MQA_ARCH = "granite-20b"
# (c)'s depth in phases 13, 16, 17, 18 and 21-23, an eighth of the
# layers of deepseek-7b, mistral-nemo-12b, granite-20b, qwen2-vl-2b and
# whisper-medium's decoder since phase 24 joined the script and timed
# flex_attention's compiles, a quarter of the others' (each (b) serves
# all of them): the scheduler's run is
# host launches a layer (38 s at deepseek-7b's 30 layers, 47 s at
# mistral-nemo-12b's 40, 56 s at granite-20b's 52, 26 s at qwen3-moe's
# 12, 40.7 s at xlstm-350m's 24 before its sLSTM scan replayed CUDA
# graphs, where a decode step is ~1,300 launches, 28.2 s at
# qwen2-vl-2b's 28, when the whole script took 856.6 s), and the whole
# script is held near 850 s with phases 19-23 in it (whisper-medium's
# (c) at 6 of its 24 decoder layers from its first run, its encoder at
# full depth). Phase 20 serves (b) and (c) at ZAMBA_GROUPS of
# zamba2-7b's 13 groups and its tail (15 of 81 layers, two applications
# of the shared attention): a decode step is ~3,900 launches at full
# depth, 128 ms of host time (0.875 device-idle); its native init and
# first-step check run all 81 layers
ZAMBA_GROUPS = 2
WORKLOAD_GROUPS = {"deepseek-7b": 4, "mistral-nemo-12b": 5,
                   "granite-20b": 7, "qwen3-moe-235b-a22b": 3,
                   "zamba2-7b": ZAMBA_GROUPS, "xlstm-350m": 3,
                   "qwen2-vl-2b": 4, "whisper-medium": 3}
SERVE_GROUPS = {"zamba2-7b": ZAMBA_GROUPS}
MOE_ARCH = "qwen3-moe-235b-a22b"
TOP1_ARCH = "llama4-maverick-400b-a17b"
SSM_ARCH = "zamba2-7b"
XLSTM_ARCH = "xlstm-350m"
VL_ARCH = "qwen2-vl-2b"
AUDIO_ARCH = "whisper-medium"
# phase 22's vision-prefix prompt: a VISION_GRID x VISION_GRID grid of
# patch embeddings, then text to MAX_LEN - 1 positions; over the image
# h = VISION_OFFSETS[0] + row and w = VISION_OFFSETS[1] + column, and t
# the index everywhere (the case in which the reference's mask is
# index-causal, as the port's kernels are)
VISION_GRID = 16
VISION_OFFSETS = (3, 5)
# a paused session's blob where its size is known from the reference's
# `init_cache` (jax.eval_shape): xlstm-350m's, the same at any context;
# whisper-medium's at MAX_LEN positions, its bf16 leaves (147,456,000 B
# of cross K/V of the 1,500 encoder rows, one size at any context, and
# 100,663,296 B of self K/V) widened to float32
BLOB_BYTES = {"xlstm-350m": 51_068_928, "whisper-medium": 496_238_592}
# phase 23's non-causal flash attention beside the encoder's and the
# prompts' shapes: (S, T, kv heads, what): one query and a ragged prompt
# onto the encoder's rows, T within one 64-key tile (the bf16 kernel's
# second warpgroup then has no tile) with S below and above it, S above
# T across tiles, and GQA 4:1 onto the encoder's rows
AUDIO_FLASH_EDGES = ((1, None, None, "cross, one query"),
                     (23, None, None, "cross, ragged S"),
                     (23, 40, None, "T <= 64"),
                     (100, 40, None, "S > T, T <= 64"),
                     (300, 130, None, "S > T"),
                     (77, None, 4, "GQA 4:1"))
WINDOWS = 3                    # phases 13 and 16-23's decode windows
EXPERT_STEPS = 64              # phases 18 and 19 (d)'s decode steps replayed


def _at_depth(cfg, params, groups):
    """`cfg` and its weights at the first `groups` groups (views of the
    stacked weights; shared weights and the tail as they are), or both as
    given when `groups` is None."""
    if groups is None:
        return cfg, params
    return (dataclasses.replace(cfg, n_groups=groups),
            dict(params, groups=_map(params["groups"],
                                     lambda t: t[:groups])))


def _long_lengths(T: int) -> tuple:
    """Decode attention's lengths at a config's own context of T = max_seq
    positions: a full row, two ragged ones and one of a single position.
    The ragged ones are ceil(T * 100,003 / 131,072) (about 0.763 T; at
    131,072 positions 100,003) and T / 4 + 1, each ending inside a
    chunk; at 32,768 positions 25,001 and 8,193."""
    return (T, -(-T * 100_003 // 131_072), T // 4 + 1, 1)


def _dense_kernels(cfg, lengths_main, buckets):
    """The three serving kernels at `cfg`'s shapes against their plain
    versions on the card (TOL), in float32 and bf16, each timed by phase
    3's rules: rmsnorm and add_rmsnorm at a decode step's rows and at the
    largest prefill bucket's; decode_attention at the decode step's
    lengths, ragged ones and lengths 0 and past T, timed over one cache a
    layer (distinct caches, so each call finds its own cold in L2 as a
    layer does); flash_attention at every prefill bucket, in the
    prefill's strided layout too. A config without attention (xlstm-350m)
    takes rmsnorm's part alone, and one under LayerNorm (whisper-medium,
    whose path launches no rmsnorm) its attention parts alone."""
    import torch
    from repro_torch.kernels import (add_rmsnorm, decode_attention,
                                     flash_attention, rmsnorm)
    from repro_torch.kernels.decode_attention import \
        timeline as decode_timeline
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    D, eps, bf16 = cfg.d_model, cfg.norm_eps, torch.bfloat16

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- rmsnorm and add_rmsnorm ------------------------------------------
    for dt in ((torch.float32, bf16) if _norms(cfg) else ()):
        name = str(dt).split(".")[1]
        for rows in (MAX_SLOTS, max(buckets)):
            x, r = randn(rows, D, dtype=dt), randn(rows, D, dtype=dt)
            s = 1.0 + 0.1 * randn(D, dtype=torch.float32)
            _check("rmsnorm", rmsnorm(x, s, eps),
                   reference_rmsnorm(x, s, eps), name, f"[{rows},{D}] {name}")
            normed, summed = add_rmsnorm(x, r, s, eps)
            want_n, want_s = reference_add_rmsnorm(x, r, s, eps)
            _check("add_rmsnorm", normed, want_n, name,
                   f"[{rows},{D}] {name}")
            assert torch.equal(summed, want_s), f"sum [{rows},{D}] {name}"
    for rows in ((MAX_SLOTS, max(buckets)) if _norms(cfg) else ()):
        _rmsnorm_times(D, eps, rows)
    if not _attn_layers(cfg):
        return
    attn = _attn_specs(cfg)[0]
    H, KV, hd = attn.n_heads, attn.n_kv, attn.head_dim
    scale = 1.0 / math.sqrt(hd)

    # ---- decode attention: H / KV query heads a kv head -------------------
    ragged = torch.tensor([1, 77, 700, MAX_LEN], dtype=torch.int32,
                          device=dev)
    edge = torch.tensor([0, 5, MAX_LEN + 100, 300], dtype=torch.int32,
                        device=dev)
    for dt in (torch.float32, bf16):
        name = str(dt).split(".")[1]
        q = randn(MAX_SLOTS, H, hd, dtype=dt)
        k = randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=dt)
        v = randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=dt)
        for lens, lab in ((lengths_main, "main"), (ragged, "ragged"),
                          (edge, "0 and > T")):
            got = decode_attention(q, k, v, lens, scale=scale)
            assert bool(torch.isfinite(got).all()), lab
            _check("decode_attention", got,
                   reference_decode_attention(q, k, v, lens, scale=scale),
                   name, f"H={H} KV={KV} hd={hd} {lab} {name}")
    caches = [(randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=bf16),
               randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=bf16))
              for _ in range(_timed_caches(cfg))]
    q = randn(MAX_SLOTS, H, hd, dtype=bf16)
    err = _check("decode_attention",
                 decode_attention(q, *caches[0], lengths_main, scale=scale),
                 reference_decode_attention(q, *caches[0], lengths_main,
                                            scale=scale),
                 "bfloat16", "the timed inputs, main lengths bf16")
    _print_record("decode_attention",
                  _decode_record(q, caches, lengths_main, scale, err))
    del caches
    # where a call spends its time at this head grouping
    _print_timeline(decode_timeline.run(lengths_main.tolist(), heads=H,
                                        kv_heads=KV, head_dim=hd),
                    f" at H={H} KV={KV} hd={hd}")

    # ---- flash attention at every prefill bucket ---------------------------
    for dt in (torch.float32, bf16):
        name = str(dt).split(".")[1]
        # the prefill's own layout: q a transposed [B,S,H,hd] projection,
        # k and v the first S rows of a max_len cache
        kc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        vc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        for S in buckets:
            q, k, v = (randn(1, n, S, hd, dtype=dt) for n in (H, KV, KV))
            _check("flash_attention", flash_attention(q, k, v, scale=scale),
                   reference_attention(q, k, v, scale=scale), name,
                   f"H={H} KV={KV} S={S} hd={hd} {name}")
            q = randn(1, S, H, hd, dtype=dt).transpose(1, 2)
            _check("flash_attention",
                   flash_attention(q, kc[:, :, :S], vc[:, :, :S],
                                   scale=scale),
                   reference_attention(q, kc[:, :, :S], vc[:, :, :S],
                                       scale=scale),
                   name, f"strided views S={S} {name}")
    for S in buckets:
        ins = [tuple(randn(1, n, S, hd, dtype=bf16) for n in (H, KV, KV))
               for _ in range(4)]
        err = _check("flash_attention", flash_attention(*ins[0], scale=scale),
                     reference_attention(*ins[0], scale=scale), "bfloat16",
                     f"bucket S={S} H={H} KV={KV} hd={hd} bf16")
        _print_record("flash_attention", _flash_record(ins, scale, err))


def _long_decode(cfg):
    """decode_attention at `cfg`'s own context, max_seq positions a slot
    (at mistral-nemo-12b's 131,072, 4,096 chunks of 32 a row, whose
    partials the row's last block merges; at granite-20b's 32,768, 1,024
    chunks of 48 heads): `_long_lengths(max_seq)`, in float32 and bf16
    against the plain version (TOL), then timed in bf16 (one cache: it is
    far past L2) beside the plain version, masked SDPA and the filled
    bytes' bound, and the per-phase timeline there. The inputs' bytes are
    reckoned before they are made."""
    import torch
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention import \
        timeline as decode_timeline
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    attn = _attn_specs(cfg)[0]
    B, T = MAX_SLOTS, cfg.max_seq
    H, KV, hd = attn.n_heads, attn.n_kv, attn.head_dim
    scale = 1.0 / math.sqrt(hd)
    lengths = torch.tensor(_long_lengths(T), dtype=torch.int32, device=dev)
    kv = 2 * B * KV * T * hd
    scratch = 4 * ops.scratch_numel(B, KV, T, H // KV, hd)
    print(f"  decode_attention at max_seq {T}: k, v [{B},{KV},{T},{hd}] "
          f"take {2 * kv / 1e9:.3f} GB in bf16, {4 * kv / 1e9:.3f} GB in "
          f"float32; the kernel's float32 scratch {scratch / 1e6:.1f} MB "
          f"({-(-T // ops.CHUNK)} chunks a row); lengths "
          f"{lengths.tolist()}")

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q = randn(B, H, hd, dtype=dt)
        k, v = randn(B, KV, T, hd, dtype=dt), randn(B, KV, T, hd, dtype=dt)
        got = decode_attention(q, k, v, lengths, scale=scale)
        assert bool(torch.isfinite(got).all()), name
        err = _check("decode_attention", got, reference_decode_attention(
            q, k, v, lengths, scale=scale), name,
            f"H={H} KV={KV} hd={hd} T={T} {name}")
        del got
    _print_record("decode_attention",
                  _decode_record(q, [(k, v)], lengths, scale, err))
    del q, k, v
    torch.cuda.empty_cache()
    _print_timeline(decode_timeline.run(lengths.tolist(), heads=H,
                                        kv_heads=KV, head_dim=hd,
                                        max_len=T),
                    f" at H={H} KV={KV} hd={hd} T={T}")
    torch.cuda.empty_cache()


def _two_sessions(prompts, tag):
    """Requests of the two prompts after the six served, MAX_NEW tokens
    each."""
    from repro_torch.serving import Request
    return [Request(rid=f"{tag}{i}", prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts[N_REQUESTS:N_REQUESTS + 2],
                                  start=N_REQUESTS)]


def _unbroken(eng, prompts, tag):
    """`_two_sessions` decoded to their end without a break."""
    whole = _two_sessions(prompts, tag)
    for r in whole:
        eng.admit(r)
    while eng.live.any():
        eng.step()
    return whole


def _pause_resume(eng, clock, prompts):
    """Two sessions (the prompts after the six served) decode without a
    break, then again paused three steps in: DRAM of 1.5 blobs sends the
    colder to flash, which comes back through a prefetch three steps
    ahead. The greedy tokens must be those of the run without a break.
    Returns the tiers of the two pauses, the colder one's after both,
    and the host-clock seconds of the first pause and of that blob's
    restore."""
    from repro_torch.core.policy import Tier

    whole = _unbroken(eng, prompts, "whole-s")
    a, b = _two_sessions(prompts, "paused-s")
    eng.admit(a)
    eng.admit(b)
    for _ in range(3):
        eng.step()
    tier_a, t_pause = _timed(eng.pause, a.rid)
    tier_b = eng.pause(b.rid)
    demoted = eng.store.tier_of(("kv", a.rid))
    assert demoted == Tier.FLASH, "the colder session was not demoted"
    clock.advance(1.2)
    eng.prefetch(a.rid)
    clock.advance(3 * STEP_TIME)
    _, t_restore = _timed(eng.resume, a.rid)
    eng.resume(b.rid)
    while eng.live.any():
        eng.step()
    assert [a.generated, b.generated] == [r.generated for r in whole], \
        "pause and resume changed the greedy tokens"
    return [tier_a.name, tier_b.name, demoted.name], t_pause, t_restore


def _largest_matrix(cfg) -> tuple:
    """Elements of one layer's largest weight (the embedding tables
    apart), what the first-step check's float32 path casts at once, and
    of native init's largest float32 draw: that weight, or one
    leading-axis slice (one expert) of a weight above
    `M.DRAW_SLICE_ELEMENTS`."""
    from repro_torch.models import model as M
    specs = [spec for _, spec in M._sublayers(cfg)] + [
        spec for _, spec in M._tail(cfg)]
    shapes = [shape for spec in specs
              for _, shape, init in M._leaves_of(
                  M._MIXERS[spec.kind].param_shapes(cfg, spec))
              if M._drawn(init)]
    sizes = [math.prod(shape) for shape in shapes]
    return max(sizes), max(n if n <= M.DRAW_SLICE_ELEMENTS else n // sh[0]
                           for n, sh in zip(sizes, shapes))


def _qk_norm_rows(cfg, buckets):
    """rmsnorm at the qk-norm rows, head_dim wide, one row a (token,
    head): q's and k's of a decode step ([slots x heads, hd] and [slots x
    kv heads, hd]) and of the largest prefill bucket, against its plain
    version in float32 and bf16 (TOL), then timed beside F.rms_norm and
    the byte bound."""
    import torch
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    attn = _attn_specs(cfg)[0]
    hd, eps, S = attn.head_dim, cfg.norm_eps, max(buckets)
    rows = (MAX_SLOTS * attn.n_heads, MAX_SLOTS * attn.n_kv,
            S * attn.n_heads, S * attn.n_kv)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for r in rows:
            x = torch.randn(r, hd, generator=gen, device=dev).to(dt)
            s = 1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev)
            _check("rmsnorm", rmsnorm(x, s, eps),
                   reference_rmsnorm(x, s, eps), name,
                   f"qk-norm [{r},{hd}] {name}")
    for r in rows:
        _rmsnorm_times(hd, eps, r, entries=("rmsnorm",))


def _inner_norm_rows(cfg, buckets):
    """rmsnorm at each recurrent sublayer's inner norm (`_inner_norms`),
    float32 rows, one a token: Mamba-2's gated norm (y * silu(z)) and the
    mLSTM's at d_inner, the sLSTM's at d_model; a decode step's [slots,
    D] and the largest prefill's [S, D], against its plain version
    (TOL), then timed beside F.rms_norm and the byte bound."""
    import torch
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    eps = cfg.norm_eps
    for label, D in _inner_norms(cfg):
        for rows in (MAX_SLOTS, max(buckets)):
            x = torch.randn(rows, D, generator=gen, device=dev)
            s = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
            _check("rmsnorm", rmsnorm(x, s, eps),
                   reference_rmsnorm(x, s, eps), "float32",
                   f"{label} [{rows},{D}] float32")
        for rows in (MAX_SLOTS, max(buckets)):
            _rmsnorm_times(D, eps, rows, entries=("rmsnorm",),
                           dtype=torch.float32)


def _slstm_scan(cfg, S, card):
    """The sLSTM prefill's scan on the card, where a recurrent prefill's
    host time goes: the device operations of one cell step
    (`xlstm.slstm_cell_` at a batch of one, as admit prefills), counted
    under torch.profiler with their device time; S steps of one layer
    step by step on the host clock (synchronised); and the same S steps
    through `xlstm.scan`, which replays whole chunks of SCAN_CHUNK steps
    as a CUDA graph, held to the step-by-step run (TOL) and timed. A
    prefill of S tokens runs S steps in each sLSTM layer."""
    import torch
    from repro_torch.models import xlstm

    spec = next(s for s in _applied(cfg) if s.kind == "slstm")
    layers = sum(s.kind == "slstm" for s in _applied(cfg))
    H, P = spec.n_heads, cfg.d_model // spec.n_heads
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    R = xlstm.recurrent_weights(torch.randn(
        H, 4, P, P, generator=gen, device=dev) / math.sqrt(P))
    pre0 = torch.randn(S, H, 1, 4 * P, generator=gen, device=dev)

    def state():
        return [torch.zeros(H, 1, P, device=dev) for _ in range(4)]

    def by_step():
        pre, (h, c, n, m) = pre0.clone(), state()
        hs = torch.empty(S, H, 1, P, device=dev)
        for t in range(S):
            h = xlstm.slstm_cell_(pre[t], h, c, n, m, R, hs[t])
        return hs, c, n, m

    def chunked():
        pre, (h, c, n, m) = pre0.clone(), state()
        hs = torch.empty(S, H, 1, P, device=dev)
        xlstm.scan(pre, R, h, c, n, m, hs)
        return hs, c, n, m

    want, got = by_step(), chunked()        # warm-up, and the graph's capture
    for name, a, b in zip(("h", "c", "n", "m"), got, want):
        _check("sLSTM scan", a, b, "float32",
               f"{name}, CUDA graph vs step by step, S={S}")
    pre, (h, c, n, m) = pre0.clone(), state()
    kern, _ = _profiled(lambda: xlstm.slstm_cell_(pre[0], h, c, n, m, R,
                                                  torch.empty_like(h)))
    ops = sum(e.count for e in kern)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    wall = _timed(by_step)[1]
    graph_wall = _timed(chunked)[1]
    print(f"  sLSTM scan: one cell step at [{H},1,{4 * P}] launches {ops} "
          f"device operations ({busy * 1e3:.1f} us of device time); {S} "
          f"steps of one layer {wall * 1e3:.2f} ms step by step on the "
          f"host clock ({wall / S * 1e6:.1f} us a step), "
          f"{graph_wall * 1e3:.2f} ms through `scan` (CUDA graphs of "
          f"{xlstm.SCAN_CHUNK} steps); a prefill of {S} tokens runs "
          f"{S * layers} steps in its {layers} sLSTM layers, "
          f"{S * layers * ops} launches [{card}]")
    return ops, wall / S


def _vision_inputs(cfg):
    """Phase 22's prompt on the card: VISION_GRID^2 patch embeddings
    [1,S_vis,D] (normal x 0.02 in bf16 from SEED, as the reference's
    `concrete_batch` draws them), text tokens to MAX_LEN - 1 positions
    in all, and their [3,1,S] positions (see VISION_OFFSETS)."""
    import numpy as np
    import torch

    n_img = VISION_GRID ** 2
    S = MAX_LEN - 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vis = torch.randn((1, n_img, cfg.d_model), generator=gen,
                      device="cuda", dtype=torch.bfloat16) * 0.02
    toks = np.random.default_rng(SEED).integers(1, cfg.vocab, S - n_img)
    row, col = np.divmod(np.arange(n_img), VISION_GRID)
    pos = np.broadcast_to(np.arange(S), (3, S)).copy()
    pos[1, :n_img] = VISION_OFFSETS[0] + row
    pos[2, :n_img] = VISION_OFFSETS[1] + col
    return (torch.as_tensor(toks[None], device="cuda"), vis,
            torch.as_tensor(pos[:, None], device="cuda"))


def _vision_check(cfg, params, card):
    """A vision-prefix prefill and one decode step through the kernels
    against the plain path on the same bf16 weights, by `_first_step`'s
    rule (within twice the plain bf16 path's distance from the float32
    path): the last logits, then the logits of a decode step of the
    kernel path's greedy token at the cache index, on all three M-RoPE
    streams as the reference decodes. A prefill launches flash attention
    once a layer at S = MAX_LEN - 1 and no decode attention, a step decode
    attention once a layer; both make `_norms` rmsnorm launches. Prints
    the prefill's wall (host clock, synchronised) and its device kernel
    time under the profiler."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import model as M

    toks, vis, pos = _vision_inputs(cfg)
    S = toks.shape[1] + vis.shape[1]
    assert S == MAX_LEN - 1, S

    def run(dtype, plain, tok=None):
        cache = M.init_cache(cfg, 1, MAX_LEN, dtype, "cuda")
        _, pre = M.prefill(params, cfg, toks, cache, compute_dtype=dtype,
                           plain=plain, vision_embeds=vis, positions=pos)
        if tok is None:
            tok = pre.argmax(-1, keepdim=True)
        _, dec = M.decode_step(params, cfg, tok, cache, S,
                               compute_dtype=dtype, plain=plain)
        return pre.float(), dec.float(), tok

    kern_pre, kern_dec, tok = run(torch.bfloat16, False)
    plain = run(torch.bfloat16, True, tok)
    truth = run(torch.float32, True, tok)
    for i, what in enumerate(("prefill's last", "decode step's")):
        kern = (kern_pre, kern_dec)[i]
        err = float((kern - plain[i]).abs().max())
        noise = float((plain[i] - truth[i]).abs().max())
        print(f"  vision prefix: the {what} logits [1,{cfg.vocab}] "
              f"({vis.shape[1]} patches + {toks.shape[1]} tokens): kernels "
              f"vs plain bf16 max_abs_err={err:.4e}; plain bf16 vs float32 "
              f"{noise:.4e}; argmax {int(kern.argmax())} / "
              f"{int(plain[i].argmax())} / {int(truth[i].argmax())}")
        assert err <= 2 * noise, (what, err, noise)
    del plain, truth
    n_attn, n_norm = _attn_layers(cfg), _norms(cfg)
    cache = M.init_cache(cfg, 1, MAX_LEN, torch.bfloat16, "cuda")
    kernels.reset_launch_counts()
    _, wall = _timed(lambda: M.prefill(params, cfg, toks, cache,
                                       vision_embeds=vis, positions=pos))
    per_prefill = kernels.launch_counts()
    kernels.reset_launch_counts()
    M.decode_step(params, cfg, tok, cache, S)
    per_step = kernels.launch_counts()
    print(f"  vision prefix: launches of the prefill {per_prefill}, of a "
          f"decode step {per_step}")
    serving = {"rmsnorm": n_norm, "flash_attention": n_attn,
               "decode_attention": 0}
    assert {k: per_prefill[k] for k in serving} == serving, per_prefill
    serving.update(flash_attention=0, decode_attention=n_attn)
    assert {k: per_step[k] for k in serving} == serving, per_step
    kern, prof_wall = _profiled(lambda: M.prefill(
        params, cfg, toks, cache, vision_embeds=vis, positions=pos))
    busy = sum(e.self_device_time_total for e in kern) / 1e3     # ms
    # the kernel's own name: flash_wgmma_kernel in bf16
    flash = sum(e.self_device_time_total for e in kern
                if "flash_" in e.key) / 1e3
    n_flash = sum(e.count for e in kern if "flash_" in e.key)
    print(f"  vision prefix: a prefill of S = {S} in {wall * 1e3:.3f} ms "
          f"of wall (host clock, synchronised); under the profiler "
          f"{busy:.3f} ms of device kernels in {prof_wall * 1e3:.3f} ms, "
          f"{n_flash} flash attention kernels {flash:.4f} ms, device-idle "
          f"share {1 - busy / (wall * 1e3):.3f} of the unprofiled wall "
          f"[{card}]")
    assert not busy or n_flash == n_attn, n_flash
    torch.cuda.empty_cache()


def _audio_kernels(cfg, buckets):
    """The attention of an encoder-decoder (whisper-medium) at its own
    shapes, beyond `_dense_kernels`' causal flash and self-cache decode:
    flash_attention with causal=False at the encoder's self-attention
    (q, k, v [1,H,F,hd], F the n_frames rows), at its cross-attention
    from each prompt length and `AUDIO_FLASH_EDGES`' shapes onto the F
    rows (and the prefill's own layout, k and v a transposed projection),
    in float32 and bf16 against the plain version (TOL), then timed in
    bf16 at the encoder's shape and at S = 1, 23 and the longest prompt
    beside SDPA (is_causal=False) and the bound; decode_attention on the
    cross cache, q [slots,H,hd] on k, v [slots,KV,F,hd] with every slot's
    length F, checked and timed over distinct caches (past L2)."""
    import torch
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    enc = next(s for layer in cfg.encoder.pattern for s in layer
               if s.kind == "attn")
    cross = next(s for s in _attn_specs(cfg) if s.cross)
    assert not enc.causal and not cross.causal, (enc, cross)
    H, KV, hd, F_ = cross.n_heads, cross.n_kv, cross.head_dim, \
        cfg.encoder.n_frames
    scale = 1.0 / math.sqrt(hd)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = [(F_, F_, KV, "encoder self-attention")]
    cases += [(S, F_, KV, "cross, a prompt's length") for S in buckets]
    cases += [(S, T or F_, kv or KV, what)
              for S, T, kv, what in AUDIO_FLASH_EDGES]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for S, T, kv, what in cases:
            q, k, v = (randn(1, n, t, hd, dtype=dt)
                       for n, t in ((H, S), (kv, T), (kv, T)))
            _check("flash_attention",
                   flash_attention(q, k, v, scale=scale, causal=False),
                   reference_attention(q, k, v, scale=scale, causal=False),
                   name, f"non-causal S={S} T={T} KV={kv} {name}")
        # the cross-attention's layout at prefill: q a transposed [B,S,H,hd]
        # projection, k and v transposed [B,F,KV,hd] projections
        S = max(buckets)
        q = randn(1, S, H, hd, dtype=dt).transpose(1, 2)
        k, v = (randn(1, F_, KV, hd, dtype=dt).transpose(1, 2)
                for _ in "kv")
        _check("flash_attention",
               flash_attention(q, k, v, scale=scale, causal=False),
               reference_attention(q, k, v, scale=scale, causal=False),
               name, f"non-causal strided views S={S} T={F_} {name}")
    for S in (F_, 1, 23, max(buckets)):
        ins = [tuple(randn(1, n, t, hd, dtype=torch.bfloat16)
                     for n, t in ((H, S), (KV, F_), (KV, F_)))
               for _ in range(4)]
        err = _check("flash_attention",
                     flash_attention(*ins[0], scale=scale, causal=False),
                     reference_attention(*ins[0], scale=scale,
                                         causal=False),
                     "bfloat16", f"timed non-causal S={S} T={F_} bf16")
        _print_record("flash_attention",
                      _flash_record(ins, scale, err, causal=False))

    full = torch.full((MAX_SLOTS,), F_, dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q = randn(MAX_SLOTS, H, hd, dtype=dt)
        k, v = (randn(MAX_SLOTS, KV, F_, hd, dtype=dt) for _ in "kv")
        _check("decode_attention",
               decode_attention(q, k, v, full, scale=scale),
               reference_decode_attention(q, k, v, full, scale=scale),
               name, f"cross cache T={F_} lengths {F_} {name}")
    one = 2 * MAX_SLOTS * KV * F_ * hd * 2
    caches = [tuple(randn(MAX_SLOTS, KV, F_, hd, dtype=torch.bfloat16)
                    for _ in "kv") for _ in range(L2_BYTES // one + 2)]
    q = randn(MAX_SLOTS, H, hd, dtype=torch.bfloat16)
    err = _check("decode_attention",
                 decode_attention(q, *caches[0], full, scale=scale),
                 reference_decode_attention(q, *caches[0], full,
                                            scale=scale),
                 "bfloat16", f"timed cross cache T={F_} bf16")
    _print_record("decode_attention",
                  _decode_record(q, caches, full, scale, err))
    del caches
    torch.cuda.empty_cache()


def _audio_check(cfg, params, prompt, card):
    """Random frame embeddings [1, n_frames, d_model] (unit normal in bf16
    from SEED, the scale of the sinusoidal table they are added to; the
    reference's `concrete_batch` draws them at 0.02, under which they move
    the logits by about the bf16 noise, 0.031 against 0.026 on an H100)
    and `prompt` prefilled and decoded one step through the kernels
    against the plain path on the same bf16 weights, by `_first_step`'s
    rule
    (within twice the plain bf16 path's distance from the float32 path):
    the prefill's last logits, then a decode step's of the kernel path's
    greedy token. The engine only feeds zero frames, so this is where
    input that is not zero reaches the encoder on the card; the logits'
    distance from those of zero frames is printed. A prefill launches
    flash attention once an encoder layer (non-causal) and twice a
    decoder layer (causal self-, non-causal cross-attention), no decode
    attention and no rmsnorm; a step decode attention twice a decoder
    layer. Prints the encoder's wall (host clock, synchronised) and its
    device kernel time under the profiler."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.models.layers import Ctx

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randn((1, cfg.encoder.n_frames, cfg.d_model),
                         generator=gen, device="cuda", dtype=torch.bfloat16)
    toks = torch.as_tensor(prompt[None].astype("int64"), device="cuda")
    S = toks.shape[1]

    def run(dtype, plain, fr, tok=None):
        cache = M.init_cache(cfg, 1, MAX_LEN, dtype, "cuda")
        _, pre = M.prefill(params, cfg, toks, cache, compute_dtype=dtype,
                           plain=plain, frames=fr)
        if tok is None:
            tok = pre.argmax(-1, keepdim=True)
        _, dec = M.decode_step(params, cfg, tok, cache, S,
                               compute_dtype=dtype, plain=plain)
        return pre.float(), dec.float(), tok

    kern_pre, kern_dec, tok = run(torch.bfloat16, False, frames)
    plain = run(torch.bfloat16, True, frames, tok)
    truth = run(torch.float32, True, frames, tok)
    silent = run(torch.bfloat16, False, torch.zeros_like(frames), tok)
    for i, what in enumerate(("prefill's last", "decode step's")):
        kern = (kern_pre, kern_dec)[i]
        err = float((kern - plain[i]).abs().max())
        noise = float((plain[i] - truth[i]).abs().max())
        moved = float((kern - silent[i]).abs().max())
        print(f"  audio: the {what} logits [1,{cfg.vocab}] (frames [1,"
              f"{cfg.encoder.n_frames},{cfg.d_model}], {S} tokens): "
              f"kernels vs plain bf16 max_abs_err={err:.4e}; plain bf16 vs "
              f"float32 {noise:.4e}; argmax {int(kern.argmax())} / "
              f"{int(plain[i].argmax())} / {int(truth[i].argmax())}; "
              f"{moved:.4e} from the logits on zero frames")
        assert err <= 2 * noise, (what, err, noise)
        assert bool(torch.isfinite(kern).all()), what
    del plain, truth, silent
    cache = M.init_cache(cfg, 1, MAX_LEN, torch.bfloat16, "cuda")
    kernels.reset_launch_counts()
    M.prefill(params, cfg, toks, cache, frames=frames)
    per_prefill = kernels.launch_counts()
    kernels.reset_launch_counts()
    M.decode_step(params, cfg, tok, cache, S)
    per_step = kernels.launch_counts()
    print(f"  audio: launches of the prefill {per_prefill}, of a decode "
          f"step {per_step}")
    serving = {"rmsnorm": 0, "flash_attention": _flash_launches(cfg),
               "decode_attention": 0}
    assert {k: per_prefill[k] for k in serving} == serving, per_prefill
    serving.update(flash_attention=0, decode_attention=_attn_layers(cfg))
    assert {k: per_step[k] for k in serving} == serving, per_step
    ctx = Ctx(mode="train", positions=None, compute_dtype=torch.bfloat16)
    _, wall = _timed(M.run_encoder, params, frames, cfg, ctx)
    _, wall = _timed(M.run_encoder, params, frames, cfg, ctx)
    kern, prof_wall = _profiled(lambda: M.run_encoder(params, frames, cfg,
                                                      ctx))
    busy = sum(e.self_device_time_total for e in kern) / 1e3     # ms
    flash = sum(e.self_device_time_total for e in kern
                if "flash_" in e.key) / 1e3
    n_flash = sum(e.count for e in kern if "flash_" in e.key)
    print(f"  audio: the encoder ({cfg.encoder.n_groups} layers over "
          f"{cfg.encoder.n_frames} frames) in {wall * 1e3:.3f} ms of wall "
          f"(host clock, synchronised, second run); under the profiler "
          f"{busy:.3f} ms of device kernels in {prof_wall * 1e3:.3f} ms, "
          f"{n_flash} flash attention kernels {flash:.4f} ms, device-idle "
          f"share {1 - busy / (wall * 1e3):.3f} of the unprofiled wall "
          f"[{card}]")
    assert not busy or n_flash == _enc_attn_layers(cfg), n_flash
    torch.cuda.empty_cache()


def _park_check(eng, prompts):
    """Two sessions (the prompts after the six served) decode without a
    break, then again with the first parked three steps in while the
    second decodes three more: after the unpark the parked session's
    greedy tokens must be those of the run without the park (its
    recurrent state held while the grid decoded around it)."""
    whole = _unbroken(eng, prompts, "whole-p")
    a, b = _two_sessions(prompts, "parked-p")
    eng.admit(a)
    eng.admit(b)
    for _ in range(3):
        eng.step()
    eng.park(a.rid)
    for _ in range(3):
        eng.step()
    assert len(a.generated) == 4 and len(b.generated) == 7
    eng.unpark(a.rid)
    while eng.live.any():
        eng.step()
    assert [a.generated, b.generated] == [r.generated for r in whole], \
        "park and unpark changed the greedy tokens"


def _decode_routings(noted, cfg):
    """The expert ids of each decode step with every slot decoding, from
    `_routes`' notes (one call a layer; prefills apart): [{layer: ids
    [slots, 1, k] as numpy}, ...] in step order."""
    k = _moe_spec(cfg).top_k
    calls = [i.cpu().numpy() for i, _ in noted
             if tuple(i.shape) == (MAX_SLOTS, 1, k)]
    L = _moe_layers(cfg)
    assert calls and len(calls) % L == 0, len(calls)
    return [dict(enumerate(calls[i:i + L]))
            for i in range(0, len(calls), L)]


def _expert_products(eng, prompts, card):
    """The expert FFN's three products in one decode step with every slot
    decoding, timed where they run by CUDA events around each layer's
    call (a stand-in for `moe._expert_ffn` set from outside the package):
    against the bound of reading every expert's weights, which the
    static-capacity product does, and against the bytes of the experts
    the step routed."""
    import torch
    from repro_torch.core import units
    from repro_torch.models import moe
    from repro_torch.serving import Request

    cfg = eng.cfg
    spec = _moe_spec(cfg)
    for i, p in enumerate(prompts[:MAX_SLOTS]):
        eng.admit(Request(rid=f"ffn{i}", prompt=p, max_new=4))
    eng.step()                                  # warm-up
    ffn = moe._expert_ffn
    events = []

    def timed(*args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = ffn(*args)
        ev[1].record()
        events.append(ev)
        return out

    moe._expert_ffn = timed
    try:
        with _routes() as noted:
            _, wall = _timed(eng.step)
    finally:
        moe._expert_ffn = ffn
    ms = sum(a.elapsed_time(b) for a, b in events)
    mats = 3 if spec.act in ("swiglu", "geglu") else 2
    one = mats * cfg.d_model * spec.d_ff * 2
    every = len(events) * spec.n_experts * one
    routed = sum(int(torch.unique(i).numel()) for i, _ in noted)
    print(f"  expert products in a decode step ({MAX_SLOTS} slots, "
          f"{len(events)} layers, capacity "
          f"{moe.capacity(spec, MAX_SLOTS)} a expert): {ms:.4f} ms (CUDA "
          f"events) of a {wall * 1e3:.3f} ms step (host clock); bound "
          f"{every / units.H100_HBM_BW * 1e3:.4f} ms to read every "
          f"expert's {every / 1e9:.3f} GB; the {routed} routed experts' "
          f"{routed * one / 1e9:.3f} GB would take "
          f"{routed * one / units.H100_HBM_BW * 1e3:.4f} ms [{card}]")
    while eng.live.any():
        eng.step()
    return ms


def _expert_arm(cfg, routings, layer_time, device, pipelined):
    """One arm of phase 18 (d) on `device`, on a fresh platform: a
    one-host spec under the economic policy priced at one expert's bytes,
    `Platform.expert_store` with every (layer, expert) on FLASH (one host
    buffer backs every key: `TieredStore.put` keeps a reference), then
    the noted routings, through `decode_step` (pipelined) or the
    reference test's fetch loop without a prefetch
    (tests/test_autopilot.py::test_expert_decode_step_pipelines_prefetch).
    Returns the record and the host-clock seconds of the replay."""
    import numpy as np
    from repro_torch.core.policy import Tier
    from repro_torch.platform import (HierarchySpec, HostDecl, Platform,
                                      PolicyDecl)

    spec = _moe_spec(cfg)
    one = 3 * cfg.d_model * spec.d_ff * 2
    platform = Platform.compile(HierarchySpec(
        hosts=(HostDecl(),), policy=PolicyDecl.economic(l_blk=one)),
        device=device)
    L = _moe_layers(cfg)
    es = platform.expert_store(n_layers=L, n_experts=spec.n_experts,
                               expert_bytes=one)
    blob = np.zeros(one, np.uint8)
    for layer in range(L):
        for e in range(spec.n_experts):
            es.store.put((layer, e), blob, tier=Tier.FLASH)
    platform.drain()
    platform.reset_stats()
    clock = platform.clock
    stall, steps = 0.0, []
    t0 = time.perf_counter()
    for r in routings:
        if pipelined:
            rec = es.decode_step(r, layer_time=layer_time, tokens=MAX_SLOTS)
            stall += rec["stall"]
            steps.append([rec["fetched"], rec["prefetched"]])
            continue
        for layer in sorted(r):
            for e in np.unique(r[layer]):
                t = clock.now()
                es.fetch_expert(layer, int(e))
                stall += clock.now() - t
            es.store.runtime.advance(layer_time)
    wall = time.perf_counter() - t0
    out = {"stall": stall, "now": clock.now(), "steps": steps}
    if pipelined:
        plan = es.residency_plan(layer_time * L)
        out.update(
            plan={k: v for k, v in plan.items() if k != "tiers"},
            tiers=plan["tiers"].tolist(),
            gate=dataclasses.asdict(es.policy.gate_stats),
            mass=float(es.policy.tracker.class_mass("expert")),
            counts=es.counts.tolist())
    return out, wall


def _expert_store(cfg, routings, step_s, card):
    """Phases 18 and 19 (d): (b)'s decode routings replayed through
    `Platform.expert_store`, pipelined and not, on the card (the economic
    gate's reuse sketch launches reuse_sketch) and on the CPU (its plain
    version), with the layer time of (b)'s profiled decode step over its
    MoE layers; the records must be equal and the pipelined stall below
    the sync one. At one MoE layer a step (phase 19) nothing lies upstream
    to prefetch behind, so every step must prefetch no expert."""
    import numpy as np
    from repro_torch import kernels

    spec = _moe_spec(cfg)
    one = 3 * cfg.d_model * spec.d_ff * 2
    L = _moe_layers(cfg)
    layer_time = step_s / L
    ids = np.stack([np.stack([r[layer].ravel() for layer in sorted(r)])
                    for r in routings])              # [steps, L, slots*k]
    share = np.stack([np.bincount(ids[:, layer].ravel(),
                                  minlength=spec.n_experts)
                      for layer in range(L)]) / ids[:, 0].size
    keys = L * spec.n_experts
    print(f"  {len(routings)} decode steps x {L} MoE layers of "
          f"expert ids ({MAX_SLOTS} slots x top-{spec.top_k}); one expert "
          f"{one} B; one host buffer of {one} B backs all {keys} keys "
          f"({keys * one / 1e9:.3f} GB were each its own); "
          f"layer_time {layer_time!r} s = the profiled decode step's "
          f"device time / {L}, on both devices")
    print(f"  selection share a layer (uniform {1 / spec.n_experts:.5f}; "
          f"random weights): max " + " ".join(
              f"{v:.4f}" for v in share.max(1)) + "; min " + " ".join(
              f"{v:.4f}" for v in share.min(1)))
    recs, walls = {}, {}
    for device in ("cuda", "cpu"):
        before = kernels.launch_counts()["reuse_sketch"]
        for arm in ("pipelined", "sync"):
            recs[device, arm], walls[device, arm] = _expert_arm(
                cfg, routings, layer_time, device, arm == "pipelined")
        launches = kernels.launch_counts()["reuse_sketch"] - before
        print(f"  on {device}: replay wall {walls[device, 'pipelined']:.3f} "
              f"s pipelined, {walls[device, 'sync']:.3f} s sync (host "
              f"clock); reuse_sketch launches {launches}")
        if device == "cuda":
            assert launches > 0, "the gate's sketch never ran on the card"
    for arm in ("pipelined", "sync"):
        assert json.dumps(recs["cuda", arm], sort_keys=True) == json.dumps(
            recs["cpu", arm], sort_keys=True), f"(d) {arm}: card != CPU"
    pipe, sync = recs["cuda", "pipelined"], recs["cuda", "sync"]
    steps = np.array(pipe["steps"])
    print(f"  stall (modeled) over {len(routings)} steps: pipelined "
          f"{pipe['stall']!r} s, sync {sync['stall']!r} s; a step fetches "
          f"{steps[:, 0].mean():.2f} and prefetches {steps[:, 1].mean():.2f}"
          f" experts (mean); residency_plan({layer_time * L!r})"
          f" {json.dumps(pipe['plan'])}; gate {json.dumps(pipe['gate'])}; "
          f"expert class mass {pipe['mass']!r}; records equal on the card "
          f"and the CPU [{card}]")
    if L == 1:
        assert not steps[:, 1].any(), "a prefetch with no upstream layer"
    else:
        assert pipe["stall"] < sync["stall"], (pipe["stall"], sync["stall"])


def phase_dense(cfg, prompts, label, long_context=False):
    """A full-width dense config on the card (phase 13: deepseek-7b, MHA
    of 32 heads of 128 at d_model 4096; phase 16: mistral-nemo-12b, GQA
    of 32 query heads on 8 kv heads of 128 at d_model 5120; both SwiGLU,
    an untied unembed, no embedding scale; phase 17: granite-20b, MQA of
    48 query heads on one kv head of 128 at d_model 6144, a plain GELU
    FFN, tied embeddings without a scale), `label` naming the phase in
    its prints, with the device memory held when it starts and the bytes
    it will need reckoned first: (a) the three serving kernels at its shapes
    against their plain versions, timed, and with `long_context` decode
    attention at the config's own max_seq; (b) serve_tiered_kv's spec
    through Platform.compile -> Platform.engine on native bf16 weights: the
    first step's logits against the plain path, phase 4's prompts and the
    example's flow, greedy tokens across a pause to flash and a prefetched
    resume equal to a run without a break, decode windows with every slot in
    use, one prefill and one decode step profiled; (c) one run of phase 10's
    declared workload through Platform.scheduler -> run(Platform.jobs()),
    at the first WORKLOAD_GROUPS groups of the weights where the config
    has an entry (phases 13, 16-18 and 20-22), and (b)'s serving after the
    first-step check at the first SERVE_GROUPS groups where the config
    has one (phase 20). Peak device memory by part (native
    init apart from (b)). An MoE config (phase 18: qwen3-moe-235b-a22b, GQA of 64 query heads on 4 kv
    heads of 128 with qk-norm, 128 experts top-8 of d_ff 1536) adds the
    qk-norm rows to (a), its routing to (b)'s first-step check, the
    expert products' time in a decode step against their byte bound, and
    (d): the expert ids (b)'s first decode window chose, replayed through
    Platform.expert_store on the card and on the CPU. An MoE config whose
    group is a dense and an MoE layer (phase 19: llama4-maverick-400b-a17b,
    GQA of 40 query heads on 8 kv heads of 128, 128 experts top-1 of d_ff
    8192 and a shared expert of 8192) runs the same steps, with every
    count of attention and MoE layers taken from its pattern. A config
    with recurrent state (phase 20: zamba2-7b, Mamba-2 layers with a
    shared attention and FFN and a tail) prefills at the exact prompt
    lengths, so (a) takes those lengths for the buckets and adds the
    gated norm's float32 rows, and (b) adds a park check. A config with
    neither attention nor an FFN (phase 21: xlstm-350m, alternating mLSTM
    and sLSTM) runs rmsnorm's part of (a) with the mLSTM's and sLSTM's
    inner norms, asserts that no attention kernel launched in (b) or (c),
    and adds the sLSTM scan's launches and time a step to (b). A "vlm"
    config (phase 22: qwen2-vl-2b, M-RoPE, GQA of 12 query heads on 2 kv
    heads of 128, SwiGLU, tied) adds a vision-prefix prefill and decode
    step to (b), held to the plain path after the first-step check. An
    encoder-decoder (phase 23: whisper-medium, 24 encoder and 24 decoder
    layers of MHA, 16 heads of 64, the decoder's cross-attention onto the
    encoder's 1,500 rows, LayerNorm, GELU, tied) prefills at the exact
    prompt lengths on zero frames, as its engine does: (a) adds
    `_audio_kernels` (non-causal flash attention, decode attention on the
    cross cache) and skips rmsnorm, which its path never launches; (b)
    counts 72 flash launches a prefill (24 of them the encoder's) and adds
    `_audio_check` on random frames after the first-step check; (c) cuts
    the decoder's groups and keeps the encoder at its full depth (it runs
    once an admission).
    Returns the launches of (b), (c) and (d)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.policy import Tier
    from repro_torch.platform import Platform

    t_phase = time.perf_counter()
    card = _smi()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  device memory held as the phase starts "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    torch.cuda.reset_peak_memory_stats()
    recurrent = _recurrent(cfg)
    lengths_main, buckets = _path_shapes(prompts, exact=_exact(cfg))
    attn = _attn_specs(cfg)[0] if _attn_layers(cfg) else None
    ffn = _ffn_spec(cfg)
    blob = _blob_bytes(cfg)
    assert blob == BLOB_BYTES.get(cfg.name, blob), blob
    mixer = ("no attention" if attn is None else
             f"{attn.n_heads} heads / {attn.n_kv} kv of {attn.head_dim}")
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{mixer}, "
          f"{'no FFN' if ffn is None else f'{ffn.act} d_ff {ffn.d_ff}'}, "
          f"vocab {cfg.vocab}, tied {cfg.tie_embeddings}; a paused blob "
          f"{blob} B; prompts {[len(p) for p in prompts]}, "
          f"{'prefill lengths' if _exact(cfg) else 'buckets'} "
          f"{buckets}, decode lengths {lengths_main.tolist()}")
    if cfg.encoder is not None:
        print(f"  {cfg.name}: an encoder of {cfg.encoder.n_groups} layers "
              f"over {cfg.encoder.n_frames} frames (non-causal "
              f"self-attention, sinusoidal positions), each decoder layer "
              f"self-attention (rope {attn.rope}), cross-attention onto the"
              f" encoder's rows and an FFN; {cfg.norm}; "
              f"{_flash_launches(cfg)} flash attention launches a prefill, "
              f"{_attn_layers(cfg)} decode attention launches a step, "
              f"{_norms(cfg)} rmsnorm launches")
    xl = {s.kind: s for s in _applied(cfg) if s.kind in ("mlstm", "slstm")}
    if xl:
        m, sl = xl["mlstm"], xl["slstm"]
        d_in = int(m.proj_factor * cfg.d_model)
        print(f"  {cfg.name}: "
              f"{sum(s.kind == 'mlstm' for s in _applied(cfg))} mLSTM "
              f"layers of {m.n_heads} heads of {d_in // m.n_heads} (d_in "
              f"{d_in}, state [{m.n_heads},{d_in // m.n_heads},"
              f"{d_in // m.n_heads + 1}] float32, conv {m.d_conv}, chunk "
              f"{m.chunk}), {sum(s.kind == 'slstm' for s in _applied(cfg))}"
              f" sLSTM layers of {sl.n_heads} heads of "
              f"{cfg.d_model // sl.n_heads} (GeGLU d_up "
              f"{int(sl.proj_factor * cfg.d_model)}); {_norms(cfg)} norms "
              f"a forward; a blob of one size at any context")
    elif recurrent:
        m = next(s for s in _applied(cfg) if s.kind == "mamba2")
        d_in = m.expand * cfg.d_model
        print(f"  {cfg.name}: {sum(s.kind == 'mamba2' for s in _applied(cfg))}"
              f" Mamba-2 layers ({len(cfg.tail)} in the tail) of "
              f"{d_in // m.head_dim} heads of {m.head_dim}, state "
              f"{m.d_state}, d_inner {d_in}, conv {m.d_conv}, chunk "
              f"{m.chunk}; {_attn_layers(cfg)} applications of the shared "
              f"attention and FFN; {_norms(cfg)} norms a forward")
    # every slot, in bf16 (a Mamba-2 state stays float32)
    cache = MAX_SLOTS * _slot_bytes(cfg, 2)
    print(f"  reckoned: weights {2 * PARAMS[cfg.name] / 1e9:.2f} GB in "
          f"bf16; the engine's cache at {MAX_SLOTS} slots x {MAX_LEN} "
          f"positions {cache / 1e6:.1f} MB in bf16; a paused blob "
          f"{blob} B (float32)")
    big, draw = _largest_matrix(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    weights = 2 * PARAMS[cfg.name]
    sliced = (f"drawn one expert at a time, {draw} elements a draw" if
              draw < big else "drawn whole")
    print(f"  reckoned: the largest stacked weight's layer {big} elements, "
          f"{sliced}; native init holds a draw as float32, its scaled "
          f"float32 copy and its bf16 cast (10 B an element), so it peaks "
          f"near {(weights + 10 * draw) / 1e9:.2f} GB; the first-step "
          f"check's float32 path casts one whole weight at a time (4 B an "
          f"element), {(weights + 4 * big) / 1e9:.2f} GB with the "
          f"activations apart; the card has {total / 1e9:.2f} GB")
    assert weights + 10 * draw < total, "native init would not fit"
    assert weights + 4 * big < total, "the first-step check would not fit"
    moe = _moe_spec(cfg)
    if moe is not None:
        print(f"  {cfg.name}: {moe.n_experts} experts top-{moe.top_k} of "
              f"d_ff {moe.d_ff} ({moe.act}), capacity factor "
              f"{moe.capacity_factor}, shared expert d_ff "
              f"{moe.shared_d_ff}; qk-norm {attn.qk_norm}; "
              f"{cfg.n_layers} of its layers ({_moe_layers(cfg)} MoE, "
              f"{_attn_layers(cfg)} attention): {PARAMS[cfg.name]} "
              f"parameters")

    print(f"  (a) the serving kernels at its shapes [{card}]")
    _dense_kernels(cfg, lengths_main, buckets)
    if attn is not None and attn.qk_norm:
        _qk_norm_rows(cfg, buckets)
    if recurrent:
        _inner_norm_rows(cfg, buckets)
    if cfg.encoder is not None:
        _audio_kernels(cfg, buckets)
    if long_context:
        _long_decode(cfg)
    peaks = {"(a)": torch.cuda.max_memory_allocated()}

    print(f"  (b) Platform.compile -> Platform.engine [{card}]")
    torch.cuda.reset_peak_memory_stats()
    params = _native_params(cfg)
    peaks["native init"] = torch.cuda.max_memory_allocated()
    # resets the peak: (b) from here is the check and the serving
    (per_prefill, per_step), t_check = _timed(_first_step, cfg, params,
                                              prompts[0])
    parts = {"first-step check": t_check}
    if cfg.modality == "vlm":
        parts["vision-prefix check"] = _timed(_vision_check, cfg, params,
                                              card)[1]
    if cfg.encoder is not None:
        parts["audio check"] = _timed(_audio_check, cfg, params, prompts[0],
                                      card)[1]
    assert per_prefill["flash_attention"] == _flash_launches(cfg), \
        per_prefill
    assert per_step["decode_attention"] == _attn_layers(cfg), per_step
    bcfg, bparams = _at_depth(cfg, params, SERVE_GROUPS.get(cfg.name))
    if bcfg is not cfg:
        blob = _blob_bytes(bcfg)
        print(f"  the engine serves at {bcfg.n_layers} of its {cfg.n_layers}"
              f" layers (views of the first {bcfg.n_groups} groups, the "
              f"shared weights and the tail); a paused blob {blob} B")
    platform = Platform.compile(_example_spec(bcfg), device="cuda")
    eng = platform.engine(bcfg, bparams, max_slots=MAX_SLOTS,
                          max_len=MAX_LEN, compute_dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    _, flow_tiers, wall = _example_flow(eng, platform.clock, prompts)
    print(f"  served {N_REQUESTS} requests, {N_REQUESTS * MAX_NEW} tokens, "
          f"in {wall:.3f} s (host clock, synchronised); the example's "
          f"paused tiers {flow_tiers[:3]}, cold session on {flow_tiers[-1]}"
          f" before its prefetch; kv_stall_time={eng.kv_stall_time!r} s "
          f"(modeled) [{card}]")
    assert flow_tiers[-1] == Tier.FLASH.name, "the cold session's blob " \
        "did not reach FLASH"
    parts["example's flow"] = wall
    (tiers, t_pause, t_restore), parts["pause and resume"] = _timed(
        _pause_resume, eng, platform.clock, prompts)
    host = platform.fabric.hosts[0]
    dram, flash = host.stats[Tier.DRAM], host.stats[Tier.FLASH]
    assert dram.bytes_written >= blob and flash.bytes_written >= blob, \
        (dram, flash)
    print(f"  pause and resume: paused to {tiers[:2]}, the colder then on "
          f"{tiers[2]} and resumed through a prefetch; greedy tokens of "
          f"both sessions == a run without a break; one pause of the "
          f"{blob} B blob {t_pause!r} s, its restore from flash "
          f"{t_restore!r} s (host clock, synchronised) [{card}]")
    print(f"  kv_stall_time={eng.kv_stall_time!r} s after both flows "
          f"(modeled); store DRAM {dram}; FLASH {flash}")
    assert eng._slot_blob(0)[0].nbytes == blob, "the engine's blob size"
    if recurrent:
        _, t_park = _timed(_park_check, eng, prompts)
        parts["park check"] = t_park
        print(f"  park check: a session parked three steps while another "
              f"decoded, then unparked, decoded the tokens of the run "
              f"without the park ({t_park:.3f} s, host clock) [{card}]")
    tps = []
    t_windows = time.perf_counter()
    for i in range(WINDOWS):
        # an MoE config's first window notes its decode steps' expert ids
        # for (d)
        with (_routes() if moe is not None and i == 0
              else contextlib.nullcontext()) as noted:
            tps.append(_decode_window(eng, prompts, f"w{i}-",
                                      DENSE_STEADY_NEW))
        if moe is not None and i == 0:
            routings = _decode_routings(noted, cfg)[:EXPERT_STEPS]
    parts["decode windows"] = time.perf_counter() - t_windows
    tps.sort()
    print(f"  decode windows, {MAX_SLOTS} slots live for "
          f"{DENSE_STEADY_NEW - 1} "
          f"steps each, tokens/s (host clock, synchronised): median "
          f"{tps[len(tps) // 2]!r}, range {tps[0]!r} - {tps[-1]!r} over "
          f"{len(tps)} windows [{card}]")
    step_ms, parts["profile"] = _timed(_profile_split, eng, prompts)
    if xl:
        parts["sLSTM scan"] = _timed(_slstm_scan, cfg, len(prompts[5]),
                                     card)[1]
    print(f"  (b)'s parts, host clock: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + f" [{card}]")
    if moe is not None:
        _expert_products(eng, prompts, card)
    peaks["(b)"] = torch.cuda.max_memory_allocated()
    del eng, platform
    torch.cuda.empty_cache()

    wcfg, wparams = _at_depth(cfg, params, WORKLOAD_GROUPS.get(cfg.name))
    blob = _blob_bytes(wcfg)
    depth = ("" if wcfg is cfg else
             f" at {wcfg.n_layers} of its {cfg.n_layers} layers (views of "
             f"the first {wcfg.n_groups} groups' weights: the run's wall is "
             f"host launches a layer, and the whole script is held near "
             f"850 s)")
    print(f"  (c) Platform.scheduler -> run(Platform.jobs()){depth} "
          f"[{card}]")
    torch.cuda.reset_peak_memory_stats()
    platform, sched, jobs, report, wall, split, pauses = _serve_workload(
        wcfg, wparams, _workload_spec(wcfg), dtype=torch.bfloat16)
    counts = kernels.launch_counts()
    _workload_report(platform, sched, report, pauses, card)
    assert report["tokens"] == sum(len(j.request.generated) for j in jobs)
    assert report["pauses"] > 0, report["pauses"]
    print(f"  wall (host clock, synchronised, Platform.compile outside) "
          f"{wall!r} s [{card}]")
    _print_split("split", report, wall, split)
    peaks["(c)"] = torch.cuda.max_memory_allocated()
    print(f"  peak host RSS {_peak_rss_mib():.1f} MiB (paused blobs are "
          f"{blob / 2**20:.0f} MiB each on the host); peak device memory "
          + ", ".join(f"{v / 1e9:.3f} GB in {k}" for k, v in peaks.items())
          + f", {max(peaks.values()) / 1e9:.3f} GB in all [{card}]")
    if moe is not None:
        assert step_ms is not None, "(d) takes the profiled decode step"
        print(f"  (d) Platform.expert_store [{card}]")
        _expert_store(cfg, routings, step_ms / 1e3, card)
        counts = kernels.launch_counts()
    counts = {name: counts[name] for name in
              SERVING_KERNELS + ("reuse_sketch",)}
    parts = "(b), (c) and (d)" if moe is not None else "(b) and (c)"
    print(f"  launches in {label} {parts}: {json.dumps(counts)}")
    for name, n in counts.items():
        if name in ATTENTION_KERNELS and attn is None:
            assert n == 0, f"{name} launched {n} times in {label}, " \
                f"a config without attention"
        elif name == "rmsnorm" and not _norms(cfg):
            assert n == 0, f"rmsnorm launched {n} times in {label}, " \
                f"a config under {cfg.norm}"
        else:
            assert n > 0, f"{name} never launched in {label}"
    del platform, sched, jobs, params, wparams
    torch.cuda.empty_cache()
    print(f"  {label} wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts


# --------------------------------------------------------------- phase 14
# the replay at the reference's defaults (benchmarks/serving_scale.py), and
# what the reference's run printed there (12 significant digits) beside
# the counts it printed exactly
SCALE_DEFAULTS = dict(n_keys=1_000_000, n_sessions=100_000, n_steps=120,
                      accesses_per_step=50_000, n_hosts=8)
SCALE_MODELED = {"accesses": 6_207_181.0, "ghost_size": 965_935.0,
                 "ops_sketch_updates": 120.0}
SCALE_MODELED_12 = {"hit_rate": 0.368545399272,
                    "total_stall": 67.5326785811,
                    "owner_imbalance": 1.21774699336}
SCALE_SECTIONS = ("digest", "routing", "tracking", "admission",
                  "stall_pricing", "metrics")


RACE_MAX_LEN = 64              # serving_scale's race: run_compare's engines


def _fleet_argv_run(fleet, argv):
    """The fleet twin's `main(argv)` once. The keyword fleet is host
    Python on a virtual clock and holds nothing on a device, so `--device`
    changes nothing there. Returns (report, wall)."""
    import contextlib
    import io
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        fleet.main(list(argv))
    return json.loads(buf.getvalue()), time.perf_counter() - t


def _print_fleet_cells(label, trajectory, wall, card):
    print(f"  {label}: wall {wall} (host clock); peak host RSS "
          f"{_peak_rss_mib():.1f} MiB [{card}]")
    for rec in trajectory:
        s, a = rec["sync"], rec["async"]
        line = (f"    hosts {rec['hosts']} skew {rec['skew']}: stall per "
                f"token sync {s['per_token_stall'] * 1e6!r} us, async "
                f"{a['per_token_stall'] * 1e6!r} us, stall_speedup "
                f"{rec['stall_speedup']!r}, remote_fetches "
                f"{a['remote_fetches']:.0f} (modeled)")
        if "churn" in rec:
            ch = rec["churn"]
            line += (f"; churn moved {ch['rebalance_bytes']:.0f} B, "
                     f"{ch['rebalance_fraction']!r} of resident (ideal "
                     f"{1 / (rec['hosts'] + 1)!r}), stall x"
                     f"{ch['stall_ratio']!r}")
        print(line)


def _fleet_spec_runs(fleet, label, spec, card, **kw):
    """`run_sweep` over a declared fleet on the card and on the CPU (the
    platform's gates keep their sketch on `device`): byte-identical; the
    card run's reuse_sketch launches and wall."""
    from repro_torch import kernels
    from repro_torch.obs import bench_json

    js, walls, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        before = kernels.launch_counts()["reuse_sketch"]
        t = time.perf_counter()
        traj = fleet.run_sweep([spec.n_hosts], [0.0, 1.2], spec=spec,
                               device=dev, **kw)
        walls[dev] = time.perf_counter() - t
        launches[dev] = kernels.launch_counts()["reuse_sketch"] - before
        js[dev] = bench_json(traj)
    assert js["cuda"] == js["cpu"], f"{label}: cuda and cpu differ"
    assert launches["cpu"] == 0, launches
    _print_fleet_cells(
        f"{label}, reuse_sketch launches on cuda {launches['cuda']}: JSON "
        f"identical on cuda and cpu", traj,
        f"{walls['cuda']!r} s on cuda, {walls['cpu']!r} s on cpu", card)
    return traj, launches["cuda"]


def _replay_on(scale, device, capture=False, **kw):
    """`scale_replay(device=device, obs=on, **kw)` with the ghost's host
    time a step, the same spy on either device. With `capture` (on the
    card) the run is instrumented inside its window: each step's sketch
    inputs are cloned and its call is bracketed by CUDA events (from the
    call to the kernel's end; the stream is idle when the call starts, so
    the wrapper's host time shows). After that run the kernel is timed on
    each step's own inputs (device time, queued, not counted) and held bit
    for bit against its plain version on every tenth step's, where the
    plain version is timed. Returns (record, timings, ghost seconds,
    launches, wall, sketch): sketch is None without capture, else the
    in-run and kernel ms a step, the plain version's ms, each step's bound
    and N."""
    import torch
    from repro_torch import kernels
    from repro_torch.autopilot import ReuseTracker, reuse
    from repro_torch.kernels.reuse_sketch import reference_reuse_sketch
    from repro_torch.obs import Observability

    ghost_s, events, inputs = [], [], []
    init, update = ReuseTracker.__init__, reuse.reuse_sketch_update
    cuda = device == "cuda"

    def spy(self, *a, **k):
        init(self, *a, **k)
        touch = self._last_seen.touch_batch

        def timed_touch(keys, now):
            t = time.perf_counter()
            out = touch(keys, now)
            ghost_s.append(time.perf_counter() - t)
            return out
        self._last_seen.touch_batch = timed_touch

    def captured_update(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        inputs.append(([t.clone() for t in a], k))
        ev[0].record()
        out = update(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    ReuseTracker.__init__ = spy
    if capture:
        reuse.reuse_sketch_update = captured_update
    try:
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        record, timings = scale.scale_replay(obs=Observability(),
                                             device=device, **kw)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()["reuse_sketch"]
    finally:
        ReuseTracker.__init__ = init
        reuse.reuse_sketch_update = update
    if not capture:
        return record, timings, ghost_s, launches, wall, None
    sample = inputs[::10]
    for a, k in sample:
        assert torch.equal(update(*a, **k).view(torch.int32),
                           reference_reuse_sketch(*a, **k).view(torch.int32))
    sketch = dict(
        in_run_ms=[a.elapsed_time(b) for a, b in events],
        kernel_ms=[_time_ms([lambda a=a, k=k: update(*a, **k)], iters=10)
                   for a, k in inputs],
        plain_ms=_time_ms([lambda a=a, k=k: reference_reuse_sketch(*a, **k)
                           for a, k in sample], iters=len(sample)),
        bound=[_bound_ms(8 * a[1].numel() + 8 * a[0].numel(), 0,
                         torch.float32) for a, _ in inputs],
        n=[a[1].numel() for a, _ in inputs])
    return record, timings, ghost_s, launches, wall, sketch


def _print_replay(label, timings, ghost_s, wall, card):
    import numpy as np
    secs = ", ".join(f"{k} {timings[k]!r}" for k in SCALE_SECTIONS)
    print(f"  {label}: wall {wall!r} s; sections (s, host clock) {secs}; "
          f"steady state {timings['keys_per_sec']!r} keys/s [{card}]")
    print(f"    tracking {timings['tracking']!r} s = host ghost "
          f"{sum(ghost_s)!r} s (median {np.median(ghost_s) * 1e3:.3f} ms "
          f"a step, range {min(ghost_s) * 1e3:.3f}-"
          f"{max(ghost_s) * 1e3:.3f}) + the sketch's upload and launch "
          f"(or its plain version on the CPU; its class reads are in "
          f"admission)")


def _print_sketch(sketch):
    import numpy as np
    k, r = sketch["kernel_ms"], sketch["in_run_ms"]
    bounds = [b for b, _ in sketch["bound"]]
    print(f"    sketch a step (the instrumented run): kernel (device time, "
          f"queued, on each step's inputs) {sum(k)!r} ms in all, median "
          f"{np.median(k):.6f} ms, range {min(k):.6f}-{max(k):.6f}; from "
          f"the call to the kernel's end {sum(r)!r} ms, median "
          f"{np.median(r):.6f}; N {min(sketch['n'])}-{max(sketch['n'])} "
          f"(mean {float(np.mean(sketch['n']))!r}); bound_ms median "
          f"{np.median(bounds):.8f} ({sketch['bound'][0][1]}); plain "
          f"version {sketch['plain_ms']:.6f} ms (device, queued, on every "
          f"tenth step's inputs, where the kernel equals it bit for bit)")


def _session_jobs(run):
    """`run()` with every job list that `jobs_from_trace` makes noted (the
    race makes one a scenario and arm). Returns (result, job lists)."""
    from repro_torch import serving
    made, inner = [], serving.jobs_from_trace

    def noted(*a, **k):
        made.append(inner(*a, **k))
        return made[-1]
    serving.jobs_from_trace = noted
    try:
        return run(), made
    finally:
        serving.jobs_from_trace = inner


def _race(cfg, params, scenarios, *, n_jobs, horizon):
    """serving_scale's race at `cfg`'s width on the card: run_compare's
    engines (4 slots, max_len 64, a pinned-flash store, 2 ms steps) and
    jobs (two turns of 5 tokens, pause_idle_steps 4) over `params`,
    computing in their dtype. Each engine notes on the host, before it
    runs them, the lengths a decode step hands decode_attention and the
    bucket a prefill hands flash_attention (no device work). Returns
    (report, buckets, length vectors)."""
    from repro_torch import serving
    from repro_torch.core.policy import TieringPolicy
    from repro_torch.runtime.clock import VirtualClock
    from repro_torch.runtime.tiers import TieredStore
    from repro_torch.serving.engine import _next_pow2

    buckets, lengths = set(), set()

    class Noted(serving.DecodeEngine):
        def admit(self, req):
            buckets.add(min(_next_pow2(len(req.prompt)), self.max_len - 1))
            return super().admit(req)

        def step(self):
            if (self.live & self.active).any():
                lengths.add(tuple(self.lengths.tolist()))
            return super().step()

    def engine_factory():
        store = TieredStore(
            TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0),
            clock=VirtualClock())
        return Noted(cfg, params, max_slots=MAX_SLOTS, max_len=RACE_MAX_LEN,
                     store=store, step_time=2e-3,
                     compute_dtype=params["embed"].dtype, device="cuda")

    report = {scen: serving.compare_scheduling(
        engine_factory,
        lambda scen=scen: serving.jobs_from_trace(
            scen, n_jobs=n_jobs, n_turns=2, tokens_per_turn=5,
            vocab=cfg.vocab, horizon=horizon, seed=SEED),
        pause_idle_steps=4) for scen in scenarios}
    return report, sorted(buckets), sorted(lengths)


def _race_kernels(cfg, buckets, lengths, what="the race's"):
    """The serving kernels at the race's own shapes, bf16 as it ran,
    against their plain versions (TOL) on seeded inputs: rmsnorm and
    add_rmsnorm at a decode step's rows and each prefill bucket's;
    decode_attention over a max_len cache at every length vector a decode
    step of the race held; flash_attention at each bucket, contiguous and
    in the prefill's strided layout."""
    import torch
    from repro_torch.kernels import (add_rmsnorm, decode_attention,
                                     flash_attention, rmsnorm)
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    attn = _attn_specs(cfg)[0]
    D, H, KV, hd = cfg.d_model, attn.n_heads, attn.n_kv, attn.head_dim
    eps, scale = cfg.norm_eps, 1.0 / math.sqrt(hd)
    errs = {n: 0.0 for n in ("rmsnorm", "add_rmsnorm", "decode_attention",
                             "flash_attention")}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def hold(name, got, want, label):
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL["bfloat16"],
                                   msg=lambda m: f"{name} {label}: {m}")
        errs[name] = max(errs[name],
                         float((got.float() - want.float()).abs().max()))

    rows = sorted({MAX_SLOTS, *buckets})
    for n in rows:
        x, r = randn(n, D), randn(n, D)
        s = 1.0 + 0.1 * randn(D, dtype=torch.float32)
        hold("rmsnorm", rmsnorm(x, s, eps), reference_rmsnorm(x, s, eps),
             f"[{n},{D}]")
        normed, summed = add_rmsnorm(x, r, s, eps)
        want_n, want_s = reference_add_rmsnorm(x, r, s, eps)
        hold("add_rmsnorm", normed, want_n, f"[{n},{D}]")
        assert torch.equal(summed, want_s), f"sum [{n},{D}]"
    q = randn(MAX_SLOTS, H, hd)
    k, v = (randn(MAX_SLOTS, KV, RACE_MAX_LEN, hd) for _ in range(2))
    for lens in lengths:
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        hold("decode_attention", decode_attention(q, k, v, lt, scale=scale),
             reference_decode_attention(q, k, v, lt, scale=scale),
             f"lengths {list(lens)}")
    kc, vc = (randn(1, KV, RACE_MAX_LEN, hd) for _ in range(2))
    for S in buckets:
        for q, k, v in ((randn(1, H, S, hd), randn(1, KV, S, hd),
                         randn(1, KV, S, hd)),
                        (randn(1, S, H, hd).transpose(1, 2), kc[:, :, :S],
                         vc[:, :, :S])):
            hold("flash_attention", flash_attention(q, k, v, scale=scale),
                 reference_attention(q, k, v, scale=scale), f"S={S}")
    flat = [n for lens in lengths for n in lens]
    print(f"  check at {what} shapes, bf16 (TOL): rmsnorm and "
          f"add_rmsnorm at rows {rows} x {D}; decode_attention q "
          f"[{MAX_SLOTS},{H},{hd}] k,v [{MAX_SLOTS},{KV},{RACE_MAX_LEN},"
          f"{hd}] at the run's {len(lengths)} length vectors (lengths "
          f"{min(flat)}-{max(flat)}); flash_attention q [1,{H},S,{hd}] k,v "
          f"[1,{KV},S,{hd}] at S {buckets}, contiguous and strided; "
          f"max_abs_err {json.dumps(errs)} ok")


def _compare_cells(report, wall, card, label):
    for scen, cell in report.items():
        c, lk = cell["continuous"], cell["lockstep"]
        print(f"    {label} {scen}: tokens_identical "
              f"{cell['tokens_identical']}, continuous_wins "
              f"{cell['continuous_wins']}; tokens_per_sec {c['tokens_per_sec']!r}"
              f" vs lock-step {lk['tokens_per_sec']!r}, per_token_stall "
              f"{c['per_token_stall']!r} vs {lk['per_token_stall']!r} s "
              f"(modeled); ticks {c['ticks']} vs {lk['ticks']}")
    print(f"    {label} wall {wall!r} s (host clock, synchronised) [{card}]")


def phase_fleet_scale(cfg):
    """The fleet at scale: (a) the fleet bench through the serving_fleet
    twin: the keyword cells (--smoke, --smoke --churn, the default sweep at
    one full-width gemma-2b KV blob a session) once each, host Python on a
    virtual clock; the heterogeneous 2:1 DRAM spec under capacity and
    uniform weighting and a four-host economic spec, whose gates keep
    their sketch on the card, on the card and the CPU, byte-identical;
    (b) the control-plane replay at the reference's defaults (1M keys,
    100k sessions, 120 steps, 8 hosts, metrics on) on the card, timed as
    the CPU run is, its record byte-identical to the CPU's and equal to
    the reference's modeled values, one reuse_sketch launch a step; then
    again, instrumented, for the sketch's device time beside the host
    ghost's; (c) the serving_scale twin's run_compare on reduced gemma-2b
    in float32 on one set of weights, its report and every session's
    tokens equal on the card and the CPU, and the same race on full-width gemma-2b in bf16 (native
    seed-0 weights, built again here: phase 10 freed its own), held to the
    plain path by phase 4's first-step logits rule and by each serving
    kernel at the shapes the race gave it. Returns the launches of the
    phase's runs on the card."""
    import torch
    from repro_torch import kernels
    from repro_torch.benchmarks import serving_fleet as fleet
    from repro_torch.benchmarks import serving_scale
    from repro_torch.configs import get_config
    from repro_torch.core.policy import Tier
    from repro_torch.models import model as M
    from repro_torch.obs import bench_json
    from repro_torch.platform import (HierarchySpec, HostDecl, PolicyDecl,
                                      TierDecl)
    from repro_torch.serving import scale

    t_phase = time.perf_counter()
    card = _smi()
    blob = _blob_bytes(cfg)
    assert blob == 36 << 20, blob
    total = {n: 0 for n in SERVING_KERNELS + ("reuse_sketch",)}

    def add(counts):
        for n in total:
            total[n] += counts[n]

    # (a) the fleet bench
    print("  (a) the fleet bench (serving_fleet twin)")
    kernels.reset_launch_counts()
    for label, argv in (
            ("--smoke", ["--smoke"]),
            ("--smoke --churn", ["--smoke", "--churn"]),
            (f"default sweep at --kv-mib 36 ({blob} B, one {cfg.name} "
             f"blob a session)", ["--kv-mib", "36"])):
        report, wall = _fleet_argv_run(fleet, argv)
        _print_fleet_cells(f"{label} (keyword fleet: host only, virtual "
                           f"clock)", report["trajectory"], f"{wall!r} s",
                           card)
    small = 3 * (1 << 19)
    het = {w: HierarchySpec(
        hosts=(HostDecl(tiers={"dram": TierDecl(2 * small, 45e9, 5e-7)}),
               HostDecl(tiers={"dram": TierDecl(small, 45e9, 5e-7)},
                        count=3)),
        policy=PolicyDecl.pinned_dram(), weighting=w, vnodes=128)
        for w in ("capacity", "uniform")}
    het_kw = dict(n_sessions=14, rounds=3, kv_bytes=1 << 19, decode_steps=8,
                  step_time=2e-3, lead=6, seed=0, kv_tier=Tier.DRAM)
    stall = {}
    for w, spec in het.items():
        traj, _ = _fleet_spec_runs(
            fleet, f"2:1 DRAM spec, weighting {w!r}, kv_tier DRAM", spec,
            card, **het_kw)
        stall[w] = traj[0]["sync"]["per_token_stall"]
    print(f"    capacity-weighted ring's sync stall per token "
          f"{stall['capacity']!r} s against uniform {stall['uniform']!r} s "
          f"(modeled)")
    assert stall["capacity"] < stall["uniform"], stall
    econ = HierarchySpec(hosts=(HostDecl(count=4),),
                         policy=PolicyDecl.economic(l_blk=1 << 20))
    traj, econ_launches = _fleet_spec_runs(
        fleet, "four-host economic spec (l_blk 1 MiB), 8 sessions of 1 MiB",
        econ, card, n_sessions=8, rounds=2, kv_bytes=1 << 20,
        decode_steps=16, step_time=2e-3, lead=8, seed=0)
    add(kernels.launch_counts())

    # (b) the control-plane replay at the reference's defaults
    print("  (b) scale_replay at the reference's defaults, metrics on")
    rss = _peak_rss_mib()
    rec, timings, ghost_s, launches, wall, _ = _replay_on(
        scale, "cuda", **SCALE_DEFAULTS)
    add({**{n: 0 for n in SERVING_KERNELS}, "reuse_sketch": launches})
    print(f"  record {json.dumps(rec)}")
    assert launches == SCALE_DEFAULTS["n_steps"], launches
    for k, v in SCALE_MODELED.items():
        assert rec[k] == v, (k, rec[k], v)
    for k, v in SCALE_MODELED_12.items():
        assert math.isclose(rec[k], v, rel_tol=1e-11), (k, rec[k], v)
    _print_replay("on cuda", timings, ghost_s, wall, card)
    rec_cpu, t_cpu, ghost_cpu, launches_cpu, wall_cpu, _ = _replay_on(
        scale, "cpu", **SCALE_DEFAULTS)
    assert launches_cpu == 0, launches_cpu
    assert json.dumps(rec_cpu) == json.dumps(rec), "replay: cuda != cpu"
    _print_replay("on cpu (the sketch's plain version)", t_cpu, ghost_cpu,
                  wall_cpu, card)
    rec_i, _, _, launches_i, _, sketch = _replay_on(
        scale, "cuda", capture=True, **SCALE_DEFAULTS)
    assert json.dumps(rec_i) == json.dumps(rec), "replay: instrumented"
    assert launches_i == launches == len(sketch["kernel_ms"]), launches_i
    _print_sketch(sketch)
    print(f"    record byte-identical on cuda and cpu and equal to the "
          f"reference's modeled values; reuse_sketch launches {launches} "
          f"== n_steps; {rec['accesses'] / rec['n_steps']:.1f} accesses a "
          f"step (each one launch on the large path); peak host RSS "
          f"{rss:.1f} MiB before, {_peak_rss_mib():.1f} MiB after")

    # (c) run_compare: reduced on both devices, then full width on the card
    print("  (c) serving_scale's run_compare")
    # one set of weights on both devices: native init draws from each
    # device's own generator, so its seed alone gives the card and the CPU
    # different weights (and the report, which holds no token, the same)
    small = M.init_params(get_config(cfg.name, reduced=True), SEED,
                          device="cpu")
    weights = {"cpu": small, "cuda": _map(small, lambda t: t.to("cuda"))}
    got, walls, toks = {}, {}, {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            kernels.reset_launch_counts()
        t = time.perf_counter()
        got[dev], jobs = _session_jobs(lambda: serving_scale.run_compare(
            ["zipf"], smoke=True, seed=SEED, device=dev,
            params=weights[dev]))
        if dev == "cuda":
            torch.cuda.synchronize()
            add(kernels.launch_counts())
        walls[dev] = time.perf_counter() - t
        toks[dev] = [_tokens(js) for js in jobs]
    assert bench_json(got["cuda"]) == bench_json(got["cpu"]), \
        "run_compare (reduced): cuda != cpu"
    assert toks["cuda"] == toks["cpu"], "run_compare (reduced): tokens"
    n_tok = sum(len(t) for arm in toks["cpu"] for t in arm.values())
    print(f"    reduced {cfg.name} f32 (seed-{SEED} weights made on the "
          f"CPU, copied to the card), zipf, 6 jobs, horizon 48: the JSON "
          f"({len(bench_json(got['cpu']))} bytes) and every session's "
          f"tokens ({len(toks['cpu'])} arms, {n_tok} tokens) are identical "
          f"on the card (kernels) and the CPU (plain versions); wall "
          f"{walls['cuda']!r} s on cuda, {walls['cpu']!r} s on cpu")
    _compare_cells(got["cuda"], walls["cuda"], card, "reduced")
    del small, weights
    params = _native_params(cfg)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (full, buckets, lengths), jobs = _session_jobs(lambda: _race(
        cfg, params, ["zipf", "diurnal"], n_jobs=10, horizon=96))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    add(kernels.launch_counts())
    print(f"    full-width {cfg.name} bf16, 10 jobs, horizon 96 (verdicts "
          f"as measured):")
    _compare_cells(full, wall, card, "full-width")
    prompt = jobs[0][0].prompt
    bucket = min(1 << (len(prompt) - 1).bit_length(), RACE_MAX_LEN - 1)
    assert bucket in buckets, (bucket, buckets)
    _first_step(cfg, params, prompt, max_len=RACE_MAX_LEN, bucket=bucket)
    _race_kernels(cfg, buckets, lengths)
    del params, full
    torch.cuda.empty_cache()

    print(f"  launches in phase 14: {json.dumps(total)} (the economic "
          f"spec's fleet: {econ_launches})")
    for name, n in total.items():
        assert n > 0, f"{name} never launched in phase 14"
    print(f"  phase 14 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total

# --------------------------------------------------------------- phase 15
BENCH_MAX_LEN = 64             # the tenant and tiers benches' engines
TENANT_ARMS = ("gated", "shared", "no_adversary")
TIERS_SCENARIOS = ("moe_scan", "diurnal")


class _Noting:
    """Notes, at the class level of the port's platform, scheduler and
    engine, what a bench's runs do inside it, with no device work: every
    Platform.jobs list, each ContinuousScheduler.run's wall (host clock,
    `sync`ed) and decode steps, the bucket a prefill hands
    flash_attention and the lengths a decode step hands
    decode_attention."""

    def __init__(self, sync):
        from repro_torch.platform.compiler import Platform
        from repro_torch.serving.engine import DecodeEngine, _next_pow2
        from repro_torch.serving.scheduler import ContinuousScheduler
        self.jobs, self.runs, self.buckets, self.lengths = [], [], set(), set()
        jobs, run = Platform.jobs, ContinuousScheduler.run
        admit, step = DecodeEngine.admit, DecodeEngine.step
        note = self

        def noted_jobs(plat, *a, **k):
            note.jobs.append(jobs(plat, *a, **k))
            return note.jobs[-1]

        def noted_run(sched, *a, **k):
            sync()
            t = time.perf_counter()
            report = run(sched, *a, **k)
            sync()
            note.runs.append((time.perf_counter() - t,
                              report["decode_steps"]))
            return report

        def noted_admit(eng, req):
            note.buckets.add(min(_next_pow2(len(req.prompt)),
                                 eng.max_len - 1))
            return admit(eng, req)

        def noted_step(eng):
            if (eng.live & eng.active).any():
                note.lengths.add(tuple(eng.lengths.tolist()))
            return step(eng)

        self._patches = [(Platform, "jobs", jobs, noted_jobs),
                         (ContinuousScheduler, "run", run, noted_run),
                         (DecodeEngine, "admit", admit, noted_admit),
                         (DecodeEngine, "step", step, noted_step)]

    def __enter__(self):
        for cls, name, _, new in self._patches:
            setattr(cls, name, new)
        return self

    def __exit__(self, *exc):
        for cls, name, old, _ in self._patches:
            setattr(cls, name, old)

    def tokens(self):
        """Every session's generated tokens, one dict a run."""
        return [{j.sid: None if j.request is None else
                 list(j.request.generated) for j in jobs}
                for jobs in self.jobs]


def _rescaled(spec, blob, unit):
    """`spec` with its sizes in blob units (host DRAM and the policy's
    l_blk) moved from `unit` bytes a blob to `blob`."""
    hosts = tuple(dataclasses.replace(h, tiers={
        name: dataclasses.replace(t, capacity_bytes=t.capacity_bytes
                                  / unit * blob) if name == "dram" else t
        for name, t in h.tiers.items()}) for h in spec.hosts)
    return dataclasses.replace(
        spec, hosts=hosts, policy=dataclasses.replace(spec.policy,
                                                      l_blk=blob))


def _bench_arms(kind, out):
    """(label, cell) of each arm of a tenant (`kind` "tenants") or tiers
    bench's result, in the order the bench runs them."""
    from repro_torch.serving.tiers import ARM_ORDER
    if kind == "tenants":
        return [(arm, out[arm]) for arm in TENANT_ARMS]
    return [(f"{scen}/{arm}", out[scen][arm]) for scen in TIERS_SCENARIOS
            for arm in ARM_ORDER]


def _print_bench(kind, out, note, card):
    """Each arm's wall, decode steps and ms a step beside its modeled
    per_token_stall, $/token, tau_be and tau_pool; then the verdicts."""
    arms = _bench_arms(kind, out)
    assert len(arms) == len(note.runs), (len(arms), len(note.runs))
    for (label, cell), (wall, steps) in zip(arms, note.runs):
        rep = cell["report"]
        assert rep["decode_steps"] == steps, (label, steps)
        if kind == "tenants":
            priced = f"tau_be {json.dumps(cell['tau_be'], sort_keys=True)}"
        else:
            priced = (f"$/token {cell['costs']['per_token']!r}; tau_be "
                      f"{cell['tau_be']!r} s; tau_pool "
                      f"{cell.get('tau_pool')!r} s")
        print(f"    {label}: wall {wall!r} s (host clock, synchronised) "
              f"[{card}], {steps} decode steps, "
              f"{wall / max(steps, 1) * 1e3:.3f} ms of wall a decode step "
              f"(prefills, pauses and resumes inside); tokens "
              f"{rep['tokens']}, per_token_stall {rep['per_token_stall']!r}"
              f" s (modeled); {priced} (modeled)")
    if kind == "tenants":
        print(f"    verdicts: {json.dumps(out['verdicts'], sort_keys=True)}"
              f"; isolation_effective {out['isolation_effective']}")
    else:
        for scen in TIERS_SCENARIOS:
            cell = out[scen]
            print(f"    {scen}: wins {json.dumps(cell['wins'])}; advisor "
                  f"recommends {cell['advice']['recommended_arm']} "
                  f"(advice_agreement {cell['advice_agreement']})")
        print(f"    gpu_flash_wins_somewhere "
              f"{out['gpu_flash_wins_somewhere']}, pool_wins_somewhere "
              f"{out['pool_wins_somewhere']}")


def phase_tenants_tiers(cfg):
    """Declared tenants and the fourth tier: the tenant-isolation bench
    (serving/tenants.py, its default pack in three arms) and the
    fourth-tier bench (serving/tiers.py, the smoke packs in four arms,
    the pool and the GPU-direct lane) through Platform.compile ->
    Platform.scheduler. (a) the reference's geometry (reduced `cfg`,
    max_len 64, 4 slots) on the card and on the CPU over one weight set
    made on the CPU: each bench's JSON byte-identical and every session's
    tokens equal, and the reference tests' verdicts held on the card;
    (b) full-width `cfg` in bf16 (native seed-0 weights) on the card at
    max_len 64, each pack's blob-unit sizes (host DRAM, l_blk, the
    pool's capacity) rescaled to the engine's own blob at that width,
    verdicts printed as measured, the run held to the plain path by
    phase 4's first-step logits rule and by each serving kernel at the
    prefill buckets and length vectors the run launched. Returns the
    launches of the phase's bench runs on the card."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.obs import bench_json
    from repro_torch.serving import tenants, tiers

    t_phase = time.perf_counter()
    card = _smi()
    total = {n: 0 for n in SERVING_KERNELS + ("reuse_sketch",)}

    def bench(fn, device, **kw):
        """fn(device=device, **kw), noted; its launches added on the card.
        Returns (result, notes, wall)."""
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        if device == "cuda":
            kernels.reset_launch_counts()
        sync()
        t = time.perf_counter()
        with _Noting(sync) as note:
            out = fn(device=device, **kw)
        sync()
        wall = time.perf_counter() - t
        if device == "cuda":
            for n, c in kernels.launch_counts().items():
                if n in total:
                    total[n] += c
        return out, note, wall

    runs = {"tenants": (tenants.run_tenant_bench, {}),
            "tiers": (tiers.run_tiers_bench, {"smoke": True})}

    # (a) the reference's geometry on both devices
    small_cfg = get_config(cfg.name, reduced=True)
    small = tenants.bench_weights(small_cfg, "cpu")
    weights = {"cpu": small, "cuda": _map(small, lambda t: t.to("cuda"))}
    reduced = {}
    for kind, (fn, kw) in runs.items():
        got = {dev: bench(fn, dev, params=weights[dev], **kw)
               for dev in ("cuda", "cpu")}
        js = {dev: bench_json(got[dev][0]) for dev in got}
        assert js["cuda"] == js["cpu"], f"{kind} (reduced): cuda != cpu"
        toks = {dev: got[dev][1].tokens() for dev in got}
        assert toks["cuda"] == toks["cpu"], f"{kind} (reduced): tokens"
        n_tok = sum(len(t) for arm in toks["cpu"] for t in arm.values()
                    if t is not None)
        assert n_tok > 0 and all(t for arm in toks["cpu"]
                                 for t in arm.values()), kind
        print(f"  (a) {kind} bench, reduced {cfg.name} f32 (seed-0 weights "
              f"made on the CPU, copied to the card), max_len "
              f"{BENCH_MAX_LEN}, {MAX_SLOTS} slots: the JSON "
              f"({len(js['cpu'])} bytes) and every session's tokens "
              f"({len(toks['cpu'])} runs, {n_tok} tokens) are identical on "
              f"the card (kernels) and the CPU (plain versions); wall "
              f"{got['cuda'][2]!r} s on cuda, {got['cpu'][2]!r} s on cpu")
        _print_bench(kind, got["cuda"][0], got["cuda"][1], card)
        reduced[kind] = got["cuda"][0]
    # the reference tests' verdicts (tests/test_workload.py,
    # tests/test_fourth_tier.py): modeled, held on the card
    assert reduced["tenants"]["isolation_effective"], \
        reduced["tenants"]["verdicts"]
    r = reduced["tiers"]
    assert r["gpu_flash_wins_somewhere"] and r["pool_wins_somewhere"], r
    for scen in TIERS_SCENARIOS:
        assert r[scen]["advice_agreement"], (scen, r[scen]["advice"])
    del small, weights

    # (b) full width, the packs rescaled to the engine's blob
    blob = _blob_bytes(cfg, max_len=BENCH_MAX_LEN)
    assert blob == 2_359_296, blob
    unit = tenants.KV_BLOB_BYTES
    pool = tiers.default_pool_decl()
    pool = dataclasses.replace(
        pool, capacity_bytes=pool.capacity_bytes / unit * blob)
    full_kw = {
        "tenants": {"spec": _rescaled(tenants.tenant_pack(), blob, unit)},
        "tiers": {"packs": {k: _rescaled(v, blob, unit) for k, v in
                            tiers.scenario_packs(smoke=True).items()},
                  "pool": pool}}
    print(f"  (b) full-width {cfg.name} bf16, max_len {BENCH_MAX_LEN}, "
          f"{MAX_SLOTS} slots; blob-unit sizes rescaled from {unit} B to "
          f"the engine's blob {blob} B (host DRAM, l_blk, pool capacity "
          f"{pool.capacity_bytes!r} B); verdicts as measured")
    params = _native_params(cfg)
    buckets, lengths, first_jobs = set(), set(), None
    for kind, (fn, _) in runs.items():
        out, note, wall = bench(fn, "cuda", params=params, cfg=cfg,
                                **full_kw[kind])
        specs = full_kw[kind].get("packs") or {kind: full_kw[kind]["spec"]}
        print(f"  {kind} bench: " + "; ".join(
            f"{name} DRAM {sp.hosts[0].dram_capacity()!r} B "
            f"({sp.hosts[0].dram_capacity() / blob:g} blobs), l_blk "
            f"{sp.policy.l_blk}" for name, sp in specs.items())
            + f"; wall {wall!r} s (host clock, synchronised) [{card}]")
        _print_bench(kind, out, note, card)
        buckets |= note.buckets
        lengths |= note.lengths
        first_jobs = first_jobs or note.jobs[0]
    buckets, lengths = sorted(buckets), sorted(lengths)
    prompt = first_jobs[0].prompt
    bucket = min(1 << (len(prompt) - 1).bit_length(), BENCH_MAX_LEN - 1)
    assert bucket in buckets, (bucket, buckets)
    _first_step(cfg, params, prompt, max_len=BENCH_MAX_LEN, bucket=bucket)
    assert BENCH_MAX_LEN == RACE_MAX_LEN       # _race_kernels' cache rows
    _race_kernels(cfg, buckets, lengths, what="the benches'")
    del params
    torch.cuda.empty_cache()

    print(f"  launches in phase 15: {json.dumps(total)}")
    for name, n in total.items():
        assert n > 0, f"{name} never launched in phase 15"
    print(f"  phase 15 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


# --------------------------------------------------------------- phase 24
# gemma-2b with Gemma 2's attention features (arXiv:2408.00118 section
# 2.1; Hugging Face `Gemma2Config`): its 18 layers as 9 groups of a local
# layer (a sliding window of 4,096) and a global one, every layer's scores
# capped at 50 and the logits at 30. No reference config turns these on;
# the reference's model implements them, and the port runs them inside
# both attention kernels, with the reference's int8 KV cache.
G2_ARCH = "gemma-2b"
G2_NAME = "gemma-2b-gemma2"
G2_GROUPS = 9
G2_WINDOW = 4096
G2_SOFTCAP = 50.0
G2_FINAL_SOFTCAP = 30.0
G2_MAX_LEN = 8192              # gemma-2b's max_seq, the engine's max_len
G2_DECODE_T = (1024, G2_MAX_LEN)
G2_FLASH_S = (700, 4097, G2_MAX_LEN - 1)   # the prefill's top bucket
# five prompts that cross the window and one under it (served), then two
# that cross it (paused and resumed)
G2_PROMPTS = ((4200, 6001), (700, 701), (4200, 6001), (4200, 6001),
              (4200, 6001), (4200, 6001), (4200, 6001), (4200, 6001))
G2_INT8_STEPS = 32
G2_MARGIN = 2e-2               # top-2 margin past which greedy tokens hold
# q scaled up in the kernel checks of a score cap, so that scores reach
# the cap (unit q and k give scores of ~1 at head_dim 256)
G2_CAP_Q = 40.0


def _gemma2_config():
    """Full-width gemma-2b with Gemma 2's attention features."""
    from repro_torch.configs import get_config
    base = get_config(G2_ARCH)
    attn, ffn = base.pattern[0]
    local = dataclasses.replace(attn, sliding_window=G2_WINDOW,
                                logit_softcap=G2_SOFTCAP)
    glob = dataclasses.replace(attn, logit_softcap=G2_SOFTCAP)
    return dataclasses.replace(base, name=G2_NAME, n_groups=G2_GROUPS,
                               pattern=((local, ffn), (glob, ffn)),
                               final_logit_softcap=G2_FINAL_SOFTCAP)


def _gemma2_prompts(vocab: int, rng):
    import numpy as np
    return [rng.integers(1, vocab, int(rng.integers(lo, hi))).astype(
        np.int32) for lo, hi in G2_PROMPTS]


def _decode_forms(T):
    """(label, lengths, window, softcap, int8) of decode attention's forms
    on this path at T positions: the int8 cache (ragged lengths, then 0
    and past T), the window at lengths whose window starts mid-chunk, at
    a chunk's edge and past the row's start (at T = 1,024 no row is past
    4,096, so a window of 100 stands in for the window's edges), the cap,
    and all three."""
    ragged, edge = _long_lengths(T), (0, 5, T + 100, 300)
    if T >= G2_MAX_LEN:
        win, win_edge, w_edge = (8192, 6000, 4097, 4096), \
            (1, 4127, 8191, 0), G2_WINDOW
    else:
        win, win_edge, w_edge = (T, T - 24, T // 2 + 1, 1), \
            (1, 1000, 101, 33), 100
    return [("int8", ragged, 0, 0.0, True),
            ("int8, 0 and > T", edge, 0, 0.0, True),
            ("window", win, G2_WINDOW, 0.0, False),
            ("window edges", win_edge, w_edge, 0.0, False),
            ("softcap", ragged, 0, G2_SOFTCAP, False),
            ("int8 + window + softcap", win, G2_WINDOW, G2_SOFTCAP, True)]


def _flash_forms(S):
    """(label, window, softcap) of flash attention's forms at S: a local
    layer (window and cap), a global one (cap), the window alone, and at
    S = 700, where 4,096 masks nothing, windows of 100 and 1 (a window
    that starts mid-tile, and the diagonal alone)."""
    forms = [("local", G2_WINDOW, G2_SOFTCAP), ("global", 0, G2_SOFTCAP),
             ("window", G2_WINDOW, 0.0)]
    if S < G2_WINDOW:
        forms += [("window 100", 100, 0.0), ("window 1", 1, G2_SOFTCAP)]
    return forms


def _gemma2_kernels(cfg):
    """(a): decode attention's and flash attention's forms at this
    config's shapes (q [4,8,256] on k,v [4,1,T,256] at T = 1,024 and
    8,192; q [1,8,S,256] on k,v [1,1,S,256] at S = 700, 4,097 and 8,191,
    in the prefill's strided layout too), in float32 and bf16 against
    their plain versions (TOL, all finite), then timed in bf16 beside the
    library call and the bound: each decode form at both T over distinct
    caches past L2, and each flash form at each S."""
    import torch
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.models.attention import quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    attn = _attn_specs(cfg)[0]
    H, KV, hd = attn.n_heads, attn.n_kv, attn.head_dim
    scale = 1.0 / math.sqrt(hd)
    bf16 = torch.bfloat16

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def cache(T, dtype, int8):
        k, v = (randn(MAX_SLOTS, KV, T, hd, dtype=dtype) for _ in "kv")
        if not int8:
            return k, v
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        return k8, v8, ks, vs

    def decode(fn, q, c, lengths, window, softcap):
        sc = dict(k_scale=c[2], v_scale=c[3]) if len(c) == 4 else {}
        return fn(q, c[0], c[1], lengths, scale=scale, window=window,
                  softcap=softcap, **sc)

    for T in G2_DECODE_T:
        for dt in (torch.float32, bf16):
            name = str(dt).split(".")[1]
            plain_c, int8_c = cache(T, dt, False), cache(T, dt, True)
            for label, lens, window, softcap, int8 in _decode_forms(T):
                q = randn(MAX_SLOTS, H, hd, dtype=dt) * (
                    G2_CAP_Q if softcap else 1.0)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                c = int8_c if int8 else plain_c
                got = decode(decode_attention, q, c, lengths, window,
                             softcap)
                assert bool(torch.isfinite(got).all()), (T, label, name)
                _check("decode_attention", got,
                       decode(reference_decode_attention, q, c, lengths,
                              window, softcap),
                       name, f"T={T} {label} {name}")
            del plain_c, int8_c
        forms = _decode_forms(T)
        for label, lens, window, softcap, int8 in [forms[i]
                                                   for i in (0, 2, 4, 5)]:
            one = 2 * MAX_SLOTS * KV * T * hd * (1 if int8 else 2)
            caches = [cache(T, bf16, int8)
                      for _ in range(L2_BYTES // one + 2)]
            q = randn(MAX_SLOTS, H, hd, dtype=bf16) * (
                G2_CAP_Q if softcap else 1.0)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            err = _check("decode_attention",
                         decode(decode_attention, q, caches[0], lengths,
                                window, softcap),
                         decode(reference_decode_attention, q, caches[0],
                                lengths, window, softcap),
                         "bfloat16", f"timed T={T} {label} bf16")
            _print_record("decode_attention", _decode_record(
                q, caches, lengths, scale, err, window, softcap))
            del caches
        torch.cuda.empty_cache()

    for S in G2_FLASH_S:
        for dt in (torch.float32, bf16):
            name = str(dt).split(".")[1]
            # the prefill's own layout: q a transposed [B,S,H,hd]
            # projection, k and v the first S rows of a max_len cache
            kc = randn(1, KV, G2_MAX_LEN, hd, dtype=dt)
            vc = randn(1, KV, G2_MAX_LEN, hd, dtype=dt)
            for label, window, softcap in _flash_forms(S):
                boost = G2_CAP_Q if softcap else 1.0
                kw = dict(scale=scale, window=window, softcap=softcap)
                q, k, v = (randn(1, n, S, hd, dtype=dt) for n in (H, KV, KV))
                q = q * boost
                got = flash_attention(q, k, v, **kw)
                assert bool(torch.isfinite(got).all()), (S, label, name)
                _check("flash_attention", got,
                       reference_attention(q, k, v, **kw), name,
                       f"S={S} {label} {name}")
                q = randn(1, S, H, hd, dtype=dt).transpose(1, 2) * boost
                _check("flash_attention",
                       flash_attention(q, kc[:, :, :S], vc[:, :, :S], **kw),
                       reference_attention(q, kc[:, :, :S], vc[:, :, :S],
                                           **kw),
                       name, f"strided views S={S} {label} {name}")
            del kc, vc
        for label, window, softcap in _flash_forms(S)[:3]:
            boost = G2_CAP_Q if softcap else 1.0
            ins = [tuple(randn(1, n, S, hd, dtype=bf16) * (
                boost if n == H else 1.0) for n in (H, KV, KV))
                for _ in range(4)]
            kw = dict(scale=scale, window=window, softcap=softcap)
            err = _check("flash_attention", flash_attention(*ins[0], **kw),
                         reference_attention(*ins[0], **kw), "bfloat16",
                         f"timed S={S} {label} bf16")
            _print_record("flash_attention", _flash_record(
                ins, scale, err, window=window, softcap=softcap))
            del ins
        torch.cuda.empty_cache()


def _slot_copy(dst, src, slot):
    """A batch-1 cache `src` copied into slot `slot` of `dst` (grouped
    leaves [G,B,...], tail leaves [B,...])."""
    for part, subs in dst.items():
        for key, leaves in subs.items():
            for n, t in leaves.items():
                if part == "groups":
                    t[:, slot].copy_(src[part][key][n][:, 0])
                else:
                    t[slot].copy_(src[part][key][n][0])


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(cache))


def _int8_check(cfg, params, prompts, card):
    """(c) the int8 KV cache on (b)'s weights: `init_cache(cfg, 4, 8192,
    dtype=torch.int8)`, the first four prompts prefilled one a slot (at
    their bucket, as the engine pads them), then G2_INT8_STEPS greedy
    decode steps through the kernels and through the plain path, both fed
    the plain path's greedy tokens: the first step's logits held by the
    first-step rule (twice the plain bf16 path's distance from the plain
    float32 path over the same int8 cache), the kernels' greedy token
    equal to the plain path's wherever its top-2 margin exceeds
    G2_MARGIN; the cache bytes against a bf16 cache's and the logits'
    distance from the kernels' run over the bf16 cache printed (the
    quantization's own, not held). Returns the int8 and bf16 caches and
    the slots' next indices, for `_int8_times`."""
    import numpy as np
    import torch
    from repro_torch.models import model as M

    reqs = prompts[:MAX_SLOTS]
    T = G2_MAX_LEN
    lens = [len(p) for p in reqs]

    def prefilled(dtype, compute, plain):
        cache = M.init_cache(cfg, MAX_SLOTS, T, dtype, "cuda")
        first = []
        for slot, p in enumerate(reqs):
            toks = np.zeros(_bucket(len(p), T), np.int64)
            toks[:len(p)] = p
            one = M.init_cache(cfg, 1, T, dtype, "cuda")
            one, logits = M.prefill(
                params, cfg, torch.as_tensor(toks[None], device="cuda"), one,
                compute_dtype=compute, last_index=len(p) - 1, plain=plain)
            _slot_copy(cache, one, slot)
            first.append(logits[0].float())
            del one
        return cache, torch.stack(first)

    def step(cache, tok, index, compute, plain):
        return M.decode_step(
            params, cfg, torch.as_tensor(tok[:, None], device="cuda"), cache,
            torch.as_tensor(index, device="cuda"), compute_dtype=compute,
            plain=plain)[1].float()

    runs = {"kernels, int8": (torch.int8, torch.bfloat16, False),
            "plain, int8": (torch.int8, torch.bfloat16, True),
            "kernels, bf16 cache": (torch.bfloat16, torch.bfloat16, False)}
    caches, logits = {}, {}
    for label, (dtype, compute, plain) in runs.items():
        caches[label], logits[label] = prefilled(dtype, compute, plain)
    truth = prefilled(torch.int8, torch.float32, True)[1]
    kern, plain = logits["kernels, int8"], logits["plain, int8"]
    err = float((kern - plain).abs().max())
    noise = float((plain - truth).abs().max())
    print(f"  int8 first-step logits [{MAX_SLOTS},{cfg.vocab}] (prompts "
          f"{lens}, max_len {T}): kernels vs plain bf16 max_abs_err="
          f"{err:.4e}; plain bf16 vs float32 {noise:.4e}; kernels vs "
          f"float32 {float((kern - truth).abs().max()):.4e}")
    assert err <= 2 * noise, (err, noise)
    del truth
    index = np.array(lens, np.int64)
    held = tried = 0
    dist = [float((kern - logits["kernels, bf16 cache"]).abs().max())]
    for i in range(G2_INT8_STEPS):
        top2 = plain.topk(2, dim=-1).values
        sep = (top2[:, 0] - top2[:, 1] > G2_MARGIN).cpu().numpy()
        want = plain.argmax(-1).cpu().numpy()
        got = kern.argmax(-1).cpu().numpy()
        assert (got[sep] == want[sep]).all(), (i, got, want, sep)
        held += int(sep.sum())
        tried += len(sep)
        tok = want.astype(np.int64)
        kern = step(caches["kernels, int8"], tok, index, torch.bfloat16,
                    False)
        plain = step(caches["plain, int8"], tok, index, torch.bfloat16, True)
        dist.append(float((kern - step(caches["kernels, bf16 cache"], tok,
                                       index, torch.bfloat16, False))
                          .abs().max()))
        index = index + 1
    print(f"  int8 greedy decode, {G2_INT8_STEPS} steps of {MAX_SLOTS} "
          f"slots fed the plain path's tokens: the kernels' token == the "
          f"plain path's at the {held} of {tried} slot-steps whose top-2 "
          f"margin exceeds {G2_MARGIN} [{card}]")
    print(f"  int8 vs bf16 cache (the kernels' logits, the quantization's "
          f"own distance, not held): first step {dist[0]:.4e}, over "
          f"{G2_INT8_STEPS} steps max {max(dist):.4e}")
    b8, b16 = (_cache_bytes(caches[k]) for k in ("kernels, int8",
                                                "kernels, bf16 cache"))
    print(f"  cache bytes at {MAX_SLOTS} slots x {T} positions: int8 {b8} "
          f"B (K/V and bf16 scales) vs bf16 {b16} B, {b8 / b16:.4f}x")
    assert b8 < 0.53 * b16, (b8, b16)
    return {k: caches[k] for k in ("kernels, int8", "kernels, bf16 cache")}, \
        index


def _int8_times(cfg, params, caches, index, card):
    """One decode step at the slots' `index` over (c)'s int8 cache against
    its bf16 cache: the step's decode_attention launches (device time)
    and the whole step as the host launches it (CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention
    from repro_torch.models import model as M

    def step(cache, tok, index):
        return M.decode_step(
            params, cfg, torch.as_tensor(tok[:, None], device="cuda"), cache,
            torch.as_tensor(index, device="cuda"),
            compute_dtype=torch.bfloat16)

    lengths = torch.as_tensor(index + 1, dtype=torch.int32, device="cuda")
    tok = np.ones(MAX_SLOTS, np.int64)
    attn = _attn_specs(cfg)[0]
    q = torch.randn(MAX_SLOTS, attn.n_heads, attn.head_dim,
                    device="cuda").to(torch.bfloat16)
    times = {}
    for label in ("kernels, int8", "kernels, bf16 cache"):
        c = caches[label]
        layers = [(c["groups"][key], g, spec)
                  for g in range(cfg.n_groups)
                  for key, spec in (("L0S0", cfg.pattern[0][0]),
                                    ("L1S0", cfg.pattern[1][0]))]

        def attn_step(layers=layers):
            for leaves, g, spec in layers:
                sc = ({"k_scale": leaves["k_scale"][g],
                       "v_scale": leaves["v_scale"][g]}
                      if "k_scale" in leaves else {})
                decode_attention(q, leaves["k"][g], leaves["v"][g], lengths,
                                 scale=spec.head_dim ** -0.5,
                                 window=spec.sliding_window,
                                 softcap=spec.logit_softcap, **sc)
        times[label] = (
            _time_ms([attn_step], iters=10),
            _time_ms([lambda c=c: step(c, tok, index)], iters=10,
                     queued=False))
    (a8, s8), (a16, s16) = times["kernels, int8"], \
        times["kernels, bf16 cache"]
    print(f"  one decode step at lengths {lengths.tolist()}: the "
          f"{cfg.n_layers} decode_attention launches {a8:.4f} ms over "
          f"int8 vs {a16:.4f} ms over bf16 (device time, CUDA events); "
          f"the whole step, the host launching as the path does, "
          f"{s8:.4f} ms vs {s16:.4f} ms (CUDA events; the int8 step also "
          f"quantizes each layer's new K and V row) [{card}]")


def phase_gemma2():
    """Phase 24: gemma-2b with Gemma 2's attention features at full width
    (`_gemma2_config`): (a) `_gemma2_kernels`; (b) serve_tiered_kv's spec
    at max_len 8,192 and 4 slots through Platform.compile ->
    Platform.engine on native bf16 weights: the first-step check on the
    first prompt at its bucket (8,191 rows), 18 flash launches a prefill,
    18 decode-attention launches a step and 37 norms each, six requests
    (five of 4,200-6,000 tokens, across the window, and one of 700), the
    example's flow, a pause to flash and a prefetched resume with the
    unbroken run's greedy tokens, one prefill and one decode step
    profiled; (c) `_int8_check`. Runs no decode windows. Returns the
    launches of (b) and (c)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.policy import Tier
    from repro_torch.platform import Platform

    t_phase = time.perf_counter()
    card = _smi()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = _gemma2_config()
    prompts = _gemma2_prompts(cfg.vocab, np.random.default_rng(SEED + 24))
    blob = _blob_bytes(cfg, G2_MAX_LEN)
    local, glob = _attn_specs(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} groups of "
          f"a local layer, window {local.sliding_window}, and a global "
          f"one), d_model {cfg.d_model}, {local.n_heads} heads / "
          f"{local.n_kv} kv of {local.head_dim}, score cap "
          f"{local.logit_softcap:g} ({glob.logit_softcap:g} global), final "
          f"cap {cfg.final_logit_softcap:g}; prompts "
          f"{[len(p) for p in prompts]}, buckets "
          f"{sorted({_bucket(len(p), G2_MAX_LEN) for p in prompts})}; a "
          f"paused blob {blob} B at {G2_MAX_LEN} positions [{card}]")
    print(f"  (a) the attention kernels' forms at its shapes [{card}]")
    _, t_a = _timed(_gemma2_kernels, cfg)
    if _FLEX:
        # flex_attention's compile worker processes end here
        from torch._inductor.async_compile import shutdown_compile_workers
        shutdown_compile_workers()

    print(f"  (b) Platform.compile -> Platform.engine, max_len "
          f"{G2_MAX_LEN} [{card}]")
    params = _native_params(cfg)
    (per_prefill, per_step), t_check = _timed(
        _first_step, cfg, params, prompts[0], G2_MAX_LEN,
        _bucket(len(prompts[0]), G2_MAX_LEN))
    assert per_prefill["flash_attention"] == _attn_layers(cfg) == 18, \
        per_prefill
    assert per_step["decode_attention"] == 18, per_step
    platform = Platform.compile(_example_spec(cfg, G2_MAX_LEN),
                                device="cuda")
    eng = platform.engine(cfg, params, max_slots=MAX_SLOTS,
                          max_len=G2_MAX_LEN, compute_dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    _, flow_tiers, wall = _example_flow(eng, platform.clock, prompts)
    print(f"  served {N_REQUESTS} requests, {N_REQUESTS * MAX_NEW} tokens, "
          f"in {wall:.3f} s (host clock, synchronised); the example's "
          f"paused tiers {flow_tiers[:3]}, cold session on {flow_tiers[-1]}"
          f" before its prefetch [{card}]")
    assert flow_tiers[-1] == Tier.FLASH.name, flow_tiers
    (tiers, t_pause, t_restore), t_pr = _timed(
        _pause_resume, eng, platform.clock, prompts)
    print(f"  pause and resume: paused to {tiers[:2]}, the colder then on "
          f"{tiers[2]} and resumed through a prefetch; greedy tokens of "
          f"both sessions == a run without a break; one pause of the "
          f"{blob} B blob {t_pause!r} s, its restore from flash "
          f"{t_restore!r} s (host clock, synchronised) [{card}]")
    assert eng._slot_blob(0)[0].nbytes == blob, "the engine's blob size"
    _, t_prof = _timed(_profile_split, eng, prompts)
    del eng, platform
    torch.cuda.empty_cache()

    print(f"  (c) the int8 KV cache on the same weights [{card}]")
    (caches, index), t_c = _timed(_int8_check, cfg, params, prompts, card)
    counts = kernels.launch_counts()
    counts = {name: counts[name] for name in SERVING_KERNELS}
    print(f"  launches in phase 24 (b) and (c): {json.dumps(counts)}")
    for name, n in counts.items():
        assert n > 0, f"{name} never launched in phase 24"
    # timed apart from the path, its launches uncounted
    _int8_times(cfg, params, caches, index, card)
    del caches, params
    torch.cuda.empty_cache()
    print(f"  phase 24's parts, host clock: (a) {t_a:.1f} s, first-step "
          f"check {t_check:.1f} s, example's flow {wall:.1f} s, pause and "
          f"resume {t_pr:.1f} s, profile {t_prof:.1f} s, (c) {t_c:.1f} s; "
          f"wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts


# --------------------------------------------------------------- phase 25
# Training on the card: the two backward kernels against their plain
# versions, one float32 step of every reduced config on the card against
# the CPU, and full-width gemma-2b trained for TRAIN_STEPS steps.
TRAIN_ARCH = "gemma-2b"
TRAIN_SEQ = 1024
TRAIN_BATCH = 2
TRAIN_STEPS = 5
HOLD_GROUPS = 4                # (c)'s gradient hold: the first 4 groups
# the float32 state a parameter: weights, grads, mu and nu
STATE_BYTES_A_PARAM = 16
# (a): flash_attention_bwd's forms (label, q shape, k/v shape, causal,
# window, softcap, whether SDPA's backward computes the same function)
FLASH_BWD_FORMS = (
    ("gemma-2b training", (2, 8, 1024, 256), (2, 1, 1024, 256), True, 0,
     0.0, True),
    ("MHA, deepseek-7b's heads", (1, 32, 512, 128), (1, 32, 512, 128), True,
     0, 0.0, True),
    ("GQA 4:1", (1, 32, 512, 128), (1, 8, 512, 128), True, 0, 0.0, True),
    ("whisper cross", (1, 16, 605, 64), (1, 16, 1500, 64), False, 0, 0.0,
     True),
    ("window 256, cap 50", (1, 8, 700, 256), (1, 1, 700, 256), True, 256,
     50.0, False),
    ("S = 1", (1, 8, 1, 128), (1, 2, 300, 128), False, 0, 0.0, True),
    ("T = 1", (1, 8, 37, 128), (1, 2, 1, 128), False, 0, 0.0, True),
    ("S = T = 1", (1, 8, 1, 128), (1, 2, 1, 128), True, 0, 0.0, True),
)
# head dims the wrapper pads (112 -> 128 in bf16, 16 -> 32 in float32),
# through the autograd route
FLASH_BWD_PADDED = ((1, 8, 300, 112), (1, 2, 300, 112)), \
    ((1, 8, 300, 16), (1, 2, 300, 16))
RMS_BWD_SHAPES = (((2048, 2048), "bfloat16"), ((2048, 2048), "float32"),
                  ((605, 7168), "float32"), ((1023, 2050), "bfloat16"))
# (b): the reduced configs' batch, whose 40 positions cross a 32-row tile
REDUCED_SEQ = 40
# (b)'s MoE configs: held where every routing choice clears this margin
# between the k-th and the (k+1)-th router logit, as
# tests/test_torch_model.py holds bf16 logits past its ROUTE_MARGIN (0.03,
# bf16's resolution at those logits). Here both devices compute the
# router's product in float32, in another summation order, so logits
# differ by ~1e-6 and a gap of 1e-4 cannot swap an expert; at 0.03 a
# reduced MoE config's 80 tokens are never held (its least gaps are
# ~0.008)
TRAIN_ROUTE_MARGIN = 1e-4
# (b)'s reduced Gemma 2 (tests/test_torch_model.py's `gemma2`)
REDUCED_G2 = dict(window=5, softcap=0.3, final=1.0)


def _dtype(name):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _grad_hold(label, got, plain, plain_f32, out_dtypes):
    """A backward kernel's outputs against its plain version's on the same
    inputs. A float32 output: max abs error <= 1e-4 x the plain float32
    outputs' largest |value| (over all of the call's outputs of that rule:
    dq and dk are 0 in exact arithmetic when T = 1). A bf16 output: its
    distance from the plain float32 version at most twice the plain bf16
    version's own (the first-step rule). Returns the max abs error against
    the plain version in the working type."""
    import torch
    f32 = [i for i, d in enumerate(out_dtypes) if d == torch.float32]
    bf = [i for i, d in enumerate(out_dtypes) if d == torch.bfloat16]
    if f32:
        top = max(float(plain_f32[i].abs().max()) for i in f32)
        err = max(float((got[i].float() - plain_f32[i]).abs().max())
                  for i in f32)
        assert err <= 1e-4 * top, f"{label}: float32 {err:.3e} > 1e-4 x " \
            f"{top:.3e}"
    if bf:
        own = max(float((plain[i].float() - plain_f32[i]).abs().max())
                  for i in bf)
        err = max(float((got[i].float() - plain_f32[i]).abs().max())
                  for i in bf)
        assert err <= 2 * own, f"{label}: bf16 {err:.3e} > 2 x {own:.3e}"
    return max(float((g.float() - p.float()).abs().max())
               for g, p in zip(got, plain))


# the bf16 form's passes, by the names of their kernels
BWD_PASS_KERNELS = (("rows", "flash_bwd_rows_tc"),
                    ("dk/dv", "flash_bwd_dkdv_tc"),
                    ("group sum", "flash_bwd_group_sum"),
                    ("dq", "flash_bwd_dq_tc"))
BWD_PASS_CALLS = 10            # calls profiled for the split


def _flash_bwd_passes(call, label):
    """Prints the device time of each pass of flash_attention_bwd's bf16
    form, a call's mean over BWD_PASS_CALLS calls under torch.profiler, by
    kernel name."""
    ops, _ = _profiled(lambda: [call() for _ in range(BWD_PASS_CALLS)])
    split = {name: sum(e.device_time_total for e in ops if key in e.key)
             / 1e3 / BWD_PASS_CALLS for name, key in BWD_PASS_KERNELS}
    assert split["rows"] and split["dk/dv"] and split["dq"], split
    print(f"  passes of flash_attention_bwd {label} (torch.profiler, the "
          f"mean of {BWD_PASS_CALLS} calls): " + ", ".join(
              f"{name} {ms:.4f} ms" for name, ms in split.items())
          + f"; sum {sum(split.values()):.4f} ms")


def _library_grad_hold(label, got, plain_f32, dtype_name):
    """A library call's gradients against the plain float32 version's:
    max abs error <= TOL's atol + rtol x the plain outputs' largest
    |value|: TOL's terms on the scale of the largest gradient, as
    `_grad_hold` holds a float32 output. Returns the max abs error."""
    top = max(float(w.abs().max()) for w in plain_f32)
    err = max(float((g.float() - w).abs().max())
              for g, w in zip(got, plain_f32))
    tol = TOL[dtype_name]["atol"] + TOL[dtype_name]["rtol"] * top
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"
    return err


def _flash_bwd_case(form, dtype_name, gen):
    """flash_attention_bwd at one form and type against
    reference_attention_bwd on the card, a bitwise repeat, and its times.
    Returns (the record, a call of the kernel on the form's inputs)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import \
        reference_attention_bwd
    label, qs, ks, causal, window, softcap, has_lib = form
    dt = _dtype(dtype_name)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in (qs, ks, ks))
    if softcap:
        q = q * G2_CAP_Q           # scores that reach the cap
    dout = torch.randn(qs, generator=gen, device="cuda").to(dt)
    kw = dict(scale=qs[-1] ** -0.5, causal=causal, window=window,
              softcap=softcap)
    with torch.no_grad():
        out = flash_attention(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        f"flash_attention_bwd {label} {dtype_name}: repeat differs"
    assert all(bool(torch.isfinite(g).all()) for g in got)
    plain = reference_attention_bwd(q, k, v, out, dout, **kw)
    plain_f32 = reference_attention_bwd(
        *(t.float() for t in (q, k, v, out, dout)), **kw)
    err = _grad_hold(f"flash_attention_bwd {label}", got, plain, plain_f32,
                     [dt] * 3)
    print(f"  check flash_attention_bwd {label} q {list(qs)} k,v "
          f"{list(ks)} {dtype_name}: max_abs_err={err:.3e} (plain max "
          f"{max(float(t.abs().max()) for t in plain_f32):.3e}), repeat "
          f"bitwise ok")
    B, H, S, hd = qs
    KV, T = ks[1], ks[2]
    i = torch.arange(S, device="cuda")[:, None]
    j = torch.arange(T, device="cuda")[None, :]
    seen = torch.ones(S, T, dtype=torch.bool, device="cuda")
    if causal:
        seen = i >= j
        if window:
            seen &= i - j < window
    pairs = int(seen.sum()) * B * H
    nbytes = (4 * B * H * S * hd + 4 * B * KV * T * hd) * q.element_size()
    b_ms, b_by = _bound_ms(nbytes, 10 * pairs * hd, dt)
    calls = [lambda: flash_attention_bwd(q, k, v, out, dout, **kw)]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if has_lib:
        import torch.nn.functional as F
        o = F.scaled_dot_product_attention(*leaves, scale=kw["scale"],
                                           is_causal=causal, enable_gqa=True)
        lib_ms = _time_ms([lambda: torch.autograd.grad(
            o, leaves, dout, retain_graph=True)], iters=5)
    else:
        # compiled flex_attention: the cap its score_mod, the causal
        # window its block mask (as phase 24 times the forward), its
        # gradients held to the plain float32 ones before they are timed.
        # Its backward is compiled without donated buffers, which would
        # refuse the retained graph that the timing calls it on again
        import torch._functorch.config as functorch_config
        assert softcap and causal, "flex is timed for the capped forms"
        band = ((lambda b, i, j: (i >= j) & (i - j < window)) if window
                else (lambda b, i, j: i >= j))
        with functorch_config.patch(donated_buffer=False):
            o = _capped_flex(softcap, band, B, S, T, kw["scale"],
                             "cuda")(*leaves)
            lib_err = _library_grad_hold(
                f"flex_attention's backward {label} {dtype_name}",
                torch.autograd.grad(o, leaves, dout, retain_graph=True),
                plain_f32, dtype_name)
            lib_ms = _time_ms([lambda: torch.autograd.grad(
                o, leaves, dout, retain_graph=True)], iters=5)
        own = max(float((g.float() - w).abs().max())
                  for g, w in zip(got, plain_f32))
        print(f"  check library flash_attention_bwd {label} {dtype_name}: "
              f"autograd through compiled flex_attention, max_abs_err "
              f"{lib_err:.3e} from the plain float32 gradients (the "
              f"kernel's {own:.3e}) ok")
    return dict(
        shape=(f"q {list(qs)} k,v {list(ks)} {dtype_name}"
               f"{'' if causal else ' non-causal'}"
               f"{f' window {window}' if window else ''}"
               f"{f' softcap {softcap:g}' if softcap else ''}"),
        max_abs_err=err, ms=_time_ms(calls, iters=5),
        launch_ms=_time_ms(calls, iters=5, queued=False),
        plain_ms=_time_ms([lambda: reference_attention_bwd(
            q, k, v, out, dout, **kw)], iters=3),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by), calls[0]


def _flash_bwd_padded(qs, ks, dtype_name, gen):
    """flash_attention's autograd route (the Function inside the head_dim
    padding) at a head_dim the wrapper pads, against the plain backward at
    the true head_dim on the kernel's own forward output."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.kernels.flash_attention.ref import \
        reference_attention_bwd
    dt = _dtype(dtype_name)
    leaves = [torch.randn(s, generator=gen, device="cuda").to(
        dt).requires_grad_() for s in (qs, ks, ks)]
    dout = torch.randn(qs, generator=gen, device="cuda").to(dt)
    kw = dict(scale=qs[-1] ** -0.5, causal=True)
    out = flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, dout)
    ins = [t.detach() for t in leaves] + [out.detach(), dout]
    plain = reference_attention_bwd(*ins, **kw)
    plain_f32 = reference_attention_bwd(*(t.float() for t in ins), **kw)
    err = _grad_hold(f"flash_attention_bwd padded hd {qs[-1]}", got, plain,
                     plain_f32, [dt] * 3)
    print(f"  check flash_attention_bwd through the padding, hd {qs[-1]} -> "
          f"{kernel_head_dim(qs[-1], dt)} {dtype_name}: max_abs_err="
          f"{err:.3e} ok")


def _rms_bwd_case(shape, dtype_name, fused, gen, timed):
    """rmsnorm_bwd (fused: the add form) at one shape and type against its
    plain version on the card (dx by its type's rule, dscale float32 by
    the float32 rule), a bitwise repeat, and its times. Returns the
    record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
    from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm_bwd
    dt = _dtype(dtype_name)
    D = shape[-1]
    x, g = (torch.randn(shape, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    gs = (torch.randn(shape, generator=gen, device="cuda").to(dt)
          if fused else None)
    scale = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    eps = 1e-6
    got = rmsnorm_bwd(x, g, scale, eps, gs)
    again = rmsnorm_bwd(x, g, scale, eps, gs)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        f"rmsnorm_bwd {shape} {dtype_name}: repeat differs"
    plain = reference_rmsnorm_bwd(x, g, scale, eps, gs)
    plain_f32 = reference_rmsnorm_bwd(
        x.float(), g.float(), scale, eps, None if gs is None else gs.float())
    form = "add_rmsnorm" if fused else "rmsnorm"
    err = _grad_hold(f"rmsnorm_bwd {form} {shape}", got, plain, plain_f32,
                     [dt, torch.float32])
    print(f"  check rmsnorm_bwd ({form}) x {list(shape)} {dtype_name}: "
          f"max_abs_err={err:.3e} (dx and dscale), repeat bitwise ok")
    if not timed:
        return None
    rows = x.numel() // D
    nbytes = (3 + fused) * x.numel() * x.element_size() + 8 * D
    b_ms, b_by = _bound_ms(nbytes, 8 * x.numel(), dt)
    # the library's weight in x's type, as phase 3 times F.rms_norm (a
    # float32 weight on bf16 rows takes its unfused path)
    xs, ss = x.detach().requires_grad_(), scale.to(dt).requires_grad_()
    if fused:
        xl, rl = (t.detach().requires_grad_() for t in (x, x))
        summed = xl + rl
        y = F.rms_norm(summed, (D,), ss, eps)
        lib = [lambda: torch.autograd.grad((y, summed), (xl, rl, ss),
                                           (g, gs), retain_graph=True)]
    else:
        y = F.rms_norm(xs, (D,), ss, eps)
        lib = [lambda: torch.autograd.grad(y, (xs, ss), g,
                                           retain_graph=True)]
    calls = [lambda: rmsnorm_bwd(x, g, scale, eps, gs)]
    return dict(
        shape=f"x [{rows},{D}] {dtype_name}{' (add form)' if fused else ''}",
        max_abs_err=err, ms=_time_ms(calls), launch_ms=_time_ms(
            calls, queued=False),
        plain_ms=_time_ms([lambda: reference_rmsnorm_bwd(
            x, g, scale, eps, gs)], iters=10),
        library_ms=_time_ms(lib, iters=10), bound_ms=b_ms, bound_by=b_by)


def _reduced_configs():
    """Every reduced config, and reduced gemma-2b with Gemma 2's window
    and caps on its local/global pattern."""
    from repro_torch.configs import PORTED, get_config
    out = [get_config(a, reduced=True) for a in sorted(PORTED)]
    base = get_config(G2_ARCH, reduced=True)
    attn, ffn = base.pattern[0]
    local = dataclasses.replace(attn, sliding_window=REDUCED_G2["window"],
                                logit_softcap=REDUCED_G2["softcap"])
    glob = dataclasses.replace(attn, logit_softcap=REDUCED_G2["softcap"])
    out.append(dataclasses.replace(
        base, name="gemma-2b-gemma2 (reduced)",
        pattern=((local, ffn), (glob, ffn)),
        final_logit_softcap=REDUCED_G2["final"]))
    return out


@contextlib.contextmanager
def _route_margins(found):
    """The port's router wrapped so that each call appends the least
    margin between the k-th and the (k+1)-th router logit over its tokens
    to `found`."""
    import torch
    from repro_torch.models import moe
    route = moe.route

    def noted(params, x, spec, ctx):
        with torch.no_grad():
            logits = torch.einsum("bsd,de->bse", x, params["router"].to(
                ctx.compute_dtype)).float()
            top = torch.topk(logits, spec.top_k + 1, dim=-1).values
            found.append(float((top[..., -2] - top[..., -1]).min()))
        return route(params, x, spec, ctx)
    moe.route = noted
    try:
        yield found
    finally:
        moe.route = route


def _reduced_step(cfg):
    """One float32 train step of a reduced config on the card through the
    kernels and on the CPU, from one weight set drawn on the CPU: the loss
    within 1e-5 (relative) and every gradient leaf within 1e-4 of its
    largest |g|, for a config whose routing (if any) clears
    TRAIN_ROUTE_MARGIN. Returns the step's launches on the card."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    tcfg = TS.TrainConfig(compute_dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, REDUCED_SEQ)).astype(
        np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    cpu = {"params": M.init_params(cfg, SEED, device="cpu")}
    card = {"params": adamw.tree_map(lambda t: t.to("cuda"),
                                     cpu["params"])}
    out = {}
    for dev, state in (("cpu", cpu), ("cuda", card)):
        params = TS.trainable(state["params"])
        state["opt"] = adamw.init_state(params, tcfg.optimizer)
        margins = []
        kernels.reset_launch_counts()
        with _route_margins(margins):
            loss, _, grads = TS.grads_and_metrics(
                params, cfg, TS.batch_on(batch, dev), tcfg)
        _, m = TS.train_step(state, batch, cfg=cfg, tcfg=tcfg)
        counts = kernels.launch_counts()
        out[dev] = (float(loss), grads, margins, counts, float(m["loss"]))
    (l_c, g_c, margins, _, s_c), (l_d, g_d, _, counts, s_d) = \
        out["cpu"], out["cuda"]
    assert math.isfinite(s_c) and math.isfinite(s_d), (s_c, s_d)
    margin = min(margins) if margins else None
    held = margin is None or margin > TRAIN_ROUTE_MARGIN
    worst = 0.0
    if held:
        assert abs(l_d - l_c) <= 1e-5 * abs(l_c), (cfg.name, l_d, l_c)
        want = dict(adamw.leaves(g_c))
        for path, got in adamw.leaves(g_d):
            w = want[path]
            top = float(w.abs().max())
            err = float((got.cpu() - w).abs().max())
            assert err <= 1e-4 * top or err == 0.0, \
                f"{cfg.name} {'/'.join(path)}: {err:.3e} > 1e-4 x {top:.3e}"
            worst = max(worst, err / top if top else 0.0)
    has_attn = any(s.kind == "attn" for _, _, _, s in cfg.sublayers())
    has_rms = cfg.norm == "rmsnorm" or any(
        s.kind in ("mamba2", "mlstm", "slstm") for _, _, _, s in
        cfg.sublayers())
    assert (counts["flash_attention_bwd"] > 0) == has_attn, counts
    assert (counts["rmsnorm_bwd"] > 0) == has_rms, counts
    print(f"  check train step {cfg.name:32s} loss cpu {l_c:.6f} cuda "
          f"{l_d:.6f}; "
          + (f"worst grad leaf {worst:.3e} of its max |g|" if held else
             f"routing margin {margin:.4f} under {TRAIN_ROUTE_MARGIN}: not "
             f"held")
          + (f" (routing margin {margin:.4f})" if held and margin is not None
             else "")
          + f"; launches flash_attention_bwd "
          f"{counts['flash_attention_bwd']}, rmsnorm_bwd "
          f"{counts['rmsnorm_bwd']}")
    return counts


def _rel_l2(a, b) -> float:
    """|a - b| / |b| in the L2 norm, in float32."""
    import torch
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _hold_full_width(cfg, params, batch):
    """(c)'s gradient hold: one gradient of the first HOLD_GROUPS groups
    (views of the full model's weights) through the kernels in bf16,
    through the plain path in bf16 and in float32; each leaf's relative L2
    distance from the float32 plain gradient, the kernels' at most twice
    the plain bf16's."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cut = dataclasses.replace(cfg, n_groups=HOLD_GROUPS)
    views = dict(params, groups=adamw.tree_map(
        lambda t: t[:HOLD_GROUPS], params["groups"]))
    paths, flat = zip(*adamw.leaves(views))
    grads = {}
    for name, dt, plain in (("kernels bf16", torch.bfloat16, False),
                            ("plain bf16", torch.bfloat16, True),
                            ("plain float32", torch.float32, True)):
        loss, _ = M.loss_and_aux(views, cut, batch, compute_dtype=dt,
                                 plain=plain)
        grads[name] = torch.autograd.grad(loss, flat)
        print(f"  hold {name}: loss {float(loss.detach()):.6f}")
        del loss
    worst = 0.0
    for i, path in enumerate(paths):
        truth = grads["plain float32"][i]
        own = _rel_l2(grads["plain bf16"][i], truth)
        got = _rel_l2(grads["kernels bf16"][i], truth)
        assert got <= 2 * own, f"{'/'.join(path)}: {got:.3e} > 2 x {own:.3e}"
        worst = max(worst, got / own if own else 0.0)
    print(f"  check gradient hold, {len(paths)} leaves of the first "
          f"{HOLD_GROUPS} groups: each kernel gradient's relative L2 "
          f"distance from float32 within twice the plain bf16's (worst "
          f"ratio {worst:.3f}) ok")
    del grads


def phase_training():
    """Phase 25: (a) the backward kernels against their plain versions,
    timed; (b) one float32 train step of every reduced config on the card
    against the CPU; (c) full-width gemma-2b: the gradient hold, then
    TRAIN_STEPS train steps under the watchdog, profiled once. Returns
    (the phase's launches from (c)'s steps, records for the kernels
    line)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.train.watchdog import Watchdog

    t0 = time.perf_counter()
    smi = _smi()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # (a) the backward kernels
    rec = {}
    for form in FLASH_BWD_FORMS:
        for dtype_name in ("float32", "bfloat16"):
            r, call = _flash_bwd_case(form, dtype_name, gen)
            _print_record("flash_attention_bwd", r)
            if form[0] == "gemma-2b training" and dtype_name == "bfloat16":
                _flash_bwd_passes(call, f"{form[0]} {dtype_name}")
                rec["flash_attention_bwd"] = r
    for dtype_name, (qs, ks) in zip(("bfloat16", "float32"),
                                    FLASH_BWD_PADDED):
        _flash_bwd_padded(qs, ks, dtype_name, gen)
    for shape, dtype_name in RMS_BWD_SHAPES:
        for fused in (False, True):
            r = _rms_bwd_case(shape, dtype_name, fused, gen, timed=True)
            _print_record("rmsnorm_bwd", r)
            if shape == (2048, 2048) and dtype_name == "bfloat16" \
                    and not fused:
                rec["rmsnorm_bwd"] = r
    print(f"  (a) wall {time.perf_counter() - t0:.1f} s [{smi}]")

    # (b) every reduced config, one float32 step, card against CPU
    t_b = time.perf_counter()
    for cfg in _reduced_configs():
        _reduced_step(cfg)
    print(f"  (b) wall {time.perf_counter() - t_b:.1f} s")

    # (c) full-width gemma-2b
    t_c = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tcfg = TS.TrainConfig()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=SEED))
    torch.cuda.reset_peak_memory_stats()
    params = TS.trainable(M.init_params(cfg, SEED, device="cuda",
                                         dtype=torch.float32))
    n_params = sum(t.numel() for _, t in adamw.leaves(params))
    assert n_params == PARAMS[cfg.name], n_params
    reckoned = STATE_BYTES_A_PARAM * n_params
    print(f"  {cfg.name}: {n_params} parameters, float32 master weights; "
          f"the state reckoned at {STATE_BYTES_A_PARAM} B a parameter: "
          f"{reckoned / 1e9:.2f} GB")
    _hold_full_width(cfg, params, TS.batch_on(data.batch_at(0), "cuda"))
    torch.cuda.synchronize()
    state = {"params": params, "opt": adamw.init_state(params,
                                                      tcfg.optimizer)}
    wd = Watchdog()
    losses, walls = [], []
    want = {"flash_attention": 2 * _attn_layers(cfg),
            "rmsnorm": 2 * _norms(cfg) - 1,
            "flash_attention_bwd": _attn_layers(cfg),
            "rmsnorm_bwd": _norms(cfg)}
    total = dict.fromkeys(want, 0)
    gc_clock = _GcClock()
    for step in range(TRAIN_STEPS):
        batch = data.batch_at(step + 1)
        kernels.reset_launch_counts()
        wd.begin_step()
        before = _host_stalls(gc_clock)
        (state, m), wall = _timed(lambda: TS.train_step(
            state, batch, cfg=cfg, tcfg=tcfg))
        stalls = {k: v - before[k] for k, v in
                  _host_stalls(gc_clock).items()}
        loss = float(m["loss"])
        events = wd.end_step(step, loss)
        counts = kernels.launch_counts()
        assert {n: counts[n] for n in want} == want, (counts, want)
        for n in want:
            total[n] += counts[n]
        assert math.isfinite(loss) and not wd.rollbacks, (loss, events)
        losses.append(loss)
        walls.append(wall)
        print(f"  step {step + 1}: loss {loss:.6f} (ce {float(m['ce']):.6f}, "
              f"z_loss {float(m['z_loss']):.3e}), lr {float(m['lr']):.3e}, "
              f"grad_norm {float(m['grad_norm']):.4f}; wall {wall:.4f} s "
              f"(host clock, synchronised; alloc retries "
              f"{stalls['retries']}, cudaMalloc {stalls['mallocs']}, "
              f"garbage collection {stalls['gc_s']:.4f} s in "
              f"{stalls['gc_runs']} runs, {stalls['gc_full']} of the "
              f"oldest generation); watchdog {events or 'quiet'} [{smi}]")
    gc_clock.close()
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"  loss curve {[round(x, 6) for x in losses]} [{smi}]")
    print(f"  launches a step: flash_attention {want['flash_attention']} "
          f"(18 forward + 18 in the remat replay), rmsnorm "
          f"{want['rmsnorm']} (37 forward + 36 replayed: the final norm is "
          f"outside the groups), flash_attention_bwd "
          f"{want['flash_attention_bwd']}, rmsnorm_bwd "
          f"{want['rmsnorm_bwd']} ok")
    print(f"  training: step wall median of steps 2-{TRAIN_STEPS} "
          f"{steady:.4f} s, {tokens / steady:.1f} tokens/s; peak device "
          f"memory {peak / 1e9:.2f} GB against the state's reckoned "
          f"{reckoned / 1e9:.2f} GB [{smi}]")
    batch = data.batch_at(TRAIN_STEPS + 1)
    kernels.reset_launch_counts()
    ops, wall = _profiled(lambda: TS.train_step(state, batch, cfg=cfg,
                                                tcfg=tcfg))
    busy = sum(e.device_time_total for e in ops) / 1e3
    if busy:
        print(f"  profiled step: wall {wall * 1e3:.2f} ms, device kernels "
              f"{busy:.2f} ms, device-idle share "
              f"{max(0.0, 1 - busy / (wall * 1e3)):.4f} [{smi}]")
        for e in sorted(ops, key=lambda e: -e.device_time_total)[:8]:
            print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:90]}")
    else:
        print("  profiled step: the profiler saw no device time; the idle "
              "share is not measured")
    # the optimizer's share of a step: apply_updates alone on gradients of
    # zeros (its elementwise passes do not depend on the values), twice
    grads = adamw.tree_map(torch.zeros_like, state["params"])
    opt_s = [_timed(lambda: adamw.apply_updates(
        state["params"], grads, state["opt"], tcfg.optimizer))[1]
        for _ in range(2)]
    del grads
    print(f"  AdamW's apply_updates alone: {opt_s[-1]:.4f} s (first call "
          f"{opt_s[0]:.4f} s; host clock, synchronised) of the step's "
          f"{steady:.4f} s [{smi}]")
    print(f"  (c) wall {time.perf_counter() - t_c:.1f} s; phase 25 wall "
          f"{time.perf_counter() - t0:.1f} s")
    del state, params
    torch.cuda.empty_cache()
    return total, rec


class _GcClock:
    """Seconds and runs of Python's garbage collections since it was made
    (a gc callback), until close()."""

    def __init__(self):
        import gc
        self.seconds, self.runs, self.full, self._t = 0.0, 0, 0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.runs += 1
            self.full += info["generation"] == 2
            self._t = None

    def close(self):
        import gc
        gc.callbacks.remove(self)


def _host_stalls(gc_clock) -> dict:
    """The caching allocator's retries (a free of cached blocks and a
    second cudaMalloc, after a first one failed) and cudaMalloc calls so
    far, and the garbage collections' seconds and runs."""
    import torch
    st = torch.cuda.memory_stats()
    return dict(retries=st.get("num_alloc_retries", 0),
                mallocs=st.get("num_device_alloc", 0),
                gc_s=gc_clock.seconds, gc_runs=gc_clock.runs,
                gc_full=gc_clock.full)


# phase 2: flash_attention_bwd's kernels by name, "flash_bwd_dkdv_tc<256,
# window 0, cap 1>": the bf16 passes at each head_dim and form, and the
# float32 CUDA-core passes and the group sum, which are no templates
BWD_TC_PASSES = ("rows_tc", "dkdv_tc", "dq_tc")
BWD_TC_HEAD_DIMS = (64, 128, 256)
BWD_PLAIN_KERNELS = ("rows", "dkdv", "dq", "group_sum")


def _bwd_kernel_name(mangled: str) -> str | None:
    """The label of a flash_attention_bwd kernel's mangled name, or None
    where it is not one the source defines."""
    m = re.search(r"flash_bwd_([a-z_]+)(?:ILi(\d+)ELb([01])ELb([01])EE|E)",
                  mangled)
    if not m:
        return None
    if m.group(2):
        return (f"flash_bwd_{m.group(1)}<{m.group(2)}, window {m.group(3)}, "
                f"cap {m.group(4)}>")
    return f"flash_bwd_{m.group(1)}"


def _bwd_build_report() -> None:
    """Phase 2's lines for flash_attention_bwd: each kernel's registers
    and spill bytes as ptxas (-v) gave them, the dynamic shared memory of
    the bf16 passes' blocks, and each kernel's wgmma instructions (HGMMA)
    in `cuobjdump -sass` of the built library. Fails unless the kernels
    are exactly the 3 bf16 passes x 3 head_dims x 4 forms (window, cap)
    and the 4 float32 ones, each found in the SASS, and on a spill or no
    wgmma in a bf16 pass."""
    from repro_torch.kernels import _build
    stem = _build.BUILD_DIR / f"flash_attention_bwd-{_build._digest()}"
    props, name = {}, None
    for line in (stem.parent / (stem.name + ".log")).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            props[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            props[name]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props[name]["registers"] = int(m.group(1))
    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(stem) + ".so"],
                          capture_output=True, text=True, check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            hgmma[fn] = 0
        elif fn and "HGMMA" in line:
            hgmma[fn] += 1
    labels = {mangled: _bwd_kernel_name(mangled) for mangled in props}
    unparsed = [k for k, v in labels.items() if v is None]
    assert not unparsed, f"flash_attention_bwd: unknown kernels {unparsed}"
    want = sorted([f"flash_bwd_{p}<{hd}, window {w}, cap {c}>"
                   for p in BWD_TC_PASSES for hd in BWD_TC_HEAD_DIMS
                   for w in (0, 1) for c in (0, 1)]
                  + [f"flash_bwd_{p}" for p in BWD_PLAIN_KERNELS])
    assert sorted(labels.values()) == want, sorted(labels.values())
    assert set(props) <= set(hgmma), set(props) - set(hgmma)
    smem = _build.library("flash_attention_bwd_smem")
    for mangled in sorted(props, key=labels.get):
        p, label = props[mangled], labels[mangled]
        line = (f"  flash_attention_bwd: {label}: {p['registers']} "
                f"registers, {p['spill'][0]} B spill stores, "
                f"{p['spill'][1]} B spill loads, {hgmma[mangled]} HGMMA")
        if "<" in label:
            pass_ = BWD_TC_PASSES.index(label[len("flash_bwd_"):
                                              label.index("<")])
            hd = int(label[label.index("<") + 1:label.index(",")])
            line += f", {smem(hd, pass_)} B dynamic shared memory"
            assert p["spill"] == (0, 0) and hgmma[mangled] > 0, line
        print(line)
    print(f"  flash_attention_bwd: {len(want) - len(BWD_PLAIN_KERNELS)} "
          f"bf16 pass instances, each with wgmma and no spill, and "
          f"{len(BWD_PLAIN_KERNELS)} float32 kernels ok")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_script = time.perf_counter()
    # float32 products in full float32 on both paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card
    print(_smi())
    print(f"[1] torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}")

    # phase 2: build
    built = _build.build()
    print(f"[2] built {len(_build.SOURCES)} kernels in "
          f"{built['seconds']:.1f} s")
    for name, log in built["logs"].items():
        if name == "flash_attention_bwd":
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    _bwd_build_report()

    cfg = get_config("gemma-2b")
    rng = np.random.default_rng(SEED)
    prompts = _prompts(cfg.vocab, N_REQUESTS + 2, rng)
    lengths_main, buckets = _path_shapes(prompts)
    print("[3] kernels vs plain versions on the card")
    rec = phase_kernels(cfg, lengths_main, buckets)
    print(f"[4] full-width {cfg.name} serving through the kernels and "
          f"tiers")
    counts, params = phase_serving(cfg, prompts)
    print("[5] reduced gemma-2b, float32, kernels vs plain path")
    phase_reduced(rng)
    print("[6] cuckoo KV store: demo scenario and a 2^23 x 8 table")
    counts["cuckoo_probe"], rec["cuckoo_probe"] = phase_kvstore()
    print("[7] two-stage ANN search over 262,144 vectors")
    counts["ann_topk"], rec["ann_topk"] = phase_ann()
    print("[8] autopilot: reuse sketch, admission benchmark, control plane")
    counts["reuse_sketch"], rec["reuse_sketch"] = phase_autopilot()
    print(f"[9] the declared platform: HierarchySpec -> Platform.compile "
          f"-> Platform.engine, full-width {cfg.name}")
    served = phase_platform(cfg, params, prompts)
    print(f"[10] continuous batching over a declared workload: "
          f"Platform.scheduler -> run(Platform.jobs()), full-width "
          f"{cfg.name}")
    workload = phase_workload(cfg, params)
    del params
    print("[11] the autopilot's closed loops: Platform.autoscale, "
          "fail_host and Platform.repair through the autoscale and "
          "failover benches")
    loops = phase_closed_loops(cfg)
    print("[12] the paper's artifacts on the card: the harness, the "
          "analytic grid and the example twins")
    artifacts = phase_artifacts()
    dense_cfg = get_config(DENSE_ARCH)
    print(f"[13] full-width {DENSE_ARCH} through the kernels, the platform "
          f"and the scheduler")
    dense = phase_dense(dense_cfg, _prompts(dense_cfg.vocab, N_REQUESTS + 2,
                                            np.random.default_rng(SEED)),
                        "phase 13")
    print(f"[14] the fleet at scale: the fleet bench and the control-plane "
          f"replay, then run_compare on {cfg.name}")
    at_scale = phase_fleet_scale(cfg)
    print(f"[15] declared tenants and the fourth tier: the tenant and "
          f"tiers benches through Platform.scheduler, reduced and "
          f"full-width {cfg.name}")
    tiered = phase_tenants_tiers(cfg)
    long_cfg = get_config(LONG_ARCH)
    print(f"[16] full-width {LONG_ARCH} through the kernels, the platform "
          f"and the scheduler, and decode attention at its "
          f"{long_cfg.max_seq}-position context")
    nemo = phase_dense(long_cfg, _prompts(long_cfg.vocab, N_REQUESTS + 2,
                                          np.random.default_rng(SEED)),
                       "phase 16", long_context=True)
    mqa_cfg = get_config(MQA_ARCH)
    print(f"[17] full-width {MQA_ARCH} through the kernels, the platform "
          f"and the scheduler, and decode attention at its "
          f"{mqa_cfg.max_seq}-position context")
    granite = phase_dense(mqa_cfg, _prompts(mqa_cfg.vocab, N_REQUESTS + 2,
                                            np.random.default_rng(SEED)),
                          "phase 17", long_context=True)
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_groups=MOE_GROUPS)
    print(f"[18] full-width {MOE_ARCH} ({MOE_GROUPS} of its "
          f"{get_config(MOE_ARCH).n_groups} layers) through the kernels, "
          f"the platform, the scheduler and Platform.expert_store, and "
          f"decode attention at its {moe_cfg.max_seq}-position context")
    qwen = phase_dense(moe_cfg, _prompts(moe_cfg.vocab, N_REQUESTS + 2,
                                         np.random.default_rng(SEED)),
                       "phase 18", long_context=True)
    top1_cfg = dataclasses.replace(get_config(TOP1_ARCH),
                                   n_groups=TOP1_GROUPS)
    print(f"[19] full-width {TOP1_ARCH} ({TOP1_GROUPS} of its "
          f"{get_config(TOP1_ARCH).n_groups} groups: {top1_cfg.n_layers} "
          f"of {get_config(TOP1_ARCH).n_layers} layers, a dense and an MoE "
          f"layer) through the kernels, the platform, the scheduler and "
          f"Platform.expert_store, and decode attention at its "
          f"{top1_cfg.max_seq}-position context")
    llama = phase_dense(top1_cfg, _prompts(top1_cfg.vocab, N_REQUESTS + 2,
                                           np.random.default_rng(SEED)),
                        "phase 19", long_context=True)
    ssm_cfg = get_config(SSM_ARCH)
    print(f"[20] full-width {SSM_ARCH} ({ssm_cfg.n_layers} layers: Mamba-2 "
          f"with a shared attention and FFN and a tail) through the "
          f"kernels, the platform and the scheduler ((b)'s serving and (c) "
          f"at {ZAMBA_GROUPS} of its {ssm_cfg.n_groups} groups and the "
          f"tail)")
    zamba = phase_dense(ssm_cfg, _prompts(ssm_cfg.vocab, N_REQUESTS + 2,
                                          np.random.default_rng(SEED)),
                        "phase 20")
    xl_cfg = get_config(XLSTM_ARCH)
    print(f"[21] full-width {XLSTM_ARCH} ({xl_cfg.n_layers} layers: "
          f"alternating mLSTM and sLSTM, no attention) through the "
          f"kernels, the platform and the scheduler")
    xlstm = phase_dense(xl_cfg, _prompts(xl_cfg.vocab, N_REQUESTS + 2,
                                         np.random.default_rng(SEED)),
                        "phase 21")
    vl_cfg = get_config(VL_ARCH)
    print(f"[22] full-width {VL_ARCH} ({vl_cfg.n_layers} layers, M-RoPE, "
          f"GQA of 12 query heads on 2) through the kernels, the platform "
          f"and the scheduler, a vision-prefix prefill, and decode "
          f"attention at its {vl_cfg.max_seq}-position context")
    vl = phase_dense(vl_cfg, _prompts(vl_cfg.vocab, N_REQUESTS + 2,
                                      np.random.default_rng(SEED)),
                     "phase 22", long_context=True)
    au_cfg = get_config(AUDIO_ARCH)
    print(f"[23] full-width {AUDIO_ARCH} ({au_cfg.encoder.n_groups} "
          f"encoder and {au_cfg.n_layers} decoder layers, cross-attention "
          f"onto {au_cfg.encoder.n_frames} frames, LayerNorm) through the "
          f"kernels, the platform and the scheduler, an audio prefill on "
          f"random frames, and decode attention at its "
          f"{au_cfg.max_seq}-position context")
    audio = phase_dense(au_cfg, _prompts(au_cfg.vocab, N_REQUESTS + 2,
                                         np.random.default_rng(SEED)),
                        "phase 23", long_context=True)
    print(f"[24] full-width {G2_ARCH} with Gemma 2's attention features "
          f"({G2_GROUPS} groups of a local layer, window {G2_WINDOW}, and "
          f"a global one; score cap {G2_SOFTCAP:g}, final cap "
          f"{G2_FINAL_SOFTCAP:g}) at {G2_MAX_LEN} positions through the "
          f"kernels and the platform, and the int8 KV cache")
    gemma2 = phase_gemma2()
    print(f"[25] training on the card: the backward kernels against their "
          f"plain versions, one float32 step of every reduced config "
          f"against the CPU, and full-width {TRAIN_ARCH} for {TRAIN_STEPS} "
          f"steps")
    training, train_rec = phase_training()
    rec.update(train_rec)
    # each path's launches, its counts set to 0 just before it ran; the
    # kernels line's `launches` is the newest path that runs each kernel
    by_path = {"phase4": {n: counts[n] for n in SERVING_KERNELS},
               "phase6": {"cuckoo_probe": counts["cuckoo_probe"]},
               "phase7": {"ann_topk": counts["ann_topk"]},
               "phase8": {"reuse_sketch": counts["reuse_sketch"]},
               "phase9": served, "phase10": workload, "phase11": loops,
               "phase12": artifacts, "phase13": dense, "phase14": at_scale,
               "phase15": tiered, "phase16": nemo, "phase17": granite,
               "phase18": qwen, "phase19": llama, "phase20": zamba,
               "phase21": xlstm, "phase22": vl, "phase23": audio,
               "phase24": gemma2, "phase25": training}
    print(f"  launches_by_path {json.dumps(by_path, sort_keys=True)}")
    # a path that holds a kernel at 0 (phase 21's attention kernels, phase
    # 23's rmsnorm) does not replace the newest path that ran it
    for path in (workload, loops, artifacts, dense, at_scale, tiered, nemo,
                 granite, qwen, llama, zamba, xlstm, vl, audio, gemma2,
                 training):
        counts.update({name: n for name, n in path.items() if n})
    for name in ("cuckoo_probe", "ann_topk", "reuse_sketch"):
        r = rec[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  time  {name:17s} {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"(with host launch {r['launch_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} library_ms={lib} ({r['library']}) "
              f"bound_ms={r['bound_ms']:.6g} ({r['bound_by']}); "
              f"launches {counts[name]}")
        assert counts[name] > 0, f"{name} kernel never launched on its path"

    wall = time.perf_counter() - t_script
    print(f"  the script's wall from main's start {wall:.1f} s (host "
          f"clock) [{_smi()}]")
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=counts[name],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             shape=r["shape"], launches_by_path={
                 path: c[name] for path, c in by_path.items()
                 if name in c})
        for name, r in rec.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
