"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  (a) device: a CUDA device must be present; prints the card's name and
      power limit as nvidia-smi reports them, and the build stamp
      (obs/build.py: torch, CUDA, driver, device);
  (b) build: compiles the six CUDA sources from kubeflow_tpu_torch/csrc
      (one nvcc per source, in parallel) and prints the seconds; for K1,
      K2, K3 (slab and paged), B1, B2 and B3 the registers and spills of
      each kernel from ptxas -v (no spill allowed) and the tensor-core
      instructions in their SASS, where cuobjdump is present (K1, K3, B1,
      B2, B3: wgmma's HGMMA and no mma.sync HMMA; K2 runs on mma.sync);
  (c) kernels: each serving kernel against its plain PyTorch version on
      the card at the Llama-3-8B serving shapes, with the error, the kernel's, the
      plain version's and one PyTorch library call's time (CUDA events,
      after warm-up, weights rotated through copies larger than the L2
      cache), and the bound (bytes at 3.35 TB/s or operations at
      989 TFLOP/s, whichever is larger); K1 at m = 1, 8, 13, 32 and 128,
      and at the verify rows of speculation at 16 slots, m = 48, 80 and
      112, each summed over one 8B verify round (m = 32 too) beside
      torch.matmul's sum and the round's bound; K2 also at S_v = 8, at
      span 200, with every length 0 and with one slot far past the others
      in a longer slab, and at B=16 span 2048 int8 with S_v = 7, 9 and 17
      (28, 36 and 68 query rows a kv head: one, two and three 32-row
      groups), slab and paged (bt 128); K3 also at the engine's
      1024-token wave, at 1, 2, 3 and 8 query heads per kv head (hd 64),
      and as a ragged int8 continuation in a longer slab; every K1, K2
      and K3 case launched twice for the same bits; K2's paged mode
      (K2-paged) at B=8, S_v 1 and 4, span 1024 and 2048, block_tokens
      16, 64 and 128, int8 and bf16, over a shuffled table into a pool
      larger than the batch needs with finite junk in block 0: against
      its plain version, launched twice for the same bits, and against
      the slab kernel on the same keys gathered into a slab (the same
      bits), with K2-slab's time at the same shape; K3's paged mode
      (K3-paged) the same way at the serving profiler's prefill probe
      (B=8, S=32, q_offset 2016, 2048 keys) and at the 1024-token wave
      (B=3, q_offset 0, a 2048-key table naming block 0 past the keys
      the rows see), block_tokens 16, 64, 128 and 256, int8 and bf16,
      with K3-slab's time on the gathered keys;
  (d) reference: a small int8 model's prefill, chunked prefill (128
      tokens continued against the first 128 rows dequantized from the
      int8 cache, K3 at q_offset 128), decode and verify logits through
      the kernels against the same functions on the CPU;
  (e) engine: LLMEngine at full Llama-3-8B width (32 layers, random int8
      weights from --seed, int8 KV, 8 slots x 2048, buckets 128/512/1024,
      decode_chunk 8, pipelined decode, every decode chunk a CUDA graph
      replay) warms up (its decode graphs captured, timed) and serves 8
      prompts of 30..1000 tokens x 32 greedy tokens, twice: TTFT, decode
      tokens/s, determinism, no capture in live traffic, and the launch
      count of every kernel during the run (each must be > 0; a graph's
      launches count once per replay);
  (e2) paged engine: PagedLLMEngine over the same weights and settings
      (block_tokens 128 = the gcd of the buckets), warmed up, the same
      burst, twice: with the default pool (the slab's memory, 128 blocks)
      and with 24 blocks, fewer than the burst's 32; each run's greedy
      tokens must equal the slab engine's request by request, the small
      pool must hold at least one prefill, and K2-paged must launch while
      K2-slab does not; TTFT, decode tokens/s, held prefills and the
      pool's peak used blocks;
  (e3) flagship engine: the ISVC configuration (16 slots x 2048, int8
      weights and KV, buckets 128/512/1024, decode_chunk 8, pipelined,
      logprobs_topk 5) over (e)'s weights, a slab LLMEngine and a
      PagedLLMEngine of 128 blocks, each warmed up (seconds and the graph
      pool's memory printed); a burst of 16 prompts (14 of 30..1000
      tokens, and 1500 and 1900 tokens, chunked) with greedy rows,
      seeded-sampled rows (temperature 0.7, top_p 0.9), two penalized
      rows, two rows with a stop sequence taken from a first run's
      output, and one row cancelled once it has 8 tokens, with a chunk in
      flight. It holds: tokens equal row by row between pipelined and
      unpipelined decode and between the slab and the paged engine;
      seeded rows equal across runs and engines; the stop rows cut where
      their sequence first ends the output; the cancelled row a prefix of
      the others, "cancelled"; every logprob finite and <= 0, and a
      greedy row's the top-1 alternative's; graph replays > 0, no capture
      after warmup, K1, K2, K2-paged and K3 launched (K3 at the chunked
      continuation's q_offset 1024 among them); and one chunk's graph
      replay bit for bit the eager body (rows, slot state, KV cache, both
      variants). Prints TTFT mean/max (the chunked rows' too) and decode
      tokens/s; then K3 against its plain version at each continuation
      shape those runs launched it at;
  (e4) prefix cache: the flagship settings with prefix_cache (the
      default store, 32 blocks of 128 tokens) over (e)'s weights: a slab
      LLMEngine (run twice, every block evicted between), PagedLLMEngines
      of 128 and E4_SMALL_POOL blocks, and a cold slab engine without the
      cache (run twice), each warmed up, serve a 512-token system
      prompt, a burst of 16 sharing it (14 hits as continuation waves at
      q_offset 512, one per tail bucket, and two chunked chains from the
      cached head), four second turns and three cold long prompts (where
      the small pool's eviction valve must fire). It holds: the hit and miss counts,
      cached_tokens (512 on the burst, each second turn its first
      prompt's block-aligned length, one past 1024), one wave per (p, t)
      group, K3 at q_offset 512 with B > 1; tokens equal bit for bit
      between the slab, the paged, the small-pool and the repeated run;
      each banked block byte-equal to the slot rows it came from (int8
      rows and f32 scales; the paged tables naming the trie's blocks);
      the store's bytes, and the requested bytes evicting it frees, equal
      to n_blocks x block bytes; used pool blocks equal to the trie's at
      idle; the valve fired; K1, K2, K2-paged and K3 launched; no capture
      after warmup; each hit row's first-token logprobs within
      E4_LP_TOL of the cold engine's. Prints both bursts' TTFT (each
      engine's second run: a first run carries first-use costs), the
      prompt tokens computed and reused, the warmups and the store's
      bytes; then K3 against its plain version at each continuation shape
      it launched at;
  (p) stage-sharded serving: StageShardedEngine at stage 3 over (e)'s
      weights with the flagship settings and the prefix cache (layer
      slabs 11/11/10, microbatches of 6/5/5 slots, every stage on the
      one card), warmed up, once with the sync schedule and once with
      the overlapped one, replays (e4)'s traffic: every row's tokens,
      logprobs, top-5 logprobs and cached tokens, and the continuation
      waves, equal (e4)'s first slab run bit for bit; no capture after
      warmup; the slabs views of the stacked weights (the engine adds
      its KV slabs and under 64 MB else); K1 225 x 3, K2 32 x 3 and K3 0
      launches a decode step; the decode step's wall (16 slots at 1024)
      beside (e4)'s single program's; then an eager stage_timing burst
      on the sync engine (every stage launches K1, K2 and K3; the
      measured bubble beside the schedule's (S-1)/(M+S-1)); then K2 over
      slot rows [6, 11) of a 16-slot slab (split_slots 16) against its
      plain version and the whole slab's launch, bit for bit;
  (e5) speculation: the ISVC's whole engine config (the flagship
      settings with prefix_cache and speculative 6, spec_ngram 3, the
      adaptive draft length) over (e)'s weights: a slab LLMEngine (run
      twice, the store evicted between), a 128-block PagedLLMEngine and
      the same slab engine without speculation, each warmed up (the
      speculative ones capture the verify menu: 14 keys x 2 variants),
      serve (e3)'s burst, then a burst of four copy-heavy prompts (a
      300-token passage quoted twice). It holds: no capture after
      warmup; tokens equal slab/paged/repeat; each greedy row (not
      sampled, penalized or cancelled) equal to the plain engine's, or
      first different where the plain run's top-2 logprob gap is under
      E5_GAP; finite logprobs with a top-5 list for every token; K1, K2
      (at S_v > 1), K2-paged and K3 launched, 225 K1 launches a round;
      one verify chunk's graph replay bit for bit its eager body. Prints
      each differing row and its gap, decode tokens/s and TTFT of (e3)'s
      burst with and without speculation, the spec_* metrics, warmups and
      graph pools; then K2 and K2-paged against their plain versions at
      each verify S_v the runs launched;
  (e6) dataplane: an InferenceService's path through the port. chip_smoke's
      own safetensors writer puts a Llama-3-8B-shaped HF directory of
      random bf16 weights from --seed (the published config.json fields,
      4 shards and the index, no tokenizer; fewer layers only when the
      temp directory's disk cannot hold 16.06 GB) into a temp directory
      that is kept until (l) has read it;
      an LLMModel over it with the ISVC's config as written
      (examples/llama-8b-serving-isvc.yaml, plus device, a 1 s SSE
      keepalive and compile_cache in the temp directory) loads it
      (load_hf straight to the card, int8 as it lands) and warms up:
      load_hf seconds and GB/s, warmup seconds, resident GB and the
      graph pool, the compile_cache holding the six libraries, and
      embed, final_norm, wq[0], w_down[-1] and lm_head bit for bit the
      written tensors (int8 leaves as quantize_int8 of them). Through the
      port's server, with the engine held at a gate so each burst is
      submitted whole and in order: (e3)'s 16 prompts as concurrent SSE
      streams read by chip_smoke's own SSE reader (one [DONE] each, 48
      tokens, client-side TTFT mean/p50/max from the first data event and
      decode tokens/s), the same 16 buffered from the same engine state
      (tokens equal row by row), a chat stream beside a client that
      hangs up after 4 tokens (ended cancelled), K1, K2 and K3 launched
      and no capture after warmup; then the streams again with a one-shot
      backend_crash from a duck-typed injector once every stream has 8
      tokens: one restart, keepalive comments in every stream, each
      stream's tokens its uncrashed ones (or first different at a top-2
      gap under E5_GAP, counted as a replay_mismatch), the outage, and
      torch.cuda.memory_allocated() after the restart equal to before
      within the graph pool; /metrics' TTFT count equal to the requests
      served; after unload(), memory back to its value before (e6) once
      the cuBLAS workspaces are cleared;
  (e7) scenarios: committed loadgen traffic through the port's runner
      (kubeflow_tpu_torch/loadgen) into slab LLMEngines with the
      flagship settings and the prefix cache over (e)'s weights, each
      behind an EngineSupervisor (degraded-mode ShedPolicy: t0 above the
      threshold) whose factory builds it, warmed up, its scheduler the
      C++ core (NativeScheduler): on one without adapters (e7.a)
      run_scenario of `steady` and (e7.c); on one with (e8)'s four
      adapters a0..a3 loaded (e7.b) run_scenario of `multi_tenant_lora`
      with its adapters (its caps 2/32, six tenants and four adapters: the
      per-tenant table, Jain's index and the requests offered and
      completed per adapter), then a flood of 64 t0 and 8
      t1 requests submitted whole under set_tenant_limits(2, 32): 32 of
      t0's refused with TenantOverQuota and none of t1's, t1's largest
      queue wait under t0's median, every request terminal; (e7.c)
      `steady` with a second tenant and the committed `crash_midstream`
      script (the restart backoff E7_BACKOFF_S; the crash, once due, held
      until a stream holds delivered tokens): one restart, nothing lost,
      shedding only of t1 and only between the crash and the restart,
      every delivered prefix replayed and verified (or counted a mismatch
      as the supervisor counts it), every accepted request's tokens and
      every delivered prefix (a)'s or first different at a top-2 gap
      under E5_GAP where its prefill wave had (a)'s (bucket, rows), under
      E7_OTHER_GAP where it had another shape (past 128 rows a wave
      projects through cuBLAS, whose rows depend on the wave's size); as
      witness, every request that differs after a wave of another shape
      (and every mismatched replay) runs again on the restarted engine in
      waves of both shapes and gives each run's tokens exactly; (e7.d)
      run_trace_http of `steady` through the port's server over an
      LLMModel of the same settings:
      one [DONE] and the budget's tokens a stream, client TTFT from the
      first data event. Each replay prints its trace_sha256 (the pinned
      E7_TRACES), TTFT and TPOT p50/p99, attainment, goodput, completed,
      rejected and seconds, and holds K1, K2 and K3 launched and no
      capture after warmup;
  (e8) multi-adapter serving: four rank-8 adapters a0..a3 on
      wq/wk/wv/wo from --seed (b random and nonzero: LoRA's own b = 0
      would pass every check on an engine that ignored them), alpha 16,
      on flagship engines with the prefix cache over (e)'s weights, each
      warmed up: a burst of 16 (14 prompts of 30-1500 tokens, the last
      chunked, and two rows of one 512-token system prompt plus a
      question under a0 and a2) that mixes base rows and all four
      adapters (E8_ROUTES), 48 greedy tokens each. It holds: every base
      row bit for bit the same engine's without adapters; at least two
      adapters changing their rows; the burst again with half of the
      adapters' rows moved to the base (twice) giving every row's tokens
      exactly (its wave has the same (bucket, rows)), and the adapters'
      rows alone (waves of other shapes) first different only at a top-2
      gap under E7_OTHER_GAP, and where any differs, run alone again,
      their own tokens exactly (the witness: the wave shape decides);
      follow-ups of the system prompt under a0
      (a hit of 512 tokens: a continuation wave with adapters), a1 and
      the base (misses: the prefix cache never hits across adapters);
      one chunk's graph replay bit for bit the eager body with the slots
      spread over the adapters; a 128-block paged engine's tokens equal
      to the slab engine's; the speculative engine (speculative 6) equal,
      or first different at a top-2 gap under E5_GAP (base rows) or
      E7_OTHER_GAP (adapter rows: a verify round runs the bypass
      products at S_v rows a slot, whose GEMM bits depend on the rows),
      and where any row differs, the burst again on it giving its rows
      exactly;
      K1, K2, K2-paged and K3 launched; no capture after warmup. Prints
      TTFT and decode
      tokens/s against the engine without adapters, and the decode step's
      graph-replay wall with and without adapters at 8 and 16 slots;
      then K3 against its plain version at each shape it launched;
  (e9) disaggregated serving: LLMModel(disaggregated=True) at the
      flagship ISVC's config without speculation (16 slab slots x 2048,
      int8, the prefix cache with 96-block stores) over (e)'s weights,
      with the zero-copy handoff and then the serialized one, beside the
      supervised colocated LLMModel: ten prompts of 136-255 tokens (one
      block and a tail) and two under a block (bypass), 256 greedy tokens
      each, submitted whole behind a gate, then four of 1,536 tokens
      (64 tokens) once all twelve have their first token. It holds:
      serialized tokens and the sha256 of every handed-off block equal
      to zero-copy's, bytes_sent the blocks' bytes; the disaggregated
      rows equal to the colocated ones or first different at a top-2
      gap under E7_OTHER_GAP, and where any differs the colocated burst
      again giving its tokens exactly; no full prefill on the decode
      role, two bypasses, nothing lost; one weight copy (a leaf's
      data_ptr in both roles); K1 and K3 launched by the prefill role
      (no K2) and K1, K2, K3 by the decode role (counted by thread,
      printed per role); no capture after warmup; the kv_handoff bucket
      of serving_decode_breakdown on the decode role's engine; a
      backend_crash on the prefill supervisor as the long prompts reach
      it: one prefill restart, every stream complete, the tokens of the
      run without it, nothing lost. Prints the short streams' per-token
      delivery gaps while the long prompts prefill (p50/p99, colocated
      against disaggregated), the long prompts' TTFT, handoff_ms, the
      blocks and bytes handed off and the memory with both roles warm;
      then K3 against its plain version at each shape it launched;
  (f) engine shapes: every kernel again against its plain version, at
      each argument shape the wrappers recorded in (e) (prefill waves,
      decode spans, lm_head rows, the paged engine's K2-paged launches),
      with its times as in (c); then one decode step (slab and paged) as
      a replay of the engine's captured 8-step chunk beside the eager body
      of the same chunk, each with its wall time, the card's busy time by
      kernel family, the replay's span by CUDA events and the idle share,
      and one B=3 x 1024 prefill wave's wall time against the card's busy
      time by kernel family;
  (f2) serving breakdown: training/profiling.py serving_decode_breakdown
      (steps 8, iters 5, span 2048; its chunks are replays of the
      engine's decode graphs) on the slab engine of (e) and on the paged
      engine of (e2), whose slot tables are first filled with a shuffled
      permutation of its pool blocks: the bucket partition, K3-slab
      launched in the slab call and K3-paged (not K3-slab, not K2-slab)
      in the paged call, 32 launches a probe run, and each engine's greedy
      tokens for the burst unchanged after it; both dicts and, from a
      second call under torch.profiler, each kernel family's card-busy
      time beside the probe buckets; the chunk wall, device step,
      host_dispatch_per_step and host fetch/replay of the same traffic
      and breakdown with the eager body beside the graphs'; then K3-paged
      against its plain version at each shape the paged call launched it
      at;
  (g) server: three concurrent /openai/v1/completions requests against
      the port's HTTP server over an LLMModel of (e)'s weights and
      settings, warmed up at load;
  (h) training kernels: flash-attention forward (B1), dq (B2) and dk/dv
      (B3) against their plain versions at B=2 H=32 D=128 — S=4096
      causal, S=4000 causal with two documents per row, S=1024
      non-causal — the worst row's error over its largest value, a
      repeat launch bit for bit, and kernel, plain, SDPA and bound
      times; then B1 alone: the forward-only q_offset path, D=64, and
      Sq=200 (not a multiple of its 128-row tile), causal and not; then
      B2 and B3 at the edges of their tiles: D=64, S=200 causal and not,
      S=320 causal (a partial 128-key block), each against its plain
      version and launched twice for the same bits;
  (i) train reference: a small bf16 Llama's loss and every grad through
      the kernels on the card against the same function on the CPU;
  (j) trainer: Llama-3-8B width cut to 4 layers, B=2 x S=4096, AdamW,
      6 steps, twice from --seed: loss and grad_norm per step, tokens/s,
      MFU, peak memory, launches of B1-B3 per step (each at least one per
      layer, at the shape (h) timed), the two runs' losses, and one
      step's wall time against the card's busy time;
  (j2) trainer profile window: (j)'s trainer again with profile_dir
      (steps 2 and 3 of 6): PROFILE_DONE and one trace file, and each
      step's time inside and outside the window;
  (j3) training job: examples/llama-longctx-jaxjob.yaml's trainer config
      (J3_JOB: a Llama of head dim 128 with a bf16 first moment, B=1 x
      S=8192) cut to 3 of its 8 layers (1 when the temp directory cannot
      hold three checkpoints; printed; 4 layers until (n) took the
      split checks) and 6 steps logged each step, over
      a token_file corpus of 2^24 uint32 tokens from --seed (write_corpus;
      batches/s of the native loader and the Python twin),
      checkpoint_every 2, keep_checkpoints 2, through training/job.py
      train_target as the control plane calls it: a run cancelled at step
      5 exits 143 and leaves steps 2 and 4 (orbax's rule: the initial
      save at step 1, then every 2, the newest 2); the same env again
      prints "resumed from checkpoint at step 4" and saves step 6; B1-B3
      launched in the two runs. In-process: step 4 restored (verified,
      then read into tensors from abstract_state), steps 5-6 on batches
      0-1 give the resumed job's logged losses bit for bit and every leaf
      of step 6's restore bit for bit; an LLMModel over the checkpoint
      (int8 weights and KV) and one over the in-process params give the
      same greedy tokens for 8 prompts, K1-K3 launched by each; one more
      step saved under a scripted ckpt_io_fail
      (FaultInjector.as_io_fault_hook) is quarantined and
      latest_intact_step falls back to 6. Prints each save's host copy,
      write, hashing and manifest seconds and GB/s, the restores' verify
      and read seconds, the step after a save against one without (the
      stall), and peak memory; the directory is removed after. The model
      is not (j)'s because a run of this script keeps what it writes to
      disk, deleted files included, under J3_DISK_BUDGET_GB: (e6) writes
      16.06 GB, and five saves of (j)'s state would write 115 GB.
  (l) LoRA fine-tune: llama_lora at Llama-3-8B width, all 32 layers,
      rank 8, alpha 16, wq/wk/wv/wo, trainable_prefix "lora", the base
      (f32) read from (e6)'s HF directory through base_checkpoint (the
      directory is kept until here), B=2 x S=4096 as (j) when it fits
      one card, else B=1 (printed), 6 steps, no checkpoint (the state is
      32 GB a save), twice: per step loss, grad_norm and time; tokens/s,
      MFU by the JAX formula (it counts the frozen weights' weight
      gradients), peak memory and the optimizer state's bytes. It holds:
      every base leaf's bits unchanged (two 64-bit sums of its bit
      patterns before and after), every b leaf nonzero after step 2,
      optimizer state for the adapters alone, finite losses equal bit
      for bit on the repeat, B1-B3 launched each step on every layer;
  (l2) LoRA job: examples/llama-lora-jaxjob.yaml's trainer config
      (L2_JOB, key for key) through training/job.py train_target over a
      2^20-token corpus from --seed: exit 0, checkpoints at steps 1 and
      50 (orbax's initial save and the last), the base bit for bit
      between them, b zero at step 1 (lr 0) and moved by step 50; then
      the checkpoint served by LLMModel merged (lora: {rank 8, alpha
      16}) and through `adapters` (the step-50 adapter, and the step-1
      one from a copy of that step) over the base, bf16 and int8: the
      adapter route's tokens equal the merged model's or first different
      at a top-2 gap under L2_GAP, the step-1 adapter's rows equal the
      base rows exactly, the step-50 adapter's rows not all the base's,
      the first token's top logprobs of the route against an f32 CPU
      reference (the merged f32 model) within L2_LP_FACTOR times the
      engine-merged model's own error and under half the base rows'
      error, K2 and K3 launched (K1 too with int8); then, the model's
      head dim being 32 (the kernels ran on zero-padded heads), B1-B3 at
      the training's shapes, K2 and K3 at the serving's, and K2-paged
      and K3-paged at one shape each, int8 and bf16, against their plain
      versions at head dim 32;
  (m) the other model families: B1-B3 against their plain versions at
      ViT-B/16's attention (B=64, S=197 of 196 patches and [CLS], H=12,
      D=64, non-causal: ragged last tiles), with SDPA's times; ViT (its
      default config) and Mixtral (tiny, head dim 8 on padded heads) in
      bf16 through the kernels against the same params in f32 on the CPU
      (the loss within LOSS_RTOL, each grad leaf within GRAD_LEAF_TOL or
      M_REF_FACTOR times the plain bf16 CPU run's error); then a port
      Trainer over each family's trainer config (m_jobs), 6 steps twice
      from --seed on for_model's synthetic data: (m1) examples/
      mnist-jaxjob.yaml's config (M1_JOB, less its checkpoint_dir), (m2)
      BERT-base at 32 x 128 tokens, (m3) ResNet-50 at 224, B=64, (m4)
      ViT-B/16, B=64, (m5) examples/nas-experiment.yaml's trial config
      (M5_TRIAL with M5_OPS) and the DARTS supernet on its skeleton, then
      derive, (m6) Mixtral at 8x7B widths cut to 2 of 32 layers, B=1 x
      4096, with cuDNN's deterministic algorithms (restored after). It
      holds finite losses, the repeat's losses bit for bit,
      accuracy logged by the classifiers, B1-B3 launched in (m4) and (m6)
      and in no other family; prints each family's median step (steps
      2-6), samples/s (tokens/s for (m2), (m6)), the synthetic batch's
      host seconds, peak memory, (m6)'s MFU over active experts, one
      profiled step of (m3), (m4) and (m6); (m7) saves (m3)'s and (m4)'s
      states with CheckpointManager and serves each with
      TrainerCheckpointModel on the card: V1 and V2 logits for 8 images
      bit for bit apply's on the in-process params, argmax theirs; the
      checkpoints are removed after; (m2)'s, (m3)'s and (m4)'s trained
      params are kept for (mm);
  (r) RL (inside (e3), beside its warm slab engine, before its graph
      check): examples/rl-anakin-jaxjob.yaml's learner config as
      written (R_JOB: CartPole, 2048 envs x 64 steps, hidden (64, 64),
      PPO 2 epochs, clip 0.2, mesh {"data": -1}) as an AnakinLearner on
      the card, every update one CUDA graph replay. It holds: 3 replays
      from one state bit for bit the eager body and a second learner's 3
      replays from the same seed (state, optimizer state and metrics);
      a small config (R_SMALL, 2 updates) on the card within R_SMALL_TOL
      of the same learner on the CPU (the count of differing actions
      printed); finite losses; bench.py's seeded curve (150 updates, one
      point every 25) ending at or above R_THRESHOLD mean balanced steps;
      rl_learner_target called as the control plane calls it (at the
      small config) writing its metrics at the log cadence, and exiting
      143 on a cancel; none of
      the eight kernels launched (the path has no Pallas kernel). Prints
      env-steps/s and updates/s (measure_steps_per_s), the host's time to
      enqueue a replay, the card's time per replay, and one update's
      kernels, card-busy time and idle share, replayed and eager;
  (r2) packing: measure_interference of (r)'s update (a chunk is one
      replay, synced, on a CUDA stream of its own) against (e3)'s warm
      flagship slab engine (a chunk is 16 prompts of 99 tokens x 32
      greedy tokens, on its thread's default stream), R2_SECONDS
      windows as bench.py's: prints the record's JSON and each side's
      stream; holds positive rates and the engine's packed tokens equal
      to its solo tokens (the retentions are findings);
  (mm) multi-model serving (after (m)): the port's server whose own
      model is an LLMModel at the flagship config (random int8 weights
      from --seed, warmed at load) and a MultiModelAgent(max_loaded=2)
      over its repository pulling (m)'s ResNet-50, ViT-B/16 and
      BERT-base params through the `trainer` runtime by file:// URI. It
      holds: the third pull evicts the least recently used model, and
      torch.cuda.memory_allocated falls by its parameter bytes less
      MM_SLACK_BYTES; V1 and V2 answers by name bit for bit each
      model's direct predict; the host's greedy completion tokens the
      same before and after the pulls; a pull of the host's name
      refused; K1-K3 (the host) and B1 (ViT) launched. Prints each
      pull's seconds, parameter and resident GB;
  (n) sharded trainer (after (mm)): a one-rank NCCL process group on a
      file:// store (no port bound; the NCCL version printed), the
      meshes {"data": -1}, {"fsdp": -1}, {"tensor": -1} and
      {"expert": -1} (every axis 1, on cuda); (j)'s config on the Trainer
      over {"fsdp": -1} and over {"tensor": -1}, (m6)'s over
      {"expert": -1}, N_STEPS steps each from --seed: every state leaf a
      DTensor, B1-B3 launched at least once per layer a step, step 1's
      loss bit for bit the unsharded run 1's ((j)'s, (m6)'s) and every
      loss, aux loss and grad_norm within TRAIN_LOSS_RTOL of it (the
      bit-equality of each printed); (n.t) one Llama-3-8B-width layer
      (random weights, B=2 x S=4096) split over N_TENSOR = 2 tensor ranks
      in this process (each rank's column blocks of wq/wk/wv and
      w_gate/w_up, row blocks of wo and w_down, run one after the other,
      their reduce-outs summed by hand): the output and the gradients of
      x and of every leaf within N_SPLIT_TOL of the unsplit layer's, B1,
      B2 and B3 each launched twice at the rank's H=16 (KV=4 before
      their expansion), then held against their plain versions at B=2
      S=4096 H=16 D=128 causal (times, bound, SDPA) as in (h); and
      Llama-3-8B's lm_head and embedding (V=128256) split into N_TENSOR
      vocabulary halves at B=2 x S=4096: the cross-entropy from each
      half's `sharding.vocab_shard_stats`, combined by hand as
      `vocab_parallel_ce`'s all-reduces combine them, and each half's
      `vocab_shard_grad` within N_CE_TOL of log_softmax over the whole
      vocabulary and its gradient; the halves' `llama.embed_partial`
      lookups summed bit for bit the whole table's, their table
      gradient within N_CE_TOL; (n.p) (j)'s config at its seed and
      first batch through the port's GPipe schedule in this process:
      NP_STAGES = 2 one-stage `pipeline.gpipe` calls chained, each over
      its slab of 2 layers (`pipeline.llama_stage_fn`) and
      NP_MICROBATCHES = 2 microbatches of one row
      (`pipeline.microbatch`), the last one's outputs through
      `pipeline.llama_loss_tail`, one backward through both; and
      `pipeline.pipelined_llama_loss` off a mesh: each loss within
      TRAIN_LOSS_RTOL of (j)'s step 1 and of the unstaged
      `llama.loss_fn`, each stage's layer gradients and the embed,
      final_norm and lm_head gradients within N_SPLIT_TOL of the
      unstaged ones (the bit-equality of each printed), B1-B3 launched
      at least 4 times a stage at one row, then held against their plain
      versions at that microbatch's B=1 S=4096 H=32 D=128 causal (times,
      bound, SDPA) as in (h); the forward-backward seconds beside (j)'s
      median step and the phase's peak memory; (n.e)
      Mixtral-8x7B's MoE block at (m6)'s widths (B=1 x S=4096) split
      over N_EXPERT = 2 expert ranks the same way (one routing, each
      rank's dispatch, combine and expert blocks): the output, aux loss
      and gradients within N_SPLIT_TOL; (n.r) the RLJob example's
      learner (2048 envs x 64 steps) over {"data": -1}: its update graph
      captures the NCCL all-reduces (counted), and R_REPLAYS replays give
      (r)'s unsharded learner's state and metrics bit for bit; then
      training/job.py's job from a pod env of KTPU_NUM_PROCESSES=1 and
      N_JOB (mesh {"fsdp": -1}) on the group, as train_target runs it
      past one process: four sharded steps logged, steps 2 and 4 saved,
      B1-B3 launched. Prints each run's median step beside the unsharded
      one's with the card's name and power limit, the state's GB on the
      rank and the phase's peak memory; the group is destroyed before
      the phase ends. One card: NCCL across cards (the stages'
      point-to-point messages among them), the splits' memory saving,
      the pipeline's bubble and multi-card speed are not checked here;
  (s) sequence parallelism: (s.t) on a one-rank NCCL group (file://
      store), examples/llama-longctx-jaxjob.yaml's config (J3_JOB) at its
      full 8 layers and width, B=1 x 8192 synthetic tokens from --seed,
      N_STEPS steps unsharded with attention_impl "flash", then on the
      sharded trainer over {"sequence": -1} with "ring" and "ulysses"
      (at one rank: flash attention): step 1's loss bit for bit the
      flash run's, every loss and grad norm within TRAIN_LOSS_RTOL, B1-B3
      launched every layer; the median steps with the card's name and
      power limit and the peak memories; the group is destroyed. (s.r)
      the example's attention (16 query, 8 kv heads of 128, causal, two
      documents whose boundary lies inside a shard) as S_RANKS = 4 ring
      ranks' forward and backward steps in this process
      (`ring_fwd_step`, `ring_merge`, `ring_bwd_step`, the kv-width
      shards rotated by hand) against the unsharded B1-B3 at S=8192
      within S_RING_TOL of the largest value, B1, B2 and B3 launched
      N(N+1)/2 = 10 times each (nothing for a future shard), the steps'
      ms beside the unsharded kernels'; (s.u) Ulysses' rank bodies (4
      query and 2 kv heads of the whole sequence each) bit for bit the
      unsharded run's heads, 4 launches each; a ring step whose query
      rows include 300 that see no key (B1: o = 0, lse <= -1e29, no NaN;
      B2/B3 from the merged lse against their plain versions, dq = 0
      there); B1-B3 against their plain versions and timed, with their
      bounds and SDPA's time, at a ring step (B=1, 2048 rows, H=16,
      non-causal, query ids other than the keys') and at Ulysses' rank
      (B=1, S=8192, H=4, causal). One card: NCCL P2P and all-to-all
      across cards and their overlap with the kernels are not checked;
Each phase prints its seconds. The line before the last is
{"kernels": [...]}, each kernel timed at a shape its path launched it at
(the 8B engine run for the serving kernels, the paged engine's run for
K2-paged, the paged serving breakdown for K3-paged, the trainer for
B1-B3), then K1, K2 and K2-paged again at (e5)'s verify shapes (K1's
verify round at the row count (e5) launched most, with its launches
there), K2 at (p)'s slot window with (p.1)'s launches at B=5, B1-B3 at
(m4)'s shape with (m4)'s launches, B1-B3 at a
Llama-3-8B tensor rank's shape with (n.t)'s launches, and B1-B3 at a
ring step's and at Ulysses' rank's shape with (s.r)'s and (s.u)'s
launches; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab OTHER_TREE

compares this tree with another checkout (an unpacked `git archive` of
the parent commit, say) on one card in one call: K1's decode step (the
224 m=8 matmuls and the lm_head of (c)), K2 at B=8 S_v=1 span 1024 int8,
the 8B engine's decode-step breakdown at span 2048 (twice) and its
prefill-wave breakdown, (e3)'s flagship burst (TTFT and decode
tokens/s, slab and paged), B1-B3 at the trainer's shape, K3 at the engine's
1024-token wave and phase (j), with each tree's own code, in turns
(other, this, this, other), one process each. It prints no result
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import hashlib
import http.client
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch import loadgen
from kubeflow_tpu_torch.chaos import FaultInjector
from kubeflow_tpu_torch.models import llama, moe_llama, nas_cnn, registry
from kubeflow_tpu_torch.models import vit as vit_lib
from kubeflow_tpu_torch.obs.build import build_stamp
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import flash_decode as fd
from kubeflow_tpu_torch.ops import flash_prefill as fp
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops import quant_matmul as qm
from kubeflow_tpu_torch.ops.attention import KERNEL_MIN_HEAD_DIM
from kubeflow_tpu_torch.parallel.pipeline import (microbatch_ranges,
                                                  stage_bounds)
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.multichip import StageShardedEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.scheduler import (NativeScheduler,
                                                  ShedPolicy, TenantOverQuota,
                                                  TenantShed)
from kubeflow_tpu_torch.serving.server import CompletionServer
from kubeflow_tpu_torch.training import data as train_data
from kubeflow_tpu_torch.training import mfu
from kubeflow_tpu_torch.training import trainer as train
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
L2_ROTATE_BYTES = 120e6       # working set past the 50 MB L2
SLEEP_CYCLES_PER_CALL = 1_000_000   # ~0.5 ms of card time per queued call
DEV = "cuda"

# K1 shapes of one 8B decode step: (d, o) -> matmuls per layer, plus the
# lm_head once per step with f32 output
K1_LAYER = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2,
            (14336, 4096): 1}
K1_HEAD = (4096, 128256)
# K1's rows in one verify round of speculation at the ISVC's 16 slots:
# m = 16 (kd + 1) for the draft lengths kd 1, 2, 4, 6 of `speculative: 6`
K1_VERIFY_M = (32, 48, 80, 112)

SERVING_KERNELS = ("quant_matmul", "flash_decode", "flash_prefill")
PAGED_KERNELS = ("quant_matmul", "flash_decode_paged", "flash_prefill")
TRAINING_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")

REPLACES = {
    "quant_matmul": "kubeflow_tpu/ops/quant_matmul.py:68",
    "flash_decode": "kubeflow_tpu/ops/flash_decode.py:125",
    "flash_decode_paged": "kubeflow_tpu/ops/flash_decode.py:125",
    "flash_prefill": "kubeflow_tpu/ops/flash_prefill.py:134",
    "flash_prefill_paged": "kubeflow_tpu/ops/flash_prefill.py:134",
    "flash_attn_fwd": "kubeflow_tpu/ops/flash_pallas.py:77",
    "flash_attn_dq": "kubeflow_tpu/ops/flash_pallas.py:229",
    "flash_attn_dkv": "kubeflow_tpu/ops/flash_pallas.py:284",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fns, iters: int) -> float:
    """Device ms per call of fns run round-robin (distinct copies of the
    inputs keep the weights out of L2), after one warm-up pass. A sleep
    kernel holds the card while the host enqueues every call, so the
    events time the card's work, not Python's launch rate."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def n_copies(nbytes: float) -> int:
    return max(1, math.ceil(L2_ROTATE_BYTES / nbytes))


# -- (b) build report -------------------------------------------------------

# the kernels whose build (b) holds to no spill and to wgmma (HGMMA
# present, no mma.sync HMMA); B1 is built on K3's mainloop
WGMMA_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                 "quant_matmul", "flash_prefill")
# ... and those held to no spill alone (K2 runs on mma.sync)
SPILL_KERNELS = WGMMA_KERNELS + ("flash_decode",)
# template arguments in a mangled name: a type by its length-prefixed name
# or one of these codes, or an integer literal
_MANGLED_TYPES = {"a": "int8_t", "f": "float"}
_MANGLED_BOOLS = {"Lb0E": "false", "Lb1E": "true"}


def kernel_name(mangled: str) -> str:
    """`dq_kernel<128>` or `decode_kernel<signed char, 128, 8>` from a
    mangled `..._kernelI...E...` name: the identifier is the one whose
    length prefix matches it."""
    m = re.search(r"_kernelI", mangled)
    if not m:
        return mangled
    end = m.start() + len("_kernel")
    name = None
    for n in range(len("_kernel"), end):
        ident = mangled[end - n:end]
        if mangled[:end - n].endswith(str(n)) and ident[0].isalpha():
            name = ident
            break
    if name is None:
        return mangled
    args, rest = [], mangled[end + 1:]
    while rest and rest[0] != "E":
        lit = re.match(r"Li(\d+)E", rest)
        typ = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif rest[:4] in _MANGLED_BOOLS:
            args.append(_MANGLED_BOOLS[rest[:4]])
            rest = rest[4:]
        elif typ:
            n = int(typ.group(1))
            start = typ.end()
            args.append(rest[start:start + n])
            rest = rest[start + n:]
        elif rest[0] in _MANGLED_TYPES:
            args.append(_MANGLED_TYPES[rest[0]])
            rest = rest[1:]
        else:
            return mangled
    return f"{name}<{', '.join(args)}>"


def ptxas_kernels(log: str) -> list[dict]:
    """Each entry function of a -Xptxas -v log: name, registers, spill
    bytes stored and loaded."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"name": kernel_name(m.group(1)), "registers": None,
                        "spill_stores": None, "spill_loads": None})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def build_report(built: dict) -> None:
    """For B1, B2, B3, K1, K2 and K3 (slab and paged): registers and
    spills of each kernel from the build log (a spill fails the run),
    ptxas's wgmma warnings, and the count of wgmma (HGMMA) and mma.sync
    (HMMA) instructions in the built SASS (for B1, B2, B3, K1 and K3 an
    HMMA, or no HGMMA, fails the run)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in SPILL_KERNELS:
        if name not in built:
            print(f"{name}: library was already built, no ptxas log",
                  flush=True)
        else:
            log = built[name][1]
            for k in ptxas_kernels(log):
                print(f"ptxas {name} {k['name']}: {k['registers']} "
                      f"registers, spill stores {k['spill_stores']} B, "
                      f"spill loads {k['spill_loads']} B", flush=True)
                check(k["spill_stores"] == 0 and k["spill_loads"] == 0,
                      f"{name} {k['name']}: ptxas spilled registers")
            for line in log.splitlines():
                if "wgmma" in line.lower():
                    print(f"ptxas {name}: {line.strip()}", flush=True)
        try:
            sass = subprocess.run([cuobjdump, "-sass",
                                   str(_build._lib_path(name))],
                                  capture_output=True, text=True,
                                  check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"{name}: no SASS listing ({e})", flush=True)
            continue
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        hmma = len(re.findall(r"\bHMMA\.", sass))
        print(f"sass {name}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
        if name in WGMMA_KERNELS:
            check(hgmma > 0 and hmma == 0,
                  f"{name}: SASS has {hgmma} HGMMA and {hmma} HMMA")


# -- (c) kernels against their plain versions --------------------------------


def k1_case(gen, m, d, o, out_dtype):
    x = torch.randn(m, d, device=DEV, generator=gen).to(torch.bfloat16)
    w = quant.quantize_int8(torch.randn(d, o, device=DEV, generator=gen)
                            / d ** 0.5)
    got = qm.dequant_matmul(x, w["q"], w["s"], out_dtype)
    again = qm.dequant_matmul(x, w["q"], w["s"], out_dtype)
    ref = qm.dequant_matmul_plain(x, w["q"], w["s"], out_dtype)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K1 m={m} d={d} o={o} {out_dtype}: a "
                                   "second launch gave other bits")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # bf16 output: half an ulp of the largest value per rounding, sums in
    # another order; f32 output: f32 rounding of a d-long sum
    tol = (2 ** -7 if out_dtype == torch.bfloat16 else 1e-5) * scale
    check(math.isfinite(err) and err <= tol,
          f"K1 m={m} d={d} o={o} {out_dtype}: err {err} > {tol}")
    k = n_copies(d * o)
    qs = [w["q"].clone() for _ in range(k)]
    ss = [w["s"].clone() for _ in range(k)]
    wd = [(q.to(torch.bfloat16) * s.to(torch.bfloat16)) for q, s in
          zip(qs, ss)][:n_copies(2 * d * o)]
    ms = time_ms([lambda q=q, s=s: qm.dequant_matmul(x, q, s, out_dtype)
                  for q, s in zip(qs, ss)], 30)
    plain = time_ms([lambda q=q, s=s: qm.dequant_matmul_plain(
        x, q, s, out_dtype) for q, s in zip(qs, ss)], 10)
    lib = time_ms([lambda w=w_: torch.matmul(x, w) for w_ in wd], 30)
    ob = 4 if out_dtype == torch.float32 else 2
    b, by = bound_ms(m * d * 2 + d * o + o * 4 + m * o * ob, 2.0 * m * d * o)
    return dict(err=err, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by)


def kv_inputs(gen, b, t, nkv, hd, int8, slot_stride=None):
    """K, V (and scales) [b, t, nkv, hd] as views of a slab whose slots are
    slot_stride elements apart, as the engine's cache hands them over."""
    rows = (slot_stride or t * nkv * hd) // (nkv * hd)
    kf = torch.randn(b, rows, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(b, rows, nkv, hd, device=DEV, generator=gen)
    if int8:
        kq, ks = llama.quantize_kv(kf)
        vq, vs = llama.quantize_kv(vf)
        return kq[:, :t], vq[:, :t], ks[:, :t], vs[:, :t]
    return (kf.to(torch.bfloat16)[:, :t], vf.to(torch.bfloat16)[:, :t],
            None, None)


def slab_copy(x):
    """A copy of a slab view that keeps its strides."""
    if x is None:
        return None
    base = x.new_empty(x.shape[0], x.stride(0) // x[0, 0].numel(),
                       *x.shape[2:])
    out = base[:, :x.shape[1]]
    out.copy_(x)
    return out


def dequant(x, s):
    return x if s is None else (x.float() * s[..., None]).to(torch.bfloat16)


# Attention errors are held per output row (one query position of one
# head) against that row's largest value: bf16 probabilities and output,
# rounded at other places in the two versions, stay within a few bf16 ulps
# of it.
ATTN_ROW_TOL = 2 ** -6
# K3 with int8 K/V: the plain version (the JAX mha path) also rounds the
# dequantized K and V to bf16 before the products, where the kernel keeps
# the scales in f32 as the TPU kernel does; on a row that sees few keys
# the softmax amplifies that rounding past the limit above.
ATTN_ROW_TOL_K3_INT8 = 2 ** -5


def attn_err(got, ref, name, row_tol, grad=False):
    """The max abs error, and the worst row's error over the row's largest
    value, which must be at most row_tol. For a gradient (grad=True) the
    row's largest value is floored at the median row's: a row whose exact
    gradient cancels to about 0 (dq of the first causal row, where dp
    equals delta) holds only rounding residue in both versions."""
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    if grad:
        scale = scale.clamp_min(scale.median())
    err = diff.max().item()
    worst = (diff / scale.clamp_min(1e-30)).max().item()
    check(math.isfinite(err) and worst <= row_tol,
          f"{name}: a row's err is {worst:.4g} of its largest value "
          f"> {row_tol:.4g}")
    return err, worst


def k2_case(gen, s_v, span, int8, b=8, nh=32, nkv=8, hd=128,
            slot_stride=None, lengths="ragged", times=True, window=None):
    """K2 against its plain version, a repeat launch bit for bit, and its
    times (with times). lengths: "ragged" (random, the first slot
    reaching the end of the span), "zero" (every slot at position 0) or
    "one_long" (the first slot at the end, the others in its first 100
    positions). window (start, n): the b slots are slot rows [start,
    start + b) of a slab of n slots, as a stage of the stage-sharded
    engine hands a microbatch over (split_slots n), and give the bits of
    a launch over the whole slab."""
    start, n = window or (0, b)
    q_all = torch.randn(n, s_v, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    kv_all = kv_inputs(gen, n, span, nkv, hd, int8, slot_stride)
    top = {"ragged": span - s_v + 1, "zero": 1, "one_long": 100}[lengths]
    mode = lengths
    lengths_all = torch.randint(0, top, (n,), device=DEV, generator=gen,
                                dtype=torch.int32)
    if mode != "zero":
        lengths_all[start] = span - s_v
    rows = slice(start, start + b)
    q, lengths = q_all[rows], lengths_all[rows]
    k, v, ks, vs = [None if x is None else x[rows] for x in kv_all]
    kw = dict(k_scale=ks, v_scale=vs)
    split = n if window else None
    got = fd.flash_decode_attention(q, k, v, lengths, split_slots=split,
                                    **kw)
    again = fd.flash_decode_attention(q, k, v, lengths, split_slots=split,
                                      **kw)
    ref = fd.flash_decode_plain(q, k, v, lengths, **kw)
    name = (f"K2 B={b} S_v={s_v} span={span} hd={hd} int8={int8} "
            f"lengths={mode}" + (f" window={window}" if window else ""))
    err, worst = attn_err(got, ref, name, ATTN_ROW_TOL)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    if window is not None:
        whole = fd.flash_decode_attention(q_all, kv_all[0], kv_all[1],
                                          lengths_all, k_scale=kv_all[2],
                                          v_scale=kv_all[3])
        check(torch.equal(whole[rows], got),
              f"{name}: the window's rows give other bits than the launch "
              "over the whole slab")
    if not times:
        return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL)
    elem = 1 if int8 else 2
    kv_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(slab_copy(x) for x in (k, v, ks, vs))
              for _ in range(n_copies(kv_bytes))]
    ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3],
        split_slots=split) for c in copies], 50)
    plain = time_ms([lambda c=c: fd.flash_decode_plain(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
        for c in copies], 10)
    # library yardstick: SDPA on the dequantized bf16 cache, [B, kv, T, hd]
    pos = lengths.long()[:, None] + torch.arange(s_v, device=DEV)
    mask = (torch.arange(span, device=DEV)[None, None, None, :]
            <= pos[:, None, :, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in copies[:n_copies(k.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        50)
    live = torch.clamp(lengths.long() + s_v, max=span).sum().item()
    nbytes = (live * nkv * hd * elem * 2 + (live * nkv * 8 if int8 else 0)
              + q.numel() * 4 + b * 4)
    b_ms, by = bound_ms(nbytes, 4.0 * live * (nh // nkv) * nkv * s_v * hd)
    return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)


def paged_inputs(gen, b, span, bt, nkv, hd, int8, n_pool=None,
                 lengths=None, s_v=1):
    """A pool of n_pool blocks (by default half again what the batch
    needs) with large finite junk in block 0, ragged lengths (the first
    slot at the end of the span) unless given, and tables [b, span // bt]
    that name a shuffled set of blocks for each slot's live keys and
    block 0 past them, as the engine leaves them."""
    nb = span // bt
    n_pool = n_pool or b * nb * 3 // 2 + 1
    if lengths is None:
        lengths = torch.randint(0, span - s_v + 1, (b,), device=DEV,
                                generator=gen, dtype=torch.int32)
        lengths[0] = span - s_v
    kf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    kf[0] *= 1e4
    vf[0] *= 1e4
    if int8:
        k, ks = llama.quantize_kv(kf)
        v, vs = llama.quantize_kv(vf)
        ks[0] = vs[0] = 1e4
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    perm = torch.randperm(n_pool - 1, device=DEV, generator=gen) + 1
    live = (lengths.long() + s_v + bt - 1) // bt
    tables = torch.zeros(b, nb, dtype=torch.int32, device=DEV)
    start = 0
    for i, n in enumerate(live.tolist()):
        check(start + n <= n_pool - 1, "paged inputs: pool too small")
        tables[i, :n] = perm[start:start + n].to(torch.int32)
        start += n
    return lengths, k, v, ks, vs, tables


def k2_paged_case(gen, s_v, span, bt, int8, b=8, nh=32, nkv=8, hd=128,
                  n_pool=None, times=True):
    """K2-paged against its plain version, a repeat launch bit for bit,
    the slab kernel on the same keys gathered into a slab bit for bit, and
    its times beside K2-slab's on that slab. The library yardstick is
    SDPA on KV already gathered and dequantized: the gather is not
    counted."""
    q = torch.randn(b, s_v, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    lengths, k, v, ks, vs, tables = paged_inputs(gen, b, span, bt, nkv, hd,
                                                 int8, n_pool, s_v=s_v)
    kw = dict(k_scale=ks, v_scale=vs)
    got = fd.flash_decode_attention(q, k, v, lengths, tables=tables, **kw)
    again = fd.flash_decode_attention(q, k, v, lengths, tables=tables, **kw)
    ref = fd.flash_decode_plain(q, k, v, lengths, tables=tables, **kw)
    sk, sv, sks, svs = fd.gather_pages(tables, k, v, ks, vs)
    slab = fd.flash_decode_attention(q, sk, sv, lengths, k_scale=sks,
                                     v_scale=svs)
    name = (f"K2-paged B={b} S_v={s_v} span={span} bt={bt} hd={hd} "
            f"int8={int8} pool={k.shape[0]}")
    err, worst = attn_err(got, ref, name, ATTN_ROW_TOL)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    check(torch.equal(got, slab), f"{name}: other bits than the slab "
                                  "kernel on the same keys")
    if not times:
        return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL)
    elem = 1 if int8 else 2
    pool_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
              for _ in range(n_copies(pool_bytes))]
    ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3], tables=tables)
        for c in copies], 50)
    plain = time_ms([lambda c=c: fd.flash_decode_plain(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3], tables=tables)
        for c in copies], 10)
    slab_bytes = sk.numel() * elem * 2 + (sks.numel() * 8 if int8 else 0)
    slabs = [tuple(None if x is None else x.clone()
                   for x in (sk, sv, sks, svs))
             for _ in range(n_copies(slab_bytes))]
    slab_ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
        for c in slabs], 50)
    pos = lengths.long()[:, None] + torch.arange(s_v, device=DEV)
    mask = (torch.arange(span, device=DEV)[None, None, None, :]
            <= pos[:, None, :, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in slabs[:n_copies(sk.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        50)
    live = torch.clamp(lengths.long() + s_v, max=span)
    n_live = live.sum().item()
    table_bytes = ((live + bt - 1) // bt).sum().item() * 4
    nbytes = (n_live * nkv * hd * elem * 2 + (n_live * nkv * 8 if int8 else 0)
              + q.numel() * 4 + b * 4 + table_bytes)
    b_ms, by = bound_ms(nbytes, 4.0 * n_live * nh * s_v * hd)
    return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                slab_ms=slab_ms)


def k3_case(gen, s, q_offset, int8, b=2, nh=32, nkv=8, hd=128, t=None,
            slot_stride=None, times=True):
    t = q_offset + s if t is None else t
    q = torch.randn(b, s, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    k, v, ks, vs = kv_inputs(gen, b, t, nkv, hd, int8, slot_stride)
    kw = dict(q_offset=q_offset, k_scale=ks, v_scale=vs)
    got = fp.flash_prefill_attention(q, k, v, **kw)
    again = fp.flash_prefill_attention(q, k, v, **kw)
    ref = fp.flash_prefill_plain(q, k, v, **kw)
    row_tol = ATTN_ROW_TOL_K3_INT8 if int8 else ATTN_ROW_TOL
    name = (f"K3 B={b} S={s} H={nh} kv={nkv} hd={hd} q_offset={q_offset} "
            f"int8={int8}")
    err, worst = attn_err(got, ref, name, row_tol)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    if not times:
        return dict(err=err, worst_row=worst, row_tol=row_tol)
    ms = time_ms([lambda: fp.flash_prefill_attention(q, k, v, **kw)], 20)
    plain = time_ms([lambda: fp.flash_prefill_plain(q, k, v, **kw)], 5)
    mask = (torch.arange(t, device=DEV)[None, :]
            <= q_offset + torch.arange(s, device=DEV)[:, None])
    kk = dequant(k, ks).transpose(1, 2).contiguous()
    vv = dequant(v, vs).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True)], 20)
    elem = 1 if int8 else 2
    # keys summed over rows: row i sees min(t, q_offset + i + 1)
    visible = sum(min(t, q_offset + i + 1) for i in range(s))
    nbytes = (2 * q.numel() * 2 + k.numel() * elem * 2
              + (ks.numel() * 8 if int8 else 0))
    b_ms, by = bound_ms(nbytes, 4.0 * b * nh * hd * visible)
    return dict(err=err, worst_row=worst, row_tol=row_tol, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)


def k3_paged_case(gen, b, s, q_offset, bt, int8, nb, nh=32, nkv=8, hd=128,
                  n_pool=None, times=True):
    """K3-paged against its plain version, a repeat launch bit for bit, the
    slab kernel on the same keys gathered into a slab bit for bit, and its
    times beside K3-slab's on that slab. The pool holds n_pool blocks (by
    default half again what the batch needs) with large finite junk in
    block 0; each slot's table names a shuffled set of blocks for the keys
    its rows can see and block 0 past them, as an engine leaves them. The
    library yardstick is SDPA on KV already gathered and dequantized: the
    gather is not counted."""
    t = nb * bt
    n_keys = min(t, q_offset + s)          # keys the deepest row sees
    live = -(-n_keys // bt)
    n_pool = n_pool or b * nb * 3 // 2 + 1
    q = torch.randn(b, s, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    kf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    kf[0] *= 1e4
    vf[0] *= 1e4
    if int8:
        k, ks = llama.quantize_kv(kf)
        v, vs = llama.quantize_kv(vf)
        ks[0] = vs[0] = 1e4
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    del kf, vf
    check(b * live <= n_pool - 1, "K3-paged inputs: pool too small")
    perm = torch.randperm(n_pool - 1, device=DEV, generator=gen) + 1
    tables = torch.zeros(b, nb, dtype=torch.int32, device=DEV)
    tables[:, :live] = perm[:b * live].reshape(b, live).to(torch.int32)
    kw = dict(q_offset=q_offset, k_scale=ks, v_scale=vs)
    got = fp.flash_prefill_attention(q, k, v, tables=tables, **kw)
    again = fp.flash_prefill_attention(q, k, v, tables=tables, **kw)
    ref = fp.flash_prefill_plain(q, k, v, tables=tables, **kw)
    sk, sv, sks, svs = fd.gather_pages(tables, k, v, ks, vs)
    skw = dict(q_offset=q_offset, k_scale=sks, v_scale=svs)
    slab = fp.flash_prefill_attention(q, sk, sv, **skw)
    row_tol = ATTN_ROW_TOL_K3_INT8 if int8 else ATTN_ROW_TOL
    name = (f"K3-paged B={b} S={s} H={nh} kv={nkv} hd={hd} "
            f"q_offset={q_offset} bt={bt} nb={nb} int8={int8} pool={n_pool}")
    err, worst = attn_err(got, ref, name, row_tol)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    check(torch.equal(got, slab), f"{name}: other bits than the slab "
                                  "kernel on the same keys")
    if not times:
        return dict(err=err, worst_row=worst, row_tol=row_tol)
    elem = 1 if int8 else 2
    pool_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
              for _ in range(n_copies(pool_bytes))]
    ms = time_ms([lambda c=c: fp.flash_prefill_attention(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3],
        tables=tables) for c in copies], 20)
    plain = time_ms([lambda c=c: fp.flash_prefill_plain(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3],
        tables=tables) for c in copies[:1]], 5)
    slab_bytes = sk.numel() * elem * 2 + (sks.numel() * 8 if int8 else 0)
    slabs = [tuple(None if x is None else x.clone()
                   for x in (sk, sv, sks, svs))
             for _ in range(n_copies(slab_bytes))]
    slab_ms = time_ms([lambda c=c: fp.flash_prefill_attention(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3])
        for c in slabs], 20)
    mask = (torch.arange(t, device=DEV)[None, :]
            <= q_offset + torch.arange(s, device=DEV)[:, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in slabs[:n_copies(sk.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        20)
    del copies, slabs, lib_kv
    # each row sees min(t, q_offset + i + 1) keys; the bytes are the keys
    # the deepest row sees (and their scales and table entries), q and out
    visible = sum(min(t, q_offset + i + 1) for i in range(s))
    nbytes = (2 * q.numel() * 2 + b * n_keys * nkv * hd * elem * 2
              + (b * n_keys * nkv * 8 if int8 else 0) + b * live * 4)
    b_ms, by = bound_ms(nbytes, 4.0 * b * nh * hd * visible)
    return dict(err=err, worst_row=worst, row_tol=row_tol, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                slab_ms=slab_ms)


# K3-paged in (c): the serving profiler's prefill probe on the 8B paged
# engine (B=8 slots, a 32-row chunk at the end of a 2048-key span), and
# the engine's 1024-token wave (B=3) in a 2048-key table whose entries
# past the keys it sees name block 0; each at four block sizes
K3_PAGED_CASES = (
    [dict(b=8, s=32, q_offset=2016, bt=bt, nb=2048 // bt, int8=int8)
     for bt in (16, 64, 128, 256) for int8 in (True, False)]
    + [dict(b=3, s=1024, q_offset=0, bt=bt, nb=2048 // bt, int8=int8)
       for bt in (16, 64, 128, 256) for int8 in (True, False)])


def fmt(case: dict) -> str:
    tol = (f"worst row {case['worst_row']:.3g} of its max, tol "
           f"{case['row_tol']:.3g}" if "row_tol" in case
           else f"tol {case['tol']:.3g}")
    return (f"max_abs_err={case['err']:.3g} ({tol}) "
            f"ms={case['ms']:.4f} plain_ms={case['plain_ms']:.4f} "
            f"library_ms={case['library_ms']:.4f} "
            f"bound_ms={case['bound_ms']:.4f} ({case['bound_by']})"
            + (f" slab_ms={case['slab_ms']:.4f}" if "slab_ms" in case
               else ""))


def k1_round() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
            "nbytes": 0.0, "ops": 0.0}


def kernel_phase(gen) -> tuple[dict, dict]:
    """Every case of (c); returns K1's entry for the kernels line, one 8B
    decode step (the engine's decode shapes, m = 8 slots), and K1's sum
    over one 8B verify round at each m of K1_VERIFY_M."""
    rounds = {m: k1_round() for m in (8,) + K1_VERIFY_M}
    # m = 13 and 128: the kernel's activation tile edge (13 rounds up to
    # 16) and the gate's top; 48, 80 and 112 (verify rounds) only in the
    # output type the engine asks for
    for m in (1, 8, 13, 32, 48, 80, 112, 128):
        for (d, o) in list(K1_LAYER) + [K1_HEAD]:
            engine_od = (torch.float32 if (d, o) == K1_HEAD
                         else torch.bfloat16)
            for od in (torch.bfloat16, torch.float32):
                if m in (48, 80, 112) and od != engine_od:
                    continue
                c = k1_case(gen, m, d, o, od)
                print(f"K1 m={m} d={d} o={o} out={od}: {fmt(c)}",
                      flush=True)
                if m in rounds and od == engine_od:
                    # one 8B decode step (m = 8) or verify round
                    mult = 1 if (d, o) == K1_HEAD else 32 * K1_LAYER[d, o]
                    r = rounds[m]
                    for key in ("ms", "plain_ms", "library_ms"):
                        r[key] += mult * c[key]
                    r["err"] = max(r["err"], c["err"])
                    ob = 4 if od == torch.float32 else 2
                    r["nbytes"] += mult * (m * d * 2 + d * o + o * 4
                                           + m * o * ob)
                    r["ops"] += mult * 2.0 * m * d * o
    for m, r in rounds.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("nbytes"),
                                                r.pop("ops"))
        what = ("decode step (8 slots" if m == 8 else
                f"verify round (16 slots x {m // 16} rows")
        print(f"K1 one {what}, 32 layers + lm_head, m={m}): "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    k1_step = rounds.pop(8)
    for s_v in (1, 4):
        for span in (128, 2048):
            for int8 in (True, False):
                c = k2_case(gen, s_v, span, int8)
                print(f"K2 B=8 S_v={s_v} span={span} int8={int8}: "
                      f"{fmt(c)}", flush=True)
    # S_v = 8 (32 rows a kv head, the kernel's limit); span 200 (a partial
    # 64-key tile); every length 0 (each block's share one tile or none);
    # one slot far past the others in a slab longer than the span
    k2_more = [dict(s_v=8, span=2048, int8=True),
               dict(s_v=8, span=2048, int8=False),
               dict(s_v=1, span=200, int8=True),
               dict(s_v=4, span=200, int8=False),
               dict(s_v=1, span=1024, int8=True, lengths="zero"),
               dict(s_v=4, span=1024, int8=False, lengths="zero"),
               dict(s_v=1, span=600, int8=True, lengths="one_long",
                    slot_stride=2048 * 8 * 128)]
    for kw in k2_more:
        c = k2_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K2 B=8 {desc}: {fmt(c)}", flush=True)
    # verify rows at the ISVC's 16 slots: S_v = 7 (speculative 6, 28 rows a
    # kv head), 9 and 17 (36 and 68 rows: two and three 32-row groups;
    # 17 is speculative 16), slab and paged
    for s_v in (7, 9, 17):
        c = k2_case(gen, s_v, 2048, True, b=16)
        print(f"K2 B=16 S_v={s_v} span=2048 int8=True: {fmt(c)}",
              flush=True)
        c = k2_paged_case(gen, s_v, 2048, 128, True, b=16)
        print(f"K2-paged B=16 S_v={s_v} span=2048 bt=128 int8=True: "
              f"{fmt(c)}", flush=True)
    for s_v in (1, 4):
        for span in (1024, 2048):
            for bt in (16, 64, 128):
                for int8 in (True, False):
                    c = k2_paged_case(gen, s_v, span, bt, int8)
                    print(f"K2-paged B=8 S_v={s_v} span={span} bt={bt} "
                          f"int8={int8}: {fmt(c)}", flush=True)
    for s in (128, 512):
        for q_offset in (0, 512):
            for int8 in (False, True):
                c = k3_case(gen, s, q_offset, int8)
                print(f"K3 B=2 S={s} q_offset={q_offset} int8={int8}: "
                      f"{fmt(c)}", flush=True)
    # the engine's 1024-token wave; the group sizes 1, 2, 8 (and 3) at hd 64;
    # a ragged int8 continuation in a slab longer than its keys (tile
    # edges of the mask, the slot stride of the 4-D TMA map)
    k3_more = [dict(b=3, s=1024, q_offset=0, int8=False)]
    k3_more += [dict(b=2, s=512, q_offset=q_offset, int8=int8, nh=8 * g,
                     nkv=8, hd=64)
                for g in (1, 2, 8) for q_offset, int8 in ((0, False),
                                                          (256, True))]
    k3_more.append(dict(b=2, s=200, q_offset=300, int8=True,
                        slot_stride=2048 * 8 * 128))
    # g = 3 does not divide the 128-row tile: 2 pad rows per block
    k3_more.append(dict(b=2, s=100, q_offset=37, int8=True, nh=24, nkv=8,
                        hd=64))
    for kw in k3_more:
        c = k3_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K3 {desc}: {fmt(c)}", flush=True)
    for kw in K3_PAGED_CASES:
        c = k3_paged_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K3-paged {desc}: {fmt(c)}", flush=True)
        torch.cuda.empty_cache()
    return (dict(k1_step, shape="one 8B decode step: 224 int8 matmuls at "
                 "m=8 + lm_head"), rounds)


# -- (d) small-model reference ------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_phase(seed: int) -> None:
    """Prefill, chunked prefill (a continuation link), decode and verify
    logits of a small int8 model (widths that pass every kernel gate) on
    the card against the CPU run of the same functions, which takes the
    plain versions."""
    cfg = llama.LlamaConfig(vocab_size=1024, d_model=512, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=1024,
                            dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = llama.init(cfg, seed=seed, device=DEV, quantize="int8")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    lengths = torch.tensor([100, 128], dtype=torch.int32)
    outs = {}
    for side, dev, p in (("card", DEV, params),
                         ("cpu", "cpu", _to(params, "cpu"))):
        tok = tokens.to(dev)
        logits, ks, vs = llama.prefill(p, tok[:, :128], cfg)
        cache = llama.init_cache(cfg, 2, 256, "int8", device=dev)
        prefix = []
        for name, val in (("k", ks), ("v", vs)):
            q8, sc = llama.quantize_kv(val)
            cache[name][:, :, :128] = q8
            cache[name + "_s"][:, :, :128] = sc
            prefix.append(llama.dequantize_kv(q8, sc, cfg.dtype))
        # a chunked prefill's next link, as the engine runs it: the next
        # 128 tokens against the first 128 rows dequantized from the int8
        # cache (K3 at q_offset 128 on the card)
        chunk = llama.prefill_continue(p, tok[:, 128:], *prefix, cfg)[0]
        dec = llama.decode_step(p, tok[:, 127], cache, lengths.to(dev), cfg)
        ver = llama.verify_step(p, tok[:, :4], cache, lengths.to(dev) + 1,
                                cfg)
        outs[side] = [x.float().cpu() for x in (logits, chunk, dec, ver)]
    for name, got, ref in zip(("prefill", "chunked prefill", "decode",
                               "verify"), outs["card"], outs["cpu"]):
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"reference {name}: bad shape or non-finite logits")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # bf16 model, two layers, KV re-quantized from slightly different
        # prefill values on each side: 5% of the logit range
        check(err <= 0.05 * scale, f"reference {name}: err {err} > "
                                   f"{0.05 * scale}")
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"reference {name}: logits {tuple(got.shape)} "
              f"max_abs_err={err:.4g} (tol {0.05 * scale:.4g}) "
              f"argmax agreement {agree:.3f}", flush=True)


# -- (h) training attention kernels against their plain versions ------------


def two_documents(b: int, s: int) -> torch.Tensor:
    """[b, s] int32 segment ids, two documents per row, the boundary of
    row i at s // 2 + 17 * (i + 1): inside a 64-row tile of every
    kernel."""
    seg = torch.zeros(b, s, dtype=torch.int32, device=DEV)
    for i in range(b):
        seg[i, s // 2 + 17 * (i + 1):] = 1
    return seg


def visible_pairs(b: int, s: int, causal: bool, seg, seg_q=None) -> int:
    """(query row, key) pairs visible in this input, summed over the
    batch: the work the attention kernels must do for it. With seg_q
    (not causal) the query rows' ids differ from the keys' `seg`."""
    if seg_q is not None:
        return sum(int((seg_q[i, :, None] == seg[i, None, :]).sum())
                   for i in range(b))
    total = 0
    for i in range(b):
        lens = ([s] if seg is None else
                torch.unique_consecutive(seg[i], return_counts=True)[1]
                .tolist())
        total += sum(n * (n + 1) // 2 if causal else n * n for n in lens)
    return total


def train_attn_case(gen, b, s, causal, segments, h=32, d=128, ids=None):
    """B1, B2 and B3 at one shape against their plain versions (run per
    batch row, to hold the [H, S, S] f32 scores of one row at a time),
    repeat-launch bitwise equality, and each kernel's, plain and SDPA
    times with its bound. `ids` = (query ids, key ids) [B, S]: a ring
    step's segments, the query rows' other than the keys'. Returns
    {kernel: case}."""
    def mk():
        return torch.randn(b, s, h, d, device=DEV, generator=gen).to(
            torch.bfloat16)

    q, k, v, do = mk(), mk(), mk(), mk()
    seg_q, seg = (None, two_documents(b, s) if segments else None) \
        if ids is None else ids
    kw = dict(causal=causal, segment_ids=seg, q_segment_ids=seg_q)
    _build.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.row_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    shape_key = {name: next(iter(_build.SHAPES[name]))
                 for name in TRAINING_KERNELS}
    again = (*fa.flash_fwd(q, k, v, **kw),
             fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in
              zip((o, lse, dq, dk, dv), again)),
          f"B1-B3 B={b} S={s}: a second launch gave other bits")

    def rows(i):
        sl = slice(i, i + 1)
        return dict(causal=causal,
                    segment_ids=None if seg is None else seg[sl],
                    q_segment_ids=None if seg_q is None else seg_q[sl]), sl

    def plain_fwd_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_fwd(q[sl], k[sl], v[sl], **kwi))
        return [torch.cat(x) for x in zip(*outs)]

    def plain_dq_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_bwd_dq(q[sl], k[sl], v[sl], do[sl],
                                        lse[sl], delta[sl], **kwi))
        return torch.cat(outs)

    def plain_dkv_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_bwd_dkv(q[sl], k[sl], v[sl], do[sl],
                                         lse[sl], delta[sl], **kwi))
        return [torch.cat(x) for x in zip(*outs)]

    name = f"B={b} S={s} causal={causal} segments={segments}" + (
        "" if ids is None else " (query ids other than the keys')")
    ro, rlse = plain_fwd_all()
    errs = {"o": attn_err(o, ro, f"B1 {name} o", ATTN_ROW_TOL),
            "lse": attn_err(lse, rlse, f"B1 {name} lse", ATTN_ROW_TOL)}
    del ro, rlse
    errs["dq"] = attn_err(dq, plain_dq_all(), f"B2 {name} dq", ATTN_ROW_TOL,
                          grad=True)
    rdk, rdv = plain_dkv_all()
    errs["dk"] = attn_err(dk, rdk, f"B3 {name} dk", ATTN_ROW_TOL, grad=True)
    errs["dv"] = attn_err(dv, rdv, f"B3 {name} dv", ATTN_ROW_TOL, grad=True)
    del rdk, rdv
    torch.cuda.empty_cache()

    ms = {"fwd": time_ms([lambda: fa.flash_fwd(q, k, v, **kw)], 10),
          "dq": time_ms([lambda: fa.flash_bwd_dq(
              q, k, v, do, lse, delta, **kw)], 10),
          "dkv": time_ms([lambda: fa.flash_bwd_dkv(
              q, k, v, do, lse, delta, **kw)], 10)}
    plain = {"fwd": time_ms([plain_fwd_all], 2),
             "dq": time_ms([plain_dq_all], 2),
             "dkv": time_ms([plain_dkv_all], 2)}
    torch.cuda.empty_cache()
    # library yardstick: SDPA forward, and its backward (dq, dk and dv in
    # one autograd call) as forward+backward less the forward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None
    if seg is not None:
        mask = (seg if seg_q is None else seg_q)[:, None, :, None] \
            == seg[:, None, None, :]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device=DEV).tril()
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    dot = do.transpose(1, 2)
    with torch.no_grad():
        lib_fwd = time_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_kw)], 10)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    lib_fb = time_ms([sdpa_fwd_bwd], 10)
    del qt, kt, vt, mask
    pairs = h * visible_pairs(b, s, causal, seg, seg_q)
    x = b * s * h * d * 2           # one bf16 [B, S, H, D] tensor
    rowv = b * h * s * 4            # one f32 [B, H, S] vector
    segb = 0 if seg is None else (1 if seg_q is None else 2) * b * s * 4
    bounds = {"fwd": bound_ms(4 * x + rowv + segb, 4.0 * d * pairs),
              "dq": bound_ms(5 * x + 2 * rowv + segb, 6.0 * d * pairs),
              "dkv": bound_ms(6 * x + 2 * rowv + segb, 8.0 * d * pairs)}
    lib = {"fwd": lib_fwd, "dq": lib_fb - lib_fwd, "dkv": lib_fb - lib_fwd}
    out = {}
    for kern, part, outs in (("flash_attn_fwd", "fwd", ("o", "lse")),
                             ("flash_attn_dq", "dq", ("dq",)),
                             ("flash_attn_dkv", "dkv", ("dk", "dv"))):
        worst = max(errs[n][1] for n in outs)
        out[kern] = dict(
            err=max(errs[n][0] for n in outs), worst_row=worst,
            row_tol=ATTN_ROW_TOL, ms=ms[part], plain_ms=plain[part],
            library_ms=lib[part], bound_ms=bounds[part][0],
            bound_by=bounds[part][1],
            errs={n: errs[n] for n in outs}, shape_key=shape_key[kern],
            shape=f"one launch at {name} H={h} D={d}")
    return out


def train_attn_phase(gen) -> dict:
    """(h): the three training-attention kernels at the training shapes,
    plus B1's forward-only q_offset path. Returns the kernels-line
    entries from the trainer's shape (B=2, S=4096, causal)."""
    entries = None
    for b, s, causal, segments in ((2, 4096, True, False),
                                   (2, 4000, True, True),
                                   (2, 1024, False, False)):
        case = train_attn_case(gen, b, s, causal, segments)
        for kern, c in case.items():
            errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                            c["errs"].items())
            print(f"{kern} B={b} S={s} causal={causal} "
                  f"segments={segments}: {errs}; {fmt(c)}", flush=True)
        entries = entries or case
        torch.cuda.empty_cache()
    # B1 alone: the continuation prefill (forward only, rows at q_offset
    # 512 of 812 keys, with segments), head dim 64, and 200 rows (not a
    # multiple of the 128-row tile), causal and not
    for kw in (dict(b=1, sq=300, sk=812, q_offset=512, segments=True),
               dict(b=2, sq=1024, sk=1024, d=64),
               dict(b=2, sq=1024, sk=1024, d=64, causal=False,
                    segments=True),
               dict(b=2, sq=200, sk=200),
               dict(b=2, sq=200, sk=200, causal=False)):
        b1_case(gen, **kw)
    # B2 and B3 at the edges of their tiles: head dim 64; 200 rows (not a
    # multiple of 64 or 128), causal and not; 320 causal, whose last key
    # block holds 64 keys and whose last 128-row block 64 rows
    for kw in (dict(b=2, s=1024, d=64),
               dict(b=2, s=1024, d=64, causal=False, segments=True),
               dict(b=2, s=200),
               dict(b=2, s=200, causal=False),
               dict(b=2, s=200, segments=True),
               dict(b=2, s=320)):
        bwd_case(gen, **kw)
    return entries


def b1_case(gen, b, sq, sk, h=32, d=128, causal=True, q_offset=0,
            segments=False):
    """B1 against its plain version (o and lse), and a repeat launch bit
    for bit."""
    q = torch.randn(b, sq, h, d, device=DEV, generator=gen).to(
        torch.bfloat16)
    k, v = (torch.randn(b, sk, h, d, device=DEV, generator=gen).to(
        torch.bfloat16) for _ in range(2))
    seg = two_documents(b, sk) if segments else None
    kw = dict(causal=causal, q_offset=q_offset, segment_ids=seg)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.plain_fwd(q, k, v, **kw)
    name = (f"flash_attn_fwd B={b} Sq={sq} Sk={sk} H={h} D={d} "
            f"causal={causal} q_offset={q_offset} segments={segments}")
    e_o = attn_err(o, ro, f"{name} o", ATTN_ROW_TOL)
    e_l = attn_err(lse, rlse, f"{name} lse", ATTN_ROW_TOL)
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          f"{name}: a second launch gave other bits")
    print(f"{name}: o worst row {e_o[1]:.3g}, lse worst row {e_l[1]:.3g} "
          f"(tol {ATTN_ROW_TOL:.3g})", flush=True)


def bwd_case(gen, b, s, h=32, d=128, causal=True, segments=False):
    """B2 and B3 against their plain versions (dq, dk, dv), from B1's lse,
    and a repeat launch bit for bit."""
    q, k, v, do = (torch.randn(b, s, h, d, device=DEV, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    seg = two_documents(b, s) if segments else None
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.row_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    name = f"B2/B3 B={b} S={s} H={h} D={d} causal={causal} " \
           f"segments={segments}"
    check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
          and torch.equal(dv, dv2), f"{name}: a second launch gave other "
                                    "bits")
    rdq = fa.plain_bwd_dq(q, k, v, do, lse, delta, **kw)
    rdk, rdv = fa.plain_bwd_dkv(q, k, v, do, lse, delta, **kw)
    worst = {n: attn_err(g, r, f"{name} {n}", ATTN_ROW_TOL, grad=True)[1]
             for n, g, r in (("dq", dq, rdq), ("dk", dk, rdk),
                             ("dv", dv, rdv))}
    print(f"{name}: " + ", ".join(f"{n} worst row {w:.3g}" for n, w in
                                  worst.items())
          + f" (tol {ATTN_ROW_TOL:.3g}); same bits twice", flush=True)


# -- (i) small model: training loss and grads, card against CPU -------------


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device).requires_grad_(True)


# bf16 model, two layers: a grad leaf on the card is held within 2^-4 of
# the leaf's largest value of the CPU run (bf16 rounds at other places in
# the kernels and the GEMMs); the loss within 1% of the CPU loss
GRAD_LEAF_TOL = 2 ** -4
LOSS_RTOL = 1e-2


def train_reference_phase(seed: int) -> None:
    """(i): loss_fn and every grad of a small bf16 Llama (2 layers, d 512,
    hd 128, GQA 4/2, vocab 4096, seq 256, two documents per row and a
    loss mask) through the kernels on the card against the same function
    on the CPU, which takes the plain versions."""
    cfg = llama.LlamaConfig(vocab_size=4096, d_model=512, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=1024,
                            max_seq_len=256)
    params = llama.init(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    b, s = 2, 256
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, dtype=torch.int32),
             "segment_ids": torch.zeros(b, s, dtype=torch.int32),
             "loss_mask": (torch.rand(b, s, generator=gen) < 0.7).float()}
    batch["segment_ids"][0, 100:] = 1
    batch["segment_ids"][1, 150:] = 1
    out = {}
    _build.reset_launches()
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        p = tree_to(params, dev)
        loss, aux = llama.loss_fn(p, {k: v.to(dev) for k, v in
                                      batch.items()}, cfg)
        grads = torch.autograd.grad(loss, train.leaves(p))
        out[side] = (loss.item(), aux["tokens"].item(),
                     [g.float().cpu() for g in grads])
    for name in TRAINING_KERNELS:
        check(_build.LAUNCHES[name] > 0,
              f"train reference: {name} was not launched on the card")
    (cl, ct, cg), (rl, rt, rg) = out["card"], out["cpu"]
    check(math.isfinite(cl) and ct == rt, "train reference: bad loss")
    check(abs(cl - rl) <= LOSS_RTOL * abs(rl),
          f"train reference: loss {cl} vs CPU {rl}")
    worst, worst_name = 0.0, ""
    names = [".".join(k) for k in leaf_names(params)]
    for name, g, r in zip(names, cg, rg):
        check(bool(torch.isfinite(g).all()), f"train reference: {name} "
                                             "grad not finite")
        rel = ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= GRAD_LEAF_TOL, f"train reference: grad {worst_name} "
                                  f"off by {worst:.4g} of its max")
    print(f"train reference: loss card {cl:.6f} cpu {rl:.6f} (tol "
          f"{LOSS_RTOL:.0%}); worst grad leaf {worst_name} {worst:.4g} of "
          f"its max (tol {GRAD_LEAF_TOL:.4g}); kernel launches "
          f"{json.dumps({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})}",
          flush=True)


def leaf_names(tree, prefix=()):
    """Key paths of a nested dict in train.leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            prefix + (k,))]
    return [prefix]


# -- (j) the trainer at Llama-3-8B width -------------------------------------


TRAIN_STEPS = 6
# the two runs' losses: the same seed and data; the embedding gradient's
# scatter-add on the card may sum in another order from run to run
TRAIN_LOSS_RTOL = 1e-3


def train_config(seed: int) -> train.TrainerConfig:
    """Llama-3-8B width with the depth cut to 4 layers, B=2 x S=4096,
    AdamW with 2 warmup steps of 100, remat "minimal" (the defaults)."""
    base = llama.LlamaConfig.llama3_8b()
    overrides = {f: getattr(base, f) for f in (
        "vocab_size", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "rope_theta")}
    overrides.update(n_layers=4, max_seq_len=4096)
    return train.TrainerConfig(
        model="llama", model_overrides=overrides, batch_size=2,
        optimizer=train.OptimizerConfig(warmup_steps=2, total_steps=100),
        dataset=train_data.DatasetConfig(seq_len=4096), seed=seed,
        log_every=1)


def train_run(cfg: train.TrainerConfig):
    """One trainer run of TRAIN_STEPS; returns (trainer, state, per-step
    metrics, cumulative launches after each step)."""
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    state = trainer.init_state()
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    log, counts = [], []

    def on_step(step, scalars):
        log.append(scalars)
        counts.append({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})

    trainer.train(data, TRAIN_STEPS, state, step_callback=on_step)
    return trainer, state, log, counts, data


def step_profile(trainer, state, batch) -> dict:
    """One training step's wall time against the card's busy time from the
    profiler's kernel events, by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    busy = {"flash_attn_fwd": 0.0, "flash_attn_dq": 0.0,
            "flash_attn_dkv": 0.0, "conv": 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        key = evt.key.lower()
        if "fwd_kernel" in key:
            busy["flash_attn_fwd"] += ms
        elif "dq_kernel" in key:
            busy["flash_attn_dq"] += ms
        elif "dkv_kernel" in key:
            busy["flash_attn_dkv"] += ms
        elif any(w in key for w in ("conv", "cudnn", "dgrad", "wgrad",
                                    "fprop")):
            busy["conv"] += ms
        elif any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")):
            busy["gemm"] += ms
        else:
            busy["other"] += ms
    device_ms = sum(busy.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "busy_ms_by_kernel": busy,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "top_kernels_ms": {k[:90]: round(v, 3) for k, v in top}}


def trainer_phase(seed: int, attn_shape: dict) -> tuple[dict, dict]:
    """(j): the trainer at the Llama-3-8B-width config, twice from the same
    seed; each kernel must have run at the shape (h) timed it at
    (attn_shape, its _build.SHAPES key). Returns the training kernels'
    launches in run 1 and run 1's stats."""
    cfg = train_config(seed)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    trainer, state, log, counts, data = train_run(cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
    shapes = {k: dict(_build.SHAPES[k]) for k in TRAINING_KERNELS}
    mcfg = trainer.model_cfg
    tokens = cfg.batch_size * cfg.dataset.seq_len
    flops = llama.flops_per_token(mcfg, cfg.dataset.seq_len) * tokens
    for i, m in enumerate(log):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"trainer: step {i + 1} loss/grad_norm not finite")
        print(f"trainer step {i + 1}: loss={m['loss']:.6f} "
              f"grad_norm={m['grad_norm']:.6f} "
              f"step_time_s={m['step_time_s']:.4f}"
              + (" (includes the first launches)" if i == 0 else ""),
              flush=True)
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    for name in TRAINING_KERNELS:
        check(all(p[name] >= mcfg.n_layers for p in per_step),
              f"trainer: {name} launched fewer than once per layer in a "
              f"step: {[p[name] for p in per_step]}")
        check(attn_shape[name] in shapes[name],
              f"trainer: {name} never ran at the shape phase (h) timed")
    steady = sorted(m["step_time_s"] for m in log[1:])
    step_s = steady[len(steady) // 2]
    stats = {"step_time_s_median": step_s,
             "tokens_per_s": tokens / step_s,
             "mfu": mfu.mfu(flops, step_s, 1),
             "flops_per_step": flops, "peak_memory_gb": peak_gb,
             "launches_per_step": per_step[-1],
             "params": sum(p.numel() for p in train.leaves(state["params"]))}
    print(f"trainer: Llama-3-8B width, {mcfg.n_layers} layers, B="
          f"{cfg.batch_size} S={cfg.dataset.seq_len}: {json.dumps(stats)}",
          flush=True)
    # (n) holds the sharded trainer to run 1
    stats["loss"] = [m["loss"] for m in log]
    stats["grad_norm"] = [m["grad_norm"] for m in log]
    profile_batch = trainer.to_device(next(data))
    del trainer, state
    torch.cuda.empty_cache()
    trainer2, state2, log2, _, _ = train_run(cfg)
    for i, (a, b) in enumerate(zip(log, log2)):
        check(abs(a["loss"] - b["loss"]) <= TRAIN_LOSS_RTOL * abs(a["loss"]),
              f"trainer: run 2 step {i + 1} loss {b['loss']} vs "
              f"{a['loss']}")
    diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(log, log2))
    print(f"trainer: run 2 losses {[round(m['loss'], 6) for m in log2]}; "
          f"max |loss diff| vs run 1 {diff:.3g} (tol "
          f"{TRAIN_LOSS_RTOL:g} relative)", flush=True)
    prof = step_profile(trainer2, state2, profile_batch)
    print(f"train step breakdown: {json.dumps(prof)}", flush=True)
    del trainer2, state2
    torch.cuda.empty_cache()
    return launches, stats


def trainer_profile_phase(seed: int, base_step_s: float) -> None:
    """(j2): the trainer of (j) once more with profile_dir set (window at
    steps 2 and 3 of 6): PROFILE_DONE must name that window and one trace
    file must be written; prints each step's time, inside and outside the
    window, beside (j)'s median step. The trace goes to a temporary
    directory, removed after."""
    import tempfile

    logdir = tempfile.mkdtemp(prefix="kft_profile_")
    try:
        cfg = dataclasses.replace(train_config(seed), profile_dir=logdir,
                                  profile_start_step=2, profile_num_steps=2)
        trainer, state, log, _, _ = train_run(cfg)
        del trainer, state
        torch.cuda.empty_cache()
        with open(os.path.join(logdir, "PROFILE_DONE")) as f:
            done = f.read()
        check(done == "steps 2..3\n",
              f"trainer profile: PROFILE_DONE says {done!r}")
        traces = [f for f in os.listdir(logdir) if ".pt.trace.json" in f]
        check(len(traces) == 1, f"trainer profile: trace files {traces}")
        size = os.path.getsize(os.path.join(logdir, traces[0]))
        times = [m["step_time_s"] for m in log]
        check(all(math.isfinite(m["loss"]) for m in log),
              "trainer profile: loss not finite")
        outside = sorted(times[3:])[len(times[3:]) // 2]
        print(f"trainer profile window: step times {json.dumps(times)} "
              f"(steps 2-3 profiled; step 3 also writes the trace, "
              f"{size} bytes); median outside the window {outside:.4f} s, "
              f"(j)'s median {base_step_s:.4f} s", flush=True)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


# -- (j3) the training job: corpus, checkpoints, kill and resume, serve -------


#: examples/llama-longctx-jaxjob.yaml's KTPU_TRAINER_CONFIG as written
#: (tests/test_torch_job.py holds them equal): a Llama job over a
#: token_file corpus at head dim 128 with a bf16 first moment. (j3) runs
#: it cut to J3_STEPS steps logged each step and J3_LAYERS layers, so
#: that its five saves and (e6)'s 16.06 GB stay under J3_DISK_BUDGET_GB
#: of disk writes in one run (deleted files count: the disk under a
#: machine's temp directory may be an image that never shrinks); the
#: Llama-3-8B-width state of (j) is 23.1 GB a save at 4 layers
J3_JOB = {"model": "llama", "batch_size": 1, "num_steps": 30,
          "log_every": 5,
          "model_overrides": {"vocab_size": 32000, "d_model": 2048,
                              "n_layers": 8, "n_heads": 16,
                              "n_kv_heads": 8, "d_ff": 7168,
                              "max_seq_len": 8192,
                              "attention_impl": "flash",
                              "remat": True, "remat_policy": "minimal",
                              "scan_layers": False},
          "dataset": {"type": "token_file", "path": "/tmp/corpus.bin",
                      "seq_len": 8192},
          "mesh": {"data": -1},
          "optimizer": {"learning_rate": 0.0003, "warmup_steps": 10,
                        "mu_dtype": "bfloat16"}}
J3_LAYERS = 2
J3_DISK_BUDGET_GB = 45 * 2 ** 30 / 1e9
J3_OTHER_WRITES_GB = 17.0   # (e6)'s 16.06 GB, the builds, traces, corpus
J3_CORPUS_TOKENS = 1 << 24       # uint32 tokens, 64 MiB, from --seed
J3_STEPS = 6
J3_CANCEL_AT = 5                 # the first run is cancelled at this step
J3_EVERY, J3_KEEP = 2, 2         # checkpoint_every, keep_checkpoints
J3_PROMPTS = 8
J3_NEW = 16


def j3_checkpoint_gb(overrides: dict, mu_dtype: str | None) -> float:
    """One checkpoint's tensor bytes: f32 params and nu, mu in mu_dtype."""
    n = sum(t.numel() for t in train.leaves(llama.abstract_params(
        llama.LlamaConfig(**overrides))))
    mu = getattr(torch, mu_dtype).itemsize if mu_dtype else 4
    return n * (8 + mu) / 1e9


class J3Cancel(threading.Event):
    """A cancel event that reads as set from its n-th check on: the job
    checks it once a logged step, so n=J3_CANCEL_AT cancels at that step
    (before its save), as a pod deletion would."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.checks = n, 0

    def is_set(self) -> bool:
        self.checks += 1
        return self.checks >= self.n or super().is_set()


class Tee:
    """stdout that is also kept, to read what the job printed."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def j3_run(env: dict, cancel) -> tuple[int, str]:
    """train_target as the control plane calls it: (exit code, stdout)."""
    import contextlib

    from kubeflow_tpu_torch.training import job

    tee = Tee(sys.stdout)
    code = 0
    with contextlib.redirect_stdout(tee):
        try:
            job.train_target(env, cancel)
        except SystemExit as e:
            code = e.code
    gc.collect()   # the run's state, held by the exception's frames
    torch.cuda.empty_cache()
    return code, tee.text()


def j3_saves(text: str) -> list[dict]:
    """The trainer's "[checkpoint N] {...}" lines."""
    return [json.loads(m.group(1)) for m in
            re.finditer(r"^\[checkpoint \d+\] (\{.*\})$", text, re.M)]


def j3_steps(ckpt: str) -> list[int]:
    return sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())


def j3_same(a, b, path="") -> None:
    """Every leaf of two state trees bit for bit."""
    if isinstance(a, dict):
        check(sorted(a) == sorted(b), f"j3: keys differ at {path}")
        for k in a:
            j3_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"j3: lengths differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            j3_same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a.detach(), b.detach()),
              f"j3: leaf {path} differs from the restored step")
    else:
        check(a == b, f"j3: {path} is {a}, restored {b}")


def j3_serve(ckpt, overrides, params, mcfg, seed) -> list:
    """The checkpoint served by LLMModel against the in-process params:
    each model's greedy tokens for J3_PROMPTS prompts."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(30, 1000, (J3_PROMPTS,), generator=gen).tolist()
    prompts = [torch.randint(0, mcfg.vocab_size, (n,),
                             generator=gen).tolist() for n in lens]
    body = [{"prompt_tokens": p, "max_new_tokens": J3_NEW} for p in prompts]
    serving = dict(n_slots=J3_PROMPTS, max_len=2048,
                   buckets=(128, 512, 1024), quantize="int8",
                   kv_quantize="int8", supervised=False, device=DEV)
    outs = []
    for label, kw in (("checkpoint", dict(checkpoint=ckpt,
                                          model=overrides)),
                      ("params", dict(params=params, llama_config=mcfg))):
        _build.reset_launches()
        t = time.monotonic()
        model = LLMModel(f"j3-{label}", **serving, **kw)
        model.load()
        load_s = time.monotonic() - t
        try:
            rows = model.predict(body)
        finally:
            model.unload()
        launched = {k: _build.LAUNCHES[k] for k in SERVING_KERNELS}
        check(all(launched.values()),
              f"j3: serving the {label} launched {launched}")
        toks = [r["output_tokens"] for r in rows]
        check(all(len(t) == J3_NEW for t in toks),
              f"j3: {label} gave {[len(t) for t in toks]} tokens")
        print(f"j3 serve ({label}): load + warmup {load_s:.2f} s, "
              f"launches {json.dumps(launched)}", flush=True)
        outs.append(toks)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def training_job_phase(seed: int) -> dict:
    """(j3): the port's trainer as a job, through training/job.py
    train_target, over a token corpus and integrity-checked checkpoints;
    the checkpoint served by LLMModel. See the module doc."""
    import numpy as np

    from kubeflow_tpu_torch.chaos import (FaultScriptConfig, FaultSpec,
                                          generate_fault_script,
                                          set_io_fault_hook)
    from kubeflow_tpu_torch.training import checkpoint as ckpt_lib
    from kubeflow_tpu_torch.training import loader
    from kubeflow_tpu_torch.training.metrics_writer import read_metrics

    root = tempfile.mkdtemp(prefix="kft_j3_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        mu_dtype = J3_JOB["optimizer"].get("mu_dtype")
        n_layers = J3_LAYERS
        overrides = dict(J3_JOB["model_overrides"], n_layers=n_layers)
        ckpt_gb = j3_checkpoint_gb(overrides, mu_dtype)
        # three checkpoints exist while a save lands; five are written
        if (free_gb < 3 * ckpt_gb + 1 or 5 * ckpt_gb + J3_OTHER_WRITES_GB
                > J3_DISK_BUDGET_GB):
            n_layers = max(1, J3_LAYERS // 2)
            overrides["n_layers"] = n_layers
            ckpt_gb = j3_checkpoint_gb(overrides, mu_dtype)
        print(f"j3: {free_gb:.1f} GB free under {root}; {n_layers} layers "
              f"(the example's {J3_JOB['model_overrides']['n_layers']}"
              + (f", cut to {n_layers} for the disk"
                 if n_layers != J3_LAYERS else "")
              + f"), a checkpoint {ckpt_gb:.3f} GB, five saves "
              f"{5 * ckpt_gb:.2f} GB of a {J3_DISK_BUDGET_GB:.2f} GB "
              "budget", flush=True)
        batch, seq = J3_JOB["batch_size"], J3_JOB["dataset"]["seq_len"]
        corpus = os.path.join(root, "corpus.bin")
        rng = np.random.default_rng(seed)
        loader.write_corpus(corpus, rng.integers(
            0, overrides["vocab_size"], J3_CORPUS_TOKENS, dtype=np.uint32))
        rates = {}
        for name, cls in (("native", loader.NativeTokenLoader),
                          ("python", loader.PyTokenLoader)):
            it = cls(corpus, batch, seq, seed)
            next(it)
            t = time.perf_counter()
            for _ in range(200):
                next(it)
            rates[name] = 200 / (time.perf_counter() - t)
            it.close()
        print(f"j3 loader: batches/s (B={batch} x {seq}) "
              f"{json.dumps(rates)}", flush=True)
        ckpt = os.path.join(root, "ckpt")
        raw = dict(J3_JOB, model_overrides=overrides, num_steps=J3_STEPS,
                   log_every=1, seed=seed,
                   dataset=dict(J3_JOB["dataset"], path=corpus),
                   checkpoint_dir=ckpt, checkpoint_every=J3_EVERY,
                   keep_checkpoints=J3_KEEP)
        metrics = os.path.join(root, "metrics.jsonl")
        env = {"KTPU_TRAINER_CONFIG": json.dumps(raw),
               "KTPU_METRICS_FILE": metrics, "KTPU_TORCH_DEVICE": DEV}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        code, out1 = j3_run(env, J3Cancel(J3_CANCEL_AT))
        check(code == 143, f"j3: the cancelled run exited {code}")
        steps1 = j3_steps(ckpt)
        print(f"j3 run 1: cancelled at step {J3_CANCEL_AT}, exit {code}, "
              f"steps kept {steps1} (orbax's rule: the initial save, "
              f"every {J3_EVERY}, the newest {J3_KEEP})", flush=True)
        check(steps1 == [2, 4], f"j3: run 1 left steps {steps1}")
        code, out2 = j3_run(env, threading.Event())
        check(code == 0, f"j3: the resumed run exited {code}")
        check("resumed from checkpoint at step 4" in out2,
              "j3: run 2 did not resume from step 4")
        steps2 = j3_steps(ckpt)
        check(steps2 == [4, 6], f"j3: run 2 left steps {steps2}")
        launched = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
        check(all(n >= n_layers * (J3_CANCEL_AT + 2)
                  for n in launched.values()),
              f"j3: the two runs launched {launched}")
        job_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [(r["step"], r["metrics"]) for r in read_metrics(metrics)]
        check([s for s, _ in rows] == [1, 2, 3, 4, 5, 5, 6],
              f"j3: logged steps {[s for s, _ in rows]}")
        check(all(math.isfinite(m["loss"]) for _, m in rows),
              "j3: a loss is not finite")
        saves = j3_saves(out1) + j3_saves(out2)
        check([s["step"] for s in saves] == [1, 2, 4, 6],
              f"j3: saves at {[s['step'] for s in saves]}")
        for s in saves:
            check("manifest_failed" not in s, f"j3: save {s} unmanifested")
        # run 1: step k's time holds the save of step k - 1 (if any)
        times = {s: m["step_time_s"] for s, m in rows[:5]}
        with_save = [times[s] for s in (2, 3, 5)]
        without = [times[4]]
        print(f"j3 runs: losses {[round(m['loss'], 6) for _, m in rows]}; "
              f"B1-B3 launches {json.dumps(launched)}; peak "
              f"{job_peak_gb:.2f} GB", flush=True)

        # in-process: step 4 restored, steps 5-6 again on batches 0-1
        cfg = train.TrainerConfig.from_dict(
            {k: v for k, v in raw.items() if k != "checkpoint_dir"})
        trainer = train.Trainer(cfg, device=DEV,
                                metrics=MetricsWriter(echo=False))
        mngr = ckpt_lib.CheckpointManager(ckpt, max_to_keep=J3_KEEP)
        t = time.perf_counter()
        check(ckpt_lib.verify_step(ckpt, 4) == "intact",
              "j3: step 4 is not intact")
        verify_s = time.perf_counter() - t
        state = mngr.restore(trainer.abstract_state(), step=4, device=DEV)
        restore4 = dict(mngr.last_restore, verify_s=verify_s)
        data = train_data.make_dataset(cfg.dataset, cfg.model,
                                       trainer.model_cfg, cfg.batch_size,
                                       fallback_seed=cfg.seed)
        log = []
        trainer.train(data, 2, state,
                      step_callback=lambda s, m: log.append(m))
        want = [m["loss"] for s, m in rows[5:]]
        got = [m["loss"] for m in log]
        check(got == want, f"j3: steps 5-6 in-process losses {got}, the "
                           f"resumed job's {want}")
        state6 = mngr.restore(trainer.abstract_state(), step=6, device=DEV)
        j3_same(state, state6)
        del state6
        torch.cuda.empty_cache()
        print(f"j3 in-process: step 4 restored ({json.dumps(restore4)}), "
              f"steps 5-6 losses {got} equal to the resumed job's bit for "
              "bit, every leaf equal to step 6's restored leaf", flush=True)

        params = {k: ({kk: vv.detach() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.detach())
                  for k, v in state["params"].items()}
        served = j3_serve(ckpt, overrides, params, trainer.model_cfg, seed)
        check(served[0] == served[1],
              "j3: the served checkpoint's tokens differ from the "
              "in-process params'")
        del params

        # one more step and its save under a scripted ckpt_io_fail
        trainer.train(data, 1, state)
        data.close()
        inj = FaultInjector(generate_fault_script(FaultScriptConfig(
            seed=seed, duration_s=1.0,
            faults=(FaultSpec("ckpt_io_fail", 1, (0.0, 0.0)),)),
            name="j3"))
        inj.start()
        prev = set_io_fault_hook(inj.as_io_fault_hook())
        try:
            check(mngr.save(7, state), "j3: step 7 was not saved")
        finally:
            set_io_fault_hook(prev)
        save7 = mngr.last_save
        check([f["kind"] for f in inj.log()] == ["ckpt_io_fail"],
              f"j3: the injector fired {inj.log()}")
        t = time.perf_counter()
        fallback = mngr.latest_intact_step()
        fallback_s = time.perf_counter() - t
        check(fallback == 6, f"j3: latest_intact_step gave {fallback}")
        check(os.path.isdir(os.path.join(ckpt, ckpt_lib.QUARANTINE_DIR,
                                         "7")),
              "j3: step 7 was not quarantined")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        stats = {
            "layers": n_layers, "free_gb": free_gb,
            "checkpoint_gb": saves[-1]["bytes"] / 1e9,
            "written_gb": sum(x["bytes"] for x in saves + [save7]) / 1e9,
            "saves": saves + [save7],
            "restore_step4": restore4,
            "fallback_verify_s": fallback_s,
            "loader_batches_per_s": rates,
            "step_s_after_a_save": with_save,
            "step_s_without": without,
            "stall_s": sum(with_save) / len(with_save) - without[0],
            "run2_step6_s": rows[-1][1]["step_time_s"],
            "job_peak_gb": job_peak_gb, "peak_gb": peak_gb}
        print(f"j3 training job: {json.dumps(stats)}", flush=True)
        return stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- (l) LoRA fine-tune at 8B width, (l2) the LoRA job ------------------------

L_RANK, L_ALPHA = 8, 16.0
L_SEQ = 4096
#: B=2 x S=4096 as (j) when it fits one card, else B=1 (printed)
L_BATCHES = (2, 1)
L_STEPS = 6
#: examples/llama-lora-jaxjob.yaml's trainer config, key for key (a test
#: holds it equal); (l2) only points dataset.path and checkpoint_dir at
#: its temp directory
L2_JOB = {"model": "llama_lora", "batch_size": 8, "num_steps": 50,
          "log_every": 10,
          "model_overrides": {"rank": 8, "alpha": 16.0,
                              "llama": {"vocab_size": 2048, "d_model": 256,
                                        "n_layers": 4, "n_heads": 8,
                                        "n_kv_heads": 4, "d_ff": 1024,
                                        "max_seq_len": 512}},
          "dataset": {"type": "token_file", "path": "/tmp/corpus.bin",
                      "seq_len": 256},
          "mesh": {"data": -1},
          "checkpoint_dir": "/tmp/ckpt/llama-lora",
          "optimizer": {"learning_rate": 0.001, "warmup_steps": 5,
                        "trainable_prefix": "lora"}}
L2_CORPUS_TOKENS = 1 << 20
L2_PROMPTS = 8
L2_NEW = 16
#: the bound on the top-2 gap where the adapter route first differs from
#: the merged model (E7_OTHER_GAP's): the card's kernels run bf16, and
#: bf16 (or int8) of a merged weight is not bf16 (int8) of the base plus
#: an f32 bypass, so the two part by up to a rounding step a weight; a
#: model trained 50 steps on random tokens has many near-ties
L2_GAP = 0.2
L2_MAX_LEN = 512
L2_TOPK = 4
#: the route's first-token logprob error against the f32 merged model may
#: be this many times the engine-merged model's largest: each serves the
#: f32 function through one rounding of its weights to the served dtype
L2_LP_FACTOR = 2.0


def lora_config(seed: int, base_ckpt: str, batch: int) -> train.TrainerConfig:
    """(l)'s job: llama_lora at Llama-3-8B width, all 32 layers, rank 8,
    alpha 16, the default targets (wq, wk, wv, wo), the base from the HF
    directory (e6) wrote, trainable_prefix "lora", (j)'s optimizer and
    data otherwise."""
    base = llama.LlamaConfig.llama3_8b()
    fields = {f: getattr(base, f) for f in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
        "d_ff", "rope_theta")}
    fields["max_seq_len"] = L_SEQ
    return train.TrainerConfig(
        model="llama_lora",
        model_overrides={"rank": L_RANK, "alpha": L_ALPHA, "llama": fields,
                         "base_checkpoint": base_ckpt},
        batch_size=batch,
        optimizer=train.OptimizerConfig(warmup_steps=2, total_steps=100,
                                        trainable_prefix="lora"),
        dataset=train_data.DatasetConfig(seq_len=L_SEQ), seed=seed,
        log_every=1)


def bits_fingerprint(t: torch.Tensor) -> tuple[int, int]:
    """Two 64-bit sums over a tensor's bit patterns (plain and weighted by
    a position hash), taken on the card a slice at a time: equal before
    and after means the bits are unchanged (a copy of the 32 GB base for
    an exact compare does not fit beside the training state)."""
    flat = t.detach().reshape(-1)
    flat = flat.view(torch.int32 if flat.element_size() == 4
                     else torch.int16)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 24
    for i in range(0, flat.numel(), step):
        x = flat[i:i + step].to(torch.int64)
        w = (torch.arange(i, i + x.numel(), device=t.device,
                          dtype=torch.int64) * 2654435761) % (1 << 31) + 1
        s1 += x.sum()
        s2 += (x * w).sum()
    return int(s1), int(s2)


def lora_run(cfg: train.TrainerConfig) -> tuple[list, dict]:
    """One (l) run of L_STEPS: returns its per-step metrics and stats and
    holds the base bit for bit, the b leaves moving by step 2, optimizer
    state for the adapters alone and B1-B3 launched each step."""
    torch.cuda.reset_peak_memory_stats()
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    t = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    named = train.named_leaves(state["params"])
    base = [(p, x) for p, x in named if p.startswith("base/")]
    lora_leaves = [x for p, x in named if p.startswith("lora/")]
    opt = state["opt_state"]
    check([m.shape for m in opt["mu"]] == [x.shape for x in lora_leaves]
          and [n.shape for n in opt["nu"]] == [x.shape
                                               for x in lora_leaves],
          "l: optimizer state is not the adapters' alone")
    check(not any(x.requires_grad for _, x in base),
          "l: a base leaf requires grad")
    opt_bytes = sum(x.nbytes for x in opt["mu"] + opt["nu"])
    before = [bits_fingerprint(x) for _, x in base]
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    log, counts = [], []
    moved = {}

    def on_step(step, scalars):
        log.append(scalars)
        counts.append({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})
        if step == 2:
            moved.update({t: bool(ab["b"].abs().max() > 0) for t, ab in
                          state["params"]["lora"].items()})

    _build.reset_launches()
    trainer.train(data, L_STEPS, state, step_callback=on_step)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = [bits_fingerprint(x) for _, x in base]
    changed = [p for (p, _), a, b in zip(base, before, after) if a != b]
    check(not changed, f"l: base leaves changed: {changed[:4]}")
    check(moved and all(moved.values()),
          f"l: b leaves still zero after step 2: {moved}")
    mcfg = trainer.model_cfg
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    for name in TRAINING_KERNELS:
        check(all(p[name] >= mcfg.n_layers for p in per_step),
              f"l: {name} launched fewer than once per layer in a step: "
              f"{[p[name] for p in per_step]}")
    for i, m in enumerate(log):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"l: step {i + 1} loss/grad_norm not finite")
    tokens = cfg.batch_size * cfg.dataset.seq_len
    steady = sorted(m["step_time_s"] for m in log[1:])
    step_s = steady[len(steady) // 2]
    flops = llama.flops_per_token(mcfg, cfg.dataset.seq_len) * tokens
    stats = {"batch": cfg.batch_size, "seq_len": cfg.dataset.seq_len,
             "init_s": init_s, "step_time_s_median": step_s,
             "tokens_per_s": tokens / step_s,
             "mfu_jax_formula": mfu.mfu(flops, step_s, 1),
             "peak_memory_gb": peak_gb,
             "optimizer_state_bytes": opt_bytes,
             "adapter_params": sum(x.numel() for x in lora_leaves),
             "base_params": sum(x.numel() for _, x in base),
             "launches_per_step": per_step[-1]}
    del trainer, state, base, lora_leaves, opt, named
    gc.collect()
    torch.cuda.empty_cache()
    return log, stats


def lora_train_phase(seed: int, base_ckpt: str) -> dict:
    """(l): see the module docstring."""
    gc.collect()
    torch.cuda.empty_cache()
    for batch in L_BATCHES:
        cfg = lora_config(seed, base_ckpt, batch)
        try:
            log, stats = lora_run(cfg)
            break
        except torch.OutOfMemoryError as e:
            print(f"l: B={batch} x S={L_SEQ} does not fit one card "
                  f"({str(e).splitlines()[0][:160]})", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise SmokeFailure("l: no batch fits one card")
    for i, m in enumerate(log):
        print(f"l step {i + 1}: loss={m['loss']:.6f} "
              f"grad_norm={m['grad_norm']:.6f} "
              f"step_time_s={m['step_time_s']:.4f}"
              + (" (includes the first launches)" if i == 0 else ""),
              flush=True)
    log2, _ = lora_run(cfg)
    same = [a["loss"] == b["loss"] for a, b in zip(log, log2)]
    check(all(same), f"l: the repeat run's losses differ: "
                     f"{[m['loss'] for m in log2]}")
    print(f"l LoRA fine-tune: Llama-3-8B width, 32 layers, rank {L_RANK} "
          f"alpha {L_ALPHA} on wq/wk/wv/wo, base from (e6)'s HF directory "
          f"(f32, frozen): {json.dumps(stats)}; MFU by the JAX formula "
          "(6 x every matmul param, so it counts the frozen weights' "
          "weight gradients, which are never computed); the repeat run's "
          "losses equal bit for bit", flush=True)
    return stats


def padded_train_case(gen, b, s, h, hd, causal=True, segments=False):
    """B1, B2 and B3 through flash_attention's route for a head dim under
    the kernels' smallest (zero-padded heads): o, dq, dk and dv at head
    dim hd against the plain versions at hd, each kernel launched once."""
    q, k, v, do = (torch.randn(b, s, h, hd, device=DEV, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    seg = two_documents(b, s) if segments else None
    kw = dict(causal=causal, segment_ids=seg)
    before = {n: _build.LAUNCHES[n] for n in TRAINING_KERNELS}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, do)
    ran = {n: _build.LAUNCHES[n] - before[n] for n in TRAINING_KERNELS}
    ro, lse = fa.plain_fwd(q, k, v, **kw)
    delta = fa.row_delta(ro, do)
    ref = (fa.plain_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.plain_bwd_dkv(q, k, v, do, lse, delta, **kw))
    name = (f"B1-B3 on padded heads B={b} S={s} H={h} hd={hd} "
            f"causal={causal} segments={segments}")
    check(all(n == 1 for n in ran.values()), f"{name}: launches {ran}")
    worst = {"o": attn_err(o.detach(), ro, f"{name} o", ATTN_ROW_TOL)[1]}
    for n, g, r in zip(("dq", "dk", "dv"), grads, ref):
        worst[n] = attn_err(g, r, f"{name} {n}", ATTN_ROW_TOL, grad=True)[1]
    return name, worst


def padded_head_phase(gen, train_shapes, serve_shapes, hd, max_len) -> None:
    """(l2)'s kernels at the shapes its training and serving launched
    them at, with the model's head dim hd (under 64: the wrappers ran
    them on zero-padded heads, and recorded the padded shapes), each
    against its plain version at hd: B1-B3 through flash_attention, K2
    and K3 on slab views of the engine's layout (max_len positions a
    slot), and K2-paged and K3-paged (no (l2) engine is paged) on pools
    of 128-key blocks, int8 and bf16."""
    check(hd < KERNEL_MIN_HEAD_DIM, f"l2: head dim {hd} is not padded")
    lines = []
    for key in sorted(train_shapes, key=str):
        a = dict(key)
        check(a["d"] == KERNEL_MIN_HEAD_DIM and a["q_offset"] == 0,
              f"l2: training launched B1 at {key}")
        name, worst = padded_train_case(gen, a["b"], a["sq"], a["h"], hd,
                                        a["causal"], a["segmented"])
        lines.append(f"{name}: worst row {json.dumps(worst)}")
    for kernel, by_shape in sorted(serve_shapes.items()):
        for key in sorted(by_shape, key=str):
            a = dict(key)
            check(a["hd"] == KERNEL_MIN_HEAD_DIM,
                  f"l2: {kernel} launched at {key}")
            stride = max_len * a["nkv"] * hd
            if kernel == "flash_decode":
                c = k2_case(gen, a["s_v"], a["t"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=hd,
                            slot_stride=stride, times=False)
            else:
                c = k3_case(gen, a["s"], a["q_offset"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=hd, t=a["t"],
                            slot_stride=stride, times=False)
            desc = " ".join(f"{k}={v}" for k, v in key
                            if k not in ("hd", "slot_stride"))
            lines.append(f"{kernel} {desc} hd={hd} slot_stride={stride}: "
                         f"worst row "
                         f"{c['worst_row']:.3g} (tol {c['row_tol']:.3g})")
    nh, nkv = (dict(next(iter(serve_shapes["flash_decode"])))[k]
               for k in ("nh", "nkv"))
    for int8 in (True, False):
        c = k2_paged_case(gen, 1, max_len, 128, int8, b=16, nh=nh, nkv=nkv,
                          hd=hd, times=False)
        lines.append(f"flash_decode_paged b=16 span={max_len} bt=128 "
                     f"int8={int8} hd={hd}: worst row {c['worst_row']:.3g}")
        c = k3_paged_case(gen, 2, 128, 256, 128, int8, max_len // 128,
                          nh=nh, nkv=nkv, hd=hd, times=False)
        lines.append(f"flash_prefill_paged b=2 s=128 q_offset=256 bt=128 "
                     f"int8={int8} hd={hd}: worst row {c['worst_row']:.3g}")
    print(f"l2 padded heads: {len(lines)} cases against the plain "
          f"versions at hd={hd}: " + "; ".join(lines), flush=True)


def l2_first_lp(rows) -> list[dict]:
    """Each row's first generated position: {token: logprob} of its top
    tokens."""
    return [{int(t): float(lp) for t, lp in r["top"][0].items()}
            for r in rows]


def l2_lp_err(got: list[dict], ref: list[torch.Tensor]) -> list[float]:
    """Per row, the largest |logprob - reference| over the row's top
    tokens (ref: the full f32 log-softmax)."""
    return [max(abs(lp - r[t].item()) for t, lp in g.items())
            for g, r in zip(got, ref)]


def l2_rows(model, body) -> list:
    """An LLMModel's rows for a burst submitted whole: token ids and top
    logprobs."""
    return [{"tokens": r["token_ids"], "top": r.get("top_logprobs")}
            for r in model._submit_wait_all(body)]


def lora_job_phase(seed: int) -> dict:
    """(l2): see the module docstring."""
    import numpy as np

    from kubeflow_tpu_torch.models import lora as lora_lib
    from kubeflow_tpu_torch.training import job
    from kubeflow_tpu_torch.training.checkpoint import restore_params
    from kubeflow_tpu_torch.training.loader import write_corpus
    from kubeflow_tpu_torch.training.metrics_writer import read_metrics

    root = tempfile.mkdtemp(prefix="kft_l2_")
    try:
        raw = json.loads(json.dumps(L2_JOB))
        corpus = os.path.join(root, "corpus.bin")
        ckpt = os.path.join(root, "ckpt")
        metrics = os.path.join(root, "metrics.jsonl")
        vocab = raw["model_overrides"]["llama"]["vocab_size"]
        write_corpus(corpus, np.random.default_rng(seed).integers(
            0, vocab, L2_CORPUS_TOKENS, dtype=np.uint32))
        raw["dataset"]["path"] = corpus
        raw["checkpoint_dir"] = ckpt
        env = {"KTPU_TRAINER_CONFIG": json.dumps(raw),
               "KTPU_METRICS_FILE": metrics, job.DEVICE_ENV: DEV}
        _build.reset_launches()
        t = time.monotonic()
        code, _ = j3_run(env, threading.Event())
        train_s = time.monotonic() - t
        check(code == 0, f"l2: the job exited {code}")
        trained = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
        check(all(trained.values()), f"l2: training launched {trained}")
        train_shapes = dict(_build.SHAPES["flash_attn_fwd"])
        steps = j3_steps(ckpt)
        check(steps == [1, raw["num_steps"]],
              f"l2: checkpoints at {steps}")
        losses = [(r["step"], r["metrics"]["loss"])
                  for r in read_metrics(metrics)]
        check(losses and all(math.isfinite(v) for _, v in losses),
              f"l2: losses {losses}")
        cfg, _ = job.config_from_env(env)
        lcfg = lora_lib.LoraLlamaConfig(**cfg.model_overrides)
        bcfg = lcfg.base_cfg
        bases = [restore_params(ckpt, llama.abstract_params(bcfg), step=s,
                                device=DEV, subtree="params/base")
                 for s in steps]
        check(all(torch.equal(a, b) for a, b in zip(
            train.leaves(bases[0]), train.leaves(bases[1]))),
            "l2: the base moved between the job's first and last step")
        lora_abs = lora_lib.abstract_params(lcfg)["lora"]
        ab = {s: restore_params(ckpt, lora_abs, step=s, device=DEV,
                                subtree="params/lora") for s in steps}
        check(all(not x["b"].any() for x in ab[1].values())
              and all(x["b"].any() for x in ab[steps[-1]].values()),
              "l2: b is not zero at step 1 (lr 0) and moved by the end")
        # the earlier step as an adapter checkpoint of its own
        early = os.path.join(root, "early")
        os.makedirs(early)
        shutil.copytree(os.path.join(ckpt, "1"), os.path.join(early, "1"))
        gen = torch.Generator().manual_seed(seed + 12)
        lens = torch.randint(20, 200, (L2_PROMPTS,), generator=gen).tolist()
        prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                   for n in lens]
        spec = {"rank": lcfg.rank, "alpha": lcfg.alpha}
        serving = dict(n_slots=2 * L2_PROMPTS, max_len=L2_MAX_LEN,
                       buckets=(128, 256), logprobs_topk=L2_TOPK,
                       supervised=False, device=DEV)
        # the reference: each prompt's first-token log-softmax in f32 on
        # the CPU, of the f32 merged model and of the base alone
        f32 = dataclasses.replace(bcfg, dtype=torch.float32)
        cpu_base = _to(bases[-1], "cpu")
        cpu_merged = lora_lib.merge(
            {"base": cpu_base, "lora": _to(ab[steps[-1]], "cpu")}, lcfg)
        ref = {name: [torch.log_softmax(llama.apply(
            p, torch.tensor([pr]), f32)[0, -1], -1) for pr in prompts]
            for name, p in (("merged", cpu_merged), ("base", cpu_base))}
        del cpu_base, cpu_merged
        serve_shapes = {"flash_decode": {}, "flash_prefill": {}}
        out = {"train_s": round(train_s, 2), "losses": losses}
        for quant in (None, "int8"):
            kw = dict(serving, quantize=quant, kv_quantize=quant)
            _build.reset_launches()
            merged = LLMModel("l2-merged", checkpoint=ckpt,
                              model=raw["model_overrides"]["llama"],
                              lora=spec, **kw)
            merged.load()
            try:
                want = l2_rows(merged, [{"prompt_tokens": p,
                                         "max_new_tokens": L2_NEW}
                                        for p in prompts])
            finally:
                merged.unload()
            routed = LLMModel("l2-adapters", params=bases[-1],
                              llama_config=bcfg, adapters={
                                  "ft": dict(spec, checkpoint=ckpt),
                                  "early": dict(spec, checkpoint=early)},
                              **kw)
            routed.load()
            try:
                got = l2_rows(routed, [{"prompt_tokens": p,
                                        "max_new_tokens": L2_NEW,
                                        "adapter": "ft"} for p in prompts])
                mix = l2_rows(routed, [
                    dict({"prompt_tokens": p, "max_new_tokens": L2_NEW},
                         **({"adapter": "early"} if j else {}))
                    for p in prompts for j in (0, 1)])
            finally:
                routed.unload()
            # K1 is the int8 weights' matmul: bf16 weights take cuBLAS
            launched = {k: _build.LAUNCHES[k] for k in SERVING_KERNELS
                        if quant or k != "quant_matmul"}
            check(all(launched.values()),
                  f"l2 ({quant}): serving launched {launched}")
            for k, by_shape in serve_shapes.items():
                by_shape.update(_build.SHAPES[k])
            diffs = [e7_diff(g["tokens"], w["tokens"], g["top"])
                     for g, w in zip(got, want)]
            check(all(len(g["tokens"]) == L2_NEW for g in got),
                  f"l2 ({quant}): token counts")
            check(all(d is None or d["gap"] < L2_GAP for d in diffs),
                  f"l2 ({quant}): the adapter route first differs from the "
                  f"merged model at a top-2 gap over {L2_GAP}: {diffs}")
            # b = 0 at step 1: its bypass adds exact zeros
            base_rows = mix[0::2]
            check(all(b["tokens"] == e["tokens"]
                      for b, e in zip(base_rows, mix[1::2])),
                  f"l2 ({quant}): the step-1 adapter's rows are not the "
                  "base rows")
            check(any(g["tokens"] != b["tokens"]
                      for g, b in zip(got, base_rows)),
                  f"l2 ({quant}): the 'ft' adapter's rows are the base's")
            # first-token logprobs against the f32 reference: the route
            # and the merged model each serve the f32 function through
            # one rounding of its weights to the served dtype, so the
            # route's error may be at most L2_LP_FACTOR times the merged
            # model's, and under half the error of the base rows (a route
            # that dropped the adapter would err by the adapter's effect)
            err = {name: l2_lp_err(l2_first_lp(rows), ref["merged"])
                   for name, rows in (("merged", want), ("route", got),
                                      ("base", base_rows))}
            bound = L2_LP_FACTOR * max(err["merged"])
            check(max(err["route"]) <= bound,
                  f"l2 ({quant}): the route's first-token logprobs err by "
                  f"{max(err['route']):.4g} against f32, over "
                  f"{L2_LP_FACTOR} x the merged model's "
                  f"{max(err['merged']):.4g}")
            check(sum(err["route"]) < 0.5 * sum(err["base"]),
                  f"l2 ({quant}): the route's first-token logprobs are not "
                  f"nearer the merged f32 model than the base's: "
                  f"{sum(err['route']):.4g} against {sum(err['base']):.4g}")
            out[str(quant)] = {
                "rows_equal_merged": sum(d is None for d in diffs),
                "first_diffs": [d for d in diffs if d], "launches": launched,
                "first_lp_err_vs_f32": {k: [round(x, 5) for x in v]
                                        for k, v in err.items()}}
            del merged, routed
            gc.collect()
            torch.cuda.empty_cache()
        padded_head_phase(torch.Generator(device=DEV).manual_seed(seed + 13),
                          train_shapes, serve_shapes, bcfg.head_dim,
                          L2_MAX_LEN)
        print(f"l2 LoRA job ({raw['num_steps']} steps of the example's "
              f"config, checkpoints at {steps}): {json.dumps(out)}",
              flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- (m) the other model families on the card --------------------------------


#: examples/mnist-jaxjob.yaml's KTPU_TRAINER_CONFIG as written
#: (tests/test_torch_vision_models.py holds them equal); (m) leaves out
#: its checkpoint_dir, a path outside the run's temporary directory
M1_JOB = {"model": "mnist_cnn", "batch_size": 32, "num_steps": 60,
          "log_every": 10,
          "optimizer": {"name": "adamw", "learning_rate": 0.003},
          "checkpoint_dir": "/tmp/kubeflow-tpu-examples/mnist-ckpt"}
#: examples/nas-experiment.yaml's trial config as written; (m5) fills in
#: the trial's two ops with M5_OPS
M5_TRIAL = {"model": "nas_cnn",
            "model_overrides": {"ops": ["${trialParameters.op_0}",
                                        "${trialParameters.op_1}"],
                                "channels": 8, "image_size": 8,
                                "n_classes": 4},
            "batch_size": 8, "num_steps": 20, "log_every": 5,
            "optimizer": {"learning_rate": 0.003}}
M5_OPS = ("sep3", "conv3")
M_STEPS = 6
# the width configs' schedule (as (j)): lr reaches its peak in 2 steps
M_OPT = {"warmup_steps": 2, "total_steps": 100}
#: the families whose steps must launch B1-B3 (the others none)
M_FLASH = ("m4 vit", "m6 mixtral")
M_SERVED = ("m3 resnet", "m4 vit")
M7_IMAGES = 8
#: ViT-B/16's attention in (m4): B, S (196 patches and [CLS]), H, D
M4_ATTN = (64, 197, 12, 64)


def m_jobs() -> dict[str, dict]:
    """(m)'s trainer configs, as a job's KTPU_TRAINER_CONFIG holds them."""
    nas = json.loads(json.dumps(M5_TRIAL).replace(
        "${trialParameters.op_0}", M5_OPS[0]).replace(
        "${trialParameters.op_1}", M5_OPS[1]))
    vit = {f: getattr(vit_lib.ViTConfig.vit_b16(), f) for f in (
        "image_size", "patch_size", "n_classes", "d_model", "n_layers",
        "n_heads", "d_ff")}
    mix = moe_llama.MoELlamaConfig.mixtral_8x7b()
    mixtral = {f: getattr(mix, f) for f in (
        "vocab_size", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "rope_theta", "n_experts", "top_k")}
    mixtral.update(n_layers=2, max_seq_len=4096)
    return {
        "m1 mnist_cnn": {k: v for k, v in M1_JOB.items()
                         if k != "checkpoint_dir"},
        # BertConfig's defaults are BertConfig.base(); bert-jaxjob.yaml's
        # optimizer and mesh
        "m2 bert": {"model": "bert", "batch_size": 32, "mesh": {"data": -1},
                    "optimizer": {"learning_rate": 0.0001, **M_OPT},
                    "dataset": {"seq_len": 128}},
        "m3 resnet": {"model": "resnet", "batch_size": 64,
                      "model_overrides": {"image_size": 224,
                                          "n_classes": 1000},
                      "optimizer": dict(M_OPT)},
        "m4 vit": {"model": "vit", "batch_size": 64, "model_overrides": vit,
                   "optimizer": dict(M_OPT)},
        "m5 nas_cnn": nas,
        "m5 darts_supernet": dict(nas, model="darts_supernet"),
        "m6 mixtral": {"model": "mixtral", "batch_size": 1,
                       "model_overrides": mixtral,
                       "dataset": {"seq_len": 4096},
                       "optimizer": dict(M_OPT)}}


def m_run(job: dict, seed: int):
    """One run of M_STEPS steps of a trainer config on the card; returns
    (trainer, state, per-step metrics, B1-B3 launches, peak GB)."""
    cfg = train.TrainerConfig.from_dict(dict(job, log_every=1, seed=seed))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    state = trainer.init_state()
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    log = []
    trainer.train(data, M_STEPS, state,
                  step_callback=lambda s, m: log.append(m))
    launches = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
    return (trainer, state, log, launches,
            torch.cuda.max_memory_allocated() / 1e9, data)


#: (m)'s small reference: a card grad leaf may be off the f32 CPU run by
#: this many times the plain bf16 CPU run's error (or GRAD_LEAF_TOL)
M_REF_FACTOR = 2.0


def m_reference_phase(seed: int) -> None:
    """(m)'s small reference: ViT (its default config: 32 pixels, patch 4,
    S = 65, head dim 64) and Mixtral (tiny: head dim 8, the kernels on
    zero-padded heads) in bf16 through the kernels on the card against
    the same params in f32 on the CPU: the loss within LOSS_RTOL, and
    each grad leaf's largest error, relative to the leaf's largest
    value, within GRAD_LEAF_TOL or M_REF_FACTOR times the error of the
    same bf16 model on the CPU (the plain versions): bf16 alone moves
    some leaves (ViT's wk) past GRAD_LEAF_TOL from f32. The ViT head is
    made nonzero (its init is zero, which stops every other grad);
    Mixtral's router is zero, so every token routes to experts 0 and 1
    in every run (ties take the first index): a near tie could otherwise
    go another way in bf16 than in f32 and move a whole token's
    gradient."""
    gen = torch.Generator().manual_seed(seed)
    cases = (
        ("vit", vit_lib.ViTConfig(), {"image": torch.randn(
            4, 32, 32, 3, generator=gen), "label": torch.randint(
            0, 10, (4,), generator=gen)}),
        ("mixtral", moe_llama.MoELlamaConfig.tiny(), {
            "tokens": torch.randint(0, 512, (2, 128), generator=gen)}))
    for name, cfg, batch in cases:
        mdef = registry.get(name)
        params = mdef.init(dataclasses.replace(cfg, dtype=torch.float32),
                           seed=seed, device="cpu")
        if name == "vit":
            params["head"]["w"] = 0.1 * torch.randn(
                params["head"]["w"].shape, generator=gen)
        else:
            params["layers"]["router"].zero_()
        _build.reset_launches()
        out = {}
        for side, dev, dtype in (("card", DEV, torch.bfloat16),
                                 ("cpu_bf16", "cpu", torch.bfloat16),
                                 ("cpu_f32", "cpu", torch.float32)):
            c = dataclasses.replace(cfg, dtype=dtype)
            p = tree_to(params, dev)
            loss, _ = mdef.loss_fn(p, {k: v.to(dev) for k, v in
                                       batch.items()}, c)
            named = train.named_leaves(p)
            grads = torch.autograd.grad(loss, [t for _, t in named])
            out[side] = (loss.item(), [(n, g.float().cpu()) for (n, _), g
                                       in zip(named, grads)])
        for kern in TRAINING_KERNELS:
            check(_build.LAUNCHES[kern] > 0,
                  f"m reference {name}: {kern} was not launched")
        (cl, cg), (_, bg), (rl, rg) = (out["card"], out["cpu_bf16"],
                                       out["cpu_f32"])
        check(math.isfinite(cl) and abs(cl - rl) <= LOSS_RTOL * abs(rl),
              f"m reference {name}: loss {cl} vs CPU f32 {rl}")
        worst = (0.0, "", 0.0)
        for (n, g), (_, b), (_, r) in zip(cg, bg, rg):
            check(bool(torch.isfinite(g).all()),
                  f"m reference {name}: {n} grad not finite")
            top = r.abs().max().clamp_min(1e-30)
            rel = ((g - r).abs().max() / top).item()
            plain = ((b - r).abs().max() / top).item()
            check(rel <= max(GRAD_LEAF_TOL, M_REF_FACTOR * plain),
                  f"m reference {name}: grad {n} off f32 by {rel:.4g} of "
                  f"its max, the plain bf16 run by {plain:.4g}")
            if rel > worst[0]:
                worst = (rel, n, plain)
        print(f"m reference {name}: loss card bf16 {cl:.6f} cpu f32 "
              f"{rl:.6f} (tol {LOSS_RTOL:.0%}); worst grad leaf "
              f"{worst[1]} {worst[0]:.4g} of its max against f32 (the "
              f"plain bf16 run {worst[2]:.4g}; tol {GRAD_LEAF_TOL:.4g} or "
              f"{M_REF_FACTOR:g}x the plain run's); launches "
              f"{json.dumps({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})}",
              flush=True)


def m7_serve(label: str, job: dict, trainer, state, seed: int,
             root: str) -> dict:
    """(m7): the trained state saved by the port's CheckpointManager and
    served by TrainerCheckpointModel(checkpoint=...) on the card: logits
    for M7_IMAGES images bit for bit the family's apply on the in-process
    params, argmax theirs, a V2 single-tensor payload the same. The
    checkpoint is removed after."""
    from kubeflow_tpu_torch.serving.trainer_runtime import (
        TrainerCheckpointModel)
    from kubeflow_tpu_torch.training.checkpoint import CheckpointManager

    ckpt = os.path.join(root, label.split()[0])
    try:
        t0 = time.monotonic()
        mngr = CheckpointManager(ckpt)
        mngr.save(state["step"], state, force=True)
        mngr.close()
        save_s = time.monotonic() - t0
        images = next(train_data.for_model(
            job["model"], trainer.model_cfg, M7_IMAGES, seed=seed + 7))[
            "image"]
        with torch.no_grad():
            want = trainer.model.apply(
                state["params"], torch.from_numpy(images).to(DEV),
                trainer.model_cfg).float().cpu().numpy()
        got = {}
        for output in ("logits", "argmax"):
            model = TrainerCheckpointModel(
                label, model=job["model"],
                model_overrides=job.get("model_overrides"),
                checkpoint=ckpt, output=output, device=DEV)
            t0 = time.monotonic()
            model.load()
            load_s = time.monotonic() - t0
            got[output] = (model.predict(images.tolist()),
                           model.predict({"image": images}))
            model.unload()
        for i, logits in enumerate(got["logits"]):
            check(logits.dtype == np.float32 and logits.shape == want.shape
                  and np.array_equal(logits, want),
                  f"m7 {label}: served logits ({('V1', 'V2')[i]}) differ "
                  f"from apply's by {np.abs(logits - want).max()}")
        for top in got["argmax"]:
            check(np.array_equal(top, want.argmax(axis=-1)),
                  f"m7 {label}: served argmax differs")
        return {"save_s": round(save_s, 3), "load_s": round(load_s, 3),
                "logits_shape": list(want.shape),
                "checkpoint_gb": round(sum(
                    os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(ckpt) for f in fs) / 1e9, 3)}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def families_phase(seed: int, gen, keep: str | None = None
                    ) -> tuple[dict, dict]:
    """(m): each family's trainer config (m_jobs) on a port Trainer, 6
    steps twice from --seed on for_model's data, with cuDNN's
    deterministic algorithms: finite losses, the repeat's losses bit for
    bit, accuracy logged by the classifiers, B1-B3 launched in (m4) and
    (m6) and in no other family; the median step over steps 2-6,
    samples/s (tokens/s for (m2) and (m6)), peak memory, (m6)'s MFU over
    active experts, one profiled step of (m3), (m4) and (m6), the
    supernet's derived architecture, and (m7). B1-B3 are first held to
    their plain versions at (m4)'s shape. With `keep`, the trained
    params of MM_FAMILIES are saved there for (mm). Returns B1-B3's
    kernel-line entries at (m4)'s shape, with (m4)'s launches, and
    (m6)'s run 1 (losses, aux losses, grad norms, median step) for (n)."""
    print(f"m families on {card_line()}", flush=True)
    # deterministic cuDNN algorithms: with the defaults, (m1)'s repeat
    # differed after step 3 in a full run (not when (m) ran alone); the
    # setting cost nothing measurable alone (PERF.md)
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _families(seed, gen, keep)
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic


def _families(seed: int, gen, keep: str | None) -> tuple[dict, dict]:
    b, s, h, d = M4_ATTN
    attn = train_attn_case(gen, b, s, False, False, h=h, d=d)
    for kern, c in attn.items():
        errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                        c["errs"].items())
        print(f"{kern} at ViT-B/16's B={b} S={s} H={h} D={d} non-causal: "
              f"{errs}; {fmt(c)}", flush=True)
    torch.cuda.empty_cache()
    m_reference_phase(seed)
    root = tempfile.mkdtemp(prefix="chip-smoke-m-")
    stats: dict[str, dict] = {}
    m6_ref: dict = {}
    try:
        for label, job in m_jobs().items():
            runs = []
            for rep in range(2):
                trainer, state, log, launches, peak, data = m_run(job, seed)
                runs.append(log)
                if rep == 0:
                    del trainer, state
                    continue
                st = m_family_stats(label, job, trainer, state, log,
                                    launches, peak, data)
                if label == "m4 vit":
                    shape_key = attn["flash_attn_fwd"]["shape_key"]
                    check(shape_key in _build.SHAPES["flash_attn_fwd"],
                          "m4: B1 never ran at the shape timed before it")
                    for kern in TRAINING_KERNELS:
                        attn[kern]["launches"] = launches[kern]
                if keep is not None and label in MM_FAMILIES:
                    mm_keep(label, job, state, keep)
                if label in M_SERVED:
                    st["m7"] = m7_serve(label, job, trainer, state, seed,
                                        root)
                    print(f"m7 {label}: {json.dumps(st['m7'])}", flush=True)
                if label == "m5 darts_supernet":
                    arch = nas_cnn.derive(state["params"]["alpha"].detach())
                    check(len(arch) == len(M5_OPS) and all(
                        op in nas_cnn.OP_NAMES for op in arch),
                        f"m5: derive gave {arch}")
                    st["derived"] = list(arch)
                del trainer, state
            first, second = ([m["loss"] for m in r] for r in runs)
            check(first == second, f"{label}: run 2's losses {second} "
                                   f"differ from run 1's {first}")
            if label == "m6 mixtral":   # (n) holds {expert: -1} to run 1
                m6_ref = {k: [m[k] for m in runs[0]]
                          for k in ("loss", "aux_loss", "grad_norm")}
                m6_ref["step_time_s_median"] = st["step_time_s_median"]
            stats[label] = st
            print(f"{label}: {json.dumps(st)}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return attn, m6_ref


def m_family_stats(label, job, trainer, state, log, launches, peak,
                   data) -> dict:
    """Checks and numbers of one (m) family's second run."""
    classifier = job["model"] not in ("mixtral",)
    for i, m in enumerate(log):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{label}: step {i + 1} loss/grad_norm not finite")
        check(not classifier or "accuracy" in m,
              f"{label}: step {i + 1} logged no accuracy")
    flash = label in M_FLASH
    for kern in TRAINING_KERNELS:
        check((launches[kern] > 0) == flash,
              f"{label}: {kern} launched {launches[kern]} times")
    cfg = trainer.config
    steady = sorted(m["step_time_s"] for m in log[1:])
    step_s = steady[len(steady) // 2]
    t0 = time.perf_counter()
    batch = next(data)
    data_s = time.perf_counter() - t0
    st = {"losses": [round(m["loss"], 6) for m in log],
          "step_time_s_median": step_s,
          "samples_per_s": cfg.batch_size / step_s,
          "data_s_per_batch": data_s, "peak_memory_gb": peak,
          "b1_b3_launches": launches,
          "params": sum(p.numel() for p in train.leaves(state["params"]))}
    if "accuracy" in log[-1]:
        st["accuracy"] = [m["accuracy"] for m in log]
    if job["model"] in ("bert", "mixtral"):
        tokens = cfg.batch_size * cfg.dataset.seq_len
        st["tokens_per_s"] = tokens / step_s
    if job["model"] == "mixtral":
        flops = moe_llama.flops_per_token(
            trainer.model_cfg, cfg.dataset.seq_len) * tokens
        st["mfu_active_experts"] = mfu.mfu(flops, step_s, 1)
        st["aux_loss"] = [round(m["aux_loss"], 6) for m in log]
    if label in ("m3 resnet", "m4 vit", "m6 mixtral"):
        st["profile"] = step_profile(trainer, state,
                                     trainer.to_device(batch))
    return st


# -- (e) engine at full 8B width, (f) engine shapes, (g) server --------------


def warm(engine, label) -> float:
    """engine.warmup(), timed; prints the decode menu it captured."""
    t = time.monotonic()
    engine.warmup()
    torch.cuda.synchronize()
    sec = time.monotonic() - t
    g = engine.graph_stats()
    print(f"{label}: warmup {sec:.2f} s, {g['captures']} decode graphs "
          f"captured, graph pool {g['pool_bytes'] / 1e6:.1f} MB; keys "
          f"{g['keys']}", flush=True)
    # a stage-sharded engine holds one graph a (span, sample): its chunks
    # replay it
    graphs = (len({key[1:] for key in g["keys"]})
              if isinstance(engine, StageShardedEngine) else len(g["keys"]))
    check(g["captures"] == graphs > 0,
          f"{label}: warmup captured no decode graph")
    return sec


def run_batch(engine, prompts, max_new, kws=None, on_step=None,
              cancel_row=None):
    """Submit a burst at once (per-request keywords `kws`) and step the
    engine until idle; cancel row `cancel_row` once it has E3_CANCEL_AT
    tokens (with a chunk in flight under pipelining). Returns each row's
    tokens, finish reason, logprobs, top logprobs and TTFT, and the run's
    stats: TTFT mean and max, and decode tokens/s from the moment every
    request has its first token."""
    t0 = time.monotonic()
    kws = kws or [{}] * len(prompts)
    rids = [engine.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    t_first = None
    cancel_in_flight = None
    while engine.step():
        if on_step is not None:
            on_step()
        if cancel_row is not None and cancel_in_flight is None:
            r = rids[cancel_row]
            if (len(engine.partial_result(r)) >= E3_CANCEL_AT
                    and (engine._pending is not None
                         or not engine.pipeline_decode)):
                cancel_in_flight = engine._pending is not None
                check(engine.cancel(r), "cancel of a running request "
                                        "returned False")
        if t_first is None and all(engine.ttft_seconds(r) is not None
                                   for r in rids):
            torch.cuda.synchronize()
            t_first = time.monotonic()
    torch.cuda.synchronize()
    t_end = time.monotonic()
    rows = [dict(tokens=engine.result(r), reason=engine.finish_reason(r),
                 cached=engine.cached_tokens(r),
                 logprobs=engine.result_logprobs(r),
                 top=(engine.result_top_logprobs(r) if engine.logprobs_topk
                      else None),
                 ttft=engine.ttft_seconds(r)) for r in rids]
    for r in rids:
        engine.release(r)
    ttft = [row["ttft"] for row in rows]
    n = sum(len(row["tokens"]) for row in rows)
    stats = dict(ttft_mean_s=sum(ttft) / len(ttft), ttft_max_s=max(ttft),
                 decode_tok_s=(n - len(prompts)) / (t_end - t_first),
                 wall_s=t_end - t0)
    if cancel_row is not None:
        stats.update(tokens=n, cancel_with_chunk_in_flight=cancel_in_flight)
    return rows, stats


def tokens_of(rows):
    return [row["tokens"] for row in rows]


class IdTokenizer:
    """Text in as UTF-8 bytes, ids out as decimal text: random weights
    have no vocabulary, so the completion text shows the ids."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def engine_phase(seed: int):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    t = time.monotonic()
    params = llama.init(cfg, seed=seed, device=DEV, quantize="int8")
    engine = LLMEngine(params, cfg, n_slots=8, max_len=2048,
                       buckets=(128, 512, 1024), decode_chunk=8,
                       kv_quantize="int8", device=DEV)
    torch.cuda.synchronize()
    print(f"engine: Llama-3-8B, {cfg.n_layers} layers, int8 weights + int8 "
          f"KV, 8 slots x 2048; init {time.monotonic() - t:.2f} s; "
          f"resident {torch.cuda.memory_allocated() / 1e9:.3f} GB",
          flush=True)
    warmup_s = warm(engine, "engine")
    gen = torch.Generator().manual_seed(seed)
    plens = (30, 75, 130, 260, 400, 600, 800, 1000)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    captures = engine.graph_stats()["captures"]
    first, stats1 = run_batch(engine, prompts, 32)
    first = tokens_of(first)
    launches = {name: _build.LAUNCHES[name] for name in SERVING_KERNELS}
    shapes = {name: dict(_build.SHAPES[name]) for name in SERVING_KERNELS}
    second, stats2 = run_batch(engine, prompts, 32)
    second = tokens_of(second)
    check(engine.graph_stats()["captures"] == captures,
          "engine: a decode graph was captured in live traffic")
    print(f"engine run 1 (after a {warmup_s:.2f} s warmup): "
          f"{json.dumps(stats1)}", flush=True)
    print(f"engine run 2: {json.dumps(stats2)}", flush=True)
    print(f"engine launches in run 1: {json.dumps(launches)}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    check(all(len(t) == 32 for t in first), "engine: wrong token counts")
    check(all(0 <= x < cfg.vocab_size for t in first for x in t),
          "engine: token outside the vocabulary")
    check(first == second, "engine: the same prompts gave other tokens")
    for name, n in launches.items():
        check(n > 0, f"engine: kernel {name} was never launched")
    print("engine: determinism ok (two runs, identical tokens)", flush=True)
    return engine, launches, shapes, prompts, first


# the oversubscribed pool of (e2): the burst's requests need 1, 1, 2, 3,
# 4, 5, 7 and 9 blocks of 128 tokens (prompt + 32 new tokens), 32 in all
PAGED_SMALL_POOL = 24


def paged_engine_phase(engine, prompts, want):
    """(e2): PagedLLMEngine over the slab engine's weights and settings,
    the same burst, with the default pool and with PAGED_SMALL_POOL
    blocks. Returns the kernels' launches and shapes of the default-pool
    run, the paged engine with the default pool, and each run's stats."""
    runs = {}
    for label, pool_blocks in (("default pool", None),
                               ("small pool", PAGED_SMALL_POOL)):
        paged = PagedLLMEngine(engine.params, engine.cfg, n_slots=8,
                               max_len=2048, buckets=(128, 512, 1024),
                               decode_chunk=8, kv_quantize="int8",
                               pool_blocks=pool_blocks, device=DEV)
        warm(paged, f"paged engine ({label})")
        seen = {"held": 0, "used": 0}

        def note(paged=paged, seen=seen):
            m = paged.metrics()
            seen["held"] = max(seen["held"], m["held_prefills"])
            seen["used"] = max(seen["used"], m["kv_pool"]["used_blocks"])

        _build.reset_launches()
        toks, stats = run_batch(paged, prompts, 32, on_step=note)
        toks = tokens_of(toks)
        launches = {name: _build.LAUNCHES[name] for name in _build.KERNELS}
        shapes = {name: dict(_build.SHAPES[name]) for name in PAGED_KERNELS}
        pool = paged.metrics()["kv_pool"]
        stats.update(held_prefills_max=seen["held"],
                     pool_peak_used_blocks=seen["used"],
                     pool_blocks=pool["pool_blocks"],
                     alloc_failures=pool["alloc_failures"])
        print(f"paged engine ({label}): {json.dumps(stats)}; launches "
              f"{json.dumps(launches)}", flush=True)
        for i, (got, ref) in enumerate(zip(toks, want)):
            step = next((j for j, (a, b) in enumerate(zip(got, ref))
                         if a != b), min(len(got), len(ref)))
            check(got == ref, f"paged engine ({label}): request {i} "
                              f"differs from the slab engine's tokens "
                              f"first at step {step}")
        for name in PAGED_KERNELS:
            check(launches[name] > 0,
                  f"paged engine ({label}): {name} was never launched")
        check(launches["flash_decode"] == 0,
              f"paged engine ({label}): the slab K2 was launched")
        check(pool["free_blocks"] == pool["pool_blocks"],
              f"paged engine ({label}): blocks still held after the burst")
        if pool_blocks is not None:
            check(seen["held"] > 0,
                  f"paged engine ({label}): no prefill was held")
        runs[label] = (paged, launches, shapes, stats)
    print("paged engine: greedy tokens equal the slab engine's in both "
          "runs", flush=True)
    paged, launches, shapes, _ = runs["default pool"]
    del runs["small pool"]
    return launches, shapes, paged


# (e3): the flagship ISVC engine (examples/llama-8b-serving-isvc.yaml
# without the prefix cache, speculation and streaming) and its burst: 14
# prompts of 30..1000 tokens and two chunked ones (1500: 1024 + a 476
# tail in bucket 512; 1900: 1024 + an 876 tail in bucket 1024)
FLAGSHIP = dict(n_slots=16, max_len=2048, buckets=(128, 512, 1024),
                decode_chunk=8, kv_quantize="int8", logprobs_topk=5)
E3_PLENS = (30, 60, 90, 130, 200, 260, 330, 400, 480, 560, 640, 720, 850,
            1000, 1500, 1900)
E3_NEW = 48
E3_SEEDED = (1, 5, 9, 13, 15)              # temperature 0.7, top_p 0.9
E3_PENALIZED = {2: dict(presence_penalty=0.6),
                6: dict(frequency_penalty=0.8)}
E3_STOP = (3, 10)                          # greedy rows given a stop
E3_CANCEL = 7                              # greedy, cancelled mid-decode
E3_CANCEL_AT = 8                           # ... once it has this many tokens
E3_POOL_BLOCKS = 128


def e3_kwargs(stops=None) -> list[dict]:
    kws = []
    for i in range(len(E3_PLENS)):
        kw = dict(E3_PENALIZED.get(i, {}))
        if i in E3_SEEDED:
            kw.update(temperature=0.7, top_p=0.9, seed=1000 + i)
        if stops and i in stops:
            kw["stop"] = [stops[i]]
        kws.append(kw)
    return kws


def stop_cut(tokens, stop):
    """The result a stop sequence leaves of `tokens`: cut before the first
    place where the output so far ends with it."""
    for j in range(len(stop), len(tokens) + 1):
        if tokens[j - len(stop):j] == stop:
            return tokens[:j - len(stop)]
    return None


def graph_equals_eager(engine, seed, kd=None, label="e3") -> None:
    """One chunk (8 steps, span 2048, both variants; with kd, 8 verify
    rounds of kd drafts) from equal state: the replay of its captured
    graph bit for bit the eager body, in the output rows, the slot state
    (the token history too) and the KV cache."""
    n, v = engine.n_slots, engine.cfg.vocab_size
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(100, 1900, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
    tokens = torch.randint(0, v, (n,), generator=gen, device=DEV)
    samp = torch.zeros(n, 6, device=DEV)
    samp[:, 5] = -1
    samp[1::4, 0], samp[1::4, 2], samp[1::4, 5] = 0.7, 0.9, 77
    samp[2::4, 0], samp[2::4, 1] = 1.0, 20
    samp[3::4, 3], samp[3::4, 4] = 0.6, 0.3
    cnt = torch.randint(0, 2, (n, v), generator=gen, device=DEV,
                        dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    active[n // 2] = False
    kv = {k: t.clone() for k, t in engine.cache.items()}
    for sample in (True, False):
        outs = []
        for run in ("graph", "eager"):
            engine.lengths.copy_(lengths)
            engine.last_tokens.copy_(tokens)
            engine.samp.copy_(samp)
            engine._cnt.copy_(cnt)
            engine._draws.fill_(5)
            for k, t in kv.items():
                engine.cache[k].copy_(t)
            engine._active_dev.copy_(active)
            if run == "graph":
                replays = engine.graph_stats()["replays"]
                out = (engine._decode_chunk(8, 2048, active, sample)
                       if kd is None else
                       engine._spec_chunk(8, 2048, kd, active, sample))
                out = out.clone()
                check(engine.graph_stats()["replays"] == replays + 1,
                      f"{label}: the chunk was not a graph replay")
            else:
                out = (engine._decode_body(8, 2048, sample) if kd is None
                       else engine._spec_body(8, 2048, kd, sample))
            outs.append([out, *(t.clone() for t in engine._chunk_state()),
                         *(engine.cache[k].clone() for k in kv)])
        same = [torch.equal(a, b) for a, b in zip(*outs)]
        check(all(same), f"{label}: graph replay differs from the eager "
                         f"body (sample={sample}): {same}")
    del kv, outs
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    engine._cnt.zero_()
    engine._samp_host[:] = engine._samp_reset()
    engine.samp.copy_(torch.from_numpy(engine._samp_host))
    engine._active_host = None
    print(f"{label}: one chunk's graph replay is bit for bit the eager body "
          "(rows, slot state, KV cache; sampled and greedy variants)",
          flush=True)


def flagship_phase(engine, seed: int, during=None):
    """(e3): the flagship engine at full Llama-3-8B width over (e)'s int8
    weights: a slab LLMEngine and a PagedLLMEngine (128 blocks), warmed
    up, serve the E3 burst of greedy, seeded-sampled, penalized, stopped
    and cancelled rows; see the module docstring for what it holds.
    `during(slab)`, if given, runs on the warm slab engine between its
    runs and its graph check ((r) and (r2) in a full run). Returns the K3
    shapes of the slab runs (the chunked continuation among them) and
    each kernel's launches."""
    cfg = engine.cfg
    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in E3_PLENS]
    slab = LLMEngine(engine.params, cfg, device=DEV, **FLAGSHIP)
    warmup_s = warm(slab, "e3 slab")
    pool_mb = slab.graph_stats()["pool_bytes"] / 1e6
    captures = slab.graph_stats()["captures"]
    replays = slab.graph_stats()["replays"]
    _build.reset_launches()
    runs = {}
    runs["A"] = run_batch(slab, prompts, E3_NEW, e3_kwargs(),
                          cancel_row=E3_CANCEL)
    stops = {i: runs["A"][0][i]["tokens"][j:j + n]
             for i, j, n in ((E3_STOP[0], 10, 2), (E3_STOP[1], 6, 3))}
    kws = e3_kwargs(stops)
    runs["B"] = run_batch(slab, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    slab.pipeline_decode = False
    runs["C"] = run_batch(slab, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    slab.pipeline_decode = True
    launches = dict(_build.LAUNCHES)
    k3_shapes = dict(_build.SHAPES["flash_prefill"])
    check(slab.graph_stats()["captures"] == captures,
          "e3: a decode graph was captured after warmup")
    slab_replays = slab.graph_stats()["replays"] - replays
    if during is not None:
        during(slab)
    graph_equals_eager(slab, seed)
    del slab
    gc.collect()
    paged = PagedLLMEngine(engine.params, cfg, device=DEV,
                           pool_blocks=E3_POOL_BLOCKS, **FLAGSHIP)
    warm(paged, "e3 paged")
    captures = paged.graph_stats()["captures"]
    _build.reset_launches()
    runs["D"] = run_batch(paged, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    check(paged.graph_stats()["captures"] == captures,
          "e3 paged: a decode graph was captured after warmup")
    p_launches = dict(_build.LAUNCHES)
    pool = paged.metrics()["kv_pool"]
    check(pool["free_blocks"] == pool["pool_blocks"],
          "e3 paged: blocks still held after the burst")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    for label, (_, stats) in runs.items():
        print(f"e3 run {label}: {json.dumps(stats)}", flush=True)
    a, b, c, d = (runs[k][0] for k in "ABCD")
    for i in range(len(E3_PLENS)):
        if i == E3_CANCEL:
            toks = [x[i]["tokens"] for x in (a, b, c, d)]
            longest = max(toks, key=len)
            check(all(t == longest[:len(t)] and len(t) >= E3_CANCEL_AT
                      and x[i]["reason"] == "cancelled"
                      for t, x in zip(toks, (a, b, c, d))),
                  f"e3: cancelled row {i}: {[len(t) for t in toks]} tokens")
            continue
        want = b[i]["tokens"]
        check(c[i]["tokens"] == want, f"e3: row {i} differs between "
                                      "pipelined and unpipelined decode")
        check(d[i]["tokens"] == want, f"e3: row {i} differs between the "
                                      "slab and the paged engine")
        if i in stops:
            check(want == stop_cut(a[i]["tokens"], stops[i])
                  and b[i]["reason"] == "stop",
                  f"e3: stop row {i} was not cut as its stop sequence says")
        else:
            check(a[i]["tokens"] == want and len(want) == E3_NEW,
                  f"e3: row {i} differs between two runs")
    for x in (a, b, c, d):
        for i, row in enumerate(x):
            lps = row["logprobs"]
            check(len(lps) == len(row["tokens"]) == len(row["top"])
                  and all(math.isfinite(lp) and lp <= 0 for lp in lps),
                  f"e3: row {i}: bad logprobs")
            if i in E3_SEEDED or i in E3_PENALIZED:
                continue
            for tok, lp, top in zip(row["tokens"], lps, row["top"]):
                check(len(top) == 5 and max(top, key=top.get) == tok
                      and top[tok] == lp,
                      f"e3: greedy row {i}: logprob {lp} of {tok} is not "
                      f"the top-1 alternative's ({top})")
    check(any(a[i]["tokens"] != c[i]["tokens"] for i in E3_STOP),
          "e3: no stop sequence cut a row")
    check(slab_replays > 0, "e3: no decode graph was replayed")
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"e3: {name} never launched")
    check(p_launches["flash_decode_paged"] > 0
          and p_launches["flash_decode"] == 0,
          "e3 paged: K2-paged not launched, or K2-slab launched")
    check(any(dict(key)["q_offset"] == 1024 for key in k3_shapes),
          "e3: K3 never ran a chunked continuation at q_offset 1024")
    stats = runs["B"][1]
    print(f"e3 flagship: warmup {warmup_s:.2f} s, graph pool {pool_mb:.1f} "
          f"MB, {slab_replays} graph replays in three slab runs; TTFT mean "
          f"{stats['ttft_mean_s']:.4f} s max {stats['ttft_max_s']:.4f} s "
          f"(chunked rows {[row['ttft'] for row in b[-2:]]}); decode "
          f"{stats['decode_tok_s']:.1f} tok/s; launches {json.dumps(launches)}"
          f"; paged {json.dumps(p_launches)}", flush=True)
    print("e3: tokens equal pipelined/unpipelined and slab/paged, seeded "
          "rows reproduce, stop rows cut, the cancelled row stopped, greedy "
          "logprobs are the top-1's", flush=True)
    return k3_shapes, launches


def engine_shape_phase(gen, shapes) -> dict[str, dict]:
    """(f): every kernel against its plain version at each argument shape
    the engine run launched it at. Returns the attention kernels' entries
    for the kernels line: the shape launched most often, and of those the
    one with the most work."""
    best: dict[str, tuple] = {}
    for name, by_shape in shapes.items():
        for key, n in sorted(by_shape.items(), key=str):
            a = dict(key)
            desc = " ".join(f"{k}={v}" for k, v in key)
            if name == "quant_matmul":
                c = k1_case(gen, a["m"], a["d"], a["o"], a["out_dtype"])
                work = 0        # its kernels-line entry is the decode step
            elif name == "flash_decode":
                c = k2_case(gen, a["s_v"], a["t"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=a["hd"],
                            slot_stride=a["slot_stride"])
                work = a["b"] * a["s_v"] * a["t"]
            elif name == "flash_decode_paged":
                span = a["nb"] * a["bt"]
                c = k2_paged_case(gen, a["s_v"], span, a["bt"], a["int8"],
                                  b=a["b"], nh=a["nh"], nkv=a["nkv"],
                                  hd=a["hd"], n_pool=a["n_pool"])
                work = a["b"] * a["s_v"] * span
            else:
                c = k3_case(gen, a["s"], a["q_offset"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=a["hd"], t=a["t"],
                            slot_stride=a["slot_stride"])
                work = a["b"] * a["s"] * a["t"]
            print(f"engine shape {name} {desc} launches={n}: {fmt(c)}",
                  flush=True)
            if work and (n, work) > best.get(name, ((0, 0),))[0]:
                best[name] = ((n, work), dict(
                    c, shape=f"one launch at the engine's {desc}"))
    return {name: entry for name, (_, entry) in best.items()}


def continuation_shape_phase(gen, shapes, label="e3") -> None:
    """K3 against its plain version, with its times, at each continuation
    shape (q_offset > 0) the runs of phase `label` launched it at."""
    seen = 0
    for key, n in sorted(shapes.items(), key=str):
        a = dict(key)
        if a["q_offset"] == 0:
            continue
        c = k3_case(gen, a["s"], a["q_offset"], a["int8"], b=a["b"],
                    nh=a["nh"], nkv=a["nkv"], hd=a["hd"], t=a["t"],
                    slot_stride=a["slot_stride"])
        desc = " ".join(f"{k}={v}" for k, v in key)
        print(f"{label} shape flash_prefill {desc} launches={n}: "
              f"{fmt(c)}", flush=True)
        seen += 1
    check(seen > 0, f"{label}: no continuation shape recorded")


# (e4): the prefix cache on the flagship engines (the ISVC's settings with
# prefix_cache: true and the default store, 4 x 1024 / 128 = 32 blocks of
# 128 tokens). A 512-token system prompt with a 40-token question banks
# the prompt's four blocks; a burst of 16 shares it, with suffixes of
# 30..900 tokens: the 14 prompts of at most 1024 tokens are hits that run
# as continuation waves at q_offset 512, one per tail bucket (5 rows in
# bucket 128, 9 in bucket 512), and the two longer ones take the chunked
# chain from the cached head; four sessions send a second turn (the first
# prompt, its 48 tokens and 60 more), which reuses the first prompt's
# whole block-aligned chain (896, 896, 1152 and 1408 tokens); then three
# cold long prompts. The burst needs 49 fresh blocks beside the 4 cached
# ones, so a pool of 56 funds it at once; at the pressure step the trie
# holds its 32 blocks and the three prompts need 45, so the small pool's
# valve must evict, after the last reuse, and every engine's tokens stay
# comparable bit for bit.
E4_SYSTEM = 512
E4_QUESTION = 40
E4_SUFFIXES = (30, 50, 70, 90, 110, 140, 170, 200, 240, 280, 320, 380, 440,
               500, 700, 900)
E4_SESSIONS = (12, 13, 14, 15)
E4_TURN = 60
E4_PRESSURE = (1700, 1800, 1900)
E4_NEW = 48
E4_SMALL_POOL = 56
# hit against cold, per hit row's first token: each token in both top-5
# lists within E4_LP_TOL nats, and each row's top-1 in the other's top-5.
# The int8 round moves a K/V element by at most half a step, 1/254 of its
# row's largest value (about two bf16 rounds); the lm_head of this
# random-weight model spreads the logits with a standard deviation near 1
# (unit-RMS hidden states over N(0, 1/d_model) columns), and the top-5
# logits of a 128k vocabulary lie about 0.1 apart, so a prefix error that
# moved them by a tenth of their spread would reorder the lists; a
# different prompt gives other lists altogether (printed as the control).
E4_LP_TOL = 0.1


def e4_prompts(cfg, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed + 4)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    system = rand(E4_SYSTEM)
    return {"sys": system + rand(E4_QUESTION),
            "burst": [system + rand(n) for n in E4_SUFFIXES],
            "turn_tails": [rand(E4_TURN) for _ in E4_SESSIONS],
            "pressure": [rand(n) for n in E4_PRESSURE]}


def e4_turns(prompts, burst_rows) -> list:
    """Each session's second turn: its first prompt, that prompt's output
    and E4_TURN new tokens."""
    return [prompts["burst"][i] + burst_rows[i]["tokens"] + tail
            for i, tail in zip(E4_SESSIONS, prompts["turn_tails"])]


def bank_check(engine) -> None:
    """Every running slot's banked prefix: on a slab engine the trie's
    blocks (int8 rows and f32 scales) byte-equal to the slot's rows they
    were banked from, the hits' prefix rows included (written from the
    store); on a paged engine the slot's table naming the trie's blocks."""
    bt = engine.prefix_block_tokens
    seen = 0
    for slot in range(engine.n_slots):
        prompt = engine._prompts.get(engine.scheduler.slot_request(slot))
        if prompt is None:
            continue
        aligned = len(prompt) // bt * bt
        m = engine.kvcache.match(prompt, max_tokens=aligned, namespace=0)
        try:
            check(m.tokens == aligned, f"e4: slot {slot}: {m.tokens} of "
                                       f"{aligned} prompt tokens banked")
            if isinstance(engine, PagedLLMEngine):
                check([int(b) for b in engine._tbl_host[slot, :m.n_blocks]]
                      == [int(b) for b in m.payloads],
                      f"e4 paged: slot {slot}'s table is not the trie's "
                      "blocks")
            else:
                # a stage-sharded engine banks a payload a stage
                stages = engine.cache.get("stages")
                for st, cache in enumerate(stages or [engine.cache]):
                    blocks = ([b[st] for b in m.payloads] if stages
                              else m.payloads)
                    for j, name in enumerate(("k", "k_s", "v", "v_s")):
                        stored = torch.cat([b[j] for b in blocks], dim=2)
                        check(stored.dtype == (torch.int8 if j % 2 == 0
                                               else torch.float32)
                              and torch.equal(stored[:, 0], cache[name][
                                  :, slot, :aligned]),
                              f"e4: slot {slot}: stored {name} differs "
                              f"from the slot's rows (stage {st})")
        finally:
            engine.kvcache.release(m)
        seen += 1
    check(seen == len(E4_SUFFIXES), f"e4: {seen} slots checked")


def e4_run(engine, prompts, turns, label):
    """The e4 traffic through `engine`: the system prompt, the burst
    (continuation waves recorded, banked prefixes checked once after its
    prefill), the second turns and the pressure prompts. Returns each
    stage's rows and stats, the waves and the engine's metrics."""
    waves = []
    dispatch = engine._dispatch_prefill_cont_wave

    def recording(p, t, pairs):
        waves.append((p, t, len(pairs)))
        return dispatch(p, t, pairs)

    engine._dispatch_prefill_cont_wave = recording
    checked = []

    def on_burst_step():
        if not checked and engine.kvcache is not None:
            bank_check(engine)
            checked.append(True)

    out = {"sys": run_batch(engine, [prompts["sys"]], E4_NEW),
           "burst": run_batch(engine, prompts["burst"], E4_NEW,
                              on_step=on_burst_step)}
    check(checked or engine.kvcache is None,
          f"e4 {label}: the banked prefixes were not checked")
    if turns is None:
        turns = e4_turns(prompts, out["burst"][0])
    out["turns"] = run_batch(engine, turns, E4_NEW)
    if label != "cold":
        out["pressure"] = run_batch(engine, prompts["pressure"], E4_NEW)
    del engine._dispatch_prefill_cont_wave
    out["waves"] = waves
    out["metrics"] = engine.metrics()
    out["turn_prompts"] = turns
    return out


def e4_tokens(run) -> list:
    return [row["tokens"] for stage in ("sys", "burst", "turns", "pressure")
            for row in run.get(stage, ([],))[0]]


def store_bytes(engine) -> tuple[int, int]:
    """(bytes of the storages behind the trie's payloads, n_blocks x the
    bytes of one block's int8 rows and f32 scales)."""
    storages = {}
    for payload in engine.kvcache.payloads():
        for a in payload:
            st = a.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    cfg, bt = engine.cfg, engine.prefix_block_tokens
    per_block = cfg.n_layers * bt * cfg.n_kv_heads * (2 * cfg.head_dim + 8)
    return sum(storages.values()), engine.kvcache.n_blocks * per_block


def first_token_gap(hit_row, cold_row) -> float | None:
    """Largest first-token logprob gap over the tokens both top-5 lists
    hold, or None when either row's top-1 is missing from the other's
    list."""
    a, b = hit_row["top"][0], cold_row["top"][0]
    if max(a, key=a.get) not in b or max(b, key=b.get) not in a:
        return None
    return max(abs(a[t] - b[t]) for t in a.keys() & b.keys())


def prefix_cache_phase(engine, seed: int):
    """(e4): the prefix cache on the flagship engines over (e)'s weights
    (see E4_* above): a slab LLMEngine run twice (every block evicted
    between, and its freed bytes counted), PagedLLMEngines of 128 and
    E4_SMALL_POOL blocks, each with prefix_cache, and a cold slab engine
    without the cache, run twice; each warmed up. Returns the K3 shapes
    of the first slab run, and what (p) replays: the prompts, the second
    turns, the first slab run and the slab engine's decode step."""
    cfg = engine.cfg
    prompts = e4_prompts(cfg, seed)
    runs, launches, warmup_s = {}, {}, {}
    memo = {}
    for label, kw in (("slab", {}), ("paged", {"pool": E3_POOL_BLOCKS}),
                      ("small", {"pool": E4_SMALL_POOL}), ("cold", {})):
        if "pool" in kw:
            eng = PagedLLMEngine(engine.params, cfg, device=DEV,
                                 pool_blocks=kw["pool"], prefix_cache=True,
                                 **FLAGSHIP)
        else:
            eng = LLMEngine(engine.params, cfg, device=DEV,
                            prefix_cache=label != "cold", **FLAGSHIP)
        warmup_s[label] = warm(eng, f"e4 {label}")
        captures = eng.graph_stats()["captures"]
        turns = memo.get("turns")
        _build.reset_launches()
        runs[label] = e4_run(eng, prompts, turns, label)
        launches[label] = dict(_build.LAUNCHES)
        if label == "slab":
            k3_shapes = dict(_build.SHAPES["flash_prefill"])
            memo["turns"] = runs[label]["turn_prompts"]
            got, want = store_bytes(eng)
            # the allocator's requested bytes (its allocated bytes round
            # a block up when the rest of a cached segment is too small
            # to split off)
            gc.collect()     # so that only the store is freed below
            before = torch.cuda.memory_stats()["requested_bytes.all.current"]
            n = eng.kvcache.n_blocks
            check(eng.kvcache.evict(10**9) == n, "e4: blocks left pinned")
            freed = (before - torch.cuda.memory_stats()[
                "requested_bytes.all.current"])
            memo["store"] = (n, got, want, freed)
            print(f"e4 slab store: {n} blocks, {got} bytes in their own "
                  f"storages, n_blocks x block bytes {want}, freed by "
                  f"evicting all {freed}", flush=True)
            check(got == want == freed, "e4: the store's bytes are not "
                                        "n_blocks x block bytes")
            runs["repeat"] = e4_run(eng, prompts, memo["turns"], "repeat")
            memo["step"] = step_wall_ms(eng)
        if label == "cold":
            runs["cold repeat"] = e4_run(eng, prompts, memo["turns"], "cold")
        check(eng.graph_stats()["captures"] == captures,
              f"e4 {label}: a decode graph was captured after warmup")
        if "pool" in kw:
            m = runs[label]["metrics"]
            check(m["kv_pool"]["used_blocks"] == m["prefix_cache"]["blocks"],
                  f"e4 {label}: {m['kv_pool']['used_blocks']} pool blocks "
                  f"used at idle, the trie holds "
                  f"{m['prefix_cache']['blocks']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    slab = runs["slab"]
    for label in ("repeat", "paged", "small"):
        for i, (got, want) in enumerate(zip(e4_tokens(runs[label]),
                                             e4_tokens(slab))):
            check(got == want, f"e4 {label}: row {i} differs from the slab "
                               "engine's tokens")
    check(e4_tokens(runs["cold repeat"]) == e4_tokens(runs["cold"]),
          "e4 cold: a repeated run gave other tokens")
    m = slab["metrics"]
    n_burst, n_turns = len(E4_SUFFIXES), len(E4_SESSIONS)
    check(m["prefix_hits"] == n_burst + n_turns
          and m["prefix_misses"] == 1 + len(E4_PRESSURE),
          f"e4: hits {m['prefix_hits']} misses {m['prefix_misses']}")
    bt = math.gcd(*FLAGSHIP["buckets"])
    cached = [row["cached"] for row in slab["burst"][0]]
    check(cached == [E4_SYSTEM] * n_burst, f"e4: burst cached {cached}")
    turn_cached = [row["cached"] for row in slab["turns"][0]]
    want_turn = [len(prompts["burst"][i]) // bt * bt for i in E4_SESSIONS]
    check(turn_cached == want_turn
          and max(turn_cached) > FLAGSHIP["buckets"][-1],
          f"e4: second turns cached {turn_cached}, want {want_turn}")
    n_wave = sum(len(p) <= FLAGSHIP["buckets"][-1] for p in prompts["burst"])
    groups = {(E4_SYSTEM, min(b for b in FLAGSHIP["buckets"]
                              if b >= len(p) - E4_SYSTEM))
              for p in prompts["burst"] if len(p) <= FLAGSHIP["buckets"][-1]}
    check(sorted((p, t) for p, t, _ in slab["waves"]) == sorted(groups)
          and sum(w for *_, w in slab["waves"]) == n_wave,
          f"e4: continuation waves {slab['waves']}, want one per group "
          f"{sorted(groups)} over {n_wave} rows")
    check(any(dict(k)["q_offset"] == E4_SYSTEM and dict(k)["b"] > 1
              for k in k3_shapes),
          f"e4: K3 never ran at q_offset {E4_SYSTEM} with B > 1")
    small = runs["small"]["metrics"]
    check(small["prefix_cache"]["evicted_blocks"] > 0
          and small["kv_pool"]["alloc_failures"] > 0,
          "e4 small: the eviction valve never fired")
    for label, want_k in (("slab", SERVING_KERNELS),
                          ("paged", PAGED_KERNELS)):
        for name in want_k:
            check(launches[label][name] > 0,
                  f"e4 {label}: {name} never launched")
    # hit against cold
    cold = runs["cold"]
    gaps, ctrl, equal, first, agree = [], 0, 0, 0, []
    hit_rows = slab["burst"][0] + slab["turns"][0]
    cold_rows = cold["burst"][0] + cold["turns"][0]
    for i, (h, c) in enumerate(zip(hit_rows, cold_rows)):
        gap = first_token_gap(h, c)
        check(gap is not None and gap <= E4_LP_TOL,
              f"e4: hit row {i}: first-token logprobs {h['top'][0]} "
              f"against cold {c['top'][0]}")
        gaps.append(gap)
        ctrl += first_token_gap(h, cold_rows[(i + 1) % len(cold_rows)]) \
            is not None
        equal += h["tokens"] == c["tokens"]
        first += h["tokens"][0] == c["tokens"][0]
        agree.append(next((j for j, (a, b) in enumerate(
            zip(h["tokens"], c["tokens"])) if a != b), len(h["tokens"])))
    stats, cstats = runs["repeat"]["burst"][1], runs["cold repeat"][
        "burst"][1]
    print(f"e4: hit vs cold first-token logprobs: largest gap "
          f"{max(gaps):.5f} nats (tol {E4_LP_TOL}), mean "
          f"{sum(gaps) / len(gaps):.5f}; "
          f"rows whose whole output equals the cold engine's: {equal}/"
          f"{len(hit_rows)}, whose first token does: {first}/"
          f"{len(hit_rows)}, tokens equal before the first difference: "
          f"mean {sum(agree) / len(agree):.2f}, min {min(agree)}; control "
          f"(hit row against the next row's cold "
          f"run): {ctrl}/{len(hit_rows)} within the top-5 criterion",
          flush=True)
    n, got, want, freed = memo["store"]
    pc = m["prefix_cache"]
    print(f"e4 prefix cache (second runs): hit burst TTFT mean "
          f"{stats['ttft_mean_s']:.4f} s max {stats['ttft_max_s']:.4f} s; "
          f"cold burst TTFT mean {cstats['ttft_mean_s']:.4f} s max "
          f"{cstats['ttft_max_s']:.4f} s; "
          f"prefill_tokens_computed {pc['prefill_tokens_computed']} against "
          f"prefill_tokens_saved {pc['prefill_tokens_saved']} (cold engine "
          f"computed {cold['metrics']['prefill_tokens_computed']}); warmup "
          f"s {json.dumps({k: round(v, 2) for k, v in warmup_s.items()})}; "
          f"store {n} blocks, {got} bytes; waves {slab['waves']}; small pool "
          f"{json.dumps(small['kv_pool'])}, evicted "
          f"{small['prefix_cache']['evicted_blocks']}; launches "
          f"{json.dumps(launches['slab'])}; paged "
          f"{json.dumps(launches['paged'])}", flush=True)
    for label in ("slab", "repeat", "cold", "cold repeat"):
        print(f"e4 {label} stages: " + json.dumps(
            {k: runs[label][k][1] for k in ("sys", "burst", "turns")}),
            flush=True)
    print("e4: hits counted, cached_tokens as banked, one continuation "
          "wave per (p, t), tokens equal slab/paged/small pool/repeat, "
          "store bytes as reckoned, the valve fired, hits within tolerance "
          "of cold", flush=True)
    return k3_shapes, {"prompts": prompts, "turns": memo["turns"],
                       "slab": slab, "step": memo["step"]}


# (p): stage-sharded serving at full width. StageShardedEngine over (e)'s
# Llama-3-8B int8 weights at the flagship settings with the prefix cache
# (the default store, 32 logical blocks), P_STAGES stages: layer slabs of
# 11, 11 and 10 layers and decode microbatches of 6, 5 and 5 slots, all
# on the one card (virtual staging). (p.1) replays (e4)'s traffic with
# the sync schedule and (p.2) with the overlapped one, each on an engine
# of its own, warmed up: every token, logprob and top-5 logprob, the
# cached tokens and the continuation waves equal (e4)'s first slab run
# bit for bit. (p.3) arms stage_timing on the sync engine for one decode
# burst of P_TIMING_NEW tokens: the measured bubble beside the
# schedule's (S-1)/(M+S-1), and each stage's K1, K2 and K3 launches.
# (p.k) holds K2 over a stage's window of slot rows to its plain version.
P_STAGES = 3
P_TIMING_NEW = 16
# K2's window: slot rows [6, 11) of the 16-slot slab, microbatch 1
P_K2_WINDOW = (6, 5)
P_K2_SPAN = 1024
# the decode-step wall: every slot at this length, the largest chunk
# replayed this many times
P_STEP_FILL = 1024
P_STEP_ITERS = 10


def step_wall_ms(engine) -> dict:
    """One decode step's wall on a warm idle engine: every slot active at
    length fill, the engine's largest chunk replayed (greedy) iters
    times after an untimed run, the card synchronized after each. Returns
    the median ms a step and the serving kernels' launches a step; resets
    the slot state (the junk KV rows are dead, as the profiler leaves
    them). fill = P_STEP_FILL, iters = P_STEP_ITERS."""
    fill, iters = P_STEP_FILL, P_STEP_ITERS
    steps = engine.decode_chunk
    span = engine._pick_span(fill + steps * (iters + 1))
    active = torch.ones(engine.n_slots, dtype=torch.bool, device=DEV)
    engine.lengths.fill_(fill)
    engine.last_tokens.fill_(1)
    engine._decode_chunk(steps, span, active, sample=False)
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        engine._decode_chunk(steps, span, active, sample=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3 / steps)
    launches = {n: _build.LAUNCHES[n] / (iters * steps)
                for n in SERVING_KERNELS}
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    engine._host_lengths[:] = 0
    engine._active_host = None
    if hasattr(engine, "pipeline_perf"):
        engine.pipeline_perf(reset=True)
    return {"ms": float(np.median(times)), "span": span, "steps": steps,
            "launches": launches}


def p_rows(run) -> list:
    """Every row of an (e4) traffic run as its tokens, logprobs, top-5
    logprobs and cached tokens."""
    return [(row["tokens"], row["logprobs"], row["top"], row["cached"])
            for stage in ("sys", "burst", "turns", "pressure")
            for row in run[stage][0]]


def p_timed_burst(eng, prompts) -> dict:
    """(p.3): one burst through the sync engine with stage_timing armed:
    its decode runs eagerly, each stage program bracketed; each stage's
    K1/K2 launches (its decode programs) and K3 launches (its prefill
    and continuation programs) counted apart. Returns the pipeline
    accounting and the per-stage launches."""
    per_stage = [dict.fromkeys(SERVING_KERNELS, 0) for _ in eng.params]

    def counted(s, fn, *a, **kw):
        before = dict(_build.LAUNCHES)
        out = fn(*a, **kw)
        for n in SERVING_KERNELS:
            per_stage[s][n] += _build.LAUNCHES[n] - before[n]
        return out

    def stage_of(layers):
        return next(s for s, slab in enumerate(eng.params)
                    if slab["layers"] is layers)

    decode = eng._stage_decode
    inner = {n: getattr(llama, n)
             for n in ("prefill_inner", "prefill_continue_inner")}
    eng._stage_decode = lambda s, *a: counted(s, decode, s, *a)
    for n, fn in inner.items():
        setattr(llama, n, lambda layers, *a, fn=fn, **kw: counted(
            stage_of(layers), fn, layers, *a, **kw))
    eng.stage_timing = True
    eng.pipeline_perf(reset=True)
    try:
        rows, stats = run_batch(eng, prompts, P_TIMING_NEW)
        pp = eng.pipeline_perf(reset=True)
    finally:
        eng.stage_timing = False
        del eng._stage_decode
        for n, fn in inner.items():
            setattr(llama, n, fn)
    check(all(len(r["tokens"]) == P_TIMING_NEW for r in rows),
          "p.3: wrong token counts")
    return {"pipeline": pp, "per_stage": per_stage, "stats": stats}


def stage_phase(engine, seed: int, e4: dict, gen) -> dict:
    """(p): see P_* above. Returns K2's slot-window case with its
    launches in (p.1)."""
    cfg = engine.cfg
    prompts, turns, ref = e4["prompts"], e4["turns"], e4["slab"]
    want = p_rows(ref)
    S = P_STAGES
    # at 8B: layer slabs of 11, 11 and 10, microbatches of 6, 5 and 5
    bounds = stage_bounds(cfg.n_layers, S)
    mbs = microbatch_ranges(FLAGSHIP["n_slots"], S)
    M = len(mbs)
    summary, steps, p_k2_launches = {}, {"e4 single": e4["step"]}, 0
    single_bytes = engine.mesh_info()["params_bytes"]
    for schedule in ("sync", "overlapped"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = StageShardedEngine(engine.params, cfg, device=DEV, stage=S,
                                 stage_schedule=schedule, prefix_cache=True,
                                 **FLAGSHIP)
        added = torch.cuda.memory_allocated() - before
        kv_bytes = sum(t.nbytes for c in eng.cache["stages"]
                       for t in c.values())
        info = eng.mesh_info()
        check(info["stage_layers"] == [hi - lo for lo, hi in bounds]
              and info["microbatches"] == [list(r) for r in mbs]
              and info["virtual_stages"],
              f"p: geometry {json.dumps(info)}")
        check(info["params_bytes"] == single_bytes,
              f"p: slabs hold {info['params_bytes']} bytes, the model "
              f"{single_bytes}")
        check(all(eng.params[s]["layers"]["wq"]["q"].untyped_storage()
                  .data_ptr() == engine.params["layers"]["wq"]["q"]
                  .untyped_storage().data_ptr() for s in range(S)),
              "p: a stage's slab is not a view of the stacked weights")
        # the engine adds its KV slabs and slot state (the penalty counts,
        # 16 x 128256 int32, and smaller), never a copy of the weights
        check(added - kv_bytes < 64e6,
              f"p: the engine added {added} bytes, its KV slabs "
              f"{kv_bytes}")
        warm_s = warm(eng, f"p {schedule}")
        g = eng.graph_stats()
        _build.reset_launches()
        run = e4_run(eng, prompts, turns, f"p {schedule}")
        launches = dict(_build.LAUNCHES)
        if schedule == "sync":
            p_k2_launches = sum(n for key, n in
                                _build.SHAPES["flash_decode"].items()
                                if dict(key)["b"] == P_K2_WINDOW[1])
        check(eng.graph_stats()["captures"] == g["captures"],
              f"p {schedule}: a decode graph was captured after warmup")
        got = p_rows(run)
        for i, (a, b) in enumerate(zip(got, want)):
            if a[0] != b[0]:
                j = next(j for j, (x, y) in enumerate(zip(a[0], b[0]))
                         if x != y)
                check(False, f"p {schedule}: row {i}'s tokens first differ "
                             f"from (e4)'s at {j}: {a[0][j]} != {b[0][j]}")
            check(a == b, f"p {schedule}: row {i}'s logprobs, top-5 or "
                          "cached tokens differ from (e4)'s")
        check(len(got) == len(want), "p: row count")
        check(run["waves"] == ref["waves"],
              f"p {schedule}: waves {run['waves']} != {ref['waves']}")
        for n in SERVING_KERNELS:
            check(launches[n] > 0, f"p {schedule}: {n} never launched")
        step = step_wall_ms(eng)
        steps[schedule] = step
        per_step = step["launches"]
        # each microbatch through every layer's 7 matmuls and its
        # attention, then the lm_head (at 8B: 225 x 3 and 32 x 3)
        check(per_step == {"quant_matmul": (7 * cfg.n_layers + 1) * M,
                           "flash_decode": cfg.n_layers * M,
                           "flash_prefill": 0},
              f"p {schedule}: launches a decode step {per_step}")
        summary[schedule] = dict(
            warmup_s=round(warm_s, 2), captures=g["captures"],
            pool_mb=round(g["pool_bytes"] / 1e6, 1),
            added_gb=round(added / 1e9, 3), kv_gb=round(kv_bytes / 1e9, 3),
            peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
            run_launches=launches)
        if schedule == "sync":
            timed = p_timed_burst(eng, prompts["burst"])
            pp = timed["pipeline"]
            check(pp["steps"] > 0 and pp["bubble_frac"] is not None
                  and pp["schedule_bubble_frac"] == round((S - 1) / (
                      M + S - 1), 4),
                  f"p.3: pipeline accounting {json.dumps(pp)}")
            for s, counts in enumerate(timed["per_stage"]):
                for n in SERVING_KERNELS:
                    check(counts[n] > 0,
                          f"p.3: stage {s} never launched {n}: {counts}")
            print(f"p.3 stage_timing burst ({len(prompts['burst'])} x "
                  f"{P_TIMING_NEW} tokens, eager): measured bubble_frac "
                  f"{pp['bubble_frac']} beside schedule_bubble_frac "
                  f"{pp['schedule_bubble_frac']}; {json.dumps(pp)}; "
                  f"per-stage launches {json.dumps(timed['per_stage'])}",
                  flush=True)
            print(f"p mesh_info: {json.dumps(info)}", flush=True)
        eng.close()
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"p: {json.dumps(summary)}", flush=True)
    print("p decode step wall (16 slots at length "
          f"{P_STEP_FILL}, chunk of {e4['step']['steps']}, ms a step): "
          + json.dumps({k: round(v["ms"], 4) for k, v in steps.items()}),
          flush=True)
    print("p: (e4)'s tokens, logprobs and top-5 bit for bit under both "
          "schedules, K1/K2/K3 launched on every stage, no capture after "
          "warmup", flush=True)
    start, b = P_K2_WINDOW
    c = k2_case(gen, 1, P_K2_SPAN, True, b=b,
                slot_stride=FLAGSHIP["max_len"] * 8 * 128,
                window=(start, FLAGSHIP["n_slots"]))
    c["launches"] = p_k2_launches
    c["shape"] = (f"B={b} at slot_start {start} of a "
                  f"{FLAGSHIP['n_slots']}-slot slab, S_v=1 span "
                  f"{P_K2_SPAN} int8 (p.k; launches: (p.1)'s K2 launches "
                  f"at B={b}, the 5-slot microbatches)")
    print(f"p.k K2 slot window: {fmt(c)}", flush=True)
    return c


# (e5): speculation on the flagship engines: the ISVC's whole engine config
# (examples/llama-8b-serving-isvc.yaml: FLAGSHIP with prefix_cache and
# `speculative: 6`, spec_ngram 3, the adaptive draft length) over (e)'s
# weights. The traffic is (e3)'s burst of 16 rows (the same prompts,
# sampling, stop and cancel rows), then a burst of E5_COPY copy-heavy
# prompts: a random passage of E5_PASSAGE tokens quoted twice around a
# short question, where prompt-lookup drafting has text to find. Each
# burst fits the 16 slots, so every engine prefills it in the same waves.
# A slab and a 128-block paged engine with speculation and the same slab
# engine without it, each warmed up, serve it; the slab engines twice,
# every cached block evicted between, so each run is cold.
E5_SPEC = dict(prefix_cache=True, speculative=6, spec_ngram=3,
               spec_adaptive=True)
E5_COPY = 4
E5_PASSAGE = 300
# A greedy row with speculation against the same engine without it: equal,
# or first different where the plain run's top two logprobs lie less than
# E5_GAP nats apart. A verify round computes a row's logits in products of
# 16 (kd + 1) rows where a decode step has 16; K1 sums each output in the
# same order at every row count, so only a near-tie could flip.
E5_GAP = 2 ** -5


def e5_prompts(cfg, seed: int) -> tuple[list, list]:
    """(e3)'s prompts, and the copy-heavy ones."""
    gen = torch.Generator().manual_seed(seed + 3)
    e3 = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
          for n in E3_PLENS]
    gen = torch.Generator().manual_seed(seed + 5)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    copy = []
    for i in range(E5_COPY):
        passage = rand(E5_PASSAGE)
        copy.append(rand(8) + passage + rand(12 + i) + passage)
    return e3, copy


def fresh_estimates(engine) -> None:
    """A speculative engine back to a new engine's acceptance estimates:
    the tokens-per-round EMA sizes the chunks, and so decides which
    queued requests share a prefill wave, whose batched GEMMs round each
    row differently, and the draft lengths decide the verify rounds'
    shapes; a repeat then takes the first run's schedule."""
    if engine.spec:
        engine._spec_round_ema = None
        engine._spec_adapt.ema[:] = engine.spec


def e5_run(engine, prompts, kws, label):
    """One cold run of the two bursts ((e3)'s with its cancel row, then
    the copy rows), then every cached block evicted; returns the rows of
    both, each burst's stats and the metrics. A speculative engine starts
    from a new engine's acceptance estimates (fresh_estimates)."""
    fresh_estimates(engine)
    captures = engine.graph_stats()["captures"]
    e3, copy = prompts
    rows, stats = run_batch(engine, e3, E3_NEW, kws, cancel_row=E3_CANCEL)
    copy_rows, copy_stats = run_batch(engine, copy, E3_NEW)
    rows += copy_rows
    stats = {"e3 burst": stats, "copy burst": copy_stats}
    metrics = engine.metrics()
    check(engine.graph_stats()["captures"] == captures,
          f"e5 {label}: a decode graph was captured after warmup")
    for i, row in enumerate(rows):
        check(len(row["logprobs"]) == len(row["tokens"]) == len(row["top"])
              and all(math.isfinite(lp) and lp <= 0
                      for lp in row["logprobs"])
              and all(math.isfinite(v) for top in row["top"]
                      for v in top.values()),
              f"e5 {label}: row {i}: bad logprobs")
    engine.kvcache.evict(10**9)
    return rows, stats, metrics


def first_diff(a, b) -> int | None:
    """The first position where token lists a and b differ (the shorter
    one's end when one is the other's prefix), or None when equal."""
    if a == b:
        return None
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def spec_phase(engine, seed: int):
    """(e5): see E5_* above; returns the launch shapes of the
    speculative slab and paged runs."""
    cfg = engine.cfg
    prompts = e5_prompts(cfg, seed)
    runs, warmup_s, pool_mb, launches, shapes = {}, {}, {}, {}, {}
    kws = None
    for label, spec, pool in (("plain", False, None), ("slab", True, None),
                              ("paged", True, E3_POOL_BLOCKS)):
        kw = dict(FLAGSHIP, **(E5_SPEC if spec else
                               dict(E5_SPEC, speculative=None)))
        eng = (PagedLLMEngine(engine.params, cfg, device=DEV,
                              pool_blocks=pool, **kw) if pool
               else LLMEngine(engine.params, cfg, device=DEV, **kw))
        warmup_s[label] = warm(eng, f"e5 {label}")
        pool_mb[label] = eng.graph_stats()["pool_bytes"] / 1e6
        if kws is None:   # the plain run without stops sets them
            runs["plain free"] = e5_run(eng, prompts, e3_kwargs(),
                                        "plain")
            free = runs["plain free"][0]
            stops = {i: free[i]["tokens"][j:j + n]
                     for i, j, n in ((E3_STOP[0], 10, 2),
                                     (E3_STOP[1], 6, 3))}
            kws = e3_kwargs(stops)
        _build.reset_launches()
        eng.perf_counters(reset=True)
        runs[label] = e5_run(eng, prompts, kws, label)
        launches[label] = dict(_build.LAUNCHES)
        shapes[label] = {k: dict(v) for k, v in _build.SHAPES.items()}
        rounds = eng.perf_counters()["decode_steps"]
        if label != "paged":
            runs[f"{label} repeat"] = e5_run(eng, prompts, kws, label)
        if label == "slab":
            graph_equals_eager(eng, seed, kd=E5_SPEC["speculative"],
                               label="e5")
        if spec:
            m = runs[label][2]
            check(m["spec_verify_rounds"] > 0 and rounds > 0,
                  f"e5 {label}: no verify round")
            verify_k1 = {key: n for key, n in
                         shapes[label]["quant_matmul"].items()
                         if dict(key)["m"] in K1_VERIFY_M}
            by_m = {}
            for key, n in verify_k1.items():
                by_m[dict(key)["m"]] = by_m.get(dict(key)["m"], 0) + n
            print(f"e5 {label}: {rounds} verify rounds on the card; K1 "
                  f"launches at verify rows {json.dumps(by_m)}, "
                  f"{sum(by_m.values()) / rounds:.2f} a round", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    slab = runs["slab"][0]
    for label in ("slab repeat", "paged"):
        for i, (got, want) in enumerate(zip(runs[label][0], slab)):
            if i == E3_CANCEL:
                continue
            check(got["tokens"] == want["tokens"],
                  f"e5 {label}: row {i} differs from the slab engine's")
    cancelled = [runs[k][0][E3_CANCEL] for k in ("slab", "slab repeat",
                                                 "paged")]
    longest = max((r["tokens"] for r in cancelled), key=len)
    check(all(r["reason"] == "cancelled" and len(r["tokens"]) >= E3_CANCEL_AT
              and r["tokens"] == longest[:len(r["tokens"])]
              for r in cancelled), "e5: the cancelled row")
    # against speculation off
    free = runs["plain free"][0]
    plain = runs["plain"][0]
    diffs, greedy = [], 0
    for i, row in enumerate(slab):
        if i in E3_SEEDED or i in E3_PENALIZED or i == E3_CANCEL:
            continue
        greedy += 1
        ref = free[i]["tokens"]
        if i in E3_STOP:
            stop = kws[i]["stop"][0]
            ref = stop_cut(ref, stop)
            check(plain[i]["tokens"] == ref and plain[i]["reason"] == "stop",
                  f"e5 plain: stop row {i} was not cut")
        j = first_diff(row["tokens"], ref)
        if j is None:
            continue
        top = sorted(free[i]["top"][j].values(), reverse=True)
        gap = top[0] - top[1]
        diffs.append((i, j, gap))
        print(f"e5: greedy row {i} first differs from the plain run at "
              f"token {j}: top-2 gap {gap:.5f} nats there", flush=True)
        check(gap < E5_GAP, f"e5: greedy row {i} differs from the plain "
                            f"run at token {j}, where its top-2 gap is "
                            f"{gap:.5f} >= {E5_GAP}")
    for label, want_k in (("slab", SERVING_KERNELS),
                          ("paged", PAGED_KERNELS)):
        for name in want_k:
            check(launches[label][name] > 0,
                  f"e5 {label}: {name} never launched")
    check(any(dict(k)["s_v"] > 1 for k in shapes["slab"]["flash_decode"])
          and any(dict(k)["s_v"] > 1
                  for k in shapes["paged"]["flash_decode_paged"]),
          "e5: K2 never ran a verify round")
    check(launches["paged"]["flash_decode"] == 0,
          "e5 paged: K2-slab launched")
    m = runs["slab repeat"][2]
    stats = runs["slab repeat"][1]["e3 burst"]
    pstats = runs["plain"][1]["e3 burst"]
    spec_keys = {k: v for k, v in m.items() if k.startswith("spec_")}
    print(f"e5 speculation (second slab run): {json.dumps(spec_keys)}; "
          f"(e3)'s burst: decode {stats['decode_tok_s']:.1f} tok/s, TTFT "
          f"mean {stats['ttft_mean_s']:.4f} s max {stats['ttft_max_s']:.4f} "
          "s; "
          f"without speculation (plain engine, stops set): decode "
          f"{pstats['decode_tok_s']:.1f} tok/s, TTFT mean "
          f"{pstats['ttft_mean_s']:.4f} s max {pstats['ttft_max_s']:.4f} s; "
          f"copy rows' tokens per row "
          f"{[len(r['tokens']) for r in slab[-E5_COPY:]]}; greedy rows "
          f"differing from the plain run {len(diffs)}/{greedy} "
          f"{json.dumps(diffs)}; warmup s "
          f"{json.dumps({k: round(v, 2) for k, v in warmup_s.items()})}; "
          "graph pool MB "
          f"{json.dumps({k: round(v, 1) for k, v in pool_mb.items()})}",
          flush=True)
    for label in ("slab", "slab repeat", "paged", "plain", "plain free"):
        print(f"e5 {label} run: {json.dumps(runs[label][1])}", flush=True)
    print(f"e5 launches: slab {json.dumps(launches['slab'])}; paged "
          f"{json.dumps(launches['paged'])}", flush=True)
    print("e5: no capture after warmup, tokens equal slab/paged/repeat, "
          "greedy rows equal the plain engine's or differ first at a "
          "near-tie, logprobs finite", flush=True)
    return shapes


def verify_shape_phase(gen, shapes) -> dict:
    """K2 and K2-paged against their plain versions, with their times, at
    each verify S_v the (e5) runs launched them at (the span launched most
    often for each); returns each one's kernels-line entry at the verify
    shape launched most often, with its launches in (e5)."""
    out = {}
    for label, name in (("slab", "flash_decode"),
                        ("paged", "flash_decode_paged")):
        best_by_sv: dict[int, tuple] = {}
        for key, n in shapes[label][name].items():
            a = dict(key)
            if a["s_v"] > 1 and n > best_by_sv.get(a["s_v"], (0,))[0]:
                best_by_sv[a["s_v"]] = (n, key)
        best = None
        for s_v, (n, key) in sorted(best_by_sv.items()):
            a = dict(key)
            desc = " ".join(f"{k}={v}" for k, v in key)
            if name == "flash_decode":
                c = k2_case(gen, s_v, a["t"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=a["hd"],
                            slot_stride=a["slot_stride"])
            else:   # a pool that holds ragged lengths up to the span
                desc += " (timed over 1.5 b nb + 1 pool blocks)"
                c = k2_paged_case(gen, s_v, a["nb"] * a["bt"], a["bt"],
                                  a["int8"], b=a["b"], nh=a["nh"],
                                  nkv=a["nkv"], hd=a["hd"])
            print(f"e5 shape {name} {desc} launches={n}: {fmt(c)}",
                  flush=True)
            if best is None or n > best[0]:
                best = (n, dict(c, launches=n, shape=(
                    f"one verify launch at the (e5) engine's {desc}")))
        check(best is not None, f"e5: no verify shape of {name}")
        out[name] = best[1]
    return out


# (e6): the dataplane. The ISVC's config as written in
# examples/llama-8b-serving-isvc.yaml:28-45 (a test holds the two equal);
# the phase adds device, and a 1 s SSE keepalive so the crash's outage
# shows keepalives, and points compile_cache into the temp directory (the
# run writes nothing outside its checkout and its TMPDIR)
E6_ISVC = {"quantize": "int8", "kv_quantize": "int8", "n_slots": 16,
           "max_len": 2048, "buckets": [128, 512, 1024], "decode_chunk": 8,
           "pipeline_decode": True, "prefix_cache": True, "speculative": 6,
           "logprobs_topk": 5, "compile_cache": "/var/cache/ktpu-xla",
           "timeout_s": 120}
# the config.json fields of the published meta-llama/Meta-Llama-3-8B
E6_HF_CONFIG = {"architectures": ["LlamaForCausalLM"],
                "model_type": "llama", "vocab_size": 128256,
                "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "max_position_embeddings": 8192,
                "rope_theta": 500000.0, "rms_norm_eps": 1e-05,
                "hidden_act": "silu", "tie_word_embeddings": False,
                "bos_token_id": 128000, "eos_token_id": 128001,
                "torch_dtype": "bfloat16"}
E6_SHARDS = 4
E6_KEEPALIVE_S = 1.0
E6_CRASH_AT = 8          # crash once every stream has this many tokens
E6_DISCONNECT_AT = 4     # the disconnecting client leaves after these


def clear_cublas_workspaces() -> None:
    """Free the cuBLAS workspaces (torch keeps one per thread and stream
    that ran a GEMM, in its allocator): what an unload leaves is then the
    model's own."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def hf_tensors(cfg) -> list[tuple[str, tuple, int]]:
    """(name, HF shape [out, in], fan_in) of every tensor of a Llama
    checkpoint, in the published files' order; norms have fan_in 0."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    out = [("model.embed_tokens.weight", (cfg.vocab_size, d), d)]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (d,), 0),
                (p + "self_attn.q_proj.weight", (d, d), d),
                (p + "self_attn.k_proj.weight", (kv, d), d),
                (p + "self_attn.v_proj.weight", (kv, d), d),
                (p + "self_attn.o_proj.weight", (d, d), d),
                (p + "post_attention_layernorm.weight", (d,), 0),
                (p + "mlp.gate_proj.weight", (f, d), d),
                (p + "mlp.up_proj.weight", (f, d), d),
                (p + "mlp.down_proj.weight", (d, f), f)]
    return out + [("model.norm.weight", (d,), 0),
                  ("lm_head.weight", (cfg.vocab_size, d), d)]


def write_hf_checkpoint(path, cfg, hf_config, seed, keep=()) -> dict:
    """chip_smoke's own safetensors writer: a Llama checkpoint of random
    bf16 weights (normal / sqrt(fan_in), unit norms) from `seed`, made on
    the card tensor by tensor, in E6_SHARDS files plus the index. Returns
    the tensors named in `keep` (on the card) and the bytes written."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    tensors = hf_tensors(cfg)
    per = -(-len(tensors) // E6_SHARDS)
    weight_map, kept, total = {}, {}, 0
    for s in range(E6_SHARDS):
        part = tensors[s * per:(s + 1) * per]
        fname = f"model-{s + 1:05d}-of-{E6_SHARDS:05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for name, shape, _ in part:
            n = math.prod(shape) * 2
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(os.path.join(path, fname), "wb") as fh:
            fh.write(len(head).to_bytes(8, "little") + head)
            for name, shape, fan_in in part:
                t = (torch.randn(shape, generator=gen, device=DEV)
                     / fan_in ** 0.5 if fan_in
                     else torch.ones(shape, device=DEV)).to(torch.bfloat16)
                if name in keep:
                    kept[name] = t
                fh.write(t.view(torch.uint8).cpu().numpy())
        total += 8 + len(head) + off
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {"total_size": total - 8 * E6_SHARDS},
                   "weight_map": weight_map}, fh)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf_config, fh)
    return {"kept": kept, "bytes": total}


class SSEStream:
    """chip_smoke's own SSE reader: one streaming completion on a thread
    of its own, recording the token ids, the first data event's instant,
    keepalive comments, [DONE] lines, errors and the finish; with
    `leave_after` it closes the connection once that many tokens came."""

    def __init__(self, port, body, path="/openai/v1/completions",
                 leave_after=None, on_token=None):
        self.port, self.body, self.path = port, dict(body, stream=True), path
        self.leave_after, self.on_token = leave_after, on_token
        self.tokens, self.lps, self.token_t = [], [], []
        self.keepalives = self.done = 0
        self.errors, self.finish, self.usage, self.text = [], None, None, ""
        self.status = self.t_first = self.t_send = self.t_end = None
        self.headers = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        resp = None
        try:
            self.t_send = time.monotonic()
            conn.request("POST", self.path, json.dumps(self.body).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            self.status = resp.status
            self.headers.set()
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b":"):
                    self.keepalives += 1
                    continue
                if not line.startswith(b"data: "):
                    continue
                data = line[6:].strip()
                if self.t_first is None:
                    self.t_first = time.monotonic()
                if data == b"[DONE]":
                    self.done += 1
                    continue
                chunk = json.loads(data)
                if "error" in chunk:
                    self.errors.append(chunk["error"])
                    continue
                self.usage = chunk.get("usage") or self.usage
                for ch in chunk["choices"]:
                    if ch.get("token_id") is not None:
                        self.tokens.append(ch["token_id"])
                        self.lps.append(ch.get("logprob"))
                        self.token_t.append(time.monotonic())
                        if self.on_token is not None:
                            self.on_token()
                    self.text += (ch.get("text")
                                  or (ch.get("delta") or {}).get("content")
                                  or "")
                    self.finish = ch.get("finish_reason") or self.finish
                if (self.leave_after is not None
                        and len(self.tokens) >= self.leave_after):
                    break
        finally:
            self.t_end = time.monotonic()
            self.headers.set()
            if resp is not None:
                resp.close()   # with Connection: close it owns the socket
            conn.close()


class EngineGate:
    """Holds a supervised model's engine loop between steps, so a burst
    is submitted whole, in a fixed order, before the engine takes any of
    it: the waves and the slot order are then the same in every run."""

    def __init__(self, sup):
        self.sup, self._step = sup, sup.step
        self.is_open, self.parked = threading.Event(), threading.Event()
        sup.step = self._gated

    def _gated(self):
        if not self.is_open.is_set():
            self.parked.set()
            self.is_open.wait()
            self.parked.clear()
        return self._step()

    def close(self):
        """Returns once the engine loop waits at the gate."""
        self.is_open.clear()
        check(self.parked.wait(timeout=120), "e6: the engine loop did not "
                                              "reach the gate")

    def remove(self):
        del self.sup.step
        self.is_open.set()


def e6_submit(model, start_one, n):
    """Start n requests in order, each once the previous was accepted."""
    sup = model.supervisor
    out = []
    for i in range(n):
        before = sup.accounting()["accepted"]
        out.append(start_one(i))
        t = time.monotonic()
        while sup.accounting()["accepted"] == before:
            check(time.monotonic() - t < 60, f"e6: request {i} never "
                                              "accepted")
            time.sleep(0.0005)
    return out


def e6_reset(model, gate):
    """Between runs: park the engine, evict the prefix store, and start
    speculation from a new engine's estimates (see e5_run)."""
    gate.close()
    eng = model.engine
    eng.kvcache.evict(10**9)
    eng._spec_round_ema = None
    eng._spec_adapt.ema[:] = eng.spec


def e6_bodies(prompts, kws, **extra):
    bodies = []
    for p, kw in zip(prompts, kws):
        body = {"model": "llama3-8b", "prompt": p, "max_tokens": E3_NEW,
                **extra}
        body.update({k: v for k, v in kw.items()
                     if k in ("temperature", "top_p", "seed",
                              "presence_penalty", "frequency_penalty")})
        bodies.append(body)
    return bodies


def e6_stream_run(model, gate, server, bodies, crash=None):
    """The burst as concurrent SSE streams, submitted in order behind the
    gate (with `crash`, a CrashOnce watching them); returns the streams
    and the client-side stats from the gate's opening: TTFT (the first
    data event) mean, p50 and max, and decode tokens/s once every stream
    had its first token."""
    on_token = crash.on_token if crash is not None else None
    streams = e6_submit(model, lambda i: SSEStream(
        server.port, bodies[i], on_token=on_token).start(), len(bodies))
    if crash is not None:
        crash.streams = streams
    t_open = time.monotonic()
    gate.is_open.set()
    for st in streams:
        st.thread.join(timeout=600)
        check(not st.thread.is_alive(), "e6: a stream did not end")
    ttft = sorted(st.t_first - t_open for st in streams)
    t_all = max(st.token_t[0] for st in streams)
    t_end = max(st.token_t[-1] for st in streams)
    n = sum(len(st.tokens) for st in streams)
    return streams, {"ttft_mean_s": sum(ttft) / len(ttft),
                     "ttft_p50_s": ttft[len(ttft) // 2],
                     "ttft_max_s": ttft[-1],
                     "decode_tok_s": (n - len(streams)) / (t_end - t_all),
                     "tokens": n}


def post_json(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def ttft_count(url) -> int:
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    m = re.search(r'^serving_ttft_seconds_count\{component="engine"\} (\d+)$',
                  text, re.M)
    return int(m.group(1)) if m else 0


def dataplane_phase(seed: int, n_layers: int | None = None,
                    root: str | None = None) -> str:
    """(e6): see the module docstring. `n_layers` cuts the depth (the
    temp directory's free disk decides it when None). Returns the HF
    directory it wrote; with `root` (the caller's temp directory, which
    the caller removes) it is kept there for (l), else removed."""
    clear_cublas_workspaces()
    mem0 = torch.cuda.memory_allocated()
    hf_config = dict(E6_HF_CONFIG)
    keep_dir = root is not None
    root = root or tempfile.mkdtemp(prefix="chip-smoke-e6-")
    try:
        free = shutil.disk_usage(root).free
        full = llama.LlamaConfig.llama3_8b()
        per_layer = sum(math.prod(s) * 2 for n, s, _ in hf_tensors(
            dataclasses.replace(full, n_layers=1)) if ".layers." in n)
        fixed = 2 * full.vocab_size * full.d_model * 2
        if n_layers is None:
            n_layers = min(full.n_layers,
                           int((free - (2 << 30) - fixed) // per_layer))
        check(n_layers >= 1, f"e6: {free / 1e9:.1f} GB free in {root}")
        hf_config["num_hidden_layers"] = n_layers
        cfg = dataclasses.replace(full, n_layers=n_layers)
        print(f"e6: {free / 1e9:.2f} GB free in the temp directory; "
              f"Llama-3-8B width at {n_layers} of 32 layers "
              f"({(fixed + n_layers * per_layer) / 1e9:.2f} GB of bf16)",
              flush=True)
        ckpt = os.path.join(root, "llama-3-8b")
        os.makedirs(ckpt)
        keep = ("model.embed_tokens.weight", "model.norm.weight",
                "model.layers.0.self_attn.q_proj.weight",
                f"model.layers.{n_layers - 1}.mlp.down_proj.weight",
                "lm_head.weight")
        t = time.monotonic()
        written = write_hf_checkpoint(ckpt, cfg, hf_config, seed + 6, keep)
        write_s = time.monotonic() - t
        print(f"e6: wrote {written['bytes'] / 1e9:.3f} GB in {E6_SHARDS} "
              f"shards + index in {write_s:.2f} s", flush=True)
        dataplane_serve(ckpt, cfg, written, seed, root, mem0)
        return ckpt
    finally:
        if not keep_dir:
            shutil.rmtree(root, ignore_errors=True)


class CrashOnce:
    """A duck-typed fault injector: one `backend_crash`, due at the first
    supervised step after it is armed."""

    def __init__(self, model):
        self.model, self.streams, self.fired_at = model, [], None
        self._lock = threading.Lock()
        self._armed = False

    def on_token(self):
        """Arms the crash once every stream has E6_CRASH_AT tokens."""
        with self._lock:
            if self._armed or not self.streams or any(
                    len(st.tokens) < E6_CRASH_AT for st in self.streams):
                return
            self._armed = True
        self.model.supervisor.arm_faults(self)

    def start(self):
        pass

    def due_one_shots(self, kind):
        if kind != "backend_crash" or self.fired_at is not None:
            return []
        self.fired_at = time.monotonic()
        return [kind]

    def active(self, kind):
        return None

    def clear(self, event):
        pass


def dataplane_serve(ckpt, cfg, written, seed, root, mem0):
    """(e6) from the written checkpoint on: load, the bit check, the
    streamed and buffered bursts, chat and a disconnect, the crash, and
    the unload."""
    old_root = _build.BUILD_ROOT
    cache_dir = os.path.join(root, "compile-cache")
    isvc = dict(E6_ISVC, compile_cache=cache_dir,
                sse_keepalive_s=E6_KEEPALIVE_S, device=DEV)
    t = time.monotonic()
    model = LLMModel("llama3-8b", ckpt, **isvc)
    model.load()
    torch.cuda.synchronize()
    load_s = time.monotonic() - t
    kept = written.pop("kept")
    resident = (torch.cuda.memory_allocated() - mem0
                - sum(x.nbytes for x in kept.values()))
    ls = model.load_stats
    g = model.engine.graph_stats()
    libs = os.listdir(os.path.join(cache_dir, _build._source_hash()))
    check(sorted(libs) == sorted(f"lib{n}.so" for n in _build.SOURCES),
          f"e6: compile_cache holds {libs}")
    print(f"e6 load: LLMModel.load {load_s:.2f} s: load_hf "
          f"{ls['seconds']:.2f} s for {ls['bytes'] / 1e9:.3f} GB "
          f"({ls['bytes'] / 1e9 / ls['seconds']:.2f} GB/s, int8 as it "
          f"lands), engine build + warmup {load_s - ls['seconds']:.2f} s "
          f"({g['captures']} graphs); resident {resident / 1e9:.3f} GB; "
          f"graph pool {g['pool_bytes'] / 1e6:.1f} MB; compile_cache "
          f"{len(libs)} libraries", flush=True)
    p = model.engine.params
    L = cfg.n_layers

    def same(got, want, what):
        check(torch.equal(got, want), f"e6: loaded {what} differs from "
                                      "the written tensor")

    same(p["embed"], kept["model.embed_tokens.weight"].float(), "embed")
    same(p["final_norm"], kept["model.norm.weight"].float(), "final_norm")
    for name, leaf, i in (("model.layers.0.self_attn.q_proj.weight", "wq",
                           0),
                          (f"model.layers.{L - 1}.mlp.down_proj.weight",
                           "w_down", L - 1)):
        want = quant.quantize_int8(kept[name].t().float())
        same(p["layers"][leaf]["q"][i], want["q"], f"{leaf}[{i}].q")
        same(p["layers"][leaf]["s"][i], want["s"], f"{leaf}[{i}].s")
    want = quant.quantize_int8(kept["lm_head.weight"].t().float())
    same(p["lm_head"]["q"], want["q"], "lm_head.q")
    same(p["lm_head"]["s"], want["s"], "lm_head.s")
    del kept, want, p
    print("e6: embed, final_norm, wq[0], w_down[-1] and lm_head bit for "
          "bit the written tensors (int8 leaves as quantize_int8 of them)",
          flush=True)

    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in E3_PLENS]
    kws = e3_kwargs()
    bodies = e6_bodies(prompts, kws)
    server = CompletionServer(model).start()
    sup = model.supervisor
    gate = EngineGate(sup)
    try:
        gate.close()
        ttft0 = ttft_count(server.url)
        captures = model.engine.graph_stats()["captures"]
        _build.reset_launches()
        # A: the burst as SSE streams
        streams, stats = e6_stream_run(model, gate, server, bodies)
        for i, st in enumerate(streams):
            check(st.status == 200 and st.done == 1 and not st.errors
                  and st.finish == "length" and len(st.tokens) == E3_NEW
                  and st.usage["completion_tokens"] == len(st.tokens),
                  f"e6: stream {i}: status {st.status}, {st.done} [DONE], "
                  f"errors {st.errors}, finish {st.finish}, "
                  f"{len(st.tokens)} tokens, usage {st.usage}")
        # B: the same burst buffered, from the same engine state
        e6_reset(model, gate)
        results = [None] * len(bodies)

        def post(i):
            def run():
                results[i] = post_json(
                    server.url + "/openai/v1/completions",
                    dict(bodies[i], logprobs=2))
            th = threading.Thread(target=run, daemon=True)
            th.start()
            return th

        threads = e6_submit(model, post, len(bodies))
        gate.is_open.set()
        for th in threads:
            th.join(timeout=600)
        buffered = [r["choices"][0] for r in results]
        for i, (st, ch) in enumerate(zip(streams, buffered)):
            check(st.tokens == ch["token_ids"],
                  f"e6: row {i}: streamed tokens differ from the buffered "
                  f"ones at {first_diff(st.tokens, ch['token_ids'])}")
        # C: a chat stream beside a client that leaves mid-stream
        e6_reset(model, gate)
        cancelled = sup.accounting()["cancelled"]
        gate.is_open.set()
        chat = SSEStream(server.port, {
            "model": "llama3-8b", "max_tokens": 24,
            "messages": [{"role": "system", "content": "You are terse."},
                         {"role": "user", "content": "Name three rivers."}]},
            path="/openai/v1/chat/completions").start()
        gone = SSEStream(server.port, dict(bodies[0], max_tokens=400),
                         leave_after=E6_DISCONNECT_AT).start()
        for st in (chat, gone):
            st.thread.join(timeout=600)
        t = time.monotonic()
        while sup.accounting()["in_flight"]:
            check(time.monotonic() - t < 60, "e6: the left request never "
                                             "ended")
            time.sleep(0.01)
        acc = sup.accounting()
        check(chat.status == 200 and chat.done == 1 and not chat.errors
              and len(chat.tokens) == 24 and chat.finish == "length",
              f"e6: chat: {chat.status} {chat.done} {chat.errors} "
              f"{len(chat.tokens)} {chat.finish}")
        check(acc["cancelled"] == cancelled + 1 and gone.done == 0
              and len(gone.tokens) >= E6_DISCONNECT_AT,
              f"e6: the disconnected request: cancelled "
              f"{acc['cancelled'] - cancelled}, {len(gone.tokens)} tokens")
        launches = dict(_build.LAUNCHES)
        for name in SERVING_KERNELS:
            check(launches[name] > 0, f"e6: {name} was never launched")
        check(model.engine.graph_stats()["captures"] == captures,
              "e6: a decode graph was captured after warmup")
        # D: the burst again, crashed once every stream has tokens
        e6_reset(model, gate)
        mem_idle = torch.cuda.memory_allocated()
        pool = model.engine.graph_stats()["pool_bytes"]
        crash = CrashOnce(model)
        before = sup.accounting()
        factory, rebuilt = sup._factory, []

        def timed_factory():   # the restart's engine build + warmup
            t0 = time.monotonic()
            eng = factory()
            rebuilt.append(time.monotonic() - t0)
            return eng

        sup._factory = timed_factory
        d_streams, d_stats = e6_stream_run(model, gate, server, bodies,
                                           crash=crash)
        acc = sup.accounting()
        outage = acc["outages"][-1]
        sup._factory = factory
        del factory, timed_factory   # they hold the params
        e6_reset(model, gate)
        mem_after = torch.cuda.memory_allocated()
        check(acc["restarts"] == before["restarts"] + 1
              and crash.fired_at is not None,
              f"e6: restarts {acc['restarts'] - before['restarts']}")
        check(model.engine.graph_stats()["captures"] == captures,
              "e6: the restarted engine captured other graphs")
        diffs = {}
        for i, (st, ref) in enumerate(zip(d_streams, streams)):
            check(st.status == 200 and st.done == 1 and not st.errors
                  and st.keepalives > 0 and len(st.tokens) == E3_NEW,
                  f"e6 crash: stream {i}: {st.status}, {st.done} [DONE], "
                  f"errors {st.errors}, {st.keepalives} keepalives, "
                  f"{len(st.tokens)} tokens")
            j = first_diff(st.tokens, ref.tokens)
            if j is not None:
                top = sorted(buffered[i]["logprobs"]["top_logprobs"][j]
                             .values(), reverse=True)
                diffs[i] = {"at": j, "gap": top[0] - top[1]}
                check(top[0] - top[1] < E5_GAP or i in E3_SEEDED
                      or i in E3_PENALIZED,
                      f"e6 crash: row {i} differs from its uncrashed "
                      f"tokens at {j}, top-2 gap {top[0] - top[1]:.4f}")
        replays = {k: acc[k] - before[k] for k in
                   ("replayed", "replay_verified", "replay_mismatch")}
        check(replays["replay_mismatch"] >= len(diffs)
              and replays["replayed"] == len(bodies),
              f"e6 crash: replays {replays}, rows differing {diffs}")
        check(abs(mem_after - mem_idle) <= pool,
              f"e6 crash: allocated {mem_idle} before, {mem_after} after "
              f"the restart (graph pool {pool})")
        gaps = [b - a for st in d_streams
                for a, b in zip(st.token_t, st.token_t[1:])]
        served = ttft_count(server.url) - ttft0
        n_req = 2 * len(bodies) + 2 + len(bodies)
        check(served == n_req, f"e6: /metrics counts {served} TTFTs for "
                               f"{n_req} requests")
    finally:
        gate.remove()
        server.stop()
        model.unload()
        _build.set_build_root(old_root)
    del model, server, gate, sup
    gc.collect()
    mem_end = torch.cuda.memory_allocated()
    clear_cublas_workspaces()
    mem_clear = torch.cuda.memory_allocated()
    check(mem_clear == mem0,
          f"e6: {mem_clear - mem0} bytes still allocated after unload() "
          "(the cuBLAS workspaces cleared)")
    print(f"e6 burst (SSE, 16 streams, client-side from the gate's "
          f"opening): {json.dumps(stats)}", flush=True)
    print(f"e6: streamed tokens equal the buffered ones (16/16 rows); one "
          f"[DONE] a stream; chat {len(chat.tokens)} tokens; the client "
          f"that left after {len(gone.tokens)} tokens ended cancelled; "
          f"launches {json.dumps(launches)}; no capture after warmup",
          flush=True)
    print(f"e6 crash: outage {outage['mttr_s']:.3f} s (detected to "
          f"replayed, backoff {outage['backoff_s']} s, engine build + "
          f"warmup {rebuilt[0]:.3f} s), the longest "
          f"silence a client saw {max(gaps):.3f} s, keepalives per stream "
          f"{[st.keepalives for st in d_streams]}; replays "
          f"{json.dumps(replays)}; rows differing from the uncrashed run "
          f"{json.dumps(diffs)}; TTFT mean {d_stats['ttft_mean_s']:.4f} s; "
          f"allocated "
          f"{mem_idle / 1e9:.4f} GB before the crash, {mem_after / 1e9:.4f}"
          f" GB after the restart (graph pool {pool / 1e6:.1f} MB); "
          f"after unload() {(mem_end - mem0) / 1e6:+.1f} MB against before "
          f"(e6), {mem_clear - mem0:+d} bytes once the cuBLAS workspaces "
          f"(one a thread) are cleared; /metrics TTFT count +{served}",
          flush=True)


# -- (e7) scenarios: committed traffic through the runner, the supervisor
# and the tenant-fair native scheduler ----------------------------------------

#: the committed traces (e7) replays, with the only overrides it gives
#: (through load_scenario's keywords) and their sha256, which
#: tests/test_torch_loadgen.py pins against the JAX package's traces
E7_TRACES = {
    "steady": ("steady", {},
               "2d3f20c1952fddd2e7b19e2591c60d39"
               "bc26234995496f4b841442b0b64cae0d"),
    "steady_two_tenants": ("steady", {"n_tenants": 2},
                           "8ca0673d417454beea39a3c36d152b3f"
                           "a3a5b481382652f6a35940146d518310"),
    "multi_tenant_lora": ("multi_tenant_lora", {},
                          "4d61174032a28b3cbc00ca5cf49c9347"
                          "01da41e608d89723d8aa9cb92ca351cf"),
}
#: (e7.b)'s flood: t0's and t1's requests, submitted whole before a step,
#: under the multi_tenant_lora caps
E7_FLOOD = (64, 8)
E7_CAPS = (2, 32)
E7_FLOOD_PLEN = (30, 200)
E7_FLOOD_NEW = 16
#: (e7.c): t0 ranks above the shed threshold, t1 (the default) below
E7_SHED = ShedPolicy(priorities=(("t0", 1),))
#: (e7.c)'s restart backoff. The restart's warmup runs inside one step()
#: and so holds the runner's arrivals back; the backoff is the part of the
#: outage in which they meet degraded-mode admission (5 of t1's arrivals
#: in the committed trace fall in the 3 s after the crash instant)
E7_BACKOFF_S = 3.0
#: one replay's wall budget: the 30 s window, a restart and the drain
E7_WALL_S = 300.0
#: (e7.c)'s bound on the top-2 gap at a request's first difference from
#: its uncrashed tokens where its prefill wave had another (bucket, rows)
#: than its uncrashed run's (E5_GAP bounds the same-shape ones). Each
#: such request is also run again in waves of both shapes (e7_witness),
#: which must give both runs' tokens exactly; the bound is the guard
#: against a gross error. The largest such gap seen on an H100 was
#: 0.0753 nats
E7_OTHER_GAP = 0.2


class E7Tap:
    """The supervisor as the runner sees it, keeping each request's tokens
    and top logprobs (by prompt) when the runner releases it, and each
    TenantShed refusal with its tenant, whether the supervisor was
    degraded, and when. `waves` is filled by the engines the factory
    builds (scenario_phase): each prompt's prefill waves as (bucket,
    rows), in order. A fault script the runner arms goes through
    E7HeldCrash (`held`)."""

    def __init__(self, sup):
        self.sup = sup
        self._prompt: dict[int, tuple] = {}
        self.rows: dict[tuple, tuple] = {}
        self.shed: list[tuple] = []
        self.waves: dict[tuple, list] = {}
        self.held = None

    def __getattr__(self, name):
        return getattr(self.sup, name)

    def arm_faults(self, script):
        self.held = E7HeldCrash(FaultInjector(script), self.sup)
        self.sup.arm_faults(self.held)
        return self

    def submit(self, prompt, *a, **kw):
        try:
            rid = self.sup.submit(prompt, *a, **kw)
        except TenantShed:
            self.shed.append((kw.get("tenant"), self.sup.degraded,
                              time.monotonic()))
            raise
        self._prompt[rid] = tuple(prompt)
        return rid

    def release(self, rid):
        self.rows[self._prompt.pop(rid)] = (
            self.sup.result(rid), self.sup.result_top_logprobs(rid))
        self.sup.release(rid)


class E7HeldCrash:
    """(e7.c)'s injector: the script's, but a crash that falls due is held
    until a journaled stream holds delivered tokens, so that the restart
    replays a delivered prefix and verifies it. `delivered` keeps, at the
    crash, each such stream's prompt and tokens."""

    def __init__(self, injector, sup):
        self.injector = injector
        self.sup = sup
        self.delivered: dict[tuple, list] = {}

    def __getattr__(self, name):
        return getattr(self.injector, name)

    def due_one_shots(self, kind, *a, **kw):
        if kind != "backend_crash":
            return self.injector.due_one_shots(kind, *a, **kw)
        streams = {tuple(e.prompt): list(e.tokens)
                   for e in self.sup._journal.values()
                   if not e.terminal and e.tokens}
        if not streams or not self.injector.due_one_shots(kind, *a, **kw):
            return False
        self.delivered = streams
        return True


def pct(xs, q):
    """The q-th percentile of xs (nearest rank), or None when empty."""
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[max(0, math.ceil(q / 100 * len(xs)) - 1)], 3)


def e7_summary(records, aggregate) -> dict:
    """A replay's SLO line: TTFT (from the scheduled arrival) and TPOT
    p50/p99 over its records, attainment, goodput, completed, rejected."""
    ttft = [t for r in records if (t := r.ttft_ms()) is not None]
    tpot = [t for r in records if (t := r.tpot_ms()) is not None]
    return {"requests": aggregate["n_requests"],
            "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
            "tpot_p50_ms": pct(tpot, 50), "tpot_p99_ms": pct(tpot, 99),
            "slo_attainment": aggregate["slo_attainment"],
            "goodput_tok_per_s": aggregate["goodput_tok_per_s"],
            "throughput_tok_per_s": aggregate["throughput_tok_per_s"],
            "completed": aggregate["completed"],
            "rejected": aggregate["rejected"]}


def e7_replay(tap, key, label, **kw):
    """run_scenario of one (e7) trace through the port's runner, the
    prefix store emptied first: the trace's sha256 the pinned one, no
    time-out, K1, K2 and K3 launched, and no capture after warmup (the
    engine that ends the run holds the warmed menu, every key captured
    once). Returns run_scenario's record, the runner's records (its
    summary keeps p50/p95 only) and the trace."""
    name, over, sha = E7_TRACES[key]
    scenario = loadgen.load_scenario(name, **over)
    trace = loadgen.generate_trace(scenario.trace)
    keys = tap.sup.engine.graph_stats()["keys"]
    tap.sup.engine.kvcache.evict(10**9)
    records = []
    run_trace = loadgen.runner.run_trace

    def run_trace_kept(*a, **rkw):
        res = run_trace(*a, **rkw)
        records.extend(res["records"])
        return res

    _build.reset_launches()
    t0 = time.monotonic()
    loadgen.runner.run_trace = run_trace_kept
    try:
        out = loadgen.run_scenario(tap, scenario, max_wall_s=E7_WALL_S, **kw)
    finally:
        loadgen.runner.run_trace = run_trace
    sec = time.monotonic() - t0
    launches = {n: _build.LAUNCHES[n] for n in SERVING_KERNELS}
    g = tap.sup.engine.graph_stats()
    check(out["trace_sha256"] == sha,
          f"{label}: trace sha256 {out['trace_sha256']}, pinned {sha}")
    check(not out["timed_out"], f"{label}: the replay ran out of time")
    check(g["keys"] == keys and g["captures"] == len(keys),
          f"{label}: a decode graph was captured after warmup")
    for n, c in launches.items():
        check(c > 0, f"{label}: kernel {n} was never launched")
    check(len(records) == len(trace.requests),
          f"{label}: {len(records)} records for {len(trace.requests)} "
          "requests")
    print(f"{label} {name} {json.dumps(over)}: trace_sha256 "
          f"{out['trace_sha256']}, {len(trace.requests)} requests, "
          f"{sec:.2f} s; {json.dumps(e7_summary(records, out['aggregate']))}"
          f"; launches {json.dumps(launches)}", flush=True)
    return out, records, trace


def e7_flood(sup, seed: int) -> None:
    """(e7.b)'s flood: E7_FLOOD requests of t0 and t1 submitted whole
    before a step under E7_CAPS; 32 of t0's refused with TenantOverQuota
    and none of t1's, t1's largest queue wait under t0's median (the fair
    pop), every accepted request terminal."""
    gen = torch.Generator().manual_seed(seed + 7)
    n0, n1 = E7_FLOOD
    tenants = ["t0"] * n0 + ["t1"] * n1
    vocab = sup.engine.cfg.vocab_size
    prompts = [torch.randint(1, vocab, (int(n),), generator=gen).tolist()
               for n in torch.randint(*E7_FLOOD_PLEN, (len(tenants),),
                                      generator=gen)]
    before = sup.accounting()
    _build.reset_launches()
    t0 = time.monotonic()
    sup.set_tenant_limits(*E7_CAPS)
    rids, refused = [], {"t0": 0, "t1": 0}
    try:
        for p, t in zip(prompts, tenants):
            try:
                rids.append((t, sup.submit(p, E7_FLOOD_NEW, tenant=t)))
            except TenantOverQuota:
                refused[t] += 1
        sup.run_until_idle()
    finally:
        sup.set_tenant_limits(0, 0)
    sec = time.monotonic() - t0
    waits = {"t0": [], "t1": []}
    for t, rid in rids:
        check(sup.is_done(rid) and len(sup.result(rid)) == E7_FLOOD_NEW,
              f"e7.b flood: request {rid} of {t} did not complete")
        waits[t].append(sup.request_timing(rid)["queue_wait_ms"])
        sup.release(rid)
    acc = sup.accounting()
    check(refused == {"t0": n0 - E7_CAPS[1], "t1": 0},
          f"e7.b flood: refused {refused}")
    check(max(waits["t1"]) < pct(waits["t0"], 50),
          f"e7.b flood: t1's largest queue wait {max(waits['t1'])} ms is "
          f"not under t0's median {pct(waits['t0'], 50)} ms")
    check(acc["lost"] == 0 and acc["in_flight"] == 0
          and acc["completed"] - before["completed"] == len(rids),
          f"e7.b flood: accounting {acc}")
    launches = {n: _build.LAUNCHES[n] for n in SERVING_KERNELS}
    for n, c in launches.items():
        check(c > 0, f"e7.b flood: kernel {n} was never launched")
    print(f"e7.b flood: {n0} t0 + {n1} t1 requests x {E7_FLOOD_NEW} tokens "
          f"under caps {E7_CAPS}, {sec:.2f} s: refused {json.dumps(refused)};"
          f" queue wait ms t1 max {max(waits['t1'])}, t0 p50 "
          f"{pct(waits['t0'], 50)}, t0 max {max(waits['t0'])}; launches "
          f"{json.dumps(launches)}", flush=True)


def e7_diff(toks, ref, top) -> dict | None:
    """Where toks first part from ref (over toks' length) and the top-2
    gap of `top` there, or None when they agree."""
    j = first_diff(toks, ref[:len(toks)])
    if j is None:
        return None
    lp = sorted(top[j].values(), reverse=True)
    return {"at": j, "gap": round(lp[0] - lp[1], 5)}


def e7_crash_check(tap, out, uncrashed, before, label) -> dict:
    """(e7.c)'s holds: one restart, nothing lost, shedding only of t1 and
    only inside the outage; a crash that found streams holding delivered
    tokens, each replayed and verified or counted a mismatch as the
    supervisor counts; each accepted greedy request's tokens, and each
    delivered prefix, its uncrashed ones or first different at a top-2
    gap under E5_GAP where its prefill wave had the uncrashed run's
    (bucket, rows), under E7_OTHER_GAP where it had another shape (a
    prefill wider than K1's 128 rows projects through cuBLAS, whose bf16
    rows depend on the wave's size). Returns the record and the prompts
    e7_witness runs again: every request that differs after a wave of
    another shape, and every mismatched replay."""
    acc = out["chaos"]["accounting"]
    sup = tap.sup
    outage = sup.outages[-1]
    check(acc["restarts"] - before["restarts"] == 1,
          f"{label}: {acc['restarts'] - before['restarts']} restarts")
    check(acc["lost"] == 0 and acc["in_flight"] == 0,
          f"{label}: accounting {acc}")
    shed = acc["shed"] - before["shed"]
    check(shed > 0 and shed == len(tap.shed)
          == out["aggregate"]["rejected"],
          f"{label}: shed {shed}, refusals seen {len(tap.shed)}, rejected "
          f"{out['aggregate']['rejected']}")
    check(all(t == "t1" and down
              and outage["detected_s"] <= at <= outage["recovered_s"]
              for t, down, at in tap.shed),
          f"{label}: shed outside the outage or of t0: {tap.shed}")
    check(out["per_tenant"]["t0"]["rejected"] == 0,
          f"{label}: t0 lost requests: {out['per_tenant']['t0']}")
    ref_rows, ref_waves = uncrashed
    replays = {k: acc[k] - before[k] for k in
               ("replayed", "replay_verified", "replay_mismatch")}
    delivered = tap.held.delivered
    mismatched = [p for p, d in delivered.items()
                  if tap.rows[p][0][:len(d)] != d]
    check(replays["replayed"] == len(delivered) > 0
          and replays["replay_mismatch"] == len(mismatched)
          and replays["replay_verified"] + len(mismatched)
          == len(delivered),
          f"{label}: replays {replays}, streams holding tokens at the "
          f"crash {len(delivered)}, their prefixes regenerated otherwise "
          f"{len(mismatched)}")
    bad, same, other, prefixes = [], [], [], []
    n_same_wave = 0
    for prompt, (toks, top) in tap.rows.items():
        ref = ref_rows[prompt][0]
        wave, ref_wave = tap.waves[prompt][-1], ref_waves[prompt][-1]
        n_same_wave += wave == ref_wave
        d = e7_diff(toks, ref, top)
        if d is None:
            continue
        d.update(wave=wave, uncrashed_wave=ref_wave)
        (same if wave == ref_wave else other).append((d, prompt))
        if d["gap"] >= (E5_GAP if wave == ref_wave else E7_OTHER_GAP):
            bad.append(d)
    for prompt, toks in delivered.items():
        ref, ref_top = ref_rows[prompt]
        wave, ref_wave = tap.waves[prompt][0], ref_waves[prompt][-1]
        d = e7_diff(toks, ref, ref_top)
        if d is None:
            continue
        d.update(delivered=len(toks), wave=wave, uncrashed_wave=ref_wave)
        prefixes.append(d)
        if d["gap"] >= (E5_GAP if wave == ref_wave else E7_OTHER_GAP):
            bad.append(d)
    check(len(tap.rows) > 0, f"{label}: no request compared")
    check(not bad, f"{label}: first differences from the uncrashed tokens "
          f"past their bound (E5_GAP for a wave of the uncrashed shape, "
          f"E7_OTHER_GAP for another): {bad}")
    witness = [p for _, p in other] + [p for p in mismatched
                                       if p not in [q for _, q in other]]
    gaps = [lp[0] - lp[1] for toks, top in tap.rows.values() for t in top
            for lp in [sorted(t.values(), reverse=True)]]
    record = {"restarts": 1, "shed": shed, "compared": len(tap.rows),
              "same_wave_shape": n_same_wave,
              "differing_same_wave": [d for d, _ in same],
              "differing_other_wave": [d for d, _ in other],
              "other_wave_gaps_over_e5_gap": sum(
                  d["gap"] >= E5_GAP for d, _ in other),
              "delivered_prefixes_differing": prefixes,
              "positions_with_gap_under_e7_other_gap": round(
                  sum(g < E7_OTHER_GAP for g in gaps) / len(gaps), 4),
              "mttr_s": outage.get("mttr_s"), "replays": replays}
    return record, witness


def e7_witness_run(eng, waves, prompt, n_new, shape, seed) -> list:
    """`prompt`'s greedy tokens from `eng` with the prompt prefilled in a
    wave of `shape` (bucket, rows): submitted with rows - 1 fillers of its
    length before a step, the prefix store emptied first."""
    bucket, rows = shape
    gen = torch.Generator().manual_seed(seed)
    eng.kvcache.evict(10**9)
    rid = eng.submit(list(prompt), n_new)
    fill = [eng.submit(torch.randint(1, eng.cfg.vocab_size, (len(prompt),),
                                     generator=gen).tolist(), 1)
            for _ in range(rows - 1)]
    eng.run_until_idle()
    got = waves[tuple(prompt)][-1]
    check(got == shape, f"e7.c witness: prefilled in a wave {got}, "
          f"wanted {shape}")
    toks = eng.result(rid)
    for r in (rid, *fill):
        eng.release(r)
    return toks


def e7_witness(eng, tap, uncrashed, prompts, seed) -> list:
    """The wave shape decides a request's tokens: each of `prompts`, run
    again on `eng` in a wave of its (e7.c) shape, gives its (e7.c) tokens,
    and in a wave of its uncrashed shape its uncrashed ones, exactly."""
    ref_rows, ref_waves = uncrashed
    seen = []
    for k, prompt in enumerate(prompts):
        toks, ref = tap.rows[prompt][0], ref_rows[prompt][0]
        shapes = (tap.waves[prompt][-1], ref_waves[prompt][-1])
        for shape, want, what in zip(shapes, (toks, ref),
                                     ("e7.c", "uncrashed")):
            got = e7_witness_run(eng, tap.waves, prompt, len(want), shape,
                                 seed + k)
            check(got == want, f"e7.c witness: in a wave {shape} the "
                  f"tokens first differ from the {what} run's at "
                  f"{first_diff(got, want)}")
        seen.append({"crashed_wave": shapes[0], "uncrashed_wave": shapes[1],
                     "first_diff": first_diff(toks, ref)})
    return seen


def e7_http(engine, seed: int) -> dict:
    """(e7.d): steady's trace through the port's server and its SSE client
    (run_trace_http): every stream 200 with one [DONE] and its tokens;
    client TTFT from the first data event."""
    name, over, sha = E7_TRACES["steady"]
    trace = loadgen.generate_trace(loadgen.load_scenario(name, **over).trace)
    check(loadgen.trace_sha256(trace) == sha, "e7.d: trace sha256")
    t0 = time.monotonic()
    server = CompletionServer.from_config(
        engine.params, engine.cfg,
        dict(FLAGSHIP, buckets=list(FLAGSHIP["buckets"]), prefix_cache=True),
        device=DEV, model="llama3-8b", tokenizer=IdTokenizer()).start()
    load_s = time.monotonic() - t0
    try:
        eng = server.model.engine
        keys = eng.graph_stats()["keys"]
        _build.reset_launches()
        t1 = time.monotonic()
        out = loadgen.run_trace_http(server.port, trace, model="llama3-8b",
                                     max_wall_s=E7_WALL_S, timeout_s=300.0)
        sec = time.monotonic() - t1
        launches = {n: _build.LAUNCHES[n] for n in SERVING_KERNELS}
        g = eng.graph_stats()
        check(g["keys"] == keys and g["captures"] == len(keys),
              "e7.d: a decode graph was captured after warmup")
    finally:
        server.stop()
    check(not out["timed_out"], "e7.d: the replay ran out of time")
    for r in trace.requests:
        st = out["streams"][r.index]
        check(st["status"] == 200 and st["done_count"] == 1
              and st["usage_count"] == 1 and not st["errors"]
              and len(st["token_ids"]) == r.max_new_tokens,
              f"e7.d: stream {r.index}: status {st['status']}, "
              f"{st['done_count']} [DONE], errors {st['errors']}, "
              f"{len(st['token_ids'])}/{r.max_new_tokens} tokens")
    for n, c in launches.items():
        check(c > 0, f"e7.d: kernel {n} was never launched")
    agg = out["summary"]["aggregate"]
    check(agg["completed"] == len(trace.requests), f"e7.d: {agg}")
    ttft = [(st["t_first_token_s"] - st["t_request_s"]) * 1e3
            for st in out["streams"].values()]
    line = dict(e7_summary(out["records"], agg),
                client_ttft_p50_ms=pct(ttft, 50),
                client_ttft_p99_ms=pct(ttft, 99))
    print(f"e7.d run_trace_http steady: trace_sha256 {sha}, "
          f"{len(trace.requests)} SSE streams, one [DONE] each; server "
          f"load {load_s:.2f} s, replay {sec:.2f} s; {json.dumps(line)} "
          f"(client TTFT from the request to the first data event; the "
          f"record's from the scheduled arrival); launches "
          f"{json.dumps(launches)}", flush=True)
    return line


def e7_supervisor(engine, waves, built, adapters=None):
    """An EngineSupervisor (with E7_SHED) whose factory builds a slab
    LLMEngine with the flagship settings and the prefix cache over (e)'s
    weights (and `adapters`), each engine appended to `built` and its
    prefill waves recorded in `waves` by prompt; warmed up."""

    def factory():
        eng = LLMEngine(engine.params, engine.cfg, device=DEV,
                        prefix_cache=True, adapters=adapters, **FLAGSHIP)
        dispatch = eng._dispatch_prefill_wave

        def dispatch_seen(bucket, wave):
            for a in wave:
                waves.setdefault(tuple(eng._prompts[a.req_id]), []).append(
                    (bucket, len(wave)))
            return dispatch(bucket, wave)

        eng._dispatch_prefill_wave = dispatch_seen
        built.append(eng)
        return eng

    t = time.monotonic()
    sup = EngineSupervisor(factory, warm=True, shed_policy=E7_SHED)
    g = sup.engine.graph_stats()
    check(type(sup.engine.scheduler) is NativeScheduler,
          f"e7: the engine's scheduler is {type(sup.engine.scheduler)}")
    check(g["captures"] == len(g["keys"]) > 0, "e7: warmup captured no graph")
    sec = round(time.monotonic() - t, 2)
    print(f"e7: supervised slab engine (flagship + prefix cache"
          + (f" + adapters {sorted(adapters)}" if adapters else "")
          + f"), scheduler {type(sup.engine.scheduler).__name__}, built and "
          f"warmed in {sec} s, {g['captures']} graphs", flush=True)
    return sup, sec


def scenario_phase(engine, seed: int) -> dict:
    """(e7): EngineSupervisors (with E7_SHED) whose factories build slab
    LLMEngines with the flagship settings and the prefix cache over (e)'s
    weights, warmed up. On one without adapters: (e7.a) steady through
    the runner; (e7.c) steady with a second tenant and crash_midstream.
    On one with (e8)'s four adapters a0..a3: (e7.b) multi_tenant_lora
    with its adapters (its caps 2/32) and the flood. Then (e7.d) steady
    through the port's server (no adapters) and SSE client."""
    seconds = {}
    built: list = []
    waves: dict[tuple, list] = {}
    sup, seconds["warmup"] = e7_supervisor(engine, waves, built)
    tap = E7Tap(sup)
    tap.waves = waves
    t = time.monotonic()
    _, _, steady = e7_replay(tap, "steady", "e7.a")
    uncrashed = (dict(tap.rows), {k: list(v) for k, v in waves.items()})
    check(len(uncrashed[0]) == len(steady.requests),
          "e7.a: a request was not released")
    seconds["a"] = round(time.monotonic() - t, 2)
    t = time.monotonic()
    before = sup.accounting()
    tap.rows.clear()
    waves.clear()
    sup.backoff_base_s = sup.backoff_cap_s = E7_BACKOFF_S
    out, _, _ = e7_replay(tap, "steady_two_tenants", "e7.c",
                          fault_script="crash_midstream")
    crash, witness = e7_crash_check(tap, out, uncrashed, before, "e7.c")
    sec_c = time.monotonic() - t
    check(len(built) == 2 and sup.engine is built[1],
          f"e7.c: {len(built)} engines built")
    print(f"e7.c crash_midstream: script sha256 "
          f"{out['chaos']['script_sha256']}, fired (held until a stream "
          f"held tokens) {json.dumps(out['chaos']['events_fired'])}; "
          f"{json.dumps(crash)}", flush=True)
    seen = e7_witness(sup.engine, tap, uncrashed, witness, seed)
    print(f"e7.c witness: {len(seen)} requests run again on the restarted "
          f"engine in waves of their e7.c and uncrashed shapes give those "
          f"runs' tokens exactly, {time.monotonic() - t - sec_c:.2f} s: "
          f"{json.dumps(seen)}", flush=True)
    seconds["c"] = round(time.monotonic() - t, 2)
    sup.close()
    del built[:], tap, sup
    gc.collect()
    torch.cuda.empty_cache()
    sup, seconds["warmup_adapters"] = e7_supervisor(
        engine, waves, built, e8_adapters(engine.cfg, seed))
    tap = E7Tap(sup)
    t = time.monotonic()
    out, records, _ = e7_replay(tap, "multi_tenant_lora", "e7.b")
    agg = out["aggregate"]
    by_adapter: dict[str, dict] = {}
    for r in records:
        c = by_adapter.setdefault(str(r.adapter), {"offered": 0,
                                                   "completed": 0})
        c["offered"] += 1
        c["completed"] += int(r.completed)
    check(set(by_adapter) == {"None", *E8_ADAPTERS},
          f"e7.b: the trace routed to {sorted(by_adapter)}")
    print(f"e7.b per adapter: {json.dumps(by_adapter)}", flush=True)
    print("e7.b per tenant: " + json.dumps(
        {k: {f: v[f] for f in ("offered", "completed", "rejected",
                               "slo_attainment", "ttft_p50_ms",
                               "service_ratio")}
         for k, v in out["per_tenant"].items()})
        + f"; Jain's index {agg['fairness_jain']}, min/max "
        f"{agg['fairness_min_over_max']}", flush=True)
    check(len(out["per_tenant"]) == 6 and agg["completed"]
          + agg["rejected"] == agg["n_requests"],
          f"e7.b: {json.dumps(agg)}")
    e7_flood(sup, seed)
    seconds["b"] = round(time.monotonic() - t, 2)
    sup.close()
    del built[:], tap, sup
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    e7_http(engine, seed)
    seconds["d"] = round(time.monotonic() - t, 2)
    print(f"e7 seconds: {json.dumps(seconds)}", flush=True)
    return seconds


# -- (e8) multi-adapter serving at full 8B width -----------------------------

E8_ADAPTERS = ("a0", "a1", "a2", "a3")
E8_TARGETS = ("wq", "wk", "wv", "wo")
E8_RANK, E8_ALPHA = 8, 16.0
#: b is random and nonzero: LoRA's own init (b = 0) would pass every check
#: below on an engine that ignored the adapters
E8_B_STD = 0.05
#: 14 rows of these lengths (the last one chunked) and two rows of a
#: 512-token system prompt plus a question, under two adapters
E8_PLENS = (30, 60, 90, 130, 200, 260, 330, 400, 480, 560, 640, 720, 850,
            1500)
E8_ROUTES = tuple([None, "a0", "a1", "a2", "a3"][i % 5]
                  for i in range(len(E8_PLENS))) + ("a0", "a2")
E8_SYSTEM = 512
E8_QUESTION = 40
E8_NEW = 48
#: the follow-ups after the burst: the system prompt under a0 (a hit),
#: under a1 (another namespace: a miss) and under the base (a miss)
E8_FOLLOW = ("a0", "a1", None)
E8_STEP_ITERS = 20


def e8_adapters(cfg, seed: int) -> dict:
    """Four rank-8 adapters on wq/wk/wv/wo from --seed: a ~ N(0, 1/d_in),
    b ~ N(0, E8_B_STD^2), alpha 16, on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    shapes = llama.matmul_shapes(cfg)
    L, out = cfg.n_layers, {}
    for name in E8_ADAPTERS:
        tree = {}
        for t in E8_TARGETS:
            d_in, d_out = shapes[t]
            tree[t] = {
                "a": torch.randn((L, d_in, E8_RANK), generator=gen,
                                 device=DEV) / d_in ** 0.5,
                "b": torch.randn((L, E8_RANK, d_out), generator=gen,
                                 device=DEV) * E8_B_STD}
        out[name] = {"lora": tree, "alpha": E8_ALPHA}
    return out


def e8_prompts(cfg, seed: int) -> tuple[list, list]:
    gen = torch.Generator().manual_seed(seed + 80)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    system = rand(E8_SYSTEM)
    burst = [rand(n) for n in E8_PLENS] + [system + rand(E8_QUESTION)
                                           for _ in range(2)]
    follow = [system + rand(E8_QUESTION) for _ in E8_FOLLOW]
    return burst, follow


def e8_kws(routes) -> list[dict]:
    return [{"adapter": a} if a else {} for a in routes]


def e8_step_ms(params, cfg, n_slots: int, adapters) -> float:
    """The graph replay's wall per decode step of an 8-step greedy chunk
    (every slot at position 1000, span 2048) on a fresh engine of
    `n_slots` slots (the flagship's other settings), its slots spread over
    the base and every adapter; the median of E8_STEP_ITERS replays."""
    eng = LLMEngine(params, cfg, device=DEV, adapters=adapters,
                    **dict(FLAGSHIP, n_slots=n_slots))
    active = torch.ones(n_slots, dtype=torch.bool, device=DEV)
    if adapters:
        eng.cache["aids"].copy_(torch.arange(n_slots, device=DEV)
                                % (len(adapters) + 1))
    walls = []
    for i in range(E8_STEP_ITERS + 1):
        eng.lengths.fill_(1000)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._decode_chunk(8, 2048, active, sample=False)
        torch.cuda.synchronize()
        if i:   # the first call captures the graph
            walls.append(time.perf_counter() - t)
    eng.close()
    gc.collect()
    torch.cuda.empty_cache()
    return sorted(walls)[len(walls) // 2] / 8 * 1e3


def multi_adapter_phase(engine, seed: int):
    """(e8): see the module docstring. Returns the K3 shapes of the
    adapter slab engine's runs."""
    cfg = engine.cfg
    adapters = e8_adapters(cfg, seed)
    prompts, follow = e8_prompts(cfg, seed)
    kws = e8_kws(E8_ROUTES)
    settings = dict(FLAGSHIP, prefix_cache=True)
    plain = LLMEngine(engine.params, cfg, device=DEV, **settings)
    warm(plain, "e8 plain")
    base_rows, base_stats = run_batch(plain, prompts, E8_NEW)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    slab = LLMEngine(engine.params, cfg, device=DEV, adapters=adapters,
                     **settings)
    warmup_s = warm(slab, "e8 slab")
    captures = slab.graph_stats()["captures"]
    check(slab.metrics()["adapters_loaded"] == list(E8_ADAPTERS),
          f"e8: adapters loaded {slab.metrics()}")
    _build.reset_launches()
    rows, stats = run_batch(slab, prompts, E8_NEW, kws)
    launches = {k: _build.LAUNCHES[k] for k in SERVING_KERNELS}
    k3_shapes = dict(_build.SHAPES["flash_prefill"])
    for i, a in enumerate(E8_ROUTES):
        check(len(rows[i]["tokens"]) == E8_NEW,
              f"e8: row {i} has {len(rows[i]['tokens'])} tokens")
        if a is None:
            check(rows[i]["tokens"] == base_rows[i]["tokens"],
                  f"e8: base row {i} differs from the engine without "
                  "adapters")
    differ = sorted({a for i, a in enumerate(E8_ROUTES)
                     if a and rows[i]["tokens"] != base_rows[i]["tokens"]})
    check(len(differ) >= 2, f"e8: only adapters {differ} change the output")
    # the hits: the system prompt is banked under a0 and a2 only
    hits0 = slab.metrics()["prefix_hits"]
    fol, _ = run_batch(slab, follow, E8_NEW, e8_kws(E8_FOLLOW))
    cached = [r["cached"] for r in fol]
    check(cached == [E8_SYSTEM, 0, 0]
          and slab.metrics()["prefix_hits"] - hits0 == 1,
          f"e8: follow-up cached tokens {cached} (want a hit under a0 "
          "only)")
    # a row's tokens do not depend on its batchmates' adapters: the burst
    # again with half of the adapters' rows moved to the base
    same_shape = {}
    for keep in (("a0", "a2"), ("a1", "a3")):
        slab.kvcache.evict(10 ** 9)
        again, _ = run_batch(slab, prompts, E8_NEW, e8_kws(
            [a if a in keep else None for a in E8_ROUTES]))
        for i, a in enumerate(E8_ROUTES):
            want = rows[i] if a in keep else base_rows[i]
            check(again[i]["tokens"] == want["tokens"],
                  f"e8: row {i} ({a}) differs with other batchmates' "
                  "adapters in a wave of its shape")
        same_shape[",".join(keep)] = "equal"
    # the adapters' rows alone: waves of other shapes
    slab.kvcache.evict(10 ** 9)
    idx = [i for i, a in enumerate(E8_ROUTES) if a]
    alone, _ = run_batch(slab, [prompts[i] for i in idx], E8_NEW,
                         [kws[i] for i in idx])
    other = {i: e7_diff(alone[j]["tokens"], rows[i]["tokens"],
                        alone[j]["top"]) for j, i in enumerate(idx)}
    check(all(d is None or d["gap"] < E7_OTHER_GAP for d in other.values()),
          f"e8: adapter rows alone differ past E7_OTHER_GAP: {other}")
    if any(other.values()):
        # the witness (e7_witness's): the wave shape decides the tokens.
        # The batchmates' reruns gave every adapter row its burst tokens
        # in the burst's waves; the rows alone again give theirs
        slab.kvcache.evict(10 ** 9)
        again, _ = run_batch(slab, [prompts[i] for i in idx], E8_NEW,
                             [kws[i] for i in idx])
        check(tokens_of(again) == tokens_of(alone),
              "e8: the adapter rows alone, run again, differ")
    check(slab.graph_stats()["captures"] == captures,
          "e8: a decode graph was captured after warmup")
    slab.cache["aids"].copy_(torch.arange(slab.n_slots, device=DEV) % 5)
    graph_equals_eager(slab, seed, label="e8")
    slab.cache["aids"].zero_()
    del slab
    gc.collect()
    torch.cuda.empty_cache()
    paged = PagedLLMEngine(engine.params, cfg, device=DEV,
                           pool_blocks=E3_POOL_BLOCKS, adapters=adapters,
                           **settings)
    warm(paged, "e8 paged")
    _build.reset_launches()
    prows, pstats = run_batch(paged, prompts, E8_NEW, kws)
    p_launches = {k: _build.LAUNCHES[k] for k in PAGED_KERNELS}
    check(tokens_of(prows) == tokens_of(rows),
          "e8: the paged engine's rows differ from the slab engine's")
    check(all(p_launches.values()), f"e8 paged: launches {p_launches}")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    spec = LLMEngine(engine.params, cfg, device=DEV, adapters=adapters,
                     speculative=6, spec_ngram=3, **settings)
    spec_warmup_s = warm(spec, "e8 speculative")
    _build.reset_launches()
    fresh_estimates(spec)
    srows, sstats = run_batch(spec, prompts, E8_NEW, kws)
    s_launches = {k: _build.LAUNCHES[k] for k in SERVING_KERNELS}
    # a verify round runs each adapter's bypass products at S_v rows a
    # slot, a decode step at one; the batched GEMM's bits depend on the
    # rows, so adapter rows may part from the plain engine's at near-ties
    # wider than E5_GAP (K2's own summation order): E7_OTHER_GAP bounds
    # them, E5_GAP the base rows
    spec_diffs = {i: d for i in range(len(prompts))
                  if (d := e7_diff(srows[i]["tokens"], rows[i]["tokens"],
                                   rows[i]["top"])) is not None}
    check(all(d["gap"] < (E7_OTHER_GAP if E8_ROUTES[i] else E5_GAP)
              for i, d in spec_diffs.items()),
          f"e8 speculative: rows first differ at gaps {spec_diffs}")
    if spec_diffs:
        # the witness: the burst again on the speculative engine gives
        # its rows exactly (and the batchmates' reruns gave the plain
        # engine's its own), so the programs, not a race, part them
        spec.kvcache.evict(10 ** 9)
        fresh_estimates(spec)
        again, _ = run_batch(spec, prompts, E8_NEW, kws)
        check(tokens_of(again) == tokens_of(srows),
              "e8 speculative: the burst run again gives other tokens")
    check(spec.metrics()["spec_verify_rounds"] > 0 and all(
        s_launches.values()), f"e8 speculative: launches {s_launches}")
    del spec
    gc.collect()
    torch.cuda.empty_cache()
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"e8: {name} never launched")
    step_ms = {f"{n}_slots_{label}": e8_step_ms(engine.params, cfg, n, ad)
               for n in (8, 16)
               for label, ad in (("base", None), ("adapters", adapters))}
    print(f"e8 multi-adapter burst (16 rows, routes {list(E8_ROUTES)}): "
          f"slab {json.dumps(stats)}; without adapters "
          f"{json.dumps(base_stats)}; paged {json.dumps(pstats)}; "
          f"speculative {json.dumps(sstats)}, {len(spec_diffs)} rows first "
          f"different at gaps {json.dumps(spec_diffs)}", flush=True)
    print(f"e8: warmups {warmup_s:.2f} / {spec_warmup_s:.2f} s; adapters "
          f"changing their rows {differ}; follow-up cached {cached}; "
          f"batchmates {json.dumps(same_shape)}; rows alone (other wave "
          f"shapes) first diffs {json.dumps(other)}; launches "
          f"{json.dumps(launches)}, paged {json.dumps(p_launches)}, "
          f"speculative {json.dumps(s_launches)}", flush=True)
    print(f"e8 decode step, graph replay wall per step (8-step greedy "
          f"chunk, span 2048, position 1000): {json.dumps(step_ms)}",
          flush=True)
    return k3_shapes


# (e9): disaggregated prefill/decode at the flagship ISVC's config
# (E6_ISVC without speculation: the prefix cache, 16 slab slots x 2048,
# int8 weights and KV, logprobs_topk 5) over (e)'s weights, through
# LLMModel(disaggregated=True), a burst per handoff transport, beside the
# supervised colocated LLMModel. Ten prompts of 136..255 tokens (one 128-token block
# and a tail, a hit on the decode role; a prompt of exactly 128 tokens
# would leave no tail token for a hit) and two of 60 and 100 tokens
# (shorter than a block: bypass) take 256 greedy tokens each; once all
# twelve have their first token, four prompts of 1,536 tokens (the
# chunked chain 1024 + 512 on the prefill role; a hit of 1,408 tokens and
# a 128-token tail on the decode role) take 64. The prefix stores hold 96
# blocks so the burst's 60 blocks never evict.
E9_ISVC = {k: v for k, v in E6_ISVC.items()
           if k not in ("speculative", "compile_cache")}
E9_STORE_BLOCKS = 96
E9_SHORT = (136, 150, 164, 178, 192, 206, 220, 234, 248, 255, 60, 100)
E9_SHORT_NEW = 256
E9_LONG = (1536,) * 4
E9_LONG_NEW = 64


class E9Gate(EngineGate):
    """EngineGate over the supervisor the model loop steps (the decode
    role's, or the colocated one), also recording after each step the
    token count of each tracked request as (time, count) when it moved."""

    def __init__(self, sup, engine):
        super().__init__(sup)
        self.engine = engine
        self.track: list[int] = []
        self.seen: dict[int, list[tuple[float, int]]] = {}

    def _gated(self):
        out = super()._gated()
        now = time.monotonic()
        for rid in self.track:
            n = len(self.engine.partial_result(rid))
            s = self.seen.setdefault(rid, [])
            if not s or s[-1][1] < n:   # (a released request reads 0)
                s.append((now, n))
        return out


def e9_model(engine, handoff):
    """An LLMModel over (e)'s weights with the (e9) config, disaggregated
    with `handoff` (None: colocated), loaded (each engine warmed), its
    loop held at an E9Gate."""
    cfg = dict(E9_ISVC, prefix_cache_blocks=E9_STORE_BLOCKS,
               usage_timing=True)
    if handoff is not None:
        cfg.update(disaggregated=True, disagg={"handoff": handoff})
    model = LLMModel("llama3-8b", params=engine.params,
                     llama_config=engine.cfg, device=DEV, **cfg)
    t = time.monotonic()
    model.load()
    sec = time.monotonic() - t
    gate = E9Gate(model.supervisor, model._engine)
    gate.close()
    return model, gate, sec


def e9_hash(payload) -> str:
    h = hashlib.sha256()
    for t in payload:
        h.update(t.detach().cpu().contiguous().flatten().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def e9_burst(model, gate, prompts, crash=None) -> dict:
    """The (e9) burst through `model`: the twelve short prompts submitted
    whole behind the gate (on a disaggregated model with the prefill
    dispatch held too, and the gate opened once all ten handed-off ones
    reached the decode role, so each role takes them in one wave), the
    four long ones once all twelve have their first token (with `crash`,
    the prefill supervisor armed with it as they go to the prefill role).
    Returns each row's result, TTFT and deliveries, the gap window and the
    payloads handed off."""
    co = model._engine
    disagg = model.prefill_supervisor is not None
    short, long = prompts
    sent = []
    if disagg:
        transfer = co.handoff.transfer

        def kept(payload):
            out = transfer(payload)
            sent.append(out)
            return out

        co.handoff.transfer = kept
        cap = co._max_inflight
        co._max_inflight = 0
    gate.seen = {}
    _build.reset_launches()
    sub_t = {}

    def submit(p, n):
        rid = model._submit({"prompt_tokens": p, "max_new_tokens": n})
        sub_t[rid] = time.monotonic()
        return rid

    rids = [submit(p, E9_SHORT_NEW) for p in short]
    gate.track = list(rids)
    if disagg:
        co._max_inflight = cap
        t = time.monotonic()
        while any(co._reqs[r].stage != "decode" for r in rids):
            check(time.monotonic() - t < 120, "e9: the handed-off prompts "
                  "never reached the decode role")
            time.sleep(0.001)
    gate.is_open.set()
    t = time.monotonic()
    while any(not gate.seen.get(r) or gate.seen[r][-1][1] < 1
              for r in rids):
        check(time.monotonic() - t < 120, "e9: no first tokens")
        time.sleep(0.001)
    if disagg:
        co._max_inflight = 0
    t_long = time.monotonic()
    long_rids = [submit(p, E9_LONG_NEW) for p in long]
    gate.track = rids + long_rids
    if crash is not None:
        model.prefill_supervisor.arm_faults(crash)
    if disagg:
        co._max_inflight = cap
    results = [model._wait(r, full=True) for r in rids + long_rids]
    if disagg:
        del co.handoff.transfer
    gate.close()
    first = {r: next(t for t, n in gate.seen[r] if n >= 1)
             for r in rids + long_rids}
    t_end = max(first[r] for r in long_rids)
    gaps = []
    for r in rids:
        pts = gate.seen[r]
        for (t0, n0), (t1, n1) in zip(pts, pts[1:]):
            if t_long <= t1 <= t_end and n1 > n0:
                gaps.append((t1 - t0) / (n1 - n0) * 1e3)
    return {"rows": results,
            "ttft_ms": [round((first[r] - sub_t[r]) * 1e3, 3)
                        for r in rids + long_rids],
            "gaps_ms": gaps, "sent": sent,
            "tagged": {k: dict(v) for k, v in _build.TAGGED.items()},
            "k3_shapes": dict(_build.SHAPES["flash_prefill"])}


def e9_summary(run, label) -> dict:
    rows = run["rows"]
    long_ttft = run["ttft_ms"][len(E9_SHORT):]
    handoff = [r["timing"]["handoff_ms"] for r in rows
               if r["timing"].get("handoff_ms") is not None]
    out = {"gap_p50_ms": pct(run["gaps_ms"], 50),
           "gap_p99_ms": pct(run["gaps_ms"], 99),
           "gaps": len(run["gaps_ms"]),
           "long_ttft_ms": long_ttft,
           "long_ttft_mean_ms": round(sum(long_ttft) / len(long_ttft), 3)}
    if handoff:
        out["handoff_ms_mean"] = round(sum(handoff) / len(handoff), 3)
    print(f"e9 {label}: {json.dumps(out)}", flush=True)
    return out


def e9_tokens(run) -> list:
    return [r["token_ids"] for r in run["rows"]]


def e9_check_rows(run, label) -> None:
    for i, r in enumerate(run["rows"]):
        n = E9_SHORT_NEW if i < len(E9_SHORT) else E9_LONG_NEW
        check(r["finish_reason"] == "length" and len(r["token_ids"]) == n,
              f"e9 {label}: row {i} {r['finish_reason']} with "
              f"{len(r['token_ids'])} tokens")


def disagg_phase(engine, seed: int) -> dict:
    """(e9) (the constants above): on one disaggregated model with the
    zero-copy handoff, then the serialized one (its transport swapped and
    both stores emptied between), and on the colocated model. Holds: serialized tokens and handed-off payload bytes (a
    sha256 of every block) equal to zero-copy's; the disaggregated tokens
    equal to the colocated ones or first different at a top-2 gap under
    E7_OTHER_GAP, and where any differs the colocated burst again giving
    its own tokens exactly (the serialized run is the disaggregated
    repeat); no full prefill on the decode role, two bypasses, nothing
    lost; one weight copy in both roles; K1 and K3 launched on the
    prefill role and K1, K2 and K3 on the decode role, no K2 on the
    prefill role; no decode capture after warmup; the kv_handoff bucket
    on the decode role's engine a number. Then a backend_crash on the
    prefill supervisor as the long prompts reach it (a chaos script): one
    prefill restart, every stream complete, the zero-copy tokens, nothing
    lost. Prints the short streams' per-token delivery gaps while the long
    prompts prefill (colocated against disaggregated), the long prompts'
    TTFT, handoff_ms, blocks and bytes handed off, the bucket and the
    memory with both roles warm. Returns K3's shapes."""
    from kubeflow_tpu_torch.chaos import (FaultScriptConfig, FaultSpec,
                                          generate_fault_script)
    from kubeflow_tpu_torch.serving.disagg import HANDOFFS
    from kubeflow_tpu_torch.training import profiling

    gen = torch.Generator().manual_seed(seed + 9)
    vocab = engine.cfg.vocab_size
    prompts = tuple([torch.randint(0, vocab, (n,), generator=gen).tolist()
                     for n in lens] for lens in (E9_SHORT, E9_LONG))
    runs, summary = {}, {}
    model, gate, load_s = e9_model(engine, "zero_copy")
    try:
        co = model._engine
        peng = model.prefill_supervisor.engine
        deng = model.supervisor.engine
        mem = torch.cuda.memory_allocated() / 1e9
        keys = deng.graph_stats()["keys"]
        wq = [e.params["layers"]["wq"]["q"].data_ptr()
              for e in (engine, peng, deng)]
        check(wq[0] == wq[1] == wq[2],
              f"e9: the roles hold more than one weight copy {wq}")
        print(f"e9: model loaded (both roles warmed) in {load_s:.2f} s, "
              f"decode role {len(keys)} graphs, memory allocated "
              f"{mem:.3f} GB with both roles warm", flush=True)
        summary["memory_gb"] = round(mem, 3)
        n_req = len(E9_SHORT) + len(E9_LONG)
        for i, handoff in enumerate(("zero_copy", "serialized")):
            # each transport from stores as empty as the first run's
            co.handoff = HANDOFFS[handoff](lambda: co.decode.kvcache)
            for eng in (peng, deng):
                eng.kvcache.evict(10**9)
            run = runs[handoff] = e9_burst(model, gate, prompts)
            e9_check_rows(run, handoff)
            m = model.metrics()
            dg = m["disagg"]
            acc = m["supervisor"]
            check(m["disagg_full_prefills"] == 0
                  and dg["bypass"] == 2 * (i + 1),
                  f"e9 {handoff}: full prefills {m['disagg_full_prefills']}"
                  f", bypass {dg['bypass']}")
            check(acc["lost"] == 0 and acc["in_flight"] == 0
                  and acc["completed"] == n_req * (i + 1),
                  f"e9 {handoff}: accounting {acc}")
            check(dg["pump_errors"] == 0, f"e9: {dg['last_pump_error']}")
            check(deng.graph_stats()["keys"] == keys
                  and deng.graph_stats()["captures"] == len(keys),
                  f"e9 {handoff}: a decode graph was captured after warmup")
            tagged = run["tagged"]
            for role, names in (("prefill", ("quant_matmul",
                                             "flash_prefill")),
                                ("decode", SERVING_KERNELS)):
                for n in names:
                    check(tagged.get(role, {}).get(n, 0) > 0,
                          f"e9 {handoff}: {role} role never launched {n}")
            check(tagged.get("prefill", {}).get("flash_decode", 0) == 0,
                  "e9: the prefill role launched K2")
            s = summary[handoff] = e9_summary(run, handoff)
            s.update(handoff=dg["handoff"],
                     launches={role: {n: tagged.get(role, {}).get(n, 0)
                                      for n in SERVING_KERNELS}
                               for role in ("prefill", "decode")})
            print(f"e9 {handoff}: handoff {json.dumps(dg['handoff'])}; "
                  f"queue wait mean {dg['queue_wait_ms_mean']} ms; "
                  f"launches by role {json.dumps(s['launches'])}",
                  flush=True)
        bd = profiling.serving_decode_breakdown(deng)
        kvh = bd["buckets_ms"]["kv_handoff"]
        check(isinstance(kvh, float),
              f"e9: kv_handoff bucket {kvh!r} on the slab engine")
        summary["kv_handoff_ms"] = kvh
        print(f"e9 serving breakdown of the decode role: kv_handoff {kvh} "
              f"ms (one 128-token block extracted, sliced and handed off); "
              f"device_step_ms {bd['device_step_ms']}", flush=True)
        # the crash run: zero-copy again, from empty stores
        co.handoff = HANDOFFS["zero_copy"](lambda: co.decode.kvcache)
        for eng in (peng, deng):
            eng.kvcache.evict(10**9)
        script = generate_fault_script(FaultScriptConfig(
            seed=seed, duration_s=1.0,
            faults=(FaultSpec("backend_crash", 1, (0.0, 0.0)),)),
            name="e9")
        crash = e9_burst(model, gate, prompts, crash=script)
        e9_check_rows(crash, "crash")
        pacc = model.prefill_supervisor.accounting()
        acc = model.metrics()["supervisor"]
        check(pacc["restarts"] == 1 and acc["decode"]["restarts"] == 0,
              f"e9 crash: prefill restarts {pacc['restarts']}, decode "
              f"{acc['decode']}")
        check(acc["lost"] == 0 and acc["in_flight"] == 0,
              f"e9 crash: accounting {acc}")
        check(e9_tokens(crash) == e9_tokens(runs["zero_copy"]),
              "e9 crash: tokens differ from the run without it")
        summary["crash"] = {
            "prefill_restarts": pacc["restarts"],
            "prefill_mttr_s": pacc["mttr_s"],
            "replayed": pacc["replayed"], "lost": acc["lost"]}
        print(f"e9 prefill-role crash: {json.dumps(summary['crash'])}; "
              "every stream complete, tokens equal to the run without the "
              "crash", flush=True)
    finally:
        gate.remove()
        model.unload()
    zc, ser = runs["zero_copy"], runs["serialized"]
    check(e9_tokens(ser) == e9_tokens(zc),
          "e9: serialized tokens differ from zero-copy's")
    hashes = {k: sorted(e9_hash(p) for p in runs[k]["sent"]) for k in runs}
    check(hashes["serialized"] == hashes["zero_copy"]
          and len(hashes["zero_copy"]) == summary["zero_copy"]["handoff"][
              "blocks_sent"] > 0,
          f"e9: handed-off payloads differ ({len(hashes['zero_copy'])} / "
          f"{len(hashes['serialized'])} blocks)")
    ser_bytes = summary["serialized"]["handoff"]["bytes_sent"]
    check(ser_bytes == sum(t.nbytes for p in ser["sent"] for t in p) > 0,
          f"e9: serialized bytes_sent {ser_bytes}")
    model, gate, load_s = e9_model(engine, None)
    try:
        print(f"e9 colocated: model loaded in {load_s:.2f} s", flush=True)
        colo = e9_burst(model, gate, prompts)
        e9_check_rows(colo, "colocated")
        summary["colocated"] = e9_summary(colo, "colocated")
        diffs = []
        for i, (d, c) in enumerate(zip(zc["rows"], colo["rows"])):
            j = first_diff(d["token_ids"], c["token_ids"])
            if j is not None:
                lp = sorted(d["top_logprobs"][j].values(), reverse=True)
                diffs.append({"row": i, "at": j,
                              "gap": round(lp[0] - lp[1], 5)})
        check(all(d["gap"] < E7_OTHER_GAP for d in diffs),
              f"e9: disaggregated rows past E7_OTHER_GAP: {diffs}")
        if diffs:
            model.engine.kvcache.evict(10**9)
            again = e9_burst(model, gate, prompts)
            check(e9_tokens(again) == e9_tokens(colo),
                  "e9 witness: the colocated burst again gave other tokens")
        summary["differing_rows"] = diffs
        print(f"e9: disaggregated against colocated, rows first "
              f"different: {json.dumps(diffs)}"
              + (" (witness: the colocated burst again gave its tokens "
                 "exactly; serialized gave zero-copy's)" if diffs else ""),
              flush=True)
    finally:
        gate.remove()
        model.unload()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"e9 summary: {json.dumps(summary)}", flush=True)
    shapes = dict(zc["k3_shapes"])
    return shapes


def fill_tables(engine, seed: int = 5) -> None:
    """A paged engine's slot tables filled with a shuffled permutation of
    its pool blocks (an idle engine leaves every row at block 0), in place:
    the decode graphs read that very table."""
    n_pool = engine.cache["k"].shape[1]
    ids = torch.randperm(n_pool - 1, generator=torch.Generator()
                         .manual_seed(seed)) + 1
    check(ids.numel() >= engine._tbl_host.size,
          "the pool cannot fill every slot's table")
    engine._tbl_host[:] = ids[:engine._tbl_host.size].reshape(
        engine._tbl_host.shape).numpy()
    engine._tbl_sync()


def clear_tables(engine) -> None:
    engine._tbl_host[:] = 0
    engine._tbl_sync()


def step_breakdown(engine, steps: int = 8) -> dict:
    """One 8B decode step (every slot at position 1000, span 2048) as the
    engine runs it, one replay of its captured decode chunk (`steps`
    steps, the greedy variant), beside the eager body of the same chunk
    in the same call, and the replay of the sampled variant (penalties
    and the draw, on greedy rows): the wall time per step, the card's
    busy time per step from the profiler's kernel events by kernel
    family, the run's span on the card by CUDA events, and the idle
    share. A paged engine's slot tables are filled with its shuffled pool
    blocks first and zeroed after; the slot state is reset after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_slots, iters = engine.n_slots, 2
    active = torch.ones(n_slots, dtype=torch.bool, device=DEV)
    paged = "tbl" in engine.cache
    if paged:
        fill_tables(engine)

    def graph():
        engine._decode_chunk(steps, 2048, active, sample=False)

    def eager():
        engine._active_dev.copy_(active)
        engine._decode_body(steps, 2048, False)

    def sampled():
        engine._decode_chunk(steps, 2048, active, sample=True)

    out = {}
    for label, run in (("graph", graph), ("eager", eager),
                       ("graph_sampled", sampled)):
        engine.lengths.fill_(1000)
        run()   # first use: the graph's capture, if the menu lacks it
        walls, events = [], []
        for _ in range(iters):
            engine.lengths.fill_(1000)
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            events.append(t0.elapsed_time(t1))
        engine.lengths.fill_(1000)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = {"quant_matmul": 0.0, "flash_decode": 0.0, "other": 0.0}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            ms = evt.self_device_time_total / 1e3 / steps
            if "dequant_kernel" in evt.key:
                busy["quant_matmul"] += ms
            elif "decode_kernel" in evt.key:
                busy["flash_decode"] += ms
            else:
                busy["other"] += ms
        wall_ms = sorted(walls)[iters // 2] / steps * 1e3
        device_ms = sum(busy.values())
        out[label] = {"wall_ms": wall_ms, "device_busy_ms": device_ms,
                      "event_ms": sorted(events)[iters // 2] / steps,
                      "busy_ms_by_kernel": busy,
                      "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    if paged:
        clear_tables(engine)
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    engine._cnt.zero_()
    engine._active_host = None
    print(f"decode step breakdown ({type(engine).__name__}, per step of a "
          f"{steps}-step chunk): {json.dumps(out)}", flush=True)
    if out["graph"]["device_busy_ms"] == 0:
        print("decode step breakdown: the profiler saw no kernel inside the "
              "graph replay; its card time is event_ms", flush=True)
    return out


def prefill_breakdown(engine, seed: int) -> dict:
    """One prefill wave of the 8B engine: three 1000-token prompts (bucket
    1024, B=3 x 1024, the largest wave of (e)) submitted with one new
    token each, so the engine step that runs the wave finishes them. Its
    wall time, and the card's busy time in it from the profiler's kernel
    events by family (K3, K1, cuBLAS GEMMs, other). The wave runs once
    before either timing, so neither holds first-use costs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(seed + 1)
    prompts = [torch.randint(0, engine.cfg.vocab_size, (1000,),
                             generator=gen).tolist() for _ in range(3)]

    def wave():
        rids = [engine.submit(p, 1) for p in prompts]
        engine.step()
        torch.cuda.synchronize()
        check(all(engine.is_done(r) for r in rids),
              "prefill breakdown: one step did not finish the wave")
        for r in rids:
            engine.release(r)

    wave()
    t = time.perf_counter()
    wave()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wave()
    busy = {"flash_prefill": 0.0, "quant_matmul": 0.0, "gemm": 0.0,
            "other": 0.0}
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        key = evt.key.lower()
        if "prefill_kernel" in key:
            busy["flash_prefill"] += ms
        elif "dequant_kernel" in key:
            busy["quant_matmul"] += ms
        elif any(w in key for w in ("conv", "cudnn", "dgrad", "wgrad",
                                    "fprop")):
            busy["conv"] += ms
        elif any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")):
            busy["gemm"] += ms
        else:
            busy["other"] += ms
    device_ms = sum(busy.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": device_ms,
           "busy_ms_by_kernel": busy,
           "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
           "top_kernels_ms": {k[:90]: round(v, 3) for k, v in top}}
    print(f"prefill wave breakdown: {json.dumps(out)}", flush=True)
    return out


def probe_busy(eng, bd) -> dict:
    """The card-busy time of one run of the breakdown's two attention
    probes: the same per-layer calls (K2 over the live span at S_v=1, K3 on
    a 32-row chunk at its end, through the slot tables on a paged engine)
    on the engine's cache, at the lengths the breakdown's decode runs left,
    each under torch.profiler; ms and launches by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, cache, n = eng.cfg, eng.cache, eng.n_slots
    span = bd["span"]
    paged = "tbl" in cache
    if paged:
        bt = cache["k"].shape[2]
        nb = min(span // bt, cache["tbl"].shape[1])
        tbl, span_p = cache["tbl"][:, :nb], nb * bt
    else:
        tbl, span_p = None, span

    def kv(li):
        return [None if name not in cache else
                cache[name][li] if paged else cache[name][li][:, :span]
                for name in ("k", "v", "k_s", "v_s")]

    gen = torch.Generator(device=DEV).manual_seed(7)
    q1 = torch.randn(n, 1, cfg.n_heads, cfg.head_dim, device=DEV,
                     generator=gen).to(cfg.dtype)
    qp = torch.randn(n, 32, cfg.n_heads, cfg.head_dim, device=DEV,
                     generator=gen).to(cfg.dtype)
    lengths = torch.full((n,), bd["fill_len"] + bd["steps"]
                         * (2 + 2 * bd["iters"]), dtype=torch.int32,
                         device=DEV)
    probes = {
        "attn_kernel": lambda li: llama.decode_attention(
            cfg, q1, *kv(li), lengths, tbl),
        "prefill_attn": lambda li: llama.prefill_attention(
            cfg, qp, *kv(li), q_offset=span_p - 32, tables=tbl)}
    fam = {"flash_decode": "decode_kernel", "flash_prefill": "prefill_kernel"}
    out = {}
    for name, call in probes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for li in range(cfg.n_layers):
                call(li)
            torch.cuda.synchronize()
        busy = {f: {"ms": 0.0, "launches": 0} for f in (*fam, "other")}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            f = next((f for f, w in fam.items() if w in evt.key), "other")
            busy[f]["ms"] += evt.self_device_time_total / 1e3
            busy[f]["launches"] += evt.count
        out[name] = busy
    return out


def eager_breakdown(eng, label, prompts, bd) -> None:
    """The same traffic and breakdown with the decode programs run as the
    eager body (only here, for the comparison: the engine never does on
    the card), printed beside the graphs' numbers of `bd`."""
    from kubeflow_tpu_torch.training import profiling

    def eager_fn(steps, span, sample=True):
        return functools.partial(eng._decode_body, steps, span, sample)

    eng._decode_fn = eager_fn
    try:
        eng.perf_counters(reset=True)
        run_batch(eng, prompts[:2], 16)
        if "tbl" in eng.cache:
            fill_tables(eng)
        ebd = profiling.serving_decode_breakdown(eng)
        if "tbl" in eng.cache:
            clear_tables(eng)
    finally:
        del eng._decode_fn
    keys = ("chunk_wall_ms", "device_step_ms", "host_dispatch_per_step_ms")
    side = {k: {"graph": bd[k], "eager": ebd[k]} for k in keys}
    side["host_fetch_replay_per_step"] = {
        "graph": bd["buckets_ms"]["host_fetch_replay_per_step"],
        "eager": ebd["buckets_ms"]["host_fetch_replay_per_step"]}
    print(f"serving breakdown ({label}), graphs against the eager body: "
          f"{json.dumps(side)}", flush=True)


def serving_breakdown_phase(engine, paged, prompts, want):
    """The serving profiler (training/profiling.py serving_decode_breakdown,
    default steps, iters and fill_len) on the 8B slab engine of (e) and on
    the paged engine of (e2). The paged engine's slot tables are first
    filled with a shuffled permutation of its pool blocks (an idle engine
    leaves every row at block 0), and zeroed again after. Checks the
    launches (K3-slab in the slab call, K3-paged and no slab K2 or K3 in
    the paged call), the bucket partition, and that each engine's greedy
    tokens for the burst are unchanged after it; a second call under
    torch.profiler gives the card-busy time of each kernel family beside
    the buckets. Returns the paged call's K3-paged launches and shapes."""
    from kubeflow_tpu_torch.training import profiling

    out = {}
    for label, eng in (("slab", engine), ("paged", paged)):
        eng.perf_counters(reset=True)
        run_batch(eng, prompts[:2], 16)   # the host counters' traffic
        if label == "paged":
            fill_tables(eng)
        _build.reset_launches()
        bd = profiling.serving_decode_breakdown(
            eng, hbm_gbps=HBM_BYTES_PER_S / 1e9)
        launches = dict(_build.LAUNCHES)
        shapes = dict(_build.SHAPES["flash_prefill_paged"])
        busy = probe_busy(eng, bd)
        if label == "paged":
            clear_tables(eng)
        b = bd["buckets_ms"]
        print(f"serving breakdown ({label}): {json.dumps(bd)}", flush=True)
        eager_breakdown(eng, label, prompts, bd)
        print(f"serving breakdown ({label}) launches: {json.dumps(launches)}"
              f"; card busy of one probe run by kernel family: "
              f"{json.dumps(busy)}", flush=True)
        n_layers = eng.cfg.n_layers
        runs = 1 + bd["iters"]   # each probe: one untimed + iters timed
        for name, fam in (("attn_kernel", "flash_decode"),
                          ("prefill_attn", "flash_prefill")):
            wall = b[name]
            kern = busy[name][fam]
            # the profiler may miss the first kernel of a session: the
            # per-launch mean times the probe's launches (one a layer)
            card = kern["ms"] / max(kern["launches"], 1) * n_layers
            lead = "the host" if wall > 2 * card else "the card"
            print(f"serving breakdown ({label}) {name}: bucket {wall:.4f} ms"
                  f" wall a probe; {fam} card busy {card:.4f} ms a probe "
                  f"({kern['launches']} of its {n_layers} launches seen by "
                  f"the profiler); {lead} leads", flush=True)
        for name, val in b.items():
            check(val is None or val >= 0, f"breakdown ({label}): bucket "
                                           f"{name} = {val}")
        part = b["weight_read"] + b["attention_kv_update"] + \
            b["sampling_penalties"]
        check(abs(part - bd["device_step_ms"])
              <= 0.02 * bd["device_step_ms"],
              f"breakdown ({label}): buckets sum to {part}, device step "
              f"{bd['device_step_ms']}")
        check(b["kv_handoff"] is None and b["pipeline_bubble"] is None,
              f"breakdown ({label}): kv_handoff/pipeline_bubble not None")
        check(b["prefill_attn"] is not None and b["attn_kernel"] is not None
              and b["attn_dequant"] is not None,
              f"breakdown ({label}): a probe bucket is None")
        kernel = "flash_prefill_paged" if label == "paged" else \
            "flash_prefill"
        other = "flash_prefill" if label == "paged" else \
            "flash_prefill_paged"
        check(launches[kernel] == n_layers * runs and launches[other] == 0,
              f"breakdown ({label}): {kernel} launched {launches[kernel]} "
              f"times (want {n_layers * runs}), {other} "
              f"{launches[other]}")
        if label == "paged":
            check(isinstance(b["kv_gather"], float),
                  "breakdown (paged): kv_gather is not a number")
            check(launches["flash_decode_paged"] > 0
                  and launches["flash_decode"] == 0,
                  "breakdown (paged): K2-paged not launched, or K2-slab "
                  "launched")
        else:
            check(b["kv_gather"] is None, "breakdown (slab): kv_gather set")
        toks, stats = run_batch(eng, prompts, 32)
        toks = tokens_of(toks)
        check(toks == want, f"breakdown ({label}): the burst's greedy "
                            "tokens changed after profiling")
        print(f"serving breakdown ({label}): the burst's tokens are "
              f"unchanged after it ({json.dumps(stats)})", flush=True)
        out[label] = (launches, shapes)
    return out["paged"]


def paged_prefill_shape_phase(gen, shapes) -> dict:
    """K3-paged against its plain version at each argument shape the paged
    breakdown launched it at. Returns its kernels-line entry: the shape
    launched most often."""
    best = None
    for key, n in sorted(shapes.items(), key=str):
        a = dict(key)
        c = k3_paged_case(gen, a["b"], a["s"], a["q_offset"], a["bt"],
                          a["int8"], a["nb"], nh=a["nh"], nkv=a["nkv"],
                          hd=a["hd"], n_pool=a["n_pool"])
        desc = " ".join(f"{k}={v}" for k, v in key)
        print(f"breakdown shape flash_prefill_paged {desc} launches={n}: "
              f"{fmt(c)}", flush=True)
        if best is None or n > best[0]:
            best = (n, dict(c, shape="one launch at the paged serving "
                            f"breakdown's {desc}"))
    check(best is not None, "breakdown: no K3-paged shape recorded")
    return best[1]


# -- (r) RL on the card, (r2) packing beside serving, (mm) multi-model ----------

#: examples/rl-anakin-jaxjob.yaml's KTPU_RL_CONFIG as written
#: (tests/test_torch_rl_job.py holds the two equal)
R_JOB = {"env": "cartpole", "n_envs": 2048, "rollout_len": 64,
         "hidden": [64, 64], "learning_rate": 0.003, "gamma": 0.99,
         "gae_lambda": 0.95, "clip_eps": 0.2, "entropy_coef": 0.01,
         "value_coef": 0.5, "ppo_epochs": 2, "mesh": {"data": -1},
         "seed": 0, "num_updates": 500, "log_every": 25}
#: bench.py's seeded reward curve (updates, log_every) and its threshold
#: in mean balanced steps (a random policy sits near 20)
R_CURVE = (150, 25)
R_THRESHOLD = 100.0
R_REPLAYS = 3
#: the card-against-CPU config and its tolerance on every param (f32;
#: the same draws on both sides, so the trajectories match while no
#: action flips)
R_SMALL = {"n_envs": 64, "rollout_len": 16}
R_SMALL_UPDATES = 2
R_SMALL_TOL = 1e-4
R_ITERS = 20


class ActionTap:
    """An env that records every action the learner takes (the learner
    steps `learner.env`); everything else is the env's."""

    def __init__(self, env):
        self.env, self.actions = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action, u):
        self.actions.append(action.detach().to("cpu", copy=True))
        return self.env.step(state, action, u)


def rl_bits(learner, state, metrics) -> list[torch.Tensor]:
    """Every tensor of the learner's state and its metrics, copied."""
    return ([t.detach().clone() for t in learner._tensors(state)]
            + [metrics[k].detach().clone() for k in sorted(metrics)])


def r_run(env: dict, cancel) -> int:
    """rl_learner_target as the control plane calls it: its exit code."""
    from kubeflow_tpu_torch.rl import job as rl_job

    try:
        rl_job.rl_learner_target(env, cancel)
    except SystemExit as e:
        return e.code
    return 0


def rl_update_profile(learner, state) -> dict:
    """One update, replayed and eager, under torch.profiler: the kernels
    each ran and their busy time against the wall (synced) time; and the
    host's time to enqueue a replay, the card's time per replay (CUDA
    events) and the wall per synced replay over R_ITERS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        return {"kernels": sum(e.count for e in kern),
                "busy_ms": round(busy, 4), "wall_ms": round(wall, 4),
                "idle_share": round(max(0.0, 1 - busy / wall), 4)}

    learner.step(state)
    out = {"replay": profiled(learner._graph.replay),
           "eager": profiled(learner._body)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(R_ITERS):
        learner._graph.replay()
    out["host_ms_per_replay"] = round(
        (time.perf_counter() - t) / R_ITERS * 1e3, 4)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(R_ITERS):
        learner._graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    out["card_ms_per_replay"] = round(ev[0].elapsed_time(ev[1]) / R_ITERS,
                                      4)
    t = time.perf_counter()
    for _ in range(R_ITERS):
        learner._graph.replay()
        torch.cuda.synchronize()
    out["wall_ms_per_synced_replay"] = round(
        (time.perf_counter() - t) / R_ITERS * 1e3, 4)
    return out


def rl_phase(seed: int):
    """(r): the RLJob example's learner on the card (module doc). Returns
    the learner, its update graph captured, and the bits of its state
    and metrics after its first R_REPLAYS updates ((n.r) holds the
    learner over {"data": -1} to them)."""
    from kubeflow_tpu_torch.rl.anakin import AnakinLearner, net_leaves
    from kubeflow_tpu_torch.rl.config import (LEARNER_METRICS,
                                              REWARD_METRIC, parse_rl_config)
    from kubeflow_tpu_torch.training.metrics_writer import read_metrics

    print(f"r RL on {card_line()}", flush=True)
    cfg, _, _ = parse_rl_config(dict(R_JOB, seed=seed))
    _build.reset_launches()
    learner = AnakinLearner(cfg, device=DEV)
    s0 = learner.init(seed)
    t = time.monotonic()
    state, m = learner.step(s0)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t
    for _ in range(R_REPLAYS - 1):
        state, m = learner.step(state)
    graph = rl_bits(learner, state, m)
    state, m = learner.eager_step(s0)
    for _ in range(R_REPLAYS - 1):
        state, m = learner.eager_step(state)
    eager = rl_bits(learner, state, m)
    check(all(torch.equal(a, b) for a, b in zip(graph, eager)),
          f"r: {R_REPLAYS} graph replays differ from the eager body")
    other = AnakinLearner(cfg, device=DEV)
    st = other.init(seed)
    for _ in range(R_REPLAYS):
        st, om = other.step(st)
    check(all(torch.equal(a, b) for a, b in
              zip(graph, rl_bits(other, st, om))),
          "r: a second learner from the same seed gave other bits")
    del other, st, om
    print(f"r: capture + first replay {capture_s:.2f} s; {R_REPLAYS} "
          "replays bit for bit the eager body and a second learner's "
          "replays", flush=True)
    # the card against the CPU at a small config, the same draws
    small = dataclasses.replace(cfg, **R_SMALL)
    runs = {}
    for dev in ("cpu", DEV):
        lrn = AnakinLearner(small, device=dev)
        tap = lrn.env = ActionTap(lrn.env)
        s = lrn.init(seed)
        for _ in range(R_SMALL_UPDATES):
            s, sm = lrn.eager_step(s)
        runs[dev] = (tap.actions, [p.detach().cpu() for p in
                                   net_leaves(s["params"])],
                     {k: float(v) for k, v in sm.items()})
    (ca, cp, cm), (ga, gp, gm) = runs["cpu"], runs[DEV]
    n_diff = sum(int((a != b).sum()) for a, b in zip(ca, ga))
    err = max(float((a - b).abs().max()) for a, b in zip(cp, gp))
    print(f"r small ({R_SMALL}, {R_SMALL_UPDATES} updates) card against "
          f"CPU: {n_diff} of {sum(a.numel() for a in ca)} actions differ; "
          f"params max abs err {err:.3g} (tol {R_SMALL_TOL:g}); loss card "
          f"{gm['loss']:.6f} cpu {cm['loss']:.6f}", flush=True)
    check(err <= R_SMALL_TOL, f"r: card params off the CPU's by {err}")
    for k, v in m.items():
        check(math.isfinite(float(v)), f"r: metric {k} not finite")
    t = time.monotonic()
    _, hist = learner.train(learner.init(seed), R_CURVE[0],
                            log_every=R_CURVE[1])
    curve_s = time.monotonic() - t
    curve = [round(h[REWARD_METRIC], 2) for h in hist]
    print(f"r curve (seed {seed}, {R_CURVE[0]} updates, every "
          f"{R_CURVE[1]}): {REWARD_METRIC} {curve}; losses "
          f"{[round(h['loss'], 4) for h in hist]}; {curve_s:.2f} s",
          flush=True)
    check(all(math.isfinite(h["loss"]) for h in hist),
          "r: a curve loss is not finite")
    check(hist[-1][REWARD_METRIC] >= R_THRESHOLD,
          f"r: the curve ends at {curve[-1]}, under {R_THRESHOLD}")
    _, sps = learner.measure_steps_per_s(learner.init(seed), iters=R_ITERS)
    prof = rl_update_profile(learner, learner.init(seed))
    print(f"r speed ({cfg.n_envs} envs x {cfg.rollout_len} steps, "
          f"{learner.env_steps_per_update()} env-steps an update): "
          f"{sps:.1f} env-steps/s, "
          f"{sps / learner.env_steps_per_update():.3f} updates/s; "
          f"{json.dumps(prof)}", flush=True)
    root = tempfile.mkdtemp(prefix="chip-smoke-r-")
    try:
        env = {"KTPU_RL_CONFIG": json.dumps(dict(R_JOB, **R_SMALL,
                                                 seed=seed, num_updates=4,
                                                 log_every=2)),
               "KTPU_METRICS_FILE": os.path.join(root, "run.jsonl")}
        code = r_run(env, threading.Event())
        recs = read_metrics(env["KTPU_METRICS_FILE"])
        check(code == 0 and [r["step"] for r in recs] == [2, 4]
              and all(set(LEARNER_METRICS) <= set(r["metrics"])
                      for r in recs),
              f"r: rl_learner_target exited {code}, wrote {recs}")
        env["KTPU_METRICS_FILE"] = os.path.join(root, "cancel.jsonl")
        code = r_run(env, J3Cancel(3))
        recs = read_metrics(env["KTPU_METRICS_FILE"])
        check(code == 143 and [r["step"] for r in recs] == [2],
              f"r: the cancelled target exited {code}, wrote {recs}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("r: rl_learner_target wrote its metrics at updates 2 and 4, and "
          "a cancel at the third update's check exited 143", flush=True)
    check(not any(_build.LAUNCHES.values()),
          f"r: a port kernel was launched: {dict(_build.LAUNCHES)}")
    print("r: launched none of the eight kernels (the RL path has no "
          "Pallas kernel)", flush=True)
    return learner, graph


#: (r2): bench.py's packing point against the flagship engine: its
#: window, and a serving chunk of 16 prompts (bench.py's 99-token prompt)
#: x 32 greedy tokens
R2_SECONDS = 4.0
R2_PROMPTS = 16
R2_NEW = 32
R2_PROMPT = list(range(1, 100))


def packing_phase(eng, learner, seed: int) -> dict:
    """(r2): measure_interference of the learner's update (a chunk is one
    replay, synced, on a stream of its own) against (e3)'s warm flagship
    slab engine (a chunk is R2_PROMPTS x R2_NEW greedy tokens, on its
    thread's default stream)."""
    from kubeflow_tpu_torch.rl.packing import measure_interference

    rl_stream = torch.cuda.Stream()
    rl_stream.wait_stream(torch.cuda.current_stream())
    cur = {"state": learner.init(seed)}
    torch.cuda.synchronize()
    streams: dict[str, int] = {}
    tokens: list = []

    def learner_chunk() -> float:
        with torch.cuda.stream(rl_stream):
            cur["state"], m = learner.step(cur["state"])
            float(m["loss"])
            streams["rl-learner"] = torch.cuda.current_stream().cuda_stream
        return float(learner.env_steps_per_update())

    def serve_chunk() -> float:
        rows, _ = run_batch(eng, [R2_PROMPT] * R2_PROMPTS, R2_NEW)
        tokens.append(tokens_of(rows))
        streams["llm-serving"] = torch.cuda.current_stream().cuda_stream
        return float(R2_PROMPTS * R2_NEW)

    rec = measure_interference(
        "rl-learner", learner_chunk, "llm-serving", serve_chunk,
        seconds=R2_SECONDS, unit_a="env_steps/s", unit_b="tok/s")
    out = rec.to_json()
    print(f"r2 interference record: {json.dumps(out)}", flush=True)
    print(f"r2 streams (cudaStream_t; 0 is the legacy default stream): "
          f"{json.dumps(streams)}; {len(tokens)} serving chunks", flush=True)
    check(min(rec.solo_a, rec.solo_b, rec.packed_a, rec.packed_b) > 0,
          f"r2: a rate is not positive: {out}")
    check(len(tokens) >= 2 and all(t == tokens[0] for t in tokens),
          "r2: the engine's tokens while packed differ from its solo "
          "tokens")
    return out


#: (mm): the families (m) trained whose states it keeps for (mm), in the
#: order (mm) pulls them (the third pull evicts)
MM_FAMILIES = ("m3 resnet", "m4 vit", "m2 bert")
MM_MAX_LOADED = 2
MM_INPUTS = 2            # images (or sequences) a request
MM_PROMPTS = 4
MM_NEW = 16
#: what the eviction must give back: the evicted model's parameter bytes
#: less this (allocator rounding, the request threads' small tensors)
MM_SLACK_BYTES = 64 << 20
#: the host model: the flagship engine config on random int8 weights
MM_HOST = dict(FLAGSHIP, quantize="int8", buckets=list(FLAGSHIP["buckets"]))


def mm_keep(label: str, job: dict, state, root: str) -> None:
    """Save a family's trained params (step and params only) for (mm)."""
    from kubeflow_tpu_torch.training.checkpoint import CheckpointManager

    mngr = CheckpointManager(os.path.join(root, label.split()[1]))
    mngr.save(int(state["step"]), {"params": state["params"],
                                   "step": state["step"]}, force=True)
    mngr.close()
    with open(os.path.join(root, label.split()[1] + ".json"), "w") as f:
        json.dump(job, f)


def mm_inputs(job: dict, seed: int) -> np.ndarray:
    """A request's input for a family: NHWC images or token ids."""
    cfg = registry.make_config(job["model"], job.get("model_overrides"))
    rng = np.random.default_rng(seed)
    if job["model"] == "bert":
        return rng.integers(0, cfg.vocab_size, (MM_INPUTS, job["dataset"][
            "seq_len"])).astype(np.int64)
    size = cfg.image_size
    return rng.normal(size=(MM_INPUTS, size, size, 3)).astype(np.float32)


def mm_served(server, name: str, x: np.ndarray) -> None:
    """V1 and V2 by name through the server equal the model's direct
    predict on the same payload bit for bit."""
    model = server.repository.get(name)
    dtype = "INT64" if x.dtype == np.int64 else "FP32"
    want = model.predict(x.tolist())
    v1 = post_json(f"{server.url}/v1/models/{name}:predict",
                   {"instances": x.tolist()})
    got = np.asarray(v1["predictions"], dtype=want.dtype)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"mm {name}: V1 differs from predict by "
          f"{np.abs(got - want).max() if got.shape == want.shape else '?'}")
    want2 = model.predict({"input": x})
    v2 = post_json(f"{server.url}/v2/models/{name}/infer", {
        "inputs": [{"name": "input", "shape": list(x.shape),
                    "datatype": dtype, "data": x.ravel().tolist()}]})
    o = v2["outputs"][0]
    got2 = np.asarray(o["data"], dtype=want2.dtype).reshape(o["shape"])
    check(np.array_equal(got2, want2) and np.array_equal(want2, want),
          f"mm {name}: V2 differs from predict")


def mm_host_tokens(server) -> list:
    """MM_PROMPTS greedy completions of the host model, one at a time."""
    out = []
    for i in range(MM_PROMPTS):
        body = post_json(server.url + "/openai/v1/completions", {
            "model": "llama3-8b", "prompt": list(range(5 + i, 205 + 50 * i)),
            "max_tokens": MM_NEW})
        out.append(body["choices"][0]["token_ids"])
    return out


def multimodel_phase(seed: int, root: str) -> dict:
    """(mm): the port's server over a repository whose own model is an
    LLMModel at the flagship config (random int8 weights from --seed,
    warmed at load) and a MultiModelAgent(max_loaded=2) pulling (m)'s
    ResNet-50, ViT-B/16 and BERT-base params through the `trainer`
    runtime by file:// URI (module doc)."""
    from kubeflow_tpu_torch.serving.agent import MultiModelAgent
    from kubeflow_tpu_torch.serving.model import ModelError

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    host = LLMModel("llama3-8b", model={f.name: getattr(cfg, f.name) for f
                                        in dataclasses.fields(cfg)},
                    seed=seed, device=DEV, tokenizer=IdTokenizer(),
                    **MM_HOST)
    t = time.monotonic()
    server = CompletionServer(host).start()
    out = {"host_load_s": round(time.monotonic() - t, 2),
           "host_resident_gb": round(torch.cuda.memory_allocated() / 1e9, 3)}
    agent = MultiModelAgent(server.repository, max_loaded=MM_MAX_LOADED)
    names = {label: label.split()[1] for label in MM_FAMILIES}
    try:
        _build.reset_launches()
        before = mm_host_tokens(server)
        pulls, nbytes, inputs = {}, {}, {}

        def pull(label):
            name = names[label]
            with open(os.path.join(root, name + ".json")) as f:
                job = json.load(f)
            inputs[name] = mm_inputs(job, seed)
            t0 = time.monotonic()
            m = agent.pull(name, "trainer", "file://" + os.path.join(
                root, name), model=job["model"],
                model_overrides=job.get("model_overrides"), device=DEV)
            torch.cuda.synchronize()
            nbytes[name] = sum(p.numel() * p.element_size()
                               for p in train.leaves(m.params))
            pulls[name] = {"seconds": round(time.monotonic() - t0, 3),
                           "param_gb": round(nbytes[name] / 1e9, 4),
                           "resident_gb": round(
                               torch.cuda.memory_allocated() / 1e9, 3)}

        first, second, third = (names[x] for x in MM_FAMILIES)
        pull(MM_FAMILIES[0])
        pull(MM_FAMILIES[1])
        for name in (second, first):   # the second pulled becomes the LRU
            mm_served(server, name, inputs[name])
            agent.touch(name)
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        pull(MM_FAMILIES[2])
        freed = alloc0 + nbytes[third] - torch.cuda.memory_allocated()
        check(agent.loaded() == sorted([first, third])
              and agent.evictions == 1,
              f"mm: loaded {agent.loaded()} after {agent.evictions} "
              f"evictions; {second} was the least recently used")
        check(freed >= nbytes[second] - MM_SLACK_BYTES,
              f"mm: evicting {second} freed {freed} bytes of its "
              f"{nbytes[second]}")
        for name in (third, first):
            mm_served(server, name, inputs[name])
            agent.touch(name)
        try:
            agent.pull("llama3-8b", "trainer", model="resnet")
            check(False, "mm: pulling the host's own name did not raise")
        except ModelError as e:
            refused = str(e)
        after = mm_host_tokens(server)
        check(after == before, "mm: the host's greedy tokens changed "
                               "across the pulls")
        launches = {k: _build.LAUNCHES[k] for k in (
            "quant_matmul", "flash_decode", "flash_prefill",
            "flash_attn_fwd")}
        check(all(launches.values()),
              f"mm: a kernel of the path was not launched: {launches}")
        out.update(pulls=pulls, evicted=second,
                   evicted_param_gb=round(nbytes[second] / 1e9, 4),
                   freed_gb=round(freed / 1e9, 4), launches=launches,
                   refused=refused)
        print(f"mm multi-model: {json.dumps(out)}", flush=True)
    finally:
        for name in agent.loaded():
            agent.unload(name)
        server.stop()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def server_phase(engine) -> None:
    """(g): three concurrent completions through the port's server, over
    an LLMModel of (e)'s weights and settings (warmed up at load)."""
    server = CompletionServer.from_config(
        engine.params, engine.cfg,
        {"n_slots": 8, "max_len": 2048, "buckets": [128, 512, 1024],
         "decode_chunk": 8, "kv_quantize": "int8"},
        device=DEV, model="llama3-8b", tokenizer=IdTokenizer()).start()
    results: list = [None] * 3
    try:
        def post(i):
            req = urllib.request.Request(
                server.url + "/openai/v1/completions",
                data=json.dumps({"model": "llama3-8b",
                                 "prompt": f"request {i}: " + "x" * 40 * i,
                                 "max_tokens": 16}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, json.loads(r.read()))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads),
              "server: request threads did not finish")
    finally:
        server.stop()
    ok = 0
    for res in results:
        check(res is not None, "server: a request got no answer")
        status, body = res
        check(status == 200 and body["choices"][0]["text"]
              and body["usage"]["completion_tokens"] == 16,
              f"server: bad completion {body}")
        ok += 1
    print(f"server: {ok}/3 completions ok", flush=True)


# One tree's side of --ab: its own chip_smoke's functions on its own code
# (only functions that the parent tree's chip_smoke has too).
AB_RUN = """
import dataclasses, gc, os, sys
root, label, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from kubeflow_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(f"[{label}] {root}", flush=True)
_build.build_all()
gen = torch.Generator(device=cs.DEV).manual_seed(seed)
# K1: one 8B decode step (8 slots: 224 matmuls + the f32 lm_head)
step = {"ms": 0.0, "library_ms": 0.0}
for (d, o), n in list(cs.K1_LAYER.items()) + [(cs.K1_HEAD, None)]:
    od = torch.float32 if n is None else torch.bfloat16
    c = cs.k1_case(gen, 8, d, o, od)
    for key in step:
        step[key] += (1 if n is None else 32 * n) * c[key]
    print(f"[{label}] quant_matmul m=8 d={d} o={o}: {cs.fmt(c)}", flush=True)
print(f"[{label}] quant_matmul decode step: ms={step['ms']:.4f} "
      f"library_ms={step['library_ms']:.4f}", flush=True)
c = cs.k2_case(gen, 1, 1024, True)
print(f"[{label}] flash_decode B=8 S_v=1 span=1024 int8: {cs.fmt(c)}",
      flush=True)
# the 8B engine (no requests): one decode step and one prefill wave
cfg = dataclasses.replace(cs.llama.LlamaConfig.llama3_8b(),
                          param_dtype=torch.bfloat16)
engine = cs.LLMEngine(cs.llama.init(cfg, seed=seed, device=cs.DEV,
                                    quantize="int8"),
                      cfg, n_slots=8, max_len=2048, buckets=(128, 512, 1024),
                      decode_chunk=8, kv_quantize="int8", device=cs.DEV)
for i in range(2):
    cs.step_breakdown(engine)
cs.prefill_breakdown(engine, seed)
# (e3): the flagship burst's TTFT and decode tok/s on both engines
print(f"[{label}] e3 flagship burst", flush=True)
cs.flagship_phase(engine, seed)
del engine
gc.collect()
torch.cuda.empty_cache()
case = cs.train_attn_case(gen, 2, 4096, True, False)
for kern, c in case.items():
    print(f"[{label}] {kern} B=2 S=4096 H=32 D=128 causal: {cs.fmt(c)}",
          flush=True)
torch.cuda.empty_cache()
c = cs.k3_case(gen, 1024, 0, False, b=3)
print(f"[{label}] flash_prefill B=3 S=1024 wave: {cs.fmt(c)}", flush=True)
torch.cuda.empty_cache()
cs.trainer_phase(seed, {n: case[n]["shape_key"] for n in
                        cs.TRAINING_KERNELS})
"""


# -- (n) the sharded trainer on a one-rank process group ----------------------


#: (n): steps of each sharded trainer run, held to the first steps of the
#: unsharded run of the same config ((j)'s, (m6)'s)
N_STEPS = 3
#: (n)'s train_target job: a small Llama (head dim 128, so B1-B3 run on
#: real heads) on {"fsdp": -1}, logged and saved each step
N_JOB = {"model": "llama", "batch_size": 2, "num_steps": 4, "log_every": 1,
         "seed": 5, "checkpoint_every": 2, "keep_checkpoints": 2,
         "mesh": {"fsdp": -1},
         "model_overrides": {"vocab_size": 4096, "d_model": 512,
                             "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
                             "d_ff": 1024, "max_seq_len": 1024},
         "optimizer": {"warmup_steps": 2},
         "dataset": {"seq_len": 1024}}
#: (n)'s tensor split in one process: Llama-3-8B's 32 query and 8 kv heads
#: over two tensor ranks (16 and 4 a rank), B=2 x S=4096 as (j)
N_TENSOR = 2
#: (n)'s expert split in one process: Mixtral-8x7B's 8 experts over two
#: expert ranks (4 a rank), B=1 x S=4096 as (m6)
N_EXPERT = 2
#: (n.t)'s vocabulary split in f32 (the cross-entropy, its logits
#: gradient, the embedding's table gradient) against the whole
#: vocabulary's, as a share of the largest value: the halves' sums of
#: exponentials are rescaled to the common max (one more rounding) and
#: summed in another order
N_CE_TOL = 1e-5
#: the split layer's output and every gradient against the unsplit
#: layer's on the same inputs, as a share of the tensor's largest value:
#: the split rounds its row-parallel partial sums in f32 before one cast
#: to bf16 where the unsplit layer rounds each GEMM's output to bf16, so
#: the two differ by a few bf16 roundings (2^-8 each)
N_SPLIT_TOL = 2 ** -6


def n_trainer_run(label: str, cfg, mesh, ref: dict, keys,
                  tag: str = "n") -> dict:
    """N_STEPS of the sharded Trainer on `mesh` (every leaf a DTensor,
    B1-B3 launched at least once per layer a step) held to the unsharded
    run `ref` of the same config: step 1's loss bit for bit, every value
    of `keys` within TRAIN_LOSS_RTOL (the embedding gradient's
    scatter-add may sum in another order between runs); the bit-equality
    of each value is recorded."""
    from torch.distributed.tensor import DTensor

    trainer = train.Trainer(cfg, device=DEV, mesh=mesh,
                            metrics=MetricsWriter(echo=False))
    state = trainer.init_state()
    check(all(isinstance(p, DTensor)
              for p in train.leaves(state["params"])
              + train.leaves([state["opt_state"]["mu"],
                              state["opt_state"]["nu"]])),
          f"({tag}) {label}: a state leaf is not a DTensor")
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    _build.reset_launches()
    log = []
    trainer.train(data, N_STEPS, state,
                  step_callback=lambda s, m: log.append(m))
    launches = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
    for name, n in launches.items():
        check(n >= N_STEPS * trainer.model_cfg.n_layers,
              f"({tag}) {label}: {name} launched {n} times in {N_STEPS} "
              "sharded steps")
    check(log[0]["loss"] == ref["loss"][0],
          f"({tag}) {label}: step 1 loss {log[0]['loss']!r} vs the "
          "unsharded "
          f"run's {ref['loss'][0]!r}")
    diffs, bits = {}, {}
    for key in keys:
        d = [abs(m[key] - r) / abs(r) for m, r in zip(log, ref[key])]
        check(max(d) <= TRAIN_LOSS_RTOL,
              f"({tag}) {label}: {key} {[m[key] for m in log]} vs the "
              f"unsharded run's {ref[key][:N_STEPS]}")
        diffs[key] = max(d)
        bits[key] = [m[key] == r for m, r in zip(log, ref[key])]
    steady = sorted(m["step_time_s"] for m in log[1:])
    stats = {key: [m[key] for m in log] for key in keys}
    stats.update(
        bit_equal_to_unsharded=bits, max_rel_diff=diffs, launches=launches,
        step_time_s_median=steady[len(steady) // 2],
        state_gb_per_rank=sum(p.to_local().nbytes for p in train.leaves(
            [state["params"], state["opt_state"]["mu"],
             state["opt_state"]["nu"]])) / 1e9)
    print(f"sharded trainer ({tag}) {label}: {card_line()}; "
          f"{json.dumps(stats)}", flush=True)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def split_err(name: str, got, want) -> float:
    """|got - want|'s max as a share of |want|'s max, held to
    N_SPLIT_TOL."""
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max().clamp_min(1e-30)).item()
    check(math.isfinite(err) and err <= N_SPLIT_TOL,
          f"(n) {name}: off the unsplit layer's by {err:.4g} of its max "
          f"(tol {N_SPLIT_TOL:.4g})")
    return err


def megatron_layer_phase(seed: int) -> dict:
    """(n.t): one Llama-3-8B-width decoder layer (random f32 weights, bf16
    compute, B=2 x S=4096, (j)'s widths) unsplit, then as N_TENSOR tensor
    ranks' bodies one after the other in this process (each rank's column
    blocks of wq/wk/wv and w_gate/w_up, row blocks of wo and w_down,
    `llama.attention_partial` and `llama.mlp_partial`), their reduce-outs
    summed by hand: the output and the gradients of x and of every leaf
    against the unsplit layer's (a random cotangent), B1-B3 launched at
    the rank's heads. Returns the errors and the split run's launches and
    shapes."""
    from kubeflow_tpu_torch.ops.norms import rms_norm

    cfg = llama.LlamaConfig(**train_config(seed).model_overrides)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, s, d, t = 2, 4096, cfg.d_model, N_TENSOR
    layer = {n: (torch.randn(sh, generator=gen, device=DEV) / sh[0] ** 0.5
                 ).requires_grad_()
             for n, sh in llama.matmul_shapes(cfg).items()}
    for n in ("attn_norm", "mlp_norm"):
        layer[n] = (1 + 0.1 * torch.randn(d, generator=gen, device=DEV)
                    ).requires_grad_()
    x = torch.randn(b, s, d, generator=gen, device=DEV).to(
        cfg.dtype).requires_grad_()
    cot = torch.randn(b, s, d, generator=gen, device=DEV)
    rope = llama._rope(cfg, torch.arange(s, device=DEV))
    names = sorted(layer)
    leaves = [x] + [layer[n] for n in names]
    out = llama._layer_body(cfg, x, layer, rope, None)
    want = [out.detach()] + list(torch.autograd.grad(
        (out.float() * cot).sum(), leaves))
    del out
    def block(r):
        return {n: (w if n.endswith("norm") else
                    w.chunk(t, dim=0 if n in llama.ROW_PARALLEL else 1)[r])
                for n, w in layer.items()}
    _build.reset_launches()
    blocks = [block(r) for r in range(t)]
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    part = sum(llama.attention_partial(cfg, h, blk, rope, None)
               for blk in blocks)
    x1 = x + part.to(x.dtype)
    h2 = rms_norm(x1, layer["mlp_norm"], cfg.norm_eps)
    out = x1 + sum(llama.mlp_partial(cfg, h2, blk)
                   for blk in blocks).to(x.dtype)
    got = [out.detach()] + list(torch.autograd.grad(
        (out.float() * cot).sum(), leaves))
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
    shapes = {k: [dict(key) for key in _build.SHAPES[k]]
              for k in TRAINING_KERNELS}
    heads = cfg.n_heads // t
    for k in TRAINING_KERNELS:
        check(launches[k] == t and all(sh["h"] == heads
                                       for sh in shapes[k]),
              f"(n.t): {k} launched {launches[k]} times at {shapes[k]} "
              f"(want {t} at H={heads})")
    errs = {n: split_err(f"t {n}", g, w) for n, g, w in zip(
        ["out", "x"] + names, got, want)}
    del got, want, layer, x, blocks, h, h2, x1, out, part
    torch.cuda.empty_cache()
    stats = {"tensor": t, "heads_per_rank": heads,
             "kv_heads_per_rank": cfg.n_kv_heads // t, "errs": errs,
             "launches": launches, "shapes": shapes,
             "vocab": vocab_split_check(cfg, seed)}
    print(f"(n.t) Megatron layer at Llama-3-8B width, T={t}, B={b} S={s}, "
          f"{heads} query and {cfg.n_kv_heads // t} kv heads a rank, "
          f"{card_line()}: {json.dumps(stats)}", flush=True)
    return stats


def ce_err(name: str, got, want) -> float:
    """|got - want|'s max as a share of |want|'s max, held to N_CE_TOL."""
    err = ((got - want).abs().max()
           / want.abs().max().clamp_min(1e-30)).item()
    check(math.isfinite(err) and err <= N_CE_TOL,
          f"(n.t) {name}: off the whole vocabulary's by {err:.4g} of its "
          f"max (tol {N_CE_TOL:.4g})")
    return err


def vocab_split_check(cfg, seed: int) -> dict:
    """(n.t)'s vocabulary split at Llama-3-8B's vocabulary and width (B=2
    x S=4096, random weights): the logits of a bf16 hidden state through
    an f32 lm_head in bf16 compute (as `llama.apply`), split into
    N_TENSOR column halves; each half's `sharding.vocab_shard_stats`
    combined by hand as `vocab_parallel_ce`'s all-reduces combine them
    (the max, then the rescaled sums and the target logits summed), and
    each half's `sharding.vocab_shard_grad` from the combined statistics,
    against log_softmax over the whole vocabulary and its autograd
    gradient (a random cotangent). Then the embedding table split into
    N_TENSOR row halves: the halves' `llama.embed_partial` lookups summed
    (as `llama._embed`'s reduce-out) against the whole table's lookup,
    bit for bit, and the table's gradient through both."""
    from kubeflow_tpu_torch.parallel import sharding

    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    n, d, v, t = 2 * 4096, cfg.d_model, cfg.vocab_size, N_TENSOR
    h = torch.randn(n, d, generator=gen, device=DEV).to(cfg.dtype)
    head = torch.randn(d, v, generator=gen, device=DEV) / d ** 0.5
    logits = quant.matmul_f32_out(h, head, cfg.dtype)
    del h, head
    targets = torch.randint(0, v, (n,), generator=gen, device=DEV)
    g = torch.rand(n, generator=gen, device=DEV)
    whole = logits.requires_grad_()
    want = -torch.log_softmax(whole, dim=-1).gather(
        -1, targets[:, None])[:, 0]
    want_grad, = torch.autograd.grad((want * g).sum(), whole)
    want = want.detach()
    logits = logits.detach()
    vr = v // t
    halves = logits.split(vr, dim=-1)
    parts = [sharding.vocab_shard_stats(c, targets, r * vr)
             for r, c in enumerate(halves)]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total = sum(s * torch.exp(m - top) for m, s, _ in parts)
    tgt = sum(x for _, _, x in parts)
    got = torch.log(total) + top - tgt
    errs = {"ce": ce_err("ce", got, want)}
    del got, want
    got_grad = torch.cat([
        sharding.vocab_shard_grad(c, targets, r * vr, top, total, g)
        for r, c in enumerate(halves)], dim=-1)
    errs["ce_logits_grad"] = ce_err("ce logits grad", got_grad, want_grad)
    del got_grad, want_grad, logits, halves, whole
    torch.cuda.empty_cache()
    tokens = torch.randint(0, v, (2, 4096), generator=gen, device=DEV)
    table = torch.randn(v, d, generator=gen, device=DEV).requires_grad_()
    cot = torch.randn(2, 4096, d, generator=gen, device=DEV)
    want = table[tokens].to(cfg.dtype)
    want_grad, = torch.autograd.grad((want.float() * cot).sum(), table)
    got = sum(llama.embed_partial(blk, tokens, r * vr)
              for r, blk in enumerate(table.split(vr, dim=0))).to(cfg.dtype)
    got_grad, = torch.autograd.grad((got.float() * cot).sum(), table)
    check(torch.equal(got, want),
          "(n.t): the embedding halves' lookups do not sum to the whole "
          "table's")
    errs["embed_grad"] = ce_err("embed grad", got_grad, want_grad)
    errs["embed_grad_bit_equal"] = torch.equal(got_grad, want_grad)
    del table, got, want, got_grad, want_grad, cot
    torch.cuda.empty_cache()
    return {"vocab": v, "vocab_per_rank": vr, "rows": n, "errs": errs,
            "embed_bit_equal": True}


def expert_layer_phase(seed: int) -> dict:
    """(n.e): Mixtral-8x7B's MoE block at (m6)'s widths (random f32
    weights, bf16 compute, B=1 x S=4096, capacity factor 1.25) unsplit,
    then as N_EXPERT expert ranks' bodies in this process (one routing,
    each rank's dispatch and combine for its experts and its expert
    blocks through `moe.experts_partial`, the partial outputs summed by
    hand in f32): the output, the aux loss and the gradients of the input,
    the router and the experts against the unsplit block's."""
    from kubeflow_tpu_torch.ops import moe

    mcfg = moe_llama.MoELlamaConfig(**m_jobs()["m6 mixtral"][
        "model_overrides"])
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    d, f, e, n = mcfg.d_model, mcfg.d_ff, mcfg.n_experts, 4096

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=DEV)
                / shape[-2] ** 0.5).requires_grad_()
    router, w_gate, w_up, w_down = w(d, e), w(e, d, f), w(e, d, f), \
        w(e, f, d)
    h = torch.randn(1, n, d, generator=gen, device=DEV).to(
        mcfg.dtype).requires_grad_()
    cot = torch.randn(1, n, d, generator=gen, device=DEV)
    leaves = [h, router, w_gate, w_up, w_down]
    names = ["h", "router", "w_gate", "w_up", "w_down"]

    def grads(out, aux):
        return [out.detach(), aux.detach()] + list(torch.autograd.grad(
            (out.float() * cot).sum() + 100.0 * aux, leaves))
    want = grads(*moe.moe_mlp(h, router, w_gate, w_up, w_down,
                              mcfg.moe_args, dtype=mcfg.dtype))
    xt = h.reshape(n, d)
    dispatch, combine, aux = moe.route(xt.float() @ router.float(),
                                       mcfg.moe_args)
    per = e // N_EXPERT
    part = sum(moe.experts_partial(
        xt, dispatch[:, r * per:(r + 1) * per],
        combine[:, r * per:(r + 1) * per], w_gate[r * per:(r + 1) * per],
        w_up[r * per:(r + 1) * per], w_down[r * per:(r + 1) * per],
        mcfg.dtype).float() for r in range(N_EXPERT))
    got = grads(part.to(mcfg.dtype).reshape(1, n, d), aux)
    errs = {k: split_err(f"e {k}", g, v) for k, g, v in zip(
        ["out", "aux"] + names, got, want)}
    kept = int(dispatch.sum())
    del got, want, leaves, dispatch, combine, part, xt
    del router, w_gate, w_up, w_down, h
    torch.cuda.empty_cache()
    stats = {"experts": e, "expert_ranks": N_EXPERT,
             "experts_per_rank": per, "tokens": n,
             "slots_kept": kept, "errs": errs}
    print(f"(n.e) MoE block at Mixtral-8x7B width, {{expert: {N_EXPERT}}}, "
          f"{card_line()}: {json.dumps(stats)}", flush=True)
    return stats


#: (n.p)'s GPipe cut of (j)'s config: stages of the 4 layers and
#: microbatches of the 2 rows
NP_STAGES = 2
NP_MICROBATCHES = 2


def pipeline_train_phase(seed: int, ref: dict) -> dict:
    """(n.p): (j)'s config (Llama-3-8B width, 4 layers, B=2 x S=4096,
    remat "minimal") at (j)'s seed and first batch through the port's
    GPipe schedule in this process, twice. Chained: the port's
    `pipeline.microbatch` cuts the embedded rows into NP_MICROBATCHES
    microbatches, NP_STAGES one-stage `pipeline.gpipe` calls each run
    their slab of 2 layers (`pipeline.llama_stage_fn`) over them, the
    last one's outputs go through `pipeline.llama_loss_tail`, and one
    backward runs every stage's `gpipe` backward in reverse. Whole:
    `pipeline.pipelined_llama_loss` off a mesh (one stage of 4 layers
    over the same microbatches). Holds each loss within TRAIN_LOSS_RTOL
    of (j)'s step 1 and of the unstaged `llama.loss_fn` here, each
    stage's layer gradients and the embed, final_norm and lm_head
    gradients within N_SPLIT_TOL of the unstaged ones (the bit-equality
    of each printed: a GEMM over one row's 4096 tokens may take another
    cuBLAS algorithm than over both rows' 8192), and B1-B3 launched at
    least 2 layers x NP_MICROBATCHES times on each chained stage (its
    forward call, and its part of the backward, told apart by hooks on
    the stages' outputs) and 4 layers x NP_MICROBATCHES times in the
    whole one. Prints the forward-backward times beside (j)'s median
    step and the phase's peak memory (the peak is reset here)."""
    from kubeflow_tpu_torch.parallel import pipeline

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    cfg = train_config(seed)
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    mcfg = trainer.model_cfg
    params = trainer.model.init(mcfg, seed=cfg.seed, device=DEV)
    data = train_data.make_dataset(cfg.dataset, cfg.model, mcfg,
                                   cfg.batch_size, fallback_seed=cfg.seed)
    batch = trainer.to_device(next(data))
    data.close()
    names = [n for n, _ in train.named_leaves(params)]
    leaves = [t.requires_grad_() for t in train.leaves(params)]
    tokens = batch["tokens"].long()

    def launches():
        return {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}

    def since(before):
        now = launches()
        return {k: now[k] - before[k] for k in now}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def unstaged():
        loss, _ = llama.loss_fn(params, batch, mcfg)
        return loss.item(), dict(zip(names, torch.autograd.grad(
            loss, leaves)))
    (want_loss, want), plain_s = timed(unstaged)
    n_stage = mcfg.n_layers // NP_STAGES
    slabs = [{n: v[s * n_stage:(s + 1) * n_stage].detach().requires_grad_()
              for n, v in params["layers"].items()}
             for s in range(NP_STAGES)]
    ends = {n: params[n].detach().requires_grad_()
            for n in ("embed", "final_norm", "lm_head")}
    stage_fn = pipeline.llama_stage_fn(mcfg, llama.global_positions(tokens))
    fwd, marks = [], {}

    def chained():
        h = pipeline.microbatch(llama._embed(ends, tokens, mcfg),
                                NP_MICROBATCHES)
        for s in range(NP_STAGES):
            before = launches()
            h = pipeline.gpipe(stage_fn, slabs[s], h, group=None)
            fwd.append(since(before))
            # runs as the gradient of stage s's output is ready, so just
            # before stage s's backward
            h.register_hook(lambda g, s=s: marks.update({s: launches()}))
        total, n_tok = pipeline.llama_loss_tail(
            ends, h.reshape(*tokens.shape, -1), batch, mcfg)
        loss = total / n_tok.clamp_min(1.0)
        keys = list(ends) + [f"{s}/{n}" for s in range(NP_STAGES)
                             for n in slabs[s]]
        grads = torch.autograd.grad(loss, list(ends.values()) + [
            t for slab in slabs for t in slab.values()])
        marks[-1] = launches()
        return loss.item(), dict(zip(keys, grads))
    (staged_loss, got), staged_s = timed(chained)
    per_stage = [{k: fwd[s][k] + marks[s - 1][k] - marks[s][k]
                  for k in TRAINING_KERNELS} for s in range(NP_STAGES)]
    for n in params["layers"]:
        got["layers/" + n] = torch.cat([got.pop(f"{s}/{n}")
                                        for s in range(NP_STAGES)])

    def whole():
        before = launches()
        loss, _ = pipeline.pipelined_llama_loss(params, batch, mcfg, None,
                                                NP_MICROBATCHES)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        return loss.item(), grads, since(before)
    (whole_loss, whole_got, whole_launches), whole_s = timed(whole)
    for label, value in (("chained stages", staged_loss),
                         ("pipelined_llama_loss", whole_loss)):
        rel = abs(value - ref["loss"][0]) / abs(ref["loss"][0])
        check(rel <= TRAIN_LOSS_RTOL,
              f"(n.p): the {label} loss {value!r} vs (j)'s step 1 "
              f"{ref['loss'][0]!r}")
        check(abs(value - want_loss) <= TRAIN_LOSS_RTOL * abs(want_loss),
              f"(n.p): the {label} loss {value!r} vs unstaged {want_loss!r}")
    errs, bits, whole_errs, whole_bits = {}, {}, {}, {}
    for n in names:
        whole_errs[n] = split_err(f"p whole {n}", whole_got[n], want[n])
        whole_bits[n] = torch.equal(whole_got[n], want[n])
        if n.startswith("layers/"):
            for s in range(NP_STAGES):
                rows = slice(s * n_stage, (s + 1) * n_stage)
                key = f"stage{s}/{n}"
                errs[key] = split_err(f"p {key}", got[n][rows],
                                      want[n][rows])
                bits[key] = torch.equal(got[n][rows], want[n][rows])
        else:
            errs[n] = split_err(f"p {n}", got[n], want[n])
            bits[n] = torch.equal(got[n], want[n])
    for s, c in enumerate(per_stage):
        check(all(c[k] >= n_stage * NP_MICROBATCHES for k in c),
              f"(n.p): stage {s} launched {c} (want each at least "
              f"{n_stage * NP_MICROBATCHES})")
    check(all(v >= mcfg.n_layers * NP_MICROBATCHES
              for v in whole_launches.values()),
          f"(n.p): pipelined_llama_loss launched {whole_launches} (want "
          f"each at least {mcfg.n_layers * NP_MICROBATCHES})")
    shape_keys = {k: set(_build.SHAPES[k]) for k in TRAINING_KERNELS}
    stats = {"stages": NP_STAGES, "layers_per_stage": n_stage,
             "microbatches": NP_MICROBATCHES,
             "rows_per_microbatch": cfg.batch_size // NP_MICROBATCHES,
             "loss": staged_loss, "unstaged_loss": want_loss,
             "j_step1_loss": ref["loss"][0],
             "loss_bit_equal_to_j": staged_loss == ref["loss"][0],
             "loss_bit_equal_to_unstaged": staged_loss == want_loss,
             "grad_errs": errs, "grad_bit_equal": bits,
             "launches_per_stage": per_stage,
             "whole": {"loss": whole_loss,
                       "loss_bit_equal_to_unstaged": whole_loss == want_loss,
                       "grad_errs": whole_errs, "grad_bit_equal": whole_bits,
                       "launches": whole_launches, "fwd_bwd_s": whole_s},
             "staged_fwd_bwd_s": staged_s, "unstaged_fwd_bwd_s": plain_s,
             "j_step_time_s_median": ref["step_time_s_median"],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del got, want, whole_got, slabs, ends, params, leaves, trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"(n.p) GPipe stages of (j)'s config, {NP_STAGES} stages x "
          f"{n_stage} layers, {NP_MICROBATCHES} microbatches of "
          f"{stats['rows_per_microbatch']} row, {card_line()}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"(n.p) chained stages' forward-backward {staged_s:.4f} s, "
          f"pipelined_llama_loss's {whole_s:.4f} s, unstaged "
          f"{plain_s:.4f} s, (j)'s median step "
          f"{ref['step_time_s_median']:.4f} s; peak "
          f"{stats['peak_memory_gb']:.2f} GB", flush=True)
    stats["shape_keys"] = shape_keys
    return stats


def n_rl_run(seed: int, mesh, rl_ref: list) -> dict:
    """(n.r): the RLJob example's learner (R_JOB, 2048 envs x 64 steps)
    with its env batch over the mesh's data axis (one rank): the update
    graph captured with its all-reduces (over data: the grads, the
    metrics; the all-gather of the advantages), R_REPLAYS replays bit for
    bit (r)'s unsharded learner's first updates (`rl_ref`)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.rl.anakin import AnakinLearner
    from kubeflow_tpu_torch.rl.config import parse_rl_config

    cfg, _, _ = parse_rl_config(dict(R_JOB, seed=seed))
    learner = AnakinLearner(cfg, device=DEV, mesh=mesh)
    calls, real = [], dist.all_reduce

    def counted(*a, **kw):
        calls.append(torch.cuda.is_current_stream_capturing())
        return real(*a, **kw)
    state = learner.init(seed)
    t = time.monotonic()
    dist.all_reduce = counted
    try:
        state, m = learner.step(state)
    finally:
        dist.all_reduce = real
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t
    check(learner._graph is not None and sum(calls) > 0,
          f"(n.r): the update graph captured {sum(calls)} all-reduces "
          f"({len(calls)} calls)")
    for _ in range(R_REPLAYS - 1):
        state, m = learner.step(state)
    bits = rl_bits(learner, state, m)
    same = [torch.equal(a, b) for a, b in zip(bits, rl_ref)]
    check(len(bits) == len(rl_ref) and all(same),
          f"(n.r): {same.count(False)} of {len(same)} state and metric "
          "tensors differ from (r)'s unsharded learner's")
    stats = {"n_envs": cfg.n_envs, "rollout_len": cfg.rollout_len,
             "all_reduces_captured": sum(calls),
             "all_reduce_calls": len(calls), "capture_s": capture_s,
             "replays_bit_equal_to_r": R_REPLAYS}
    print(f"(n.r) RL learner on {{data: -1}}, {card_line()}: "
          f"{json.dumps(stats)}", flush=True)
    del learner, state, m, bits
    return stats


def sharded_trainer_phase(seed: int, ref: dict, gen, m6_ref: dict,
                          rl_ref: list) -> dict:
    """(n): a one-rank NCCL process group on a file:// store (no port is
    bound), the meshes {"data": -1}, {"fsdp": -1}, {"tensor": -1} and
    {"expert": -1}; (j)'s config on the sharded trainer over {"fsdp": -1}
    and {"tensor": -1}, (m6)'s over {"expert": -1}, N_STEPS steps each
    from (j)'s and (m6)'s seeds; the tensor and expert splits of one
    layer in this process (n.t, n.e) and B1-B3 at the tensor rank's
    shape against their plain versions; the GPipe stages of (j)'s config
    in this process (n.p); the RL learner over {"data": -1}
    (n.r); then train_target's job from KTPU_NUM_PROCESSES=1 and N_JOB on
    the group's mesh; the group is destroyed before the phase ends.
    `ref` is (j)'s run 1 (per-step losses, grad norms, median step time),
    `m6_ref` (m6)'s run 1, `rl_ref` (r)'s first updates' bits. Returns
    the stats, with B1-B3's kernel-line entries at the tensor rank's
    shape."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import make_mesh, mesh_shape
    from kubeflow_tpu_torch.training import job as train_job
    from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.training.metrics_writer import read_metrics

    tmp = tempfile.mkdtemp(prefix="chip-smoke-n-")
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "pg"), world_size=1, rank=0, device_id=dev)
    try:
        print(f"sharded trainer: NCCL {torch.cuda.nccl.version()}, world "
              f"size {dist.get_world_size()}, backend {dist.get_backend()}",
              flush=True)
        meshes = {axis: make_mesh({axis: -1})
                  for axis in ("data", "fsdp", "tensor", "expert")}
        for axis, mesh in meshes.items():
            check(mesh_shape(mesh) == {a: 1 for a in mesh.mesh_dim_names}
                  and mesh.device_type == "cuda",
                  f"(n): mesh {{{axis}: -1}} is {mesh_shape(mesh)} on "
                  f"{mesh.device_type}")
        cfg = train_config(seed)
        stats = {"fsdp": n_trainer_run("{fsdp: -1}", cfg, meshes["fsdp"],
                                       ref, ("loss", "grad_norm"))}
        stats["fsdp"]["j_step_time_s_median"] = ref["step_time_s_median"]
        stats["tensor"] = n_trainer_run("{tensor: -1}", cfg,
                                        meshes["tensor"], ref,
                                        ("loss", "grad_norm"))
        mcfg = train.TrainerConfig.from_dict(dict(
            m_jobs()["m6 mixtral"], log_every=1, seed=seed))
        stats["expert"] = n_trainer_run("{expert: -1}", mcfg,
                                        meshes["expert"], m6_ref,
                                        ("loss", "aux_loss", "grad_norm"))
        stats["megatron_layer"] = megatron_layer_phase(seed)
        # (n.p) resets the peak for its own: (n)'s folds in the one before
        peak = torch.cuda.max_memory_allocated()
        stats["pipeline"] = pipeline_train_phase(seed, ref)
        case = train_attn_case(gen, 2, 4096, True, False,
                               h=cfg.model_overrides["n_heads"] // N_TENSOR)
        for kern, c in case.items():
            errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                            c["errs"].items())
            c["launches"] = stats["megatron_layer"]["launches"][kern]
            print(f"{kern} at the tensor rank's B=2 S=4096 H="
                  f"{cfg.model_overrides['n_heads'] // N_TENSOR} D=128 "
                  f"causal, {card_line()}: {errs}; {fmt(c)}", flush=True)
        torch.cuda.empty_cache()
        pcase = train_attn_case(gen, 1, 4096, True, False)
        for kern, c in pcase.items():
            errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                            c["errs"].items())
            c["launches"] = sum(st[kern] for st in
                                stats["pipeline"]["launches_per_stage"])
            check(c["shape_key"] in stats["pipeline"]["shape_keys"][kern],
                  f"(n.p): {kern} never ran at one microbatch's shape")
            print(f"{kern} at (n.p)'s microbatch B=1 S=4096 H=32 D=128 "
                  f"causal, {card_line()}: {errs}; {fmt(c)}", flush=True)
        torch.cuda.empty_cache()
        stats["expert_layer"] = expert_layer_phase(seed)
        stats["rl"] = n_rl_run(seed, meshes["data"], rl_ref)
        # the pod target's job on this group, as train_target runs it
        # past one process: the trainer on a mesh of the config's mesh
        sharded_steps = [0]
        step_fn = train.Trainer._sharded_step

        def counted(self, *a):
            sharded_steps[0] += 1
            return step_fn(self, *a)

        job_dir = os.path.join(tmp, "job")
        env = {"KTPU_TRAINER_CONFIG": json.dumps(dict(
            N_JOB, checkpoint_dir=os.path.join(job_dir, "ckpt"))),
            "KTPU_NUM_PROCESSES": "1", "KTPU_PROCESS_ID": "0",
            "KTPU_METRICS_FILE": os.path.join(job_dir, "metrics.jsonl"),
            "KTPU_TORCH_DEVICE": DEV}
        before = dict(_build.LAUNCHES)
        train.Trainer._sharded_step = counted
        try:
            train_job._train(env, threading.Event(), DEV, True,
                             sharded=True)
        finally:
            train.Trainer._sharded_step = step_fn
        rows = read_metrics(env["KTPU_METRICS_FILE"])
        steps = CheckpointManager(os.path.join(job_dir, "ckpt")).all_steps()
        job_launches = {k: _build.LAUNCHES[k] - before.get(k, 0)
                        for k in TRAINING_KERNELS}
        check([r["step"] for r in rows] == [1, 2, 3, 4]
              and all(math.isfinite(r["metrics"]["loss"]) for r in rows),
              f"(n): train_target logged {rows}")
        check(steps == [2, 4], f"(n): train_target saved steps {steps}")
        check(sharded_steps[0] == N_JOB["num_steps"],
              f"(n): train_target ran {sharded_steps[0]} sharded steps")
        check(all(n > 0 for n in job_launches.values()),
              f"(n): train_target launches {job_launches}")
        stats["job"] = {"losses": [r["metrics"]["loss"] for r in rows],
                        "saved_steps": steps, "launches": job_launches}
        stats["peak_memory_gb"] = max(
            peak, torch.cuda.max_memory_allocated()) / 1e9
        print(f"sharded trainer: {card_line()}; job "
              f"{json.dumps(stats['job'])}; peak "
              f"{stats['peak_memory_gb']:.2f} GB", flush=True)
        med = {k: stats[k]["step_time_s_median"]
               for k in ("fsdp", "tensor", "expert")}
        print(f"sharded trainer: median step {med['fsdp']:.4f} s on "
              f"{{fsdp: 1}}, {med['tensor']:.4f} s on {{tensor: 1}} "
              f"against (j)'s {ref['step_time_s_median']:.4f} s unsharded; "
              f"{med['expert']:.4f} s on {{expert: 1}} against (m6)'s "
              f"{m6_ref['step_time_s_median']:.4f} s", flush=True)
        stats["attn_cases"] = case
        stats["pipe_attn_cases"] = pcase
        return stats
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# -- (s) sequence parallelism: the ring and Ulysses ---------------------------


#: (s.r)'s and (s.u)'s ranks of the sequence split, run in one process
S_RANKS = 4
#: (s.r)'s ring against the unsharded kernels at S=8192, as a share of the
#: tensor's largest value: the ring rounds each step's o to bf16 (B1's
#: output) before its f32 merge and sums the steps' bf16 dq, dk and dv
#: parts in f32, where the unsharded kernels round once, so the two
#: differ by a few bf16 roundings (2^-8 each)
S_RING_TOL = 2 ** -6
#: the ring step's rows: key ids 0 then 1 from S_KEY_SPLIT; query ids 1,
#: then 2 (absent from the keys: rows that see no key) over S_BLIND, then 0
S_KEY_SPLIT = 900
S_BLIND = (700, 1000)


def s_config(seed: int, impl: str, mesh: dict) -> train.TrainerConfig:
    """(s.t)'s job: examples/llama-longctx-jaxjob.yaml's config (J3_JOB)
    at its full width and depth, attention_impl `impl` on `mesh`, logged
    each step, from `seed`; its token_file corpus replaced by the
    synthetic stream of `seed` at the same seq_len."""
    return train.TrainerConfig.from_dict(dict(
        J3_JOB, log_every=1, seed=seed, mesh=mesh,
        model_overrides=dict(J3_JOB["model_overrides"], attention_impl=impl),
        dataset={"seq_len": J3_JOB["dataset"]["seq_len"]}))


def s_flash_run(cfg) -> dict:
    """N_STEPS of the unsharded trainer (no mesh): per-step losses and
    grad norms, the median step and the peak memory."""
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    state = trainer.init_state()
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    log = []
    trainer.train(data, N_STEPS, state,
                  step_callback=lambda s, m: log.append(m))
    for name in TRAINING_KERNELS:
        check(_build.LAUNCHES[name] >= N_STEPS * trainer.model_cfg.n_layers,
              f"(s.t) flash: {name} launched {_build.LAUNCHES[name]} times")
    steady = sorted(m["step_time_s"] for m in log[1:])
    stats = {"loss": [m["loss"] for m in log],
             "grad_norm": [m["grad_norm"] for m in log],
             "step_time_s_median": steady[len(steady) // 2],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"(s.t) flash, no mesh, {card_line()}: {json.dumps(stats)}",
          flush=True)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def s_err(name: str, got, want) -> float:
    """|got - want|'s max as a share of |want|'s max, held to
    S_RING_TOL."""
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max().clamp_min(1e-30)).item()
    check(math.isfinite(err) and err <= S_RING_TOL,
          f"(s.r) {name}: off the unsharded kernels' by {err:.4g} of its max "
          f"(tol {S_RING_TOL:.4g})")
    return err


def s_attn_inputs(gen, b, s, h, hkv, d):
    def mk(heads):
        return torch.randn(b, s, heads, d, generator=gen, device=DEV).to(
            torch.bfloat16)
    return mk(h), mk(hkv), mk(hkv), mk(h)


def ring_steps(q, k, v, do, seg, n, causal=True):
    """Every rank's forward and backward ring steps in this process
    (`ring_fwd_step`, `ring_merge`, `ring_bwd_step`), the shards rotated
    by hand: (o, dq, dk, dv) whole, o and dq in q's dtype, dk and dv f32
    at kv width."""
    from kubeflow_tpu_torch.ops import ring_attention as ra

    qs, ks, vs, dos = (x.chunk(n, dim=1) for x in (q, k, v, do))
    segs = seg.chunk(n, dim=1)
    outs, lses = [], []
    for me in range(n):
        b, s_loc, h, _ = qs[me].shape
        o = torch.zeros(qs[me].shape, dtype=torch.float32, device=DEV)
        lse = torch.full((b, h, s_loc), fa.NEG_INF, device=DEV)
        for src in range(n):
            if ra.runs_step(causal, src, me):
                o, lse = ra.ring_merge(o, lse, *ra.ring_fwd_step(
                    qs[me].contiguous(), ks[src].contiguous(),
                    vs[src].contiguous(), segs[me].contiguous(),
                    segs[src].contiguous(), diag=causal and src == me))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    dq = [torch.zeros(x.shape, device=DEV) for x in qs]
    dk = [torch.zeros(x.shape, device=DEV) for x in ks]
    dv = [torch.zeros(x.shape, device=DEV) for x in vs]
    for me in range(n):
        do_me = dos[me].contiguous()
        delta = fa.row_delta(outs[me], do_me)
        for src in range(n):
            if ra.runs_step(causal, src, me):
                dq_p, dk_p, dv_p = ra.ring_bwd_step(
                    qs[me].contiguous(), ks[src].contiguous(),
                    vs[src].contiguous(), do_me, lses[me], delta,
                    segs[me].contiguous(), segs[src].contiguous(),
                    diag=causal and src == me)
                dq[me] += dq_p.float()
                dk[src] += dk_p
                dv[src] += dv_p
    return (torch.cat(outs, dim=1), torch.cat(dq, dim=1).to(q.dtype),
            torch.cat(dk, dim=1), torch.cat(dv, dim=1))


def ring_steps_phase(seed: int) -> dict:
    """(s.r): the long-context example's attention (B=1, S=8192, 16 query
    and 8 kv heads of 128, causal, two packed documents whose boundary
    lies inside shard 2) split over S_RANKS ring ranks in this process:
    each rank's forward and backward steps through the port's step
    functions, the kv-width shards rotated by hand, against the
    unsharded B1-B3 at S=8192 (GQA expanded; dk and dv folded to kv
    width in f32) within S_RING_TOL; B1, B2 and B3 launched N(N+1)/2
    times each (no launch for a future shard). Times the ring's steps
    beside the unsharded kernels."""
    from kubeflow_tpu_torch.ops import ring_attention as ra
    from kubeflow_tpu_torch.ops.attention import repeat_kv

    mo = J3_JOB["model_overrides"]
    b, s, h, hkv = 1, J3_JOB["dataset"]["seq_len"], mo["n_heads"], \
        mo["n_kv_heads"]
    d, n, groups = mo["d_model"] // h, S_RANKS, h // hkv
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    q, k, v, do = s_attn_inputs(gen, b, s, h, hkv, d)
    seg = two_documents(b, s)

    def whole():
        kw = dict(causal=True, segment_ids=seg)
        ke, ve = repeat_kv(k, groups).contiguous(), repeat_kv(
            v, groups).contiguous()
        o, lse = fa.flash_fwd(q, ke, ve, **kw)
        dq, dk, dv = fa.flash_bwd(q, ke, ve, o, lse, do, **kw)
        return o, dq, ra._fold(dk, groups), ra._fold(dv, groups)

    want = whole()
    _build.reset_launches()
    got = ring_steps(q, k, v, do, seg, n)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES[name] for name in TRAINING_KERNELS}
    shapes = {name: [dict(key) for key in _build.SHAPES[name]]
              for name in TRAINING_KERNELS}
    steps = n * (n + 1) // 2
    check(all(x == steps for x in launches.values()),
          f"(s.r): launches {launches}, want {steps} each")
    check(all(sh["sq"] == s // n and sh["sk"] == s // n
              for name in TRAINING_KERNELS for sh in shapes[name]),
          f"(s.r): a kernel ran at another shape than a shard's: {shapes}")
    errs = {name: s_err(name, g, w) for name, g, w in zip(
        ("o", "dq", "dk", "dv"), got, want)}
    del got, want
    ms = {"ring_steps": time_ms([lambda: ring_steps(q, k, v, do, seg, n)],
                                3),
          "unsharded": time_ms([whole], 3)}
    stats = {"ranks": n, "s_loc": s // n, "errs": errs, "tol": S_RING_TOL,
             "launches": launches, "ms_fwd_bwd": ms}
    print(f"(s.r) ring at B={b} S={s} H={h} kv heads {hkv} D={d} causal, two "
          f"documents, {n} ranks' steps in one process, {card_line()}: "
          f"{json.dumps(stats)}", flush=True)
    del q, k, v, do
    torch.cuda.empty_cache()
    return stats


def ulysses_heads_phase(seed: int) -> dict:
    """(s.u): Ulysses' body at the long-context example's attention (B=1,
    S=8192, 16 query and 8 kv heads of 128, causal) over S_RANKS ranks in
    this process: each rank's `flash_attention` on its 4 query and 2 kv
    heads of the whole sequence (the heads the all-to-all hands it)
    against the unsharded run's heads: o, dq, dk and dv bit for bit (B1-B3
    compute each head alone); B1-B3 launched once a rank."""
    mo = J3_JOB["model_overrides"]
    b, s, h, hkv = 1, J3_JOB["dataset"]["seq_len"], mo["n_heads"], \
        mo["n_kv_heads"]
    d, n = mo["d_model"] // h, S_RANKS
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    q, k, v, do = s_attn_inputs(gen, b, s, h, hkv, d)

    def run(qx, kx, vx, dox):
        xs = [x.contiguous().requires_grad_() for x in (qx, kx, vx)]
        o = fa.flash_attention(*xs, causal=True)
        return [o.detach()] + list(torch.autograd.grad(o, xs,
                                                       dox.contiguous()))

    want = run(q, k, v, do)
    _build.reset_launches()
    hq, hk = h // n, hkv // n
    bits, errs = [], {}
    for j in range(n):
        sq, sk = slice(j * hq, (j + 1) * hq), slice(j * hk, (j + 1) * hk)
        got = run(q[:, :, sq], k[:, :, sk], v[:, :, sk], do[:, :, sq])
        for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                              (want[0][:, :, sq], want[1][:, :, sq],
                               want[2][:, :, sk], want[3][:, :, sk])):
            bits.append(torch.equal(g, w))
            errs[name] = max(errs.get(name, 0.0), (
                (g.float() - w.float()).abs().max()
                / w.float().abs().max()).item())
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES[name] for name in TRAINING_KERNELS}
    check(all(x == n for x in launches.values()),
          f"(s.u): launches {launches}, want {n} each")
    check(all(bits), f"(s.u): a rank's heads differ from the unsharded "
                     f"run's (max error of its max {errs})")
    stats = {"ranks": n, "heads_per_rank": hq, "kv_heads_per_rank": hk,
             "bit_equal": all(bits), "launches": launches}
    print(f"(s.u) Ulysses' rank body at B={b} S={s}, {hq} query and {hk} "
          f"kv heads a rank, {card_line()}: {json.dumps(stats)}",
          flush=True)
    del q, k, v, do, want
    torch.cuda.empty_cache()
    return stats


def blind_rows_check(gen) -> dict:
    """A ring step whose query rows S_BLIND see no key (their document is
    absent from the arriving shard), at the ring step's shape (B=1, 2048
    rows, 16 heads of 128, not causal): B1 gives o = 0 and lse <= -1e29
    there and nothing NaN; B2 and B3, given the global lse and delta of
    this step merged with a second shard where those rows see keys, are
    held to their plain versions and give those rows a zero dq."""
    from kubeflow_tpu_torch.ops import ring_attention as ra

    b, s, h, d = 1, 2048, 16, 128
    q, k1, v1, do = s_attn_inputs(gen, b, s, h, h, d)
    _, k2, v2, _ = s_attn_inputs(gen, b, s, h, h, d)
    seg_q, seg_1 = ring_step_ids(s)
    seg_2 = torch.full_like(seg_1, 2)
    o1, lse1 = fa.flash_fwd(q, k1, v1, causal=False, segment_ids=seg_1,
                            q_segment_ids=seg_q)
    blind = slice(*S_BLIND)
    check(torch.isfinite(o1).all().item()
          and not torch.isnan(lse1).any().item()
          and (o1[:, blind] == 0).all().item()
          and (lse1[:, :, blind] <= -1e29).all().item(),
          "(s) B1: rows that see no key are not o = 0, lse <= -1e29")
    o2, lse2 = fa.flash_fwd(q, k2, v2, causal=False, segment_ids=seg_2,
                            q_segment_ids=seg_q)
    o, lse = ra.ring_merge(torch.zeros(q.shape, device=DEV),
                           torch.full((b, h, s), fa.NEG_INF, device=DEV),
                           o1, lse1)
    o, lse = ra.ring_merge(o, lse, o2, lse2)
    o = o.to(q.dtype)
    delta = fa.row_delta(o, do)
    kw = dict(causal=False, segment_ids=seg_1, q_segment_ids=seg_q)
    dq = fa.flash_bwd_dq(q, k1, v1, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k1, v1, do, lse, delta, **kw)
    check((dq[:, blind] == 0).all().item(),
          "(s) B2: a row that sees no key has a nonzero dq")
    name = "B2/B3 ring step with the global lse"
    worst = {
        "dq": attn_err(dq, fa.plain_bwd_dq(q, k1, v1, do, lse, delta, **kw),
                       f"{name} dq", ATTN_ROW_TOL, grad=True)[1]}
    rdk, rdv = fa.plain_bwd_dkv(q, k1, v1, do, lse, delta, **kw)
    worst["dk"] = attn_err(dk, rdk, f"{name} dk", ATTN_ROW_TOL, grad=True)[1]
    worst["dv"] = attn_err(dv, rdv, f"{name} dv", ATTN_ROW_TOL, grad=True)[1]
    print(f"(s) rows that see no key ({S_BLIND[1] - S_BLIND[0]} of {s}): B1 "
          "o = 0, lse <= -1e29, no NaN; B2/B3 from the merged lse, worst "
          f"rows {json.dumps(worst)} (tol {ATTN_ROW_TOL:.3g}), dq = 0 there",
          flush=True)
    return worst


def ring_step_ids(s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(query ids, key ids) [1, s] int32 of a ring step: the keys are
    documents 0 and 1, the queries documents 1, 2 (rows S_BLIND, none of
    whose keys arrived) and 0."""
    seg_k = torch.zeros(1, s, dtype=torch.int32, device=DEV)
    seg_k[:, S_KEY_SPLIT:] = 1
    seg_q = torch.ones(1, s, dtype=torch.int32, device=DEV)
    seg_q[:, S_BLIND[0]:S_BLIND[1]] = 2
    seg_q[:, S_BLIND[1]:] = 0
    return seg_q, seg_k


def sequence_phase(seed: int, gen) -> dict:
    """(s): a one-rank NCCL process group on a file:// store and the mesh
    {"sequence": -1}; (s.t) the long-context example's config at its
    full width and depth on the unsharded trainer with "flash", then on
    the sharded trainer over {"sequence": -1} with "ring" and "ulysses"
    (one rank: flash attention, B1-B3 every layer), N_STEPS each, step
    1's loss bit for bit the flash run's and every loss and grad norm
    within TRAIN_LOSS_RTOL; the group is destroyed. Then (s.r) the ring's
    steps and (s.u) Ulysses' rank bodies in one process, the rows that
    see no key, and B1-B3 against their plain versions and timed at a
    ring step's shape and at Ulysses' rank's. Returns the stats with the
    kernel-line entries of both shapes."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import make_mesh, mesh_shape

    tmp = tempfile.mkdtemp(prefix="chip-smoke-s-")
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "pg"), world_size=1, rank=0, device_id=dev)
    stats = {}
    try:
        mesh = make_mesh({"sequence": -1})
        check(mesh_shape(mesh) == {a: 1 for a in mesh.mesh_dim_names},
              f"(s): mesh {{sequence: -1}} is {mesh_shape(mesh)}")
        ref = s_flash_run(s_config(seed, "flash", J3_JOB["mesh"]))
        stats["flash"] = ref
        for impl in ("ring", "ulysses"):
            torch.cuda.reset_peak_memory_stats()
            run = n_trainer_run(f"{impl} on {{sequence: -1}}",
                                s_config(seed, impl, {"sequence": -1}),
                                mesh, ref, ("loss", "grad_norm"), tag="s.t")
            run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            stats[impl] = run
            print(f"(s.t) {impl} on {{sequence: 1}}, {card_line()}: median "
                  f"step {run['step_time_s_median']:.4f} s against flash's "
                  f"{ref['step_time_s_median']:.4f} s unsharded; peak "
                  f"{run['peak_memory_gb']:.2f} GB (flash "
                  f"{ref['peak_memory_gb']:.2f} GB)", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    stats["ring_steps"] = ring_steps_phase(seed)
    stats["ulysses"]["heads"] = ulysses_heads_phase(seed)
    stats["blind_rows"] = blind_rows_check(gen)
    cases = {}
    mo = J3_JOB["model_overrides"]
    h = mo["n_heads"]
    ring_case = train_attn_case(gen, 1, 2048, False, True, h=h,
                                ids=ring_step_ids(2048))
    uly_case = train_attn_case(gen, 1, J3_JOB["dataset"]["seq_len"], True,
                               False, h=h // S_RANKS)
    for label, case, launches in (
            ("a ring step of the long-context example (s.r)", ring_case,
             stats["ring_steps"]["launches"]),
            ("Ulysses' rank of the long-context example (s.u)", uly_case,
             stats["ulysses"]["heads"]["launches"])):
        for kern, c in case.items():
            c["launches"] = launches[kern]
            c["shape"] = f"{c['shape']} ({label})"
            errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                            c["errs"].items())
            print(f"{kern} at {label}, {card_line()}: {errs}; {fmt(c)}",
                  flush=True)
        cases[label] = case
    stats["attn_cases"] = cases
    return stats


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def ab_main(other: str, seed: int) -> int:
    """--ab: the other tree and this one in turns, each in its own
    process; stops at the first run that fails."""
    print(card_line(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    check(os.path.isfile(os.path.join(other, "chip_smoke.py")),
          f"--ab: no chip_smoke.py in {other}")
    for root, label in ((other, "other"), (here, "this"), (here, "this"),
                        (other, "other")):
        rc = subprocess.run([sys.executable, "-c", AB_RUN, root, label,
                             str(seed)]).returncode
        if rc != 0:
            print(f"chip_smoke --ab: the {label} run failed ({rc})",
                  file=sys.stderr)
            return rc
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="OTHER_TREE",
                    help="compare K1's decode step, K2, the decode step, "
                         "the prefill wave, (e3)'s flagship burst, the "
                         "training kernels, K3 and the trainer with "
                         "another checkout instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return ab_main(args.ab, args.seed)
    # f32 references run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "allow_tf32 matmul=False cudnn=False", flush=True)
    print(f"build stamp: {json.dumps(build_stamp())}", flush=True)
    t = time.monotonic()
    built = _build.build_all()
    print(f"build: {time.monotonic() - t:.2f} s for {len(built)} kernels; "
          "seconds each: " + json.dumps({name: round(sec, 2) for name, (sec, _)
                                          in built.items()}), flush=True)
    build_report(built)
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    seconds = {}

    def phase(name, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        seconds[name] = round(time.monotonic() - t0, 2)
        print(f"phase {name}: {seconds[name]} s", flush=True)
        return out

    k1_step, k1_rounds = phase("c kernels", kernel_phase, gen)
    phase("d reference", reference_phase, args.seed)
    engine, launches, shapes, prompts, tokens = phase(
        "e engine", engine_phase, args.seed)
    p_launches, p_shapes, paged = phase("e2 paged engine",
                                        paged_engine_phase, engine, prompts,
                                        tokens)
    launches["flash_decode_paged"] = p_launches["flash_decode_paged"]
    shapes["flash_decode_paged"] = p_shapes["flash_decode_paged"]
    rl_ref = []

    def rl_phases(slab):
        learner, bits = phase("r RL", rl_phase, args.seed)
        rl_ref.extend(bits)
        phase("r2 packing", packing_phase, slab, learner, args.seed)

    e3_k3_shapes, _ = phase("e3 flagship engine", flagship_phase, engine,
                            args.seed, rl_phases)
    phase("e3 K3 shapes", continuation_shape_phase, gen, e3_k3_shapes)
    e4_k3_shapes, e4_ref = phase("e4 prefix cache", prefix_cache_phase,
                                 engine, args.seed)
    phase("e4 K3 shapes", continuation_shape_phase, gen, e4_k3_shapes, "e4")
    p_k2 = phase("p stage-sharded serving", stage_phase, engine, args.seed,
                 e4_ref, gen)
    del e4_ref
    e5_shapes = phase("e5 speculation", spec_phase, engine, args.seed)
    verify_cases = phase("e5 verify shapes", verify_shape_phase, gen,
                         e5_shapes)
    # (e6)'s HF directory stays until (l) has fine-tuned on it
    e6_root = tempfile.mkdtemp(prefix="chip-smoke-e6-")
    try:
        hf_dir = phase("e6 dataplane", dataplane_phase, args.seed, None,
                       e6_root)
        phase("e7 scenarios", scenario_phase, engine, args.seed)
        e8_k3_shapes = phase("e8 multi-adapter serving",
                             multi_adapter_phase, engine, args.seed)
        phase("e8 K3 shapes", continuation_shape_phase, gen, e8_k3_shapes,
              "e8")
        e9_k3_shapes = phase("e9 disaggregated serving", disagg_phase,
                             engine, args.seed)
        phase("e9 K3 shapes", continuation_shape_phase, gen, e9_k3_shapes,
              "e9")
        cases = {"quant_matmul": k1_step,
                 **phase("f engine shapes", engine_shape_phase, gen,
                         shapes)}
        phase("f step breakdown", step_breakdown, engine)
        phase("f paged step breakdown", step_breakdown, paged)
        phase("f prefill breakdown", prefill_breakdown, engine, args.seed)
        bd_launches, bd_shapes = phase("f2 serving breakdown",
                                       serving_breakdown_phase, engine,
                                       paged, prompts, tokens)
        del paged
        launches["flash_prefill_paged"] = bd_launches["flash_prefill_paged"]
        cases["flash_prefill_paged"] = phase(
            "f2 breakdown shapes", paged_prefill_shape_phase, gen, bd_shapes)
        phase("g server", server_phase, engine)
        del engine   # the engine holds reference cycles: collect it now,
        gc.collect()   # so the trainer's peak memory is the trainer's own
        torch.cuda.empty_cache()
        print(f"after serving: {torch.cuda.memory_allocated() / 1e9:.3f} "
              "GB still allocated", flush=True)
        train_cases = phase("h training kernels", train_attn_phase, gen)
        cases.update(train_cases)
        phase("i train reference", train_reference_phase, args.seed)
        train_launches, train_stats = phase(
            "j trainer", trainer_phase, args.seed,
            {name: train_cases[name]["shape_key"]
             for name in TRAINING_KERNELS})
        launches.update(train_launches)
        phase("j2 trainer profile window", trainer_profile_phase, args.seed,
              train_stats["step_time_s_median"])
        phase("j3 training job", training_job_phase, args.seed)
        phase("l LoRA fine-tune", lora_train_phase, args.seed, hf_dir)
    finally:
        shutil.rmtree(e6_root, ignore_errors=True)
    phase("l2 LoRA job", lora_job_phase, args.seed)
    mm_root = tempfile.mkdtemp(prefix="chip-smoke-mm-")
    try:
        m4_attn, m6_ref = phase("m model families", families_phase,
                                args.seed, gen, mm_root)
        phase("mm multi-model serving", multimodel_phase, args.seed,
              mm_root)
    finally:
        shutil.rmtree(mm_root, ignore_errors=True)
    n_stats = phase("n sharded trainer", sharded_trainer_phase, args.seed,
                    train_stats, gen, m6_ref, rl_ref)
    s_stats = phase("s sequence parallel", sequence_phase, args.seed, gen)
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)
    kernels = []
    for name in _build.KERNELS:
        c = cases[name]
        source = name.removesuffix("_paged")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{source}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"]})
    # the verify shapes of (e5): K1's verify round at the row count (e5)
    # launched most, K2 and K2-paged at their most launched verify shape
    by_m: dict[int, int] = {}
    for key, n in e5_shapes["slab"]["quant_matmul"].items():
        m = dict(key)["m"]
        if m in K1_VERIFY_M:
            by_m[m] = by_m.get(m, 0) + n
    m = max(by_m, key=by_m.get)
    verify_cases["quant_matmul"] = dict(
        k1_rounds[m], launches=by_m[m],
        shape=f"one 8B verify round (e5): 224 int8 matmuls at m={m} + "
              "lm_head")
    for name in ("quant_matmul", "flash_decode", "flash_decode_paged"):
        c = verify_cases[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/"
                      f"{name.removesuffix('_paged')}.cu",
            "replaces": REPLACES[name], "launches": c["launches"],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"]})
    # K2 over a stage's window of slot rows, with (p)'s launches there
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": REPLACES["flash_decode"], "launches": p_k2["launches"],
        "max_abs_err": p_k2["err"], "ms": p_k2["ms"],
        "plain_ms": p_k2["plain_ms"], "bound_ms": p_k2["bound_ms"],
        "bound_by": p_k2["bound_by"], "library_ms": p_k2["library_ms"],
        "shape": p_k2["shape"]})
    # B1-B3 at ViT-B/16's non-causal shape, launched by (m4)
    for name in TRAINING_KERNELS:
        c = m4_attn[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": c["launches"],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": f"{c['shape']} (m4, ViT-B/16)"})
    # B1-B3 at a Llama-3-8B tensor rank's heads (T=2), launched by (n.t)
    for name in TRAINING_KERNELS:
        c = n_stats["attn_cases"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": c["launches"],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": f"{c['shape']} (n.t, a tensor rank of Llama-3-8B)"})
    # B1-B3 at a GPipe microbatch of (j)'s config, launched by (n.p)
    for name in TRAINING_KERNELS:
        c = n_stats["pipe_attn_cases"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": c["launches"],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": f"{c['shape']} (n.p, a GPipe microbatch of (j))"})
    # B1-B3 at a ring step's and at Ulysses' rank's shape, with (s.r)'s
    # and (s.u)'s launches
    for case in s_stats["attn_cases"].values():
        for name in TRAINING_KERNELS:
            c = case[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"kubeflow_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": c["launches"],
                "max_abs_err": c["err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "shape": c["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
