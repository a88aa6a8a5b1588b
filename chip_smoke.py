#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing here catches a failure):

  1. build  — refuse to run with ``REPRO_KERNEL_BACKEND`` set (every tier
     here is picked by explicit argument), compile every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel) and print
     the build time, the registers/spills ptxas reports, and the card's
     name and power limit.
  2. kernels — call each of the seven kernels' wrappers on the card at the
     shapes the serving paths give it and hold it against its plain PyTorch
     version on the same inputs: quantize_act (also at bits 2, 4 and 6, on
     .5 ties and near-ties, ragged K and a row past its registers, timed
     beside a one-element launch, the launch floor) and qmatmul_w8a8
     bit-equal;
     qmatmul_w8a16 within ``W8A16_TOL`` (it applies the scale after the sum,
     the plain version before it); fused_decode's appended cache bit-equal,
     its output within ``OUT_TOL``, and its quantize-out bit-equal to
     quantize_act of that output and off the plain version's only at
     rounding ties; kv_attention within ``OUT_TOL`` at the decode shape, a
     ragged S, S below the plain version's block, GQA 4 and the JAX bench's
     long context, with and without v_err, a fully masked row exactly 0;
     fused_decode bit-equal to append_quantize + kv_attention (+
     quantize_act); the attention split sweep (both attention kernels under
     forced S splits at the decode shape and the long context, with rows
     whose splits are all masked but one: within ``OUT_TOL``, two calls and
     fused against unfused bit-equal at every split, each split timed); the
     three calls the CUDA tiers once refused (kv_attention's float32 out
     from bfloat16 q, fused_decode's shared idx [1] and float32 quantize-out
     from bfloat16 q, quantize_act at bits < 8), against the torch tier;
     the quantize-out GEMMs (one launch each) bit-equal to
     the stepwise pair of the port's own kernels (W8A8, and W8A16 with
     float32 a) and to the W8A8 plain version, W8A16 with bfloat16 a within
     one step of its plain version, at every path shape, the JAX benches'
     shapes and qwen2's vocabulary (N = 151936, the workspace route), on
     the route ``gemm_plan.q8_plan`` takes, at bits 4 and 8 and on the
     forced workspace route at one decode and one prefill shape, two calls
     of each bit-equal; each shape's route, tile, tickets and waiters are
     logged beside the q8 kernel, the pair and the GEMM alone (warm, and
     cold at M = 8). In float32 the W8A16 check also runs
     two controls that must fall outside its tolerance (TF32, and ``a``
     rounded to bf16). The split sweep runs both GEMMs at every path shape
     under forced K splits (1, 2, the planner's, the largest it allows):
     W8A8 bit-equal in both output types at M = 8, 64 and 256, W8A16 within
     ``W8A16_TOL`` in bf16 and f32, and two calls of each GEMM and each
     quantize-out variant bit-equal; it logs each split's time. The
     quantize-in W8A8 GEMM (qmatmul_w8a8_qin: quantize_act folded into its
     prologue) bit-equal to quantize_act + qmatmul_w8a8, and the int8 x it
     hands out to quantize_act's, at every path K x N and a ragged K, M 1-256,
     bf16/f32 x and out, every split whose slice fits, .5 ties, near-ties, a
     zero row and a row whose only large value lies in the last split;
     timed beside the pair, the GEMM alone and torch._int_mm, warm and (M =
     8) cold. Times each
     kernel (device time, queued behind a sleep kernel so the host's
     per-call cost is hidden, and the time of a back-to-back wrapper call,
     host included), its plain version, the stepwise pair a quantize-out GEMM
     replaces and, where one exists, the one PyTorch call computing the same
     function, all with CUDA events, and beside the attention rows
     ``scaled_dot_product_attention`` on a bfloat16 cache of the same shape
     (GQA heads expanded: a different function, a yardstick only). At M = 8
     the GEMMs and their library
     calls are also timed cold: rotating over 128 MB of weight copies, so
     each call reads its weight from HBM as the serving path does. One line
     sums the GEMMs' device time over a decode step and a prefill chunk, two
     more a W8A8 decode step's GEMMs + activation quantization, pair
     against fold. Then the geometries of the four other dense archs:
     fused_decode and kv_attention at B=8 S=512 with Hq/Hkv/hd 32/8/128
     (mistral-nemo-12b), 56/8/128 (yi-34b), 64/8/128 (chameleon-34b) and
     16/16/256 (gemma-7b), float32 and bfloat16, against their plain
     versions as above (the plan's splits and shared memory logged); and
     the three W8A8/W8A16 GEMMs at mistral-nemo-12b's decode projections
     and gemma-7b's K=24576 down projection, M = 8 and 256: qmatmul_w8a8
     bit-equal, qmatmul_w8a16 within ``W8A16_TOL``, qmatmul_w8a8_qin
     bit-equal to the pair where ``gemm_plan`` folds and refused with the
     plan's reason where it does not; every new row timed in the phase's
     row format (the kernels JSON line keeps qwen2's rows). Then the MoE
     archs: the decode attention kernels at 48/8/128 (mixtral-8x22b) and
     40/8/128 (llama4-scout-17b-a16e), and the expert-batched GEMMs
     (``check_expert_gemms``, one launch a projection, the expert index
     in the grid): mixtral's E = 8 at M = 8 and 80 (8 slots x capacity
     10), 6144 x 16384 and 16384 x 6144, llama4's E = 16 at M = 8 and 16,
     5120 x 8192 and 8192 x 5120, and the routers (N = 8, 16) at M = 8
     and 256 — W8A8 and the quantize-in fold bit-equal to their plain
     versions, W8A16 within ``W8A16_TOL``, each timed beside its bound, a
     loop over the experts (the plain version) and a yardstick that is
     not the same function (a loop of ``torch._int_mm``; ``torch.bmm``
     over the bf16-dequantized weights). Then every GEMM of phase 11's
     path (``family_gemms``, derived from the layers phase 11 runs):
     mamba2's in_proj (N = 10576, a partial last N tile) and out_proj,
     zamba2's in_proj (N = 10448) and its shared block's q/k/v/o, gate/up
     and down at M = 8 and 1024, whisper's projections at M = 8 and 1024
     (decoder) and 12,000 (encoder, K = 384 and 1536), as the new shapes
     above (W8A8 and the fold bit-equal, the fold's refusals logged, W8A16
     within ``W8A16_TOL``), and quantize_act at every input phase 11
     quantizes with it (``family_quantize``, up to 12,000 rows)
     bit-equal; each timed in the rows' format.
  3. reference — for each serving recipe, the paper's Fig. 4 recipes
     (``dfq-int8``, ``naive-int8``, ``cle-only``) and the bias-corrected
     w8a8 deployment (``BC_DEPLOY``), ``repro_torch.quantize`` of a
     smoke-size qwen2 (seeded weights that need every rewrite) on the card
     against the same call on the CPU, on the same calibration tokens:
     payloads, scales and weight leaves bit-equal, E[x] within
     ``STAT_TOL``, each corrected bias within ``correction_bounds`` (``bo``
     also within its absorption's matrix-product rounding bound); then
     that model on the card against the CPU's (plain versions):
     teacher-forced logits within tolerance. Then the JAX integration
     test's gate on the card: on those weights dfq-int8's logits SQNR
     above naive-int8's by 10 dB, greedy agreement above 0.9. Then the fp
     KV cache: serve-w8a16 and serve-w8a8 the same way over it; and
     ``repro_torch.serve`` at smoke size, fast (graphs) and stepwise on
     the card against the CPU, for serve-w8a16 and serve-w8a8 over the fp
     cache, ``--quantize none`` and each other dense arch under
     serve-w8a16-kv8 — fast equal to stepwise, launch counts exact, every
     request's first token the CPU's, and the same quantized weights'
     teacher-forced prefill and decode logits on the card within tolerance
     of the CPU's; and ``backend="torch"`` on the
     card: the CPU's tokens and ticks, no kernel launched. Then the MoE
     archs at smoke size (``check_moe_smoke``: mixtral with its 16-position
     window, llama4 with its shared expert): quantize on the card
     bit-equal to the CPU's under serve-w8a16-kv8 and serve-w8a8-kv8, each
     model teacher-forced past the window on both decode routes
     (fused_decode, kv_attention) within tolerance of the CPU, and served
     (serve-w8a16 over the fp cache, serve-w8a8-kv8) fast = stepwise,
     launch counts exact (the router and one launch an expert
     projection), every token the CPU's.
  4. serve — qwen2-0.5b at full width (24 layers, seeded random weights
     through ``repro_torch.quantize``: norm folding, CLE and bias
     absorption on the card, then the int8 pack), the engine with 8 slots,
     max_len 512, prefill chunks of 32, 16 requests of 32-256 prompt
     tokens and 32 new tokens each. The fast path (the default: batched
     prefill, decode horizons of up to 8 steps, each dispatch a replayed
     CUDA graph, every graph captured by ``warmup`` before the timed
     loop) five times: ``repro_torch.serve`` under ``serve-w8a16-kv8``
     (the default) and ``serve-w8a8-kv8``, both again with
     ``REPRO_FUSED_DECODE=0`` (which must serve the fused runs' tokens,
     request by request), and ``serve-w8a8-kv8`` with the V bias
     correction (``kv_bias_correct``, a ``repro_torch.ServingEngine`` over
     the replaced config, ``engine.warmup()``). The stepwise path
     (``reference=True``) once for each recipe and for the V bias
     correction: each fast run must serve its stepwise run's tokens and
     finish ticks, request by request. Every request must finish with 32
     tokens and finite logits. The launch counts are reset just before
     each run and read just after, and each kernel must have launched
     exactly as often as the path's layers and forwards give
     (``expected_launches`` of the run's decode steps and prefill
     dispatches, its warmup's included: a replay counts the launches its
     graph holds; as ``gemm_plan`` folds: no quantize_act at a W8A8 decode
     step), every other kernel never. Each run logs its path, decode
     dispatches and mean horizon, host syncs a token, and for the fast
     path the graphs' capture seconds and pool memory; tok/s fast beside
     stepwise. One more, untimed fast run of the default recipe under
     ``torch.profiler`` logs the device busy share of the loop.
  5. DFQ at full width — qwen2-0.5b with ``hostile_params`` drawn on the
     card, through ``repro_torch.quantize`` under naive-int8, cle-only,
     fold → CLE → absorb → weight_quant (no correction) and dfq-int8: each
     stage's seconds, the sites bias_correct corrected, the per-site weight
     SQNR, logits SQNR and greedy agreement against fp on tokens of
     another seed than the calibration's, and the output mean error at
     every captured statistic without and with the correction; dfq-int8's
     SQNR must be above naive-int8's (the other orderings are logged).
     Then the bias-corrected w8a8 deployment of those weights is saved
     (``QuantizedModel.save`` under ``build/``, removed afterwards),
     loaded (every leaf bit-equal) and served by
     ``repro_torch.serve(ServeConfig(load=...))`` on phase 4's trace, fast
     and stepwise: every request finishes, the same tokens and ticks, the
     exact launch counts; its tok/s beside phase 4's serve-w8a8-kv8.
  6. serve mistral-nemo-12b — at full width (d_model 5120, 32 q / 8 kv
     heads of 128, d_ff 14336, vocab 131072, bf16), at ``NEMO_LAYERS`` of
     its 40 layers (fewer where that would not leave 8 GiB of the card
     free while ``repro_torch.quantize`` runs: the peak measured at 2 and
     4 layers, extrapolated; the depth is logged), through ``repro_torch.serve`` on phase 4's trace:
     serve-w8a16 over the bf16 KV cache (the reference's default
     deployment) and serve-w8a8-kv8, each stepwise and fast (graphs
     captured by warmup): fast tokens and ticks equal stepwise, launch
     counts exact as ``gemm_plan`` plans them, tok/s, quantize and warmup
     seconds and peak memory logged beside the card's name and power
     limit, and the phase's wall seconds.
  7. the paper's CNN flow — no Pallas kernel lies on it, so no kernel row.
     7a: the JAX reference's recipe (``benchmarks/_cnn_pipeline.py``) on
     the repo's mobilenet_v2 config: ``MobileNetCNN.init(0)``, 300 AdamW
     steps at batch 128 on ``synthetic_image_batch`` (drawn on the host by
     4 threads), fold, the hostile rescale; then the rows of the paper's
     Tables 1 and 2 (``benchmarks.tables``: original, ReLU6 → ReLU, CLE,
     + absorption, per-channel, bias correction alone, clip@15 with and
     without it, full DFQ), 8-bit weights and data-free 8-bit activations
     on 6 held-out batches of 256, each beside the JAX reference's CPU
     number. Gates: the loss finite and falling, CLE's fp32 top-1 within
     0.2 points of the ReLU model's, full DFQ int8 at least the ReLU fp32
     top-1 − 5 and the original int8 + 30. 7b: MobileNetV2's published
     widths at 224 (``MOBILENET_V2_224``: no 1280 conv, ReLU), random
     weights with log-normal BN γ and normal β, running statistics from 30
     train-mode forwards at batch 32, folded and made hostile; fold, CLE,
     absorption, 8-bit weights and analytic correction on the card equal
     to the CPU's leaf by leaf (bit-equal, sums within ``CNN_SUM_TOL``);
     fp32 logits card against CPU within ``CNN_FWD_TOL`` and a TF32
     forward outside it; the fp32 logits after CLE within ``CNN_CLE_TOL``
     and after absorption within ``CNN_ABSORB_TOL`` of the hostile
     model's; full DFQ's logits SQNR above original int8's. Logged: the
     SQNRs, Fig. 2's depthwise range spread, each stage's seconds,
     images/s of the folded forward at batch 64 and 256 with and without
     activation fake-quant, and peak memory, beside the card's name and
     power limit.
  8. the paged pool — qwen2-0.5b at full width on phase 4's settings with
     pages of 32 positions (``PAGED``). 8a: ``repro_torch.serve`` under
     serve-w8a16 over the bf16 KV cache (the default deployment) and
     serve-w8a8-kv8, each fast after warmup contiguous then paged, and
     paged stepwise, and serve-w8a8-kv8 paged fast with
     REPRO_FUSED_DECODE=0 (kv_attention over the dense view): every
     request's tokens and finish tick the contiguous run's (and phase 4's
     for serve-w8a8-kv8), launches exact; tok/s paged beside contiguous,
     the page pool's and the dense view's bytes. Then ``ServingEngine``s over
     one serve-w8a16 model: 8b a trace of 16 requests sharing a 192-token
     prefix, reuse on and off — the same tokens, no request later with
     reuse on, prefix hits, fewer prefill chunks, ``cow_copies`` logged;
     8c a pool of half the full capacity under two priority classes —
     preemptions, each resumed, every request ok with the full pool's
     tokens; 8e phase 4's trace with deadlines — fast and stepwise expire
     the same requests at the same ticks with the same tokens; each run's
     launches exact. 8d ``run_chaos`` under ``FaultPlan.seeded`` at the
     chaos CLI's settings (a smoke model under serve-w8a16, weights drawn
     on the host) on the card and on the CPU: the pool audited after
     every step, 0 leaked pages, the unfaulted requests the card's
     fault-free tokens, outcomes, counts and steps the CPU's, launches
     exact. Last, the dense view's memory and the device time of the
     gather and of a horizon's commit (each in a CUDA graph) for both
     caches beside the bytes bound, and the phase's wall seconds.
  9. serve mixtral-8x22b — at full width (d_model 6144, 48 q / 8 kv heads
     of 128, d_ff 16384, 8 experts top-2 at capacity factor 1.25, window
     4096, vocab 32768, bf16) at every layer that leaves 8 GiB free while
     ``repro_torch.quantize`` runs (the peak measured at 1 and 2 layers,
     extrapolated; the depth is logged), through ``repro_torch.serve`` on
     phase 4's trace under serve-w8a16 over the bf16 KV cache and
     serve-w8a8-kv8, each stepwise and fast: fast tokens and ticks equal
     stepwise, every request finished, launch counts exact (each expert
     projection one expert-batched launch); tok/s, quantize and warmup
     seconds, peak memory, the expert choices dropped for capacity at
     prefill (the prompts replayed one by one), the card's name and power
     limit and the phase's wall seconds. Its fast runs give the kernels
     JSON line's expert-batched rows their launches.
  10. the async front-end — ``repro_torch.serving.AsyncServer`` (circuit
     breaker, shedding ladder), ``AsyncClient`` (retries with seeded
     jittered backoff) and ``run_open_loop`` over qwen2-0.5b at full width
     on phase 4's engine settings (serve-w8a16 over the bf16 KV cache,
     the fast path, every graph captured by warmup). 10a: 16 requests in
     two priority classes offered at 0.25 a tick, no queue bound, against
     ``engine.run`` of the same requests: every outcome ok, each rid's
     tokens equal, token ticks in order; tok/s of both. 10b:
     ``repro_torch.serve(ServeConfig(serve_async=True, ...))`` — 48
     requests at 2.0 a tick from the paged pool (pages of 32) behind a
     4-deep queue, a 48-tick client timeout, shedding from queue pressure
     0.5: requests shed and the breaker opened, every outcome terminal, no
     page leaked; goodput, TTFT and per-token p50/p99 in ticks, mean
     attempts and the wall seconds logged. 10c: 10b again, every outcome
     (status, tokens, attempts, token ticks), the server's counters and the
     SLO summary identical. Each run's launches exact
     (``expected_launches``, warmup's included).
  11. the SSM, hybrid and encoder-decoder families — first each at smoke
     size on host-drawn weights (``check_family_smoke``): under serve-w8a16
     and serve-w8a8 ``repro_torch.quantize`` on the card equal to the
     CPU's leaf by leaf (a LayerNorm shift folded through a weight and an
     absorbed value bias within ``FAMILY_SUM_TOL``), prefill 8 + 16 decode
     steps within ``teacher_forced``'s bound of the CPU. Then at every
     published width: mamba2-2.7b and zamba2-2.7b at ``FAMILY_MOST``'s
     depth (16 of 64 and 12 of 54 layers; ``cut_depth`` checks they fit),
     whisper-tiny whole
     (4 + 4 layers, 1500 frames from ``prng.normal``), each quantized on
     the card under serve-w8a16 and serve-w8a8 and run through
     ``warm_cache`` (whisper), ``model.prefill`` of 8 x 128 tokens and 32
     greedy ``decode_step``s: launches exact (``family_launches`` of the
     layers: in_proj / out_proj, the shared blocks, the encoder and the
     cross keys and values), the decode logits no farther from the float32
     teacher-forced forward than ``FAMILY_TF_FACTOR`` times the bf16 one;
     then the same prefill and decode steps at ``backend="torch"`` fed the
     kernel run's tokens: no launch, and the kernels' logits bit for bit
     under W8A8, within ``FAMILY_TF_FACTOR`` times the bf16 forward's
     distance under W8A16. Logged: quantize seconds and
     peak memory, warm_cache and prefill ms, decode tok/s. No decode
     attention kernel runs: zamba2's shared attention (head_dim 80) and
     whisper's self attention read fp caches, as in the reference.
  12. training — 12a: ``repro_torch.launch.train.main`` on qwen2-0.5b at
     full width (24 layers, d 896, vocab 151,936, tied embeddings, bf16
     compute over float32 params, remat on), ``TRAIN``'s batch, sequence
     and steps, checkpoints in a directory under ``build/`` removed after:
     median and p90 step ms (the first step apart), train tokens/s, ``mfu``
     (6·N·tokens over the step time over the bf16 peak ``bound_ms`` uses,
     N ``cfg.param_count()``), peak device memory, the mean loss of the
     first 10 steps against the last 10 (it must fall), straggler events
     and retries; then ``TRAIN_PROFILED`` more steps under
     ``torch.profiler`` (the device busy share, the leading kernels). 12b:
     the fault path at full width and ``TRAIN_FAULT``'s cut depth under
     ``torch.use_deterministic_algorithms(True)`` (with
     ``CUBLAS_WORKSPACE_CONFIG`` set for 12b only): an uninterrupted run, a
     run with a failure injected past the first checkpoint (the loop
     restores and replays), and a preempted run (its checkpoint bit-equal
     to the state the loop held) resumed with ``--resume`` in a fresh
     loop: both end bit-equal to the uninterrupted run. 12c: 12a's trained
     weights through ``repro_torch.quantize`` under dfq-int8, serve-w8a16,
     naive-int8 and serve-w8a8-kv8 — logits SQNR and greedy agreement
     against the trained float model on ``calibration_tokens(5, 4, 64,
     vocab)`` and the loss on a held-out batch of the training stream,
     logged (which recipe keeps more is a finding, not a gate) — then
     served (``TRAINED_SERVE``'s 8 requests, fast path, graphs captured by
     warmup) under serve-w8a16 over the bf16 KV cache and serve-w8a8-kv8:
     launches exact (``expected_launches``), and again at
     ``backend="torch"``: no launch, every request finished.
  13. tensor-parallel serving — phase 2 first holds every per-rank kernel
     shape of qwen2-0.5b over a model axis of 2 (``check_tp_shapes``: the
     cut column GEMMs, the epilogue-free int32 W8A8 GEMM at the cut and the
     whole K, bit-equal to its plain version and through ``w8a8_epilogue``
     to qmatmul_w8a8, the W8A16 float32 partials, head-local fused_decode
     and kv_attention, quantize_act of the gathered rows). 13a / 13b: two
     ranks spawned on the one card (``tp_rank``; gloo, named explicitly:
     NCCL refuses two ranks on one device) serve phase 4's trace under
     serve-w8a8-kv8-tp and serve-w8a16-kv8-tp over 1x2 and 2x1 meshes,
     fast (eager: gloo's collectives cannot be captured) and stepwise, at
     full width cut to ``TP_LAYERS`` layers (the depth logged): every
     request's tokens and finish tick equal one device's at that depth
     (fast and stepwise, ``serve_cut``), each rank's
     launches exact (``tp_expected_launches``); after each fast 1x2 run,
     the teacher-forced logits of every request (``tp_teacher_forced``,
     ``tp_teacher_gate``): in float32 within ``TP_F32_TOL`` of one device
     on every sequence with one device's MoE choices, a planted dropped
     partial past it; W8A8 bit-equal to one device in bf16; W8A16
     (float32 partials summed in another order), where its choices are
     one device's, no farther from one device than twice the bf16
     forward's own distance from float32, its argmax moved only at
     near-ties, its tokens counted against one device's. 13c: a 1x1 NCCL mesh
     in this process, the fast path with its CUDA graphs capturing the
     mesh's collectives (warmup): phase 4's tokens, launches exact, tok/s
     beside phase 4's. 13d: ``repro_torch.serve(ServeConfig(mesh=(1, 2),
     mesh_backend="gloo", save=...))`` and ``--load`` of that artifact over
     its recorded mesh: the same tokens, each rank's launches exact.
  14. the MoE family and the async front-end over a mesh — phase 2 first
     holds every per-rank expert GEMM (``check_moe_tp_shapes``: the
     expert-batched int32 W8A8 GEMM at mixtral's and llama4's row-parallel
     expert down — one launch, bit-equal to its plain version and through
     ``w8a8_epilogue`` to the expert-batched qmatmul_w8a8 —, W8A16's
     float32 partials of mixtral's and llama4's expert down at 1x2 within
     W8A16_TOL, and the cut expert gate/up, W8A8 and W8A16). 14a:
     mixtral-8x22b at full width and ``MOE_TP_LAYERS`` layers (checked
     against what two ranks on the card hold), quantized once under serve-w8a8-kv8-tp
     and serve-w8a16-tp and saved; one device serves ``MOE_TP``'s trace
     (phase 4's, cut to ``MOE_TP_TRACE`` requests) fast and stepwise; a
     W8A8 prefill chunk of 8 slots bit-equal to its two halves' (the batch a
     rank of a data axis of 2 prefills), timed as the model runs it (a KV
     head's group a call) and as one call over every head
     (``prefill_rows_check``; 14d the same for qwen2); two ranks spawned on
     the one card (``moe_tp_rank``, gloo) load each artifact and serve it
     over 1x2 and 2x1, fast (eager) and stepwise: W8A8 every request's
     tokens, admission and finish ticks the one device's, W8A16 the same
     at 2x1 and at 1x2 the same or a move the teacher-forced gate
     (``tp_teacher_gate``, run after W8A16's fast 1x2 run in any case)
     shows is rounding;
     after each fast run layer 0's MoE block on the same activations,
     sharded against one device (``moe_block_gap``): router logits
     bit-equal, drops equal, the output W8A8 bit-equal and W8A16 within
     ``MOE_BLOCK_TOL`` of max |y|; each rank's launches exact (``moe_tp_expected_launches``), its peak
     memory and the choices dropped logged. 14b: the W8A8 artifact over a
     1x1 NCCL mesh under CUDA graphs: the one device's tokens and ticks.
     14c: llama4-scout at smoke size over 1x2, W8A8 (its float shared
     expert cut over "model"): the one device's tokens. 14d:
     ``repro_torch.serve(ServeConfig(serve_async=True, mesh=(1, 2)))`` of
     qwen2-0.5b's serve-w8a8-kv8-tp artifact on phase 10a's and 10b's
     traces (cut: ``ASYNC_TP_TRACES``): every outcome, the server's
     counters and the SLO summary equal the one device's, each rank's
     launches exact.
  15. training over a mesh (no kernel of the port on the path: the
     reference's training runs no Pallas kernel either) — ``make_train_step``
     under ``configure_sharding_hints``, every rank drawing the same whole
     init and keeping its blocks, three steps of phase 12's batches.
     15a: qwen2-0.5b at full width, ``TRAIN_MESH_LAYERS`` of 24 layers,
     over 2x1 (FSDP) and 1x2 (TP, head-parallel: 7 of 14 q heads, 1 of 2
     KV heads a rank), two gloo ranks spawned on the one card
     (``train_mesh_rank``), in float32 and in the config's bf16 compute:
     losses and grad norms against one device's at that depth within
     ``TRAIN_MESH_TOL`` of the dtype, each rank's resident params and
     moments equal to the planner's block bytes, its peak memory and step
     ms. 15b: a 1x1 NCCL mesh at 24 layers in this process, deterministic
     algorithms: losses, grad norms, params and moments bit-equal to one
     device's. 15c: ``launch.train.main`` in the ranks' group at
     ``TRAIN_ELASTIC``'s depth — an uninterrupted 2x1 run, a failure
     injected on every rank and replayed (bit-equal to it), and the
     uninterrupted run's checkpoint resumed by ``elastic_restore`` onto 1x2
     (in the ranks) and onto one device (here), each to the end within
     ``ELASTIC_TOL`` of the uninterrupted run's own update from the
     checkpoint, and a resume from it with its AdamW moments zeroed (here)
     outside that gate. 15d: mixtral-8x22b at full width, 1 of 56 layers, over
     1x2, two steps donating the state (AdamW in place), beside one device
     at that depth after the ranks end: losses and grad norms within
     ``TRAIN_MESH_TOL``'s bf16 gate, each rank's blocks and peak. Every
     gate is logged before the phase fails on one.
  16. the dry-run (``repro_torch.launch.dryrun``) — 16a: the stated
     subset ``DRYRUN_CELLS`` of the registry's cells at the 16x16 mesh,
     each in a process of its own over a fake world of 256 on this host's
     torch, and ``dry_run`` of 16b's cells on a 1x1 mesh in one more,
     all started after phase 1 at the lowest CPU priority (they trace on
     the host's idle cores while phases 2-15 run) and collected here: ok,
     no CUDA touched; their dominant term, bound, ``fits_hbm`` and
     seconds. Then 16b, alone on the host: qwen2-0.5b at full width on one
     device — a decode step at phase 4's shape (W8A16 over the bf16 cache,
     W8A8 over the int8 cache; the cache filled to 480 of 512 positions by
     a prefill) and phase 12a's train step (8 x 256, donated) — its time,
     resident bytes and peak, every kernel launch of the decode runs
     counted, held to the dry-run's prediction: the step's time at least
     the roofline's bound, the card's resident argument bytes the
     dry-run's plus the caching allocator's rounding, the first step's
     peak above them within ``TEMP_BAND`` of the dry-run's temp bytes.
  17. the graph linter (``repro_torch.analysis.lint``) — 17a: ``python -m
     repro_torch.analysis.lint --check --report`` in a process started
     after phase 1 at the lowest CPU priority (no card visible to it),
     collected here: the eight committed contracts hold on this host's
     torch, 0 errors, no CUDA touched. 17b, run inside phase 4 where its
     engines live (no new ``quantize``): ``lint_engine`` at the cuda tier
     on a fresh engine over each fast fused run's weights (w8a16-kv8,
     w8a8-kv8: before warmup) and on the run's own engine (after warmup
     and its 16 requests): 0 errors; each recorded path's kernel nodes
     equal the launches the wrappers counted in it, and one masked decode
     step's are ``expected_launches`` of one step (W8A16 168 +
     fused_decode 24; W8A8 72 quantize-in + 96 + 24); the pool's
     addresses, bytes and bookkeeping unchanged; the captured graphs
     exactly ``warmup_shapes()`` (none before warmup). 17c: an eager
     ``.to(bfloat16)`` of layer 0's int8 K cache planted in the decode
     path is reported by ``dtype-ledger`` on the live card graph, on both
     decode paths.

The line before the last is the kernel table as one JSON object; the last
line is the device record. Each phase's start, in the script's seconds, also
goes to stderr. Exits non-zero with no result when torch sees no
CUDA device, or when the port's sources are not beside this script.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 and bf16
# tensor-core operations/s, float32 (CUDA-core) operations/s: keys of the
# port's ``analysis.roofline.HW_H100``, the dry-run's constants too, so
# the two cannot drift apart
HBM_BYTES_S, INT8_OPS_S, BF16_OPS_S, F32_OPS_S = (
    "hbm_bw", "peak_flops_int8", "peak_flops_bf16", "peak_flops_f32")


def hw_peak(key: str) -> float:
    """``HW_H100[key]`` (the port importable: ``main`` puts ``src`` on the
    path)."""
    from repro_torch.analysis.roofline import HW_H100

    return HW_H100[key]


# fused_decode's ``out`` against its plain version (expf and the order of the
# sums differ, so the float32 results are ~1e-7 apart): float32 within
# T = atol 1e-6 + rtol 1e-5; bfloat16 within T plus one bf16 ulp of
# |reference| + T, since two float32 values that close can round to
# neighbouring bf16 values. (One bf16 ulp alone does not hold near zero,
# where two float32 values within T may lie more than a bf16 ulp apart.)
OUT_TOL = {"float32": "T = atol 1e-6 + rtol 1e-5",
           "bfloat16": "T + 1 bf16 ulp"}

# qmatmul_w8a16 against its plain version: the kernel sums a·q in float32
# and scales after the sum; the plain version rounds q·s first and sums
# a·(q·s). Both are float32 sums of the same K products, rounded in other
# orders, and such rounding errors add like a random walk: about
# sqrt(K) · 2^-24 · ||a_m ⊙ w_n||, the products' 2-norm being
# sqrt(a² @ w_deq²). The float32 tolerance is 16 times that, plus the
# epilogue's roundings of the scale and the bias:
#   E = 16 · sqrt(K) · 2^-24 · sqrt(a² @ w_deq²) + 2^-22 · (|y| + |bias|).
# A product with 10-bit mantissas (TF32: about 2^-11 · ||a_m ⊙ w_n||) or
# with a rounded to bf16 lies well outside it, and phase 2 checks that both
# do. The bfloat16 output rounds the two float32 results once more: within
# E plus one bf16 ulp of |y| + E (one ulp alone fails where the sum cancels,
# |y| far below the products' norm).
W8A16_TOL = {"float32": "E = 16 sqrt(K) 2^-24 sqrt(a^2 @ w^2) + 2^-22 (|y|+|b|)",
             "bfloat16": "E + 1 bf16 ulp"}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def phase(t_script: float, title: str) -> float:
    """Log phase ``title``'s header, and on stderr the script's seconds so
    far (the last lines a run stopped at its time limit shows); returns the
    phase's start."""
    log(f"== phase {title}")
    print(f"chip_smoke: phase {title.split(':')[0]} starts at "
          f"{time.perf_counter() - t_script:.1f} s", file=sys.stderr,
          flush=True)
    return time.perf_counter()


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one back-to-back call of ``fn`` in ms, between CUDA
    events: the Python wrapper's host time included, which is what a caller
    pays when the card runs faster than the host enqueues."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms. The card is first held
    busy by ``torch.cuda._sleep`` while the host enqueues all ``iters``
    calls, so the CUDA events around them time the calls back to back on
    the device, without the host's per-call cost. The sleep is doubled until
    it outlasts the enqueue."""
    import time

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        sleep_ms = _sleep_ms(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < sleep_ms:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("the host could not enqueue ahead of the card")


_SLEEP_MS: dict = {}


def _sleep_ms(cycles: int) -> float:
    """How long ``torch.cuda._sleep(cycles)`` holds the card, in ms."""
    import torch

    if cycles not in _SLEEP_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_MS[cycles] = start.elapsed_time(end)
    return _SLEEP_MS[cycles]


def bound_ms(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / hw_peak(HBM_BYTES_S) * 1e3
    t_ops = ops / hw_peak(ops_rate) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# weight copies a cold timing rotates over: 2.5 times the H100's 50 MB L2
COLD_BYTES = 128 << 20


def cold_ms(torch, call, w, iters: int = 50) -> float:
    """``device_ms`` of ``call(w_i)`` rotating over copies of the K-major
    int8 weight ``w`` ([K, N] view of [N, K] storage) that together hold at
    least ``COLD_BYTES``: each call reads a weight that ~128 MB of other
    weights were read after, as the serving path reads 358 MB of weights a
    decode step, so it comes from HBM and not from the L2."""
    import itertools

    K, N = w.shape
    n = -(-COLD_BYTES // (K * N))
    copies = w.t().unsqueeze(0).expand(n, N, K).contiguous()
    views = [copies[i].t() for i in range(n)]
    turn = itertools.count()
    ms = device_ms(lambda: call(views[next(turn) % n]), iters)
    del views, copies
    return ms


# --------------------------------------------------------------- phase 2
def check_quantize_act(torch, dev, gen):
    """The standalone kernel at the serving shapes (timed), a ragged K (the
    element-wise loader) and a row too long for the registers (the re-read
    loop), with .5 ties and a row of near-ties: bit-equal to the plain
    version at 8 bits and at bits 2, 4 and 6.
    Each timed row carries the launch floor: the device time of a
    one-element ``fill_`` in the same phase."""
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    one = torch.zeros((1,), device=dev)
    floor = device_ms(lambda: one.fill_(1.0), 100)
    timed = ((8, 896), (8, 4864), (64, 896), (256, 896), (256, 4864))
    rows = []
    for M, K in timed + ((13, 77), (8, 4100), (2, 40000)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=gen, device=dev) * 3
            x[0, :7] = torch.tensor([0.5, 1.5, -2.5, 0, 0, 0, 0])  # ties
            x[1] = near_ties(torch, gen, dev, K)            # at scale 1
            x[1, 0] = 127.0
            x = x.to(dtype)
            for bits in (8, 2, 4, 6):
                q, s = quantize_act_cuda(x, bits)
                qr, sr = quantize_act_ref(x, bits)
                torch.cuda.synchronize()
                assert torch.equal(q, qr) and torch.equal(s, sr), (
                    f"quantize_act {M}x{K} {dtype} bits={bits}: not bit-equal "
                    f"to the plain version ({int((q != qr).sum())} payload "
                    f"mismatches)")
            if (M, K) not in timed:
                continue
            e = x.element_size()
            b, by = bound_ms(M * K * e + M * K + 4 * M, 5 * M * K, F32_OPS_S)
            rows.append({
                "shape": f"x[{M},{K}] {str(dtype)[6:]}", "max_abs_err": 0.0,
                "ms": device_ms(lambda: quantize_act_cuda(x), 100),
                "call_ms": call_ms(lambda: quantize_act_cuda(x), 100),
                "plain_ms": device_ms(lambda: quantize_act_ref(x), 20),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "floor_ms": floor})
    log(f"  quantize_act at 8 shapes x bf16/f32 x bits 8/2/4/6 (ragged K=77 "
        f"and 4100, K=40000 past the registers): bit-equal to the plain "
        f"version; launch floor (one-element fill_) {floor * 1e3:.2f} us")
    return rows


def _kmajor_int8(torch, gen, dev, K, N):
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    return w.t()                                   # [K, N], K-major storage


def check_qmatmul(torch, dev, gen):
    from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_cuda
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref

    rows = []
    for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (8, 64, 256):
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            for out_dtype in (torch.bfloat16, torch.float32):
                y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=out_dtype)
                yr = qmatmul_w8a8_ref(a, w, sa, sw, bias, out_dtype)
                torch.cuda.synchronize()
                assert torch.equal(y, yr), (
                    f"qmatmul_w8a8 M={M} K={K} N={N} {out_dtype}: not "
                    f"bit-equal (max |diff| "
                    f"{float((y.float() - yr.float()).abs().max())})")
            # torch._int_mm takes M > 16 only: at decode (M = 8) it runs on
            # the rows zero-padded to 32, the nearest shape it accepts
            a_lib = a if M > 16 else torch.cat(
                [a, a.new_zeros((32 - M, K))])
            lib = device_ms(lambda: torch._int_mm(a_lib, w), 50)
            lib_call = ("torch._int_mm" if M > 16
                        else f"torch._int_mm, M zero-padded {M}->32")
            b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw, bias,
                                             out_dtype=torch.bfloat16)
            row = {
                "shape": f"M={M} K={K} N={N} -> bf16", "mkn": [M, K, N],
                "max_abs_err": 0.0,
                "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                    a, w, sa, sw, bias, torch.bfloat16), 10),
                "bound_ms": b, "bound_by": by, "library_ms": lib,
                "library": lib_call}
            if M == 8:
                # each call's weight from HBM, not from the L2
                row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_cuda(
                    a, wc, sa, sw, bias, out_dtype=torch.bfloat16), w)
                row["library_cold_ms"] = cold_ms(
                    torch, lambda wc: torch._int_mm(a_lib, wc), w)
            rows.append(row)
    return rows


def w8a16_tolerance(torch, a, w_q, w_scale, bias, y_ref):
    """``W8A16_TOL`` elementwise for the plain version's output ``y_ref``."""
    w_deq = w_q.float() * torch.atleast_1d(w_scale).float()[None, :]
    norm = torch.sqrt(a.float().square() @ w_deq.square())
    e = 16 * a.shape[1] ** 0.5 * 2.0 ** -24 * norm + 2.0 ** -22 * (
        y_ref.float().abs() + (0 if bias is None else bias.float().abs()))
    if y_ref.dtype == torch.bfloat16:
        e = e + bf16_ulp(torch, y_ref.float().abs() + e)
    return e


def check_qmatmul_w8a16(torch, dev, gen):
    """The W8A16 GEMM at the serving path's shapes: every projection at
    decode (M = 8) and at a prefill chunk (M = 8 slots x 32 = 256), a
    per-tensor [1] scale, a bias (bq, bk, bv, bo and bd have one), in bf16
    (scale and bias bf16, as the bf16 model casts them) and in float32. In
    float32 two controls must fall outside the tolerance: the plain version
    with TF32 allowed, and with ``a`` rounded to bf16."""
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    rows = []
    for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        w = _kmajor_int8(torch, gen, dev, K, N)
        for M in (8, 256):
            for dtype in (torch.bfloat16, torch.float32):
                a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                sw = (torch.rand((1,), generator=gen, device=dev) * 0.01
                      + 1e-4).to(dtype)
                bias = torch.randn((N,), generator=gen, device=dev).to(dtype)
                y = qmatmul_w8a16_cuda(a, w, sw, bias)
                yr = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
                torch.cuda.synchronize()
                diff = (y.float() - yr.float()).abs()
                tol = w8a16_tolerance(torch, a, w, sw, bias, yr)
                name = str(dtype)[6:]
                worst = int((diff - tol).argmax())
                assert bool((diff <= tol).all()), (
                    f"qmatmul_w8a16 M={M} K={K} N={N} {name}: off the plain "
                    f"version at {int((diff > tol).sum())} values (max |diff| "
                    f"{float(diff.max())}, {W8A16_TOL[name]}; worst: kernel "
                    f"{float(y.flatten()[worst])!r}, plain "
                    f"{float(yr.flatten()[worst])!r}, tolerance "
                    f"{float(tol.flatten()[worst])!r})")
                note = f"max |diff|/tol {float((diff / tol).max()):.3g}"
                if dtype == torch.bfloat16:
                    ulp = bf16_ulp(torch, yr.float())
                    note += (f"; of {diff.numel()}: "
                             f"{int(((diff > 0) & (diff <= ulp)).sum())} one "
                             f"bf16 ulp off, {int((diff > ulp).sum())} more")
                if dtype == torch.float32:
                    # controls: a lower-precision product must fail E
                    torch.backends.cuda.matmul.allow_tf32 = True
                    y_tf32 = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
                    torch.backends.cuda.matmul.allow_tf32 = False
                    y_a16 = qmatmul_w8a16_ref(a.bfloat16(), w, sw, bias, dtype)
                    ctl = [float(((c - yr).abs() / tol).max())
                           for c in (y_tf32, y_a16)]
                    assert min(ctl) > 1, (
                        f"qmatmul_w8a16 M={M} K={K} N={N}: a control passed "
                        f"the float32 tolerance (max |diff|/tol: TF32 "
                        f"{ctl[0]}, a in bf16 {ctl[1]})")
                    note += (f"; controls max |diff|/tol: TF32 {ctl[0]:.3g}, "
                             f"a in bf16 {ctl[1]:.3g}")
                log(f"  qmatmul_w8a16 M={M} K={K} N={N} {name}: max |diff| "
                    f"{float(diff.max()):.3g} ({W8A16_TOL[name]}); {note}")
                e = a.element_size()
                b, by = bound_ms(M * K * e + K * N + e + N * e + M * N * e,
                                 2 * M * K * N,
                                 BF16_OPS_S if dtype == torch.bfloat16
                                 else F32_OPS_S)
                if has_lib:
                    # int8 weight [N, K] and a per-channel scale in a's type
                    wt, s_n = w.t(), sw.expand(N).contiguous()
                    lib_fn = lambda: torch._weight_int8pack_mm(a, wt, s_n)
                    lib_call = "torch._weight_int8pack_mm"
                else:
                    # the weight pre-dequantized to a's type: reads twice
                    # the int8 weight's bytes in bf16
                    w_deq_t = (w.float() * sw.float()).to(dtype).t().contiguous()
                    lib_fn = lambda: torch.nn.functional.linear(a, w_deq_t, bias)
                    lib_call = "F.linear on the pre-dequantized weight"
                kern = lambda: qmatmul_w8a16_cuda(a, w, sw, bias)
                row = {
                    "shape": f"M={M} K={K} N={N} {name}", "mkn": [M, K, N],
                    "max_abs_err": float(diff.max()),
                    "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                    "plain_ms": device_ms(lambda: qmatmul_w8a16_ref(
                        a, w, sw, bias, dtype), 10),
                    "bound_ms": b, "bound_by": by,
                    "library_ms": device_ms(lib_fn, 50), "library": lib_call}
                if M == 8:
                    # each call's weight from HBM, not from the L2
                    row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a16_cuda(
                        a, wc, sw, bias), w)
                    if has_lib:
                        row["library_cold_ms"] = cold_ms(
                            torch, lambda wc: torch._weight_int8pack_mm(
                                a, wc.t(), s_n), w)
                rows.append(row)
    return rows


def bf16_ulp(torch, x):
    """Spacing of bfloat16 numbers at |x| (float32): 2**(e-8) for |x| in
    [2**(e-1), 2**e), the subnormal spacing 2**-133 below 2**-126."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_attention_out(torch, out, outr, what):
    """Hold a decode attention output (fused_decode's or kv_attention's)
    against its plain version within ``OUT_TOL``; return (|diff| [B, Hq·hd],
    a note on the values one bf16 ulp alone would refuse)."""
    B = out.shape[0]
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    diff = (o - r).abs()
    bf16 = out.dtype == torch.bfloat16
    tol = 1e-6 + 1e-5 * r.abs()
    if bf16:
        tol = tol + bf16_ulp(torch, r.abs() + tol)
    ok = diff <= tol
    worst = int((diff - tol).argmax())
    assert bool(ok.all()), (
        f"{what}: out off at {int((~ok).sum())} values (max |diff| "
        f"{float(diff.max())}; worst at row {worst // o.shape[1]} col "
        f"{worst % o.shape[1]}: kernel {float(o.flatten()[worst])!r}, plain "
        f"{float(r.flatten()[worst])!r}, tolerance {float(tol.flatten()[worst])!r})")
    past = ""
    if bf16:
        # the elements one bf16 ulp alone would not admit, and the worst one
        ulp = bf16_ulp(torch, r)
        over = diff > ulp
        if bool(over.any()):
            i = int(torch.where(over, diff - ulp, -1.0).argmax())
            past = (f"; beyond one bf16 ulp at {int(over.sum())} of "
                    f"{diff.numel()}, all at |plain| <= "
                    f"{float(r.abs()[over].max()):.3g} (worst: kernel "
                    f"{float(o.flatten()[i])!r}, plain {float(r.flatten()[i])!r}"
                    f", one ulp {float(ulp.flatten()[i])!r}, T + ulp "
                    f"{float(tol.flatten()[i])!r})")
        else:
            past = "; within one bf16 ulp everywhere"
    return diff, past


def check_fused_out(torch, out, outr, oq, os_, oqr, osr, what):
    """Hold fused_decode's ``out`` and its quantize-out epilogue against the
    plain version's; return (max |out diff|, a summary)."""
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    B = out.shape[0]
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    bf16 = out.dtype == torch.bfloat16
    diff, past = check_attention_out(torch, out, outr, what)
    # the epilogue quantizes the cast output (not the float32 accumulator)
    # with the quantize_act formula: bit-equal to that on the kernel's out
    qs, ss = quantize_act_ref(o)
    assert torch.equal(oq, qs) and torch.equal(os_, ss), (
        f"{what}: quantize-out is not quantize_act of the cast output")
    # against the reference: a row whose out is bit-equal quantizes
    # bit-equal; elsewhere the scale moves by at most the row's out error
    # / 127 (+1 ulp for the division), and an int8 value only at a rounding
    # tie of the reference (|x/scale| within 1e-3 of .5) or, in bf16, where
    # that element of out itself moved
    same = (diff == 0).all(1)
    assert torch.equal(oq[same], oqr[same]) and torch.equal(
        os_[same], osr[same]), f"{what}: quantize-out of a bit-equal row differs"
    assert bool(((os_ - osr).abs()
                 <= diff.amax(1) / 127 + osr * 2.0 ** -23).all()), (
        f"{what}: quantize-out scale off")
    dq = (oq.int() - oqr.int()).abs()
    tie = ((r / osr[:, None]).abs() % 1.0 - 0.5).abs() < 1e-3
    allowed = tie | (diff > 0) if bf16 else tie
    assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~allowed).any()), (
        f"{what}: quantize-out int8 differs away from a rounding tie")
    return float(diff.max()), (
        f"out bit-equal in {int(same.sum())}/{B} rows; quantize-out bit-equal "
        f"to quantize_act of the kernel's out; int8 off by 1 at "
        f"{int((dq > 0).sum())} of {dq.numel()} (at ties "
        f"{int(((dq > 0) & tie).sum())}){past}")


def sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, iters):
    """Device time of ``torch.nn.functional.scaled_dot_product_attention``
    for one query token over a bfloat16 K/V cache of the same shape, its
    GQA heads expanded to Hq (unmasked): a different function — it reads
    2 * Hq / Hkv times the int8 cache's payload bytes — timed as a
    yardstick of an unquantized cache's decode attention on this card,
    never as the library column."""
    key = (B, S, Hq, Hkv, hd)
    if key not in _SDPA_MS:
        F = torch.nn.functional
        G = Hq // Hkv
        q = torch.randn((B, Hq, 1, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, S, hd), generator=gen, device=dev)
                .bfloat16().repeat_interleave(G, dim=1) for _ in range(2))
        _SDPA_MS[key] = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), iters)
        del k, v
    return _SDPA_MS[key]


_SDPA_MS: dict = {}


def check_fused_decode(torch, dev, gen):
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.fused_decode.ref import fused_decode_ref

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kq = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, S, Hkv), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, S, Hkv), generator=gen, device=dev) * 0.02
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[1] = S                                    # a full ring
        idx = lens - 1
        idx[2] = S - 1                                 # write at the ring end
        lens[2] = S
        valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
        valid[3] = False                               # a fully masked row
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kn = (torch.randn((B, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
        vn = torch.randn((B, Hkv, hd), generator=gen, device=dev).to(dtype)
        idx32 = idx.to(torch.int32)

        leaves = [t.clone() for t in (kq, ks, vq, vs)]
        out, oq, os_ = fused_decode_cuda(q, *leaves, kn, vn, idx32, valid,
                                         quantize_out=True)
        ref_leaves = [t.clone() for t in (kq, ks, vq, vs)]
        (outr, oqr, osr), _ = fused_decode_ref(
            q, *ref_leaves, kn[:, None], vn[:, None], idx[:, None],
            valid=valid, out_dtype=dtype, quantize_out=True)
        torch.cuda.synchronize()
        for a, b_, name in zip(leaves, ref_leaves, ("k", "k_scale", "v",
                                                     "v_scale")):
            assert torch.equal(a, b_), f"fused_decode {dtype}: appended {name} differs"
        err, note = check_fused_out(torch, out, outr, oq, os_, oqr, osr,
                                    f"fused_decode {dtype}")
        assert float(out[3].float().abs().max()) == 0.0, "masked row not 0"
        log(f"  fused_decode {str(dtype)[6:]}: out max |diff| {err:.3g} "
            f"({OUT_TOL[str(dtype)[6:]]}); {note}; appended leaves bit-equal")

        n_live = int(valid.sum())
        e = q.element_size()
        bytes_moved = (2 * B * Hq * hd * e + n_live * Hkv * (hd + 4) * 2
                       + B * S + 2 * B * Hkv * hd * (e + 1) + 8 * B * Hkv
                       + B * Hq * hd + 4 * B)
        b, by = bound_ms(bytes_moved, 4 * Hq * n_live * hd, F32_OPS_S)
        run_leaves = [t.clone() for t in (kq, ks, vq, vs)]
        kern = lambda: fused_decode_cuda(q, *run_leaves, kn, vn, idx32, valid,
                                         quantize_out=True)
        # the W8A16 path's call: no quantize-out
        no_q8 = lambda: fused_decode_cuda(q, *run_leaves, kn, vn, idx32, valid)
        rows.append({
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {str(dtype)[6:]}",
            "max_abs_err": err,
            "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
            "plain_ms": device_ms(lambda: fused_decode_ref(
                q, *run_leaves, kn[:, None], vn[:, None], idx[:, None],
                valid=valid, out_dtype=dtype, quantize_out=True), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "no_q8_ms": device_ms(no_q8, 50),
            "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
            "splits": attention_plan.plan(B, S, Hq, Hkv, hd).splits})
    return rows


# (label, B, Hq, Hkv, hd, S, the plain version's blk, a fully masked row)
KV_CASES = (("main decode", 8, 14, 2, 64, 512, 512, True),
            ("S=33 blk=32", 4, 14, 2, 64, 33, 32, True),
            ("S<blk", 4, 14, 2, 64, 100, 512, False),
            ("GQA 4", 4, 8, 2, 64, 300, 512, False),
            # the JAX bench's long context (benchmarks/kernels_bench.py)
            ("long context", 8, 32, 8, 128, 32768, 512, False))


def _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens):
    """Random int8 K/V and scales, the scales zero past each row's length
    (the invalid marker the attention masks on); the live mask [B, S]."""
    live = torch.arange(S, device=dev)[None, :] < lens[:, None]
    leaves = []
    for _ in range(2):
        leaves.append(torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                                    device=dev, dtype=torch.int8))
        leaves.append(torch.rand((B, S, Hkv), generator=gen, device=dev)
                      * 0.02 * live[..., None])
    return leaves, live


def check_kv_attention(torch, dev, gen):
    """The unfused decode attention at every KV_CASES shape, float32 and
    bfloat16, with and without v_err (zero where the scales are, as the
    decode route passes it), within ``OUT_TOL`` of the plain version; a row
    whose scales are all 0 gives exactly 0."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref

    rows = []
    for label, B, Hq, Hkv, hd, S, blk, masked in KV_CASES:
        long = S > 4096
        lens = (torch.full((B,), S, device=dev) if long else
                torch.randint(1, S + 1, (B,), generator=gen, device=dev))
        lens[0] = S
        if masked:
            lens[B - 1] = 0
        (kq, ks, vq, vs), live = _int8_cache(torch, dev, gen, B, S, Hkv, hd,
                                             lens)
        v_err = (torch.randn((B, S, Hkv), generator=gen, device=dev) * 1e-3
                 * live[..., None])
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
            for ve in (None, v_err):
                out = kv_attention_cuda(q, kq, ks, vq, vs, ve)
                ref = kv_attention_ref(q, kq, ks, vq, vs, dtype, blk=blk,
                                       v_err=ve)
                torch.cuda.synchronize()
                name = str(dtype)[6:]
                what = (f"kv_attention {label} B={B} Hq={Hq} Hkv={Hkv} "
                        f"hd={hd} S={S} {name}" + (" v_err" if ve is not None
                                                   else ""))
                diff, past = check_attention_out(torch, out, ref, what)
                if masked:
                    assert float(out[B - 1].float().abs().max()) == 0.0, (
                        f"{what}: the fully masked row is not 0")
                log(f"  {what} (plain blk={blk}): max |diff| "
                    f"{float(diff.max()):.3g} ({OUT_TOL[name]}){past}"
                    + ("; masked row exactly 0" if masked else ""))
                if label not in ("main decode", "long context"):
                    continue
                n_live = int(live.sum())
                e = q.element_size()
                bytes_moved = (2 * B * Hq * hd * e + B * S * Hkv * 4
                               + n_live * Hkv * (2 * hd + 4)
                               + (n_live * Hkv * 4 if ve is not None else 0))
                b, by = bound_ms(bytes_moved, 4 * Hq * n_live * hd,
                                 F32_OPS_S)
                iters = 5 if long else 50
                kern = (lambda q=q, ve=ve:
                        kv_attention_cuda(q, kq, ks, vq, vs, ve))
                plain = (lambda q=q, ve=ve: kv_attention_ref(
                    q, kq, ks, vq, vs, dtype, blk=blk, v_err=ve))
                rows.append({
                    "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name}"
                             + (" v_err" if ve is not None else ""),
                    "max_abs_err": float(diff.max()),
                    "ms": device_ms(kern, iters),
                    "call_ms": call_ms(kern, iters),
                    # at the long context the plain version's ~1,300
                    # launches a call fill the launch queue behind the
                    # sleep of device_ms: time it back to back instead
                    "plain_ms": (call_ms(plain, 2, warmup=1) if long
                                 else device_ms(plain, 5)),
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd,
                                       iters),
                    "splits": attention_plan.plan(B, S, Hq, Hkv, hd,
                                                  ve is not None).splits})
    return rows


def check_fused_equals_unfused(torch, dev, gen):
    """fused_decode against the unfused composition (append_quantize, the
    kv_attention kernel, the quantize_act kernel) at the main decode shape:
    the shared attention body gives the same bits — out, quantize-out and
    the appended cache."""
    from repro_torch.kernels.fused_decode.ops import fused_decode
    from repro_torch.kernels.kv_attention.ops import kv_attention_decode
    from repro_torch.kernels.quantize_act.ops import quantize_act

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    for dtype in (torch.float32, torch.bfloat16):
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[1] = S
        leaves, valid = _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens)
        valid[3] = False                              # a fully masked row
        idx = (lens - 1)[:, None]
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kn = (torch.randn((B, 1, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
        vn = torch.randn((B, 1, Hkv, hd), generator=gen, device=dev).to(dtype)
        fused = [t.clone() for t in leaves]
        comp = [t.clone() for t in leaves]
        (out, oq, os_), _ = fused_decode(q, *fused, kn, vn, idx, valid=valid,
                                         out_dtype=dtype, quantize_out=True)
        outc, _ = kv_attention_decode(q, *comp, kn, vn, idx, valid=valid,
                                      out_dtype=dtype)
        oqc, osc = quantize_act(outc.reshape(B, -1))
        torch.cuda.synchronize()
        for a, b_, name in zip(fused, comp, ("k", "k_scale", "v", "v_scale")):
            assert torch.equal(a, b_), f"fused vs unfused {dtype}: {name} differs"
        assert torch.equal(out, outc), (
            f"fused vs unfused {dtype}: out differs at "
            f"{int((out != outc).sum())} values")
        assert torch.equal(oq, oqc) and torch.equal(os_, osc), (
            f"fused vs unfused {dtype}: quantize-out differs")
        assert float(out[3].float().abs().max()) == 0.0
        log(f"  fused_decode vs append_quantize + kv_attention + quantize_act, "
            f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {str(dtype)[6:]}: out, "
            f"quantize-out and the appended cache bit-equal")


def _decode_inputs(torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens):
    """A decode step's operands: the int8 cache (scales zero past each
    row's length), the live mask (also each row's new position), q, the
    new token's K/V and its ring offset (the last live position; 0 in a
    row of length 0, where the mask hides it)."""
    leaves, valid = _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens)
    idx = (lens - 1).clamp_min(0)
    valid[torch.arange(B, device=dev), idx] |= lens > 0
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
    kn = (torch.randn((B, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
    vn = torch.randn((B, Hkv, hd), generator=gen, device=dev).to(dtype)
    return leaves, valid, q, kn, vn, idx


# the attention split sweep's shapes: the serving decode step and the JAX
# bench's long context (B, Hq, Hkv, hd, S)
SWEEP_SHAPES = ((8, 14, 2, 64, 512), (8, 32, 8, 128, 32768))


def check_attention_sweep(torch, dev, gen):
    """Both decode attention kernels under forced S splits (the wrappers'
    private ``_splits``) at the serving decode shape and the long context:
    splits in {1, 2, 4, 6, the plan's, 8, 12, 16} as far as the tiles
    allow. Rows:
    0 full, 1 of length 1 (every split but the first fully masked), 2 of
    length 65 (all but two), 3 fully masked, the rest random. At every
    split, in float32 and bfloat16: kv_attention within ``OUT_TOL`` of the
    plain version, row 3 exactly 0, two calls the same bits; fused_decode
    (with quantize-out) equal to append_quantize + the kv_attention kernel
    at the same split + the quantize_act kernel, bit for bit (out,
    quantize-out, cache). Logs each split's device time (bf16) beside the
    bound."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ops import append_quantize
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    for B, Hq, Hkv, hd, S in SWEEP_SHAPES:
        plan = attention_plan.plan(B, S, Hq, Hkv, hd)
        top = attention_plan.max_splits(plan.tiles)
        splits = sorted({s for s in (1, 2, 4, 6, plan.splits, 8, 12, 16)
                         if s <= top})
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[0], lens[1], lens[2], lens[3] = S, 1, 65, 0
        long = S > 4096
        times = []
        for dtype in (torch.float32, torch.bfloat16):
            leaves, valid, q, kn, vn, idx = _decode_inputs(
                torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens)
            kq, ks, vq, vs = leaves
            ref = kv_attention_ref(q, kq, ks, vq, vs, dtype)
            comp = [t.clone() for t in leaves]
            append_quantize(*comp, kn[:, None], vn[:, None], idx[:, None])
            live = valid[..., None]
            ks_eff = torch.where(live, comp[1], 0.0)
            vs_eff = torch.where(live, comp[3], 0.0)
            idx32 = idx.to(torch.int32)
            name = str(dtype)[6:]
            for sp in splits:
                what = f"attention sweep B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name} splits={sp}"
                out = kv_attention_cuda(q, kq, ks, vq, vs, _splits=sp)
                again = kv_attention_cuda(q, kq, ks, vq, vs, _splits=sp)
                torch.cuda.synchronize()
                assert torch.equal(out, again), f"{what}: two calls differ"
                check_attention_out(torch, out, ref, what)
                assert float(out[3].float().abs().max()) == 0.0, (
                    f"{what}: the fully masked row is not 0")
                fused = [t.clone() for t in leaves]
                fo, foq, fos = fused_decode_cuda(q, *fused, kn, vn, idx32, valid,
                                                 quantize_out=True, _splits=sp)
                uo = kv_attention_cuda(q, comp[0], ks_eff, comp[2], vs_eff,
                                       _splits=sp)
                uoq, uos = quantize_act_cuda(uo.reshape(B, -1))
                torch.cuda.synchronize()
                for a, b_, leaf in zip(fused, comp, ("k", "k_scale", "v", "v_scale")):
                    assert torch.equal(a, b_), f"{what}: fused appended {leaf} differs"
                assert torch.equal(fo, uo), (
                    f"{what}: fused out differs from unfused at "
                    f"{int((fo != uo).sum())} values")
                assert torch.equal(foq, uoq) and torch.equal(fos, uos), (
                    f"{what}: fused quantize-out differs from unfused")
                if dtype == torch.bfloat16:
                    iters = 10 if long else 100
                    run = [t.clone() for t in leaves]
                    times.append((sp, device_ms(lambda: kv_attention_cuda(
                        q, kq, ks, vq, vs, _splits=sp), iters) * 1e3,
                        device_ms(lambda: fused_decode_cuda(
                            q, *run, kn, vn, idx32, valid, quantize_out=True,
                            _splits=sp), iters) * 1e3))
            del comp, ks_eff, vs_eff
        n_bytes = B * S * Hkv * (2 * hd + 8)
        log(f"  attention split sweep B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} "
            f"({plan.tiles} tiles of {attention_plan.TS}; * the plan's; cache "
            f"bound {n_bytes / hw_peak(HBM_BYTES_S) * 1e6:.2f} us), us kv_attention / "
            f"fused_decode bf16: " + ", ".join(
                f"{sp}{'*' if sp == plan.splits else ''} {tk:.2f} / {tf:.2f}"
                for sp, tk, tf in times))
    log(f"  attention split sweep: every split within {OUT_TOL['float32']} "
        f"(+1 bf16 ulp in bf16) of the plain version, fully masked row 0, two "
        f"calls bit-equal, fused == unfused (out, quantize-out, cache) bit for bit")


def check_queue_c(torch, dev, gen):
    """The three calls the CUDA tiers refused before (ROADMAP Queue C), on
    the card through the public ops, against the torch tier: kv_attention
    with bfloat16 q and the default out_dtype=float32 (within OUT_TOL of
    the plain version; its bf16 cast bit-equal to the kernel's own bfloat16
    output); fused_decode with one shared ring offset idx [1] (bit-equal to
    the same call with that offset per slot, its appended cache bit-equal
    to the plain version's); fused_decode with bfloat16 q, out_dtype=float32
    and the W8A8 quantize-out (the epilogue bit-equal to quantize_act of the
    float32 out, out within OUT_TOL); quantize_act at bits 2, 4 and 6
    (bit-equal to the plain version)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
    from repro_torch.kernels.kv_attention import kv_attention, kv_attention_ref
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lens[3] = 0
    leaves, valid, q, kn, vn, idx = _decode_inputs(
        torch, dev, gen, B, S, Hq, Hkv, hd, torch.bfloat16, lens)
    kq, ks, vq, vs = leaves
    reset_launch_counts()
    out = kv_attention(q, kq, ks, vq, vs)              # out_dtype=float32
    out16 = kv_attention(q, kq, ks, vq, vs, out_dtype=torch.bfloat16)
    assert launch_counts()["kv_attention"] == 2
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    check_attention_out(torch, out, kv_attention_ref(q, kq, ks, vq, vs), "kv_attention bf16 q -> f32")
    assert torch.equal(out.bfloat16(), out16), "f32 out cast to bf16 differs"
    # one shared ring offset against the same offset per slot
    shared = torch.tensor([S - 1], device=dev)
    mask = valid.clone()
    mask[:, S - 1] = True
    mine = [t.clone() for t in leaves]
    slot = [t.clone() for t in leaves]
    plain = [t.clone() for t in leaves]
    (o1, q1, s1), _ = fused_decode(q, *mine, kn[:, None], vn[:, None], shared,
                                   valid=mask, quantize_out=True)
    (o2, q2, s2), _ = fused_decode(q, *slot, kn[:, None], vn[:, None],
                                   shared.expand(B)[:, None], valid=mask,
                                   quantize_out=True)
    (o3, q3, s3), _ = fused_decode_ref(q, *plain, kn[:, None], vn[:, None], shared,
                                       valid=mask, quantize_out=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(q1, q2) and torch.equal(s1, s2)
    for a, b_, c in zip(mine, slot, plain):
        assert torch.equal(a, b_) and torch.equal(a, c), "shared idx: cache differs"
    check_fused_out(torch, o1, o3, q1, s1, q3, s3, "fused_decode shared idx")
    # bf16 q, float32 out, quantize-out (the fused W8A8 route's epilogue)
    mine = [t.clone() for t in leaves]
    plain = [t.clone() for t in leaves]
    (o1, q1, s1), _ = fused_decode(q, *mine, kn[:, None], vn[:, None], idx[:, None],
                                   valid=valid, out_dtype=torch.float32,
                                   quantize_out=True)
    (o3, q3, s3), _ = fused_decode_ref(q, *plain, kn[:, None], vn[:, None],
                                       idx[:, None], valid=valid,
                                       out_dtype=torch.float32, quantize_out=True)
    torch.cuda.synchronize()
    assert o1.dtype == torch.float32
    assert float(o1[3].abs().max()) == 0.0
    for a, c in zip(mine, plain):
        assert torch.equal(a, c), "bf16 q f32 out: cache differs"
    _, note = check_fused_out(torch, o1, o3, q1, s1, q3, s3,
                              "fused_decode bf16 q -> f32 quantize-out")
    for bits in (2, 4, 6):
        x = torch.randn((8, 896), generator=gen, device=dev) * 3
        got, want = quantize_act(x, bits=bits), quantize_act_ref(x, bits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), bits
    log(f"  Queue C on the card: kv_attention(bf16 q) -> float32 within "
        f"{OUT_TOL['float32']}, its bf16 cast = the bf16 kernel bit for bit; "
        f"fused_decode shared idx [1] = per-slot bit for bit, cache = plain; "
        f"fused_decode bf16 q -> float32 + quantize-out: {note}; quantize_act "
        f"bits 2/4/6 bit-equal")


# every K x N of the serving path: wq and wo, wk and wv, wg and wu, wd
PATH_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896))


def near_ties(torch, gen, dev, n):
    """n values k/2 + within 1e-5 relative of it, |k/2| < 127: at scale 1
    some lie inside quantize16's 2^-13 band around a half-integer (the
    IEEE division decides them) and some outside (the reciprocal's integer
    must be the division's)."""
    k = torch.randint(-253, 254, (n,), generator=gen, device=dev).float() / 2
    return k * (1 + (torch.rand((n,), generator=gen, device=dev) - 0.5) * 2e-5)


def _qin_input(torch, gen, dev, M, K, dtype):
    """x [M, K] for the quantize-in GEMM: randn * 3; row 0 holds .5 ties
    (0.5, 1.5, -2.5, 2.5, -0.5) and its only large value, 127 (so its
    scale is exactly 1), in its last element — the last split's K range,
    which only the cluster's max carries to the other splits; row 1 all
    zero (the 1e-8 floor); row 2 near-ties at scale 1 (its max, 127, in
    its first element)."""
    x = torch.randn((M, K), generator=gen, device=dev) * 3
    x[0, :5] = torch.tensor([0.5, 1.5, -2.5, 2.5, -0.5])
    x[0, K - 1] = 127.0
    if M > 1:
        x[1] = 0.0
    if M > 2:
        x[2] = near_ties(torch, gen, dev, K)
        x[2, 0] = 127.0
    return x.to(dtype)


def check_qmatmul_w8a8_qin(torch, dev, gen):
    """The quantize-in W8A8 GEMM (quantize_act folded into the GEMM, one
    launch) bit-equal to the pair of the port's own kernels
    (``quantize_act_cuda`` then ``qmatmul_w8a8_cuda``) and to the plain
    version, and the quantized x it hands out bit-equal to quantize_act's:
    every path K x N and a ragged K (K % 16 != 0: the element-wise
    loaders; K = 4100 split), the decode tile's M in {1, 8, 16} (ragged
    5, 8, 13), bf16 and f32 x, bf16 and f32 out, at every split the
    planner allows (forced by ``_splits``; splits whose int8 slice does
    not fit are refused by the wrapper, and counted). A 64-row tile (M in
    {64, 256}; ragged 70), which the plan never folds, is refused. Timed at
    the path shapes on the bf16 x it checked (bf16 out): the fold, the
    pair (timed together), the GEMM alone on pre-quantized A,
    ``torch._int_mm`` on that A (M padded to 32), beside the bound (W
    bytes + A bytes in x's type + out)."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_qin_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    cases = [(K, N, (1, 8, 16), (64, 256)) for K, N in PATH_KN]
    cases += [(900, 130, (5, 8, 13), (70,)), (4100, 70, (5, 8, 13), (70,))]
    rows, checked, refused, tiles_refused = [], 0, 0, 0
    for K, N, Ms, wide in cases:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in wide:
            assert not gemm_plan.plan(M, N, K).fold
            try:
                qmatmul_w8a8_qin_cuda(_qin_input(torch, gen, dev, M, K,
                                                 torch.bfloat16), w, sw, bias)
            except ValueError as e:
                assert "decode tile" in str(e), e
                tiles_refused += 1
            else:
                raise AssertionError(f"qmatmul_w8a8_qin M={M} K={K} N={N}: "
                                     f"a {gemm_plan.plan(M, N, K).bm}-row "
                                     f"tile launched")
        for M in Ms:
            p = gemm_plan.plan(M, N, K)
            assert p.fold, f"M={M} K={K} N={N}: the plan does not fold"
            top = gemm_plan.max_splits(p.k_steps)
            for xdt in (torch.bfloat16, torch.float32):
                x = _qin_input(torch, gen, dev, M, K, xdt)
                if xdt == torch.bfloat16:
                    x_timed = x  # checked below, then timed
                a_q, a_s = quantize_act_cuda(x)
                for od in (torch.bfloat16, torch.float32):
                    what = (f"qmatmul_w8a8_qin M={M} K={K} N={N} "
                            f"{str(xdt)[6:]} -> {str(od)[6:]}")
                    pair = qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias, out_dtype=od)
                    plain = qmatmul_w8a8_qin_ref(x, w, sw, bias, od)
                    torch.cuda.synchronize()
                    assert torch.equal(pair, plain), f"{what}: pair != plain"
                    for S in range(1, top + 1):
                        if not gemm_plan.plan(M, N, K, splits=S).fold:
                            refused += 1
                            continue
                        y, xq, xs = qmatmul_w8a8_qin_cuda(
                            x, w, sw, bias, out_dtype=od, quantized=True,
                            _splits=S)
                        torch.cuda.synchronize()
                        assert torch.equal(y, pair), (
                            f"{what} S={S}: not bit-equal to quantize_act + "
                            f"qmatmul_w8a8 ({int((y != pair).sum())} values, "
                            f"max |diff| "
                            f"{float((y.float() - pair.float()).abs().max())})")
                        assert torch.equal(xq, a_q) and torch.equal(xs, a_s), (
                            f"{what} S={S}: the quantized x it hands out is "
                            f"not quantize_act's")
                        assert bool(torch.isfinite(y).all()), f"{what} S={S}"
                        checked += 1
            if (K, N) not in PATH_KN:
                continue
            x = x_timed
            a_q, a_s = quantize_act_cuda(x)
            fold = lambda: qmatmul_w8a8_qin_cuda(x, w, sw, bias,
                                                 out_dtype=torch.bfloat16)

            def pair():
                aq, asc = quantize_act_cuda(x)
                return qmatmul_w8a8_cuda(aq, w, asc, sw, bias,
                                         out_dtype=torch.bfloat16)

            gemm = lambda: qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias,
                                             out_dtype=torch.bfloat16)
            a_lib = torch.cat([a_q, a_q.new_zeros((32 - M, K))])
            b, by = bound_ms(K * N + 2 * M * K + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            err = float((fold().float() - pair().float()).abs().max())
            assert err == 0.0, f"M={M} K={K} N={N}: the timed fold is off the pair by {err}"
            row = {
                "shape": f"M={M} K={K} N={N} bf16 -> bf16", "mkn": [M, K, N],
                "max_abs_err": err, "splits": p.splits, "share": p.share,
                "ms": device_ms(fold, 50), "call_ms": call_ms(fold, 50),
                "pair_ms": device_ms(pair, 50), "gemm_ms": device_ms(gemm, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_qin_ref(
                    x, w, sw, bias, torch.bfloat16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lambda: torch._int_mm(a_lib, w), 50),
                "library": (f"torch._int_mm on quantize_act's A, M "
                            f"zero-padded {M}->32")}
            if M == 8:
                # each call's weight from HBM, as on the serving path

                def pair_on(wc):
                    aq, asc = quantize_act_cuda(x)
                    return qmatmul_w8a8_cuda(aq, wc, asc, sw, bias,
                                             out_dtype=torch.bfloat16)

                row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_qin_cuda(
                    x, wc, sw, bias, out_dtype=torch.bfloat16), w)
                row["pair_cold_ms"] = cold_ms(torch, pair_on, w)
                row["gemm_cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_cuda(
                    a_q, wc, a_s, sw, bias, out_dtype=torch.bfloat16), w)
            rows.append(row)
    log(f"  qmatmul_w8a8_qin: {checked} results (path K x N and ragged K, "
        f"M 1-16, bf16/f32 x, bf16/f32 out, every split that fits) bit-equal "
        f"to quantize_act + qmatmul_w8a8, with the quantized x they hand out "
        f"equal to quantize_act's, and the pair to the plain version; "
        f"{refused} forced splits refused (int8 slice over "
        f"{gemm_plan.QIN_SMEM_MAX} bytes); {tiles_refused} calls at M 64-256 "
        f"(64-row tiles) refused")
    for r in rows:
        log(f"  qmatmul_w8a8_qin {r['shape']:30s} fold {r['ms'] * 1e3:7.2f} us"
            f"  pair {r['pair_ms'] * 1e3:7.2f}  GEMM alone "
            f"{r['gemm_ms'] * 1e3:7.2f}  _int_mm {r['library_ms'] * 1e3:7.2f}"
            f"  bound {r['bound_ms'] * 1e3:6.3f}"
            + (f"  cold: fold {r['cold_ms'] * 1e3:.2f}, pair "
               f"{r['pair_cold_ms'] * 1e3:.2f}, GEMM alone "
               f"{r['gemm_cold_ms'] * 1e3:.2f}" if "cold_ms" in r else "")
            + f"  (S={r['splits']}, share {r['share']})")
    return rows


# the quantize-out GEMMs' shapes: every path K x N at a decode step and a
# prefill chunk, then qwen2's vocabulary at a decode step (9,496 N tiles:
# more than the card keeps resident, so the workspace route)
Q8_PATH = [(M, K, N) for K, N in PATH_KN for M in (8, 256)]
Q8_VOCAB = (8, 896, 151936)
# the shapes where each q8 kernel also runs at bits 4 and under the forced
# workspace route (one decode, one prefill)
Q8_BITS_SHAPES = ((8, 896, 4864), (256, 896, 4864))


def check_q8(torch, what, plan, kern, pair, gemm, plain, equal, w, big):
    """One quantize-out GEMM at one shape: ``kern(bits, route, w)`` (route
    None: the plan's) against ``pair(bits, w)`` (the port's GEMM to float32,
    then quantize_act) and ``plain(bits)`` by ``equal(q8, pair, plain,
    bits)``, which asserts and returns the largest payload step off the
    plain version; two calls of each route bit-equal. At ``Q8_BITS_SHAPES``
    also bits 4, and the workspace route forced (bits 4 and 8). Returns the
    row: the plan's route and tickets, the kernel, the pair and the GEMM
    alone (``gemm(w)``) timed warm and, at M = 8, cold; the forced
    workspace route's time where it ran, and where the plan takes the
    workspace route but an M tile's N tiles fit the card, the resident route
    by ticket (forced), checked and timed."""
    def twice(bits, route):
        first, second = kern(bits, route, w), kern(bits, route, w)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]), (
            f"{what} bits={bits} route={route or plan.q8_route}: two calls "
            f"gave different bits")
        return first

    bits_shape = (plan.M, plan.K, plan.N) in Q8_BITS_SHAPES
    runs = [(8, None)]
    if bits_shape:
        runs += [(4, None), (8, "workspace"), (4, "workspace")]
    err = 0.0
    for bits, route in runs:
        err = max(err, equal(twice(bits, route), pair(bits, w), plain(bits), bits))
    iters = 10 if big else 50
    row = {"q8_route": plan.q8_route, "bm": plan.bm, "residency": plan.residency,
           "tickets": plan.tiles if plan.q8_ticketed else 0,
           "waiters": plan.q8_waiters,
           "max_abs_err": err,
           "ms": device_ms(lambda: kern(8, None, w), iters),
           "call_ms": call_ms(lambda: kern(8, None, w), iters),
           "stepwise_ms": device_ms(lambda: pair(8, w), iters),
           "gemm_ms": device_ms(lambda: gemm(w), iters),
           "plain_ms": device_ms(lambda: plain(8), 3 if big else 10)}
    if bits_shape:
        row["workspace_ms"] = device_ms(lambda: kern(8, "workspace", w), iters)
    if plan.q8_route == "workspace" and plan.n_tiles <= plan.residency:
        # the resident route by ticket, which the plan declines here
        equal(twice(8, "resident"), pair(8, w), plain(8), 8)
        row["resident_ms"] = device_ms(lambda: kern(8, "resident", w), iters)
    if plan.M == 8:
        # each call's weight from HBM, as a serving path would read it
        row["cold_ms"] = cold_ms(torch, lambda wc: kern(8, None, wc), w)
        row["stepwise_cold_ms"] = cold_ms(torch, lambda wc: pair(8, wc), w)
        row["gemm_cold_ms"] = cold_ms(torch, gemm, w)
    return row


def log_q8(name, r):
    log(f"  {name} {r['shape']:32s} {r['q8_route']:9s} bm {r['bm']:3d} residency "
        f"{r['residency']:4d} tickets {r['tickets']:5d} waiters {r['waiters']:4d}"
        f"  q8 {r['ms'] * 1e3:8.2f} us"
        f"  pair {r['stepwise_ms'] * 1e3:8.2f}  "
        f"GEMM alone {r['gemm_ms'] * 1e3:8.2f}"
        + (f"  forced workspace {r['workspace_ms'] * 1e3:.2f}"
           if "workspace_ms" in r else "")
        + (f"  forced resident (tickets) {r['resident_ms'] * 1e3:.2f}"
           if "resident_ms" in r else "")
        + (f"  cold: q8 {r['cold_ms'] * 1e3:.2f}, pair "
           f"{r['stepwise_cold_ms'] * 1e3:.2f}, GEMM alone "
           f"{r['gemm_cold_ms'] * 1e3:.2f}" if "cold_ms" in r else ""))


def check_qmatmul_w8a8_q8(torch, dev, gen):
    """qmatmul_w8a8 with the quantize-out epilogue, one launch: payload and
    scale bit-equal to the plain version and to the stepwise pair of the
    port's own kernels (the W8A8 GEMM to float32, then quantize_act), at
    every path shape, the JAX bench's 4096^3 and the vocabulary (the
    workspace route); at ``Q8_BITS_SHAPES`` also at bits 4 and on the
    forced workspace route; two calls bit-equal at each."""
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_q8_cuda,
        qmatmul_w8a8_q8_plan,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_q8_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    shapes = Q8_PATH + [(4096, 4096, 4096), Q8_VOCAB]  # 4096^3: the JAX bench's
    rows = []
    for M, K, N in shapes:
        what = f"qmatmul_w8a8 q8 M={M} K={K} N={N}"
        big = M * K * N > 1e10
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4

        def equal(got, pair_out, plain_out, bits):
            q, s = got
            for name, (qo, so) in (("the plain version", plain_out),
                                   ("the stepwise pair", pair_out)):
                assert torch.equal(q, qo) and torch.equal(s, so), (
                    f"{what} bits={bits}: not bit-equal to {name} "
                    f"({int((q != qo).sum())} payloads, "
                    f"{int((s != so).sum())} scales)")
            return 0.0

        row = check_q8(
            torch, what, qmatmul_w8a8_q8_plan(M, N, K, dev),
            lambda bits, route, wc: qmatmul_w8a8_q8_cuda(
                a, wc, sa, sw, bias, bits=bits, _route=route),
            lambda bits, wc: quantize_act_cuda(
                qmatmul_w8a8_cuda(a, wc, sa, sw, bias), bits),
            lambda wc: qmatmul_w8a8_cuda(a, wc, sa, sw, bias),
            lambda bits: qmatmul_w8a8_q8_ref(a, w, sa, sw, bias, bits),
            equal, w, big)
        b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + M * N + 4 * M,
                         2 * M * K * N, INT8_OPS_S)
        rows.append({"shape": f"M={M} K={K} N={N}", "mkn": [M, K, N], **row,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
        log_q8("qmatmul_w8a8_q8", rows[-1])
        del w
    log(f"  qmatmul_w8a8 q8 at {len(shapes)} shapes: payload and scale "
        f"bit-equal to the plain version and to the stepwise pair, two calls "
        f"bit-equal; bits 4 and the forced workspace route at "
        f"{len(Q8_BITS_SHAPES)} shapes")
    return rows


def check_qmatmul_w8a16_q8(torch, dev, gen):
    """qmatmul_w8a16 with the quantize-out epilogue, one launch. float32 a:
    payload and scale bit-equal to the stepwise pair of the port's own
    kernels (the W8A16 GEMM to float32, then quantize_act). bfloat16 a:
    against the plain version (float32 sums in another order), no payload
    more than one step apart (the count of one-step payloads printed), the
    scale within E/qmax + one float32 ulp, E the float32 ``W8A16_TOL``
    bound at the row's largest value. Shapes, bits and routes as the W8A8
    check, with the JAX bench's decode (M=8 K=N=8192) in place of 4096^3;
    two calls bit-equal at each."""
    from repro_torch.kernels.qmatmul_w8a16.kernel import (
        qmatmul_w8a16_cuda,
        qmatmul_w8a16_q8_cuda,
        qmatmul_w8a16_q8_plan,
    )
    from repro_torch.kernels.qmatmul_w8a16.ref import (
        qmatmul_w8a16_q8_ref,
        qmatmul_w8a16_ref,
    )
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    shapes = Q8_PATH + [(8, 8192, 8192), Q8_VOCAB]  # the JAX bench's decode
    rows, one_step = [], {}
    for M, K, N in shapes:
        w = _kmajor_int8(torch, gen, dev, K, N)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            what = f"qmatmul_w8a16 q8 M={M} K={K} N={N} {name}"
            a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            sw = (torch.rand((1,), generator=gen, device=dev) * 0.01
                  + 1e-4).to(dtype)
            bias = torch.randn((N,), generator=gen, device=dev).to(dtype)
            y32 = qmatmul_w8a16_ref(a, w, sw, bias, torch.float32)
            e_row = w8a16_tolerance(torch, a, w, sw, bias, y32).amax(1)
            del y32

            def equal(got, pair_out, plain_out, bits):
                q, s = got
                if dtype == torch.float32:
                    qp, sp = pair_out
                    assert torch.equal(q, qp) and torch.equal(s, sp), (
                        f"{what} bits={bits}: not bit-equal to the stepwise "
                        f"pair ({int((q != qp).sum())} payloads, "
                        f"{int((s != sp).sum())} scales)")
                qr, sr = plain_out
                steps = (q.int() - qr.int()).abs()
                s_tol = e_row / (2 ** (bits - 1) - 1) + sr * 2.0 ** -23
                assert int(steps.max()) <= 1, (
                    f"{what} bits={bits}: a payload {int(steps.max())} steps "
                    f"off the plain version")
                assert bool(((s - sr).abs() <= s_tol).all()), (
                    f"{what} bits={bits}: scale off the plain version by "
                    f"{float((s - sr).abs().max())} (bound "
                    f"{float(s_tol.min())})")
                if dtype == torch.bfloat16 and bits == 8:
                    one_step.setdefault((M, K, N), f"M={M} K={K} N={N}: "
                                        f"{int((steps > 0).sum())} of {q.numel()}")
                return float(steps.max())

            row = check_q8(
                torch, what, qmatmul_w8a16_q8_plan(M, N, K, dtype, dev),
                lambda bits, route, wc: qmatmul_w8a16_q8_cuda(
                    a, wc, sw, bias, bits=bits, _route=route),
                lambda bits, wc: quantize_act_cuda(
                    qmatmul_w8a16_cuda(a, wc, sw, bias), bits),
                lambda wc: qmatmul_w8a16_cuda(a, wc, sw, bias),
                lambda bits: qmatmul_w8a16_q8_ref(a, w, sw, bias, bits),
                equal, w, False)
            e = a.element_size()
            b, by = bound_ms(M * K * e + K * N + e + N * e + M * N + 4 * M,
                             2 * M * K * N,
                             BF16_OPS_S if dtype == torch.bfloat16
                             else F32_OPS_S)
            rows.append({"shape": f"M={M} K={K} N={N} {name}",
                         "mkn": [M, K, N], **row, "bound_ms": b,
                         "bound_by": by, "library_ms": None})
            log_q8("qmatmul_w8a16_q8", rows[-1])
        del w
    log(f"  qmatmul_w8a16 q8 at {len(shapes)} shapes: float32 a bit-equal to "
        f"the stepwise pair; bfloat16 a within one step and E/qmax of the "
        f"plain version; two calls bit-equal; bits 4 and the forced "
        f"workspace route at {len(Q8_BITS_SHAPES)} shapes; payloads one step "
        f"apart (bf16, bits 8): " + "; ".join(one_step.values()))
    return rows


def check_split_sweep(torch, dev, gen):
    """Both GEMMs at every path K x N under forced K splits (the wrappers'
    private ``_splits``): S in {1, 2, the plan's, the largest the planner
    allows}, M in {8, 64, 256} for W8A8 and {8, 256} for W8A16. W8A8
    bit-equal to its plain version in bfloat16 and float32; W8A16 within
    ``W8A16_TOL`` in bfloat16 and float32. At the plan's S and the largest,
    two calls of each GEMM and of each quantize-out variant give the same
    bits. Logs each S's device time (bfloat16 out): the planner's evidence."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref
    from repro_torch.kernels.qmatmul_w8a16.kernel import (
        qmatmul_w8a16_cuda,
        qmatmul_w8a16_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    def same_twice(fn):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if isinstance(first, tuple):
            return all(torch.equal(x, y) for x, y in zip(first, second))
        return torch.equal(first, second)

    checked = 0
    for K, N in PATH_KN:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (8, 64, 256):
            p = gemm_plan.plan(M, N, K)
            top = gemm_plan.max_splits(p.k_steps)
            a_q = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                                dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            a16 = {dt: torch.randn((M, K), generator=gen, device=dev).to(dt)
                   for dt in (torch.bfloat16, torch.float32)}
            sw16 = {dt: (sw[:1] * 10).to(dt) for dt in a16}
            b16 = {dt: bias.to(dt) for dt in a16}
            times = []
            for S in sorted({1, min(2, top), p.splits, top}):
                what = f"M={M} K={K} N={N} S={S}"
                for od in (torch.bfloat16, torch.float32):
                    y = qmatmul_w8a8_cuda(a_q, w, sa, sw, bias, out_dtype=od,
                                          _splits=S)
                    yr = qmatmul_w8a8_ref(a_q, w, sa, sw, bias, od)
                    torch.cuda.synchronize()
                    assert torch.equal(y, yr), (
                        f"qmatmul_w8a8 {what} {od}: not bit-equal to the "
                        f"plain version ({int((y != yr).sum())} values)")
                    checked += 1
                t8 = device_ms(lambda: qmatmul_w8a8_cuda(
                    a_q, w, sa, sw, bias, out_dtype=torch.bfloat16,
                    _splits=S), 20)
                t16 = None
                if M != 64:
                    for dt, a in a16.items():
                        y = qmatmul_w8a16_cuda(a, w, sw16[dt], b16[dt],
                                               _splits=S)
                        yr = qmatmul_w8a16_ref(a, w, sw16[dt], b16[dt], dt)
                        torch.cuda.synchronize()
                        diff = (y.float() - yr.float()).abs()
                        tol = w8a16_tolerance(torch, a, w, sw16[dt], b16[dt], yr)
                        assert bool((diff <= tol).all()), (
                            f"qmatmul_w8a16 {what} {dt}: off the plain "
                            f"version at {int((diff > tol).sum())} values "
                            f"({W8A16_TOL[str(dt)[6:]]})")
                        checked += 1
                    t16 = device_ms(lambda: qmatmul_w8a16_cuda(
                        a16[torch.bfloat16], w, sw16[torch.bfloat16],
                        b16[torch.bfloat16], _splits=S), 20)
                if S in (p.splits, top):
                    runs = [lambda: qmatmul_w8a8_cuda(
                                a_q, w, sa, sw, bias, _splits=S),
                            lambda: qmatmul_w8a8_q8_cuda(
                                a_q, w, sa, sw, bias, _splits=S)]
                    if M != 64:
                        for dt, a in a16.items():
                            runs.append(lambda a=a, dt=dt: qmatmul_w8a16_cuda(
                                a, w, sw16[dt], b16[dt], _splits=S))
                            runs.append(lambda a=a, dt=dt: qmatmul_w8a16_q8_cuda(
                                a, w, sw16[dt], b16[dt], _splits=S))
                    for fn in runs:
                        assert same_twice(fn), (
                            f"{what}: two calls gave different bits")
                times.append(f"S={S}{'*' if S == p.splits else ''} "
                             f"{t8 * 1e3:.2f}" + ("" if t16 is None
                                                  else f" / {t16 * 1e3:.2f}"))
            log(f"  split sweep M={M} K={K} N={N} ({p.tiles} tiles, "
                f"{p.k_steps} K steps; * the plan's), us w8a8"
                + ("" if M == 64 else " / w8a16") + " bf16: "
                + ", ".join(times))
    log(f"  split sweep: {checked} W8A8 results bit-equal to the plain "
        f"version and W8A16 within {W8A16_TOL['float32']} (+1 bf16 ulp in "
        f"bf16); two calls of each GEMM and quantize-out variant at the "
        f"plan's and the largest S bit-equal")


# the serving path's projections a layer: (K, N) and how many of each —
# q and o, k and v, gate and up, down
LAYER_GEMMS = (((896, 896), 2), ((896, 128), 2), ((896, 4864), 2),
               ((4864, 896), 1))


def log_step_sums(tables):
    """One line with the device time of one decode step's GEMMs (24 layers x
    the seven projections at M = 8, warm and cold) and of one prefill
    chunk's (M = 256), each beside the bound's sum and, for W8A8,
    ``torch._int_mm``'s; two lines (GEMMs warm, cold) with the W8A8 decode
    step's GEMMs plus activation quantization on the fused route: the pair —
    quantize_act of the qkv, gate/up and down inputs and the seven int8
    GEMMs — against the fold — q, gate and down quantize-in GEMMs, and k, v,
    up (on the fold's quantized input) and wo (on fused_decode's
    quantize-out) int8 GEMMs."""
    def total(name, M, key, suffix=""):
        rows = {tuple(r["mkn"][1:]): r for r in tables[name]
                if r["mkn"][0] == M and r["shape"].endswith(suffix)}
        return 24 * sum(n * rows[kn][key] for kn, n in LAYER_GEMMS)

    qa = {r["shape"]: r["ms"] for r in tables["quantize_act"]}
    quant = 24 * (2 * qa["x[8,896] bfloat16"] + qa["x[8,4864] bfloat16"])
    def at(name, K, N, key):
        return next(r[key] for r in tables[name] if r["mkn"] == [8, K, N])

    for temp, key in (("warm", "ms"), ("cold", "cold_ms")):
        gemms = total("qmatmul_w8a8", 8, key)
        fold = 24 * sum(at("qmatmul_w8a8_qin", K, N, key)
                        for K, N in ((896, 896), (896, 4864), (4864, 896)))
        int8 = 24 * sum(at("qmatmul_w8a8", K, N, key) for K, N in
                        ((896, 128), (896, 128), (896, 896), (896, 4864)))
        log(f"  W8A8 device ms per decode step, GEMMs + activation "
            f"quantization (24 layers, M=8, GEMMs {temp}): pair "
            f"{gemms + quant:.4f} (GEMMs {gemms:.4f} + quantize_act 72 x = "
            f"{quant:.4f}); fold {fold + int8:.4f} (72 qmatmul_w8a8_qin "
            f"{fold:.4f} + 96 qmatmul_w8a8 {int8:.4f})")

    w16, w8 = "qmatmul_w8a16", "qmatmul_w8a8"
    log(f"  GEMM device ms per decode step (24 layers x 7 projections, M=8): "
        f"{w16} bf16 warm {total(w16, 8, 'ms', 'bfloat16'):.4f}, cold "
        f"{total(w16, 8, 'cold_ms', 'bfloat16'):.4f} (bound "
        f"{total(w16, 8, 'bound_ms', 'bfloat16'):.4f}); {w8} warm "
        f"{total(w8, 8, 'ms'):.4f}, cold {total(w8, 8, 'cold_ms'):.4f} (bound "
        f"{total(w8, 8, 'bound_ms'):.4f}; torch._int_mm, M padded to 32, warm "
        f"{total(w8, 8, 'library_ms'):.4f}, cold "
        f"{total(w8, 8, 'library_cold_ms'):.4f})")
    log(f"  GEMM device ms per prefill chunk (M=256): {w16} bf16 "
        f"{total(w16, 256, 'ms', 'bfloat16'):.4f} (bound "
        f"{total(w16, 256, 'bound_ms', 'bfloat16'):.4f}); {w8} "
        f"{total(w8, 256, 'ms'):.4f} (bound {total(w8, 256, 'bound_ms'):.4f}; "
        f"torch._int_mm {total(w8, 256, 'library_ms'):.4f})")


# the decode attention geometries of the other archs besides qwen2 (the four
# dense ones, then the two MoE ones, group 6 and 5): (arch, Hq, Hkv, hd),
# each at B = 8 slots and S = 512 positions
NEW_ATTENTION = (("mistral-nemo-12b", 32, 8, 128), ("yi-34b", 56, 8, 128),
                 ("chameleon-34b", 64, 8, 128), ("gemma-7b", 16, 16, 256),
                 ("mixtral-8x22b", 48, 8, 128),
                 ("llama4-scout-17b-a16e", 40, 8, 128))


def check_new_attention(torch, dev, gen):
    """fused_decode (with its quantize-out) and kv_attention at the decode
    geometry of each new arch (``NEW_ATTENTION``), float32 and bfloat16,
    against their plain versions as at qwen2's shape: the appended cache
    bit-equal, ``out`` within ``OUT_TOL``, the quantize-out as
    ``check_fused_out`` holds it, a row of length 0 exactly 0; each
    geometry's plan (splits, shared memory a CTA) logged, and the bf16
    calls timed beside the plain versions, the bound and SDPA (logged in
    the rows' format; the kernels JSON line keeps qwen2's rows)."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.fused_decode.ref import fused_decode_ref
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref

    B, S = 8, 512
    for arch, Hq, Hkv, hd in NEW_ATTENTION:
        plan = attention_plan.plan(B, S, Hq, Hkv, hd)
        log(f"  attention plan {arch} B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S}: "
            f"group {plan.group}, {plan.splits} splits, {plan.ctas} CTAs, "
            f"{plan.smem} bytes of shared memory a CTA")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lens[0], lens[B - 1] = S, 0
            leaves, valid, q, kn, vn, idx = _decode_inputs(
                torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens)
            idx32 = idx.to(torch.int32)
            fused = [t.clone() for t in leaves]
            out, oq, os_ = fused_decode_cuda(q, *fused, kn, vn, idx32, valid,
                                             quantize_out=True)
            ref = [t.clone() for t in leaves]
            (outr, oqr, osr), _ = fused_decode_ref(
                q, *ref, kn[:, None], vn[:, None], idx[:, None], valid=valid,
                out_dtype=dtype, quantize_out=True)
            torch.cuda.synchronize()
            what = f"fused_decode {arch} Hq={Hq} Hkv={Hkv} hd={hd} {name}"
            for a, b_, leaf in zip(fused, ref, ("k", "k_scale", "v",
                                                "v_scale")):
                assert torch.equal(a, b_), f"{what}: appended {leaf} differs"
            err, note = check_fused_out(torch, out, outr, oq, os_, oqr, osr,
                                        what)
            assert float(out[B - 1].float().abs().max()) == 0.0, (
                f"{what}: the row of length 0 is not 0")
            log(f"  {what}: out max |diff| {err:.3g} ({OUT_TOL[name]}); "
                f"{note}; appended leaves bit-equal")
            # the unfused kernel over the appended cache, the stepwise
            # route's masking (the scales zero where a position is dead)
            live = valid[..., None]
            kq, ks, vq, vs = fused
            ks, vs = ks * live, vs * live
            kv = kv_attention_cuda(q, kq, ks, vq, vs, None)
            kvr = kv_attention_ref(q, kq, ks, vq, vs, dtype)
            torch.cuda.synchronize()
            kwhat = f"kv_attention {arch} Hq={Hq} Hkv={Hkv} hd={hd} {name}"
            diff, past = check_attention_out(torch, kv, kvr, kwhat)
            assert float(kv[B - 1].float().abs().max()) == 0.0
            log(f"  {kwhat}: max |diff| {float(diff.max()):.3g} "
                f"({OUT_TOL[name]}){past}")
            if dtype != torch.bfloat16:
                continue
            n_live = int(valid.sum())
            e = q.element_size()
            shape = f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name} ({arch})"
            run = [t.clone() for t in leaves]
            fb, fby = bound_ms(
                2 * B * Hq * hd * e + n_live * Hkv * (hd + 4) * 2 + B * S
                + 2 * B * Hkv * hd * (e + 1) + 8 * B * Hkv + B * Hq * hd
                + 4 * B, 4 * Hq * n_live * hd, F32_OPS_S)
            kern = lambda: fused_decode_cuda(q, *run, kn, vn, idx32, valid,
                                             quantize_out=True)
            log_row("fused_decode", {
                "shape": shape, "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: fused_decode_ref(
                    q, *run, kn[:, None], vn[:, None], idx[:, None],
                    valid=valid, out_dtype=dtype, quantize_out=True), 5),
                "bound_ms": fb, "bound_by": fby, "library_ms": None,
                "no_q8_ms": device_ms(lambda: fused_decode_cuda(
                    q, *run, kn, vn, idx32, valid), 50),
                "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
                "splits": plan.splits})
            kb, kby = bound_ms(2 * B * Hq * hd * e + B * S * Hkv * 4
                               + n_live * Hkv * (2 * hd + 4),
                               4 * Hq * n_live * hd, F32_OPS_S)
            kern = lambda: kv_attention_cuda(q, kq, ks, vq, vs, None)
            log_row("kv_attention", {
                "shape": shape, "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: kv_attention_ref(
                    q, kq, ks, vq, vs, dtype), 5),
                "bound_ms": kb, "bound_by": kby, "library_ms": None,
                "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
                "splits": plan.splits})


# mistral-nemo-12b's decode projections (K, N) and gemma-7b's down
# projection, the longest K of the new archs
NEW_GEMMS = (("nemo q", 5120, 4096), ("nemo k/v", 5120, 1024),
             ("nemo o", 4096, 5120), ("nemo gate/up", 5120, 14336),
             ("nemo down", 14336, 5120), ("gemma down", 24576, 3072))


def family_gemms():
    """``check_new_gemms``' entries for phase 11: (label, K, N, the Ms
    ascending), one a (K, N) of ``family_path_gemms`` over the three archs
    in the order the path first reaches them, labelled by the first
    projection that reaches it (whisper's q/k/v stands for every 384 x 384
    projection, mamba2's out_proj for zamba2's too)."""
    groups: dict = {}
    for arch in FAMILY_PROBES:
        for name, K, N, M in family_path_gemms(arch):
            label, ms = groups.setdefault(
                (K, N), (f"{arch.split('-')[0]} {name}", set()))
            ms.add(M)
    return tuple((label, K, N, tuple(sorted(ms)))
                 for (K, N), (label, ms) in groups.items())


def check_new_gemms(torch, dev, gen, gemms=NEW_GEMMS, what="the new shapes"):
    """The three GEMMs of the W8A16 and W8A8 paths at ``gemms`` (label, K,
    N, and optionally the Ms; default M = 8, a decode step of 8 slots, and
    256, a prefill chunk): qmatmul_w8a8 bit-equal to its plain version
    (bf16 out), qmatmul_w8a16 (bf16) within ``W8A16_TOL``, and
    qmatmul_w8a8_qin bit-equal to quantize_act + qmatmul_w8a8 (and its
    int8 x to quantize_act's) where ``gemm_plan`` folds, refused with the
    plan's reason where it does not (the model then takes the pair). Each
    logged with its plan and timed in the rows' format beside its plain
    version, the library call and the bound; returns the rows by kernel."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_qin_ref,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    bf16 = torch.bfloat16
    has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    folded, refused = 0, 0
    rows = {"qmatmul_w8a8": [], "qmatmul_w8a16": [], "qmatmul_w8a8_qin": []}

    def row(name, r):
        log_row(name, r)
        rows[name].append({**r, "gemm": (M, K, N)})

    for label, K, N, *ms in gemms:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (ms[0] if ms else (8, 256)):
            p = gemm_plan.plan(M, N, K)
            shape = f"M={M} K={K} N={N} ({label})"
            log(f"  gemm plan {shape}: {p.bm}-row tiles, {p.splits} K "
                f"split(s), {p.ctas} CTAs, quantize-in "
                + ("folds" if p.fold else
                   f"refused ({p.bm}-row tile)" if p.bm not in
                   gemm_plan.FOLD_BM else
                   f"refused ({p.qin_smem} bytes of shared memory > "
                   f"{gemm_plan.QIN_SMEM_MAX})"))
            # W8A8 (the int8 GEMM on a quantized activation)
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=bf16)
            yr = qmatmul_w8a8_ref(a, w, sa, sw, bias, bf16)
            torch.cuda.synchronize()
            assert torch.equal(y, yr), f"qmatmul_w8a8 {shape}: not bit-equal"
            a_lib = a if M > 16 else torch.cat([a, a.new_zeros((32 - M, K))])
            b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw, bias,
                                             out_dtype=bf16)
            row("qmatmul_w8a8", {
                "shape": shape + " -> bf16", "max_abs_err": 0.0,
                "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                    a, w, sa, sw, bias, bf16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lambda: torch._int_mm(a_lib, w), 50),
                "library": "torch._int_mm" + ("" if M > 16 else
                                              f", M zero-padded {M}->32")})
            # W8A16 (bf16 activation, per-tensor bf16 scale, as the path)
            x = torch.randn((M, K), generator=gen, device=dev).to(bf16)
            s1 = (torch.rand((1,), generator=gen, device=dev) * 0.01
                  + 1e-4).to(bf16)
            b16 = bias.to(bf16)
            y = qmatmul_w8a16_cuda(x, w, s1, b16)
            yr = qmatmul_w8a16_ref(x, w, s1, b16, bf16)
            torch.cuda.synchronize()
            diff = (y.float() - yr.float()).abs()
            tol = w8a16_tolerance(torch, x, w, s1, b16, yr)
            assert bool((diff <= tol).all()), (
                f"qmatmul_w8a16 {shape}: off the plain version at "
                f"{int((diff > tol).sum())} values ({W8A16_TOL['bfloat16']})")
            b, by = bound_ms(M * K * 2 + K * N + 2 + N * 2 + M * N * 2,
                             2 * M * K * N, BF16_OPS_S)
            if has_lib:
                wt, s_n = w.t(), s1.expand(N).contiguous()
                lib_fn = lambda: torch._weight_int8pack_mm(x, wt, s_n)
                lib_call = "torch._weight_int8pack_mm"
            else:
                w_deq_t = (w.float() * s1.float()).to(bf16).t().contiguous()
                lib_fn = lambda: torch.nn.functional.linear(x, w_deq_t, b16)
                lib_call = "F.linear on the pre-dequantized weight"
            kern = lambda: qmatmul_w8a16_cuda(x, w, s1, b16)
            row("qmatmul_w8a16", {
                "shape": shape + " bfloat16",
                "max_abs_err": float(diff.max()), "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a16_ref(
                    x, w, s1, b16, bf16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lib_fn, 50), "library": lib_call})
            log(f"  qmatmul_w8a16 {shape} bfloat16: max |diff| "
                f"{float(diff.max()):.3g}, max |diff|/tol "
                f"{float((diff / tol).max()):.3g} ({W8A16_TOL['bfloat16']})")
            # W8A8 quantize-in (the fold), or the plan's refusal
            xq = _qin_input(torch, gen, dev, M, K, bf16)
            if not p.fold:
                try:
                    qmatmul_w8a8_qin_cuda(xq, w, sw, bias, out_dtype=bf16)
                except ValueError as e:
                    refused += 1
                    log(f"  qmatmul_w8a8_qin {shape}: refused by the plan "
                        f"({str(e)[:120]}...); the model takes quantize_act "
                        f"+ qmatmul_w8a8")
                    continue
                raise AssertionError(f"qmatmul_w8a8_qin {shape}: launched "
                                     f"where the plan does not fold")
            a_q, a_s = quantize_act_cuda(xq)
            pair = qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias, out_dtype=bf16)
            y, x_q, x_s = qmatmul_w8a8_qin_cuda(xq, w, sw, bias,
                                                out_dtype=bf16,
                                                quantized=True)
            torch.cuda.synchronize()
            assert torch.equal(y, pair), (
                f"qmatmul_w8a8_qin {shape}: not bit-equal to quantize_act + "
                f"qmatmul_w8a8")
            assert torch.equal(x_q, a_q) and torch.equal(x_s, a_s)
            folded += 1
            b, by = bound_ms(M * K * 2 + K * N + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_qin_cuda(xq, w, sw, bias,
                                                 out_dtype=bf16)

            def pair_call():
                q_, s_ = quantize_act_cuda(xq)
                return qmatmul_w8a8_cuda(q_, w, s_, sw, bias, out_dtype=bf16)

            row("qmatmul_w8a8_qin", {
                "shape": shape + " bf16 -> bf16", "max_abs_err": 0.0,
                "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_qin_ref(
                    xq, w, sw, bias, bf16), 10),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "stepwise_ms": device_ms(pair_call, 50)})
    log(f"  {what}: qmatmul_w8a8_qin folded and bit-equal at {folded}, "
        f"refused by the plan at {refused}")
    return rows


def family_quantize():
    """(M, K) of every quantize_act launch on phase 11's serve-w8a8 path,
    over the three archs (``family_quantize_inputs``), once each in path
    order."""
    return tuple(dict.fromkeys(
        mk for arch in FAMILY_PROBES for mk in family_quantize_inputs(arch)))


def check_family_quantize_act(torch, dev, gen):
    """quantize_act at ``family_quantize()``, bfloat16 (the serving dtype),
    with .5 ties and near-ties: bit-equal to the plain version; timed in
    the rows' format. Returns the rows."""
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    rows = []
    for M, K in family_quantize():
        x = torch.randn((M, K), generator=gen, device=dev) * 3
        x[0, :7] = torch.tensor([0.5, 1.5, -2.5, 0, 0, 0, 0])
        x[1] = near_ties(torch, gen, dev, K)
        x[1, 0] = 127.0
        x = x.to(torch.bfloat16)
        q, sc = quantize_act_cuda(x)
        qr, sr = quantize_act_ref(x)
        torch.cuda.synchronize()
        assert torch.equal(q, qr) and torch.equal(sc, sr), (
            f"quantize_act {M}x{K}: not bit-equal to the plain version")
        b, by = bound_ms(M * K * 2 + M * K + 4 * M, 5 * M * K, F32_OPS_S)
        r = {"shape": f"x[{M},{K}] bfloat16", "max_abs_err": 0.0,
             "ms": device_ms(lambda: quantize_act_cuda(x), 50),
             "call_ms": call_ms(lambda: quantize_act_cuda(x), 50),
             "plain_ms": device_ms(lambda: quantize_act_ref(x), 10),
             "bound_ms": b, "bound_by": by, "library_ms": None}
        log_row("quantize_act", r)
        rows.append({**r, "gemm": (M, K)})
    return rows


# the per-rank shapes of tensor-parallel qwen2-0.5b (phase 13): a model axis
# of 2 cuts q to 448 columns, k / v to 64 (one N tile, a 64-column bias)
# and gate / up to 2432, and the row-parallel o and down to K = 448 and
# 2432 (their epilogue-free int32 GEMM); a model axis of 1 keeps the whole
# K (o 896, down 4864) on the same int32 route. Each with the rows it
# takes: a decode step 8 slots (4 a rank on a data axis of 2), a prefill
# chunk 8 slots x 32 (4 x 32).
TP_COLUMN = (("q", 896, 448), ("k/v", 896, 64), ("gate/up", 896, 2432))
TP_ROW = (("o", 448, 896), ("down", 2432, 896), ("o model=1", 896, 896),
          ("down model=1", 4864, 896))
TP_M = {"cut": (8, 256), "model=1": (4, 8, 128, 256)}
# head-local decode attention at 1x2 (7 of the 14 q heads over 1 of the 2
# KV heads: group 7), and the whole heads at 4 slots a rank (2x1)
TP_ATTENTION = ((8, 7, 1, 64, 512), (4, 14, 2, 64, 512))
# the row-parallel projections' whole rows quantize_act quantizes after
# the gather (down's input; o's is phase 2's x[8,896]), decode and prefill
TP_QUANTIZE = ((8, 4864), (256, 4864), (256, 896))


def _int_mm_ms(torch, a, w):
    """``torch._int_mm`` (an exact int8 x int8 -> int32 product: the int32
    variant's function) on ``a``, its rows zero-padded to 32 below 17."""
    M, K = a.shape
    a_lib = a if M > 16 else torch.cat([a, a.new_zeros((32 - M, K))])
    return device_ms(lambda: torch._int_mm(a_lib, w), 50)


def check_tp_shapes(torch, dev, gen, column=TP_COLUMN, row=TP_ROW, ms=TP_M,
                    attention=TP_ATTENTION, quantize=TP_QUANTIZE):
    """Every per-rank kernel shape of phase 13 against its plain version
    before any rank serves: the column-parallel W8A8 GEMM (and its
    quantize-in fold where gemm_plan folds) and W8A16 GEMM at q / k / v /
    gate / up's cut N, bit-equal and within W8A16_TOL; the epilogue-free
    int32 W8A8 GEMM at o / down's cut K (and the whole K of a model axis of
    1), bit-equal to its plain version and, through the scale epilogue
    (``w8a8_epilogue``), to ``qmatmul_w8a8`` in bfloat16 and float32; the
    row-parallel W8A16 GEMM's float32 partials at the cut K; fused_decode and
    kv_attention head-local (Hq 7, Hkv 1) and at 4 slots; quantize_act at
    the gathered rows. The shape tables default to qwen2's (``TP_*``);
    phase 14 passes mixtral's (``MOE_TP_*``). Returns {kernel: rows}
    (timed, the rows' format)."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.fused_decode.ref import fused_decode_ref
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_i32_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_i32_ref,
        qmatmul_w8a8_qin_ref,
        qmatmul_w8a8_ref,
        w8a8_epilogue,
    )
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    out = {k: [] for k in ("qmatmul_w8a8", "qmatmul_w8a8_qin",
                           "qmatmul_w8a8_i32", "qmatmul_w8a16",
                           "fused_decode", "kv_attention", "quantize_act")}
    bf = torch.bfloat16
    for (label, K, N), row_par in ([(c, False) for c in column]
                                   + [(r, True) for r in row]):
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in ms["model=1" if "model=1" in label else "cut"]:
            p = gemm_plan.plan(M, N, K)
            tag = f"M={M} K={K} N={N} ({label})"
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            x = (torch.randn((M, K), generator=gen, device=dev) * 2).to(bf)
            if row_par:
                acc = qmatmul_w8a8_i32_cuda(a, w)
                accr = qmatmul_w8a8_i32_ref(a, w)
                torch.cuda.synchronize()
                assert torch.equal(acc, accr), f"qmatmul_w8a8_i32 {tag}"
                for od in (bf, torch.float32):
                    y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=od)
                    assert torch.equal(w8a8_epilogue(acc, sa, sw, bias, od), y), (
                        f"qmatmul_w8a8_i32 {tag} + epilogue != qmatmul_w8a8 "
                        f"{od}")
                b, by = bound_ms(M * K + K * N + 4 * M * N, 2 * M * K * N,
                                 INT8_OPS_S)
                kern = lambda: qmatmul_w8a8_i32_cuda(a, w)
                out["qmatmul_w8a8_i32"].append({
                    "shape": tag + " -> int32", "max_abs_err": 0.0,
                    "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                    "plain_ms": device_ms(
                        lambda: qmatmul_w8a8_i32_ref(a, w), 10),
                    "bound_ms": b, "bound_by": by,
                    "library_ms": _int_mm_ms(torch, a, w),
                    "library": "torch._int_mm" + (
                        "" if M > 16 else f", M zero-padded {M}->32"),
                    "splits": p.splits})
                if "model=1" in label:
                    # a model axis of 1 runs W8A16's single-device GEMM
                    # (phase 2's rows)
                    continue
                # the W8A16 row shard: float32 partials (the bf16
                # activation taken in float32), no bias
                x = x.float()
                y16 = qmatmul_w8a16_cuda(x, w, sw, None)
                y16r = qmatmul_w8a16_ref(x, w, sw, None, torch.float32)
            else:
                y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=bf)
                torch.cuda.synchronize()
                assert torch.equal(y, qmatmul_w8a8_ref(a, w, sa, sw, bias, bf)), (
                    f"qmatmul_w8a8 {tag}")
                b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + 2 * M * N,
                                 2 * M * K * N, INT8_OPS_S)
                kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw, bias,
                                                 out_dtype=bf)
                out["qmatmul_w8a8"].append({
                    "shape": tag + " -> bf16", "max_abs_err": 0.0,
                    "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                    "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                        a, w, sa, sw, bias, bf), 10),
                    "bound_ms": b, "bound_by": by,
                    "library_ms": _int_mm_ms(torch, a, w),
                    "library": "torch._int_mm (no epilogue)",
                    "splits": p.splits})
                if p.fold:
                    yq = qmatmul_w8a8_qin_cuda(x, w, sw, bias, out_dtype=bf)
                    torch.cuda.synchronize()
                    assert torch.equal(yq, qmatmul_w8a8_qin_ref(
                        x, w, sw, bias, bf)), f"qmatmul_w8a8_qin {tag}"
                    b, by = bound_ms(2 * M * K + K * N + 8 * N + 2 * M * N,
                                     2 * M * K * N, INT8_OPS_S)
                    kern = lambda: qmatmul_w8a8_qin_cuda(x, w, sw, bias,
                                                         out_dtype=bf)
                    out["qmatmul_w8a8_qin"].append({
                        "shape": tag + " bf16 -> bf16", "max_abs_err": 0.0,
                        "ms": device_ms(kern, 50),
                        "call_ms": call_ms(kern, 50),
                        "plain_ms": device_ms(lambda: qmatmul_w8a8_qin_ref(
                            x, w, sw, bias, bf), 10),
                        "bound_ms": b, "bound_by": by, "library_ms": None,
                        "splits": p.splits})
                y16 = qmatmul_w8a16_cuda(x, w, sw, bias)
                y16r = qmatmul_w8a16_ref(x, w, sw, bias, bf)
            torch.cuda.synchronize()
            tol = w8a16_tolerance(torch, x, w, sw, None if row_par else bias,
                                  y16r)
            err = (y16.float() - y16r.float()).abs()
            assert bool((err <= tol).all()), (
                f"qmatmul_w8a16 {tag}: max |diff| {float(err.max())}")
            od = torch.float32 if row_par else bf
            b, by = bound_ms(M * K * x.element_size() + K * N + 4 * N
                             + M * N * (4 if row_par else 2),
                             2 * M * K * N,
                             F32_OPS_S if row_par else BF16_OPS_S)
            bb = None if row_par else bias
            kern = lambda: qmatmul_w8a16_cuda(x, w, sw, bb)
            out["qmatmul_w8a16"].append({
                "shape": tag + (" -> f32 partials" if row_par else " -> bf16"),
                "max_abs_err": float(err.max()),
                "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a16_ref(
                    x, w, sw, bb, od), 10),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "splits": p.splits})
    for B, Hq, Hkv, hd, S in attention:
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        leaves, valid, q, kn, vn, idx = _decode_inputs(
            torch, dev, gen, B, S, Hq, Hkv, hd, bf, lens)
        tag = f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} bfloat16"
        got = [t.clone() for t in leaves]
        o = fused_decode_cuda(q, *got, kn, vn, idx.to(torch.int32), valid)
        want = [t.clone() for t in leaves]
        orf, _ = fused_decode_ref(q, *want, kn[:, None], vn[:, None],
                                  idx[:, None], valid=valid, out_dtype=bf)
        torch.cuda.synchronize()
        assert all(torch.equal(a_, b_) for a_, b_ in zip(got, want)), (
            f"fused_decode {tag}: appended leaves differ")
        diff, _ = check_attention_out(torch, o, orf, f"fused_decode {tag}")
        n_live = int(valid.sum())
        b, by = bound_ms(2 * B * Hq * hd * 2 + n_live * Hkv * (hd + 4) * 2
                         + B * S + 2 * B * Hkv * hd * 3 + 8 * B * Hkv,
                         4 * Hq * n_live * hd, F32_OPS_S)
        run = [t.clone() for t in leaves]
        idx32 = idx.to(torch.int32)
        kern = lambda: fused_decode_cuda(q, *run, kn, vn, idx32, valid)
        out["fused_decode"].append({
            "shape": tag + " (no quantize-out)", "max_abs_err": float(diff.max()),
            "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
            "plain_ms": device_ms(lambda: fused_decode_ref(
                q, *run, kn[:, None], vn[:, None], idx[:, None], valid=valid,
                out_dtype=bf), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None})
        kq, ks, vq, vs = leaves
        o = kv_attention_cuda(q, kq, ks, vq, vs, None)
        orf = kv_attention_ref(q, kq, ks, vq, vs, bf)
        torch.cuda.synchronize()
        diff, _ = check_attention_out(torch, o, orf, f"kv_attention {tag}")
        b, by = bound_ms(2 * B * Hq * hd * 2 + B * S * Hkv * 4
                         + n_live * Hkv * (2 * hd + 4), 4 * Hq * n_live * hd,
                         F32_OPS_S)
        kern = lambda: kv_attention_cuda(q, kq, ks, vq, vs, None)
        out["kv_attention"].append({
            "shape": tag, "max_abs_err": float(diff.max()),
            "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
            "plain_ms": device_ms(lambda: kv_attention_ref(
                q, kq, ks, vq, vs, bf), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None})
    for M, K in quantize:
        x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(bf)
        qa, sa = quantize_act_cuda(x)
        qr, sr = quantize_act_ref(x)
        torch.cuda.synchronize()
        assert torch.equal(qa, qr) and torch.equal(sa, sr), (
            f"quantize_act x[{M},{K}]")
        b, by = bound_ms(M * K * 2 + M * K + 4 * M, 5 * M * K, F32_OPS_S)
        out["quantize_act"].append({
            "shape": f"x[{M},{K}] bfloat16", "max_abs_err": 0.0,
            "ms": device_ms(lambda: quantize_act_cuda(x), 50),
            "call_ms": call_ms(lambda: quantize_act_cuda(x), 50),
            "plain_ms": device_ms(lambda: quantize_act_ref(x), 10),
            "bound_ms": b, "bound_by": by, "library_ms": None})
    for name, rows in out.items():
        for r in rows:
            log_row(name, r)
    return out


# the expert-batched GEMMs of the MoE archs (one launch a projection, E
# experts' rows in its grid): (arch, E, the expert rows M at a decode step
# and a prefill chunk — 8 slots x the capacity C — then the expert
# projections (label, K, N) and the router's (K, N = E), whose rows are the
# tokens': 8 a decode step, 256 a prefill chunk of 32)
EXPERT_GEMMS = (
    ("mixtral-8x22b", 8, (8, 80), (("gate/up", 6144, 16384),
                                   ("down", 16384, 6144)), (6144, 8)),
    ("llama4-scout-17b-a16e", 16, (8, 16), (("gate/up", 5120, 8192),
                                            ("down", 8192, 5120)), (5120, 16)),
)


def _experts_w(torch, gen, dev, E, K, N):
    """E K-major int8 weights [E, K, N] (storage [E, N, K])."""
    w = torch.randint(-127, 128, (E, N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    return w.transpose(1, 2)


def check_expert_gemms(torch, dev, gen):
    """The three GEMMs of the MoE path, expert-batched (``EXPERT_GEMMS``),
    each ONE launch: qmatmul_w8a8 bit-equal to its plain version expert by
    expert (bf16 out), qmatmul_w8a8_qin bit-equal to quantize_act +
    qmatmul_w8a8 where ``gemm_plan`` folds (every expert's int8 rows those
    of the flat quantize_act), qmatmul_w8a16 (bf16, the per-tensor [E, 1]
    scale the pack gives) within ``W8A16_TOL`` of each expert's plain
    version; the routers (N = 8, 16: one BN = 16 tile, its columns past N
    masked) as plain GEMMs at M = 8 and 256. Each timed beside its bound,
    the plain version (a loop over the experts) and a yardstick that is
    not the same function (no one PyTorch call is: ``library_ms`` None): a
    loop of ``torch._int_mm`` over the experts (W8A8, rows zero-padded to
    32 where M <= 16) or ``torch.bmm`` over the bf16-dequantized weights
    (W8A16). Returns the rows (the kernels JSON line takes mixtral's
    gate/up rows)."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_qin_ref,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    bf16 = torch.bfloat16
    rows = {"qmatmul_w8a8": [], "qmatmul_w8a8_qin": [], "qmatmul_w8a16": []}

    def one_launch(name, fn):
        reset_launch_counts()
        out = fn()
        assert launch_counts()[name] == 1, (
            f"{name}: {launch_counts()[name]} launches, not one")
        return out

    for arch, E, Ms, projs, (rK, rN) in EXPERT_GEMMS:
        cases = [(label, E, M, K, N) for label, K, N in projs for M in Ms]
        cases += [("router", 1, M, rK, rN) for M in (8, 256)]
        for label, e, M, K, N in cases:
            p = gemm_plan.plan(M, N, K, experts=e)
            shape = (f"E={e} M={M} K={K} N={N} ({arch} {label})" if e > 1
                     else f"M={M} K={K} N={N} ({arch} {label})")
            log(f"  gemm plan {shape}: {p.bm}-row tiles, {p.splits} K "
                f"split(s), {p.ctas} CTAs, quantize-in "
                + ("folds" if p.fold else "refused"))
            w = _experts_w(torch, gen, dev, e, K, N)
            if e == 1:
                w = w[0]
            lead = (e,) if e > 1 else ()
            sw = (torch.rand(lead + (1,), generator=gen, device=dev) * 0.01
                  + 1e-4)
            sw_n = sw.expand(lead + (N,)).contiguous()
            zero = torch.zeros(lead + (N,), device=dev)
            per = [slice(None)] if e == 1 else range(e)
            # W8A8
            a = torch.randint(-128, 128, lead + (M, K), generator=gen,
                              device=dev, dtype=torch.int8)
            sa = torch.rand(lead + (M,), generator=gen, device=dev) * 0.05 + 1e-4
            y = one_launch("qmatmul_w8a8", lambda: qmatmul_w8a8_cuda(
                a, w, sa, sw_n, zero, out_dtype=bf16))

            def plain8():
                return [qmatmul_w8a8_ref(a[i], w[i], sa[i], sw_n[i], zero[i],
                                         bf16) for i in per]
            torch.cuda.synchronize()
            for i, yr in zip(per, plain8()):
                assert torch.equal(y[i], yr), (
                    f"qmatmul_w8a8 {shape}: expert {i} not bit-equal")
            # torch._int_mm takes M > 16 only: rows zero-padded to 32
            a_lib = a if M > 16 else torch.cat(
                [a, a.new_zeros(lead + (32 - M, K))], -2)
            lib8 = (lambda: [torch._int_mm(a_lib[i], w[i]) for i in per])
            b, by = bound_ms(e * (M * K + K * N + 4 * M + 8 * N + 2 * M * N),
                             2 * e * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw_n, zero,
                                             out_dtype=bf16)
            row = {"shape": shape + " -> bf16", "mkn": [M, K, N],
                   "experts": e, "max_abs_err": 0.0,
                   "ms": device_ms(kern, 20), "call_ms": call_ms(kern, 20),
                   "plain_ms": device_ms(plain8, 3),
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "yardstick_ms": device_ms(lib8, 20),
                   "yardstick": ("a loop of torch._int_mm over the experts"
                                 if e > 1 else "torch._int_mm")
                   + ("" if M > 16 else f", M zero-padded {M}->32")}
            log_row("qmatmul_w8a8", row)
            rows["qmatmul_w8a8"].append(row)
            # W8A16 (bf16 x, the pack's per-tensor scale cast to bf16)
            x = torch.randn(lead + (M, K), generator=gen, device=dev).to(bf16)
            s16 = sw.to(bf16)
            y = one_launch("qmatmul_w8a16",
                           lambda: qmatmul_w8a16_cuda(x, w, s16, None))
            torch.cuda.synchronize()
            worst = 0.0
            for i in per:
                yr = qmatmul_w8a16_ref(x[i], w[i], s16[i], None, bf16)
                diff = (y[i].float() - yr.float()).abs()
                tol = w8a16_tolerance(torch, x[i], w[i], s16[i], None, yr)
                assert bool((diff <= tol).all()), (
                    f"qmatmul_w8a16 {shape}: expert {i} off the plain version "
                    f"at {int((diff > tol).sum())} values "
                    f"({W8A16_TOL['bfloat16']})")
                worst = max(worst, float(diff.max()))
                del yr, diff, tol
            w_deq = (w.float() * s16.float()[..., None, :]).to(bf16)
            lib16 = ((lambda: torch.bmm(x, w_deq)) if e > 1
                     else (lambda: x @ w_deq))
            b, by = bound_ms(e * (2 * M * K + K * N + 2 + 2 * M * N),
                             2 * e * M * K * N, BF16_OPS_S)
            kern = lambda: qmatmul_w8a16_cuda(x, w, s16, None)
            row = {"shape": shape + " bfloat16", "mkn": [M, K, N],
                   "experts": e, "max_abs_err": worst,
                   "ms": device_ms(kern, 20), "call_ms": call_ms(kern, 20),
                   "plain_ms": device_ms(lambda: [qmatmul_w8a16_ref(
                       x[i], w[i], s16[i], None, bf16) for i in per], 3),
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "yardstick_ms": device_ms(lib16, 20),
                   "yardstick": ("torch.bmm" if e > 1 else "matmul")
                   + " over the bf16-dequantized weights"}
            del w_deq
            log_row("qmatmul_w8a16", row)
            rows["qmatmul_w8a16"].append(row)
            # the quantize-in W8A8 GEMM, where the plan folds
            if not p.fold:
                continue
            xq = torch.stack([_qin_input(torch, gen, dev, M, K, bf16)
                              for _ in range(e)]) if e > 1 else \
                _qin_input(torch, gen, dev, M, K, bf16)
            a_q, a_s = quantize_act_cuda(xq.reshape(-1, K))
            a_q, a_s = a_q.reshape(xq.shape), a_s.reshape(xq.shape[:-1])
            pair = qmatmul_w8a8_cuda(a_q, w, a_s, sw_n, zero, out_dtype=bf16)
            y, x_q, x_s = one_launch(
                "qmatmul_w8a8_qin", lambda: qmatmul_w8a8_qin_cuda(
                    xq, w, sw_n, zero, out_dtype=bf16, quantized=True))
            torch.cuda.synchronize()
            assert torch.equal(y, pair), (
                f"qmatmul_w8a8_qin {shape}: not bit-equal to quantize_act + "
                f"qmatmul_w8a8")
            assert torch.equal(x_q, a_q) and torch.equal(x_s, a_s)
            for i in per:
                assert torch.equal(y[i], qmatmul_w8a8_qin_ref(
                    xq[i], w[i], sw_n[i], zero[i], bf16)), (
                    f"qmatmul_w8a8_qin {shape}: expert {i} off its plain "
                    f"version")
            b, by = bound_ms(e * (2 * M * K + K * N + 8 * N + 2 * M * N),
                             2 * e * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_qin_cuda(xq, w, sw_n, zero,
                                                 out_dtype=bf16)

            def pair_call():
                q_, s_ = quantize_act_cuda(xq.reshape(-1, K))
                return qmatmul_w8a8_cuda(q_.reshape(xq.shape), w,
                                         s_.reshape(xq.shape[:-1]), sw_n,
                                         zero, out_dtype=bf16)

            row = {"shape": shape + " bf16 -> bf16", "mkn": [M, K, N],
                   "experts": e, "max_abs_err": 0.0,
                   "ms": device_ms(kern, 20), "call_ms": call_ms(kern, 20),
                   "plain_ms": device_ms(lambda: [qmatmul_w8a8_qin_ref(
                       xq[i], w[i], sw_n[i], zero[i], bf16) for i in per], 3),
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "stepwise_ms": device_ms(pair_call, 20)}
            log_row("qmatmul_w8a8_qin", row)
            rows["qmatmul_w8a8_qin"].append(row)
    log("  the expert-batched GEMMs: one launch a projection, W8A8 and the "
        "quantize-in fold bit-equal, W8A16 within its tolerance, at every "
        "expert shape and both routers")
    return rows


# the per-rank expert shapes of tensor-parallel MoE serving (phase 14): the
# row-parallel expert down through the expert-batched int32 GEMM — (arch,
# mesh, E, the expert rows M a rank at a decode step and a prefill chunk of
# 32, K, N): a model axis of 2 cuts mixtral's K = 16384 to 8192 and
# llama4's 8192 to 4096, a data axis of 2 halves the slots (4 a rank), a
# 1x1 mesh keeps both (14b's decode step);
# then the cut expert gate/up (K, N = F/2), W8A8 (quantize-in where
# gemm_plan folds) and W8A16, at both row counts
MOE_TP_DOWN = (("mixtral-8x22b", "1x2", 8, (8, 80), 8192, 6144),
               ("mixtral-8x22b", "2x1", 8, (4, 40), 16384, 6144),
               ("mixtral-8x22b", "1x1", 8, (8,), 16384, 6144),
               ("llama4-scout-17b-a16e", "1x2", 16, (8, 16), 4096, 5120))
MOE_TP_GATE_UP = (("mixtral-8x22b", 8, (8, 80), 6144, 8192),
                  ("llama4-scout-17b-a16e", 16, (8, 16), 5120, 4096))
# and mixtral's dense per-rank shapes (``check_tp_shapes``' tables): q
# (48 heads of 128) and k / v (8) cut to this rank's heads at 1x2, o
# row-parallel at the cut K = 3072 and the whole 6144 (2x1, 1x1);
# head-local decode attention at 1x2 (24 q heads over 4 KV heads), the
# whole heads at 4 slots (2x1) and 8 (1x1); quantize_act of the gathered
# expert rows (E x the slots' capacity rows, K = 16384: 1x2 and 1x1 a
# decode step and a prefill chunk, 2x1 a decode step) and of o's rows
MOE_TP_COLUMN = (("mixtral q", 6144, 3072), ("mixtral k/v", 6144, 512))
MOE_TP_ROW = (("mixtral o", 3072, 6144), ("mixtral o model=1", 6144, 6144))
MOE_TP_ATTENTION = ((8, 24, 4, 128, 512), (4, 48, 8, 128, 512),
                    (8, 48, 8, 128, 512))
MOE_TP_QUANTIZE = ((64, 16384), (640, 16384), (32, 16384), (8, 6144))


def check_moe_tp_shapes(torch, dev, gen):
    """Every per-rank expert GEMM of phase 14 against its plain version:
    ``qmatmul_w8a8_i32`` with the expert axis (``MOE_TP_DOWN``) ONE launch
    (``qmatmul_w8a8_i32_experts``), each expert's accumulator its plain
    version's, and through ``w8a8_epilogue`` (per-expert scales [E, M] and
    [E, 1]) the expert-batched ``qmatmul_w8a8``'s bits in bfloat16 and
    float32; at a model axis of 2 (1x2) also W8A16's expert down, ONE
    launch of ``qmatmul_w8a16`` on float32 rows (the float32 partials
    ``_row_linear`` sums), each expert within ``W8A16_TOL`` of its plain
    version; the cut gate/up (``MOE_TP_GATE_UP``) as the quantize-in W8A8
    GEMM where the plan folds (else ``qmatmul_w8a8`` on quantize_act's rows)
    bit-equal to its plain version, and as ``qmatmul_w8a16`` within
    ``W8A16_TOL``. Each row timed beside its bound and plain version; a
    loop of ``torch._int_mm`` over the experts is the int32 rows' yardstick
    (no one PyTorch call computes an expert-batched product:
    ``library_ms`` None). Returns {kernel: rows}."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_i32_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_i32_ref,
        qmatmul_w8a8_qin_ref,
        qmatmul_w8a8_ref,
        w8a8_epilogue,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    bf = torch.bfloat16
    out = {"qmatmul_w8a8_i32_experts": [], "qmatmul_w8a8": [],
           "qmatmul_w8a8_qin": [], "qmatmul_w8a16": []}
    for arch, mesh, E, Ms, K, N in MOE_TP_DOWN:
        w = _experts_w(torch, gen, dev, E, K, N)
        sw = torch.rand((E, 1), generator=gen, device=dev) * 0.01 + 1e-4
        sw_n = sw.expand(E, N).contiguous()
        zero = torch.zeros((E, N), device=dev)
        for M in Ms:
            tag = f"E={E} M={M} K={K} N={N} ({arch} down, a rank at {mesh})"
            p = gemm_plan.plan(M, N, K, experts=E)
            a = torch.randint(-128, 128, (E, M, K), generator=gen,
                              device=dev, dtype=torch.int8)
            sa = torch.rand((E, M), generator=gen, device=dev) * 0.05 + 1e-4
            reset_launch_counts()
            acc = qmatmul_w8a8_i32_cuda(a, w)
            assert launch_counts().get("qmatmul_w8a8_i32_experts") == 1, (
                f"qmatmul_w8a8_i32 {tag}: {launch_counts()}")
            torch.cuda.synchronize()
            for e in range(E):
                assert torch.equal(acc[e], qmatmul_w8a8_i32_ref(a[e], w[e])), (
                    f"qmatmul_w8a8_i32 {tag}: expert {e} off its plain "
                    f"version")
            for od in (bf, torch.float32):
                y = qmatmul_w8a8_cuda(a, w, sa, sw_n, zero, out_dtype=od)
                assert torch.equal(w8a8_epilogue(acc, sa, sw, None, od), y), (
                    f"qmatmul_w8a8_i32 {tag} + epilogue != qmatmul_w8a8 {od}")
            a_lib = a if M > 16 else torch.cat(
                [a, a.new_zeros((E, 32 - M, K))], 1)
            b, by = bound_ms(E * (M * K + K * N + 4 * M * N),
                             2 * E * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_i32_cuda(a, w)
            out["qmatmul_w8a8_i32_experts"].append({
                "shape": tag + " -> int32", "max_abs_err": 0.0,
                "ms": device_ms(kern, 20), "call_ms": call_ms(kern, 20),
                "plain_ms": device_ms(lambda: [qmatmul_w8a8_i32_ref(
                    a[e], w[e]) for e in range(E)], 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "yardstick_ms": device_ms(lambda: [torch._int_mm(
                    a_lib[e], w[e]) for e in range(E)], 20),
                "yardstick": "a loop of torch._int_mm over the experts"
                + ("" if M > 16 else f", M zero-padded {M}->32"),
                "with_epilogue_ms": device_ms(lambda: qmatmul_w8a8_cuda(
                    a, w, sa, sw_n, zero, out_dtype=bf), 20),
                "splits": p.splits})
            if mesh != "1x2":
                continue
            # W8A16 at a model axis of 2: the expert down's float32
            # partials (``_row_linear``: the bf16 hidden rows taken in
            # float32, the bf16-cast scale), one expert-batched launch of
            # the float32 kernel
            x = torch.randn((E, M, K), generator=gen, device=dev).to(bf).float()
            s16 = sw.to(bf)
            reset_launch_counts()
            y = qmatmul_w8a16_cuda(x, w, s16, None)
            assert launch_counts().get("qmatmul_w8a16") == 1, (
                f"qmatmul_w8a16 {tag} float32: {launch_counts()}")
            torch.cuda.synchronize()
            worst = 0.0
            for e in range(E):
                yr = qmatmul_w8a16_ref(x[e], w[e], s16[e], None, torch.float32)
                diff = (y[e] - yr).abs()
                tol = w8a16_tolerance(torch, x[e], w[e], s16[e], None, yr)
                assert bool((diff <= tol).all()), (
                    f"qmatmul_w8a16 {tag} float32: expert {e} off its plain "
                    f"version at {int((diff > tol).sum())} values")
                worst = max(worst, float(diff.max()))
            b, by = bound_ms(E * (4 * M * K + K * N + 2 + 4 * M * N),
                             2 * E * M * K * N, F32_OPS_S)
            kern = lambda: qmatmul_w8a16_cuda(x, w, s16, None)
            out["qmatmul_w8a16"].append({
                "shape": tag + " float32 -> f32 partials",
                "max_abs_err": worst, "ms": device_ms(kern, 20),
                "call_ms": call_ms(kern, 20),
                "plain_ms": device_ms(lambda: [qmatmul_w8a16_ref(
                    x[e], w[e], s16[e], None, torch.float32)
                    for e in range(E)], 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "splits": p.splits})
        del w
    for arch, E, Ms, K, N in MOE_TP_GATE_UP:
        w = _experts_w(torch, gen, dev, E, K, N)
        sw = torch.rand((E, 1), generator=gen, device=dev) * 0.01 + 1e-4
        sw_n = sw.expand(E, N).contiguous()
        zero = torch.zeros((E, N), device=dev)
        for M in Ms:
            tag = f"E={E} M={M} K={K} N={N} ({arch} gate/up, a rank at 1x2)"
            p = gemm_plan.plan(M, N, K, experts=E)
            x = torch.stack([_qin_input(torch, gen, dev, M, K, bf)
                             for _ in range(E)])
            if p.fold:
                y = qmatmul_w8a8_qin_cuda(x, w, sw_n, zero, out_dtype=bf)
                torch.cuda.synchronize()
                for e in range(E):
                    assert torch.equal(y[e], qmatmul_w8a8_qin_ref(
                        x[e], w[e], sw_n[e], zero[e], bf)), (
                        f"qmatmul_w8a8_qin {tag}: expert {e}")
                b, by = bound_ms(E * (2 * M * K + K * N + 8 * N + 2 * M * N),
                                 2 * E * M * K * N, INT8_OPS_S)
                kern = lambda: qmatmul_w8a8_qin_cuda(x, w, sw_n, zero,
                                                     out_dtype=bf)
                name = "qmatmul_w8a8_qin"
                plain = lambda: [qmatmul_w8a8_qin_ref(
                    x[e], w[e], sw_n[e], zero[e], bf) for e in range(E)]
            else:
                a = torch.randint(-128, 128, (E, M, K), generator=gen,
                                  device=dev, dtype=torch.int8)
                sa = (torch.rand((E, M), generator=gen, device=dev) * 0.05
                      + 1e-4)
                y = qmatmul_w8a8_cuda(a, w, sa, sw_n, zero, out_dtype=bf)
                torch.cuda.synchronize()
                for e in range(E):
                    assert torch.equal(y[e], qmatmul_w8a8_ref(
                        a[e], w[e], sa[e], sw_n[e], zero[e], bf)), (
                        f"qmatmul_w8a8 {tag}: expert {e}")
                b, by = bound_ms(E * (M * K + K * N + 4 * M + 8 * N
                                      + 2 * M * N),
                                 2 * E * M * K * N, INT8_OPS_S)
                kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw_n, zero,
                                                 out_dtype=bf)
                name = "qmatmul_w8a8"
                plain = lambda: [qmatmul_w8a8_ref(
                    a[e], w[e], sa[e], sw_n[e], zero[e], bf)
                    for e in range(E)]
            out[name].append({
                "shape": tag + (" bf16 -> bf16" if p.fold else " -> bf16"),
                "max_abs_err": 0.0, "ms": device_ms(kern, 20),
                "call_ms": call_ms(kern, 20), "plain_ms": device_ms(plain, 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "splits": p.splits})
            s16 = sw.to(bf)
            y = qmatmul_w8a16_cuda(x, w, s16, None)
            torch.cuda.synchronize()
            worst = 0.0
            for e in range(E):
                yr = qmatmul_w8a16_ref(x[e], w[e], s16[e], None, bf)
                diff = (y[e].float() - yr.float()).abs()
                tol = w8a16_tolerance(torch, x[e], w[e], s16[e], None, yr)
                assert bool((diff <= tol).all()), (
                    f"qmatmul_w8a16 {tag}: expert {e} off its plain version")
                worst = max(worst, float(diff.max()))
            b, by = bound_ms(E * (2 * M * K + K * N + 2 + 2 * M * N),
                             2 * E * M * K * N, BF16_OPS_S)
            kern = lambda: qmatmul_w8a16_cuda(x, w, s16, None)
            out["qmatmul_w8a16"].append({
                "shape": tag + " bfloat16", "max_abs_err": worst,
                "ms": device_ms(kern, 20), "call_ms": call_ms(kern, 20),
                "plain_ms": device_ms(lambda: [qmatmul_w8a16_ref(
                    x[e], w[e], s16[e], None, bf) for e in range(E)], 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "splits": p.splits})
        del w
    for name, rows in out.items():
        for r in rows:
            log_row(name, r)
            if "with_epilogue_ms" in r:
                log(f"    + epilogue as qmatmul_w8a8 (one launch, bf16 out): "
                    f"{r['with_epilogue_ms'] * 1e3:.2f} us")
    log("  the per-rank expert GEMMs of phase 14: the expert-batched int32 "
        "GEMM one launch, bit-equal to its plain version and through the "
        "epilogue to qmatmul_w8a8; the cut gate/up bit-equal (W8A8) and "
        "within W8A16_TOL")
    return out


# --------------------------------------------------------------- phase 3
def hostile_params(torch, model, device="cpu"):
    """Seeded weights that give every rewrite work: log-normal norm gains,
    random q/k/v/o biases, and the MLP's hidden channels spread over two
    decades each way (up times s, down divided by s: the same function).
    Drawn on ``device`` from a generator there: the smoke model's on the
    CPU (the card's quantize moves them), the full-width one's on the
    card."""
    gen = torch.Generator(device=device).manual_seed(2)
    params = model.init(0, device=device)
    blocks, mlp = params["blocks"], params["blocks"]["mlp"]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    for norm in ("attn_norm", "mlp_norm"):
        blocks[norm]["w"] = torch.exp(randn(blocks[norm]["w"].shape) * 0.5)
    for k in ("bq", "bk", "bv", "bo"):
        blocks["attn"][k] = randn(blocks["attn"][k].shape) * 0.5
    L, _, F = mlp["wu"].shape
    s = torch.exp(randn((L, F)) * 2.3)
    mlp["wu"] = mlp["wu"] * s[:, None, :]
    mlp["wd"] = mlp["wd"] / s[:, :, None]
    return params


def _leaves(tree, path=()):
    from repro_torch.quantized import QTensor

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, QTensor):
        yield path + ("q",), tree.q
        yield path + ("scale",), tree.scale
    elif isinstance(tree, (list, tuple)):        # a train state
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


# the bias-corrected int8 deployment: the serve-w8a8-kv8 stages with the
# paper's weight bias correction before the pack (whose symmetric int8
# quantizer ε then targets)
BC_DEPLOY = ["fold_norm", "cle", "bias_absorb", "bias_correct",
             ("pack", {"mode": "w8a8"}), ("kv_cache", {"bits": 8})]
# E[x] of the card's calibration forward against the CPU's, per stat key:
# within STAT_TOL · max |E[x]| (tests/test_torch_bias_correction.py's bound
# for the port against the JAX package: two float32 forwards summing in
# other orders)
STAT_TOL = 2.0 ** -16


def recipe_label(recipe) -> str:
    return recipe if isinstance(recipe, str) else "bias-corrected w8a8"


def recording(calibrate, into):
    """``calibrate`` that also keeps the E[x] it returned in ``into``."""
    def hook(params):
        into.update(calibrate(params))
        return into
    return hook


def correction_bounds(torch, model, params, recipe, e_cpu, e_card):
    """{bias path: bound} of a recipe's bias correction, card against CPU:
    |δ| @ |ε| + 2·D·2^-24·(|E[x]| @ |ε|), δ the gap between the two sides'
    E[x] and ε the quantization error of the equalized weights under the
    spec the recipe's bias_correct used (plus one ulp of |b|, added by the
    caller)."""
    import repro_torch
    from repro_torch.core import DFQConfig, weight_quant_error
    from repro_torch.core.tree import get_path
    from repro_torch.pipeline.api import _fold_weight_spec_overrides
    from repro_torch.pipeline.recipes import resolve_recipe

    r = resolve_recipe(recipe)
    stages = r.stage_names()
    spec = _fold_weight_spec_overrides(r, DFQConfig()).weight_spec
    eq = repro_torch.quantize(model, params, calibration=None, device="cpu",
                              recipe=list(r.steps[:stages.index("bias_correct")])
                              ).params
    out = {}
    for site in model.dfq_plan().sites:
        eps = weight_quant_error(get_path(eq, site.w), spec).abs().double()
        e = e_cpu[site.stat_key].double()
        delta = (e_card[site.stat_key].cpu().double() - e).abs()
        D = eps.shape[-2]
        out[site.b] = (torch.einsum("...i,...io->...o", delta, eps)
                       + 2 * D * 2.0 ** -24
                       * torch.einsum("...i,...io->...o", e.abs(), eps))
    return out


def check_dfq_on_card(torch, dev, model, params, recipe):
    """``repro_torch.quantize`` on the card against the same call on the
    CPU, on the same calibration tokens (drawn on the host): every int8
    payload, scale and weight leaf bit-equal, since quantization reads the
    weights only; E[x] within ``STAT_TOL``; a bias the recipe corrected
    within ``correction_bounds`` plus one float32 ulp; ``bo``'s value-bias
    shift, a matrix product summed in another order, within that product's
    rounding bound n · 2^-23 · (|c| @ |wo|) (added to its correction's,
    where the recipe absorbs); the stage records equal and the per-site
    SQNR within 1e-4 dB. Returns (CPU, card) QuantizedModels."""
    import repro_torch
    from repro_torch.pipeline import default_calibration
    from repro_torch.pipeline.recipes import resolve_recipe

    cfg = model.cfg
    e_cpu, e_card = {}, {}
    hook = default_calibration(model, cfg)
    cpu = repro_torch.quantize(model, params, recipe=recipe, device="cpu",
                               calibration=recording(hook, e_cpu))
    card = repro_torch.quantize(model, params, recipe=recipe, device=dev,
                                calibration=recording(hook, e_card))
    name = recipe_label(recipe)
    stages = resolve_recipe(recipe).stage_names()
    tol = {}
    if "bias_absorb" in stages and cfg.qkv_bias:
        attn = repro_torch.quantize(model, params, recipe=["fold_norm", "cle"],
                                    device="cpu").params["blocks"]["attn"]
        group = cfg.n_heads // cfg.n_kv_heads
        L = attn["bv"].shape[0]
        c = attn["bv"].reshape(L, cfg.n_kv_heads, 1, cfg.head_dim).expand(
            L, cfg.n_kv_heads, group, cfg.head_dim).reshape(L, -1)
        tol[("blocks", "attn", "bo")] = c.shape[-1] * 2.0 ** -23 * torch.einsum(
            "ln,lno->lo", c.abs(), attn["wo"].abs()).double()
    stat_err = 0.0
    if "bias_correct" in stages:
        assert sorted(e_cpu) == sorted(e_card) and e_cpu, name
        for k, e in e_cpu.items():
            err = float((e_card[k].cpu() - e).abs().max())
            assert err <= STAT_TOL * float(e.abs().max()), (
                f"{name}: E[x] {k} on the card off the CPU's by {err}")
            stat_err = max(stat_err, err / float(e.abs().max()))
        for path, b in correction_bounds(torch, model, params, recipe, e_cpu,
                                         e_card).items():
            tol[path] = tol.get(path, 0) + b
    want, got = dict(_leaves(cpu.params)), dict(_leaves(card.params))
    assert sorted(want) == sorted(got), f"{name}: card tree differs"
    worst = {}
    for path, t in want.items():
        g = got[path].cpu()
        assert g.dtype == t.dtype and g.shape == t.shape, path
        if path in tol:
            diff = (g - t).abs().double()
            ulp = (torch.nextafter(torch.maximum(t.abs(), g.abs()),
                                   torch.tensor(float("inf"))) - t.abs()
                   ).abs().double()
            assert bool((diff <= tol[path] + ulp).all()), (
                f"{name}: {'/'.join(path)} on the card off the CPU's by "
                f"{float(diff.max())}")
            worst[path[-1]] = float(diff.max())
        else:
            assert torch.equal(g, t), (
                f"{name}: {'/'.join(path)} on the card differs from the "
                f"CPU's at {int((g != t).sum())} of {t.numel()}")
    snr = {}
    for rc, rg in zip(cpu.report, card.report):
        mc, mg = dict(rc["metrics"]), dict(rg["metrics"])
        assert rc["stage"] == rg["stage"], name
        sc, sg = mc.pop("sqnr_db", {}), mg.pop("sqnr_db", {})
        for k in ("sqnr_min_db", "sqnr_mean_db"):
            if k in mc:
                snr[k] = abs(mc.pop(k) - mg.pop(k))
        assert mc == mg, f"{name}: stage {rc['stage']} records differ"
        assert sorted(sc) == sorted(sg), name
        snr.update({k: abs(sc[k] - sg[k]) for k in sc})
    assert max(snr.values()) <= 1e-4, f"{name}: per-site SQNR differs"
    log(f"  {name} on the card vs the CPU (smoke, weights that need every "
        f"rewrite): {len(want) - len(worst)} leaves bit-equal, "
        + (f"E[x] max |diff| {stat_err:.3g} of max |E[x]|, " if stat_err else "")
        + ("bounded max |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in sorted(worst.items())) + ", "
           if worst else "")
        + f"stage records equal, per-site SQNR max |diff| "
        f"{max(snr.values()):.3g} dB")
    return cpu, card


def check_reference(torch, dev, recipe, kv_bits=8):
    """Smoke-size qwen2 under ``recipe``: DFQ on the card against DFQ on
    the CPU, then the model on the card (kernels) against the CPU (plain
    versions), over the int8 KV cache (``kv_bits`` 8) or the fp one."""
    import repro_torch

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    cpu, card = check_dfq_on_card(torch, dev, model,
                                  hostile_params(torch, model), recipe)
    teacher_forced(torch, dev, model.cfg, cpu.params, card.params, kv_bits,
                   f"smoke qwen2 (2 layers, f32) under "
                   f"{recipe_label(recipe)}")


def teacher_forced(torch, dev, cfg, cpu_params, card_params, kv_bits, what):
    """The model at ``cfg`` on the card (kernels) against the CPU (plain
    versions), over the int8 KV cache (``kv_bits`` 8) or the fp one: prefill
    8 tokens, then 16 teacher-forced decode steps, every step's logits
    within 5 % of the largest |logit| and greedy agreement at least 0.9."""
    import repro_torch

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
    out = {}
    for name, d, p in (("cpu", "cpu", cpu_params), ("cuda", dev, card_params)):
        m = repro_torch.build_model(cfg)
        cache = m.init_cache(4, 32, device=d, kv_bits=kv_bits)
        lg, cache = m.prefill(p, toks[:, :8].to(d), cache)
        steps = [lg]
        for t in range(8, 24):
            lg, cache = m.decode_step(p, toks[:, t:t + 1].to(d), cache)
            steps.append(lg)
        out[name] = torch.stack(steps).float().cpu()
    diff = float((out["cpu"] - out["cuda"]).abs().max())
    scale = float(out["cpu"].abs().max())
    agree = float((out["cpu"].argmax(-1) == out["cuda"].argmax(-1)).float().mean())
    log(f"  {what}, {'int8' if kv_bits == 8 else 'fp'} KV cache, card vs "
        f"CPU plain versions, prefill 8 + 16 teacher-forced decode steps: "
        f"max |logit diff| {diff:.3g} (max |logit| {scale:.3g}), greedy "
        f"agreement {agree:.3f}")
    assert all(torch.isfinite(v).all() for v in out.values())
    assert diff <= 0.05 * scale and agree >= 0.9, "card and CPU disagree"


def check_hostile_gate(torch, dev):
    """``tests/test_dfq_integration.py``'s gate, on the card: on the hostile
    smoke weights per-tensor INT8 (naive-int8) collapses and dfq-int8
    recovers — logits SQNR above naive-int8's by 10 dB, greedy agreement
    with fp above 0.9, on synthetic tokens of another seed than the
    calibration's."""
    import repro_torch
    from repro_torch.core import sqnr_db
    from repro_torch.data import calibration_tokens

    from repro_torch.quantized import map_leaves

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    params = hostile_params(torch, model)
    toks = calibration_tokens(0, 2, 16, model.cfg.vocab_size, device=dev)
    y_fp = model.apply(map_leaves(lambda t: t.to(dev), params), toks)
    snr, agree = {}, {}
    for recipe in ("naive-int8", "dfq-int8"):
        y = model.apply(repro_torch.quantize(model, params, recipe=recipe,
                                             device=dev).params, toks)
        snr[recipe] = float(sqnr_db(y_fp, y))
        agree[recipe] = float((y.argmax(-1) == y_fp.argmax(-1)).float().mean())
    log(f"  hostile smoke gate on the card: logits SQNR naive-int8 "
        f"{snr['naive-int8']:.2f} dB, dfq-int8 {snr['dfq-int8']:.2f} dB; "
        f"greedy agreement with fp {agree['naive-int8']:.3f} / "
        f"{agree['dfq-int8']:.3f}")
    assert snr["dfq-int8"] > snr["naive-int8"] + 10.0, snr
    assert agree["dfq-int8"] > 0.9, agree


# the serving run of phase 4: qwen2-0.5b at full width, 8 slots, 16 requests
SERVE = dict(arch="qwen2-0.5b", seed=0, device="cuda", slots=8, max_len=512,
             prefill_chunk=32, trace=16, trace_seed=0, prompt_min=32,
             prompt_len=256, gen_min=32, gen_len=32)


def layer_inputs(cfg, T):
    """The inputs of a layer's projections at T tokens a batch row, each
    (K, the N of every projection reading it, the experts E of its launch,
    its rows a batch row): qkv, wo, then gate/up (up alone without a gate)
    and down — an MoE layer's as the router (its E columns, every token)
    and the experts' projections, each one expert-batched launch over the
    capacity C = max(1, int(T·top_k/E·capacity_factor)) rows a batch row
    of every expert (the shared expert is not a weight site: float, no
    kernel)."""
    D, F, A, KV = cfg.d_model, cfg.d_ff, cfg.attn_dim, cfg.kv_dim
    gate = (F, F) if cfg.act.endswith("_glu") else (F,)
    ins = [(D, (A, KV, KV), 1, T), (A, (D,), 1, T)]
    if not cfg.n_experts:
        return ins + [(D, gate, 1, T), (F, (D,), 1, T)]
    E = cfg.n_experts
    C = max(1, int(T * cfg.top_k / E * cfg.capacity_factor))
    return ins + [(D, (E,), 1, T), (D, gate, E, C), (F, (D,), E, C)]


def expected_launches(quantize, fused, steps, chunks, *, cfg=None,
                      kv_bits=8, slots=None, chunk=None):
    """{kernel: launches} of one serve run: per decode step (one token a
    slot) and per prefill chunk (``chunk`` tokens a slot), every layer's
    projections (``layer_inputs``: M = slots x its rows a batch row; an
    expert projection one launch for all its experts; ``cfg`` defaults to
    qwen2-0.5b's, the slots and chunk to ``SERVE``'s). Over the int8 cache (``kv_bits`` 8) the fused
    decode once a layer per decode step, or kv_attention on the unfused
    route; over the fp cache no attention kernel (plain maths, as in the
    reference). W8A16: one qmatmul_w8a16 a projection. W8A8, as
    ``gemm_plan`` says for each input of a layer: where the plan folds for
    every projection reading it, the first is one qmatmul_w8a8_qin, which
    hands its quantized input to the others (an int8 GEMM each);
    elsewhere one quantize_act and an int8 GEMM each; except wo at a fused
    decode step, an int8 GEMM on the fused kernel's quantize-out.
    ``quantize="none"``: no GEMM kernel."""
    import repro_torch
    from repro_torch.kernels import gemm_plan

    cfg = cfg or repro_torch.get_config(SERVE["arch"])
    slots = slots or SERVE["slots"]
    chunk = chunk or SERVE["prefill_chunk"]
    L = cfg.n_layers
    want = {}
    if kv_bits == 8:
        want["fused_decode" if fused else "kv_attention"] = L * steps
    if quantize == "w8a16":
        want["qmatmul_w8a16"] = (sum(len(Ns) for _, Ns, _, _ in
                                     layer_inputs(cfg, 1)) * L
                                 * (steps + chunks))
    if quantize != "w8a8":
        return want
    want.update(quantize_act=0, qmatmul_w8a8=0, qmatmul_w8a8_qin=0)
    for T, n, decode in ((1, steps, True), (chunk, chunks, False)):
        for i, (K, Ns, E, rows) in enumerate(layer_inputs(cfg, T)):
            M = slots * rows
            if decode and i == 1 and kv_bits == 8 and fused:
                want["qmatmul_w8a8"] += L * n
            elif all(gemm_plan.plan(M, N, K, experts=E).fold for N in Ns):
                want["qmatmul_w8a8_qin"] += L * n
                want["qmatmul_w8a8"] += (len(Ns) - 1) * L * n
            else:
                want["quantize_act"] += L * n
                want["qmatmul_w8a8"] += len(Ns) * L * n
    return want


def forwards(run):
    """(decode steps, prefill dispatches) a serve run made on the card: its
    timed loop's, plus its warmup's (the throwaway traffic and the masked
    dispatch before each capture), one forward each."""
    warm = run.warmup or {}
    return (run.stats["decode_steps"] + warm.get("decode_steps", 0),
            run.stats["prefill_dispatches"] + warm.get("prefill_dispatches", 0))


def check_served(run, counts, label, want, trace=SERVE["trace"]):
    """Every one of the ``trace`` requests finished with 32 tokens and
    finite logits; the launch counts (reset just before the run, read just
    after) are ``want``'s, and 0 for every other kernel."""
    assert len(run.results) == trace, (
        f"{label}: {len(run.results)} of {trace} served")
    for r in run.results.values():
        assert r.status == "ok", f"{label}: request {r.rid}: {r.status}"
        assert len(r.tokens) == 32, f"{label}: request {r.rid}: {len(r.tokens)} tokens"
    st = run.stats
    warm = run.warmup or {}
    graphs = (f", {warm['graphs']} graphs captured in "
              f"{warm['capture_seconds']:.2f} s (warmup {warm['seconds']:.2f} s),"
              f" graph pool {warm['graph_pool_bytes'] / 2**20:.1f} MiB"
              if "graphs" in warm else "")
    log(f"  {label}: {trace}/{trace} requests finished with 32 tokens and "
        f"finite logits, {run.generated_tokens} tokens in {run.seconds:.3f} s = "
        f"{run.tokens_per_second:.1f} tok/s ({run.path} path, "
        f"{SERVE['slots']} slots, {st['decode_steps']} decode steps in "
        f"{st['decode_dispatches']} dispatches (mean horizon "
        f"{st['decode_steps'] / st['decode_dispatches']:.2f}), "
        f"{st['prefill_chunks']} prefill chunks in "
        f"{st['prefill_dispatches']} dispatches, "
        f"{st['host_syncs'] / st['generated_tokens']:.3f} host syncs/token"
        f"{graphs})")
    log(f"  kernel launches on the {label} path: {json.dumps(counts)}")
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")


def same_tokens(run, ref, what):
    """Every request of ``run`` got ``ref``'s tokens and finish tick."""
    for rid, r in ref.results.items():
        got = run.results[rid]
        assert got.tokens == r.tokens, f"{what}: request {rid}: other tokens"
        assert got.finished_at == r.finished_at, (
            f"{what}: request {rid}: finished at tick {got.finished_at}, "
            f"not {r.finished_at}")


class fused_route:
    """``with fused_route(False):`` sets REPRO_FUSED_DECODE=0 for the block
    (the unfused decode route), and restores it after."""

    def __init__(self, fused: bool):
        self.fused = fused

    def __enter__(self):
        self.saved = os.environ.get("REPRO_FUSED_DECODE")
        if not self.fused:
            os.environ["REPRO_FUSED_DECODE"] = "0"

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("REPRO_FUSED_DECODE", None)
        else:
            os.environ["REPRO_FUSED_DECODE"] = self.saved


def counted_serve(config, fused=True):
    """``repro_torch.serve(config)`` with the launch counts reset just
    before and read just after; ``fused=False`` sets REPRO_FUSED_DECODE=0
    for this run only. Returns (run, counts)."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    with fused_route(fused):
        reset_launch_counts()
        run = repro_torch.serve(config)
        return run, launch_counts()


def serve_full_width(torch, quantize, *, fused=True, reference=False,
                     profile=False):
    """``repro_torch.serve`` of qwen2-0.5b at full width under
    ``serve-<quantize>-kv8``: the fast path with every graph captured by
    ``warmup`` before the timed loop, or the stepwise path
    (``reference``); ``fused=False`` sets REPRO_FUSED_DECODE=0 for this
    run only."""
    import repro_torch

    config = repro_torch.ServeConfig(quantize=quantize, kv_bits=8,
                                     reference=reference,
                                     warmup=not reference, profile=profile,
                                     **SERVE)
    run, counts = counted_serve(config, fused)
    label = (f"serve-{quantize}-kv8" + ("" if fused else " unfused")
             + (" stepwise" if reference else "")
             + (" profiled" if profile else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, fused, *forwards(run)))
    if fused and not reference and not profile:
        sqnr = next(r for r in run.report
                    if r["stage"] == "pack")["metrics"]["sqnr_db"]
        log("  pack stage per-site weight SQNR (dB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sqnr.items()))
    return run, counts


def serve_bias_corrected(torch):
    """The same serve with the V bias correction: the model built from a
    ``kv_bias_correct`` config, quantized by ``repro_torch.quantize`` under
    ``serve-w8a8-kv8`` and served by a fast ``ServingEngine`` (graphs
    captured by ``engine.warmup()`` before the timed loop), whose cache then
    carries the v_err leaf; decode runs kv_attention, never fused_decode.
    A stepwise engine over the same weights must serve the same tokens."""
    import dataclasses
    import time

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import ServeRun
    from repro_torch.serving import ServingEngine, synthetic_trace

    cfg = dataclasses.replace(repro_torch.get_config(SERVE["arch"]),
                              kv_bias_correct=True)
    model = repro_torch.build_model(cfg)
    qm = repro_torch.quantize(model, model.init(SERVE["seed"], device="cuda"),
                              recipe="serve-w8a8-kv8", device="cuda")
    runs = {}
    for fast in (True, False):
        engine = ServingEngine(model, qm.params, cfg, fast=fast, kv_bits=8,
                               num_slots=SERVE["slots"],
                               max_len=SERVE["max_len"],
                               prefill_chunk=SERVE["prefill_chunk"],
                               device="cuda")
        assert "v_err" in engine.pool.cache
        requests = synthetic_trace(
            SERVE["trace_seed"], SERVE["trace"], vocab_size=cfg.vocab_size,
            prompt_lens=(SERVE["prompt_min"], SERVE["prompt_len"]),
            gen_lens=(SERVE["gen_min"], SERVE["gen_len"]),
            mean_interarrival=1.0)
        reset_launch_counts()
        warm = engine.warmup() if fast else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        run = ServeRun(results=results, stats=dict(engine.stats),
                       seconds=seconds,
                       generated_tokens=engine.stats["generated_tokens"],
                       report=qm.report, warmup=warm,
                       path="fast (decode horizon 8)" if fast else "stepwise")
        label = "serve-w8a8-kv8 kv_bias_correct" + ("" if fast else " stepwise")
        check_served(run, counts, label,
                     expected_launches("w8a8", False, *forwards(run)))
        assert float(engine.pool.cache["v_err"].abs().max()) > 0
        runs[fast] = run, counts
    same_tokens(runs[True][0], runs[False][0],
                "serve-w8a8-kv8 kv_bias_correct fast against stepwise")
    log("  serve-w8a8-kv8 kv_bias_correct: every request's tokens and finish "
        "tick equal the stepwise run's")
    return runs[True], runs[False]


# the smoke serving runs of phase 3: 3 slots, 6 requests
SMOKE_SERVE = dict(smoke=True, seed=0, slots=3, max_len=32, prefill_chunk=8,
                   trace=6, trace_seed=0, prompt_min=4, prompt_len=20,
                   gen_min=4, gen_len=8)
# the MoE archs' smoke runs: mixtral's 16-position window rings the cache,
# so a request needs at most 15 positions (prompts up to 10 in chunks of 4,
# up to 6 new tokens)
MOE_SMOKE_SERVE = dict(SMOKE_SERVE, prompt_len=10, gen_len=6, prefill_chunk=4)


def _smoke_run(torch, device, sv=SMOKE_SERVE, **kw):
    """``repro_torch.serve`` at smoke size on ``device`` (the fast path's
    graphs captured by warmup on the card) with the settings ``sv``;
    returns (run, launch counts)."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    fast = not kw.get("reference", False)
    run = repro_torch.serve(repro_torch.ServeConfig(
        device=device, warmup=fast and device != "cpu", **{**sv, **kw}))
    return run, launch_counts()


def _smoke_engine_run(torch, arch, quantize, kv_bits, device, backend=None,
                      sv=SMOKE_SERVE):
    """The stepwise engine on ``device`` over a smoke model whose weights
    are drawn on the host (the same on every device) and quantized there
    by ``serve-<quantize>[-kv8]`` (``quantize="none"``: as drawn), on the
    trace of the settings ``sv``; returns (results, launch counts, (model,
    params))."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quantized import map_leaves
    from repro_torch.serving import ServingEngine, synthetic_trace

    model = repro_torch.build_model(repro_torch.get_config(arch, smoke=True))
    params = model.init(0, device="cpu")
    if quantize == "none":
        params = map_leaves(lambda t: t.to(device), params)
    else:
        kv8 = "-kv8" if kv_bits == 8 else ""
        qm = repro_torch.quantize(model, params, device=device,
                                  recipe=f"serve-{quantize}{kv8}")
        model, params = qm.model, qm.params
    engine = ServingEngine(model, params, model.cfg, fast=False,
                           kv_bits=kv_bits, device=device, backend=backend,
                           num_slots=sv["slots"], max_len=sv["max_len"],
                           prefill_chunk=sv["prefill_chunk"])
    reset_launch_counts()
    results = engine.run(synthetic_trace(
        0, sv["trace"], vocab_size=model.cfg.vocab_size,
        prompt_lens=(sv["prompt_min"], sv["prompt_len"]),
        gen_lens=(sv["gen_min"], sv["gen_len"]), mean_interarrival=1.0))
    return results, launch_counts(), (model, params)


def check_smoke_serving(torch, arch, quantize, kv_bits, sv=SMOKE_SERVE,
                        every_token=False):
    """A smoke model served on the card: ``repro_torch.serve`` fast
    (graphs) and stepwise — the fast path's tokens and finish ticks equal
    the stepwise path's, the launch counts exact (``expected_launches`` of
    the arch, its KV precision and its forwards); then the stepwise
    engine on the same host-drawn weights, quantized on the card and on
    the CPU: every request's first token (the one no earlier difference
    can move) the CPU's, the share of equal tokens logged; and the two
    quantized models' teacher-forced prefill and decode logits
    (``teacher_forced``), so the decode path past the first token is held
    to the CPU's too. ``every_token``: every token of every request the
    CPU's (the MoE archs)."""
    import repro_torch

    label = (f"smoke {arch} --quantize {quantize} --kv-bits "
             f"{kv_bits or 16}")
    kw = dict(arch=arch, quantize=quantize, kv_bits=kv_bits)
    cfg = repro_torch.get_config(arch, smoke=True)
    for reference in (True, False):
        run, counts = _smoke_run(torch, "cuda", sv, reference=reference, **kw)
        steps, chunks = forwards(run)
        want = expected_launches(quantize, True, steps, chunks, cfg=cfg,
                                 kv_bits=kv_bits or 16, slots=sv["slots"],
                                 chunk=sv["prefill_chunk"])
        for name, n in counts.items():
            assert n == want.get(name, 0), (
                f"{label}: {name} launched {n} times, expected "
                f"{want.get(name, 0)}")
        if reference:
            stepwise = run
            continue
        same_tokens(run, stepwise, f"{label} fast against stepwise")
    cpu, _, (model, cpu_params) = _smoke_engine_run(torch, arch, quantize,
                                                    kv_bits, "cpu", sv=sv)
    card, _, (_, card_params) = _smoke_engine_run(torch, arch, quantize,
                                                  kv_bits, "cuda", sv=sv)
    firsts = sum(card[r].tokens[0] == c.tokens[0] for r, c in cpu.items())
    equal = sum(a == b for r, c in cpu.items()
                for a, b in zip(card[r].tokens, c.tokens))
    total = sum(len(c.tokens) for c in cpu.values())
    assert firsts == len(cpu), (
        f"{label}: first tokens equal the CPU's in {firsts} of {len(cpu)} "
        f"requests")
    assert not every_token or equal == total, (
        f"{label}: {equal} of {total} tokens equal the CPU's")
    log(f"  {label} (kv cache {'int8' if run.kv_bits == 8 else 'fp'}): "
        f"repro_torch.serve fast = stepwise, request by request, launches "
        f"exact ({json.dumps({k: v for k, v in counts.items() if v})}); the "
        f"engine on the CPU's weights: every first token the CPU's, {equal} "
        f"of {total} tokens equal")
    teacher_forced(torch, torch.device("cuda"), model.cfg, cpu_params,
                   card_params, run.kv_bits, f"{label} ({cfg.n_layers} "
                   f"layers, {cfg.dtype})")


def check_moe_smoke(torch, dev):
    """The MoE archs at smoke size (mixtral: 4 of 8 experts top-2, the
    16-position window; llama4: 4 of 16 experts top-1 and a shared expert)
    on the card against the CPU. Per arch: ``repro_torch.quantize`` under
    serve-w8a16-kv8 and serve-w8a8-kv8 on the card bit-equal to the CPU's
    (``check_dfq_on_card``: every payload, scale and float leaf), and each
    quantized model teacher-forced past the window (prefill 8, then 16
    decode steps over a 32-position request: mixtral's 16-position ring
    wraps) on the fused route (fused_decode) and the unfused one
    (REPRO_FUSED_DECODE=0: kv_attention), within ``teacher_forced``'s bound
    of the CPU; then ``repro_torch.serve`` of the reference's default
    deployment (serve-w8a16 over the fp cache) and of serve-w8a8-kv8, fast
    = stepwise, launch counts exact (the router and one expert-batched
    launch an expert projection), and every token of the stepwise engine
    on the host-drawn weights the CPU's."""
    import repro_torch

    for arch in ("mixtral-8x22b", "llama4-scout-17b-a16e"):
        model = repro_torch.build_model(repro_torch.get_config(arch,
                                                               smoke=True))
        params = model.init(0, device="cpu")
        for recipe in ("serve-w8a16-kv8", "serve-w8a8-kv8"):
            cpu, card = check_dfq_on_card(torch, dev, model, params, recipe)
            for fused in (True, False):
                with fused_route(fused):
                    teacher_forced(
                        torch, dev, cpu.cfg, cpu.params, card.params, 8,
                        f"smoke {arch} (2 layers, f32) under {recipe}, "
                        + ("fused_decode" if fused else "kv_attention"))
        check_smoke_serving(torch, arch, "w8a16", None, MOE_SMOKE_SERVE,
                            every_token=True)
        check_smoke_serving(torch, arch, "w8a8", 8, MOE_SMOKE_SERVE,
                            every_token=True)


def check_torch_tier_on_card(torch):
    """``backend="torch"`` (an explicit argument: the engine's tier scope)
    on the card, over the CPU's weights quantized on the card: the plain
    versions through the model — the CPU's tokens and ticks, and no
    kernel launched; the default tier on the same weights launches."""
    kw = dict(arch="qwen2-0.5b", quantize="w8a8", kv_bits=8)
    cpu, _, _ = _smoke_engine_run(torch, device="cpu", **kw)
    card, counts, _ = _smoke_engine_run(torch, device="cuda",
                                        backend="torch", **kw)
    assert not any(counts.values()), f"torch tier launched kernels: {counts}"
    for rid, r in cpu.items():
        assert card[rid].tokens == r.tokens, f"request {rid}: other tokens"
        assert card[rid].finished_at == r.finished_at, rid
    _, kcounts, _ = _smoke_engine_run(torch, device="cuda", **kw)
    assert all(kcounts[k] for k in ("fused_decode", "qmatmul_w8a8")), kcounts
    log(f"  backend='torch' on the card (smoke qwen2, serve-w8a8-kv8, "
        f"stepwise engine): the CPU's tokens and finish ticks, 0 kernel "
        f"launches (the default tier on the same weights: "
        f"{sum(kcounts.values())} launches)")


# --------------------------------------------------------------- phase 5
# the recipes phase 5 quantizes qwen2-0.5b with at full width: the
# collapse baseline, the equalization ablation, the function-preserving
# rewrites then fake-quant without correction, and the paper's full flow
FULL_WIDTH_RECIPES = (
    ("naive-int8", "naive-int8"),
    ("cle-only", "cle-only"),
    ("fold-cle-absorb-wq", ["fold_norm", "cle", "bias_absorb", "weight_quant"]),
    ("dfq-int8", "dfq-int8"),
)
# the evaluation tokens' seed: not the calibration's (1)
EVAL_SEED = 7


def dfq_full_width(torch, dev):
    """qwen2-0.5b at full width, ``hostile_params`` drawn on the card:
    ``repro_torch.quantize`` under each of ``FULL_WIDTH_RECIPES``, with each
    stage's seconds, the sites bias_correct corrected, the per-site weight
    SQNR, and the logits SQNR and greedy agreement against fp on synthetic
    tokens of another seed; the output mean error (``output_bias_error``
    of the captured per-channel means against fp's, at every stat key,
    ``final_h`` included) without and with the correction. dfq-int8's
    logits SQNR must be above naive-int8's; the other orderings are logged,
    not asserted (a one-shot correction on random weights: a finding, not
    a gate). Returns the model and its fp weights."""
    import time

    import repro_torch
    from repro_torch.core import output_bias_error, sqnr_db
    from repro_torch.data import calibration_tokens

    cfg = repro_torch.get_config(SERVE["arch"])
    model = repro_torch.build_model(cfg)
    params = hostile_params(torch, model, device=dev)
    toks = calibration_tokens(EVAL_SEED, 2, 32, cfg.vocab_size, device=dev)
    y_fp = model.apply(params, toks).float()
    stats_fp = model.calibration_stats(params, toks)
    snr, stats = {}, {}
    for label, recipe in FULL_WIDTH_RECIPES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qm = repro_torch.quantize(model, params, recipe=recipe, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        y = model.apply(qm.params, toks).float()
        assert bool(torch.isfinite(y).all()), label
        snr[label] = float(sqnr_db(y_fp, y))
        agree = float((y.argmax(-1) == y_fp.argmax(-1)).float().mean())
        stats[label] = model.calibration_stats(qm.params, toks)
        rec = qm.stage_record("bias_correct")
        site = qm.site_sqnr_db()
        log(f"  {label}: quantized in {seconds:.3f} s ("
            + ", ".join(f"{r['stage']} {r['seconds']:.3f} s" for r in qm.report)
            + f"); logits SQNR {snr[label]:.2f} dB, greedy agreement "
            f"{agree:.3f} on {toks.numel()} tokens of seed {EVAL_SEED}"
            + (f"; bias_correct corrected {rec['metrics']['sites_corrected']}"
               if rec else ""))
        log(f"    per-site weight SQNR (dB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in site.items()))
    for key in stats_fp:
        err = {label: output_bias_error(stats_fp[key].float()[None],
                                        stats[label][key].float()[None]).abs()
               for label in ("fold-cle-absorb-wq", "dfq-int8")}
        log(f"  output mean error at {key} (mean / max |E[ỹ] − E[y]| over "
            f"{err['dfq-int8'].numel()} channels): without correction "
            f"{float(err['fold-cle-absorb-wq'].mean()):.4g} / "
            f"{float(err['fold-cle-absorb-wq'].max()):.4g}, with "
            f"{float(err['dfq-int8'].mean()):.4g} / "
            f"{float(err['dfq-int8'].max()):.4g}")
    order = sorted(snr, key=snr.get, reverse=True)
    log("  logits SQNR ordering: " + " > ".join(
        f"{k} ({snr[k]:.2f} dB)" for k in order))
    assert snr["dfq-int8"] > snr["naive-int8"], snr
    return model, params


def serve_saved_deployment(torch, dev, model, params):
    """The bias-corrected w8a8 deployment (``BC_DEPLOY``) of the full-width
    weights: ``QuantizedModel.save``, ``load`` (every leaf bit-equal to
    the saved), then ``repro_torch.serve(ServeConfig(load=...))`` on the
    fast path (graphs captured by warmup) and the stepwise path, phase 4's
    trace. Every request finishes, the fast path gives the stepwise tokens
    and ticks, and each kernel launches exactly ``expected_launches``
    times. Returns the fast run."""
    import shutil
    import time

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.pipeline import QuantizedModel

    qm = repro_torch.quantize(model, params, recipe=BC_DEPLOY, device=dev)
    bias = qm.params["blocks"]["mlp"]
    assert float(bias["bg"].abs().max()) > 0 and float(bias["bu"].abs().max()) > 0
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_artifact")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        qm.save(directory)
        t1 = time.perf_counter()
        loaded = QuantizedModel.load(directory, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want, got = dict(_leaves(qm.params)), dict(_leaves(loaded.params))
        assert sorted(want) == sorted(got), "the loaded tree differs"
        for path, t in want.items():
            assert got[path].dtype == t.dtype and torch.equal(got[path], t), path
        size = sum(os.path.getsize(os.path.join(directory, "step_0", f))
                   for f in os.listdir(os.path.join(directory, "step_0")))
        log(f"  bias-corrected w8a8 deployment: saved {size / 2**20:.1f} MiB in "
            f"{t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s, {len(want)} leaves "
            f"bit-equal to the saved, kv_bits {loaded.kv_bits}")
        del loaded
        runs = {}
        for reference in (True, False):
            config = repro_torch.ServeConfig(
                load=directory, reference=reference, warmup=not reference,
                **{k: v for k, v in SERVE.items() if k not in ("arch", "seed")})
            reset_launch_counts()
            run = repro_torch.serve(config)
            counts = launch_counts()
            label = "bias-corrected w8a8 --load" + (" stepwise" if reference
                                                    else "")
            check_served(run, counts, label,
                         expected_launches("w8a8", True, *forwards(run)))
            runs[reference] = run
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    same_tokens(runs[False], runs[True],
                "bias-corrected w8a8 --load fast against stepwise")
    log("  bias-corrected w8a8 --load: every request's tokens and finish tick "
        "equal the stepwise run's")
    return runs[False], runs[True]


def log_row(name, r):
    """One kernel row of phase 2: device and call time, the plain version,
    the library call, the bound and what else the row measured."""
    lib_ms = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f}"
    log(f"  {name:16s} {r['shape']:40s} kernel "
        f"{r['ms'] * 1e3:9.2f} us (call {r['call_ms'] * 1e3:7.2f})  "
        f"plain {r['plain_ms'] * 1e3:9.2f} us  library {lib_ms:>6s} us"
        f"  bound {r['bound_ms'] * 1e3:8.3f} us ({r['bound_by']})"
        + (f"  stepwise pair {r['stepwise_ms'] * 1e3:8.2f} us"
           if "stepwise_ms" in r else "")
        + (f"  cold {r['cold_ms'] * 1e3:8.2f} us" if "cold_ms" in r else "")
        + (f" (library {r['library_cold_ms'] * 1e3:.2f})"
           if "library_cold_ms" in r else "")
        + (f"  [{r['library']}]" if "library" in r else "")
        + (f"  yardstick {r['yardstick_ms'] * 1e3:.2f} us [{r['yardstick']}]"
           if "yardstick_ms" in r else "")
        + (f"  without quantize-out {r['no_q8_ms'] * 1e3:.2f} us"
           if "no_q8_ms" in r else "")
        + (f"  splits {r['splits']}, SDPA bf16 (GQA expanded) "
           f"{r['sdpa_ms'] * 1e3:.2f} us" if "sdpa_ms" in r else "")
        + (f"  launch floor {r['floor_ms'] * 1e3:.2f} us"
           if "floor_ms" in r else ""))


# --------------------------------------------------------------- phase 6
# the serving runs of phase 6: phase 4's trace at mistral-nemo-12b's width
NEMO = dict(SERVE, arch="mistral-nemo-12b")
# phase 6 serves at most NEMO_LAYERS of the 40 layers, a cut for the
# script's time: at the 28 that leave 8 GiB free the phase took 37-54 s
# on the H100, and the whole script ran past its 1,200 s once
NEMO_LAYERS = 12
# device memory quantize must leave free (of the card's total)
FREE_BYTES = 8 << 30


def cut_depth(torch, dev, arch, probe, most=None):
    """The depth a phase serves ``arch`` at: all its layers (at most
    ``most``, a cut for the script's time) if ``repro_torch.quantize``'s
    peak (``torch.cuda.max_memory_allocated``, serve-w8a16: the float32
    weights and the copies the flow makes) leaves ``FREE_BYTES`` of the
    card free, else the deepest that does. The peak is linear in the depth
    (the embedding and the head, then the same blocks a layer): measured at
    the two depths ``probe`` and extrapolated; each run checks its own
    peak."""
    import dataclasses
    import gc

    import repro_torch

    cfg = repro_torch.get_config(arch)
    lo, hi = probe
    peaks = {}
    for L in probe:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        qm = repro_torch.quantize(
            repro_torch.build_model(dataclasses.replace(cfg, n_layers=L)),
            None, recipe="serve-w8a16", device=dev)
        torch.cuda.synchronize(dev)
        peaks[L] = torch.cuda.max_memory_allocated(dev) - base
        del qm
    per_layer = (peaks[hi] - peaks[lo]) / (hi - lo)
    fixed = peaks[lo] - lo * per_layer
    total = torch.cuda.get_device_properties(dev).total_memory
    room = total - FREE_BYTES - torch.cuda.memory_allocated(dev)
    fits = int((room - fixed) // per_layer)
    depth = max(1, min(cfg.n_layers, most or cfg.n_layers, fits))
    log(f"  {arch}: quantize peak of serve-w8a16 at {lo} / {hi} layers: "
        f"{peaks[lo] / 2**30:.2f} / {peaks[hi] / 2**30:.2f} GiB -> "
        f"{per_layer / 2**30:.3f} GiB a layer + {fixed / 2**30:.2f} GiB; the "
        f"card holds {total / 2**30:.2f} GiB: {fits} layers leave "
        f"{FREE_BYTES / 2**30:.0f} GiB free -> serving "
        f"{depth} of {cfg.n_layers} layers"
        + (f" (at most {most}, the script's time)" if most else ""))
    return depth


def serve_cut(torch, settings, depth, quantize, kv_bits, *, reference):
    """``repro_torch.serve`` of ``settings``' arch (full width, ``depth``
    layers) on phase 4's trace: the fast path with every graph captured by
    warmup, or the stepwise path; checked as phase 4's runs, the launch
    counts from the plan. Returns (run, launch counts)."""
    import dataclasses
    import gc

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    config = repro_torch.ServeConfig(
        quantize=quantize, kv_bits=kv_bits, layers=depth,
        reference=reference, warmup=not reference, **settings)
    reset_launch_counts()
    run = repro_torch.serve(config)
    counts = launch_counts()
    cfg = dataclasses.replace(repro_torch.get_config(settings["arch"]),
                              n_layers=depth)
    kv = kv_bits or 16
    label = (f"{cfg.name} ({depth} layers) serve-{quantize}"
             + ("-kv8" if kv == 8 else " (bf16 KV cache)")
             + (" stepwise" if reference else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, True, *forwards(run), cfg=cfg,
                                   kv_bits=kv), trace=settings["trace"])
    total = torch.cuda.get_device_properties(0).total_memory
    free = total - run.quantize_peak_bytes
    log(f"  {label}: {run.tokens_per_second:.1f} tok/s; quantize "
        f"{run.quantize_seconds:.2f} s (peak {run.quantize_peak_bytes / 2**30:.2f}"
        f" GiB, {free / 2**30:.2f} GiB of {total / 2**30:.2f} free)"
        + (f", warmup {run.warmup['seconds']:.2f} s" if run.warmup else "")
        + f"; peak from then to the loop's end {run.peak_bytes / 2**30:.2f} "
          f"GiB ({smi_line()})")
    assert free >= FREE_BYTES, (
        f"{label}: quantize left {free / 2**30:.2f} GiB free")
    return run, counts


# --------------------------------------------------------------- phase 7
# the reference's top-1 (%) on the same recipe: the JAX package on the CPU
# (jax 0.9.0, benchmarks.tables.table1_cle and table2_bias_correction, 1536
# held-out images); the card's rows are logged beside them, and the gates
# are relative to the card's own rows
CNN_REFERENCE_CPU = {
    "original_fp32": 55.1, "original_int8": 18.9, "replace_relu6_fp32": 73.7,
    "replace_relu6_int8": 20.2, "cle_int8": 74.5, "cle_absorb_int8": 74.5,
    "per_channel_int8": 49.7, "bias_corr_int8": 17.3, "clip15_int8": 18.2,
    "clip15_bias_corr_int8": 12.2, "full_dfq_int8": 74.7}
# the reference recipe (benchmarks/_cnn_pipeline.py): 8 classes of 32x32
# gratings, 300 AdamW steps at batch 128, lr 3e-3, weight decay 1e-4; the
# evaluation: 6 held-out batches of 256 (seed 99, steps 10000+)
CNN_TRAIN = dict(steps=300, batch=128, seed=0, lr=3e-3, weight_decay=1e-4)
CNN_CLASSES, CNN_IMG = 8, 32
CNN_EVAL = dict(seed=99, batches=6, batch=256)
# MobileNetV2 1.0 at 224 (Sandler et al. 2018, Table 2): the stem of 32,
# then each (t, c, n, s) row of the table as n blocks, the first at stride
# s; CNNConfig has no field for the 1280-wide last 1x1 conv, so it is left
# out and the classifier reads the 320 channels. The activation is ReLU:
# the paper swaps ReLU6 for ReLU before CLE (§5.1.1), and here the swap
# comes before the BN statistics are set — with random BN moments many
# pre-activations pass 6, and statistics taken under ReLU6 do not describe
# the ReLU model (its logits reached ~1e9 at 224 px in a chip probe)
MOBILENET_V2_224 = dict(
    name="mobilenet_v2-1.0-224 (no 1280 conv)", in_channels=3,
    num_classes=1000, width=32,
    blocks=((1, 16, 1), (6, 24, 2), (6, 24, 1), (6, 32, 2), (6, 32, 1),
            (6, 32, 1), (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
            (6, 96, 1), (6, 96, 1), (6, 96, 1), (6, 160, 2), (6, 160, 1),
            (6, 160, 1), (6, 320, 1)),
    img_size=224, act_clip=None)
# fp32 logits, card against CPU on the same folded weights and images:
# float32 convolutions summing in other orders, through every layer —
# within CNN_FWD_TOL of the largest |logit|; a TF32 forward (inputs of
# every product rounded to 10 mantissa bits, ~2^-11 relative) must fall
# outside it
CNN_FWD_TOL = 1e-4
# the transforms' leaves, card against CPU: bit-equal where the arithmetic
# is elementwise (fold, CLE, weight quantization); where a leaf is a sum
# (absorption's shifted biases, bias correction's), within CNN_SUM_TOL of
# the leaf's largest magnitude
CNN_SUM_TOL = 1e-6
# fp32 logits after a function-preserving rewrite against before it, on
# the card, relative to the largest |logit|. CLE rescales whole channels:
# only rounding through 1.5 decades of hostile scales. High-bias absorption
# assumes each absorbed channel's pre-activation stays above c = β − 3γ,
# which the BN moments of random weights describe only roughly, and a 3x3
# window at the padding border sums fewer taps of c: CPU rehearsals at
# 64-128 px moved the logits by 3-7 % of the largest |logit|, the chip run
# at 224 px by 11.3 %
CNN_CLE_TOL = 1e-3
CNN_ABSORB_TOL = 0.15


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (i,))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _tree_leaves(v, path + (k,))
    else:
        yield path, tree


def merge_bn(trained, with_stats):
    """benchmarks/_cnn_pipeline.py's ``_merge_bn``: the running mean and
    var from the forward's tree, everything else from AdamW's."""
    if isinstance(trained, dict):
        if set(trained) == {"gamma", "beta", "mean", "var"}:
            return {"gamma": trained["gamma"], "beta": trained["beta"],
                    "mean": with_stats["mean"], "var": with_stats["var"]}
        return {k: merge_bn(trained[k], with_stats[k]) for k in trained}
    if isinstance(trained, list):
        return [merge_bn(a, b) for a, b in zip(trained, with_stats)]
    return trained


def cnn_train_step(torch, model, params, opt, batch, lr, weight_decay):
    """One step of the reference recipe: the loss's gradients (zeros for
    the running statistics, which the loss does not read — JAX's gradient
    there), AdamW, then the forward's running statistics merged in."""
    from repro_torch.models.cnn import fp32
    from repro_torch.optim import adamw_update

    live = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = [t for _, t in _tree_leaves(live)]
    with fp32():
        loss, new_params = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    upd, opt, _ = adamw_update(_tree_map(lambda t: by_leaf[id(t)], live), opt,
                               params, lr=lr, weight_decay=weight_decay)
    return merge_bn(upd, new_params), opt, loss.detach()


def image_batches(torch, dev, seed, steps, batch, size, classes, workers=4):
    """``synthetic_image_batch(seed, step, ...)`` for each step, drawn on
    the host by ``workers`` threads ahead of the consumer (numpy releases
    the interpreter lock) and moved to ``dev`` in order."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data import synthetic_image_batch

    def draw(step):
        return synthetic_image_batch(seed, step, batch, size, 3, classes,
                                     device="cpu")

    with ThreadPoolExecutor(workers) as pool:
        for b in pool.map(draw, steps):
            yield {k: v.to(dev) for k, v in b.items()}


def adversarial_rescale(torch, folded, seed=0, decades=1.5):
    """benchmarks/_cnn_pipeline.py's hostile-ranges injector: a
    function-preserving log-normal per-channel rescale over each inverted
    residual's expand → dw and dw → project interfaces, with the JAX
    package's draws for the seed (``prng.normal``, within 4 ulp)."""
    import numpy as np

    from repro_torch.core.cle import ConvLayer, _scale_in, _scale_out
    from repro_torch.data import prng

    folded = _tree_map(lambda t: t, folded)
    key = prng.PRNGKey(seed)
    for blk in folded["blocks"]:
        for src, dst, dst_kind in (("expand", "dw", "depthwise"),
                                   ("dw", "project", "conv")):
            key, k = prng.split(key)
            n = prng.normal(k, (blk[src].w.shape[-1],))
            s = torch.from_numpy(np.exp(n * np.float32(decades))).to(
                blk[src].w.device)
            l1s = _scale_out(ConvLayer(blk[src].w, blk[src].b,
                                       "depthwise" if src == "dw" else "conv"),
                             s)
            l2s = _scale_in(ConvLayer(blk[dst].w, blk[dst].b, dst_kind), s)
            blk[src] = blk[src]._replace(w=l1s.w, b=l1s.b,
                                         act_mean=blk[src].act_mean / s,
                                         act_std=blk[src].act_std / s)
            blk[dst] = blk[dst]._replace(w=l2s.w)
    return folded


def clip_weights(torch, folded, clip=15.0):
    """The paper's §5.1.2 weight-clipping baseline (every conv, not the
    head)."""
    q = _tree_map(lambda t: t, folded)
    q["stem"] = q["stem"]._replace(w=torch.clamp(q["stem"].w, -clip, clip))
    for blk in q["blocks"]:
        for k in ("expand", "dw", "project"):
            blk[k] = blk[k]._replace(w=torch.clamp(blk[k].w, -clip, clip))
    return q


def act_quantizer(torch, act_clip, bits=8, n_sigma=6.0):
    """benchmarks' data-free activation fake-quant: the range max(β ± 6γ)
    over the layer's channels, its low end clamped to 0 (post-ReLU) and the
    high end capped at the clip."""
    from repro_torch.core import (QuantSpec, fake_quant_with_qparams,
                                  qparams_from_range)

    spec = QuantSpec(bits=bits, symmetric=False)

    def act_quant(h, name, mean, std):
        lo = torch.clamp_min(torch.clamp_max(
            torch.min(mean - n_sigma * std), 0.0), 0.0)
        hi = torch.max(mean + n_sigma * std)
        if act_clip is not None:
            hi = torch.clamp_max(hi, act_clip)
        return fake_quant_with_qparams(h, qparams_from_range(lo, hi, spec))

    return act_quant


def cnn_accuracy(torch, model, folded, batches, act_clip=None, w_bits=None,
                 per_channel=False, bias_correct=False, act_bits=None):
    """Top-1 (%) over the held-out batches — benchmarks' ``eval_accuracy``
    on the tree ``_acc`` makes: weights fake-quantized to ``w_bits`` (and
    bias-corrected), activations to ``act_bits`` with data-free ranges."""
    from repro_torch.core import QuantSpec

    q = folded
    if w_bits:
        spec = QuantSpec(bits=w_bits, per_channel_axis=-1 if per_channel
                         else None)
        q = model.quantize_weights(folded, spec)
        if bias_correct:
            q = model.bias_correct_analytic(folded, q, spec, act_clip=act_clip)
    act_quant = act_quantizer(torch, act_clip) if act_bits else None
    correct = total = 0
    for b in batches:
        logits = model.apply_folded(q, b["x"], act_clip=act_clip,
                                    act_quant=act_quant)
        correct = correct + (logits.argmax(-1) == b["y"]).sum()
        total += b["y"].numel()
    return 100.0 * float(correct) / total


def timed(torch, secs, name, fn):
    """``fn()``, its seconds on the card (synchronized) put in ``secs``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    return out


def cnn_rows(torch, model, hostile, batches, secs):
    """The rows of tables.table1_cle and table2_bias_correction, on the
    hostile model; each transform's seconds go in ``secs``."""
    eq = timed(torch, secs, "equalize", lambda: model.equalize(hostile))
    ab = timed(torch, secs, "absorb_high_bias",
               lambda: model.absorb_high_bias(eq))
    clipped = clip_weights(torch, hostile, 15.0)

    def acc(tree, act_clip, **kw):
        if kw:
            kw.setdefault("act_bits", 8)
        return cnn_accuracy(torch, model, tree, batches, act_clip=act_clip,
                            **kw)

    rows = {
        "original_fp32": acc(hostile, 6.0),
        "original_int8": acc(hostile, 6.0, w_bits=8),
        "replace_relu6_fp32": acc(hostile, None),
        "replace_relu6_int8": acc(hostile, None, w_bits=8),
        "cle_fp32": acc(eq, None),
        "cle_int8": acc(eq, None, w_bits=8),
        "cle_absorb_fp32": acc(ab, None),
        "cle_absorb_int8": acc(ab, None, w_bits=8),
        "per_channel_int8": acc(hostile, 6.0, w_bits=8, per_channel=True),
        "bias_corr_int8": acc(hostile, 6.0, w_bits=8, bias_correct=True),
        "clip15_fp32": acc(clipped, 6.0),
        "clip15_int8": acc(clipped, 6.0, w_bits=8),
        "clip15_bias_corr_int8": acc(clipped, 6.0, w_bits=8,
                                     bias_correct=True),
        "full_dfq_int8": acc(ab, None, w_bits=8, bias_correct=True),
    }
    return rows


def cnn_paper_tables(torch, dev, smi):
    """Phase 7a: the reference's recipe on the repo's mobilenet_v2 config,
    trained and quantized on the card; the rows of the paper's Tables 1
    and 2 beside the reference's."""
    import math

    from repro_torch.configs.mobilenet_v2 import CONFIG
    from repro_torch.models import MobileNetCNN
    from repro_torch.optim import adamw_init

    tr, cfg = CNN_TRAIN, CONFIG
    assert (cfg.num_classes, cfg.img_size) == (CNN_CLASSES, CNN_IMG)
    model = MobileNetCNN(cfg)
    params = model.init(tr["seed"], device=dev)
    opt = adamw_init(params)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # cuDNN's deterministic algorithms: the same trained weights every run,
    # so that the rows below (the collapsed int8 ones moved 12.6 → 31.8 %
    # between two runs without it) are reproducible
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for b in image_batches(torch, dev, tr["seed"], range(tr["steps"]),
                               tr["batch"], CNN_IMG, CNN_CLASSES):
            params, opt, loss = cnn_train_step(torch, model, params, opt, b,
                                               tr["lr"], tr["weight_decay"])
            losses.append(loss)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    losses = [float(x) for x in torch.stack(losses).cpu()]
    train_s = time.perf_counter() - t0
    log(f"  7a {cfg.name} (width {cfg.width}, {len(cfg.blocks)} blocks, "
        f"{CNN_IMG}x{CNN_IMG}, {CNN_CLASSES} classes): {tr['steps']} AdamW "
        f"steps at batch {tr['batch']} in {train_s:.2f} s, "
        f"{tr['steps'] / train_s:.1f} steps/s (host drawing included); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({smi})")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses

    secs = {}
    hostile = timed(torch, secs, "fold + hostile rescale",
                    lambda: adversarial_rescale(torch, model.fold(params)))
    ev = CNN_EVAL
    batches = list(image_batches(
        torch, dev, ev["seed"], range(10_000, 10_000 + ev["batches"]),
        ev["batch"], CNN_IMG, CNN_CLASSES))
    rows = timed(torch, secs, "rows",
                 lambda: cnn_rows(torch, model, hostile, batches, secs))
    for name, top1 in rows.items():
        ref = CNN_REFERENCE_CPU.get(name)
        log(f"  7a {name:24s} top-1 {top1:6.2f} %  (reference, JAX on the "
            f"CPU: " + ("none given" if ref is None else f"{ref:.1f} %")
            + ")")
    log("  7a seconds on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f" ({smi})")
    assert abs(rows["cle_fp32"] - rows["replace_relu6_fp32"]) <= 0.2, rows
    assert rows["full_dfq_int8"] >= rows["replace_relu6_fp32"] - 5.0, rows
    assert rows["full_dfq_int8"] >= rows["original_int8"] + 30.0, rows


def _max_rel(torch, a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / b.double().abs().max())


def check_leaves_card_cpu(torch, name, card, cpu, summed):
    """A transform's tree on the card against the same transform's on the
    CPU: every leaf bit-equal, or for the leaves ``summed(path)`` marks
    within CNN_SUM_TOL of the leaf's largest magnitude."""
    worst, n = 0.0, 0
    cpu_leaves = dict(_tree_leaves(cpu))
    for path, t in _tree_leaves(card):
        want = cpu_leaves[path]
        if isinstance(t, int):
            assert t == want, (name, path)
            continue
        n += 1
        if summed(path):
            rel = _max_rel(torch, t, want)
            worst = max(worst, rel)
            assert rel <= CNN_SUM_TOL, (name, path, rel)
        else:
            assert torch.equal(t.cpu(), want), (name, path)
    return n, worst


def _blocks_b(*parts):
    def summed(path):
        return path[0] == "blocks" and path[2] in parts and path[3] == "b"
    return summed


def fig2_spread(torch, folded):
    """Fig. 2's per-channel range spread of the depthwise kernels: max over
    median of each block's channel ranges, averaged over the blocks."""
    from repro_torch.core import channel_ranges

    vals = []
    for blk in folded["blocks"]:
        r = torch.clamp_min(channel_ranges(blk["dw"].w, -1), 1e-9)
        vals.append(float(r.max() / torch.quantile(r, 0.5)))
    return sum(vals) / len(vals)


def mobilenet_v2_published(torch, dev, smi):
    """Phase 7b: MobileNetV2's published widths at 224x224 (random
    weights from the seed, BN γ log-normal and β normal, running statistics
    from train-mode forwards), folded, made hostile and taken through CLE,
    absorption, 8-bit weights and analytic bias correction on the card."""
    import numpy as np

    from repro_torch.core import QuantSpec, sqnr_db
    from repro_torch.data import prng
    from repro_torch.models import CNNConfig, MobileNetCNN

    cfg = CNNConfig(**MOBILENET_V2_224)
    model = MobileNetCNN(cfg)
    secs = {}
    torch.cuda.reset_peak_memory_stats()
    log(f"  7b {cfg.name}: width {cfg.width}, {len(cfg.blocks)} blocks, "
        f"{cfg.img_size}x{cfg.img_size}, {cfg.num_classes} classes; the "
        f"1280-wide last 1x1 conv of the published model is left out "
        f"(CNNConfig has no field for it)")
    params = timed(torch, secs, "init", lambda: model.init(0, device=dev))
    keys = iter(prng.split(prng.fold_in(prng.PRNGKey(0), 1),
                           2 * (1 + 3 * len(cfg.blocks))))

    def random_bn(bn):
        c = bn["gamma"].shape[0]
        gamma = np.exp(prng.normal(next(keys), (c,)) * np.float32(0.5))
        beta = prng.normal(next(keys), (c,))
        return dict(bn, gamma=torch.from_numpy(gamma).to(dev),
                    beta=torch.from_numpy(beta).to(dev))

    params["stem"]["bn"] = random_bn(params["stem"]["bn"])
    for blk in params["blocks"]:
        for k in ("expand", "dw", "project"):
            blk[k]["bn"] = random_bn(blk[k]["bn"])
    images = list(image_batches(torch, dev, 0, range(30), 32, cfg.img_size,
                                cfg.num_classes, workers=8))

    def stats(p):
        with torch.no_grad():
            for b in images:
                _, p = model.apply_train(p, b["x"])
        return p

    params = timed(torch, secs, "bn_stats", lambda: stats(params))
    folded = timed(torch, secs, "fold", lambda: model.fold(params))
    hostile = timed(torch, secs, "hostile",
                    lambda: adversarial_rescale(torch, folded))
    eq = timed(torch, secs, "equalize", lambda: model.equalize(hostile))
    ab = timed(torch, secs, "absorb_high_bias",
               lambda: model.absorb_high_bias(eq))
    spec = QuantSpec(bits=8)
    q = timed(torch, secs, "quantize_weights",
              lambda: model.quantize_weights(ab, spec))
    bc = timed(torch, secs, "bias_correct_analytic",
               lambda: model.bias_correct_analytic(ab, q, spec))
    log("  7b seconds on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f" ({smi})")

    # the same transforms on the CPU, from the card's params moved across
    cpu = _tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, params)
    c_fold = model.fold(cpu)
    c_host = adversarial_rescale(torch, c_fold)
    c_eq = model.equalize(c_host)
    c_ab = model.absorb_high_bias(c_eq)
    c_q = model.quantize_weights(c_ab, spec)
    c_bc = model.bias_correct_analytic(c_ab, c_q, spec)
    none = _blocks_b()
    report = []
    for name, card, host, summed in (
            ("fold", folded, c_fold, none), ("hostile", hostile, c_host, none),
            ("equalize", eq, c_eq, none),
            ("absorb_high_bias", ab, c_ab, _blocks_b("dw", "project")),
            ("quantize_weights", q, c_q, _blocks_b("dw", "project")),
            ("bias_correct_analytic", bc, c_bc,
             _blocks_b("expand", "dw", "project"))):
        n, worst = check_leaves_card_cpu(torch, name, card, host, summed)
        report.append(f"{name} {n} leaves" + (
            f" (sums within {worst:.2g})" if worst else ""))
    log("  7b card = CPU, leaf by leaf: " + "; ".join(report))

    x = images[0]["x"][:8]
    y_fp = model.apply_folded(hostile, x)
    y_cpu = model.apply_folded(c_host, x.cpu())
    y_tf32 = model.apply_folded(hostile, x, allow_tf32=True)
    fp_err, tf32_err = (_max_rel(torch, y_fp, y_cpu),
                        _max_rel(torch, y_tf32, y_cpu))
    log(f"  7b fp32 logits card against CPU: max |diff| {fp_err:.3g} of max "
        f"|logit| (tolerance {CNN_FWD_TOL:g}); a TF32 forward on the card: "
        f"{tf32_err:.3g}, outside it")
    assert fp_err <= CNN_FWD_TOL, fp_err
    assert tf32_err > CNN_FWD_TOL, tf32_err

    cle_err = _max_rel(torch, model.apply_folded(eq, x), y_fp)
    ab_err = _max_rel(torch, model.apply_folded(ab, x), y_fp)
    log(f"  7b fp32 logits against the hostile model's: after CLE "
        f"{cle_err:.3g} (tolerance {CNN_CLE_TOL:g}), after CLE + absorption "
        f"{ab_err:.3g} (tolerance {CNN_ABSORB_TOL:g}: exact only above c "
        f"and away from the padding borders)")
    assert cle_err <= CNN_CLE_TOL, cle_err
    assert ab_err <= CNN_ABSORB_TOL, ab_err

    aq = act_quantizer(torch, None)
    snr = {name: float(sqnr_db(y_fp, model.apply_folded(tree, x,
                                                         act_quant=aq)))
           for name, tree in (
               ("original int8", model.quantize_weights(hostile, spec)),
               ("CLE + BA int8", q), ("full DFQ int8", bc))}
    log("  7b logits SQNR against fp32 (8-bit weights and activations): "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items()))
    assert snr["full DFQ int8"] > snr["original int8"], snr
    log(f"  7b Fig. 2 depthwise range spread (max/median, mean over blocks): "
        f"hostile {fig2_spread(torch, hostile):.2f}, after CLE "
        f"{fig2_spread(torch, eq):.2f}")

    pool = torch.cat([b["x"] for b in images])
    for n in (64, 256):
        xb = pool[:n]
        for label, tree, kw in (("fp32", hostile, {}),
                                ("int8 fake-quant", bc, {"act_quant": aq})):
            def fwd():
                with torch.no_grad():
                    return model.apply_folded(tree, xb, **kw)

            ms = call_ms(fwd, 10, warmup=2)
            log(f"  7b folded forward at batch {n} ({label}): {ms:.2f} ms, "
                f"{n / ms * 1e3:.0f} images/s ({smi})")
    log(f"  7b peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")


# --------------------------------------------------------------- phase 9
# the serving runs of phase 9: phase 4's trace at mixtral-8x22b's width
# (every width as published; the depth cut to what quantize leaves 8 GiB of
# the card free at)
MIXTRAL = dict(SERVE, arch="mixtral-8x22b")


def prefill_drops(torch, depth):
    """The choices mixtral's MoE blocks drop for capacity at prefill, out of
    those routed, on the weights phase 9 serves (``repro_torch.quantize``
    under serve-w8a16 from the same seed): every prompt of phase 4's trace
    prefilled alone in the engine's chunks of 32 (its last chunk
    zero-padded, the pad positions routed too, as in the engine), through
    the model's ``drop_log``. Capacity is per batch row, so a row's drops do
    not depend on the other slots. Returns (dropped, routed)."""
    import dataclasses

    import repro_torch
    from repro_torch.serving import synthetic_trace

    cfg = dataclasses.replace(repro_torch.get_config(MIXTRAL["arch"]),
                              n_layers=depth)
    qm = repro_torch.quantize(repro_torch.build_model(cfg), None,
                              init_seed=MIXTRAL["seed"], device="cuda",
                              recipe="serve-w8a16")
    C = MIXTRAL["prefill_chunk"]
    requests = synthetic_trace(
        MIXTRAL["trace_seed"], MIXTRAL["trace"], vocab_size=cfg.vocab_size,
        prompt_lens=(MIXTRAL["prompt_min"], MIXTRAL["prompt_len"]),
        gen_lens=(MIXTRAL["gen_min"], MIXTRAL["gen_len"]),
        mean_interarrival=1.0)
    qm.model.drop_log = []
    routed = 0
    for r in requests:
        n = -(-len(r.prompt) // C) * C
        toks = torch.zeros((1, n), dtype=torch.int64)
        toks[0, :len(r.prompt)] = torch.as_tensor(r.prompt)
        cache = qm.model.init_cache(1, MIXTRAL["max_len"], device="cuda")
        for c in range(0, n, C):
            _, cache = qm.prefill(toks[:, c:c + C].cuda(), cache)
        routed += n * cfg.top_k * depth
    return int(sum(int(d.sum()) for d in qm.model.drop_log)), routed


# --------------------------------------------------------------- main
# --------------------------------------------------------------- phase 8
# the paged runs of phase 8: phase 4's settings, pages of 32 positions (the
# prefill chunk)
PAGED = dict(SERVE, page_size=32)
# phase 4's engine from the paged runs' ServingEngine
ENGINE = dict(num_slots=SERVE["slots"], max_len=SERVE["max_len"],
              prefill_chunk=SERVE["prefill_chunk"], decode_horizon=8,
              page_size=PAGED["page_size"], device="cuda")
# 8b: 16 requests sharing a 192-token prompt prefix (6 pages), each with
# 8-64 tokens of its own; the first at tick 0, the others from tick 7 on,
# when its prefix is published
SHARED_PREFIX = 192
# 8c: half the full page capacity (8 slots x 16 pages), and a trace of
# long prompts in two priority classes that overflows it
STARVED_PAGES = 64
STARVED_TRACE = dict(seed=2, n=16, prompt_lens=(224, 256), gen_lens=(32, 32),
                     mean_interarrival=1.0, priority_levels=2)
# 8e: phase 4's trace with a deadline 16-64 ticks after each arrival
DEADLINE_SLACK = (16.0, 64.0)
# 8d: the chaos CLI's engine (repro_torch.serving.chaos), its starved pool
# and its seeded plan
CHAOS = dict(num_slots=4, max_len=48, prefill_chunk=8, decode_horizon=4,
             page_size=8)
CHAOS_PAGES = 2 * (48 // 8)


def serve_paged(torch, quantize, kv_bits, *, fused=True, reference=False,
                **kw):
    """``repro_torch.serve`` of qwen2-0.5b at full width on phase 4's
    trace from the paged pool (``PAGED``; ``page_size=None`` the contiguous
    pool), fast after warmup or stepwise, checked as phase 4's runs (every
    request ok with 32 tokens, launches exact); ``fused=False`` sets
    REPRO_FUSED_DECODE=0 for this run only. Returns (run, counts)."""
    import repro_torch

    config = repro_torch.ServeConfig(quantize=quantize, kv_bits=kv_bits,
                                     reference=reference,
                                     warmup=not reference, **{**PAGED, **kw})
    run, counts = counted_serve(config, fused)
    label = (f"serve-{quantize}" + ("-kv8" if kv_bits == 8 else " (bf16 KV)")
             + (f" paged (page {config.page_size})" if config.page_size
                else " contiguous")
             + ("" if fused else " unfused") + (" stepwise" if reference
                                                else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, fused, *forwards(run),
                                   kv_bits=kv_bits or 16))
    return run, counts


def check_paged_serving(torch, runs, stepwise):
    """8a: serve-w8a16 over the bf16 KV cache (the default deployment) and
    serve-w8a8-kv8, each fast twice — contiguous, then paged (four turns,
    contiguous, paged, paged, contiguous, until the script's time was cut)
    — then paged stepwise; serve-w8a8-kv8 paged fast once more
    with REPRO_FUSED_DECODE=0 (kv_attention over the dense view). Every
    request's tokens and finish tick equal the first contiguous run's, and
    for serve-w8a8-kv8 phase 4's fast and stepwise runs'; launches exact."""
    pg = PAGED["page_size"]
    for quantize, kv_bits in (("w8a16", None), ("w8a8", 8)):
        label = f"serve-{quantize}" + ("-kv8" if kv_bits else " (bf16 KV)")
        turns = [serve_paged(torch, quantize, kv_bits, page_size=size)[0]
                 for size in (None, pg)]
        for run in turns[1:]:
            same_tokens(run, turns[0], f"{label} against its first "
                                       f"contiguous run")
        step = serve_paged(torch, quantize, kv_bits, reference=True)[0]
        same_tokens(step, turns[0], f"{label} paged stepwise against fast")
        if kv_bits:
            same_tokens(turns[0], runs[quantize][0],
                        f"{label} against phase 4's run")
            same_tokens(step, stepwise[quantize],
                        f"{label} paged stepwise against phase 4's")
            unfused = serve_paged(torch, quantize, kv_bits, fused=False)[0]
            same_tokens(unfused, turns[1], f"{label} paged unfused against "
                                           f"fused")
        flat, paged = (run.tokens_per_second for run in turns)
        log(f"  8a {label}: every paged request's tokens and finish tick "
            f"equal the contiguous run's; tok/s paged {paged:.1f} / "
            f"contiguous {flat:.1f} "
            f"({(paged / flat - 1) * 100:+.1f} %); paged stepwise "
            f"{step.tokens_per_second:.1f}"
            + (f", paged unfused {unfused.tokens_per_second:.1f}"
               if kv_bits else "")
            + f"; page pool {turns[1].pool_bytes / 2**20:.2f} MiB (the "
            f"contiguous pool's bytes), dense view "
            f"{turns[1].view_bytes / 2**20:.2f} MiB ({smi_line()})")


def served_engine(torch, engine, requests, label, *, warm=True):
    """Run ``requests`` through ``engine`` (its graphs captured by warmup
    first when ``warm``), launches reset before and read after and held to
    ``expected_launches`` of serve-w8a16 over the fp cache; returns
    (results, seconds)."""
    import time

    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    warmup = engine.warmup() if warm else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    steps = engine.stats["decode_steps"] + warmup.get("decode_steps", 0)
    chunks = (engine.stats["prefill_dispatches"]
              + warmup.get("prefill_dispatches", 0))
    want = expected_launches("w8a16", True, steps, chunks, kv_bits=16)
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")
    return results, seconds


def shared_prefix_trace(vocab):
    """8b's trace (see ``SHARED_PREFIX``)."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, size=SHARED_PREFIX)
    out = []
    for i in range(SERVE["trace"]):
        own = rng.randint(0, vocab, size=int(rng.randint(8, 65)))
        out.append(Request(rid=i, prompt=np.concatenate([base, own]),
                           max_new_tokens=SERVE["gen_len"],
                           arrival=0.0 if i == 0 else 6.0 + i))
    return out


def check_prefix_reuse(torch, model, params, cfg):
    """8b: the shared-prefix trace with reuse on and off (serve-w8a16,
    bf16 KV, fast after warmup): the same tokens, no request later with
    reuse on, prefix hits, fewer prefill chunks; cow_copies logged."""
    from repro_torch.serving import ServingEngine

    out = {}
    for reuse in (True, False):
        engine = ServingEngine(model, params, cfg, prefix_reuse=reuse,
                               **ENGINE)
        label = f"8b reuse {'on' if reuse else 'off'}"
        res, secs = served_engine(torch, engine, shared_prefix_trace(
            cfg.vocab_size), label)
        assert all(r.status == "ok" and len(r.tokens) == SERVE["gen_len"]
                   for r in res.values()), label
        out[reuse] = engine, res, secs
    (on, res_on, s_on), (off, res_off, s_off) = out[True], out[False]
    for rid, r in res_off.items():
        assert res_on[rid].tokens == r.tokens, f"8b: request {rid}: tokens"
        assert res_on[rid].finished_at <= r.finished_at, (
            f"8b: request {rid} finished later with reuse on")
    hits = on.prefix_index.hits
    assert hits > 0, "8b: no prefix hit"
    assert on.stats["prefill_chunks"] < off.stats["prefill_chunks"], (
        "8b: reuse saved no prefill chunk")
    gen = sum(len(r.tokens) for r in res_on.values())
    log(f"  8b shared {SHARED_PREFIX}-token prefix, 16 requests: the same "
        f"tokens with reuse on and off; prefix hits {hits}, prefill chunks "
        f"{on.stats['prefill_chunks']} / {off.stats['prefill_chunks']} "
        f"(on / off), engine ticks {on.stats['engine_steps']} / "
        f"{off.stats['engine_steps']}, cow_copies {on.pool.cow_copies}, "
        f"{gen / s_on:.1f} / {gen / s_off:.1f} tok/s ({smi_line()})")
    return on


def check_starved_pool(torch, model, params, cfg):
    """8c: a pool of ``STARVED_PAGES`` pages against the full one on a
    trace of long prompts in two priority classes: preemptions, every one
    resumed, every request ok with the full pool's tokens."""
    from repro_torch.serving import ServingEngine, synthetic_trace

    tr = dict(STARVED_TRACE)
    trace = lambda: synthetic_trace(tr["seed"], tr["n"],
                                    vocab_size=cfg.vocab_size,
                                    **{k: v for k, v in tr.items()
                                       if k not in ("seed", "n")})
    full = ServingEngine(model, params, cfg, **ENGINE)
    res_full, _ = served_engine(torch, full, trace(), "8c full pool")
    starved = ServingEngine(model, params, cfg, num_pages=STARVED_PAGES,
                            **ENGINE)
    res, secs = served_engine(torch, starved, trace(), "8c starved pool")
    st = starved.stats
    assert st["preempted"] > 0, "8c: nothing was preempted"
    assert st["resumed"] == st["preempted"], (
        f"8c: {st['resumed']} of {st['preempted']} preempted resumed")
    for rid, r in res_full.items():
        assert res[rid].status == "ok", f"8c: request {rid}: {res[rid].status}"
        assert res[rid].tokens == r.tokens, f"8c: request {rid}: tokens"
    starved.check_invariants()
    log(f"  8c starved pool ({STARVED_PAGES} of {full.pool.num_pages} pages): "
        f"{st['preempted']} preempted, {st['resumed']} resumed, 16/16 ok "
        f"with the full pool's tokens; engine ticks {st['engine_steps']} / "
        f"{full.stats['engine_steps']} (starved / full), "
        f"{st['generated_tokens'] / secs:.1f} tok/s")


def check_deadlines(torch, model, params, cfg):
    """8e: phase 4's trace with deadlines, fast and stepwise: the same
    requests expire at the same ticks with the same tokens."""
    from repro_torch.serving import ServingEngine, synthetic_trace

    out = {}
    for fast in (True, False):
        engine = ServingEngine(model, params, cfg, fast=fast, **ENGINE)
        trace = synthetic_trace(
            SERVE["trace_seed"], SERVE["trace"], vocab_size=cfg.vocab_size,
            prompt_lens=(SERVE["prompt_min"], SERVE["prompt_len"]),
            gen_lens=(SERVE["gen_min"], SERVE["gen_len"]),
            mean_interarrival=1.0, deadline_slack=DEADLINE_SLACK)
        out[fast] = served_engine(torch, engine, trace,
                                  f"8e fast={fast}", warm=fast)[0]
    for rid, r in out[False].items():
        got = out[True][rid]
        assert (got.status, got.finished_at, got.tokens) == (
            r.status, r.finished_at, r.tokens), f"8e: request {rid}"
    expired = sorted(rid for rid, r in out[True].items()
                     if r.status == "expired")
    assert expired, "8e: no request expired"
    log(f"  8e deadlines {DEADLINE_SLACK[0]:g}-{DEADLINE_SLACK[1]:g} ticks "
        f"after arrival: fast and stepwise expire the same {len(expired)} "
        f"requests ({expired}) at the same ticks with the same tokens")


def check_chaos(torch):
    """8d: ``run_chaos`` under ``FaultPlan.seeded`` at the chaos CLI's
    settings (serve-w8a16 over the smoke model's weights drawn on the
    host), on the card and on the CPU: invariants checked after every step,
    0 leaked pages, the unfaulted requests the card's fault-free tokens,
    and outcomes, counters and steps the CPU's; launches exact."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (FaultPlan, ServingEngine,
                                     assert_unfaulted_parity, run_chaos,
                                     synthetic_trace)

    cfg = dataclasses.replace(repro_torch.get_config("qwen2-0.5b", smoke=True),
                              name="qwen2-chaos-smoke")
    model = repro_torch.build_model(cfg)
    params = model.init(0, device="cpu")
    trace = synthetic_trace(0, 24, vocab_size=cfg.vocab_size,
                            prompt_lens=(4, 16), gen_lens=(4, 16),
                            mean_interarrival=1.0, priority_levels=2)
    plan = lambda: FaultPlan.seeded(0, [r.rid for r in trace], n_steps=40)
    reports = {}
    for device in ("cpu", "cuda"):
        qm = repro_torch.quantize(model, params, device=device,
                                  recipe="serve-w8a16")
        kw = dict(CHAOS, device=device)
        clean = ServingEngine(qm.model, qm.params, qm.cfg, **kw).run(
            [dataclasses.replace(r) for r in trace])
        engine = ServingEngine(qm.model, qm.params, qm.cfg,
                               num_pages=CHAOS_PAGES, **kw)
        reset_launch_counts()
        report = run_chaos(engine, [dataclasses.replace(r) for r in trace],
                           plan())
        counts = launch_counts()
        compared = assert_unfaulted_parity(report, clean,
                                           plan().faulted_rids())
        assert report.leaked_pages == 0, f"8d {device}: pages leaked"
        reports[device] = report
        if device == "cuda":
            masked = engine._masked_forwards
            want = expected_launches(
                "w8a16", True, engine.stats["decode_steps"]
                + masked["decode_steps"], engine.stats["prefill_dispatches"]
                + masked["prefill_dispatches"], cfg=cfg, kv_bits=16,
                slots=CHAOS["num_slots"], chunk=CHAOS["prefill_chunk"])
            for name, n in counts.items():
                assert n == want.get(name, 0), (
                    f"8d: {name} launched {n} times, expected "
                    f"{want.get(name, 0)}")
            assert counts["qmatmul_w8a16"] > 0
    card, cpu = reports["cuda"], reports["cpu"]
    drop = lambda c: {k: v for k, v in c.items() if k != "straggler_steps"}
    assert card.outcomes == cpu.outcomes, "8d: outcomes differ from the CPU's"
    assert drop(card.counts) == drop(cpu.counts), (
        f"8d: counts {card.counts} against the CPU's {cpu.counts}")
    assert card.steps == cpu.steps, "8d: steps differ from the CPU's"
    log(f"  8d chaos (the CLI's settings, {CHAOS_PAGES}-page pool, "
        f"FaultPlan.seeded(0)): {card.steps} steps, invariants held every "
        f"step, {compared} unfaulted requests with the fault-free tokens, "
        f"0 leaked pages; outcomes, counts and steps the CPU's: "
        f"{json.dumps(drop(card.counts))}")


def graph_ms(torch, fn, iters: int = 50) -> float:
    """Device time of ``fn`` captured in a CUDA graph, as the fast path
    runs it (one replay a call: the host enqueues ahead of the card)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return device_ms(graph.replay, iters)


def time_gather(torch):
    """The dense view's memory and the device time of the gather and of a
    horizon's commit at phase 4's shape (8 slots x 512 positions, 24
    layers, pages of 32), each captured in a graph as the fast path runs
    it, for the bf16 and the int8 cache, beside the bytes bound (the view
    read from the pages and written once)."""
    import repro_torch
    from repro_torch.serving import CachePool
    from repro_torch.serving.engine import _paged_commit, _paged_view

    model = repro_torch.build_model(repro_torch.get_config(SERVE["arch"]))
    B, S, pg = SERVE["slots"], SERVE["max_len"], PAGED["page_size"]
    for kv_bits in (16, 8):
        pool = CachePool(model, B, S, device="cuda", kv_bits=kv_bits,
                         page_size=pg)
        for slot in range(B):
            pool.allocate_pages(S)
        dense = {n: torch.empty((s.shape[0], B, S) + tuple(s.shape[3:]),
                                dtype=s.dtype, device="cuda")
                 for n, s in pool.storage.items()}
        view = sum(t.numel() * t.element_size() for t in dense.values())
        gather = graph_ms(torch, lambda: _paged_view(pool, dense))
        rows = torch.arange(8, device="cuda").repeat(B, 1)
        commit = graph_ms(torch, lambda: _paged_commit(pool, dense, rows))
        bound = 2 * view / hw_peak(HBM_BYTES_S) * 1e3
        log(f"  paged gather, {'bf16' if kv_bits == 16 else 'int8'} cache: "
            f"dense view {view / 2**20:.2f} MiB (pool "
            f"{pool.cache_bytes() / 2**20:.2f} MiB), gather {gather * 1e3:.1f}"
            f" us [bound {bound * 1e3:.1f} us, bytes], a horizon's commit "
            f"(8 x 8 positions) {commit * 1e3:.1f} us ({smi_line()})")


# --------------------------------------------------------------- phase 10
# the async front-end on phase 4's engine settings (8 slots, max_len 512,
# prefill chunks of 32, serve-w8a16 over the bf16 KV cache, the fast path
# with every graph captured by warmup) and phase 4's request lengths in two
# priority classes: 10a 16 requests offered at 0.25 a tick, no queue bound;
# 10b 48 at 2.0 a tick from the paged pool (pages of 32) behind a 4-deep
# queue, a client timeout of 48 ticks, shedding from queue pressure 0.5
UNDERLOAD = dict(n=16, qps=0.25)
OVERLOAD = dict(SERVE, trace=48, qps=2.0, max_queue=4, timeout=48.0,
                shed_pressure=0.5, page_size=32, serve_async=True,
                warmup=True, quantize="w8a16")
# the statuses a client outcome ends in
TERMINAL = {"ok", "expired", "cancelled", "quarantined", "shed", "rejected"}


def async_underload(torch, qm):
    """10a: ``UNDERLOAD``'s open-loop trace through ``AsyncServer`` /
    ``AsyncClient`` over an engine (graphs captured by warmup) against
    ``engine.run`` of the same requests over another: every outcome ok,
    each rid's tokens ``engine.run``'s (the JAX test
    ``test_streaming_matches_batch_engine``), token ticks in order; both
    runs' launches exact. Returns the async run's launch counts."""
    import asyncio
    import dataclasses

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (
        AsyncClient,
        AsyncServer,
        RetryPolicy,
        ServingEngine,
        open_loop_trace,
        run_open_loop,
    )

    trace = open_loop_trace(
        SERVE["trace_seed"], UNDERLOAD["n"], UNDERLOAD["qps"],
        vocab_size=qm.cfg.vocab_size,
        prompt_lens=(SERVE["prompt_min"], SERVE["prompt_len"]),
        gen_lens=(SERVE["gen_min"], SERVE["gen_len"]), priority_levels=2)
    engine = dict(ENGINE, page_size=None)
    ref, ref_s = served_engine(torch, ServingEngine(
        qm.model, qm.params, qm.cfg, **engine),
        [dataclasses.replace(r) for r in trace], "10a engine.run")
    eng = ServingEngine(qm.model, qm.params, qm.cfg, **engine)
    reset_launch_counts()
    warm = eng.warmup()
    server = AsyncServer(eng)
    client = AsyncClient(server, RetryPolicy(), seed=SERVE["trace_seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outcomes = asyncio.run(run_open_loop(
        server, client, [dataclasses.replace(r) for r in trace]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_launches(
        "w8a16", True, eng.stats["decode_steps"] + warm["decode_steps"],
        eng.stats["prefill_dispatches"] + warm["prefill_dispatches"],
        kv_bits=16)
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"10a async: {name} launched {n} times, expected "
            f"{want.get(name, 0)}")
    assert len(outcomes) == UNDERLOAD["n"]
    for o in outcomes:
        assert o.ok, f"10a: request {o.rid}: {o.status}"
        assert o.tokens == ref[o.rid].tokens, f"10a: request {o.rid}: tokens"
        assert o.token_ticks == sorted(o.token_ticks), o.rid
    gen = sum(len(o.tokens) for o in outcomes)
    log(f"  10a underload ({UNDERLOAD['n']} requests at {UNDERLOAD['qps']} a "
        f"tick): every outcome ok, each rid's tokens engine.run's; "
        f"{gen / secs:.1f} tok/s through the front-end against "
        f"{gen / ref_s:.1f} tok/s engine.run ({secs:.3f} / {ref_s:.3f} s, "
        f"{server.steps} server steps; {smi_line()})")
    log(f"  kernel launches on the 10a async path: {json.dumps(counts)}")
    return counts


def async_overload(torch, label):
    """10b / 10c: ``repro_torch.serve`` of ``OVERLOAD`` (the user's
    --serve-async path): shed and breaker counters above 0, every outcome
    terminal, no page leaked, launches exact. Returns (run, counts)."""
    import repro_torch

    run, counts = counted_serve(repro_torch.ServeConfig(**OVERLOAD))
    want = expected_launches("w8a16", True, *forwards(run), kv_bits=16)
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")
    st, s = run.server_stats, run.async_summary
    shed = st["shed_breaker"] + st["shed_priority"] + st["shed_refused"] \
        + st["shed_queue"]
    assert shed > 0 and st["breaker_opens"] > 0, (
        f"{label}: the overload shed {shed} and opened the breaker "
        f"{st['breaker_opens']} times")
    assert len(run.outcomes) == OVERLOAD["trace"]
    bad = [o.rid for o in run.outcomes if o.status not in TERMINAL]
    assert not bad, f"{label}: outcomes not terminal: {bad}"
    assert run.leaked_pages == 0, f"{label}: {run.leaked_pages} pages leaked"
    log(f"  {label} overload ({OVERLOAD['trace']} requests at "
        f"{OVERLOAD['qps']} a tick, max_queue {OVERLOAD['max_queue']}, timeout "
        f"{OVERLOAD['timeout']:g}, paged): statuses {s['statuses']}; goodput "
        f"{s['goodput_qps']:.4f} req/tick ({s['goodput_fraction']:.0%}); TTFT "
        f"p50/p99 {s['ttft_p50']:.2f}/{s['ttft_p99']:.2f} ticks, per-token "
        f"p50/p99 {s['per_token_p50']:.2f}/{s['per_token_p99']:.2f} ticks, "
        f"mean attempts {s['mean_attempts']:.3f}; admission "
        + ", ".join(f"{k}={st[k]}" for k in (
            "submitted", "accepted", "shed_breaker", "shed_priority",
            "shed_refused", "shed_queue", "deadlines_tightened",
            "breaker_opens"))
        + f"; 0 pages leaked; {run.seconds:.3f} s wall, "
        f"{run.tokens_per_second:.1f} tok/s ({smi_line()})")
    log(f"  kernel launches on the {label} async path: {json.dumps(counts)}")
    return run, counts


def check_async_front_end(torch):
    """Phase 10: 10a, then 10b, then 10c (10b again: its outcomes — status,
    tokens, attempts, token ticks — and the server's counters identical,
    determinism on the card). Returns the 10b launch counts."""
    import repro_torch

    qm = repro_torch.quantize(repro_torch.build_model(
        repro_torch.get_config(SERVE["arch"])), None, init_seed=SERVE["seed"],
        device="cuda", recipe="serve-w8a16")
    async_underload(torch, qm)
    del qm
    b, counts = async_overload(torch, "10b")
    c, _ = async_overload(torch, "10c")

    def key(run):
        return ([(o.rid, o.status, o.attempts, o.tokens, o.token_ticks)
                 for o in run.outcomes], run.server_stats, run.async_summary)

    assert key(b) == key(c), "10c: the rerun's outcomes or counters differ"
    log("  10c rerun: every outcome (status, tokens, attempts, token ticks), "
        "the server's counters and the SLO summary identical to 10b's")
    return counts


# --------------------------------------------------------------- phase 11
# the new families at full width: 8 sequences of a 128-token prompt, then
# 32 greedy decode steps; whisper's encoder over 1500 frames each
FAMILY = dict(batch=8, prompt=128, steps=32)
# the depths cut_depth probes the quantize peak at (zamba2: segments of 6
# mamba layers, each followed by a shared block); whisper-tiny runs whole
FAMILY_PROBES = {"mamba2-2.7b": (1, 2), "zamba2-2.7b": (6, 12),
                 "whisper-tiny": None}
# the most layers phase 11 runs of mamba2's 64 and zamba2's 54 (two of its
# segments), a cut for the script's time (at full depth the phase took
# 40-57 s on the H100)
FAMILY_MOST = {"mamba2-2.7b": 16, "zamba2-2.7b": 12}
# the smoke models' quantize on the card against the CPU's: a bias a
# rewrite computes by a sum (a LayerNorm shift folded through a weight, an
# absorbed value bias) sums in another order on the card — within
# FAMILY_SUM_TOL of its largest |value| (tests/_torch_port.py's BIAS_TOL
# for the port against the JAX package); every other leaf bit-equal
FAMILY_SUM_TOL = 1e-5
# decode logits (prefill + greedy decode_steps over the cache, bf16 at full
# width) against the float32 teacher-forced forward of the same quantized
# weights over the same tokens: no farther from it than FAMILY_TF_FACTOR
# times the bf16 teacher-forced forward is. Both bf16 paths round at every
# layer, in other places (the chunked scan against the recurrence, the
# cached attention against the causal forward, GEMMs of other row counts),
# so their distance from each other is bf16 noise of the size of either's
# distance from float32 — up to 6 % of the largest |logit| over mamba2's
# 64 layers (chip run) — and an absolute bound would not say which path
# strayed
FAMILY_TF_FACTOR = 2.0


def family_inputs(cfg, M):
    """(projection, K, the Ns of the projections reading one input, M
    rows) of every linear input of one forward of the decoder at M rows: a
    Mamba2 layer's in_proj and out_proj, a shared (zamba2) or decoder
    (whisper) block's q/k/v trio, o, the MLP's gate/up (up alone without a
    gate) and down; and whisper's cross attention's q and o."""
    from repro_torch.models.mamba import ssm_dims

    D, A, KV, F = cfg.d_model, cfg.attn_dim, cfg.kv_dim, cfg.d_ff
    attn = [("q/k/v", D, (A, KV, KV), M), ("o", A, (D,), M)]
    mlp = [("gate/up", D, (F, F), M) if cfg.act.endswith("_glu")
           else ("up", D, (F,), M), ("down", F, (D,), M)]
    if cfg.is_encdec:
        return (attn + [("cross q", D, (A,), M), ("cross o", A, (D,), M)]
                + mlp) * cfg.n_layers
    din, _, _, _, d_proj, _ = ssm_dims(cfg)
    out = [("in_proj", D, (d_proj,), M),
           ("out_proj", din, (D,), M)] * cfg.n_layers
    if cfg.family == "hybrid":
        out += (attn + mlp) * (cfg.n_layers // cfg.hybrid_attn_every)
    return out


def warm_inputs(cfg, M):
    """``EncDecModel.warm_cache``'s linear inputs at M encoder rows: each
    encoder layer's q/k/v trio, o, up and down, then each decoder layer's
    cross keys and values (two projections, each on its own)."""
    D, A, KV, F = cfg.d_model, cfg.attn_dim, cfg.kv_dim, cfg.d_ff
    return ([("enc q/k/v", D, (A, KV, KV), M), ("enc o", A, (D,), M),
             ("enc up", D, (F,), M), ("enc down", F, (D,), M)]
            * cfg.n_enc_layers
            + [("cross k", D, (KV,), M), ("cross v", D, (KV,), M)]
            * cfg.n_layers)


def family_path_inputs(arch):
    """The linear inputs of phase 11's path through ``arch`` at full
    width, as ``family_inputs`` gives them, once each in the order the path
    first reaches them: the prefill's (FAMILY's batch x prompt rows), a
    decode step's (the batch), and whisper's ``warm_inputs`` (batch x
    enc_seq encoder rows). The depth does not change them."""
    import repro_torch

    cfg = repro_torch.get_config(arch)
    B, P = FAMILY["batch"], FAMILY["prompt"]
    inputs = family_inputs(cfg, B * P) + family_inputs(cfg, B)
    if cfg.is_encdec:
        inputs += warm_inputs(cfg, B * cfg.enc_seq)
    return list(dict.fromkeys(inputs))


def family_path_gemms(arch):
    """(projection, K, N, M) of every GEMM on phase 11's path through
    ``arch``, once each, in path order."""
    out: dict = {}
    for name, K, Ns, M in family_path_inputs(arch):
        for N in Ns:
            out.setdefault((K, N, M), name)
    return [(name, K, N, M) for (K, N, M), name in out.items()]


def family_quantize_inputs(arch):
    """(M, K) of every input that serve-w8a8 quantizes with quantize_act
    on phase 11's path through ``arch`` (where ``gemm_plan`` does not fold
    for every projection reading it; ``family_launches``' rule), once
    each, in path order."""
    from repro_torch.kernels import gemm_plan

    return list(dict.fromkeys(
        (M, K) for _, K, Ns, M in family_path_inputs(arch)
        if not all(gemm_plan.plan(M, N, K).fold for N in Ns)))


def family_launches(quantize, inputs):
    """{kernel: launches} of ``inputs``: W8A16 one qmatmul_w8a16 a
    projection; W8A8 as ``gemm_plan`` says for each input — where it folds
    for every projection reading it, one qmatmul_w8a8_qin (which hands its
    quantized input to the others, an int8 GEMM each), else one
    quantize_act and an int8 GEMM each."""
    from repro_torch.kernels import gemm_plan

    want: dict = {}

    def add(k, n):
        want[k] = want.get(k, 0) + n

    for _, K, Ns, M in inputs:
        if quantize == "w8a16":
            add("qmatmul_w8a16", len(Ns))
        elif all(gemm_plan.plan(M, N, K).fold for N in Ns):
            add("qmatmul_w8a8_qin", 1)
            add("qmatmul_w8a8", len(Ns) - 1)
        else:
            add("quantize_act", 1)
            add("qmatmul_w8a8", len(Ns))
    return want


def family_generate(torch, model, params, toks, frames, steps, dev,
                    forced=None):
    """Prefill ``toks`` [B, P] (whisper: after ``warm_cache`` on
    ``frames``) into a cache of P + ``FAMILY["steps"]`` positions, then
    ``steps`` greedy decode steps (or, given ``forced`` [B, P+steps], steps
    fed its tokens), the card synchronized around each phase.
    Returns (logits of every step [steps+1, B, V], the tokens fed [B,
    P+steps], warm ms, prefill ms, decode seconds)."""
    B, P = toks.shape
    cache = model.init_cache(B, P + FAMILY["steps"], device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if frames is not None:
        cache = model.warm_cache(params, frames, cache)
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    lg, cache = model.prefill(params, toks, cache)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    out, seq = [lg], [toks]
    for i in range(steps):
        nxt = (lg.argmax(-1, keepdim=True) if forced is None
               else forced[:, P + i:P + i + 1])
        seq.append(nxt)
        lg, cache = model.decode_step(params, nxt, cache)
        out.append(lg)
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    return (torch.stack(out).float(), torch.cat(seq, 1),
            (t1 - t0) * 1e3, (t2 - t1) * 1e3, t3 - t2)


def family_full_width(torch, dev, arch, depth, recipe):
    """One arch of phase 11 under ``recipe``: ``repro_torch.quantize`` at
    full width (``depth`` layers) on the card, ``FAMILY``'s prefill and
    greedy decode, launches reset just before and read just after and held
    to ``family_launches`` of its layers, the decode logits against the
    float32 teacher-forced forward within ``FAMILY_TF_FACTOR`` times the
    bf16 forward's distance from it; then the prefill and the decode steps
    again at ``backend="torch"`` (the tier scope, the plain versions), fed
    the kernel run's tokens: no launch, and its logits the kernels' bit for
    bit under W8A8 and within ``FAMILY_TF_FACTOR`` times the bf16
    forward's distance under W8A16 (the one check of the logits that runs
    no hand-written kernel: the float32 forward launches qmatmul_w8a16
    too). Returns the launch counts."""
    import dataclasses
    import gc

    import repro_torch
    from repro_torch.data import calibration_tokens, prng
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import tier_scope

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(repro_torch.get_config(arch), n_layers=depth)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    qm = repro_torch.quantize(repro_torch.build_model(cfg), None,
                              recipe=recipe, device=dev)
    torch.cuda.synchronize(dev)
    q_s = time.perf_counter() - t0
    q_peak = torch.cuda.max_memory_allocated(dev) - base
    model, params = qm.model, qm.params
    B, P, S = FAMILY["batch"], FAMILY["prompt"], FAMILY["steps"]
    toks = calibration_tokens(5, B, P, cfg.vocab_size, device=dev)
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(prng.normal(
            prng.PRNGKey(5), (B, cfg.enc_seq, cfg.d_model))).to(dev)
    reset_launch_counts()
    steps, seq, warm_ms, prefill_ms, decode_s = family_generate(
        torch, model, params, toks, frames, S, dev)
    counts = launch_counts()
    quantize = recipe.split("-")[1]
    inputs = family_inputs(cfg, B * P) + family_inputs(cfg, B) * S
    if cfg.is_encdec:
        inputs += warm_inputs(cfg, B * cfg.enc_seq)
    want = family_launches(quantize, inputs)
    label = f"{arch} ({depth} layers) {recipe}"
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")
    def forced(m):
        """m's teacher-forced logits at the decode positions [S+1, B, V]."""
        full = m.apply(params, seq, frames) if cfg.is_encdec else m.apply(
            params, seq)
        return full.float()[:, P - 1:].transpose(0, 1)

    tf = forced(model)
    ref = forced(repro_torch.build_model(dataclasses.replace(
        cfg, dtype="float32")))
    assert all(torch.isfinite(t).all() for t in (steps, tf, ref)), label
    err_dec = float((steps - ref).abs().max())
    err_tf = float((tf - ref).abs().max())
    diff = float((steps - tf).abs().max())
    scale = float(ref.abs().max())
    agree = float((steps.argmax(-1) == tf.argmax(-1)).float().mean())
    assert err_dec <= FAMILY_TF_FACTOR * err_tf, (
        f"{label}: decode logits {err_dec:.4g} off the float32 forward, the "
        f"bf16 teacher-forced forward {err_tf:.4g}")
    reset_launch_counts()
    with tier_scope("torch"):
        plain = family_generate(torch, model, params, toks, frames, S, dev,
                                forced=seq)[0]
    plain_counts = launch_counts()
    assert not any(plain_counts.values()), (
        f"{label}: backend='torch' launched {plain_counts}")
    plain_diff = float((plain - steps).abs().max())
    plain_prefill = float((plain[0] - steps[0]).abs().max())
    assert torch.isfinite(plain).all(), label
    # W8A8's plain versions are the kernels' bits (integer products, the
    # same float epilogue); W8A16's apply the scale before the sum, in
    # float32, where the kernel applies it after: bf16 noise of the size
    # of the kernel path's own distance from float32
    if quantize == "w8a8":
        assert plain_diff == 0.0, (
            f"{label}: backend='torch' logits {plain_diff} off the kernels'")
    else:
        assert plain_diff <= FAMILY_TF_FACTOR * err_tf, (
            f"{label}: backend='torch' logits {plain_diff:.4g} off the "
            f"kernels' on the same tokens, the bf16 teacher-forced forward "
            f"{err_tf:.4g} off float32")
    log(f"  {label}: quantize {q_s:.2f} s (peak {q_peak / 2**30:.2f} GiB)"
        + (f", warm_cache (encoder over {cfg.enc_seq} frames) {warm_ms:.2f} ms"
           if frames is not None else "")
        + f", prefill {B}x{P} {prefill_ms:.2f} ms, {S} greedy decode steps "
        f"{B * S / decode_s:.1f} tok/s ({decode_s * 1e3 / S:.2f} ms a step); "
        f"off the float32 teacher-forced forward (max |logit| {scale:.4g}): "
        f"decode {err_dec:.4g}, bf16 forward {err_tf:.4g}; decode vs bf16 "
        f"forward max |diff| {diff:.4g}, greedy agreement {agree:.3f}; "
        f"backend='torch' on the same tokens 0 launches, its logits within "
        f"{plain_diff:.4g} of the kernels' (prefill {plain_prefill:.4g}) "
        f"({smi_line()})")
    log(f"  kernel launches on the {label} path: {json.dumps(counts)}")
    del qm, model, params
    return counts


def summed_biases(plan):
    """The bias paths a plan's rewrites compute by a sum: the consumer
    biases of a LayerNorm fold and the absorbing biases."""
    from repro_torch.core.graph import NormFoldOp, VBiasAbsorbOp

    out = set()
    for op in plan.ops:
        if isinstance(op, NormFoldOp) and op.norm_b is not None:
            out |= {b for b in op.consumer_biases or () if b is not None}
        elif isinstance(op, VBiasAbsorbOp):
            out.add(op.bo)
    return out


def check_family_smoke(torch, dev, arch):
    """``arch`` at smoke size, weights drawn on the host: for serve-w8a16
    and serve-w8a8, ``repro_torch.quantize`` on the card against the CPU's
    leaf by leaf (payloads, scales and weights bit-equal, ``summed_biases``
    within ``FAMILY_SUM_TOL``); then prefill 8 + 16 teacher-forced decode
    steps of the card's model (kernels) against the CPU's (plain versions),
    every step within 5 % of the largest |logit| and greedy agreement at
    least 0.9 (``teacher_forced``'s bound)."""
    import repro_torch
    from repro_torch.data import prng

    model = repro_torch.build_model(repro_torch.get_config(arch, smoke=True))
    cfg = model.cfg
    params = model.init(0, device="cpu")
    summed = summed_biases(model.dfq_plan())
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
    frames = (torch.from_numpy(prng.normal(prng.PRNGKey(2), (
        4, cfg.enc_seq, cfg.d_model))) if cfg.is_encdec else None)
    for recipe in ("serve-w8a16", "serve-w8a8"):
        cpu = repro_torch.quantize(model, params, recipe=recipe, device="cpu")
        card = repro_torch.quantize(model, params, recipe=recipe, device=dev)
        want, got = dict(_leaves(cpu.params)), dict(_leaves(card.params))
        assert sorted(want) == sorted(got), f"{arch} {recipe}: tree differs"
        worst = 0.0
        for path, t in want.items():
            g = got[path].cpu()
            assert g.dtype == t.dtype and g.shape == t.shape, path
            if path in summed:
                err = float((g - t).abs().max())
                assert err <= FAMILY_SUM_TOL * max(float(t.abs().max()), 1.0), (
                    f"{arch} {recipe}: {'/'.join(path)} off the CPU's by {err}")
                worst = max(worst, err)
            else:
                assert torch.equal(g, t), (
                    f"{arch} {recipe}: {'/'.join(path)} on the card differs "
                    f"from the CPU's")
        out = {}
        for name, d, p in (("cpu", "cpu", cpu.params),
                           ("cuda", dev, card.params)):
            cache = model.init_cache(4, 32, device=d)
            if frames is not None:
                cache = model.warm_cache(p, frames.to(d), cache)
            lg, cache = model.prefill(p, toks[:, :8].to(d), cache)
            steps = [lg]
            for t in range(8, 24):
                lg, cache = model.decode_step(p, toks[:, t:t + 1].to(d), cache)
                steps.append(lg)
            out[name] = torch.stack(steps).float().cpu()
        diff = float((out["cpu"] - out["cuda"]).abs().max())
        scale = float(out["cpu"].abs().max())
        agree = float((out["cpu"].argmax(-1)
                       == out["cuda"].argmax(-1)).float().mean())
        assert all(torch.isfinite(v).all() for v in out.values())
        assert diff <= 0.05 * scale and agree >= 0.9, (
            f"{arch} {recipe}: card and CPU disagree ({diff} of {scale}, "
            f"agreement {agree})")
        log(f"  smoke {arch} {recipe}: quantize on the card = the CPU's "
            f"({len(want) - len(summed & set(want))} leaves bit-equal"
            + (f", summed biases within {worst:.3g}" if worst else "")
            + f"); prefill 8 + 16 decode steps card vs CPU: max |logit diff| "
            f"{diff:.3g} (max |logit| {scale:.3g}), greedy agreement "
            f"{agree:.3f}")


def check_families(torch, dev):
    """Phase 11: each new family at smoke size card against CPU, then at
    full width (mamba2-2.7b and zamba2-2.7b at the depth ``cut_depth``
    allows, whisper-tiny whole) under serve-w8a16 and serve-w8a8. Returns
    {(arch, recipe): launch counts}."""
    counts = {}
    for arch, probe in FAMILY_PROBES.items():
        check_family_smoke(torch, dev, arch)
        depth = None
        if probe is not None:
            depth = cut_depth(torch, dev, arch, probe,
                              most=FAMILY_MOST[arch])
            every = probe[0] if arch.startswith("zamba2") else 1
            depth = max(every, depth // every * every)
        import repro_torch

        depth = depth or repro_torch.get_config(arch).n_layers
        for recipe in ("serve-w8a16", "serve-w8a8"):
            counts[arch, recipe] = family_full_width(torch, dev, arch, depth,
                                                     recipe)
    return counts


# --------------------------------------------------------------- phase 12
# 12a: the training run (the launcher's flags): qwen2-0.5b at full width, one
# checkpoint mid-run (step 20) and the final one
TRAIN = dict(arch="qwen2-0.5b", steps=30, batch=8, seq=256, ckpt_every=20)
# 12b: the fault path at full width and a cut depth: checkpoints at steps 2
# and 4 and the end, a failure injected at step 5, a preemption requested
# once 5 steps are done. The loop restores the latest checkpoint it can
# see: the step-4 one may still be in writing (saves are asynchronous), but
# the step-2 one is complete (a save waits for the one before it)
TRAIN_FAULT = dict(layers=1, steps=6, ckpt_every=2, fail_at=5, preempt_at=5)
# 12a: steps run again under torch.profiler after the launcher's run
TRAIN_PROFILED = 3
# 12c: the evaluation tokens (seed, batch, length), the held-out batch of
# the training stream (a step the run never reads) and the served trace of
# the trained model: phase 4's settings, 8 requests
TRAINED_EVAL = (5, 4, 64)
HELD_OUT_STEP = 10_000
TRAINED_SERVE = dict(SERVE, trace=8)


def train_args(ckpt_dir, *extra, **over):
    """The launcher's argv for ``TRAIN`` (``over`` replacing its values)."""
    t = dict(TRAIN, **over)
    return ["--arch", t["arch"], "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(t["ckpt_every"]), *extra]


def train_full_width(torch, dev, smi):
    """12a: the launcher's ``main`` at full width. Returns its ``TrainRun``."""
    import shutil

    import numpy as np

    from repro_torch.launch import train

    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_train")
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    try:
        t0 = time.perf_counter()
        run = train.main(train_args(directory))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev) - base
    cfg = run.cfg
    assert run.end == TRAIN["steps"] and len(run.losses) == TRAIN["steps"]
    assert run.metrics.retries == 0 and all(np.isfinite(run.losses))
    steady = np.array(run.step_seconds[1:]) * 1e3
    med, p90 = float(np.median(steady)), float(np.percentile(steady, 90))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    n_params = cfg.param_count()
    mfu = 6 * n_params * tokens / (med / 1e3) / hw_peak(BF16_OPS_S)
    first, last = float(np.mean(run.losses[:10])), float(np.mean(run.losses[-10:]))
    assert last < first, f"12a: the loss did not fall ({first:.4f} -> {last:.4f})"
    log(f"  12a qwen2-0.5b ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, {cfg.dtype} compute "
        f"over {cfg.param_dtype} params, remat {cfg.remat}; N = {n_params} "
        f"params): {TRAIN['steps']} steps of {TRAIN['batch']} x "
        f"{TRAIN['seq']} tokens in {seconds:.2f} s (checkpoints at step "
        f"{TRAIN['ckpt_every']} and the end included)")
    log(f"  12a step ms: first {run.step_seconds[0] * 1e3:.1f}, median "
        f"{med:.2f}, p90 {p90:.2f}, min {float(steady.min()):.2f}, max "
        f"{float(steady.max()):.2f}; train tokens/s {tokens / (med / 1e3):.0f} "
        f"(at the median); peak device memory {peak / 2**30:.2f} GiB ({smi})")
    log(f"  12a mfu {mfu:.4f} (6 x {n_params} x {tokens} tokens / "
        f"{med:.2f} ms / {hw_peak(BF16_OPS_S) / 1e12:.0f} TFLOP/s bf16 peak)")
    log(f"  12a loss: first 10 steps {first:.4f}, last 10 {last:.4f} "
        f"(step 1 {run.losses[0]:.4f}, step {TRAIN['steps']} "
        f"{run.losses[-1]:.4f}); straggler events "
        f"{run.metrics.straggler_events}, retries {run.metrics.retries}")
    profile_train_steps(torch, dev, run, smi)
    return run


def profile_train_steps(torch, dev, run, smi):
    """``TRAIN_PROFILED`` more steps of the launcher's train step from 12a's
    state (one unprofiled first), under ``torch.profiler``: the wall time a
    step, the device busy share and the kernels that lead."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import _report_profile
    from repro_torch.launch.steps import make_train_step

    _, step = make_train_step(run.cfg, lr_cfg={
        "peak_lr": 1e-3, "warmup": 20, "total": TRAIN["steps"]})
    stream = TokenStream(seed=0, shard=0, n_shards=1,
                         batch_per_shard=TRAIN["batch"], seq=TRAIN["seq"],
                         vocab=run.cfg.vocab_size, device=dev)
    params, opt = run.state
    params, opt, m = step(params, opt, stream.batch(TRAIN["steps"]))
    float(m["loss"])
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(TRAIN_PROFILED):
            params, opt, m = step(params, opt,
                                  stream.batch(TRAIN["steps"] + 1 + i))
            float(m["loss"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    busy = _report_profile(prof, wall)
    log(f"  12a profiled: {TRAIN_PROFILED} more steps at "
        f"{wall / TRAIN_PROFILED * 1e3:.1f} ms a step under the profiler; "
        "device busy share "
        + ("not measured (no device time recorded)" if busy is None
           else f"{busy * 100:.1f} %") + f" ({smi})")


def same_state(torch, a, b, what):
    """Two train states equal leaf for leaf, bit for bit; returns the leaf
    count."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), (
            f"{what}: {'/'.join(map(str, path))} differs")
    return len(la)


def train_fault_path(torch, dev):
    """12b: the launcher's fault path at full width, ``TRAIN_FAULT``'s depth,
    deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set for this
    phase only, both restored after)."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.optim import AdamWState

    f = TRAIN_FAULT
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_fault")
    shutil.rmtree(root, ignore_errors=True)
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    saved_det = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        def args(name, *extra):
            return train_args(os.path.join(root, name), "--layers",
                              str(f["layers"]), *extra, steps=f["steps"],
                              ckpt_every=f["ckpt_every"])

        t0 = time.perf_counter()
        ref = train.main(args("ref"))
        fired = []

        def inject(step):
            if step == f["fail_at"] and not fired:
                fired.append(step)
                return True
            return False

        failed = train.main(args("fail"), inject_failure=inject)
        assert fired and failed.metrics.retries == 1
        assert failed.metrics.restores == 1 and failed.end == f["steps"]
        pre = train.main(args("pre"), preempt_at=f["preempt_at"])
        assert pre.metrics.preempted and pre.end == f["preempt_at"]
        ckpt = Checkpointer(os.path.join(root, "pre"))
        assert ckpt.latest_step() == f["preempt_at"]
        saved, _ = ckpt.restore(pre.state)
        assert isinstance(saved[1], AdamWState)
        n = same_state(torch, saved, pre.state, "the preemption checkpoint")
        resumed = train.main(args("pre", "--resume"))
        assert resumed.start == f["preempt_at"] and resumed.end == f["steps"]
        same_state(torch, failed.state, ref.state,
                   "the replayed run against the uninterrupted one")
        same_state(torch, resumed.state, ref.state,
                   "the resumed run against the uninterrupted one")
        seconds = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(saved_det)
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    replays = len(failed.losses) - f["steps"]
    log(f"  12b fault path (qwen2-0.5b full width, {f['layers']} layers, "
        f"{f['steps']} steps, checkpoints every {f['ckpt_every']}, "
        f"deterministic algorithms): failure injected at step "
        f"{f['fail_at']}: 1 retry, restored from step "
        f"{f['fail_at'] - replays} and replayed ({len(failed.losses)} step "
        f"calls for {f['steps']} steps); "
        f"preempted after step {f['preempt_at']}: its checkpoint = the "
        f"loop's state ({n} leaves bit-equal), resumed with --resume to step "
        f"{f['steps']}; both final states bit-equal to the uninterrupted "
        f"run's, leaf for leaf; losses {[round(x, 4) for x in ref.losses]} "
        f"({seconds:.1f} s)")


def quantize_trained(torch, dev, run):
    """12c, first half: 12a's trained weights through ``repro_torch.quantize``
    under dfq-int8, serve-w8a16, naive-int8 and serve-w8a8-kv8: logits SQNR
    and greedy agreement against the trained float model on
    ``TRAINED_EVAL``'s uniform ids (the data-free calibration source), and
    the loss on a held-out batch of the training stream beside the float
    model's. Logged, not gated (beyond finite values): which recipe keeps
    more is the finding. Returns {recipe: QuantizedModel} of the two served
    recipes."""
    import numpy as np

    import repro_torch
    from repro_torch.core import sqnr_db
    from repro_torch.data import calibration_tokens, token_batch

    model, params = run.model, run.state[0]
    cfg = run.cfg
    toks = calibration_tokens(*TRAINED_EVAL, cfg.vocab_size, device=dev)
    held = token_batch(0, HELD_OUT_STEP, 0, TRAIN["batch"], TRAIN["seq"],
                       cfg.vocab_size, device=dev)
    with torch.no_grad():
        y_fp = model.apply(params, toks).float()
        loss_fp = float(model.loss(params, held))
    log(f"  12c trained float model: held-out loss {loss_fp:.4f} (training "
        f"stream step {HELD_OUT_STEP}, {TRAIN['batch']} x {TRAIN['seq']})")
    served = {}
    for recipe in ("dfq-int8", "serve-w8a16", "naive-int8",
                   "serve-w8a8-kv8"):
        qm = repro_torch.quantize(model, params=params, recipe=recipe,
                                  device=dev)
        with torch.no_grad():
            y = qm.model.apply(qm.params, toks).float()
            loss_q = float(qm.model.loss(qm.params, held))
        assert bool(torch.isfinite(y).all()) and np.isfinite(loss_q), recipe
        agree = float((y.argmax(-1) == y_fp.argmax(-1)).float().mean())
        log(f"  12c trained qwen2-0.5b {recipe}: logits SQNR "
            f"{float(sqnr_db(y_fp, y)):.2f} dB, greedy agreement {agree:.4f} "
            f"against the trained float model on calibration_tokens"
            f"{TRAINED_EVAL + (cfg.vocab_size,)}; held-out loss {loss_q:.4f} "
            f"({loss_q - loss_fp:+.4f} on the float model's)")
        if recipe.startswith("serve-"):
            served[recipe] = qm
    return served


def serve_trained(torch, dev, qm, label, kv_bits, quantize):
    """12c, second half: ``TRAINED_SERVE``'s requests through a fast
    ``ServingEngine`` of the quantized trained weights (graphs captured by
    warmup), launches exact; then a ``backend="torch"`` engine on the same
    requests: no launch. Returns the kernel run's launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import ServeRun
    from repro_torch.serving import ServingEngine, synthetic_trace

    sv = TRAINED_SERVE
    out = {}
    for backend in (None, "torch"):
        engine = ServingEngine(qm.model, qm.params, qm.cfg, fast=True,
                               kv_bits=kv_bits, num_slots=sv["slots"],
                               max_len=sv["max_len"],
                               prefill_chunk=sv["prefill_chunk"],
                               device=dev, backend=backend)
        requests = synthetic_trace(
            sv["trace_seed"], sv["trace"], vocab_size=qm.cfg.vocab_size,
            prompt_lens=(sv["prompt_min"], sv["prompt_len"]),
            gen_lens=(sv["gen_min"], sv["gen_len"]), mean_interarrival=1.0)
        reset_launch_counts()
        warm = engine.warmup() if backend is None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        run = ServeRun(results=results, stats=dict(engine.stats),
                       seconds=seconds,
                       generated_tokens=engine.stats["generated_tokens"],
                       report=qm.report, warmup=warm, path="fast")
        assert len(results) == sv["trace"], label
        assert all(r.status == "ok" and r.tokens for r in results.values()), label
        out[backend] = run, counts
    run, counts = out[None]
    want = expected_launches(quantize, True, *forwards(run), cfg=qm.cfg,
                             kv_bits=kv_bits, slots=sv["slots"],
                             chunk=sv["prefill_chunk"])
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"12c {label}: {name} launched {n} times, expected "
            f"{want.get(name, 0)}")
    plain_run, plain_counts = out["torch"]
    assert not any(plain_counts.values()), (
        f"12c {label}: backend='torch' launched {plain_counts}")
    same = sum(plain_run.results[rid].tokens == r.tokens
               for rid, r in run.results.items())
    log(f"  12c served the trained model under {label}: {sv['trace']} "
        f"requests, {run.generated_tokens} tokens in {run.seconds:.3f} s = "
        f"{run.tokens_per_second:.1f} tok/s (fast path, {sv['slots']} slots); "
        f"launches {json.dumps(counts)} = expected; backend='torch': 0 "
        f"launches, {same} of {sv['trace']} requests with the kernels' tokens")
    return counts


def check_training(torch, dev, smi):
    """Phase 12. Returns {served label: launch counts}."""
    run = train_full_width(torch, dev, smi)
    train_fault_path(torch, dev)
    served = quantize_trained(torch, dev, run)
    del run
    counts = {}
    for label, recipe, kv_bits, quantize in (
            ("serve-w8a16 (bf16 KV)", "serve-w8a16", 16, "w8a16"),
            ("serve-w8a8-kv8", "serve-w8a8-kv8", 8, "w8a8")):
        counts[label] = serve_trained(torch, dev, served[recipe], label,
                                      kv_bits, quantize)
    return counts


# --------------------------------------------------------------- phase 13
# the meshes of 13a and 13b: two ranks on the one card, over gloo (NCCL
# refuses two ranks on one device)
TP_MESHES = ((1, 2), (2, 1))
# 13a / 13b serve qwen2-0.5b at full width cut to TP_LAYERS of its 24
# layers (two gloo ranks on the one card stage each collective through
# host memory: at 24 layers 13a / 13b took 163-285 s, at 6 the serving
# loops 49 s), beside one-device runs at the same depth; 13c and 13d
# serve all 24
TP_LAYERS = 3
# 13d's serve / --load round trip: a shorter trace of phase 4's settings
TP_ROUND_TRIP = dict(SERVE, trace=4, prompt_min=32, prompt_len=64, gen_min=8,
                     gen_len=8)


def tp_expected_launches(quantize, shape, steps, chunks, layers=None):
    """{kernel: launches} of one rank of a tensor-parallel serve of
    qwen2-0.5b over ``shape`` (data, model) on phase 4's settings, per
    decode step and prefill dispatch, as the model launches them: the
    column-parallel q/k/v and gate/up at this rank's columns (W8A8: the
    quantize-in fold where gemm_plan folds at every N, else quantize_act and
    an int8 GEMM each), fused_decode once a layer a decode step, and the
    row-parallel o and down — W8A16 one GEMM each (float32 partials); W8A8
    one epilogue-free int32 GEMM each, after one quantize_act of the
    gathered row, except o at a decode step of a model axis of 1, which
    takes the fused kernel's quantize-out (the attention sees every
    head). ``layers`` cuts the depth (default: all 24)."""
    import repro_torch
    from repro_torch.kernels import gemm_plan

    cfg = repro_torch.get_config(SERVE["arch"])
    data, m = shape
    D, F, A, KV, L = (cfg.d_model, cfg.d_ff, cfg.attn_dim, cfg.kv_dim,
                      layers or cfg.n_layers)
    slots = SERVE["slots"] // data
    want = {"fused_decode": L * steps}
    if quantize == "w8a16":
        want["qmatmul_w8a16"] = 7 * L * (steps + chunks)
        return want
    want.update(quantize_act=0, qmatmul_w8a8=0, qmatmul_w8a8_qin=0,
                qmatmul_w8a8_i32=0)
    for T, n, decode in ((1, steps, True), (SERVE["prefill_chunk"], chunks,
                                            False)):
        M = slots * T
        for K, Ns in ((D, (A // m, KV // m, KV // m)), (D, (F // m, F // m))):
            if all(gemm_plan.plan(M, N, K).fold for N in Ns):
                want["qmatmul_w8a8_qin"] += L * n
                want["qmatmul_w8a8"] += (len(Ns) - 1) * L * n
            else:
                want["quantize_act"] += L * n
                want["qmatmul_w8a8"] += len(Ns) * L * n
        want["qmatmul_w8a8_i32"] += 2 * L * n
        want["quantize_act"] += (1 if decode and m == 1 else 2) * L * n
    return want


#: the teacher-forced gate of 13 and 14 in float32 over a float cache: a
#: sharded forward's distance from one device's, as a share of max
#: |logit|, on a sequence whose every MoE choice is one device's. Both sum
#: the same float32 products in another order (the row-parallel partials
#: over "model"): 7.76e-07 on the CPU at mixtral's widened smoke config, 1
#: layer (tests/test_torch_serving_sharded_moe.py), where a rank's
#: down-projection partial dropped reads 0.517 and a 0.1 % error in it
#: ~4e-04. Over an int8 cache the card read 1.1e-04-7.7e-04 on qwen2's
#: 3 layers at 1x2: the cache's rounding steps, which a float cache lacks.
TP_F32_TOL = 1e-4


def plant_dropped_partial(torch, tree, drop):
    """``tree`` (a rank's cut params) with every MLP down projection
    (``mlp/wd``, ``mlp/experts/wd``: row-parallel under a serving shard)
    zeroed where ``drop`` — a planted fault: that rank's partial sums drop
    out of the forward. The rest of the tree is shared, not copied."""
    import dataclasses

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if drop and path[-1:] == ("wd",) and "mlp" in path and hasattr(
                t, "q"):
            return dataclasses.replace(t, q=torch.zeros_like(t.q))
        return t

    return walk(tree, ())


def tp_teacher_forced(torch, model, params, eng, seqs, kv_bits=8,
                      device="cuda"):
    """Each sequence's every-position logits (``logits_at="all"``) and
    each MoE block's top-k expert choices on ``device``: the single-device
    ``params`` in the config's compute dtype (bf16, the serving dtype) and
    in float32, and the sharded engine's blocks (``eng.params`` under
    ``eng.shard``) in both; on the first sequence also the float32 shard
    with ``plant_dropped_partial`` on the last model rank. The bf16 runs
    and the float32 one they are measured against use ``kv_bits``' cache;
    the float32 shard and the float32 one device it is held to use a
    float cache, since an int8 cache rounds each K/V entry: a step
    wherever the shard's K/V leave one device's in the last bit (the
    card's GEMMs sum a column cut in another order). Returns a dict a
    sequence: ``n`` positions; ``moved``, positions whose argmax left the
    single-device one (bf16); ``bf16`` / ``f32``, max |sharded - single| /
    max |logit| in each dtype; ``rounding``, max |single bf16 - single
    float32| / max |logit| (the bf16 forward's own distance); ``gap``, the
    largest ratio of a moved position's single-device top-2 gap to twice
    ``bf16``'s max |diff| (0 where none moved); ``routes_bf16`` /
    ``routes_f32``, whether the shard's expert choices are one device's in
    each dtype, and ``routes_rounding`` whether the bf16 single's are the
    float32 single's (True without MoE blocks); ``planted``, the planted
    float32 distance (None after the first sequence). Every rank runs it
    (its collectives) and gets the same numbers."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    import repro_torch
    from repro_torch.models import layers
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.tp import tp_scope

    shard = eng.shard
    model32 = repro_torch.build_model(
        dataclasses.replace(model.cfg, dtype="float32"))
    last = dist.get_rank(shard.model_group) == shard.model_n - 1
    planted_tree = plant_dropped_partial(torch, eng.params, last)
    real = layers.top_k

    def forward(m, tree, toks, sharded, bits):
        """(logits [T, V or V / model], each MoE block's choices)."""
        routes = []

        def top_k(probs, k):
            vals, idx = real(probs, k)
            routes.append(idx.cpu().numpy())
            return vals, idx

        cache = m.init_cache(1, toks.shape[1], device=device, per_slot=True,
                             kv_bits=bits,
                             **({"kv_heads": shard.kv_heads} if sharded
                                else {}))
        layers.top_k = top_k
        try:
            with tp_scope(shard if sharded else None):
                got = m.prefill(tree, toks, cache, logits_at="all")[0][0]
        finally:
            layers.top_k = real
        return got.float(), routes

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))

    out = []
    with torch.no_grad():
        for i, seq in enumerate(seqs):
            toks = torch.tensor([list(seq)], device=device)
            T = toks.shape[1]
            f32, r_f32 = forward(model32, params, toks, False, kv_bits)
            single, r_single = forward(model, params, toks, False, kv_bits)
            exact, r_exact = ((f32, r_f32) if kv_bits == 16 else
                              forward(model32, params, toks, False, 16))
            runs = [("bf16", model, eng.params, kv_bits),
                    ("f32", model32, eng.params, 16)]
            if i == 0:
                runs.append(("planted", model32, planted_tree, 16))
            entry = {"n": T, "planted": None,
                     "rounding": float((single - f32).abs().max())
                     / float(single.abs().max()),
                     "routes_rounding": same(r_single, r_f32)}
            for name, m, tree, bits in runs:
                sh, routes = forward(m, tree, toks, True, bits)
                ref = single if name == "bf16" else exact
                lo = shard.vocab_offset(sh.shape[-1])
                diff = (sh - ref[:, lo:lo + sh.shape[-1]]).abs().amax()
                coll.all_reduce_max(diff, shard.model_group)
                entry[name] = float(diff) / float(ref.abs().max())
                if name == "planted":
                    continue
                entry["routes_" + name] = same(
                    routes, r_single if name == "bf16" else r_exact)
                if name == "bf16":
                    with tp_scope(shard):
                        moved_to = coll.argmax(sh, lo, shard.model_group)
                    arg = single.argmax(-1)
                    moved = moved_to != arg
                    rows = torch.arange(T, device=device)
                    gap = single[rows, arg] - single[rows, moved_to]
                    entry["moved"] = int(moved.sum())
                    entry["gap"] = (float(gap[moved].max()) / (2 * float(diff))
                                    if bool(moved.any()) else 0.0)
            out.append(entry)
    return out


def tp_teacher_gate(tf, label):
    """The teacher-forced gate over ``tp_teacher_forced``'s sequences;
    returns (failures, a log line). Float32: every sequence whose MoE
    choices are one device's within ``TP_F32_TOL`` (at least one such),
    and the planted dropped partial past it. Bf16, where the shard's
    choices and the float32 forward's are the bf16 single's (a moved
    choice or a capacity drop it moves is a step in the function, not
    rounding): within twice the bf16 forward's own distance from float32,
    every moved argmax a near-tie (top-2 gap at most twice the max
    |diff|)."""
    fails = []
    exact = [t for t in tf if t["routes_f32"]]
    if not exact:
        fails.append(f"{label}: no sequence kept one device's float32 "
                     f"expert choices")
    for t in exact:
        if t["f32"] > TP_F32_TOL:
            fails.append(f"{label}: float32 distance {t['f32']:.3g} on a "
                         f"sequence of {t['n']} positions, over "
                         f"{TP_F32_TOL:g}")
    planted = tf[0]["planted"]
    if not planted > TP_F32_TOL:
        fails.append(f"{label}: the planted dropped partial read "
                     f"{planted:.3g}, within {TP_F32_TOL:g}")
    clean = [t for t in tf if t["routes_bf16"] and t["routes_rounding"]]
    for t in clean:
        if not (t["bf16"] <= 2 * t["rounding"] and t["gap"] <= 1.0):
            fails.append(f"{label}: bf16 on a sequence of {t['n']} "
                         f"positions with one device's choices: distance "
                         f"{t['bf16']:.3g}, its own {t['rounding']:.3g}, "
                         f"worst gap ratio {t['gap']:.3g}")
    flipped = [t for t in tf if not t["routes_bf16"]]
    n = sum(t["n"] for t in tf)
    line = (f"float32 max |sharded - one device| "
            f"{max((t['f32'] for t in exact), default=float('nan')):.3g} of "
            f"max |logit| over {len(exact)} of {len(tf)} sequences with one "
            f"device's choices (the gate {TP_F32_TOL:g}; the planted dropped "
            f"partial {planted:.3g}); bf16 "
            f"{max((t['bf16'] for t in tf), default=0.0):.3g}, argmax moved "
            f"at {sum(t['moved'] for t in tf)} of {n} positions; "
            f"{len(flipped)} sequences with other expert choices than one "
            f"device's in bf16 (max |diff| there "
            f"{max((t['bf16'] for t in flipped), default=0.0):.3g}), "
            f"{len(clean)} gated against the bf16 forward's own distance "
            f"(max {max((t['rounding'] for t in clean), default=0.0):.3g}; "
            f"their bf16 max |diff| "
            f"{max((t['bf16'] for t in clean), default=0.0):.3g})")
    return fails, line


def tp_rank(rank, world, store, out, ref):
    """A rank of 13a / 13b: join the gloo group, and for serve-w8a8-kv8-tp
    and serve-w8a16-kv8-tp (qwen2-0.5b at ``TP_LAYERS`` layers, quantized
    from phase 4's seed on the card) serve phase 4's trace over each mesh
    of ``TP_MESHES``, fast and stepwise, each run's launches counted from
    0; after each fast 1x2 run, ``tp_teacher_forced`` over every request's
    prompt and the one device's tokens at that depth (``ref``: {quantize:
    {rid: tokens}}). Writes its results (or its traceback) to
    ``out.<rank>``."""
    import dataclasses
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    result = None
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        import repro_torch
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.serve import _requests

        meshes = {s: make_production_mesh(shape=s, device="cuda",
                                          backend="gloo") for s in TP_MESHES}
        config = repro_torch.ServeConfig(**SERVE)
        result = {}
        cfg = dataclasses.replace(repro_torch.get_config(SERVE["arch"]),
                                  n_layers=TP_LAYERS)
        for quantize in ("w8a8", "w8a16"):
            qm = repro_torch.quantize(
                repro_torch.build_model(cfg), None, init_seed=SERVE["seed"],
                device="cuda", recipe=f"serve-{quantize}-kv8-tp")
            reqs = _requests(config, qm.cfg.vocab_size)
            for shape in TP_MESHES:
                for fast in (True, False):
                    eng = repro_torch.ServingEngine.from_quantized(
                        qm, mesh=meshes[shape], num_slots=SERVE["slots"],
                        max_len=SERVE["max_len"],
                        prefill_chunk=SERVE["prefill_chunk"], fast=fast,
                        device="cuda")
                    torch.cuda.synchronize()
                    dist.barrier()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    res = eng.run([dataclasses.replace(r) for r in reqs])
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    result[quantize, shape, fast] = {
                        "tokens": {rid: (list(r.tokens), r.finished_at,
                                         r.status) for rid, r in res.items()},
                        "seconds": dt, "stats": dict(eng.stats),
                        "counts": launch_counts(),
                        "head_local": eng.shard.head_local}
                    if fast and shape == (1, 2):
                        t0 = time.perf_counter()
                        result[quantize, shape, fast]["teacher_forced"] = (
                            tp_teacher_forced(
                                torch, qm.model, qm.params, eng,
                                [list(r.prompt) + ref[quantize][r.rid]
                                 for r in reqs]))
                        result[quantize, shape, fast]["tf_seconds"] = (
                            time.perf_counter() - t0)
                    del eng
            del qm
        dist.destroy_process_group()
    except BaseException:
        result = traceback.format_exc()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(target, world, job, phase, timeout=900):
    """Run ``target(rank, world, store, out, job)`` in ``world`` spawned
    processes (``tp_rank``, ``moe_tp_rank``); {rank: results}."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=target,
                             args=(r, world, os.path.join(tmp, "store"),
                                   os.path.join(tmp, "out"), job))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
        got = {}
        for r in range(world):
            path = os.path.join(tmp, f"out.{r}")
            assert os.path.exists(path), (
                f"phase {phase} rank {r} left no result (exit codes "
                f"{[p.exitcode for p in procs]})")
            with open(path, "rb") as f:
                got[r] = pickle.load(f)
            assert not isinstance(got[r], str), (
                f"phase {phase} rank {r} failed:\n{got[r]}")
        return got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def same_tp_tokens(tokens, ref, what):
    """Every request of a phase-13 run (``{rid: (tokens, finish tick,
    status)}``) got ``ref``'s (a phase-4 run) tokens and finish tick."""
    assert sorted(tokens) == sorted(ref.results), f"{what}: other requests"
    for rid, r in ref.results.items():
        toks, fin, status = tokens[rid]
        assert status == "ok", f"{what}: request {rid}: {status}"
        assert toks == r.tokens, f"{what}: request {rid}: other tokens"
        assert fin == r.finished_at, (
            f"{what}: request {rid}: finished at tick {fin}, not "
            f"{r.finished_at}")


def check_tensor_parallel(torch, dev, runs, smi):
    """Phase 13: qwen2-0.5b served tensor-parallel on the card.

    13a / 13b: meshes 1x2 and 2x1, two ranks on the one card over gloo (the
    backend named explicitly; NCCL refuses two ranks on one device), the
    fast path (eager: gloo's collectives cannot be captured) and the
    stepwise path, serve-w8a8-kv8-tp and serve-w8a16-kv8-tp on phase 4's
    trace at ``TP_LAYERS`` layers: every request's tokens and finish tick
    equal the one device's runs (``serve_cut``) on the same weights and
    depth, each rank's launches exact.
    13c: a 1x1 NCCL mesh, the fast path with its CUDA graphs (captured by
    warmup) holding the mesh's collectives: phase 4's tokens, launches
    exact, tok/s beside phase 4's. 13d: ``repro_torch.serve(ServeConfig(
    mesh=(1, 2), mesh_backend="gloo", save=...))`` and ``--load`` of that
    artifact over its recorded mesh: the same tokens, each rank's launches
    exact. Returns {label: (launch counts of rank 0, the run's note)}."""
    import shutil

    import torch.distributed as dist

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_production_mesh

    counted = {}
    # the one device at 13a / 13b's cut depth, fast and stepwise
    cut = {q: {fast: serve_cut(torch, SERVE, TP_LAYERS, q, 8,
                               reference=not fast)[0]
               for fast in (True, False)} for q in ("w8a8", "w8a16")}
    t = time.perf_counter()
    ranks = spawn_ranks(tp_rank, 2, {q: {rid: list(r.tokens) for rid, r in
                                         cut[q][True].results.items()}
                                     for q in ("w8a8", "w8a16")}, 13)
    log(f"  13a/13b: 2 ranks spawned, quantized and served in "
        f"{time.perf_counter() - t:.1f} s")
    for (quantize, shape, fast), r0 in ranks[0].items():
        mesh_s = "x".join(map(str, shape))
        label = (f"serve-{quantize}-kv8-tp {mesh_s} gloo "
                 + ("fast (eager)" if fast else "stepwise")
                 + f" ({TP_LAYERS} layers)")
        ref = cut[quantize][fast]
        tf = r0.get("teacher_forced")
        if tf is not None:
            fails, line = tp_teacher_gate(tf, label)
            log(f"  {label}: teacher-forced logits over the 16 requests' "
                f"prompts and one device's tokens ({r0['tf_seconds']:.1f} s):"
                f" {line}")
            assert not fails, "; ".join(fails)
            if quantize == "w8a8":
                assert all(t["moved"] == 0 and t["bf16"] == 0.0
                           for t in tf), (
                    f"{label}: W8A8 logits not bit-equal to one device")
        if quantize == "w8a16" and shape == (1, 2):
            # float32 partials summed in another order than the
            # single-device GEMM's: a near-tie may move (checked above);
            # the tokens are phase 4's up to each request's first move
            same, first = 0, []
            for rid, rr in ref.results.items():
                toks = r0["tokens"][rid][0]
                assert r0["tokens"][rid][2] == "ok" and len(toks) == 32, (
                    f"{label}: request {rid}")
                if toks == rr.tokens:
                    same += 1
                else:
                    first.append(next(i for i, (a, b) in
                                      enumerate(zip(toks, rr.tokens))
                                      if a != b))
            log(f"  {label}: {same} of 16 requests = one device's tokens; "
                f"the others part at generated token {sorted(first)}")
        else:
            same_tp_tokens(r0["tokens"], ref, label)
        st = r0["stats"]
        assert st["graphs"] == 0 and (not fast or "gloo" in st["graphs_off"]), (
            label, st["graphs_off"])
        want = tp_expected_launches(quantize, shape, st["decode_steps"],
                                    st["prefill_dispatches"], TP_LAYERS)
        for rank, res in ranks.items():
            got = res[quantize, shape, fast]["counts"]
            for name in set(got) | set(want):
                assert got.get(name, 0) == want.get(name, 0), (
                    f"{label} rank {rank}: {name} launched "
                    f"{got.get(name, 0)} times, expected {want.get(name, 0)}")
        gen = st["generated_tokens"]
        moves = quantize == "w8a16" and shape == (1, 2)
        log(f"  {label}: "
            + ("16/16 requests finished" if moves else
               "16/16 requests = one device's tokens and finish ticks")
            + f"; {gen} tokens in {r0['seconds']:.3f} s = "
            f"{gen / r0['seconds']:.1f} tok/s (one device "
            f"{ref.tokens_per_second:.1f}); head-local "
            f"{r0['head_local']}; {st['decode_steps']} decode steps in "
            f"{st['decode_dispatches']} dispatches, "
            f"{st['prefill_dispatches']} prefill dispatches; launches a "
            f"rank {json.dumps(r0['counts'])}, equal on both ranks ({smi})")
        counted[f"13{'a' if shape == (1, 2) else 'b'} {label}"] = r0["counts"]

    log("  13c: a 1x1 NCCL mesh, the fast path under CUDA graphs")
    mesh = make_production_mesh(shape=(1, 1), device="cuda")
    assert dist.get_backend() == "nccl"
    try:
        for quantize in ("w8a8", "w8a16"):
            qm = repro_torch.quantize(
                repro_torch.build_model(repro_torch.get_config(SERVE["arch"])),
                None, init_seed=SERVE["seed"], device="cuda",
                recipe=f"serve-{quantize}-kv8-tp")
            from repro_torch.launch.serve import _requests

            reqs = _requests(repro_torch.ServeConfig(**SERVE),
                             qm.cfg.vocab_size)
            eng = repro_torch.ServingEngine.from_quantized(
                qm, mesh=mesh, num_slots=SERVE["slots"],
                max_len=SERVE["max_len"],
                prefill_chunk=SERVE["prefill_chunk"], device="cuda")
            reset_launch_counts()
            warm = eng.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            label = f"serve-{quantize}-kv8-tp 1x1 nccl fast (CUDA graphs)"
            same_tp_tokens({rid: (list(r.tokens), r.finished_at, r.status)
                            for rid, r in res.items()}, runs[quantize][0],
                           label)
            st = eng.stats
            assert st["graphs"] == 1 and warm["graphs"] > 0, label
            want = tp_expected_launches(
                quantize, (1, 1), st["decode_steps"] + warm["decode_steps"],
                st["prefill_dispatches"] + warm["prefill_dispatches"])
            for name in set(counts) | set(want):
                assert counts.get(name, 0) == want.get(name, 0), (
                    f"{label}: {name} launched {counts.get(name, 0)} times, "
                    f"expected {want.get(name, 0)}")
            gen = st["generated_tokens"]
            log(f"  {label}: 16/16 requests = phase 4's tokens and finish "
                f"ticks; {warm['graphs']} graphs captured in "
                f"{warm['capture_seconds']:.2f} s; {gen} tokens in {dt:.3f} s "
                f"= {gen / dt:.1f} tok/s beside phase 4's "
                f"{runs[quantize][0].tokens_per_second:.1f}; launches "
                f"{json.dumps(counts)} ({smi})")
            counted["13c " + label] = counts
            del eng, qm
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_tp_artifact")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        common = dict(mesh_backend="gloo", quantize="w8a8", kv_bits=8,
                      **TP_ROUND_TRIP)
        first = repro_torch.serve(repro_torch.ServeConfig(
            mesh=(1, 2), save=directory, **common))
        common.pop("quantize")
        common.pop("kv_bits")
        again = repro_torch.serve(repro_torch.ServeConfig(load=directory,
                                                          **common))
        assert first.mesh == again.mesh == (1, 2), (first.mesh, again.mesh)
        assert [r["stage"] for r in first.report][-1] == "shard"
        for rid, r in first.results.items():
            assert r.status == "ok" and again.results[rid].tokens == r.tokens, (
                f"13d: request {rid}: --load tokens differ")
        for label, run in (("serve", first), ("--load", again)):
            st = run.stats
            want = tp_expected_launches("w8a8", (1, 2), st["decode_steps"],
                                        st["prefill_dispatches"])
            for rank, got in enumerate(run.rank_launches):
                for name in set(got) | set(want):
                    assert got.get(name, 0) == want.get(name, 0), (
                        f"13d {label} rank {rank}: {name} launched "
                        f"{got.get(name, 0)}, expected {want.get(name, 0)}")
        log(f"  13d: repro_torch.serve(mesh=(1, 2), save=...) then --load "
            f"over the recorded 1x2 mesh: {len(first.results)} requests, "
            f"the same tokens; launches exact on both ranks of both runs; "
            f"{first.tokens_per_second:.1f} / {again.tokens_per_second:.1f} "
            f"tok/s ({smi})")
        counted["13d serve-w8a8-kv8-tp 1x2 gloo --load"] = \
            again.rank_launches[0]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return counted


# --------------------------------------------------------------- phase 14
# the MoE family over a mesh: mixtral-8x22b at full width on phase 4's
# engine settings, the trace cut to MOE_TP_TRACE requests to keep phase 14
# inside its time (two ranks on the one card over gloo stage every
# collective through host memory)
MOE_TP_TRACE = 8
MOE_TP = dict(MIXTRAL, trace=MOE_TP_TRACE)
# 14a's depth: MOE_TP_LAYERS of mixtral's 56 (phase 9's 3 before), a cut
# for the script's time: quantizing and saving the two artifacts took
# 33.1 s of 14a at 3 layers, 16.1 s at 1, on the H100
MOE_TP_LAYERS = 2
MOE_TP_RECIPES = (("w8a8", "serve-w8a8-kv8-tp", 8),
                  ("w8a16", "serve-w8a16-tp", 16))
# 14c: llama4-scout at smoke size (its shared expert's route), 1x2 W8A8
LLAMA4_SMOKE = dict(arch="llama4-scout-17b-a16e-smoke", slots=3, max_len=32,
                    prefill_chunk=4, trace=6, prompt_len=10, gen_len=6)
# 14d: the async front-end over a 1x2 mesh, qwen2-0.5b serve-w8a8-kv8-tp
# at phase 13's TP_LAYERS of its 24 layers (at 24, 14d took 71.5 s on the
# H100 at 700 W); phase 10a's and 10b's traces cut in length (gen 16) and
# count
ASYNC_TP = dict(SERVE, gen_min=16, gen_len=16, serve_async=True)
ASYNC_TP_TRACES = {"underload": dict(trace=4, qps=0.25),
                   "overload": dict(trace=12, qps=2.0, max_queue=4,
                                    timeout=48.0, shed_pressure=0.5,
                                    page_size=32)}


#: 14a's MoE-block gate: a sharded block's output from one device's on the
#: same activations, as a share of one device's max |y|, where routing
#: cannot amplify it (the router is whole, so every choice is one
#: device's). W8A16 differs by float32 partials summed in another order
#: (one bf16 rounding of y, 2^-8 of it) and by one-ulp flips of the cut
#: gate/up's bf16 outputs, which the down projection averages: the gate is
#: four of bf16's roundoffs. A rank's partial dropped moves y by about half
#: its size (tests/test_torch_serving_sharded_moe.py plants it).
MOE_BLOCK_TOL = 2.0 ** -6


def moe_block_gap(torch, cfg, whole, local, x, shard):
    """Layer 0's MoE block on activations ``x`` [B, T, D]: one device on
    every row (``whole``: the one device's params tree) and the shard on
    its rows (``local``: the rank's cut tree, each cast to the compute
    dtype as the forward casts it), gathered over "data" where the slots
    shard. Returns (router logits bit-equal, the drops of every row equal,
    max |sharded - one device| / max |one device|). Every rank runs it
    (its collectives) and gets the same answer."""
    from repro_torch.models import layers
    from repro_torch.models.lm import _layer, cast_for_compute
    from repro_torch.sharding.tp import tp_scope

    def mlp(params):
        return cast_for_compute(_layer(params["blocks"], 0)["mlp"],
                                cfg.compute_dtype)

    with torch.no_grad():
        one, cut = mlp(whole), mlp(local)
        drops = []
        y1, _ = layers.moe_block(one, x, cfg, drops=drops)
        want = {"y": y1, "logits": layers.router_logits(one, x),
                "drops": drops[0]}
        rows = x[shard.slot_lo:shard.slot_hi] if shard.slots_sharded else x
        drops = []
        with tp_scope(shard):
            y2, _ = layers.moe_block(cut, rows, cfg, drops=drops)
            got = {"y": y2, "logits": layers.router_logits(cut, rows),
                   "drops": drops[0]}
        if shard.slots_sharded:
            got = {k: shard.gather_slots(v.contiguous())
                   for k, v in got.items()}
    y1 = want["y"].float()
    gap = float((got["y"].float() - y1).abs().max() / y1.abs().max())
    return (bool(torch.equal(got["logits"], want["logits"])),
            bool(torch.equal(got["drops"], want["drops"])), gap)


@contextlib.contextmanager
def one_call_prefill_attention():
    """For a timing only: the prefill attention over the int8 cache as ONE
    call over every head, as before it ran a KV head's group a call
    (``layers._cached_attention``; the fp cache and the decode step as
    they are)."""
    from repro_torch.models import layers

    real = layers._cached_attention

    def one_call(q, k, v, dims, cache, slots, chunk_kv, dtype, want_q8):
        if "k_scale" not in cache or q.shape[1] == 1 or "v_err" in cache:
            return real(q, k, v, dims, cache, slots, chunk_kv, dtype,
                        want_q8)
        B, T, nq, hd = q.shape
        group = nq // k.shape[2]
        ck, ks, cv, vs = layers.append_quantize(
            cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], k, v,
            slots.idx)[:4]
        kd = ck.to(dtype) * ks.to(dtype)[..., None]
        vd = cv.to(dtype) * vs.to(dtype)[..., None]
        attn = layers.attention_scores_softmax(
            q, layers._repeat_kv(kd, group), layers._repeat_kv(vd, group),
            slots.mask, chunk_kv=chunk_kv,
            causal_segments=dims.causal_segments)
        return attn.reshape(B, T, nq * hd), None

    layers._cached_attention = one_call
    try:
        yield
    finally:
        layers._cached_attention = real


def prefill_rows_check(torch, qm, settings, label, smi):
    """One prefill chunk at ``settings``' shape (its slots x prefill_chunk
    tokens into a cache of max_len positions, int8 KV) through
    ``model.prefill``: every position's logits over all the slots bit-equal
    to those of the two halves run alone (a data axis of 2 prefills half
    the slots a rank: the batched attention GEMMs see another batch).
    Then the cost of running the prefill attention a KV head's group a
    call, against ONE call over every head
    (``one_call_prefill_attention``), back to back (``call_ms``: eager,
    the host's time and syncs included — both hold a host sync, so
    ``device_ms`` cannot run ahead of them): the chunk, and the attention
    alone at the chunk's shape (a layer); and ``settings``' trace served
    on the fast path (CUDA graphs, captured by warmup under the same
    attention: ``one_device_run``) both ways, in the order split, one
    call, one call, split. Returns {name: ms or tok/s}."""
    from repro_torch.models import layers

    cfg = qm.cfg
    B, T, S = settings["slots"], settings["prefill_chunk"], settings["max_len"]
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen).cuda()
    model = qm.model

    def prefill(rows):
        cache = model.init_cache(rows.shape[0], S, device="cuda",
                                 per_slot=True, kv_bits=8)
        return model.prefill(qm.params, rows, cache, logits_at="all")[0]

    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dims = layers.AttnDims(n_q=Hq, n_kv=Hkv, head_dim=hd)
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn((B, T, h, hd), generator=g, device="cuda").to(bf)
               for h in (Hq, Hkv, Hkv))
    slots = layers.slot_write(
        torch.full((B, S), -1, dtype=torch.int64, device="cuda"),
        torch.arange(T, device="cuda")[None].expand(B, T))
    kv = {"k": torch.zeros((B, S, Hkv, hd), dtype=torch.int8, device="cuda"),
          "v": torch.zeros((B, S, Hkv, hd), dtype=torch.int8, device="cuda"),
          "k_scale": torch.zeros((B, S, Hkv), device="cuda"),
          "v_scale": torch.zeros((B, S, Hkv), device="cuda")}
    with torch.no_grad():
        whole = prefill(toks)
        h = B // 2
        halves = torch.cat([prefill(toks[:h]), prefill(toks[h:])])
        assert torch.equal(whole, halves), (
            f"{label}: prefill logits of {B} slots differ from their halves' "
            f"(max |diff| {float((whole.float() - halves.float()).abs().max())})")
        cache = model.init_cache(B, S, device="cuda", per_slot=True,
                                 kv_bits=8)
        chunk = lambda: model.prefill(qm.params, toks, cache)
        attend = lambda: layers._cached_attention(q, k, v, dims, kv, slots,
                                                  None, bf, False)
        ms = {"chunk": call_ms(chunk, 5), "attention": call_ms(attend, 20)}
        with one_call_prefill_attention():
            ms["chunk_one_call"] = call_ms(chunk, 5)
            ms["attention_one_call"] = call_ms(attend, 20)
    del cache, kv
    fast, served = {"split": [], "one_call": []}, []
    for way in ("split", "one_call", "one_call", "split"):
        with (one_call_prefill_attention() if way == "one_call"
              else contextlib.nullcontext()):
            got, tps, _ = one_device_run(
                torch, qm, settings, True, f"{label} ({way})", cfg=cfg,
                kv_bits=8, quantize="w8a8")
        fast[way].append(tps)
        served.append(got)
    same = all(got == served[0] for got in served)
    ms.update({f"fast_{k}": v for k, v in fast.items()})
    log(f"  {label}: a prefill chunk ({B} slots x {T} tokens, {S} "
        f"positions, {cfg.n_layers} layers): every position's logits = its "
        f"two halves' run alone, bit for bit; a KV head's group a call "
        f"against one call over every head: the chunk back to back "
        f"{ms['chunk']:.3f} / {ms['chunk_one_call']:.3f} ms "
        f"({(ms['chunk'] / ms['chunk_one_call'] - 1) * 100:+.1f} %), the "
        f"attention alone a layer {ms['attention']:.3f} / "
        f"{ms['attention_one_call']:.3f} ms; the trace on the fast path "
        f"(graphs) {' / '.join(f'{t:.1f}' for t in fast['split'])} against "
        f"{' / '.join(f'{t:.1f}' for t in fast['one_call'])} tok/s, tokens "
        f"and ticks {'the same' if same else 'not all the same'} ({smi})")
    return ms


def moe_tp_expected_launches(quantize, cfg, shape, flags, steps, chunks, *,
                             slots, chunk, kv_bits):
    """{kernel: launches} of one rank of an MoE engine over ``shape``
    (data, model) per decode step and prefill dispatch, from the rank's
    shard ``flags`` (``col`` / ``row`` / ``head_local`` /
    ``slots_sharded``) as the layers launch them. W8A16: one qmatmul_w8a16
    a projection (q, k, v, o, the router, the experts' gate, up and down).
    W8A8 at each input: q / k / v at this rank's columns, the router whole,
    the experts' gate / up at this rank's F columns (E rows of the capacity
    C a row each) — the quantize-in fold where gemm_plan folds for all, else
    quantize_act and an int8 GEMM each; o row-parallel: quantize_act of the
    gathered row (none at a decode step that takes the fused kernel's
    quantize-out: a model axis of 1) and one qmatmul_w8a8_i32, else
    whole; the experts' down row-parallel: quantize_act of the gathered
    rows and one qmatmul_w8a8_i32_experts. The fused decode once a layer a
    decode step over the int8 cache. llama4's shared expert is float: no
    kernel."""
    from repro_torch.kernels import gemm_plan

    data, m = shape
    col, row = flags["col"], flags["row"]
    local = slots // data if flags["slots_sharded"] else slots
    L, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    A, KV = cfg.attn_dim, cfg.kv_dim
    want = {}
    if kv_bits == 8:
        want["fused_decode"] = L * steps
    if quantize == "w8a16":
        want["qmatmul_w8a16"] = 8 * L * (steps + chunks)
        return want
    want.update(quantize_act=0, qmatmul_w8a8=0, qmatmul_w8a8_qin=0,
                qmatmul_w8a8_i32=0, qmatmul_w8a8_i32_experts=0)

    def cut(name, n):
        return n // m if col[name] else n

    def add(M, K, Ns, e, n):
        if all(gemm_plan.plan(M, N, K, experts=e).fold for N in Ns):
            want["qmatmul_w8a8_qin"] += L * n
            want["qmatmul_w8a8"] += (len(Ns) - 1) * L * n
        else:
            want["quantize_act"] += L * n
            want["qmatmul_w8a8"] += len(Ns) * L * n

    for T, n, decode in ((1, steps, True), (chunk, chunks, False)):
        M = local * T
        BC = local * max(1, int(T * cfg.top_k / E * cfg.capacity_factor))
        add(M, D, (cut("wq", A), cut("wk", KV), cut("wv", KV)), 1, n)
        q8 = decode and kv_bits == 8 and not flags["head_local"]
        if row["wo"]:
            want["qmatmul_w8a8_i32"] += L * n
            want["quantize_act"] += 0 if q8 else L * n
        elif q8:
            want["qmatmul_w8a8"] += L * n
        else:
            add(M, A, (D,), 1, n)
        add(M, D, (E,), 1, n)
        add(BC, D, (cut("experts/wg", F), cut("experts/wu", F)), E, n)
        if row["experts/wd"]:
            want["quantize_act"] += L * n
            want["qmatmul_w8a8_i32_experts"] += L * n
        else:
            add(BC, F, (D,), E, n)
    return want


def moe_tp_rank(rank, world, store, out, job):
    """A rank of 14a / 14c: join the gloo group; for each of ``job``'s
    mixtral artifacts load it (``QuantizedModel.load``, as ``--load``) and
    serve ``MOE_TP``'s trace over 1x2 and 2x1, fast and stepwise, each
    run's launches, peak memory and drops (this rank's rows) counted from
    its start; after each fast run, ``moe_block_gap`` on layer 0; after
    W8A16's fast 1x2 run, and any other 1x2 run whose tokens are not the
    one device's (``job["ref"]``), ``tp_teacher_forced`` over its requests
    and the one device's tokens; then the llama4 smoke artifact over 1x2, fast. Writes its results (or
    its traceback) to ``out.<rank>``."""
    import dataclasses
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    result = None
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        import repro_torch
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.serve import _requests
        from repro_torch.sharding import collectives as coll

        meshes = {s: make_production_mesh(shape=s, device="cuda",
                                          backend="gloo") for s in TP_MESHES}
        result = {}
        runs = [(q, job["dirs"][q], MOE_TP, shape, fast)
                for q, _, _ in MOE_TP_RECIPES for shape in TP_MESHES
                for fast in (True, False)]
        runs.append(("llama4", job["dirs"]["llama4"], LLAMA4_SMOKE, (1, 2),
                     True))
        qm = loaded = None
        for key, directory, sv, shape, fast in runs:
            t0 = time.perf_counter()
            if loaded != directory:
                qm = None
                torch.cuda.empty_cache()
                qm = repro_torch.QuantizedModel.load(directory, device="cuda")
                loaded = directory
            load_s = time.perf_counter() - t0
            reqs = _requests(repro_torch.ServeConfig(**{
                k: v for k, v in sv.items() if k != "arch"}),
                qm.cfg.vocab_size)
            eng = repro_torch.ServingEngine.from_quantized(
                qm, mesh=meshes[shape], num_slots=sv["slots"],
                max_len=sv["max_len"], prefill_chunk=sv["prefill_chunk"],
                fast=fast, device="cuda")
            qm.model.drop_log = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = eng.run([dataclasses.replace(r) for r in reqs])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            drops = torch.zeros((), dtype=torch.int64, device="cuda")
            for d in qm.model.drop_log:
                drops += d.sum()
            qm.model.drop_log = None
            sh = eng.shard
            if sh.slots_sharded:
                coll.all_reduce_sum(drops, sh.dp_group)
            tokens = {rid: (list(r.tokens), r.admitted_at, r.finished_at,
                            r.status) for rid, r in res.items()}
            entry = {
                "tokens": tokens, "seconds": dt, "load_seconds": load_s,
                "stats": dict(eng.stats), "counts": counts,
                "peak": torch.cuda.max_memory_allocated(),
                "resident": torch.cuda.memory_allocated(),
                "drops": int(drops),
                "flags": {"col": dict(sh.col), "row": dict(sh.row),
                          "head_local": sh.head_local,
                          "slots_sharded": sh.slots_sharded}}
            if fast and key != "llama4":
                # layer 0's MoE block on seeded activations (8 slots x a
                # prefill chunk), sharded against one device: the gate
                # where routing cannot amplify a difference
                x = torch.randn((sv["slots"], sv["prefill_chunk"],
                                 qm.cfg.d_model),
                                generator=torch.Generator().manual_seed(13))
                entry["block"] = moe_block_gap(
                    torch, qm.cfg, qm.params, eng.params,
                    x.to("cuda", qm.cfg.compute_dtype), sh)
            ref = job["ref"].get(key, {}).get(fast)
            if (shape == (1, 2) and ref is not None
                    and ((fast and key == "w8a16")
                         or any(tokens[rid][0] != ref[rid] for rid in ref))):
                t0 = time.perf_counter()
                entry["teacher_forced"] = tp_teacher_forced(
                    torch, qm.model, qm.params, eng,
                    [list(r.prompt) + ref[r.rid] for r in reqs],
                    kv_bits=qm.cfg.kv_cache_bits)
                entry["tf_seconds"] = time.perf_counter() - t0
            result[key, shape, fast] = entry
            del eng
        dist.destroy_process_group()
    except BaseException:
        result = traceback.format_exc()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a params tree (a QTensor's payload and
    scale)."""
    from repro_torch.quantized.qtensor import QTensor

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return tree_bytes(tree.q) + tree_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def one_device_run(torch, qm, sv, fast, label, *, cfg, kv_bits, quantize):
    """The one-device engine over ``qm`` on ``sv``'s trace, fast (graphs
    captured by warmup) or stepwise; launches held to
    ``expected_launches``. Returns (tokens {rid: (tokens, admitted,
    finished, status)}, tok/s, counts)."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import _requests

    reqs = _requests(repro_torch.ServeConfig(**{
        k: v for k, v in sv.items() if k != "arch"}), qm.cfg.vocab_size)
    eng = repro_torch.ServingEngine.from_quantized(
        qm, num_slots=sv["slots"], max_len=sv["max_len"],
        prefill_chunk=sv["prefill_chunk"], fast=fast, device="cuda")
    reset_launch_counts()
    warm = eng.warmup() if fast else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run([dataclasses.replace(r) for r in reqs])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_launches(
        quantize, True, eng.stats["decode_steps"] + warm.get("decode_steps", 0),
        eng.stats["prefill_dispatches"] + warm.get("prefill_dispatches", 0),
        cfg=cfg, kv_bits=kv_bits, slots=sv["slots"], chunk=sv["prefill_chunk"])
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")
    for r in res.values():
        assert r.status == "ok", f"{label}: request {r.rid}: {r.status}"
    tokens = {rid: (list(r.tokens), r.admitted_at, r.finished_at, r.status)
              for rid, r in res.items()}
    return tokens, eng.stats["generated_tokens"] / dt, counts


def check_moe_tensor_parallel(torch, dev, depth, smi):
    """Phase 14: the MoE family served tensor-parallel on the card.

    14a: mixtral-8x22b at full width and ``depth`` layers (``MOE_TP_LAYERS``,
    within phase 9's cut; checked against what two ranks on the card
    hold), quantized ONCE here under serve-w8a8-kv8-tp
    and serve-w8a16-tp and saved; a one-device run of each (fast under
    graphs, stepwise); two ranks spawned on the one card (gloo) load each
    artifact and serve ``MOE_TP``'s trace over 1x2 and 2x1, fast (eager)
    and stepwise: W8A8 every request's tokens, admission and finish ticks
    the one device's; W8A16 the same at 2x1, and at 1x2 the same or a
    move the teacher-forced gate shows is rounding (``tp_teacher_gate``:
    float32 logits within ``TP_F32_TOL`` of one device where the MoE
    choices are one device's, a planted dropped partial past it; bf16
    within twice the bf16 forward's own distance where no choice moved);
    after each fast run, layer 0's MoE block on the
    same activations (``moe_block_gap``): router logits bit-equal, drops
    equal, W8A8 bit-equal, W8A16 within ``MOE_BLOCK_TOL``; the W8A8
    artifact's prefill chunk against its two halves, timed both ways
    (``prefill_rows_check``); each rank's launches exact
    (``moe_tp_expected_launches``). 14b: the W8A8 artifact over a 1x1 NCCL
    mesh in this process, the fast path under CUDA graphs (warmup): the
    one device's tokens and ticks, launches exact. 14c: llama4-scout at
    smoke size, W8A8, over 1x2 in the same ranks (its shared expert a
    float MLP cut over "model"): the one device's tokens, launches exact.
    14d: ``repro_torch.serve(ServeConfig(serve_async=True, mesh=(1, 2)))``
    of qwen2-0.5b's serve-w8a8-kv8-tp artifact at ``TP_LAYERS`` layers on
    ``ASYNC_TP_TRACES`` (phase 10a's and 10b's traces, cut) against the
    same served on one device: every outcome, the server's counters and the SLO summary
    equal; each rank's launches exact. Returns {label: counts} of the
    fast runs of rank 0."""
    import dataclasses
    import gc
    import shutil

    import torch.distributed as dist

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_production_mesh

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_moe_tp")
    shutil.rmtree(root, ignore_errors=True)
    counted = {}
    t14 = time.perf_counter()
    try:
        cfg = dataclasses.replace(repro_torch.get_config(MOE_TP["arch"]),
                                  n_layers=depth)
        dirs, ref, single, sizes = {}, {}, {}, {}
        for quantize, recipe, kv_bits in MOE_TP_RECIPES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            qm = repro_torch.quantize(repro_torch.build_model(cfg), None,
                                      init_seed=MOE_TP["seed"], device="cuda",
                                      recipe=recipe)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            dirs[quantize] = os.path.join(root, recipe)
            qm.save(dirs[quantize])
            save_s = time.perf_counter() - t0
            sizes[quantize] = tree_bytes(qm.params)
            ref[quantize], single[quantize] = {}, {}
            for fast in (True, False):
                label = (f"14a mixtral-8x22b ({depth} layers) {recipe} one "
                         f"device {'fast' if fast else 'stepwise'}")
                toks, tps, counts = one_device_run(
                    torch, qm, MOE_TP, fast, label, cfg=qm.cfg,
                    kv_bits=kv_bits, quantize=quantize)
                single[quantize][fast] = toks, tps
                ref[quantize][fast] = {rid: t[0] for rid, t in toks.items()}
                if fast:
                    counted[label] = counts
            if kv_bits == 8:
                prefill_rows_check(torch, qm, MOE_TP,
                                   f"14a mixtral-8x22b ({depth} layers) "
                                   f"{recipe}", smi)
            log(f"  14a {recipe}: quantized once and saved in {save_s:.1f} s "
                f"(peak {peak / 2**30:.2f} GiB, {sizes[quantize] / 2**30:.2f} "
                f"GiB of weights); one device {single[quantize][True][1]:.1f} "
                f"/ {single[quantize][False][1]:.1f} tok/s fast / stepwise "
                f"({smi})")
            del qm
        # what two ranks on the one card hold: each loads the whole artifact
        # (a column cut is a view of it) and keeps a copy of its K rows of
        # the row-parallel weights
        total = torch.cuda.get_device_properties(dev).total_memory
        per_layer = max(sizes.values()) / depth
        hold = int((total - FREE_BYTES) // (2 * 1.5 * per_layer))
        whole = repro_torch.get_config(MOE_TP["arch"]).n_layers
        log(f"  14a depth: {depth} of {whole} layers (MOE_TP_LAYERS, within "
            f"phase 9's cut); two ranks holding up to 1.5x the artifact's"
            f" {per_layer / 2**30:.2f} GiB a layer each could "
            f"hold {hold}")
        assert hold >= depth, f"two ranks cannot hold {depth} layers"
        l4 = repro_torch.quantize(LLAMA4_SMOKE["arch"],
                                  recipe="serve-w8a8-kv8-tp", device="cuda")
        dirs["llama4"] = os.path.join(root, "llama4")
        l4.save(dirs["llama4"])
        l4_tokens, _, _ = one_device_run(
            torch, l4, LLAMA4_SMOKE, True, "14c llama4-scout smoke one device",
            cfg=l4.cfg, kv_bits=8, quantize="w8a8")
        ref["llama4"] = {True: {rid: t[0] for rid, t in l4_tokens.items()}}
        l4_cfg = l4.cfg
        del l4
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = spawn_ranks(moe_tp_rank, 2, {"dirs": dirs, "ref": ref}, 14,
                            timeout=600)
        log(f"  14a/14c: 2 ranks spawned, loaded and served in "
            f"{time.perf_counter() - t0:.1f} s")
        for (key, shape, fast), r0 in ranks[0].items():
            mesh_s = "x".join(map(str, shape))
            if key == "llama4":
                label = f"14c llama4-scout smoke serve-w8a8-kv8-tp {mesh_s} gloo"
                want_toks, q, kv, c, sv = (l4_tokens, "w8a8", 8, l4_cfg,
                                           LLAMA4_SMOKE)
            else:
                recipe, kv = next((r, k) for q_, r, k in MOE_TP_RECIPES
                                  if q_ == key)
                label = (f"14a mixtral-8x22b {recipe} {mesh_s} gloo "
                         + ("fast (eager)" if fast else "stepwise"))
                want_toks, q, c, sv = single[key][fast][0], key, cfg, MOE_TP
            block = r0.get("block")
            if block is not None:
                same_logits, same_drops, gap = block
                limit = 0.0 if q == "w8a8" else MOE_BLOCK_TOL
                log(f"  {label}: layer 0's MoE block on the same activations: "
                    f"router logits bit-equal {same_logits}, drops equal "
                    f"{same_drops}, max |sharded - one device| {gap:.4g} of "
                    f"max |y| (the gate {limit:.4g})")
                assert same_logits and same_drops and gap <= limit, (
                    f"{label}: the MoE block off one device's: {block}")
            tf = r0.get("teacher_forced")
            if tf is not None:
                fails, line = tp_teacher_gate(tf, label)
                log(f"  {label}: teacher-forced logits "
                    f"({r0['tf_seconds']:.1f} s): {line}")
                assert not fails, "; ".join(fails)
            same_toks = r0["tokens"] == want_toks
            # W8A16 at 1x2 sums the expert down's float32 partials in another
            # order than one device: a moved expert choice may move a token,
            # and the teacher-forced gate above holds the forward instead
            assert same_toks or (tf is not None and q == "w8a16"
                                 and shape == (1, 2)), (
                f"{label}: tokens, admission or finish ticks differ from "
                f"one device's")
            st = r0["stats"]
            assert st["graphs"] == 0, label
            want = moe_tp_expected_launches(
                q, c, shape, r0["flags"], st["decode_steps"],
                st["prefill_dispatches"], slots=sv["slots"],
                chunk=sv["prefill_chunk"], kv_bits=kv)
            for rank, res in ranks.items():
                got = res[key, shape, fast]["counts"]
                for name in set(got) | set(want):
                    assert got.get(name, 0) == want.get(name, 0), (
                        f"{label} rank {rank}: {name} launched "
                        f"{got.get(name, 0)} times, expected "
                        f"{want.get(name, 0)}")
            gen = st["generated_tokens"]
            peaks = ", ".join(
                f"rank {rank} {res[key, shape, fast]['peak'] / 2**30:.2f}"
                for rank, res in sorted(ranks.items()))
            log(f"  {label}: {len(r0['tokens'])} requests"
                + (" = one device's tokens, admission and finish ticks"
                   if same_toks else ", other tokens than one device's")
                + f"; {gen} tokens in {r0['seconds']:.3f} s = "
                f"{gen / r0['seconds']:.1f} tok/s; peak memory GiB {peaks}; "
                f"head-local {r0['flags']['head_local']}; prefill and decode "
                f"drops (this rank's rows, summed over data) {r0['drops']}; "
                f"{st['decode_steps']} decode steps in "
                f"{st['decode_dispatches']} dispatches, "
                f"{st['prefill_dispatches']} prefill dispatches; launches a "
                f"rank {json.dumps(r0['counts'])}, equal on both ranks "
                f"({smi})")
            if fast:
                counted[label] = r0["counts"]

        log("  14b: the W8A8 artifact over a 1x1 NCCL mesh, the fast path "
            "under CUDA graphs")
        mesh = make_production_mesh(shape=(1, 1), device="cuda")
        assert dist.get_backend() == "nccl"
        try:
            qm = repro_torch.QuantizedModel.load(dirs["w8a8"], device="cuda")
            from repro_torch.launch.serve import _requests

            reqs = _requests(repro_torch.ServeConfig(**{
                k: v for k, v in MOE_TP.items() if k != "arch"}),
                qm.cfg.vocab_size)
            eng = repro_torch.ServingEngine.from_quantized(
                qm, mesh=mesh, num_slots=MOE_TP["slots"],
                max_len=MOE_TP["max_len"],
                prefill_chunk=MOE_TP["prefill_chunk"], device="cuda")
            reset_launch_counts()
            warm = eng.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            label = "14b mixtral-8x22b serve-w8a8-kv8-tp 1x1 nccl fast (CUDA graphs)"
            got = {rid: (list(r.tokens), r.admitted_at, r.finished_at,
                         r.status) for rid, r in res.items()}
            assert got == single["w8a8"][True][0], (
                f"{label}: tokens or ticks differ from one device's")
            st = eng.stats
            assert st["graphs"] == 1 and warm["graphs"] > 0, label
            sh = eng.shard
            want = moe_tp_expected_launches(
                "w8a8", cfg, (1, 1), {"col": sh.col, "row": sh.row,
                                      "head_local": sh.head_local,
                                      "slots_sharded": sh.slots_sharded},
                st["decode_steps"] + warm["decode_steps"],
                st["prefill_dispatches"] + warm["prefill_dispatches"],
                slots=MOE_TP["slots"], chunk=MOE_TP["prefill_chunk"],
                kv_bits=8)
            for name in set(counts) | set(want):
                assert counts.get(name, 0) == want.get(name, 0), (
                    f"{label}: {name} launched {counts.get(name, 0)} times, "
                    f"expected {want.get(name, 0)}")
            gen = st["generated_tokens"]
            log(f"  {label}: {len(got)} requests = one device's tokens and "
                f"ticks; {warm['graphs']} graphs captured in "
                f"{warm['capture_seconds']:.2f} s; {gen} tokens in {dt:.3f} s "
                f"= {gen / dt:.1f} tok/s beside one device's "
                f"{single['w8a8'][True][1]:.1f}; launches {json.dumps(counts)}"
                f" ({smi})")
            counted[label] = counts
            del eng, qm
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  14a-14c took {time.perf_counter() - t14:.1f} s")

    t0 = time.perf_counter()
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_async_tp")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        cut = dataclasses.replace(repro_torch.get_config(SERVE["arch"]),
                                  n_layers=TP_LAYERS)
        qm = repro_torch.quantize(
            repro_torch.build_model(cut), None, init_seed=SERVE["seed"],
            device="cuda", recipe="serve-w8a8-kv8-tp")
        qm.save(directory)
        prefill_rows_check(torch, qm, SERVE,
                           "14d qwen2-0.5b serve-w8a8-kv8-tp", smi)
        del qm
        base = {k: v for k, v in ASYNC_TP.items() if k != "arch"}
        for scenario, over in ASYNC_TP_TRACES.items():
            kw = dict(base, load=directory, **over)
            one, one_counts = counted_serve(repro_torch.ServeConfig(
                warmup=True, **kw))
            want = expected_launches("w8a8", True, *forwards(one), cfg=cut)
            for name, n in one_counts.items():
                assert n == want.get(name, 0), (
                    f"14d {scenario} one device: {name} launched {n} times, "
                    f"expected {want.get(name, 0)}")
            tp = repro_torch.serve(repro_torch.ServeConfig(
                mesh=(1, 2), mesh_backend="gloo", **kw))
            label = f"14d {scenario} --serve-async 1x2 gloo"
            assert tp.mesh == (1, 2), label

            def key(run):
                return ([(o.rid, o.status, o.attempts, o.tokens,
                          o.token_ticks, o.first_token_tick, o.finished_tick)
                         for o in run.outcomes], run.server_stats,
                        run.async_summary)

            assert key(tp) == key(one), (
                f"{label}: outcomes or counters differ from one device's")
            st = tp.stats
            want = tp_expected_launches("w8a8", (1, 2), st["decode_steps"],
                                        st["prefill_dispatches"],
                                        layers=TP_LAYERS)
            for rank, got in enumerate(tp.rank_launches):
                for name in set(got) | set(want):
                    assert got.get(name, 0) == want.get(name, 0), (
                        f"{label} rank {rank}: {name} launched "
                        f"{got.get(name, 0)}, expected {want.get(name, 0)}")
            s, sv = tp.async_summary, tp.server_stats
            log(f"  {label} ({over['trace']} requests at {over['qps']} a "
                f"tick, gen {ASYNC_TP['gen_len']}"
                + (f", max_queue {over['max_queue']}, paged"
                   if "max_queue" in over else "")
                + f"): every outcome, the server's counters and the SLO "
                f"summary = one device's; statuses {s['statuses']}, "
                f"admission " + ", ".join(f"{k}={sv[k]}" for k in (
                    "submitted", "accepted", "shed_breaker", "shed_priority",
                    "shed_queue", "breaker_opens"))
                + f"; {tp.tokens_per_second:.1f} tok/s against one device's "
                f"{one.tokens_per_second:.1f}; launches exact on both ranks "
                f"({smi})")
            counted[label] = tp.rank_launches[0]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log(f"  14d took {time.perf_counter() - t0:.1f} s")
    return counted


# --------------------------------------------------------------- phase 15
# the train step over a mesh (launch.steps under configure_sharding_hints,
# sharding.train). 15a: qwen2-0.5b at full width cut to TRAIN_MESH_LAYERS
# of its 24 layers (two gloo ranks on the one card stage every FSDP gather
# and gradient sum through host memory), over 2x1 (FSDP) and 1x2 (TP),
# beside one device at that depth; 15b: a 1x1 NCCL mesh at all 24 layers,
# bit-equal to one device (deterministic algorithms); three steps of
# phase 12's TokenStream batches from one init (seed 0, whole on every
# rank, then cut)
TRAIN_MESH = dict(steps=3, batch=8, seq=256, seed=0)
TRAIN_MESH_LR = {"peak_lr": 1e-3, "warmup": 2, "total": 10}
TRAIN_MESH_LAYERS = 2
TRAIN_MESHES = ((2, 1), (1, 2))
# a mesh's step against one device's on the card, each loss and grad norm
# relative. In float32 compute (the config's widths and params, its
# activations float32) the two sum in other orders: 1e-5 and 1e-4 (the
# CPU tests hold the same step within 1e-5 of JAX's). In the config's
# bfloat16 compute the embedding's gradient accumulates the rows of
# repeated tokens in bf16, and the batch a rank holds changes that
# rounding (a 1.8 % grad norm gap at 2x1 on the H100): 5e-3 and
# 5e-2, a fault that drops a data shard's gradient or counts a replicated
# leaf twice moves the norm by tens of percent
TRAIN_MESH_TOL = {"float32": {"loss": 1e-5, "grad_norm": 1e-4},
                  "bfloat16": {"loss": 5e-3, "grad_norm": 5e-2}}
# 15c: the launcher (repro_torch.launch.train.main) in the two gloo ranks'
# group, qwen2-0.5b at ``layers``: an uninterrupted 2x1 run, and a failure
# injected on every rank and replayed; then the uninterrupted run's
# checkpoint of step ``resume_at`` resumed onto 1x2 and onto one device
# (elastic_restore), each to the end
TRAIN_ELASTIC = dict(layers=2, steps=4, ckpt_every=2, fail_at=3,
                     resume_at=2)
# across meshes (bf16 compute): a resumed run's final params against the
# uninterrupted run's, as a share of what the uninterrupted run itself
# moved them after the checkpoint, ||resumed - run|| / ||run - checkpoint||
# over every param leaf at once but the key bias, at most 5e-2. A sound
# resume differs by the meshes' roundings alone; one that drops the AdamW
# moments moves a third or more of the update (the phase plants it and
# requires the gate to see it). The key bias's gradient is rounding noise
# (zero in exact arithmetic), so it takes lr-sized steps in any direction:
# each element within 2 x the resumed steps' summed lr, as the CPU test
# holds it. The resumed losses within TRAIN_MESH_TOL's bf16 gate
ELASTIC_TOL = 5e-2
# 15d: mixtral-8x22b at full width, 1 of its 56 layers, over 1x2 (gloo):
# each rank holds its F half of the experts (1.2 G float32 parameters) with
# their gradients and moments; the steps donate the state (AdamW in place:
# no second copy); the one-device oracle runs after the ranks end
MOE_TRAIN = dict(layers=1, steps=2)


def _param_paths(tree, path=()):
    """[(path, leaf)] of a tree, dict keys sorted (``jax.tree.leaves``'
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _param_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _param_paths(t, path + (i,))]
    return [(path, tree)]


def _train_leaves(tree):
    return [x for _, x in _param_paths(tree)]


def train_zeros(torch, tree):
    """Zeros in the shape of every leaf of ``tree`` (dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: train_zeros(torch, v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _train_leaves(tree))


def mesh_train(torch, cfg, mesh, *, steps, lr=TRAIN_MESH_LR, donate=False,
               keep=False):
    """``steps`` train steps of ``cfg`` on the card from ``init(seed)``
    (whole, then cut where ``mesh``: this rank's blocks) over phase 12's
    TokenStream batches. Returns ({"losses", "grad_norms", "ms", "peak" —
    bytes above what was allocated before —, and over a mesh "resident",
    "planned", "whole": this rank's params and moments, the planner's
    block bytes of the same, the whole state's}, the final state where
    ``keep``)."""
    import torch.distributed as dist

    from repro_torch.data import TokenStream
    from repro_torch.launch import steps as st
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.partition import (
        block_bytes,
        opt_spec_tree,
        shard_tree,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    if mesh is not None:
        st.configure_sharding_hints(cfg, mesh)
    try:
        model, step = st.make_train_step(cfg, lr_cfg=lr, donate=donate)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        params = model.init(TRAIN_MESH["seed"], device=dev)
        out = {}
        if mesh is not None:
            shapes, (p_spec, _) = st.state_specs(model, mesh)
            specs = (p_spec, opt_spec_tree(p_spec))
            params = shard_tree(params, p_spec, mesh)
        opt = adamw_init(params)
        if mesh is not None:
            out.update(resident=_tree_bytes((params, opt)),
                       planned=block_bytes(shapes, specs, mesh),
                       whole=_tree_bytes(shapes))
        stream = TokenStream(seed=0, shard=0, n_shards=1,
                             batch_per_shard=TRAIN_MESH["batch"],
                             seq=TRAIN_MESH["seq"], vocab=cfg.vocab_size,
                             device=dev)
        losses, norms, ms = [], [], []
        for s in range(steps):
            batch = stream.batch(s)
            torch.cuda.synchronize(dev)
            if mesh is not None:
                dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out.update(losses=losses, grad_norms=norms, ms=ms,
                   peak=torch.cuda.max_memory_allocated(dev) - base)
        return out, ((params, opt) if keep else None)
    finally:
        if mesh is not None:
            st.clear_sharding_hints()


def elastic_argv(directory, *extra):
    e = TRAIN_ELASTIC
    return ["--arch", "qwen2-0.5b", "--layers", str(e["layers"]), "--steps",
            str(e["steps"]), "--batch", str(TRAIN_MESH["batch"]), "--seq",
            str(TRAIN_MESH["seq"]), "--ckpt-every", str(e["ckpt_every"]),
            "--ckpt-dir", directory, *extra]


def copy_checkpoint(src, dst, step):
    """``src``'s checkpoint of ``step`` alone into ``dst`` (its latest)."""
    import shutil

    shutil.copytree(os.path.join(src, f"step_{step}"),
                    os.path.join(dst, f"step_{step}"))


def launcher_over_mesh(torch, dirs):
    """15c in the ranks' group: the launcher's runs over 2x1 and 1x2 (gloo
    named), deterministic algorithms on: uninterrupted, a failure replayed,
    and the uninterrupted run's checkpoint of ``resume_at`` resumed onto
    1x2 (copied to ``dirs["r"]``; rank 0 also copies it to ``dirs["one"]``
    for the one-device resume). Returns their losses, ends, seconds,
    retries, and whether the replayed run's state is the uninterrupted
    one's bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch import train

    gloo = ("--mesh-backend", "gloo")
    e = TRAIN_ELASTIC
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs, seconds = {}, {}
    try:
        for k, extra, kw in (
                ("a", ("--mesh", "2x1"), {}),
                ("f", ("--mesh", "2x1"),
                 {"inject_failure": train.FailOnce(e["fail_at"])}),
                ("r", ("--mesh", "1x2", "--resume"), {})):
            if k == "r":
                dist.barrier()
                if dist.get_rank() == 0:
                    for d in ("r", "one"):
                        copy_checkpoint(dirs["a"], dirs[d], e["resume_at"])
                dist.barrier()
            t = time.perf_counter()
            runs[k] = train.main(elastic_argv(dirs[k], *extra, *gloo), **kw)
            seconds[k] = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(saved)
    a, f = runs["a"], runs["f"]
    replay = all(torch.equal(x, y) for x, y in zip(_train_leaves(f.state),
                                                   _train_leaves(a.state)))
    return {"losses": {k: run.losses for k, run in runs.items()},
            "ends": {k: (run.start, run.end) for k, run in runs.items()},
            "seconds": seconds, "retries": f.metrics.retries,
            "restores": f.metrics.restores, "replay_equal": replay,
            "ranks": {k: run.ranks for k, run in runs.items()}}


def resume_gap(torch, got, run, ckpt):
    """A resumed run's params ``got`` against the uninterrupted run's
    ``run``: (||got - run|| / ||run - ckpt|| over every leaf but the key
    bias, the key bias's largest |got - run|); ``ckpt`` the params the
    resume started from."""
    num = den = 0.0
    bias = 0.0
    for (path, g), (_, w), (_, c) in zip(_param_paths(got),
                                         _param_paths(run),
                                         _param_paths(ckpt)):
        g, w, c = (t.double() for t in (g, w.to(g.device), c.to(g.device)))
        if path[-1] == "bk":
            bias = max(bias, float((g - w).abs().max()))
            continue
        num += float((g - w).square().sum())
        den += float((w - c).square().sum())
    return (num / max(den, 1e-300)) ** 0.5, bias


def train_mesh_rank(rank, world, store, out, job):
    """A rank of phase 15 (two on the one card, gloo): 15a over each of
    ``TRAIN_MESHES``, 15c the launcher's fault path and elastic resume,
    15d mixtral over 1x2. Writes its results (or its traceback) to
    ``out.<rank>``."""
    import dataclasses
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    result = None
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        import repro_torch
        from repro_torch.launch.mesh import make_production_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        meshes = {s: make_production_mesh(shape=s, device="cuda",
                                          backend="gloo")
                  for s in TRAIN_MESHES}
        cfg = dataclasses.replace(repro_torch.get_config("qwen2-0.5b"),
                                  n_layers=TRAIN_MESH_LAYERS)
        result = {}
        t0 = time.perf_counter()
        for dtype in TRAIN_MESH_TOL:
            c = dataclasses.replace(cfg, dtype=dtype)
            for shape in TRAIN_MESHES:
                result["15a", dtype, shape] = mesh_train(
                    torch, c, meshes[shape], steps=TRAIN_MESH["steps"])[0]
                torch.cuda.empty_cache()
        result["15a seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["15c"] = launcher_over_mesh(torch, job["dirs"])
        result["15c seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(repro_torch.get_config("mixtral-8x22b"),
                                   n_layers=MOE_TRAIN["layers"])
        result["15d"] = mesh_train(torch, mcfg, meshes[(1, 2)],
                                   steps=MOE_TRAIN["steps"], donate=True)[0]
        result["15d seconds"] = time.perf_counter() - t0
        dist.destroy_process_group()
    except BaseException:
        result = traceback.format_exc()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


def _gaps(what, run, one, tol, failures):
    """The largest relative gap of ``run``'s losses and grad norms from
    ``one``'s; a gap over ``tol`` joins ``failures``."""
    worst = {}
    for key in ("losses", "grad_norms"):
        gate = tol["loss" if key == "losses" else "grad_norm"]
        gaps = [abs(g / w - 1) for g, w in zip(run[key], one[key])]
        worst[key] = max(gaps)
        if worst[key] > gate:
            failures.append(f"{what} {key}: {run[key]} against one device's "
                            f"{one[key]} ({worst[key]:.3g} > {gate})")
    return worst


def log_mesh_run(label, run, one, tol, failures):
    """A mesh run's losses and grad norms beside one device's, gated."""
    worst = _gaps(label, run, one, tol, failures)
    log(f"  {label}: losses {[round(x, 6) for x in run['losses']]} "
        f"(one device {[round(x, 6) for x in one['losses']]}), grad norms "
        f"{[round(x, 5) for x in run['grad_norms']]} (one device "
        f"{[round(x, 5) for x in one['grad_norms']]}); largest relative gap "
        f"loss {worst['losses']:.3g} (gate {tol['loss']}), grad norm "
        f"{worst['grad_norms']:.3g} (gate {tol['grad_norm']})")


def log_rank_blocks(label, ranks, key, smi, failures):
    """Each rank's resident params and moments against the planner's
    block bytes (equal, and less than the whole state), its peak and step
    ms."""
    for r, res in sorted(ranks.items()):
        run = res[key]
        if not run["resident"] == run["planned"] < run["whole"]:
            failures.append(f"{label} rank {r}: resident {run['resident']} "
                            f"bytes, the planner's blocks {run['planned']}, "
                            f"whole {run['whole']}")
        log(f"  {label} rank {r}: params + AdamW moments resident "
            f"{run['resident']} bytes = the planner's block bytes "
            f"{run['planned']} (whole state {run['whole']}); peak "
            f"{run['peak'] / 2**30:.2f} GiB; step ms "
            f"{[round(x, 1) for x in run['ms']]} ({smi})")


def check_training_over_mesh(torch, dev, smi):
    """Phase 15. Nothing here launches a kernel of the port (the
    reference's training runs no Pallas kernel either). Every gate is
    read, and logged, before the phase fails on the first that did not
    hold."""
    import dataclasses
    import shutil

    import repro_torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import cosine_schedule

    failures = []
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train_mesh")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("a", "f", "r", "one", "z")}
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-0.5b"),
                              n_layers=TRAIN_MESH_LAYERS)
    one = {}
    for dtype in TRAIN_MESH_TOL:
        one[dtype], _ = mesh_train(
            torch, dataclasses.replace(cfg, dtype=dtype), None,
            steps=TRAIN_MESH["steps"])
        log(f"  15a one device, qwen2-0.5b at {TRAIN_MESH_LAYERS} of 24 "
            f"layers, {dtype} compute: losses "
            f"{[round(x, 6) for x in one[dtype]['losses']]}, step ms "
            f"{[round(x, 1) for x in one[dtype]['ms']]}, peak "
            f"{one[dtype]['peak'] / 2**30:.2f} GiB ({smi})")
        torch.cuda.empty_cache()
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        t_ranks = time.perf_counter()
        ranks = spawn_ranks(train_mesh_rank, 2, {"dirs": dirs}, 15,
                            timeout=1200)
        t_ranks = time.perf_counter() - t_ranks
        r0 = ranks[0]
        for dtype, tol in TRAIN_MESH_TOL.items():
            for shape in TRAIN_MESHES:
                label = (f"15a {shape[0]}x{shape[1]} (gloo, two ranks on the "
                         f"card), {dtype}")
                log_mesh_run(label, r0["15a", dtype, shape], one[dtype], tol,
                             failures)
                log_rank_blocks(label, ranks, ("15a", dtype, shape), smi,
                                failures)
        log(f"  15a ranks took {r0['15a seconds']:.1f} s, 15c "
            f"{r0['15c seconds']:.1f} s, 15d {r0['15d seconds']:.1f} s; the "
            f"ranks' spawn and all their phases {t_ranks:.1f} s")

        # 15c: the launcher over the mesh, then onto one device, then the
        # planted fault: the checkpoint with its AdamW moments zeroed
        c, e = r0["15c"], TRAIN_ELASTIC
        if not (c["replay_equal"] and c["retries"] == 1
                and c["restores"] == 1):
            failures.append(f"15c: the replayed 2x1 run: bit-equal "
                            f"{c['replay_equal']}, retries {c['retries']}, "
                            f"restores {c['restores']}")
        saved_det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            t = time.perf_counter()
            onto = train.main(elastic_argv(dirs["one"], "--resume"))
            c["seconds"]["one"] = time.perf_counter() - t
            t = time.perf_counter()
            (params, opt), _ = Checkpointer(dirs["a"]).restore(
                onto.state, step=e["resume_at"])
            Checkpointer(dirs["z"]).save(e["resume_at"], (params, opt._replace(
                m=train_zeros(torch, opt.m), v=train_zeros(torch, opt.v))),
                blocking=True)
            planted = train.main(elastic_argv(dirs["z"], "--resume"))
            c["seconds"]["planted"] = time.perf_counter() - t
        finally:
            torch.use_deterministic_algorithms(saved_det)
        run = Checkpointer(dirs["a"]).restore(onto.state)[0][0]
        resumed = {"onto 1x2": (c["losses"]["r"], c["ends"]["r"],
                                Checkpointer(dirs["r"]).restore(
                                    onto.state)[0][0]),
                   "onto one device": (onto.losses, (onto.start, onto.end),
                                       onto.state[0]),
                   "planted (moments dropped)": (
                       planted.losses, (planted.start, planted.end),
                       planted.state[0])}
        lr_sum = sum(float(cosine_schedule(s, **train.LR_SCHEDULE,
                                           total=e["steps"]))
                     for s in range(e["resume_at"], e["steps"]))
        tail = {"losses": c["losses"]["a"][e["resume_at"]:],
                "grad_norms": [1.0] * (e["steps"] - e["resume_at"])}
        readings = {}
        for what, (losses, ends, got) in resumed.items():
            gap, bias = resume_gap(torch, got, run, params)
            readings[what] = (losses, gap, bias)
            if ends != (e["resume_at"], e["steps"]):
                failures.append(f"15c resumed {what}: steps {ends}")
            if what.startswith("planted"):
                if not gap > ELASTIC_TOL:
                    failures.append(f"15c: a resume without its moments "
                                    f"reads {gap:.3g}, within the gate "
                                    f"{ELASTIC_TOL}")
                continue
            if gap > ELASTIC_TOL or bias > 2 * lr_sum:
                failures.append(f"15c resumed {what}: params {gap:.3g} of "
                                f"the uninterrupted run's update from the "
                                f"checkpoint (gate {ELASTIC_TOL}), the key "
                                f"bias {bias:.3g} (gate {2 * lr_sum:.3g})")
            _gaps(f"15c resumed {what}",
                  {"losses": losses, "grad_norms": tail["grad_norms"]}, tail,
                  TRAIN_MESH_TOL["bfloat16"], failures)
        del onto, planted, run, resumed, params, opt
        log(f"  15c the launcher over 2x1 (gloo) at {e['layers']} layers, "
            f"{e['steps']} steps, checkpoints every {e['ckpt_every']}: losses "
            f"{[round(x, 6) for x in c['losses']['a']]}; a failure injected "
            f"on every rank at step {e['fail_at']} replayed ({c['retries']} "
            f"retry, {c['restores']} restore), its end state bit-equal to "
            f"the uninterrupted run's: {c['replay_equal']}; its checkpoint "
            f"of step {e['resume_at']} resumed by elastic_restore "
            + "; ".join(f"{what}: losses {[round(x, 6) for x in losses]}, "
                        f"params {gap:.3g} of the uninterrupted run's update "
                        f"from the checkpoint, key bias {bias:.3g}"
                        for what, (losses, gap, bias) in readings.items())
            + f" (gates {ELASTIC_TOL}, the planted run above it; key bias "
            f"{2 * lr_sum:.3g}); seconds " + ", ".join(
                f"{k} {v:.1f}" for k, v in c["seconds"].items()))
        for k, label in (("a", "uninterrupted 2x1"), ("r", "resumed 1x2")):
            log(f"  15c {label}: each rank's resident / planned bytes and "
                f"peak: " + ", ".join(
                    f"rank {i} {x['resident']} / {x['planned']}, "
                    f"{x['peak'] / 2**30:.2f} GiB"
                    for i, x in enumerate(c["ranks"][k])))
            if any(x["resident"] != x["planned"] for x in c["ranks"][k]):
                failures.append(f"15c {label}: resident != planned")
    finally:
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
        shutil.rmtree(root, ignore_errors=True)

    # 15b: a 1x1 NCCL mesh at 24 layers, bit-equal to one device
    t15b = time.perf_counter()
    full = repro_torch.get_config("qwen2-0.5b")
    saved_det = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        one24, s_one = mesh_train(torch, full, None,
                                  steps=TRAIN_MESH["steps"], keep=True)
        mesh = make_production_mesh(shape=(1, 1), device="cuda")
        try:
            nccl, s_nccl = mesh_train(torch, full, mesh,
                                      steps=TRAIN_MESH["steps"], keep=True)
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(saved_det)
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    bit_equal = (nccl["losses"] == one24["losses"]
                 and nccl["grad_norms"] == one24["grad_norms"]
                 and all(torch.equal(a, b) for a, b in
                         zip(_train_leaves(s_nccl), _train_leaves(s_one))))
    del s_one, s_nccl
    if not bit_equal or not nccl["resident"] == nccl["planned"] == \
            nccl["whole"]:
        failures.append(f"15b: the 1x1 NCCL mesh against one device: "
                        f"bit-equal {bit_equal}, losses {nccl['losses']} / "
                        f"{one24['losses']}")
    log(f"  15b 1x1 NCCL mesh, qwen2-0.5b at 24 layers: losses "
        f"{nccl['losses']}, grad norms {nccl['grad_norms']}; bit-equal to "
        f"one device's, params and moments after {TRAIN_MESH['steps']} "
        f"steps too: {bit_equal}; step ms {[round(x, 1) for x in nccl['ms']]}"
        f" (one device {[round(x, 1) for x in one24['ms']]}; phase 12's "
        f"steps are 8 x 256 too); peak {nccl['peak'] / 2**30:.2f} GiB (one "
        f"device {one24['peak'] / 2**30:.2f}); "
        f"{time.perf_counter() - t15b:.1f} s ({smi})")
    torch.cuda.empty_cache()

    # 15d: mixtral-8x22b over 1x2, then its one-device oracle
    t15d = time.perf_counter()
    mcfg = dataclasses.replace(repro_torch.get_config("mixtral-8x22b"),
                               n_layers=MOE_TRAIN["layers"])
    moe_one, _ = mesh_train(torch, mcfg, None, steps=MOE_TRAIN["steps"],
                            donate=True)
    label = "15d mixtral-8x22b 1 of 56 layers 1x2 (gloo)"
    log_mesh_run(label, r0["15d"], moe_one, TRAIN_MESH_TOL["bfloat16"],
                 failures)
    log_rank_blocks(label, ranks, "15d", smi, failures)
    log(f"  15d one device: peak {moe_one['peak'] / 2**30:.2f} GiB, step ms "
        f"{[round(x, 1) for x in moe_one['ms']]}; the oracle took "
        f"{time.perf_counter() - t15d:.1f} s ({smi})")
    torch.cuda.empty_cache()
    assert not failures, "phase 15: " + "; ".join(failures)


# --------------------------------------------------------------- phase 16
# 16a: the dry-run (repro_torch.launch.dryrun) over a fake world of 256 on
# this host's torch, a subset of the registry's cells stated here — the whole
# sweep takes tens of minutes of the host's CPU: one cell a family (dense,
# MoE, SSM, hybrid, encoder-decoder) and the dense train cell, the decode
# cells W8A16 over the int8 cache (--quantized --kv8); each cell a process
# of its own (the fake world is the process's default group), all started
# together after the build, at the lowest CPU priority, tracing on the
# host's idle cores while phases 2-15 run the card (the sweep took 25-30 s
# of phase 16 when it ran there)
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k"), ("mixtral-8x22b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"), ("zamba2-2.7b", "decode_32k"),
                ("whisper-tiny", "train_4k"), ("qwen2-0.5b", "train_4k"))
# the most phase 16 waits for the sweep's processes still running (each
# cell traced in 10-20 s on the H100's host)
DRYRUN_WAIT = 180
_DRYRUN_CELL = r"""
import json, sys
import torch
from repro_torch.launch.dryrun import run_cell
arch, shape, out = sys.argv[1:4]
q = shape in ("decode_32k", "long_500k")
r = run_cell(arch, shape, False, quantized=q, kv8=q)
r["cuda_initialized"] = torch.cuda.is_initialized()
with open(out, "w") as f:
    json.dump(r, f)
"""
# 16b's predictions: ``dry_run`` of each of ``YARDSTICK_CELLS`` on a 1x1
# mesh, in one more process of the sweep
_DRYRUN_YARDSTICK = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.launch.dryrun import dry_run
out = sys.argv[2]
r = [dry_run(cfg, shape, (1, 1), quantized=q, probe=False)
     for cfg, shape, q in (chip_smoke.yardstick_cell(*c)
                           for c in chip_smoke.YARDSTICK_CELLS)]
with open(out, "w") as f:
    json.dump({"preds": r, "cuda_initialized": torch.cuda.is_initialized()},
              f)
"""
# 16b: the dry-run's prediction of one device against the card, qwen2-0.5b
# at full width — phase 4's decode shape (8 slots, a 512-position cache,
# the cache filled to 480 by a prefill before the timed steps) and phase
# 12a's train step (8 x 256); measured after 16a's processes end, so
# that no step is timed beside them
YARDSTICK = dict(arch="qwen2-0.5b", seed=0, slots=8, max_len=512, filled=480,
                 decode_steps=20, train_batch=8, train_seq=256, train_steps=5)
# 16b's cells: (quantize, kv_bits) of the two decode steps, then the train
# step's (None, None)
YARDSTICK_CELLS = (("w8a16", 16), ("w8a8", 8), (None, None))
# argument bytes: the card's resident bytes of the step's arguments are the
# dry-run's block bytes plus the caching allocator's rounding — a tensor
# under 1 MiB up to a multiple of 512 bytes; a larger one takes its block
# whole where less than 1 MiB of its segment would remain after it (the
# allocator splits a large block only above that), so up to 1 MiB more
ALLOC_ROUNDING = 512
ALLOC_LARGE = 1 << 20
# temp bytes: the measured peak above the resident arguments, over the
# dry-run's. Decode: the dry-run traces the plain tier, whose W8A16 GEMM
# dequantizes each weight before its product and whose attention
# dequantizes the int8 cache, where the kernels write their outputs only;
# both hold the compute-dtype copy of the tied float32 embedding (272 MB of
# ~300): [0.5, 1.25]. Train: no kernel on the path, the same operations on
# meta and on the card: [0.8, 1.25]
TEMP_BAND = {"decode": (0.5, 1.25), "train": (0.8, 1.25)}


def start_dryrun_sweep():
    """16a's cells and 16b's predictions, each a process of its own at the
    lowest CPU priority, started now; ``finish_dryrun_sweep`` collects
    them (and they are killed if the script ends first)."""
    import atexit
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    jobs = {(arch, shape): [_DRYRUN_CELL, arch, shape]
            for arch, shape in DRYRUN_CELLS}
    jobs["16b"] = [_DRYRUN_YARDSTICK, root]
    procs = {}
    for key, argv in jobs.items():
        out = os.path.join(tmp, "__".join(key if key != "16b" else (key,))
                           + ".json")
        sink = open(out + ".log", "wb")
        procs[key] = (subprocess.Popen(
            [sys.executable, "-c", *argv, out], env=env, stdout=sink,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19)),
            out, sink)
    sweep = {"procs": procs, "tmp": tmp, "t0": time.perf_counter()}
    atexit.register(_end_dryrun_sweep, sweep)
    return sweep


def _end_dryrun_sweep(sweep):
    """Kill the sweep's processes still running; remove its files."""
    import shutil

    for proc, _, sink in sweep["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        sink.close()
    shutil.rmtree(sweep["tmp"], ignore_errors=True)


def finish_dryrun_sweep(torch, smi, sweep):
    """16a: every cell of ``DRYRUN_CELLS`` ok, and none touched CUDA;
    returns 16b's predictions."""
    t0 = time.perf_counter()
    deadline = t0 + DRYRUN_WAIT
    results = {}
    try:
        for key, (proc, out, sink) in sweep["procs"].items():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            sink.close()
            if proc.returncode != 0:
                with open(out + ".log") as f:
                    raise RuntimeError(f"16a {key}: the dry-run failed:\n"
                                       f"{f.read()[-3000:]}")
            with open(out) as f:
                results[key] = json.load(f)
    finally:
        _end_dryrun_sweep(sweep)
    yard = results.pop("16b")
    assert not yard["cuda_initialized"], "16b's predictions touched CUDA"
    for (arch, shape), r in results.items():
        assert r["status"] == "ok", (arch, shape, r)
        assert not r["cuda_initialized"], (arch, shape)
        ro = r["roofline"]
        log(f"  16a {arch} {shape} 16x16"
            f"{' W8A16 kv8' if 'decode' in shape or 'long' in shape else ''}: "
            f"{r['status']}, {r['placement']}, dominant {ro['dominant']}, "
            f"bound {ro['bound_time_s'] * 1e3:.3f} ms (H100 constants), "
            f"fits_hbm {r['fits_hbm']} ({r['hbm_used_per_device'] / 1e9:.2f} "
            f"GB a device), per-device flops {r['cost']['flops']:.4e}, "
            f"collective bytes {r['collectives']['total']}, traced in "
            f"{r['timings']['total_s']:.1f} s")
    log(f"  16a: {len(results)} cells ok on torch {torch.__version__}'s fake "
        f"world, started {t0 - sweep['t0']:.1f} s before phase 16 at the "
        f"lowest CPU priority; waited {time.perf_counter() - t0:.1f} s for "
        f"them and 16b's predictions ({smi})")
    return yard["preds"]


def _alloc_slack(tree) -> int:
    """The most the caching allocator may add to the bytes of ``tree``'s
    tensors."""
    from repro_torch.launch.dryrun import tensors

    return sum(ALLOC_LARGE if t.numel() * t.element_size() >= ALLOC_LARGE
               else ALLOC_ROUNDING for t in tensors(tree, None))


def _yardstick_gates(reading, pred, smi, failures):
    """Log the dry-run's prediction beside the card's reading (a
    ``yardstick_*`` result), and gate: measured time at least the bound;
    resident arguments the predicted bytes plus at most the allocator's
    rounding (``slack``); the step's peak above them within ``TEMP_BAND``
    of the predicted temp bytes."""
    label, resident, slack, peak, ms, kind = (
        reading[k] for k in ("label", "resident", "slack", "peak", "ms",
                             "kind"))
    arg = pred["memory"]["argument_size_in_bytes"]
    temp = pred["memory"]["temp_size_in_bytes"]
    bound_ms = pred["roofline"]["bound_time_s"] * 1e3
    lo, hi = TEMP_BAND[kind]
    log(f"  16b {label}: step {ms:.3f} ms against the bound {bound_ms:.4f} ms "
        f"({pred['roofline']['dominant']}; measured / bound "
        f"{ms / bound_ms:.1f}); resident {resident} bytes against the "
        f"dry-run's arguments {arg} (+{resident - arg}, the allocator's "
        f"rounding at most {slack}); "
        f"the step's peak above them {peak} bytes against the dry-run's temp "
        f"{temp} (ratio {peak / temp:.3f}, band [{lo}, {hi}]) ({smi})")
    if ms < bound_ms:
        failures.append(f"{label}: {ms} ms below the bound {bound_ms} ms")
    if not 0 <= resident - arg <= slack:
        failures.append(f"{label}: resident {resident} bytes, the dry-run's "
                        f"arguments {arg}")
    if not lo <= peak / temp <= hi:
        failures.append(f"{label}: peak {peak} bytes, the dry-run's temp "
                        f"{temp}: ratio {peak / temp:.3f}")


def yardstick_cell(quantize, kv_bits):
    """16b's cell of ``YARDSTICK_CELLS`` as the dry-run takes it: (cfg,
    shape, quantize) of the decode step (``quantize`` weights over a
    ``kv_bits`` cache), or of phase 12a's train step (``quantize`` None)."""
    import dataclasses

    import repro_torch
    from repro_torch.models import ShapeConfig

    y = YARDSTICK
    cfg = repro_torch.get_config(y["arch"])
    if quantize is None:
        return cfg, ShapeConfig("train_256", y["train_seq"],
                                y["train_batch"], "train"), None
    return (dataclasses.replace(cfg, kv_cache_bits=kv_bits),
            ShapeConfig("decode_512", y["max_len"], y["slots"], "decode"),
            quantize)


def yardstick_decode(torch, dev, quantize, kv_bits):
    """16b: one decode step of qwen2-0.5b on the card (``quantize`` weights
    over a ``kv_bits`` cache): its resident arguments, the first step's
    peak (the compute-dtype cast made then, as in the dry-run's trace) and
    the time of a step over a cache filled to ``filled`` positions; with
    the cell the dry-run is to predict."""
    import repro_torch
    from repro_torch.quantized import quantize_for_serving

    y = YARDSTICK
    cfg, shape, _ = yardstick_cell(quantize, kv_bits)
    model = repro_torch.build_model(cfg)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    params = quantize_for_serving(model.init(y["seed"], device=dev),
                                  model.dfq_plan(), mode=quantize)
    cache = model.init_cache(y["slots"], y["max_len"], device=dev,
                             per_slot=True, kv_bits=kv_bits,
                             dtype=torch.bfloat16)
    token = torch.zeros((y["slots"], 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    slack = _alloc_slack((params, cache, token))
    torch.cuda.reset_peak_memory_stats(dev)
    _, cache = model.decode_step(params, token, cache)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base - resident
    # fill the cache: a prefill to ``filled`` positions, then the steps
    gen = torch.Generator(device=dev).manual_seed(y["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (y["slots"], y["filled"] - 1),
                           device=dev, generator=gen)
    _, cache = model.prefill(params, prompt, cache)
    held = {"cache": cache}

    def step():
        _, held["cache"] = model.decode_step(params, token, held["cache"])

    ms = call_ms(step, y["decode_steps"], warmup=2)
    cache = held["cache"]
    assert int(cache["pos"].min()) == y["filled"] + y["decode_steps"] + 2
    assert int(cache["pos"].max()) <= y["max_len"]
    label = (f"qwen2-0.5b decode B={y['slots']} S={y['max_len']} "
             f"{quantize.upper()} over the {'int8' if kv_bits == 8 else 'bf16'}"
             f" cache")
    del params, cache, model
    torch.cuda.empty_cache()
    return dict(label=label, resident=resident, slack=slack, peak=peak, ms=ms,
                kind="decode")


def yardstick_train(torch, dev):
    """16b: phase 12a's train step (qwen2-0.5b, 8 x 256, the state
    donated) on the card, as ``yardstick_decode``'s reading."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import LR_SCHEDULE
    from repro_torch.optim import adamw_init

    y = YARDSTICK
    cfg, _, _ = yardstick_cell(None, None)
    model, step = make_train_step(
        cfg, lr_cfg=dict(LR_SCHEDULE, total=60), donate=True)
    stream = TokenStream(seed=0, shard=0, n_shards=1,
                         batch_per_shard=y["train_batch"],
                         seq=y["train_seq"], vocab=cfg.vocab_size,
                         device=dev)
    batches = [{k: v.to(torch.int32).contiguous()
                for k, v in stream.batch(s).items()}
               for s in range(y["train_steps"] + 1)]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    params = model.init(y["seed"], device=dev)
    opt = adamw_init(params)
    batch = {k: v.clone() for k, v in batches[0].items()}
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    slack = _alloc_slack((params, opt, batch))
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt, m = step(params, opt, batch)
    float(m["loss"])
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base - resident
    ms = []
    for b in batches[1:]:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        float(m["loss"])
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    label = (f"qwen2-0.5b train step {y['train_batch']} x {y['train_seq']} "
             f"(donated), steps 2-{len(ms) + 1} "
             f"{[round(x, 1) for x in ms]} ms, the least")
    del params, opt, model
    torch.cuda.empty_cache()
    return dict(label=label, resident=resident, slack=slack, peak=peak,
                ms=min(ms), kind="train")


def check_dryrun(torch, dev, smi, sweep):
    """Phase 16: the card's readings of 16b's cells (the sweep's processes
    ended, so alone on the host: waited for first if one still runs); the
    dry-run's sweep (16a, ``start_dryrun_sweep``'s) collected and its
    predictions of 16b's cells held to the readings; the kernel launches of
    16b's decode steps (prefill included) by run. Every gate is read and
    logged before the phase fails on the first that did not hold."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launch_counts

    preds = finish_dryrun_sweep(torch, smi, sweep)
    failures, counts, readings = [], {}, []
    for quantize, kv_bits in YARDSTICK_CELLS:
        if quantize is None:
            readings.append(yardstick_train(torch, dev))
            continue
        reset_launch_counts()
        readings.append(yardstick_decode(torch, dev, quantize, kv_bits))
        counts[f"{quantize} kv{kv_bits}"] = launch_counts()
    for reading, pred in zip(readings, preds, strict=True):
        _yardstick_gates(reading, pred, smi, failures)
    for label, c in counts.items():
        log(f"  16b {label} launches: "
            + ", ".join(f"{k} {v}" for k, v in sorted(c.items()) if v))
    assert not failures, "phase 16: " + "; ".join(failures)
    return counts


# --------------------------------------------------------------- phase 17
# 17a: the linter's gate on this host's torch, in a process of its own at
# the lowest CPU priority, started after phase 1 (it records the eight
# smoke engines on the CPU, ~17 s on an idle core: done long before phase
# 17); no card is visible to it
LINT_WAIT = 120.0
# phase 17's limit: its own time (17a's wait included) and 17b / 17c's,
# which run inside phase 4 and are timed there; a slower phase 17 fails
# the script (14.1 s on the H100's slowest host seen so far, whose 12a
# step took 475 ms)
LINT_PHASE_S = 20.0


def start_lint_check():
    """17a's ``python -m repro_torch.analysis.lint --check --report`` in
    a process at the lowest CPU priority, started now; ``finish_lint_check``
    collects it (and it is killed if the script ends first)."""
    import atexit
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["CUDA_VISIBLE_DEVICES"] = ""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lint_")
    report = os.path.join(tmp, "lint_report.json")
    sink = open(report + ".log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--check",
         "--report", report], env=env, stdout=sink,
        stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
    job = {"proc": proc, "sink": sink, "report": report, "tmp": tmp,
           "t0": time.time()}
    atexit.register(_end_lint_check, job)
    return job


def _end_lint_check(job):
    import shutil

    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    job["sink"].close()
    shutil.rmtree(job["tmp"], ignore_errors=True)


def finish_lint_check(torch, smi, job):
    """17a: the check exited 0, every contract held with 0 errors."""
    t0 = time.perf_counter()
    try:
        job["proc"].wait(timeout=LINT_WAIT)
        job["sink"].close()
        with open(job["report"] + ".log") as f:
            out = f.read()
        assert job["proc"].returncode == 0, (
            f"17a: the lint check exited {job['proc'].returncode}:\n"
            f"{out[-3000:]}")
        took = os.path.getmtime(job["report"]) - job["t0"]
        with open(job["report"]) as f:
            report = json.load(f)
    finally:
        _end_lint_check(job)
    assert report["ok"] and report["mode"] == "check", report["ok"]
    for r in report["recipes"]:
        assert r["counts"]["error"] == 0 and r["diff"] == [], (r["stem"],
                                                                r["diff"])
        rules = sorted({f["rule"] for f in r["findings"]})
        log(f"  17a {r['stem']}: checked, 0 errors, {r['counts']['info']} "
            f"info (known debt: {', '.join(rules) or 'none'}) ({smi})")
    log(f"  17a: {len(report['recipes'])} contracts hold on torch "
        f"{torch.__version__}'s CPU, no drift; the check took {took:.1f} s "
        f"from its start after phase 1 at the lowest CPU priority, waited "
        f"{time.perf_counter() - t0:.1f} s for it ({smi})")
    return len(report["recipes"])


@contextlib.contextmanager
def kept_engines():
    """Inside the block, every ``ServingEngine`` that ``repro_torch.serve``
    builds is also appended to the yielded list (17b lints phase 4's
    engines after their runs; the list is the only other reference)."""
    import repro_torch.launch.serve as launcher

    real = launcher.ServingEngine
    kept: list = []

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    launcher.ServingEngine = Kept
    try:
        yield kept
    finally:
        launcher.ServingEngine = real


def _pool_state(torch, engine):
    pool = engine.pool
    return (engine.pool_pointers(), pool.cache_bytes(),
            {k: pool.cache[k].clone() for k in ("kpos", "pos")})


def lint_card_engine(torch, engine, recipe, want_step, label, smi):
    """``lint_engine`` of a card engine at the cuda tier, with 17b's
    checks; returns (seconds, {kernel: launches} of its paths, the live
    graph)."""
    from repro_torch.analysis.lint import lint_engine
    from repro_torch.analysis.lint.extract import graph_from_engine

    ptrs, nbytes, book = _pool_state(torch, engine)
    t0 = time.perf_counter()
    graph = graph_from_engine(engine, recipe=recipe, live=True)
    findings = lint_engine(engine, recipe, verbose=False, graph=graph)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    errors = [f.format() for f in findings if f.severity == "error"]
    assert not errors, f"17b {label}: " + "\n".join(errors)
    launched: dict = {}
    for name, art in graph.jits.items():
        nodes = art.graph.kernel_counts("cuda")
        assert nodes == art.graph.launches, (
            f"17b {label} {name}: kernel nodes {nodes} but the wrappers "
            f"counted {art.graph.launches}")
        assert not art.graph.kernel_counts("torch"), (label, name)
        for op, n in nodes.items():
            launched[op] = launched.get(op, 0) + n
    step = graph.jits["decode"].graph.kernel_counts("cuda")
    assert step == want_step, (
        f"17b {label}: one masked decode step's kernel nodes {step}, "
        f"expected {want_step}")
    ptrs2, nbytes2, book2 = _pool_state(torch, engine)
    assert ptrs2 == ptrs and nbytes2 == nbytes, f"17b {label}: pool moved"
    assert all(torch.equal(book[k], book2[k]) for k in book), (
        f"17b {label}: the lint changed the pool's bookkeeping")
    shapes = engine.warmup_shapes()
    captured = engine.graphs.keys()
    assert captured == (shapes if engine.warmed else set()), (
        f"17b {label}: captured {sorted(captured)}, warmup shapes "
        f"{sorted(shapes)}")
    assert graph.captured == captured
    infos = sum(f.severity == "info" for f in findings)
    log(f"  17b {label}: lint_engine at the cuda tier: 0 errors, {infos} "
        f"info (the prefill dequant, structural debt), {took:.2f} s; one "
        f"masked decode step's kernel nodes = the wrappers' count = "
        f"{json.dumps(step, sort_keys=True)}; every path's nodes = its "
        f"launches; the pool's {len(ptrs)} leaves at their addresses, "
        f"{nbytes} bytes, bookkeeping unchanged; captured graphs "
        f"{sorted(captured) if captured else 'none'} ({smi})")
    return took, launched, graph


def plant_decode_dequant(torch, engine):
    """17c: every decode-path call of the fused kernel on layer 0 first
    converts its int8 K cache to bf16 in eager torch (outside any kernel);
    lint_engine must report it. Returns the dtype-ledger errors."""
    from repro_torch.analysis.lint import lint_engine
    from repro_torch.analysis.lint.extract import graph_from_engine
    from repro_torch.models import layers

    real = layers.fused_decode
    leaf = engine.pool.cache["k"]

    def planted(q, cache_k, *args, **kwargs):
        if cache_k.data_ptr() == leaf.data_ptr():
            cache_k.to(torch.bfloat16)
        return real(q, cache_k, *args, **kwargs)

    layers.fused_decode = planted
    try:
        # the serve paths alone: the plant is in none of the kernel specs
        graph = graph_from_engine(engine, recipe="serve-w8a8-kv8", live=True,
                                  include_kernels=False)
    finally:
        layers.fused_decode = real
    findings = lint_engine(engine, "serve-w8a8-kv8", verbose=False,
                           graph=graph)
    return [f for f in findings if f.severity == "error"
            and f.rule == "dtype-ledger"]


def check_lint_live(torch, run_engine, quantize, smi):
    """17b (and 17c on the w8a8 engine), inside phase 4: a fresh engine
    over the fast run's weights before warmup, then the run's own warmed
    engine. Returns (seconds, {kernel: launches}, 17c's errors)."""
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    e = run_engine
    recipe = f"serve-{quantize}-kv8"
    want = {k: v for k, v in expected_launches(quantize, True, 1, 0).items()
            if v}
    fresh = ServingEngine(e.model, e.params, e.cfg, num_slots=e.num_slots,
                          max_len=e.max_len, prefill_chunk=e.prefill_chunk,
                          decode_horizon=e.decode_horizon, kv_bits=e.kv_bits,
                          device=e.device)
    launched: dict = {}
    for eng, when in ((fresh, "before warmup"),
                      (e, "after warmup and the 16 requests")):
        _, counted, _ = lint_card_engine(torch, eng, recipe, want,
                                         f"{recipe} {when}", smi)
        for op, n in counted.items():
            launched[op] = launched.get(op, 0) + n
    planted = []
    if quantize == "w8a8":
        planted = plant_decode_dequant(torch, fresh)
        S, hkv, hd = (int(d) for d in fresh.pool.cache["k"].shape[2:])
        where = f"{fresh.num_slots}x{S}x{hkv}x{hd}"
        got = {(f.jit, f.where) for f in planted}
        assert got == {("decode", where), ("decode_horizon", where)}, got
        log(f"  17c: a planted eager .to(bfloat16) of layer 0's int8 K cache "
            f"on the decode path: dtype-ledger reports it on the live card "
            f"graph ({smi}) — " + "; ".join(f.format() for f in planted))
    del fresh
    took = time.perf_counter() - t0
    log(f"  17b{'/17c' if planted else ''} {recipe} took {took:.1f} s "
        f"({smi})")
    return took, launched, planted


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if os.environ.get("REPRO_KERNEL_BACKEND"):
        print("chip_smoke: REPRO_KERNEL_BACKEND is set "
              f"({os.environ['REPRO_KERNEL_BACKEND']!r}); this script picks "
              "every kernel tier by explicit argument — unset it",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device — this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t1 = phase(t_script, "1: build")
    # entering phase 17's graph recorder (a TorchDispatchMode) the first
    # time imports torch._dynamo, ~2-11 s by host (a first lint took
    # 11.4 s against 2.5-3.1 for the next): imported here, on a thread,
    # while the main thread waits on nvcc
    import threading

    dynamo = threading.Thread(target=__import__, args=("torch._dynamo",))
    dynamo.start()
    lib = _build.build()
    dynamo.join()
    log(f"  built {lib.path.name} in {lib.seconds:.1f} s")
    for line in lib.log.splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Function properties for" in line):
            log("  " + line.strip())
    log(f"  phase 1 took {time.perf_counter() - t1:.1f} s")
    # phase 16a's dry-run cells and 17a's lint check trace on the host's
    # idle cores from here
    sweep = start_dryrun_sweep()
    lint_job = start_lint_check()

    t2 = phase(t_script, "2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {"quantize_act": check_quantize_act(torch, dev, gen),
              "qmatmul_w8a8": check_qmatmul(torch, dev, gen),
              "qmatmul_w8a16": check_qmatmul_w8a16(torch, dev, gen),
              "fused_decode": check_fused_decode(torch, dev, gen),
              "kv_attention": check_kv_attention(torch, dev, gen)}
    check_fused_equals_unfused(torch, dev, gen)
    check_attention_sweep(torch, dev, gen)
    check_queue_c(torch, dev, gen)
    tables["qmatmul_w8a8_q8"] = check_qmatmul_w8a8_q8(torch, dev, gen)
    tables["qmatmul_w8a16_q8"] = check_qmatmul_w8a16_q8(torch, dev, gen)
    tables["qmatmul_w8a8_qin"] = check_qmatmul_w8a8_qin(torch, dev, gen)
    check_split_sweep(torch, dev, gen)
    for name, rows in tables.items():
        if name == "qmatmul_w8a8_qin":
            continue  # logged by its check, fold beside pair
        for r in rows:
            log_row(name, r)
    log_step_sums(tables)
    check_new_attention(torch, dev, gen)
    check_new_gemms(torch, dev, gen)
    expert_rows = check_expert_gemms(torch, dev, gen)
    family_rows = check_new_gemms(torch, dev, gen, family_gemms(),
                                  "the new families' shapes")
    family_rows["quantize_act"] = check_family_quantize_act(torch, dev, gen)
    log("  the per-rank shapes of tensor-parallel qwen2-0.5b (phase 13)")
    tp_rows = check_tp_shapes(torch, dev, gen)
    log("  the per-rank expert shapes of tensor-parallel mixtral-8x22b and "
        "llama4-scout (phase 14), then mixtral's dense ones")
    moe_tp_rows = check_moe_tp_shapes(torch, dev, gen)
    for name, rows in check_tp_shapes(
            torch, dev, gen, MOE_TP_COLUMN, MOE_TP_ROW, TP_M,
            MOE_TP_ATTENTION, MOE_TP_QUANTIZE).items():
        moe_tp_rows.setdefault(name, []).extend(rows)
    log(f"  phase 2 took {time.perf_counter() - t2:.1f} s ({smi})")

    t3 = phase(t_script, "3: small-input reference")
    for recipe in ("serve-w8a16-kv8", "serve-w8a8-kv8", "dfq-int8",
                   "naive-int8", "cle-only", BC_DEPLOY):
        check_reference(torch, dev, recipe)
    check_hostile_gate(torch, dev)
    # the fp KV cache (the reference's default deployment), the
    # unquantized model, every new arch through serve-w8a16-kv8, and the
    # plain tier on the card by explicit argument
    for recipe in ("serve-w8a16", "serve-w8a8"):
        check_reference(torch, dev, recipe, kv_bits=16)
    check_smoke_serving(torch, "qwen2-0.5b", "w8a16", None)
    check_smoke_serving(torch, "qwen2-0.5b", "w8a8", None)
    check_smoke_serving(torch, "qwen2-0.5b", "none", None)
    for arch in ("yi-34b", "mistral-nemo-12b", "gemma-7b", "chameleon-34b"):
        check_smoke_serving(torch, arch, "w8a16", 8)
    check_torch_tier_on_card(torch)
    check_moe_smoke(torch, dev)
    log(f"  phase 3 took {time.perf_counter() - t3:.1f} s ({smi})")

    t4 = phase(t_script, "4: serve qwen2-0.5b (full width) through "
                         "repro_torch.serve")
    log(f"  {smi}")
    runs, stepwise, lint_live = {}, {}, {}
    for quantize in ("w8a16", "w8a8"):
        stepwise[quantize] = serve_full_width(torch, quantize,
                                              reference=True)[0]
        with kept_engines() as kept:
            runs[quantize] = serve_full_width(torch, quantize)
        # 17b / 17c on the fast run's engine, while it lives
        lint_live[quantize] = check_lint_live(torch, kept.pop(), quantize,
                                              smi)
        del kept
        same_tokens(runs[quantize][0], stepwise[quantize],
                    f"serve-{quantize}-kv8 fast against stepwise")
        log(f"  serve-{quantize}-kv8: every request's tokens and finish tick "
            f"equal the stepwise run's")
    for quantize in ("w8a16", "w8a8"):
        run, counts = serve_full_width(torch, quantize, fused=False)
        same_tokens(run, runs[quantize][0],
                    f"serve-{quantize}-kv8 unfused against fused")
        log(f"  serve-{quantize}-kv8 unfused: every request's tokens equal "
            f"the fused run's")
        runs[quantize + " unfused"] = run, counts
    runs["w8a8 kv_bias_correct"], bc_stepwise = serve_bias_corrected(torch)
    stepwise["w8a8 kv_bias_correct"] = bc_stepwise[0]
    speeds = [f"{label} {run.tokens_per_second:.1f}"
              for label, (run, _) in runs.items()]
    log("  fast tok/s in run order: " + ", ".join(speeds) + f" ({smi})")
    log("  tok/s fast / stepwise: " + ", ".join(
        f"{label} {runs[label][0].tokens_per_second:.1f} / "
        f"{run.tokens_per_second:.1f}" for label, run in stepwise.items())
        + f" ({smi})")
    # an extra, untimed fast run of the default recipe under torch.profiler:
    # the device busy share of the serving loop
    prof_run, _ = serve_full_width(torch, "w8a16", profile=True)
    busy = prof_run.busy_share
    log(f"  device busy share of the profiled fast w8a16 loop: "
        + ("not measured (the profiler recorded no device time)"
           if busy is None else f"{busy * 100:.1f} %")
        + f" over {prof_run.seconds:.3f} s ({smi})")
    log(f"  phase 4 took {time.perf_counter() - t4:.1f} s ({smi})")

    t5 = phase(t_script, "5: DFQ of qwen2-0.5b (full width) and its "
                         "bias-corrected w8a8 deployment saved, loaded and "
                         "served")
    log(f"  {smi}")
    model, params = dfq_full_width(torch, dev)
    bc_fast, bc_stepwise = serve_saved_deployment(torch, dev, model, params)
    del model, params
    log(f"  tok/s fast / stepwise: bias-corrected w8a8 --load "
        f"{bc_fast.tokens_per_second:.1f} / {bc_stepwise.tokens_per_second:.1f}"
        f", phase 4's serve-w8a8-kv8 {runs['w8a8'][0].tokens_per_second:.1f} / "
        f"{stepwise['w8a8'].tokens_per_second:.1f} ({smi})")
    log(f"  phase 5 took {time.perf_counter() - t5:.1f} s ({smi})")

    t6 = phase(t_script, "6: serve mistral-nemo-12b (full width) through "
                         "repro_torch.serve")
    log(f"  {smi}")
    depth = cut_depth(torch, dev, NEMO["arch"], (2, 4), most=NEMO_LAYERS)
    nemo = {}
    for quantize, kv_bits in (("w8a16", None), ("w8a8", 8)):
        step = serve_cut(torch, NEMO, depth, quantize, kv_bits,
                         reference=True)[0]
        fast = serve_cut(torch, NEMO, depth, quantize, kv_bits,
                         reference=False)[0]
        label = f"serve-{quantize}" + ("-kv8" if kv_bits else " (bf16 KV)")
        same_tokens(fast, step, f"mistral-nemo-12b {label} fast against "
                                f"stepwise")
        nemo[label] = fast, step
        log(f"  mistral-nemo-12b {label}: every request's tokens and finish "
            f"tick equal the stepwise run's")
    log("  mistral-nemo-12b tok/s fast / stepwise: " + ", ".join(
        f"{label} {f.tokens_per_second:.1f} / {s.tokens_per_second:.1f}"
        for label, (f, s) in nemo.items())
        + f" ({depth} layers; {smi})")
    log(f"  phase 6 took {time.perf_counter() - t6:.1f} s")

    t7 = phase(t_script, "7: the paper's CNN flow (BN folding, CLE, "
                         "high-bias absorption, bias correction) trained and "
                         "quantized on the card")
    log(f"  {smi}")
    cnn_paper_tables(torch, dev, smi)
    mobilenet_v2_published(torch, dev, smi)
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    t8 = phase(t_script, "8: serve qwen2-0.5b (full width) from the paged "
                         "pool: prefix reuse, preemption, chaos, deadlines")
    log(f"  {smi}")
    check_paged_serving(torch, runs, stepwise)
    import repro_torch

    qm = repro_torch.quantize(repro_torch.build_model(
        repro_torch.get_config(SERVE["arch"])), None, init_seed=SERVE["seed"],
        device="cuda", recipe="serve-w8a16")
    check_prefix_reuse(torch, qm.model, qm.params, qm.cfg)
    check_starved_pool(torch, qm.model, qm.params, qm.cfg)
    check_deadlines(torch, qm.model, qm.params, qm.cfg)
    del qm
    check_chaos(torch)
    time_gather(torch)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s ({smi})")

    t9 = phase(t_script, "9: serve mixtral-8x22b (full width, its MoE blocks "
                         "through the expert-batched GEMMs) through "
                         "repro_torch.serve")
    log(f"  {smi}")
    depth9 = cut_depth(torch, dev, MIXTRAL["arch"], (1, 2))
    mixtral = {}
    for quantize, kv_bits in (("w8a16", None), ("w8a8", 8)):
        step, _ = serve_cut(torch, MIXTRAL, depth9, quantize, kv_bits,
                            reference=True)
        fast, counts = serve_cut(torch, MIXTRAL, depth9, quantize, kv_bits,
                                 reference=False)
        label = f"serve-{quantize}" + ("-kv8" if kv_bits else " (bf16 KV)")
        same_tokens(fast, step, f"mixtral-8x22b {label} fast against "
                                f"stepwise")
        mixtral[label] = fast, step, counts
        log(f"  mixtral-8x22b {label}: every request's tokens and finish "
            f"tick equal the stepwise run's")
    log("  mixtral-8x22b tok/s fast / stepwise: " + ", ".join(
        f"{label} {f.tokens_per_second:.1f} / {s_.tokens_per_second:.1f}"
        for label, (f, s_, _) in mixtral.items())
        + f" ({depth9} layers; {smi})")
    dropped, routed = prefill_drops(torch, depth9)
    log(f"  mixtral-8x22b at prefill (capacity_factor 1.25, C = 10 slots an "
        f"expert a chunk of 32): {dropped} of {routed} expert choices dropped "
        f"({100 * dropped / routed:.2f} %), the trace's prompts one by one, "
        f"pad positions included")
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s ({smi})")

    t10 = phase(t_script, "10: the async front-end (circuit breaker, "
                          "shedding ladder, client retries) serving "
                          "qwen2-0.5b (full width)")
    log(f"  {smi}")
    async_counts = check_async_front_end(torch)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s ({smi})")

    t11 = phase(t_script, "11: the SSM, hybrid and encoder-decoder families "
                          "(mamba2-2.7b, zamba2-2.7b, whisper-tiny) at full "
                          "width through repro_torch.quantize, prefill and "
                          "greedy decode")
    log(f"  {smi}")
    family_counts = check_families(torch, dev)
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s ({smi})")

    t12 = phase(t_script, "12: train qwen2-0.5b (full width) through "
                          "repro_torch.launch.train, then quantize and serve "
                          "what it trained")
    log(f"  {smi}")
    trained_counts = check_training(torch, dev, smi)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s ({smi})")

    # each kernel's launches come from the run of the path it serves; the
    # fused decode from the default (w8a16) path, kv_attention from the
    # default recipe's unfused route; the quantize-out GEMMs are on no
    # serving path (quantize_out=True only), so the w8a8 run counts them 0;
    # quantize_act's are the w8a8 prefill chunks' (decode folds it into
    # qmatmul_w8a8: the qmatmul_w8a8_qin entry)
    main = {"quantize_act": ("x[8,896] bfloat16", "w8a8"),
            "qmatmul_w8a8_qin": ("M=8 K=896 N=4864 bf16 -> bf16", "w8a8"),
            "qmatmul_w8a8": ("M=8 K=896 N=4864 -> bf16", "w8a8"),
            "qmatmul_w8a16": ("M=8 K=896 N=4864 bfloat16", "w8a16"),
            "fused_decode": ("B=8 Hq=14 Hkv=2 hd=64 S=512 bfloat16", "w8a16"),
            "kv_attention": ("B=8 Hq=14 Hkv=2 hd=64 S=512 bfloat16",
                             "w8a16 unfused"),
            "qmatmul_w8a8_q8": ("M=8 K=896 N=4864", "w8a8"),
            "qmatmul_w8a16_q8": ("M=8 K=896 N=4864 bfloat16", "w8a8")}
    csrc = "src/repro_torch/csrc/"
    tpu = "src/repro/kernels/"
    sources = {"quantize_act": ("quantize_act.cu", "quantize_act/kernel.py:27"),
               "qmatmul_w8a8": ("qmatmul_w8a8.cu", "qmatmul_w8a8/kernel.py:72"),
               "qmatmul_w8a16": ("qmatmul_w8a16.cu",
                                 "qmatmul_w8a16/kernel.py:64"),
               "fused_decode": ("fused_decode.cu", "fused_decode/kernel.py:143"),
               "kv_attention": ("kv_attention.cu", "kv_attention/kernel.py:95"),
               "qmatmul_w8a8_q8": ("qmatmul_w8a8.cu",
                                   "qmatmul_w8a8/kernel.py:143"),
               "qmatmul_w8a16_q8": ("qmatmul_w8a16.cu",
                                    "qmatmul_w8a16/kernel.py:127"),
               "qmatmul_w8a8_qin": ("qmatmul_w8a8.cu",
                                    "quantize_act/kernel.py:27")}
    notes = {"quantize_act": {"decode": "folded into qmatmul_w8a8 "
                              "(qmatmul_w8a8_qin) wherever gemm_plan folds: "
                              "0 launches a decode step; launches are the "
                              "prefill chunks'"},
             "qmatmul_w8a8_qin": {"fuses": tpu + "qmatmul_w8a8/kernel.py:72"}}
    kernels = []
    for name, rows in tables.items():
        shape, path = main[name]
        row = next(r for r in rows if r["shape"] == shape)
        kernels.append({
            # the plan's split, share, tile, ticket, waiter and residency
            # counts are not measured: log only
            **{k: v for k, v in row.items()
               if k not in ("splits", "share", "tickets", "bm", "waiters",
                            "residency")},
            **notes.get(name, {}),
            # the contract's keys, last so that no row key replaces them
            "name": name, "route": "cuda",
            "source": csrc + sources[name][0],
            "replaces": tpu + sources[name][1],
            "launches": runs[path][1][name],
            "path": ("none: quantize_out=True only"
                     if name.endswith("_q8") else path)})
    # the expert-batched launches (phase 9's fast runs, mixtral's decode
    # gate/up rows of phase 2): the same kernels with the expert axis
    w8a16_run, w8a8_run = (mixtral["serve-w8a16 (bf16 KV)"][2],
                           mixtral["serve-w8a8-kv8"][2])
    for name, counted, shape in (
            ("qmatmul_w8a16", w8a16_run, "E=8 M=8 K=6144 N=16384 (mixtral-8x22b "
             "gate/up) bfloat16"),
            ("qmatmul_w8a8", w8a8_run, "E=8 M=80 K=6144 N=16384 (mixtral-8x22b "
             "gate/up) -> bf16"),
            ("qmatmul_w8a8_qin", w8a8_run, "E=8 M=8 K=6144 N=16384 "
             "(mixtral-8x22b gate/up) bf16 -> bf16")):
        row = next(r for r in expert_rows[name] if r["shape"] == shape)
        kernels.append({
            **{k: v for k, v in row.items() if k != "stepwise_ms"},
            "name": name + " (expert-batched)", "route": "cuda",
            "source": csrc + sources[name][0],
            "replaces": tpu + sources[name][1],
            "launches": counted[name],
            "path": "phase 9: mixtral-8x22b " + (
                "serve-w8a16 (bf16 KV)" if counted is w8a16_run
                else "serve-w8a8-kv8")})
    # phase 10's overload run (10b) serves through qmatmul_w8a16 (the bf16
    # KV cache launches no attention kernel); its row is phase 2's at the
    # decode shape
    row = next(r for r in tables["qmatmul_w8a16"]
               if r["shape"] == main["qmatmul_w8a16"][0])
    kernels.append({
        **row, "name": "qmatmul_w8a16 (async front-end)", "route": "cuda",
        "source": csrc + sources["qmatmul_w8a16"][0],
        "replaces": tpu + sources["qmatmul_w8a16"][1],
        "launches": async_counts["qmatmul_w8a16"],
        "path": "phase 10b: qwen2-0.5b --serve-async overload, serve-w8a16 "
                "(bf16 KV), paged"})
    # phase 11's launches, each beside the phase-2 row of the same kernel
    # at the first shape of the arch's path that phase 2 ran it at (the
    # quantize-in fold has rows only where gemm_plan folds)
    recipes = {"qmatmul_w8a16": "serve-w8a16", "qmatmul_w8a8": "serve-w8a8",
               "qmatmul_w8a8_qin": "serve-w8a8", "quantize_act": "serve-w8a8"}
    for arch in FAMILY_PROBES:
        keys = [(M, K, N) for _, K, N, M in family_path_gemms(arch)]
        for name, recipe in recipes.items():
            n = family_counts[arch, recipe].get(name, 0)
            if n == 0 and name == "qmatmul_w8a8_qin":
                continue          # the plan folds at none of its inputs
            assert n > 0, f"phase 11 {arch} {recipe}: {name} never launched"
            want = (family_quantize_inputs(arch) if name == "quantize_act"
                    else keys)
            row = next(r for key in want for r in family_rows[name]
                       if r["gemm"] == key)
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("stepwise_ms", "gemm")},
                "name": f"{name} ({arch})", "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": tpu + sources[name][1], "launches": n,
                "path": f"phase 11: {arch} {recipe} prefill + decode"})
    # phase 12's launches (the trained model served), each beside the
    # kernel's phase-2 row at the decode shape
    for label, counted in trained_counts.items():
        for name, n in counted.items():
            if n == 0:
                continue
            row = next(r for r in tables[name] if r["shape"] == main[name][0])
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("splits", "share", "tickets", "bm", "waiters",
                                "residency", "stepwise_ms")},
                "name": f"{name} (trained qwen2-0.5b)", "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": tpu + sources[name][1], "launches": n,
                "path": f"phase 12: trained qwen2-0.5b {label}, fast path"})
    t13 = phase(t_script, "13: serve qwen2-0.5b (full width) tensor-parallel "
                          "over a torch.distributed mesh (1x2 and 2x1 over "
                          "gloo on the one card, 1x1 over NCCL under CUDA "
                          "graphs)")
    log(f"  {smi}")
    tp_counts = check_tensor_parallel(torch, dev, runs, smi)
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s ({smi})")
    # the launches of phase 13's fast and --load runs, each beside phase
    # 2's row of the kernel at the shape the run launched it at (1x2: this
    # rank's cut shapes; 2x1 and 1x1: the whole shapes, the int32 GEMM at
    # the whole K) or, where phase 2 has none there, its decode-shape row
    at_shape = {
        "1x2": {"qmatmul_w8a8": "M=8 K=896 N=2432",
                "qmatmul_w8a8_qin": "M=8 K=896",
                "qmatmul_w8a8_i32": "M=8 K=2432 N=896",
                "quantize_act": "x[8,4864]",
                "qmatmul_w8a16": "M=8 K=896 N=2432",
                "fused_decode": "B=8 Hq=7 Hkv=1"},
        "2x1": {"qmatmul_w8a8_i32": "M=4 K=4864 N=896",
                "fused_decode": "B=4 Hq=14"},
        "1x1": {"qmatmul_w8a8_i32": "M=8 K=4864 N=896"}}
    for label, counted in tp_counts.items():
        if "stepwise" in label:
            continue
        for name, n in sorted(counted.items()):
            if n == 0:
                continue
            rows = tp_rows.get(name, [])
            key = at_shape[label.split()[2]].get(name)
            row = next((r for r in rows if key and r["shape"].startswith(key)),
                       None)
            if row is None:
                row = next(r for r in tables[name]
                           if r["shape"] == main[name][0])
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("splits", "share", "tickets", "bm", "waiters",
                                "residency", "stepwise_ms")},
                "name": f"{name} (tensor-parallel)", "route": "cuda",
                "source": csrc + (sources[name][0] if name in sources
                                  else "qmatmul_w8a8.cu"),
                "replaces": tpu + (sources[name][1] if name in sources
                                   else "qmatmul_w8a8/kernel.py:72"),
                "launches": n, "path": f"phase {label}"})
    t14 = phase(t_script, "14: serve the MoE family (mixtral-8x22b full "
                          "width, llama4-scout) tensor-parallel over a "
                          "torch.distributed mesh, and --serve-async over a "
                          "mesh")
    log(f"  {smi}")
    moe_tp_counts = check_moe_tensor_parallel(
        torch, dev, min(depth9, MOE_TP_LAYERS), smi)
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s ({smi})")
    # the launches of phase 14's fast runs, each beside phase 2's row of
    # the kernel at the shape the run launched it at (the per-rank expert
    # GEMMs of check_moe_tp_shapes at a decode step), or its decode-shape
    # row where phase 2 has none there
    moe_at = {"1x2": {"qmatmul_w8a8_i32_experts": "E=8 M=8 K=8192",
                      "qmatmul_w8a8_i32": "M=8 K=3072 N=6144",
                      "qmatmul_w8a8_qin": "E=8 M=8 K=6144 N=8192",
                      "qmatmul_w8a8": "E=8 M=80 K=6144 N=8192",
                      "qmatmul_w8a16": "E=8 M=8 K=6144 N=8192",
                      "fused_decode": "B=8 Hq=24",
                      "quantize_act": "x[64,16384]"},
              "2x1": {"qmatmul_w8a8_i32_experts": "E=8 M=4 K=16384",
                      "qmatmul_w8a8_i32": "M=4 K=6144 N=6144",
                      "fused_decode": "B=4 Hq=48",
                      "quantize_act": "x[32,16384]"},
              "1x1": {"qmatmul_w8a8_i32_experts": "E=8 M=8 K=16384",
                      "qmatmul_w8a8_i32": "M=8 K=6144 N=6144",
                      "fused_decode": "B=8 Hq=48",
                      "quantize_act": "x[64,16384]"}}
    for label, counted in moe_tp_counts.items():
        mesh_s = next((m for m in ("1x2", "2x1", "1x1") if f" {m} " in label),
                      None)
        if mesh_s is None or label.startswith("14c"):
            continue          # one device (phase 9's rows), smoke size
        # 14d serves qwen2 (phase 13's shapes), 14a / 14b mixtral
        at, rows_of = ((at_shape, tp_rows) if label.startswith("14d")
                       else (moe_at, moe_tp_rows))
        for name, n in sorted(counted.items()):
            if n == 0:
                continue
            key = at.get(mesh_s, {}).get(name)
            row = next((r for r in rows_of.get(name, [])
                        if key and r["shape"].startswith(key)), None)
            if row is None:
                row = next(r for r in tables[name]
                           if r["shape"] == main[name][0])
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("splits", "share", "tickets", "bm", "waiters",
                                "residency", "stepwise_ms",
                                "with_epilogue_ms")},
                "name": f"{name} ({'async ' if '14d' in label else ''}"
                        f"tensor-parallel{' MoE' if '14d' not in label else ''})",
                "route": "cuda",
                "source": csrc + (sources[name][0] if name in sources
                                  else "qmatmul_w8a8.cu"),
                "replaces": tpu + (sources[name][1] if name in sources
                                   else "qmatmul_w8a8/kernel.py:72"),
                "launches": n, "path": f"phase {label}"})
    t15 = phase(t_script, "15: train over a torch.distributed mesh — "
                          "qwen2-0.5b (full width) over 2x1 (FSDP) and 1x2 "
                          "(TP) with two gloo ranks on the one card, a 1x1 "
                          "NCCL mesh, the launcher's fault path and elastic "
                          "resume, mixtral-8x22b over 1x2")
    log(f"  {smi}")
    check_training_over_mesh(torch, dev, smi)
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s ({smi})")
    t16 = phase(t_script, "16: the dry-run (repro_torch.launch.dryrun) over "
                          "a fake world on this torch, and its roofline and "
                          "memory held to the card")
    log(f"  {smi}")
    dry_counts = check_dryrun(torch, dev, smi, sweep)
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s ({smi})")
    # phase 16b's launches, each beside the kernel's phase-2 row at the
    # decode shape
    for label, counted in dry_counts.items():
        for name, n in sorted(counted.items()):
            if n == 0:
                continue
            row = next(r for r in tables[name] if r["shape"] == main[name][0])
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("splits", "share", "tickets", "bm", "waiters",
                                "residency", "stepwise_ms")},
                "name": f"{name} (dry-run yardstick)", "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": tpu + sources[name][1], "launches": n,
                "path": f"phase 16: qwen2-0.5b {label}, eager decode steps "
                        f"and one prefill"})
    t17 = phase(t_script, "17: the graph linter (repro_torch.analysis.lint)"
                          " — the contracts on this torch, the live card "
                          "engines of phase 4, a planted dequant")
    log(f"  {smi}")
    n_contracts = finish_lint_check(torch, smi, lint_job)
    for quantize, (took, launched, planted) in lint_live.items():
        log(f"  17b serve-{quantize}-kv8 (in phase 4, {took:.1f} s): kernel "
            f"launches of the linted paths {json.dumps(launched, sort_keys=True)}"
            + (f"; 17c caught by {len(planted)} dtype-ledger errors"
               if planted else "") + f" ({smi})")
    assert lint_live["w8a8"][2], "17c: the planted dequant went unreported"
    took17 = time.perf_counter() - t17
    inside4 = sum(v[0] for v in lint_live.values())
    log(f"  phase 17 took {took17:.1f} s (17a's {n_contracts} contracts "
        f"collected), 17b / 17c {inside4:.1f} s inside phase 4: "
        f"{took17 + inside4:.1f} s in all against the limit "
        f"{LINT_PHASE_S:.0f} s ({smi})")
    assert took17 + inside4 <= LINT_PHASE_S, (
        f"phase 17 took {took17 + inside4:.1f} s, over its "
        f"{LINT_PHASE_S:.0f} s")
    # phase 17b's launches (the linted paths of phase 4's engines, masked),
    # each beside the kernel's phase-2 row at the decode shape
    for quantize, (_, launched, _) in lint_live.items():
        for name, n in sorted(launched.items()):
            row = next(r for r in tables[name] if r["shape"] == main[name][0])
            kernels.append({
                **{k: v for k, v in row.items()
                   if k not in ("splits", "share", "tickets", "bm", "waiters",
                                "residency", "stepwise_ms")},
                "name": f"{name} (graph lint)", "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": tpu + sources[name][1], "launches": n,
                "path": f"phase 17b: lint_engine of qwen2-0.5b "
                        f"serve-{quantize}-kv8, its paths masked"})
    log(f"  the script took {time.perf_counter() - t_script:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
