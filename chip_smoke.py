#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, one nvcc per source at once;
     the tensor-core flash instances and every RG-LRU instance must not
     spill (nor may any D=80 flash instance), and the Python mirrors of
     the launch arithmetic that the CPU
     tests check must agree with the libraries' own numbers;
  3. kernels: each kernel against its plain PyTorch version on the card
     (the flash-attention cases of tests/test_kernels.py in f32, on the
     FMA kernel, and in bf16, on the tensor-core kernel, plus the serve
     prefill shapes, phase 8's shapes non-causal and causal, and the
     recurrentgemma-9b MQA shapes at head_dim 256;
     the SSD-scan cases of tests/test_kernels.py plus the mamba2-2.7b
     training shape with bf16 B/C; the RG-LRU cases of
     tests/test_kernels.py plus ragged lengths and the recurrentgemma-9b
     shape, forward and the backward's reverse mode, log_a down to -20
     and the slow decay of trained gates, the fused backward against
     autograd of the plain recurrence, and repeat calls bitwise equal),
     and, at the main paths' shapes, each kernel's time beside the plain
     version's, a library call's where one exists, and the card's bound
     (one call per CUDA-event pair, and back to back; the RG-LRU scan's
     reverse mode and fused backward too); one full-width mamba2 layer
     and one full-width rglru mixer through the kernel against the plain
     path;
  4. serve: the paper's GPT (gpt-h8192-l4, random weights from seed 0)
     through `repro_torch.launch.serve`, paged KV with quantum
     preemption evicting pages through the spool to a directory, then
     the same trace on the dense cache. Tokens and every logits row
     must be bitwise equal, every evicted page restored, the spool
     directory empty after close, and the kernel launched once per
     layer per prefill in the paged run;
  5. train: mamba2-2.7b at full width cut to 16 of its 64 layers
     (random weights from seed 0) through `repro_torch.session.TrainSession`, adamw, B=1,
     S=1024, 3 steps on the SSD-scan kernel, once with every residual
     kept on the card and once spooled to a fresh directory (fs, raw).
     Losses and final parameters must be bitwise equal, the spool run's
     peak device memory lower, bytes offloaded, every stored stage
     fetched, the directory empty after close, and the kernel launched
     once per layer per step in each run; one full-width layer through
     the kernel must agree with the plain path;
  6. policy matrix at a depth-2 cut: Recompute, Adaptive on fs and on
     mem, the mem backend and the zlib codec, each bitwise equal to
     Keep; every spool run reads blobs back (the zlib run waits for its
     layer stores before backward, so every layer goes through the codec
     both ways on the card); each adaptive plan is the one the paper's
     rule gives for the profiled stages and the calibrated write rate,
     and its steps read blobs back where it stores bytes;
  7. train: recurrentgemma-9b at full width cut to 8 of its 38 layers
     (2 super-layers of rglru, rglru, local attention and a remainder of
     two rglru blocks; random weights from seed 0) through
     `TrainSession`, sgd
     (lr 3e-4, no momentum, clip 1.0), B=1, S=2048, 2 steps on the
     RG-LRU and flash kernels, kept and spooled (fs, raw). The checks of
     phase 5, with the stage count taken from the engine (11 stages),
     and the RG-LRU kernel launched once per rglru block per step in
     forward and once in backward, the flash kernel once per attention
     block per step;
  8. train: the paper's GPT, BERT and T5 (gpt-h8192-l4, bert(8192, 4)
     and t5(8192, 4): 64 heads of 128; learned positions and
     bidirectional attention for BERT; T5 with 2 bidirectional encoder
     layers and 2 decoder layers of causal self-attention and
     cross-attention over the encoder states, its encoder reading the
     decoder's tokens; random weights from seed 0) through
     `TrainSession`, sgd (lr 3e-4, no momentum), B=4 (T5 B=8), S=1024, 3
     steps for GPT and 2 for BERT and T5 (3 before the named tiers below)
     on the flash kernel, kept and spooled (fs, raw). The checks of
     phase 5 with the stage count from the engine, which must be 6 (GPT,
     BERT) and 8 (T5: enc_embed, 2 encoder layers, enc_final, embed, 2
     decoder layers, head), and the flash kernel launched once per
     attention per step (the backward is the plain VJP): 4 for GPT and
     BERT, 6 for T5; the tracked activation peaks of both runs; the
     bytes the spool stored per stage in step 1; for GPT and BERT (and
     mamba2 in phase 5) the layer stages' saved bytes equal to the exact
     counter (`core.endurance.residual_bytes_per_layer` on the meta
     device) times the layers. Then GPT again with the chunked
     cross-entropy (`RunSettings(ce_chunk=512)`), kept and spooled:
     bitwise to each other, its spool losses within 1e-3 relative of the
     unchunked spool run's, a head stage that stores less than the
     (B, S, V) f32 logits; its stored bytes and both device peaks
     printed beside the unchunked run's. And the GPT under the memory
     tiers' names inside a layer (the jit name, 2 steps, step 1 under the
     op counter, step 2 timed outside it): (i) "save_names" of "attn_out" and "mlp_hidden" (layers
     recomputed, the two kept on the card) and (ii) "offload" of
     "blk_in", "attn_out" and "mlp_hidden" (the three in pinned host
     memory between a layer's forward and its recompute): losses and
     parameters bitwise equal to the keep run's after 2 steps, 4 flash
     launches a step (the recompute takes the held "attn_out" and
     launches no attention forward), (i)'s tracked footprint at backward
     begin remat's plus the named tensors' 1.342 GB, (ii)'s keep's less
     the layer stages' saved bytes, 1.610 GB off the card in step 1 by
     the op counter and its device peak below keep's; every pool lease back,
     nothing stored;
  9. checkpoints and tracing on the paper's GPT (gpt-h8192-l4, phase 8's
     spool settings: B=4, S=1024, sgd, fs, raw, seed 0): a traced run of
     2 steps checkpointing every 2 steps prints each step's `obs_*`
     overlap fields; its losses must be bitwise equal to phase 8's first
     two spool losses, its trace valid, with 2 `engine.step` spans, an
     `io.write` span per store and every fetch wait keyed to a read, 6
     stages fetched a step and 4 flash launches a step. Its second step
     runs under torch.profiler: the device's idle time is printed beside
     the step's exposed wait. A fresh session then restores step 2 and
     runs step 3: loss and final parameters bitwise equal to phase 8's
     third spool loss and final parameters, and its device peak equal to
     that step's (the restore writes into the session's tensors, so
     the card holds one copy of the model). The checkpoint's bytes, the
     snapshot, write and restore seconds and its filesystem are
     printed; too little free space fails the phase;
 10. storage and resilience on the paper's GPT (gpt-h8192-l4, phase 8's
     spool settings: B=4, S=1024, sgd, raw, seed 0, SpoolPolicy), traced:
     (a) `striped` over two directories, (b) `managed:2gb,fs` (a host
     bound below one step's offload), (c) `aio@8`, 2 steps each, and
     (d) the chaos run, `fault:striped` over three directories for 3
     steps with stripe device 1 killed and 3 raising reads after step 1
     (every layer's store lands before backward, so backward reads).
     Losses and final parameters must be bitwise equal to phase 8's keep
     run after as many steps, 6 stages fetched a step (in (d) fetched or
     recomputed) and 4 flash launches a step (plus one per recomputed
     layer stage), the directories empty after close; (a) writes to both
     devices at JAX's default pool idle cap and hits the pool in step 2,
     (b) demotes and is hinted without passing its host bound (its
     promotions, priced and timed as in the JAX manager, are printed),
     (c) prints whether the mount took O_DIRECT and hits the pool in
     step 2, (d) retries, falls back to recompute and rebalances, with
     device 1 down and `resilience_*` rows each step. Each run prints
     its step times, exposed wait, io_hidden_frac and pool stats; the
     copy rates between the card and a registered pool buffer at
     aligned and unaligned offsets are printed beside torch's pinned
     memory's;
 11. the optimizer state and the jit engine on the paper's GPT cut to
     1 layer (gpt-h8192-l1, random weights from seed 0, adamw with lr
     3e-4 and no clipping, B=4, S=1024, fs, raw, traced without a
     file), 2 steps: (a) the
     staged engine, KeepPolicy, the fused update (the reference); (b)
     `engine="jit"`, `host_offload="opt_state"` (the whole state staged
     through the spool between steps); (c) `engine="jit"`,
     `opt_overlap=True` (each layer updated as its gradients land in
     backward, its moments on the spool); (d) (c) with
     `host_offload="activations"` (activations on the spool too); (e)
     `opt_overlap="sync"`. (b), (c) and (e) keep their
     activations (`activation_policy="keep"`), as (a) does. Losses
     bitwise equal to (a)'s, final parameters of (b)-(d) bitwise equal
     to (a)'s ((e)'s too), and the parameters' and moments' (`materialize()`)
     fingerprints (two 64-bit weighted sums of their bits, on the card:
     a host copy of a 32 GB state per run does not fit beside the
     spool's pool) equal to (a)'s after as many steps; a flash launch
     a step; moments fetched in step 2; the spool dirs empty after
     close; (c)'s device peak at least 3.22 GB (half the layer's 6.44
     GB of moments) below (a)'s. Each run prints its step times, device
     peak, `opt_updates`, fetched / staged / skipped bytes,
     `opt_io_busy_s`, `opt_exposed_wait_s`, `opt_hidden_frac`, its
     pool's stats, the host's `free -g` and the training thread's
     `engine.opt_fetch` / `engine.opt_stage` spans. Before the runs it
     times, on the spool's filesystem, the unlink of a 4 GiB blob and the
     longest 2 GiB device allocation made while an 8 GiB registered pool
     buffer is written in 2 GiB and in 64 MiB syscalls, and alone;
 12. serve the rest: mamba2-2.7b and recurrentgemma-9b at full width
     (random weights from seed 0), each built once: the last prefill
     logits and the first decode step's logits through the kernels
     against the plain path, in an f32 copy of the weights (5e-3 abs;
     the bf16 difference is printed), then one trace (8 requests, 4
     slots, prompts of 24-48 tokens, 16 new tokens, 16-token pages,
     quantum 4) served through `make_server` / `Server` paged (fs, raw)
     and dense from the same parameters. Tokens and every logits row
     bitwise equal, every parked state (conv windows, f32 recurrent
     state, K/V pages) restored bitwise leaf by leaf, the spool
     directory empty after close, and per prefill 64 SSD calls (mamba2),
     26 RG-LRU and 12 flash calls (recurrentgemma) in each run; TTFT,
     ITL p50/p99 and decode tok/s printed. The SSD kernel against its
     plain version at the trace's prompt lengths, at 37 and at 200
     (chunk 8): y and the final state, and its time at the longest
     prompt beside its bound;
 13. the registry's archs (random bf16 weights from seed 0) through
     `TrainSession`, sgd (lr 3e-4, no momentum), S=1024, 2 steps, kept
     and spooled (fs, raw) as in phase 5: (a) qwen2.5-3b at full width
     and depth (36 layers, GQA 16/2, qkv biases, B=1), (b) gemma2-27b at
     full width cut to 2 layers (a local/global pair: window 4096,
     softcap 50, post-block norms; B=2; 4 before phase 20), (c)
     hubert-xlarge at full width cut to 12 of its 48 bidirectional
     layers (24 before phase 20; 16 heads of 80, frame
     embeddings from a seeded generator through `loader`, B=2; in f32,
     its keep run phase 17's one-device reference), (d)
     llama4-scout-17b-a16e at full width cut to 2 layers (16 experts
     top-1 plus a shared one, GQA 40/8, B=8); (b), (c) and (d) spool through
     `drained_spool_policy` (REG_TRAIN says why). Each: losses and final
     parameters bitwise equal, the engine's stage count, every stored
     stage fetched, the spool dir empty, the tracked activation peak and
     the device peak lower when spooled, one flash launch per attention
     block per step, and each layer stage's saved bytes equal to the
     exact counter times the layers. (e) qwen2.5-3b at full width served
     as phase 12 serves (8 requests, 4 slots, prompts 24-48, 16 new
     tokens, quantum 4, fs, raw): tokens and logits paged vs dense
     bitwise, 36 flash launches per prefill, the first logits through
     the kernel within 5e-3 of the plain path in an f32 copy of the
     weights and within phase 4's 0.25 in the served bf16 weights
     (0.0625 on an H100 80GB HBM3 at 700 W). Phase 3 holds the instances
     these runs launch (D=80 in f32 and bf16, hubert's non-causal (2,
     1024, 16, 80), qwen's and llama4's GQA (1, 1024, 16/2 and 40/8,
     128), gemma2's window and softcap at S=8192) against the plain
     attention with their times;
 14. llama-3.2-vision-90b at full width cut to 15 layers (three
     periods: three layer stages of four self-attention blocks and a
     cross block over 1024 patch embeddings; random bf16 weights from
     seed 0, batches of `data.pipeline.vision_batches`), sgd (lr 3e-4,
     no momentum), B=1, S=1024, 2 steps (3 before phase 8's named tiers):
     (a) kept and spooled (fs, raw)
     through `drained_spool_policy`, with phase 13's checks (6 stages:
     vlm_enc, embed, 3 layers, head; 15 flash launches a step); (b) the
     jit name under `activation_policy="offload"`, the host tier (layers
     recomputed, their inputs in pinned host memory between forward and
     backward): losses and parameters bitwise equal to (a)'s keep run,
     30 flash launches a step, its tracked footprint at backward begin
     keep's less the layers' saved bytes, its tracked and device peaks
     below keep's, nothing stored; (c) a 48-token prefill with its patch
     embeddings (15 flash launches), then 16 tokens through
     `decode_step` and `decode_step_paged` (16-token pages, the cross
     K/V resident): tokens and logits bitwise equal, the cross entries
     unwritten, the first logits through the kernel within phase 4's
     0.25 of the plain path in bf16 and within 5e-3 in an f32 copy of
     the weights. Phase 3 holds its self- and cross-attention instances
     (B=1, 1024 x 1024, 64 / 8 heads of 128) with their times;
 15. meshes (slice 12a): the paper's GPT at full width cut to 2 layers
     (gpt-h8192-l1, f32, sgd, B=2, S=1024, 2 steps, the jit engine, fs
     spool dirs): (a) one device, keep, in this process; then one spawn
     of 2 ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
     device; CUDA tensors are staged through pinned host memory) runs
     (b) a 1x2 mesh (tp=2), keep; (c) 1x2, the layers spooled; (d) (c)
     again; (e) 1x2 with hooks and model over dp only (the model axis
     one replica group, replica dedup across the two processes); (f)
     (e) without dedup; (h) 1x2 with adamw (lr 3e-4, no clipping), keep,
     the fused update on each rank's ZeRO-1 shards; (i) (h) with the
     optimizer overlap (each layer updated as its gradient shards land,
     its moments on each rank's spool, leases `opt{step}L{stage}/s{rank}`
     in the shared dir); (g) a 2x1 mesh (dp=2, fsdp + ZeRO-1), keep,
     that starts from the checkpoint (b) wrote after step 1 (the logical
     arrays, gathered over the ranks and written by rank 0; each (g)
     rank restores its shards in place) and runs step 2. (b) and (g)
     within 1e-4 of (a) ((g)'s step-2 loss against (a)'s); (c) = (b),
     (d) = (c), (i) = (h) (losses, final parameters and the moments'
     fingerprints), and (e) = (a) and (f) = (e), bitwise ((e) runs (a)'s
     computation on each rank: tp=None replicates the model); (c)'s
     shards 0 and 1 each with 2 offloads and fetches and bytes in = out;
     (e) shard 0 only, 2 offloads, 4 fetches, 2 replica skips, half the
     bytes handed to the spool of (f); every spool dir empty and the
     checkpoint dir removed; 2 flash launches per rank and run (1 in
     (g)); each rank's tracked activation peak lower in (c) than in (b).
     The flash kernel at the tp-local shape (2, 1024, 32, 128), in f32
     (the path's) and bf16, against its plain version at phase 3's bars,
     with its times. Prints each rank's device peaks beside (a)'s, the
     backend and the bytes staged through host memory, the checkpoint's
     bytes, save and restore seconds, and the phase's time. `python3
     chip_smoke.py --mesh-only` runs phases 1-3's device line and build,
     then this phase and phases 16 to 18;
 16. expert parallelism, the GPipe pipeline and the int8 compressed dp
     mean (slice 12b part 1): llama4-scout-17b-a16e at full width (40/8
     heads of 128, 16 experts of 5120 -> 8192 top-1 and the shared
     expert, vocab 202048) cut to 1 layer (4.27 B parameters), f32, sgd,
     B=1, S=1024, 2 steps, the jit engine: (a) one device, keep, in this
     process, which ends and frees the card before the ranks allocate;
     then one spawn of 2 ranks sharing cuda:0 over gloo runs (b) a 1x2
     mesh (tp=2: 8 experts a rank, dropless, the shared expert column /
     row parallel), keep; (c) (b) with the layers spooled; (d)
     `ep_axis="model"` at capacity factor 16 (E/k: every local row has
     its slot); (e) `ep_axis="model"` at 1.25, kept, and (e2) spooled;
     (f) GPipe of gpt-h8192 cut to 2 layers on a ("pipe",) mesh of 2, one
     layer a rank, f32, 4 microbatches of 1x1024 through the transformer
     block on the flash kernel, against the 2 layers in sequence on the
     rank; (g) the compressed and the exact mean over a ("data",) mesh
     of 2 of each rank's stage gradients from (f) (one gpt-h8192 layer's),
     then 16 error-feedback rounds; and (a) again, in this process, on
     the host tier of "moe_hidden" (the experts' hidden, (16, 1024,
     8192) f32, in pinned host memory between the layer's forward and its
     recompute), step 1 under the op counter, step 2 timed outside it:
     losses and parameters bitwise equal to (a)'s, 536.9 MB held a step
     and off the card in step 1 by the op counter, 2 flash launches a
     step (the recompute launches the kernel again), every pool lease
     back; then (a) under remat, bitwise equal to (a), its device peak
     and step 2 printed beside the tier's. (b)'s losses within 1e-4 of (a)'s,
     and its first-step gradients within 1e-4 of (a)'s shards of them
     (at 65536 seeded positions a leaf, over (a)'s largest magnitude);
     (c) = (b), (d) = (b) and (e2) = (e) bitwise in losses and
     parameters; no row dropped in (a)-(d) (the model's own count,
     `moe.dropped_rows`), (e)'s dropped rows printed; (c)'s and (e2)'s
     shards 0 and 1 each with 2 offloads and fetches, bytes in = out;
     spool dirs empty; (c)'s tracked activation peak under (b)'s; 2 flash
     launches a rank a run; (f) outputs within 1e-5 and the stage's
     gradients within 1e-4 of the sequential run (largest difference
     over the largest magnitude; bitwise or not printed), 4 flash
     launches a stage; (g) within 5% of the exact mean and the 16 rounds'
     mean nearer than one round's. Phase 3's table gains the flash
     kernel at llama4's one-device shape (1, 1024, 40/8, 128) f32 and
     its tp=2 shape (1, 1024, 20/4, 128) f32, kimi's tp=4 shape (1, 1024,
     16/2, 128) bf16 and the stage's (1, 1024, 64, 128) f32, each
     against its plain version with its times. `python3
     chip_smoke.py --kimi-4card` (four cards) runs the device line, the
     build, then kimi-k2-1t-a32b at full width cut to 2 layers (the
     leading dense layer and one MoE layer of 384 experts), bf16, sgd,
     B=1, S=1024, 3 steps, on a 1x4 mesh over NCCL, one rank a card:
     dropless and at `ep_axis="model"` capacity factor 1.25, each kept
     and spooled, bitwise;
 17. hubert and llama-3.2-vision on a mesh (slice 12b part 2), sgd (lr
     3e-4), S=1024, 2 steps, the jit engine, each (b) kept and (c)
     spooled (fs, one dir the ranks share) on a 1x2 mesh of 2 ranks
     sharing cuda:0 over gloo: hubert-xlarge at full width cut to phase
     13's 12 layers (8 of 16 heads of 80 a rank, `frontend_proj`
     column-parallel with its width gathered), f32, B=2, its (a) phase
     13's keep run;
     llama-3.2-vision-90b at full width cut to one period (5 layers: four
     self-attention blocks and a cross block over the 1024 patch
     embeddings, column-parallel q/k/v and row-parallel wo; 6.4 B
     parameters), bf16, B=1, its (a) one device, keep, in this process,
     ended before the ranks allocate. hubert's (b) within 1e-4 of (a) and
     each rank's tracked activation peak lower in (c); both families (c)
     = (b) in losses and parameters' fingerprints, each shard storing and
     fetching every layer stage once a step, spool dirs empty, and one
     flash launch per attention block per step (96 a rank a run for
     hubert, 10 for vision: 4 self, 1 cross a step); the vision model's
     one-device losses printed beside the mesh's (bf16 sums in another
     order: no bar). Phase 3's table gains the flash kernel at hubert's
     one-device f32 shape (2, 1024, 16, 80) and its tp=2 rank's (2, 1024,
     8, 80) f32, and at a vision tp=2 rank's (1, 1024, 32/4, 128) bf16,
     causal and not, each against its plain version with its times;
 18. mamba2, recurrentgemma and T5 on a mesh (slice 12b part 3), in
     phase 17's spawn, f32, sgd (lr 3e-4), S=1024, 2 steps, the jit
     engine, each (b) kept and (c) spooled (fs, one dir the ranks share)
     on the 1x2 mesh, its (a) one device, keep, in this process, ended
     before the ranks allocate: mamba2-2.7b at full width cut to 8 layers
     (40 of 80 SSM heads of 64 a rank, state 128: the SSD kernel on each
     rank's heads, `w_zx` and the conv laid out by heads, B and C whole),
     B=2; recurrentgemma-9b at one period (rglru, rglru and the MQA block,
     2048 of the 4096 RG-LRU channels a rank, the gates' input gathered),
     B=1; the paper's T5 at hidden 8192, t5(8192, 4) (2 encoder layers,
     then 2 decoder layers of self- and cross-attention), B=1. (b) within 1e-4
     of (a), (c) = (b) in losses and parameters' fingerprints, each shard
     storing and fetching every layer stage once a step, spool dirs
     empty, each rank's tracked activation peak lower in (c), and each
     rank's launches a run exact (16 SSD calls; 8 RG-LRU wrapper calls and
     2 flash; 12 flash for T5: its 2 encoder layers, 2 decoder layers'
     self- and cross-attention). Phase 3's table gains the SSD scan at a
     rank's (2, 1024, 40, 64) with f32 B/C (2, 1024, 128), the RG-LRU
     forward and fused backward at (1, 1024, 2048), and flash at
     recurrentgemma's rank (1, 1024, 8/1, 256, window 2048) and T5's (1,
     1024, 32, 128), non-causal and causal, all f32, each against its
     plain version with its times;
 19. the dry run against the card (`repro_torch.launch.{steps,op_stats,
     dryrun}`): each prediction is the dry run's count on the meta
     device of the same step and placement; the card runs the step once
     under the same counter and is timed on separate uncounted steps.
     (a) gpt-h8192-l4 at phase 8's shape (B=4, S=1024, bf16, sgd)
     through `make_train_step` on one device (the host tier: each layer
     forward and recomputed, 8 flash launches a step): FLOPs, host bytes
     and products equal to the prediction, the allocator's peak within
     15% of the traced peak; its step time, mfu (6 N_active tokens over
     t_step x PEAK_FLOPS_BF16) and t_compute / t_step printed. (b) a
     prefill at (1, 1024) (4 flash launches) and a decode over a
     1024-token cache: FLOPs equal. (c) mamba2-2.7b at 4 layers and
     recurrentgemma-9b at one period, B=1, S=1024, one step each: FLOPs
     equal and the SSD / RG-LRU calls the dry run counts. (d) in phase
     15's spawn: each rank's `Comm` counters over one step of its model
     through `make_train_step` equal a `DryComm`'s of that rank, op by
     op, in calls and result bytes. (e) a bf16 8192^3 matmul and a 4
     GiB device copy, printed beside PEAK_FLOPS_BF16 and HBM_BW; no rate
     above 1.05x its constant. (f) `python -m repro_torch.launch.dryrun
     --arch qwen2.5-3b --shape train_4k --mesh single` exits 0 with
     status ok; its dominant term and t's printed;
 20. serving on a mesh (`launch/steps.py::make_prefill_step` /
     `make_decode_step`, ROADMAP item 22), random f32 weights from seed
     0, run in phase 15's spawn ((a) in this process after phase 15's,
     once the ranks have joined their process group, (b) and (c) in its
     2 ranks after theirs) and checked after phase 19:
     gpt-h8192 at 2 layers, B=2, a
     prefill of 1008 tokens into a cache of 1024 and 16 decode steps
     teacher-forced with (a)'s greedy tokens, as (a) one device, (b) a
     1x2 mesh (TP-only weights, 32 of 64 heads a rank) and (c) a 2x1 mesh,
     where its 9.74 GB are over SERVE_TP_ONLY_BUDGET and the weights are
     fsdp (each layer gathered before it runs; 2 decode steps); mamba2-
     2.7b at 4 layers and recurrentgemma-9b at one period, B=1, a prompt
     of 1024 tokens and 16 decode steps, as (a) and (b). Each rank's
     logits (prefill's last and every decode step's) and its caches
     gathered after prefill within 1e-4 of (a)'s over the largest
     magnitude; each run's prefill launches (2 flash for gpt, 4 SSD
     calls, 2 RG-LRU forwards and 1 flash) and FLOPs equal to its meta
     trace's, and each rank's collectives over the prefill and the first
     decode step equal a `DryComm`'s over the same steps traced on the
     meta device, in calls and bytes by op and group size; (c)'s device
     peak under (a)'s and under its shard plus every gathered leaf. The
     time to first token (a second prefill, outside the op counter), the
     decode time a token and the bytes staged through host memory are
     printed, with no bar. Phase 3's table gains
     the flash kernel at gpt's ragged prompt at a tp=2 rank's (2, 1008,
     32, 128) and under fsdp (1, 1008, 64, 128), and the SSD scan at a
     rank's (1, 1024, 40, 64), f32, each against its plain version;
 21. a `kernels` JSON line, the nvidia-smi line, and the result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# cuBLAS picks a reduction split per call unless its workspace is pinned:
# the keep/spool parity of phases 5-6 needs one order (set before any
# CUDA context exists)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# growable segments in place of fixed ones: phase 13's llama4-scout keep
# run at B=8 holds 70.5 GB allocated, and with fixed segments it ran out
# of the card's 79 GiB with 17 GiB reserved but free between them (on an
# H100 80GB HBM3 at 700 W)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch.mesh import H100_PEAKS, peaks_for  # noqa: E402
ARCH = "gpt-h8192-l4"
SERVE_ARGS = ["--arch", ARCH, "--seed", "0", "--device", "cuda",
              "--cache", "paged", "--batch", "4", "--requests", "12",
              "--prompt-len", "1024", "--max-new", "24",
              "--cache-len", "1056", "--page-tokens", "16", "--quantum", "8",
              "--kv-backend", "fs", "--kv-codec", "raw"]

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): tests/test_kernels.py
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (2, 64, 64, 4, 1, 32, True, 0, 0.0),
    (1, 128, 128, 2, 2, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),
    (1, 96, 96, 2, 2, 32, True, 0, 0.0),
    (1, 16, 16, 2, 2, 128, True, 0, 0.0),
]
TOL_F32 = 2e-5
# bf16 attention against the f32 reference, per row: 2^-6 of the row's
# largest |output|. The output's own bf16 rounding is at most 2^-8 of it,
# and the tensor-core kernel's bf16 P adds about as much again (the
# source's header note); a mask a few keys off, or a coarser P, breaks it
TOL_BF16_ROW = 2 ** -6
# full-width prefill logits, kernel vs plain attention path: both bf16
# models, so they differ by bf16 roundings of the attention output that
# propagate through 4 layers (4 bf16 ulps at |logit| ~ 8)
TOL_E2E = 0.25

# (B, S, H, P, N, chunk): tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (2, 96, 2, 16, 8, 32),
]
TOL_SSD = 2e-4
# the training shape with bf16 B/C: kernel and plain version read the same
# bf16 values and both sum in f32, so only the order of the N=128 and
# Q=128 sums differs; relative to the output's scale
TOL_SSD_PATH = 1e-5
# one full-width mamba2 layer, kernel vs plain scan: bf16 outputs, so one
# or two bf16 roundings (2**-7 relative) of the output's scale
TOL_LAYER = 2 ** -6
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ = "mamba2-2.7b", 3, 1024
# phase 7's steps, cut from TRAIN_STEPS to make room for phase 17 (its
# checks hold at any step count; the launches scale with it)
RG_STEPS = 2
# phase 6's depth (8 until PR 21; cut to 4 in PR 22 to make room for
# phase 13, and to 2 in PR 25 after the whole script took 1174 s of its
# 1200 on an H100 80GB HBM3 at 700 W; its bounds scale with it)
MATRIX_DEPTH = 2

# (B, S, W): tests/test_kernels.py::RGLRU_CASES (their chunk and block
# width are the Pallas kernel's tiling, which the CUDA kernel has not)
RGLRU_CASES = [(1, 64, 16), (2, 128, 32), (1, 100, 8)]
TOL_RGLRU = 1e-5
TOL_RGLRU_GRAD = 5e-4     # the JAX package's RG-LRU gradient bar
# recurrentgemma-9b's attention at head_dim 256: (B, S, Hq, Hkv, D,
# causal, window, dtype, tol); the path's shape (window 2048 masks
# nothing at S=2048), a window that masks at S=4096, and an f32 case
FLASH_D256_CASES = [
    (1, 2048, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 4096, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 512, 16, 1, 256, True, 128, torch.float32, TOL_F32),
]
RG_ARCH, RG_SEQ, RG_LR, RG_CLIP = "recurrentgemma-9b", 2048, 3e-4, 1.0
# phases 5 and 7 train at full width cut in depth (to make room for
# phases 15 and 17, after the whole script took 1131.7 s of its 1200 on
# an H100 80GB HBM3 at 700 W, and again for phases 18 and 20):
# mamba2-2.7b to TRAIN_LAYERS of its 64 layers (32 before phase 18; at 8
# the adamw update, not the activations, sets both runs' device peak,
# 10.29 GB), recurrentgemma-9b to RG_LAYERS of its 38 (2 super-layers
# and the remainder of two rglru blocks; 26 before phase 18, 14 before
# phase 20); their checks scale with the depth
TRAIN_LAYERS, RG_LAYERS = 16, 8
# the paper's GPT, BERT and T5 at its first scenario (§4.2): hidden 8192,
# 4 layers, S=1024, sgd without momentum; B=4 keeps the phase short (the
# paper's micro-batch of 16 runs in benchmarks/torch_fig10.py --paper).
# T5 runs at B=8: at B=4 its device peak, kept or spooled alike, is set at
# the end of backward by its parameters, its full gradients and the last
# encoder layer's backward (33.29 GB both ways on an H100 80GB HBM3 at
# 700 W), where no activation is left to spool; at B=8 its activations
# set the peak
PAPER_HIDDEN, PAPER_LAYERS, PAPER_SEQ, PAPER_BATCH = 8192, 4, 1024, 4
T5_BATCH = 8
PAPER_LR = 3e-4
# phase 8's BERT and T5 run PAPER_SHORT_STEPS steps (3 before the named
# tiers, to make room for them: T5's third spooled step took 9.8 s, the
# named tiers' three runs 10.6 s on an H100 80GB HBM3 at 700 W); the GPT
# keeps TRAIN_STEPS, which phases 9 and 10 resume and replay
PAPER_SHORT_STEPS = 2
# phase 8's named tiers: the GPT's runs (i) "save_names" of NAMED_GPT and
# (ii) "offload" of "blk_in" and NAMED_GPT, NAMED_STEPS steps each, held
# to its keep run after as many steps
NAMED_GPT, NAMED_STEPS = ("attn_out", "mlp_hidden"), 2
# the idle cap of the spool's aligned pool in every spool run but phase
# 10's striped one (which keeps the default): three
# blobs of the largest class (a recurrentgemma-9b stage, ~1.5 GB, is in
# the 2 GiB class; a phase 8 GPT stage at B=4, ~0.85 GB, in the 1 GiB
# one), so released leases are reused, not unmapped and registered anew
POOL_BYTES = 6 << 30
# phase 10: the managed backend's host bound, below one step's offload
# (~5 GB at B=4), so blobs are demoted to the SSD tier
STORAGE_HOST_BOUND = "2gb"
# phase 11: adamw on the paper's GPT cut to OPT_LAYERS layers (4 at
# first; cut to 2 to make room for phase 13, and to 1 to make room for
# phases 15 and 17); (e), the sync drain, runs 2 steps. (c)'s
# device peak must fall by half the layers' moments (OPT_DROP_GB: a
# layer of 12 * 8192**2 parameters, m and v in f32, halved: 3.22 GB), so
# a design that holds a whole layer's moments on the card at once fails.
# (b) can have two state blobs on disk at once: OPT_FREE_GB of free space
OPT_LAYERS = 1
# 2 steps (3 took 250 s on an H100 80GB HBM3 at 700 W with the spool on
# 9p; cut to make room for phase 16): (e) then runs as many as the
# others, and its parameters are held to (a)'s too
OPT_STEPS, OPT_SYNC_STEPS = 2, 2
OPT_FREE_GB = 45
# phase 8's chunked-CE runs: the JAX package's `make_train_step` default,
# and the bar on their losses against the unchunked ones (the order of
# the sum changes; 3 sgd steps)
CE_CHUNK, TOL_CE_CHUNK = 512, 1e-3
# phase 12: the first logits through the kernels against the plain path,
# in an f32 copy of the served weights, where the two differ by the order
# of f32 sums (64 layers of mamba2-2.7b: 1.3-1.4e-4 at S=40, logit std
# 0.89, on an H100 80GB HBM3 at 700 W); in the served bf16 weights
# recurrentgemma-9b is held to TOL_E2E (0.15-0.16 there), mamba2-2.7b
# only printed: its 64 layers differ by 0.53-0.73, the rounding of each
# layer's output amplifying that order through the depth
TOL_E2E_F32 = 5e-3
# phase 12: the serving trace of mamba2-2.7b and recurrentgemma-9b (its
# prompt lengths are drawn in [24, 48], so the SSD scan's chunk is the
# prompt length), and two more lengths for the SSD and flash kernels: an
# odd one, and one above 128 that is no multiple of it (SSD chunk 8;
# flash's last query and key tiles partial)
REST_SERVE = dict(requests=8, slots=4, prompt_len=48, max_new=16,
                  cache_len=64, page_tokens=16, quantum=4)
SERVE_EXTRA = (37, 200)
OPT_DROP_GB = 3.22
# phase 13: the registry's archs, (arch, layers (None: the config's),
# batch), sgd without momentum at PAPER_LR, S=1024, REG_STEPS steps;
# then the serving trace of phase 12 on REG_SERVE at full width. The runs
# cut in depth spool through `drained_spool_policy`: 2-4 layers run
# forward faster than 9p writes one of their 1.5-5 GB blobs, so without
# the wait every store of steps 2-3 is still in flight at backward and
# its tensors are forwarded from the card, as if kept. llama4-scout runs
# at B=8, the least batch at which its activations set the device peak
# (on an H100 80GB HBM3 at 700 W): at B=1 the sgd update's f32 copies of
# its stacked expert weights set it (36.71 GB kept and spooled); at B=4
# the last layer's backward, which holds the whole stacked gradient tree
# (8.8 GB) beside that layer's activations in both runs (48.58 GB both
# ways); from B=7 the first layer's backward, where keep also holds the
# other layer's activations (1.4 GB a sample), is the higher
REG_TRAIN = [("qwen2.5-3b", None, 1), ("gemma2-27b", 2, 2),
             ("hubert-xlarge", 12, 2), ("llama4-scout-17b-a16e", 2, 8)]
# phase 13 trains these in f32: hubert-xlarge's keep run is then phase
# 17's one-device reference (a), which phase 17 need not run again
REG_F32 = ("hubert-xlarge",)
REG_SEQ = 1024
# the steps of phase 13's runs, cut from 3 to make room for phase 16 (its
# checks hold at any step count; the launches scale with it)
REG_STEPS = 2
REG_SERVE = "qwen2.5-3b"
# phase 3: the flash instances phase 13 launches, (label, (B, Sq, Skv,
# Hq, Hkv, D, causal, window, cap), dtype, tol): D=80 at a ragged length
# in both dtypes, then the path shapes; gemma2's at S=8192, where its
# 4096 window masks (at S=1024 it never does)
REG_FLASH_CASES = [
    ("d80 ragged", (1, 96, 96, 2, 2, 80, True, 0, 0.0), torch.float32,
     TOL_F32),
    ("d80 ragged", (1, 96, 96, 2, 2, 80, True, 0, 0.0), torch.bfloat16,
     TOL_BF16_ROW),
    ("hubert-xlarge", (2, 1024, 1024, 16, 16, 80, False, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
    ("hubert-xlarge f32", (2, 1024, 1024, 16, 16, 80, False, 0, 0.0),
     torch.float32, TOL_F32),
    ("qwen2.5-3b", (1, 1024, 1024, 16, 2, 128, True, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
    ("llama4-scout", (1, 1024, 1024, 40, 8, 128, True, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
    ("gemma2-27b S=8192", (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
     torch.bfloat16, TOL_BF16_ROW),
]
# phase 14: llama-3.2-vision-90b at full width cut to VISION_LAYERS
# layers, three periods: three layer stages of four self-attention
# blocks and a cross block each; random bf16 weights from seed 0, sgd at
# PAPER_LR, S=REG_SEQ, VISION_STEPS steps. A layer stage saves 1.69 GB a
# sample (the exact counter). With two stages the device peak sits in
# the last backward stage, beside the whole stacked gradient tree, where
# keep and spool hold the same tensors (72.67 GB both at 10 layers and
# B=5, on an H100 80GB HBM3 at 700 W); two stages' activations would rise
# above it only from B=11, which does not fit. With three, the middle
# stage's backward holds that tree and, kept, two stages' activations:
# at B=1 the activations set the peak (29.9 GB of parameters). Then
# decode: a VISION_PROMPT-token prompt with its patch embeddings,
# VISION_NEW tokens dense and paged (pages of VISION_PAGE tokens)
VISION_ARCH = "llama-3.2-vision-90b"
VISION_LAYERS = 15
VISION_BATCH = 1
# its training steps (TRAIN_STEPS, 3, before phase 8's named tiers)
VISION_STEPS = 2
VISION_PROMPT, VISION_NEW, VISION_PAGE = 48, 16, 16
# phase 3 adds the vision layers' flash instances at that batch: causal
# self-attention and the cross-attention over the 1024 patch embeddings
REG_FLASH_CASES += [
    (f"vision {kind}", (VISION_BATCH, 1024, 1024, 64, 8, 128,
                        kind == "self", 0, 0.0), torch.bfloat16,
     TOL_BF16_ROW) for kind in ("self", "cross")]
# the attention of phase 8's GPT and BERT: (B, S, H, D); BERT's is
# bidirectional, GPT's causal; T5's both, at its batch (its encoder
# input has the decoder's length, so cross-attention has this shape too)
BERT_ATTN = (PAPER_BATCH, PAPER_SEQ, PAPER_HIDDEN // 128, 128)
T5_ATTN = (T5_BATCH,) + BERT_ATTN[1:]

# Published dense peaks (NVIDIA data sheets): memory bytes/s, and
# operations/s for bf16 on the tensor cores and f32 on the CUDA cores.
# phase 15: meshes on the one card: the paper's GPT (gpt-h8192) cut to
# MESH_LAYERS layers in f32, sgd, B=MESH_BATCH, S=PAPER_SEQ, MESH_STEPS
# steps; 2 ranks share cuda:0 over gloo. B=4 and 3 steps took 144.1 s
# (measured on one H100); B=2 and 2 steps keep the phase in its 100 s;
# one layer (two before phase 18) makes room for phase 18: its checks
# scale with the depth
MESH_LAYERS, MESH_BATCH, MESH_STEPS, MESH_RANKS = 1, 2, 2, 2
# the flash instance a tp=2 rank launches: (B, S, H / 2, D)
MESH_ATTN = (MESH_BATCH, PAPER_SEQ, PAPER_HIDDEN // 128 // 2, 128)
# (b) and (g) against (a): the JAX package's GSPMD bar
# (tests/test_multidevice.py:233)
TOL_MESH = 1e-4
# phase 16: expert parallelism, the GPipe pipeline and the int8
# compressed dp mean. llama4-scout at full width (40/8 heads of 128, 16
# experts of 5120 -> 8192 and the shared one, vocab 202048) cut to
# MOE_LAYERS layer, f32 (the GSPMD bar applies to f32), sgd, B=1,
# S=PAPER_SEQ, MOE_STEPS steps: 4.27 B parameters, 17.1 GB, so (a) on one
# device ends and frees the card before the 2 ranks allocate. (e) runs
# the expert-parallel capacity path at MOE_DROP_CAP (JAX's default).
MOE_ARCH, MOE_LAYERS, MOE_STEPS, MOE_DROP_CAP = \
    "llama4-scout-17b-a16e", 1, 2, 1.25
# (b)'s first-step gradients against (a)'s cut by the specs, at
# GRAD_SAMPLES seeded positions of each leaf's shard (every entry of a
# smaller leaf), each within TOL_MESH of (a)'s largest magnitude
GRAD_SAMPLES = 1 << 16
# (f): gpt-h8192 cut to PIPE_LAYERS layers, one a stage, PIPE_M
# microbatches of (1, PAPER_SEQ); the outputs and each stage's gradients
# against the layers in sequence on one device, each as its largest
# difference over the reference's largest magnitude, at JAX's bars
# (tests/test_multidevice.py:97-114)
PIPE_LAYERS, PIPE_M = 2, 4
TOL_PIPE_OUT, TOL_PIPE_GRAD = 1e-5, 1e-4
# (g): one round of the compressed mean within TOL_COMP of the exact mean
# (on its scale), and COMP_ROUNDS error-feedback rounds nearer than one
# (tests/test_multidevice.py:116-138)
COMP_ROUNDS, TOL_COMP = 16, 0.05
# `--kimi-4card`: kimi-k2 at full width cut to KIMI_LAYERS layers (the
# leading dense layer and one MoE layer of 384 experts), bf16, sgd, B=1,
# S=PAPER_SEQ, KIMI_STEPS steps, on a 1xKIMI_RANKS mesh over NCCL, one
# rank a card
KIMI_ARCH, KIMI_LAYERS, KIMI_STEPS, KIMI_RANKS = "kimi-k2-1t-a32b", 2, 3, 4
# phase 16's flash instances: llama4 on one device ((a): 40/8 heads, f32)
# and at tp=2 (20/4 heads a rank, f32), kimi at tp=4 (16/2 heads a rank,
# bf16) and the pipeline's stage (64 heads, f32), all causal
MOE_FLASH_CASES = [
    ("llama4 one device", (1, 1024, 1024, 40, 8, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
    ("llama4 tp=2", (1, 1024, 1024, 20, 4, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
    ("kimi tp=4", (1, 1024, 1024, 16, 2, 128, True, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
    ("pipeline stage", (1, 1024, 1024, 64, 64, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
]
# phase 17: the families on a 1x2 mesh of MESH_RANKS ranks sharing the
# card over gloo, sgd at PAPER_LR, S=REG_SEQ, MESH_STEPS steps (phase 13's
# REG_STEPS): hubert-xlarge at full width in f32 cut to phase 13's depth
# (12 of its 48 layers since phase 20 came, 24 since phase 18; phase
# 13's keep run, in f32
# too, is its one-device (a)), and llama-3.2-vision-90b
# at full width cut to one period (FAMILY_VISION_LAYERS layers: four
# self-attention blocks and a cross block, 6.4 B parameters) in bf16 (in
# f32 two ranks' parameters, gradients and the update's copies do not
# fit on one card)
FAMILY_HUBERT, FAMILY_VISION = "hubert-xlarge", "llama-3.2-vision-90b"
FAMILY_VISION_LAYERS = 5
FAMILY_BATCH = {FAMILY_HUBERT: 2, FAMILY_VISION: 1}
# phase 17's flash instances, a tp=2 rank's shapes: hubert's 8 of 16
# heads of 80 (f32, bidirectional), the vision model's 32 of 64 query
# and 4 of 8 kv heads of 128 (bf16), causal self-attention and the cross
# block's attention over the 1024 patch embeddings
FAMILY_FLASH_CASES = [
    ("hubert tp=2", (2, 1024, 1024, 8, 8, 80, False, 0, 0.0),
     torch.float32, TOL_F32),
    ("vision self tp=2", (1, 1024, 1024, 32, 4, 128, True, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
    ("vision cross tp=2", (1, 1024, 1024, 32, 4, 128, False, 0, 0.0),
     torch.bfloat16, TOL_BF16_ROW),
]

# phase 18: mamba2, recurrentgemma and T5 on the 1x2 mesh of phase 17's
# spawn, f32 (the GSPMD bar), sgd at PAPER_LR, S=REG_SEQ, MESH_STEPS
# steps, at full width cut in depth (REC_LAYERS): mamba2-2.7b to 8 of its
# 64 layers (80 SSM heads of 64, 40 a rank; state 128), B=2;
# recurrentgemma-9b to one period (rglru, rglru and the MQA attention
# block; W=4096, 2048 a rank; 16/1 heads of 256, window 2048), B=1; the
# paper's T5 at hidden 8192, t5(8192, REC_LAYERS[REC_T5]) (its encoder
# and decoder layers), B=1. Each (a) one device, keep, in this process
REC_MAMBA, REC_RG, REC_T5 = "mamba2-2.7b", "recurrentgemma-9b", "t5"
REC_ARCHS = (REC_MAMBA, REC_RG, REC_T5)
REC_LAYERS = {REC_MAMBA: 8, REC_RG: 3, REC_T5: 4}
REC_BATCH = {REC_MAMBA: 2, REC_RG: 1, REC_T5: 1}
# phase 18's kernel instances, a tp=2 rank's shapes: the SSD scan over 40
# of mamba2's 80 heads at B=2 (f32 B and C: strided views of the conv
# output, 2560 x channels then 128 + 128), the RG-LRU scan over 2048 of
# the 4096 channels, forward and fused backward, and flash at
# recurrentgemma's 8 of 16 query heads over its one kv head (window 2048)
# and T5's 32 of 64 heads (non-causal: encoder and cross; causal: the
# decoder's self-attention), all f32
REC_SSD = (REC_BATCH[REC_MAMBA], REG_SEQ, 40, 64, 128, 2560)
REC_RGLRU = (REC_BATCH[REC_RG], REG_SEQ, 2048)
REC_FLASH_CASES = [
    ("recurrentgemma tp=2", (1, 1024, 1024, 8, 1, 256, True, 2048, 0.0),
     torch.float32, TOL_F32),
    ("t5 tp=2", (1, 1024, 1024, 32, 32, 128, False, 0, 0.0),
     torch.float32, TOL_F32),
    ("t5 self tp=2", (1, 1024, 1024, 32, 32, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
]

# phase 20: serving on a mesh through `make_prefill_step` /
# `make_decode_step`, random f32 weights from seed 0 (the GSPMD bar), the
# mesh ranks of phase 15 (2 sharing the card over gloo): gpt-h8192 at 2
# layers, B=2, a prefill of 1008 tokens into a cache of 1024, then
# SM_NEW decode steps teacher-forced with (a)'s greedy tokens, as (a) one
# device, (b) on 1x2 (TP-only) and (c) on 2x1, where its 9.74 GB exceed
# SERVE_TP_ONLY_BUDGET (8 GiB) and the weights are fsdp: each layer
# gathered over gloo before it runs, 3.2 GB a layer staged through host
# memory, so (c) decodes SM_FSDP_NEW steps; mamba2-2.7b at 4 layers and
# recurrentgemma-9b at one period, B=1, a prompt of 1024 tokens into a
# cache of 1040, as (a) and (b)
SM_GPT = "gpt-h8192-l2"
SM_ARCHS = (SM_GPT, REC_MAMBA, REC_RG)
SM_LAYERS = {SM_GPT: 2, REC_MAMBA: 4, REC_RG: 3}
SM_BATCH = {SM_GPT: 2, REC_MAMBA: 1, REC_RG: 1}
SM_PROMPT = {SM_GPT: 1008, REC_MAMBA: 1024, REC_RG: 1024}
SM_NEW, SM_FSDP_NEW = 16, 2
SM_CACHE = {a: max(1024, SM_PROMPT[a] + SM_NEW) for a in SM_ARCHS}
# the flash and SSD instances phase 20's ranks launch that no earlier
# phase checks: gpt's prompt of 1008 at tp=2 (32 of 64 heads, B=2) and
# under fsdp (64 heads, B=1), and mamba2's 40 heads at B=1 (phase 18
# holds recurrentgemma's rank shapes); all f32, causal
SM_FLASH_CASES = [
    ("gpt serve tp=2", (2, 1008, 1008, 32, 32, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
    ("gpt serve fsdp", (1, 1008, 1008, 64, 64, 128, True, 0, 0.0),
     torch.float32, TOL_F32),
]
SM_SSD = (1, 1024, 40, 64, 128, 2560)

# the cards' datasheet peaks: one table, the dry run's
# (`repro_torch/launch/mesh.py`)
PEAKS = H100_PEAKS


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)



def time_ms(fn, runs=30, warmup=3):
    """Median over `runs` of one call timed with CUDA events (the host's
    launch overhead included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_back_to_back_ms(fn, runs=30, batch=10):
    """Median over `runs` CUDA-event pairs, each around `batch` calls back
    to back, divided by the batch: the host enqueues ahead of the card, so
    its launch overhead hides behind the card's work, as on the main
    paths. A second yardstick beside `time_ms`, never mixed with it."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def attn_error(out, want, tol):
    """(max abs error, max error relative to its row's largest |output|,
    within the bar) of attention `out` against the f32 reference `want`:
    f32 at `tol` abs + rel per element, bf16 at `tol` of each row's
    largest |output| (TOL_BF16_ROW)."""
    d = (out.float() - want).abs()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    if out.dtype == torch.float32:
        ok = bool(torch.all(d <= tol + tol * want.abs()))
    else:
        ok = bool(torch.all(d <= tol * rowmax))
    rel = (d / rowmax.clamp_min(1e-30)).max().item()
    return d.max().item(), rel, ok and math.isfinite(d.max().item())


def mount_of(path):
    """(mount point, filesystem type) holding `path`, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return best


def ptxas_report(log):
    """One line per kernel instance from `nvcc -Xptxas -v` output: its
    name with the template arguments of the mangled name (D=256 on the
    tensor cores reads `attn_fwd_mma_kernel<256>`, the RG-LRU fused
    backward's rescan `rglru_rescan_kernel<true,true>`, an SSD pass on
    bf16 B/C `ssd_states_kernel<bf16>`), then registers and spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*kernel)(?:I(\w+?)E)?E", line)
        if "Compiling entry" in line and m:
            args = re.sub(r"Lb([01])E?", lambda b: ("false,", "true,")[
                int(b.group(1))], m.group(2) or "")
            args = re.sub(r"Li(\d+)E?", r"\1,", args)
            args = args.replace("13__nv_bfloat16", "bf16").rstrip(",")
            args = re.sub(r"(^|,)f$", r"\1f32", args)
            name = f"{m.group(1)}<{args}>" if args else m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def mirror_check():
    """The Python mirrors of the launch arithmetic that the CPU tests
    check (`flash_plan`, `kv_tiles`, `warp_live`, `ssd_plan`,
    `rglru_plan`) against the built libraries' own numbers: every flash
    instance's constants, the kv tiles of every q tile and the live tiles
    of every warp at the attention cases and the path shapes, the SSD
    passes at the SSD cases and the training shape, and the RG-LRU passes
    at its cases, ragged lengths and the recurrentgemma-9b shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    shapes = ATTN_CASES + [(1, S, S, 64, 64, 128, True, 0, 0.0)
                           for S in (1024, 1000)]
    shapes += [(B, S, S, H, H, D, causal, 0, 0.0) for causal in (False, True)
               for B, S, H, D in (BERT_ATTN, T5_ATTN)]
    shapes += [(B, S, S, Hq, Hkv, D, causal, window, 0.0) for
               B, S, Hq, Hkv, D, causal, window, _, _ in FLASH_D256_CASES]
    shapes += [c for _, c, _, _ in REG_FLASH_CASES]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in fa.HEAD_DIMS:
            plan = fa.flash_plan(D, dtype)
            check(plan == fa.library_plan(D, dtype), f"flash_plan({D}, "
                  f"{dtype}) {plan} is not the library's "
                  f"{fa.library_plan(D, dtype)}")
            n += 1
        for B, Sq, Skv, Hq, Hkv, D, causal, window, _ in shapes:
            plan = fa.flash_plan(D, dtype)
            bq, bk = plan["bq"], plan["bk"]
            for q0 in range(0, Sq, bq):
                tiles = fa.kv_tiles(q0, bq, bk, Sq, Skv, causal, window)
                check(tiles == fa.library_kv_tiles(D, dtype, q0, Sq, Skv,
                                                   causal, window),
                      f"kv_tiles differs from the library at D={D} "
                      f"{dtype} Sq={Sq} q0={q0}")
                n += 1
                if dtype != torch.bfloat16:
                    continue
                for t in tiles:
                    for r_lo in range(q0, q0 + bq, 16):
                        check(fa.warp_live(t * bk, r_lo, bk, Sq, causal,
                                           window)
                              == fa.library_warp_live(D, t * bk, r_lo, Sq,
                                                      causal, window),
                              f"warp_live differs from the library at D={D}"
                              f" Sq={Sq} tile {t} rows {r_lo}")
                        n += 1
    for B, S, H, P, N, chunk in SSD_CASES + [(1, TRAIN_SEQ, 80, 64, 128,
                                              128)]:
        Q = ssd.pick_chunk(S, chunk)
        mine = ssd.ssd_plan(B, S, H, P, N, Q)["passes"]
        check(mine == ssd.library_plan(B, S, H, P, N, Q),
              f"ssd_plan {mine} is not the library's "
              f"{ssd.library_plan(B, S, H, P, N, Q)}")
        n += 1
    for B, S, W in RGLRU_CASES + [(1, 300, 40), (2, 40, 8), (3, 129, 200),
                                  (1, RG_SEQ, 4096)]:
        mine = rg.rglru_plan(B, S, W)
        del mine["scratch"]
        check(mine == rg.library_plan(B, S, W), f"rglru_plan {mine} is not "
              f"the library's {rg.library_plan(B, S, W)}")
        n += 1
    print(f"  launch arithmetic: the Python mirrors agree with the "
          f"libraries in {n} checks")


def bound_ms(q, k, v, causal, window, peaks):
    """Least time for the card: each input read once and the output
    written once over the memory rate, or the score and value products
    of the unmasked pairs over the peak rate of the input type (the
    kernel module's one count of its work, `flash_attention.work`)."""
    from repro_torch.kernels.flash_attention import work
    s, by = work(q, k, v, causal=causal, window=window).bound_s(peaks)
    return 1e3 * s, by


def ssd_bound_ms(xh, dA_log, B_s, C_s, chunk, peaks):
    """Least time for the SSD scan: inputs read once and y and the final
    state written once over the memory rate, or the products the
    chunked algorithm needs over the f32 rate (`ssd_scan.work`)."""
    from repro_torch.kernels.ssd_scan import work
    s, by = work(xh, dA_log, B_s, C_s, chunk).bound_s(peaks)
    return 1e3 * s, by


def ssd_phase(gen, peaks, smi):
    """The SSD-scan kernel against its plain version; its time at the
    training shape. Returns (worst error of the cases at the 2e-4 bar,
    the training shape's error relative to its output scale, kernel_ms,
    plain_ms, bound, back-to-back kernel ms)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_fwd

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    worst = 0.0
    for B, S, H, P, N, chunk in SSD_CASES:
        xh, a = rand((B, S, H, P)), -rand((B, S, H), 0.2).abs()
        Bs, Cs = rand((B, S, N)), rand((B, S, N))
        y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=chunk)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(xh, a, Bs, Cs, chunk)
        ok = all(bool(torch.all((g - w).abs() <= TOL_SSD + TOL_SSD * w.abs()))
                 for g, w in ((y, yr), (st, sr)))
        err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
        worst = max(worst, err)
        print(f"  ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
              f"float32: max_abs_err {err:.3e} tol {TOL_SSD:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), "ssd_scan disagrees with its plain "
              "version")
    # the training shape: B and C are bf16 column slices of the conv
    # output (strided views), decays of full-width size (dt ~ softplus)
    conv = rand((1, 1024, 5376)).bfloat16()
    Bs, Cs = conv[..., 5120:5248], conv[..., 5248:]
    xh = rand((1, 1024, 80, 64))
    a = -torch.nn.functional.softplus(rand((1, 1024, 80)))
    y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
    torch.cuda.synchronize()
    yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
    scale = yr.abs().max().item()
    err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
    ok = err <= TOL_SSD_PATH * scale and bool(torch.isfinite(y).all())
    print(f"  ssd_scan training shape B=1 S=1024 H=80 P=64 N=128 chunk=128 "
          f"bf16 B/C: max_abs_err {err:.3e} (output scale {scale:.1f}, "
          f"tol {TOL_SSD_PATH:g} relative) {'ok' if ok else 'FAIL'}")
    check(ok, "ssd_scan disagrees with its plain version at the training "
          "shape")
    kernel_ms = time_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs, chunk=128))
    b2b_ms = time_back_to_back_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs,
                                                       chunk=128))
    plain_ms = time_ms(lambda: ssd_chunked(xh, a, Bs, Cs, 128))
    b_ms, b_by = ssd_bound_ms(xh, a, Bs, Cs, 128, peaks)
    print(f"  ssd_scan training shape: kernel_ms {kernel_ms:.4f} "
          f"(back-to-back {b2b_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
          f"none (no single PyTorch call computes the SSD scan) bound_us "
          f"{1e3 * b_ms:.1f} ({b_by}) on {smi}")
    return worst, err / scale, kernel_ms, plain_ms, (b_ms, b_by), b2b_ms


def rglru_bound_ms(x, peaks, tensors=3):
    """Least time for the RG-LRU scan: `tensors` f32 tensors of x's size
    read or written once over the memory rate (3 forward: log_a, x, h; 5
    in the backward: log_a, g, h, dx, dlog_a), or one exp and one FMA per
    element over the f32 rate (`rglru_scan.work`)."""
    from repro_torch.kernels.rglru_scan import work
    s, by = work(x, tensors).bound_s(peaks)
    return 1e3 * s, by


def scan_err(got, want, tol, scale=None):
    """(max abs error, worst error over its bar): the bar is tol (1 +
    |want|), or given a `scale`, tol (1 + scale). A slow decay's check
    gives the scale the scan has carried (`rglru_scan.scan_scale`) and
    the exact (f64) recurrence as `want`: no f32 order, the plain
    sequential one included, meets the elementwise bar there."""
    d = (got.double() - want.double()).abs()
    ref = want.double().abs() if scale is None else scale.double()
    return d.max().item(), (d / (1 + ref)).max().item() / tol


def rglru_phase(gen, peaks, smi):
    """The RG-LRU kernel against its plain version, both modes (forward,
    and the reverse recurrence) and the fused backward, and repeat calls
    bitwise equal; its times at the recurrentgemma-9b shape. Returns a
    dict of the worst error and the times."""
    from repro_torch.kernels.rglru_scan import (dlog_a_scale,
                                                rglru_scan_bwd,
                                                rglru_scan_fwd,
                                                rglru_sequential, scan_scale)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    path = (1, RG_SEQ, 4096)
    cases = [(c, "-|N(0,0.5)|")
             for c in RGLRU_CASES + [(1, 300, 40), (2, 40, 8), path]]
    cases += [(path, "U[-20,0]"), (path, "U[-1e-3,0]")]
    worst = worst_bar = 0.0

    def report(what, err, bar, tol, slow):
        how = " of the carried scale, against the f64 recurrence"
        print(f"  rglru_scan {what}: max_abs_err {err:.3e}, {bar:.3f} of the "
              f"bar (tol {tol:g}{how if slow else ''}) "
              f"{'ok' if bar <= 1 else 'FAIL'}")
        check(bar <= 1 and math.isfinite(err), f"rglru_scan {what} disagrees "
              f"with its plain version")

    for (B, S, W), decay in cases:
        if decay == "-|N(0,0.5)|":      # the JAX tests' decays
            la = -(rand((B, S, W)) * 0.5).abs()
        else:                           # uniform in [-20, 0] or [-1e-3, 0]
            depth = 20.0 if decay == "U[-20,0]" else 1e-3
            la = -torch.rand((B, S, W), generator=gen, device="cuda") * depth
        # a slow decay's oracle is the exact recurrence: the f32 sequential
        # one misses the bar there itself (printed)
        slow = decay == "U[-1e-3,0]"
        dt = torch.float64 if slow else torch.float32
        x = rand((B, S, W))
        for reverse in (False, True):
            h = rglru_scan_fwd(la, x, reverse=reverse)
            torch.cuda.synchronize()
            want = rglru_sequential(la.to(dt), x.to(dt), reverse=reverse)
            scale = scan_scale(want, reverse=reverse) if slow else None
            err, bar = scan_err(h, want, TOL_RGLRU, scale)
            worst, worst_bar = max(worst, err), max(worst_bar, bar)
            mode = "reverse" if reverse else "forward"
            report(f"B={B} S={S} W={W} log_a {decay} {mode}", err, bar,
                   TOL_RGLRU, slow)
            if slow:
                f32 = scan_err(rglru_sequential(la, x, reverse=reverse),
                               want, TOL_RGLRU, scale)
                print(f"    the plain f32 sequential {mode}: max_abs_err "
                      f"{f32[0]:.3e}, {f32[1]:.3f} of the same bar")
        if (B, S, W) != path or decay == "U[-20,0]":
            continue
        # the fused backward against autograd through the plain recurrence
        g = rand((B, S, W))
        h = rglru_scan_fwd(la, x)
        dla, dx = rglru_scan_bwd(la, g, h)
        torch.cuda.synchronize()
        la_, x_ = (t.to(dt).requires_grad_(True) for t in (la, x))
        h_ = rglru_sequential(la_, x_)
        wla, wx = torch.autograd.grad(h_, (la_, x_), g.to(dt))
        scales = ((scan_scale(wx, reverse=True), dlog_a_scale(wx, h_))
                  if slow else (None, None))
        for name, got, want, sc in (("dx", dx, wx, scales[0]),
                                    ("dlog_a", dla, wla, scales[1])):
            err, bar = scan_err(got, want, TOL_RGLRU_GRAD, sc)
            report(f"fused backward B={B} S={S} W={W} log_a {decay}: {name}",
                   err, bar, TOL_RGLRU_GRAD, slow)
        del la_, x_, h_, wla, wx, scales
        # two calls, the same bits
        for name, fn in (("forward", lambda: (rglru_scan_fwd(la, x),)),
                         ("reverse", lambda: (rglru_scan_fwd(
                             la, g, reverse=True),)),
                         ("backward", lambda: rglru_scan_bwd(la, g, h))):
            first = [t.clone() for t in fn()]
            check(all(torch.equal(a, b) for a, b in zip(first, fn())),
                  f"two rglru_scan {name} calls differ")
        print(f"  rglru_scan B={B} S={S} W={W} log_a {decay}: forward, "
              f"reverse and backward bitwise equal on a repeat call")
    la = -(rand(path) * 0.5).abs()
    x, g = rand(path), rand(path)
    h = rglru_scan_fwd(la, x)
    fns = {"forward": lambda: rglru_scan_fwd(la, x),
           "reverse": lambda: rglru_scan_fwd(la, g, reverse=True),
           "backward": lambda: rglru_scan_bwd(la, g, h)}
    out = {"max_abs_err": worst, "max_err_over_bar": worst_bar}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_ms_back_to_back"] = time_back_to_back_ms(fn)
    out["plain_ms"] = time_ms(lambda: rglru_sequential(la, x))
    out["bound"] = rglru_bound_ms(x, peaks)
    out["backward_bound"] = rglru_bound_ms(x, peaks, tensors=5)
    print(f"  rglru_scan recurrentgemma-9b shape B=1 S={RG_SEQ} W=4096 f32: "
          f"kernel_ms {out['forward_ms']:.4f} (back-to-back "
          f"{out['forward_ms_back_to_back']:.4f}), reverse "
          f"{out['reverse_ms']:.4f} ({out['reverse_ms_back_to_back']:.4f}), "
          f"fused backward {out['backward_ms']:.4f} "
          f"({out['backward_ms_back_to_back']:.4f}; bound_us "
          f"{1e3 * out['backward_bound'][0]:.1f}) plain_ms "
          f"{out['plain_ms']:.4f} library_ms none (no single PyTorch call "
          f"computes this scan) bound_us {1e3 * out['bound'][0]:.1f} "
          f"({out['bound'][1]}) on {smi}")
    return out


def flash_d256_phase(gen, peaks, smi):
    """The flash kernel at recurrentgemma-9b's MQA head_dim 256 against
    the plain attention; at the path's shape its time beside the bound
    and scaled_dot_product_attention's. Returns (worst bf16 error,
    kernel_ms, plain_ms, library_ms, bound, back-to-back kernel ms)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    worst, path = 0.0, None
    for B, S, Hq, Hkv, D, causal, window, dtype, tol in FLASH_D256_CASES:
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
        err, rel, ok = attn_error(out, want, tol)
        print(f"  flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"causal={causal} window={window} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} row_rel_err {rel:.3e} tol {tol:g}"
              f"{' of the row max' if dtype == torch.bfloat16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "flash_attention disagrees with its plain version at "
              "head_dim 256")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        if path is None:
            path = (q, k, v, window)
    q, k, v, window = path
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                window=window))
    b2b_ms = time_back_to_back_ms(lambda: flash_attention(
        q, k, v, causal=True, window=window))
    plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True,
                                                   window=window))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True))
    b_ms, b_by = bound_ms(q, k, v, True, window, peaks)
    B, S, Hq, D = q.shape
    print(f"  recurrentgemma-9b shape B={B} S={S} Hq={Hq} Hkv={k.shape[2]} "
          f"D={D} causal window {window} bf16: kernel_ms {kernel_ms:.4f} "
          f"(back-to-back {b2b_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} "
          f"(scaled_dot_product_attention, yardstick only) bound_us "
          f"{1e3 * b_ms:.1f} ({b_by}) on {smi}")
    return worst, kernel_ms, plain_ms, library_ms, (b_ms, b_by), b2b_ms


def flash_bert_phase(gen, peaks, smi):
    """The flash kernel at the attention shapes phase 8 gives it (q/k/v
    (4, 1024, 64, 128) bf16 for GPT and BERT, (8, 1024, 64, 128) for T5),
    bidirectional as BERT's (every kv tile of every query block is live)
    and causal as GPT's, against the plain attention; at each shape the
    bidirectional time beside the bound and scaled_dot_product_attention's
    (is_causal=False). Returns {"bert": ..., "t5": ...}, each a dict of
    that shape's bidirectional error and times."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    res = {}
    for fam, (B, S, H, D) in (("t5", T5_ATTN), ("bert", BERT_ATTN)):
        q, k, v = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        for causal in (True, False):
            o = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = attention_reference(q.float(), k.float(), v.float(),
                                       causal=causal)
            err, rel, ok = attn_error(o, want, TOL_BF16_ROW)
            del o, want
            print(f"  flash_attention phase-8 shape B={B} S={S} H={H} "
                  f"D={D} causal={causal} bf16: max_abs_err {err:.3e} "
                  f"row_rel_err {rel:.3e} tol {TOL_BF16_ROW:g} of the row "
                  f"max {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention disagrees with its plain version "
                  f"at phase 8's shape B={B} (causal={causal})")
        out = res[fam] = {"max_abs_err": err, "max_row_rel_err": rel}
        out["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=False))
        out["ms_back_to_back"] = time_back_to_back_ms(
            lambda: flash_attention(q, k, v, causal=False))
        out["plain_ms"] = time_ms(lambda: attention_reference(
            q, k, v, causal=False))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out["library_ms"] = time_ms(lambda: torch.nn.functional.
                                    scaled_dot_product_attention(
                                        qt, kt, vt, is_causal=False))
        out["bound"] = bound_ms(q, k, v, False, 0, peaks)
        print(f"  phase-8 shape B={B} S={S} H={H} D={D} non-causal bf16: "
              f"kernel_ms {out['ms']:.4f} (back-to-back "
              f"{out['ms_back_to_back']:.4f}) plain_ms "
              f"{out['plain_ms']:.4f} library_ms {out['library_ms']:.4f} "
              f"(scaled_dot_product_attention, is_causal=False, yardstick "
              f"only) bound_us {1e3 * out['bound'][0]:.1f} "
              f"({out['bound'][1]}) on {smi}")
        del q, k, v, qt, kt, vt
    return res


def flash_registry_phase(gen, peaks, smi, cases=REG_FLASH_CASES):
    """The flash instances phase 13 launches (`cases`: REG_FLASH_CASES;
    phase 16 passes MOE_FLASH_CASES) against
    the plain attention in f32; at each path shape its time (one call
    and back to back) beside the plain version's, the bound and
    scaled_dot_product_attention's (with the window as a boolean mask
    where one applies; it has no softcap, so at gemma2's shape it
    computes another function and is a yardstick only). Returns
    {label: {max_abs_err, max_row_rel_err, ms, ms_back_to_back, plain_ms,
    sdpa_ms, library_ms, bound}} for the path shapes, and the worst
    errors of the D=80 cases ({"d80 f32", "d80 bf16"})."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res, d80 = {}, {"d80 f32": 0.0, "d80 bf16": 0.0}
    for label, case, dtype, tol in cases:
        B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
        q = torch.randn((B, Sq, Hq, D), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((B, Skv, Hkv, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        opts = dict(causal=causal, window=window, logit_cap=cap)
        out = flash_attention(q, k, v, **opts)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(), **opts)
        err, rel, ok = attn_error(out, want, tol)
        del out, want
        print(f"  flash_attention {label} B={B} Sq={Sq} Skv={Skv} Hq={Hq} "
              f"Hkv={Hkv} D={D} causal={causal} window={window} cap={cap} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} row_rel_err "
              f"{rel:.3e} tol {tol:g}"
              f"{' of the row max' if dtype == torch.bfloat16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention disagrees with its plain version at "
              f"{label} ({str(dtype)[6:]})")
        if D == 80:
            key = "d80 f32" if dtype == torch.float32 else "d80 bf16"
            d80[key] = max(d80[key], err)
        if Sq < 1024:
            continue
        r = res[label] = {"max_abs_err": err, "max_row_rel_err": rel}
        r["ms"] = time_ms(lambda: flash_attention(q, k, v, **opts))
        r["ms_back_to_back"] = time_back_to_back_ms(
            lambda: flash_attention(q, k, v, **opts))
        r["plain_ms"] = time_ms(lambda: attention_reference(q, k, v,
                                                            **opts))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(Sq, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] >
                                                 i[:, None] - window)
            r["sdpa_ms"] = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                enable_gqa=True))
            del mask
        else:
            r["sdpa_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                enable_gqa=True))
        # one PyTorch call computing the same function: none with a cap
        r["library_ms"] = None if cap else r["sdpa_ms"]
        r["bound"] = bound_ms(q, k, v, causal, window, peaks)
        other = (" with the window mask and no softcap: another function"
                 if cap else "")
        print(f"  {label} shape: kernel_ms {r['ms']:.4f} (back-to-back "
              f"{r['ms_back_to_back']:.4f}) plain_ms {r['plain_ms']:.4f} "
              f"sdpa_ms {r['sdpa_ms']:.4f} (scaled_dot_product_attention"
              f"{other}, yardstick only) bound_us "
              f"{1e3 * r['bound'][0]:.1f} "
              f"({r['bound'][1]}) on {smi}")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return res, d80


def rg_layer_check(gen):
    """One full-width rglru mixer forward through the kernel against the
    plain recurrence, bf16 weights from a seed."""
    from repro_torch.configs import resolve_config
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models.rglru import apply_rglru, init_rglru
    cfg = resolve_config(RG_ARCH)
    p = init_rglru(gen, cfg, torch.bfloat16)
    x = torch.randn((1, RG_SEQ, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        before = rglru_scan.launches
        yk, _ = apply_rglru(p, x, cfg, impl="cuda")
        check(rglru_scan.launches == before + 1, "the rglru mixer did not "
              "launch the rglru_scan kernel")
        yp, _ = apply_rglru(p, x, cfg, impl="torch")
    scale = yp.float().abs().max().item()
    err = (yk.float() - yp.float()).abs().max().item()
    print(f"  one {RG_ARCH} rglru mixer, kernel vs plain recurrence: "
          f"max_abs_err {err:.3e} (output scale {scale:.3f}, tol "
          f"{TOL_LAYER:g} relative)")
    check(bool(torch.isfinite(yk).all()) and err <= TOL_LAYER * scale,
          "the rglru mixer through the kernel differs from the plain path")


def layer_check(gen):
    """One full-width mamba2 layer forward through the kernel against the
    plain scan, bf16 weights from a seed."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.mamba2 import apply_mamba2, init_mamba2
    cfg = resolve_config(TRAIN_ARCH)
    p = init_mamba2(gen, cfg, torch.bfloat16)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    from repro_torch.kernels.ssd_scan import ssd_scan
    with torch.no_grad():
        before = ssd_scan.launches
        yk, _ = apply_mamba2(p, x, cfg, impl="cuda")
        check(ssd_scan.launches == before + 1, "the layer did not launch "
              "the ssd_scan kernel")
        yp, _ = apply_mamba2(p, x, cfg, impl="torch")
    scale = yp.float().abs().max().item()
    err = (yk.float() - yp.float()).abs().max().item()
    print(f"  one {TRAIN_ARCH} layer, kernel vs plain scan: max_abs_err "
          f"{err:.3e} (output scale {scale:.3f}, tol {TOL_LAYER:g} "
          f"relative)")
    check(bool(torch.isfinite(yk).all()) and err <= TOL_LAYER * scale,
          "the mamba2 layer through the kernel differs from the plain path")


def drained_spool_policy():
    """A SpoolPolicy that, before the head stage is stored, waits for the
    store of every earlier stage to land: backward then reads each layer
    back through the backend and the codec instead of forwarding the
    host copy of a store still queued (zlib encodes slower than 8 layers
    run forward, so without the wait nothing would be read back)."""
    from repro_torch.core.policies import SpoolPolicy

    class DrainedSpoolPolicy(SpoolPolicy):
        spool = None

        def should_offload(self, stage, profile=None):
            if profile is not None and profile.name == "head":
                self.spool.wait_io()
            return True

    return DrainedSpoolPolicy()


def drained_adaptive_policy():
    """An AdaptivePolicy that, on a planned step, waits before the head
    stage for the store of every earlier stage to land, as
    `drained_spool_policy` does: a planned step's bytes are then written
    and read back within the step, and its stats delta (taken at the
    step's end) holds them. Undrained, a layer's write on a slow
    directory outlasts the step, and its bytes land in a later step's
    delta or after the last one. The profiling step is not drained
    before its head, so the profile and the plan are the policy's own."""
    from repro_torch.core.policies import AdaptivePolicy

    class DrainedAdaptivePolicy(AdaptivePolicy):
        spool = None

        def should_offload(self, stage, profile=None):
            if (self.plan is not None and profile is not None
                    and profile.name == "head"):
                self.spool.wait_io()
            return super().should_offload(stage, profile)

    return DrainedAdaptivePolicy()


def train_run(cfg, policy, io, label, *, optimizer="adamw", seq=TRAIN_SEQ,
              batch=1, keep_params=None, snap=None, settings=None,
              stage_bytes=None, engine="staged", steps=TRAIN_STEPS,
              counter=None):
    """TrainSession steps at B=batch, S=seq on the card. Every kernel's
    launch count is set to 0 just before the steps and read just after.
    Returns (losses, params, reports, {kernel: launches}, run peak, stage
    count): params are the final parameters on the host, or, given the
    host parameters of an earlier run as `keep_params`, whether they are
    bitwise equal to those (one host copy of a large model, not two).
    Given a dict `snap`, its "params" get a host copy of the parameters
    after step 2 (the run goes on as one loop: `run(2)`, then `run(1)`).
    `settings`: the session's RunSettings (the default's, with the
    kernels, otherwise). Given a list `stage_bytes`, it gets the bytes
    the spool stored for each stage of the first step, in stage order.
    A spool run prints its pool's stats; `steps` steps (TRAIN_STEPS by
    default). `engine="jit"` runs the jit
    name (policy None, its placement from `settings`); its reports carry
    the loss, the tracked footprints and the device peak, and at its end
    every pool lease has come back. Given an `OpCounter` as `counter`, the
    first step runs under it and the later ones outside it, so their
    step times carry none of its cost."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data.pipeline import (embedding_batches,
                                           encoder_decoder_batches,
                                           vision_batches)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.session import TrainSession
    kernels = (flash_attention, ssd_scan, rglru_scan)
    loader = (encoder_decoder_batches(cfg.vocab_size, batch=batch,
                                      seq_len=seq, seed=0)
              if cfg.family == "encdec" else
              embedding_batches(cfg.d_model, cfg.vocab_size, batch=batch,
                                seq_len=seq, seed=0)
              if cfg.input_kind == "embeddings" else
              vision_batches(cfg.vocab_size, cfg.d_model,
                             cfg.encoder_seq_len, batch=batch, seq_len=seq,
                             seed=0)
              if cfg.family == "vlm" else None)
    sess = TrainSession(cfg, engine=engine, policy=policy, io=io,
                        optimizer=optimizer, lr=3e-4, batch_size=batch,
                        seq_len=seq, seed=0, device="cuda", attn_impl="cuda",
                        loader=loader, settings=settings)
    if hasattr(policy, "spool"):
        policy.spool = sess.spool
    if stage_bytes is not None:
        offload, spool = sess.spool.offload, sess.spool

        def counted(key, tree):
            offload(key, tree)
            if len(stage_bytes) < len(sess.engine.stage_names):
                stage_bytes.append(spool._records[key]["nbytes"])
        spool.offload = counted
    try:
        sess.init()
        print(f"  {label}: {sess.n_params / 1e9:.3f} B parameters "
              f"({cfg.dtype})")
        for k in kernels:
            k.launches = 0
        if snap is not None:
            reports = sess.run(2).reports
            snap["params"] = [t.detach().cpu()
                              for t in tree_flatten(sess.params)[0]]
            reports += sess.run(steps - 2).reports
        elif counter is not None:
            with counter:
                reports = sess.run(1).reports
            reports += sess.run(steps - 1).reports
        else:
            reports = sess.run(steps).reports
        launches = {k.__name__: k.launches for k in kernels}
        if io is not None:
            print(f"  {label} pool: {pool_line(sess.spool)}")
        n_stages = len(sess.engine.stage_names)
        if engine == "jit":
            # the jit name's placement stores nothing: no record, no byte
            st = sess.engine.spool.stats
            check(sess.spool is None and st.bytes_offloaded == 0
                  and sess.engine.spool.backend.stats.bytes_written == 0
                  and sess.engine.spool.live_keys() == [],
                  f"{label}: the jit run stored {st.bytes_offloaded} bytes")
            leased = sess.engine.spool.pool._leased_bytes
            check(leased == 0, f"{label}: {leased} bytes of the pool still "
                  f"leased after the run")
        leaves = tree_flatten(sess.params)[0]
        if keep_params is None:
            params = [t.detach().cpu() for t in leaves]
        else:
            params = same_params(leaves, keep_params)
        del leaves
        for r in reports:
            st, ex = r.stats, r.extra
            if engine == "jit":
                print(f"  {label} step {r.step}: loss {r.loss:.6f} "
                      f"{r.step_time:.3f}s peak "
                      f"{ex['device_peak_bytes'] / 1e9:.2f} GB (tracked act "
                      f"peak {r.peak_activation_bytes / 1e9:.3f} GB, at "
                      f"bwd-begin {r.backward_begin_bytes / 1e9:.3f} GB)")
                continue
            print(f"  {label} step {r.step}: loss {r.loss:.6f} "
                  f"{r.step_time:.3f}s (fwd {ex['forward_s']:.3f} bwd "
                  f"{ex['backward_s']:.3f} opt {ex['optimizer_s']:.3f}) "
                  f"peak {ex['device_peak_bytes'] / 1e9:.2f}"
                  f" GB bwd-begin {ex['device_backward_begin_bytes'] / 1e9:.2f}"
                  f" GB (tracked act {r.backward_begin_bytes / 1e9:.2f} GB) "
                  f"offloaded {st.bytes_offloaded / 1e9:.3f} GB (of "
                  f"{st.bytes_offloaded_logical / 1e9:.3f} GB before the "
                  f"codec) loaded "
                  f"{st.bytes_loaded / 1e9:.3f} GB forwarded "
                  f"{st.bytes_forwarded / 1e9:.3f} GB store {st.store_time:.2f}s"
                  f" load {st.load_time:.2f}s fetch wait "
                  f"{st.fetch_wait_time:.3f}s stages off/kept/recomp/fetched "
                  f"{ex['stages_offloaded']}/{ex['stages_kept']}/"
                  f"{ex['stages_recomputed']}/{ex['stages_fetched']}")
        losses = [r.loss for r in reports]
        peak = max(r.extra["device_peak_bytes"] for r in reports)
    finally:
        sess.close()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    return losses, params, reports, launches, peak, n_stages


def pool_line(spool):
    """The spool's aligned pool: reuse, trims, lifetime mapping volume and
    CUDA registrations (count and seconds)."""
    p = spool.pool.stats()
    return (f"hits {p['hits']} misses {p['misses']} (hit rate "
            f"{p['hit_rate']:.3f}) trimmed {p['trimmed']} bytes_allocated "
            f"{p['bytes_allocated']} idle cap {p['idle_cap']} (set "
            f"{spool.pool.max_bytes}, peak leased {p['peak_leased_bytes']}) "
            f"CUDA registrations {p['registrations']} "
            f"({p['register_s']:.3f}s)")


def deterministic():
    """Deterministic kernels for the parity phases (warn, not raise, on an
    op without one: the bitwise checks catch any that matters), without
    the NaN fill of every new tensor that the mode turns on by default."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def same_params(a, b) -> bool:
    """Leaf lists bitwise equal (b's leaves are moved to a's device one
    at a time)."""
    return len(a) == len(b) and all(torch.equal(x, y.to(x.device))
                                    for x, y in zip(a, b))


def keep_vs_spool(cfg, seq, optimizer, want, smi, batch=1, stages=None,
                  hold=False, settings=None, label=None, policy=None,
                  act_lower=False, keep_out=None, steps=TRAIN_STEPS):
    """Full-width training of `cfg` kept on the card, then spooled (fs,
    raw) to a fresh directory: bitwise losses and parameters, a lower
    peak, bytes offloaded, every stored stage fetched (the stage count
    is the engine's, and equal to `stages` where given), the directory
    empty after close, and each kernel's launches equal to `want` in
    each run. `policy`: the spool run's (a SpoolPolicy by default); with
    `act_lower` its tracked activation peak must be lower than keep's
    too. A model of one segment (no encoder) also holds the
    layer stages' saved bytes to the exact counter
    (`core.endurance.residual_bytes_per_layer` on the meta device).
    Returns the spool run's launches (the main path's); with `hold`,
    also its losses, the final parameters' host copy, each step's device
    peak, the keep run's parameters after step 2 and the bytes the spool
    stored per stage in step 1, with each run's device peak. A dict
    `keep_out` gets the keep run's losses, reports, device peak and final
    parameters' host copy. Each run takes `steps` steps."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.endurance import residual_bytes_per_layer
    from repro_torch.core.policies import KeepPolicy, SpoolPolicy
    from repro_torch.models.transformer import build_segments
    deterministic()
    label = label or cfg.name
    snap = {} if hold else None
    stage_bytes = []
    lk, pk, rk, nk, peak_k, _ = train_run(cfg, KeepPolicy(), None,
                                          f"{label} keep",
                                          optimizer=optimizer, seq=seq,
                                          batch=batch, snap=snap,
                                          settings=settings, steps=steps)
    spool_dir = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    mnt, fstype = mount_of(spool_dir)
    ls, same, rs, ns, peak_s, n_stages = train_run(
        cfg, policy or SpoolPolicy(), SpoolIoConfig(
            backend="fs", directory=spool_dir, codec="raw",
            pool_bytes=POOL_BYTES),
        f"{label} spool", optimizer=optimizer, seq=seq, batch=batch,
        keep_params=pk, settings=settings, stage_bytes=stage_bytes,
        steps=steps)
    n_leaves = len(pk)
    if keep_out is not None:
        keep_out.update(losses=lk, reports=rk, peak=peak_k, params=pk)
    if not hold:
        del pk
    left = os.listdir(spool_dir)
    if not left:
        os.rmdir(spool_dir)
    act_k, act_s = (max(r.peak_activation_bytes for r in reps)
                    for reps in (rk, rs))
    print(f"train: {label} {cfg.num_layers + cfg.num_decoder_layers} "
          f"layers in {n_stages} "
          f"stages, d_model {cfg.d_model}, {steps} steps at B={batch} "
          f"S={seq}; keep losses {lk}, spool losses {ls}; peak device "
          f"memory keep {peak_k / 1e9:.2f} GB, spool {peak_s / 1e9:.2f} GB;"
          f" tracked activation peak keep {act_k / 1e9:.3f} GB, spool "
          f"{act_s / 1e9:.3f} GB ({100 * (1 - act_s / max(act_k, 1)):.1f}% "
          f"lower); launches keep {nk}, spool {ns}; spool dir on {mnt} "
          f"({fstype}) on {smi}")
    check(lk == ls, f"keep and spool losses differ: {lk} vs {ls}")
    check(same, "keep and spool parameters differ")
    check(peak_s < peak_k, f"spool peak {peak_s} not below keep {peak_k}")
    check(not act_lower or act_s < act_k, f"tracked activation peak "
          f"{act_s} spooled not below keep {act_k}")
    check(sum(r.stats.bytes_offloaded for r in rs) > 0, "nothing offloaded")
    check(all(r.extra["stages_offloaded"] == r.extra["stages_fetched"]
              == n_stages for r in rs), "a stored stage was not fetched")
    check(not left, f"spool directory not empty after close: {left[:5]}")
    check(stages is None or n_stages == stages,
          f"{n_stages} stages, want {stages}")
    for name, n in want.items():
        check(nk[name] == ns[name] == n, f"{name} launches "
              f"{nk[name]}/{ns[name]}, want {n}")
    print(f"  keep vs spool: losses and {n_leaves} parameter leaves bitwise "
          f"equal; stored bytes per stage in step 1 {stage_bytes}")
    if cfg.family != "encdec" and len(build_segments(cfg)) == 1:
        t0 = time.perf_counter()
        per = residual_bytes_per_layer(
            cfg, batch, seq, offloadable_only=False,
            attn_impl=settings.attn_impl if settings else "cuda")
        got = rs[0].extra["layer_saved_bytes"]
        # the counter is a layer stage's bytes floor-divided by its
        # blocks, as the JAX package divides (a vision period's 5 blocks
        # do not divide its stage's bytes)
        n_blocks = len(build_segments(cfg)[-1].blocks)
        per_stage, rest = divmod(got, cfg.num_layers // n_blocks)
        print(f"  layer stages' saved bytes {got} ({per_stage} a stage of "
              f"{n_blocks} blocks), exact counter {cfg.num_layers} x {per} "
              f"(meta device, {time.perf_counter() - t0:.1f}s)")
        check(rest == 0 and per_stage // n_blocks == per, "the exact "
              "residual counter disagrees with the engine's layer stages")
    return (ns, ls, pk, [r.extra["device_peak_bytes"] for r in rs],
            snap["params"], stage_bytes, (peak_k, peak_s)) if hold else ns


def train_phase(smi):
    """Full-width mamba2-2.7b cut to TRAIN_LAYERS layers with adamw: the
    SSD kernel once per layer per step."""
    from repro_torch.configs import resolve_config
    cfg = dataclasses.replace(resolve_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    return keep_vs_spool(cfg, TRAIN_SEQ, "adamw",
                         {"ssd_scan": cfg.num_layers * TRAIN_STEPS}, smi)


def rg_train_phase(smi):
    """Full-width recurrentgemma-9b cut to RG_LAYERS layers with sgd (no
    momentum: adamw's f32 moments, 83.6 GB at full depth, pass one
    card): the RG-LRU kernel once per rglru block per step in forward
    and once in backward, the flash kernel once per attention block per
    step (its backward is the plain VJP)."""
    from repro_torch.configs import resolve_config
    from repro_torch.optim.optimizers import sgd
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(resolve_config(RG_ARCH), num_layers=RG_LAYERS)
    kinds = [b.mixer for seg in build_model(cfg).segments
             for _ in range(seg.n_repeat) for b in seg.blocks]
    return keep_vs_spool(
        cfg, RG_SEQ, sgd(RG_LR, clip_norm=RG_CLIP),
        {"rglru_scan": 2 * kinds.count("rglru") * RG_STEPS,
         "flash_attention": kinds.count("attn") * RG_STEPS,
         "ssd_scan": 0}, smi, steps=RG_STEPS)


def paper_train_phase(smi):
    """The paper's GPT, BERT and T5 at hidden 8192, 4 layers, S=1024 with
    sgd (no momentum), at B=4 (T5 at B=8): the flash kernel once per
    attention per step, causal for GPT, bidirectional for BERT, and for
    T5 bidirectional in its 2 encoder layers, causal in the
    self-attention and bidirectional in the cross-attention of its 2
    decoder layers (the backward is the plain VJP). Stages: one per
    layer, the embed and head stages, and T5's enc_embed and enc_final.
    Returns {family: the spool run's launches} and, for phases 9 and 10,
    GPT's spool losses, final parameters (host copy), device peaks and
    the keep run's parameters after step 2."""
    from repro_torch.configs import bert, gpt, t5
    from repro_torch.optim.optimizers import sgd
    out, keep = {}, {}
    for fam, make in (("gpt", gpt), ("bert", bert), ("t5", t5)):
        cfg = make(PAPER_HIDDEN, PAPER_LAYERS)
        encdec = cfg.family == "encdec"
        # each decoder layer of T5 attends twice: to itself, then to enc
        per_step = cfg.num_layers + 2 * cfg.num_decoder_layers
        steps = TRAIN_STEPS if fam == "gpt" else PAPER_SHORT_STEPS
        out[fam] = keep_vs_spool(
            cfg, PAPER_SEQ, sgd(PAPER_LR),
            {"flash_attention": per_step * steps, "ssd_scan": 0,
             "rglru_scan": 0}, smi,
            batch=T5_BATCH if encdec else PAPER_BATCH,
            stages=PAPER_LAYERS + 2 + 2 * encdec, hold=fam == "gpt",
            keep_out=keep if fam == "gpt" else None, steps=steps)
        if fam == "gpt":
            # the named tiers, held to the keep run after NAMED_STEPS
            out["named"] = named_tier_runs(smi, keep, out["gpt"][4])
        keep.clear()
    out["gpt"], *gpt_run = out["gpt"]
    ce_chunk_runs(smi, gpt_run[0], *gpt_run[4:])
    return out, gpt_run[:4]


def named_tier_runs(smi, keep, keep_params2):
    """Phase 8's named tiers on the paper's GPT (gpt-h8192-l4, bf16, sgd,
    B=PAPER_BATCH, S=PAPER_SEQ, the jit name, the flash kernel),
    NAMED_STEPS steps each: (i) "save_names" of NAMED_GPT (layers
    recomputed, "attn_out" and "mlp_hidden" kept on the card) and (ii)
    "offload" of "blk_in" and NAMED_GPT (the three in pinned host memory
    between a layer's forward and its recompute), each with its first
    step under the op counter and its step 2 timed outside it, beside
    keep's step 2. `keep`: the keep run's losses, reports and device peak;
    `keep_params2`: its parameters after step 2 (host copy). Losses and
    parameters bitwise equal to keep's; one flash launch per layer per
    step (the recompute takes the held "attn_out"); (i)'s tracked
    footprint at backward begin remat's (keep's less the layer stages'
    saved bytes, plus their inputs) plus the named tensors' bytes; (ii)'s
    the keep's less the layer stages' saved bytes, the named tensors and
    the inputs off the card in step 1 by the op counter, and its device
    peak below
    keep's. Returns {run: flash launches}."""
    from repro_torch.configs import gpt
    from repro_torch.launch.op_stats import OpCounter
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    t0 = time.perf_counter()
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    L, tokens, es = PAPER_LAYERS, PAPER_BATCH * PAPER_SEQ, 2
    attn_out = tokens * cfg.num_heads * cfg.resolved_head_dim * es
    hidden = tokens * cfg.d_ff * es
    blk_in = tokens * cfg.d_model * es
    rk = keep["reports"][:NAMED_STEPS]
    out = {}
    for run, policy, names in (
            ("i", "save_names", NAMED_GPT),
            ("ii", "offload", ("blk_in",) + NAMED_GPT)):
        label = f"{cfg.name} {policy} {'+'.join(names)}"
        settings = RunSettings(attn_impl="cuda", attn_chunk=256,
                               param_dtype=cfg.dtype, device="cuda",
                               activation_policy=policy,
                               offload_names=names)
        counter = OpCounter("cuda")
        t_run = time.perf_counter()
        losses, same, reps, launches, peak, _ = train_run(
            cfg, None, None, label, optimizer=sgd(PAPER_LR), seq=PAPER_SEQ,
            batch=PAPER_BATCH, keep_params=keep_params2, settings=settings,
            engine="jit", steps=NAMED_STEPS, counter=counter)
        host = counter.analysis().host_bytes
        peak_k = max(r.extra["device_peak_bytes"] for r in rk)
        print(f"train: {label} (jit name), B={PAPER_BATCH}: losses {losses} "
              f"(keep {keep['losses'][:NAMED_STEPS]}); step times "
              f"{[round(r.step_time, 4) for r in reps]} s, step 1 under "
              f"the op counter (keep "
              f"{[round(r.step_time, 4) for r in rk]}, no counter); step "
              f"2 {reps[1].step_time:.4f} s against keep's "
              f"{rk[1].step_time:.4f} s, neither counted; tracked at "
              f"backward begin {[r.backward_begin_bytes for r in reps]} "
              f"(keep {[r.backward_begin_bytes for r in rk]}, its layers' "
              f"saved {[r.extra['layer_saved_bytes'] for r in rk]}); named "
              f"bytes a step {[r.extra['named_bytes'] for r in reps]}; off "
              f"the card by the op counter {host / 1e9:.4f} GB in step 1; "
              f"device peak {peak / 1e9:.2f} GB (keep "
              f"{peak_k / 1e9:.2f}); launches {launches}; "
              f"{time.perf_counter() - t_run:.1f}s on {smi}")
        check(losses == keep["losses"][:NAMED_STEPS], f"{label}: losses "
              f"{losses} differ from keep's {keep['losses']}")
        check(same, f"{label}: parameters differ from keep's after "
              f"{NAMED_STEPS} steps")
        check(launches["flash_attention"] == L * NAMED_STEPS,
              f"{label}: {launches['flash_attention']} flash launches, "
              f"want {L * NAMED_STEPS} (no attention forward in the "
              f"recompute)")
        for r, k in zip(reps, rk):
            check(r.extra["named_bytes"] == L * (attn_out + hidden),
                  f"{label} step {r.step}: named bytes "
                  f"{r.extra['named_bytes']}, want {L * (attn_out + hidden)}")
            less = k.backward_begin_bytes - k.extra["layer_saved_bytes"]
            want = (less + L * (blk_in + attn_out + hidden)
                    if policy == "save_names" else less)
            check(r.backward_begin_bytes == want, f"{label} step {r.step}: "
                  f"tracked {r.backward_begin_bytes} at backward begin, "
                  f"want {want}")
        if policy == "offload":
            want = L * (blk_in + attn_out + hidden)
            check(host == want, f"{label}: {host} bytes off the card in "
                  f"step 1 by the op counter, want {want}")
            check(peak < peak_k, f"{label}: device peak {peak} not below "
                  f"keep's {peak_k}")
        else:
            check(host == 0, f"{label}: {host} bytes off the card")
        out[run] = launches["flash_attention"]
        del counter
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  named tiers: (i) and (ii) bitwise equal to keep after "
          f"{NAMED_STEPS} steps, {L} flash launches a step; "
          f"{time.perf_counter() - t0:.1f}s")
    return out


def ce_chunk_runs(smi, plain_losses, plain_bytes, plain_peaks):
    """Phase 8's GPT again with the chunked CE (`RunSettings.ce_chunk`),
    kept and spooled: bitwise to each other, the spool losses within
    TOL_CE_CHUNK relative of the unchunked spool run's, and a head stage
    that stores no more than its labels; its stored bytes and both runs'
    device peaks printed beside the unchunked run's."""
    from repro_torch.configs import gpt
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    settings = RunSettings(attn_impl="cuda", attn_chunk=256,
                           param_dtype=cfg.dtype, device="cuda",
                           ce_chunk=CE_CHUNK)
    t0 = time.perf_counter()
    _, losses, _, _, _, stage_bytes, (peak_k, peak_s) = keep_vs_spool(
        cfg, PAPER_SEQ, sgd(PAPER_LR),
        {"flash_attention": PAPER_LAYERS * TRAIN_STEPS, "ssd_scan": 0,
         "rglru_scan": 0}, smi, batch=PAPER_BATCH, stages=PAPER_LAYERS + 2,
        hold=True, settings=settings,
        label=f"{cfg.name} ce_chunk={CE_CHUNK}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    logits = PAPER_BATCH * PAPER_SEQ * cfg.padded_vocab * 4
    print(f"  ce_chunk={CE_CHUNK}: spool losses {losses} vs unchunked "
          f"{plain_losses} (largest relative difference {rel:.3e}, tol "
          f"{TOL_CE_CHUNK:g}); head stage stored {stage_bytes[-1]} bytes "
          f"(unchunked {plain_bytes[-1]}; (B, S, V) f32 logits are "
          f"{logits}); device peak keep {peak_k / 1e9:.3f} GB, spool "
          f"{peak_s / 1e9:.3f} GB (unchunked {plain_peaks[0] / 1e9:.3f} / "
          f"{plain_peaks[1] / 1e9:.3f} GB); {time.perf_counter() - t0:.1f}s "
          f"on {smi}")
    check(rel <= TOL_CE_CHUNK, f"chunked CE losses {losses} differ from "
          f"the unchunked {plain_losses} by {rel} relative")
    # the stage's input (the hidden state) is a graph leaf the engine
    # holds, so the only tensors it may store are the labels, which fall
    # under the offload threshold
    labels = PAPER_BATCH * PAPER_SEQ * 8
    check(stage_bytes[-1] <= labels, "the chunked head stage stored "
          f"{stage_bytes[-1]} bytes, more than the labels' {labels}")


def device_busy_s(prof_trace):
    """(kernel busy, copy busy) seconds: the union of the card's kernel
    intervals and of its memory copies in an exported torch.profiler
    trace (None, None if it holds no device event)."""
    with open(prof_trace) as f:
        events = json.load(f).get("traceEvents", [])

    def busy(cats):
        ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in cats and e.get("ph") == "X")
        total, end = 0.0, -math.inf
        for lo, hi in ivs:
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        return total / 1e6, len(ivs)

    kernels, n = busy(("kernel",))
    copies, _ = busy(("gpu_memcpy", "gpu_memset"))
    return (kernels, copies) if n else (None, None)


def ckpt_trace_phase(smi, spool_losses, final_params, spool_peaks):
    """Phase 9: checkpoints and tracing on the paper's GPT at phase 8's
    spool settings. A traced run of 2 steps (checkpoints every 2 steps,
    its second step under torch.profiler), then a fresh session that
    restores step 2 and runs step 3; held bitwise against phase 8's spool
    run (`spool_losses`, `final_params`: its final parameters on the
    host), and its device peak against that run's third step's
    (`spool_peaks`): the restore leaves one copy of the model on the
    card. Returns the flash launches of the two runs."""
    from repro_torch.configs import SpoolIoConfig, gpt
    from repro_torch.core.policies import SpoolPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.obs.export import validate_trace
    from repro_torch.optim.optimizers import sgd
    from repro_torch.session import TrainSession
    from torch.profiler import ProfilerActivity, profile
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt, trace = os.path.join(work, "ckpt"), os.path.join(work, "t.json")
    prof_trace = os.path.join(work, "profile.json")
    ckpt_bytes = sum(t.numel() * t.element_size() for t in final_params)
    mnt, fstype = mount_of(work)
    free = shutil.disk_usage(work).free
    # a step rewritten in place holds two copies until the commit, beside
    # a few GB of spooled activations
    need = 2 * ckpt_bytes + 10e9
    print(f"ckpt: directory on {mnt} ({fstype}), {free / 1e9:.1f} GB free, "
          f"a checkpoint is {ckpt_bytes / 1e9:.2f} GB")
    check(free >= need, f"ckpt: {free / 1e9:.1f} GB free under {work}, "
          f"need {need / 1e9:.1f} GB for phase 9")

    def session(name, **kw):
        return TrainSession(
            cfg, policy=SpoolPolicy(), io=SpoolIoConfig(
                backend="fs", directory=os.path.join(work, name),
                codec="raw", pool_bytes=POOL_BYTES),
            optimizer=sgd(PAPER_LR), lr=PAPER_LR,
            batch_size=PAPER_BATCH, seq_len=PAPER_SEQ, seed=0,
            device="cuda", attn_impl="cuda", ckpt_dir=ckpt, keep_last=1,
            **kw)

    obs_keys = ("io_busy_s", "exposed_wait_s", "io_hidden_frac",
                "stall_read_s", "stall_decode_s", "stall_queue_s",
                "store_s", "load_s", "encode_s", "decode_s",
                "prefetch_hit_rate")
    try:
        sess = session("spool_traced", ckpt_every=2, trace=trace)
        prof = profile(activities=[ProfilerActivity.CUDA])
        window = {}

        def on_report(rep):
            # the profiler covers step 2 alone: on from step 1's report
            # to step 2's, before step 2's checkpoint
            if rep.step == 1:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            else:
                torch.cuda.synchronize()
                window["s"] = time.perf_counter() - window["t0"]
                prof.stop()

        try:
            sess.init()
            flash_attention.launches = 0
            reports = sess.run(2, on_report=on_report).reports
            traced_launches = flash_attention.launches
            ck = sess.ckpt
            snap_s, write_s = ck.last_snapshot_s, ck.last_write_s
        finally:
            sess.close()
        num_stores = sess.spool.stats.num_stores
        print(f"  traced run pool: {pool_line(sess.spool)}")
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        losses = [r.loss for r in reports]
        for r in reports:
            print(f"  traced step {r.step}: loss {r.loss:.6f} "
                  f"{r.step_time:.3f}s fetched {r.extra['stages_fetched']} "
                  f"stages; obs " + " ".join(f"{k} {r.obs[k]:.4f}"
                                             for k in obs_keys))
        prof.export_chrome_trace(prof_trace)
        kernel_s, copy_s = device_busy_s(prof_trace)
        r2 = reports[1]
        if kernel_s is None:
            print("  step 2 under torch.profiler: no device event seen; "
                  "device idle not measured")
        else:
            idle = window["s"] - kernel_s
            print(f"  step 2 under torch.profiler: step {r2.step_time:.3f}s, "
                  f"profiled window {window['s']:.3f}s, kernels busy "
                  f"{kernel_s:.3f}s, copies busy {copy_s:.3f}s, device idle "
                  f"(no kernel) {idle:.3f}s; exposed wait "
                  f"{r2.obs['exposed_wait_s']:.3f}s; idle minus exposed "
                  f"wait {idle - r2.obs['exposed_wait_s']:.3f}s on {smi}")
        errors = validate_trace(trace, ("engine", "spool", "io", "codec"))
        check(not errors, f"ckpt: trace invalid: {errors[:3]}")
        with open(trace) as f:
            host = [e for e in json.load(f)["traceEvents"]
                    if e["pid"] == 0]
        names = [e["name"] for e in host]
        reads = {e["args"]["key"] for e in host if e["name"] == "io.read"}
        waits = [e["args"]["key"] for e in host
                 if e["name"] == "spool.fetch_wait"]
        print(f"  trace: {len(host)} host events, {names.count('io.write')} "
              f"io.write for {num_stores} stores, {len(waits)} fetch waits, "
              f"{names.count('io.read')} reads; flash launches "
              f"{traced_launches}")
        check(losses == spool_losses[:2], f"ckpt: traced losses {losses} "
              f"differ from phase 8's spool losses {spool_losses[:2]}")
        check(names.count("engine.step") == 2, "ckpt: engine.step spans "
              f"{names.count('engine.step')}, want 2")
        check(names.count("io.write") == num_stores > 0,
              f"ckpt: {names.count('io.write')} io.write spans for "
              f"{num_stores} stores")
        check(all(r.extra["stages_fetched"] == PAPER_LAYERS + 2
                  for r in reports), "ckpt: a stage was not fetched")
        check(all(k in reads for k in waits),
              "ckpt: a fetch wait has no read of its key")
        check(traced_launches == 4 * 2, f"ckpt: {traced_launches} flash "
              f"launches in 2 traced steps, want 8")
        npz = os.path.join(ckpt, "step_00000002", "arrays.npz")
        check(os.path.exists(npz), "ckpt: no committed step 2")
        npz_bytes = os.path.getsize(npz)

        # resume: a fresh session restores step 2 and runs step 3
        sess = session("spool_resumed")
        try:
            sess.init()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            rep3 = sess.run(1, resume=True).reports[0]
            run_s = time.perf_counter() - t0
            resumed_launches = flash_attention.launches
            restore_s = sess.ckpt.last_restore_s
            leaves = tree_flatten(sess.params)[0]
            same = same_params(leaves, final_params)
            del leaves
        finally:
            sess.close()
            del sess
            gc.collect()
            torch.cuda.empty_cache()
        peak3 = rep3.extra["device_peak_bytes"]
        print(f"  resumed at step 2: step {rep3.step} loss {rep3.loss:.6f} "
              f"({rep3.step_time:.3f}s; restore {restore_s:.3f}s, the "
              f"run with its final checkpoint {run_s:.3f}s); flash "
              f"launches {resumed_launches}; device peak {peak3} bytes, "
              f"phase 8's spool steps {spool_peaks} bytes")
        print(f"ckpt: gpt-h8192-l4 arrays.npz {npz_bytes} bytes "
              f"({npz_bytes / 1e9:.3f} GB); host snapshot {snap_s:.3f}s, "
              f"async write {write_s:.3f}s (the final save at step 2), "
              f"restore {restore_s:.3f}s; on {mnt} ({fstype}), "
              f"{shutil.disk_usage(work).free / 1e9:.1f} GB free; {smi}")
        check(rep3.step == 3 and rep3.loss == spool_losses[2],
              f"ckpt: resumed step {rep3.step} loss {rep3.loss}, phase 8 "
              f"gave {spool_losses[2]}")
        check(same, "ckpt: resumed final parameters differ from phase 8's")
        check(resumed_launches == 4, f"ckpt: {resumed_launches} flash "
              f"launches in the resumed step, want 4")
        check(peak3 == spool_peaks[2], f"ckpt: the resumed step's device "
              f"peak {peak3} differs from phase 8's third step's "
              f"{spool_peaks[2]}")
        check(os.listdir(ckpt) == ["step_00000003"],
              f"ckpt: keep_last=1 left {os.listdir(ckpt)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("  checkpoints and tracing: traced losses, the resumed step and "
          "the final parameters bitwise equal to phase 8")
    return traced_launches, resumed_launches


def copy_rates(smi, nbytes=1 << 30):
    """Host-to-device and device-to-host rates (GB/s, best of 3, CUDA
    events) from a buffer the spool's pool registered with CUDA, at
    offsets 0, 1, 8 and 4096 of it (a blob's leaves sit at offsets the
    variable-length header sets, not aligned ones), beside torch's own
    pinned memory."""
    from repro_torch.io.bufpool import AlignedBufferPool
    pool = AlignedBufferPool(max_bytes=0)
    pool.register_cuda()
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def rate(host, to_device):
        best = math.inf
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            if to_device:
                dev.copy_(host, non_blocking=True)
            else:
                host.copy_(dev, non_blocking=True)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return nbytes / best / 1e9

    out = {}
    with pool.acquire(nbytes + 4096) as lease:
        for off in (0, 1, 8, 4096):
            host = torch.frombuffer(lease.mv[off:off + nbytes],
                                    dtype=torch.uint8)
            out[off] = (rate(host, True), rate(host, False))
            del host
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out["torch pinned"] = (rate(pinned, True), rate(pinned, False))
    del pinned, dev
    pool.close()
    print("  copy rates from a registered pool lease, H2D / D2H GB/s: "
          + "; ".join(f"offset {k}: {a:.2f} / {b:.2f}" if k != "torch pinned"
                      else f"{k}: {a:.2f} / {b:.2f}" for k, (a, b)
                      in out.items()) + f" (1 GiB, best of 3) on {smi}")
    return out


def storage_phase(smi, keep_losses, params2, params3):
    """Phase 10: the storage stack and resilience on the paper's GPT at
    phase 8's spool settings, traced: striped, managed, aio (2 steps
    each) and the chaos run (3 steps), each held bitwise against phase
    8's keep run (`keep_losses`; `params2` / `params3`: its parameters
    after steps 2 and 3, on the host). Returns the flash launches of the
    four runs."""
    from repro_torch import obs
    from repro_torch.configs import SpoolIoConfig, gpt
    from repro_torch.core.policies import SpoolPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.optim.optimizers import sgd
    from repro_torch.resilience import ChaosHarness, unwrap_chain
    from repro_torch.session import TrainSession
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    n_stages = PAPER_LAYERS + 2
    deterministic()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_storage_")

    def dirs(*names):
        return ",".join(os.path.join(work, n) for n in names)

    runs = [("striped", f"striped:{dirs('s0', 's1')}", 2),
            ("managed", f"managed:{STORAGE_HOST_BOUND},fs:{dirs('ssd')}", 2),
            ("aio", f"aio:{dirs('aio')}@8", 2),
            ("chaos", f"fault:striped:{dirs('c0', 'c1', 'c2')}", 3)]
    mnt, fstype = mount_of(work)
    print(f"storage: gpt-h8192-l4 B={PAPER_BATCH} S={PAPER_SEQ} sgd raw, "
          f"directories on {mnt} ({fstype}), pool idle cap {POOL_BYTES} "
          f"bytes, on {smi}")
    copy_rates(smi)
    launches = {}
    try:
        for label, spec, steps in runs:
            chaos = label == "chaos"
            policy = drained_spool_policy() if chaos else SpoolPolicy()
            # the striped run keeps the default idle cap (a registered
            # pool raises it to the most bytes it had leased at once)
            io = SpoolIoConfig(backend=spec, codec="raw",
                               pool_bytes=(SpoolIoConfig.pool_bytes
                                           if label == "striped"
                                           else POOL_BYTES),
                               retry_attempts=2 if chaos else 3,
                               retry_backoff_s=1e-3 if chaos else 0.01)
            sess = TrainSession(
                cfg, policy=policy, io=io, optimizer=sgd(PAPER_LR),
                lr=PAPER_LR, batch_size=PAPER_BATCH, seq_len=PAPER_SEQ,
                seed=0, device="cuda", attn_impl="cuda",
                trace_ring=obs.DEFAULT_RING_SIZE)
            policy.spool = sess.spool
            pools = []
            try:
                sess.init()
                flash_attention.launches = 0

                def on_report(rep):
                    pools.append(dict(sess.spool.pool.stats()))

                reports = sess.run(1, on_report=on_report).reports
                harness = ChaosHarness(sess.spool.backend)
                if chaos:
                    sess.spool.wait_io()
                    harness.kill_device(1)
                    harness.raising_reads(3)
                reports += sess.run(steps - 1, on_report=on_report).reports
                launches[label] = flash_attention.launches
                events, _ = obs.get_tracer().snapshot_new(None)
                fallbacks = [e[4]["stage"] for e in events
                             if e[0] == "resilience.fetch_fallback"]
                leaves = tree_flatten(sess.params)[0]
                same = same_params(leaves, params3 if steps == 3
                                   else params2)
                del leaves
                report = harness.report()
                st = sess.spool.stats
                chain = list(unwrap_chain(sess.spool.backend))
                extra = []
                for b in chain:
                    if hasattr(b, "per_device_write_bytes"):
                        extra.append(f"per-device write bytes "
                                     f"{b.per_device_write_bytes()}")
                    if hasattr(b, "direct"):
                        amnt, afs = mount_of(b.directory)
                        extra.append(
                            f"aio on {amnt} ({afs}): "
                            + ("O_DIRECT accepted" if b.direct else
                               "O_DIRECT refused, buffered + fdatasync "
                               "+ fadvise"))
                    if hasattr(b, "residency"):
                        lo, up = b.lower.stats, b.upper.stats
                        extra.append(
                            f"host peak {b.peak_host_bytes} of bound "
                            f"{b.capacity_bytes}; GB/s read / write: SSD "
                            f"tier {lo.read_bandwidth / 1e9:.2f} / "
                            f"{lo.write_bandwidth / 1e9:.2f}, host tier "
                            f"{up.read_bandwidth / 1e9:.2f} / "
                            f"{up.write_bandwidth / 1e9:.2f}")
                sess.spool.wait_io()
                pool = pool_line(sess.spool)
                striped = next((b for b in chain
                                if hasattr(b, "per_device_write_bytes")),
                               None)
                dev_bytes = (striped.per_device_write_bytes()
                             if striped is not None else [])
                aio_direct = next((b.direct for b in chain
                                   if hasattr(b, "direct")), None)
            finally:
                sess.close()
                del sess
                gc.collect()
                torch.cuda.empty_cache()
            losses = [r.loss for r in reports]
            rows = [r.to_metrics() for r in reports]
            for r, row, p in zip(reports, rows, pools):
                cache = {k[6:]: v for k, v in row.items()
                         if k.startswith("cache_")}
                resil = {k[11:]: v for k, v in row.items()
                         if k.startswith("resilience_")}
                print(f"  {label} step {r.step}: loss {r.loss:.6f} "
                      f"{r.step_time:.3f}s fetch wait "
                      f"{r.stats.fetch_wait_time:.3f}s exposed wait "
                      f"{r.obs['exposed_wait_s']:.3f}s io_hidden_frac "
                      f"{r.obs['io_hidden_frac']:.4f} fetched "
                      f"{r.extra['stages_fetched']} stages; pool hits "
                      f"{p['hits']} misses {p['misses']} trimmed "
                      f"{p['trimmed']} bytes_allocated "
                      f"{p['bytes_allocated']}; resilience {resil}"
                      + (f"; cache {cache}" if cache else ""))
            print(f"  {label}: {spec.split(':')[0]} losses {losses}, "
                  f"flash launches {launches[label]}, stores "
                  f"{st.num_stores} loads {st.num_loads} store retries "
                  f"{st.store_retries} load retries {st.load_retries} "
                  f"fallbacks {st.fetch_fallbacks} {fallbacks}; "
                  f"{'; '.join(extra)}; pool {pool}"
                  + (f"; chaos report {report}" if chaos else ""))
            left = [f for _, _, fs in os.walk(work) for f in fs]
            check(losses == keep_losses[:steps],
                  f"storage {label}: losses {losses} differ from keep's "
                  f"{keep_losses[:steps]}")
            check(same, f"storage {label}: parameters differ from keep's "
                  f"after {steps} steps")
            check(not left, f"storage {label}: files left after close: "
                  f"{left[:5]}")
            layer_fallbacks = sum(name.startswith("seg")
                                  for name in fallbacks)
            check(launches[label] == 4 * steps + layer_fallbacks,
                  f"storage {label}: {launches[label]} flash launches "
                  f"for {steps} steps and {layer_fallbacks} recomputed "
                  f"layer stages")
            check(all(r.extra["stages_fetched"]
                      + row["resilience_fetch_fallbacks"] == n_stages
                      for r, row in zip(reports, rows)),
                  f"storage {label}: a stage was neither fetched nor "
                  f"recomputed")
            check(all("resilience_health" in row for row in rows),
                  f"storage {label}: a row without its resilience block")
            if label == "striped":
                check(len(dev_bytes) == 2 and min(dev_bytes) > 0,
                      f"storage striped: per-device bytes {dev_bytes}")
                check(len(pools) == 2 and pools[1]["hits"]
                      > pools[0]["hits"], "storage striped: no pool hit "
                      "in step 2 at the default idle cap")
            if label == "managed":
                # promotions are priced by measured rates (the SSD tier's
                # read against the host tier's write) and race the load
                # of the same key, as in the JAX manager: printed, not
                # required
                check(sum(row["cache_evictions"] for row in rows) > 0
                      and sum(row["cache_hints"] for row in rows) > 0,
                      "storage managed: no demotion or no reuse hint")
                check(all(row["cache_host_peak_bytes"]
                          <= row["cache_host_bound_bytes"] for row in rows),
                      "storage managed: the host bound was passed")
            if label == "aio":
                check(aio_direct is not None, "storage aio: no aio backend")
                check(len(pools) == 2 and pools[1]["hits"]
                      > pools[0]["hits"], "storage aio: no pool hit in "
                      "step 2")
            if chaos:
                check(st.load_retries > 0 and st.fetch_fallbacks > 0,
                      f"storage chaos: load retries {st.load_retries}, "
                      f"fallbacks {st.fetch_fallbacks}")
                check(report["rebalanced_chunks"] > 0
                      and report["devices_down"] == 1,
                      f"storage chaos: report {report}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"  storage and resilience: 4 runs bitwise equal to keep in "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def adaptive_check(label, policy, reps):
    """The adaptive plan against the paper's rule (§3.3.3), worked here
    from the profiled stages and the calibrated write rate: offloading
    stages 0..m needs (bytes of 0..m-1 + 2 x bytes of m) / (forward time
    of 1..m + (1 + bwd_factor) x forward time of m+1..) within the rate,
    and the plan takes the largest such m short of the last stage. The
    profiling step offloads every stage and reads blobs back. A planned
    step (drained: `drained_adaptive_policy`) reads blobs back where it
    stores bytes, and it does store bytes where the plan it started under
    holds a layer stage (the embed stage's saved token ids fall under the
    spool's size filter). The write rate is the
    calibrated tiers' rate for the plan's bytes, scaled as the policy
    scales it after a health event of the backend (a re-plan)."""
    from repro_torch.core.adaptive import effective_write_bandwidth
    prof, bw, plan = policy.profiles, policy.bandwidths, policy.plan
    nbytes = [p.bytes for p in prof]
    fwd = [p.fwd_time for p in prof]
    ev = policy.last_health_event
    scale = (1.0 if ev is None or ev.kind == "recovered" else
             0.0 if ev.kind == "failing" else 1 / max(ev.latency_ratio, 1))

    def plan_bytes(m):
        return sum(nbytes[:m]) + 2 * nbytes[m]

    def rate(m):
        r = (bw if isinstance(bw, (int, float)) else
             effective_write_bandwidth(bw, plan_bytes(m)))
        return r * scale

    def need(m):
        deadline = sum(fwd[1:m + 1]) + (1 + policy.bwd_factor) * sum(
            fwd[m + 1:])
        return plan_bytes(m) / deadline if deadline > 0 else float("inf")

    want = max((m for m in range(len(prof) - 1) if need(m) <= rate(m)),
               default=-1)
    m = plan.last_offloaded
    tiers = ("" if isinstance(bw, (int, float)) else " (tiers " + ", ".join(
        f"{t.name} {t.write_bw / 1e9:.3f} GB/s" for t in bw) + ")")
    print(f"  d{MATRIX_DEPTH} {label}: calibrated write rate "
          f"{rate(max(m, 0)) / 1e9:.3f} GB/s{tiers}, {policy.replans} "
          f"re-plans on health events (scale {scale:.3f}), profiled "
          f"forward {sum(fwd):.4f} s over "
          f"{len(prof)} stages; plan 0..{m} needs "
          f"{plan.required_bw / 1e9:.3f} GB/s"
          + (f", 0..{m + 1} would need {need(m + 1) / 1e9:.3f} GB/s"
             if m + 1 < len(prof) - 1 else "")
          + f"; planned steps store "
          f"{[r.stats.bytes_offloaded for r in reps[1:]]} bytes")
    check(m == want and plan.offload == [i <= want
                                         for i in range(len(prof))],
          f"{label}: plan 0..{m}, the rule gives 0..{want}")
    check(reps[0].stats.bytes_loaded > 0,
          f"{label}: the profiling step read nothing back")
    # each planned step against the plan it started under: the one in
    # force at the end of the step before (a re-plan swaps the object)
    for prev, r in zip(reps, reps[1:]):
        if prev.plan.last_offloaded >= 1:
            check(r.stats.bytes_offloaded > 0,
                  f"{label}: a plan with layer stages stored nothing")
        if r.stats.bytes_offloaded > 0:
            check(r.stats.bytes_loaded > 0,
                  f"{label}: a planned step read nothing back")


def matrix_phase():
    """Depth-cut policy matrix: every run bitwise equal to keep, and
    every run that offloads reads blobs back."""
    from repro_torch.configs import SpoolIoConfig, resolve_config
    from repro_torch.core.policies import (KeepPolicy, RecomputePolicy,
                                           SpoolPolicy)
    cfg = dataclasses.replace(resolve_config(TRAIN_ARCH),
                              num_layers=MATRIX_DEPTH)
    deterministic()
    lk, pk, _, _, _, _ = train_run(cfg, KeepPolicy(), None,
                                   f"d{MATRIX_DEPTH} keep")
    # Adaptive plans the offloaded prefix from the profiled forward time
    # and the backend's calibrated write rate, so on a slow directory the
    # plan may hold no layer stage: it is held to its own arithmetic
    # (adaptive_check) and must read blobs back where it stores bytes;
    # its planned steps are drained, so each step's writes land in its
    # own stats
    runs = [("recompute", RecomputePolicy(), None, 2),
            ("adaptive fs raw", drained_adaptive_policy(),
             SpoolIoConfig(backend="fs", codec="raw"), 1),
            ("adaptive mem raw", drained_adaptive_policy(),
             SpoolIoConfig(backend="mem", codec="raw"), 1),
            ("spool mem raw", SpoolPolicy(),
             SpoolIoConfig(backend="mem", codec="raw"), 1),
            ("spool fs zlib", drained_spool_policy(),
             SpoolIoConfig(backend="fs", codec="zlib"), 1)]
    for label, policy, io, fwd_per_layer in runs:
        l, same, reps, launches, peak, _ = train_run(
            cfg, policy, io, f"d{MATRIX_DEPTH} {label}", keep_params=pk)
        n = launches["ssd_scan"]
        plan = reps[-1].plan
        print(f"  d{MATRIX_DEPTH} {label}: losses {l} peak "
              f"{peak / 1e9:.2f} GB ssd launches {n}"
              + (f" plan offloads stages 0..{plan.last_offloaded}"
                 if plan is not None else ""))
        check(l == lk, f"{label}: losses differ from keep: {l} vs {lk}")
        check(same, f"{label}: parameters differ from keep")
        check(n == fwd_per_layer * MATRIX_DEPTH * TRAIN_STEPS,
              f"{label}: {n} ssd_scan launches")
        if label.startswith("adaptive"):
            adaptive_check(label, policy, reps)
        elif label != "recompute":
            check(all(r.stats.bytes_loaded > 0 for r in reps),
                  f"{label}: a step read nothing back from the spool")
        if "zlib" in label:
            check(all(r.stats.num_loads >= MATRIX_DEPTH for r in reps),
                  f"{label}: the layer stages were forwarded, not read "
                  f"back through the codec")
    print(f"  policy matrix at depth {MATRIX_DEPTH}: every run bitwise "
          f"equal to keep")


def host_free_line():
    """`free -g` of the card's host, on one line."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True)
    return " | ".join(" ".join(line.split()) for line in
                      out.stdout.strip().splitlines()[:2])


def bit_fingerprint(tensors):
    """Two 64-bit sums (mod 2**64) of the tensors' bit patterns (as
    int16 or int32 words), each element weighted by a fixed pseudo-random
    odd int64: equal bits give equal sums, and a differing element
    changes both unless weighted differences cancel (odds about 2**-33 a
    sum). Computed on the card in slices, so a 32 GB optimizer state
    needs no host copy to be compared between runs (host memory holds
    the spool's pool)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    acc = torch.zeros(2, dtype=torch.int64, device="cuda")
    for t in tensors:
        flat = t.detach().reshape(-1)
        bits = flat.view({2: torch.int16, 4: torch.int32}[
            flat.element_size()])
        for sl in bits.split(1 << 26):
            x = sl.to("cuda", non_blocking=False).to(torch.int64)
            w = torch.randint(-(1 << 62), 1 << 62, (2, x.numel()),
                              generator=gen, device="cuda",
                              dtype=torch.int64) | 1
            acc += (w * x).sum(dim=1)
            del x, w
    return tuple(acc.tolist())


def opt_run(cfg, label, *, engine="jit", host_offload="none",
            activations="keep", opt_overlap=None, steps=OPT_STEPS,
            keep_params=None, snap_at=None):
    """One run of phase 11: gpt-h8192-l1, adamw (lr 3e-4, no clipping),
    B=4, S=1024, fs, raw, traced (no file). (a) is the staged engine
    with KeepPolicy and the fused update; the others the jit engine with
    `activations` placement, `host_offload` and `opt_overlap`. Every
    kernel's launches are set to 0 just before the steps and read just
    after. Returns a dict: losses, reports, launches, the device peak,
    whether the spool dir was left empty, the fingerprints of the final
    parameters and moments ("fp"), the final parameters on the host or,
    given `keep_params`, whether they equal those ("params"), and with
    `snap_at` the fingerprints after that step ("snap")."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.policies import KeepPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import adamw
    from repro_torch.session import TrainSession
    kernels = (flash_attention, ssd_scan, rglru_scan)
    spool_dir = tempfile.mkdtemp(prefix="chip_smoke_opt_")
    io = SpoolIoConfig(backend="fs", directory=spool_dir, codec="raw",
                       pool_bytes=POOL_BYTES, host_offload=host_offload)
    kw = dict(io=io, optimizer=adamw(PAPER_LR, clip_norm=None),
              batch_size=PAPER_BATCH, seq_len=PAPER_SEQ, seed=0,
              device="cuda", attn_impl="cuda", trace_ring=1 << 16)
    if engine == "staged":
        kw["policy"] = KeepPolicy()
    else:
        kw["settings"] = RunSettings(
            attn_impl="cuda", attn_chunk=256, param_dtype=cfg.dtype,
            device="cuda", activation_policy=activations)
        kw["opt_overlap"] = opt_overlap
    sess = TrainSession(cfg, engine=engine, **kw)

    def fingerprints():
        """(parameters, moments) fingerprints of the session's state;
        the overlap's moments through `materialize()`."""
        bridge = sess.opt_bridge
        state = bridge.materialize() if bridge is not None \
            else sess.opt_state
        return (bit_fingerprint(tree_flatten(sess.params)[0]),
                bit_fingerprint(tree_flatten(state.mu)[0]
                                + tree_flatten(state.nu)[0]))

    out = {}
    try:
        sess.init()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        if snap_at:
            reports = sess.run(snap_at).reports
            out["snap"] = fingerprints()
            reports += sess.run(steps - snap_at).reports
        else:
            reports = sess.run(steps).reports
        run_s = time.perf_counter() - t0
        out["launches"] = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        out["fp"] = fingerprints()
        fp_s = time.perf_counter() - t0
        leaves = tree_flatten(sess.params)[0]
        out["params"] = ([t.detach().cpu() for t in leaves]
                         if keep_params is None
                         else same_params(leaves, keep_params))
        del leaves
        for r in reports:
            ex, st, ob = r.extra, r.stats, r.obs or {}
            line = (f"  {label} step {r.step}: loss {r.loss:.6f} "
                    f"{r.step_time:.3f}s peak "
                    f"{ex['device_peak_bytes'] / 1e9:.2f} GB")
            if "opt_updates" in ex:
                line += (f" opt_updates {int(ex['opt_updates'])} fetched "
                         f"{ex['opt_fetched_bytes'] / 1e9:.3f} GB staged "
                         f"{ex['opt_staged_bytes'] / 1e9:.3f} GB skipped "
                         f"{ex['opt_skipped_bytes'] / 1e9:.3f} GB")
            if st is not None:
                line += (f" spool offloaded {st.bytes_offloaded / 1e9:.3f}"
                         f" GB loaded {st.bytes_loaded / 1e9:.3f} GB "
                         f"forwarded {st.bytes_forwarded / 1e9:.3f} GB")
            line += (f" opt_io_busy_s {ob.get('opt_io_busy_s', 0.0):.3f}"
                     f" opt_exposed_wait_s "
                     f"{ob.get('opt_exposed_wait_s', 0.0):.3f} "
                     f"opt_hidden_frac {ob.get('opt_hidden_frac', 1.0):.3f}"
                     f" opt_update_s {ob.get('opt_update_s', 0.0):.3f}"
                     f" io_busy_s {ob.get('io_busy_s', 0.0):.3f}")
            print(line)
        if sess.spool is not None:
            print(f"  {label} pool: {pool_line(sess.spool)}")
        print(f"  {label} spans: {span_line()}")
        print(f"  {label}: {steps} steps in {run_s:.1f}s, materialize and "
              f"fingerprints {fp_s:.1f}s; host: {host_free_line()}")
        out["reports"] = reports
        out["peak"] = max(r.extra["device_peak_bytes"] for r in reports)
        out["losses"] = [r.loss for r in reports]
    finally:
        sess.close()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    left = os.listdir(spool_dir)
    if not left:
        os.rmdir(spool_dir)
    out["empty"] = not left
    check(all(math.isfinite(x) for x in out["losses"]),
          f"{label}: non-finite loss")
    return out


def span_line():
    """The training thread's opt fetch / stage spans of the run's trace
    (seconds, each)."""
    from repro_torch import obs
    events = obs.get_tracer().snapshot()

    def durs(name):
        return [round(ev[3] / 1e9, 3) for ev in events if ev[0] == name]
    return (f"engine.opt_fetch {durs('engine.opt_fetch')} engine.opt_stage "
            f"{durs('engine.opt_stage')} s")


def write_stall_probe(work):
    """On the filesystem under `work`: the unlink time of a 4 GiB blob,
    and the longest of eight 2 GiB device allocations made while an
    8 GiB registered pool buffer is written there in 2 GiB and in
    64 MiB syscalls, and with no write."""
    from repro_torch.io.bufpool import AlignedBufferPool
    n = 8 << 30
    pool = AlignedBufferPool(max_bytes=n)
    pool.register_cuda()
    lease = pool.acquire(n)
    torch.frombuffer(lease.mv[:n], dtype=torch.uint8).fill_(3)
    path = os.path.join(work, "chip_smoke_stall_probe.blob")

    def write(nbytes, chunk):
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        off = 0
        while off < nbytes:
            off += os.pwritev(fd, [lease.mv[off:min(off + chunk, nbytes)]],
                              off)
        os.close(fd)

    def longest_alloc():
        worst = 0.0
        for _ in range(8):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            x = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
            worst = max(worst, time.perf_counter() - t0)
            del x
        return worst

    try:
        write(4 << 30, 1 << 30)
        t0 = time.perf_counter()
        os.unlink(path)
        unlink_s = time.perf_counter() - t0
        out = {"alone": longest_alloc()}
        for chunk in (2 << 30, 64 << 20):
            w = threading.Thread(target=write, args=(n, chunk))
            w.start()
            time.sleep(0.3)
            out[chunk] = longest_alloc()
            w.join()
            os.unlink(path)
    finally:
        lease.release()
        pool.close()
        torch.cuda.empty_cache()
    print(f"opt: on {mount_of(work)[1]}: unlink of a 4 GiB blob "
          f"{unlink_s:.3f} s; longest 2 GiB device allocation "
          f"{out['alone']:.3f} s alone, {out[2 << 30]:.3f} s during an "
          f"8 GiB write from a registered buffer in 2 GiB syscalls, "
          f"{out[64 << 20]:.3f} s in 64 MiB syscalls")


def ssd_serve_check(gen, peaks, smi, lengths):
    """The SSD-scan kernel at the ragged prompt lengths of the serving
    trace (chunk pick_chunk(S, 128): S itself up to 128), an odd length
    and a length above 128 that halves the chunk to 8: y and the final
    state against the plain version, at the f32 cases' scales
    elementwise (TOL_SSD) and in the serve path's layout (bf16 B/C views
    of the conv output, full-width decays) relative to the output scale
    (TOL_SSD_PATH). Its time at the longest prompt beside its bound."""
    from repro_torch.kernels.ssd_scan import (pick_chunk, ssd_chunked,
                                              ssd_scan_fwd)
    H, P, N, d_inner = 80, 64, 128, 5120

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def path_inputs(S):
        conv = rand((1, S, d_inner + 2 * N)).bfloat16()
        return (rand((1, S, H, P)),
                -torch.nn.functional.softplus(rand((1, S, H))),
                conv[..., d_inner:d_inner + N], conv[..., d_inner + N:])

    worst = worst_rel = 0.0
    for S in sorted(set(lengths) | set(SERVE_EXTRA)):
        xh, a = rand((1, S, H, P)), -rand((1, S, H), 0.2).abs()
        Bs, Cs = rand((1, S, N)), rand((1, S, N))
        y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
        ok = all(bool(torch.all((g - w).abs() <= TOL_SSD + TOL_SSD * w.abs()))
                 for g, w in ((y, yr), (st, sr)))
        err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
        xh, a, Bs, Cs = path_inputs(S)
        y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
        rel = max((y - yr).abs().max().item() / yr.abs().max().item(),
                  (st - sr).abs().max().item() / sr.abs().max().item())
        ok = ok and rel <= TOL_SSD_PATH and bool(torch.isfinite(y).all())
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        print(f"  ssd_scan serve prefill S={S} chunk {pick_chunk(S, 128)}: "
              f"y and final state max_abs_err {err:.3e} (tol {TOL_SSD:g}), "
              f"bf16 B/C relative {rel:.3e} (tol {TOL_SSD_PATH:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), f"ssd_scan disagrees with its "
              f"plain version at the serve length {S}")
    S = max(lengths)
    xh, a, Bs, Cs = path_inputs(S)
    kernel_ms = time_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs, chunk=128))
    plain_ms = time_ms(lambda: ssd_chunked(xh, a, Bs, Cs, 128))
    b_ms, b_by = ssd_bound_ms(xh, a, Bs, Cs, 128, peaks)
    print(f"  ssd_scan serve prefill shape B=1 S={S} H={H} P={P} N={N} "
          f"bf16 B/C: kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_us {1e3 * b_ms:.2f} ({b_by}) on {smi}")
    return {"max_abs_err": worst, "rel_err": worst_rel, "S": S,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound": (b_ms, b_by)}


def flash_serve_check(gen, lengths):
    """The bf16 tensor-core flash instance at the shape recurrentgemma-9b's
    serving prefill gives it, q (1, S, 16, 256), k/v (1, S, 1, 256),
    causal, window 2048, at the trace's prompt lengths (ragged, partial
    query and key tiles) and SERVE_EXTRA's, against the f32 plain
    attention per row (TOL_BF16_ROW). Returns (max_abs_err, worst row
    relative error)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    worst = worst_rel = 0.0
    for S in sorted(set(lengths) | set(SERVE_EXTRA)):
        q = torch.randn((1, S, 16, 256), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((1, S, 1, 256), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        out = flash_attention(q, k, v, causal=True, window=2048)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=True, window=2048)
        err, rel, ok = attn_error(out, want, TOL_BF16_ROW)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        print(f"  flash_attention serve prefill S={S} Hq=16 Hkv=1 D=256 "
              f"causal window 2048 bf16: max_abs_err {err:.3e} "
              f"row_rel_err {rel:.3e} tol {TOL_BF16_ROW:g} of the row max "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention disagrees with its plain version at "
              f"the serve length {S}")
    return worst, worst_rel


def first_logits(api, params, batch, nxt, pos, cache_len, dtype, label):
    """The last prefill logits of `batch` and the first decode step's
    (token `nxt` at `pos`) through the kernels and through the plain
    path, in `dtype` weights: (prefill max_abs_err, decode max_abs_err,
    the plain decode logits' std, whether the two decode argmaxes
    agree)."""
    from repro_torch.models.transformer import RunSettings
    out = []
    V = api.cfg.vocab_size
    with torch.inference_mode():
        for impl in ("cuda", "torch"):
            st = RunSettings(attn_impl=impl, attn_chunk=256,
                             param_dtype=dtype, device="cuda")
            lp, cache = api.prefill(params, batch, st, cache_len=cache_len)
            ld = api.decode_step(params, cache, {"tokens": nxt}, pos, st)
            out.append((lp[..., :V].float(), ld[..., :V].float()))
            del cache
    (pk, dk), (pp, dp) = out
    check(bool(torch.isfinite(dk).all() and torch.isfinite(pk).all()),
          f"{label}: non-finite {dtype} logits")
    return ((pk - pp).abs().max().item(), (dk - dp).abs().max().item(),
            dp.std().item(), bool(dk.argmax() == dp.argmax()))


def serve_rest_arch(arch, gen, smi, want, bf16_tol):
    """One model of phase 12 at full width (random weights from seed 0):
    the first decode step's logits through the kernels against the plain
    path (in f32 at TOL_E2E_F32, in the served bf16 at `bf16_tol` where
    it is not None), then the trace served paged (fs, raw; every parked
    state checked on restore) and dense from the same parameters.
    `want`: kernel -> launches per prefill. Returns (the paged run's
    launches, the trace's prompt lengths)."""
    from benchmarks import torch_serve_kv
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    kernels = (flash_attention, ssd_scan, rglru_scan)
    t0 = time.perf_counter()
    cfg, api, params, settings = serve.build_runtime(arch, seed=0,
                                                     device="cuda")
    torch.cuda.synchronize()
    print(f"serve: {arch} weights ready in {time.perf_counter() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    S0 = REST_SERVE["prompt_len"] - 8
    toks = torch.randint(0, cfg.vocab_size, (1, S0), generator=gen,
                         device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device="cuda")

    def first(api_, params_, dtype):
        return first_logits(api_, params_, {"tokens": toks}, nxt,
                            torch.tensor([S0], device="cuda"),
                            REST_SERVE["cache_len"], dtype, arch)

    # the served weights cast to f32: there the two paths differ by the
    # order of f32 sums only; in bf16 a deep random model (mamba2's 64
    # layers) turns that order into logit differences of order one
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    leaves, tdef = tree_flatten(params)
    params32 = tree_unflatten(tdef, [t.float() for t in leaves])
    del leaves
    e32 = first(build_model(cfg32), params32, "float32")
    del params32
    torch.cuda.empty_cache()
    e16 = first(api, params, cfg.dtype)
    for dtype, (err_p, err_d, std, same) in (("float32", e32),
                                             (cfg.dtype, e16)):
        bar = (f"tol {TOL_E2E_F32:g}" if dtype == "float32" else
               f"tol {bf16_tol:g}" if bf16_tol is not None else "no bar")
        print(f"  {arch} {dtype} prefill (S={S0}) then one decode step, "
              f"kernels vs plain path: last prefill logits max_abs_err "
              f"{err_p:.3e}, first decode logits {err_d:.3e} (logit std "
              f"{std:.3f}, {bar}), decode argmax equal {same}")
    check(max(e32[:2]) <= TOL_E2E_F32, f"{arch}: f32 logits through the "
          f"kernels differ from the plain path by {max(e32[:2])}")
    check(bf16_tol is None or max(e16[:2]) <= bf16_tol, f"{arch}: "
          f"{cfg.dtype} logits through the kernels differ from the plain "
          f"path by {max(e16[:2])}")

    args = torch_serve_kv.parse_args(
        [f"--{k.replace('_', '-')}={v}" for k, v in REST_SERVE.items()]
        + ["--prefetch-depth=2", "--seed=0"])
    runs = {}
    for kind in ("paged", "dense"):
        kv_dir = tempfile.mkdtemp(prefix="chip_smoke_kv_") \
            if kind == "paged" else None
        where = " ".join(mount_of(kv_dir)) if kv_dir else ""
        spool = (serve.build_kv_spool("fs", kv_dir, "raw", cuda=True)
                 if kind == "paged" else None)
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t1 = time.perf_counter()
        try:
            srv, rep, _, parking = torch_serve_kv.run_side(
                (cfg, api, params, settings), kind, args, spool)
        finally:
            if spool is not None:
                spool.close()
        secs = time.perf_counter() - t1
        launches = {k.__name__: k.launches for k in kernels}
        left = os.listdir(kv_dir) if kv_dir else []
        if kv_dir and not left:
            os.rmdir(kv_dir)
        restores = parking["restores"]
        for line in serve.report_lines(rep):
            print(f"  {arch} {kind}: {line}")
        print(f"  {arch} {kind}: {secs:.2f}s (server build included), "
              f"launches {launches}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, ttft p50 "
              f"{rep.ttft_p50_ms:.1f} ms, itl p50 {rep.itl_p50_ms:.2f} ms "
              f"p99 {rep.itl_p99_ms:.2f} ms, decode {rep.decode_tok_s:.1f} "
              f"tok/s"
              + (f"; {len(restores)} restores checked leaf by leaf "
                 f"({sum(n for _, n in restores)} leaves); spool dir on "
                 f"{where}" if spool else ""))
        for name, per in want.items():
            check(launches[name] == per * rep.kv["prefills"],
                  f"{arch} {kind}: {name} launches {launches[name]}, want "
                  f"{per} x {rep.kv['prefills']} prefills")
        check(not parking["mismatched"], f"{arch}: restored state differs "
              f"from the parked one: {parking['mismatched'][:5]}")
        check(not left, f"{arch}: spool directory not empty after close: "
              f"{left[:5]}")
        runs[kind] = (srv, rep, launches, restores)
    (sp, rp, lp, restores), (sd, _, _, _) = runs["paged"], runs["dense"]
    check(rp.preemptions > 0 and rp.kv["evictions"] > 0,
          f"{arch}: no preemption in the paged run")
    check(rp.kv["restores"] == rp.kv["evictions"] == len(restores),
          f"{arch}: {rp.kv['evictions']} evictions, {rp.kv['restores']} "
          f"restores, {len(restores)} checked")
    check(rp.kv["pages_evicted"] == rp.kv["pages_restored"]
          and rp.kv["bytes_evicted"] == rp.kv["bytes_restored"] > 0,
          f"{arch}: evicted pages/bytes differ from the restored")
    check(len(sp.finished) == REST_SERVE["requests"]
          and torch_serve_kv.bitwise_parity(sp, sd),
          f"{arch}: paged tokens or logits differ from the dense ones")
    rows = sum(len(s.logits) for s in sp.finished)
    check(all(r.shape == (cfg.padded_vocab,) for s in sp.finished
              for r in s.logits), f"{arch}: logits rows of the wrong width")
    print(f"  {arch} paged vs dense: {rows} logits rows bitwise equal, "
          f"tokens equal for {len(sp.finished)} requests; "
          f"{rp.kv['evictions']} states parked ({rp.kv['bytes_evicted']} "
          f"bytes, {rp.kv['pages_evicted']} pages) and restored bitwise; "
          f"{time.perf_counter() - t0:.1f}s on {smi}")
    lengths = [len(s.prompt) for s in sp.finished]
    del sp, sd, runs, params, api
    gc.collect()
    torch.cuda.empty_cache()
    return lp, lengths


def serve_rest_phase(gen, peaks, smi):
    """Phase 12: mamba2-2.7b and recurrentgemma-9b served at full width;
    the SSD and flash kernels at the trace's ragged prefill lengths.
    Returns ({arch: the paged run's launches}, the SSD serve-shape
    numbers, the flash serve-shape errors)."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.api import build_model
    rg = resolve_config(RG_ARCH)
    kinds = [b.mixer for seg in build_model(rg).segments
             for _ in range(seg.n_repeat) for b in seg.blocks]
    t0 = time.perf_counter()
    m2, lengths = serve_rest_arch(
        TRAIN_ARCH, gen, smi,
        {"ssd_scan": resolve_config(TRAIN_ARCH).num_layers,
         "flash_attention": 0, "rglru_scan": 0}, None)
    ssd = ssd_serve_check(gen, peaks, smi, lengths)
    rgl, lengths = serve_rest_arch(
        RG_ARCH, gen, smi,
        {"rglru_scan": kinds.count("rglru"),
         "flash_attention": kinds.count("attn"), "ssd_scan": 0}, TOL_E2E)
    flash = flash_serve_check(gen, lengths)
    print(f"serve the rest: {time.perf_counter() - t0:.1f}s")
    return {TRAIN_ARCH: m2, RG_ARCH: rgl}, ssd, flash


def registry_phase(gen, smi):
    """Phase 13: the registry's archs of REG_TRAIN kept vs spooled at
    S=REG_SEQ with sgd (keep_vs_spool's checks; one flash launch per
    attention block per step; REG_F32's in f32), then REG_SERVE served
    at full width as phase 12 serves. Returns ({arch: the spool run's
    launches}, the paged serve run's launches, {arch: the keep run's
    losses} of REG_F32's archs)."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.transformer import build_segments
    from repro_torch.optim.optimizers import sgd
    out, keep_losses = {}, {}
    for arch, layers, batch in REG_TRAIN:
        t0 = time.perf_counter()
        cfg = resolve_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if arch in REG_F32:
            cfg = dataclasses.replace(cfg, dtype="float32")
        keep_out = {}
        segs = build_segments(cfg)
        n_attn = sum(seg.n_repeat * sum(b.mixer == "attn"
                                        for b in seg.blocks)
                     for seg in segs)
        out[arch] = keep_vs_spool(
            cfg, REG_SEQ, sgd(PAPER_LR),
            {"flash_attention": n_attn * REG_STEPS, "ssd_scan": 0,
             "rglru_scan": 0}, smi, batch=batch,
            stages=sum(seg.n_repeat for seg in segs) + 2,
            label=f"{arch}" + (f" d{layers}" if layers else ""),
            policy=drained_spool_policy() if layers else None,
            act_lower=True, steps=REG_STEPS, keep_out=keep_out)
        if arch in REG_F32:
            keep_losses[arch] = keep_out["losses"]
        del keep_out
        print(f"  {arch}: {time.perf_counter() - t0:.1f}s")
    n_layers = resolve_config(REG_SERVE).num_layers
    serve_launches, _ = serve_rest_arch(
        REG_SERVE, gen, smi, {"flash_attention": n_layers, "ssd_scan": 0,
                              "rglru_scan": 0}, TOL_E2E)
    return out, serve_launches, keep_losses


def vision_pages(caches, paged, tables, n_phys, page):
    """A prefill's dense caches as `decode_step_paged` reads them: each
    paged block's K/V laid into a pool of `n_phys` pages of `page`
    tokens at its rows' `tables` pages, and the other blocks' entries
    (the cross K/V over the patch embeddings) cloned as resident ones.
    Returns (pools, resident)."""
    pools, resident = [], []
    for seg, ids in zip(caches, paged):
        pool_seg, res_seg = {}, {}
        for bid, entry in seg.items():
            if bid not in ids:
                res_seg[bid] = {k: v.clone() for k, v in entry.items()}
                continue
            kv = {}
            for name, dense in entry.items():          # (L, B, S, H, D)
                pool = torch.zeros((dense.shape[0], n_phys, page)
                                   + dense.shape[3:], dtype=dense.dtype,
                                   device=dense.device)
                for b in range(dense.shape[1]):
                    for j in range(dense.shape[2] // page):
                        pool[:, int(tables[b, j])] = \
                            dense[:, b, j * page:(j + 1) * page]
                kv[name] = pool
            pool_seg[bid] = kv
        pools.append(pool_seg)
        resident.append(res_seg)
    return pools, resident


def vision_phase(smi):
    """Phase 14: llama-3.2-vision-90b at full width cut to VISION_LAYERS
    layers (random bf16 weights from seed 0, sgd at PAPER_LR, S=REG_SEQ,
    B=VISION_BATCH, batches of `data.pipeline.vision_batches`): (a) kept
    vs spooled through `drained_spool_policy` (keep_vs_spool's checks, 5
    stages, one flash launch per attention block per step); (b) the jit
    name under activation_policy "offload" (the host tier), bitwise equal
    to (a)'s keep run, two flash launches per attention block per step,
    its tracked footprint at backward begin keep's minus the layer
    stages' saved bytes and its tracked and device peaks below keep's,
    nothing stored; (c) a VISION_PROMPT-token prefill with its patch
    embeddings, then VISION_NEW tokens through `decode_step` and
    `decode_step_paged` (the cross K/V resident), tokens and logits
    bitwise equal, and the first logits through the kernel against the
    plain path (TOL_E2E in bf16, TOL_E2E_F32 in an f32 copy of the
    weights). Returns {"train", "host_tier", "prefill"}: the flash launches
    of (a)'s spool run, of (b) and of the prefill."""
    from repro_torch.configs import resolve_config
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kvcache.adapters import paged_block_ids
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    t0 = time.perf_counter()
    cfg = dataclasses.replace(resolve_config(VISION_ARCH),
                              num_layers=VISION_LAYERS)
    B, label = VISION_BATCH, f"{VISION_ARCH} d{VISION_LAYERS}"
    per_step = {"flash_attention": VISION_LAYERS, "ssd_scan": 0,
                "rglru_scan": 0}
    keep = {}
    train_launches = keep_vs_spool(
        cfg, REG_SEQ, sgd(PAPER_LR),
        {k: n * VISION_STEPS for k, n in per_step.items()}, smi, batch=B,
        stages=VISION_LAYERS // cfg.cross_attn_period + 3, label=label,
        policy=drained_spool_policy(), act_lower=True, keep_out=keep,
        steps=VISION_STEPS)
    t_a = time.perf_counter()
    print(f"  (a) keep vs spool: {t_a - t0:.1f}s")

    # (b) the host tier: the jit name, layers recomputed, their inputs in
    # pinned host memory between forward and backward
    tier = RunSettings(attn_impl="cuda", attn_chunk=256,
                       param_dtype=cfg.dtype, device="cuda",
                       activation_policy="offload")
    lh, same, rh, nh, peak_h, _ = train_run(
        cfg, None, None, f"{label} host tier", optimizer=sgd(PAPER_LR),
        seq=REG_SEQ, batch=B, keep_params=keep.pop("params"),
        settings=tier, engine="jit", steps=VISION_STEPS)
    rk, peak_k = keep["reports"], keep["peak"]
    act_k = max(r.peak_activation_bytes for r in rk)
    act_h = max(r.peak_activation_bytes for r in rh)
    # every layer stage's bf16 input
    inputs = (VISION_LAYERS // cfg.cross_attn_period) * B * REG_SEQ \
        * cfg.d_model * 2
    print(f"train: {label} host tier (jit name, activation_policy "
          f"'offload'), B={B}: losses {lh}; step times "
          f"{[round(r.step_time, 3) for r in rh]} s (keep "
          f"{[round(r.step_time, 3) for r in rk]}); device peak "
          f"{peak_h / 1e9:.2f} GB (keep {peak_k / 1e9:.2f}); tracked "
          f"activation peak {act_h / 1e9:.3f} GB (keep {act_k / 1e9:.3f}), "
          f"at backward begin {rh[-1].backward_begin_bytes / 1e9:.3f} GB "
          f"(keep {rk[-1].backward_begin_bytes / 1e9:.3f}); the layer "
          f"stages' inputs, {inputs / 1e6:.1f} MB a step, on the host "
          f"between forward and backward; launches {nh} on {smi}")
    check(lh == keep["losses"], f"host tier losses {lh} differ from keep "
          f"{keep['losses']}")
    check(same, "host tier parameters differ from keep's")
    for name, n in per_step.items():
        check(nh[name] == 2 * n * VISION_STEPS, f"host tier {name} launches "
              f"{nh[name]}, want {2 * n * VISION_STEPS}")
    for r, k in zip(rh, rk):
        check(r.backward_begin_bytes == k.backward_begin_bytes
              - k.extra["layer_saved_bytes"], f"host tier step {r.step}: "
              f"tracked {r.backward_begin_bytes} at backward begin, keep "
              f"{k.backward_begin_bytes} less its layers' "
              f"{k.extra['layer_saved_bytes']}")
    check(act_h < act_k, f"host tier tracked peak {act_h} not below keep "
          f"{act_k}")
    check(peak_h < peak_k, f"host tier device peak {peak_h} not below "
          f"keep {peak_k}")
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    print(f"  (b) host tier: {t_b - t_a:.1f}s")

    # (c) decode: prefill, then dense and paged decode steps
    api = build_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (1, VISION_PROMPT))).cuda(),
             "enc_embeddings": torch.from_numpy(rng.standard_normal(
                 (1, cfg.encoder_seq_len, cfg.d_model),
                 dtype=np.float32)).cuda()}
    cache_len = VISION_PROMPT + VISION_NEW
    V = cfg.vocab_size
    pos0 = torch.tensor([VISION_PROMPT], device="cuda")
    nxt = torch.from_numpy(rng.integers(0, V, (1, 1))).cuda()

    def first(api_, params_, dtype):
        """The larger of the prefill's and the decode step's max_abs_err
        (kernel vs plain), and the plain decode logits' std."""
        pre, dec, std, _ = first_logits(api_, params_, batch, nxt, pos0,
                                        cache_len, dtype, label)
        return max(pre, dec), std

    e16 = first(api, params, cfg.dtype)
    st = RunSettings(attn_impl="cuda", attn_chunk=256, param_dtype=cfg.dtype,
                     device="cuda")
    n_pages = cache_len // VISION_PAGE
    tables = torch.arange(n_pages, 0, -1, device="cuda")[None]  # 4, 3, 2, 1
    with torch.inference_mode():
        flash_attention.launches = 0
        last, caches = api.prefill(params, batch, st, cache_len=cache_len)
        pre_launches = flash_attention.launches
        paged = paged_block_ids(api.segments, cache_len)
        pools, resident = vision_pages(caches, paged, tables, n_pages + 1,
                                       VISION_PAGE)
        cross = [e["k"].clone() for seg in resident for e in seg.values()]
        runs = {}
        t_dec = {}
        for kind in ("dense", "paged"):
            tok = last[..., :V].argmax(-1)
            toks, rows = [], []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(VISION_NEW):
                pos = pos0 + t
                if kind == "dense":
                    logits = api.decode_step(params, caches, {"tokens": tok},
                                             pos, st)
                else:
                    logits = api.decode_step_paged(
                        params, pools, resident, tables, {"tokens": tok},
                        pos, st)
                rows.append(logits)
                tok = logits[..., :V].argmax(-1)
                toks.append(int(tok))
            torch.cuda.synchronize()
            t_dec[kind] = time.perf_counter() - t1
            runs[kind] = (toks, rows)
    same_rows = all(torch.equal(a, b) for a, b in zip(runs["dense"][1],
                                                       runs["paged"][1]))
    cross_kept = all(torch.equal(a, e["k"]) for a, e in zip(
        cross, [e for seg in resident for e in seg.values()]))
    print(f"  {label} decode: prefill of {VISION_PROMPT} tokens launched "
          f"flash {pre_launches} times; {VISION_NEW} tokens dense "
          f"{runs['dense'][0]} in {t_dec['dense']:.3f}s, paged "
          f"({VISION_PAGE}-token pages, the cross K/V resident) in "
          f"{t_dec['paged']:.3f}s; tokens "
          f"{'equal' if runs['dense'][0] == runs['paged'][0] else 'DIFFER'}"
          f", logits rows {'bitwise equal' if same_rows else 'DIFFER'}")
    check(pre_launches == VISION_LAYERS, f"{pre_launches} flash launches in "
          f"the prefill, want {VISION_LAYERS}")
    check(runs["dense"][0] == runs["paged"][0], "paged and dense decode "
          "tokens differ")
    check(same_rows, "paged and dense decode logits differ")
    check(cross_kept, "a paged decode step wrote a resident cross entry")
    del caches, pools, resident, runs, last
    # the f32 copy takes the bf16 weights' place a leaf at a time: both
    # would not fit at once
    leaves, tdef = tree_flatten(params)
    del params
    for i, t in enumerate(leaves):
        leaves[i] = t.float()
        del t
    params32 = tree_unflatten(tdef, leaves)
    del leaves
    torch.cuda.empty_cache()
    e32 = first(build_model(dataclasses.replace(cfg, dtype="float32")),
                params32, "float32")
    del api, params32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {label} first logits (prefill of {VISION_PROMPT} tokens with "
          f"{cfg.encoder_seq_len} patch embeddings, and one decode step), "
          f"kernel vs plain attention: f32 copy of the weights max_abs_err "
          f"{e32[0]:.3e} (tol {TOL_E2E_F32:g}; logit std {e32[1]:.3f}), "
          f"bf16 {e16[0]:.3e} (tol {TOL_E2E:g}; logit std {e16[1]:.3f})")
    check(e32[0] <= TOL_E2E_F32, f"{label}: f32 first logits through the "
          f"kernel differ from the plain path by {e32[0]}")
    check(e16[0] <= TOL_E2E, f"{label}: bf16 first logits through the "
          f"kernel differ from the plain path by {e16[0]}")
    print(f"  (c) decode: {time.perf_counter() - t_b:.1f}s")
    return {"train": train_launches["flash_attention"],
            "host_tier": nh["flash_attention"], "prefill": pre_launches}


def opt_phase(smi):
    """Phase 11: the optimizer state and the jit engine on the paper's
    GPT with adamw: (a) staged, keep, the fused update; (b) jit, the
    state staged through the spool between steps; (c) jit with the
    optimizer overlap; (d) (c) with the activations on the spool too;
    (e) the overlap's "sync" drain, 2 steps. Losses equal to (a)'s,
    final parameters equal to (a)'s (exactly; (e)'s by fingerprint
    against (a) after step 2) and final moments' fingerprints equal to
    (a)'s at the same step, a flash launch per layer a step, moments
    fetched in
    steps 2-3, the spool dirs empty, and (c)'s device peak at least
    OPT_DROP_GB below (a)'s. Returns (c)'s flash launches."""
    from repro_torch.configs import gpt
    cfg = gpt(PAPER_HIDDEN, OPT_LAYERS)
    deterministic()
    work = tempfile.gettempdir()
    mnt, fstype = mount_of(work)
    free = shutil.disk_usage(work).free
    print(f"opt: spool dirs on {mnt} ({fstype}), {free / 1e9:.1f} GB "
          f"free; host: {host_free_line()}")
    check(free >= OPT_FREE_GB * 1e9, f"opt: {free / 1e9:.1f} GB free "
          f"under {work}, need {OPT_FREE_GB} GB for phase 11")
    write_stall_probe(work)
    a = opt_run(cfg, "(a) staged keep", engine="staged",
                snap_at=(OPT_SYNC_STEPS if OPT_SYNC_STEPS < OPT_STEPS
                         else None))
    runs = {
        "(b) jit opt_state": dict(host_offload="opt_state"),
        "(c) jit overlap": dict(opt_overlap=True),
        "(d) jit activations+overlap": dict(host_offload="activations",
                                            activations="spool",
                                            opt_overlap=True),
        "(e) jit sync": dict(opt_overlap="sync", steps=OPT_SYNC_STEPS),
    }
    out = {label: opt_run(cfg, label, keep_params=a["params"], **kw)
           for label, kw in runs.items()}
    n_leaves = len(a.pop("params"))
    check(a["launches"]["flash_attention"] == OPT_LAYERS * OPT_STEPS,
          f"(a) flash launches {a['launches']['flash_attention']}")
    for label, r in out.items():
        steps = len(r["reports"])
        want_fp = a["fp"] if steps == OPT_STEPS else a["snap"]
        check(r["losses"] == a["losses"][:steps], f"{label}: losses "
              f"{r['losses']} != (a)'s {a['losses'][:steps]}")
        if steps == OPT_STEPS:
            check(r["params"], f"{label}: final parameters differ from "
                  f"(a)'s")
        check(r["fp"][0] == want_fp[0], f"{label}: parameters' "
              f"fingerprint differs from (a)'s after {steps} steps")
        check(r["fp"][1] == want_fp[1], f"{label}: moments' fingerprint "
              f"{r['fp'][1]} differs from (a)'s {want_fp[1]} after "
              f"{steps} steps")
        check(r["launches"]["flash_attention"] == OPT_LAYERS * steps,
              f"{label}: flash launches "
              f"{r['launches']['flash_attention']}, want "
              f"{OPT_LAYERS * steps}")
        check(r["empty"], f"{label}: spool directory not empty after "
              f"close")
        for rep in r["reports"][1:]:
            fetched = (rep.extra["opt_fetched_bytes"]
                       if "opt_fetched_bytes" in rep.extra
                       else rep.stats.bytes_loaded
                       + rep.stats.bytes_forwarded)
            check(fetched > 0, f"{label}: step {rep.step} fetched no "
                  f"moments")
    peak_c = out["(c) jit overlap"]["peak"]
    drop = (a["peak"] - peak_c) / 1e9
    print(f"opt: losses {a['losses']}; device peaks (a) "
          f"{a['peak'] / 1e9:.2f} GB, "
          + ", ".join(f"{k[:3]} {v['peak'] / 1e9:.2f} GB"
                      for k, v in out.items())
          + f"; (c) is {drop:.2f} GB lower (bar {OPT_DROP_GB} GB) on {smi}")
    check(drop >= OPT_DROP_GB, f"(c)'s device peak only {drop:.2f} GB "
          f"below (a)'s, want >= {OPT_DROP_GB}")
    print(f"  (b)-(e): losses bitwise equal to (a)'s, (b)-(d) final "
          f"{n_leaves} parameter leaves bitwise equal, parameters' and "
          f"moments' fingerprints equal to (a)'s at the same step")
    return out["(c) jit overlap"]["launches"]["flash_attention"]


def mesh_run(label, work, *, mesh=None, axes=None, offload=False,
             dedupe=True, cfg=None, loader=None, optimizer=None,
             batch=MESH_BATCH, overlap=None, save_dir=None, resume_dir=None,
             keep_params=None, host_params=False, fingerprints=False):
    """One run of phases 15 and 17 in this process: one device (`mesh`
    None) or this rank of `mesh`, MESH_STEPS steps of the jit engine on
    `cfg` (gpt-h8192-l1 in f32 by default) with `optimizer` (sgd at
    PAPER_LR by default) at B=`batch`, S=PAPER_SEQ; every layer kept, or
    with `offload` spooled into `work/label` (a directory every rank of
    the mesh shares); `overlap`: the optimizer overlap, each rank's
    moments on its spool in `work/label`. `save_dir`: after step 1 the
    train state is checkpointed there (`ckpt.save_train_state` through a
    `ShardLayout`: the logical arrays, gathered over the ranks, and
    written by rank 0 in the background, its `CheckpointManager` under
    "ckpt_manager") and the run goes on; `resume_dir`: the run starts
    from the checkpoint there (each rank restores its shards in place)
    and takes the steps after it. Flash launches are set to 0 just before
    the steps and read just after. Returns losses, launches, the tracked
    and device peaks, the run's shard totals over the ranks, the bytes
    staged through host memory, with `offload` or `overlap` what the
    dir holds after close, the checkpoint's gather and snapshot seconds,
    with
    `host_params` the final parameters on the host (given `keep_params`,
    whether they equal those), and with `fingerprints` those of the
    parameters and moments (`materialize()` under the overlap)."""
    from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                             restore_train_state,
                                             save_train_state)
    from repro_torch.configs import SpoolIoConfig, gpt
    from repro_torch.core.meshrun import ShardLayout
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import rglru_scan, ssd_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    from repro_torch.session import TrainSession
    cfg = cfg or dataclasses.replace(gpt(PAPER_HIDDEN, MESH_LAYERS),
                                     dtype="float32")
    d = os.path.join(work, label)
    spooled = offload or overlap
    if spooled:
        os.makedirs(d, exist_ok=True)
    io = SpoolIoConfig(backend="fs", directory=d, codec="raw",
                       pool_bytes=POOL_BYTES,
                       host_offload="activations" if offload else "none",
                       dedupe_replicas=dedupe) if spooled else None
    settings = None if offload else RunSettings(
        attn_impl="cuda", attn_chunk=256, param_dtype=cfg.dtype,
        device="cuda", activation_policy="keep")
    t_wall = time.perf_counter()
    sess = TrainSession(cfg, engine="jit", io=io, settings=settings,
                        optimizer=optimizer or sgd(PAPER_LR),
                        batch_size=batch, seq_len=PAPER_SEQ, seed=0,
                        device="cuda", attn_impl="cuda", loader=loader,
                        mesh=mesh, mesh_axes=axes, opt_overlap=overlap)

    def manager(path):
        return CheckpointManager(path, layout=None if mesh is None else
                                 ShardLayout(mesh, sess.engine.mesh_run.specs,
                                             "cuda"))

    out = {}
    try:
        sess.init()
        steps = MESH_STEPS
        if resume_dir is not None:
            t0 = time.perf_counter()
            mgr = manager(resume_dir)
            step, _, sess.opt_state = restore_train_state(
                mgr, sess.params, sess.opt_state, sess.loader)
            out["restore_s"] = time.perf_counter() - t0
            check(step == 1, f"mesh ({label}): restored step {step}")
            steps -= step
        for k in (flash_attention, ssd_scan.ssd_scan, rglru_scan.rglru_scan):
            k.launches = 0
        t0 = time.perf_counter()
        if save_dir is not None:
            reps = sess.run(1).reports
            t1 = time.perf_counter()
            # the write runs on rank 0's checkpoint thread while the
            # phase goes on; the caller joins it (`ckpt_manager`)
            mgr = out["ckpt_manager"] = manager(save_dir)
            save_train_state(mgr, sess.step, sess.params, sess.opt_state,
                             sess.loader)
            out["save_s"] = time.perf_counter() - t1
            reps += sess.run(steps - 1).reports
            run_s = time.perf_counter() - t0 - out["save_s"]
        else:
            reps = sess.run(steps).reports
            run_s = time.perf_counter() - t0
        out.update({
            "s": run_s, "launches": flash_attention.launches,
            "ssd_launches": ssd_scan.ssd_scan.launches,
            "rglru_launches": rglru_scan.rglru_scan.launches,
            "losses": [r.loss for r in reps],
            "tracked": max(r.peak_activation_bytes for r in reps),
            "device": max(r.extra["device_peak_bytes"] for r in reps),
            "shards": sess.shard_totals() if mesh is not None else {},
            "staged": sum(r.extra.get("comm_host_staged_bytes", 0)
                          for r in reps),
            "comm_s": {k: sum(r.extra.get(f"comm_{k}_s", 0.0)
                              for r in reps)
                       for k in ("total", "wait", "stage")},
            "backend": (reps[-1].extra.get("comm_backend")
                        if mesh is not None else None),
            "steps_s": [r.step_time for r in reps]})
        leaves = tree_flatten(sess.params)[0]
        if fingerprints:
            bridge = sess.opt_bridge
            state = bridge.materialize() if bridge is not None \
                else sess.opt_state
            out["fp"] = (bit_fingerprint(leaves), bit_fingerprint([
                t for t in tree_flatten(state.mu)[0]
                + tree_flatten(state.nu)[0] if t is not None]))
            del state
        if keep_params is not None:
            out["same_params"] = same_params(leaves, keep_params)
        elif host_params:
            out["params"] = [t.detach().cpu() for t in leaves]
        del leaves
    finally:
        sess.close()      # on a mesh: after every rank's spool closed
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    if spooled:
        out["left"] = sorted(os.listdir(d))
    out["wall"] = time.perf_counter() - t_wall
    return out


def _rank_setup(rank, port, work):
    """A spawned rank of phases 15-17: gloo over the loopback device,
    f32 matmuls without TF32, deterministic kernels, the process group
    (a file `ready<rank>` in `work` says it has joined); then it waits for the parent's one-device run (a) to end and give the
    card's memory back."""
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.parallel.comm import single_node_gloo
    single_node_gloo()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=MESH_RANKS)
    open(os.path.join(work, f"ready{rank}"), "w").close()
    deadline = time.perf_counter() + 600
    while not os.path.exists(os.path.join(work, "a_done")):
        if time.perf_counter() > deadline:
            raise RuntimeError("(a) did not end within 600 s")
        time.sleep(0.05)


def _mesh_rank(rank, port, work):
    """One of phase 15's ranks: (b)-(f), (h) and (i) on a 1x2 mesh, (g) on
    a 2x1 one from (b)'s checkpoint; its results (or its traceback)
    pickled into `work`."""
    import pickle
    import traceback
    import torch.distributed as dist
    try:
        _rank_setup(rank, port, work)
        from repro_torch.optim.optimizers import adamw
        from repro_torch.parallel.comm import init_mesh
        from repro_torch.parallel.sharding import MeshAxes
        mesh = init_mesh((1, MESH_RANKS), ("data", "model"), device="cuda")
        res = {"describe": mesh.comm.describe()}
        ck = os.path.join(work, "ckpt")
        res["b"] = mesh_run("b", work, mesh=mesh, save_dir=ck)
        res["c"] = mesh_run("c", work, mesh=mesh, offload=True)
        res["d"] = mesh_run("d", work, mesh=mesh, offload=True)
        dp_only = MeshAxes(dp=("data",), tp=None)
        res["e"] = mesh_run("e", work, mesh=mesh, axes=dp_only,
                            offload=True)
        res["f"] = mesh_run("f", work, mesh=mesh, axes=dp_only,
                            offload=True, dedupe=False)
        res["h"] = mesh_run("h", work, mesh=mesh,
                            optimizer=adamw(PAPER_LR, clip_norm=None),
                            host_params=True, fingerprints=True)
        res["i"] = mesh_run("i", work, mesh=mesh,
                            optimizer=adamw(PAPER_LR, clip_norm=None),
                            overlap=True, keep_params=res["h"].pop("params"),
                            fingerprints=True)
        # (b)'s checkpoint has landed before (g) reads it
        mgr = res["b"].pop("ckpt_manager")
        mgr.wait()
        res["b"]["write_s"] = mgr.last_write_s
        npz = os.path.join(ck, "step_00000001", "arrays.npz")
        res["b"]["ckpt_bytes"] = (os.path.getsize(npz) if rank == 0 else 0)
        mesh.comm.barrier()
        mesh2 = init_mesh((MESH_RANKS, 1), ("data", "model"),
                          device="cuda")
        res["g"] = mesh_run("g", work, mesh=mesh2, resume_dir=ck)
        mesh2.comm.barrier()
        if rank == 0:
            shutil.rmtree(ck)
        res["ckpt_left"] = os.path.exists(ck) if rank == 0 else False
        # phase 19 (d): the collectives of a step against the dry run's
        res["counts"] = comm_count_check(mesh)
        # phase 20's (b) and (c)
        res["serve"] = sm_rank_runs(mesh, mesh2, work)
        dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(target, work, parent_runs):
    """Start MESH_RANKS ranks running `target(rank, port, work)`, run
    `parent_runs()` here while they start, then tell them it ended and
    join them. Returns (what `parent_runs` returned, each rank's
    results, the seconds from the start to the join)."""
    import pickle
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = torch.multiprocessing.start_processes(
        target, args=(port, work), nprocs=MESH_RANKS, start_method="spawn",
        join=False)
    try:
        here = parent_runs()
    finally:
        open(os.path.join(work, "a_done"), "w").close()
    try:
        while not procs.join():
            pass
    except Exception as e:                    # noqa: BLE001
        fail(f"the {MESH_RANKS} ranks of {target.__name__} did not run: {e}")
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(MESH_RANKS):
        path = os.path.join(work, f"rank{r}.pkl")
        check(os.path.exists(path), f"{target.__name__}: rank {r} reported "
              f"nothing")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        check("error" not in ranks[r], f"{target.__name__}: rank {r} "
              f"failed:\n{ranks[r].get('error')}")
    return here, ranks, ranks_s


def mesh_flash_check(gen, peaks, smi):
    """The flash kernel at the shape a tp=2 rank gives it (MESH_ATTN,
    causal), in f32 (the phase's dtype) and bf16, against its plain
    version at phase 3's bars; the f32 instance's times, bound and
    scaled_dot_product_attention's."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    B, S, H, D = MESH_ATTN
    out = {}
    for dtype, tol in ((torch.bfloat16, TOL_BF16_ROW),
                       (torch.float32, TOL_F32)):
        q, k, v = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        o = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=True)
        err, rel, ok = attn_error(o, want, tol)
        del o, want
        name = str(dtype)[6:]
        print(f"  flash_attention tp-local shape B={B} S={S} H={H} D={D} "
              f"causal {name}: max_abs_err {err:.3e} row_rel_err "
              f"{rel:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention disagrees with its plain version at "
              f"the tp-local shape ({name})")
        out[f"{name}_max_abs_err"] = err
    out["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=True))
    out["ms_back_to_back"] = time_back_to_back_ms(
        lambda: flash_attention(q, k, v, causal=True))
    out["plain_ms"] = time_ms(lambda: attention_reference(q, k, v,
                                                          causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["library_ms"] = time_ms(lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    qt, kt, vt, is_causal=True))
    out["bound"] = bound_ms(q, k, v, True, 0, peaks)
    print(f"  tp-local shape f32: kernel_ms {out['ms']:.4f} (back-to-back "
          f"{out['ms_back_to_back']:.4f}) plain_ms {out['plain_ms']:.4f} "
          f"library_ms {out['library_ms']:.4f} "
          f"(scaled_dot_product_attention, yardstick only) bound_us "
          f"{1e3 * out['bound'][0]:.1f} ({out['bound'][1]}) on {smi}")
    del q, k, v, qt, kt, vt
    return out


def mesh_phase(gen, peaks, smi):
    """Phase 15 (see the module docstring), with phase 20's runs in its
    spawn. Returns the flash row's mesh numbers, and phase 20's (a) and
    each rank's phase-20 results."""
    t_phase = time.perf_counter()
    flash = mesh_flash_check(gen, peaks, smi)
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    # the ranks start (CUDA, the process group) while (a) runs here;
    # they train once (a) has ended
    # phase 20's (a) runs here after phase 15's, its (b) and (c) in the
    # ranks after theirs
    (a, sm_a), ranks, ranks_s = spawn_ranks(
        _mesh_rank, work, lambda: (mesh_run("a", work), sm_one_device(work)))
    shutil.rmtree(work, ignore_errors=True)
    print(f"mesh: {ranks[0]['describe']}")
    print(f"  (a) one device: losses {a['losses']} device peak "
          f"{a['device'] / 1e9:.2f} GB tracked {a['tracked'] / 1e9:.3f} GB "
          f"({a['s']:.1f}s, steps {[round(x, 3) for x in a['steps_s']]})")
    for r, res in enumerate(ranks):
        for run in "bcdefghi":
            x = res[run]
            print(f"  rank {r} ({run}): losses {x['losses']} device peak "
                  f"{x['device'] / 1e9:.2f} GB tracked "
                  f"{x['tracked'] / 1e9:.3f} GB flash launches "
                  f"{x['launches']} staged {x['staged'] / 1e9:.3f} GB "
                  f"through host memory, in collectives "
                  f"{x['comm_s']['total']:.1f}s (waiting "
                  f"{x['comm_s']['wait']:.1f}s, staging "
                  f"{x['comm_s']['stage']:.1f}s) ({x['backend']}; "
                  f"{x['s']:.1f}s of {x['wall']:.1f}s, "
                  f"steps {[round(t, 3) for t in x['steps_s']]})")
    print(f"  shards (c): {ranks[0]['c']['shards']}")
    print(f"  shards (e): {ranks[0]['e']['shards']}")
    print(f"  shards (f): {ranks[0]['f']['shards']}")
    b0, g0 = ranks[0]["b"], ranks[0]["g"]
    print(f"  checkpoint of (b) after step 1 (1x2, logical arrays, rank 0 "
          f"writing): {b0['ckpt_bytes'] / 1e9:.3f} GB, gathers and host "
          f"snapshot {b0['save_s']:.1f}s, write {b0['write_s']:.1f}s in "
          f"the background while (b)-(i) ran; (g) on "
          f"2x1 restored it in {[x['g']['restore_s'] for x in ranks]} s "
          f"and ran step 2: loss {g0['losses']} against (a)'s "
          f"{a['losses'][1:]}")
    check(a["launches"] == MESH_LAYERS * MESH_STEPS,
          f"mesh (a): flash launches {a['launches']}")
    for r, res in enumerate(ranks):
        for run in "bcdefghi":
            x = res[run]
            n = MESH_LAYERS * (MESH_STEPS - 1 if run == "g" else MESH_STEPS)
            check(all(math.isfinite(v) for v in x["losses"]),
                  f"mesh ({run}) rank {r}: non-finite loss")
            check(x["launches"] == n, f"mesh ({run}) rank {r}: flash "
                  f"launches {x['launches']}, want {n}")
            check(x["backend"] == "gloo", f"mesh ({run}): backend "
                  f"{x['backend']}")
        check(np.allclose(res["b"]["losses"], a["losses"], rtol=TOL_MESH,
                          atol=0.0),
              f"mesh (b) rank {r}: losses {res['b']['losses']} not within "
              f"{TOL_MESH} of (a)'s {a['losses']}")
        check(np.allclose(res["g"]["losses"], a["losses"][1:],
                          rtol=TOL_MESH, atol=0.0),
              f"mesh (g) rank {r}: step-2 loss {res['g']['losses']} from "
              f"(b)'s checkpoint not within {TOL_MESH} of (a)'s "
              f"{a['losses'][1:]}")
        for run, want in (("c", "b"), ("d", "c"), ("f", "e"), ("i", "h")):
            check(res[run]["losses"] == res[want]["losses"],
                  f"mesh ({run}) rank {r}: losses {res[run]['losses']} != "
                  f"({want})'s {res[want]['losses']}")
        check(res["i"]["same_params"], f"mesh (i) rank {r}: final "
              f"parameters differ from (h)'s")
        check(res["i"]["fp"] == res["h"]["fp"], f"mesh (i) rank {r}: "
              f"fingerprints {res['i']['fp']} of the parameters and "
              f"moments differ from (h)'s {res['h']['fp']}")
        check(res["e"]["losses"] == a["losses"],
              f"mesh (e) rank {r}: losses {res['e']['losses']} != (a)'s "
              f"{a['losses']}")
        check(np.allclose(res["e"]["losses"], res["b"]["losses"],
                          rtol=TOL_MESH, atol=0.0),
              f"mesh (e) rank {r}: not within {TOL_MESH} of (b)")
        for run in "cdefi":
            check(res[run]["left"] == [], f"mesh ({run}): spool dir not "
                  f"empty after close: {res[run]['left'][:4]}")
        check(not res["ckpt_left"], "mesh: the checkpoint dir was not "
              "removed")
        check(res["c"]["tracked"] < res["b"]["tracked"],
              f"mesh rank {r}: (c)'s tracked peak {res['c']['tracked']} "
              f"not below (b)'s {res['b']['tracked']}")
        check(res["b"]["staged"] > 0, "mesh (b): nothing staged through "
              "host memory under gloo")
    check(b0["ckpt_bytes"] > 0, "mesh (b): no checkpoint written")
    for r, res in enumerate(ranks):
        c = res["counts"]
        print(f"  phase 19 (d) rank {r}: Comm over one step {c['card']}; "
              f"DryComm {c['dry']}")
        check(c["card"] == c["dry"] and c["card"], f"phase 19 (d) rank {r}: "
              f"the card's collectives {c['card']} are not the dry run's "
              f"{c['dry']}")
    n = MESH_LAYERS * MESH_STEPS
    c_sh, e_sh, f_sh = (ranks[0][x]["shards"] for x in "cef")
    check(sorted(c_sh) == ["0", "1"], f"mesh (c): shards {sorted(c_sh)}")
    for v in c_sh.values():
        check(v["offloads"] == v["fetches"] == n
              and v["bytes_in"] == v["bytes_out"] > 0,
              f"mesh (c): shard counts {v}")
    check(sorted(e_sh) == ["0"], f"mesh (e): shards {sorted(e_sh)}")
    v = e_sh["0"]
    check(v["offloads"] == n and v["fetches"] == 2 * n
          and v["replica_skips"] == n, f"mesh (e): shard counts {v}")
    f_in = sum(x["bytes_in"] for x in f_sh.values())
    check(2 * v["bytes_in"] == f_in and f_in > 0, f"mesh (e): "
          f"{v['bytes_in']} bytes to the spool, (f) {f_in}: not half")
    dt = time.perf_counter() - t_phase
    print(f"  mesh: (b), (g) within {TOL_MESH} of (a); (c) = (b), (d) = "
          f"(c), (e) = (a), (f) = (e), (i) = (h) bitwise (the overlap's "
          f"parameters and moments too); shards and replica skips as the "
          f"JAX bridge counts them; spool dirs empty, the checkpoint dir "
          f"removed; device peaks per rank (b) "
          f"{[x['b']['device'] / 1e9 for x in ranks]} GB, (c) "
          f"{[x['c']['device'] / 1e9 for x in ranks]} GB, (g) "
          f"{[x['g']['device'] / 1e9 for x in ranks]} GB, (h) "
          f"{[x['h']['device'] / 1e9 for x in ranks]} GB, (i) "
          f"{[x['i']['device'] / 1e9 for x in ranks]} GB, (a) "
          f"{a['device'] / 1e9:.2f} GB; (a) and the ranks {ranks_s:.1f}s, "
          f"phase {dt:.1f}s on {smi}")
    flash["launches_per_rank_run"] = ranks[0]["b"]["launches"]
    flash["phase_s"] = dt
    return flash, (sm_a, [res["serve"] for res in ranks])


def family_cfg(arch):
    """Phase 17's config of `arch`: hubert-xlarge at full width in f32 at
    phase 13's depth, llama-3.2-vision-90b at full width cut to
    FAMILY_VISION_LAYERS layers in bf16."""
    from repro_torch.configs import resolve_config
    cfg = resolve_config(arch)
    if arch == FAMILY_HUBERT:
        layers = dict((a, n) for a, n, _ in REG_TRAIN)[arch]
        return dataclasses.replace(cfg, dtype="float32", num_layers=layers)
    return dataclasses.replace(cfg, num_layers=FAMILY_VISION_LAYERS)


def family_run(arch, label, work, **kw):
    """One run of phase 17 (`mesh_run` over `family_cfg(arch)` and the
    seeded batches phases 13 and 14 train the family on)."""
    from repro_torch.data.pipeline import embedding_batches, vision_batches
    cfg, batch = family_cfg(arch), FAMILY_BATCH[arch]
    loader = (embedding_batches(cfg.d_model, cfg.vocab_size, batch=batch,
                                seq_len=REG_SEQ, seed=0)
              if cfg.input_kind == "embeddings" else
              vision_batches(cfg.vocab_size, cfg.d_model,
                             cfg.encoder_seq_len, batch=batch,
                             seq_len=REG_SEQ, seed=0))
    return mesh_run(label, work, cfg=cfg, loader=loader, batch=batch,
                    fingerprints=True, **kw)


def rec_cfg(arch):
    """Phase 18's config of `arch` (REC_LAYERS deep, f32)."""
    from repro_torch.configs import resolve_config, t5
    cfg = (t5(PAPER_HIDDEN, REC_LAYERS[arch]) if arch == REC_T5 else
           dataclasses.replace(resolve_config(arch),
                               num_layers=REC_LAYERS[arch]))
    return dataclasses.replace(cfg, dtype="float32")


def rec_run(arch, label, work, **kw):
    """One run of phase 18 (`mesh_run` over `rec_cfg(arch)`; T5 reads the
    encoder-decoder batches phase 8 trains it on)."""
    from repro_torch.data.pipeline import encoder_decoder_batches
    cfg, batch = rec_cfg(arch), REC_BATCH[arch]
    loader = (encoder_decoder_batches(cfg.vocab_size, batch=batch,
                                      seq_len=REG_SEQ, seed=0)
              if cfg.family == "encdec" else None)
    return mesh_run(label, work, cfg=cfg, loader=loader, batch=batch,
                    fingerprints=True, **kw)


def rec_launches(arch):
    """(layer stages, flash, SSD and RG-LRU launches) of one step of
    `rec_cfg(arch)`: a flash launch per attention or cross block, an SSD
    call per ssm block, an RG-LRU forward and fused backward per rglru
    block."""
    from repro_torch.models.api import build_model
    api = build_model(rec_cfg(arch))
    segs = tuple(api.enc_segments) + tuple(api.segments)
    mixers = [b.mixer for seg in segs for _ in range(seg.n_repeat)
              for b in seg.blocks]
    return (sum(seg.n_repeat for seg in segs),
            sum(m in ("attn", "cross") for m in mixers),
            mixers.count("ssm"), 2 * mixers.count("rglru"))


def _family_rank(rank, port, work):
    """One of phases 17 and 18's ranks: each family kept and spooled on a
    1x2 mesh; its results (or its traceback) pickled into `work`."""
    import pickle
    import traceback
    import torch.distributed as dist
    try:
        _rank_setup(rank, port, work)
        from repro_torch.parallel.comm import init_mesh
        mesh = init_mesh((1, MESH_RANKS), ("data", "model"), device="cuda")
        res = {}
        for arch in (FAMILY_HUBERT, FAMILY_VISION):
            res[arch] = {
                "b": family_run(arch, f"{arch}_b", work, mesh=mesh),
                "c": family_run(arch, f"{arch}_c", work, mesh=mesh,
                                offload=True)}
        for arch in REC_ARCHS:
            res[arch] = {
                "b": rec_run(arch, f"{arch}_b", work, mesh=mesh),
                "c": rec_run(arch, f"{arch}_c", work, mesh=mesh,
                             offload=True)}
        dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def recurrent_kernels(gen, peaks, smi):
    """Phase 18's SSD and RG-LRU instances (REC_SSD, REC_RGLRU) against
    their plain versions at phase 3's bars, with their times (one call
    and back to back) beside the plain version's and the bound (no
    single PyTorch call computes either scan). Returns {"ssd": ...,
    "rglru": ...}."""
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd,
                                                rglru_scan_fwd,
                                                rglru_sequential)
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_fwd

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    B, S, H, P, N, inner = REC_SSD
    conv = rand((B, S, inner + 2 * N))
    Bs, Cs = conv[..., inner:inner + N], conv[..., inner + N:]
    xh = rand((B, S, H, P))
    a = -torch.nn.functional.softplus(rand((B, S, H)))
    y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
    torch.cuda.synchronize()
    yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
    # phase 3's bar at the training shape: both read the same values and
    # sum in f32, so only the order of the N=128 and Q=128 sums differs
    scale = yr.abs().max().item()
    err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
    ok = err <= TOL_SSD_PATH * scale and bool(torch.isfinite(y).all())
    print(f"  ssd_scan mamba2 tp=2 B={B} S={S} H={H} P={P} N={N} chunk=128 "
          f"float32 (strided B/C): max_abs_err {err:.3e} (output scale "
          f"{scale:.1f}, tol {TOL_SSD_PATH:g} relative) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "ssd_scan disagrees with its plain version at a tp=2 rank's "
          "shape")
    ssd = {"max_abs_err": err, "rel_err": err / scale,
           "ms": time_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)),
           "ms_back_to_back": time_back_to_back_ms(
               lambda: ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)),
           "plain_ms": time_ms(lambda: ssd_chunked(xh, a, Bs, Cs, 128)),
           "bound": ssd_bound_ms(xh, a, Bs, Cs, 128, peaks)}
    print(f"  ssd_scan mamba2 tp=2 shape: kernel_ms {ssd['ms']:.4f} "
          f"(back-to-back {ssd['ms_back_to_back']:.4f}) plain_ms "
          f"{ssd['plain_ms']:.4f} library_ms none bound_us "
          f"{1e3 * ssd['bound'][0]:.1f} ({ssd['bound'][1]}) on {smi}")
    del conv, Bs, Cs, xh, a, y, st, yr, sr

    shape = REC_RGLRU
    la, x, g = -(rand(shape) * 0.5).abs(), rand(shape), rand(shape)
    h = rglru_scan_fwd(la, x)
    dla, dx = rglru_scan_bwd(la, g, h)
    torch.cuda.synchronize()
    la_, x_ = (t.clone().requires_grad_(True) for t in (la, x))
    h_ = rglru_sequential(la_, x_)
    wla, wx = torch.autograd.grad(h_, (la_, x_), g)
    errs = {"forward": scan_err(h, h_.detach(), TOL_RGLRU),
            "backward dx": scan_err(dx, wx, TOL_RGLRU_GRAD),
            "backward dlog_a": scan_err(dla, wla, TOL_RGLRU_GRAD)}
    for what, (e, bar) in errs.items():
        print(f"  rglru_scan recurrentgemma tp=2 B={shape[0]} S={shape[1]} "
              f"W={shape[2]} {what}: max_abs_err {e:.3e}, {bar:.3f} of the "
              f"bar {'ok' if bar <= 1 else 'FAIL'}")
        check(bar <= 1 and math.isfinite(e), f"rglru_scan {what} disagrees "
              f"with its plain version at a tp=2 rank's shape")
    del la_, x_, h_, wla, wx
    rg = {"max_abs_err": max(e for e, _ in errs.values()),
          "max_err_over_bar": max(b for _, b in errs.values()),
          "ms": time_ms(lambda: rglru_scan_fwd(la, x)),
          "ms_back_to_back": time_back_to_back_ms(
              lambda: rglru_scan_fwd(la, x)),
          "backward_ms": time_ms(lambda: rglru_scan_bwd(la, g, h)),
          "backward_ms_back_to_back": time_back_to_back_ms(
              lambda: rglru_scan_bwd(la, g, h)),
          "plain_ms": time_ms(lambda: rglru_sequential(la, x)),
          "bound": rglru_bound_ms(x, peaks),
          "backward_bound": rglru_bound_ms(x, peaks, tensors=5)}
    print(f"  rglru_scan recurrentgemma tp=2 shape: kernel_ms "
          f"{rg['ms']:.4f} (back-to-back {rg['ms_back_to_back']:.4f}), "
          f"fused backward {rg['backward_ms']:.4f} "
          f"({rg['backward_ms_back_to_back']:.4f}; bound_us "
          f"{1e3 * rg['backward_bound'][0]:.1f}) plain_ms "
          f"{rg['plain_ms']:.4f} library_ms none bound_us "
          f"{1e3 * rg['bound'][0]:.1f} ({rg['bound'][1]}) on {smi}")
    del la, x, g, h, dla, dx
    torch.cuda.empty_cache()
    return {"ssd": ssd, "rglru": rg}


def family_phase(gen, peaks, smi, hubert_keep=None):
    """Phases 17 and 18 (see the module docstring), one spawn of ranks.
    `hubert_keep`: phase 13's f32 keep losses of hubert-xlarge, its (a)
    (run here when None). Returns the flash rows of their shapes, phase
    18's SSD and RG-LRU rows, each rank's launches a run, and the
    seconds of each phase's runs."""
    t_phase = time.perf_counter()
    flash, _ = flash_registry_phase(gen, peaks, smi,
                                    cases=FAMILY_FLASH_CASES)
    t_rec = time.perf_counter()
    flash.update(flash_registry_phase(gen, peaks, smi,
                                      cases=REC_FLASH_CASES)[0])
    scans = recurrent_kernels(gen, peaks, smi)
    rec_kernels_s = time.perf_counter() - t_rec
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_family_")

    def one_device():
        out = {FAMILY_VISION: family_run(FAMILY_VISION, "vision_a", work)}
        if hubert_keep is None:
            out[FAMILY_HUBERT] = family_run(FAMILY_HUBERT, "hubert_a", work)
        for arch in REC_ARCHS:
            out[arch] = rec_run(arch, f"{arch}_a", work)
        return out

    a, ranks, ranks_s = spawn_ranks(_family_rank, work, one_device)
    shutil.rmtree(work, ignore_errors=True)
    launches = family_checks(a, ranks, hubert_keep)
    launches.update(recurrent_checks(a, ranks))
    # each family's runs: its (a), then the slower rank's (b) and (c)
    walls = {arch: (a[arch]["wall"] if arch in a else 0.0) + max(
                 res[arch]["b"]["wall"] + res[arch]["c"]["wall"]
                 for res in ranks)
             for arch in (FAMILY_HUBERT, FAMILY_VISION) + REC_ARCHS}
    t18 = rec_kernels_s + sum(walls[arch] for arch in REC_ARCHS)
    dt = time.perf_counter() - t_phase
    print(f"  families: (a) and the ranks {ranks_s:.1f}s, phases 17 and 18 "
          f"{dt:.1f}s on {smi}, of which phase 18's kernels "
          f"{rec_kernels_s:.1f}s; each family's runs, (a) and the slower "
          f"rank's (b) and (c): "
          + ", ".join(f"{arch} {w:.1f}s" for arch, w in walls.items()))
    return flash, scans, launches, (dt - t18, t18)


def family_checks(a, ranks, hubert_keep):
    """Phase 17's checks of hubert and vision on the 1x2 mesh. Returns
    each rank's flash launches a run."""
    from repro_torch.models.transformer import build_segments
    a_losses = {arch: (a[arch]["losses"] if arch in a else hubert_keep)
                for arch in (FAMILY_HUBERT, FAMILY_VISION)}
    launches = {}
    for arch in (FAMILY_HUBERT, FAMILY_VISION):
        cfg = family_cfg(arch)
        segs = build_segments(cfg)
        per_step = sum(seg.n_repeat * len(seg.blocks) for seg in segs)
        stages = sum(seg.n_repeat for seg in segs)
        n = per_step * MESH_STEPS
        launches[arch] = ranks[0][arch]["b"]["launches"]
        if arch in a:
            x = a[arch]
            check(x["launches"] == n, f"{arch} (a): flash launches "
                  f"{x['launches']}, want {n}")
            print(f"  {arch} (a) one device ({cfg.dtype}): losses "
                  f"{x['losses']} device peak {x['device'] / 1e9:.2f} GB "
                  f"tracked {x['tracked'] / 1e9:.3f} GB ({x['s']:.1f}s)")
        else:
            print(f"  {arch} (a) one device ({cfg.dtype}): phase 13's keep "
                  f"losses {hubert_keep}")
        for r, res in enumerate(ranks):
            for run in "bc":
                x = res[arch][run]
                print(f"  {arch} rank {r} ({run}): losses {x['losses']} "
                      f"device peak {x['device'] / 1e9:.2f} GB tracked "
                      f"{x['tracked'] / 1e9:.3f} GB flash launches "
                      f"{x['launches']} staged {x['staged'] / 1e9:.3f} GB "
                      f"through host memory, in collectives "
                      f"{x['comm_s']['total']:.1f}s ({x['s']:.1f}s of "
                      f"{x['wall']:.1f}s, steps "
                      f"{[round(t, 3) for t in x['steps_s']]})")
            b, c = res[arch]["b"], res[arch]["c"]
            for run, x in (("b", b), ("c", c)):
                check(all(math.isfinite(v) for v in x["losses"]),
                      f"{arch} ({run}) rank {r}: non-finite loss")
                check(x["launches"] == n, f"{arch} ({run}) rank {r}: flash "
                      f"launches {x['launches']}, want {n}")
            check(c["losses"] == b["losses"] and c["fp"][0] == b["fp"][0],
                  f"{arch} rank {r}: spooled losses {c['losses']} or "
                  f"parameters differ from kept ({b['losses']})")
            check(c["left"] == [], f"{arch} (c): spool dir not empty after "
                  f"close: {c['left'][:4]}")
            if arch == FAMILY_HUBERT:
                check(np.allclose(b["losses"], a_losses[arch],
                                  rtol=TOL_MESH, atol=0.0),
                      f"{arch} (b) rank {r}: losses {b['losses']} not "
                      f"within {TOL_MESH} of (a)'s {a_losses[arch]}")
                check(c["tracked"] < b["tracked"], f"{arch} rank {r}: (c)'s "
                      f"tracked peak {c['tracked']} not below (b)'s "
                      f"{b['tracked']}")
        shards = ranks[0][arch]["c"]["shards"]
        print(f"  {arch} shards (c): {shards}")
        check(sorted(shards) == ["0", "1"], f"{arch} (c): shards "
              f"{sorted(shards)}")
        for v in shards.values():
            check(v["offloads"] == v["fetches"] == stages * MESH_STEPS
                  and v["bytes_in"] == v["bytes_out"] > 0,
                  f"{arch} (c): shard counts {v}")
        print(f"  {arch}: (a) losses {a_losses[arch]}, 1x2 "
              f"{ranks[0][arch]['b']['losses']}"
              + (f" (within {TOL_MESH})" if arch == FAMILY_HUBERT else
                 " (bf16: sums in another order, no bar)")
              + f"; spooled = kept bitwise; {n} flash launches a rank a "
              f"run")
    return launches


def recurrent_checks(a, ranks):
    """Phase 18's checks of mamba2, recurrentgemma and T5 on the 1x2
    mesh: (b) within TOL_MESH of (a), (c) = (b) in losses and parameters'
    fingerprints, each shard storing and fetching every layer stage once
    a step, empty spool dirs, a lower tracked peak in (c), and each
    kernel's launches a rank a run exact. Returns them."""
    launches = {}
    for arch in REC_ARCHS:
        cfg = rec_cfg(arch)
        stages, flash, ssd, rglru = (n * MESH_STEPS
                                     for n in rec_launches(arch))
        want = {"launches": flash, "ssd_launches": ssd,
                "rglru_launches": rglru}
        x = a[arch]
        print(f"  {arch} (a) one device ({cfg.num_layers} layers, f32, "
              f"B={REC_BATCH[arch]}): losses {x['losses']} device peak "
              f"{x['device'] / 1e9:.2f} GB tracked {x['tracked'] / 1e9:.3f} "
              f"GB launches flash {x['launches']} ssd {x['ssd_launches']} "
              f"rglru {x['rglru_launches']} ({x['s']:.1f}s)")
        check(all(x[k] == n for k, n in want.items()),
              f"{arch} (a): launches { {k: x[k] for k in want} }, want "
              f"{want}")
        for r, res in enumerate(ranks):
            for run in "bc":
                x = res[arch][run]
                print(f"  {arch} rank {r} ({run}): losses {x['losses']} "
                      f"device peak {x['device'] / 1e9:.2f} GB tracked "
                      f"{x['tracked'] / 1e9:.3f} GB launches flash "
                      f"{x['launches']} ssd {x['ssd_launches']} rglru "
                      f"{x['rglru_launches']} staged "
                      f"{x['staged'] / 1e9:.3f} GB through host memory, in "
                      f"collectives {x['comm_s']['total']:.1f}s "
                      f"({x['s']:.1f}s of {x['wall']:.1f}s, steps "
                      f"{[round(t, 3) for t in x['steps_s']]})")
                check(all(math.isfinite(v) for v in x["losses"]),
                      f"{arch} ({run}) rank {r}: non-finite loss")
                check(all(x[k] == n for k, n in want.items()),
                      f"{arch} ({run}) rank {r}: launches "
                      f"{ {k: x[k] for k in want} }, want {want}")
            b, c = res[arch]["b"], res[arch]["c"]
            check(np.allclose(b["losses"], a[arch]["losses"], rtol=TOL_MESH,
                              atol=0.0),
                  f"{arch} (b) rank {r}: losses {b['losses']} not within "
                  f"{TOL_MESH} of (a)'s {a[arch]['losses']}")
            check(c["losses"] == b["losses"] and c["fp"][0] == b["fp"][0],
                  f"{arch} rank {r}: spooled losses {c['losses']} or "
                  f"parameters differ from kept ({b['losses']})")
            check(c["left"] == [], f"{arch} (c): spool dir not empty after "
                  f"close: {c['left'][:4]}")
            check(c["tracked"] < b["tracked"], f"{arch} rank {r}: (c)'s "
                  f"tracked peak {c['tracked']} not below (b)'s "
                  f"{b['tracked']}")
        shards = ranks[0][arch]["c"]["shards"]
        print(f"  {arch} shards (c): {shards}")
        check(sorted(shards) == ["0", "1"], f"{arch} (c): shards "
              f"{sorted(shards)}")
        for v in shards.values():
            check(v["offloads"] == v["fetches"] == stages
                  and v["bytes_in"] == v["bytes_out"] > 0,
                  f"{arch} (c): shard counts {v}, want {stages} stages")
        launches[arch] = {k: ranks[0][arch]["b"][k] for k in want}
        print(f"  {arch}: (a) losses {a[arch]['losses']}, 1x2 "
              f"{ranks[0][arch]['b']['losses']} (within {TOL_MESH}); "
              f"spooled = kept bitwise; launches a rank a run {want}")
    return launches


def moe_cfg(arch, layers, dtype):
    """`arch` at full width cut to `layers` layers, in `dtype`."""
    from repro_torch.configs import resolve_config
    return dataclasses.replace(resolve_config(arch), num_layers=layers,
                               dtype=dtype)


def grad_samples(leaves):
    """GRAD_SAMPLES entries of each leaf, at flat positions drawn from a
    generator seeded with the leaf's index (every entry of a smaller
    leaf), as f32 numpy arrays."""
    out = []
    for i, g in enumerate(leaves):
        n = g.numel()
        idx = (torch.arange(n) if n <= GRAD_SAMPLES else torch.randint(
            n, (GRAD_SAMPLES,), generator=torch.Generator().manual_seed(i)))
        out.append(g.detach().reshape(-1)[idx.to(g.device)].float().cpu()
                   .numpy())
    return out


def shard_samples(grads, params):
    """Phase 16 (a)'s probe: for each rank of the 1xMESH_RANKS mesh, the
    shapes of its shards of the one-device gradients (cut by the specs a
    mesh session gives the parameters) and `grad_samples` of them."""
    from repro_torch.core.meshrun import shard_tree
    from repro_torch.core.tree import tree_flatten
    from repro_torch.parallel.mesh import make_test_mesh
    from repro_torch.parallel.sharding import default_axes, param_specs
    out = []
    for r in range(MESH_RANKS):
        m = make_test_mesh((1, MESH_RANKS), ("data", "model"), rank=r)
        # the rules read the leaves' names and shapes, not the config
        specs = param_specs(None, params, m, default_axes(m), fsdp=True)
        leaves = tree_flatten(shard_tree(grads, specs, m))[0]
        out.append(([tuple(t.shape) for t in leaves], grad_samples(leaves)))
        del leaves
    return out


def sample_errors(grads, want):
    """This rank's first-step gradients against (a)'s samples of its
    shards (`shard_samples`): per leaf, the largest difference over (a)'s
    largest magnitude; None when the shards' shapes differ."""
    from repro_torch.core.tree import tree_flatten
    leaves = tree_flatten(grads)[0]
    shapes, ref = want
    if [tuple(t.shape) for t in leaves] != shapes:
        return None
    return [float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30))
            for g, w in zip(grad_samples(leaves), ref)]


def moe_run(cfg, label, work, *, steps, mesh=None, offload=False,
            ep_axis=None, cap=1.25, probe=None, tier=None):
    """One MoE training run of phase 16 (or of `--kimi-4card`) in this
    process: one device (`mesh` None) or this rank of `mesh`, sgd, B=1,
    S=PAPER_SEQ, the jit engine keeping every layer, or with `offload`
    spooling them into `work/label` (a directory every rank shares);
    `ep_axis` and `cap` the expert-parallel path's axis and capacity
    factor; `probe(grads, params)` is called on the first step's
    gradients, before its update, and its result returned. `tier`: a
    memory tier's (activation_policy, offload_names) in place of keep,
    its first step under the op counter (`host`: the bytes it counts off
    the card) and the later ones outside it. Flash launches
    and the rows the capacity drops (`moe.dropped_rows`) are set to 0
    just before the steps and read just after. Returns losses, launches,
    dropped rows, the tracked and device peaks, the shard totals over the
    ranks, the bytes staged through host memory, the final parameters'
    fingerprint and, with `offload`, what the dir holds after close."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    from repro_torch.session import TrainSession
    d = os.path.join(work, label)
    io = SpoolIoConfig(backend="fs", directory=d, codec="raw",
                       pool_bytes=POOL_BYTES,
                       host_offload="activations") if offload else None
    from repro_torch.launch.op_stats import OpCounter
    policy, names = tier or ("spool" if offload else "keep", ("blk_in",))
    settings = RunSettings(
        attn_impl="cuda", attn_chunk=256, param_dtype=cfg.dtype,
        device="cuda", activation_policy=policy, offload_names=names,
        ep_axis=ep_axis, moe_capacity_factor=cap)
    counter = OpCounter("cuda") if tier else contextlib.nullcontext()
    opt, probed = sgd(PAPER_LR), []
    if probe is not None:
        base = opt.update

        def update(grads, state, params, **kw):
            if not probed:
                probed.append(probe(grads, params))
            return base(grads, state, params, **kw)
        opt = dataclasses.replace(opt, update=update)
    t_wall = time.perf_counter()
    sess = TrainSession(cfg, engine="jit", io=io, settings=settings,
                        optimizer=opt, batch_size=1,
                        seq_len=PAPER_SEQ, seed=0, device="cuda",
                        attn_impl="cuda", mesh=mesh)
    try:
        sess.init()
        flash_attention.launches = 0
        moe.dropped_rows.reset()
        t0 = time.perf_counter()
        with counter:
            reps = sess.run(1 if tier else steps).reports
        if tier:
            reps += sess.run(steps - 1).reports
        out = {"s": time.perf_counter() - t0,
               "launches": flash_attention.launches,
               "dropped": moe.dropped_rows.read(),
               "losses": [r.loss for r in reps],
               "aux": [(r.extra["moe_lb"], r.extra["moe_z"]) for r in reps],
               "tracked": max(r.peak_activation_bytes for r in reps),
               "device": max(r.extra["device_peak_bytes"] for r in reps),
               "shards": sess.shard_totals() if mesh is not None else {},
               "staged": sum(r.extra.get("comm_host_staged_bytes", 0)
                             for r in reps),
               "comm_s": sum(r.extra.get("comm_total_s", 0.0)
                             for r in reps),
               "backend": (reps[-1].extra.get("comm_backend")
                           if mesh is not None else None),
               "fp": bit_fingerprint(tree_flatten(sess.params)[0]),
               "steps_s": [r.step_time for r in reps],
               "probe": probed[0] if probed else None,
               "host": counter.analysis().host_bytes if tier else 0,
               "named": [r.extra.get("named_bytes", 0) for r in reps],
               "leased": sess.engine.spool.pool._leased_bytes}
    finally:
        sess.close()      # on a mesh: after every rank's spool closed
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    if offload:
        out["left"] = sorted(os.listdir(d))
    out["wall"] = time.perf_counter() - t_wall
    return out


def moe_named_check(a, named, smi):
    """Phase 16's (a) on the host tier of "moe_hidden": losses and
    parameters (fingerprint) bitwise equal to (a)'s; the expert buffer's
    hidden, (E, C, d_ff) f32 with C the dropless capacity B x S, held
    each step and off the card in step 1 by the op counter (step 2 runs
    outside the counter, timed beside (a)'s step 2); the flash kernel
    twice a layer a step ("attn_out" is not held, so the recompute
    launches it); every pool lease back. `named["remat"]`: (a) under remat, bitwise equal
    to (a) too, its device peak and step 2 printed beside the tier's."""
    cfg = moe_cfg(MOE_ARCH, MOE_LAYERS, "float32")
    remat = named["remat"]
    per_step = MOE_LAYERS * cfg.moe_num_experts * PAPER_SEQ * cfg.d_ff * 4
    print(f"  (a) on the host tier of moe_hidden: losses {named['losses']} "
          f"(keep {a['losses']}); named bytes a step {named['named']}; off "
          f"the card by the op counter {named['host'] / 1e6:.1f} MB in "
          f"step 1; device peak {named['device'] / 1e9:.2f} GB "
          f"(keep {a['device'] / 1e9:.2f}); tracked "
          f"{named['tracked'] / 1e9:.3f} GB (keep {a['tracked'] / 1e9:.3f}); "
          f"flash launches "
          f"{named['launches']}; steps "
          f"{[round(x, 4) for x in named['steps_s']]} s, step 1 under the "
          f"op counter (keep {[round(x, 4) for x in a['steps_s']]}, no "
          f"counter); step 2 {named['steps_s'][1]:.4f} s against keep's "
          f"{a['steps_s'][1]:.4f} s, neither counted; {named['wall']:.1f}s "
          f"on {smi}")
    print(f"  (a) under remat: losses {remat['losses']}; device peak "
          f"{remat['device'] / 1e9:.3f} GB (moe_hidden "
          f"{named['device'] / 1e9:.3f}, keep {a['device'] / 1e9:.3f}); "
          f"tracked {remat['tracked'] / 1e9:.3f} GB; flash launches "
          f"{remat['launches']}; step 2 {remat['steps_s'][1]:.4f} s, not "
          f"counted; {remat['wall']:.1f}s on {smi}")
    check(remat["losses"] == a["losses"] and remat["fp"] == a["fp"],
          f"moe (a) remat: losses {remat['losses']} or parameters differ "
          f"from (a)'s {a['losses']}")
    check(named["losses"] == a["losses"] and named["fp"] == a["fp"],
          f"moe (a) moe_hidden: losses {named['losses']} or parameters "
          f"differ from (a)'s {a['losses']}")
    check(named["named"] == [per_step] * MOE_STEPS
          and named["host"] == per_step,
          f"moe (a) moe_hidden: {named['named']} named bytes a step, "
          f"{named['host']} off the card, want {per_step} a step")
    check(named["launches"] == 2 * MOE_LAYERS * MOE_STEPS,
          f"moe (a) moe_hidden: flash launches {named['launches']}, want "
          f"{2 * MOE_LAYERS * MOE_STEPS}")
    check(named["leased"] == 0 and named["dropped"] == 0,
          f"moe (a) moe_hidden: {named['leased']} bytes still leased, "
          f"{named['dropped']} rows dropped")


def pipe_run(pmesh):
    """Phase 16 (f) on this rank of the ("pipe",) mesh: gpt-h8192 cut to
    PIPE_LAYERS layers in f32 (random weights from seed 0, the same on
    every rank), one layer a stage, PIPE_M microbatches of (1, PAPER_SEQ,
    PAPER_HIDDEN) through `pipeline_apply` with the transformer block on
    the flash kernel, and the loss sum(y * w) of a random w backward
    through the pipeline's drain. Then the layers in sequence on
    this rank, microbatch by microbatch: the reference. Returns the
    errors, whether each is bitwise, the flash launches of the pipeline
    run, its seconds and this stage's parameter gradients."""
    from repro_torch.configs import gpt
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import (BlockDef, RunSettings,
                                                apply_block, init_block,
                                                layer)
    from repro_torch.parallel.pipeline import pipeline_apply
    cfg = dataclasses.replace(gpt(PAPER_HIDDEN, PIPE_LAYERS),
                              dtype="float32")
    settings = RunSettings(attn_impl="cuda", attn_chunk=256,
                           param_dtype="float32", device="cuda")
    bdef = BlockDef("attn")

    def stage_fn(p, x):
        return apply_block(bdef, p, x, cfg, settings)[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacked = init_block(gen, bdef, cfg, torch.float32, PIPE_LAYERS)
    x_mb = torch.randn((PIPE_M, 1, PAPER_SEQ, PAPER_HIDDEN), generator=gen,
                       device="cuda")
    w = torch.randn(x_mb.shape, generator=gen, device="cuda")
    sid = pmesh.coords["pipe"]
    leaves, tdef = tree_flatten(stacked)
    leaves = [t.requires_grad_(True) for t in leaves]
    tree = tree_unflatten(tdef, leaves)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    y_pipe = pipeline_apply(stage_fn, tree, x_mb, pmesh)
    loss = (y_pipe * w).sum()
    loss.backward()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = flash_attention.launches
    y_pipe = y_pipe.detach()
    grads = [t.grad[sid].clone() for t in leaves]
    for t in leaves:
        t.grad = None
    # the reference: the layers in order on this rank
    ys = []
    for m in range(PIPE_M):
        y = x_mb[m]
        for s in range(PIPE_LAYERS):
            y = stage_fn(layer(tree, s), y)
        ys.append(y)
    y_ref = torch.stack(ys)
    loss_ref = (y_ref * w).sum()
    loss_ref.backward()
    out = {"s": run_s, "launches": launches,
           "loss": loss.item(), "loss_ref": loss_ref.item()}
    out["y_err"] = rel_err(y_pipe, y_ref)
    out["y_bitwise"] = bool(torch.equal(y_pipe, y_ref))
    errs = [rel_err(a, b.grad[sid]) for a, b in zip(grads, leaves)]
    out["g_err"] = max(errs)
    out["g_bitwise"] = all(torch.equal(a, b.grad[sid])
                           for a, b in zip(grads, leaves))
    del tree, ys, y_ref, y_pipe, stacked, leaves, x_mb, w
    del loss, loss_ref
    gc.collect()
    torch.cuda.empty_cache()
    return out, grads


def rel_err(a, b):
    """max |a - b| over max |b|: an error on the tensor's own scale."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def comp_run(gmesh, grads):
    """Phase 16 (g) on this rank of the ("data",) mesh: the compressed
    and the exact dp mean of this rank's gradients (one gpt-h8192
    layer's: its pipeline stage's from (f), so the ranks' differ), then
    COMP_ROUNDS error-feedback rounds of the same gradients. Returns the
    worst leaf's error of one round and of the rounds' mean, each over
    the exact mean's largest magnitude, and the seconds."""
    from repro_torch.parallel.compress import (compressed_mean_grads,
                                               exact_mean_grads,
                                               init_error_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = exact_mean_grads(grads, gmesh, "data")
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp, _ = compressed_mean_grads(grads, init_error_state(grads), gmesh,
                                    "data")
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    rel = max(rel_err(c, e) for c, e in zip(comp, exact))
    del comp
    acc = [torch.zeros_like(g) for g in grads]
    err = init_error_state(grads)
    t0 = time.perf_counter()
    for _ in range(COMP_ROUNDS):
        c, err = compressed_mean_grads(grads, err, gmesh, "data")
        for a, x in zip(acc, c):
            a.add_(x, alpha=1.0 / COMP_ROUNDS)
        del c
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    rel_acc = max(rel_err(a, e) for a, e in zip(acc, exact))
    n = sum(g.numel() for g in grads)
    del acc, err, exact
    return {"rel": rel, "rel_acc": rel_acc, "exact_s": exact_s,
            "comp_s": comp_s, "rounds_s": rounds_s, "elements": n,
            "staged": gmesh.comm.host_staged_bytes}


def _moe_rank(rank, port, work):
    """One of phase 16's ranks: (b)-(e) on a 1x2 mesh, (f) on a ("pipe",)
    mesh of 2, (g) on a ("data",) mesh of 2; its results (or its
    traceback) pickled into `work`."""
    import pickle
    import traceback
    import torch.distributed as dist
    try:
        # (a) runs in the parent first: (a) and two ranks would not fit
        # the card
        _rank_setup(rank, port, work)
        from repro_torch.parallel.comm import init_mesh
        mesh = init_mesh((1, MESH_RANKS), ("data", "model"), device="cuda")
        res = {"describe": mesh.comm.describe()}
        cfg = moe_cfg(MOE_ARCH, MOE_LAYERS, "float32")
        full = cfg.moe_num_experts / cfg.moe_top_k
        with open(os.path.join(work, "a_grads.pkl"), "rb") as f:
            want = pickle.load(f)[rank]
        for label, kw in (("b", dict(probe=lambda g, p: sample_errors(
                                         g, want))),
                          ("c", dict(offload=True)),
                          ("d", dict(ep_axis="model", cap=full)),
                          ("e", dict(ep_axis="model", cap=MOE_DROP_CAP)),
                          ("e2", dict(ep_axis="model", cap=MOE_DROP_CAP,
                                      offload=True))):
            res[label] = moe_run(cfg, label, work, steps=MOE_STEPS,
                                 mesh=mesh, **kw)
        pmesh = init_mesh((MESH_RANKS,), ("pipe",), device="cuda")
        res["f"], grads = pipe_run(pmesh)
        gmesh = init_mesh((MESH_RANKS,), ("data",), device="cuda")
        res["g"] = comp_run(gmesh, grads)
        del grads
        dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def moe_phase(gen, peaks, smi):
    """Phase 16 (see the module docstring). Returns the flash rows of its
    shapes and the launches of its runs."""
    import pickle
    t_phase = time.perf_counter()
    flash, _ = flash_registry_phase(gen, peaks, smi, cases=MOE_FLASH_CASES)
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    for sub in ("c", "e2"):
        os.makedirs(os.path.join(work, sub))

    def one_device():
        cfg = moe_cfg(MOE_ARCH, MOE_LAYERS, "float32")
        a = moe_run(cfg, "a", work, steps=MOE_STEPS, probe=shard_samples)
        with open(os.path.join(work, "a_grads.pkl"), "wb") as f:
            pickle.dump(a["probe"], f)
        # (a) again on the host tier of "moe_hidden" (phase 8's named
        # tiers on an MoE model)
        named = moe_run(cfg, "a_named", work, steps=MOE_STEPS,
                        tier=("offload", ("moe_hidden",)))
        # and under remat, the peak and the step the tier is read beside
        named["remat"] = moe_run(cfg, "a_remat", work, steps=MOE_STEPS,
                                 tier=("remat", ("blk_in",)))
        return a, named

    # the ranks start (CUDA, the process group) while (a) runs here; they
    # allocate once (a) has ended
    (a, named), ranks, ranks_s = spawn_ranks(_moe_rank, work, one_device)
    shutil.rmtree(work, ignore_errors=True)
    runs = ("b", "c", "d", "e", "e2")
    print(f"moe: {MOE_ARCH} at {MOE_LAYERS} layer(s), f32, sgd, B=1, "
          f"S={PAPER_SEQ}, {MOE_STEPS} steps; {ranks[0]['describe']}")
    print(f"  (a) one device: losses {a['losses']} aux (moe_lb, moe_z) "
          f"{a['aux']} device peak {a['device'] / 1e9:.2f} GB tracked "
          f"{a['tracked'] / 1e9:.3f} GB ({a['s']:.1f}s of "
          f"{a['wall']:.1f}s, steps {[round(x, 3) for x in a['steps_s']]})")
    for r, res in enumerate(ranks):
        for run in runs:
            x = res[run]
            print(f"  rank {r} ({run}): losses {x['losses']} dropped rows "
                  f"{x['dropped']} device peak {x['device'] / 1e9:.2f} GB "
                  f"tracked {x['tracked'] / 1e9:.3f} GB flash launches "
                  f"{x['launches']} staged {x['staged'] / 1e9:.3f} GB "
                  f"through host memory, {x['comm_s']:.1f}s in "
                  f"collectives ({x['backend']}; {x['s']:.1f}s of "
                  f"{x['wall']:.1f}s, steps "
                  f"{[round(t, 3) for t in x['steps_s']]})")
        ge = res["b"]["probe"]
        print(f"  rank {r} (b) first-step gradients against (a)'s shards: "
              + ("shapes differ" if ge is None else
                 f"largest error {max(ge):.3e} over {len(ge)} leaves"))
        f, g = res["f"], res["g"]
        print(f"  rank {r} (f) pipeline: loss {f['loss']:.6f} (sequential "
              f"{f['loss_ref']:.6f}), output error {f['y_err']:.3e} "
              f"(bitwise {f['y_bitwise']}), its stage's gradients "
              f"{f['g_err']:.3e} (bitwise {f['g_bitwise']}), flash "
              f"launches {f['launches']}, {f['s']:.2f}s")
        print(f"  rank {r} (g) compressed mean of {g['elements']} "
              f"gradients: error {g['rel']:.3e} of the exact mean's scale "
              f"(one round, {g['comp_s']:.2f}s; exact {g['exact_s']:.2f}s), "
              f"{COMP_ROUNDS} rounds' mean {g['rel_acc']:.3e} "
              f"({g['rounds_s']:.1f}s)")
    print(f"  shards (c): {ranks[0]['c']['shards']}")
    print(f"  shards (e2): {ranks[0]['e2']['shards']}")
    n = MOE_LAYERS * MOE_STEPS
    check(a["launches"] == n, f"moe (a): flash launches {a['launches']}")
    check(a["dropped"] == 0, f"moe (a): {a['dropped']} rows dropped")
    moe_named_check(a, named, smi)
    for r, res in enumerate(ranks):
        for run in runs:
            x = res[run]
            check(all(math.isfinite(v) for v in x["losses"]),
                  f"moe ({run}) rank {r}: non-finite loss")
            check(x["launches"] == n, f"moe ({run}) rank {r}: flash "
                  f"launches {x['launches']}, want {n}")
            check(x["backend"] == "gloo", f"moe ({run}): backend "
                  f"{x['backend']}")
        check(np.allclose(res["b"]["losses"], a["losses"], rtol=TOL_MESH,
                          atol=0.0),
              f"moe (b) rank {r}: losses {res['b']['losses']} not within "
              f"{TOL_MESH} of (a)'s {a['losses']}")
        ge = res["b"]["probe"]
        check(ge is not None, f"moe (b) rank {r}: its gradients' shards "
              f"differ in shape from (a)'s cut by the specs")
        check(max(ge) <= TOL_MESH, f"moe (b) rank {r}: first-step "
              f"gradients {max(ge):.3e} from (a)'s shards (leaf "
              f"{int(np.argmax(ge))} of {len(ge)}), bar {TOL_MESH}")
        for run, want in (("c", "b"), ("d", "b"), ("e2", "e")):
            check(res[run]["losses"] == res[want]["losses"]
                  and res[run]["fp"] == res[want]["fp"],
                  f"moe ({run}) rank {r}: losses {res[run]['losses']} or "
                  f"parameters differ from ({want})'s "
                  f"{res[want]['losses']}")
        for run in ("b", "c", "d"):
            check(res[run]["dropped"] == 0, f"moe ({run}) rank {r}: "
                  f"{res[run]['dropped']} rows dropped")
        for run in ("c", "e2"):
            check(res[run]["left"] == [], f"moe ({run}): spool dir not "
                  f"empty after close: {res[run]['left'][:4]}")
        check(res["c"]["tracked"] < res["b"]["tracked"],
              f"moe rank {r}: (c)'s tracked peak {res['c']['tracked']} not "
              f"below (b)'s {res['b']['tracked']}")
        f, g = res["f"], res["g"]
        check(f["launches"] == PIPE_M, f"moe (f) rank {r}: flash launches "
              f"{f['launches']}, want {PIPE_M}")
        check(f["y_err"] <= TOL_PIPE_OUT, f"moe (f) rank {r}: pipeline "
              f"output {f['y_err']} from the sequential layers, bar "
              f"{TOL_PIPE_OUT}")
        check(f["g_err"] <= TOL_PIPE_GRAD, f"moe (f) rank {r}: stage "
              f"gradients {f['g_err']} from the sequential layers', bar "
              f"{TOL_PIPE_GRAD}")
        check(g["rel"] < TOL_COMP, f"moe (g) rank {r}: compressed mean "
              f"{g['rel']} from the exact one, bar {TOL_COMP}")
        check(g["rel_acc"] < g["rel"], f"moe (g) rank {r}: {COMP_ROUNDS} "
              f"rounds' mean {g['rel_acc']} not nearer than one round's "
              f"{g['rel']}")
    for run in ("c", "e2"):
        sh = ranks[0][run]["shards"]
        check(sorted(sh) == ["0", "1"], f"moe ({run}): shards {sorted(sh)}")
        for v in sh.values():
            check(v["offloads"] == v["fetches"] == n
                  and v["bytes_in"] == v["bytes_out"] > 0,
                  f"moe ({run}): shard counts {v}")
    dt = time.perf_counter() - t_phase
    print(f"  moe: (b) within {TOL_MESH} of (a); (c) = (b), (d) = (b), "
          f"(e2) = (e) bitwise (losses and parameters); (f) within "
          f"{TOL_PIPE_OUT} / {TOL_PIPE_GRAD}; (g) within {TOL_COMP}, "
          f"{COMP_ROUNDS} rounds nearer; shards exact; spool dirs empty; "
          f"device peaks per rank (b) "
          f"{[round(x['b']['device'] / 1e9, 2) for x in ranks]} GB, (c) "
          f"{[round(x['c']['device'] / 1e9, 2) for x in ranks]} GB, (a) "
          f"{a['device'] / 1e9:.2f} GB; (a) and the ranks {ranks_s:.1f}s, "
          f"phase {dt:.1f}s on {smi}")
    return flash, {"moe_rank_run": ranks[0]["b"]["launches"],
                   "moe_one_device_run": a["launches"],
                   "moe_hidden_run": named["launches"],
                   "pipeline_rank_run": ranks[0]["f"]["launches"],
                   "phase_s": dt}


def _kimi_rank(rank, port, work):
    """One of `--kimi-4card`'s ranks, on its own card over NCCL: kimi-k2
    at full width cut to KIMI_LAYERS layers, bf16, on a 1xKIMI_RANKS mesh,
    dropless and then with `ep_axis="model"` at MOE_DROP_CAP, each kept
    and spooled; its results (or its traceback) pickled into `work`."""
    import pickle
    import traceback
    import torch.distributed as dist
    try:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.parallel.comm import init_mesh
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        deterministic()
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=KIMI_RANKS)
        mesh = init_mesh((1, KIMI_RANKS), ("data", "model"), device="cuda")
        res = {"describe": mesh.comm.describe()}
        cfg = moe_cfg(KIMI_ARCH, KIMI_LAYERS, "bfloat16")
        for label, kw in (("keep", {}), ("spool", dict(offload=True)),
                          ("ep_keep", dict(ep_axis="model",
                                           cap=MOE_DROP_CAP)),
                          ("ep_spool", dict(ep_axis="model",
                                            cap=MOE_DROP_CAP,
                                            offload=True))):
            res[label] = moe_run(cfg, label, work, steps=KIMI_STEPS,
                                 mesh=mesh, **kw)
        dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def kimi_phase(smi):
    """`--kimi-4card`: kimi-k2 on KIMI_RANKS cards (see `_kimi_rank`).
    Each path kept = spooled bitwise (losses and parameters), the
    dropless runs drop no row, a flash launch per layer a step, spool
    dirs empty."""
    import pickle
    import socket
    n_cards = torch.cuda.device_count()
    check(n_cards >= KIMI_RANKS, f"--kimi-4card needs {KIMI_RANKS} cards, "
          f"have {n_cards}")
    t0 = time.perf_counter()
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_kimi_")
    for sub in ("spool", "ep_spool"):
        os.makedirs(os.path.join(work, sub))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    try:
        torch.multiprocessing.start_processes(
            _kimi_rank, args=(port, work), nprocs=KIMI_RANKS,
            start_method="spawn")
    except Exception as e:                    # noqa: BLE001
        fail(f"kimi: the {KIMI_RANKS} ranks did not run: {e}")
    ranks = []
    for r in range(KIMI_RANKS):
        path = os.path.join(work, f"rank{r}.pkl")
        check(os.path.exists(path), f"kimi: rank {r} reported nothing")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        check("error" not in ranks[r],
              f"kimi: rank {r} failed:\n{ranks[r].get('error')}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"kimi: {KIMI_ARCH} at {KIMI_LAYERS} layers, bf16, sgd, B=1, "
          f"S={PAPER_SEQ}, {KIMI_STEPS} steps; {ranks[0]['describe']}")
    n = KIMI_LAYERS * KIMI_STEPS
    for r, res in enumerate(ranks):
        for run in ("keep", "spool", "ep_keep", "ep_spool"):
            x = res[run]
            print(f"  rank {r} ({run}): losses {x['losses']} aux "
                  f"{x['aux']} dropped rows {x['dropped']} device peak "
                  f"{x['device'] / 1e9:.2f} GB tracked "
                  f"{x['tracked'] / 1e9:.3f} GB flash launches "
                  f"{x['launches']}, {x['comm_s']:.1f}s in collectives "
                  f"({x['backend']}; {x['s']:.1f}s of {x['wall']:.1f}s, "
                  f"steps {[round(t, 3) for t in x['steps_s']]})")
            check(all(math.isfinite(v) for v in x["losses"]),
                  f"kimi ({run}) rank {r}: non-finite loss")
            check(x["launches"] == n, f"kimi ({run}) rank {r}: flash "
                  f"launches {x['launches']}, want {n}")
            check(x["backend"] == "nccl", f"kimi ({run}): backend "
                  f"{x['backend']}")
        for a, b in (("spool", "keep"), ("ep_spool", "ep_keep")):
            check(res[a]["losses"] == res[b]["losses"]
                  and res[a]["fp"] == res[b]["fp"],
                  f"kimi ({a}) rank {r}: losses {res[a]['losses']} or "
                  f"parameters differ from ({b})'s {res[b]['losses']}")
            check(res[a]["left"] == [], f"kimi ({a}): spool dir not empty")
        check(res["keep"]["dropped"] == 0, f"kimi rank {r}: the dropless "
              f"run dropped {res['keep']['dropped']} rows")
    print(f"  kimi: kept = spooled bitwise on both paths; shards (spool) "
          f"{ranks[0]['spool']['shards']}; device peaks per rank keep "
          f"{[round(x['keep']['device'] / 1e9, 2) for x in ranks]} GB, "
          f"spool {[round(x['spool']['device'] / 1e9, 2) for x in ranks]} "
          f"GB; {time.perf_counter() - t0:.1f}s on {smi}")


# phase 19: the dry run's counts against the card's. Peak within this
# share of the prediction (the caching allocator's rounding and cuBLAS's
# workspace are not in the trace); no rate above this share of its
# datasheet peak
TOL_P19_PEAK = 0.15
P19_RATE_CAP = 1.05
P19_MAMBA_LAYERS = 4


def p19_counted(build, label):
    """(the dry run's prediction on the meta device, the card's count of
    the same step, the card's bundle, its kernel launches a step, the
    card's allocator peak over the counted step): `build(device)` makes
    the step's `StepBundle`; the card's step runs once under the
    counter, its launches read from 0 just before."""
    from repro_torch.kernels import rglru_scan, ssd_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import trace_step
    meta = build("meta")
    _, pc, t_meta = trace_step(meta, "meta")
    meta.close()
    del meta
    card = build("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = {"flash_attention": flash_attention,
               "ssd_scan": ssd_scan.ssd_scan,
               "rglru_scan": rglru_scan.rglru_scan}
    for k in kernels.values():
        k.launches = 0
    _, cc, _ = trace_step(card, "cuda")
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    peak = torch.cuda.max_memory_allocated()
    pred, got = pc.analysis(), cc.analysis()
    print(f"  ({label}) predicted on meta in {t_meta:.1f}s: flops "
          f"{pred.flops:.6e} dots {pred.dot_count} host "
          f"{pred.host_bytes:.6e} B hbm {pred.hbm_bytes:.6e} B peak "
          f"{pred.peak_bytes / 1e9:.3f} GB kernels {pred.kernels}; the "
          f"card: flops {got.flops:.6e} dots {got.dot_count} host "
          f"{got.host_bytes:.6e} B hbm {got.hbm_bytes:.6e} B launches "
          f"{launches} allocator peak {peak / 1e9:.3f} GB")
    check(got.flops == pred.flops, f"({label}) the card counted "
          f"{got.flops} flops, the dry run {pred.flops}")
    check(got.dot_count == pred.dot_count and got.host_bytes ==
          pred.host_bytes, f"({label}) dots / host bytes {got.dot_count} "
          f"/ {got.host_bytes} against the dry run's {pred.dot_count} / "
          f"{pred.host_bytes}")
    for n, k in pred.kernels.items():
        check(launches.get(n, 0) == k["calls"] == got.kernels[n]["calls"],
              f"({label}) {n}: {launches.get(n, 0)} launches, the dry "
              f"run counts {k['calls']} calls")
    return pred, got, card, launches, peak


def p19_timed(bundle, steps):
    """Seconds of each of `steps` uncounted steps."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.fn(*bundle.args)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def p19_free(*bundles):
    for b in bundles:
        b.close()
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phase(smi):
    """Phase 19 (see the module docstring). Returns its numbers for the
    result line."""
    t_phase = time.perf_counter()
    # (f) runs on the host's CPU while (a)-(e) run on the card
    d = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "train_4k", "--mesh", "single", "--out",
         d, "--force"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT)
    try:
        return dryrun_checks(smi, cli, d, t_phase)
    finally:
        if cli.poll() is None:       # a check failed first
            cli.kill()
            cli.wait()
        shutil.rmtree(d, ignore_errors=True)


def dryrun_checks(smi, cli, d, t_phase):
    """Phase 19's (a)-(f), with the CLI `cli` running into `d`."""
    from repro_torch.configs import SpoolIoConfig, get_config, gpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import sgd
    out = {}
    io = SpoolIoConfig(backend="mem", pool_bytes=POOL_BYTES)
    api = build_model(gpt(PAPER_HIDDEN, PAPER_LAYERS))
    print("dry run against the card: gpt-h8192-l4 (bf16), counted under "
          "launch/op_stats.py's OpCounter, timed uncounted")
    # (a) training on the host tier
    shape = ShapeConfig("phase19", PAPER_SEQ, PAPER_BATCH, "train")
    pred, got, b, launches, peak = p19_counted(
        lambda dev: make_train_step(api, None, None, sgd(PAPER_LR), shape,
                                    device=dev, io_config=io), "a")
    steps_s = p19_timed(b, 2)
    t_step = steps_s[-1]
    tokens = b.tokens_per_step
    mfu = 6 * b.n_active * tokens / (t_step * PEAK_FLOPS_BF16)
    t_compute = pred.flops / PEAK_FLOPS_BF16
    rel_peak = peak / pred.peak_bytes - 1
    print(f"  (a) train B={PAPER_BATCH} S={PAPER_SEQ} sgd on the host "
          f"tier: steps {[round(x, 4) for x in steps_s]} s, mfu "
          f"{mfu:.4f} (6 N_active tokens over t_step x PEAK_FLOPS_BF16, "
          f"N_active {b.n_active}), t_compute/t_step "
          f"{t_compute / t_step:.4f} (t_compute {t_compute:.4f} s), peak "
          f"{peak / 1e9:.3f} GB against the predicted "
          f"{pred.peak_bytes / 1e9:.3f} GB ({100 * rel_peak:+.1f}%)")
    want = 2 * PAPER_LAYERS         # each layer forward and recomputed
    check(launches.get("flash_attention") == want, f"(a) flash launches "
          f"{launches}, want {want} (a forward and a recompute a layer)")
    check(abs(rel_peak) <= TOL_P19_PEAK, f"(a) the card's peak "
          f"{peak} is {100 * rel_peak:+.1f}% of the predicted "
          f"{pred.peak_bytes}, not within {100 * TOL_P19_PEAK:.0f}%")
    out.update(train_step_s=t_step, mfu=mfu,
               t_compute_over_t_step=t_compute / t_step,
               train_launches=launches.get("flash_attention", 0),
               peak_bytes=peak, predicted_peak_bytes=pred.peak_bytes,
               train_flops=pred.flops)
    p19_free(b)
    del b
    # (b) prefill and decode
    pshape = ShapeConfig("phase19p", PAPER_SEQ, 1, "prefill")
    _, _, b, launches, _ = p19_counted(
        lambda dev: make_prefill_step(api, None, None, pshape, device=dev),
        "b prefill")
    check(launches.get("flash_attention") == PAPER_LAYERS,
          f"(b) prefill flash launches {launches}, want {PAPER_LAYERS}")
    out["prefill_s"] = p19_timed(b, 1)[0]
    p19_free(b)
    del b
    dshape = ShapeConfig("phase19d", PAPER_SEQ, 1, "decode")
    _, _, b, _, _ = p19_counted(
        lambda dev: make_decode_step(api, None, None, dshape, device=dev),
        "b decode")
    out["decode_s"] = p19_timed(b, 1)[0]
    print(f"  (b) prefill (1, {PAPER_SEQ}) {out['prefill_s']:.4f} s, "
          f"decode over a {PAPER_SEQ}-token cache {out['decode_s']:.4f} s")
    p19_free(b)
    del b, api
    # (c) the recurrent kernels' work reports
    for arch, layers in ((TRAIN_ARCH, P19_MAMBA_LAYERS), (RG_ARCH, 3)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        capi = build_model(cfg)
        cshape = ShapeConfig("phase19c", PAPER_SEQ, 1, "train")
        _, _, b, launches, _ = p19_counted(
            lambda dev: make_train_step(capi, None, None, sgd(PAPER_LR),
                                        cshape, device=dev, io_config=io),
            f"c {arch} {layers} layers")
        out[f"{arch}_launches"] = launches
        p19_free(b)
        del b, capi
    # (e) the card against its constants
    n = 8192
    x = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    y = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: x @ y, runs=10)
    del x, y
    src = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), runs=10)
    del src, dst
    torch.cuda.empty_cache()
    mm_rate = 2 * n ** 3 / (mm_ms / 1e3)
    cp_rate = 2 * (4 << 30) / (cp_ms / 1e3)
    print(f"  (e) bf16 {n}^3 matmul {mm_ms:.4f} ms: {mm_rate / 1e12:.1f} "
          f"TFLOP/s against PEAK_FLOPS_BF16 {PEAK_FLOPS_BF16 / 1e12:.0f} "
          f"({mm_rate / PEAK_FLOPS_BF16:.3f}); 4 GiB device copy "
          f"{cp_ms:.4f} ms: {cp_rate / 1e12:.3f} TB/s read + write against "
          f"HBM_BW {HBM_BW / 1e12:.2f} ({cp_rate / HBM_BW:.3f})")
    check(mm_rate <= P19_RATE_CAP * PEAK_FLOPS_BF16, f"(e) the matmul ran "
          f"at {mm_rate:.4e} FLOP/s, above {P19_RATE_CAP} x its peak")
    check(cp_rate <= P19_RATE_CAP * HBM_BW, f"(e) the copy ran at "
          f"{cp_rate:.4e} B/s, above {P19_RATE_CAP} x HBM_BW")
    out.update(matmul_tflops=mm_rate / 1e12, copy_tbps=cp_rate / 1e12)
    # (f) one production cell through the CLI, started with the phase
    try:
        stdout, stderr = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
    t_cli = time.perf_counter() - t_phase
    check(cli.returncode == 0, f"(f) the dry run CLI exited "
          f"{cli.returncode}: {stdout[-1500:]} {stderr[-1500:]}")
    with open(os.path.join(d, "qwen2_5-3b__train_4k__single.json")) as f:
        rec = json.load(f)
    check(rec.get("status") == "ok", f"(f) status {rec.get('status')}")
    rl = rec["roofline"]
    print(f"  (f) qwen2.5-3b x train_4k [single] status: ok within "
          f"{t_cli:.1f}s of the phase's start (trace {rec['compile_s']}s): "
          f"dominant "
          f"{rl['dominant']}, t_compute {rl['t_compute_s']:.4e} s, "
          f"t_memory {rl['t_memory_s']:.4e} s, t_collective "
          f"{rl['t_collective_s']:.4e} s, traced peak "
          f"{rec['memory_analysis']['peak_device_bytes'] / 1e9:.3f} GB")
    out["cli_dominant"] = rl["dominant"]
    dt = time.perf_counter() - t_phase
    out["phase_s"] = dt
    print(f"  dry run: (a)-(c) counts exact, (a)'s peak within "
          f"{100 * TOL_P19_PEAK:.0f}%, (e) no rate above its peak, (f) ok; "
          f"phase {dt:.1f}s on {smi}")
    return out


def comm_count_check(mesh):
    """Phase 19 (d), in a rank of phase 15's spawn: one step of phase
    15's model through `make_train_step` on this rank of `mesh`, its
    `Comm` counters over the step beside those of a `DryComm` of the
    same rank over the same step on the meta device."""
    from repro_torch.configs import gpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.parallel.sharding import MeshAxes
    api = build_model(dataclasses.replace(gpt(PAPER_HIDDEN, MESH_LAYERS),
                                          dtype="float32"))
    shape = ShapeConfig("phase19d", PAPER_SEQ, MESH_BATCH, "train")
    real = make_train_step(api, mesh, MeshAxes(), sgd(PAPER_LR), shape,
                           device="cuda")
    before = mesh.comm.op_counts()
    real.fn(*real.args)
    torch.cuda.synchronize()
    after = mesh.comm.op_counts()
    real.close()
    del real
    card = {k: [v[0] - before.get(k, [0, 0])[0],
                v[1] - before.get(k, [0, 0])[1]] for k, v in after.items()}
    card = {k: v for k, v in card.items() if v[0]}
    dmesh = make_test_mesh(mesh.devices_shape, mesh.axis_names,
                           rank=mesh.rank, dry=True)
    dry = make_train_step(api, dmesh, MeshAxes(), sgd(PAPER_LR), shape,
                          device="meta")
    dry.fn(*dry.args)
    dry.close()
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "dry": dmesh.comm.op_counts()}


def sm_cfg(arch):
    """Phase 20's config of `arch`: SM_LAYERS deep, f32."""
    from repro_torch.configs import resolve_config
    return dataclasses.replace(resolve_config(arch),
                               num_layers=SM_LAYERS[arch], dtype="float32")


def sm_rel(got, want):
    """The largest difference over the reference's largest magnitude."""
    want = want.float()
    return ((got.float().cpu() - want.cpu()).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _tensors(tree):
    from repro_torch.core.tree import tree_flatten
    return tree_flatten(tree)[0]


def _ops_delta(after, before):
    return {k: [v[0] - before.get(k, [0, 0])[0],
                v[1] - before.get(k, [0, 0])[1]]
            for k, v in after.items() if v[0] - before.get(k, [0, 0])[0]}


def sm_run(arch, label, mesh=None, ref=None, new=SM_NEW):
    """One phase-20 run of `arch` on this process's card: a prefill of
    SM_PROMPT tokens through `make_prefill_step` counted under the op
    counter, a second one timed outside it (the time to first token),
    then `new` decode steps
    through `make_decode_step`'s step on the prefill bundle's weights
    (built on the meta device: its step only; the weights are the same
    layout), teacher-forced with (a)'s greedy tokens (`ref`; (a) takes
    its own). On a mesh: the caches gathered after prefill
    (`cache_layout_specs`) and every logit against (a)'s, each rank's
    collectives over the prefill and the first decode step beside a
    `DryComm`'s over the same steps traced on the meta device, and the
    prefill's FLOPs and kernel calls beside the trace's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.meshrun import gather_leaf, wrap_specs
    from repro_torch.kernels import rglru_scan, ssd_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_stats import OpCounter
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, rank_rows)
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import MeshAxes, cache_layout_specs
    cfg = sm_cfg(arch)
    api = build_model(cfg)
    B, P, axes = SM_BATCH[arch], SM_PROMPT[arch], MeshAxes()
    pshape = ShapeConfig("phase20p", SM_CACHE[arch], B, "prefill")
    dshape = ShapeConfig("phase20d", SM_CACHE[arch], B, "decode")
    t0 = time.perf_counter()
    pb = make_prefill_step(api, mesh, axes, pshape, device="cuda", seed=0)
    step = make_decode_step(api, mesh, axes, dshape, device="meta").fn
    params = pb.args[0]
    prompt = {"tokens": pb.args[1]["tokens"][:, :P]}
    pb.args = ()
    torch.cuda.synchronize()
    dp = axes.dp_size(mesh) if mesh is not None else 1
    leaves = _tensors(params)
    specs = (_tensors(wrap_specs(pb.param_specs)) if mesh is not None
             else [None] * len(leaves))
    out = {"build_s": time.perf_counter() - t0, "fsdp": pb.fsdp,
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           # the leaves an fsdp gather makes whole, at their whole size
           "gathered_bytes": sum(
               t.numel() * t.element_size() * dp for t, sp in
               zip(leaves, specs) if sp is not None and "data" in sp.spec)}
    del leaves, specs
    torch.cuda.reset_peak_memory_stats()
    kernels = {"flash_attention": flash_attention,
               "ssd_scan": ssd_scan.ssd_scan,
               "rglru_scan": rglru_scan.rglru_scan}
    comm = mesh.comm if mesh is not None else None
    ops0 = comm.op_counts() if comm else {}
    for k in kernels.values():
        k.launches = 0
    with OpCounter("cuda") as counter:
        pb.fn(params, prompt)
        torch.cuda.synchronize()
    out["launches"] = {n: k.launches for n, k in kernels.items()
                       if k.launches}
    out["flops"] = counter.analysis().flops
    if comm:
        out["prefill_ops"] = _ops_delta(comm.op_counts(), ops0)
    del counter
    # the time to first token: a second prefill, outside the op counter
    staged0 = comm.host_staged_bytes if comm else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pb.fn(params, prompt)
    torch.cuda.synchronize()
    out["ttft_s"] = time.perf_counter() - t0
    vocab = cfg.vocab_size
    lo, rows = 0, rank_rows(B, mesh, axes)
    if mesh is not None and rows < B:
        lo = mesh.coords["data"] * rows
    got = [logits]
    if mesh is not None:
        specs = wrap_specs(cache_layout_specs(_meta_like(ref["cache"]),
                                              mesh, axes))
        out["cache_err"] = max(
            sm_rel(gather_leaf(t, sp, mesh), w) for t, sp, w in zip(
                _tensors(caches), _tensors(specs), _tensors(ref["cache"])))
        tokens = ref["tokens"][lo:lo + rows].cuda()
    else:
        out["cache"] = _map_cpu(caches)
        tokens = torch.empty((B, new), dtype=torch.int32, device="cuda")
    itl = []
    for i in range(new):
        if ref is None:
            tokens[:, i] = got[-1][:, 0, :vocab].argmax(-1)
        ops1 = comm.op_counts() if comm else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(step(params, caches, {"tokens": tokens[:, i:i + 1]},
                        torch.tensor(P + i, dtype=torch.int32,
                                     device="cuda")))
        torch.cuda.synchronize()
        itl.append(time.perf_counter() - t0)
        if comm and i == 0:
            out["decode_ops"] = _ops_delta(comm.op_counts(), ops1)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["itl_s"] = itl
    if comm:
        out["staged_bytes"] = comm.host_staged_bytes - staged0
    if ref is None:
        out["tokens"] = tokens.cpu()
        out["logits"] = [t.cpu() for t in got]
    else:
        out["logit_err"] = max(
            sm_rel(g[..., :vocab], w[lo:lo + rows, ..., :vocab])
            for g, w in zip(got, ref["logits"]))
    del params, caches, got, logits, step, pb
    gc.collect()
    torch.cuda.empty_cache()
    # the same steps traced on the meta device, over a DryComm of this
    # rank when on a mesh
    dmesh = (make_test_mesh(mesh.devices_shape, mesh.axis_names,
                            rank=mesh.rank, dry=True)
             if mesh is not None else None)
    mp = make_prefill_step(api, dmesh, axes, pshape, device="meta")
    with OpCounter("meta") as mc:
        _, mcache = mp.fn(mp.args[0], {"tokens": mp.args[1]["tokens"][
            :, :P]})
    ana = mc.analysis()
    out["meta_flops"] = ana.flops
    out["meta_kernels"] = {k: int(v["calls"]) for k, v in
                           ana.kernels.items()}
    if dmesh is not None:
        out["dry_prefill_ops"] = dmesh.comm.op_counts()
        md = make_decode_step(api, dmesh, axes, dshape, device="meta")
        md.fn(mp.args[0], mcache, md.args[2], md.args[3])
        out["dry_decode_ops"] = _ops_delta(dmesh.comm.op_counts(),
                                           out["dry_prefill_ops"])
    return out


def _meta_like(tree):
    """Meta tensors of the shapes of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_like(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _map_cpu(tree):
    """A host copy of a tree of dicts and lists (decode writes the
    device's in place)."""
    if isinstance(tree, dict):
        return {k: _map_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_cpu(v) for v in tree]
    return tree.to("cpu", copy=True)


def sm_one_device(work):
    """Phase 20's (a) runs, in phase 15's process once its ranks have
    joined their process group (so that their start-up is not in (a)'s
    times): each model on one device, its greedy tokens, logits and
    caches saved into `work` for the ranks (`sm_rank_runs`)."""
    deadline = time.perf_counter() + 600
    while not all(os.path.exists(os.path.join(work, f"ready{r}"))
                  for r in range(MESH_RANKS)):
        check(time.perf_counter() < deadline, "phase 15's ranks did not "
              "join their process group within 600 s")
        time.sleep(0.05)
    a = {}
    for arch in SM_ARCHS:
        t0 = time.perf_counter()
        a[arch] = sm_run(arch, "a")
        a[arch]["wall"] = time.perf_counter() - t0
    torch.save({arch: {"tokens": r["tokens"], "logits": r["logits"],
                       "cache": r["cache"]} for arch, r in a.items()},
               os.path.join(work, "sm_ref.pt"))
    for r in a.values():
        del r["logits"], r["cache"]
    return a


def sm_rank_runs(mesh, mesh2, work):
    """Phase 20's (b), every model on the 1x2 `mesh`, and (c), gpt on the
    2x1 `mesh2`, in a rank of phase 15's spawn."""
    ref = torch.load(os.path.join(work, "sm_ref.pt"))
    res = {}
    for arch, run, m, new in [(arch, "b", mesh, SM_NEW) for arch in SM_ARCHS
                              ] + [(SM_GPT, "c", mesh2, SM_FSDP_NEW)]:
        t0 = time.perf_counter()
        res[(arch, run)] = sm_run(arch, run, m, ref[arch], new=new)
        res[(arch, run)]["wall"] = time.perf_counter() - t0
    return res


def serve_mesh_kernels(gen, peaks, smi):
    """Phase 20's flash instances (SM_FLASH_CASES) and the SSD scan at
    SM_SSD against their plain versions at phase 3's bars."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_fwd
    flash_registry_phase(gen, peaks, smi, cases=SM_FLASH_CASES)
    B, S, H, P, N, inner = SM_SSD
    conv = torch.randn((B, S, inner + 2 * N), generator=gen, device="cuda")
    Bs, Cs = conv[..., inner:inner + N], conv[..., inner + N:]
    xh = torch.randn((B, S, H, P), generator=gen, device="cuda")
    a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
    torch.cuda.synchronize()
    yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
    scale = yr.abs().max().item()
    err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
    ok = err <= TOL_SSD_PATH * scale and bool(torch.isfinite(y).all())
    print(f"  ssd_scan mamba2 serve tp=2 B={B} S={S} H={H} P={P} N={N} "
          f"chunk=128 float32 (strided B/C): max_abs_err {err:.3e} (output "
          f"scale {scale:.1f}, tol {TOL_SSD_PATH:g} relative) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "ssd_scan disagrees with its plain version at phase 20's "
          "rank shape")
    del conv, Bs, Cs, xh, a, y, st, yr, sr
    torch.cuda.empty_cache()


def serve_mesh_phase(gen, peaks, smi, a, ranks):
    """Phase 20 (see the module docstring): its kernel instances, then
    the checks of its runs, (a) `a` in phase 15's process and (b) and (c)
    `ranks` in its ranks (`sm_rank_runs`). Returns each run's kernel
    launches (prefill), the phase's seconds and those of its runs."""
    t_phase = time.perf_counter()
    serve_mesh_kernels(gen, peaks, smi)
    launches = {}
    for arch in SM_ARCHS:
        r = a[arch]
        itl = statistics.median(r["itl_s"])
        print(f"  ({arch} a) one device: fsdp {r['fsdp']}, ttft "
              f"{r['ttft_s']:.4f} s, itl p50 {1e3 * itl:.2f} ms over "
              f"{len(r['itl_s'])} steps, peak {r['peak'] / 1e9:.2f} GB, "
              f"launches {r['launches']}, flops {r['flops']:.6e} (meta "
              f"{r['meta_flops']:.6e}), run {r['wall']:.1f}s")
        check(r["flops"] == r["meta_flops"], f"({arch} a) the card counted "
              f"{r['flops']} flops, the trace {r['meta_flops']}")
        check(r["launches"] == r["meta_kernels"], f"({arch} a) launches "
              f"{r['launches']}, the trace counts {r['meta_kernels']}")
        launches[(arch, "a")] = r["launches"]
    for (arch, run) in [(arch, "b") for arch in SM_ARCHS] + [(SM_GPT, "c")]:
        for rank, res in enumerate(ranks):
            r = res[(arch, run)]
            itl = statistics.median(r["itl_s"])
            print(f"  ({arch} {run}) rank {rank}: fsdp {r['fsdp']}, "
                  f"weights {r['param_bytes'] / 1e9:.2f} GB, ttft "
                  f"{r['ttft_s']:.4f} s, itl p50 {1e3 * itl:.2f} ms over "
                  f"{len(r['itl_s'])} steps, staged "
                  f"{r['staged_bytes'] / 1e9:.3f} GB through host memory "
                  f"(comm_host_staged_bytes), peak {r['peak'] / 1e9:.2f} "
                  f"GB; logits {r['logit_err']:.3e} and caches "
                  f"{r['cache_err']:.3e} of (a)'s largest magnitude; "
                  f"launches {r['launches']} (trace {r['meta_kernels']}); "
                  f"flops {r['flops']:.6e} (trace {r['meta_flops']:.6e}); "
                  f"prefill collectives {r['prefill_ops']}, a decode "
                  f"step's {r['decode_ops']}; run {r['wall']:.1f}s")
            check(r["logit_err"] <= TOL_MESH, f"({arch} {run}) rank {rank}'s "
                  f"logits {r['logit_err']} from (a)'s, over {TOL_MESH}")
            check(r["cache_err"] <= TOL_MESH, f"({arch} {run}) rank {rank}'s "
                  f"gathered caches {r['cache_err']} from (a)'s")
            check(r["launches"] == r["meta_kernels"], f"({arch} {run}) "
                  f"rank {rank}: launches {r['launches']}, the trace "
                  f"counts {r['meta_kernels']}")
            check(r["flops"] == r["meta_flops"], f"({arch} {run}) rank "
                  f"{rank} counted {r['flops']} flops, the trace "
                  f"{r['meta_flops']}")
            check(r["prefill_ops"] == r["dry_prefill_ops"] and
                  r["decode_ops"] == r["dry_decode_ops"],
                  f"({arch} {run}) rank {rank}'s collectives "
                  f"{r['prefill_ops']} / {r['decode_ops']} against the "
                  f"DryComm's "
                  f"{r['dry_prefill_ops']} / {r['dry_decode_ops']}")
            check(r["fsdp"] == (run == "c"), f"({arch} {run}) fsdp "
                  f"{r['fsdp']}")
            launches[(arch, run, rank)] = r["launches"]
    want = {SM_GPT: {"flash_attention": SM_LAYERS[SM_GPT]},
            REC_MAMBA: {"ssd_scan": SM_LAYERS[REC_MAMBA]},
            REC_RG: {"rglru_scan": 2, "flash_attention": 1}}
    for key, got in launches.items():
        check(got == want[key[0]], f"({key}) launches {got}, want "
              f"{want[key[0]]}")
    # (c): fsdp holds a rank's shard and one gathered layer at a time
    c = [res[(SM_GPT, "c")] for res in ranks]
    peak_a = a[SM_GPT]["peak"]
    for rank, r in enumerate(c):
        every = r["param_bytes"] + r["gathered_bytes"]
        print(f"  ({SM_GPT} c) rank {rank}: peak {r['peak'] / 1e9:.2f} GB "
              f"against (a)'s {peak_a / 1e9:.2f} GB and "
              f"{every / 1e9:.2f} GB to hold every gathered leaf beside "
              f"the shard")
        check(r["peak"] < peak_a and r["peak"] < every, f"({SM_GPT} c) "
              f"rank {rank}'s peak {r['peak']} not under (a)'s {peak_a} "
              f"and {every}")
    runs_s = sum(r["wall"] for r in a.values()) + max(
        sum(r["wall"] for r in res.values()) for res in ranks)
    dt = time.perf_counter() - t_phase + runs_s
    print(f"  serve on a mesh: logits and caches within {TOL_MESH:g} of "
          f"one device, launches, FLOPs and collectives exact; (a) and the "
          f"slower rank's runs {runs_s:.1f}s (in phase 15's spawn), phase "
          f"{dt:.1f}s on {smi}")
    return launches, dt, runs_s


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    from repro_torch.kernels.rglru_scan import \
        KERNELS_PER_CALL as RG_KERNELS_PER_CALL
    from repro_torch.kernels.ssd_scan import KERNELS_PER_CALL
    from repro_torch.launch import serve
    from repro_torch.models.transformer import RunSettings

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = peaks_for(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f}s")
    for src in libs:
        for line in ptxas_report(build.build_log(src)):
            print(f"  ptxas {src}: {line}")
            if line.startswith(("attn_fwd_mma_kernel", "rglru_",
                                "attn_fwd_fma_kernel<80>")):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"a tensor-core flash, D=80 flash or RG-LRU "
                      f"instance spills: {line}")
    mirror_check()

    # ---- 3. kernel vs plain version
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--mesh-only" in sys.argv[1:]:
        # a short run for work on the meshes: no result line
        t15 = time.perf_counter()
        _, (sm_a, sm_ranks) = mesh_phase(gen, peaks, smi)
        _, s20, sm_runs = serve_mesh_phase(gen, peaks, smi, sm_a, sm_ranks)
        t16 = time.perf_counter()
        moe_phase(gen, peaks, smi)
        t17 = time.perf_counter()
        *_, (s17, s18) = family_phase(gen, peaks, smi)
        print(f"chip_smoke --mesh-only: phases 15 "
              f"({t16 - t15 - s20:.1f}s), 20 ({s20:.1f}s), 16 "
              f"({t17 - t16:.1f}s), 17 ({s17:.1f}s) and 18 ({s18:.1f}s) "
              f"passed in {time.perf_counter() - T_START:.1f}s")
        return 0
    if "--kimi-4card" in sys.argv[1:]:
        # kimi-k2 on four cards over NCCL: no result line
        kimi_phase(smi)
        print(f"chip_smoke --kimi-4card: passed in "
              f"{time.perf_counter() - T_START:.1f}s")
        return 0

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [(c, torch.float32, TOL_F32) for c in ATTN_CASES]
    cases += [(c, torch.bfloat16, TOL_BF16_ROW) for c in ATTN_CASES]
    cases += [((1, S, S, 64, 64, 128, True, 0, 0.0), torch.bfloat16,
               TOL_BF16_ROW) for S in (1024, 1000)]
    worst = worst_rel = 0.0
    serve_inputs = None
    for (B, Sq, Skv, Hq, Hkv, D, causal, window, cap), dtype, tol in cases:
        q, k, v = (rand((B, Sq, Hq, D), dtype), rand((B, Skv, Hkv, D), dtype),
                   rand((B, Skv, Hkv, D), dtype))
        out = flash_attention(q, k, v, causal=causal, window=window,
                              logit_cap=cap)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   logit_cap=cap)
        err, rel, ok = attn_error(out, want, tol)
        print(f"  flash_attention B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} "
              f"D={D} causal={causal} window={window} cap={cap} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} row_rel_err "
              f"{rel:.3e} tol {tol:g}"
              f"{' of the row max' if dtype == torch.bfloat16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "flash_attention disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
            worst_rel = max(worst_rel, rel)
        if Sq == 1024:
            serve_inputs = (q, k, v)
    q, k, v = serve_inputs
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    b2b_ms = time_back_to_back_ms(lambda: flash_attention(q, k, v,
                                                          causal=True))
    plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))
    b_ms, b_by = bound_ms(q, k, v, True, 0, peaks)
    print(f"  serve shape B=1 S=1024 H=64 D=128 causal bf16: kernel_ms "
          f"{kernel_ms:.4f} (back-to-back {b2b_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} "
          f"(scaled_dot_product_attention, yardstick only) "
          f"bound_us {1e3 * b_ms:.1f} ({b_by}) on {smi}")

    (ssd_err, ssd_rel, ssd_ms, ssd_plain_ms, (ssd_b_ms, ssd_b_by),
     ssd_b2b_ms) = ssd_phase(gen, peaks, smi)
    layer_check(gen)
    rg = rglru_phase(gen, peaks, smi)
    d256 = flash_d256_phase(gen, peaks, smi)
    paper_attn = flash_bert_phase(gen, peaks, smi)
    bert_attn = paper_attn["bert"]
    reg_attn, d80 = flash_registry_phase(gen, peaks, smi)
    hub_attn = reg_attn["hubert-xlarge"]
    rg_layer_check(gen)
    t_kernels = time.perf_counter()

    # ---- 4. serve at full width
    t0 = time.perf_counter()
    rt = serve.build_runtime(ARCH, seed=0, device="cuda")
    cfg, api, params, settings = rt
    torch.cuda.synchronize()
    print(f"serve: {ARCH} weights ready in {time.perf_counter() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    n_layers = cfg.num_layers

    # end to end: one prefill through the kernel against the plain path
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        lk = api.forward(params, {"tokens": toks}, settings)
        lp = api.forward(params, {"tokens": toks},
                         RunSettings(attn_impl="torch", attn_chunk=256,
                                     param_dtype=cfg.dtype, device="cuda"))
    vocab = cfg.vocab_size
    e2e_err = (lk[..., :vocab] - lp[..., :vocab]).abs().max().item()
    agree = (lk[0, :, :vocab].argmax(-1) == lp[0, :, :vocab].argmax(-1))
    print(f"  prefill logits, kernel vs plain attention: max_abs_err "
          f"{e2e_err:.3e} (logit std {lp[..., :vocab].std().item():.3f}), "
          f"argmax agreement {agree.float().mean().item():.4f}")
    check(bool(torch.isfinite(lk[..., :vocab]).all()), "non-finite logits")
    check(e2e_err <= TOL_E2E, f"prefill logits through the kernel differ "
          f"from the plain path by {e2e_err} > {TOL_E2E}")

    kv_dir = tempfile.mkdtemp(prefix="chip_smoke_kv_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    sp, rp = serve.run(serve.parse_args(SERVE_ARGS + ["--kv-dir", kv_dir]),
                       rt, record_logits=True)
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    left = os.listdir(kv_dir)
    if not left:
        os.rmdir(kv_dir)
    for line in serve.report_lines(rp):
        print(f"  {line}")
    st = sp.cache.spool.stats
    mnt, fstype = mount_of(kv_dir)
    print(f"  spool: {st.bytes_offloaded / 1e9:.3f} GB stored in "
          f"{st.num_stores} blobs ({st.store_time:.3f}s busy summed over "
          f"store threads), {st.bytes_loaded / 1e9:.3f} GB loaded "
          f"({st.load_time:.3f}s), {st.bytes_forwarded / 1e9:.3f} GB "
          f"forwarded, {st.stores_canceled} stores cancelled, fetch wait "
          f"{st.fetch_wait_time:.3f}s; directory on {mnt} ({fstype})")
    print(f"  paged: flash_attention launches {launches} for "
          f"{rp.kv['prefills']} prefills x {n_layers} layers; peak device "
          f"memory {peak_gb:.2f} GB on {name}")
    launches0 = flash_attention.launches
    sd, rd = serve.run(serve.parse_args(SERVE_ARGS + ["--cache", "dense"]),
                       rt, record_logits=True)
    dense_launches = flash_attention.launches - launches0
    for line in serve.report_lines(rd):
        print(f"  {line}")

    check(rp.preemptions > 0, "no preemption in the paged run")
    check(rp.kv["pages_evicted"] == rp.kv["pages_restored"] > 0,
          f"pages evicted {rp.kv['pages_evicted']} != restored "
          f"{rp.kv['pages_restored']} (or none)")
    check(not left, f"spool directory not empty after close: {left[:5]}")
    check(launches == rp.kv["prefills"] * n_layers,
          f"{launches} kernel launches for {rp.kv['prefills']} prefills")
    check(dense_launches == rd.kv["prefills"] * n_layers,
          "dense run did not prefill through the kernel")
    p = {s.rid: s for s in sp.finished}
    d = {s.rid: s for s in sd.finished}
    check(set(p) == set(d) and len(p) == 12, "request sets differ")
    rows = 0
    for rid in p:
        check(p[rid].tokens == d[rid].tokens, f"tokens differ, rid {rid}")
        for a, b in zip(p[rid].logits, d[rid].logits):
            check(a.shape == (cfg.padded_vocab,) and
                  np.array_equal(a, b),
                  f"logits differ (paged vs dense), rid {rid}")
            rows += 1
    print(f"  paged vs dense: {rows} logits rows bitwise equal, tokens "
          f"equal for {len(p)} requests")
    del rt, cfg, api, params, sp, sd, lk, lp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. train mamba2 at full width, keep vs spool; 6. policy
    # matrix; 7. train recurrentgemma at full width, keep vs spool
    t0 = time.perf_counter()
    ssd_launches = train_phase(smi)["ssd_scan"]
    t05 = time.perf_counter()
    matrix_phase()
    t1 = time.perf_counter()
    rg_launches = rg_train_phase(smi)
    t2 = time.perf_counter()

    # ---- 8. train the paper's GPT, BERT and T5 at hidden 8192, keep vs
    # spool
    paper_launches, (gpt_losses, gpt_params, gpt_peaks, gpt_params2) = \
        paper_train_phase(smi)
    t3 = time.perf_counter()

    # ---- 9. checkpoints and tracing on the paper's GPT
    ckpt_launches = ckpt_trace_phase(smi, gpt_losses, gpt_params, gpt_peaks)
    t4 = time.perf_counter()

    # ---- 10. storage and resilience on the paper's GPT (phase 8's keep
    # and spool losses are bitwise equal)
    storage_launches = storage_phase(smi, gpt_losses, gpt_params2,
                                     gpt_params)
    del gpt_params, gpt_params2
    t5 = time.perf_counter()

    # ---- 11. the optimizer state and the jit engine on the paper's GPT
    opt_launches = opt_phase(smi)
    t6 = time.perf_counter()

    # ---- 12. serve mamba2 and recurrentgemma at full width
    rest_launches, ssd_serve, flash_serve = serve_rest_phase(
        gen, peaks, smi)
    t7 = time.perf_counter()
    print(f"phase times: 1-3 (device, build, kernels) "
          f"{t_kernels - T_START:.1f}s, 4 serve {t0 - t_kernels:.1f}s, 5 "
          f"mamba2 {t05 - t0:.1f}s, 6 policy matrix {t1 - t05:.1f}s, 7 "
          f"recurrentgemma {t2 - t1:.1f}s, 8 GPT, BERT and T5 "
          f"{t3 - t2:.1f}s, 9 checkpoints and tracing {t4 - t3:.1f}s, 10 "
          f"storage and resilience {t5 - t4:.1f}s, 11 optimizer state and "
          f"the jit engine {t6 - t5:.1f}s, 12 serve the rest "
          f"{t7 - t6:.1f}s")

    # ---- 13. the registry's archs: train four, serve qwen2.5-3b
    reg_launches, reg_serve_launches, reg_keep = registry_phase(gen, smi)
    t8 = time.perf_counter()

    # ---- 14. llama-3.2-vision: train kept, spooled and on the host
    # tier, then decode dense and paged
    vision = vision_phase(smi)
    t9 = time.perf_counter()

    # ---- 15. meshes: 2 ranks on the one card over gloo (and phase 20's
    # runs in its spawn)
    mesh, (sm_a, sm_ranks) = mesh_phase(gen, peaks, smi)
    t10 = time.perf_counter()

    # ---- 16. expert parallelism, the pipeline and compression: 2 ranks
    # on the one card over gloo
    moe_flash, moe_launches = moe_phase(gen, peaks, smi)
    t11 = time.perf_counter()

    # ---- 17. hubert and llama-3.2-vision, 18. mamba2, recurrentgemma
    # and T5 on a 1x2 mesh: 2 ranks on the one card over gloo, one spawn
    fam_flash, rec_scans, fam_launches, (s17, s18) = family_phase(
        gen, peaks, smi, reg_keep[FAMILY_HUBERT])

    # ---- 19. the dry run's counts against the card's ((d) ran in phase
    # 15's spawn)
    dry = dryrun_phase(smi)

    # ---- 20. serving on a mesh: its kernels and the checks of its runs
    # (in phase 15's spawn)
    sm_launches, s20, sm_runs = serve_mesh_phase(gen, peaks, smi, sm_a,
                                                 sm_ranks)
    print(f"phase times: 13 the registry's archs {t8 - t7:.1f}s, 14 "
          f"llama-3.2-vision {t9 - t8:.1f}s, 15 meshes "
          f"{t10 - t9 - sm_runs:.1f}s, "
          f"16 expert parallelism, pipeline and compression "
          f"{t11 - t10:.1f}s, 17 hubert and vision on a mesh {s17:.1f}s, "
          f"18 mamba2, recurrentgemma and T5 on a mesh {s18:.1f}s, 19 the "
          f"dry run against the card {dry['phase_s']:.1f}s, 20 serving on "
          f"a mesh {s20:.1f}s; the script "
          f"{time.perf_counter() - T_START:.1f}s")

    # ---- result
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::_attn_kernel",
        "launches": launches,
        "launches_per_serve_run": launches,
        "max_abs_err": worst,
        "max_err": worst,
        # bf16 cases: error over the largest |output| of its row
        "max_row_rel_err": worst_rel,
        "tol": TOL_BF16_ROW,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "ms_back_to_back": b2b_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_us": 1e3 * b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "redesigned": 14,
        "ms_over_library_ms": kernel_ms / library_ms,
        "bound_over_ms": b_ms / kernel_ms,
        # recurrentgemma-9b training: MQA at head_dim 256, window 2048
        "launches_per_train_run": rg_launches["flash_attention"],
        "d256_max_abs_err": d256[0],
        "d256_ms": d256[1],
        "d256_ms_back_to_back": d256[5],
        "d256_plain_ms": d256[2],
        "d256_library_ms": d256[3],
        "d256_bound_ms": d256[4][0],
        "d256_bound_by": d256[4][1],
        "d256_ms_over_library_ms": d256[1] / d256[3],
        "d256_bound_over_ms": d256[4][0] / d256[1],
        # the paper's GPT, BERT and T5 training (phase 8), and BERT's
        # bidirectional attention shape
        "launches_per_gpt_train_run": paper_launches["gpt"][
            "flash_attention"],
        "launches_per_bert_train_run": paper_launches["bert"][
            "flash_attention"],
        "launches_per_t5_train_run": paper_launches["t5"][
            "flash_attention"],
        # phase 9: the traced 2-step GPT run and the resumed step
        "launches_per_traced_gpt_run": ckpt_launches[0],
        "launches_per_resumed_gpt_step": ckpt_launches[1],
        # phase 10: the striped, managed, aio and chaos runs
        "launches_per_storage_run": storage_launches,
        # phase 11: the overlap run (c), adamw, OPT_STEPS steps
        "launches_per_opt_overlap_run": opt_launches,
        # phase 12: recurrentgemma-9b served paged (8 prefills)
        "launches_per_rg_serve_run": rest_launches[RG_ARCH][
            "flash_attention"],
        # phase 12: the bf16 D=256 instance at the serve prefill lengths
        "serve_max_abs_err": flash_serve[0],
        "serve_max_row_rel_err": flash_serve[1],
        "noncausal_max_abs_err": bert_attn["max_abs_err"],
        "noncausal_max_row_rel_err": bert_attn["max_row_rel_err"],
        "noncausal_ms": bert_attn["ms"],
        "noncausal_ms_back_to_back": bert_attn["ms_back_to_back"],
        "noncausal_plain_ms": bert_attn["plain_ms"],
        "noncausal_library_ms": bert_attn["library_ms"],
        "noncausal_bound_ms": bert_attn["bound"][0],
        "noncausal_bound_by": bert_attn["bound"][1],
        # T5's attention shape in phase 8 (B=8), bidirectional
        "t5_noncausal_max_row_rel_err": paper_attn["t5"]["max_row_rel_err"],
        "t5_noncausal_ms": paper_attn["t5"]["ms"],
        "t5_noncausal_ms_back_to_back": paper_attn["t5"]["ms_back_to_back"],
        "t5_noncausal_plain_ms": paper_attn["t5"]["plain_ms"],
        "t5_noncausal_library_ms": paper_attn["t5"]["library_ms"],
        "t5_noncausal_bound_ms": paper_attn["t5"]["bound"][0],
        "t5_noncausal_bound_by": paper_attn["t5"]["bound"][1],
        # phase 13: the registry's archs (3 steps each, spool run), and
        # qwen2.5-3b served paged (8 prefills x 36 layers)
        **{f"launches_per_{a.split('-')[0].replace('.', '_')}_train_run":
           reg_launches[a]["flash_attention"] for a, _, _ in REG_TRAIN},
        "launches_per_qwen_serve_run": reg_serve_launches[
            "flash_attention"],
        # phase 14: llama-3.2-vision-90b at 15 layers (12 self, 3 cross):
        # the spool run (2 steps), the host tier's run (each attention
        # block again in its layer's recompute) and one prefill
        "launches_per_vision_train_run": vision["train"],
        "launches_per_vision_host_tier_run": vision["host_tier"],
        "launches_per_vision_prefill": vision["prefill"],
        # phase 15: a tp=2 rank of gpt-h8192-l1 (each rank's launches in
        # each mesh run), the f32 instance at its shape (2, 1024, 32, 128)
        "launches_per_mesh_rank_run": mesh["launches_per_rank_run"],
        # phase 19: gpt-h8192-l4 through make_train_step on the host
        # tier (a forward and a recompute a layer) and one prefill
        "launches_per_dryrun_train_step": dry["train_launches"],
        "launches_per_dryrun_prefill": PAPER_LAYERS,
        # phase 20: a rank's prefill of gpt-h8192 at 2 layers on the 1x2
        # (TP-only) and 2x1 (fsdp) meshes, and of recurrentgemma-9b at
        # one period on 1x2; decode launches no kernel
        "launches_per_gpt_mesh_serve_prefill": sm_launches[
            (SM_GPT, "b", 0)].get("flash_attention", 0),
        "launches_per_gpt_fsdp_serve_prefill": sm_launches[
            (SM_GPT, "c", 0)].get("flash_attention", 0),
        "launches_per_rg_mesh_serve_prefill": sm_launches[
            (REC_RG, "b", 0)].get("flash_attention", 0),
        "tp_local_max_abs_err": mesh["float32_max_abs_err"],
        "tp_local_bf16_max_abs_err": mesh["bfloat16_max_abs_err"],
        "tp_local_ms": mesh["ms"],
        "tp_local_ms_back_to_back": mesh["ms_back_to_back"],
        "tp_local_plain_ms": mesh["plain_ms"],
        "tp_local_library_ms": mesh["library_ms"],
        "tp_local_bound_ms": mesh["bound"][0],
        "tp_local_bound_by": mesh["bound"][1],
        # phase 16: each rank's launches in a run of llama4-scout at one
        # layer (2 steps) on the 1x2 mesh, (a)'s on one device, and a
        # pipeline stage's (PIPE_M microbatches); the instances at
        # llama4's one-device shape (f32, (a)'s) and tp=2 shape (f32),
        # kimi's tp=4 shape (bf16, launched by --kimi-4card) and the
        # pipeline stage's (f32)
        "launches_per_moe_rank_run": moe_launches["moe_rank_run"],
        "launches_per_moe_one_device_run": moe_launches[
            "moe_one_device_run"],
        # phase 16: (a) on the host tier of "moe_hidden" (the recompute
        # launches the kernel again); phase 8: gpt-h8192-l4 under
        # "save_names" (i) and "offload" (ii) of "attn_out" (the
        # recompute takes the held output: one launch a layer a step)
        "launches_per_moe_hidden_run": moe_launches["moe_hidden_run"],
        "launches_per_gpt_save_names_run": paper_launches["named"]["i"],
        "launches_per_gpt_named_offload_run": paper_launches["named"][
            "ii"],
        "launches_per_pipeline_stage_run": moe_launches[
            "pipeline_rank_run"],
        **{f"{pre}_{k}": (moe_flash[label]["bound"][0] if k == "bound_ms"
                          else moe_flash[label]["bound"][1]
                          if k == "bound_by" else moe_flash[label][k])
           for pre, label in (("llama4_one_device", "llama4 one device"),
                              ("llama4_tp2", "llama4 tp=2"),
                              ("kimi_tp4", "kimi tp=4"),
                              ("pipe_stage", "pipeline stage"))
           for k in ("max_abs_err", "max_row_rel_err", "ms",
                     "ms_back_to_back", "plain_ms", "sdpa_ms",
                     "library_ms", "bound_ms", "bound_by")},
        # phase 17: each rank's launches in a 2-step run of hubert-xlarge
        # (12 layers) and of llama-3.2-vision-90b at one period (4 self-
        # and 1 cross-attention blocks) on the 1x2 mesh, and their tp=2
        # instances; phase 13's hubert-xlarge runs in f32
        "launches_per_hubert_mesh_rank_run": fam_launches[FAMILY_HUBERT],
        "launches_per_vision_mesh_rank_run": fam_launches[FAMILY_VISION],
        # phase 18: each rank's launches in a 2-step run of
        # recurrentgemma-9b at one period (one attention block) and of
        # t5(8192, L) (L encoder, L self- and L cross-attention blocks)
        # on the 1x2 mesh, and their tp=2 instances (f32)
        "launches_per_rg_mesh_rank_run": fam_launches[REC_RG]["launches"],
        "launches_per_t5_mesh_rank_run": fam_launches[REC_T5]["launches"],
        **{f"{pre}_{k}": (flash_rows[label]["bound"][0] if k == "bound_ms"
                          else flash_rows[label]["bound"][1]
                          if k == "bound_by" else flash_rows[label][k])
           for pre, label, flash_rows in (
               ("hubert_tp2", "hubert tp=2", fam_flash),
               ("vision_self_tp2", "vision self tp=2", fam_flash),
               ("vision_cross_tp2", "vision cross tp=2", fam_flash),
               ("hubert_f32", "hubert-xlarge f32", reg_attn),
               ("rg_tp2", "recurrentgemma tp=2", fam_flash),
               ("t5_tp2", "t5 tp=2", fam_flash),
               ("t5_self_tp2", "t5 self tp=2", fam_flash))
           for k in ("max_abs_err", "max_row_rel_err", "ms",
                     "ms_back_to_back", "plain_ms", "sdpa_ms",
                     "library_ms", "bound_ms", "bound_by")},
        # the D=80 instance (hubert-xlarge, bidirectional): its worst
        # f32 and bf16 errors, and its time at hubert's shape
        "d80_f32_max_abs_err": d80["d80 f32"],
        "d80_max_abs_err": d80["d80 bf16"],
        "d80_max_row_rel_err": hub_attn["max_row_rel_err"],
        "d80_ms": hub_attn["ms"],
        "d80_ms_back_to_back": hub_attn["ms_back_to_back"],
        "d80_plain_ms": hub_attn["plain_ms"],
        "d80_library_ms": hub_attn["library_ms"],
        "d80_bound_ms": hub_attn["bound"][0],
        "d80_bound_by": hub_attn["bound"][1],
        # GQA 8:1 (qwen2.5-3b), 5:1 (llama4-scout) and gemma2's window
        # plus softcap at S=8192 (library_ms null: SDPA has no softcap)
        **{f"{pre}_{k}": (reg_attn[label]["bound"][0] if k == "bound_ms"
                          else reg_attn[label]["bound"][1]
                          if k == "bound_by" else reg_attn[label][k])
           for pre, label in (("qwen", "qwen2.5-3b"),
                              ("llama4", "llama4-scout"),
                              ("gemma2_s8192", "gemma2-27b S=8192"),
                              ("vision_self", "vision self"),
                              ("vision_cross", "vision cross"))
           for k in ("max_row_rel_err", "ms", "ms_back_to_back",
                     "plain_ms", "sdpa_ms", "library_ms", "bound_ms",
                     "bound_by")},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:30",
        "tpu_kernel": "src/repro/kernels/ssd_scan.py::_ssd_kernel",
        "launches": ssd_launches,
        "launches_per_train_run": ssd_launches,
        # phase 19 (c): mamba2-2.7b at 4 layers, one counted step
        "launches_per_dryrun_step": dry[f"{TRAIN_ARCH}_launches"].get(
            "ssd_scan", 0),
        "max_abs_err": ssd_err,
        "max_err": ssd_err,
        "tol": TOL_SSD,
        # the training shape, relative to its output's scale
        "path_rel_err": ssd_rel,
        "path_tol_rel": TOL_SSD_PATH,
        "ms": ssd_ms,
        "kernel_ms": ssd_ms,
        "ms_back_to_back": ssd_b2b_ms,
        "plain_ms": ssd_plain_ms,
        "bound_ms": ssd_b_ms,
        "bound_us": 1e3 * ssd_b_ms,
        "bound_by": ssd_b_by,
        "library_ms": None,
        "redesigned": 14,
        "ms_over_library_ms": None,
        "bound_over_ms": ssd_b_ms / ssd_ms,
        "kernels_per_call": KERNELS_PER_CALL,
        # phase 12: mamba2-2.7b served paged, prefill at ragged lengths
        "launches_per_serve_run": rest_launches[TRAIN_ARCH]["ssd_scan"],
        "serve_max_abs_err": ssd_serve["max_abs_err"],
        "serve_rel_err": ssd_serve["rel_err"],
        "serve_seq": ssd_serve["S"],
        "serve_ms": ssd_serve["ms"],
        "serve_plain_ms": ssd_serve["plain_ms"],
        "serve_bound_ms": ssd_serve["bound"][0],
        "serve_bound_by": ssd_serve["bound"][1],
        # phase 18: mamba2-2.7b at 8 layers on the 1x2 mesh (each rank's
        # calls in a 2-step run) and a tp=2 rank's instance (40 heads)
        "launches_per_mesh_rank_run": fam_launches[REC_MAMBA][
            "ssd_launches"],
        # phase 20: a rank's prefill of mamba2-2.7b at 4 layers on 1x2
        "launches_per_mesh_serve_prefill": sm_launches[
            (REC_MAMBA, "b", 0)].get("ssd_scan", 0),
        **{f"tp2_{k}": (rec_scans["ssd"]["bound"][0] if k == "bound_ms"
                        else rec_scans["ssd"]["bound"][1]
                        if k == "bound_by" else rec_scans["ssd"][k])
           for k in ("max_abs_err", "rel_err", "ms", "ms_back_to_back",
                     "plain_ms", "bound_ms", "bound_by")},
        "tp2_library_ms": None,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan_fwd.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:29",
        "tpu_kernel": "src/repro/kernels/rglru_scan.py::_rglru_kernel",
        # wrapper calls: one forward and one fused backward per rglru
        # block per step
        "launches": rg_launches["rglru_scan"],
        "launches_per_train_run": rg_launches["rglru_scan"],
        # phase 19 (c): recurrentgemma-9b at one period, one counted step
        "launches_per_dryrun_step": dry[f"{RG_ARCH}_launches"].get(
            "rglru_scan", 0),
        "max_abs_err": rg["max_abs_err"],
        "max_err": rg["max_abs_err"],
        "max_err_over_bar": rg["max_err_over_bar"],
        "tol": TOL_RGLRU,
        "ms": rg["forward_ms"],
        "kernel_ms": rg["forward_ms"],
        "ms_back_to_back": rg["forward_ms_back_to_back"],
        "plain_ms": rg["plain_ms"],
        "bound_ms": rg["bound"][0],
        "bound_us": 1e3 * rg["bound"][0],
        "bound_by": rg["bound"][1],
        "library_ms": None,
        "redesigned": 15,
        "ms_over_library_ms": None,
        "bound_over_ms": rg["bound"][0] / rg["forward_ms"],
        "kernels_per_call": RG_KERNELS_PER_CALL,
        "reverse_ms": rg["reverse_ms"],
        "reverse_ms_back_to_back": rg["reverse_ms_back_to_back"],
        "backward_ms": rg["backward_ms"],
        "backward_ms_back_to_back": rg["backward_ms_back_to_back"],
        "backward_bound_ms": rg["backward_bound"][0],
        # phase 12: recurrentgemma-9b served paged (forward only)
        "launches_per_serve_run": rest_launches[RG_ARCH]["rglru_scan"],
        # phase 18: recurrentgemma-9b at one period on the 1x2 mesh (each
        # rank's wrapper calls in a 2-step run) and a tp=2 rank's
        # instance (2048 channels), forward and fused backward
        "launches_per_mesh_rank_run": fam_launches[REC_RG][
            "rglru_launches"],
        # phase 20: a rank's prefill of recurrentgemma-9b at one period
        # on 1x2 (forward only)
        "launches_per_mesh_serve_prefill": sm_launches[
            (REC_RG, "b", 0)].get("rglru_scan", 0),
        **{f"tp2_{k}": (rec_scans["rglru"]["bound"][0] if k == "bound_ms"
                        else rec_scans["rglru"]["bound"][1]
                        if k == "bound_by" else
                        rec_scans["rglru"]["backward_bound"][0]
                        if k == "backward_bound_ms" else
                        rec_scans["rglru"][k])
           for k in ("max_abs_err", "max_err_over_bar", "ms",
                     "ms_back_to_back", "backward_ms",
                     "backward_ms_back_to_back", "plain_ms", "bound_ms",
                     "bound_by", "backward_bound_ms")},
        "tp2_library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
