#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build   nvcc-compile every kernel source in src/repro_torch/csrc/.
  2. kernels each CUDA kernel against its plain PyTorch version on the card
             at prosparse-llama2-7b's full width (d=4096, k=11008, G=8,
             C=288, int8 quant groups of 128): the decode kernels at B in
             {1, 4, 16}, alpha in {1.0, 1.03, per-slot with a dead slot}
             (the float32 one run twice and bitwise equal);
             the chunk kernels at S in {17, 64, 128, 256} rows with pad
             rows (each run twice and bitwise equal); the int8
             decode kernel at B in {1, 4, 16} (each run twice and bitwise
             equal); small-shape edge cases (the float32 decode
             kernel's: d in {4100, 5120, 8192}, G up to 32; the int8 decode
             kernel's:
             d=100 and d in 4120..12288, qg in {1, ..., 128}, B from 1 to
             16); a decode batch of 24 through the ops layer.  Each is timed at
             the main path's shape beside its bound, its plain version and
             a library yardstick where one PyTorch call computes it (the
             float32 decode and chunk MLPs: three matmuls on the selected
             rows gathered beforehand, and on all rows; the int8 one
             beside the float32 one at the same shape); then the float32
             and the int8 chunk
             MLPs' scaling lines, S in {16, 32, 64, 128, 256} at the full
             and a third of the selection (and none at S=64), each with
             the kernel's phase trace of one launch; then the int8 decode
             MLP's, B in {1, 4, 8, 16} at the full and a third of the
             selection (and none at B=4), with its phase trace, beside a
             contiguous read of the same int8 bytes; then the float32
             decode MLP's, the same points, with its phase trace, beside
             the gathered-rows 3-matmul and a contiguous read of the same
             float32 bytes; then the predictors' scaling line (the decode
             kernel at B in {1, 4, 8, 16}, the chunk kernel at S in {16,
             ..., 256}, the counts kernel at B in {1, 4, 8, 16, 64, 128,
             256}) beside their bounds: bytes, the bit products on the
             binary tensor cores and the popcounts on the CUDA cores.
             The predictors' edges: S in {1, 17, 257}, d in {100, 4000,
             4096, 5120}, G in {1, 8, 16}, x random, all negative and all
             +-0.0, the chunk kernel and the decode kernel on 16-row
             slices bitwise equal to the plain version.
  3. decode  prosparse-llama2-7b at full width, 2 layers, float32 compute,
             a float32 and then an int8 KV cache: 8 teacher-forced decode
             steps on the card against the same weights on the CPU (plain
             kernel versions), each MLP call on the CPU fed the card's
             input of the same call, so the selections must be equal even
             where the capacity clamp binds: each call's output within
             phase 2's tolerance, its stats equal (the active and
             false-negative counts up to gate values within rounding of
             0), the logits within 1e-3 (int8 cache: 5e-2).  Phases 4, 8,
             11 and 14 compare card and CPU the same way.
  4. prefill the same 2 layers: a 160-token prompt in chunks of 64 through
             sparse prefill on the card against the CPU, with float32 and
             with int8 MLP weights.
  5. serve   prosparse-llama2-7b at full width and all 32 layers through
             Server.serve (strategy pallas, batch 4, 8 requests, mixed SLA
             tiers); the kernel launch counters must show two launches per
             sparse MLP per decode step.
  6. serve-chunked  the same model with chunked sparse prefill (chunks of
             64, 96-192-token prompts), once with float32 and once with int8
             MLP weights; the counters must show two launches per sparse MLP
             per decode step and per prefill chunk.
  7. paged kernels  paged_attention and paged_kv_write against their plain
             versions at full width (H = K = 32, hd = 128, block 16): B in
             {1, 4, 16}, max_len 256 and 2048, fragmented tables with a shared
             block, lengths 0, a block boundary and max_len - 1, bf16 and
             float32 pools; edges (GQA rep 2-8 and 48, softcap, window,
             block 1/8/32, hd 64/256, and the cluster split's boundaries:
             idle CTAs, spans ending on a tile of every CTA, windows of 1
             row and of the last segment, none live, rep 8 at max_len
             8192), each run twice and bitwise equal; the write bitwise,
             each case twice: the single entry with collisions, the paired
             entry (K and V in one launch, targets from the table) against
             two plain writes with dead slots colliding, block-edge
             positions, int32 and int64 cache_len.  Each is timed at the
             main path's shape (B=4, bf16 pool, 64-192 live tokens) beside
             its bound, its plain version and a library call (attention:
             SDPA on a view gathered beforehand, and gather + SDPA; the
             write: two index_put_ with the targets' arithmetic, and an
             empty launch); the attention also with one
             live row per slot, at doubled and equal lengths (its scaling),
             at every cluster size, and at a long-context shape (B=16,
             max_len 4096, lengths 512-4095) with its share of the bound.
  8. paged decode  2 full-width float32 layers against a fragmented float32
             pool, 8 teacher-forced steps: the kernel route on the card
             against the plain route on the CPU and the gather route on the
             card.
  9. serve-paged  all 32 layers through Server.serve with the paged KV pool
             (bf16 pool, block 16, paged_attn_kernel, chunked sparse
             prefill): a shared 128-token system prompt admitted by
             reference, a second serve() of two sessions' turn 2, exact
             launch counts (one paged_kv_write a layer and step), and a
             reused-prefix request's tokens equal to a fresh server's.
 10. sign kernels  sign_pack and predict_counts against their plain versions,
             bitwise, at full width: the gate weights (11008 x d) and x at B
             in {1, 4, 16, 24, 64, 65, 257} (64: a gather prefill chunk)
             plus a (G, B, d) batch, float32 and bf16, d in
             {4096, 4000} (a padded last word), zeros and -0.0 in the input;
             predict_margins bitwise against core.predictor.margins at alpha
             in {1.0, 1.03, per-slot with a dead slot}; predict_counts twice
             a case, and at its edges (k in {11000, 24, 1000}, d in {4096,
             4000, 100}, B in {1, 5, 65, 257}, words random, all ones, all
             ones against all zeros); sign_pack at its edges, each case
             twice (d in {5, 24, 33, 1000, 5120, 11000}, B in {1, 5, 64,
             257}, float32 and bf16, aligned and a 4-byte-offset view: the
             vector and the scalar route).  Timed at the main path's shapes
             (x at B=4, the gate weights at load, counts at B=4 and S=64)
             beside their bounds, an empty launch and their plain versions;
             no PyTorch call packs bits or counts popcounts, so no library
             yardstick.
 11. strategies  the 2 full-width float32 layers of phase 3 with strategies
             masked and gather, 8 teacher-forced steps on the card against
             the CPU, launches exact; then a 100-token gather sparse
             prefill in chunks of 64 rows (the controller serve's chunk
             MLP), card against CPU.
 12. serve-controller  all 32 layers through Server.serve with the
             adaptive-alpha controller per SLA tier (batch 4, 8 requests of
             mixed tiers, chunked sparse prefill feeding the prefill rider,
             a warmed 3-rung capacity ladder): strategy gather with a masked
             audit every 4th step, then strategy pallas (native false
             negatives, no audits).  Launch counts exact from load to
             drain; audits, bucket sequence and the controller's report
             printed; a profile of a gather step and of a masked audit step.
             With random weights the union demand stays near 1, so the
             ladder holds its top rung through the serve; a forced low
             demand estimate must then select the lowest rung.
 13. serve-overload  16 of the 32 layers (bf16 compute, bf16 paged pool, block
             16, the paged kernels, chunked sparse prefill in chunks of 64),
             batch 4, 12 requests of mixed tiers, 40-150-token prompts, 16
             new tokens each, on the fault injector's virtual clock.  Masked
             strategy (exact per slot): an unpressured serve, then the same
             queue on a pool of 18 blocks (about half of what the resident
             requests need) with preemption, a queue depth that sheds one
             request, a tight deadline, an injected prefill fault and a
             default deadline: every request ends completed or shed with a
             reason, each of queue_depth, deadline, fault and a preemption
             occurs, every completed request's tokens are bitwise the
             unpressured run's, the pool's invariants hold, paged_stats and
             throughput_report agree with the requests.  Then strategy
             pallas with the per-tier controller and the metrics hub, every
             sink written under build/metrics/: the JSONL validates, the
             trace is JSON, the exposition holds the gauge, counter and
             summary families, launches are exact; an injected decode fault
             aborts a serve and resets the server; the queue served again
             with the hub off gives the first serve's tokens bitwise, and
             the watchdog armed by the first drain counts no first use.
 14. archs   the other dense archs (prosparse-llama2-13b, qwen3-8b,
             qwen1.5-32b, granite-34b, gemma2-2b) at full width and 2
             layers (gemma2: one local, one global), float32 compute, the
             config's own selection (capacity 20%, binding), weights
             bridged from seeded numpy draws: 8 teacher-forced
             decode steps card against CPU on the dense cache (float32,
             then the config's own KV dtype), on a fragmented float32 pool
             with the paged kernels (and an int8 pool on the gather route
             for the int8 configs), a 160-token chunked sparse prefill;
             gemma2 also at per-slot lengths 4095, 4096, 4097 and 4500, its
             window of 4096 binding in the paged kernel, and the window
             against none with sparsity off.  Launches exact.  Then the
             kernels at the new shapes against their plain versions:
             sign_pack, both predictors and both float32-weight MLPs (bf16
             x, S=64 and B=4, each config's capacity) at gemma2's d=2304,
             k=9216, granite's ungated d=6144, k=24576 and qwen1.5's
             d=5120, k=27392; the paged attention and the paired KV write
             into a bf16 pool at gemma2's shape (hd 256, K=4, softcap 50,
             window 4096) and granite's (MQA, K=1); the decode MLP and the
             attention timed beside their bounds, plain versions and a
             library yardstick.
 15. serve-gemma2  gemma2-2b at full width and all 26 layers through
             Server.serve: bf16 paged pool, block 16, the paged kernels,
             chunked sparse prefill in chunks of 64, batch 4, 8 requests of
             mixed tiers with 96-192-token prompts; launches exact; a
             profiled paged decode step.
 16. sharded  the sparse MLP under SparseInferConfig.tp_shards (ms) and
             dp_shards (ds), each (data block, model shard) tile with its
             own union selection: (a) predict_group_margins and
             fused_sparse_mlp at the shard-local k/ms = 5504 and 2752 rows
             (C/ms = 144 and 72 groups, B in {2, 4}, bf16 x, on one shard's
             row views of the full weights), fused_sparse_mlp_q at 5504
             (qg 128) and predict_counts at 5504, B=2, against their plain
             versions, each twice bitwise, timed beside their bounds, plain
             versions and (the float32 MLP) the gathered-rows 3-matmul, and
             the ms shards' launches against one unsharded launch of the
             same work; (b) the 2 full-width float32 layers of phase 3, 8
             teacher-forced decode steps card against CPU (``_hold``, the
             per-shard riders held with the selection stats) for masked,
             gather and pallas at (ds, ms) = (2, 2) and (1, 4), int8 MLP
             weights at (1, 2) and per-shard bucket tuples at (2, 2),
             launches exactly ds * ms a tile kernel; (c) 16 of the 32
             layers through Server.serve at ds = ms = 2 (pallas, batch 4, 8
             requests of mixed tiers, the per-tier controller over the
             CTRL_BUCKETS ladder: 9 bucket tuples, warmed; a bf16 paged
             pool of 16-token blocks, chunks of 64, dense under sharding):
             launches exact from load to drain, the tuple sequence and
             shard_skew printed, forced per-shard demands picking a rung
             per shard, and a profiled paged decode step beside the
             unsharded one of the same shape; (d) int8 weights at
             tp_shards=4 rejected at Server construction, and the ms=4
             ladder (81 tuples) falling back to uniform tuples with a
             warning.
 16b. mesh   prosparse-llama2-7b at full width on torch.distributed ranks
             that share the card (``launch/ranks.py``, gloo: NCCL takes
             one rank of a communicator a card), each rank keeping its part
             of every leaf by the serve rules (MLP rows, attention heads
             and KV heads, vocabulary rows; ``init_lm(place=)``, a layer at
             a time): (a) 16 layers at ms = 2 on a 1x2 mesh (pallas,
             the per-tier controller, a bf16 paged pool on the paged
             kernels, batch 4, 4 requests, monolithic prefill); (b) 8
             layers at ds = ms = 2 on a 2x2 mesh (gather, the per-tier
             controller with masked audits; the slots split over 'data',
             each line decoding and caching 2 of the 4, then a two-turn
             session whose turn 2 lands on the other line, its chain
             blocks bitwise between the lines); (c) 2 layers with int8 MLP
             weights (qg 128, pallas) on the 1x2 mesh.  Ranks first, then
             the emulated grid in this process; every rank's tokens, EMAs
             and teacher-forced logits bitwise rank 0's, launches exact
             per rank; teacher-forced steps (float32 compute) on a dense
             cache and, for (a), through the paged kernels on a float32
             pool, each within 1e-3 of this process's replay fed the
             ranks' MLP inputs; each rank's slot range, decode rows and KV
             bytes held; peaks, parameter bytes and decode-step host
             walls printed; then NCCL tried once with two ranks on
             the card, its refusal printed.
 17. moe     the moe family (deepseek-moe-16b: a dense first layer on the
             sparse MLP kernels, then MoE layers of 64 experts, top-6, 2
             shared experts; olmoe-1b-7b: MoE layers only, top-8, qk-norm):
             (a) the kernels at deepseek's first-layer widths (d=2048,
             k=1408, C=48 of 176 groups, bf16 x) against their plain
             versions: sign_pack of x, of the gate weights and of one MoE
             layer's expert-stack gate weights at load (64 x 1408 rows),
             both predictors, both float32 MLPs, both int8 MLPs (qg 128)
             and predict_counts, twice bitwise where a kernel must be; the
             paged attention and the paired KV write at H=K=16, hd 128
             into a bf16 pool; each timed beside its bound, plain version
             and library yardstick; (b) both archs at full width and 2
             layers (deepseek: the dense layer and one MoE layer), float32
             compute, card against CPU through ``_hold``, whose CPU MoE
             calls also take the card's inputs: routing (the kept slots)
             equal but for tokens at a near tie in float32 rounding,
             printed with their gaps and counted; 8 teacher-forced decode
             steps (pallas, masked, gather; int8 MLP weights), a
             fragmented float32 pool on both routes, a 160-token chunked
             sparse prefill (float32 and int8 weights); launches exact;
             (c) olmoe-1b-7b (16 layers, 27.3 GB float32) and
             deepseek-moe-16b (28 layers, 64.4 GB float32 + 0.6 GB of
             sign packs) at full depth through Server.serve: the per-tier
             controller on pallas, a bf16 paged pool, chunked sparse
             prefill in chunks of 64, batch 4, 8 requests of mixed tiers
             with 96-192-token prompts; launches exact from load (the
             load-time sign packs of every MLP, expert stack and shared
             expert); a profiled paged decode step each.
 18. cross   the cross-attention families (seamless-m4t-medium: encdec,
             LayerNorm, a non-causal encoder, an ungated ReLU FFN;
             llama-3.2-vision-90b: vlm, a gated cross block every 5
             layers): (a) the sparse MLP's kernels at seamless's decoder FFN
             widths (ungated d=1024, k=4096, C=112 of 512 groups) and at the
             vlm's (d=8192, k=28672, C=720 of 3584), bf16 x, against their
             plain versions (``_mlp_kernel_times``): sign_pack of x and of
             the gate weights at load, both predictors, both float32 MLPs,
             both int8 MLPs (qg 128) and predict_counts, twice bitwise
             where a kernel must be, each timed beside its bound, plain
             version and library yardstick; (b) both at full width and
             reduced depth (seamless: 2 encoder and 2 decoder layers; the
             vlm: cross_every=2, one self and one gated cross block), the
             gates, norms and biases drawn non-zero, float32 compute, card
             against CPU through ``_hold``: ``encode`` first, then 8
             teacher-forced decode steps (pallas, masked, gather; int8 MLP
             weights) and a 160-token chunked sparse prefill (the frames
             encoded once); launches exact; (c) seamless at full depth (12
             + 12 layers, 2.46 GB float32) and the vlm at full width and 5
             layers (19.2 GB; its 100 do not fit) through Server.serve with
             their frames or images: the per-tier controller on pallas,
             chunked sparse prefill in chunks of 64, batch 4, 8 requests of
             mixed tiers with 96-192-token prompts, dense bf16 caches;
             launches exact from load (every MLP's sign pack, the
             encoder's too), one encode an admission, the peak memory and a
             profiled decode step each.
 19. recurrent  the hybrid family (zamba2-1.2b: 38 Mamba2 layers and a
             shared attention block every 6, each of its 6 invocations with
             its own LoRA on the query weights, the sparse MLP in the shared
             block) and the xlstm family (xlstm-125m: mLSTM and sLSTM blocks,
             no MLP, sparsity off): (a) the sparse MLP's kernels at the
             shared block's widths (d=2048, k=8192, C=208 of 1024 groups,
             bf16 x, ``_mlp_kernel_times``): sign_pack of x and of the gate
             weights at load, both predictors, both float32 MLPs, both int8
             MLPs (qg 128) and predict_counts against their plain versions,
             twice bitwise where a kernel must be, each timed beside its
             bound, plain version and library yardstick; (b) zamba2 at full
             width and 13 layers (two invocations, two LoRAs, one tail
             layer) and xlstm-125m at full width and depth, float32, every
             norm scale, LoRA up-projection, conv bias, D and dt bias (and
             xlstm's gate biases) drawn non-zero, card against CPU through
             ``_hold``: a 100-token prefill (two Mamba2 chunks of 50) and 8
             teacher-forced decode steps with per-slot alphas whose rows
             differ (zamba2: pallas, masked, gather, int8 MLP weights;
             xlstm: once, launching no kernel); the logits within 1e-3 and
             every recurrent state and KV cache within 1e-3 x its largest
             magnitude; launches exact; (c) both at full depth through
             Server.serve: zamba2-1.2b (4.43 GB float32) with the per-tier
             controller on pallas, bf16 compute and caches, and
             ``prefill_chunk=64``, which the family serves with the
             monolithic prefill and a warning; xlstm-125m with the plain
             serve; batch 4, 8 requests of mixed tiers with 96-192-token
             prompts; launches exact from load (zamba2: one sign pack, then
             two kernels an invocation a decode step; xlstm: none), the
             peak memory and a profiled decode step each.
 20. train   the training path (``lm_loss``, its backward, AdamW,
             ``runtime/trainer.py``), which launches none of the ten serving
             kernels (training takes the dense MLP, as the reference's):
             (a) prosparse-llama2-7b at full width and 2 layers, float32
             params and compute, one synthetic batch (B=1, S=64): the loss,
             every gradient leaf and one AdamW update on the card against
             the CPU on the same weights (loss within 1e-4 relative, each
             gradient leaf within 1e-3 x its largest magnitude, params
             within 2 lr + 1e-6), then the same step with the config's bf16
             compute (loss within 2e-2 relative, the gaps printed); (b) the
             same model at full width and 4 of its 32 layers with the
             config's dtypes and remat: 12 Trainer steps at global batch 4,
             S=1024 (median step time, tokens/s, peak memory, a profiled
             step, the model FLOPs' share of the bf16 dense peak), then 4
             steps twice from one seed under deterministic algorithms,
             their losses equal bit for bit; (c) xlstm-125m at full width
             and 4 of its 12 layers (one group: three mLSTM blocks and an
             sLSTM one; B=4, S=64) crashed at step 5 with async
             checkpoints every 3 steps, resumed by a new Trainer from step 3, steps 4-6 bit for bit an
             uninterrupted run's (deterministic algorithms on), the
             checkpoint's bytes and write time; (d) zamba2-1.2b,
             seamless-m4t-medium and gemma2-2b whole, olmoe-1b-7b at 2 of
             16 layers and deepseek-moe-16b with its dense first layer and
             one MoE layer: 3 steps each at B=2, S=256, loss and grad norm
             finite, the peak memory; (e) the same 7b at full width and 2
             layers, float32 compute, on a 2x2 mesh of gloo ranks that
             share the card (FSDP over the two data lines, the tensor
             split over 'model', ``sharding/train.py``), 2 Trainer steps
             at B=4, S=256: every rank's losses, grad norms and step times
             bitwise rank 0's; each step held against one process's step
             from the ranks' state before it (params and moments gathered
             whole): loss within 1e-5 relative, grad norm within 1e-4,
             every param leaf after it within 1e-4 x its max but for
             1% of ties (each within 2 lr).  No serving kernel launches
             in the phase.
 21. shapes  the reference's shape matrix (``configs.base.SHAPES``) on one
             card, prosparse-llama2-7b at full width unless stated, each
             peak memory beside the dry run's bytes
             (``launch/dryrun.py`` on meta): (a) one attention layer at
             S=8192, blocked by ``attn_chunk`` against whole-sequence
             softmax within 1e-3, and at S=32768 blocked only, with the
             bytes it allocates; (b) prefill_32k: ``make_step_fn``'s
             prefill step, 32 layers, B=1, S=32768, int8 KV, logits
             finite, profiled; (c) decode_32k: one decode step at cache
             length 32767 at the largest batch the dry run says fits
             (launches exact), profiled; (d) long_500k: one decode step of
             zamba2-1.2b and xlstm-125m whole at B=1, cache length 524287,
             on seeded (zero) caches; (e) train_4k: one train step at 4
             layers, B=1, S=4096, remat, profiled, no serving kernel; (f)
             the legacy chunked scheduler (``slot_refill=False``) at 32
             layers, pallas, batch 4, 8 requests of mixed tiers and
             96-192 tokens, ``prefill_chunk=64``: launches exact from load
             to drain, the tier warning once; then the serve CLI with
             ``--no-slot-refill`` (its report's scheduler and
             sla_applied); (g) 2 full-width float32 layers calibrated on
             a 256-token prompt's gate activations, co-activation
             permuted and re-prepared (a sign pack a layer): 8
             teacher-forced steps with sparsity off within 1e-3 of the
             unpermuted model, then with sparsity on card against CPU
             (``_hold``), the group density before and after printed.
 22. report  a {"kernels": [...]} line, then {"ok": true, "device": ...}.

It exits non-zero without a GPU, and without the repository beside it.

    python3 chip_smoke.py --cards4

on a host with four cards: the kernels at a rank's shapes of 1x4
(``--cards4-kernels``), then qwen1.5-32b (64 layers) and granite-34b (88)
at full depth, granite at 2 layers with int8 MLP weights and
prosparse-llama2-7b at 16 layers on a 1x4 mesh, a rank a card over NCCL
(every rank bitwise rank 0, launches exact, tokens/s, peaks, a profiled
paged decode step), the last case again on four gloo ranks of card 0,
bitwise the NCCL run; then on a 2x2 mesh over NCCL (the slots split over
'data', four of eight a line) prosparse-llama2-13b at full depth (40
layers, pallas, bf16 paged pool) and at 8 layers (gather, the per-tier
controller, float32 dense caches, a session across the lines, its
teacher-forced logits held against one process on card 0); then training
on a 2x2 mesh over NCCL (``_cards4_train``): (g) prosparse-llama2-7b at
full depth (32 layers, remat, B=8, S=1024, 3 steps; every rank's history
bitwise rank 0's; a rank's parameter and moment bytes against one
device's, its peak after placing the weights and overall, neither
holding the whole parameter tree; step ms, tokens/s, one step's
collectives by axis, the model FLOPs' share of four cards' bf16 peak)
and (h) the same model at 4 layers, float32 compute (B=8, S=256, 4
steps), its first 2 steps held against one process on card 0 as phase
20 (e) holds them, with a checkpoint of step 2 that one process resumes
for steps 3-4 (within 1e-5 of the ranks' losses).  It ends with the contract
line (``count`` 4).

    python3 chip_smoke.py --cards4-train

on a host with four cards: ``--cards4``'s training, (g) and (h), alone.
It ends with the contract line.

    python3 chip_smoke.py --cards4-kernels

on one card: the kernels at the shapes a rank of ``--cards4`` gives them
(qwen1.5-32b's, granite-34b's and prosparse-llama2-7b's heads, KV heads
and k/4 MLP rows; every MLP kernel at granite's, #5 on int8 weights
among them; prosparse-llama2-13b's 2x2 rank: 20 heads, k/2 rows, 4
slots) against their plain versions, timed.  It ends with the
contract line.

    python3 chip_smoke.py --kv-ab OTHER_SRC

times the KV write (#8) and sign_pack (#9) of another checkout's ``src``
(say the parent commit's, unpacked by ``git archive``) beside this one's,
in the order other, this, this, other, each in a process of its own: the
decode step's K and V write at B=4 and 16 beside the single entry, two
``index_put_`` and an empty launch; sign_pack on x at B in {1, 4, 64} and
on the gate weights at load; the paged attention and the float32 decode
and chunk MLPs (unchanged kernels, the yardstick); a profiled full-depth
paged decode step and gather prefill chunk and decode step.  Every run's
#8 and #9 outputs must be bitwise the first run's.  It runs no other
phase.

    python3 chip_smoke.py --pred-ab OTHER_SRC

times the predictors of another checkout's ``src`` beside this one's, in
the order other, this, this, other, each in a process of its own: the
predictors' scaling line of phase 2 (predict_group_margins,
predict_chunk_group_margins and predict_counts), the float32 decode and
chunk MLP kernels on the same shapes (unchanged code, the yardstick) and a
profiled full-depth prefill chunk (S=64) and decode step (B=4) with
float32 MLP weights, strategy pallas and then gather.  It runs no other
phase.

    python3 chip_smoke.py --decode-ab OTHER_SRC

times the float32 decode MLP of another checkout's ``src`` beside this
one's, in the order other, this, this, other, each in a process of its
own: the float32 decode scaling line of phase 2 (untraced for the other)
and a profiled full-depth decode step with float32 MLP weights.  It runs
no other phase.

    python3 chip_smoke.py --decode-q-ab OTHER_SRC

times the int8 decode MLP of another checkout's ``src`` (say the parent
commit's, unpacked by ``git archive``) beside this one's, in the order
other, this, this, other, each in a process of its own: the scaling line
of phase 2 (untraced for the other) and a profiled full-depth int8 decode
step.  It runs no other phase.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# cuBLAS reads this when it creates its handle, before any CUDA call: the
# training phase's bitwise checks run under deterministic algorithms,
# which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
# outside the tensor cores (where most kernels' arithmetic runs) and the
# dense TF32 and bf16 tensor-core rates (the chunk MLPs' products)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# the sign-bit predictors' two rates, for which no data sheet gives a
# peak: __popc issues 16 a clock per SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput), at the 1.98 GHz boost clock
# of 132 SMs (tools/predict_step0.py measured 15.8 a clock per SM on the
# H100 at 700 W); mma.sync m16n8k256 b1 .and.popc (16 x 8 x 256 bit
# multiply-adds) ran at 0.59 a clock per SM there, the rate of int8
# m16n8k32
POPC_PER_S = 16 * 132 * 1.98e9
B1_MACS_PER_S = 0.59 * 16 * 8 * 256 * 132 * 1.98e9

SLEEP_CYCLES = 10_000_000   # ~5 ms at the H100's ~1.98 GHz SM clock

D, K, G = 4096, 11008, 8
QG = 128                  # int8 quant group width
BATCHES = (1, 4, 16)
CHUNK_ROWS = (17, 64, 128, 256)
SCALING_ROWS = (16, 32, 64, 128, 256)   # the chunk MLP's scaling line
DECODE_BATCHES = (1, 4, 8, 16)          # the int8 decode MLP's scaling line
COUNTS_ROWS = (1, 4, 8, 16, 64, 128, 256)   # predict_counts' scaling line
MAIN_BATCH = 4            # the serve phase's batch: the main path's shape
MAIN_CHUNK = 64           # the chunked serve phase's prefill chunk
PAGE_BLOCK = 16           # the paged pool's block size
PAGED_NBPS = (16, 128)    # blocks per slot: max_len 256 and 2048
MAIN_LIVE = (64, 100, 150, 192)   # the timed paged shape's slot lengths
# the port's kernels by namespace (profiler rows); counts:: is that of the
# CUDA-core predict_counts of older checkouts, which --pred-ab may profile
OWN_KERNELS = ("mlp::", "mlpq::", "predict::", "paged::", "paged_write::",
               "sign::", "counts::")
D_PAD = 4000              # a width that is not a multiple of 32
# capacity fractions of the controller serve's ladder: 144, 288 and 560 of
# the 1376 row groups
CTRL_BUCKETS = (0.1, 0.2, 0.4)
OVERLOAD_POOL = 18        # the overload phase's pool: about half the demand
# the overload phase's depth, a cut of the 7b's 32 layers: its schedule
# runs on a virtual clock, so its steps, chunks, sheds and preemptions do
# not depend on it
OVERLOAD_LAYERS = 16
# the model-level checks' logits tolerance by KV dtype (``_hold``: card
# against CPU, each MLP fed the same input): with a float32 cache the two
# differ in float32 summation order only; a bf16 or int8 cache rounds q
# (and, int8, p) to bf16 before the products, where the card's float32
# drift can move a value by one bf16 ulp (2^-8 relative)
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2, "int8": 5e-2}
# the stats that follow from the selection alone (``_hold`` holds them
# equal); the active and false-negative counts also read the gate values'
# signs, which two sums in another order may disagree on near 0
SELECTION_STATS = ("predicted_density", "realized_density", "overflow_frac",
                   "union_demand_frac", "shard_realized_density",
                   "shard_union_frac")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` in ms, with the host out of the way:
    before each timed call the stream first sleeps (``torch.cuda._sleep``,
    ~5 ms) so that the host has enqueued the whole call behind the sleep,
    and the CUDA events around the call bracket device work only (a call
    that synchronizes inside still waits for the host after that point).
    With ``flush`` (a callable that evicts the L2) each call follows a
    flush, so the kernel finds its inputs in HBM as inside a decode step."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


_EMPTY: dict = {}


def empty_kernel():
    """``tools/launch_empty.cu`` built by nvcc (once a process, into
    ``build/launch_empty/``) and loaded: an empty kernel, the floor of any
    launch under ``cuda_ms``."""
    lib = _EMPTY.get("lib")
    if lib is None:
        import ctypes
        src = os.path.join(HERE, "tools", "launch_empty.cu")
        out_dir = os.path.join(HERE, "build", "launch_empty")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"liblaunch_empty.{os.getpid()}.so")
        proc = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", "-gencode",
             "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-o", out, src], capture_output=True, text=True)
        if proc.returncode:
            fail(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(out)
        lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        _EMPTY["lib"] = lib
    return lib


def empty_ms(blocks: int, flush=None, iters: int = 50) -> float:
    """``cuda_ms`` of one empty launch of ``blocks`` 128-thread blocks."""
    import torch
    lib = empty_kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.empty_launch(blocks, 128, stream)
        if rc:
            fail(f"the empty launch of {blocks} blocks: CUDA error {rc}")
    return cuda_ms(launch, iters=iters, flush=flush)


def predict_work(rows: int, xbytes: int, d: int = D, k: int = K,
                 counts: bool = False) -> tuple[float, float, float]:
    """Least times of one predictor call for ``rows`` tokens, in ms: the
    packed gate signs, x, alpha, gm and cnt moved once at the HBM rate
    (``counts``: the packed gate signs, x's packed words and the (rows, k)
    int32 counts); the AND-popcount bit products (rows * k * w * 32) on the
    binary tensor cores, the kernels' route; ``rows * k * w`` popcounts on
    the CUDA cores, the floor of any CUDA-core design."""
    w = -(-d // 32)
    n_bytes = k * w * 4 + rows * w * 4 + rows * k * 4 if counts else \
        k * w * 4 + rows * d * xbytes + rows * 4 + rows * (k // G) * 4 + \
        rows * 4
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            rows * k * w * 32 / B1_MACS_PER_S * 1e3,
            rows * k * w / POPC_PER_S * 1e3)


def predict_bounds(rows: int, xbytes: int) -> tuple[float, str, float, str]:
    """(bound ms, by) of a predictor call on the binary tensor cores (the
    least time the card could take), then the same on the CUDA cores."""
    t_b, t_tc, t_cc = predict_work(rows, xbytes)
    return (max(t_b, t_tc), "bytes" if t_b >= t_tc else "operations",
            max(t_b, t_cc), "bytes" if t_b >= t_cc else "operations")


def tc_bound_ms(n_bytes: float, tf32_flops: float,
                bf16_flops: float = 0.0) -> tuple[float, str]:
    """bound_ms for the tensor-core chunk MLPs: the flops of the TF32 passes
    the kernel runs (each product of split operands takes one pass a pair
    of parts) at the TF32 dense peak, plus those of its bf16 products at
    the bf16 peak."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = tf32_flops / TF32_OPS_PER_S + bf16_flops / BF16_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def chunk_q_work(rows: int, count: int, cap: int, xbytes: int,
                 sel_rows) -> tuple[int, int, int, int]:
    """Bytes, flops, TF32-pass flops and bf16 flops of one int8 chunk-MLP
    call: count*G int8 rows of the three matrices, their gate/up scales,
    one wd scale row per quant row-group the selection touches, x, the
    selection and its count read once, y written once; 6 flops per token,
    selected row and column.  The passes: gate and up one bf16 product each
    with bf16 x (int8 and bf16 x exact), two TF32 passes each with float32
    x (x split); down two TF32 passes (h split, float32)."""
    import torch
    q_rows = int(torch.unique(sel_rows // (QG // G)).numel())
    n_bytes = (3 * count * G * D + 2 * count * G * (D // QG) * 4
               + q_rows * D * 4 + rows * D * xbytes + cap * 4 + 4
               + rows * D * 4)
    mat = 2 * rows * count * G * D
    if xbytes == 2:
        return n_bytes, 3 * mat, 2 * mat, 2 * mat
    return n_bytes, 3 * mat, 6 * mat, 0


def chunk_mlp_work(rows: int, count: int, cap: int,
                   xbytes: int) -> tuple[int, int]:
    """Bytes and flops of one chunk-MLP call: count*G rows of the three
    float32 matrices, x, the selection and its count read once, y written
    once; 6 flops per token, selected row and column."""
    n_bytes = (3 * count * G * D * 4 + rows * D * xbytes + cap * 4 + 4
               + rows * D * 4)
    return n_bytes, 6 * rows * count * G * D


def _gathered_mlp(wg, wu, wd, sel_rows):
    """The library yardstick of the chunk MLP: the selected rows of the
    three matrices gathered beforehand, then three float32 matmuls."""
    import torch
    take = [m.reshape(K // G, G, D)[sel_rows].reshape(-1, D).contiguous()
            for m in (wg, wu, wd)]
    return lambda x: (torch.relu(x @ take[0].T) * (x @ take[1].T)) @ take[2]


def phase_chunk_scaling(traced: bool = True) -> None:
    """The float32 chunk MLP's time against the chunk's rows S and against
    the selected rows (count full and a third of it; none at S=64, the
    fixed cost), bf16 x, beside its bounds and the gathered-rows library
    yardstick at each point: whether the time follows S x rows
    (operations) or the rows alone (bytes or latency).  One more launch at
    each point records the kernel's phase trace (KF.phase_times).  Then a
    contiguous read of the same weight bytes by one PyTorch reduction: the
    rate a plain read reaches on this card.  Then the same line for the
    int8 chunk MLP on the same weights quantized (qg=128; no PyTorch call
    computes it), and a contiguous read of its weight bytes.  ``traced``
    False leaves out the traced launches (for kernels that take no trace);
    run alone from a script that puts a checkout's ``src`` on sys.path, it
    times that checkout's kernels."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    cap = SparseInferConfig().capacity(K)
    x0 = torch.randn((MAIN_CHUNK, D), generator=gen, device=dev)
    gm, _ = KP.predict_chunk_group_margins(
        P.pack_signs(wg), x0, torch.ones(MAIN_CHUNK, device=dev),
        d_valid=D, group_size=G)
    sel = S.capacity_select(S.union_margin(gm), cap)
    full = int(sel.count)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for rows in SCALING_ROWS:
        x = torch.randn((rows, D), generator=gen, device=dev).to(
            torch.bfloat16)
        xf = x.float()
        for count in (full, full // 3, 0):
            if count == 0 and rows != MAIN_CHUNK:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                x, wg, wu, wd, sel.indices, cnt, group_size=G), flush=flush)
            lib = _gathered_mlp(wg, wu, wd, sel.indices[:count].long())
            t_lib = cuda_ms(lambda: lib(xf), flush=flush)
            n_bytes, flops = chunk_mlp_work(rows, count, cap, 2)
            tc = tc_bound_ms(n_bytes, 2 * flops)
            cc = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:   # one more launch with its phase trace, L2 flushed
                trace = torch.zeros(
                    (KF.chunk_plan(x, cap * G).grid, KF.TRACE_POINTS),
                    dtype=torch.int64, device=dev)
                flush()
                KF.fused_sparse_mlp_chunk(x, wg, wu, wd, sel.indices, cnt,
                                          group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp_chunk S={rows} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, gathered-rows "
                  f"3-matmul {t_lib:.4f} ms, bound {tc[0]:.4f} ms "
                  f"({tc[1]}, TF32 x2 passes) / {cc[0]:.4f} ms ({cc[1]}, "
                  f"CUDA cores); one traced launch, ms: {phases}",
                  flush=True)
    # what a plain read of the same bytes takes on this card: one PyTorch
    # reduction over a contiguous buffer of the three matrices' selected
    # rows (113 MB at the full selection)
    n_bytes, _ = chunk_mlp_work(MAIN_CHUNK, full, cap, 2)
    flat = torch.ones(3 * full * G * D, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] a contiguous read of the selected weights' "
          f"{3 * full * G * D * 4 / 1e6:.1f} MB (torch.sum): {t_read:.4f} ms,"
          f" {3 * full * G * D * 4 / t_read / 1e9:.3f} TB/s (bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del flat
    # ---- the int8 chunk MLP on the same weights, quantized (qg=128)
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn[n] for n in QNAMES]
    del wg, wu, wd
    for rows in SCALING_ROWS:
        x = torch.randn((rows, D), generator=gen, device=dev).to(
            torch.bfloat16)
        for count in (full, full // 3, 0):
            if count == 0 and rows != MAIN_CHUNK:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp_chunk_q(
                x, *qargs, sel.indices, cnt, group_size=G), flush=flush)
            n_bytes, flops, tf32, bf16 = chunk_q_work(
                rows, count, cap, 2, sel.indices[:count].long())
            tc = tc_bound_ms(n_bytes, tf32, bf16)
            cc = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:
                trace = torch.zeros(
                    (KF.chunk_plan(x, cap * G, 1, G).grid, KF.TRACE_POINTS),
                    dtype=torch.int64, device=dev)
                flush()
                KF.fused_sparse_mlp_chunk_q(x, *qargs, sel.indices, cnt,
                                            group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp_chunk_q S={rows} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, bound "
                  f"{tc[0]:.4f} ms ({tc[1]}, bf16 gate/up, TF32 x2 down; share "
                  f"{tc[0] / t:.3f}) / {cc[0]:.4f} ms ({cc[1]}, CUDA cores); "
                  f"one traced launch, ms: {phases}", flush=True)
    # a plain read of the int8 kernel's weight bytes (28 MB at the full
    # selection), as float32 words
    n_bytes = chunk_q_work(MAIN_CHUNK, full, cap, 2,
                           sel.indices[:full].long())[0]
    flat = torch.ones(3 * full * G * D // 4, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] a contiguous read of the selected int8 weights' "
          f"{3 * full * G * D / 1e6:.1f} MB (torch.sum): {t_read:.4f} ms,"
          f" {3 * full * G * D / t_read / 1e9:.3f} TB/s (bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del qn, qargs, flat, flush_buf
    torch.cuda.empty_cache()


def phase_decode_q_scaling(traced: bool = True) -> None:
    """The int8 decode MLP's time against the batch B (1, 4, 8, 16) and the
    selected rows (count full and a third of it; none at B=4, the fixed
    cost), bf16 x, on prosparse-llama2-7b's weights quantized (qg=128),
    beside its bound (bytes, or the CUDA cores' operations): whether the
    time follows the rows (bytes or latency) or B x rows (operations).
    One more launch at each point records the kernel's phase trace
    (KF.q_phase_times); ``traced`` False leaves it out (for a kernel that
    takes no trace).  Before the line, the float32 decode kernel at B=4 on
    the same weights and selection; after it, a contiguous read of the
    same int8 bytes by one PyTorch reduction: the rate a plain read reaches
    on this card.  Run alone from a script that puts a checkout's ``src``
    first on sys.path, it times that checkout's kernels."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    cap = SparseInferConfig().capacity(K)
    x0 = torch.randn((MAIN_BATCH, D), generator=gen, device=dev)
    gm, _ = KP.predict_group_margins(
        P.pack_signs(wg), x0, torch.ones(MAIN_BATCH, device=dev),
        d_valid=D, group_size=G)
    sel = S.capacity_select(S.union_margin(gm), cap)
    full = int(sel.count)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    # the float32 decode kernel on the same weights and selection (it shares
    # no code with the int8 one: its time should not move)
    xb = x0.to(torch.bfloat16)
    t = cuda_ms(lambda: KF.fused_sparse_mlp(xb, wg, wu, wd, sel.indices,
                                            sel.count, group_size=G),
                flush=flush)
    print(f"[scaling] fused_sparse_mlp B={MAIN_BATCH} x=bfloat16 count="
          f"{full}/{cap} (float32 weights): kernel {t:.4f} ms", flush=True)
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn[n] for n in QNAMES]
    del wg, wu, wd, qn
    for b in DECODE_BATCHES:
        x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
        for count in (full, full // 3, 0):
            if count == 0 and b != MAIN_BATCH:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp_q(
                x, *qargs, sel.indices, cnt, group_size=G), flush=flush)
            n_bytes, flops = chunk_q_work(b, count, cap, 2,
                                          sel.indices[:count].long())[:2]
            bd = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:   # one more launch with its phase trace, L2 flushed
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                trace = torch.zeros((KF.MAX_BLOCKS_PER_SM * sms,
                                     KF.Q_TRACE_POINTS), dtype=torch.int64,
                                    device=dev)
                flush()
                KF.fused_sparse_mlp_q(x, *qargs, sel.indices, cnt,
                                      group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.q_phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp_q B={b} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, bound "
                  f"{bd[0]:.4f} ms ({bd[1]}; share {bd[0] / t:.3f}); one "
                  f"traced launch, ms: {phases}", flush=True)
    # a plain read of the kernel's int8 weight bytes at the full selection
    # (28 MB), as float32 words
    n_bytes = chunk_q_work(MAIN_BATCH, full, cap, 2,
                           sel.indices[:full].long())[0]
    flat = torch.ones(3 * full * G * D // 4, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] decode int8: a contiguous read of the selected int8 "
          f"weights' {3 * full * G * D / 1e6:.1f} MB (torch.sum): "
          f"{t_read:.4f} ms, {3 * full * G * D / t_read / 1e9:.3f} TB/s "
          f"(bound of the kernel's bytes at B={MAIN_BATCH} "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del qargs, flat, flush_buf
    torch.cuda.empty_cache()


def phase_decode_scaling(traced: bool = True) -> None:
    """The float32 decode MLP's time against the batch B (1, 4, 8, 16) and
    the selected rows (count full and a third of it; none at B=4, the
    fixed cost), bf16 x, on prosparse-llama2-7b's weights, beside its bound
    (bytes, or the CUDA cores' operations) and share, and the gathered-rows
    3-matmul on the same inputs: whether the time follows the rows (bytes
    or latency) or B x rows (operations).  One more launch at each point
    records the kernel's phase trace (KF.decode_phase_times); ``traced``
    False leaves it out (for a kernel that takes no trace).  After the
    line, a contiguous read of the same float32 bytes by one PyTorch
    reduction: the rate a plain read reaches on this card.  Run alone from
    a script that puts a checkout's ``src`` first on sys.path, it times
    that checkout's kernel."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    cap = SparseInferConfig().capacity(K)
    x0 = torch.randn((MAIN_BATCH, D), generator=gen, device=dev)
    gm, _ = KP.predict_group_margins(
        P.pack_signs(wg), x0, torch.ones(MAIN_BATCH, device=dev),
        d_valid=D, group_size=G)
    sel = S.capacity_select(S.union_margin(gm), cap)
    full = int(sel.count)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for b in DECODE_BATCHES:
        x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
        xf = x.float()
        for count in (full, full // 3, 0):
            if count == 0 and b != MAIN_BATCH:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp(
                x, wg, wu, wd, sel.indices, cnt, group_size=G), flush=flush)
            lib = _gathered_mlp(wg, wu, wd, sel.indices[:count].long())
            t_lib = cuda_ms(lambda: lib(xf), flush=flush)
            n_bytes, flops = chunk_mlp_work(b, count, cap, 2)
            bd = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:   # one more launch with its phase trace, L2 flushed
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                trace = torch.zeros((KF.MAX_BLOCKS_PER_SM * sms,
                                     KF.D_TRACE_POINTS), dtype=torch.int64,
                                    device=dev)
                flush()
                KF.fused_sparse_mlp(x, wg, wu, wd, sel.indices, cnt,
                                    group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.decode_phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp B={b} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, bound "
                  f"{bd[0]:.4f} ms ({bd[1]}; share {bd[0] / t:.3f}), "
                  f"gathered-rows 3-matmul {t_lib:.4f} ms; one traced "
                  f"launch, ms: {phases}", flush=True)
    # a plain read of the kernel's weight bytes at the full selection (113
    # MB)
    n_bytes = chunk_mlp_work(MAIN_BATCH, full, cap, 2)[0]
    flat = torch.ones(3 * full * G * D, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] decode float32: a contiguous read of the selected "
          f"weights' {3 * full * G * D * 4 / 1e6:.1f} MB (torch.sum): "
          f"{t_read:.4f} ms, {3 * full * G * D * 4 / t_read / 1e9:.3f} TB/s "
          f"(bound of the kernel's bytes at B={MAIN_BATCH} "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del wg, wu, wd, flat, flush_buf
    torch.cuda.empty_cache()


def phase_predict_scaling(outputs: dict | None = None) -> None:
    """The predictors' time against the tokens, bf16 x on
    prosparse-llama2-7b's gate signs, alpha 1.0: the decode kernel at B in
    DECODE_BATCHES, the chunk kernel at S in SCALING_ROWS and the counts
    kernel (x's packed words) at B in COUNTS_ROWS, each beside its three
    least times (bytes at 3.35 TB/s, the bit products on the binary tensor
    cores, the popcounts on the CUDA cores) and the share of each.  Run
    alone from a script that puts a checkout's ``src`` first on sys.path,
    it times that checkout's kernels; ``outputs`` then collects every
    point's outputs (on the CPU) by name, for another checkout's to be held
    against them."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import predict as KP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    pw = P.pack_signs(torch.randn((K, D), generator=gen, device=dev))
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for name, rows, tag in (("predict_group_margins", DECODE_BATCHES, "B"),
                            ("predict_chunk_group_margins", SCALING_ROWS,
                             "S")):
        fn = getattr(KP, name)
        for r in rows:
            x = torch.randn((r, D), generator=gen, device=dev).to(
                torch.bfloat16)
            alpha = torch.ones(r, device=dev)
            t = cuda_ms(lambda: fn(pw, x, alpha, d_valid=D, group_size=G),
                        flush=flush)
            if outputs is not None:
                outputs[f"{name} {tag}={r}"] = [
                    o.cpu() for o in fn(pw, x, alpha, d_valid=D,
                                        group_size=G)]
            t_b, t_tc, t_cc = predict_work(r, 2)
            print(f"[scaling] predict {name} {tag}={r}: {t:.4f} ms; bytes "
                  f"{t_b:.4f} ms (share {t_b / t:.3f}), b1 tensor cores "
                  f"{t_tc:.4f} ms (share {t_tc / t:.3f}), CUDA-core "
                  f"popcounts {t_cc:.4f} ms (share {t_cc / t:.3f})",
                  flush=True)
    for r in COUNTS_ROWS:
        px = P.pack_signs(torch.randn((r, D), generator=gen, device=dev))
        t = cuda_ms(lambda: KP.predict_counts(pw, px), flush=flush)
        if outputs is not None:
            outputs[f"predict_counts B={r}"] = [KP.predict_counts(pw,
                                                                  px).cpu()]
        t_b, t_tc, t_cc = predict_work(r, 4, counts=True)
        print(f"[scaling] predict_counts B={r}: {t:.4f} ms; bytes "
              f"{t_b:.4f} ms (share {t_b / t:.3f}), b1 tensor cores "
              f"{t_tc:.4f} ms (share {t_tc / t:.3f}), CUDA-core popcounts "
              f"{t_cc:.4f} ms (share {t_cc / t:.3f})", flush=True)
    del pw, flush_buf
    torch.cuda.empty_cache()


def phase_predict_edges() -> None:
    """Both predictor kernels at their edges, bitwise against the plain
    version, and the chunk kernel's rows against the decode kernel's on
    16-row slices: S in {1, 17, 257} (token tiles of 1, 17 and 52 rows),
    d=4000 (rows of 125 words: 4-byte loads, a partial span), d=100 (one
    partial span), d=5120 (prosparse-llama2-13b's width: two chunks of
    4096 columns), G in {1, 8, 16}, k not a multiple of 16 rows, x random,
    all negative and all zero (+0.0 and -0.0), bf16 and float32 x, per-row
    alphas with dead rows."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 0
    for d, k, g in ((D_PAD, K, 16), (D_PAD, K, 1), (D, K, 8), (100, 500, 1),
                    (256, 1008, 16), (5120, 1024, 8)):
        pw = P.pack_signs(torch.randn((k, d), generator=gen, device=dev))
        for s in (1, 17, 257):
            alpha = _chunk_alphas(s, dev) if s > 1 else \
                torch.ones(1, device=dev)
            x0 = torch.randn((s, d), generator=gen, device=dev)
            zero = torch.zeros((s, d), device=dev)
            zero[:, 1::2] = -0.0
            for kind, xk in (("random", x0), ("negative", -x0.abs() - 1e-3),
                             ("zero", zero)):
                for xdt in (torch.bfloat16, torch.float32):
                    x = xk.to(xdt)
                    tag = f"d={d} k={k} G={g} S={s} x={kind} {xdt}"
                    gm, cnt = ops.predict_chunk_group_margins(
                        pw, x, d, alpha, group_size=g)
                    gm_r, cnt_r = ref.predict_group_margins_ref(
                        pw, x, d, alpha, g)
                    one = [ops.predict_group_margins(
                        pw, x[i:i + 16], d, alpha[i:i + 16], group_size=g)
                        for i in range(0, s, 16)]
                    gm_1 = torch.cat([o[0] for o in one])
                    cnt_1 = torch.cat([o[1] for o in one])
                    torch.cuda.synchronize()
                    if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                        fail(f"predict_chunk_group_margins {tag}: "
                             f"{int((gm != gm_r).sum())} margins and counts "
                             f"{cnt[:4].tolist()} vs {cnt_r[:4].tolist()} "
                             "differ from the plain version")
                    if not (torch.equal(gm_1, gm_r)
                            and torch.equal(cnt_1, cnt_r)):
                        fail(f"predict_group_margins {tag}: the decode "
                             "kernel's rows differ from the plain version")
                    n += 1
    print(f"[kernels] {n} predictor edge cases (S in {{1, 17, 257}}, d in "
          f"{{100, {D_PAD}, {D}, 5120}}, G in {{1, 8, 16}}, x random, all "
          "negative, all +-0.0, bf16 and float32): the chunk kernel and the "
          "decode kernel on 16-row slices bitwise equal to the plain version",
          flush=True)


def phase_build() -> None:
    from repro_torch.kernels import build
    t = build.build()
    print(f"[build] {sorted(build.SIGNATURES)} in {t:.1f} s", flush=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def _alpha_cases(b: int, device):
    import torch
    from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
    per_slot = torch.linspace(0.9, 1.1, b, device=device)
    if b > 1:
        per_slot[-1] = DEAD_SLOT_ALPHA
    return {"1.0": torch.full((b,), 1.0, device=device),
            "1.03": torch.full((b,), 1.03, device=device),
            "per-slot+dead": per_slot}


def phase_kernels(results: dict) -> None:
    """Each kernel against its plain version at full width."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    sign_wg = P.pack_signs(wg)
    w = sign_wg.shape[1]
    cap = SparseInferConfig().capacity(K)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for xdt in (torch.bfloat16, torch.float32):
        xbytes = torch.tensor([], dtype=xdt).element_size()
        for b in BATCHES:
            x = torch.randn((b, D), generator=gen, device=dev).to(xdt)
            for aname, alpha in _alpha_cases(b, dev).items():
                tag = f"B={b} x={str(xdt)[6:]} alpha={aname}"
                # ---- predictor: bitwise
                gm, cnt = KP.predict_group_margins(sign_wg, x, alpha,
                                                   d_valid=D, group_size=G)
                gm_r, cnt_r = ref.predict_group_margins_ref(sign_wg, x, D,
                                                            alpha, G)
                torch.cuda.synchronize()
                if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                    bad = int((gm != gm_r).sum())
                    fail(f"predict_group_margins {tag}: {bad} margins and "
                         f"counts {cnt.tolist()} vs {cnt_r.tolist()} differ")
                # ---- fused MLP over this selection, full and cut short
                sel, _ = S.capacity_select_with_stats(S.union_margin(gm), cap)
                full = int(sel.count)
                for count in sorted({full, full // 3}):
                    cnt_t = torch.tensor(count, dtype=torch.int32, device=dev)
                    y, tel = KF.fused_sparse_mlp(
                        x, wg, wu, wd, sel.indices, cnt_t, gm,
                        group_size=G, collect_stats=True)
                    y0 = _same_twice(
                        f"{tag} count={count} without telemetry",
                        lambda: KF.fused_sparse_mlp(
                            x, wg, wu, wd, sel.indices, cnt_t,
                            group_size=G), name="fused_sparse_mlp")
                    y_r = ref.fused_sparse_mlp_ref(x, wg, wu, wd,
                                                   sel.indices, cnt_t,
                                                   group_size=G)
                    tel_r = ref.fused_mlp_telemetry_ref(
                        x, wg, sel.indices, cnt_t, gm, group_size=G)
                    torch.cuda.synchronize()
                    # tolerance: float32 sums in another order; with bf16
                    # inputs h is rounded to bf16, where one ulp of h's
                    # float32 value can move it by one bf16 ulp (2^-8)
                    rtol = 2e-3 if xdt == torch.bfloat16 else 1e-4
                    scale = float(y_r.abs().max()) or 1.0
                    err = float((y - y_r).abs().max())
                    if err > rtol * scale or not torch.equal(y, y0):
                        fail(f"fused_sparse_mlp {tag} count={count}: max abs "
                             f"err {err:.3e} > {rtol} x max|y| {scale:.3e}, "
                             f"or y differs with/without telemetry")
                    _check_telemetry(tel, tel_r, x, wg, sel.indices, count,
                                     f"{tag} count={count}")
                    results.setdefault("fused_err", {})[(b, xdt)] = max(
                        err, results.get("fused_err", {}).get((b, xdt), 0.0))
                if aname == "1.0":
                    results.setdefault("sel", {})[(b, xdt)] = (x, alpha, sel)
            # ---- timings on the alpha=1.0 selection of this shape
            x, alpha, sel = results["sel"][(b, xdt)]
            count = int(sel.count)
            t_pred = cuda_ms(lambda: KP.predict_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_pred_plain = cuda_ms(lambda: ref.predict_group_margins_ref(
                sign_wg, x, D, alpha, G), iters=5, flush=flush)
            p_bound = predict_bounds(b, xbytes)
            t_mlp = cuda_ms(lambda: KF.fused_sparse_mlp(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_mlp_plain = cuda_ms(lambda: ref.fused_sparse_mlp_ref(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            xf = x.float()
            t_dense = cuda_ms(lambda: (torch.relu(xf @ wg.T) * (xf @ wu.T))
                              @ wd, flush=flush)
            lib = _gathered_mlp(wg, wu, wd, sel.indices[:count].long())
            t_lib = cuda_ms(lambda: lib(xf), flush=flush)
            del lib
            mb = 3 * count * G * D * 4 + b * D * xbytes + cap * 4 + b * D * 4
            m_bound = bound_ms(mb, 6 * b * count * G * D)
            err = results["fused_err"][(b, xdt)]
            print(f"[kernels] predict_group_margins B={b} x={str(xdt)[6:]}: "
                  f"max_abs_err 0 (bitwise, 9 cases) kernel {t_pred:.4f} ms "
                  f"plain {t_pred_plain:.4f} ms bound {p_bound[0]:.4f} ms "
                  f"({p_bound[1]}, b1 tensor cores; share "
                  f"{p_bound[0] / t_pred:.3f}) / {p_bound[2]:.4f} ms "
                  f"({p_bound[3]}, CUDA-core popcounts; share "
                  f"{p_bound[2] / t_pred:.3f})", flush=True)
            print(f"[kernels] fused_sparse_mlp B={b} x={str(xdt)[6:]} "
                  f"count={count}/{cap}: max_abs_err {err:.3e} kernel "
                  f"{t_mlp:.4f} ms plain {t_mlp_plain:.4f} ms bound "
                  f"{m_bound[0]:.4f} ms ({m_bound[1]}; share "
                  f"{m_bound[0] / t_mlp:.3f}) gathered-rows-3-matmul "
                  f"{t_lib:.4f} ms dense-3-matmul {t_dense:.4f} ms",
                  flush=True)
            if b == MAIN_BATCH and xdt == torch.bfloat16:
                results["predict_group_margins"] = dict(
                    max_abs_err=0.0, ms=t_pred, plain_ms=t_pred_plain,
                    bound_ms=p_bound[0], bound_by=p_bound[1],
                    library_ms=None)
                results["fused_sparse_mlp"] = dict(
                    max_abs_err=err, ms=t_mlp, plain_ms=t_mlp_plain,
                    bound_ms=m_bound[0], bound_by=m_bound[1],
                    library_ms=t_lib)
    results.pop("sel")
    del wg, wu, wd, flush_buf
    torch.cuda.empty_cache()
    phase_kernel_edges()


def phase_kernel_edges() -> None:
    """The decode kernels' other paths at small shapes, against the plain
    versions: d not a multiple of 32 (padded signs) or of 128 (a partial
    column tile), G in {1, 8, 16}, ungated, fatrelu, a zero count; the
    float32 decode kernel's rows longer than one gate/up stage (d in
    {4100, 5120, 8192}, G up to 32, B from 1 to 16, each run twice); then
    the int8 decode kernel's: d=100, partial column tiles, d above one
    round of 4096 columns, G in {1, 8, 16}, qg in {1, 2, 4, 6, 32, 40, 48,
    64, 128}, ungated, fatrelu, a zero count, B from 1 to 16, each run
    twice."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 0
    for d, k, g, b, gated, act, thr in [
            (100, 512, 8, 3, True, "relu", 0.0),
            (128, 512, 1, 1, False, "relu", 0.0),
            (196, 768, 16, 16, True, "fatrelu", 0.05),
            (256, 256, 8, 7, False, "fatrelu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        wu = w["wu"] if gated else None
        sign = P.pack_signs(w["wg"])
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((b, d), generator=gen, device=dev).to(xdt)
            alpha = torch.linspace(0.9, 1.1, b, device=dev)
            gm, cnt = ops.predict_group_margins(sign, x, d, alpha,
                                                group_size=g)
            gm_r, cnt_r = ref.predict_group_margins_ref(sign, x, d, alpha, g)
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                fail(f"predict_group_margins d={d} k={k} G={g} B={b} "
                     f"{xdt}: differs from its plain version")
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                y, tel = ops.fused_sparse_mlp(
                    x, w["wg"], wu, w["wd"], sel.indices, count, gm,
                    group_size=g, activation=act, fatrelu_threshold=thr,
                    collect_stats=True)
                y_r = ref.fused_sparse_mlp_ref(
                    x, w["wg"], wu, w["wd"], sel.indices, count,
                    group_size=g, activation=act, fatrelu_threshold=thr)
                tel_r = ref.fused_mlp_telemetry_ref(
                    x, w["wg"], sel.indices, count, gm, group_size=g,
                    activation=act, fatrelu_threshold=thr)
                scale = float(y_r.abs().max()) or 1.0
                err = float((y - y_r).abs().max())
                rtol = 2e-3 if xdt == torch.bfloat16 else 1e-4
                if err > rtol * scale or not torch.equal(tel, tel_r):
                    fail(f"fused_sparse_mlp d={d} k={k} G={g} B={b} {xdt} "
                         f"gated={gated} {act} count={int(count)}: err "
                         f"{err:.3e}, telemetry {tel.tolist()} vs "
                         f"{tel_r.tolist()}")
                n += 1
    print(f"[kernels] {n} small-shape cases (padded d, partial column tile, "
          "G in {1, 8, 16}, ungated, fatrelu, zero count) agree with the "
          "plain versions", flush=True)
    n = 0
    # the float32 decode kernel at rows longer than one gate/up stage:
    # (d, k, G, B, gated, activation, threshold); d=4100 (two rounds of
    # 4096 at B <= 4, five of 1024 at B=16, a partial 512-column tile),
    # 5120 (the 13B model's width: two rounds at B <= 4, three of 2048 at
    # B <= 8), 8192; G=32 (down's groups in two stages of 16 rows)
    for d, k, g, b, gated, act, thr in [
            (4100, 512, 8, 4, True, "relu", 0.0),
            (4100, 256, 16, 16, True, "fatrelu", 0.05),
            (5120, 512, 8, 1, False, "relu", 0.0),
            (5120, 384, 1, 8, True, "relu", 0.0),
            (5120, 768, 32, 13, True, "relu", 0.0),
            (8192, 512, 8, 16, True, "relu", 0.0),
            (8192, 256, 8, 5, False, "fatrelu", 0.0),
            (8192, 512, 16, 2, True, "relu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        wu = w["wu"] if gated else None
        sign = P.pack_signs(w["wg"])
        kw = dict(group_size=g, activation=act, fatrelu_threshold=thr)
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((b, d), generator=gen, device=dev).to(xdt)
            alpha = torch.linspace(0.9, 1.1, b, device=dev)
            gm, _ = ops.predict_group_margins(sign, x, d, alpha,
                                              group_size=g)
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                y, tel = ops.fused_sparse_mlp(x, w["wg"], wu, w["wd"],
                                              sel.indices, count, gm, **kw,
                                              collect_stats=True)
                y0 = _same_twice(
                    f"d={d} G={g} B={b} {xdt} without telemetry",
                    lambda: ops.fused_sparse_mlp(
                        x, w["wg"], wu, w["wd"], sel.indices, count, **kw),
                    name="fused_sparse_mlp")
                y_r = ref.fused_sparse_mlp_ref(
                    x, w["wg"], wu, w["wd"], sel.indices, count, **kw)
                tel_r = ref.fused_mlp_telemetry_ref(
                    x, w["wg"], sel.indices, count, gm, **kw)
                scale = float(y_r.abs().max()) or 1.0
                err = float((y - y_r).abs().max())
                rtol = 2e-3 if xdt == torch.bfloat16 else 1e-4
                if err > rtol * scale or not torch.equal(y, y0) \
                        or not torch.equal(tel, tel_r):
                    fail(f"fused_sparse_mlp d={d} k={k} G={g} B={b} {xdt} "
                         f"gated={gated} {act} count={int(count)}: err "
                         f"{err:.3e}, y differs with/without telemetry, or "
                         f"telemetry {tel.tolist()} vs {tel_r.tolist()}")
                n += 1
    print(f"[kernels] {n} cases of the float32 decode kernel at d in {{4100, "
          "5120, 8192} (rows over several gate/up rounds, partial tiles), "
          "G in {1, 8, 16, 32}, B from 1 to 16, ungated, fatrelu, zero "
          "count agree with the plain version, bitwise equal twice and with "
          "and without telemetry", flush=True)
    n = 0
    # the int8 decode kernel: (d, k, G, qg, B, gated, activation,
    # threshold): d=100 (rows not 16-byte aligned; qg 2 and 4: one column a
    # thread), d=640 and 192 (a partial 512-column tile), qg in {1, 2, 4, 6,
    # 32, 40, 48, 64, 128}, B from 1 to 16 (1 to 4 passes of 4 tokens);
    # d above 4096 (two or three rounds of 4096 columns: the round's scales,
    # x again each round, the sums carried from round to round, slabs of 40
    # and 48 columns cut by a round's end, one-column items of qg=1)
    for d, k, g, qg, b, gated, act, thr in [
            (100, 500, 1, 4, 3, True, "relu", 0.0),
            (100, 500, 1, 2, 1, True, "fatrelu", 0.05),
            (128, 512, 8, 32, 16, True, "relu", 0.0),
            (192, 768, 16, 64, 16, False, "fatrelu", 0.05),
            (256, 256, 8, 64, 7, False, "fatrelu", 0.0),
            (640, 512, 8, 128, 5, True, "relu", 0.0),
            (96, 384, 16, 32, 12, True, "relu", 0.0),
            (192, 576, 1, 6, 2, True, "relu", 0.0),
            (8192, 512, 8, 128, 4, True, "relu", 0.0),
            (8192, 512, 8, 64, 16, False, "relu", 0.0),
            (4224, 768, 16, 48, 5, True, "fatrelu", 0.05),
            (4120, 320, 8, 40, 2, True, "relu", 0.0),
            (12288, 256, 1, 1, 3, True, "relu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        qn = Q.quantize_mlp_node({"wg_t": w["wg"],
                                  "wu_t": w["wu"] if gated else None,
                                  "wd_t": w["wd"]}, qg, g)
        qargs = [qn.get(m) for m in QNAMES]
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((b, d), generator=gen, device=dev).to(xdt)
            alpha = torch.linspace(0.9, 1.1, b, device=dev)
            gm, _ = ops.predict_group_margins(qn["sign_wg"], x, d, alpha,
                                              group_size=g)
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            kw = dict(group_size=g, activation=act, fatrelu_threshold=thr)
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                y, tel = ops.fused_sparse_mlp_q(x, *qargs, sel.indices,
                                                count, gm, **kw,
                                                collect_stats=True)
                y0 = _same_twice(
                    f"d={d} G={g} qg={qg} B={b} {xdt} without telemetry",
                    lambda: ops.fused_sparse_mlp_q(
                        x, *qargs, sel.indices, count, **kw),
                    name="fused_sparse_mlp_q")
                y_r, tel_r = ref.fused_sparse_mlp_q_ref(
                    x, *qargs, sel.indices, count, gm, **kw,
                    collect_stats=True)
                scale = float(y_r.abs().max()) or 1.0
                err = float((y - y_r).abs().max())
                if err > 1e-4 * scale or not torch.equal(y, y0) \
                        or not torch.equal(tel, tel_r):
                    fail(f"fused_sparse_mlp_q d={d} k={k} G={g} qg={qg} "
                         f"B={b} {xdt} gated={gated} {act} "
                         f"count={int(count)}: err {err:.3e}, y differs "
                         f"with/without telemetry, or telemetry "
                         f"{tel.tolist()} vs {tel_r.tolist()}")
                n += 1
    print(f"[kernels] {n} small-shape cases of the int8 decode kernel (d=100"
          ", partial column tiles, d in 4120..12288, G in {1, 8, 16}, qg in "
          "{1, 2, 4, 6, 32, 40, 48, 64, 128}, ungated, fatrelu, zero count, "
          "B from 1 to 16) agree with the plain version, bitwise equal with "
          "and without telemetry", flush=True)


def _check_telemetry(tel, tel_r, x, wg, sel_idx, count, tag) -> None:
    """Telemetry is equal, except that ``actual`` / ``false_neg`` may be off
    by the number of computed rows whose gate pre-activation lies within
    float rounding of 0 (there the two sums may disagree on its sign).
    ``wg``: the (k, d) float gate weights (the dequantized view for int8)."""
    import torch
    if torch.equal(tel, tel_r):
        return
    k, d = wg.shape
    rows = wg.reshape(k // G, G, d)[sel_idx[:count].long()].reshape(-1, d)
    g = x.float() @ rows.T
    scale = (x.float().abs() @ rows.abs().T)
    near = ((g.abs() <= 1e-5 * scale).sum(-1)).to(torch.int32)   # (B,)
    diff = (tel - tel_r).abs()
    print(f"[kernels] telemetry {tag}: differs by {diff.tolist()} where "
          f"{near.tolist()} gate values lie within rounding of 0",
          flush=True)
    # each differing token's gate value nearest 0, against its sum of
    # |x w| (float32 rounding of that sum is ~6e-8 of it)
    for b in (diff.sum(-1) > 0).nonzero().flatten().tolist():
        i = int((g[b].abs() / scale[b]).argmin())
        print(f"[kernels] telemetry {tag}: token {b}'s gate value nearest 0"
              f" is {float(g[b, i]):.3e} (reference sum) against sum |x w| "
              f"{float(scale[b, i]):.3e}: {float(g[b, i].abs() / scale[b, i]):.2e}"
              " of it", flush=True)
    if not (torch.equal(tel[:, 2], tel_r[:, 2])
            and bool((diff[:, :2] <= near[:, None]).all())):
        fail(f"fused_sparse_mlp telemetry {tag}: {tel.tolist()} vs "
             f"{tel_r.tolist()}")


def _chunk_alphas(s: int, device):
    """Per-row alphas of a prefill chunk: the schedule's two values, and
    dead pad rows at the end (a padded last chunk)."""
    import torch
    from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
    a = torch.full((s,), 1.0, device=device)
    a[1::3] = 1.03
    a[s - max(1, s // 8):] = DEAD_SLOT_ALPHA
    return a


QNAMES = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def phase_chunk_kernels(results: dict) -> None:
    """The chunk predictor (bitwise, and per row equal to the decode one),
    the chunk MLP and the two int8 MLP kernels against their plain
    versions at full width; timings at the main path's shapes."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn[n] for n in QNAMES]
    wg_deq = Q.dense_view(qn)["wg_t"]
    sign_wg = qn["sign_wg"]
    w = sign_wg.shape[1]
    cap = SparseInferConfig().capacity(K)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def check_y(name, tag, y, y0, y_r, rtol):
        scale = float(y_r.abs().max()) or 1.0
        err = float((y - y_r).abs().max())
        if err > rtol * scale or not torch.equal(y, y0):
            fail(f"{name} {tag}: max abs err {err:.3e} > {rtol} x max|y| "
                 f"{scale:.3e}, or y differs with/without telemetry")
        results.setdefault("err", {})[name] = max(
            err, results.get("err", {}).get(name, 0.0))
        return err

    cases = [(s, True) for s in CHUNK_ROWS] + [(b, False) for b in BATCHES]
    for xdt in (torch.bfloat16, torch.float32):
        for rows, chunk in cases:
            x = torch.randn((rows, D), generator=gen, device=dev).to(xdt)
            alpha = _chunk_alphas(rows, dev) if chunk else \
                torch.linspace(0.9, 1.1, rows, device=dev)
            tag = f"{'S' if chunk else 'B'}={rows} x={str(xdt)[6:]}"
            gm, cnt = KP.predict_chunk_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G)
            if chunk:
                gm_r, cnt_r = ref.predict_chunk_group_margins_ref(
                    sign_wg, x, D, alpha, G)
                # the decode kernel's outputs on each row alone
                one = [KP.predict_group_margins(
                    sign_wg, x[i:i + 1], alpha[i:i + 1], d_valid=D,
                    group_size=G) for i in range(rows)]
                gm_1 = torch.cat([o[0] for o in one])
                cnt_1 = torch.cat([o[1] for o in one])
                torch.cuda.synchronize()
                if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)
                        and torch.equal(gm, gm_1)
                        and torch.equal(cnt, cnt_1)):
                    fail(f"predict_chunk_group_margins {tag}: differs from "
                         "its plain version or from the decode kernel")
            sel, _ = S.capacity_select_with_stats(S.union_margin(gm), cap)
            full = int(sel.count)
            for count in sorted({full, full // 3}):
                cnt_t = torch.tensor(count, dtype=torch.int32, device=dev)
                ctag = f"{tag} count={count}"
                if chunk:
                    y, tel = KF.fused_sparse_mlp_chunk(
                        x, wg, wu, wd, sel.indices, cnt_t, gm, group_size=G,
                        collect_stats=True)
                    y0 = _same_twice(
                        f"{ctag} without telemetry",
                        lambda: KF.fused_sparse_mlp_chunk(
                            x, wg, wu, wd, sel.indices, cnt_t,
                            group_size=G), name="fused_sparse_mlp_chunk")
                    y_r, tel_r = ref.fused_sparse_mlp_chunk_ref(
                        x, wg, wu, wd, sel.indices, cnt_t, gm, group_size=G,
                        collect_stats=True)
                    torch.cuda.synchronize()
                    # as phase 2's fused_sparse_mlp: h rounded to bf16
                    check_y("fused_sparse_mlp_chunk", ctag, y, y0, y_r,
                            2e-3 if xdt == torch.bfloat16 else 1e-4)
                    _check_telemetry(tel, tel_r, x, wg, sel.indices, count,
                                     ctag)
                qname = "fused_sparse_mlp_chunk_q" if chunk \
                    else "fused_sparse_mlp_q"
                y, tel = getattr(KF, qname)(x, *qargs, sel.indices, cnt_t,
                                            gm, group_size=G,
                                            collect_stats=True)
                if chunk:
                    y0 = _same_twice(
                        f"{ctag} without telemetry",
                        lambda: KF.fused_sparse_mlp_chunk_q(
                            x, *qargs, sel.indices, cnt_t, group_size=G),
                        name=qname)
                else:
                    y0 = _same_twice(
                        f"{ctag} without telemetry",
                        lambda: KF.fused_sparse_mlp_q(
                            x, *qargs, sel.indices, cnt_t, group_size=G),
                        name=qname)
                y_r, tel_r = ref.fused_sparse_mlp_q_ref(
                    x, *qargs, sel.indices, cnt_t, gm, group_size=G,
                    collect_stats=True)
                torch.cuda.synchronize()
                # tolerance: float32 sums of the same products in another
                # order (both kernels scale each quant slab's partial and
                # each group's down partial, as the reference does, but sum
                # within a slab, a group and across splits or slices in
                # their own order); h stays float32
                check_y(qname, ctag, y, y0, y_r, 1e-4)
                _check_telemetry(tel, tel_r, x, wg_deq, sel.indices, count,
                                 ctag)
            main = (rows == MAIN_CHUNK and chunk) or \
                (rows == MAIN_BATCH and not chunk)
            if not main or xdt != torch.bfloat16:
                continue
            # ---- timings at the main path's shapes (bf16 activations)
            xbytes = 2
            count = full
            sel_rows = sel.indices[:count].long()
            q_rows = int(torch.unique(sel_rows // (QG // G)).numel())
            io = rows * D * xbytes + cap * 4 + 4 + rows * D * 4
            flops = 6 * rows * count * G * D
            q_bytes = (3 * count * G * D + 2 * count * G * (D // QG) * 4
                       + q_rows * D * 4 + io)
            qname = "fused_sparse_mlp_chunk_q" if chunk \
                else "fused_sparse_mlp_q"
            t_q = cuda_ms(lambda: getattr(KF, qname)(
                x, *qargs, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_q_plain = cuda_ms(lambda: ref.fused_sparse_mlp_q_ref(
                x, *qargs, sel.indices, sel.count, group_size=G), iters=5,
                flush=flush)
            qb = bound_ms(q_bytes, flops)
            if chunk:
                # the tensor cores' products (bf16 gate/up, two TF32
                # passes for down, with bf16 x), beside the CUDA-core bound
                # and the float32 chunk kernel
                q_bytes, _, tf32, bf16 = chunk_q_work(rows, count, cap,
                                                      xbytes, sel_rows)
                cc = qb
                qb = tc_bound_ms(q_bytes, tf32, bf16)
                t_f = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                    x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                    flush=flush)
                print(f"[kernels] {qname} {tag} count={count}/{cap}: "
                      f"max_abs_err {results['err'][qname]:.3e} kernel "
                      f"{t_q:.4f} ms plain {t_q_plain:.4f} ms bound "
                      f"{qb[0]:.4f} ms ({qb[1]}, bf16 gate/up, TF32 x2 "
                      f"down; share "
                      f"{qb[0] / t_q:.3f}) / {cc[0]:.4f} ms ({cc[1]}, CUDA "
                      f"cores); the float32 chunk kernel at this shape "
                      f"{t_f:.4f} ms", flush=True)
            else:
                print(f"[kernels] {qname} {tag} count={count}/{cap}: "
                      f"max_abs_err {results['err'][qname]:.3e} kernel "
                      f"{t_q:.4f} ms plain {t_q_plain:.4f} ms bound "
                      f"{qb[0]:.4f} ms ({qb[1]})", flush=True)
            results[qname] = dict(
                max_abs_err=results["err"][qname], ms=t_q,
                plain_ms=t_q_plain, bound_ms=qb[0], bound_by=qb[1],
                library_ms=None)
            if not chunk:
                continue
            t_pred = cuda_ms(lambda: KP.predict_chunk_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_pred_plain = cuda_ms(
                lambda: ref.predict_chunk_group_margins_ref(
                    sign_wg, x, D, alpha, G), iters=5, flush=flush)
            pb = predict_bounds(rows, xbytes)
            t_mlp = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_mlp_plain = cuda_ms(lambda: ref.fused_sparse_mlp_chunk_ref(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                iters=5, flush=flush)
            xf = x.float()
            t_dense = cuda_ms(lambda: (torch.relu(xf @ wg.T) * (xf @ wu.T))
                              @ wd, flush=flush)
            gathered = _gathered_mlp(wg, wu, wd, sel_rows)
            t_lib = cuda_ms(lambda: gathered(xf), flush=flush)
            del gathered
            mb_bytes, _ = chunk_mlp_work(rows, count, cap, xbytes)
            mb = tc_bound_ms(mb_bytes, 2 * flops)
            mb_cc = bound_ms(mb_bytes, flops)
            print(f"[kernels] predict_chunk_group_margins {tag}: "
                  f"max_abs_err 0 (bitwise, and per row equal to "
                  f"predict_group_margins) kernel {t_pred:.4f} ms plain "
                  f"{t_pred_plain:.4f} ms bound {pb[0]:.4f} ms ({pb[1]}, b1 "
                  f"tensor cores; share {pb[0] / t_pred:.3f}) / "
                  f"{pb[2]:.4f} ms ({pb[3]}, CUDA-core popcounts; share "
                  f"{pb[2] / t_pred:.3f})", flush=True)
            print(f"[kernels] fused_sparse_mlp_chunk {tag} count={count}/"
                  f"{cap}: max_abs_err "
                  f"{results['err']['fused_sparse_mlp_chunk']:.3e} kernel "
                  f"{t_mlp:.4f} ms plain {t_mlp_plain:.4f} ms bound "
                  f"{mb[0]:.4f} ms ({mb[1]}, TF32 x2 passes; share "
                  f"{mb[0] / t_mlp:.3f}) / {mb_cc[0]:.4f} ms ({mb_cc[1]}, "
                  f"CUDA cores) gathered-rows-3-matmul {t_lib:.4f} ms "
                  f"dense-3-matmul {t_dense:.4f} ms", flush=True)
            results["predict_chunk_group_margins"] = dict(
                max_abs_err=0.0, ms=t_pred, plain_ms=t_pred_plain,
                bound_ms=pb[0], bound_by=pb[1], library_ms=None)
            results["fused_sparse_mlp_chunk"] = dict(
                max_abs_err=results["err"]["fused_sparse_mlp_chunk"],
                ms=t_mlp, plain_ms=t_mlp_plain, bound_ms=mb[0],
                bound_by=mb[1], library_ms=t_lib)
    # the errors over every case, not only those before the timed one
    for name in ("fused_sparse_mlp_chunk", "fused_sparse_mlp_q",
                 "fused_sparse_mlp_chunk_q"):
        results[name]["max_abs_err"] = results["err"][name]
    print("[kernels] chunk and int8 kernels agree with their plain versions"
          f" at S in {CHUNK_ROWS}, B in {BATCHES}, bf16 and float32 x, full"
          " and cut-short counts; both chunk kernels bitwise equal in two "
          "runs", flush=True)
    del wg, wu, wd, qn, qargs, wg_deq, flush_buf
    torch.cuda.empty_cache()
    phase_chunk_edges()
    phase_big_decode_batch()


def phase_chunk_edges() -> None:
    """The chunk and int8 kernels' other paths at small shapes: rows not a
    multiple of the 16-row block, token tiles of 8, 16, 32 and 64 rows,
    padded d, a partial column tile, G in {1, 8, 16}, quant groups
    narrower than 4 columns, ungated, fatrelu, a zero count."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 0
    for d, k, g, qg, s, gated, act, thr in [
            (100, 500, 1, 4, 3, True, "relu", 0.0),
            (128, 512, 8, 32, 37, True, "relu", 0.0),
            (192, 768, 16, 64, 20, False, "fatrelu", 0.05),
            (64, 256, 1, 2, 5, True, "fatrelu", 0.0),
            (256, 512, 8, 64, 12, True, "relu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        wu = w["wu"] if gated else None
        qn = Q.quantize_mlp_node({"wg_t": w["wg"], "wu_t": wu,
                                  "wd_t": w["wd"]}, qg, g)
        qargs = [qn.get(m) for m in QNAMES]
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((s, d), generator=gen, device=dev).to(xdt)
            alpha = _chunk_alphas(s, dev)
            gm, cnt = ops.predict_chunk_group_margins(qn["sign_wg"], x, d,
                                                      alpha, group_size=g)
            gm_r, cnt_r = ref.predict_group_margins_ref(qn["sign_wg"], x, d,
                                                        alpha, g)
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                fail(f"predict_chunk_group_margins d={d} k={k} G={g} S={s} "
                     f"{xdt}: differs from its plain version")
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            kw = dict(group_size=g, activation=act, fatrelu_threshold=thr,
                      collect_stats=True)
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                for name, out, want in [
                        ("fused_sparse_mlp_chunk",
                         ops.fused_sparse_mlp_chunk(
                             x, w["wg"], wu, w["wd"], sel.indices, count,
                             gm, **kw),
                         ref.fused_sparse_mlp_chunk_ref(
                             x, w["wg"], wu, w["wd"], sel.indices, count,
                             gm, **kw)),
                        ("fused_sparse_mlp_chunk_q",
                         ops.fused_sparse_mlp_chunk_q(
                             x, *qargs, sel.indices, count, gm, **kw),
                         ref.fused_sparse_mlp_q_ref(
                             x, *qargs, sel.indices, count, gm, **kw))]:
                    (y, tel), (y_r, tel_r) = out, want
                    scale = float(y_r.abs().max()) or 1.0
                    err = float((y - y_r).abs().max())
                    rtol = 2e-3 if (xdt == torch.bfloat16
                                    and not name.endswith("_q")) else 1e-4
                    if err > rtol * scale or not torch.equal(tel, tel_r):
                        fail(f"{name} d={d} k={k} G={g} qg={qg} S={s} {xdt} "
                             f"gated={gated} {act} count={int(count)}: err "
                             f"{err:.3e}, telemetry {tel.tolist()} vs "
                             f"{tel_r.tolist()}")
                    n += 1
    print(f"[kernels] {n} small-shape cases of the chunk and int8 kernels "
          "(rows not a multiple of 16, padded d, partial column tile, G in "
          "{1, 8, 16}, qg in {2, 4, 32, 64}, ungated, fatrelu, zero count) "
          "agree with the plain versions", flush=True)
    phase_predict_edges()


def phase_big_decode_batch() -> None:
    """A decode batch of 24 with sparse_max_batch=32 through the ops layer:
    the decode kernels take 16 rows, so the predictor and the MLP launch
    their chunk twins; the result must match the CPU's plain versions."""
    import torch
    from repro_torch.core import sparse_mlp as SM
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    mlp = SM.init_gated_mlp(gen, D, K, device=dev)
    b = 24
    x = torch.randn((b, D), generator=gen, device=dev)
    alpha = torch.linspace(0.95, 1.05, b, device=dev)
    for weights in ("", "int8"):
        cfg = SM.SparseInferConfig(enabled=True, strategy="pallas",
                                   sparse_max_batch=32, weight_dtype=weights,
                                   quant_group_size=QG)
        params = SM.prepare_sparse_params(mlp, cfg)
        ops.reset_launch_counts()
        y, st = SM.pallas_mlp(params, x, cfg, alpha, return_stats=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        fused = "fused_sparse_mlp_chunk_q" if weights \
            else "fused_sparse_mlp_chunk"
        want = {n: int(n in ("predict_chunk_group_margins", fused))
                for n in counts}
        if counts != want:
            fail(f"decode batch of {b}: launches {counts}, want {want}")
        cpu = {kk: v.cpu() for kk, v in params.items()}
        y_c, st_c = SM.pallas_mlp(cpu, x.cpu(), cfg, alpha.cpu(),
                                  return_stats=True)
        err = float((y.cpu() - y_c).abs().max())
        scale = float(y_c.abs().max())
        same = [kk for kk in ("predicted_density", "realized_density",
                              "union_demand_frac")
                if not torch.equal(st[kk].cpu(), st_c[kk])]
        if err > 1e-4 * scale or same:
            fail(f"decode batch of {b} ({weights or 'float32'} weights): "
                 f"err {err:.3e} of max|y| {scale:.3e}; stats differ {same}")
        print(f"[kernels] decode batch of {b} (sparse_max_batch=32, "
              f"{weights or 'float32'} weights): launched {counts}; y within "
              f"{err:.3e} of the CPU, selection stats equal", flush=True)
    del mlp, params
    torch.cuda.empty_cache()


def phase_prefill() -> None:
    """Two full-width float32 layers, sparse prefill of a 160-token prompt
    in chunks of 64: card (CUDA kernels) vs CPU (plain versions), with
    float32 and with int8 MLP weights (``_prefill_chunks``)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    fp = lm.init_lm(base.replace(n_layers=2), 0, "cuda")
    for weights in ("", "int8"):
        cfg = base.replace(
            n_layers=2, dtype="float32", kv_cache_dtype="float32",
            sparse=dataclasses.replace(
                base.sparse, strategy="pallas", enabled=True,
                sparse_prefill=True, weight_dtype=weights,
                quant_group_size=QG))
        params = {"cuda": lm.prepare_sparse(fp, cfg.sparse)}
        params["cpu"] = _to(params["cuda"], "cpu")
        fused = "fused_sparse_mlp_chunk_q" if weights \
            else "fused_sparse_mlp_chunk"
        _prefill_chunks(f"[prefill] {weights or 'float32'} weights", params,
                        cfg, 160, 5, 256,
                        ("predict_chunk_group_margins", fused))
        del params
    del fp
    torch.cuda.empty_cache()


def phase_serve_chunked(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with chunked
    sparse prefill, with float32 and with int8 MLP weights."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    tiers = ("latency", "balanced", "quality")
    for weights in ("", "int8"):
        cfg = base.replace(sparse=dataclasses.replace(
            base.sparse, strategy="pallas", enabled=True,
            sparse_prefill=True, weight_dtype=weights, quant_group_size=QG,
            prefill_max_tokens=max(base.sparse.prefill_max_tokens,
                                   MAIN_CHUNK)))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, 0, "cuda")
        srv = Server(lm, cfg, ServeConfig(
            batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
            prefill_chunk=MAIN_CHUNK), params, device="cuda")
        del params        # int8: the server keeps only the quantized MLPs
        torch.cuda.synchronize()
        kind = weights or "float32"
        print(f"[serve-chunked] {kind} MLP weights, prefill chunks of "
              f"{MAIN_CHUNK}, sparse prefill; init "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.default_rng(6)
        plens = [int(p) for p in rng.integers(96, 193, size=8)]
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=p),
                        max_new=16, sla=tiers[i % 3])
                for i, p in enumerate(plens)]
        ops.reset_launch_counts()
        steps0, chunks0 = srv.decode_steps, srv.prefill_chunks_run
        done = srv.serve(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps = srv.decode_steps - steps0
        chunks = srv.prefill_chunks_run - chunks0
        rep = throughput_report(done)
        rep["prefill_chunks_run"] = chunks
        rep["prefill_chunks_skipped"] = srv.prefill_chunks_skipped
        print(f"[serve-chunked] {kind} throughput_report {json.dumps(rep)}",
              flush=True)
        print(f"[serve-chunked] {kind} peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decode "
              f"steps {steps}; prefill chunks {chunks}; launches {counts}",
              flush=True)
        if len(done) != 8 or any(
                r.outcome != "completed" or len(r.out) != 16
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-chunked ({kind}): not every request completed with "
                 "16 valid tokens")
        fused = "fused_sparse_mlp_q" if weights else "fused_sparse_mlp"
        L = cfg.n_layers
        want = {n: 0 for n in counts}
        want.update({"predict_group_margins": L * steps, fused: L * steps,
                     "predict_chunk_group_margins": L * chunks,
                     fused.replace("mlp", "mlp_chunk"): L * chunks})
        if steps == 0 or chunks != sum(-(-p // MAIN_CHUNK) for p in plens) \
                or counts != want:
            fail(f"serve-chunked ({kind}): launches {counts}, want {want} "
                 f"(2 per sparse MLP x {L} layers x {steps} decode steps "
                 f"and x {chunks} prefill chunks)")
        results[f"launches_chunked_{kind}"] = counts
        profile_prefill_chunk(srv, cfg, kind)
        if weights:
            profile_decode(srv, cfg, kind)
        del srv
        torch.cuda.empty_cache()


def phase_decode() -> None:
    """Two full-width float32 layers, 8 teacher-forced decode steps: card
    (CUDA kernels) vs CPU (plain versions) on a float32 KV cache, then on
    an int8 one (``_hold``)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(n_layers=2, dtype="float32",
                       sparse=dataclasses.replace(base.sparse,
                                                  strategy="pallas",
                                                  enabled=True))
    L = cfg.n_layers
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    for kv in ("float32", "int8"):
        run_cfg = cfg.replace(kv_cache_dtype=kv)
        _hold(f"[decode] {kv} KV cache",
              lambda dev: _teacher_forced(params[dev], run_cfg, dev),
              LOGIT_TOL[kv], dict(predict_group_margins=L * DEC_STEPS,
                                  fused_sparse_mlp=L * DEC_STEPS))
    del params
    torch.cuda.empty_cache()


DEC_BATCH, DEC_PLEN, DEC_STEPS, DEC_MAX_LEN = 4, 16, 8, 32


@contextlib.contextmanager
def _mlp_tap(fn, name: str = "mlp_apply"):
    """Inside the block every MLP call of the model modules (``models.lm``,
    ``models.encdec``, ``models.vision_lm``; ``name`` "moe_apply": every
    MoE layer's call) goes through ``fn(orig, params, x, cfg, **kw)``."""
    from repro_torch.models import encdec, lm, vision_lm
    mods = [m for m in (lm, encdec, vision_lm) if hasattr(m, name)]
    origs = [getattr(m, name) for m in mods]
    for m, orig in zip(mods, origs):
        setattr(m, name, lambda params, x, cfg, _orig=orig, **kw: fn(
            _orig, params, x, cfg, **kw))
    try:
        yield
    finally:
        for m, orig in zip(mods, origs):
            setattr(m, name, orig)


def _kept(params, x, cfg):
    """An MoE call's routing on its own device: router probabilities
    (G, Tg, E), and the kept slots as a (G, Tg, E) mask (the top-k after
    the capacity drop), on the CPU."""
    import torch
    from repro_torch.layers import moe
    probs, w, idx = moe.route(params, x, cfg)
    sl = moe.dispatch_slots(w, idx, cfg)
    g, tg = idx.shape[:2]
    mask = torch.zeros((g, tg, cfg.n_experts), dtype=torch.bool,
                       device=x.device)
    gi = torch.arange(g, device=x.device)[:, None].expand_as(sl.token)
    mask[gi[sl.keep], sl.token[sl.keep], sl.expert[sl.keep]] = True
    return probs.cpu(), w.cpu(), idx.cpu(), sl, mask.cpu()


def _route_flips(label, i, cfg, card, cpu) -> tuple:
    """Where the card's and the CPU's kept slots differ: each differing
    token must sit at a near tie, by float32 rounding, of the contest it
    lost or won: its k-th and (k+1)-th router probabilities (top-k), or
    the cap-th and (cap+1)-th weights of the expert it entered (capacity).
    Returns (the groups touched, the number of tokens flipped)."""
    import torch
    probs, w, idx, sl, mask = cpu
    diff = (mask != card[4]).any(-1)                       # (G, Tg)
    k = cfg.top_k
    top = torch.sort(probs, dim=-1, descending=True).values
    gap_k = top[..., k - 1] - top[..., k] if k < cfg.n_experts else \
        torch.full(top.shape[:-1], float("inf"))
    groups = set()
    for g, t in diff.nonzero().tolist():
        rel_k = float(gap_k[g, t]) / float(top[g, t, k - 1])
        near = rel_k <= 1e-5
        gaps = [f"top-k gap {float(gap_k[g, t]):.3e} ({rel_k:.1e} rel)"]
        for e in (mask[g, t] ^ card[4][g, t]).nonzero()[:, 0].tolist():
            ws = torch.sort(sl.weight[g][sl.expert[g] == e].cpu(),
                            descending=True).values
            if ws.numel() > sl.cap:
                gap_c = float(ws[sl.cap - 1] - ws[sl.cap])
                rel_c = gap_c / float(ws[sl.cap - 1])
                gaps.append(f"expert {e} capacity gap {gap_c:.3e} "
                            f"({rel_c:.1e} rel)")
                near |= rel_c <= 1e-5
        print(f"{label}: MoE call {i} group {g} token {t} routed "
              f"differently on the card and the CPU: {'; '.join(gaps)}",
              flush=True)
        if not near:
            fail(f"{label}: MoE call {i} group {g} token {t}: the routing "
                 "differs with no gap within float32 rounding of 0")
        groups.add(g)
    return groups, int(diff.sum())


def _near_zero(x, w):
    """Per row of ``x`` (..., d): how many rows of ``w`` (n, d) give a
    product within float rounding of 0 (|x w| <= 1e-5 sum |x| |w|, as
    ``_check_telemetry`` counts them), where two sums in another order may
    disagree on its sign."""
    xf = x.float().reshape(-1, x.shape[-1])
    wf = w.float()
    return ((xf @ wf.T).abs() <= 1e-5 * (xf.abs() @ wf.abs().T)).sum(-1)


def _hold(label: str, run, tol: float, want: dict | None = None,
          ref=None) -> None:
    """Two runs of the same steps, each returning its logits on the CPU:
    ``run("cuda")`` with the card's launches counted (exactly ``want``,
    {kernel: n}, when given), then ``ref()`` (by default ``run("cpu")``,
    the plain versions) with every MLP call fed the input that the card's
    run gave the same call.  So both sides select the same row groups,
    also where the capacity clamp binds: with random weights ~99.8% of
    groups predict active, the clamp cuts among near-equal margins, and
    one input element within rounding of 0 taking the other sign bit would
    move every margin and so the whole selection.  Each MLP call: its
    output within phase 2's tolerance of the card's (1e-4 x max|y|, 2e-3
    for bf16 x); its stats in rows (stat x k) equal, except the active and
    false-negative counts, each of which may move by the gate values of
    its row within rounding of 0.  Then the logits within ``tol``."""
    import torch
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    card, calls, moe_calls = _record_calls(lambda: run("cuda"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if want is not None and counts != _want_launches(counts, **want):
        fail(f"{label}: launches {counts}, want {want}")
    if not bool(torch.isfinite(card).all()):
        fail(f"{label}: non-finite logits on the card")
    _replay_calls(label, card, calls, moe_calls,
                  ref if ref is not None else (lambda: run("cpu")), tol, t0)


def _record_calls(run) -> tuple:
    """``run()``'s value with every MLP call's (input, output, stats) and
    every MoE call's (input, output, routing) recorded, on the CPU."""
    calls, moe_calls = [], []

    def record_moe(moe_apply, params, x, cfg):
        out = moe_apply(params, x, cfg)
        moe_calls.append((x.cpu(), out[0].cpu(), _kept(params, x, cfg)))
        return out

    def record(mlp, params, x, cfg, **kw):
        out = mlp(params, x, cfg, **kw)
        y, st = out if kw.get("return_stats") else (out, None)
        calls.append((x.cpu(), y.cpu(), st and {n: v.cpu()
                                                for n, v in st.items()}))
        return out

    with _mlp_tap(record), _mlp_tap(record_moe, "moe_apply"):
        out = run()
    return out, calls, moe_calls


def _replay_calls(label: str, card, calls: list, moe_calls: list, ref,
                  tol: float, t0: float) -> None:
    """``ref()`` with every MLP and MoE call fed the input of the same call
    in ``calls``/``moe_calls`` (``_record_calls``), each output and its
    stats held as ``_hold`` says, then its logits within ``tol`` of
    ``card``."""
    import torch
    from repro_torch.core import quantize as Q

    seen = {"n": 0, "y": 0.0, "x": 0.0, "moved": 0}
    moe_seen = {"n": 0, "y": 0.0, "flips": 0}

    def replay_moe(moe_apply, params, x, cfg):
        """The CPU's MoE call on the card's input: routing equal up to
        near ties (``_route_flips``), the output within phase 2's
        tolerance on every group routed alike; a group routed differently
        takes the card's output, so the flip does not reach the logits."""
        i = moe_seen["n"]
        if i == len(moe_calls):
            fail(f"{label}: more MoE calls than on the card")
        moe_seen["n"] += 1
        x_c, y_c, card = moe_calls[i]
        y, aux = moe_apply(params, x_c.to(x.device), cfg)
        groups, flips = _route_flips(label, i, cfg, card,
                                     _kept(params, x_c.to(x.device), cfg))
        moe_seen["flips"] += flips
        rtol = 2e-3 if x.dtype == torch.bfloat16 else 1e-4
        yg, ycg = (v.reshape(card[4].shape[:2] + (-1,))
                   for v in (y.cpu(), y_c))
        same = [g for g in range(yg.shape[0]) if g not in groups]
        rel = float((yg[same] - ycg[same]).abs().max()) / (
            float(ycg[same].abs().max()) or 1.0) if same else 0.0
        moe_seen["y"] = max(moe_seen["y"], rel)
        if rel > rtol:
            fail(f"{label}: MoE call {i}'s output {rel:.3e} x max|y| from "
                 f"the card's (tolerance {rtol})")
        if groups:
            y = y_c.to(y.device)
        return y, aux

    def replay(mlp, params, x, cfg, **kw):
        i = seen["n"]
        if i == len(calls):
            fail(f"{label}: more MLP calls than on the card")
        seen["n"] += 1
        x_c, y_c, st_c = calls[i]
        seen["x"] = max(seen["x"], float((x.cpu() - x_c).abs().max()))
        out = mlp(params, x_c.to(x.device), cfg, **kw)
        y, st = out if st_c is not None else (out, None)
        rtol = 2e-3 if x.dtype == torch.bfloat16 else 1e-4
        rel = float((y.cpu() - y_c).abs().max()) / (
            float(y_c.abs().max()) or 1.0)
        seen["y"] = max(seen["y"], rel)
        if rel > rtol:
            fail(f"{label}: MLP call {i}'s output {rel:.3e} x max|y| from "
                 f"the card's (tolerance {rtol})")
        if st_c is None:
            return out
        k = Q.mlp_hidden_rows(params)
        for n in st_c:
            moved = (torch.round(st[n].cpu() * k)
                     - torch.round(st_c[n] * k)).abs().reshape(-1)
            if not bool(moved.any()):
                continue
            near = _near_zero(x_c, Q.dense_view(params)["wg_t"].cpu())
            if n in SELECTION_STATS or bool((moved > near).any()):
                fail(f"{label}: MLP call {i}'s {n} moved by "
                     f"{moved.tolist()} rows, where {near.tolist()} gate "
                     "values lie within rounding of 0")
            seen["moved"] += int(moved.sum())
        return out

    with _mlp_tap(replay), _mlp_tap(replay_moe, "moe_apply"):
        other = ref()
    if seen["n"] != len(calls):
        fail(f"{label}: {seen['n']} MLP calls, {len(calls)} on the card")
    if moe_seen["n"] != len(moe_calls):
        fail(f"{label}: {moe_seen['n']} MoE calls, {len(moe_calls)} on the "
             "card")
    if moe_calls:
        print(f"{label}: {len(moe_calls)} MoE calls on the card's inputs: "
              f"routing equal but for {moe_seen['flips']} tokens at near "
              f"ties, outputs within {moe_seen['y']:.3e} x max|y|",
              flush=True)
    diff = (card - other).abs()
    print(f"{label}: logits max abs diff {float(diff.max()):.3e}, median "
          f"{float(diff.median()):.3e} (tolerance {tol}); {len(calls)} MLP "
          f"calls on the card's inputs (the sides' own inputs up to "
          f"{seen['x']:.3e} apart): outputs within {seen['y']:.3e} x "
          f"max|y|, selections equal, {seen['moved']} active or "
          f"false-negative row counts moved by rounding; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if float(diff.max()) > tol:
        fail(f"{label}: logits differ by {float(diff.max())}")


def _want_launches(counts: dict, **n) -> dict:
    return {k: n.get(k, 0) for k in counts}


def _teacher_forced(params, cfg, dev, extra=None):
    """Prefill a seeded batch of 4 prompts (with ``extra``, the frames or
    images of a cross-attention family), then 8 teacher-forced decode
    steps with per-slot alphas (the schedule plus SLA-like offsets) and
    the MLP stats on -> logits (steps, B, V) on the CPU.  Under a current
    mesh with a 'data' axis the model runs the rank's line's slots
    (``rules.slot_range``) and the logits of every line are gathered."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import model_module
    from repro_torch.sharding import rules as R
    mod = model_module(cfg)
    ex = () if extra is None else (extra.to(dev),)
    rows = list(R.slot_range(DEC_BATCH))
    b, plen, steps = len(rows), DEC_PLEN, DEC_STEPS
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(DEC_BATCH, plen))[rows]
    forced = rng.integers(0, cfg.vocab, size=(steps, DEC_BATCH, 1))[:, rows]
    alphas = (cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] +
              np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]
              )[:, rows]
    with torch.inference_mode():
        lg, caches = mod.prefill(params, cfg,
                                 torch.as_tensor(prompt, device=dev), *ex,
                                 DEC_MAX_LEN)
        out = []
        for t in range(steps):
            lg, caches, _ = mod.decode_step(
                params, cfg, torch.as_tensor(forced[t], device=dev), caches,
                torch.full((b,), plen + t, device=dev), alphas=alphas,
                collect_stats=True)
            out.append(R.gather_slots(lg.float()).cpu())
    return torch.stack(out)


def phase_decode_strategies() -> None:
    """The two layers of phase_decode with strategies masked and gather:
    their margins run the sign_pack and predict_counts kernels on the card
    (one launch each per layer and step) and the plain versions on the
    CPU; then a gather sparse prefill, as the controller serve runs its
    prompts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg0 = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg0, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    L = cfg0.n_layers
    for strategy in ("masked", "gather"):
        cfg = cfg0.replace(sparse=dataclasses.replace(
            base.sparse, strategy=strategy, enabled=True))
        _hold(f"[strategies] {strategy} decode",
              lambda dev: _teacher_forced(params[dev], cfg, dev),
              LOGIT_TOL["float32"], dict(sign_pack=L * DEC_STEPS,
                                         predict_counts=L * DEC_STEPS))
    # a 100-token prompt: a full chunk, then 36 rows and 28 pad rows, each
    # chunk's 64 rows one union selection
    cfg = cfg0.replace(sparse=dataclasses.replace(
        cfg0.sparse, strategy="gather", enabled=True, sparse_prefill=True,
        prefill_max_tokens=max(cfg0.sparse.prefill_max_tokens, MAIN_CHUNK)))
    _prefill_chunks("[strategies] gather sparse prefill", params, cfg, 100,
                    11, DEC_MAX_LEN * 4, ("sign_pack", "predict_counts"))
    del params
    torch.cuda.empty_cache()


def _prefill_chunks(label: str, params, cfg, plen: int, seed: int,
                    max_len: int, kernels: tuple, extra=None) -> None:
    """A seeded ``plen``-token prompt through ``prefill_chunk`` in chunks
    of 64 (the last padded), with ``cfg``'s strategy and sparse prefill,
    card against CPU (``_hold``): the logits of the last chunk, which
    holds the last prompt token; one launch of each of ``kernels`` a layer
    and chunk.  ``extra``: a cross-attention family's frames or images
    (batch 1); an encoder-decoder encodes them once for every chunk."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import model_module
    mod = model_module(cfg)

    chunk, L = MAIN_CHUNK, _mlp_layers(cfg)
    n_chunks = -(-plen // chunk)
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, n_chunks * chunk), np.int64)
    tokens[0, :plen] = rng.integers(0, cfg.vocab, size=plen)
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)

    def run(dev):
        caches = mod.init_caches(cfg, 1, max_len, dev)
        with torch.inference_mode():
            ex = () if extra is None else (extra.to(dev),)
            if ex and hasattr(mod, "encode"):
                ex = (mod.encode(params[dev], cfg, ex[0]),)
            for off in range(0, n_chunks * chunk, chunk):
                lg, caches, _ = mod.prefill_chunk(
                    params[dev], cfg,
                    torch.as_tensor(tokens[:, off:off + chunk], device=dev),
                    caches, off, plen, *ex, alphas=alphas,
                    collect_stats=True)
        return lg.float().cpu()
    _hold(f"{label}, {plen} tokens in {n_chunks} chunks of {chunk}, "
          f"{cfg.kv_cache_dtype} KV cache", run, LOGIT_TOL[cfg.kv_cache_dtype],
          {n: L * n_chunks for n in kernels})


def _mlp_layers(cfg) -> int:
    """The layers that run the sparse MLP: every one of a dense or vlm
    config, an encdec config's decoder layers, a moe config's dense first
    layers."""
    return cfg.first_dense_layers if cfg.family == "moe" else cfg.n_layers


def _to(tree, device):
    import torch
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def phase_serve(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=128,
                                      max_new_tokens=16), params,
                 device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"d_ff={cfg.d_ff}, weights {cfg.param_dtype}, compute {cfg.dtype},"
          f" KV {cfg.kv_cache_dtype}; init {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=int(rng.integers(32, 65))),
                    max_new=16, sla=tiers[i % 3]) for i in range(8)]
    ops.reset_launch_counts()
    steps0 = srv.decode_steps
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    rep = throughput_report(done)
    print(f"[serve] throughput_report {json.dumps(rep)}", flush=True)
    print(f"[serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; decode steps {steps}; launches {counts}", flush=True)
    if len(done) != 8 or any(r.outcome != "completed" or len(r.out) != 16
                             or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                             for r in done):
        fail("serve: not every request completed with 16 valid tokens")
    want = cfg.n_layers * steps
    if steps == 0 or counts != {
            n: want if n in ("predict_group_margins", "fused_sparse_mlp")
            else 0 for n in counts}:
        fail(f"serve: launches {counts}, want {want} of each kernel "
             f"(2 per sparse MLP x {cfg.n_layers} layers x {steps} steps)")
    results["launches"] = counts
    profile_decode(srv, cfg)
    del srv, params
    torch.cuda.empty_cache()


def profile_decode(srv, cfg, kind: str = "") -> None:
    """Where one full-depth decode step's time goes (``kind``: the MLP
    weights, for the label)."""
    import torch
    from repro_torch.models import lm

    b = srv.scfg.batch
    caches = lm.init_caches(cfg, b, srv.scfg.max_len, "cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    label = f", {kind} MLP weights" if kind else ""
    profile_step(f"decode step (B={b}, {cfg.n_layers} layers{label})",
                 lambda: lm.decode_step(srv.params, cfg, tok, caches,
                                        lengths))


def profile_int8_decode() -> None:
    """A full-depth decode step with int8 MLP weights, profiled, on its own
    server (random weights from seed 0): run from a script that puts a
    checkout's ``src`` first on sys.path, it profiles that checkout's
    step."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True, weight_dtype="int8",
        quant_group_size=QG))
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=256),
                 params, device="cuda")
    del params
    profile_decode(srv, cfg, "int8")
    del srv
    torch.cuda.empty_cache()


def profile_prefill_chunk(srv, cfg, kind: str) -> None:
    """Where one full-depth sparse prefill chunk's time goes, for a
    balanced-tier request (with random weights the latency tier's lower
    alpha predicts no group active, and its MLP kernel has no work)."""
    import torch
    from repro_torch.models import lm

    pc = srv.scfg.prefill_chunk
    caches = lm.init_caches(cfg, 1, srv.scfg.max_len, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (1, pc), generator=gen,
                         device="cuda")
    alphas = srv._prefill_alphas(srv._tier_index["balanced"])
    profile_step(f"prefill chunk (S={pc}, {cfg.n_layers} layers, {kind} "
                 "MLP weights)",
                 lambda: lm.prefill_chunk(srv.params, cfg, toks, caches, 0,
                                          pc, alphas=alphas))


def profile_step(label: str, fn, steps: int = 3, grad: bool = False,
                 warm: bool = True) -> None:
    """Host wall time of ``fn`` against device busy time (torch.profiler),
    and the largest kernels by name.  The profiler's count of the port's
    kernels is held against the launch counters: a run in which it missed
    launches reports no device busy time.  ``grad``: ``fn`` needs autograd
    (a training step); else it runs under inference mode.  ``warm``: one
    run before the profiled ones (off for a step of many seconds that
    builds nothing on its first run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    with (torch.enable_grad() if grad else torch.inference_mode()):
        if warm:
            fn()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
    launched = sum(ops.launch_counts().values())
    # device-side rows only: a CPU op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    seen = sum(e.count for e in events
               if e.key.removeprefix("void ").startswith(OWN_KERNELS))
    busy = sum(e.self_device_time_total for e in events) / steps / 1e3
    per_step = sum(e.count for e in events) / steps
    if not events or seen != launched:
        print(f"[profile] {label}: {wall:.3f} ms host wall; device busy not "
              f"measured (the profiler recorded {seen} of {launched} "
              "launches of the port's kernels)", flush=True)
    else:
        print(f"[profile] {label}: {wall:.3f} ms host wall, {busy:.3f} ms "
              f"device busy, idle share {max(0.0, 1 - busy / wall):.3f}, "
              f"{per_step:.0f} device kernels a step", flush=True)
    # the 8 largest rows, then the port's kernels below them
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 8 or e.key.removeprefix("void ").startswith(OWN_KERNELS):
            print(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f}"
                  f" ms/step  x{e.count // steps:<4d} {e.key[:90]}",
                  flush=True)


def _paged_inputs(gen, rng, b, h, kvh, hd, bs, nbps, kv_dtype, q_dtype,
                  lengths=None):
    """q, a random pool, a fragmented table (slots 0 and 1 share their first
    block) and lengths: max_len - 1, 0 and a block boundary first, then
    random ones, unless ``lengths`` is given."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    if b > 1:
        table[1, 0] = table[0, 0]
    s_max = nbps * bs
    if lengths is None:
        lengths = [(s_max - 1, 0, bs)[i] if i < 3
                   else int(rng.integers(1, s_max)) for i in range(b)]
    kp = torch.randn((n, bs, kvh, hd), generator=gen, device=dev)
    vp = torch.randn((n, bs, kvh, hd), generator=gen, device=dev)
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype),
            torch.as_tensor(table.astype(np.int32), device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def _check_attention(tag, out, want, vp) -> float:
    """Tolerance: the output is a weighted mean of v rows.  bf16 pools
    round p to bf16 before the PV product, where a float32 ulp of
    difference can move p by one bf16 ulp: 2^-8 * max|v|.  float32 pools
    differ in summation order only: 1e-4 * max|v|."""
    import torch
    torch.cuda.synchronize()
    vmax = float(vp.float().abs().max())
    tol = (2 ** -8 if vp.dtype == torch.bfloat16 else 1e-4) * vmax
    err = float((out - want).abs().max())
    if not bool(torch.isfinite(out).all()) or err > tol:
        fail(f"paged_attention {tag}: max abs err {err:.3e} > {tol:.3e}")
    return err


def _attention_bound(lengths, b, h, kvh, hd, nbps, elem) -> tuple:
    """Bytes: each live K and V row read once, q read, out (float32)
    written, the table and lengths read; operations: the QK and PV
    multiply-adds of the live rows."""
    live = int((lengths.long() + 1).clamp(max=nbps * PAGE_BLOCK).sum())
    n_bytes = (2 * live * kvh * hd * elem + b * h * hd * elem
               + b * h * hd * 4 + b * nbps * 4 + b * 4)
    return live, bound_ms(n_bytes, 4 * h * live * hd)


def paged_scaling(gen, rng, flush) -> None:
    """paged_attention's time (B=4, H = K = 32, hd 128, bf16) with one
    live row per slot (the fixed cost), at the main path's lengths, at
    those lengths doubled (max_len 512) and at every length 192: a kernel
    bound by latency follows the longest slot, one bound by bytes the live
    rows.  At the main lengths also each cluster size (checked against the
    plain version) and the planned one with the L2 warm."""
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    for label, nbps, lens in (
            ("one live row each", PAGED_NBPS[0], (0,) * MAIN_BATCH),
            ("main", PAGED_NBPS[0], MAIN_LIVE),
            ("main, max_len 512", 2 * PAGED_NBPS[0], MAIN_LIVE),
            ("doubled", 2 * PAGED_NBPS[0], tuple(2 * n for n in MAIN_LIVE)),
            ("all 192", PAGED_NBPS[0], (192,) * MAIN_BATCH)):
        q, kp, vp, table, lengths = _paged_inputs(
            gen, rng, MAIN_BATCH, 32, 32, 128, PAGE_BLOCK, nbps,
            torch.bfloat16, torch.bfloat16, lengths=lens)
        t = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table, lengths),
                    iters=50, flush=flush)
        live, bound = _attention_bound(lengths, MAIN_BATCH, 32, 32, 128,
                                       nbps, 2)
        print(f"[paged] scaling {label}: lengths {list(lens)} ({live} live "
              f"rows, longest {max(lens) + 1}): kernel {t:.4f} ms, bound "
              f"{bound[0]:.4f} ms", flush=True)
        if label == "main":
            # the cluster size against the plan's choice, L2 flushed and warm
            want = ref.paged_attention_ref(q, kp, vp, table, lengths)
            sweep = {}
            for p in (1, 2, 4, 8):
                _check_attention(f"main shape, P={p}", KA.paged_attention(
                    q, kp, vp, table, lengths, cluster=p), want, vp)
                sweep[p] = cuda_ms(lambda p=p: KA.paged_attention(
                    q, kp, vp, table, lengths, cluster=p), iters=50,
                    flush=flush)
            warm = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table,
                                                      lengths), iters=50)
            print("[paged] scaling main by cluster size: " + ", ".join(
                f"P={p} {t:.4f} ms ({KA.launch_plan(q, kp, table, p).fit} "
                "clusters fit)" for p, t in sweep.items())
                + f"; planned P={KA.launch_plan(q, kp, table).cluster} with "
                f"the L2 warm {warm:.4f} ms", flush=True)
        del q, kp, vp


def phase_paged_kernels(results: dict) -> None:
    """paged_attention and paged_kv_write against their plain versions at
    full width and at the edges, then the timings at the main path's
    shape, the attention's scaling with the slot lengths and the
    long-context shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    h = kvh = 32
    hd, bs = 128, PAGE_BLOCK
    worst = 0.0
    for kv_dtype in (torch.bfloat16, torch.float32):
        for b in BATCHES:
            for nbps in PAGED_NBPS:
                q, kp, vp, table, lengths = _paged_inputs(
                    gen, rng, b, h, kvh, hd, bs, nbps, kv_dtype, kv_dtype)
                tag = (f"B={b} max_len={nbps * bs} pool={str(kv_dtype)[6:]}"
                       f" lengths={lengths.tolist()[:4]}")
                err = _check_attention(
                    tag, KA.paged_attention(q, kp, vp, table, lengths),
                    ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
                worst = max(worst, err)
                print(f"[paged] paged_attention {tag}: max_abs_err "
                      f"{err:.3e}", flush=True)
                del q, kp, vp
    n_edge = phase_paged_edges()
    n_write = phase_paged_write()
    # ---- timings at the main path's shape: B=4, bf16, max_len 256
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    b, nbps = MAIN_BATCH, PAGED_NBPS[0]
    q, kp, vp, table, lengths = _paged_inputs(
        gen, rng, b, h, kvh, hd, bs, nbps, torch.bfloat16, torch.bfloat16,
        lengths=MAIN_LIVE)
    err = _check_attention(
        "main shape", _same_twice(
            "main shape", lambda: KA.paged_attention(q, kp, vp, table,
                                                     lengths)),
        ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
    pl = KA.launch_plan(q, kp, table)
    t_k, t_p, t_lib, t_gl = _time_attention(q, kp, vp, table, lengths,
                                            flush, plain_iters=10)
    live, a_bound = _attention_bound(lengths, b, h, kvh, hd, nbps, 2)
    w = time_paged_write(kp, vp, table, lengths, gen)
    print(f"[paged] paged_attention B={b} bf16 lengths {list(MAIN_LIVE)} "
          f"({live} live rows; {pl}): max_abs_err {err:.3e}, bitwise "
          f"repeatable; kernel {t_k:.4f} ms plain {t_p:.4f} ms bound "
          f"{a_bound[0]:.4f} ms ({a_bound[1]}) sdpa-on-gathered-view "
          f"{t_lib:.4f} ms gather+sdpa {t_gl:.4f} ms (kernel / sdpa "
          f"{t_k / t_lib:.3f})", flush=True)
    results["paged_attention"] = dict(
        max_abs_err=max(worst, err), ms=t_k, plain_ms=t_p,
        bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=t_lib)
    results["paged_kv_write"] = dict(
        max_abs_err=0.0, ms=w["pair"], plain_ms=w["plain"],
        bound_ms=w["bound"][0], bound_by=w["bound"][1],
        library_ms=w["index_put_targets"])
    del q, kp, vp
    paged_scaling(gen, rng, flush)
    paged_long(gen, rng, flush)
    print(f"[paged] paged_attention agrees with its plain version in "
          f"{2 * len(BATCHES) * len(PAGED_NBPS)} full-width cases (max "
          f"abs err {worst:.3e}) and {n_edge} edge cases; "
          f"paged_kv_write is bitwise in {n_write} cases", flush=True)
    del flush_buf
    torch.cuda.empty_cache()


def write_times(kp, vp, kv, vv, table, cl) -> dict:
    """#8 at one shape, without an L2 flush (the step's attention then
    reads the rows it wrote): the decode step's K and V write (the paired
    launch, or, in a checkout before it, the targets' arithmetic and two
    launches), one and two launches of the single entry, the plain
    version (the targets' arithmetic and two plain writes), the yardstick
    (two ``index_put_``, with and without the targets' arithmetic in
    front), an empty launch of 1 and of 2B blocks, and the byte bound."""
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    b, bs = kv.shape[0], kp.shape[1]
    pair = getattr(KA, "paged_kv_write_pair", None)

    def targets():     # the first port's per-layer arithmetic
        blk = table.gather(1, (cl // bs)[:, None].to(torch.long))[:, 0]
        return blk, (cl % bs).to(torch.int32)

    def step():
        if pair is not None:
            pair(kp, vp, kv, vv, table, cl)
        else:
            blk, off = targets()
            KA.paged_kv_write(kp, kv, blk, off)
            KA.paged_kv_write(vp, vv, blk, off)

    def plain():
        blk, off = targets()
        ref.paged_kv_write_ref(kp, kv, blk, off)
        ref.paged_kv_write_ref(vp, vv, blk, off)

    def library(with_targets: bool):
        def fn():
            blk, off = targets() if with_targets else given
            at = (blk.long(), off.long()) if with_targets else idx
            kp.index_put_(at, kv)
            vp.index_put_(at, vv)
        return fn

    given = targets()
    blk, off = given
    idx = (blk.long(), off.long())
    row_bytes = kv[0].numel() * kv.element_size()
    return {
        "route": "one launch" if pair is not None
                 else "targets + two launches",
        "pair": cuda_ms(step, iters=50),
        "one": cuda_ms(lambda: KA.paged_kv_write(kp, kv, blk, off),
                       iters=50),
        "two": cuda_ms(lambda: (KA.paged_kv_write(kp, kv, blk, off),
                                KA.paged_kv_write(vp, vv, blk, off)),
                       iters=50),
        "plain": cuda_ms(plain, iters=20),
        "index_put": cuda_ms(library(False), iters=50),
        "index_put_targets": cuda_ms(library(True), iters=50),
        "empty1": empty_ms(1), "empty2b": empty_ms(2 * b),
        # K and V rows read and written, a table entry and a length a slot
        "bound": bound_ms(4 * b * row_bytes + b * (4 + cl.element_size()),
                          0)}


def write_line(tag: str, t: dict, b: int) -> str:
    return (f"paged_kv_write {tag}: the decode step's K and V write "
            f"{t['pair']:.4f} ms ({t['route']}); the single entry, one "
            f"launch {t['one']:.4f}, two {t['two']:.4f}; plain "
            f"{t['plain']:.4f}; index_put_ x2 {t['index_put']:.4f}, with "
            f"the targets' arithmetic {t['index_put_targets']:.4f}; empty "
            f"launch 1 block {t['empty1']:.4f}, {2 * b} blocks "
            f"{t['empty2b']:.4f}; bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]})")


def time_paged_write(kp, vp, table, lengths, gen) -> dict:
    """#8 at the main path's shape: the attention's pool and table, each
    slot writing at its length (int64, as the decode step holds it)."""
    import torch
    b = table.shape[0]
    kv, vv = (torch.randn((b,) + kp.shape[2:], generator=gen,
                          device=kp.device).to(kp.dtype) for _ in range(2))
    t = write_times(kp, vp, kv, vv, table, lengths.long())
    print(f"[paged] {write_line(f'B={b} bf16', t, b)}", flush=True)
    return t


def pack_line(tag: str, t: float, empty: float, bound: tuple) -> str:
    return (f"sign_pack {tag}: kernel {t:.4f} ms; empty launch "
            f"{empty:.4f} (kernel - empty {t - empty:+.4f}); bound "
            f"{bound[0]:.5f} ms ({bound[1]}; share {bound[0] / t:.3f})")


def time_write_and_pack(outputs: dict | None = None) -> None:
    """#8 and #9 of the checkout whose ``repro_torch`` is imported, at the
    main path's shapes, beside an empty launch: the decode step's K and V
    write at B=4 and 16 (bf16 pool, 32 KV heads x hd 128, block 16), then
    sign_pack on x at B in {1, 4, 64} (bf16, the L2 flushed, as in a
    step) and on the gate weights at load ((11008, 4096) float32 and
    bf16).  With ``outputs`` it keeps what they computed (the written rows
    and a fingerprint of each pool, the sign words), for a bitwise check
    across checkouts."""
    import numpy as np
    import torch
    from repro_torch.kernels import sign_pack as KS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    kvh, hd, bs, nbps = 32, 128, PAGE_BLOCK, PAGED_NBPS[0]

    def fingerprint(pool):
        x = pool.view(torch.int16).flatten().long()
        weight = torch.arange(x.numel(), device=dev) % 65521 + 1
        return torch.stack([x.sum(), (x * weight).sum()]).cpu()

    for b in (MAIN_BATCH, 16):
        nb = b * nbps + 2
        kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kv, vv = (torch.randn((b, kvh, hd), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        table = torch.as_tensor((rng.permutation(nb - 2)[: b * nbps] + 2)
                                .reshape(b, nbps).astype(np.int32),
                                device=dev)
        cl = torch.as_tensor(rng.integers(0, nbps * bs, size=b), device=dev)
        t = write_times(kp, vp, kv, vv, table, cl)
        print(f"[kv] {write_line(f'B={b} bf16', t, b)}", flush=True)
        if outputs is not None:
            blk = table.gather(1, (cl // bs)[:, None])[:, 0].long()
            outputs[f"write B={b}"] = [
                kp[blk, cl % bs].cpu(), vp[blk, cl % bs].cpu(),
                fingerprint(kp), fingerprint(vp)]
        del kp, vp
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    empty, empty_warm = empty_ms(1, flush=flush), empty_ms(1)
    for b in (1, MAIN_BATCH, MAIN_CHUNK):
        x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
        t = cuda_ms(lambda: KS.sign_pack(x), iters=50, flush=flush)
        t_warm = cuda_ms(lambda: KS.sign_pack(x), iters=50)
        bound = bound_ms(b * D * 2 + b * (D // 32) * 4, b * D)
        print(f"[kv] {pack_line(f'x B={b} bf16', t, empty, bound)}; x in "
              f"the L2 (as a step finds it): kernel {t_warm:.4f} ms, empty "
              f"launch {empty_warm:.4f}", flush=True)
        if outputs is not None:
            outputs[f"sign_pack x B={b}"] = [KS.sign_pack(x).cpu()]
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        w_t = wg.to(dt)
        t = cuda_ms(lambda: KS.sign_pack(w_t), iters=10)
        bound = bound_ms(K * D * w_t.element_size() + K * (D // 32) * 4,
                         K * D)
        tag = f"gate weights ({K}, {D}) {str(dt)[6:]} at load"
        print(f"[kv] {pack_line(tag, t, empty_ms(1), bound)}", flush=True)
        if outputs is not None:
            outputs[f"sign_pack gate weights {dt}"] = [
                KS.sign_pack(w_t).cpu()]
        del w_t
    del wg, flush_buf
    torch.cuda.empty_cache()


def _same_twice(tag, fn, name="paged_attention"):
    """fn() twice on the same inputs: the outputs must be bitwise equal
    (no float atomics, fixed reduction orders)."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name} {tag}: two runs on the same inputs differ "
             f"by {float((a - b).abs().max()):.3e}")
    return a


def _time_attention(q, kp, vp, table, lengths, flush, plain_iters,
                    softcap: float = 0.0, window: int = 0):
    """The kernel, its plain version, SDPA on a dense (B, K, S, hd) view
    gathered beforehand (the gather left out of its time), and the gather
    and SDPA together.  SDPA's mask drops the dead rows and, with
    ``window``, the rows outside it; with K < H it shares each K/V head
    among its query heads (``enable_gqa``, PyTorch 2.5 on); it has no
    softcap."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    b, h, hd = q.shape
    kvh = kp.shape[2]
    s_max = table.shape[1] * kp.shape[1]
    tab = table.long()
    kw = dict(softcap=softcap, window=window)

    def view(pages):
        return pages[tab].reshape(b, s_max, kvh, hd).transpose(1, 2)
    back = lengths[:, None] - torch.arange(s_max, device=q.device)[None, :]
    live = back >= 0
    if window:
        live &= back < window
    sdpa = dict(attn_mask=live[:, None, None, :])
    if kvh != h:
        sdpa["enable_gqa"] = True
    qd = q[:, :, None, :]
    t_k = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table, lengths,
                                             **kw), iters=50, flush=flush)
    t_p = cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, table,
                                                  lengths, **kw),
                  iters=plain_iters, flush=flush)
    kd, vd = view(kp).contiguous(), view(vp).contiguous()
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, **sdpa), iters=50, flush=flush)
    del kd, vd
    t_gl = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, view(kp), view(vp), **sdpa), iters=20, flush=flush)
    return t_k, t_p, t_lib, t_gl


def paged_long(gen, rng, flush) -> None:
    """The long-context timed shape: B=16, H = K = 32, hd 128, bf16 pool,
    max_len 4096, lengths spread over 512-4095 (a ~1.1 GB pool, ~0.6 GB
    of live K and V rows per call)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    b, h, kvh, hd, nbps = 16, 32, 32, 128, 4096 // PAGE_BLOCK
    # the phase's seed alone: these lengths do not move with the draws of
    # the cases before this one
    lens = [int(x) for x in
            np.random.default_rng(8).integers(512, 4096, size=b)]
    q, kp, vp, table, lengths = _paged_inputs(
        gen, rng, b, h, kvh, hd, PAGE_BLOCK, nbps, torch.bfloat16,
        torch.bfloat16, lengths=lens)
    err = _check_attention(
        "long shape", _same_twice(
            "long shape", lambda: KA.paged_attention(q, kp, vp, table,
                                                     lengths)),
        ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
    pl = KA.launch_plan(q, kp, table)
    t_k, t_p, t_lib, t_gl = _time_attention(q, kp, vp, table, lengths,
                                            flush, plain_iters=3)
    live, bound = _attention_bound(lengths, b, h, kvh, hd, nbps, 2)
    print(f"[paged] paged_attention long shape B={b} bf16 max_len "
          f"{nbps * PAGE_BLOCK} lengths {min(lens)}-{max(lens)} ({live} live "
          f"rows; {pl}): max_abs_err {err:.3e}, bitwise repeatable; kernel "
          f"{t_k:.4f} ms plain {t_p:.4f} ms bound {bound[0]:.4f} ms "
          f"({bound[1]}; share of bound {bound[0] / t_k:.3f}) "
          f"sdpa-on-gathered-view {t_lib:.4f} ms gather+sdpa {t_gl:.4f} ms",
          flush=True)
    del q, kp, vp
    torch.cuda.empty_cache()


def phase_paged_edges() -> int:
    """paged_attention's other paths: GQA rep 2/4/6/8 and 48 (six CTAs'
    groups of query heads), hd 64 and 256, block 1/8/32, softcap, window
    (with a length past it: no live lane, a uniform softmax), float32 q on
    a bf16 pool, lengths past max_len; then the cluster split's edges at
    P = 8: a slot shorter than one CTA's share (P - 1 idle CTAs), spans
    that end exactly on a tile of every CTA and one past it, lengths at a
    page boundary, windows of 1 row, of a tile and a few rows, and of the
    last ceil(max_len / P) rows, none live at P = 8, and rep 8 at max_len
    8192.  Each case twice: bitwise equal runs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attn as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    bf, f32 = torch.bfloat16, torch.float32

    def small(pl, s_max, bs, window):
        return [s_max - 1, 0, bs, s_max + 10, 3]

    def split(pl, s_max, bs, window):
        p, tr = pl.cluster, pl.tile_rows
        return [0, p - 2, p * tr - 1, p * tr, 9 * bs - 1, 9 * bs, s_max - 1]

    def windowed(pl, s_max, bs, window):
        return [s_max - 1, 0, 77, s_max + window + 3]

    def given(*lens):
        return lambda pl, s_max, bs, window: list(lens)

    cases = [
        (3, 8, 4, 64, 8, 6, bf, bf, 0.0, 0, small),
        (3, 16, 4, 128, 1, 40, f32, f32, 0.0, 0, small),
        (2, 16, 2, 64, 32, 3, bf, f32, 30.0, 0, small),
        (5, 8, 8, 128, 16, 4, f32, bf, 0.0, 7, small),
        (5, 4, 1, 256, 8, 5, bf, bf, 20.0, 9, small),
        (4, 32, 4, 64, 8, 16, f32, f32, 0.0, 0, small),
        (7, 8, 8, 128, 16, 64, bf, bf, 0.0, 0, split),
        (7, 8, 8, 128, 16, 64, f32, f32, 0.0, 0, split),
        (7, 8, 8, 128, 16, 64, bf, f32, 0.0, 0, split),
        (4, 8, 8, 128, 16, 64, bf, bf, 0.0, 1, windowed),
        (4, 8, 8, 128, 16, 64, bf, bf, 0.0, 35, windowed),
        (4, 8, 8, 128, 16, 64, f32, f32, 5.0, 128, windowed),
        (2, 32, 4, 128, 16, 512, bf, bf, 0.0, 0, given(8191, 5000)),
        (2, 32, 4, 128, 16, 512, bf, f32, 0.0, 0, given(4095, 8191)),
        (4, 16, 16, 64, 16, 32, bf, bf, 0.0, 0, given(511, 0, 200, 33)),
        (3, 8, 4, 256, 16, 32, f32, f32, 0.0, 0, given(511, 100, 0)),
        (3, 8, 4, 256, 16, 32, bf, bf, 30.0, 0, given(300, 511, 17)),
        (2, 48, 1, 128, 16, 8, bf, bf, 0.0, 0, given(127, 50)),
        (3, 12, 2, 128, 16, 8, f32, f32, 0.0, 0, given(127, 64, 5)),
    ]
    for (b, h, kvh, hd, bs, nbps, kv_dt, q_dt, softcap, window,
         lens_of) in cases:
        s_max = nbps * bs
        q, kp, vp, table, _ = _paged_inputs(
            gen, rng, b, h, kvh, hd, bs, nbps, kv_dt, q_dt, lengths=[0] * b)
        pl = KA.launch_plan(q, kp, table)
        lengths = lens_of(pl, s_max, bs, window)[:b]
        lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        kw = dict(softcap=softcap, window=window)
        tag = (f"B={b} H={h} K={kvh} hd={hd} block={bs} max_len={s_max} "
               f"{str(kv_dt)[6:]}/{str(q_dt)[6:]} softcap={softcap} "
               f"window={window} lengths={lengths} (P={pl.cluster}, "
               f"tile {pl.tile_rows} rows, {pl.smem_bytes} B)")
        err = _check_attention(
            tag, _same_twice(tag, lambda: ops.paged_attention(
                q, kp, vp, table, lens, **kw)),
            ref.paged_attention_ref(q, kp, vp, table, lens, **kw), vp)
        print(f"[paged] edge {tag}: max_abs_err {err:.3e}", flush=True)
    return len(cases)


def phase_paged_write() -> int:
    """paged_kv_write bitwise against its plain version, each case run
    twice: the single entry (targets given) with several slots on one row
    of the write-off block (the last one wins) and a row size that is not
    a multiple of 16 bytes; the paired entry (K and V in one launch, each
    slot's target found in the table) against two plain writes, with dead
    slots colliding on the write-off block, positions on block edges,
    int32 and int64 cache_len, and rows of 4- and 2-byte copies."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    bs = PAGE_BLOCK
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        for b, row in ((16, (32, 128)), (4, (32, 128)), (9, (3, 5))):
            pages = torch.randn((40, bs) + row, generator=gen,
                                device=dev).to(dt)
            vals = torch.randn((b,) + row, generator=gen, device=dev).to(dt)
            blocks = rng.integers(2, 40, size=b)
            offsets = rng.integers(0, bs, size=b)
            blocks[: b // 2] = 1                    # the write-off block
            offsets[: b // 2] = rng.integers(0, 2, size=b // 2)
            perm = rng.permutation(b)
            blk = torch.as_tensor(blocks[perm].astype(np.int32), device=dev)
            off = torch.as_tensor(offsets[perm].astype(np.int32), device=dev)
            want = ref.paged_kv_write_ref(pages.clone(), vals, blk, off)
            last = max(i for i in range(b) if int(blk[i]) == int(blk[0])
                       and int(off[i]) == int(off[0]))
            for run in range(2):
                got = KA.paged_kv_write(pages.clone(), vals, blk, off)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(
                        got[int(blk[0]), int(off[0])], vals[last])):
                    fail(f"paged_kv_write B={b} row={row} {dt} (run "
                         f"{run}): differs from its plain version or the "
                         "last slot did not win")
            n += 1
    # the paired entry: (B, row, blocks a slot); a third of the slots dead
    for dt in (torch.bfloat16, torch.float32):
        for b, row, nbps in ((4, (32, 128), 16), (16, (32, 128), 16),
                             (9, (3, 5), 4), (64, (8, 64), 2)):
            nb = b * nbps + 2
            kp, vp = (torch.randn((nb, bs) + row, generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            kv, vv = (torch.randn((b,) + row, generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            table = (rng.permutation(nb - 2)[: b * nbps] + 2).reshape(
                b, nbps).astype(np.int32)
            lens = rng.integers(0, nbps * bs, size=b)
            edges = [bs - 1, bs, 2 * bs - 1, 2 * bs, 0, nbps * bs - 1]
            lens[: min(b, 6)] = [min(e, nbps * bs - 1)
                                 for e in edges[: min(b, 6)]]
            dead = b // 3
            if dead:
                table[b - dead:] = 1                # the write-off block
                lens[b - dead:] = rng.integers(0, 2, size=dead)
            tab = torch.as_tensor(table, device=dev)
            for len_dt in (torch.int32, torch.int64):
                cl = torch.as_tensor(lens, device=dev).to(len_dt)
                wk, wv = kp.clone(), vp.clone()
                ref.paged_kv_write_pair_ref(wk, wv, kv, vv, tab, cl)
                blk, off = ref.paged_write_target(tab, cl, bs)
                for run in range(2):
                    gk, gv = kp.clone(), vp.clone()
                    KA.paged_kv_write_pair(gk, gv, kv, vv, tab, cl)
                    torch.cuda.synchronize()
                    if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
                        fail(f"paged_kv_write pair B={b} row={row} {dt} "
                             f"cache_len {len_dt} (run {run}): differs "
                             "from two plain writes")
                    if dead > 1:
                        s = b - dead
                        last = max(i for i in range(b)
                                   if int(blk[i]) == int(blk[s])
                                   and int(off[i]) == int(off[s]))
                        if not torch.equal(gk[int(blk[s]), int(off[s])],
                                           kv[last]):
                            fail(f"paged_kv_write pair B={b} row={row}: "
                                 "the last colliding slot did not win")
                n += 1
    return n


def sign_pack_edges() -> int:
    """sign_pack at its edges, bitwise against the plain version, each
    case twice: both routes (rows of d * elem % 16 != 0 and a 4-byte-offset
    base take the scalar route), the scalar tail of a partial last word,
    x-sized and weight-sized rows, -0.0 and NaN."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    e = 0
    for d in (5, 24, 33, 1000, 5120, 11000):
        for b in (1, 5, 64, 257):
            base = torch.randn((b * d + 4,), generator=gen, device=dev)
            base[::9] = -0.0
            base[1::13] = float("nan")
            for xdt in (torch.float32, torch.bfloat16):
                buf = base.to(xdt)
                views = {"aligned": buf[: b * d].view(b, d),
                         "unaligned": buf[4 // buf.element_size():][
                             : b * d].view(b, d)}
                for kind, v in views.items():
                    pl = KS.plan(b, d, v.element_size(), v.data_ptr())
                    tag = (f"sign_pack B={b} d={d} {str(xdt)[6:]} {kind} "
                           f"({pl.route})")
                    want = ref.sign_pack_ref(v)
                    for run in range(2):
                        got = KS.sign_pack(v)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            fail(f"{tag} (run {run}): differs from its "
                                 f"plain version in "
                                 f"{int((got != want).sum())} words")
                        e += 1
    print(f"[signs] sign_pack edges bitwise equal to the plain version in "
          f"{e} runs (d in {{5, 24, 33, 1000, 5120, 11000}}, B in {{1, 5, "
          "64, 257}, float32 and bf16, an aligned and a 4-byte-offset view, "
          "-0.0 and NaN; each case twice)", flush=True)
    return e


def phase_sign_kernels(results: dict) -> None:
    """sign_pack and predict_counts against their plain versions at full
    width, bitwise, and predict_margins against core.predictor.margins;
    predict_counts at its edges, each case twice; then the timings at the
    main path's shapes."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sign_pack as KS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    n = 0

    def same(tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape \
                else "shape"
            fail(f"{tag}: differs from its plain version ({bad})")
        return 1

    for d in (D, D_PAD):
        wg = torch.randn((K, d), generator=gen, device=dev) * d ** -0.5
        wg[0, :96] = 0.0
        wg[1, :96] = -0.0
        for wdt in (torch.float32, torch.bfloat16):
            w_t = wg.to(wdt)
            n += same(f"sign_pack wg ({K}, {d}) {wdt}", KS.sign_pack(w_t),
                      ref.sign_pack_ref(w_t))
        pw = KS.sign_pack(wg)
        # 64: a gather prefill chunk's rows; 65 and 257: a partial last
        # token tile of counts
        for b in (1, 4, 16, 24, MAIN_CHUNK, 65, 257):
            x = torch.randn((b, d), generator=gen, device=dev)
            x[0, ::7] = 0.0
            x[-1, 1::5] = -0.0
            for xdt in (torch.float32, torch.bfloat16):
                tag = f"B={b} d={d} x={str(xdt)[6:]}"
                px = KS.sign_pack(x.to(xdt))
                n += same(f"sign_pack {tag}", px, ref.sign_pack_ref(x.to(xdt)))
                got = KP.predict_counts(pw, px)
                n += same(f"predict_counts {tag}", got,
                          ref.predict_counts_ref(pw, px))
                n += same(f"predict_counts {tag}, again",
                          KP.predict_counts(pw, px), got)
                for aname, alpha in _alpha_cases(b, dev).items():
                    n += same(f"predict_margins {tag} alpha={aname}",
                              ops.predict_margins(pw, px, d, alpha),
                              P.margins(pw, px, d, alpha))
        xg = torch.randn((2, MAIN_BATCH, d), generator=gen, device=dev)
        pxg = ops.sign_pack(xg)
        n += same(f"sign_pack (2, {MAIN_BATCH}, {d})", pxg,
                  ref.sign_pack_ref(xg))
        n += same(f"predict_counts (2, {MAIN_BATCH}, {d})",
                  ops.predict_counts(pw, pxg), ref.predict_counts_ref(pw, pxg))
    print(f"[signs] sign_pack, predict_counts and predict_margins bitwise "
          f"equal to their plain versions in {n} cases (d in {{{D}, "
          f"{D_PAD}}}, B in {{1, 4, 16, 24, {MAIN_CHUNK}, 65, 257}} and "
          f"(2, {MAIN_BATCH}), float32 "
          f"and bf16, zeros and -0.0; predict_counts twice)", flush=True)
    sign_pack_edges()
    # ---- predict_counts at its edges: k not a multiple of 16 rows (a
    # partial last unit), rows of 125 words (the 4-byte copies) and of 128
    # and 4 (bulk copies), partial last token tiles, words all ones (every
    # popcount term 32 w) and all ones against all zeros (the largest
    # count), each run twice
    m = 0
    for k, d in ((K - 8, D), (K - 8, D_PAD), (24, D), (24, 100), (1000, D)):
        pw = KS.sign_pack(torch.randn((k, d), generator=gen, device=dev))
        for b in (1, 5, 65, 257):
            px = KS.sign_pack(torch.randn((b, d), generator=gen, device=dev))
            ones_w, ones_x = torch.full_like(pw, -1), torch.full_like(px, -1)
            for kind, a, c in (("random", pw, px), ("ones", ones_w, ones_x),
                               ("ones-zeros", ones_w, torch.zeros_like(px)),
                               ("zeros-ones", torch.zeros_like(pw), ones_x)):
                tag = f"predict_counts k={k} d={d} B={b} words={kind}"
                got = KP.predict_counts(a, c)
                m += same(tag, got, ref.predict_counts_ref(a, c))
                m += same(f"{tag}, again", KP.predict_counts(a, c), got)
                if kind in ("ones-zeros", "zeros-ones") and \
                        not bool((got == 32 * a.shape[1]).all()):
                    fail(f"{tag}: counts other than 32 w")
    print(f"[signs] predict_counts edges bitwise equal to the plain version "
          f"in {m} runs (k in {{{K - 8}, 24, 1000}}, d in {{{D}, {D_PAD}, "
          "100}, B in {1, 5, 65, 257}, words random, all ones, all ones "
          "against all zeros; each case twice)", flush=True)
    # ---- timings at the main path's shapes: x (B=4, bf16) per MLP call,
    # the float32 gate weights at load, the counts at B=4
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    b, w = MAIN_BATCH, D // 32
    x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    pw, px = KS.sign_pack(wg), KS.sign_pack(x)
    t_sx = cuda_ms(lambda: KS.sign_pack(x), iters=50, flush=flush)
    t_sx_plain = cuda_ms(lambda: ref.sign_pack_ref(x), iters=20, flush=flush)
    b_sx = bound_ms(b * D * 2 + b * w * 4, b * D)
    t_sw = cuda_ms(lambda: KS.sign_pack(wg), iters=10)
    t_sw_plain = cuda_ms(lambda: ref.sign_pack_ref(wg), iters=3)
    b_sw = bound_ms(K * D * 4 + K * w * 4, K * D)
    e_x, e_w = empty_ms(1, flush=flush), empty_ms(1)
    t_c = cuda_ms(lambda: KP.predict_counts(pw, px), iters=50, flush=flush)
    t_c_plain = cuda_ms(lambda: ref.predict_counts_ref(pw, px), iters=5,
                        flush=flush)
    # bound: bytes against the b1 MMAs, the kernel's route; the CUDA-core
    # popcounts beside
    t_b, t_tc, t_cc = predict_work(b, 4, counts=True)
    b_c = (max(t_b, t_tc), "bytes" if t_b >= t_tc else "operations")
    pxc = KS.sign_pack(torch.randn((MAIN_CHUNK, D), generator=gen,
                                   device=dev))
    t_c64 = cuda_ms(lambda: KP.predict_counts(pw, pxc), iters=50,
                    flush=flush)
    t_b64, t_tc64, t_cc64 = predict_work(MAIN_CHUNK, 4, counts=True)
    print(f"[signs] {pack_line(f'x B={b} bf16', t_sx, e_x, b_sx)}; plain "
          f"{t_sx_plain:.4f} ms; no PyTorch call packs sign bits",
          flush=True)
    tag = f"gate weights ({K}, {D}) float32 at load"
    print(f"[signs] {pack_line(tag, t_sw, e_w, b_sw)}; plain "
          f"{t_sw_plain:.4f} ms", flush=True)
    print(f"[signs] predict_counts B={b}: kernel {t_c:.4f} ms plain "
          f"{t_c_plain:.4f} ms bound {b_c[0]:.4f} ms ({b_c[1]}; CUDA-core "
          f"popcounts {t_cc:.4f} ms)", flush=True)
    print(f"[signs] predict_counts S={MAIN_CHUNK} (a gather prefill chunk): "
          f"kernel {t_c64:.4f} ms bound {max(t_b64, t_tc64):.4f} ms (bytes "
          f"{t_b64:.4f}, b1 tensor cores {t_tc64:.4f}; CUDA-core popcounts "
          f"{t_cc64:.4f} ms)", flush=True)
    results["sign_pack"] = dict(max_abs_err=0.0, ms=t_sx, plain_ms=t_sx_plain,
                                bound_ms=b_sx[0], bound_by=b_sx[1],
                                library_ms=None)
    results["predict_counts"] = dict(
        max_abs_err=0.0, ms=t_c, plain_ms=t_c_plain, bound_ms=b_c[0],
        bound_by=b_c[1], library_ms=None)
    del wg, pw, flush_buf
    torch.cuda.empty_cache()


def phase_paged_decode() -> None:
    """Two full-width float32 layers decoding against a fragmented float32
    pool: the kernel route on the card against the plain route on the CPU
    and against the gather route on the card (``_hold``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32",
                       paged_attn_kernel=True,
                       sparse=dataclasses.replace(base.sparse,
                                                  strategy="pallas",
                                                  enabled=True))
    b, steps, bs, nbps = MAIN_BATCH, 8, PAGE_BLOCK, 4
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    rng = np.random.default_rng(11)
    n, table = _fragmented_table(rng, b, nbps)
    lens0 = np.asarray([20, 17, 33, 47])
    # stale random content everywhere: the history of the live lanes
    shape = (n, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = [{k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for k in ("k", "v")} for _ in range(cfg.n_layers)]
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] + \
        np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]

    L = cfg.n_layers
    want = dict(predict_group_margins=L * steps, fused_sparse_mlp=L * steps,
                paged_attention=L * steps, paged_kv_write=L * steps)

    def run(run_cfg):
        return lambda dev: _paged_forced(params[dev], run_cfg, dev, pool,
                                         table, lens0, forced, alphas)
    _hold("[paged-decode] kernel route vs the CPU plain route", run(cfg),
          LOGIT_TOL["float32"], want)
    _hold("[paged-decode] kernel route vs the card's gather route",
          run(cfg), LOGIT_TOL["float32"], want,
          ref=lambda: run(cfg.replace(paged_attn_kernel=False))("cuda"))
    del params
    torch.cuda.empty_cache()


def phase_serve_paged(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with the
    paged KV pool (bf16, block 16, paged_attn_kernel), chunked sparse
    prefill (chunks of 64) and float32 MLP weights."""
    import numpy as np
    import torch
    from repro_torch.configs.base import PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=dataclasses.replace(
                           base.sparse, strategy="pallas", enabled=True,
                           sparse_prefill=True,
                           prefill_max_tokens=max(
                               base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK,
                       paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, scfg, params, device="cuda")
    torch.cuda.synchronize()
    pool_bytes = sum(t.numel() * t.element_size()
                     for layer in srv._pool["blocks"] for t in layer.values())
    print(f"[serve-paged] {cfg.n_layers} layers, KV pool "
          f"{srv.kv_pool.n_blocks} blocks x {PAGE_BLOCK} tokens "
          f"{cfg.kv_cache_dtype}, {pool_bytes / 1e9:.3f} GB; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(12)
    system = rng.integers(0, cfg.vocab, size=128)
    # uid 0 shares the system prompt and finishes first (8 new tokens);
    # uids 4-6 share it too and are admitted only when a slot frees, after
    # uid 0 committed its prompt blocks.  Sharers keep one tier: the
    # sparse-prefill alphas salt the trie.
    specs = [(True, 8, "balanced", None), (False, 16, "latency", "sA"),
             (False, 16, "quality", "sB"), (False, 16, "balanced", None),
             (True, 16, "balanced", None), (True, 16, "balanced", None),
             (True, 16, "balanced", None), (False, 16, "quality", None)]
    reqs = []
    for uid, (share, max_new, sla, sid) in enumerate(specs):
        own = rng.integers(0, cfg.vocab, size=int(
            rng.integers(16, 41) if share else rng.integers(60, 151)))
        prompt = np.concatenate([system, own]) if share else own
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new,
                            sla=sla, session_id=sid))
    L = cfg.n_layers

    def serve(batch, label):
        ops.reset_launch_counts()
        steps0, run0 = srv.decode_steps, srv.prefill_chunks_run
        skip0 = srv.prefill_chunks_skipped
        done = srv.serve(batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps = srv.decode_steps - steps0
        chunks = srv.prefill_chunks_run - run0
        skipped = srv.prefill_chunks_skipped - skip0
        if len(done) != len(batch) or any(
                r.outcome != "completed" or len(r.out) != r.max_new
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-paged {label}: not every request completed with "
                 "valid tokens")
        want = {k: 0 for k in counts}
        want.update({"predict_group_margins": L * steps,
                     "fused_sparse_mlp": L * steps,
                     "paged_attention": L * steps,
                     "paged_kv_write": L * steps,
                     "predict_chunk_group_margins": L * chunks,
                     "fused_sparse_mlp_chunk": L * chunks})
        n_chunks = sum(-(-len(r.prompt) // MAIN_CHUNK) for r in batch)
        if steps == 0 or counts != want or chunks + skipped != n_chunks:
            fail(f"serve-paged {label}: launches {counts}, want {want} "
                 f"({steps} decode steps, {chunks} chunks run + {skipped} "
                 f"skipped of {n_chunks})")
        rep = throughput_report(done)
        print(f"[serve-paged] {label}: throughput_report {json.dumps(rep)}",
              flush=True)
        print(f"[serve-paged] {label}: decode steps {steps}; prefill chunks "
              f"run {chunks}, skipped {skipped}; launches {counts}; "
              f"paged_stats {json.dumps(srv.paged_stats())}", flush=True)
        return done, counts

    done, counts = serve(reqs, "8 requests")
    results["launches_paged"] = counts
    st = srv.paged_stats()
    if st["reuse_hits"] < 3 or st["prefill_chunks_skipped"] < 6:
        fail(f"serve-paged: the three later sharers of the system prompt "
             f"did not admit by reference: {st}")
    hist = {r.uid: np.concatenate([r.prompt, r.out]) for r in done}
    turn2 = [Request(uid=10 + u, prompt=np.concatenate(
                 [hist[u], rng.integers(0, cfg.vocab, size=8)]),
                 max_new=16, session_id=sid)
             for u, sid in ((1, "sA"), (2, "sB"))]
    done2, _ = serve(turn2, "turn 2 of two sessions")
    tiers = {r.uid: r.sla for r in done2}
    if tiers != {11: "latency", 12: "quality"}:
        fail(f"serve-paged: session tiers did not stick: {tiers}")
    # a sharer alone, admitted by reference, against a fresh server
    probe = np.concatenate([system, rng.integers(0, cfg.vocab, size=24)])
    skip0 = srv.prefill_chunks_skipped
    [got], _ = serve([Request(uid=20, prompt=probe, max_new=16)],
                     "a reused prefix alone")
    if srv.prefill_chunks_skipped - skip0 != 2:
        fail("serve-paged: the probe did not admit its 128-token prefix by "
             "reference")
    print(f"[serve-paged] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    srv.kv_pool.check_invariants()
    fresh = Server(lm, cfg, scfg, params, device="cuda")
    [want] = fresh.serve([Request(uid=20, prompt=probe, max_new=16)])
    torch.cuda.synchronize()
    if not np.array_equal(got.out, want.out):
        fail(f"serve-paged: the reused-prefix request emitted {got.out} "
             f"but {want.out} on a fresh server")
    print(f"[serve-paged] the reused-prefix request's 16 tokens equal a "
          f"fresh server's", flush=True)
    del fresh, params
    profile_paged_decode(srv, cfg)
    del srv
    torch.cuda.empty_cache()


def _paged_step(srv, cfg, tok=None) -> tuple:
    """(label, one full-depth paged decode step): the server's batch,
    every slot at length 64 over its own pool blocks (a pool of its own,
    max_len / 16 blocks a slot), token 0 in every slot unless ``tok`` (B,
    1) tokens are given.  On a mesh rank the step is the server's own
    (``Server._decode``: the slot check against rank 0, the model on the
    rank's line's slots, the gather of every line's tokens)."""
    import torch
    from repro_torch.models import lm

    b, nbps, dev = srv.scfg.batch, srv.scfg.max_len // PAGE_BLOCK, srv.device
    pool = lm.init_kv_pool(cfg, b * nbps + 2, PAGE_BLOCK, dev)
    table = (torch.arange(b * nbps, dtype=torch.int32, device=dev)
             + 2).reshape(b, nbps)
    tok = (torch.zeros((b, 1), dtype=torch.int32, device=dev)
           if tok is None else torch.as_tensor(tok, device=dev))
    lengths = torch.full((b,), 64, device=dev)
    label = (f"paged decode step (B={b}, {cfg.n_layers} layers, "
             f"{cfg.kv_cache_dtype} pool, paged kernels)")
    if srv.mesh is None:
        return label, lambda: lm.decode_step(srv.params, cfg, tok, pool,
                                             lengths, block_table=table)
    host = [t.cpu().numpy() for t in (tok, lengths, table)]
    return (f"{label}, the server's step on {len(srv._rows)} slots a "
            "line", lambda: srv._decode(host[0], pool, host[1],
                                        table=host[2]))


def profile_paged_decode(srv, cfg, tok=None) -> None:
    """Where one full-depth paged decode step's time goes
    (``_paged_step``)."""
    profile_step(*_paged_step(srv, cfg, tok))


def _mesh_step(srv) -> None:
    """One server decode step of ``_paged_step``, unprofiled."""
    import torch
    with torch.inference_mode():
        _paged_step(srv, srv.cfg)[1]()


def phase_serve_controller(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with the
    adaptive-alpha controller per SLA tier: strategy gather (masked audit
    every 4th step), then pallas (native false negatives).  The launch
    counters are reset before the server is built, so they cover the sign
    pack at load too."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK, warm_buckets=True,
                       controller=ControllerConfig(enabled=True,
                                                   per_tier=True,
                                                   audit_period=4))
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, base.vocab, size=int(p))
               for p in rng.integers(64, 129, size=8)]
    tiers = ("latency", "balanced", "quality")
    L = base.n_layers
    for strategy in ("gather", "pallas"):
        cfg = base.replace(sparse=dataclasses.replace(
            base.sparse, strategy=strategy, enabled=True,
            sparse_prefill=True, capacity_buckets=CTRL_BUCKETS,
            prefill_max_tokens=max(base.sparse.prefill_max_tokens,
                                   MAIN_CHUNK)))
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, 0, "cuda")
        ops.reset_launch_counts()
        srv = Server(lm, cfg, scfg, params, device="cuda")
        del params
        ladder = cfg.sparse.capacity_ladder(cfg.d_ff)
        reqs = [Request(uid=i, prompt=p, max_new=16, sla=tiers[i % 3])
                for i, p in enumerate(prompts)]
        t1 = time.perf_counter()
        done = srv.serve(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps, warm = srv.decode_steps, srv.warmup_steps
        chunks = srv.prefill_chunks_run
        ctl = srv.controller
        rep = throughput_report(done)
        print(f"[serve-controller] {strategy}: ladder {list(ladder)} groups; "
              f"init {t1 - t0:.1f} s, serve {time.perf_counter() - t1:.1f} s;"
              f" throughput_report {json.dumps(rep)}", flush=True)
        print(f"[serve-controller] {strategy}: decode steps {steps} (+{warm} "
              f"warmup), prefill chunks {chunks}, audits {ctl.state.audits}; "
              f"launches {counts}", flush=True)
        print(f"[serve-controller] {strategy}: bucket sequence "
              f"{list(srv.bucket_history)}; setups per bucket "
              f"{dict(srv._trace_counts)}", flush=True)
        print(f"[serve-controller] {strategy}: controller report "
              f"{json.dumps(ctl.report())}", flush=True)
        if len(done) != 8 or any(
                r.outcome != "completed" or len(r.out) != 16
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-controller ({strategy}): not every request "
                 "completed with 16 valid tokens")
        want = {n: 0 for n in counts}
        if strategy == "gather":
            # x's sign pack and the counts in every MLP call: decode steps,
            # warmup steps and prefill chunks; the gate weights' at load
            want["sign_pack"] = L * (1 + steps + warm + chunks)
            want["predict_counts"] = L * (steps + warm + chunks)
            audits = steps // 4
        else:
            want.update({"sign_pack": L,
                         "predict_group_margins": L * (steps + warm),
                         "fused_sparse_mlp": L * (steps + warm),
                         "predict_chunk_group_margins": L * chunks,
                         "fused_sparse_mlp_chunk": L * chunks})
            audits = 0
        if steps == 0 or counts != want:
            fail(f"serve-controller ({strategy}): launches {counts}, want "
                 f"{want}")
        if (ctl.state.steps, ctl.state.audits, ctl.prefill_chunks) != \
                (steps, audits, chunks) or ctl.native_fn != (
                    strategy == "pallas"):
            fail(f"serve-controller ({strategy}): controller saw "
                 f"{ctl.state.steps} steps, {ctl.state.audits} audits, "
                 f"{ctl.prefill_chunks} prefill chunks; want {steps}, "
                 f"{audits}, {chunks}")
        if warm != len(ladder) or set(srv._trace_counts.values()) != {1} \
                or not set(srv.bucket_history) <= set(ladder):
            fail(f"serve-controller ({strategy}): warmup {warm} steps, "
                 f"setups {dict(srv._trace_counts)}, buckets "
                 f"{set(srv.bucket_history)} (ladder {ladder})")
        # random weights keep the union demand near 1, so the serve holds
        # the top rung; a forced demand estimate must move the selection
        # down the ladder (slack 1.3, rounded up to 128 neurons: 0.05 ->
        # 96 groups -> the lowest rung, 0.15 -> 272 -> the middle one)
        held = ctl.state.union_ema
        picks = {}
        for demand in (0.05, 0.15, 1.0):
            ctl.state.union_ema = np.full_like(ctl.state.density_ema,
                                               demand)
            picks[demand] = srv._select_bucket()
        ctl.state.union_ema = held
        print(f"[serve-controller] {strategy}: forced union demand -> "
              f"bucket {picks}", flush=True)
        if list(picks.values()) != sorted(ladder):
            fail(f"serve-controller ({strategy}): forced demands selected "
                 f"{picks}, want the rungs {sorted(ladder)} in order")
        results[f"launches_ctrl_{strategy}"] = counts
        if strategy == "gather":
            profile_controller_steps(srv, cfg)
        del srv
        torch.cuda.empty_cache()


def profile_controller_steps(srv, cfg) -> None:
    """Where one full-depth controller decode step's time goes: a gather
    step at the 288-group rung and a masked audit step, B=4, balanced-tier
    alphas, caches at length 64, telemetry collected."""
    import numpy as np
    import torch
    from repro_torch.models import lm

    b = srv.scfg.batch
    caches = lm.init_caches(cfg, b, srv.scfg.max_len, "cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    alphas = srv._slot_alpha_matrix(
        np.full(b, srv._tier_index["balanced"]))
    for label, c in ((f"gather decode step (B={b}, {cfg.n_layers} layers, "
                      "bucket 288 groups)", srv._bucket_cfgs[288]),
                     (f"masked audit step (B={b}, {cfg.n_layers} layers)",
                      srv._audit_cfg)):
        profile_step(label, lambda c=c: lm.decode_step(
            srv.params, c, tok, caches, lengths, alphas=alphas,
            collect_stats=True))


def _overload_queue(vocab: int, tight: bool = True) -> list:
    """The overload phase's queue: 12 requests, tiers in turn, 40-150-token
    prompts, 16 new tokens each; with ``tight`` uid 7 has a deadline of 0.3
    virtual seconds (30 scheduler iterations)."""
    import numpy as np
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(13)
    plens = rng.integers(40, 151, size=12)
    tiers = ("latency", "balanced", "quality")
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=int(p)),
                    max_new=16, sla=tiers[i % 3],
                    deadline_s=0.3 if tight and i == 7 else 0.0)
            for i, p in enumerate(plens)]


def _overload_keys(rep: dict) -> dict:
    return {k: v for k, v in rep.items()
            if k in ("requests", "tokens", "completed", "shed", "shed_rate",
                     "preempted", "preemptions") or k.startswith("shed_")}


def _span_means_ms(trace: dict) -> dict:
    """Mean duration in ms of each phase of a trace_event document."""
    acc: dict = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] == "X":
            n, t = acc.get(ev["name"], (0, 0.0))
            acc[ev["name"]] = (n + 1, t + ev["dur"] / 1e3)
    return {k: round(t / n, 4) for k, (n, t) in sorted(acc.items())}


def phase_serve_overload(results: dict) -> None:
    """The overload handling and the metrics hub at full width and
    ``OVERLOAD_LAYERS`` layers: the masked
    strategy's bitwise bar under a 2x oversubscribed pool, deadlines,
    queue-depth shedding and injected faults, then the pallas serve with
    every sink, a decode fault and the reset."""
    import numpy as np
    import torch
    from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                          PagedKVConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime import faults as F
    from repro_torch.runtime.metrics import MetricsHub, validate_jsonl
    from repro_torch.runtime.server import (Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b").replace(
        n_layers=OVERLOAD_LAYERS)
    L = base.n_layers

    def model(strategy):
        return base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                            sparse=dataclasses.replace(
                                base.sparse, strategy=strategy, enabled=True,
                                sparse_prefill=True,
                                prefill_max_tokens=max(
                                    base.sparse.prefill_max_tokens,
                                    MAIN_CHUNK)))

    def scfg(**kw):
        return ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                           prefill_chunk=MAIN_CHUNK, **kw)

    def check_done(done, label, n):
        if len(done) != n or any(
                r.outcome not in ("completed", "shed")
                or (r.outcome == "shed" and not r.shed_reason)
                or (r.outcome == "completed" and (
                    len(r.out) != r.max_new
                    or not ((r.out >= 0) & (r.out < base.vocab)).all()))
                for r in done):
            fail(f"serve-overload {label}: a request ended "
                 f"{[(r.uid, r.outcome, r.shed_reason) for r in done]}")

    # ---- masked: the bitwise bar under pressure
    cfg = model("masked")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    ref = Server(lm, cfg, scfg(paged_kv=PagedKVConfig(block_size=PAGE_BLOCK)),
                 params, device="cuda")
    ref.attach_faults(F.FaultInjector(seed=0, virtual_clock=True))
    t1 = time.perf_counter()
    done = ref.serve(_overload_queue(cfg.vocab, tight=False))
    torch.cuda.synchronize()
    check_done(done, "unpressured", 12)
    want = {r.uid: r.out for r in done}
    print(f"[serve-overload] masked unpressured: {ref.kv_pool.n_blocks} "
          f"blocks, serve {time.perf_counter() - t1:.1f} s (init "
          f"{t1 - t0:.1f} s); {json.dumps(_overload_keys(throughput_report(done)))}",
          flush=True)
    del ref
    srv = Server(lm, cfg, scfg(
        paged_kv=PagedKVConfig(block_size=PAGE_BLOCK,
                               pool_blocks=OVERLOAD_POOL),
        preempt=True, max_queue_depth=11, default_deadline_s=100.0),
        params, device="cuda")
    fi = F.FaultInjector(seed=0, virtual_clock=True, tick_s=0.01)
    srv.attach_faults(fi)
    fi.arm("prefill", uid=2, times=1)
    pool_bytes = sum(t.numel() * t.element_size()
                     for layer in srv._pool["blocks"] for t in layer.values())
    t1 = time.perf_counter()
    done = srv.serve(_overload_queue(cfg.vocab))
    torch.cuda.synchronize()
    check_done(done, "pressured", 12)
    rep = throughput_report(done)
    st = srv.paged_stats()
    print(f"[serve-overload] masked pressured: pool {OVERLOAD_POOL} blocks "
          f"({pool_bytes / 2**20:.0f} MiB), serve "
          f"{time.perf_counter() - t1:.1f} s, decode steps "
          f"{srv.decode_steps}, prefill chunks {srv.prefill_chunks_run}; "
          f"throughput_report {json.dumps(_overload_keys(rep))}; "
          f"paged_stats {json.dumps(st)}", flush=True)
    print(f"[serve-overload] masked pressured outcomes "
          f"{sorted((r.uid, r.outcome, r.shed_reason, r.preemptions) for r in done)}",
          flush=True)
    reasons = {r.shed_reason for r in done if r.outcome == "shed"}
    if not ({"queue_depth", "deadline", "fault"} <= reasons
            and rep["preemptions"] >= 1):
        fail(f"serve-overload: shed reasons {reasons}, preemptions "
             f"{rep['preemptions']}: want queue_depth, deadline and fault "
             "sheds and a preemption")
    n_shed = sum(r.outcome == "shed" for r in done)
    if (st["preemptions"], st["shed"]) != (rep["preemptions"], n_shed) or \
            rep["completed"] + rep["shed"] != 12 or fi.fired["prefill"] != 1:
        fail(f"serve-overload: paged_stats {st} and throughput_report {rep} "
             "disagree with the requests")
    for r in done:
        if r.outcome == "completed" and not np.array_equal(r.out,
                                                          want[r.uid]):
            fail(f"serve-overload: uid {r.uid} emitted {r.out} under "
                 f"pressure, {want[r.uid]} unpressured")
    srv.kv_pool.check_invariants()
    print(f"[serve-overload] masked: {rep['completed']} completed requests "
          "bitwise the unpressured run's; pool invariants hold", flush=True)
    del srv, params
    torch.cuda.empty_cache()

    # ---- pallas (the main path's) with the controller and every sink
    cfg = model("pallas")
    out_dir = os.path.join(HERE, "build", "metrics")
    os.makedirs(out_dir, exist_ok=True)
    sinks = {k: os.path.join(out_dir, f"serve.{k}")
             for k in ("jsonl", "trace.json", "prom")}
    for path in sinks.values():
        if os.path.exists(path):
            os.remove(path)
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, scfg(
        paged_kv=PagedKVConfig(block_size=PAGE_BLOCK),
        controller=ControllerConfig(enabled=True, per_tier=True),
        metrics=MetricsConfig(enabled=True, jsonl_path=sinks["jsonl"],
                              trace=True, trace_path=sinks["trace.json"],
                              snapshot_path=sinks["prom"])),
        params, device="cuda")
    del params
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    done = srv.serve(_overload_queue(cfg.vocab, tight=False))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    check_done(done, "pallas", 12)
    steps, chunks = srv.decode_steps, srv.prefill_chunks_run
    want_l = {n: 0 for n in counts}
    want_l.update({"predict_group_margins": L * steps,
                   "fused_sparse_mlp": L * steps,
                   "paged_attention": L * steps,
                   "paged_kv_write": L * steps,
                   "predict_chunk_group_margins": L * chunks,
                   "fused_sparse_mlp_chunk": L * chunks})
    if steps == 0 or counts != want_l:
        fail(f"serve-overload pallas: launches {counts}, want {want_l}")
    hub = srv.metrics
    n_lines = validate_jsonl(sinks["jsonl"])
    with open(sinks["trace.json"]) as f:
        trace = json.load(f)
    with open(sinks["prom"]) as f:
        expo = f.read()
    families = ("tier_realized_density", "alpha", "layer_density",
                "kv_pool_pressure", "kv_pool_n_blocks", "latency_s",
                "decode_step_s", "requests_completed")
    missing = [n for n in families
               if f"# TYPE sparseinfer_{n} " not in expo]
    kinds = {e["kind"] for e in hub.events()}
    if missing or 'sparseinfer_latency_s{tier="balanced",quantile="0.95"}' \
            not in expo or not {"serve_start", "admit", "first_token",
                                "complete", "serve_end"} <= kinds:
        fail(f"serve-overload pallas: exposition lacks {missing} or events "
             f"{kinds} lack a kind")
    means = _span_means_ms(trace)
    first = {r.uid: r.out for r in done}
    rep = throughput_report(done)
    mrep = srv.metrics_report()
    print(f"[serve-overload] pallas + controller + metrics: serve "
          f"{serve_s:.1f} s, decode steps {steps}, prefill chunks {chunks}; "
          f"launches {counts}; throughput_report "
          f"{json.dumps(_overload_keys(rep))}", flush=True)
    print(f"[serve-overload] metrics_report: events {mrep['events']}, "
          f"trace events {mrep['trace_events']}, JSONL lines {n_lines}, "
          f"watchdog {json.dumps(mrep['watchdog'])}", flush=True)
    print(f"[serve-overload] span means (ms, host wall): "
          f"{json.dumps(means)}; p50/p95 latency "
          f"{rep['p50_latency_s']:.3f}/{rep['p95_latency_s']:.3f} s, "
          f"p50/p95 TTFT {rep['p50_ttft_s']:.3f}/{rep['p95_ttft_s']:.3f} s",
          flush=True)
    # a decode fault aborts the serve, and serve() resets the server
    fi = F.FaultInjector(seed=0)
    srv.attach_faults(fi)
    fi.arm("decode", after=3, times=1)
    try:
        srv.serve(_overload_queue(cfg.vocab)[:4])
        fail("serve-overload: the armed decode fault did not abort serve()")
    except F.InjectedFault:
        pass
    if srv.kv_pool.snapshot()["live_refs"] or srv.shed_count or \
            srv.preempt_count or srv.controller.state.steps:
        fail("serve-overload: reset() left state behind after the decode "
             "fault")
    # the same queue again with the hub off: bitwise the first serve, and
    # the first hub's watchdog (armed by its drain) sees no first use
    armed = hub.watchdog
    srv.faults = None
    srv.metrics = MetricsHub(MetricsConfig())
    done = srv.serve(_overload_queue(cfg.vocab, tight=False))
    torch.cuda.synchronize()
    check_done(done, "pallas metrics off", 12)
    for r in done:
        if not np.array_equal(r.out, first[r.uid]):
            fail(f"serve-overload: uid {r.uid} emitted {r.out} after the "
                 f"reset with the hub off, {first[r.uid]} before")
    wd = armed.report()
    if not wd["armed"] or wd["retraces_post_warmup"]:
        fail(f"serve-overload: watchdog {wd} after warmup")
    print(f"[serve-overload] after the decode fault and reset, the hub off: "
          f"12 requests bitwise the metrics-on serve; watchdog "
          f"{json.dumps(wd)}", flush=True)
    hub.close()
    del srv
    torch.cuda.empty_cache()


NEW_ARCHS = ("prosparse-llama2-13b", "qwen3-8b", "qwen1.5-32b", "granite-34b",
             "gemma2-2b")
# gemma2's window check: per-slot lengths on both sides of its window of
# 4096 and far past it, in a pool of 4608 positions a slot
WINDOW_LENS = (4095, 4096, 4097, 4500)
WINDOW_MAX_LEN = 4608


def _numpy_tree(cfg, seed: int) -> dict:
    """The reference's parameter tree for ``cfg`` (blocks stacked along a
    leading layer axis, float32 numpy leaves) drawn from seeded numpy
    generators at the reference's init scales: each leaf in 32 pieces, each
    piece from its own generator spawned from ``seed`` (so the draws do
    not depend on the number of threads that fill them).  The reference
    starts norm scales and QKV biases at zero; here they are drawn too
    (0.3 N(0, 1)), so qk-norm, the biases and the post-block norms act."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    seeds = np.random.SeedSequence(seed)
    d, n, k = cfg.d_model, cfg.n_layers, cfg.d_ff
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pool = ThreadPoolExecutor(os.cpu_count() or 1)

    def draw(shape, scale, parts=32):
        out = np.empty(shape, np.float32)
        flat = out.reshape(-1)
        cut = np.linspace(0, flat.size, parts + 1).astype(np.int64)

        def fill(i, ss):
            piece = flat[cut[i]:cut[i + 1]]
            np.random.default_rng(ss).standard_normal(out=piece,
                                                      dtype=np.float32)
            piece *= np.float32(scale)
        list(pool.map(fill, range(parts), seeds.spawn(parts)))
        return out

    def norm(width, layers=True):
        return {"scale": draw((n, width) if layers else (width,), 0.3)}
    attn = {"wq": draw((n, d, h * hd), d ** -0.5),
            "wk": draw((n, d, kvh * hd), d ** -0.5),
            "wv": draw((n, d, kvh * hd), d ** -0.5),
            "wo": draw((n, h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=draw((n, h * hd), 0.3), bk=draw((n, kvh * hd), 0.3),
                    bv=draw((n, kvh * hd), 0.3))
    if cfg.qk_norm:
        attn.update(q_norm=norm(hd), k_norm=norm(hd))
    mlp = {"wg_t": draw((n, k, d), d ** -0.5)}
    if cfg.gated_mlp:
        mlp["wu_t"] = draw((n, k, d), d ** -0.5)
    mlp["wd_t"] = draw((n, k, d), k ** -0.5)
    blocks = {"ln1": norm(d), "attn": attn, "ln2": norm(d), "mlp": mlp}
    if cfg.post_block_norm:
        blocks.update(ln1_post=norm(d), ln2_post=norm(d))
    tree = {"embed": {"table": draw((cfg.vocab_padded, d), d ** -0.5)},
            "final_norm": norm(d, layers=False), "blocks": blocks}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": draw((cfg.vocab_padded, d), d ** -0.5)}
    pool.shutdown()
    return tree


def _random_pool(cfg, n_blocks: int, kv_dtype, seed: int) -> list:
    """A seeded pool of stale random K/V, per layer, on the CPU: float
    values N(0, 1), or int8 values with bfloat16 scales in [0.005, 0.05]."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    shape = (n_blocks, PAGE_BLOCK, cfg.n_kv_heads, cfg.resolved_head_dim)
    out = []
    for _ in range(cfg.n_layers):
        if kv_dtype == torch.int8:
            layer = {n: torch.randint(-127, 128, shape, generator=gen,
                                      dtype=torch.int8) for n in ("k", "v")}
            layer.update({n: (torch.rand(shape[:3], generator=gen) * 0.045
                              + 0.005).to(torch.bfloat16)
                          for n in ("k_scale", "v_scale")})
        else:
            layer = {n: torch.randn(shape, generator=gen).to(kv_dtype)
                     for n in ("k", "v")}
        out.append(layer)
    return out


def _paged_forced(params, cfg, dev, pool, table, lens0, forced, alphas):
    """Teacher-forced decode steps against a copy of ``pool`` (per-layer
    CPU tensors) on ``dev``, the MLP stats on -> logits (steps, B, V) on
    the CPU."""
    import torch
    from repro_torch.models import lm
    pool = {"blocks": [{k: v.to(dev) for k, v in layer.items()}
                       for layer in pool]}
    tab = torch.as_tensor(table, device=dev)
    out = []
    with torch.inference_mode():
        for t in range(len(forced)):
            lg, pool, _ = lm.decode_step(
                params, cfg, torch.as_tensor(forced[t], device=dev), pool,
                torch.as_tensor(lens0 + t, device=dev), alphas=alphas,
                collect_stats=True, block_table=tab)
            out.append(lg.float().cpu())
    return torch.stack(out)


def _fragmented_table(rng, b: int, nbps: int):
    """A shuffled block table over 2 reserved blocks, b * nbps blocks of
    the slots and 3 spare; slots 0 and 1 share their first block."""
    import numpy as np
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    table[1, 0] = table[0, 0]
    return n, table.astype(np.int32)


def _gemma2_window(params, cfg) -> None:
    """gemma2's local layer on the model path with the window binding in
    the paged kernel: 2 decode steps at per-slot lengths 4095, 4096, 4097
    and 4500 on a float32 pool of seeded K/V, the kernel route on the card
    against the plain route on the CPU (``_hold``), launches exact.  Then,
    sparsity off (so no batch union couples the slots), the kernel route
    with the window against one with a window past every length: the slot
    at 4095 (all its keys inside the window) bitwise the same, the other
    three different."""
    import numpy as np
    import torch

    b, steps, L = len(WINDOW_LENS), 2, cfg.n_layers
    nbps = WINDOW_MAX_LEN // PAGE_BLOCK
    rng = np.random.default_rng(14)
    n, table = _fragmented_table(rng, b, nbps)
    pool = _random_pool(cfg, n, torch.float32, 14)
    lens0 = np.asarray(WINDOW_LENS)
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    alphas = cfg.sparse.alpha_schedule().alphas(L)
    kcfg = cfg.replace(kv_cache_dtype="float32", paged_attn_kernel=True)

    def run(run_cfg, steps_forced):
        return lambda dev: _paged_forced(params[dev], run_cfg, dev, pool,
                                         table, lens0, steps_forced, alphas)
    per = L * steps
    _hold(f"[archs] gemma2-2b window {cfg.window} at lengths "
          f"{list(WINDOW_LENS)} (+{steps - 1}), kernel route vs CPU",
          run(kcfg, forced), LOGIT_TOL["float32"],
          dict(predict_group_margins=per, fused_sparse_mlp=per,
               paged_attention=per, paged_kv_write=per))
    dense = kcfg.replace(sparse=dataclasses.replace(cfg.sparse,
                                                    enabled=False))
    outs = [run(c, forced[:1])("cuda")[0]
            for c in (dense, dense.replace(window=10 ** 9))]
    moved = (outs[0] - outs[1]).abs().amax(-1)
    print(f"[archs] gemma2-2b window vs none (sparsity off), logits max abs "
          f"diff per slot at lengths {list(WINDOW_LENS)}: "
          f"{[f'{float(v):.3e}' for v in moved]}", flush=True)
    if float(moved[0]) != 0.0 or not bool((moved[1:] > 0).all()):
        fail("archs gemma2 window: the window moved the slot with every key "
             "inside it, or left a slot with keys outside it unchanged")


def phase_archs() -> None:
    """The other dense archs at full width and 2 layers (gemma2: one local
    and one global layer), float32 compute, the config's own selection
    (capacity 20%: the clamp binds), weights bridged from seeded numpy
    draws to the CPU and copied to the card, each run card against CPU
    through ``_hold`` (every MLP call on the card's input, selections
    equal): 8 teacher-forced decode steps on the dense cache (float32,
    then the config's own KV dtype, then float32 with sparsity off: the
    arch's own silu or gelu) and on a fragmented float32 pool with the
    paged kernels (int8 configs also on an int8 pool, the gather route), a
    160-token chunked sparse prefill, and for gemma2 decode steps at
    lengths on both sides of its window."""
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    for i, arch in enumerate(NEW_ARCHS):
        t0 = time.perf_counter()
        base = get_config(arch)
        cfg = base.replace(n_layers=2, dtype="float32",
                           sparse=dataclasses.replace(
                               base.sparse, strategy="pallas", enabled=True))
        L, steps = cfg.n_layers, DEC_STEPS
        raw = bridge.params_from_numpy(_numpy_tree(cfg, 100 + i), cfg,
                                       device="cpu")
        params = {"cpu": lm.prepare_sparse(raw),
                  "cuda": lm.prepare_sparse(_to(raw, "cuda"))}
        del raw
        print(f"[archs] {arch}: d={cfg.d_model} H={cfg.n_heads} "
              f"K={cfg.n_kv_heads} hd={cfg.resolved_head_dim} k={cfg.d_ff} "
              f"vocab={cfg.vocab} {'gated' if cfg.gated_mlp else 'ungated'} "
              f"{cfg.activation}, KV {base.kv_cache_dtype}, windows "
              f"{lm._layer_windows(cfg)}, softcaps {cfg.attn_softcap}/"
              f"{cfg.final_softcap}, capacity "
              f"{cfg.sparse.capacity(cfg.d_ff)} of {cfg.d_ff // G} groups; "
              f"weights built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        sparse = dict(predict_group_margins=L * steps,
                      fused_sparse_mlp=L * steps)

        def decode(run_cfg):
            return lambda dev: _teacher_forced(params[dev], run_cfg, dev)
        for kv in dict.fromkeys(("float32", base.kv_cache_dtype)):
            _hold(f"[archs] {arch} decode, {kv} KV cache",
                  decode(cfg.replace(kv_cache_dtype=kv)), LOGIT_TOL[kv],
                  sparse)
        _hold(f"[archs] {arch} decode, sparsity off ({cfg.activation}), "
              "float32 KV cache", decode(cfg.replace(
                  kv_cache_dtype="float32", sparse=dataclasses.replace(
                      cfg.sparse, enabled=False))),
              LOGIT_TOL["float32"], {})
        rng = np.random.default_rng(12)
        n, table = _fragmented_table(rng, DEC_BATCH, 4)
        lens0 = np.asarray([20, 17, 33, 47])
        forced = rng.integers(0, cfg.vocab, size=(steps, DEC_BATCH, 1))
        alphas = cfg.sparse.alpha_schedule().alphas(L)[:, None] + \
            np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]
        pools = [("float32", True)]
        if base.kv_cache_dtype == "int8":
            pools.append(("int8", False))
        for kv, kernel_route in pools:
            run_cfg = cfg.replace(kv_cache_dtype=kv, paged_attn_kernel=True)
            pool = _random_pool(cfg, n, getattr(torch, kv), 12)
            paged = L * steps if kernel_route else 0
            _hold(f"[archs] {arch} paged decode, {kv} pool, "
                  f"{'kernel' if kernel_route else 'gather'} route",
                  lambda dev: _paged_forced(params[dev], run_cfg, dev, pool,
                                            table, lens0, forced, alphas),
                  LOGIT_TOL[kv], dict(paged_attention=paged,
                                      paged_kv_write=paged, **sparse))
        _prefill_chunks(
            f"[archs] {arch} chunked sparse prefill", params,
            cfg.replace(kv_cache_dtype=base.kv_cache_dtype,
                        sparse=dataclasses.replace(cfg.sparse,
                                                   sparse_prefill=True)),
            160, 5, 256,
            ("predict_chunk_group_margins", "fused_sparse_mlp_chunk"))
        if cfg.window:
            _gemma2_window(params, cfg)
        del params
        torch.cuda.empty_cache()
        print(f"[archs] {arch}: {time.perf_counter() - t0:.1f} s", flush=True)


def _served_mlp_checks(name: str, d: int, k: int, gated: bool, cap: int,
                       gen) -> tuple:
    """A sparse MLP call's kernels at one arch's served widths against
    their plain versions, bf16 x, float32 weights, G=8: sign_pack of the
    gate weights (at load) and of x, bitwise; predict_chunk_group_margins
    at S=64 (pad rows at the end) and predict_group_margins at B=4,
    bitwise; fused_sparse_mlp_chunk and fused_sparse_mlp over the
    selection at the arch's capacity ``cap`` within phase 2's 2e-3 x
    max|y| (h rounded to bf16), twice bitwise equal and equal with and
    without telemetry, the telemetry as phase 2 holds it.  Returns (wg,
    wu, wd, x, selection, max abs err) of the B=4 call."""
    import torch
    from repro_torch.core import selection as S
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    wg = torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
    wu = (torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
          if gated else None)
    wd = torch.randn((k, d), generator=gen, device=dev) * k ** -0.5
    sign_wg = KS.sign_pack(wg)
    if not torch.equal(sign_wg, ref.sign_pack_ref(wg)):
        fail(f"sign_pack {name} gate weights ({k} x {d}): differs from its "
             "plain version")
    for rows, chunk in ((MAIN_CHUNK, True), (MAIN_BATCH, False)):
        tag = (f"{name} shape {'S' if chunk else 'B'}={rows} d={d} k={k} "
               f"{'gated' if gated else 'ungated'} x=bfloat16")
        x = torch.randn((rows, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        alpha = _chunk_alphas(rows, dev) if chunk else \
            torch.linspace(0.9, 1.1, rows, device=dev)
        if not torch.equal(KS.sign_pack(x), ref.sign_pack_ref(x)):
            fail(f"sign_pack {tag}: differs from its plain version")
        pred = "predict_chunk_group_margins" if chunk \
            else "predict_group_margins"
        mlp = "fused_sparse_mlp_chunk" if chunk else "fused_sparse_mlp"
        gm, cnt = getattr(KP, pred)(sign_wg, x, alpha, d_valid=d,
                                    group_size=G)
        # one plain version serves both: a row's math is the same
        gm_r, cnt_r = ref.predict_group_margins_ref(sign_wg, x, d, alpha, G)
        torch.cuda.synchronize()
        if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
            fail(f"{pred} {tag}: differs from its plain version")
        sel, sst = S.capacity_select_with_stats(S.union_margin(gm), cap)
        count = int(sel.count)
        args = (x, wg, wu, wd, sel.indices, sel.count)
        y, tel = getattr(KF, mlp)(*args, gm, group_size=G,
                                  collect_stats=True)
        y0 = _same_twice(f"{tag} without telemetry",
                         lambda: getattr(KF, mlp)(*args, group_size=G),
                         name=mlp)
        y_r, tel_r = ref.fused_sparse_mlp_stats_ref(*args, gm, group_size=G,
                                                   collect_stats=True)
        torch.cuda.synchronize()
        scale = float(y_r.abs().max()) or 1.0
        err = float((y - y_r).abs().max())
        if err > 2e-3 * scale or not torch.equal(y, y0):
            fail(f"{mlp} {tag}: max abs err {err:.3e} > 2e-3 x max|y| "
                 f"{scale:.3e}, or y differs with/without telemetry")
        _check_telemetry(tel, tel_r, x, wg, sel.indices, count, tag)
        print(f"[arch-kernels] {tag}: sign_pack (x and the gate weights) "
              f"and {pred} bitwise; {mlp} over {count} of {cap} groups "
              f"({int(sst.predicted)} predicted active) max_abs_err "
              f"{err:.3e} (tolerance {2e-3 * scale:.3e}), bitwise "
              "repeatable, telemetry held", flush=True)
    return wg, wu, wd, x, sel, err


def _served_attention(label: str, name: str, cfg, gen, rng, flush):
    """The paged attention (twice bitwise) and the paired KV write (twice
    bitwise) against their plain versions at ``cfg``'s attention shape,
    B=4, a bf16 pool, the main lengths; the attention timed beside its
    bound, plain version and SDPA.  Returns (kp, vp, table, lengths, the
    written K and V)."""
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    b, nbps = MAIN_BATCH, PAGED_NBPS[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(softcap=cfg.attn_softcap, window=cfg.window)
    q, kp, vp, table, lengths = _paged_inputs(
        gen, rng, b, h, kvh, hd, PAGE_BLOCK, nbps, torch.bfloat16,
        torch.bfloat16, lengths=MAIN_LIVE)
    tag = f"{name} shape B={b} H={h} K={kvh} hd={hd}"
    err = _check_attention(
        tag, _same_twice(tag, lambda: KA.paged_attention(
            q, kp, vp, table, lengths, **kw)),
        ref.paged_attention_ref(q, kp, vp, table, lengths, **kw), vp)
    kv_new = [torch.randn((b, kvh, hd), generator=gen,
                          device=q.device).to(torch.bfloat16)
              for _ in range(2)]
    wk, wv = kp.clone(), vp.clone()
    ref.paged_kv_write_pair_ref(wk, wv, *kv_new, table, lengths)
    for run in range(2):
        gk, gv = kp.clone(), vp.clone()
        KA.paged_kv_write_pair(gk, gv, *kv_new, table, lengths)
        torch.cuda.synchronize()
        if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
            fail(f"paged_kv_write pair {tag} bf16 pool (run {run}): "
                 "differs from two plain writes")
    del wk, wv, gk, gv
    t_k, t_p, t_lib, t_gl = _time_attention(
        q, kp, vp, table, lengths, flush, plain_iters=10, **kw)
    live, bound = _attention_bound(lengths, b, h, kvh, hd, nbps, 2)
    print(f"[{label}] paged_attention {tag} softcap={kw['softcap']}"
          f" window={kw['window']} bf16 lengths {list(MAIN_LIVE)} ({live}"
          f" live rows; {KA.launch_plan(q, kp, table)}): max_abs_err "
          f"{err:.3e}, bitwise repeatable; kernel {t_k:.4f} ms plain "
          f"{t_p:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}; share "
          f"{bound[0] / t_k:.3f}) sdpa-on-gathered-view {t_lib:.4f} ms "
          f"gather+sdpa {t_gl:.4f} ms"
          f"{' (no softcap: SDPA has none)' if kw['softcap'] else ''}; "
          f"paged_kv_write pair bitwise twice", flush=True)
    return kp, vp, table, lengths, kv_new


def _served_mlp_time(label: str, name: str, checked: tuple, k: int,
                     cap: int, flush) -> None:
    """The float32 decode MLP at B=4 on ``checked`` (the B=4 call of
    ``_served_mlp_checks``) timed beside its bound, plain version and the
    matmuls on the selected rows gathered beforehand."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_mlp_fused as KF

    wg, wu, wd, x, sel, err = checked
    b, d = x.shape
    gated = wu is not None
    count = int(sel.count)
    t_k = cuda_ms(lambda: KF.fused_sparse_mlp(
        x, wg, wu, wd, sel.indices, sel.count, group_size=G), flush=flush)
    t_p = cuda_ms(lambda: ref.fused_sparse_mlp_ref(
        x, wg, wu, wd, sel.indices, sel.count, group_size=G), flush=flush)
    rows = sel.indices[:count].long()
    take = [m.reshape(k // G, G, d)[rows].reshape(-1, d).contiguous()
            for m in (wg, wu, wd) if m is not None]
    xf = x.float()
    if gated:
        lib = lambda: (torch.relu(xf @ take[0].T)  # noqa: E731
                       * (xf @ take[1].T)) @ take[2]
    else:
        lib = lambda: torch.relu(xf @ take[0].T) @ take[1]  # noqa: E731
    t_lib = cuda_ms(lib, flush=flush)
    n_mats = 3 if gated else 2
    bound = bound_ms(n_mats * count * G * d * 4 + b * d * 2 + cap * 4
                     + b * d * 4, 2 * n_mats * b * count * G * d)
    print(f"[{label}] fused_sparse_mlp {name} shape B={b} d={d} k={k} "
          f"{'gated' if gated else 'ungated'} x=bfloat16 count={count}/"
          f"{cap}: max_abs_err {err:.3e}; kernel {t_k:.4f} ms plain "
          f"{t_p:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}; share "
          f"{bound[0] / t_k:.3f}) gathered-rows-{n_mats}-matmul "
          f"{t_lib:.4f} ms", flush=True)


def phase_arch_kernel_times() -> None:
    """The kernels at the shapes the new archs bring, against their plain
    versions: a sparse MLP call's five (``_served_mlp_checks``) at
    gemma2-2b's served widths (d=2304, k=9216), granite-34b's ungated
    d=6144, k=24576 and qwen1.5-32b's d=5120, k=27392, each at its
    config's capacity, the decode MLP timed at B=4; the paged attention
    and the paired KV write (bitwise, twice) into a bf16 pool at gemma2's
    shape (H=8, K=4, hd 256, softcap 50, window 4096) and granite's (H=48,
    K=1: MQA), B=4, the main lengths, the attention timed.  Each time
    beside its bound, the plain version and a library yardstick."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    for name in ("gemma2-2b", "granite-34b"):
        pool = _served_attention("arch-kernels", name, get_config(name),
                                 gen, rng, flush)
        del pool
    for name in ("gemma2-2b", "granite-34b", "qwen1.5-32b"):
        cfg = get_config(name)
        cap = cfg.sparse.capacity(cfg.d_ff)
        checked = _served_mlp_checks(name, cfg.d_model, cfg.d_ff,
                                     cfg.gated_mlp, cap, gen)
        _served_mlp_time("arch-kernels", name, checked, cfg.d_ff, cap, flush)
        del checked
    del flush_buf
    torch.cuda.empty_cache()


def phase_serve_gemma2() -> None:
    """gemma2-2b at full width and all 26 layers (about 10.5 GB of float32
    weights, bf16 compute) through Server.serve: bf16 paged pool, block
    16, the paged kernels, chunked sparse prefill in chunks of 64,
    strategy pallas, batch 4, 8 requests of mixed tiers with 96-192-token
    prompts and 16 new tokens each; launches exact; one profiled paged
    decode step."""
    import numpy as np
    import torch
    from repro_torch.configs.base import PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("gemma2-2b")
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=dataclasses.replace(
                           base.sparse, strategy="pallas", enabled=True,
                           sparse_prefill=True,
                           prefill_max_tokens=max(
                               base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK,
                       paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    srv = Server(lm, cfg, scfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    print(f"[serve-gemma2] {cfg.n_layers} layers (windows "
          f"{lm._windows(cfg)} alternating), d={cfg.d_model}, "
          f"hd={cfg.resolved_head_dim}, weights {n_bytes / 1e9:.2f} GB "
          f"{cfg.param_dtype}, compute {cfg.dtype}, {cfg.kv_cache_dtype} "
          f"pool of {srv.kv_pool.n_blocks} blocks; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(25)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(96, 193))),
                max_new=16, sla=tiers[i % 3]) for i in range(8)]
    L = cfg.n_layers
    ops.reset_launch_counts()
    steps0, run0 = srv.decode_steps, srv.prefill_chunks_run
    t1 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    chunks = srv.prefill_chunks_run - run0
    if len(done) != len(reqs) or any(
            r.outcome != "completed" or len(r.out) != 16
            or not ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done):
        fail("serve-gemma2: not every request completed with 16 valid "
             "tokens")
    n_chunks = sum(-(-len(r.prompt) // MAIN_CHUNK) for r in reqs)
    want = _want_launches(counts, predict_group_margins=L * steps,
                          fused_sparse_mlp=L * steps,
                          paged_attention=L * steps,
                          paged_kv_write=L * steps,
                          predict_chunk_group_margins=L * chunks,
                          fused_sparse_mlp_chunk=L * chunks)
    if steps == 0 or counts != want or chunks != n_chunks:
        fail(f"serve-gemma2: launches {counts}, want {want} ({steps} decode "
             f"steps, {chunks} of {n_chunks} chunks)")
    rep = throughput_report(done)
    print(f"[serve-gemma2] throughput_report {json.dumps(rep)}", flush=True)
    print(f"[serve-gemma2] {wall:.1f} s; decode steps {steps}; prefill "
          f"chunks {chunks}; launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_paged_decode(srv, cfg)
    del srv
    torch.cuda.empty_cache()


# ------------------------------------------------------- phase 16: sharded --

SHARD_GRIDS = ((2, 2), (1, 4))          # (dp_shards, tp_shards) of (b)
SHARD_SERVE_LAYERS = 16   # (c): a cut of the 7b's 32 layers


def _shard_kernel_cases(results: dict, gen, flush) -> None:
    """(a): the kernels of a sharded MLP call at shard-local widths against
    their plain versions, on one shard's row views of the full weights
    (the last shard: the largest offset)."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    sign_wg = KS.sign_pack(wg)
    cap = SparseInferConfig().capacity(K)
    for ms in (2, 4):
        k_l, cap_l = K // ms, cap // ms
        s = ms - 1
        rows = slice(s * k_l, (s + 1) * k_l)
        sign_l, wg_l, wu_l, wd_l = (t[rows] for t in (sign_wg, wg, wu, wd))
        if wg_l.data_ptr() != wg.data_ptr() + s * k_l * D * 4:
            fail("sharded: a shard's weight rows are not a view")
        for b in (2, 4):
            tag = f"k_l={k_l} C_l={cap_l} B={b} x=bfloat16 (shard {s}/{ms})"
            x = torch.randn((b, D), generator=gen,
                            device=dev).to(torch.bfloat16)
            alpha = torch.linspace(0.95, 1.05, b, device=dev)
            gm, cnt = KP.predict_group_margins(sign_l, x, alpha, d_valid=D,
                                               group_size=G)
            gm2, _ = KP.predict_group_margins(sign_l, x, alpha, d_valid=D,
                                              group_size=G)
            gm_r, cnt_r = ref.predict_group_margins_ref(sign_l, x, D, alpha,
                                                        G)
            torch.cuda.synchronize()
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)
                    and torch.equal(gm, gm2)):
                fail(f"predict_group_margins {tag}: differs from its plain "
                     "version or between two runs")
            sel, sst = S.capacity_select_with_stats(S.union_margin(gm),
                                                    cap_l)
            count = int(sel.count)
            args = (x, wg_l, wu_l, wd_l, sel.indices, sel.count)
            y, tel = KF.fused_sparse_mlp(*args, gm, group_size=G,
                                         collect_stats=True)
            y0 = _same_twice(f"{tag} without telemetry",
                             lambda: KF.fused_sparse_mlp(*args,
                                                         group_size=G),
                             name="fused_sparse_mlp")
            y_r, tel_r = ref.fused_sparse_mlp_stats_ref(
                *args, gm, group_size=G, collect_stats=True)
            torch.cuda.synchronize()
            scale = float(y_r.abs().max()) or 1.0
            err = float((y - y_r).abs().max())
            if err > 2e-3 * scale or not torch.equal(y, y0):
                fail(f"fused_sparse_mlp {tag}: max abs err {err:.3e} > 2e-3"
                     f" x max|y| {scale:.3e}, or y differs with/without "
                     "telemetry")
            _check_telemetry(tel, tel_r, x, wg_l, sel.indices, count, tag)
            print(f"[sharded] {tag}: predict_group_margins bitwise, twice; "
                  f"fused_sparse_mlp over {count} of {cap_l} groups "
                  f"({int(sst.predicted)} predicted active) max_abs_err "
                  f"{err:.3e} (tolerance {2e-3 * scale:.3e}), bitwise "
                  "repeatable, telemetry held", flush=True)
            if b != MAIN_BATCH:
                continue
            # ---- times at B=4: the shard's launch, then all ms shards'
            # launches against the one unsharded launch of the same work
            t_pred = cuda_ms(lambda: KP.predict_group_margins(
                sign_l, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_pred_plain = cuda_ms(lambda: ref.predict_group_margins_ref(
                sign_l, x, D, alpha, G), iters=5, flush=flush)
            pw = predict_work(b, 2, k=k_l)
            p_bound = (max(pw[0], pw[1]),
                       "bytes" if pw[0] >= pw[1] else "operations")
            t_mlp = cuda_ms(lambda: KF.fused_sparse_mlp(*args, group_size=G),
                            flush=flush)
            t_mlp_plain = cuda_ms(lambda: ref.fused_sparse_mlp_ref(
                *args, group_size=G), flush=flush)
            take = [m.reshape(k_l // G, G, D)[sel.indices[:count].long()]
                    .reshape(-1, D).contiguous() for m in (wg_l, wu_l, wd_l)]
            xf = x.float()
            t_lib = cuda_ms(lambda: (torch.relu(xf @ take[0].T)
                                     * (xf @ take[1].T)) @ take[2],
                            flush=flush)
            del take
            m_bound = bound_ms(3 * count * G * D * 4 + b * D * 2
                               + cap_l * 4 + b * D * 4,
                               6 * b * count * G * D)
            shards = [(sign_wg[i * k_l:(i + 1) * k_l], wg[i * k_l:(i + 1)
                       * k_l], wu[i * k_l:(i + 1) * k_l],
                       wd[i * k_l:(i + 1) * k_l]) for i in range(ms)]
            sels = [S.capacity_select(S.union_margin(KP.predict_group_margins(
                sh[0], x, alpha, d_valid=D, group_size=G)[0]), cap_l)
                for sh in shards]
            t_pred_all = cuda_ms(lambda: [KP.predict_group_margins(
                sh[0], x, alpha, d_valid=D, group_size=G) for sh in shards],
                flush=flush)
            t_pred_one = cuda_ms(lambda: KP.predict_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_mlp_all = cuda_ms(lambda: [KF.fused_sparse_mlp(
                x, *sh[1:], sl.indices, sl.count, group_size=G)
                for sh, sl in zip(shards, sels)], flush=flush)
            sel1 = S.capacity_select(S.union_margin(KP.predict_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G)[0]), cap)
            t_mlp_one = cuda_ms(lambda: KF.fused_sparse_mlp(
                x, wg, wu, wd, sel1.indices, sel1.count, group_size=G),
                flush=flush)
            n_sel = sum(int(sl.count) for sl in sels)
            print(f"[sharded] predict_group_margins k_l={k_l} B={b} "
                  f"x=bfloat16: max_abs_err 0 (bitwise) kernel "
                  f"{t_pred:.4f} ms plain {t_pred_plain:.4f} ms bound "
                  f"{p_bound[0]:.4f} ms ({p_bound[1]}; share "
                  f"{p_bound[0] / t_pred:.3f}); the {ms} shards' launches "
                  f"{t_pred_all:.4f} ms against one unsharded launch (k="
                  f"{K}) {t_pred_one:.4f} ms", flush=True)
            print(f"[sharded] fused_sparse_mlp k_l={k_l} B={b} x=bfloat16 "
                  f"count={count}/{cap_l}: max_abs_err {err:.3e} kernel "
                  f"{t_mlp:.4f} ms plain {t_mlp_plain:.4f} ms bound "
                  f"{m_bound[0]:.4f} ms ({m_bound[1]}; share "
                  f"{m_bound[0] / t_mlp:.3f}) gathered-rows-3-matmul "
                  f"{t_lib:.4f} ms; the {ms} shards' launches ({n_sel} "
                  f"groups) {t_mlp_all:.4f} ms against one unsharded launch "
                  f"({int(sel1.count)} of {cap} groups) {t_mlp_one:.4f} ms",
                  flush=True)
            results[f"sharded_1_ms{ms}"] = dict(
                ms=t_pred, plain_ms=t_pred_plain, bound_ms=p_bound[0],
                all_ms=t_pred_all, one_ms=t_pred_one)
            results[f"sharded_2_ms{ms}"] = dict(
                ms=t_mlp, plain_ms=t_mlp_plain, bound_ms=m_bound[0],
                library_ms=t_lib, all_ms=t_mlp_all, one_ms=t_mlp_one)
            if ms == 2:
                results["sharded_case"] = (x, alpha, sel, gm)
    # ---- #5: the int8 fused MLP at k_l=5504, qg=128, on shard 1's views
    k_l, cap_l = K // 2, cap // 2
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    q_l = [qn[n][k_l * qn[n].shape[0] // K:] for n in QNAMES]
    x, alpha, sel, gm = results.pop("sharded_case")
    tag = f"k_l={k_l} C_l={cap_l} qg={QG} B={MAIN_BATCH} x=bfloat16 " \
          "(shard 1/2)"
    y, tel = KF.fused_sparse_mlp_q(x, *q_l, sel.indices, sel.count, gm,
                                   group_size=G, collect_stats=True)
    y0 = _same_twice(tag, lambda: KF.fused_sparse_mlp_q(
        x, *q_l, sel.indices, sel.count, group_size=G),
        name="fused_sparse_mlp_q")
    y_r, tel_r = ref.fused_sparse_mlp_q_ref(x, *q_l, sel.indices, sel.count,
                                            gm, group_size=G,
                                            collect_stats=True)
    torch.cuda.synchronize()
    scale = float(y_r.abs().max()) or 1.0
    err = float((y - y_r).abs().max())
    if err > 2e-3 * scale or not torch.equal(y, y0):
        fail(f"fused_sparse_mlp_q {tag}: max abs err {err:.3e} > 2e-3 x "
             f"max|y| {scale:.3e}, or y differs with/without telemetry")
    wg_view = Q.dense_view({n: t for n, t in zip(QNAMES, q_l)})["wg_t"]
    _check_telemetry(tel, tel_r, x, wg_view, sel.indices, int(sel.count),
                     tag)
    count = int(sel.count)
    t_q = cuda_ms(lambda: KF.fused_sparse_mlp_q(
        x, *q_l, sel.indices, sel.count, group_size=G), flush=flush)
    t_q_plain = cuda_ms(lambda: ref.fused_sparse_mlp_q_ref(
        x, *q_l, sel.indices, sel.count, group_size=G), iters=5, flush=flush)
    n_bytes, flops = chunk_q_work(MAIN_BATCH, count, cap_l, 2,
                                  sel.indices[:count].long())[:2]
    q_bound = bound_ms(n_bytes, flops)
    print(f"[sharded] fused_sparse_mlp_q {tag} count={count}/{cap_l}: "
          f"max_abs_err {err:.3e} (tolerance {2e-3 * scale:.3e}), bitwise "
          f"repeatable, telemetry held; kernel {t_q:.4f} ms plain "
          f"{t_q_plain:.4f} ms bound {q_bound[0]:.4f} ms ({q_bound[1]}; "
          f"share {q_bound[0] / t_q:.3f}); no library call takes int8 "
          "weights with group scales", flush=True)
    results["sharded_5"] = dict(ms=t_q, plain_ms=t_q_plain,
                                bound_ms=q_bound[0])
    del qn, q_l
    # ---- #10: the counts kernel at k_l=5504, B=2
    sign_l = sign_wg[k_l:]
    xs = KS.sign_pack(torch.randn((2, D), generator=gen,
                                  device=dev).to(torch.bfloat16))
    c = _same_twice("k_l=5504 B=2", lambda: KP.predict_counts(sign_l, xs),
                    name="predict_counts")
    if not torch.equal(c, ref.predict_counts_ref(sign_l, xs)):
        fail("predict_counts k_l=5504 B=2: differs from its plain version")
    t_c = cuda_ms(lambda: KP.predict_counts(sign_l, xs), flush=flush)
    t_c_plain = cuda_ms(lambda: ref.predict_counts_ref(sign_l, xs), iters=5,
                        flush=flush)
    cw = predict_work(2, 4, k=k_l, counts=True)
    c_bound = (max(cw[0], cw[1]), "bytes" if cw[0] >= cw[1] else
               "operations")
    print(f"[sharded] predict_counts k_l={k_l} B=2: bitwise, twice; kernel "
          f"{t_c:.4f} ms plain {t_c_plain:.4f} ms bound {c_bound[0]:.4f} ms "
          f"({c_bound[1]}; share {c_bound[0] / t_c:.3f})", flush=True)
    results["sharded_10"] = dict(ms=t_c, plain_ms=t_c_plain,
                                 bound_ms=c_bound[0])
    del wg, wu, wd, sign_wg


def _shard_layers() -> None:
    """(b): two full-width float32 layers, 8 teacher-forced decode steps,
    card against CPU through ``_hold`` (selections equal, riders and stats
    held as the selection stats), launches exact: ds * ms launches of each
    tile kernel per layer and step, x's sign pack once a data block."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg0 = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    raw = lm.init_lm(cfg0, 0, "cuda")
    L, n = cfg0.n_layers, cfg0.n_layers * DEC_STEPS
    cases = []
    for ds, ms in SHARD_GRIDS:
        for strategy in ("masked", "gather", "pallas"):
            cases.append((strategy, ds, ms, {}))
    cases.append(("pallas", 1, 2, {"weight_dtype": "int8",
                                   "quant_group_size": QG}))
    cases.append(("pallas", 2, 2, {"shard_bucket_caps": (72, 144),
                                   "capacity_override": 288}))
    cases.append(("gather", 2, 2, {"shard_bucket_caps": (144, 72),
                                   "capacity_override": 288}))
    for strategy, ds, ms, extra in cases:
        sp = dataclasses.replace(base.sparse, strategy=strategy,
                                 enabled=True, tp_shards=ms,
                                 dp_shards=ds if ds > 1 else 0, **extra)
        cfg = cfg0.replace(sparse=sp)
        params = {"cuda": lm.prepare_sparse(raw, sp)}
        params["cpu"] = _to(params["cuda"], "cpu")
        tiles = n * ds * ms
        if strategy == "pallas":
            mlp = ("fused_sparse_mlp_q" if extra.get("weight_dtype")
                   else "fused_sparse_mlp")
            want = {"predict_group_margins": tiles, mlp: tiles}
        else:
            want = {"sign_pack": n * ds, "predict_counts": tiles}
        label = ", ".join(f"{k}={v}" for k, v in extra.items()
                          if k != "quant_group_size")
        _hold(f"[sharded] {strategy} ds={ds} ms={ms}"
              f"{', ' + label if label else ''}",
              lambda dev: _teacher_forced(params[dev], cfg, dev),
              LOGIT_TOL["float32"], want)
        del params
    del raw
    torch.cuda.empty_cache()


def _shard_serve(results: dict) -> None:
    """(c): ``SHARD_SERVE_LAYERS`` layers, tp_shards=2, dp_shards=2, batch
    4, 8 requests of mixed tiers, strategy pallas, the per-tier controller over the
    CTRL_BUCKETS ladder (9 bucket tuples, warmed), a bf16 paged pool of
    16-token blocks, chunks of 64 (the sharded prefill runs dense)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig, PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b").replace(
        n_layers=SHARD_SERVE_LAYERS)
    sp = dataclasses.replace(base.sparse, strategy="pallas", enabled=True,
                             sparse_prefill=True, tp_shards=2, dp_shards=2,
                             capacity_buckets=CTRL_BUCKETS)
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=sp)
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK, warm_buckets=True,
                       paged_kv=PagedKVConfig(block_size=PAGE_BLOCK),
                       controller=ControllerConfig(enabled=True,
                                                   per_tier=True))
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    ops.reset_launch_counts()
    srv = Server(lm, cfg, scfg, params, device="cuda")
    del params
    rng = np.random.default_rng(26)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(64, 129))),
                max_new=16, sla=tiers[i % 3]) for i in range(8)]
    t1 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    steps, warm = srv.decode_steps, srv.warmup_steps
    ctl, L = srv.controller, cfg.n_layers
    if len(done) != 8 or any(
            r.outcome != "completed" or len(r.out) != 16
            or not ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done):
        fail("sharded serve: not every request completed with 16 valid "
             "tokens")
    tiles = L * (steps + warm) * 4
    want = _want_launches(counts, sign_pack=L, predict_group_margins=tiles,
                          fused_sparse_mlp=tiles,
                          paged_attention=L * (steps + warm),
                          paged_kv_write=L * (steps + warm))
    if steps == 0 or counts != want:
        fail(f"sharded serve: launches {counts}, want {want} ({steps} "
             f"decode steps + {warm} warmup, 4 tiles a sparse MLP)")
    n_tuples = len(srv._bucket_cfgs)
    if n_tuples != 9 or warm != 9 or set(srv._trace_counts.values()) != {1}:
        fail(f"sharded serve: {n_tuples} bucket tuples, {warm} warmup "
             f"steps, setups {dict(srv._trace_counts)}; want 9, 9, all 1")
    print(f"[sharded] serve ds=2 ms=2: init {t1 - t0:.1f} s, serve "
          f"{wall:.1f} s; throughput_report "
          f"{json.dumps(throughput_report(done))}", flush=True)
    print(f"[sharded] serve: decode steps {steps} (+{warm} warmup), "
          f"prefill chunks {srv.prefill_chunks_run} (dense); launches "
          f"{counts}", flush=True)
    print(f"[sharded] serve: local ladder {list(srv._local_ladder)}, "
          f"bucket tuples {sorted(srv._bucket_cfgs)}; sequence "
          f"{list(srv.bucket_history)}", flush=True)
    print(f"[sharded] serve: shard_skew {json.dumps(ctl.shard_skew())}",
          flush=True)
    # random weights hold every shard's union demand near 1: a forced
    # per-shard estimate must pick a rung per shard (slack 1.3 of the
    # 5504 local rows, in groups: 0.05 -> 45 -> 72, 0.15 -> 135 -> 144,
    # 0.9 -> 688 -> 280)
    held = ctl.shard_union_ema
    picks = {}
    for pair in ((0.05, 0.9), (0.15, 0.05), (0.9, 0.9)):
        ctl.shard_union_ema = np.tile(np.asarray(pair, np.float32), (L, 1))
        picks[pair] = srv._select_bucket()
    ctl.shard_union_ema = held
    print(f"[sharded] serve: forced per-shard union demand -> bucket tuple "
          f"{picks}", flush=True)
    if list(picks.values()) != [(72, 280), (144, 72), (280, 280)]:
        fail(f"sharded serve: forced demands picked {picks}")
    srv.kv_pool.check_invariants()
    # one paged decode step at the widest tuple, and the unsharded step of
    # the same serve shape (capacity 560 = 2 x 280)
    b, nbps = MAIN_BATCH, srv._nbps
    pool = lm.init_kv_pool(cfg, b * nbps + 2, PAGE_BLOCK, "cuda")
    table = (torch.arange(b * nbps, dtype=torch.int32, device="cuda")
             + 2).reshape(b, nbps)
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    alphas = srv._slot_alpha_matrix(np.full(b, srv._tier_index["balanced"]))
    flat = cfg.replace(sparse=dataclasses.replace(
        sp, tp_shards=0, dp_shards=0, capacity_override=560))
    for label, c in (("sharded ds=2 ms=2, bucket (280, 280)",
                      srv._bucket_cfgs[(280, 280)]),
                     ("unsharded, capacity 560", flat)):
        profile_step(f"paged decode step (B={b}, {L} layers, bf16 pool, "
                     f"{label}, telemetry on)",
                     lambda c=c: lm.decode_step(
                         srv.params, c, tok, pool, lengths, alphas=alphas,
                         collect_stats=True, block_table=table))
    del srv, pool
    torch.cuda.empty_cache()


def _shard_rejections() -> None:
    """(d): int8 weights at tp_shards=4 (2752 rows a shard: 21.5 quant
    groups of 128) raise at Server construction; the ms=4 ladder (81
    tuples > bucket_tuple_cap 16) warns and keeps the 3 uniform ones."""
    import warnings
    import torch
    from repro_torch.configs.base import ControllerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(n_layers=2)
    params = lm.init_lm(cfg, 0, "cuda")
    bad = cfg.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True, tp_shards=4,
        weight_dtype="int8", quant_group_size=QG))
    try:
        Server(lm, bad, ServeConfig(batch=MAIN_BATCH), params, device="cuda")
        fail("sharded: int8 at tp_shards=4 built a Server")
    except ValueError as e:
        print(f"[sharded] int8 at tp_shards=4 rejected at construction: {e}",
              flush=True)
    ladder = cfg.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True, tp_shards=4,
        capacity_buckets=CTRL_BUCKETS))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        srv = Server(lm, ladder, ServeConfig(
            batch=MAIN_BATCH, controller=ControllerConfig(enabled=True)),
            params, device="cuda")
    msgs = [str(w.message) for w in rec if "bucket_tuple_cap" in
            str(w.message)]
    keys = sorted(srv._bucket_cfgs)
    print(f"[sharded] ms=4 ladder: warnings {msgs}; bucket tuples {keys}",
          flush=True)
    if len(msgs) != 1 or keys != [(36,) * 4, (72,) * 4, (140,) * 4]:
        fail(f"sharded: the ms=4 ladder gave {keys} with warnings {msgs}")
    del srv, params
    torch.cuda.empty_cache()


def phase_sharded(results: dict) -> None:
    """Sharded sparse decode (tp_shards/dp_shards) on the card: (a) the
    kernels at shard-local widths, (b) two full-width layers card against
    CPU, (c) a full-depth sharded serve, (d) the rejections."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for step, fn in (("a", lambda: _shard_kernel_cases(
            results, gen, flush_buf.zero_)), ("b", _shard_layers),
            ("c", lambda: _shard_serve(results)), ("d", _shard_rejections)):
        t = time.perf_counter()
        fn()
        print(f"[sharded] ({step}) {time.perf_counter() - t:.1f} s",
              flush=True)
    del flush_buf
    torch.cuda.empty_cache()


MESH_DEVICE = "cuda"       # the card (a rehearsal on the CPU sets "cpu")
MESH_REQUESTS = 4          # one request a slot: four batch-1 prefills
MESH_MAX_NEW = 16
MESH_LAYERS = 16           # (a): half the model's 32 layers
MESH_LAYERS_2D = 8         # (b)


def _crossing_session(scfg, vocab: int, seed: int) -> tuple:
    """``_mesh_session``'s (serve config, turn 1, tail, max_new) for a
    server of ``scfg``'s batch B on two 'data' lines: ``scfg`` with a
    paged pool of PAGE_BLOCK-token blocks, chunked prefill of one block,
    no controller and no hub.  Turn 1 fills slots 0..B/2-1 (line 0) with
    short requests and puts the session's request (a 70-token prompt, 16
    new tokens: its blocks 4 and 5 hold decode-written KV) in slot B/2,
    line 1's first; turn 2 (slot 0, line 0) adds 20 tokens and decodes 8,
    adopting the chain's first 5 blocks.  The owner lines broadcast 3
    blocks: 2 after turn 1, 1 after turn 2."""
    import numpy as np
    from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                          PagedKVConfig)

    rng = np.random.default_rng(seed)
    b = scfg.batch
    turn1 = [(i, rng.integers(0, vocab, size=24), 4, "balanced")
             for i in range(b // 2)]
    turn1.append((b // 2, rng.integers(0, vocab, size=70), 16, "balanced"))
    paged = dataclasses.replace(
        scfg, controller=ControllerConfig(), metrics=MetricsConfig(),
        prefill_chunk=PAGE_BLOCK,
        paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    return paged, turn1, rng.integers(0, vocab, size=20), 8


SESSION_SHARED = 3         # blocks ``_crossing_session``'s owners broadcast
SESSION_REUSED = 5         # blocks its turn 2 adopts


def _check_session(label: str, on: list, e: dict, m: int) -> None:
    """``_crossing_session`` on the ranks (``on``, rank order, 'model'
    axis of ``m``) against one process (``e``): every rank's tokens and
    chain equal, turn 2's reuse, the bytes broadcast (3 blocks of a
    rank's every pool leaf), the chain's blocks bitwise between the lines
    (ranks of one 'model' index); where the free-running tokens equal one
    process's, each rank's blocks within the pool dtype's tolerance of
    one process's at its KV heads."""
    import numpy as np
    import torch

    s0, se = on[0]["session"], e["session"]
    for r, o in enumerate(on):
        s = o["session"]
        same = (s["chain"] == s0["chain"] and set(s["tokens"]) ==
                set(s0["tokens"]) and all(np.array_equal(
                    s["tokens"][u], s0["tokens"][u]) for u in s0["tokens"]))
        if not same or s["reused"] != SESSION_REUSED:
            fail(f"mesh {label} session: rank {r}'s tokens or chain differ "
                 f"from rank 0's, or it reused {s['reused']} blocks, not "
                 f"{SESSION_REUSED}")
        block = sum(v[0].numel() * v.element_size()
                    for layer in s["blocks"] for v in layer.values())
        if s["shared_bytes"] != SESSION_SHARED * block:
            fail(f"mesh {label} session: rank {r} broadcast "
                 f"{s['shared_bytes']} bytes, not {SESSION_SHARED} blocks "
                 f"of {block}")
        if r >= m:
            twin = on[r % m]["session"]["blocks"]
            for lg, lt in zip(s["blocks"], twin):
                for n in lg:
                    if not torch.equal(lg[n], lt[n]):
                        fail(f"mesh {label} session: rank {r}'s chain "
                             f"blocks ({n}) differ from line 0's rank "
                             f"{r % m}")
    free = all(np.array_equal(s0["tokens"][u], se["tokens"][u])
               for u in se["tokens"]) and s0["chain"] == se["chain"]
    gap = float("nan")
    if free:
        gap = 0.0
        for r, o in enumerate(on):
            for lg, lw in zip(o["session"]["blocks"], se["blocks"]):
                for n, v in lw.items():
                    kv_l = v.shape[2] // m
                    w = v[:, :, (r % m) * kv_l:(r % m + 1) * kv_l].float()
                    g = lg[n].float()
                    tol = LOGIT_TOL.get(str(v.dtype).split(".")[-1], 5e-2)
                    rel = float((g - w).abs().max()) / max(
                        float(w.abs().max()), 1e-30)
                    gap = max(gap, rel)
                    if rel > tol:
                        fail(f"mesh {label} session: rank {r}'s {n} blocks "
                             f"{rel:.3e} x max from one process's "
                             f"(tolerance {tol})")
    print(f"[mesh] {label} session across lines: turn 1 in slot "
          f"{len(s0['tokens']) - 2} (line 1), turn 2 in slot 0 (line 0) "
          f"adopting {s0['reused']} blocks; {s0['shared_bytes']} bytes "
          f"broadcast a rank; chain blocks bitwise between the lines; "
          + (f"tokens equal to one process's, blocks within {gap:.3e} x max"
             if free else "free-running tokens differ from one process's "
             "(blocks not compared)"), flush=True)


def _mesh_cases() -> dict:
    """The mesh phase's cases by mesh: (label, config, serve config, the
    requests as (uid, prompt, max_new, sla), ``_crossing_session``'s
    arguments or None)."""
    import numpy as np
    from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                          PagedKVConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.server import ServeConfig

    base = get_config("prosparse-llama2-7b")
    rng = np.random.default_rng(32)
    tiers = ("latency", "balanced", "quality")
    reqs = [(i, rng.integers(0, base.vocab, size=int(rng.integers(64, 129))),
             MESH_MAX_NEW, tiers[i % 3]) for i in range(MESH_REQUESTS)]
    met = MetricsConfig(enabled=True, watchdog=False)
    ctl = ControllerConfig(enabled=True, per_tier=True, audit_period=4)

    def cfg(layers, strategy, ds, ms, paged=False, **kw):
        sp = dataclasses.replace(base.sparse, strategy=strategy,
                                 enabled=True, tp_shards=ms, dp_shards=ds,
                                 **kw)
        return base.replace(n_layers=layers, sparse=sp, **(
            {"kv_cache_dtype": "bfloat16", "paged_attn_kernel": True}
            if paged else {}))
    paged = ServeConfig(batch=MAIN_BATCH, max_len=256, controller=ctl,
                        max_new_tokens=MESH_MAX_NEW, metrics=met,
                        paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    plain = dataclasses.replace(paged, paged_kv=None)
    return {
        ((2,), ("model",)): [
            (f"(a) {MESH_LAYERS} layers, ms=2 on 1x2, pallas, bf16 paged "
             "pool", cfg(MESH_LAYERS, "pallas", 1, 2, paged=True), paged,
             reqs, None),
            ("(c) 2 layers, int8 MLP weights, ms=2 on 1x2, pallas",
             cfg(2, "pallas", 1, 2, weight_dtype="int8",
                 quant_group_size=QG), plain, reqs, None)],
        ((2, 2), ("data", "model")): [
            (f"(b) {MESH_LAYERS_2D} layers, ds=ms=2 on 2x2 (slots split "
             "over 'data'), gather", cfg(MESH_LAYERS_2D, "gather", 2, 2),
             plain, reqs, _crossing_session(plain, base.vocab, 34))]}


def _mesh_paged_forced(params, cfg, dev, mesh=None):
    """``_paged_forced`` through ``cfg``'s paged route on phase 14's
    fragmented table and lengths over a seeded float32 pool of every KV
    head: on a rank of ``mesh`` its KV heads of that pool."""
    import numpy as np
    import torch
    from repro_torch.sharding import rules as R

    rng = np.random.default_rng(12)
    n, table = _fragmented_table(rng, DEC_BATCH, 4)
    lens0 = np.asarray([20, 17, 33, 47])
    forced = rng.integers(0, cfg.vocab, size=(DEC_STEPS, DEC_BATCH, 1))
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] + \
        np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]
    pool = _random_pool(cfg, n, torch.float32, 12)
    if mesh is not None:
        s = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
        pool = [{k: v[:, :, s.k0:s.k1].contiguous()
                 for k, v in layer.items()} for layer in pool]
    # a rank's line's slots, every line's logits gathered
    rows = list(R.slot_range(DEC_BATCH, mesh))
    lg = _paged_forced(params, cfg, dev, pool, table[rows], lens0[rows],
                       forced[:, rows], alphas[:, rows])
    return R.gather_slots(lg.movedim(1, 0).to(dev), mesh).movedim(
        0, 1).cpu()


def _gather_calls(calls: list) -> list:
    """Recorded MLP calls (``_record_calls``) of a rank's line's slots made
    every slot's: each input, output and stat gathered over the current
    mesh's 'data' axis along its slot dim (every rank takes part)."""
    import torch
    from repro_torch.sharding import rules as R

    def every(t):
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        return R.gather_slots(t.to(dev)).cpu()
    return [(every(x), every(y), st and {n: every(v) for n, v in st.items()})
            for x, y, st in calls]


@contextlib.contextmanager
def _count_lines(counts: dict):
    """Every gather over a line of ranks (``rules.gather_line``) inside
    the block adds one to ``counts[axis]``."""
    from repro_torch.sharding import rules as R
    orig = R.gather_line

    def counted(t, axis="model", mesh=None):
        counts[axis] = counts.get(axis, 0) + 1
        return orig(t, axis, mesh)
    R.gather_line = counted
    try:
        yield
    finally:
        R.gather_line = orig


@contextlib.contextmanager
def _decode_rows(seen: set):
    """Every ``models.lm.decode_step`` inside the block adds (its token
    rows, its first layer's K cache or pool shape) to ``seen``."""
    from repro_torch.models import lm
    orig = lm.decode_step

    def tapped(params, cfg, token, caches, cache_len, **kw):
        seen.add((token.shape[0], tuple(caches["blocks"][0]["k"].shape)))
        return orig(params, cfg, token, caches, cache_len, **kw)
    lm.decode_step = tapped
    try:
        yield
    finally:
        lm.decode_step = orig


def _mesh_session(srv, scfg, turn1: list, tail, max_new: int) -> dict:
    """A two-turn session on a server over ``srv``'s weights and mesh with
    the paged serve config ``scfg``: turn 1 (the requests as (uid,
    prompt, max_new, sla), the last kept under session "s" in the last
    slot they fill), then one request of the session whose prompt is turn
    1's history and ``tail``, decoding ``max_new`` tokens; it
    takes slot 0, on another 'data' line than turn 1's slot, and adopts
    the chain.  Returns both turns' tokens, the final chain, its blocks
    of every pool leaf (CPU), the blocks reused and the bytes the owner
    lines broadcast."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, Server

    sess = Server(lm, srv.cfg, scfg, srv.params, device=srv.device,
                  mesh=srv.mesh)
    reqs = [Request(uid=u, prompt=np.asarray(p), max_new=m, sla=t)
            for u, p, m, t in turn1]
    reqs[-1].session_id = "s"
    toks = {r.uid: np.asarray(r.out) for r in sess.serve(reqs)}
    hist = sess.kv_pool.lookup_session("s")["history"]
    toks[-1] = np.asarray(sess.serve([Request(
        uid=-1, prompt=np.concatenate([hist, tail]), max_new=max_new,
        session_id="s")])[0].out)
    chain = list(sess.kv_pool.lookup_session("s")["chain"])
    out = {"tokens": toks, "chain": chain,
           "blocks": [{k: v[chain].cpu() for k, v in layer.items()}
                      for layer in sess._pool["blocks"]],
           "reused": sess.paged_stats()["reused_blocks"],
           "shared_bytes": sess.shared_block_bytes}
    del sess
    return out


def _mesh_serve(label, cfg, scfg, reqs, dev, mesh=None, forced=None,
                calls: bool = True, profile: bool = False,
                session=None) -> dict:
    """One case's serve (on a mesh rank when ``mesh`` is given, its part of
    every leaf placed a table and a layer at a time): tokens, the
    controller's EMAs, launches from load to drain, the peak memory, the
    parameter bytes held, every rank's slot range and KV bytes, each
    decode step's (token rows, cache shape) and the decode step's mean
    host wall.  Then teacher-forced steps on the served weights:
    ``_teacher_forced`` (the dense cache) and, for a config on the paged
    kernels with ``calls``, ``_mesh_paged_forced`` (the paged route on the
    kernels), each on a rank's line's slots with every line's logits
    gathered; on a rank with its MLP calls recorded and gathered over
    'data' (rank 0 keeps them), in one process with ``forced`` (rank 0's
    result) replayed, every MLP call fed the ranks' input of the same
    call, the logits within ``LOGIT_TOL["float32"]`` of theirs (float32
    compute, cache and pool for these steps; ``calls`` False: a rank
    keeps none and runs the dense steps only).  ``profile``: the server's
    paged decode step on the served weights profiled (every rank runs it;
    rank 0 prints it) and one step's gathers counted by axis.
    ``session``: (paged serve config, turn 1, tail, max_new) through
    ``_mesh_session`` on the same weights."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request, Server
    from repro_torch.sharding import sparse as SSP
    from repro_torch.tree import tree_bytes

    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    place = None if mesh is None else (
        lambda node: SSP.place_serve_params(node, mesh, cfg))
    params = lm.init_lm(cfg, 0, dev, place=place)
    ops.reset_launch_counts()
    srv = Server(lm, cfg, scfg, params, device=dev, mesh=mesh)
    del params
    t1 = time.perf_counter()
    shapes: set = set()
    with _decode_rows(shapes):
        done = srv.serve([Request(uid=u, prompt=np.asarray(p), max_new=m,
                                  sla=t) for u, p, m, t in reqs])
    if card:
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    ctl = srv.controller
    out = {"tokens": [np.asarray(r.out) for r in
                      sorted(done, key=lambda r: r.uid)],
           "completed": sum(r.outcome == "completed" for r in done),
           "steps": srv.decode_steps, "launches": ops.launch_counts(),
           "step_ms": 1e3 * srv.metrics.hist_mean("decode_step_s"),
           "init_s": t1 - t0, "serve_s": t2 - t1,
           "tok_s": sum(len(r.out) for r in done) / (t2 - t1),
           "param_bytes": tree_bytes(srv.params),
           "slots": srv.mesh_slots(), "shapes": sorted(shapes)}
    if ctl is not None:
        for name in ("alphas", "density_ema", "fn_ema", "union_ema",
                     "predicted_ema"):
            out[name] = np.array(getattr(ctl.state, name))
        for name in ("shard_density_ema", "shard_union_ema"):
            out[name] = np.array(getattr(ctl, name))
    # the teacher-forced steps compute in float32 with a float32 cache,
    # whatever the serve's, as phase 3 holds card against CPU: in bf16 the
    # ranks' column-split projections and the sides' other summation
    # orders round their values a bf16 step apart, and over 32 layers
    # that drift passes any tolerance that would still catch a fault
    forced_cfg = srv.cfg.replace(kv_cache_dtype="float32", dtype="float32")
    tol = LOGIT_TOL["float32"]
    runs = {"forced": ("dense cache", lambda: _teacher_forced(
        srv.params, forced_cfg, dev))}
    if calls and forced_cfg.paged_attn_kernel:
        runs["forced_paged"] = ("paged kernels, float32 pool",
                                lambda: _mesh_paged_forced(
                                    srv.params, forced_cfg, dev, mesh))
    if mesh is not None:
        import torch.distributed as dist
        out["backend"] = dist.get_backend()
        with srv._mesh_ctx():
            for key, (_, run) in runs.items():
                out[key], rec, _ = _record_calls(run)
                rec = _gather_calls(rec) if calls else None
                out[f"calls_{key}"] = rec if mesh.rank == 0 else None
            if profile:
                quiet = open(os.devnull, "w") if mesh.rank else None
                with contextlib.redirect_stdout(quiet or sys.stdout):
                    profile_paged_decode(srv, srv.cfg)
                if quiet:
                    quiet.close()
                out["collectives"] = {}
                with _count_lines(out["collectives"]):
                    _mesh_step(srv)
    elif forced is not None:
        for key, (what, run) in runs.items():
            _replay_calls(f"[mesh] {label}: teacher-forced ({what}), one "
                          "process on the ranks' MLP inputs", forced[key],
                          forced[f"calls_{key}"], [], run, tol,
                          time.perf_counter())
    if session is not None:
        with srv._mesh_ctx():
            out["session"] = _mesh_session(srv, *session)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9 if card
                      else 0.0)
    del srv
    if card:
        torch.cuda.empty_cache()
    return out


def _mesh_rank(mesh, dev, cases: list) -> list:
    """A rank's serves of ``cases`` (spawned by ``launch.ranks``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [_mesh_serve(*case[:4], dev, mesh, session=case[4])
            for case in cases]


def _nccl_rank(mesh, dev) -> float:
    import torch
    import torch.distributed as dist
    t = torch.ones(1, device=dev)
    dist.all_reduce(t)
    return float(t)


def _mesh_want(cfg, strategy: str, steps: int, per_d: int,
               per_m: int) -> dict:
    """One rank's launches from load to drain: the gate sign pack of its
    rows at load, then per layer and decode step its per_d x per_m tiles
    (gather packs x once a data block); paged kernels a layer a step, on
    the rank's heads.  A tensor-sharded prefill runs the dense MLP, as the
    reference's, so no chunk kernel launches."""
    L, tiles = cfg.n_layers, per_d * per_m
    if strategy == "pallas":
        mlp = ("fused_sparse_mlp_q" if cfg.sparse.weight_dtype
               else "fused_sparse_mlp")
        want = {"sign_pack": L, "predict_group_margins": L * steps * tiles,
                mlp: L * steps * tiles}
    else:
        want = {"sign_pack": L + L * steps * per_d,
                "predict_counts": L * steps * tiles}
    if cfg.paged_attn_kernel:
        want.update(paged_attention=L * steps, paged_kv_write=L * steps)
    return want


MESH_STATE = ("tokens", "alphas", "density_ema", "fn_ema", "union_ema",
              "predicted_ema", "shard_density_ema", "shard_union_ema",
              "forced", "forced_paged")


def _same_state(a: dict, b: dict) -> list:
    """The keys of ``MESH_STATE`` whose values differ between two runs."""
    import numpy as np
    import torch

    def same(x, y):
        if isinstance(x, list):
            return len(x) == len(y) and all(map(same, x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return np.array_equal(x, y)
    return [k for k in MESH_STATE
            if k in a and k in b and not same(a[k], b[k])]


def _mesh_check(label: str, cfg, ranks: list, sizes: dict) -> None:
    """Every rank's tokens, EMAs and teacher-forced logits bitwise rank
    0's, and every rank's launches exact."""
    ds, ms = cfg.sparse.dp_shards, cfg.sparse.tp_shards
    per_d = ds // sizes.get("data", 1)
    per_m = ms // sizes.get("model", 1)
    for r, out in enumerate(ranks):
        diff = _same_state(out, ranks[0])
        if diff:
            fail(f"mesh {label}: rank {r}'s {diff} differ from rank 0's")
        want = _want_launches(out["launches"], **_mesh_want(
            cfg, cfg.sparse.strategy, out["steps"], per_d, per_m))
        if out["launches"] != want or out["steps"] != ranks[0]["steps"]:
            fail(f"mesh {label}: rank {r} launched {out['launches']} in "
                 f"{out['steps']} steps, want {want} in "
                 f"{ranks[0]['steps']}")


def _check_split(label: str, cfg, scfg, on: list, sizes: dict) -> None:
    """Each rank's slot range is its 'data' line's contiguous share of the
    batch, every decode step ran on B/D token rows against caches of B/D
    slots (a paged pool: every block) at the rank's KV heads, and its KV
    bytes are that share of the one-device KV's (``Server.mesh_slots``);
    prints them."""
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    b, dense = scfg.batch, scfg.paged_kv is None
    one = on[0]["slots"]["one_device_kv_bytes"]
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    for r, o in enumerate(on):
        line = r // m
        if o["slots"]["per_rank"][r]["slots"] != [line * b // d,
                                                  (line + 1) * b // d]:
            fail(f"mesh {label}: rank {r} owns slots "
                 f"{o['slots']['per_rank'][r]['slots']}, not line {line}'s "
                 f"share of {b}")
        if not o["shapes"]:
            fail(f"mesh {label}: rank {r} ran no decode step")
        for rows, sh in o["shapes"]:
            want = ((b // d, scfg.max_len) if dense
                    else (sh[0], scfg.paged_kv.block_size)) + (sh[2], hd)
            if rows != b // d or tuple(sh) != want or kvh % sh[2]:
                fail(f"mesh {label}: rank {r} decoded {rows} slots on a "
                     f"{sh} K leaf, not its line's {b // d} on {want}")
        kv, kv_l = o["slots"]["per_rank"][r]["kv_bytes"], o["shapes"][0][1][2]
        if kv * kvh * (d if dense else 1) != one * kv_l:
            fail(f"mesh {label}: rank {r} holds {kv} KV bytes, not "
                 f"{kv_l}/{kvh} of the heads"
                 f"{f' and 1/{d} of the slots' if dense else ''} of one "
                 f"device's {one}")
    print(f"[mesh] {label}: slots a rank "
          f"{[p['slots'] for p in on[0]['slots']['per_rank']]}, KV bytes a "
          f"rank {[p['kv_bytes'] for p in on[0]['slots']['per_rank']]} "
          f"(one device {one}); decode rows and K leaf {on[0]['shapes']}",
          flush=True)


def phase_mesh(results: dict) -> None:
    """The model placed on ranks that share the card: each mesh's cases on
    its ranks first (every leaf split by the serve rules, the attention by
    heads), then in this process (the emulated grid, replaying the ranks'
    teacher-forced MLP inputs); tokens, EMAs and teacher-forced logits
    bitwise between the ranks, the logits within tolerance of one
    process."""
    import numpy as np
    import torch
    from repro_torch.launch.ranks import run_ranks

    dev = torch.device(MESH_DEVICE)
    for (shape, axes), cases in _mesh_cases().items():
        t = time.perf_counter()
        ranks = run_ranks(_mesh_rank, shape, axes, args=(cases,),
                          device=MESH_DEVICE, timeout=600)
        t_ranks = time.perf_counter() - t
        t = time.perf_counter()
        emul = [_mesh_serve(*case[:4], dev, forced=ranks[0][j],
                            session=case[4])
                for j, case in enumerate(cases)]
        print(f"[mesh] {'x'.join(map(str, shape))} over {axes}: ranks "
              f"{t_ranks:.1f} s (start, build, serve), emulated serves "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        sizes = dict(zip(axes, shape))
        for j, (label, cfg, scfg, *_) in enumerate(cases):
            e, on = emul[j], [o[j] for o in ranks]
            _mesh_check(label, cfg, on, sizes)
            _check_split(label, cfg, scfg, on, sizes)
            if e["completed"] != MESH_REQUESTS:
                fail(f"mesh {label}: {e['completed']} requests completed")
            # free-running state is not held to one process: every mesh
            # here splits heads over 'model' or slots over 'data', so its
            # GEMMs round otherwise; the teacher-forced logits above are
            moved = [k for k in _same_state(on[0], e)
                     if not k.startswith("forced")]
            if "session" in e:
                _check_session(label, on, e, sizes.get("model", 1))
            print(f"[mesh] {label}: tokens, EMAs and teacher-forced logits "
                  f"of {len(on)} ranks bitwise ({e['steps']} decode steps, "
                  f"{MESH_REQUESTS} requests); the served "
                  f"{'state equal to' if not moved else 'state differs from'}"
                  f" the emulated serve's{f' in {moved}' if moved else ''}",
                  flush=True)

            def per_rank(key, nd):
                return [round(o[key], nd) for o in on]
            print(f"[mesh] {label}: decode step host wall {e['step_ms']:.2f}"
                  f" ms emulated, ranks {per_rank('step_ms', 2)} ms; peak "
                  f"memory {e['peak_gb']:.2f} GB emulated, ranks "
                  f"{per_rank('peak_gb', 2)} GB; parameters "
                  f"{e['param_bytes'] / 1e9:.3f} GB one process, ranks "
                  f"{[round(o['param_bytes'] / 1e9, 3) for o in on]} GB; "
                  f"serve {e['serve_s']:.1f} s emulated, ranks "
                  f"{per_rank('serve_s', 1)} s", flush=True)
            used = [{k: v for k, v in o["launches"].items() if v}
                    for o in on]
            print(f"[mesh] {label}: launches per rank {used}", flush=True)
        del emul, ranks
    try:
        run_ranks(_nccl_rank, (2,), ("model",), device=MESH_DEVICE,
                  backend="nccl", timeout=120)
        print("[mesh] nccl with two ranks on one card: ran", flush=True)
    except (RuntimeError, TimeoutError) as e:
        last = [ln for ln in str(e).splitlines() if ln.strip()][-1:]
        print(f"[mesh] nccl with two ranks on one card refused: {last}",
              flush=True)


def _mlp_kernel_times(label: str, name: str, d: int, k: int, gated: bool,
                      cap: int, gen, flush) -> None:
    """A sparse MLP call's kernels at one arch's served widths (bf16 x,
    float32 weights, G=8, the arch's capacity ``cap``) against their plain
    versions: ``_served_mlp_checks`` (#9 on x and on the gate weights, #1,
    #3, #2, #4), then #5 and #6 on the weights quantized (qg 128) and #10,
    each twice bitwise; and each timed at the main path's shape beside its
    bound, its plain version and a library yardstick where one PyTorch
    call computes it: #9 on the gate weights at load and on x at B=4, #1,
    #2 and #5 at B=4, #3, #4 and #6 at S=64, #10 at B=4."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    tag0 = f"{name} d={d} k={k}"
    checked = _served_mlp_checks(name, d, k, gated, cap, gen)
    wg, wu, wd, x, sel, _ = checked
    n_mats = 3 if gated else 2
    # ---- #9: the gate weights at load and x at B=4
    sign_wg = _same_twice(f"{tag0} gate weights", lambda: KS.sign_pack(wg),
                          name="sign_pack")
    for what, src in (("gate weights at load, float32", wg),
                      (f"x B={MAIN_BATCH} bfloat16", x)):
        t_k = cuda_ms(lambda: KS.sign_pack(src), flush=flush)
        t_p = cuda_ms(lambda: ref.sign_pack_ref(src), iters=5, flush=flush)
        bound = bound_ms(src.numel() * src.element_size()
                         + src.shape[0] * -(-d // 32) * 4, 0)
        print(f"[{label}] sign_pack {tag0} {what}: bitwise; kernel "
              f"{t_k:.4f} ms plain {t_p:.4f} ms bound {bound[0]:.4f} ms "
              f"({bound[1]}; share {bound[0] / t_k:.3f})", flush=True)
    # ---- #1 at B=4
    alpha = torch.linspace(0.9, 1.1, MAIN_BATCH, device=dev)
    t_pred = cuda_ms(lambda: KP.predict_group_margins(
        sign_wg, x, alpha, d_valid=d, group_size=G), flush=flush)
    t_pred_p = cuda_ms(lambda: ref.predict_group_margins_ref(
        sign_wg, x, d, alpha, G), iters=5, flush=flush)
    pw = predict_work(MAIN_BATCH, 2, d, k)
    pb = (max(pw[0], pw[1]), "bytes" if pw[0] >= pw[1] else "operations")
    print(f"[{label}] predict_group_margins {tag0} B={MAIN_BATCH} "
          f"x=bfloat16: kernel {t_pred:.4f} ms plain {t_pred_p:.4f} ms bound "
          f"{pb[0]:.4f} ms ({pb[1]}; share {pb[0] / t_pred:.3f})",
          flush=True)
    # ---- #2 at B=4
    _served_mlp_time(label, name, checked, k, cap, flush)
    del checked
    # ---- the chunk kernels (#3, #4) timed at S=64
    xs = torch.randn((MAIN_CHUNK, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    a_s = _chunk_alphas(MAIN_CHUNK, dev)
    gm_s, _ = KP.predict_chunk_group_margins(sign_wg, xs, a_s, d_valid=d,
                                             group_size=G)
    sel_s, _ = S.capacity_select_with_stats(S.union_margin(gm_s), cap)
    count_s = int(sel_s.count)
    t_cp = cuda_ms(lambda: KP.predict_chunk_group_margins(
        sign_wg, xs, a_s, d_valid=d, group_size=G), flush=flush)
    t_cp_p = cuda_ms(lambda: ref.predict_chunk_group_margins_ref(
        sign_wg, xs, d, a_s, G), iters=5, flush=flush)
    pw = predict_work(MAIN_CHUNK, 2, d, k)
    pbc = (max(pw[0], pw[1]), "bytes" if pw[0] >= pw[1] else "operations")
    cargs = (xs, wg, wu, wd, sel_s.indices, sel_s.count)
    y_c = KF.fused_sparse_mlp_chunk(*cargs, group_size=G)
    y_cr = ref.fused_sparse_mlp_chunk_ref(*cargs, group_size=G)
    err_c = float((y_c - y_cr).abs().max())
    if err_c > 2e-3 * (float(y_cr.abs().max()) or 1.0):
        fail(f"fused_sparse_mlp_chunk {tag0}: max abs err {err_c:.3e}")
    t_c = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(*cargs, group_size=G),
                  flush=flush)
    t_c_p = cuda_ms(lambda: ref.fused_sparse_mlp_chunk_ref(
        *cargs, group_size=G), iters=5, flush=flush)
    rows_s = sel_s.indices[:count_s].long()
    take_s = [m.reshape(k // G, G, d)[rows_s].reshape(-1, d).contiguous()
              for m in (wg, wu, wd) if m is not None]
    xsf = xs.float()
    if gated:
        lib = lambda: (torch.relu(xsf @ take_s[0].T)  # noqa: E731
                       * (xsf @ take_s[1].T)) @ take_s[2]
    else:
        lib = lambda: torch.relu(xsf @ take_s[0].T) @ take_s[1]  # noqa: E731
    t_c_lib = cuda_ms(lib, flush=flush)
    c_bytes = (n_mats * count_s * G * d * 4 + MAIN_CHUNK * d * 2 + cap * 4
               + 4 + MAIN_CHUNK * d * 4)
    cb = tc_bound_ms(c_bytes, 2 * 2 * n_mats * MAIN_CHUNK * count_s * G * d)
    print(f"[{label}] predict_chunk_group_margins {tag0} S={MAIN_CHUNK} "
          f"x=bfloat16: kernel {t_cp:.4f} ms plain {t_cp_p:.4f} ms bound "
          f"{pbc[0]:.4f} ms ({pbc[1]}; share {pbc[0] / t_cp:.3f})",
          flush=True)
    print(f"[{label}] fused_sparse_mlp_chunk {tag0} S={MAIN_CHUNK} "
          f"x=bfloat16 count={count_s}/{cap}: max_abs_err {err_c:.3e}; "
          f"kernel {t_c:.4f} ms plain {t_c_p:.4f} ms bound {cb[0]:.4f} ms "
          f"({cb[1]}, TF32 x2 passes; share {cb[0] / t_c:.3f}) "
          f"gathered-rows-{n_mats}-matmul {t_c_lib:.4f} ms", flush=True)
    del take_s
    # ---- #5, #6: int8 weights, qg 128, twice bitwise
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn.get(n) for n in QNAMES]
    for qname, xq, sq, plain_iters in (
            ("fused_sparse_mlp_q", x, sel, 20),
            ("fused_sparse_mlp_chunk_q", xs, sel_s, 5)):
        cnt_q = int(sq.count)
        fn = getattr(KF, qname)
        y = _same_twice(f"{tag0} rows={xq.shape[0]}", lambda: fn(
            xq, *qargs, sq.indices, sq.count, group_size=G), name=qname)
        y_r = ref.fused_sparse_mlp_q_ref(xq, *qargs, sq.indices, sq.count,
                                         group_size=G)
        torch.cuda.synchronize()
        scale = float(y_r.abs().max()) or 1.0
        err_q = float((y - y_r).abs().max())
        if err_q > 1e-4 * scale:
            fail(f"{qname} {tag0}: max abs err {err_q:.3e} > 1e-4 x max|y| "
                 f"{scale:.3e}")
        t_q = cuda_ms(lambda: fn(xq, *qargs, sq.indices, sq.count,
                                 group_size=G), flush=flush)
        t_qp = cuda_ms(lambda: ref.fused_sparse_mlp_q_ref(
            xq, *qargs, sq.indices, sq.count, group_size=G),
            iters=plain_iters, flush=flush)
        rows_q = xq.shape[0]
        q_rows = int(torch.unique(sq.indices[:cnt_q].long()
                                  // (QG // G)).numel())
        qb = bound_ms(n_mats * cnt_q * G * d
                      + (n_mats - 1) * cnt_q * G * (d // QG) * 4
                      + q_rows * d * 4 + rows_q * d * 2 + cap * 4 + 4
                      + rows_q * d * 4, 2 * n_mats * rows_q * cnt_q * G * d)
        print(f"[{label}] {qname} {tag0} rows={rows_q} x=bfloat16 "
              f"qg={QG} count={cnt_q}/{cap}: max_abs_err {err_q:.3e}, "
              f"bitwise twice; kernel {t_q:.4f} ms plain {t_qp:.4f} ms bound "
              f"{qb[0]:.4f} ms ({qb[1]}; share {qb[0] / t_q:.3f})",
              flush=True)
    del qn, qargs
    _counts_time(label, tag0, sign_wg, x, flush)
    del wg, wu, wd, sign_wg


def _counts_time(label: str, tag0: str, sign_wg, x, flush) -> None:
    """#10 on ``x`` (B=4) packed against the packed gate weights
    ``sign_wg``: twice bitwise and equal to its plain version, timed beside
    its bound and its plain version."""
    import torch
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS

    b, d = x.shape
    k = sign_wg.shape[0]
    xp = KS.sign_pack(x)
    cnt = _same_twice(f"{tag0} B={b}",
                      lambda: KP.predict_counts(sign_wg, xp),
                      name="predict_counts")
    if not torch.equal(cnt, ref.predict_counts_ref(sign_wg, xp)):
        fail(f"predict_counts {tag0}: differs from its plain version")
    t_n = cuda_ms(lambda: KP.predict_counts(sign_wg, xp), flush=flush)
    t_np = cuda_ms(lambda: ref.predict_counts_ref(sign_wg, xp), iters=5,
                   flush=flush)
    nw = predict_work(b, 2, d, k, counts=True)
    nb = (max(nw[0], nw[1]), "bytes" if nw[0] >= nw[1] else "operations")
    print(f"[{label}] predict_counts {tag0} B={b}: bitwise, "
          f"twice; kernel {t_n:.4f} ms plain {t_np:.4f} ms bound "
          f"{nb[0]:.4f} ms ({nb[1]}; share {nb[0] / t_n:.3f})", flush=True)


# ----------------------------------------------------------- phase 17: moe --

MOE_ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b")


def _moe_kernel_cases(gen, flush) -> None:
    """(a): the kernels at deepseek-moe-16b's first-layer widths (d=2048,
    k=1408: 176 groups, capacity 48 of them), bf16 x, against their plain
    versions: sign_pack (x, the gate weights, and one MoE layer's
    expert-stack gate weights (64 x 1408 rows) at load), both predictors
    and both float32 MLPs (``_served_mlp_checks``: bitwise, the MLPs
    twice bitwise), the int8 MLPs (qg 128) at B=4 and S=64 twice bitwise,
    predict_counts at B=4 twice bitwise; the paged attention and the
    paired KV write at H=K=16, hd 128 into a bf16 pool.  Each timed at the
    main path's shape beside its bound, plain version and library
    yardstick."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_pack as KS

    dev = torch.device("cuda")
    cfg = get_config("deepseek-moe-16b")
    d, k, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    cap = cfg.sparse.capacity(k)
    # ---- #9 on an expert stack at load (the gate weights of 64 experts)
    stack = torch.randn((e, k, d), generator=gen, device=dev) * d ** -0.5
    packed = _same_twice(f"expert stack {e}x{k}x{d}",
                         lambda: KS.sign_pack(stack.reshape(-1, d)),
                         name="sign_pack")
    if not torch.equal(packed, ref.sign_pack_ref(stack.reshape(-1, d))):
        fail(f"sign_pack expert stack {e}x{k}x{d}: differs from its plain "
             "version")
    t_k = cuda_ms(lambda: KS.sign_pack(stack.reshape(-1, d)), flush=flush)
    t_p = cuda_ms(lambda: ref.sign_pack_ref(stack.reshape(-1, d)), iters=5,
                  flush=flush)
    bound = bound_ms(stack.numel() * 4 + packed.numel() * 4, 0)
    print(f"[moe-kernels] sign_pack expert stack ({e} x {k} rows, d={d}, "
          f"float32, at load): bitwise, twice; kernel {t_k:.4f} ms plain "
          f"{t_p:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}; share "
          f"{bound[0] / t_k:.3f})", flush=True)
    del stack, packed
    _mlp_kernel_times("moe-kernels", "deepseek-moe-16b layer 0", d, k, True,
                      cap, gen, flush)
    # ---- #7, #8 at H=K=16, hd 128, bf16 pool; the write timed too
    kp, vp, table, lengths, kv_new = _served_attention(
        "moe-kernels", "deepseek-moe-16b", cfg, gen,
        np.random.default_rng(27), flush)
    t = write_times(kp, vp, *kv_new, table, lengths.long())
    print(f"[moe-kernels] {write_line('B=4 H=K=16 hd=128 bf16', t, 4)}",
          flush=True)


def _moe_layers() -> None:
    """(b): deepseek-moe-16b (its dense first layer and one MoE layer) and
    olmoe-1b-7b (two MoE layers) at full width, float32 compute, the
    config's own selection (capacity 48 of 176 groups: the clamp binds),
    card against CPU through ``_hold``: every MLP and MoE call on the
    CPU fed the card's input of the same call, routing held to near ties.
    8 teacher-forced decode steps on the dense cache with strategies
    pallas, masked and gather (deepseek; olmoe has no sparse MLP layer and
    runs pallas only), int8 MLP weights (qg 128, deepseek), a fragmented
    float32 pool on the kernel route and on the gather route, and a
    160-token chunked sparse prefill (deepseek also with int8 weights).
    Launches exact."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    for i, arch in enumerate(MOE_ARCHS):
        t0 = time.perf_counter()
        base = get_config(arch)
        cfg = base.replace(n_layers=2, dtype="float32",
                           kv_cache_dtype="float32",
                           sparse=dataclasses.replace(
                               base.sparse, strategy="pallas", enabled=True))
        Ls, steps = _mlp_layers(cfg), DEC_STEPS
        raw = lm.init_lm(cfg, 170 + i, "cuda")
        print(f"[moe] {arch}: d={cfg.d_model} H={cfg.n_heads} "
              f"K={cfg.n_kv_heads} hd={cfg.resolved_head_dim} experts "
              f"{cfg.n_experts} x f={cfg.d_ff} top-{cfg.top_k} shared "
              f"{cfg.n_shared_experts} norm_topk {cfg.router_norm_topk} "
              f"qk_norm {cfg.qk_norm} vocab {cfg.vocab}; layers "
              f"{['mlp' if 'mlp' in b else 'moe' for b in raw['blocks']]}"
              + (f"; layer-0 capacity {cfg.sparse.capacity(cfg.d_ff)} of "
                 f"{cfg.d_ff // G} groups" if Ls else ""), flush=True)
        strategies = ("pallas", "masked", "gather") if Ls else ("pallas",)
        for weights in ("", "int8") if Ls else ("",):
            wcfg = cfg.replace(sparse=dataclasses.replace(
                cfg.sparse, weight_dtype=weights, quant_group_size=QG))
            params = {"cuda": lm.prepare_sparse(raw, wcfg.sparse)}
            params["cpu"] = _to(params["cuda"], "cpu")
            for strategy in strategies if not weights else ("pallas",):
                run_cfg = wcfg.replace(sparse=dataclasses.replace(
                    wcfg.sparse, strategy=strategy))
                if strategy == "pallas":
                    fused = "fused_sparse_mlp_q" if weights \
                        else "fused_sparse_mlp"
                    want = {"predict_group_margins": Ls * steps,
                            fused: Ls * steps}
                else:
                    want = dict(sign_pack=Ls * steps,
                                predict_counts=Ls * steps)
                _hold(f"[moe] {arch} decode, {strategy}, "
                      f"{weights or 'float32'} MLP weights",
                      lambda dev, c=run_cfg: _teacher_forced(params[dev], c,
                                                             dev),
                      LOGIT_TOL["float32"], want)
            chunk_cfg = wcfg.replace(sparse=dataclasses.replace(
                wcfg.sparse, sparse_prefill=True,
                prefill_max_tokens=max(wcfg.sparse.prefill_max_tokens,
                                       MAIN_CHUNK)))
            fused = "fused_sparse_mlp_chunk_q" if weights \
                else "fused_sparse_mlp_chunk"
            _prefill_chunks(f"[moe] {arch} chunked sparse prefill, "
                            f"{weights or 'float32'} MLP weights", params,
                            chunk_cfg, 160, 5 + i, 256,
                            ("predict_chunk_group_margins", fused))
            if weights:
                del params
                continue
            rng = np.random.default_rng(17 + i)
            n, table = _fragmented_table(rng, DEC_BATCH, 4)
            lens0 = np.asarray([20, 17, 33, 47])
            forced = rng.integers(0, cfg.vocab, size=(steps, DEC_BATCH, 1))
            alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)
            pool = _random_pool(cfg, n, torch.float32, 17 + i)
            for kernel_route in (True, False):
                run_cfg = cfg.replace(paged_attn_kernel=kernel_route)
                paged = cfg.n_layers * steps if kernel_route else 0
                _hold(f"[moe] {arch} paged decode, float32 pool, "
                      f"{'kernel' if kernel_route else 'gather'} route",
                      lambda dev, c=run_cfg: _paged_forced(
                          params[dev], c, dev, pool, table, lens0, forced,
                          alphas),
                      LOGIT_TOL["float32"],
                      dict(paged_attention=paged, paged_kv_write=paged,
                           predict_group_margins=Ls * steps,
                           fused_sparse_mlp=Ls * steps))
            del params, pool
        del raw
        torch.cuda.empty_cache()
        print(f"[moe] {arch} layers: {time.perf_counter() - t0:.1f} s",
              flush=True)


def _moe_serve(arch: str) -> None:
    """(c): ``arch`` at full width and full depth (random float32 weights
    from a seed, bf16 compute) through Server.serve: the per-tier
    controller on strategy pallas, a bf16 paged pool of 16-token blocks
    with the paged kernels, chunked sparse prefill in chunks of 64, batch
    4, 8 requests of mixed tiers with 96-192-token prompts and 16 new
    tokens each.  Launch counters reset before the server is built, so
    the load-time sign packs (each MLP, each expert stack, each shared
    expert) count; launches exact; a profiled paged decode step."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig, PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config(arch)
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=dataclasses.replace(
                           base.sparse, strategy="pallas", enabled=True,
                           sparse_prefill=True,
                           prefill_max_tokens=max(
                               base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK,
                       paged_kv=PagedKVConfig(block_size=PAGE_BLOCK),
                       controller=ControllerConfig(enabled=True,
                                                   per_tier=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ops.reset_launch_counts()
    srv = Server(lm, cfg, scfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    load = ops.launch_counts()
    Ls = _mlp_layers(cfg)
    n_moe = cfg.n_layers - Ls
    packs = Ls + n_moe * (2 if cfg.n_shared_experts else 1)
    if load != _want_launches(load, sign_pack=packs):
        fail(f"serve-{arch}: load launches {load}, want {packs} sign packs")
    print(f"[moe-serve] {arch}: {cfg.n_layers} layers ({Ls} dense, {n_moe} "
          f"MoE of {cfg.n_experts} experts, top-{cfg.top_k}), weights "
          f"{n_bytes / 1e9:.2f} GB {cfg.param_dtype}, compute {cfg.dtype}, "
          f"{cfg.kv_cache_dtype} pool of {srv.kv_pool.n_blocks} blocks; "
          f"{packs} sign packs at load; memory after load "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(28)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(96, 193))),
                max_new=16, sla=tiers[i % 3]) for i in range(8)]
    steps0, run0 = srv.decode_steps, srv.prefill_chunks_run
    t1 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    chunks = srv.prefill_chunks_run - run0
    if len(done) != len(reqs) or any(
            r.outcome != "completed" or len(r.out) != 16
            or not ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done):
        fail(f"serve-{arch}: not every request completed with 16 valid "
             "tokens")
    n_chunks = sum(-(-len(r.prompt) // MAIN_CHUNK) for r in reqs)
    L = cfg.n_layers
    want = _want_launches(counts, sign_pack=packs,
                          predict_group_margins=Ls * steps,
                          fused_sparse_mlp=Ls * steps,
                          paged_attention=L * steps,
                          paged_kv_write=L * steps,
                          predict_chunk_group_margins=Ls * chunks,
                          fused_sparse_mlp_chunk=Ls * chunks)
    if steps == 0 or counts != want or chunks != n_chunks:
        fail(f"serve-{arch}: launches {counts}, want {want} ({steps} decode "
             f"steps, {chunks} of {n_chunks} chunks)")
    rep = throughput_report(done)
    print(f"[moe-serve] {arch} throughput_report {json.dumps(rep)}",
          flush=True)
    ctl = srv.controller.report()
    print(f"[moe-serve] {arch} controller: steps {ctl['steps']}, prefill "
          f"chunks {ctl['prefill_chunks']}, audits {ctl['audits']}",
          flush=True)
    print(f"[moe-serve] {arch}: {wall:.1f} s; decode steps {steps}; prefill "
          f"chunks {chunks}; launches from load {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profile_paged_decode(srv, cfg,
                         rng.integers(0, cfg.vocab, size=(MAIN_BATCH, 1)))
    del srv
    torch.cuda.empty_cache()


def phase_moe(results: dict) -> None:
    """The moe family on the card: (a) the kernels at deepseek-moe-16b's
    first-layer and attention shapes, (b) two full-width layers of each
    arch card against CPU, (c) olmoe-1b-7b and deepseek-moe-16b served at
    full depth."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for step, fn in (("a", lambda: _moe_kernel_cases(gen, flush_buf.zero_)),
                     ("b", _moe_layers),
                     ("c olmoe-1b-7b", lambda: _moe_serve("olmoe-1b-7b")),
                     ("c deepseek-moe-16b",
                      lambda: _moe_serve("deepseek-moe-16b"))):
        t = time.perf_counter()
        fn()
        print(f"[moe] ({step}) {time.perf_counter() - t:.1f} s", flush=True)
    del flush_buf
    torch.cuda.empty_cache()


# --------------------------------------------------------- phase 18: cross --

# family -> (arch, the extra input's name, the config field of its length)
CROSS_ARCHS = {"encdec": ("seamless-m4t-medium", "frames", "n_frames"),
               "vlm": ("llama-3.2-vision-90b", "images", "n_image_tokens")}
VLM_SERVE_LAYERS = 5      # one group of cross_every=5: 19.2 GB of float32


def _cross_extra(cfg, b: int, seed: int):
    """Stub frames or images (b, T, d) float32 from a seeded generator, on
    the CPU."""
    import numpy as np
    import torch
    _, _, field = CROSS_ARCHS[cfg.family]
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, getattr(cfg, field), cfg.d_model), dtype=np.float32))


def _perturb(params, cfg, gen) -> None:
    """In place: every norm scale and bias, QKV bias and gate drawn from
    ``gen`` (LayerNorm scales 1 + 0.3 N(0, 1), RMSNorm's 0.3 N(0, 1),
    biases 0.3 N(0, 1), gates +-U(0.3, 0.9)).  The reference starts gates
    at 0, where a cross block adds nothing, and LayerNorm at 1 and 0."""
    import torch

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        for name, v in node.items():
            if isinstance(v, (dict, list)):
                walk(v)
            elif name in ("gate_attn", "gate_mlp"):
                u = torch.rand(v.shape, generator=gen, device=v.device)
                sign = torch.randint(0, 2, v.shape, generator=gen,
                                     device=v.device) * 2 - 1
                v.copy_((0.3 + 0.6 * u) * sign)
            elif name in ("scale", "bias", "bq", "bk", "bv"):
                z = torch.randn(v.shape, generator=gen, device=v.device)
                layer = name == "scale" and cfg.norm == "layernorm"
                v.copy_(z * 0.3 + float(layer))
    walk(params)


def _cross_kernel_cases(gen, flush) -> None:
    """(a): the sparse MLP kernels at seamless-m4t-medium's decoder FFN
    widths (ungated, d=1024, k=4096: 512 groups, capacity 112) and at
    llama-3.2-vision-90b's (gated, d=8192, k=28672: 3584 groups, capacity
    720; the widest d a kernel has met), bf16 x: ``_mlp_kernel_times``."""
    from repro_torch.configs.registry import get_config
    for arch, what in (("seamless-m4t-medium", "decoder FFN"),
                       ("llama-3.2-vision-90b", "FFN")):
        cfg = get_config(arch)
        _mlp_kernel_times("cross-kernels", f"{arch} {what}", cfg.d_model,
                          cfg.d_ff, cfg.gated_mlp,
                          cfg.sparse.capacity(cfg.d_ff), gen, flush)


def _cross_layers() -> None:
    """(b): both archs at full width and reduced depth (seamless: 2
    encoder and 2 decoder layers; the vlm: cross_every=2, one self and
    one gated cross block), float32 compute and KV, the config's own
    selection (capacity 20%: the clamp binds), weights from the module's
    ``init_lm`` on the card with the gates, norms and biases drawn
    non-zero (``_perturb``), copied to the CPU; card against CPU through
    ``_hold``: ``encode`` first (the encoder's states, an input of every
    cross attention, within 1e-4 of the CPU's), then 8 teacher-forced
    decode steps with strategies pallas, masked and gather and with int8
    MLP weights (qg 128, pallas), and a 160-token chunked sparse prefill.
    Launches exact."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import model_module

    for i, fam in enumerate(CROSS_ARCHS):
        t0 = time.perf_counter()
        arch = CROSS_ARCHS[fam][0]
        base = get_config(arch)
        depth = (dict(n_layers=2, n_enc_layers=2) if fam == "encdec"
                 else dict(n_layers=2, cross_every=2))
        cfg = base.replace(dtype="float32", kv_cache_dtype="float32",
                           sparse=dataclasses.replace(
                               base.sparse, strategy="pallas", enabled=True),
                           **depth)
        mod = model_module(cfg)
        L, steps = cfg.n_layers, DEC_STEPS
        raw = mod.init_lm(cfg, 180 + i, "cuda")
        _perturb(raw, cfg, torch.Generator(device="cuda").manual_seed(
            181 + i))
        extra = _cross_extra(cfg, DEC_BATCH, 182 + i)
        print(f"[cross] {arch}: d={cfg.d_model} H={cfg.n_heads} "
              f"K={cfg.n_kv_heads} hd={cfg.resolved_head_dim} k={cfg.d_ff} "
              f"{'gated' if cfg.gated_mlp else 'ungated'} {cfg.activation} "
              f"{cfg.norm}, vocab {cfg.vocab}, {CROSS_ARCHS[fam][1]} "
              f"{tuple(extra.shape)}, layers {depth}, capacity "
              f"{cfg.sparse.capacity(cfg.d_ff)} of {cfg.d_ff // G} groups",
              flush=True)
        if fam == "encdec":
            params = {"cuda": raw, "cpu": _to(raw, "cpu")}
            _hold(f"[cross] {arch} encode, {extra.shape[1]} frames",
                  lambda dev: mod.encode(params[dev], cfg,
                                         extra.to(dev)).float().cpu(),
                  1e-4, {})
            del params
        for weights in ("", "int8"):
            wcfg = cfg.replace(sparse=dataclasses.replace(
                cfg.sparse, weight_dtype=weights, quant_group_size=QG))
            params = {"cuda": mod.prepare_sparse(raw, wcfg.sparse)}
            params["cpu"] = _to(params["cuda"], "cpu")
            for strategy in ("pallas", "masked", "gather") if not weights \
                    else ("pallas",):
                run_cfg = wcfg.replace(sparse=dataclasses.replace(
                    wcfg.sparse, strategy=strategy))
                if strategy == "pallas":
                    fused = "fused_sparse_mlp_q" if weights \
                        else "fused_sparse_mlp"
                    want = {"predict_group_margins": L * steps,
                            fused: L * steps}
                else:
                    want = dict(sign_pack=L * steps,
                                predict_counts=L * steps)
                _hold(f"[cross] {arch} decode, {strategy}, "
                      f"{weights or 'float32'} MLP weights",
                      lambda dev, c=run_cfg: _teacher_forced(
                          params[dev], c, dev, extra),
                      LOGIT_TOL["float32"], want)
            if not weights:
                _prefill_chunks(
                    f"[cross] {arch} chunked sparse prefill", params,
                    wcfg.replace(sparse=dataclasses.replace(
                        wcfg.sparse, sparse_prefill=True,
                        prefill_max_tokens=max(
                            wcfg.sparse.prefill_max_tokens, MAIN_CHUNK))),
                    160, 5, 256, ("predict_chunk_group_margins",
                                  "fused_sparse_mlp_chunk"), extra[:1])
            del params
        del raw
        torch.cuda.empty_cache()
        print(f"[cross] {arch} layers: {time.perf_counter() - t0:.1f} s",
              flush=True)


def _cross_serve(fam: str) -> None:
    """(c): seamless-m4t-medium at full depth (12 + 12 layers) and
    llama-3.2-vision-90b at full width and ``VLM_SERVE_LAYERS`` layers (its
    100 do not fit: 346 GB of float32) through Server.serve: random float32
    weights from a seed with the gates, norms and biases drawn non-zero,
    bf16 compute, a dense bf16 KV cache, frames or images drawn as the
    serve CLI draws them, the per-tier controller on strategy pallas,
    chunked sparse prefill in chunks of 64, batch 4, 8 requests of mixed
    tiers with 96-192-token prompts and 16 new tokens each.  Launch
    counters reset before the server is built, so the load-time sign packs
    (every MLP: the encoder's too) count; launches exact; the encoder run
    once an admission; the peak memory; a profiled decode step."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import model_module
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    arch, name, _ = CROSS_ARCHS[fam]
    base = get_config(arch)
    depth = {} if fam == "encdec" else dict(n_layers=VLM_SERVE_LAYERS)
    cfg = base.replace(kv_cache_dtype="bfloat16", sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True, sparse_prefill=True,
        prefill_max_tokens=max(base.sparse.prefill_max_tokens, MAIN_CHUNK)),
        **depth)
    mod = model_module(cfg)
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK,
                       controller=ControllerConfig(enabled=True,
                                                   per_tier=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mod.init_lm(cfg, 0, "cuda")
    _perturb(params, cfg, torch.Generator(device="cuda").manual_seed(1))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    extra = {name: np.random.default_rng(0).standard_normal(
        (MAIN_BATCH, getattr(cfg, CROSS_ARCHS[fam][2]), cfg.d_model),
        dtype=np.float32)}
    ops.reset_launch_counts()
    srv = Server(mod, cfg, scfg, params, extra_inputs=extra, device="cuda")
    del params
    torch.cuda.synchronize()
    load = ops.launch_counts()
    L = cfg.n_layers
    packs = L + cfg.n_enc_layers
    if load != _want_launches(load, sign_pack=packs):
        fail(f"serve-{arch}: load launches {load}, want {packs} sign packs")
    layers = (f"{cfg.n_enc_layers} encoder + {L} decoder layers"
              if fam == "encdec" else
              f"{L} layers ({L // cfg.cross_every} gated cross blocks)")
    print(f"[cross-serve] {arch}: {layers}, weights {n_bytes / 1e9:.2f} GB "
          f"{cfg.param_dtype}, compute {cfg.dtype}, {cfg.kv_cache_dtype} "
          f"caches, {name} {extra[name].shape}; {packs} sign packs at load; "
          f"memory after load {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"of {torch.cuda.get_device_properties(0).total_memory / 1e9:.2f};"
          f" init {time.perf_counter() - t0:.1f} s", flush=True)
    encodes = [0]
    if hasattr(mod, "encode"):
        encode = mod.encode

        def counting(*args, **kw):
            encodes[0] += 1
            return encode(*args, **kw)
        mod.encode = counting
    rng = np.random.default_rng(38)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(96, 193))),
                max_new=16, sla=tiers[i % 3]) for i in range(8)]
    steps0, run0 = srv.decode_steps, srv.prefill_chunks_run
    t1 = time.perf_counter()
    try:
        done = srv.serve(reqs)
        torch.cuda.synchronize()
    finally:
        if hasattr(mod, "encode"):
            mod.encode = encode
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    chunks = srv.prefill_chunks_run - run0
    if len(done) != len(reqs) or any(
            r.outcome != "completed" or len(r.out) != 16
            or not ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done):
        fail(f"serve-{arch}: not every request completed with 16 valid "
             "tokens")
    if hasattr(mod, "encode") and encodes[0] != len(reqs):
        fail(f"serve-{arch}: {encodes[0]} encodes for {len(reqs)} "
             "admissions")
    n_chunks = sum(-(-len(r.prompt) // MAIN_CHUNK) for r in reqs)
    want = _want_launches(counts, sign_pack=packs,
                          predict_group_margins=L * steps,
                          fused_sparse_mlp=L * steps,
                          predict_chunk_group_margins=L * chunks,
                          fused_sparse_mlp_chunk=L * chunks)
    if steps == 0 or counts != want or chunks != n_chunks:
        fail(f"serve-{arch}: launches {counts}, want {want} ({steps} decode "
             f"steps, {chunks} of {n_chunks} chunks)")
    rep = throughput_report(done)
    print(f"[cross-serve] {arch} throughput_report {json.dumps(rep)}",
          flush=True)
    ctl = srv.controller.report()
    print(f"[cross-serve] {arch} controller: steps {ctl['steps']}, prefill "
          f"chunks {ctl['prefill_chunks']}, audits {ctl['audits']}",
          flush=True)
    print(f"[cross-serve] {arch}: {wall:.1f} s; decode steps {steps}; "
          f"prefill chunks {chunks}; encodes {encodes[0]}; launches from "
          f"load {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    b = MAIN_BATCH
    caches = mod.init_caches(cfg, b, scfg.max_len, "cuda")
    for part in caches["cross"]:
        for buf in part.values():
            buf.normal_()
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, 1)),
                          device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    profile_step(f"decode step {arch} (B={b}, {layers}, bf16 caches)",
                 lambda: mod.decode_step(srv.params, cfg, tok, caches,
                                         lengths))
    del srv, caches
    torch.cuda.empty_cache()


def phase_cross(results: dict) -> None:
    """The cross-attention families on the card: (a) the kernels at
    seamless-m4t-medium's and llama-3.2-vision-90b's FFN widths, (b) two
    full-width layers of each (a decoder layer and a gated cross block
    among them) card against CPU, (c) seamless served at full depth and
    the vlm at full width and ``VLM_SERVE_LAYERS`` layers."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for step, fn in (("a", lambda: _cross_kernel_cases(gen,
                                                       flush_buf.zero_)),
                     ("b", _cross_layers),
                     ("c seamless-m4t-medium", lambda: _cross_serve("encdec")),
                     ("c llama-3.2-vision-90b", lambda: _cross_serve("vlm"))):
        t = time.perf_counter()
        fn()
        print(f"[cross] ({step}) {time.perf_counter() - t:.1f} s", flush=True)
    del flush_buf
    torch.cuda.empty_cache()


# ----------------------------------------------------- phase 19: recurrent --

REC_ARCHS = ("zamba2-1.2b", "xlstm-125m")
REC_LAYERS = 13           # zamba2 in (b): two invocations and a tail layer
REC_PLEN, REC_MAX_LEN = 100, 128   # 100 tokens: two Mamba2 chunks of 50
STATE_TOL = 1e-3          # a recurrent state's card-CPU gap, x max |state|


def _perturb_recurrent(params, gen) -> None:
    """In place: the leaves the reference starts at a value that would
    hide a fault, drawn from ``gen``: RMSNorm scales, LoRA up-projections
    (0 at init: no delta) and conv biases 0.3 N(0, 1); Mamba2's D
    U(0.5, 1.5); dt biases and xlstm's gate biases shifted by 0.3 N(0, 1)."""
    import torch

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        for name, v in node.items():
            if isinstance(v, (dict, list)):
                walk(v)
            elif name in ("scale", "lora_b_q", "conv_b"):
                v.copy_(torch.randn(v.shape, generator=gen,
                                    device=v.device) * 0.3)
            elif name == "D":
                v.copy_(torch.rand(v.shape, generator=gen,
                                   device=v.device) + 0.5)
            elif name in ("dt_bias", "b_if", "b"):
                v.add_(torch.randn(v.shape, generator=gen,
                                   device=v.device) * 0.3)
    walk(params)


def _recurrent_forced(params, cfg, dev, keep: dict):
    """Prefill a seeded batch of 4 prompts of ``REC_PLEN`` tokens, then 8
    teacher-forced decode steps with the MLP stats on and per-slot alphas
    whose rows all differ (the schedule, a ramp over the rows, SLA-like
    offsets), so an invocation reading another row would move its
    selection -> logits (1 + steps, B, V) on the CPU; the caches after
    the last step go to ``keep[dev]``, on the CPU."""
    import numpy as np
    import torch
    from repro_torch.models import lm

    b, steps = DEC_BATCH, DEC_STEPS
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(b, REC_PLEN))
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    ramp = np.linspace(-0.02, 0.02, cfg.n_layers, dtype=np.float32)
    alphas = (cfg.sparse.alpha_schedule().alphas(cfg.n_layers)
              + ramp)[:, None] + np.asarray([0.0, -0.02, 0.02, 0.0],
                                            np.float32)[None, :]
    with torch.inference_mode():
        lg, caches = lm.prefill(params, cfg,
                                torch.as_tensor(prompt, device=dev),
                                REC_MAX_LEN)
        out = [lg.float().cpu()]
        for t in range(steps):
            lg, caches, _ = lm.decode_step(
                params, cfg, torch.as_tensor(forced[t], device=dev), caches,
                torch.full((b,), REC_PLEN + t, device=dev), alphas=alphas,
                collect_stats=True)
            out.append(lg.float().cpu())
    keep[dev] = _to(caches, "cpu")
    return torch.stack(out)


def _hold_states(label: str, keep: dict) -> None:
    """Every leaf of the card's caches (the recurrent states and the KV
    caches) within ``STATE_TOL`` x its largest magnitude of the CPU's."""
    worst, where = 0.0, ""
    for part, layers in keep["cpu"].items():
        for i, (cpu, card) in enumerate(zip(layers, keep["cuda"][part])):
            for name, want in cpu.items():
                got, want = card[name].float(), want.float()
                rel = float((got - want).abs().max()) / (
                    float(want.abs().max()) or 1.0)
                if rel > worst:
                    worst, where = rel, f"{part}[{i}] {name}"
                if rel > STATE_TOL:
                    fail(f"{label}: {part}[{i}] {name} {rel:.3e} x max|state|"
                         f" from the CPU's (tolerance {STATE_TOL})")
    print(f"{label}: states and caches within {worst:.3e} x max|state| of "
          f"the CPU's (largest at {where})", flush=True)


def _recurrent_kernel_cases(gen, flush) -> None:
    """(a): the sparse MLP's kernels at zamba2-1.2b's shared block widths
    (d=2048, k=8192: 1024 groups, capacity 208), bf16 x:
    ``_mlp_kernel_times``."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("zamba2-1.2b")
    _mlp_kernel_times("recurrent-kernels", "zamba2-1.2b shared MLP",
                      cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                      cfg.sparse.capacity(cfg.d_ff), gen, flush)


def _recurrent_layers() -> None:
    """(b): zamba2 at full width and ``REC_LAYERS`` layers, xlstm-125m at
    full width and depth, float32 compute and KV, the config's own
    selection (capacity 20%: the clamp binds), weights from ``init_lm`` on
    the card with the leaves that would hide a fault drawn non-zero
    (``_perturb_recurrent``), copied to the CPU; card against CPU through
    ``_hold`` and ``_hold_states``.  Launches exact: two kernels an
    invocation of the shared block a step (pallas: the predictor and the
    MLP; masked and gather: x's sign pack and the counts), none for
    xlstm."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    for i, arch in enumerate(REC_ARCHS):
        t0 = time.perf_counter()
        base = get_config(arch)
        depth = dict(n_layers=REC_LAYERS) if base.family == "hybrid" else {}
        cfg = base.replace(dtype="float32", kv_cache_dtype="float32",
                           **depth)
        if base.family == "hybrid":
            cfg = cfg.replace(sparse=dataclasses.replace(
                cfg.sparse, strategy="pallas", enabled=True))
            n_inv, n_main, n_tail = lm._hybrid_layout(cfg)
            mc = lm.mamba_cfg(cfg)
            shape = (f"{n_inv} invocations of the shared block (H={cfg.n_heads}"
                     f" hd={cfg.resolved_head_dim}, LoRA rank "
                     f"{cfg.shared_lora_rank}, k={cfg.d_ff}, capacity "
                     f"{cfg.sparse.capacity(cfg.d_ff)} of {cfg.d_ff // G} "
                     f"groups), {n_main} + {n_tail} Mamba2 layers (d_inner "
                     f"{mc.d_inner}, {mc.n_heads} heads of {mc.head_dim}, "
                     f"state {mc.d_state}, chunk {mc.chunk})")
        else:
            xc = lm.xlstm_cfg(cfg)
            p, n_groups = lm._xlstm_layout(cfg)
            shape = (f"{n_groups} groups of {p} blocks (mLSTM d_inner "
                     f"{xc.d_inner}, {xc.n_heads} heads of {xc.head_dim}; "
                     f"sLSTM heads of {xc.s_head_dim}), no MLP")
        print(f"[recurrent] {arch}: d={cfg.d_model}, vocab {cfg.vocab}, "
              f"{cfg.n_layers} layers: {shape}", flush=True)
        raw = lm.init_lm(cfg, 190 + i, "cuda")
        _perturb_recurrent(raw, torch.Generator(device="cuda").manual_seed(
            191 + i))
        if base.family != "hybrid":
            params = {"cuda": raw, "cpu": _to(raw, "cpu")}
            keep: dict = {}
            label = (f"[recurrent] {arch} prefill {REC_PLEN} + decode "
                     f"{DEC_STEPS}")
            _hold(label, lambda dev: _recurrent_forced(params[dev], cfg, dev,
                                                       keep),
                  LOGIT_TOL["float32"], {})
            _hold_states(label, keep)
        else:
            n_inv = lm._hybrid_layout(cfg)[0]
            for weights in ("", "int8"):
                wcfg = cfg.replace(sparse=dataclasses.replace(
                    cfg.sparse, weight_dtype=weights, quant_group_size=QG))
                params = {"cuda": lm.prepare_sparse(raw, wcfg.sparse)}
                params["cpu"] = _to(params["cuda"], "cpu")
                for strategy in ("pallas", "masked", "gather") \
                        if not weights else ("pallas",):
                    run_cfg = wcfg.replace(sparse=dataclasses.replace(
                        wcfg.sparse, strategy=strategy))
                    n = n_inv * DEC_STEPS
                    if strategy == "pallas":
                        want = {"predict_group_margins": n,
                                ("fused_sparse_mlp_q" if weights
                                 else "fused_sparse_mlp"): n}
                    else:
                        want = dict(sign_pack=n, predict_counts=n)
                    keep = {}
                    label = (f"[recurrent] {arch} prefill {REC_PLEN} + "
                             f"decode {DEC_STEPS}, {strategy}, "
                             f"{weights or 'float32'} MLP weights")
                    _hold(label, lambda dev, c=run_cfg: _recurrent_forced(
                        params[dev], c, dev, keep), LOGIT_TOL["float32"],
                        want)
                    _hold_states(label, keep)
                del params
        del raw
        torch.cuda.empty_cache()
        print(f"[recurrent] {arch} layers: {time.perf_counter() - t0:.1f} s",
              flush=True)


def _recurrent_serve(arch: str) -> None:
    """(c): ``arch`` at full depth through Server.serve: random float32
    weights from a seed, perturbed (``_perturb_recurrent``), bf16 compute
    and caches, batch 4, 8 requests of mixed tiers with 96-192-token
    prompts and 16 new tokens each.  zamba2-1.2b: the per-tier controller
    on pallas and ``prefill_chunk=64``, which must warn and admit through
    the monolithic prefill; xlstm-125m: the plain serve.  Launch counters
    reset before the server is built, so the load-time sign pack counts;
    launches exact; the peak memory; a profiled decode step."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    if hybrid:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, strategy="pallas", enabled=True))
        scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                           prefill_chunk=MAIN_CHUNK,
                           controller=ControllerConfig(enabled=True,
                                                       per_tier=True))
        n_inv = lm._hybrid_layout(cfg)[0]
    else:
        scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16)
        n_inv = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    _perturb_recurrent(params, torch.Generator(device="cuda").manual_seed(1))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        srv = Server(lm, cfg, scfg, params, device="cuda")
    warned = [str(w.message) for w in rec
              if "has no chunked prefill" in str(w.message)]
    if hybrid and len(warned) != 1:
        fail(f"serve-{arch}: prefill_chunk={MAIN_CHUNK} gave {len(warned)} "
             "monolithic-prefill warnings, want 1")
    del params
    torch.cuda.synchronize()
    load = ops.launch_counts()
    packs = 1 if hybrid else 0
    if load != _want_launches(load, sign_pack=packs):
        fail(f"serve-{arch}: load launches {load}, want {packs} sign packs")
    print(f"[recurrent-serve] {arch}: {cfg.n_layers} layers, weights "
          f"{n_bytes / 1e9:.2f} GB {cfg.param_dtype}, compute {cfg.dtype}, "
          f"{cfg.kv_cache_dtype} caches; {packs} sign packs at load"
          + (f"; warned: {warned[0]!r}" if warned else "")
          + f"; memory after load {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB; init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(39)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(96, 193))),
                max_new=16, sla=tiers[i % 3]) for i in range(8)]
    steps0 = srv.decode_steps
    t1 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    # the head covers the padded vocabulary (xlstm-125m: 50304 -> 50432),
    # whose extra rows random weights can win
    if len(done) != len(reqs) or any(
            r.outcome != "completed" or len(r.out) != 16
            or not ((r.out >= 0) & (r.out < cfg.vocab_padded)).all()
            for r in done):
        fail(f"serve-{arch}: not every request completed with 16 tokens in "
             f"[0, {cfg.vocab_padded}): "
             f"{[(r.outcome, len(r.out), int(r.out.max())) for r in done]}")
    want = _want_launches(counts, sign_pack=packs,
                          predict_group_margins=n_inv * steps,
                          fused_sparse_mlp=n_inv * steps)
    if steps == 0 or counts != want or srv.prefill_chunks_run:
        fail(f"serve-{arch}: launches {counts}, want {want} ({steps} decode "
             f"steps, {srv.prefill_chunks_run} prefill chunks)")
    rep = throughput_report(done)
    print(f"[recurrent-serve] {arch} throughput_report {json.dumps(rep)}",
          flush=True)
    if hybrid:
        ctl = srv.controller.report()
        print(f"[recurrent-serve] {arch} controller: {ctl['steps']} steps, "
              f"{len(ctl['tiers']['balanced']['alpha_per_layer'])} alpha "
              f"rows, audits {ctl['audits']}", flush=True)
    print(f"[recurrent-serve] {arch}: {wall:.1f} s; decode steps {steps}; "
          f"launches from load {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    b = MAIN_BATCH
    caches = lm.init_caches(cfg, b, scfg.max_len, "cuda")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, 1)),
                          device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    profile_step(f"decode step {arch} (B={b}, {cfg.n_layers} layers, bf16 "
                 "compute and caches)",
                 lambda: lm.decode_step(srv.params, cfg, tok, caches,
                                        lengths))
    del srv, caches
    torch.cuda.empty_cache()


def phase_recurrent(results: dict) -> None:
    """The recurrent families on the card: (a) the sparse MLP's kernels at
    zamba2-1.2b's shared block widths, (b) zamba2 at 13 full-width layers
    and xlstm-125m whole, card against CPU, (c) both served at full
    depth."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for step, fn in (("a", lambda: _recurrent_kernel_cases(
                          gen, flush_buf.zero_)),
                     ("b", _recurrent_layers),
                     ("c zamba2-1.2b", lambda: _recurrent_serve(
                         "zamba2-1.2b")),
                     ("c xlstm-125m", lambda: _recurrent_serve(
                         "xlstm-125m"))):
        t = time.perf_counter()
        fn()
        print(f"[recurrent] ({step}) {time.perf_counter() - t:.1f} s",
              flush=True)
    del flush_buf
    torch.cuda.empty_cache()


TRAIN_DEVICE = "cuda"     # the card (a rehearsal on the CPU sets "cpu")
TRAIN_ARCH = "prosparse-llama2-7b"
TRAIN_LAYERS = 4          # (b): a cut of depth only, every width published
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 12
# (c): xlstm-125m's time loops are launch-bound (~15 ms a time step and
# block for a training step's forward, recomputes and backward), so the
# crash-and-resume runs 64 time steps through one group of its blocks
# (slstm_every=4: three mLSTM blocks and an sLSTM one), full width
RESUME_SEQ = 64
RESUME_LAYERS = 4
# (d): every other family the card holds whole or at a depth cut, 3 steps
TRAIN_FAMILIES = (("zamba2-1.2b", {}), ("seamless-m4t-medium", {}),
                  ("gemma2-2b", {}), ("olmoe-1b-7b", {"n_layers": 2}),
                  ("deepseek-moe-16b", {"n_layers": 2}))


def _train_opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr_peak=3e-4, lr_min=3e-5, warmup_steps=1,
                       decay_steps=100)


def _train_cpu_vs_card() -> None:
    """(a): one loss, backward and AdamW update of prosparse-llama2-7b at
    full width and 2 layers, on the card and on the CPU from the same
    weights and batch: float32, then the config's bf16 compute."""
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_update, cosine_lr, init_adamw
    from repro_torch.tree import flatten, path_str, unflatten

    base = get_config(TRAIN_ARCH).replace(n_layers=2)
    tree = _numpy_tree(base, 60)
    batch = SyntheticSource(DataConfig(vocab=base.vocab, seq_len=64,
                                       global_batch=1)).batch_at(0)
    opt = _train_opt()
    lr1 = float(cosine_lr(opt, 1))
    for dtype, loss_tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        cfg = base.replace(dtype=dtype, param_dtype="float32")
        out = [None, None]
        for i, dev in enumerate((TRAIN_DEVICE, "cpu")):
            params = bridge.params_from_numpy(tree, cfg, device=dev)
            leaves = [p.requires_grad_(True) for _, p in flatten(params)]
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            signs = []

            def tap(orig, p, x, c, **kw):
                # the ReLU gate's pre-activation signs, as the MLP forms them
                with torch.no_grad():
                    signs.append((x @ p["wg_t"].to(x.dtype).T > 0).reshape(
                        -1, p["wg_t"].shape[0]).cpu())
                return orig(p, x, c, **kw)
            with _mlp_tap(tap):
                loss, _ = lm.lm_loss(params, cfg, b)
                grads = torch.autograd.grad(loss, leaves)
            params, _, met = adamw_update(opt, params, unflatten(
                params, grads), init_adamw(params))
            names = [path_str(path) for path, _ in flatten(params)]
            out[i] = (float(loss.detach()), [g.cpu() for g in grads],
                        [p.detach().cpu() for _, p in flatten(params)],
                        float(met["grad_norm"]), signs[:cfg.n_layers])
            del params, leaves, grads, loss
            torch.cuda.empty_cache()
        (l_c, g_c, p_c, n_c, s_c), (l_h, g_h, p_h, n_h, s_h) = out
        rel = abs(l_c - l_h) / abs(l_h)
        # a gate pre-activation within rounding of 0 can take the ReLU's
        # other side on the other device: that neuron's row of the gate
        # gradient then gains or loses the token's whole term.  Those rows
        # are counted and left out of the gate leaves' check
        flipped = [(a != b).any(0) for a, b in zip(s_c, s_h)]
        gaps = []
        for a, b, n in zip(g_c, g_h, names):
            parts = n.split("/")
            if parts[-1] == "wg_t" and parts[0] == "blocks":
                keep = ~flipped[int(parts[1])]
                a, b = a[keep], b[keep]
            gaps.append((float((a - b).abs().max() / b.abs().max()
                               .clamp_min(1e-30)), n, float(b.abs().max())))
        gaps.sort(reverse=True)
        g_rel = gaps[0][0]
        p_gap = max(float((a - b).abs().max()) for a, b in zip(p_c, p_h))
        beyond = sum(int(((a - b).abs() > 1e-6).sum())
                     for a, b in zip(p_c, p_h))
        total = sum(a.numel() for a in p_c)
        print(f"[train] (a) {dtype} compute: loss card {l_c:.6f} cpu "
              f"{l_h:.6f} (rel gap {rel:.2e}), grad norm {n_c:.5f} / "
              f"{n_h:.5f}, worst gradient leaf gap {g_rel:.2e} x its max, "
              f"params after one AdamW step: max gap {p_gap:.2e} (bound "
              f"{2 * lr1 + 1e-6:.2e}), {beyond} of {total} beyond 1e-6",
              flush=True)
        print(f"[train] (a) gate rows with a pre-activation on the other "
              f"side of 0 (left out of wg_t's check): "
              f"{[int(f.sum()) for f in flipped]} of {s_h[0].shape[1]} a "
              "layer; largest gradient gaps (x the leaf's max; its max): "
              + ", ".join(f"{n} {g:.2e} ({m:.2e})" for g, n, m in gaps[:6]),
              flush=True)
        if not rel <= loss_tol:
            fail(f"train (a) {dtype}: loss gap {rel:.2e} > {loss_tol}")
        if dtype == "float32":
            if not g_rel <= 1e-3:
                fail(f"train (a): a gradient leaf is {g_rel:.2e} x its "
                     "largest magnitude off the CPU's")
            # a flipped sign is a rounding tie, so only a few rows may flip
            most = max(int(f.sum()) for f in flipped)
            if not most <= 1e-3 * s_h[0].shape[1]:
                fail(f"train (a): {most} gate rows of {s_h[0].shape[1]} "
                     "flipped the ReLU's side in one layer (> 0.1%)")
            if not p_gap <= 2 * lr1 + 1e-6:
                fail(f"train (a): params {p_gap:.2e} apart after one step")
            # the 2 lr bound holds any sign-like step: the count beyond
            # 1e-6 is what separates a few ties from wrong gradients
            if not beyond <= 1e-2 * total:
                fail(f"train (a): {beyond} of {total} params beyond 1e-6 "
                     "after one step (> 1%)")
        del out
    del tree


def _train_trainer(cfg, batch: int, seq: int, ckpt_dir: str, seed: int = 0,
                   **tkw):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.specs import model_module
    from repro_torch.launch.train import extra_batch_fn
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    tkw.setdefault("ckpt_every", 10 ** 9)
    t = Trainer(model_module(cfg), cfg, TrainerConfig(ckpt_dir=ckpt_dir,
                                                      **tkw),
                _train_opt(), DataConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch),
                device=TRAIN_DEVICE,
                extra_batch=extra_batch_fn(cfg, batch, TRAIN_DEVICE))
    t.init_state(seed)
    return t


def _check_finite(label: str, hist: list) -> None:
    import math
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train {label}: step {h['step']} loss {h['loss']} grad "
                 f"norm {h['grad_norm']}")


def _n_params(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


def _step_flops(cfg, params, tokens: int, b: int, s: int) -> tuple:
    """(model FLOPs of a training step, recompute FLOPs): 6 N tokens over
    the weights that multiply (every block and the output table; the
    embedding is a lookup) plus attention's QK^T and PV over the full S x
    S scores the port computes, times 3 for forward and backward; the
    recompute of ``remat`` is one more forward of the blocks."""
    blocks = _n_params(params["blocks"])
    head = params.get("unembed", params["embed"])["table"].numel()
    hd = cfg.resolved_head_dim
    attn_fwd = cfg.n_layers * 4 * b * s * s * cfg.n_heads * hd
    model = 6 * (blocks + head) * tokens + 3 * attn_fwd
    recompute = (2 * blocks * tokens + attn_fwd) if cfg.remat else 0
    return model, recompute


def _train_full_width(tmp: str) -> None:
    """(b): prosparse-llama2-7b at full width and 4 layers through the
    Trainer, then the deterministic double run."""
    import statistics

    import torch
    from repro_torch.configs.registry import get_config

    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS, remat=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = _train_trainer(cfg, TRAIN_BATCH, TRAIN_SEQ, tmp)
    n = _n_params(t.params)
    hist = t.run(steps=TRAIN_STEPS)
    _check_finite("(b)", hist)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(h["time_s"] for h in hist) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model, recompute = _step_flops(cfg, t.params, tokens, TRAIN_BATCH,
                                   TRAIN_SEQ)
    share = model / (ms / 1e3) / BF16_OPS_PER_S
    print(f"[train] (b) {TRAIN_ARCH} at full width, {TRAIN_LAYERS} layers "
          f"({n / 1e9:.3f} G params, float32 params, bf16 compute, remat), "
          f"global batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"{[round(h['loss'], 4) for h in hist]}, median step "
          f"{ms:.1f} ms (steps {[round(h['time_s'] * 1e3, 1) for h in hist]}"
          f"), {tokens / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GB",
          flush=True)
    print(f"[train] (b) model FLOPs a step {model / 1e12:.2f} T (6 N tokens "
          f"+ attention) and {recompute / 1e12:.2f} T recomputed; model "
          f"FLOPs / step time = {model / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{share:.3f} of the H100's bf16 dense peak (989 TFLOP/s), "
          f"{(model + recompute) / (ms / 1e3) / BF16_OPS_PER_S:.3f} with "
          "the recompute", flush=True)
    # profile_step sets the launch counts to zero: read (b)'s so far first
    _no_serving_launches("(b) Trainer steps")
    profile_step(f"train step ({TRAIN_ARCH}, {TRAIN_LAYERS} layers, "
                 f"B={TRAIN_BATCH}, S={TRAIN_SEQ})",
                 lambda: t.run(steps=1), steps=1, grad=True)
    del t
    torch.cuda.empty_cache()
    losses = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            t = _train_trainer(cfg, TRAIN_BATCH, TRAIN_SEQ, tmp, seed=5)
            losses.append([h["loss"] for h in t.run(steps=4)])
            del t
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[train] (b) deterministic algorithms, 4 steps twice from seed 5:"
          f" {losses[0]} / {losses[1]}", flush=True)
    if losses[0] != losses[1]:
        fail("train (b): two deterministic runs from one seed differ")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _train_resume(tmp: str) -> None:
    """(c): xlstm-125m at ``RESUME_LAYERS`` layers crashed at step 5 and
    resumed from step 3's async checkpoint, bitwise an uninterrupted run,
    deterministic algorithms on."""
    import torch
    from repro_torch.configs.registry import get_config

    cfg = get_config("xlstm-125m").replace(n_layers=RESUME_LAYERS)
    ck = os.path.join(tmp, "xlstm")
    torch.use_deterministic_algorithms(True)
    try:
        t1 = _train_trainer(cfg, 4, RESUME_SEQ, ck, ckpt_every=3,
                            async_ckpt=True)
        try:
            t1.run(steps=10, fail_at=5)
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            fail("train (c): the injected failure did not fire")
        steps_1 = [round(h["time_s"] * 1e3, 1) for h in t1.history]
        del t1
        torch.cuda.empty_cache()
        t2 = _train_trainer(cfg, 4, RESUME_SEQ, ck, ckpt_every=3,
                            async_ckpt=True)
        if not t2.maybe_resume() or t2.global_step != 3:
            fail(f"train (c): resumed at {t2.global_step}, not step 3")
        resumed = {h["step"]: h["loss"] for h in t2.run(steps=3)}
        nbytes = _dir_bytes(os.path.join(ck, "step_00000003"))
        t0 = time.perf_counter()
        t2.save(blocking=True)
        write_s = time.perf_counter() - t0
        del t2
        torch.cuda.empty_cache()
        t3 = _train_trainer(cfg, 4, RESUME_SEQ,
                            os.path.join(tmp, "xlstm_ref"))
        ref = {h["step"]: h["loss"] for h in t3.run(steps=6)}
        del t3
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    got, want = [resumed[s] for s in (4, 5, 6)], [ref[s] for s in (4, 5, 6)]
    print(f"[train] (c) xlstm-125m ({RESUME_LAYERS} layers) B=4 "
          f"S={RESUME_SEQ}: crashed at step 5 "
          f"(step ms {steps_1}), resumed at 3: steps 4-6 {got} / "
          f"uninterrupted {want}; a checkpoint "
          f"(params, mu, nu) {nbytes / 1e9:.3f} GB, a blocking save "
          f"{write_s:.2f} s", flush=True)
    if got != want:
        fail("train (c): the resumed steps differ from the uninterrupted run")


def _train_families(tmp: str) -> None:
    """(d): 3 steps of every other family the card holds."""
    import gc
    import statistics

    import torch
    from repro_torch.configs.registry import get_config

    for arch, cut in TRAIN_FAMILIES:
        cfg = get_config(arch).replace(**cut)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 1e9
        t = _train_trainer(cfg, 2, 256, os.path.join(tmp, arch))
        n = _n_params(t.params)
        hist = t.run(steps=3)
        _check_finite(f"(d) {arch}", hist)
        print(f"[train] (d) {arch} ({cfg.n_layers} layers, {n / 1e9:.3f} G "
              f"params) B=2 S=256: losses "
              f"{[round(h['loss'], 4) for h in hist]}, grad norms "
              f"{[round(h['grad_norm'], 3) for h in hist]}, median step "
              f"{statistics.median(h['time_s'] for h in hist) * 1e3:.1f} ms, "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
              f" ({before:.2f} GB held before the trainer)", flush=True)
        del t
    torch.cuda.empty_cache()


# (e): a 2x2 of gloo ranks sharing the card against one process, as
# (a) holds the card against the CPU: full width, float32 compute
MESH_TRAIN = (2, 2)
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 4, 256
# The ranks' steps against one process's, each step held from the ranks'
# own state before it (params and moments gathered whole), as the serving
# mesh is held teacher-forced: a placed step differs from one process's by
# summation order only, so its loss is within this relative gap, its
# grad norm within 1e-4, and every param leaf after it within 1e-4 x its
# max but for ties, at most this share of the tree's elements (the share
# phase 20 (a) allows): an element whose gradient lies within rounding of 0 (or
# near Adam's eps) takes a different step, up to 2 lr apart; a gate
# pre-activation within rounding of 0 makes its MLP rows such elements.
# Float32 compute: the one process's bf16 GEMMs may reduce in bf16
# (cuBLAS's reduced-precision reductions), the ranks' partials in float32
MESH_LOSS_REL, MESH_PARAM_REL, MESH_TIE_SHARE = 1e-5, 1e-4, 1e-2
MESH_HELD_STEPS = 2


@contextlib.contextmanager
def _count_collectives(counts: dict):
    """``_count_lines`` plus every gather over all the ranks
    (``sharding.train``'s tree sums and whole leaves) as "world"."""
    from repro_torch.sharding import train as ST
    world = ST._world_parts

    def on_world(vec):
        counts["world"] = counts.get("world", 0) + 1
        return world(vec)
    ST._world_parts = on_world
    try:
        with _count_lines(counts):
            yield
    finally:
        ST._world_parts = world


def _mesh_train_cfg(spec: dict):
    from repro_torch.configs.registry import get_config
    cfg = get_config(spec["arch"]).replace(n_layers=spec["layers"],
                                           remat=True)
    return cfg.replace(dtype=spec["dtype"]) if spec.get("dtype") else cfg


def _mesh_trainer(cfg, spec: dict, dev, mesh=None, ckpt_dir: str = "",
                  seed: int = 0):
    import tempfile
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.specs import model_module
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    t = Trainer(model_module(cfg), cfg, TrainerConfig(
        ckpt_dir=ckpt_dir or tempfile.mkdtemp(prefix="chip_smoke_mesh_"),
        ckpt_every=10 ** 9), _train_opt(),
        DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                   global_batch=spec["batch"]), device=dev, mesh=mesh)
    t.init_state(seed)
    return t


def _param_gaps(got: dict, want: dict) -> tuple:
    """(leaves wholly within ``MESH_PARAM_REL`` x their max, leaves, the
    share of the tree's elements beyond it, the largest gap, the leaf
    with most elements beyond)."""
    within, beyond, total, worst, most, where = 0, 0, 0, 0.0, -1, ""
    for path, w in want.items():
        gap = (got[path].float() - w.float()).abs()
        n = int((gap > MESH_PARAM_REL * w.abs().max()).sum())
        within += n == 0
        beyond, total = beyond + n, total + w.numel()
        if n > most:
            most, where = n, f"{path}: {n} of {w.numel()}"
        worst = max(worst, float(gap.max()))
    return within, len(want), beyond / total, worst, where


def _held_step(cfg, spec: dict, dev, before: dict, step: int) -> tuple:
    """One process's step ``step`` from ``before`` (whole params, mu, nu
    by path): (loss, grad norm, params after it by path)."""
    import torch
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import flatten, path_str
    one = _mesh_trainer(cfg, spec, dev)
    with torch.no_grad():
        for name, tree in (("params", one.params), ("mu", one.opt_state.mu),
                           ("nu", one.opt_state.nu)):
            for p, v in flatten(tree):
                v.copy_(before[name][path_str(p)])
    one.opt_state = AdamWState(step - 1, one.opt_state.mu, one.opt_state.nu)
    one.global_step = step - 1
    one.data.skip_to(step - 1)
    h = one.run(steps=1)[-1]
    return h["loss"], h["grad_norm"], {path_str(p): v.detach() for p, v
                                       in flatten(one.params)}


def _train_mesh_rank(mesh, dev, spec: dict) -> dict:
    """A rank's mesh training of ``spec`` (arch, layers, batch, seq,
    steps; profile: one more step profiled, rank 0's printed; dtype: a
    compute dtype for the config's; compare: rank 0 holds
    one process's first ``MESH_HELD_STEPS`` steps, each from the ranks'
    state before it, to the ranks' (``_held_step``); ckpt: a directory
    every rank shares, where a blocking checkpoint of step 2 goes and from
    which rank 0 resumes one process for the remaining steps).  Returns
    the backend, the history, the rank's parameter and moment bytes, its
    peak memory after init and overall, step 2's collectives by axis, the
    serving kernels launched, and on rank 0 the comparisons."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import param_shapes
    from repro_torch.sharding import train as ST
    from repro_torch.tree import flatten, path_str, tree_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _mesh_train_cfg(spec)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    t = _mesh_trainer(cfg, spec, dev, mesh, spec.get("ckpt", ""))
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    out = {"backend": dist.get_backend(), "init_s": init_s,
           "init_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "param_bytes": tree_bytes(t.params),
           "opt_bytes": tree_bytes(t.opt_state.mu)
           + tree_bytes(t.opt_state.nu),
           "whole_param_bytes": tree_bytes(param_shapes(cfg)), "held": []}

    def whole(tree) -> dict:
        return {path_str(p): ST.whole_leaf(v.detach(), s)
                for (p, v), (_, s) in zip(flatten(tree), flatten(t.layout))}
    ops.reset_launch_counts()
    for step in range(1, MESH_HELD_STEPS + 1):
        before = ({"params": whole(t.params), "mu": whole(t.opt_state.mu),
                   "nu": whole(t.opt_state.nu)} if spec.get("compare")
                  else None)
        counts: dict = {}
        with _count_collectives(counts):
            hist = t.run(steps=1)
        out["collectives"] = counts
        if before is None:
            continue
        after = whole(t.params)
        if mesh.rank == 0:
            # the other ranks wait at the next collective meanwhile
            loss, norm, params = _held_step(cfg, spec, dev, before, step)
            out["held"].append((loss, norm, _param_gaps(after, params)))
        del before, after
        gc.collect()
        torch.cuda.empty_cache()
    if spec.get("ckpt"):
        t.save(blocking=True)
    hist = t.run(steps=spec["steps"] - MESH_HELD_STEPS)
    torch.cuda.synchronize(dev)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["history"] = [{k: h[k] for k in ("step", "loss", "grad_norm",
                                          "time_s")} for h in hist]
    if spec.get("profile"):
        # one more step on every rank, rank 0's profile printed
        quiet = open(os.devnull, "w") if mesh.rank else None
        with contextlib.redirect_stdout(quiet or sys.stdout):
            profile_step(f"train step on the {mesh.shape[0]}x"
                         f"{mesh.shape[1]} mesh, rank 0 ({cfg.name}, "
                         f"{cfg.n_layers} layers, B={spec['batch']}, "
                         f"S={spec['seq']})", lambda: t.run(steps=1),
                         steps=1, grad=True, warm=False)
        if quiet:
            quiet.close()
    if mesh.rank != 0 or not spec.get("ckpt"):
        return out
    del t
    gc.collect()
    torch.cuda.empty_cache()
    res = _mesh_trainer(cfg, spec, dev, ckpt_dir=spec["ckpt"])
    if res.maybe_resume() and res.global_step == MESH_HELD_STEPS:
        out["resumed"] = {h["step"]: h["loss"] for h in res.run(
            steps=spec["steps"] - MESH_HELD_STEPS)}
    else:
        out["resumed"] = None
    del res
    torch.cuda.empty_cache()
    return out


def _train_mesh(label: str, shape: tuple, spec: dict, device: str,
                backend: str = "") -> list:
    """``_train_mesh_rank`` of ``spec`` on a (data, model) mesh of
    ``shape`` over ``backend`` (the rule's when ""): every rank's history
    (losses, grad norms, step times) bitwise rank 0's, no serving kernel
    launched; with ``compare``, rank 0's held steps of one process
    (``MESH_LOSS_REL``, grad norms within 1e-4, ``MESH_PARAM_REL`` with
    ``MESH_TIE_SHARE``), and with ``ckpt`` its resume from the ranks'
    checkpoint of step 2 held to their later steps.  Returns the ranks'
    outputs."""
    import math

    from repro_torch.launch.ranks import run_ranks
    from repro_torch.optim.adamw import cosine_lr

    t = time.perf_counter()
    outs = run_ranks(_train_mesh_rank, shape, ("data", "model"),
                     args=(spec,), device=device, timeout=CARDS4_TIMEOUT,
                     backend=backend)
    wall = time.perf_counter() - t
    hist = outs[0]["history"]
    for r, o in enumerate(outs):
        if o["history"] != hist:
            fail(f"train {label}: rank {r}'s history differs from rank 0's")
        if o["launches"]:
            fail(f"train {label}: rank {r} launched serving kernels "
                 f"{o['launches']}")
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train {label}: step {h['step']} loss {h['loss']}")
    print(f"[train] {label}: {len(outs)} ranks over "
          f"{sorted({o['backend'] for o in outs})}, "
          f"{wall:.1f} s (start, init, {spec['steps']} steps); every rank's "
          f"losses, grad norms and step times bitwise rank 0's: losses "
          f"{[h['loss'] for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 5) for h in hist]}; step ms "
          f"{[round(h['time_s'] * 1e3, 1) for h in hist]}; a rank "
          f"{outs[0]['param_bytes'] / 1e9:.3f} GB params and "
          f"{outs[0]['opt_bytes'] / 1e9:.3f} GB moments, peak "
          f"{[round(o['peak_gb'], 2) for o in outs]} GB; collectives in "
          f"step {MESH_HELD_STEPS} {outs[0]['collectives']}", flush=True)
    if not spec.get("compare"):
        return outs
    for step, (loss, norm, gaps) in enumerate(outs[0]["held"], 1):
        want = hist[step - 1]
        rel = abs(loss - want["loss"]) / abs(loss)
        nrel = abs(norm - want["grad_norm"]) / abs(norm)
        within, n, share, worst, where = gaps
        bound = 2 * float(cosine_lr(_train_opt(), step)) + 1e-6
        print(f"[train] {label}: step {step} of one process from the ranks' "
              f"state before it: loss {loss} (relative gap {rel:.2e}), "
              f"grad norm relative gap {nrel:.2e}; params after it: "
              f"{within} of {n} leaves wholly within {MESH_PARAM_REL} x "
              f"their max, {share:.2e} of the elements beyond (most in "
              f"{where}), the largest gap {worst:.2e} (2 lr: {bound:.2e})",
              flush=True)
        if rel > MESH_LOSS_REL or nrel > 1e-4:
            fail(f"train {label}: step {step}'s loss ({rel:.2e}) or grad "
                 f"norm ({nrel:.2e}) off one process's")
        if share > MESH_TIE_SHARE or worst > bound:
            fail(f"train {label}: params after step {step} off one "
                 f"process's: {share:.2e} of the elements beyond "
                 f"{MESH_PARAM_REL} x their leaf's max (most in {where}), "
                 f"largest gap {worst:.2e}")
    if spec.get("ckpt"):
        res = outs[0]["resumed"]
        if res is None:
            fail(f"train {label}: one process did not resume at step 2 "
                 "from the ranks' checkpoint")
        rr = [abs(res[h["step"]] - h["loss"]) / abs(h["loss"])
              for h in hist[MESH_HELD_STEPS:]]
        print(f"[train] {label}: the ranks' checkpoint of step 2 resumed "
              f"by one process: steps 3-{spec['steps']} {list(res.values())}"
              f" (relative gaps {[f'{x:.2e}' for x in rr]} to the ranks' "
              "uninterrupted steps)", flush=True)
        if max(rr) > MESH_LOSS_REL:
            fail(f"train {label}: the resumed run is {max(rr):.2e} off the "
                 "ranks' uninterrupted steps")
    return outs


def _train_mesh_gloo() -> None:
    """(e): ``MESH_TRAIN`` gloo ranks sharing the card, 2 layers at full
    width, float32 compute, held to one process."""
    _train_mesh(f"(e) {TRAIN_ARCH}, {MESH_TRAIN_LAYERS} layers, float32 "
                f"compute, B={MESH_TRAIN_BATCH} S={MESH_TRAIN_SEQ}, 2x2 "
                "gloo ranks sharing the card", MESH_TRAIN,
                {"arch": TRAIN_ARCH, "layers": MESH_TRAIN_LAYERS,
                 "batch": MESH_TRAIN_BATCH, "seq": MESH_TRAIN_SEQ,
                 "steps": 2, "dtype": "float32", "compare": True},
                TRAIN_DEVICE, backend="gloo")


def phase_train(results: dict) -> None:
    """The training path on the card: (a) card against CPU, (b) full-width
    training and its deterministic double run, (c) crash and resume, (d)
    every other family, (e) a 2x2 mesh of gloo ranks sharing the card
    against one process.  No serving kernel launches."""
    import shutil
    import tempfile

    import torch
    from repro_torch.kernels import ops

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for step, fn in (("a", _train_cpu_vs_card),
                         ("b", lambda: _train_full_width(tmp)),
                         ("c", lambda: _train_resume(tmp)),
                         ("d", lambda: _train_families(tmp)),
                         ("e", _train_mesh_gloo)):
            ops.reset_launch_counts()
            t = time.perf_counter()
            fn()
            print(f"[train] ({step}) {time.perf_counter() - t:.1f} s",
                  flush=True)
            _no_serving_launches(f"({step})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[train] no serving kernel launched in any sub-phase", flush=True)
    torch.cuda.empty_cache()


def _no_serving_launches(label: str) -> None:
    """Fails if a serving kernel launched since the counts were last set
    to zero: training takes the dense MLP, as the reference does."""
    from repro_torch.kernels import ops
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        fail(f"train {label}: serving kernels launched in training: "
             f"{launched}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------ 21. the shape matrix
SHAPES_DEVICE = "cuda"    # the card (a rehearsal on the CPU sets "cpu")
SHAPE_ARCH = "prosparse-llama2-7b"
ATTN_CHECK_S = 8192       # (a): chunked against whole-sequence attention
ATTN_LONG_S = 32768       # (a): chunked only
PERM_PROMPT = 256         # (g): calibration tokens


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f} GB"


def _dry(cfg, kind: str, batch: int, seq: int) -> int:
    """The dry run's total bytes (params, caches, inputs, optimizer state
    and the step's transient peak) of ``cfg`` at one shape, on meta."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    _, _, total = dryrun.measure(cfg, ShapeConfig(kind, seq, batch, kind))
    return total


def _peak_line(label: str, dry: int) -> float:
    """Prints the card's peak allocation beside the dry run's bytes."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[shapes] {label}: peak memory {_gb(peak)}, dry run {_gb(dry)} "
          f"(peak / dry {peak / dry:.3f})", flush=True)
    return peak


def _whole_attention(q, k, v, cfg, pos):
    """Causal softmax attention over the whole sequence at once, float32:
    the yardstick of (a)."""
    import torch
    from repro_torch.layers import attention as A
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    sc = torch.einsum("bqkrh,btkh->bkrqt", qg, k.float()) * hd ** -0.5
    sc = torch.where(A._chunk_mask(cfg, pos, pos), sc,
                     torch.tensor(A.NEG_INF, device=q.device))
    p = torch.softmax(sc, -1)
    return torch.einsum("bkrqt,btkh->bqkrh", p, v.float()).reshape(
        b, s, h, hd).to(q.dtype)


def _shape_attention(raw, cfg) -> None:
    """(a) one full-width attention layer (layer 0's weights, bf16 x; q,
    k and v in float32)."""
    import torch
    from repro_torch.layers import attention as A
    from repro_torch.layers.rope import apply_rope
    from repro_torch.models import common as C
    acfg = C.attn_cfg(cfg)
    attn = raw["blocks"][0]["attn"]
    gen = torch.Generator(device=SHAPES_DEVICE).manual_seed(21)
    for s in (ATTN_CHECK_S, ATTN_LONG_S):
        x = torch.randn((1, s, cfg.d_model), generator=gen,
                        device=SHAPES_DEVICE,
                        dtype=torch.bfloat16)
        pos = torch.arange(s, device=SHAPES_DEVICE)
        with torch.inference_mode():
            q, k, v = A._project_qkv(attn, x, acfg)
            # float32 in and out: the output's bf16 rounding would hide
            # the two orders of summation under one ulp (2^-8)
            q = apply_rope(q, pos, acfg.rope_theta).float()
            k = apply_rope(k, pos, acfg.rope_theta).float()
            v = v.float()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = A.flash_attention(q, k, v, acfg, pos, pos, cfg.attn_chunk)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            extra = torch.cuda.max_memory_allocated() - base
            if not bool(torch.isfinite(got).all()):
                fail(f"shapes (a): non-finite attention at S={s}")
            line = (f"[shapes] (a) attention, S={s}, H={acfg.n_heads}, "
                    f"hd {acfg.head_dim}, kv_chunk {cfg.attn_chunk}: "
                    f"{ms:.1f} ms, {_gb(extra)} beyond its inputs (one "
                    f"block's float32 scores: "
                    f"{_gb(4 * acfg.n_heads * s * cfg.attn_chunk)})")
            if s == ATTN_CHECK_S:
                want = _whole_attention(q, k, v, acfg, pos)
                diff = float((got.float() - want.float()).abs().max())
                line += f"; against whole-sequence max abs diff {diff:.3e}"
                if diff > 1e-3:
                    fail(f"shapes (a): chunked attention {diff:.3e} from "
                         "whole-sequence (tolerance 1e-3)")
                del want
            print(line, flush=True)
            del q, k, v, got, x
        torch.cuda.empty_cache()


def _shape_prefill(prepared, cfg) -> None:
    """(b) prefill_32k: ``make_step_fn``'s prefill step, 32 layers, B=1,
    S=32768, int8 KV; one run, under the profiler."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as S
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=1)
    step = S.make_step_fn(cfg, shape)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, shape.seq_len),
                                     device=SHAPES_DEVICE, dtype=torch.int32)}
    dry = _dry(cfg, "prefill", 1, shape.seq_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    ops.reset_launch_counts()
    profile_step(f"prefill_32k ({cfg.name}, {cfg.n_layers} layers, B=1, "
                 f"S={shape.seq_len}, KV {cfg.kv_cache_dtype})",
                 lambda: out.update(r=step(prepared, batch)), steps=1,
                 warm=False)
    logits, caches = out.pop("r")
    _peak_line("(b) prefill_32k", dry)
    if tuple(logits.shape) != (1, cfg.vocab_padded) or not bool(
            torch.isfinite(logits).all()):
        fail(f"shapes (b): logits {tuple(logits.shape)} not finite")
    k0 = caches["blocks"][0]["k"]
    if str(k0.dtype) != f"torch.{cfg.kv_cache_dtype}" \
            or k0.shape[1] != shape.seq_len:
        fail(f"shapes (b): cache {k0.dtype} {tuple(k0.shape)}")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[shapes] (b) logits finite {tuple(logits.shape)}; the prefill's"
          f" MLPs run dense (no sparse prefill): launches {launched}",
          flush=True)
    if launched:
        fail(f"shapes (b): kernels launched in a dense prefill: {launched}")
    del logits, caches, out
    torch.cuda.empty_cache()


def _max_batch(cfg, shape_name: str) -> int:
    """The dry run's largest batch that fits one card at a shape."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    rec = dryrun.cell_record(cfg, SHAPES[shape_name])
    print(f"[shapes] dry run: {cfg.name} {shape_name} at its batch "
          f"{rec['global_batch']}: {_gb(rec['bytes']['total'])}, fits "
          f"{rec['fits']}; the largest batch that fits {rec['max_batch']}",
          flush=True)
    return rec["max_batch"]


def _shape_decode(prepared, cfg, label: str, shape_name: str, batch: int,
                  want: dict) -> None:
    """(c), (d): one decode step (``make_step_fn``'s serve step) at cache
    length seq_len - 1 on seeded (zero) caches, launches exactly
    ``want``."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as S
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    dry = _dry(cfg, "decode", batch, shape.seq_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    caches = S.cache_structs(cfg, shape, SHAPES_DEVICE)
    batch_in = S.input_specs(cfg, shape, SHAPES_DEVICE)
    step = S.make_step_fn(cfg, shape)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = step(prepared, batch_in, caches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _peak_line(f"{label} {cfg.name} {shape_name} at B={batch}", dry)
    print(f"[shapes] {label} first step {ms:.1f} ms (host wall), logits "
          f"{tuple(logits.shape)}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if not bool(torch.isfinite(logits).all()):
        fail(f"shapes {label}: non-finite logits")
    if counts != _want_launches(counts, **want):
        fail(f"shapes {label}: launches {counts}, want {want}")
    profile_step(f"{shape_name} decode step ({cfg.name}, B={batch}, cache "
                 f"{shape.seq_len})",
                 lambda: step(prepared, batch_in, caches), steps=2)
    del logits, caches, batch_in
    torch.cuda.empty_cache()


def _shape_train(cfg) -> None:
    """(e) train_4k: ``make_step_fn``'s train step at 4 layers, B=1,
    S=4096, remat; no serving kernel."""
    import math

    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.tree import leaves
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=1)
    dry = _dry(cfg, "train", 1, shape.seq_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, 0, SHAPES_DEVICE)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = init_adamw(params)
    gen = torch.Generator(device=SHAPES_DEVICE).manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab, (1, shape.seq_len),
                              device=SHAPES_DEVICE,
                              generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = S.make_step_fn(cfg, shape)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _no_serving_launches("shapes (e)")
    loss = float(m["loss"])
    print(f"[shapes] (e) train_4k {cfg.name}, {cfg.n_layers} layers, B=1, "
          f"S={shape.seq_len}, remat: loss {loss:.4f}, grad norm "
          f"{float(m['grad_norm']):.4f}, first step {ms:.1f} ms",
          flush=True)
    _peak_line("(e) train_4k", dry)
    if not math.isfinite(loss):
        fail("shapes (e): non-finite loss")
    profile_step(f"train_4k step ({cfg.name}, {cfg.n_layers} layers, B=1, "
                 f"S={shape.seq_len})", lambda: step(params, opt, batch),
                 steps=1, grad=True)
    del params, opt
    torch.cuda.empty_cache()


def _shape_legacy(raw, cfg) -> None:
    """(f) the legacy chunked scheduler at full width and depth, launches
    exact from load to drain; then the serve CLI with --no-slot-refill."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)
    ops.reset_launch_counts()
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=256,
                                      max_new_tokens=16, slot_refill=False,
                                      prefill_chunk=MAIN_CHUNK), raw,
                 device=SHAPES_DEVICE)
    rng = np.random.default_rng(6)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(96, 193))), max_new=16,
        sla=tiers[i % 3]) for i in range(8)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = srv.serve(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tier = [w for w in caught if "ignores per-request SLA tiers"
            in str(w.message)]
    steps = srv.decode_steps
    rep = throughput_report(done)
    print(f"[shapes] (f) legacy chunked scheduler, {cfg.n_layers} layers, "
          f"batch {MAIN_BATCH}, prefill_chunk {MAIN_CHUNK}: "
          f"throughput_report {json.dumps(rep)}; decode steps {steps}; "
          f"tier warnings {len(tier)}; launches from load {counts}",
          flush=True)
    if len(tier) != 1:
        fail(f"shapes (f): {len(tier)} tier warnings, want 1")
    if steps != 2 * 15 or any(r.outcome != "completed" or len(r.out) != 16
                              for r in done):
        fail(f"shapes (f): {steps} decode steps (want 30), or a request "
             "did not complete with 16 tokens")
    want = dict(sign_pack=cfg.n_layers,
                predict_group_margins=cfg.n_layers * steps,
                fused_sparse_mlp=cfg.n_layers * steps)
    if counts != _want_launches(counts, **want):
        fail(f"shapes (f): launches {counts}, want {want}")
    del srv, done
    torch.cuda.empty_cache()


def _shape_legacy_cli() -> None:
    """(f) the serve CLI with --no-slot-refill at full width: its report
    names the scheduler and says no SLA tier applied."""
    import torch
    from repro_torch.launch import serve as serve_cli
    rep = serve_cli.main(["--arch", SHAPE_ARCH, "--strategy", "pallas",
                    "--batch", str(MAIN_BATCH), "--requests", "8",
                    "--prompt-len", "128", "--max-new", "16", "--max-len",
                    "256", "--prefill-chunk", str(MAIN_CHUNK),
                    "--no-slot-refill", "--device", SHAPES_DEVICE,
                    "--sla-mix", "latency:1,balanced:1,quality:1"])
    print(f"[shapes] (f) serve CLI --no-slot-refill: scheduler "
          f"{rep['scheduler']!r}, sla_applied {rep['sla_applied']}, "
          f"{rep['completed']} completed, {rep['tok_per_s']:.1f} tok/s",
          flush=True)
    if rep["scheduler"] != "chunked" or rep["sla_applied"] is not False \
            or rep["completed"] != 8:
        fail(f"shapes (f): the CLI's report {rep}")
    torch.cuda.empty_cache()


def _forced_logits(params, cfg, dev):
    """Prefill a seeded 4 x 16 prompt, then 8 teacher-forced decode steps
    -> logits (steps, B, V) on the CPU (no stats: sparsity may be off)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(DEC_BATCH, DEC_PLEN))
    forced = rng.integers(0, cfg.vocab, size=(DEC_STEPS, DEC_BATCH, 1))
    with torch.inference_mode():
        _, caches = lm.prefill(params, cfg, torch.as_tensor(prompt,
                                                            device=dev),
                               DEC_MAX_LEN)
        out = []
        for t in range(DEC_STEPS):
            lg, caches = lm.decode_step(
                params, cfg, torch.as_tensor(forced[t], device=dev), caches,
                DEC_PLEN + t)
            out.append(lg.float().cpu())
    return torch.stack(out)


def _shape_permutation() -> None:
    """(g) co-activation permutation of 2 full-width float32 layers,
    calibrated on a 256-token prompt's gate activations (> 0)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.selection import (apply_neuron_permutation,
                                            coactivation_permutation)
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    base = get_config(SHAPE_ARCH)
    cfg = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32",
                       sparse=dataclasses.replace(base.sparse,
                                                  strategy="pallas",
                                                  enabled=True))
    raw = lm.init_lm(cfg, 7, SHAPES_DEVICE)
    xs = []

    def record(mlp, params, x, c, **kw):
        xs.append(x.reshape(-1, x.shape[-1]))
        return mlp(params, x, c, **kw)
    prompt = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, size=(1, PERM_PROMPT)), device=SHAPES_DEVICE)
    with torch.inference_mode(), _mlp_tap(record):
        lm.prefill(raw, cfg, prompt, PERM_PROMPT)
    g = cfg.sparse.group_size
    permuted = dict(raw, blocks=[dict(b) for b in raw["blocks"]])
    for i, x in enumerate(xs):
        mlp = raw["blocks"][i]["mlp"]
        acts = (x.float() @ mlp["wg_t"].float().T > 0).cpu().numpy()
        perm = coactivation_permutation(acts)
        permuted["blocks"][i]["mlp"] = apply_neuron_permutation(mlp, perm)

        def density(a):
            return float(a.reshape(a.shape[0], -1, g).any(-1).mean())
        print(f"[shapes] (g) layer {i}: row density {acts.mean():.4f}, "
              f"group density (G={g}) {density(acts):.4f} before, "
              f"{density(acts[:, perm]):.4f} after the permutation",
              flush=True)
    off = cfg.replace(sparse=dataclasses.replace(cfg.sparse, enabled=False))
    diff = float((_forced_logits(permuted, off, SHAPES_DEVICE)
                  - _forced_logits(raw, off, SHAPES_DEVICE)).abs().max())
    print(f"[shapes] (g) sparsity off, 8 teacher-forced steps: permuted "
          f"against unpermuted logits max abs diff {diff:.3e}", flush=True)
    if diff > 1e-3:
        fail(f"shapes (g): the permuted model's logits {diff:.3e} from the "
             "unpermuted one's (tolerance 1e-3)")
    ops.reset_launch_counts()
    pp = {"cuda": lm.prepare_sparse(permuted)}
    torch.cuda.synchronize()
    packs = ops.launch_counts()["sign_pack"]
    print(f"[shapes] (g) re-prepared: {packs} sign_pack launches at load",
          flush=True)
    if packs != cfg.n_layers:
        fail(f"shapes (g): {packs} sign packs at load, want {cfg.n_layers}")
    pp["cpu"] = _to(pp["cuda"], "cpu")
    L = cfg.n_layers
    _hold("[shapes] (g) permuted, sparsity on",
          lambda dev: _teacher_forced(pp[dev], cfg, dev), LOGIT_TOL["float32"],
          dict(predict_group_margins=L * DEC_STEPS,
               fused_sparse_mlp=L * DEC_STEPS))
    del raw, permuted, pp
    torch.cuda.empty_cache()


def phase_shapes() -> None:
    """The reference's shape matrix on one card (module docstring, 21)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import HBM_PER_CARD
    from repro_torch.models import lm

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[shapes] the card holds {_gb(total)}; the dry run's "
          f"HBM_PER_CARD {_gb(HBM_PER_CARD)}", flush=True)
    cfg = get_config(SHAPE_ARCH)
    cfg = cfg.replace(sparse=dataclasses.replace(cfg.sparse,
                                                 strategy="pallas",
                                                 enabled=True))
    t = time.perf_counter()
    raw = lm.init_lm(cfg, 0, SHAPES_DEVICE)
    print(f"[shapes] {cfg.name} at full width and depth, float32 weights: "
          f"init {time.perf_counter() - t:.1f} s", flush=True)
    for step, fn in (("a", lambda: _shape_attention(raw, cfg)),
                     ("b", lambda: _shape_prefill(raw, cfg)),
                     ("c", lambda: _shape_decode(
                         lm.prepare_sparse(raw), cfg, "(c)", "decode_32k",
                         _max_batch(cfg, "decode_32k"),
                         dict(sign_pack=0,
                              predict_group_margins=cfg.n_layers,
                              fused_sparse_mlp=cfg.n_layers))),
                     ("f", lambda: _shape_legacy(raw, cfg))):
        t = time.perf_counter()
        fn()
        print(f"[shapes] ({step}) {time.perf_counter() - t:.1f} s",
              flush=True)
    del raw
    torch.cuda.empty_cache()
    for step, fn in (("f", _shape_legacy_cli),
                     ("d", _shape_long),
                     ("e", lambda: _shape_train(get_config(SHAPE_ARCH)
                                                .replace(n_layers=4,
                                                         remat=True))),
                     ("g", _shape_permutation)):
        t = time.perf_counter()
        fn()
        print(f"[shapes] ({step}) {time.perf_counter() - t:.1f} s",
              flush=True)


def _shape_long() -> None:
    """(d) long_500k: one decode step of each long-context arch at full
    depth, B=1, cache length 524287."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        cfg = get_config(arch)
        cfg = cfg.replace(sparse=dataclasses.replace(cfg.sparse,
                                                     strategy="pallas"))
        params = lm.init_lm(cfg, 0, SHAPES_DEVICE)
        if cfg.sparse.enabled:
            params = lm.prepare_sparse(params, cfg.sparse)
        # zamba2: one sparse MLP an invocation of its shared block; xlstm
        # has none
        n = cfg.n_layers // cfg.attn_every if lm.has_sparse_mlp(cfg) \
            and cfg.sparse.enabled else 0
        _shape_decode(params, cfg, "(d)", "long_500k", 1,
                      dict(predict_group_margins=n, fused_sparse_mlp=n))
        del params
        torch.cuda.empty_cache()


def decode_q_ab(other_src: str, src: str) -> None:
    """The int8 decode MLP's scaling line and int8 decode step profile of
    ``other_src`` and ``src``, in the order other, this, this, other, each
    in a process of its own (one package a process)."""
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"no repro_torch in {other_src}")
    for path in (other_src, src, src, other_src):
        traced = path == src
        code = (f"import sys; sys.path[:0] = [{path!r}, {HERE!r}]; "
                "import torch; torch.backends.cuda.matmul.allow_tf32 = "
                "False; import chip_smoke as cs; "
                f"cs.phase_decode_q_scaling(traced={traced}); "
                "cs.profile_int8_decode()")
        print(f"[ab] {path}", flush=True)
        if subprocess.run([sys.executable, "-c", code]).returncode:
            fail(f"the int8 decode A/B run of {path} failed")


def decode_ab(other_src: str, src: str) -> None:
    """The float32 decode MLP's scaling line and a profiled float32 decode
    step of ``other_src`` and ``src``, in the order other, this, this,
    other, each in a process of its own (one package a process)."""
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"no repro_torch in {other_src}")
    for path in (other_src, src, src, other_src):
        traced = path == src
        code = (f"import sys; sys.path[:0] = [{path!r}, {HERE!r}]; "
                "import torch; torch.backends.cuda.matmul.allow_tf32 = "
                "False; import chip_smoke as cs; "
                f"cs.phase_decode_scaling(traced={traced}); "
                "cs.profile_float32_decode()")
        print(f"[ab] {path}", flush=True)
        if subprocess.run([sys.executable, "-c", code]).returncode:
            fail(f"the float32 decode A/B run of {path} failed")


def profile_float32_decode() -> None:
    """A full-depth decode step with float32 MLP weights, profiled, on its
    own server (random weights from seed 0): run from a script that puts a
    checkout's ``src`` first on sys.path, it profiles that checkout's
    step."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True))
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=256),
                 params, device="cuda")
    del params
    profile_decode(srv, cfg, "float32")
    del srv
    torch.cuda.empty_cache()


def time_mlps() -> None:
    """The float32 decode MLP at B=4 and the float32 chunk MLP at S=64, bf16
    x, on a full selection of prosparse-llama2-7b's weights: the yardstick
    of the predictor A/B (the MLP kernels are the same on both sides)."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    wg, wu, wd = (torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
                  for _ in range(3))
    cap = SparseInferConfig().capacity(K)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for name, rows in (("fused_sparse_mlp", MAIN_BATCH),
                       ("fused_sparse_mlp_chunk", MAIN_CHUNK)):
        x = torch.randn((rows, D), generator=gen, device=dev).to(
            torch.bfloat16)
        gm, _ = KP.predict_chunk_group_margins(
            P.pack_signs(wg), x, torch.ones(rows, device=dev), d_valid=D,
            group_size=G)
        sel = S.capacity_select(S.union_margin(gm), cap)
        fn = getattr(KF, name)
        t = cuda_ms(lambda: fn(x, wg, wu, wd, sel.indices, sel.count,
                               group_size=G), flush=flush)
        print(f"[ab] {name} rows={rows} count={int(sel.count)}: {t:.4f} ms",
              flush=True)
    del wg, wu, wd, flush_buf
    torch.cuda.empty_cache()


def profile_float32_steps() -> None:
    """A full-depth prefill chunk (S=MAIN_CHUNK, sparse prefill) and a
    decode step with float32 MLP weights, profiled, on one server (random
    weights from seed 0): run from a script that puts a checkout's ``src``
    first on sys.path, it profiles that checkout's steps."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True, sparse_prefill=True,
        prefill_max_tokens=max(base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=256,
                                      prefill_chunk=MAIN_CHUNK), params,
                 device="cuda")
    del params
    profile_prefill_chunk(srv, cfg, "float32")
    profile_decode(srv, cfg, "float32")
    del srv
    torch.cuda.empty_cache()


def profile_gather_steps() -> None:
    """A full-depth gather prefill chunk (S=MAIN_CHUNK, sparse prefill) and
    gather decode step (B=MAIN_BATCH) with float32 MLP weights, profiled,
    on one server (random weights from seed 0): each MLP call packs x with
    sign_pack and counts with predict_counts.  Run from a script that puts
    a checkout's ``src`` first on sys.path, it profiles that checkout's
    steps."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="gather", enabled=True, sparse_prefill=True,
        prefill_max_tokens=max(base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=256,
                                      prefill_chunk=MAIN_CHUNK), params,
                 device="cuda")
    del params
    profile_prefill_chunk(srv, cfg, "gather, float32")
    profile_decode(srv, cfg, "gather, float32")
    del srv
    torch.cuda.empty_cache()


def profile_paged_steps() -> None:
    """A full-depth paged decode step (bf16 pool, paged kernels, float32
    MLP weights) profiled on its own server (random weights from seed 0),
    as ``profile_paged_decode`` profiles the paged serve's: run from a
    script that puts a checkout's ``src`` first on sys.path, it profiles
    that checkout's step."""
    import torch
    from repro_torch.configs.base import PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=dataclasses.replace(
                           base.sparse, strategy="pallas", enabled=True))
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(
        batch=MAIN_BATCH, max_len=256,
        paged_kv=PagedKVConfig(block_size=PAGE_BLOCK)), params,
        device="cuda")
    del params
    profile_paged_decode(srv, cfg)
    del srv
    torch.cuda.empty_cache()


def kv_ab(other_src: str, src: str) -> None:
    """#8 and #9 (``time_write_and_pack``), the unchanged kernels beside
    them (the paged attention at the main shape, the float32 decode and
    chunk MLPs), a profiled full-depth paged decode step and profiled
    gather prefill chunk and decode step, of ``other_src`` and ``src`` in
    the order other, this, this, other, each in a process of its own (one
    package a process).  Every run's #8 and #9 outputs must be bitwise
    the first run's."""
    import torch
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"no repro_torch in {other_src}")
    out_dir = os.path.join(HERE, "build", "kv_ab")
    os.makedirs(out_dir, exist_ok=True)
    saved = []
    for i, path in enumerate((other_src, src, src, other_src)):
        saved.append(os.path.join(out_dir, f"outputs{i}.pt"))
        code = (f"import sys; sys.path[:0] = [{path!r}, {HERE!r}]; "
                "import torch; torch.backends.cuda.matmul.allow_tf32 = "
                "False; import chip_smoke as cs; out = {}; "
                f"cs.time_write_and_pack(out); torch.save(out, "
                f"{saved[-1]!r}); cs.time_attention_main(); cs.time_mlps(); "
                "cs.profile_paged_steps(); cs.profile_gather_steps()")
        print(f"[ab] {path}", flush=True)
        if subprocess.run([sys.executable, "-c", code]).returncode:
            fail(f"the write and sign-pack A/B run of {path} failed")
    runs = [torch.load(f) for f in saved]
    for name, first in runs[0].items():
        if any(len(r[name]) != len(first) or not all(
                torch.equal(a, b) for a, b in zip(r[name], first))
               for r in runs[1:]):
            fail(f"the write and sign-pack A/B: {name}'s outputs differ "
                 "between runs")
    print(f"[ab] #8's and #9's outputs ({len(runs[0])} cases: written rows "
          "and pool fingerprints, sign words) bitwise equal in all four "
          "runs", flush=True)


def time_attention_main() -> None:
    """The paged attention at the main path's shape (B=4, bf16 pool,
    lengths 64-192, the L2 flushed): a yardstick of the A/B runs, whose
    kernel is the same on both sides."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    q, kp, vp, table, lengths = _paged_inputs(
        gen, np.random.default_rng(8), MAIN_BATCH, 32, 32, 128, PAGE_BLOCK,
        PAGED_NBPS[0], torch.bfloat16, torch.bfloat16, lengths=MAIN_LIVE)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    t = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table, lengths),
                iters=50, flush=flush_buf.zero_)
    print(f"[ab] paged_attention B={MAIN_BATCH} bf16: {t:.4f} ms",
          flush=True)
    del q, kp, vp, flush_buf
    torch.cuda.empty_cache()


def pred_ab(other_src: str, src: str) -> None:
    """The predictors' scaling line (predict_counts' too), the two float32
    MLP kernels beside them and profiled full-depth prefill chunks and
    decode steps (strategy pallas, then gather), of ``other_src`` and
    ``src`` in the order other, this, this, other, each in a process of its
    own (one package a process).  Every run's scaling-line outputs must be
    bitwise the first run's."""
    import torch
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"no repro_torch in {other_src}")
    out_dir = os.path.join(HERE, "build", "pred_ab")
    os.makedirs(out_dir, exist_ok=True)
    saved = []
    for i, path in enumerate((other_src, src, src, other_src)):
        saved.append(os.path.join(out_dir, f"outputs{i}.pt"))
        code = (f"import sys; sys.path[:0] = [{path!r}, {HERE!r}]; "
                "import torch; torch.backends.cuda.matmul.allow_tf32 = "
                "False; import chip_smoke as cs; out = {}; "
                f"cs.phase_predict_scaling(out); torch.save(out, "
                f"{saved[-1]!r}); cs.time_mlps(); "
                "cs.profile_float32_steps(); cs.profile_gather_steps()")
        print(f"[ab] {path}", flush=True)
        if subprocess.run([sys.executable, "-c", code]).returncode:
            fail(f"the predictor A/B run of {path} failed")
    runs = [torch.load(f) for f in saved]
    for name, first in runs[0].items():
        if any(len(r[name]) != len(first) or not all(
                torch.equal(a, b) for a, b in zip(r[name], first))
               for r in runs[1:]):
            fail(f"the predictor A/B: {name}'s outputs differ between runs")
    print(f"[ab] the scaling lines' outputs ({len(runs[0])} points: gm and "
          "cnt, counts) bitwise equal in all four runs", flush=True)


CARDS4_SHAPE = (4,)        # --cards4: one 'model' line of four ranks
CARDS4_TIMEOUT = 2400      # seconds for every rank's serves together


def _cards4_cases() -> list:
    """--cards4's cases: (label, config, serve config, requests), every
    config at tp_shards 4 with a bf16 paged pool on the paged kernels and
    chunked prefill in chunks of 64; batch 4, one request a slot with
    96-192-token prompts and 16 new tokens."""
    import numpy as np
    from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                          PagedKVConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.server import ServeConfig

    rng = np.random.default_rng(33)
    tiers = ("latency", "balanced", "quality")
    met = MetricsConfig(enabled=True, watchdog=False)

    def case(label, arch, layers, strategy, ctl=False, **kw):
        base = get_config(arch)
        cfg = base.replace(
            n_layers=layers, kv_cache_dtype="bfloat16",
            paged_attn_kernel=True, sparse=dataclasses.replace(
                base.sparse, strategy=strategy, enabled=True,
                sparse_prefill=True, tp_shards=CARDS4_SHAPE[0],
                dp_shards=1, **kw))
        scfg = ServeConfig(
            batch=MAIN_BATCH, max_len=256, max_new_tokens=MESH_MAX_NEW,
            metrics=met, prefill_chunk=MAIN_CHUNK,
            paged_kv=PagedKVConfig(block_size=PAGE_BLOCK),
            controller=ControllerConfig(enabled=True, per_tier=True,
                                        audit_period=4) if ctl
            else ControllerConfig())
        reqs = [(i, rng.integers(0, base.vocab,
                                 size=int(rng.integers(96, 193))),
                 MESH_MAX_NEW, tiers[i % 3]) for i in range(MAIN_BATCH)]
        return (label, cfg, scfg, reqs)
    return [
        case("(a) qwen1.5-32b, 64 layers, pallas", "qwen1.5-32b", 64,
             "pallas"),
        case("(b) granite-34b, 88 layers, pallas", "granite-34b", 88,
             "pallas"),
        case("(c) granite-34b, 2 layers, int8 MLP weights, pallas",
             "granite-34b", 2, "pallas", weight_dtype="int8",
             quant_group_size=QG),
        case("(d) prosparse-llama2-7b, 16 layers, gather, per-tier "
             "controller", "prosparse-llama2-7b", 16, "gather", ctl=True)]


CARDS4_2D = (2, 2)         # --cards4's second spawn: two lines of two
CARDS4_2D_BATCH = 8        # four slots a line
CARDS4_2D_ARCH = "prosparse-llama2-13b"


def _cards4_2d_cases() -> list:
    """--cards4's 2x2 cases, prosparse-llama2-13b at ds = ms = 2, batch 8
    (four slots a 'data' line), one request a slot with 96-192-token
    prompts and 16 new tokens: (label, config, serve config, requests,
    session).  (e) the whole model (40 layers), pallas, a bf16 paged pool
    on the paged kernels, chunked prefill in chunks of 64; (f) 8 layers,
    float32 dense caches, gather with masked audits and the per-tier
    controller, then ``_crossing_session`` (turn 2 on the other line)."""
    import numpy as np
    from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                          PagedKVConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.server import ServeConfig

    base = get_config(CARDS4_2D_ARCH)
    rng = np.random.default_rng(35)
    tiers = ("latency", "balanced", "quality")
    reqs = [(i, rng.integers(0, base.vocab, size=int(rng.integers(96, 193))),
             MESH_MAX_NEW, tiers[i % 3]) for i in range(CARDS4_2D_BATCH)]
    met = MetricsConfig(enabled=True, watchdog=False)

    def sparse(strategy):
        return dataclasses.replace(
            base.sparse, strategy=strategy, enabled=True, sparse_prefill=True,
            tp_shards=CARDS4_2D[1], dp_shards=CARDS4_2D[0])
    e_scfg = ServeConfig(batch=CARDS4_2D_BATCH, max_len=256,
                         max_new_tokens=MESH_MAX_NEW, metrics=met,
                         prefill_chunk=MAIN_CHUNK,
                         paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    f_scfg = ServeConfig(batch=CARDS4_2D_BATCH, max_len=256,
                         max_new_tokens=MESH_MAX_NEW, metrics=met,
                         controller=ControllerConfig(
                             enabled=True, per_tier=True, audit_period=4))
    return [
        (f"(e) {CARDS4_2D_ARCH}, {base.n_layers} layers, pallas, 2x2",
         base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                      sparse=sparse("pallas")), e_scfg, reqs, None),
        (f"(f) {CARDS4_2D_ARCH}, 8 layers, gather, per-tier controller, "
         "float32 dense caches, 2x2",
         base.replace(n_layers=8, kv_cache_dtype="float32",
                      sparse=sparse("gather")), f_scfg, reqs,
         _crossing_session(f_scfg, base.vocab, 36))]


def _cards4_2d_rank(mesh, dev, cases: list) -> list:
    """A rank's serves of ``_cards4_2d_cases``: (e) profiled with one
    step's collectives counted, no MLP calls kept; (f) with its
    teacher-forced MLP calls kept and its session."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [_mesh_serve(*case[:4], dev, mesh, calls=case[4] is not None,
                        profile=case[4] is None, session=case[4])
            for case in cases]


def _cards4_2d() -> None:
    """--cards4's second spawn: ``_cards4_2d_cases`` on a 2x2 mesh over
    NCCL, a card a rank; every rank's tokens, EMAs and teacher-forced
    logits bitwise rank 0's, launches exact, the slot split
    (``_check_split``), per rank its weights, peak, KV bytes, decode step
    host wall, tokens/s and one step's gathers by axis; then (f) in this
    process on card 0 (the emulated grid) replaying the ranks'
    teacher-forced MLP inputs, and its session against the ranks'
    (``_check_session``)."""
    import torch
    from repro_torch.launch.ranks import run_ranks

    cases = _cards4_2d_cases()
    sizes = dict(zip(("data", "model"), CARDS4_2D))
    t = time.perf_counter()
    ranks = run_ranks(_cards4_2d_rank, CARDS4_2D, ("data", "model"),
                      args=(cases,), device=MESH_DEVICE,
                      timeout=CARDS4_TIMEOUT)
    print(f"[time] cards4 2x2 ranks over nccl: "
          f"{time.perf_counter() - t:.1f} s (start, serves)", flush=True)
    for j, (label, cfg, scfg, _, _) in enumerate(cases):
        on = [o[j] for o in ranks]
        if {o["backend"] for o in on} != {"nccl"}:
            fail(f"cards4 {label}: ranks ran on "
                 f"{ {o['backend'] for o in on} }, not nccl")
        _mesh_check(label, cfg, on, sizes)
        _check_split(label, cfg, scfg, on, sizes)
        if on[0]["completed"] != CARDS4_2D_BATCH:
            fail(f"cards4 {label}: {on[0]['completed']} requests completed")
        used = {k: v for k, v in on[0]["launches"].items() if v}
        coll = on[0].get("collectives")
        # over 'model': the embedding's and the head's a step, the rest
        # the layers'
        per_layer = (coll.get("model", 0) - 2) / cfg.n_layers if coll \
            else None
        print(f"[cards4] {label}: nccl, {len(on)} ranks; tokens, EMAs and "
              f"teacher-forced logits bitwise between the ranks; "
              f"{on[0]['steps']} decode steps, launches exact per rank "
              f"{used}; tokens/s {[round(o['tok_s'], 2) for o in on]} at "
              f"B={scfg.batch}; decode step host wall "
              f"{[round(o['step_ms'], 2) for o in on]} ms; peak memory "
              f"{[round(o['peak_gb'], 2) for o in on]} GB; parameters "
              f"{[round(o['param_bytes'] / 1e9, 3) for o in on]} GB; KV "
              f"{[round(p['kv_bytes'] / 1e9, 4) for p in on[0]['slots']['per_rank']]}"
              f" GB a rank (one device "
              f"{on[0]['slots']['one_device_kv_bytes'] / 1e9:.4f} GB); init "
              f"{[round(o['init_s'], 1) for o in on]} s"
              + (f"; gathers in one server step {coll} ('model': "
                 f"{per_layer} a layer beside the embedding's and the "
                 "head's; plus the host slot check)" if coll else ""),
              flush=True)
    label, cfg, scfg, reqs, sess = cases[1]
    t = time.perf_counter()
    e = _mesh_serve(label, cfg, scfg, reqs, torch.device(MESH_DEVICE, 0),
                    forced=ranks[0][1], session=sess)
    _check_session(label, [o[1] for o in ranks], e, sizes["model"])
    print(f"[cards4] {label}: one process on card 0 (the emulated grid): "
          f"teacher-forced logits of the ranks held; decode step host wall "
          f"{e['step_ms']:.2f} ms, peak {e['peak_gb']:.2f} GB; "
          f"{time.perf_counter() - t:.1f} s", flush=True)


CARDS4_TRAIN = {"arch": "prosparse-llama2-7b", "layers": 32, "batch": 8,
                "seq": 1024, "steps": 3, "profile": True}
# (h): the same against one process on card 0, at 4 layers
CARDS4_TRAIN_CHECK = {"arch": "prosparse-llama2-7b", "layers": 4,
                      "batch": 8, "seq": 256, "steps": 4, "compare": True,
                      "dtype": "float32"}


def _cards4_train() -> None:
    """--cards4's training: (g) ``CARDS4_TRAIN`` on a 2x2 mesh over NCCL,
    a card a rank (FSDP over the two data lines, the tensor split over
    'model'): every rank's history bitwise rank 0's; per rank its
    parameter and moment bytes against one device's, its peak after init
    and overall (no rank ever holds the whole parameter tree beside its
    own state), step ms and tokens/s over the steps after the first, one
    step's collectives by axis, and the model FLOPs over the step time as
    a share of four cards' bf16 dense peak; (h) ``CARDS4_TRAIN_CHECK``
    against one process on card 0 from the same seed and batches, with a
    checkpoint of step 2 that one process resumes."""
    import shutil
    import statistics
    import tempfile

    from repro_torch.launch.specs import param_shapes

    spec = CARDS4_TRAIN
    label = (f"(g) {spec['arch']}, {spec['layers']} layers, remat, B="
             f"{spec['batch']} S={spec['seq']}, 2x2 over nccl")
    outs = _train_mesh(label, CARDS4_2D, spec, "cuda")
    if {o["backend"] for o in outs} != {"nccl"}:
        fail(f"cards4 {label}: ranks ran on "
             f"{ {o['backend'] for o in outs} }, not nccl")
    cfg = _mesh_train_cfg(spec)
    whole = outs[0]["whole_param_bytes"]
    hist = outs[0]["history"]
    ms = statistics.median(h["time_s"] for h in hist[1:]) * 1e3
    tokens = spec["batch"] * spec["seq"]
    model, recompute = _step_flops(cfg, param_shapes(cfg), tokens,
                                   spec["batch"], spec["seq"])
    share = model / (ms / 1e3) / (4 * BF16_OPS_PER_S)
    print(f"[cards4] {label}: backend {[o['backend'] for o in outs]}; "
          f"parameters {[round(o['param_bytes'] / 1e9, 3) for o in outs]} "
          f"GB and moments {[round(o['opt_bytes'] / 1e9, 3) for o in outs]}"
          f" GB a rank against one device's {whole / 1e9:.3f} and "
          f"{2 * whole / 1e9:.3f} GB; peak memory after init "
          f"{[round(o['init_peak_gb'], 2) for o in outs]} GB, overall "
          f"{[round(o['peak_gb'], 2) for o in outs]} GB; init "
          f"{[round(o['init_s'], 1) for o in outs]} s; step ms "
          f"{[round(h['time_s'] * 1e3, 1) for h in hist]} (median after "
          f"the first {ms:.1f}), {tokens / ms * 1e3:.0f} tokens/s; "
          f"collectives in one step {outs[0]['collectives']} (gathers "
          "over each line, 'world' over all ranks; plus the step time's "
          "host gather); model FLOPs a step "
          f"{model / 1e12:.2f} T (+{recompute / 1e12:.2f} T recomputed), "
          f"{model / (ms / 1e3) / 1e12:.1f} TFLOP/s, {share:.4f} of four "
          f"cards' bf16 dense peak", flush=True)
    for r, o in enumerate(outs):
        # placing the weights and making the moments never reach the
        # whole tree's bytes; in a step the rank's params, gradients and
        # moments stay resident, so a peak under them plus the whole tree
        # never held it
        own = o["param_bytes"] * 2 + o["opt_bytes"]
        if o["init_peak_gb"] * 1e9 >= whole:
            fail(f"cards4 {label}: rank {r} peaked at "
                 f"{o['init_peak_gb']:.2f} GB while placing the weights, "
                 f"not under the whole tree's {whole / 1e9:.2f} GB")
        if o["peak_gb"] * 1e9 >= own + whole:
            fail(f"cards4 {label}: rank {r}'s peak {o['peak_gb']:.2f} GB "
                 "would hold the whole parameter tree beside its own "
                 "params, gradients and moments")
        if o["param_bytes"] * 2 > whole:
            fail(f"cards4 {label}: rank {r} holds {o['param_bytes']} of "
                 f"{whole} parameter bytes")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards4_ckpt_")
    try:
        spec = dict(CARDS4_TRAIN_CHECK, ckpt=tmp)
        _train_mesh(f"(h) {spec['arch']}, {spec['layers']} layers, float32 "
                    f"compute, B={spec['batch']} S={spec['seq']}, 2x2 over "
                    "nccl",
                    CARDS4_2D, spec, "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cards4_rank(mesh, dev, cases: list, profile: bool) -> list:
    """A rank's serves of ``cases``, no MLP calls kept."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [_mesh_serve(*case, dev, mesh, calls=False, profile=profile)
            for case in cases]


def _cards4_kernel_times() -> None:
    """The kernels at the shapes a rank of ``_cards4_cases`` gives them,
    against their plain versions, timed beside their bounds and library
    yardsticks: #7 and #8 at a rank's heads (qwen1.5-32b: 10 query and 10
    KV heads; granite-34b: 12 query heads over its one KV head;
    prosparse-llama2-7b: 8 and 8); #9, #1 and #2 at qwen's rank rows (k/4
    = 6848, gated); at granite's (6144, ungated) every MLP kernel
    (``_mlp_kernel_times``: #5 on int8 weights with qg 128 as (c) runs
    it); at the 7b's (2752, gated) #9, #1, #2 and #10, the route (d)
    runs (gather: #9 and #10); at a 2x2 rank of prosparse-llama2-13b
    (``_cards4_2d_cases``: 20 query and 20 KV heads, k/2 = 6912 rows) #7,
    #8, #9, #1 and #2, at B/D = 4 slots a line.  Each at the rank's shard
    capacity."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.kernels import sign_pack as KS
    from repro_torch.sharding import rules as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    one_line = (("model",), CARDS4_SHAPE)
    for name, (axes, shape) in (
            ("qwen1.5-32b", one_line), ("granite-34b", one_line),
            ("prosparse-llama2-7b", one_line),
            (CARDS4_2D_ARCH, (("data", "model"), CARDS4_2D))):
        cfg = get_config(name)
        rank0 = RankMesh(axes, shape, 0)
        m = rank0.axis_size("model")
        split = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, rank0)
        local = cfg.replace(n_heads=split.q1 - split.q0,
                            n_kv_heads=split.k1 - split.k0)
        kp, vp, table, lengths, kv_new = _served_attention(
            "cards4", f"{name} rank", local, gen, rng, flush)
        t = write_times(kp, vp, *kv_new, table, lengths.long())
        tag = f"{name} rank B={MAIN_BATCH} K={local.n_kv_heads} bf16"
        print(f"[cards4] {write_line(tag, t, MAIN_BATCH)}", flush=True)
        del kp, vp
        k_l = cfg.d_ff // m
        cap = dataclasses.replace(cfg.sparse,
                                  tp_shards=m).shard_capacity(cfg.d_ff)
        if name == "granite-34b":
            _mlp_kernel_times("cards4", f"{name} rank", cfg.d_model, k_l,
                              cfg.gated_mlp, cap, gen, flush)
            continue
        checked = _served_mlp_checks(f"{name} rank", cfg.d_model, k_l,
                                     cfg.gated_mlp, cap, gen)
        _served_mlp_time("cards4", f"{name} rank", checked, k_l, cap, flush)
        if name == "prosparse-llama2-7b":
            wg, x = checked[0], checked[3]
            _counts_time("cards4", f"{name} rank d={cfg.d_model} k={k_l}",
                         KS.sign_pack(wg), x, flush)
        del checked
    del flush_buf
    torch.cuda.empty_cache()


def cards4(src: str, serve: bool = True, train_only: bool = False) -> None:
    """The placed model on four cards of one host, a rank a card over NCCL
    (``python3 chip_smoke.py --cards4`` on a host with four cards): the
    kernels at a rank's shapes (``_cards4_kernel_times``), then
    ``_cards4_cases`` on a 1x4 mesh: every rank's tokens, EMAs and
    teacher-forced logits bitwise rank 0's, launches exact per rank, the
    backend NCCL on every rank; each case's tokens/s, peak memory and
    parameter bytes per rank and a profiled paged decode step (rank 0's).
    Then (d) again on gloo ranks that all share card 0: its tokens, EMAs
    and teacher-forced logits bitwise the NCCL run's; then the 2x2 spawn
    (``_cards4_2d``: prosparse-llama2-13b whole and at 8 layers, the slots
    split over 'data'), then the training of ``_cards4_train``.
    ``serve`` False (``--cards4-kernels``, one card will do): the kernels
    only; ``train_only`` (``--cards4-train``): the training only."""
    import torch
    from repro_torch.launch.ranks import choose_backend, run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = CARDS4_SHAPE[0]
    n = torch.cuda.device_count()
    if serve and n < world:
        fail(f"--cards4 needs {world} cards, this machine has {n}")
    backend, why = choose_backend(world, "cuda")
    if serve and backend != "nccl":
        fail(f"--cards4: the backend rule gives {backend} ({why}), not nccl")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    for i, line in enumerate(out):
        print(f"[gpu] card {i}: {line}", flush=True)
    t0 = time.perf_counter()
    if train_only:
        _cards4_train()
        print(f"[done] cards4 training in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return
    phase_build()
    t = time.perf_counter()
    _cards4_kernel_times()
    print(f"[time] cards4 kernel times: {time.perf_counter() - t:.1f} s",
          flush=True)
    if not serve:
        return
    cases = _cards4_cases()
    t = time.perf_counter()
    ranks = run_ranks(_cards4_rank, CARDS4_SHAPE, ("model",),
                      args=(cases, True), device="cuda",
                      timeout=CARDS4_TIMEOUT)
    print(f"[time] cards4 ranks over {backend}: "
          f"{time.perf_counter() - t:.1f} s (start, serves)", flush=True)
    for j, (label, cfg, _, _) in enumerate(cases):
        on = [o[j] for o in ranks]
        backends = {o["backend"] for o in on}
        if backends != {"nccl"}:
            fail(f"cards4 {label}: ranks ran on {backends}, not nccl")
        _mesh_check(label, cfg, on, {"model": world})
        if on[0]["completed"] != MAIN_BATCH:
            fail(f"cards4 {label}: {on[0]['completed']} requests completed")
        used = {k: v for k, v in on[0]["launches"].items() if v}
        print(f"[cards4] {label}: nccl, {len(on)} ranks; tokens, EMAs and "
              f"teacher-forced logits bitwise between the ranks; "
              f"{on[0]['steps']} decode steps, launches exact per rank "
              f"{used}; tokens/s {[round(o['tok_s'], 2) for o in on]}; "
              f"decode step host wall "
              f"{[round(o['step_ms'], 2) for o in on]} ms; peak memory "
              f"{[round(o['peak_gb'], 2) for o in on]} GB; parameters "
              f"{[round(o['param_bytes'] / 1e9, 3) for o in on]} GB; init "
              f"{[round(o['init_s'], 1) for o in on]} s", flush=True)
    # (d) on gloo ranks that share card 0: the same kernels, the same
    # combine order, so the same bits
    t = time.perf_counter()
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    try:
        glo = run_ranks(_cards4_rank, CARDS4_SHAPE, ("model",),
                        args=(cases[-1:], False), device="cuda",
                        backend="gloo", timeout=CARDS4_TIMEOUT)
    finally:
        del os.environ["CUDA_VISIBLE_DEVICES"]
    label = cases[-1][0]
    for r, (g, o) in enumerate(zip(glo, ranks)):
        if g[0]["backend"] != "gloo":
            fail(f"cards4 {label}: the one-card run's rank {r} ran on "
                 f"{g[0]['backend']}")
        diff = _same_state(g[0], o[-1])
        if diff or g[0]["launches"] != o[-1]["launches"]:
            fail(f"cards4 {label}: rank {r}'s {diff or 'launches'} on "
                 "gloo ranks sharing card 0 differ from nccl's")
    print(f"[cards4] {label}: gloo ranks sharing card 0 bitwise the nccl "
          f"ranks (tokens, EMAs, teacher-forced logits, launches); peak "
          f"memory {[round(g[0]['peak_gb'], 2) for g in glo]} GB; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    _cards4_2d()
    t = time.perf_counter()
    _cards4_train()
    print(f"[time] cards4 training (g), (h): {time.perf_counter() - t:.1f} "
          "s", flush=True)
    print(f"[done] cards4 in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the repo")
    if sys.argv[1:] in (["--cards4"], ["--cards4-kernels"],
                        ["--cards4-train"]):
        sys.path.insert(0, src)
        cards4(src, serve=sys.argv[1] != "--cards4-kernels",
               train_only=sys.argv[1] == "--cards4-train")
        print(gpu_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    ab = {"--decode-q-ab": decode_q_ab, "--pred-ab": pred_ab,
          "--decode-ab": decode_ab, "--kv-ab": kv_ab}
    if sys.argv[1:2] and sys.argv[1] in ab and len(sys.argv) == 3:
        print(f"[gpu] {gpu_line()}", flush=True)
        ab[sys.argv[1]](os.path.abspath(sys.argv[2]), src)
        print(f"[gpu] {gpu_line()}", flush=True)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: none, --cards4, "
             "--cards4-kernels, --cards4-train, --decode-ab OTHER_SRC, --decode-q-ab "
             "OTHER_SRC, --pred-ab OTHER_SRC or --kv-ab OTHER_SRC")
    sys.path.insert(0, src)
    # tolerances are set against full-float32 matrix products: TF32 keeps
    # ~3 decimal digits and would hide (or fake) a kernel fault
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[gpu] {gpu_line()}", flush=True)
    t0 = time.perf_counter()
    results: dict = {}
    for phase, args in ((phase_build, ()), (phase_kernels, (results,)),
                        (phase_chunk_kernels, (results,)),
                        (phase_chunk_scaling, ()),
                        (phase_decode_q_scaling, ()),
                        (phase_decode_scaling, ()),
                        (phase_predict_scaling, ()),
                        (phase_paged_kernels, (results,)),
                        (phase_sign_kernels, (results,)),
                        (phase_decode, ()), (phase_prefill, ()),
                        (phase_paged_decode, ()),
                        (phase_decode_strategies, ()),
                        (phase_serve, (results,)),
                        (phase_serve_chunked, (results,)),
                        (phase_serve_paged, (results,)),
                        (phase_serve_controller, (results,)),
                        (phase_serve_overload, (results,)),
                        (phase_archs, ()), (phase_arch_kernel_times, ()),
                        (phase_serve_gemma2, ()),
                        (phase_sharded, (results,)),
                        (phase_mesh, (results,)),
                        (phase_moe, (results,)),
                        (phase_cross, (results,)),
                        (phase_recurrent, (results,)),
                        (phase_train, (results,)),
                        (phase_shapes, ())):
        t = time.perf_counter()
        phase(*args)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    src_of = "src/repro_torch/csrc/{}.cu".format
    launches = {
        **results["launches"],
        **{n: results["launches_chunked_float32"][n]
           for n in ("predict_chunk_group_margins", "fused_sparse_mlp_chunk")},
        **{n: results["launches_chunked_int8"][n]
           for n in ("fused_sparse_mlp_q", "fused_sparse_mlp_chunk_q")},
        **{n: results["launches_paged"][n]
           for n in ("paged_attention", "paged_kv_write")},
        **{n: results["launches_ctrl_gather"][n]
           for n in ("sign_pack", "predict_counts")}}
    replaces = {
        "predict_group_margins": "src/repro/kernels/predict.py:263",
        "fused_sparse_mlp": "src/repro/kernels/sparse_mlp_fused.py:300",
        "predict_chunk_group_margins": "src/repro/kernels/predict.py:216",
        "fused_sparse_mlp_chunk": "src/repro/kernels/sparse_mlp_fused.py:499",
        "fused_sparse_mlp_q": "src/repro/kernels/sparse_mlp_fused.py:397",
        "fused_sparse_mlp_chunk_q":
            "src/repro/kernels/sparse_mlp_fused.py:597",
        "paged_attention": "src/repro/kernels/paged_attn.py:125",
        "paged_kv_write": "src/repro/kernels/paged_attn.py:164",
        "sign_pack": "src/repro/kernels/sign_pack.py:73",
        "predict_counts": "src/repro/kernels/predict.py:85"}
    kernels = [{"name": n, "route": "cuda", "source": src_of(n),
                "replaces": r, "launches": launches[n], **results[n]}
               for n, r in replaces.items()]
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
